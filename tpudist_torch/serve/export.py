"""Arch name → eval-mode serving model on the device (the export half of
``tpudist_torch.serve``).

Counterpart of ``tpudist/serve/export.py``. The model computes in the
compute dtype (bf16 by default) from fresh f32 weights on the device, drawn
from ``seed`` (the bench/smoke path, where serving performance is the
measured quantity and the weights are irrelevant). ``flash`` reaches the
model's attention as the reference's ``--flash on|off`` does.

Not yet in the port: ``--flash auto`` (the measurement-honest dispatch of
``ops/attention_dispatch``) and loading a checkpoint.
"""

from __future__ import annotations

import torch

from tpudist_torch._device import resolve_device
from tpudist_torch.models import create_model


def resolve_serve_flash(mode: str) -> bool:
    """``--flash on|off`` → whether attention runs the flash kernel."""
    if mode == "on":
        return True
    if mode == "off":
        return False
    if mode == "auto":
        raise ValueError("--flash auto needs the attention dispatch layer "
                         "(ops/dispatch + ops/attention_dispatch), which "
                         "the port does not have yet; pass --flash on|off")
    raise ValueError(f"--flash must be on, off or auto, got {mode!r}")


def load_serve_state(arch: str, checkpoint: str = "", *,
                     num_classes: int = 1000, image_size: int = 224,
                     flash: str = "on", dtype=torch.bfloat16, seed: int = 0,
                     device=None, log=None) -> torch.nn.Module:
    """Build the serving model: ``arch`` in ``dtype`` on ``device`` (the
    CUDA card unless the caller passes ``"cpu"``), weights drawn from a
    ``torch.Generator`` seeded by ``seed``, in eval mode."""
    dev = resolve_device(device)
    if checkpoint:
        raise NotImplementedError(
            "--checkpoint: the port cannot read tpudist .msgpack "
            "checkpoints yet (it needs its own msgpack reader); serve "
            "fresh weights with --checkpoint ''")
    model = create_model(arch, num_classes=num_classes,
                         image_size=image_size,
                         flash=resolve_serve_flash(flash), dtype=dtype,
                         device="meta")
    model = model.to_empty(device=dev)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if log is not None:
        log(f"=> serving fresh-init '{arch}' weights on {dev} (no "
            f"checkpoint — bench/smoke mode, seed {seed})")
    return model.eval()
