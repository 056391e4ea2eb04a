"""Arch name → eval-mode serving model on the device (the export half of
``tpudist_torch.serve``).

Counterpart of ``tpudist/serve/export.py``. The model computes in the
compute dtype (bf16 by default) from f32 weights on the device: those of a
training checkpoint (a ``.msgpack`` file or a run dir, read by the port's
``checkpoint`` module, so tpudist's files serve too), the EMA copy when
the checkpoint carries one (the weights ``best`` was measured on), or
fresh weights drawn from ``seed`` (the bench/smoke path, where serving
performance is the measured quantity and the weights are irrelevant).
``image_size`` and ``flash`` reach a ViT (its position embedding and
attention) as the reference's do; every other family (the conv nets,
convnext, swin, maxvit) takes neither, and in eval mode their BatchNorm
epilogues are plain and their dropouts, stochastic depth and aux heads
idle (swin's and maxvit's biased attention is always plain), so such a
served model runs no kernel of the port and returns the main logits
alone. ``flash`` (default ``auto``) is resolved by
``resolve_serve_flash`` through ``ops/attention_dispatch`` at the eval
workload of the largest bucket, and the model is built with the verdict
in every mode.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpudist_torch import checkpoint as ckpt_lib
from tpudist_torch._device import resolve_device
from tpudist_torch.compat.jax_params import state_dict_from_jax
from tpudist_torch.models import create_model
from tpudist_torch.models.vit import VisionTransformer
from tpudist_torch.ops import attention_dispatch


def resolve_serve_flash(model, *, batch: int, mode: str = "auto",
                        device=None, telemetry=None,
                        log=None) -> Optional[dict]:
    """Resolve ``--flash`` for a served ViT: tpudist's
    ``resolve_serve_flash``, the trainer's attention dispatch with
    ``train=False`` and the largest bucket as the batch (the shape that
    dominates steady-state throughput). Sets the verdict on the model in
    every mode and returns the decision; None for a model without
    attention (the conv nets)."""
    if not isinstance(model, VisionTransformer):
        return None
    if mode not in attention_dispatch.MODES:
        raise ValueError(f"--flash must be on, off or auto, got {mode!r}")
    device = torch.device(device) if device is not None else \
        next(model.parameters()).device
    heads = model.num_heads
    dec = attention_dispatch.decide(
        batch, model.tokens, heads, model.hidden_dim // heads, model.dtype,
        train=False, mode=mode, platform=device.type, device=device)
    model.set_flash(dec["kernel"] == "flash")
    if log is not None:
        msg = (f"=> serve attention dispatch: {dec['kernel']} attention "
               f"(mode {dec['mode']}, {dec['source']}")
        if dec.get("reason"):
            msg += f": {dec['reason']}"
        if dec.get("flash_ms") is not None:
            msg += (f"; {dec['key']}: flash {dec['flash_ms']:.4f} ms vs "
                    f"plain {dec['plain_ms']:.4f} ms, margin "
                    f"{dec.get('margin', 0.0):.1%}")
        log(msg + ")")
    if telemetry is not None:
        telemetry.emit("attention_dispatch",
                       **attention_dispatch.event_fields(dec))
    return dec


def serving_variables(ckpt: dict, log=None) -> dict:
    """``{"params", "batch_stats"}`` of a checkpoint tree, the EMA copy
    when it carries one (``_extract_serving_variables``: a
    ``--model-ema-decay`` run measured its best_acc1 on the EMA)."""
    state = ckpt.get("state") or {}
    params = state.get("params")
    if params is None:
        raise ValueError("checkpoint has no state.params — not a tpudist "
                         "training checkpoint")
    batch_stats = state.get("batch_stats") or {}
    ema = state.get("ema_params")
    if isinstance(ema, dict) and ema.get("params"):
        if log is not None:
            log("=> serving the EMA weights (checkpoint carries "
                "ema_params — the copy 'best' was measured on)")
        params = ema["params"]
        batch_stats = ema.get("batch_stats") or batch_stats
    return {"params": params, "batch_stats": batch_stats}


def load_serve_state(arch: str, checkpoint: str = "", *,
                     num_classes: int = 1000, image_size: int = 224,
                     max_batch: int = 8, flash: str = "auto",
                     dtype=torch.bfloat16, seed: int = 0, device=None,
                     telemetry=None, log=None) -> torch.nn.Module:
    """Build the serving model: ``arch`` in ``dtype`` on ``device`` (the
    CUDA card unless the caller passes ``"cpu"``), in eval mode, with the
    weights of ``checkpoint`` (a file or a run dir; a checkpoint of
    another arch is refused) or, when it is empty, drawn from a
    ``torch.Generator`` seeded by ``seed``. A ViT's attention is resolved
    at batch ``max_batch`` (the largest bucket)."""
    dev = resolve_device(device)
    kw = dict(num_classes=num_classes, dtype=dtype, device="meta")
    if arch.startswith("vit"):
        kw.update(image_size=image_size)
    model = create_model(arch, **kw)
    model = model.to_empty(device=dev)
    resolve_serve_flash(model, batch=max_batch, mode=flash, device=dev,
                        telemetry=telemetry, log=log)
    if checkpoint:
        ckpt = ckpt_lib.load_checkpoint(checkpoint)
        if ckpt.get("arch") and ckpt["arch"] != arch:
            raise ValueError(
                f"checkpoint was trained as '{ckpt['arch']}' but serving "
                f"was asked for '{arch}' — refusing to apply mismatched "
                f"weights")
        v = serving_variables(ckpt, log=log)
        model.load_state_dict(state_dict_from_jax(
            arch, v["params"], v["batch_stats"]), strict=True)
        if log is not None:
            log(f"=> exported '{arch}' from {checkpoint} "
                f"(epoch {ckpt.get('epoch', '?')}, "
                f"best_acc1 {float(ckpt.get('best_acc1', 0.0)):.3f})")
        return model.eval()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if log is not None:
        log(f"=> serving fresh-init '{arch}' weights on {dev} (no "
            f"checkpoint — bench/smoke mode, seed {seed})")
    return model.eval()
