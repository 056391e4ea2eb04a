"""Where the port's entry points run: the CUDA card unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device that is not present raises
    ``RuntimeError``; the CPU is used only when the caller passes
    ``device="cpu"`` (as the tests do). Nothing falls back. A bare
    ``"cuda"`` comes back with the current card's index: the card a
    data-parallel rank bound (``dist.initialize_runtime``), ``cuda:0``
    otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpudist_torch runs on a CUDA device and none is available; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
