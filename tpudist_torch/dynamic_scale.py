"""Dynamic loss scaling for float16 training (``--amp-dtype float16``).

Counterpart of flax's ``DynamicScale`` (``flax/training/dynamic_scale.py``,
flax 0.12.3), which tpudist keeps in its ``TrainState`` under
``--use_amp --amp-dtype float16`` (``tpudist/train.py:170-171``), and of
tpudist's ``ds_finite``/``ds_update`` (``tpudist/parallel/_common.py``).
The reference's recipe 3 is ``torch.cuda.amp``'s ``GradScaler``; tpudist
follows flax's rule, and so does the port:

- the scale starts at 65,536 with ``fin_steps`` 0;
- after a step whose gradients are all finite, ``fin_steps`` counts up, and
  once it *equals* ``growth_interval`` (2,000) when a finite step arrives
  the scale doubles (capped at f32's max) and ``fin_steps`` restarts at 0:
  the scale grows on the 2,001st finite step in a row, where
  ``GradScaler`` grows on the 2,000th;
- after a step with an inf or NaN gradient the scale halves (never below
  f32's smallest normal, ``tiny``) and ``fin_steps`` restarts at 0.

The arithmetic is flax's f32 arithmetic (``np.float32``), so the scale and
``fin_steps`` equal tpudist's exactly at every step. The scale stays a
power of two unless it reaches the f32 cap, so multiplying the loss by it
and dividing the gradients by it are exact.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

F32_TINY = float(np.finfo(np.float32).tiny)
F32_MAX = float(np.finfo(np.float32).max)


@dataclasses.dataclass
class DynamicScale:
    """flax's ``DynamicScale`` with its defaults. ``fin_steps`` and
    ``scale`` are the state a checkpoint carries; the other fields are
    the rule."""

    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    fin_steps: int = 0
    scale: float = 65536.0
    minimum_scale: float | None = F32_TINY

    def update(self, finite: bool) -> None:
        """flax's rule after one step's finite check, in place."""
        scale = np.float32(self.scale)
        grow = self.fin_steps == self.growth_interval
        with np.errstate(over="ignore"):
            if finite:
                if grow:
                    scale = np.minimum(scale * np.float32(self.growth_factor),
                                       np.float32(F32_MAX))
            else:
                scale = scale * np.float32(self.backoff_factor)
                if self.minimum_scale is not None:
                    scale = np.maximum(scale, np.float32(self.minimum_scale))
        self.scale = float(scale)
        self.fin_steps = 0 if (grow or not finite) else self.fin_steps + 1

    def state_dict(self) -> dict:
        """What tpudist's trainer writes for its ``DynamicScale``: its
        state is on the devices before any save (``_shard_state``), so
        ``fin_steps`` is an int32 and ``scale`` an f32 0-d array, stepped
        or not."""
        return {"fin_steps": np.asarray(self.fin_steps, np.int32),
                "scale": np.asarray(self.scale, np.float32)}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``fin_steps`` and ``scale`` from a checkpoint's
        ``dynamic_scale`` (numpy scalars, or the Python int and float of a
        state saved before it reached a device)."""
        if not isinstance(state, dict) or set(state) != {"fin_steps",
                                                         "scale"}:
            raise ValueError(f"a dynamic_scale holds fin_steps and scale, "
                             f"got {state!r}")
        self.fin_steps = int(np.asarray(state["fin_steps"]))
        self.scale = float(np.float32(np.asarray(state["scale"])))


def unscale_and_check(grads: list[torch.Tensor], scale: float,
                      accum: int = 1) -> bool:
    """Unscale a step's (reduced) f32 gradients in place, ``g / scale``
    then ``/ accum`` as tpudist divides its accumulated sum, and return
    whether every one is finite: flax's check, taken over every leaf after
    the unscale. One host read of the flag a step, as ``GradScaler.step``
    makes.

    Where the scale is a power of two of at least 1 (always, unless a run
    of overflows took it below 1 or growth reached the f32 cap), torch's
    fused check unscales in the same pass: ``g · (1/scale)`` is exactly
    ``g / scale``, and it is finite exactly where ``g`` is, so the check
    of ``g`` is flax's check of ``g / scale``. Otherwise the division
    comes first and the check follows it. Dividing by ``accum`` afterwards
    cannot change whether a value is finite."""
    if not grads:
        return True
    dev = grads[0].device
    fused = scale >= 1.0 and math.frexp(scale)[0] == 0.5
    if not fused:
        torch._foreach_div_(grads, scale)
    found = torch.zeros(1, dtype=torch.float32, device=dev)
    torch._amp_foreach_non_finite_check_and_unscale_(
        grads, found, torch.full((1,), 1.0 / scale if fused else 1.0,
                                 dtype=torch.float32, device=dev))
    if accum > 1:
        torch._foreach_div_(grads, float(accum))
    return not bool(found.item())
