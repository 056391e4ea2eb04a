"""A tpudist ViT's flax ``params`` tree → the port's ``state_dict``.

The tree comes as nested dicts of numpy arrays (what
``flax.serialization.to_state_dict`` or ``jax.device_get`` give); this
module needs neither. The port's parameter names mirror the flax paths,
so each leaf maps by name with at most a transpose:

- ``conv_proj/kernel`` ``(p, p, 3, D)`` HWIO → ``weight`` ``(D, 3, p, p)``;
- every ``Dense``'s ``kernel`` ``(in, out)`` → ``weight`` ``(out, in)``;
  ``in_proj`` keeps its head-major column order ``[h][q|k|v][head_dim]``;
- ``ln*/scale``, ``bias`` → ``weight``, ``bias``;
- ``class_token`` and ``pos_embedding`` as they are.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """Convert a flax ViT ``params`` tree (without the ``"params"`` level)
    to a ``state_dict`` that ``VisionTransformer.load_state_dict`` takes
    with ``strict=True``."""
    out: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        *mods, leaf = path
        arr = np.array(arr, dtype=np.float32)       # a writable copy
        if leaf == "kernel":
            if arr.ndim == 4:                       # HWIO conv
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:                     # Dense (in, out)
                arr = arr.T
            else:
                raise ValueError(f"unexpected kernel rank {arr.ndim} at "
                                 f"{'/'.join(path)}")
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf not in ("bias", "class_token", "pos_embedding"):
            raise ValueError(f"unexpected ViT parameter {'/'.join(path)}")
        out[".".join([*mods, leaf])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out
