"""tpudist's flax ``params`` (and ``batch_stats``) trees → the port's
``state_dict``.

The trees come as nested dicts of numpy arrays (what
``flax.serialization.to_state_dict`` or ``jax.device_get`` give); this
module needs neither. The port's parameter names mirror the flax paths,
so each leaf maps by name with at most a transpose:

- a conv ``kernel`` ``(kh, kw, in, out)`` HWIO → ``weight``
  ``(out, in, kh, kw)``;
- every ``Dense``'s ``kernel`` ``(in, out)`` → ``weight`` ``(out, in)``;
  the ViT's ``in_proj`` keeps its head-major column order
  ``[h][q|k|v][head_dim]``;
- ViT: ``ln*/scale``, ``bias`` → ``weight``, ``bias``; ``class_token`` and
  ``pos_embedding`` as they are;
- ResNet: BatchNorm ``scale``/``bias`` and the ``batch_stats``
  ``mean``/``var`` keep their names.
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
        if leaf == "kernel":
            arr, leaf = _kernel(arr, path), "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf not in ("bias", "class_token", "pos_embedding"):
            raise ValueError(f"unexpected ViT parameter {'/'.join(path)}")
        out[".".join([*mods, leaf])] = _tensor(arr)
    return out


def resnet_state_dict_from_jax(params: Mapping, batch_stats: Mapping
                               ) -> dict[str, torch.Tensor]:
    """Convert a flax ResNet's ``params`` and ``batch_stats`` trees
    (without their collection level) to a ``state_dict`` that
    ``ResNet.load_state_dict`` takes with ``strict=True``."""
    out: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        *mods, leaf = path
        if leaf == "kernel":
            arr, leaf = _kernel(arr, path), "weight"
        elif leaf not in ("scale", "bias"):
            raise ValueError(f"unexpected ResNet parameter {'/'.join(path)}")
        out[".".join([*mods, leaf])] = _tensor(arr)
    for path, arr in _flatten(batch_stats):
        if path[-1] not in ("mean", "var"):
            raise ValueError(f"unexpected batch statistic {'/'.join(path)}")
        out[".".join(path)] = _tensor(arr)
    return out


def _kernel(arr: np.ndarray, path: tuple) -> np.ndarray:
    if arr.ndim == 4:                               # HWIO conv
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2:                               # Dense (in, out)
        return arr.T
    raise ValueError(f"unexpected kernel rank {arr.ndim} at "
                     f"{'/'.join(path)}")


def _tensor(arr: np.ndarray) -> torch.Tensor:
    # np.array copies: a writable, C-ordered f32 array torch can own.
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
