"""tpudist's flax ``params`` (and ``batch_stats``) trees ↔ the port's
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
- every other family (the BatchNorm conv nets, alexnet, squeezenet,
  mnasnet, shufflenet, efficientnet, convnext, swin, maxvit): BatchNorm
  and LayerNorm ``scale``/``bias`` (the port's ``layers.LayerNorm``
  keeps flax's names), a conv's or Dense's ``bias``, convnext's
  ``layer_scale``, swin's and maxvit's ``relative_position_bias_table``,
  swin v2's ``logit_scale`` and the ``batch_stats`` ``mean``/``var``
  keep their names and shapes.

``jax_leaves`` lists a model's leaves in the order ``jax.tree_util``
flattens tpudist's tree (every dict's keys sorted), so a rule that picks
"the first f32 leaf" or "the last 2-D leaf" of tpudist's ``params``
finds the same parameter in the port (the fault points ``bitflip`` and
``lossbomb``).

``jax_tree`` goes the other way, for the checkpoint writer: ``weight``
``(out, in, kh, kw)`` → HWIO ``kernel``, ``(out, in)`` → ``(in, out)``
``kernel``, a 1-D ``weight`` (the ViT's LayerNorm) → ``scale``. Its leaves
are transposed torch views of the port's tensors, on whatever device they
live; ``serialization`` copies each to the host in its logical C order
when it writes it (a 1x1 conv's channels_last weight included), so no
tree is copied whole.
"""

from __future__ import annotations

from typing import Mapping, Sequence

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


# The leaves other than ``kernel`` that keep their flax names.
_NAMED_LEAVES = ("scale", "bias", "layer_scale",
                 "relative_position_bias_table", "logit_scale")


def bn_net_state_dict_from_jax(params: Mapping, batch_stats: Mapping
                               ) -> dict[str, torch.Tensor]:
    """Convert a flax conv net's (or swin's, or maxvit's) ``params`` and
    ``batch_stats`` trees (without their collection level; a model
    without BatchNorm has none) to a ``state_dict`` that the port's model
    of the same arch takes with ``strict=True``: conv and Dense
    ``kernel`` → ``weight``, the rest by name."""
    out: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        *mods, leaf = path
        if leaf == "kernel":
            arr, leaf = _kernel(arr, path), "weight"
        elif leaf not in _NAMED_LEAVES:
            raise ValueError(f"unexpected conv-net parameter "
                             f"{'/'.join(path)}")
        out[".".join([*mods, leaf])] = _tensor(arr)
    for path, arr in _flatten(batch_stats):
        if path[-1] not in ("mean", "var"):
            raise ValueError(f"unexpected batch statistic {'/'.join(path)}")
        out[".".join(path)] = _tensor(arr)
    return out


# The ResNet family's converter is the same.
resnet_state_dict_from_jax = bn_net_state_dict_from_jax


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


def state_dict_from_jax(arch: str, params: Mapping,
                        batch_stats: Mapping | None = None
                        ) -> dict[str, torch.Tensor]:
    """The converter for ``arch``: ``vit*``, or any other family (a ViT,
    convnext or swin has no ``batch_stats``)."""
    if arch.startswith("vit"):
        return vit_state_dict_from_jax(params)
    return bn_net_state_dict_from_jax(params, batch_stats or {})


def _flax_leaf(name: str, t: torch.Tensor) -> tuple[tuple, torch.Tensor]:
    """A port name's flax path and the tensor in flax's layout (a view)."""
    *mods, leaf = name.split(".")
    if leaf == "weight":
        if t.ndim == 4:                           # conv → HWIO
            t, leaf = t.permute(2, 3, 1, 0), "kernel"
        elif t.ndim == 2:                         # Dense → (in, out)
            t, leaf = t.t(), "kernel"
        elif t.ndim == 1:                         # LayerNorm
            leaf = "scale"
        else:
            raise ValueError(f"unexpected weight rank {t.ndim} at {name}")
    return (*mods, leaf), t


def jax_tree(named: Mapping[str, torch.Tensor] | Sequence) -> dict:
    """Port names → the nested flax tree (the inverse of the converters
    above): ``layer1_0.conv1.weight`` is ``{"layer1_0": {"conv1":
    {"kernel": HWIO}}}``. ``named`` maps (or lists) names to tensors: a
    model's parameters, its float buffers, or per-parameter optimizer
    state keyed the same way."""
    tree: dict = {}
    for name, t in (named.items() if isinstance(named, Mapping) else named):
        (*mods, leaf), t = _flax_leaf(name, t)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = t
    return tree


def jax_leaves(named: Mapping[str, torch.Tensor] | Sequence
               ) -> list[tuple[str, str, torch.Tensor]]:
    """``(flax path, port name, flax-layout view)`` of every leaf of
    ``jax_tree(named)``, in ``jax.tree_util.tree_flatten``'s order (depth
    first, each dict's keys sorted: the paths' order). The view's element
    ``[0, ..., 0]`` is the tensor's, and an in-place op on the view acts
    on the tensor."""
    leaves = [(*_flax_leaf(name, t), name) for name, t in
              (named.items() if isinstance(named, Mapping) else named)]
    return [("/".join(path), name, view)
            for path, view, name in sorted(leaves, key=lambda e: e[0])]
