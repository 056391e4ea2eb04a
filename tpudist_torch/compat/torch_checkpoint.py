"""The reference's ``.pth.tar`` files, in and out of the port.

The port's copy of ``tpudist/compat/torch_checkpoint.py`` for every
family the port has: ``resnet``, ``resnext``, ``wide_resnet``, ``vit``,
``alexnet``, ``vgg``, ``squeezenet``, ``densenet``, ``googlenet``,
``inception``, ``mobilenet``, ``mnasnet``, ``shufflenet``, ``regnet``,
``efficientnet``, ``convnext``, ``swin`` and ``maxvit``. The reference
saves ``{"epoch", "arch", "state_dict", "best_acc1"}`` with
``torch.save`` (``checkpoint.pth.tar``,
``model_best.pth.tar``), the ``state_dict`` in torchvision's names and
layouts. The port's parameter names are flax's paths
(``compat/jax_params``), so each direction goes through the flax tree
and applies tpudist's translation to it, which makes the port's file
tpudist's for the same weights:

- names: ``layer1_0.bn1.scale`` ↔ ``layer1.0.bn1.weight``, ``mean``/
  ``var`` ↔ ``running_mean``/``running_var``, ``downsample_conv``/
  ``downsample_bn`` ↔ ``downsample.0``/``.1``; the ViT's
  ``encoder_layer_N`` ↔ ``encoder.layers.encoder_layer_N``, ``mlp_0``/
  ``mlp_3`` ↔ ``mlp.0``/``.3``, ``head`` ↔ ``heads.head``,
  ``pos_embedding`` ↔ ``encoder.pos_embedding``;
- the ViT's ``in_proj`` is head-major (``[h][q|k|v][head_dim]``),
  torch's ``in_proj_weight`` qkv-major: ``_vit_inproj_perm`` maps one to
  the other;
- vgg: ``features_N``/``classifier_N`` ↔ ``features.N``/
  ``classifier.N``; densenet: the flax names under ``features.`` with
  ``denseblockB.denselayerL.`` and ``transitionT.`` dotted (a file in
  torchvision's legacy names, ``norm.1`` for ``norm1``, as its released
  weights, is read as torchvision's own loader reads it); googlenet and
  inception_v3: torchvision's names with ``_`` for ``.``, with rules for
  the names that hold a ``_`` of their own (``Conv2d_1a_3x3``,
  ``branch3x3dbl_1``); mobilenet: a table built from the block configs
  (torchvision's nested ``features.i.block.j`` indices depend on whether a
  block expands and has SE); regnet: ``trunk_output.blockS.blockS-I.f.a.0``
  ↔ ``blockS_I_f_a_conv``, the stem ``stem.0``/``.1``. A googlenet file
  with aux-head weights loads into the default model without aux heads
  (torchvision's released weights carry them), as in tpudist;
- alexnet and squeezenet: ``features_N``/``classifier_N`` (squeezenet's
  Fire children dotted: ``features.3.squeeze``); efficientnet, convnext,
  mnasnet, shufflenet and maxvit: tables built from the block configs, as
  tpudist's; swin: rules over ``features.S.I.attn.qkv`` and the like.
  convnext's ``layer_scale`` is (C,) in the port and (C, 1, 1) in the
  file; swin's qkv is head-major in the port and qkv-major in the file
  (the ViT's permutation, with each stage's head count); the bias tables
  and swin v2's ``logit_scale`` keep their layout, and the index and
  coordinate buffers torchvision registers beside them are written from
  the window size on export and skipped on import;
- ``num_batches_tracked`` is written as 0 and dropped on import;
- the file holds contiguous tensors in torch's layout whatever the
  strides of the port's weights (a 1x1 conv's are channels_last).

An import is strict: a missing tensor, an unknown one, or one of another
shape raises, naming it. Any other family raises, naming these.
"""

from __future__ import annotations

import math
import os
import re
from functools import lru_cache
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tpudist_torch.compat.jax_params import jax_tree, state_dict_from_jax

SUPPORTED_FAMILIES = ("resnet", "resnext", "wide_resnet", "alexnet", "vgg",
                      "squeezenet", "densenet", "efficientnet", "convnext",
                      "regnet", "swin", "mobilenet", "mnasnet", "shufflenet",
                      "googlenet", "inception", "vit", "maxvit")
# torchvision's buffers of swin (and maxvit) that the port computes.
_DERIVED_BUFFERS = ("relative_position_index", "relative_coords_table")


@lru_cache(maxsize=None)
def _mobilenet_map(arch: str) -> Dict[str, str]:
    """torch module → flax module for MobileNetV2/V3 (tpudist's table):
    torchvision nests the inverted residuals in Sequentials whose indices
    depend on whether the block expands (V2: ``features.{i}.conv.{j}``)
    and whether it has SE (V3: ``features.{i}.block.{j}``); the port's
    blocks are flat ``features_{i}_{expand,dw,se,project}``."""
    from tpudist_torch.models.mobilenet import _V2_CFG, _V3_LARGE, _V3_SMALL
    m = {"features.0.0": "features_0_conv", "features.0.1": "features_0_bn"}
    if arch == "mobilenet_v2":
        i = 1
        for t, _c, n, _s in _V2_CFG:
            for _j in range(n):
                tp, f = f"features.{i}.conv", f"features_{i}"
                k = 0
                if t != 1:                      # expand iff ratio > 1
                    m[f"{tp}.0.0"] = f"{f}_expand_conv"
                    m[f"{tp}.0.1"] = f"{f}_expand_bn"
                    k = 1
                m[f"{tp}.{k}.0"] = f"{f}_dw_conv"
                m[f"{tp}.{k}.1"] = f"{f}_dw_bn"
                m[f"{tp}.{k + 1}"] = f"{f}_project_conv"   # bare conv + BN
                m[f"{tp}.{k + 2}"] = f"{f}_project_bn"
                i += 1
        m[f"features.{i}.0"] = f"features_{i}_conv"
        m[f"features.{i}.1"] = f"features_{i}_bn"
        m["classifier.1"] = "classifier_1"
        return m
    if arch not in ("mobilenet_v3_large", "mobilenet_v3_small"):
        raise ValueError(f"unknown mobilenet variant '{arch}'")
    cfg = _V3_LARGE if arch == "mobilenet_v3_large" else _V3_SMALL
    c_in = 16
    for i, (_k, exp, out, se, _nl, _s) in enumerate(cfg, start=1):
        tp, f = f"features.{i}.block", f"features_{i}"
        j = 0
        if exp != c_in:                         # expand iff widened
            m[f"{tp}.0.0"] = f"{f}_expand_conv"
            m[f"{tp}.0.1"] = f"{f}_expand_bn"
            j = 1
        m[f"{tp}.{j}.0"] = f"{f}_dw_conv"
        m[f"{tp}.{j}.1"] = f"{f}_dw_bn"
        j += 1
        if se:
            m[f"{tp}.{j}.fc1"] = f"{f}_se_fc1"
            m[f"{tp}.{j}.fc2"] = f"{f}_se_fc2"
            j += 1
        m[f"{tp}.{j}.0"] = f"{f}_project_conv"
        m[f"{tp}.{j}.1"] = f"{f}_project_bn"
        c_in = out
    n = len(cfg) + 1
    m[f"features.{n}.0"] = f"features_{n}_conv"
    m[f"features.{n}.1"] = f"features_{n}_bn"
    m["classifier.0"] = "classifier_0"
    m["classifier.3"] = "classifier_3"
    return m


@lru_cache(maxsize=None)
def _efficientnet_map(arch: str) -> Dict[str, str]:
    """torch module → flax module for EfficientNet v1/v2 (tpudist's
    table): torchvision nests each block in ``features.{s}.{i}.block.{j}``,
    ``j`` depending on whether the block expands; the port's blocks are
    flat ``features_{s}_{i}_{expand,dw,se,project}`` (fused: ``fused``,
    ``project``)."""
    from tpudist_torch.models.efficientnet import (_BASE, _V2_TABLES,
                                                   _VARIANTS)
    if arch in _V2_TABLES:
        stages = [(kind, ratio != 1, n)
                  for kind, ratio, _k, _s, _ci, _co, n in _V2_TABLES[arch]]
    elif arch in _VARIANTS:
        depth = _VARIANTS[arch][1]
        stages = [("mb", ratio != 1, int(math.ceil(n * depth)))
                  for ratio, _k, _s, _ci, _co, n in _BASE]
    else:
        raise ValueError(f"unknown efficientnet variant '{arch}'")
    m = {"features.0.0": "features_0_conv", "features.0.1": "features_0_bn",
         "classifier.1": "classifier_1"}
    for s, (kind, has_expand, n) in enumerate(stages, start=1):
        for i in range(n):
            t, f = f"features.{s}.{i}.block", f"features_{s}_{i}"
            if kind == "mb":
                j = 0
                if has_expand:
                    m[f"{t}.0.0"] = f"{f}_expand_conv"
                    m[f"{t}.0.1"] = f"{f}_expand_bn"
                    j = 1
                m[f"{t}.{j}.0"] = f"{f}_dw_conv"
                m[f"{t}.{j}.1"] = f"{f}_dw_bn"
                m[f"{t}.{j + 1}.fc1"] = f"{f}_se_fc1"
                m[f"{t}.{j + 1}.fc2"] = f"{f}_se_fc2"
                m[f"{t}.{j + 2}.0"] = f"{f}_project_conv"
                m[f"{t}.{j + 2}.1"] = f"{f}_project_bn"
            else:
                m[f"{t}.0.0"] = f"{f}_fused_conv"
                m[f"{t}.0.1"] = f"{f}_fused_bn"
                if has_expand:
                    m[f"{t}.1.0"] = f"{f}_project_conv"
                    m[f"{t}.1.1"] = f"{f}_project_bn"
    h = len(stages) + 1
    m[f"features.{h}.0"] = f"features_{h}_conv"
    m[f"features.{h}.1"] = f"features_{h}_bn"
    return m


@lru_cache(maxsize=None)
def _convnext_map(arch: str) -> Dict[str, str]:
    """torch module → flax module for ConvNeXt (torchvision's CNBlock
    indices: ``block.0`` the depthwise conv, ``block.2`` the LayerNorm,
    ``block.3``/``.5`` the MLP; the block itself holds ``layer_scale``;
    a downsampler is a LayerNorm and a conv)."""
    from tpudist_torch.models.convnext import _VARIANTS
    if arch not in _VARIANTS:
        raise ValueError(f"unknown convnext variant '{arch}'")
    m = {"features.0.0": "features_0_conv", "features.0.1": "features_0_norm",
         "classifier.0": "classifier_0", "classifier.2": "classifier_2"}
    feat = 1
    for _cin, cout, n in _VARIANTS[arch][0]:
        for i in range(n):
            t, f = f"features.{feat}.{i}", f"features_{feat}_{i}"
            m[f"{t}.block.0"] = f"{f}_dwconv"
            m[f"{t}.block.2"] = f"{f}_norm"
            m[f"{t}.block.3"] = f"{f}_mlp_fc1"
            m[f"{t}.block.5"] = f"{f}_mlp_fc2"
            m[t] = f
        feat += 1
        if cout is not None:
            m[f"features.{feat}.0"] = f"features_{feat}_norm"
            m[f"features.{feat}.1"] = f"features_{feat}_conv"
            feat += 1
    return m


@lru_cache(maxsize=None)
def _mnasnet_map(arch: str) -> Dict[str, str]:
    """torch module → flax module for MnasNet: torchvision's trunk is one
    flat ``layers`` Sequential with the six stacks at 8–13, each block an
    ``_InvertedResidual.layers`` Sequential."""
    m = {"layers.0": "stem", "layers.1": "stem_bn",
         "layers.3": "sep_dw", "layers.4": "sep_dw_bn",
         "layers.6": "sep_pw", "layers.7": "sep_pw_bn",
         "layers.14": "head", "layers.15": "head_bn",
         "classifier.1": "classifier_1"}
    for si, r in enumerate((3, 3, 3, 2, 4, 1)):
        for j in range(r):
            t, f = f"layers.{8 + si}.{j}.layers", f"stack{si}_{j}"
            for tn, fn in (("0", "expand"), ("1", "expand_bn"),
                           ("3", "dw"), ("4", "dw_bn"),
                           ("6", "project"), ("7", "project_bn")):
                m[f"{t}.{tn}"] = f"{f}_{fn}"
    return m


@lru_cache(maxsize=None)
def _shufflenet_map(arch: str) -> Dict[str, str]:
    """torch module → flax module for ShuffleNetV2 (stage repeats (4, 8,
    4) at every width; ``branch1`` only in a stage's stride-2 unit)."""
    m = {"conv1.0": "conv1", "conv1.1": "conv1_bn",
         "conv5.0": "conv5", "conv5.1": "conv5_bn", "fc": "fc"}
    for si, r in zip((2, 3, 4), (4, 8, 4)):
        for j in range(r):
            t, f = f"stage{si}.{j}", f"stage{si}_{j}"
            if j == 0:
                m[f"{t}.branch1.0"] = f"{f}_b1_dw"
                m[f"{t}.branch1.1"] = f"{f}_b1_dw_bn"
                m[f"{t}.branch1.2"] = f"{f}_b1_conv"
                m[f"{t}.branch1.3"] = f"{f}_b1_conv_bn"
            m[f"{t}.branch2.0"] = f"{f}_b2_conv1"
            m[f"{t}.branch2.1"] = f"{f}_b2_conv1_bn"
            m[f"{t}.branch2.3"] = f"{f}_b2_dw"
            m[f"{t}.branch2.4"] = f"{f}_b2_dw_bn"
            m[f"{t}.branch2.5"] = f"{f}_b2_conv2"
            m[f"{t}.branch2.6"] = f"{f}_b2_conv2_bn"
    return m


@lru_cache(maxsize=None)
def _maxvit_map(arch: str) -> Dict[str, str]:
    """torch module → flax module for MaxViT-T (torchvision's
    ``blocks.{s}.layers.{i}.layers.{MBconv,window_attention,
    grid_attention}``)."""
    if arch != "maxvit_t":
        raise ValueError(f"unknown maxvit variant '{arch}'")
    m = {"stem.0.0": "stem_0", "stem.0.1": "stem_0_bn", "stem.1.0": "stem_1",
         "classifier.2": "classifier_2", "classifier.3": "classifier_3",
         "classifier.5": "classifier_5"}
    for s, n in enumerate((2, 2, 5, 2)):
        for i in range(n):
            t, f = f"blocks.{s}.layers.{i}.layers", f"block_{s}_{i}"
            mb = f"{t}.MBconv"
            m[f"{mb}.layers.pre_norm"] = f"{f}_mbconv_pre_norm"
            m[f"{mb}.layers.conv_a.0"] = f"{f}_mbconv_conv_a"
            m[f"{mb}.layers.conv_a.1"] = f"{f}_mbconv_conv_a_bn"
            m[f"{mb}.layers.conv_b.0"] = f"{f}_mbconv_conv_b"
            m[f"{mb}.layers.conv_b.1"] = f"{f}_mbconv_conv_b_bn"
            m[f"{mb}.layers.squeeze_excitation.fc1"] = \
                f"{f}_mbconv_squeeze_excitation_fc1"
            m[f"{mb}.layers.squeeze_excitation.fc2"] = \
                f"{f}_mbconv_squeeze_excitation_fc2"
            m[f"{mb}.layers.conv_c"] = f"{f}_mbconv_conv_c"
            if i == 0:
                m[f"{mb}.proj.1"] = f"{f}_mbconv_proj"
            for part, tp in (("window", "window_attention"),
                             ("grid", "grid_attention")):
                pa = f"{t}.{tp}"
                m[f"{pa}.attn_layer.0"] = f"{f}_{part}_attn_norm"
                m[f"{pa}.attn_layer.1.to_qkv"] = f"{f}_{part}_attn_to_qkv"
                m[f"{pa}.attn_layer.1.merge"] = f"{f}_{part}_attn_merge"
                m[f"{pa}.attn_layer.1"] = f"{f}_{part}_attn"
                m[f"{pa}.mlp_layer.0"] = f"{f}_{part}_mlp_norm"
                m[f"{pa}.mlp_layer.1"] = f"{f}_{part}_mlp_0"
                m[f"{pa}.mlp_layer.3"] = f"{f}_{part}_mlp_2"
    return m


_MAP_FAMILIES = {"mobilenet": _mobilenet_map,
                 "efficientnet": _efficientnet_map,
                 "convnext": _convnext_map, "mnasnet": _mnasnet_map,
                 "shufflenet": _shufflenet_map, "maxvit": _maxvit_map}
_SWIN_TO_FLAX = (
    (r"^features\.0\.0$", "features_0_conv"),
    (r"^features\.0\.2$", "features_0_norm"),   # Sequential(conv, Permute, LN)
    (r"^features\.(\d+)\.(\d+)\.attn\.cpb_mlp\.(0|2)$",
     r"features_\1_\2_attn_cpb_mlp_\3"),
    (r"^features\.(\d+)\.(\d+)\.attn\.(qkv|proj)$", r"features_\1_\2_attn_\3"),
    (r"^features\.(\d+)\.(\d+)\.attn$", r"features_\1_\2_attn"),
    (r"^features\.(\d+)\.(\d+)\.(norm1|norm2)$", r"features_\1_\2_\3"),
    (r"^features\.(\d+)\.(\d+)\.mlp\.(0|3)$", r"features_\1_\2_mlp_\3"),
    (r"^features\.(\d+)\.(reduction|norm)$", r"features_\1_\2"),
    (r"^norm$", "norm"), (r"^head$", "head"),
)
_SWIN_FROM_FLAX = (
    (r"^features_0_conv$", "features.0.0"),
    (r"^features_0_norm$", "features.0.2"),
    (r"^features_(\d+)_(\d+)_attn_cpb_mlp_(0|2)$",
     r"features.\1.\2.attn.cpb_mlp.\3"),
    (r"^features_(\d+)_(\d+)_attn_(qkv|proj)$", r"features.\1.\2.attn.\3"),
    (r"^features_(\d+)_(\d+)_attn$", r"features.\1.\2.attn"),
    (r"^features_(\d+)_(\d+)_(norm1|norm2)$", r"features.\1.\2.\3"),
    (r"^features_(\d+)_(\d+)_mlp_(0|3)$", r"features.\1.\2.mlp.\3"),
    (r"^features_(\d+)_(reduction|norm)$", r"features.\1.\2"),
    (r"^norm$", "norm"), (r"^head$", "head"),
)

_REGNET_TO_FLAX = (
    (r"^stem\.0$", "stem_conv"), (r"^stem\.1$", "stem_bn"),
    (r"^trunk_output\.block(\d+)\.block\1-(\d+)\.f\.(a|b|c)\.0$",
     r"block\1_\2_f_\3_conv"),
    (r"^trunk_output\.block(\d+)\.block\1-(\d+)\.f\.(a|b|c)\.1$",
     r"block\1_\2_f_\3_bn"),
    (r"^trunk_output\.block(\d+)\.block\1-(\d+)\.f\.se\.(fc1|fc2)$",
     r"block\1_\2_f_se_\3"),
    (r"^trunk_output\.block(\d+)\.block\1-(\d+)\.proj\.0$",
     r"block\1_\2_proj_conv"),
    (r"^trunk_output\.block(\d+)\.block\1-(\d+)\.proj\.1$",
     r"block\1_\2_proj_bn"),
    (r"^fc$", "fc"),
)
_REGNET_FROM_FLAX = (
    (r"^stem_conv$", "stem.0"), (r"^stem_bn$", "stem.1"),
    (r"^block(\d+)_(\d+)_f_(a|b|c)_conv$",
     r"trunk_output.block\1.block\1-\2.f.\3.0"),
    (r"^block(\d+)_(\d+)_f_(a|b|c)_bn$",
     r"trunk_output.block\1.block\1-\2.f.\3.1"),
    (r"^block(\d+)_(\d+)_f_se_(fc1|fc2)$",
     r"trunk_output.block\1.block\1-\2.f.se.\3"),
    (r"^block(\d+)_(\d+)_proj_conv$",
     r"trunk_output.block\1.block\1-\2.proj.0"),
    (r"^block(\d+)_(\d+)_proj_bn$",
     r"trunk_output.block\1.block\1-\2.proj.1"),
    (r"^fc$", "fc"),
)
# GoogLeNet / Inception3: the flax names are torch's with "." → "_"
# (BasicConv2d keeps torchvision's conv/bn children), so the import is the
# generic rewrite; the export needs rules, because torch's names hold
# literal underscores (Conv2d_1a_3x3, branch3x3dbl_1, aux1).
_DOTS_TO_UNDERSCORES = ((r"\.", "_"), (r"^(fc)$", r"\1"))
_GOOGLENET_FROM_FLAX = (
    (r"^(conv[123])_(conv|bn)$", r"\1.\2"),
    (r"^(inception\d[a-e])_(branch\d)_(\d)_(conv|bn)$", r"\1.\2.\3.\4"),
    (r"^(inception\d[a-e])_(branch\d)_(conv|bn)$", r"\1.\2.\3"),
    (r"^(aux[12])_conv_(conv|bn)$", r"\1.conv.\2"),
    (r"^(aux[12])_(fc[12])$", r"\1.\2"),
    (r"^fc$", "fc"),
)
_INCEPTION_FROM_FLAX = (
    (r"^(Conv2d_\d\w_\dx\d)_(conv|bn)$", r"\1.\2"),
    (r"^(Mixed_\d[a-e])_(.+)_(conv|bn)$", r"\1.\2.\3"),
    (r"^AuxLogits_(conv\d)_(conv|bn)$", r"AuxLogits.\1.\2"),
    (r"^AuxLogits_fc$", "AuxLogits.fc"),
    (r"^fc$", "fc"),
)
# torchvision's densenet loader renames the legacy ``norm.1``-style keys
# of its released files (``denselayerL.norm.1.weight`` → ``norm1.weight``).
_DENSENET_LEGACY = re.compile(
    r"^(.*denselayer\d+\.(?:norm|relu|conv))\.((?:[12])\.(?:weight|bias|"
    r"running_mean|running_var))$")

_VIT_TO_FLAX = (
    (r"^conv_proj$", "conv_proj"),
    (r"^encoder\.layers\.(encoder_layer_\d+)\.self_attention\.out_proj$",
     r"\1_self_attention_out_proj"),
    (r"^encoder\.layers\.(encoder_layer_\d+)\.self_attention$",
     r"\1_self_attention_in_proj"),        # in_proj_{weight,bias} live here
    (r"^encoder\.layers\.(encoder_layer_\d+)\.(ln_1|ln_2)$", r"\1_\2"),
    (r"^encoder\.layers\.(encoder_layer_\d+)\.mlp\.(0|3)$", r"\1_mlp_\2"),
    (r"^encoder\.ln$", "ln"),
    (r"^heads\.head$", "head"),
)
_VIT_FROM_FLAX = (
    (r"^conv_proj$", "conv_proj"),
    (r"^(encoder_layer_\d+)_self_attention_out_proj$",
     r"encoder.layers.\1.self_attention.out_proj"),
    (r"^(encoder_layer_\d+)_self_attention_in_proj$",
     r"encoder.layers.\1.self_attention"),
    (r"^(encoder_layer_\d+)_(ln_1|ln_2)$", r"encoder.layers.\1.\2"),
    (r"^(encoder_layer_\d+)_mlp_(0|3)$", r"encoder.layers.\1.mlp.\2"),
    (r"^ln$", "encoder.ln"),
    (r"^head$", "heads.head"),
)


def family(arch: str) -> str:
    """The torchvision family of ``arch``; raises for one the port's
    interop does not cover (tpudist's vit_moe and vit_pipe, with
    tpudist's reason)."""
    if arch.startswith(("vit_moe", "vit_pipe")):
        raise ValueError(
            f"arch '{arch}' is a tpudist-native architecture with no "
            f"torchvision counterpart — torch-checkpoint interop does not "
            f"apply (use the msgpack backend)")
    for fam in SUPPORTED_FAMILIES:
        if arch.startswith(fam):
            return fam
    raise ValueError(
        f"torch-checkpoint interop in tpudist_torch does not support arch "
        f"'{arch}'; supported families: {', '.join(SUPPORTED_FAMILIES)}")


def _vit_inproj_perm(dim: int, heads: int) -> np.ndarray:
    """``perm[c]`` is the row of torch's qkv-major ``in_proj_weight``
    (3D, D) that feeds column ``c`` of the head-major flax kernel (D,
    3D): kernel = torch_w[perm].T."""
    hd = dim // heads
    h = np.arange(3 * dim) // (3 * hd)          # head of each column
    j = (np.arange(3 * dim) // hd) % 3          # q/k/v of each column
    d = np.arange(3 * dim) % hd
    return j * dim + h * hd + d


def _swin_heads(arch: str, mod: str) -> int:
    """The head count of a swin attention module: torchvision interleaves
    the stages with PatchMerging in ``features`` (stages at 1, 3, 5, 7),
    so feature index s is stage (s − 1) // 2."""
    from tpudist_torch.models.swin import _VARIANTS
    m = re.match(r"features_(\d+)_", mod)
    if m is None:
        raise ValueError(f"cannot locate the swin stage of '{mod}'")
    return _VARIANTS[arch][2][(int(m.group(1)) - 1) // 2]


def _apply_rules(rules, name: str) -> Optional[str]:
    for pat, repl in rules:
        new, n = re.subn(pat, repl, name)
        if n:
            return new
    return None


_REGEX_FAMILIES = {"regnet": (_REGNET_TO_FLAX, _REGNET_FROM_FLAX),
                   "swin": (_SWIN_TO_FLAX, _SWIN_FROM_FLAX),
                   "googlenet": (_DOTS_TO_UNDERSCORES, _GOOGLENET_FROM_FLAX),
                   "inception": (_DOTS_TO_UNDERSCORES, _INCEPTION_FROM_FLAX),
                   "vit": (_VIT_TO_FLAX, _VIT_FROM_FLAX)}


def _translate_module(fam: str, module: str, arch: str) -> str:
    """torch module path → the flax module path joined with ``_``."""
    if fam in _MAP_FAMILIES:
        return _MAP_FAMILIES[fam](arch).get(module, f"<unmapped:{module}>")
    if fam in _REGEX_FAMILIES:
        out = _apply_rules(_REGEX_FAMILIES[fam][0], module)
        return out if out is not None else f"<unmapped:{module}>"
    if fam == "densenet":
        module = re.sub(r"^features\.", "", module)
    module = module.replace("downsample.0", "downsample_conv")
    module = module.replace("downsample.1", "downsample_bn")
    return module.replace(".", "_")


def _untranslate(fam: str, mod: str, arch: str) -> str:
    """The flax module path joined with ``_`` → torch's module path."""
    if fam in _MAP_FAMILIES:
        inverse = {v: k for k, v in _MAP_FAMILIES[fam](arch).items()}
        if mod not in inverse:
            raise ValueError(f"no torch name for module '{mod}' (arch "
                             f"'{arch}')")
        return inverse[mod]
    if fam in _REGEX_FAMILIES:
        out = _apply_rules(_REGEX_FAMILIES[fam][1], mod)
        if out is None:
            raise ValueError(f"no torch name for module '{mod}' (arch "
                             f"'{arch}')")
        return out
    if fam == "densenet":
        if not mod.startswith("classifier"):
            mod = "features_" + mod
        mod = re.sub(r"(denseblock\d+)_(denselayer\d+)_", r"\1.\2.", mod)
        mod = re.sub(r"features_", "features.", mod)
        return re.sub(r"(transition\d+)_", r"\1.", mod)
    if fam in ("alexnet", "vgg", "squeezenet"):
        mod = re.sub(r"^(features|classifier)_(\d+)", r"\1.\2", mod)
        # squeezenet's Fire children: features.3_squeeze → .squeeze
        return mod.replace("_", ".") if fam == "squeezenet" else mod
    m = re.match(r"^(layer\d+)_(\d+)_(.*)$", mod)
    if m:
        mod = f"{m.group(1)}.{m.group(2)}.{m.group(3)}"
    mod = mod.replace("downsample_conv", "downsample.0")
    return mod.replace("downsample_bn", "downsample.1")


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[tuple, Any]:
    out: Dict[tuple, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: Dict[tuple, Any]) -> dict:
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _heads(fam: str, heads: Optional[int], arch: str) -> Optional[int]:
    if fam == "vit" and not heads:
        raise ValueError(f"'{arch}': the ViT's head count is needed to "
                         f"reorder its packed qkv")
    return heads


def torch_state_dict_to_flax(state_dict: Dict[str, Any], arch: str,
                             params_template: Any,
                             batch_stats_template: Any,
                             heads: Optional[int] = None
                             ) -> tuple[dict, dict]:
    """A torchvision-named ``state_dict`` → ``(params, batch_stats)``
    flax trees of numpy arrays shaped like the templates (any leaves with
    a ``shape``); ``heads`` is a ViT's head count. Raises on any missing,
    unknown or misshapen tensor."""
    fam = family(arch)
    heads = _heads(fam, heads, arch)
    p_flat = _flatten(params_template)
    s_flat = _flatten(batch_stats_template)
    p_index = {"_".join(path[:-1]): path for path in p_flat}
    s_index = {"_".join(path[:-1]): path for path in s_flat}
    new_p: Dict[tuple, np.ndarray] = {}
    new_s: Dict[tuple, np.ndarray] = {}
    for key, tensor in state_dict.items():
        if key.endswith("num_batches_tracked") \
                or key.endswith(_DERIVED_BUFFERS):
            continue
        if fam == "densenet":
            key = _DENSENET_LEGACY.sub(r"\1\2", key)
        # A DataParallel/DDP-saved file prefixes "module."; the ViT's
        # class_token is a root parameter with no module.
        module, _, param = key.removeprefix("module.").rpartition(".")
        arr = _to_numpy(tensor)
        if fam == "vit" and param in ("class_token", "pos_embedding"):
            path = (param,)
            template = p_flat.get(path)
            if template is None:
                raise ValueError(f"'{key}' maps to {path}, not in the model")
            if tuple(template.shape) != tuple(arr.shape):
                raise ValueError(
                    f"shape mismatch for '{key}': torch {tuple(arr.shape)}, "
                    f"model wants {tuple(template.shape)}")
            new_p[path] = arr
            continue
        if fam == "googlenet" and module.startswith(("aux1", "aux2")) \
                and "aux1_fc1" not in p_index:
            # torchvision's released googlenet carries aux-head weights its
            # model (aux_logits=False) discards; so does this one.
            continue
        mod = _translate_module(fam, module, arch)
        if mod not in p_index and mod not in s_index:
            raise ValueError(
                f"checkpoint key '{key}' (module '{mod}') does not match any "
                f"parameter of arch '{arch}' — is the checkpoint for a "
                f"different architecture or torchvision version?")
        if param == "running_mean":
            path = s_index[mod][:-1] + ("mean",)
            new_s[path] = arr
        elif param == "running_var":
            path = s_index[mod][:-1] + ("var",)
            new_s[path] = arr
        elif param == "layer_scale":                   # (C, 1, 1) → (C,)
            path = p_index[mod][:-1] + ("layer_scale",)
            new_p[path] = arr.reshape(-1)
        elif param in ("relative_position_bias_table", "logit_scale"):
            path = p_index[mod][:-1] + (param,)
            new_p[path] = arr
        elif fam == "swin" and mod.endswith("_attn_qkv"):
            # torchvision packs qkv-major; the port's kernel is head-major.
            perm = _vit_inproj_perm(arr.shape[-1] if param == "weight"
                                    else arr.shape[0] // 3,
                                    _swin_heads(arch, mod))
            if param == "weight":
                path = p_index[mod][:-1] + ("kernel",)
                new_p[path] = np.ascontiguousarray(arr[perm].T)
            else:
                path = p_index[mod][:-1] + ("bias",)
                new_p[path] = arr[perm]
        elif param == "in_proj_weight":                # vit packed qkv
            perm = _vit_inproj_perm(arr.shape[1], heads)
            path = p_index[mod][:-1] + ("kernel",)
            new_p[path] = np.ascontiguousarray(arr[perm].T)
        elif param == "in_proj_bias":
            perm = _vit_inproj_perm(arr.shape[0] // 3, heads)
            path = p_index[mod][:-1] + ("bias",)
            new_p[path] = arr[perm]
        elif param == "weight" and arr.ndim == 4:      # conv OIHW → HWIO
            path = p_index[mod][:-1] + ("kernel",)
            new_p[path] = arr.transpose(2, 3, 1, 0)
        elif param == "weight" and arr.ndim == 2:      # linear → (in, out)
            path = p_index[mod][:-1] + ("kernel",)
            new_p[path] = arr.T
        elif param == "weight" and arr.ndim == 1:      # BN / LN affine
            path = p_index[mod][:-1] + ("scale",)
            new_p[path] = arr
        elif param == "bias":
            path = p_index[mod][:-1] + ("bias",)
            new_p[path] = arr
        else:
            raise ValueError(f"unhandled torch parameter '{key}' "
                             f"(ndim={arr.ndim})")
        template = p_flat.get(path) if path in p_flat else s_flat.get(path)
        if template is None:
            raise ValueError(f"'{key}' maps to {path}, not in the model")
        got = new_p.get(path, new_s.get(path))
        if tuple(template.shape) != tuple(got.shape):
            raise ValueError(
                f"shape mismatch for '{key}': torch {tuple(arr.shape)} → "
                f"{tuple(got.shape)}, model wants {tuple(template.shape)}")
    missing_p = set(p_flat) - set(new_p)
    missing_s = set(s_flat) - set(new_s)
    if missing_p or missing_s:
        some = sorted("/".join(p) for p in (missing_p | missing_s))[:5]
        raise ValueError(f"checkpoint is missing "
                         f"{len(missing_p) + len(missing_s)} parameters, "
                         f"e.g. {some}")
    return _unflatten(new_p), _unflatten(new_s)


def flax_to_torch_state_dict(params: Any, batch_stats: Any, arch: str,
                             heads: Optional[int] = None) -> dict:
    """Flax ``params`` and ``batch_stats`` trees (numpy arrays or torch
    views) → a torchvision-named ``state_dict`` of contiguous CPU
    tensors; ``heads`` is a ViT's head count."""
    fam = family(arch)
    heads = _heads(fam, heads, arch)

    def tensor(a: np.ndarray) -> torch.Tensor:
        # A copy: on the CPU the leaves are views of the live weights.
        return torch.from_numpy(np.array(a, order="C", copy=True))

    out: dict = {}
    for path, leaf in _flatten(params).items():
        mod = "_".join(path[:-1])
        arr = _to_numpy(leaf)
        kind = path[-1]
        if fam == "vit":
            if path == ("class_token",):
                out["class_token"] = tensor(arr)
                continue
            if path == ("pos_embedding",):
                out["encoder.pos_embedding"] = tensor(arr)
                continue
            if mod.endswith("_in_proj"):
                tmod = _untranslate(fam, mod, arch)
                dim = arr.shape[0] if kind == "kernel" else arr.shape[0] // 3
                inv = np.argsort(_vit_inproj_perm(dim, heads))
                if kind == "kernel":
                    out[f"{tmod}.in_proj_weight"] = tensor(arr.T[inv])
                else:
                    out[f"{tmod}.in_proj_bias"] = tensor(arr[inv])
                continue
        tmod = _untranslate(fam, mod, arch)
        if kind == "layer_scale":
            out[f"{tmod}.layer_scale"] = tensor(arr.reshape(-1, 1, 1))
            continue
        if kind in ("relative_position_bias_table", "logit_scale"):
            out[f"{tmod}.{kind}"] = tensor(arr)
            out.update(_derived_buffers(tmod, kind, arr, fam, arch))
            continue
        if fam == "swin" and mod.endswith("_attn_qkv"):
            heads_here = _swin_heads(arch, mod)
            dim = arr.shape[0] if kind == "kernel" else arr.shape[0] // 3
            inv = np.argsort(_vit_inproj_perm(dim, heads_here))
            name = "weight" if kind == "kernel" else "bias"
            out[f"{tmod}.{name}"] = tensor(arr.T[inv] if kind == "kernel"
                                           else arr[inv])
            continue
        if kind == "kernel" and arr.ndim == 4:
            out[f"{tmod}.weight"] = tensor(arr.transpose(3, 2, 0, 1))
        elif kind == "kernel":
            out[f"{tmod}.weight"] = tensor(arr.T)
        elif kind == "scale":
            out[f"{tmod}.weight"] = tensor(arr)
        elif kind == "bias":
            out[f"{tmod}.bias"] = tensor(arr)
        else:
            raise ValueError(f"unhandled parameter {path}")
    for path, leaf in _flatten(batch_stats).items():
        tmod = _untranslate(fam, "_".join(path[:-1]), arch)
        name = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        out[f"{tmod}.{name}"] = tensor(_to_numpy(leaf))
        if path[-1] == "mean":
            out[f"{tmod}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)
    return out


def _derived_buffers(tmod: str, kind: str, arr: np.ndarray, fam: str,
                     arch: str) -> dict:
    """The buffers torchvision registers beside a bias table (its
    ``relative_position_index``: flat for swin, (L, L) for maxvit) or
    swin v2's ``logit_scale`` (the index and ``relative_coords_table``),
    written from the window size, as ``num_batches_tracked`` is."""
    from tpudist_torch.models.swin import (_VARIANTS, _cpb_coords,
                                           _rel_pos_index)
    if kind == "relative_position_bias_table":
        ws = (int(round(math.sqrt(arr.shape[0]))) + 1) // 2
    else:
        ws = _VARIANTS[arch][3]
    idx = _rel_pos_index(ws)
    out = {f"{tmod}.relative_position_index": torch.from_numpy(
        np.ascontiguousarray(idx if fam == "maxvit" else idx.reshape(-1))
    ).long()}
    if kind == "logit_scale":
        out[f"{tmod}.relative_coords_table"] = torch.from_numpy(
            _cpb_coords(ws).reshape(1, 2 * ws - 1, 2 * ws - 1, 2))
    return out


def model_trees(model: torch.nn.Module) -> tuple[dict, dict]:
    """A port model's ``(params, batch_stats)`` as flax trees of torch
    views."""
    return (jax_tree(model.named_parameters()),
            jax_tree([(n, b) for n, b in model.named_buffers()
                      if b.is_floating_point()]))


def export_state_dict(model: torch.nn.Module, arch: str) -> dict:
    """The model's weights as torchvision's ``state_dict``."""
    return flax_to_torch_state_dict(*model_trees(model), arch,
                                    heads=getattr(model, "num_heads", None))


def load_torch_state_dict(model: torch.nn.Module, state_dict: dict,
                          arch: str) -> None:
    """Load a torchvision-named ``state_dict`` into the port's model,
    strictly; the model keeps its devices and strides."""
    params, stats = model_trees(model)
    p, s = torch_state_dict_to_flax(state_dict, arch, params, stats,
                                    heads=getattr(model, "num_heads", None))
    model.load_state_dict(state_dict_from_jax(arch, p, s), strict=True)


def load_reference_checkpoint(path: str) -> dict:
    """``torch.load`` a reference checkpoint: ``{epoch, arch, state_dict,
    best_acc1}``, or a bare ``state_dict`` file (a torchvision download),
    read as one at epoch 0."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" not in ckpt:
        ckpt = {"state_dict": ckpt, "epoch": 0, "arch": None,
                "best_acc1": 0.0}
    return ckpt


def restore_from_torch(model: torch.nn.Module, path: str, arch: str,
                       ema: Optional[torch.nn.Module] = None
                       ) -> tuple[int, float]:
    """Load a reference ``.pth.tar``'s weights into ``model`` (and seed
    ``ema`` with them); the optimizer stays at its init (the reference
    never saved it). Returns ``(epoch, best_acc1)`` as stored: the
    epoch a resume starts at."""
    ckpt = load_reference_checkpoint(path)
    if ckpt.get("arch") and ckpt["arch"] != arch:
        raise ValueError(f"checkpoint is for arch '{ckpt['arch']}', "
                         f"trainer is building '{arch}'")
    load_torch_state_dict(model, ckpt["state_dict"], arch)
    if ema is not None:
        ema.load_state_dict(model.state_dict())
    best = ckpt.get("best_acc1", 0.0)
    if hasattr(best, "item"):
        best = best.item()
    return int(ckpt.get("epoch", 0)), float(best)


def save_reference_checkpoint(path: str, model: torch.nn.Module, arch: str,
                              epoch: int, best_acc1: float) -> str:
    """Write the reference's schema (``epoch + 1`` is where a resume
    starts) through a temporary renamed into place, so no torn file is
    left."""
    tmp = path + ".tmp"
    torch.save({"epoch": epoch + 1, "arch": arch,
                "state_dict": export_state_dict(model, arch),
                "best_acc1": best_acc1}, tmp)
    os.replace(tmp, path)
    return path
