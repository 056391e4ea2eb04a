"""Model zoo with a by-name registry.

Counterpart of ``tpudist/models/__init__.py``: ``create_model('resnet18',
num_classes=1000, ...)`` builds by name and an unknown name raises with
the list of those available. The port registers every arch of
tpudist's that runs on one card: the ResNet and ViT families, the
BatchNorm+ReLU conv families (vgg (+bn), densenet, googlenet,
inception_v3, mobilenet, regnet), and alexnet, squeezenet, mnasnet,
shufflenet_v2, efficientnet (v1, v2), convnext, swin (v1, v2) and
maxvit_t. tpudist's vit_moe and vit_pipe archs need the expert and pipe
mesh axes, which the port does not have: they are not registered.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from torch import nn

from tpudist_torch.models import alexnet as _alexnet_mod
from tpudist_torch.models import convnext as _convnext_mod
from tpudist_torch.models import densenet as _densenet_mod
from tpudist_torch.models import efficientnet as _efficientnet_mod
from tpudist_torch.models import googlenet as _googlenet_mod
from tpudist_torch.models import inception as _inception_mod
from tpudist_torch.models import maxvit as _maxvit_mod
from tpudist_torch.models import mnasnet as _mnasnet_mod
from tpudist_torch.models import mobilenet as _mobilenet_mod
from tpudist_torch.models import regnet as _regnet_mod
from tpudist_torch.models import resnet as _resnet_mod
from tpudist_torch.models import shufflenet as _shufflenet_mod
from tpudist_torch.models import squeezenet as _squeezenet_mod
from tpudist_torch.models import swin as _swin_mod
from tpudist_torch.models import vgg as _vgg_mod
from tpudist_torch.models import vit as _vit_mod
from tpudist_torch.models.resnet import ResNet  # noqa: F401
from tpudist_torch.models.vit import VisionTransformer  # noqa: F401

_REGISTRY: Dict[str, Callable[..., nn.Module]] = {}


def register_model(name: str, ctor: Callable[..., nn.Module]) -> None:
    """Register a constructor under ``name``."""
    _REGISTRY[name] = ctor


for _n in ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext101_32x8d",
           "wide_resnet50_2", "wide_resnet101_2"):
    register_model(_n, getattr(_resnet_mod, _n))

for _n in ("vit_b_16", "vit_b_32", "vit_l_16", "vit_l_32", "vit_h_14"):
    register_model(_n, getattr(_vit_mod, _n))

for _n in ("vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn"):
    register_model(_n, getattr(_vgg_mod, _n))
for _n in ("densenet121", "densenet161", "densenet169", "densenet201"):
    register_model(_n, getattr(_densenet_mod, _n))
register_model("googlenet", _googlenet_mod.googlenet)
register_model("inception_v3", _inception_mod.inception_v3)
for _n in ("mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small"):
    register_model(_n, getattr(_mobilenet_mod, _n))
for _n in _regnet_mod._VARIANTS:
    register_model(_n, getattr(_regnet_mod, _n))

register_model("alexnet", _alexnet_mod.alexnet)
for _n in ("squeezenet1_0", "squeezenet1_1"):
    register_model(_n, getattr(_squeezenet_mod, _n))
for _n in ("mnasnet0_5", "mnasnet0_75", "mnasnet1_0", "mnasnet1_3"):
    register_model(_n, getattr(_mnasnet_mod, _n))
for _n in ("shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
           "shufflenet_v2_x1_5", "shufflenet_v2_x2_0"):
    register_model(_n, getattr(_shufflenet_mod, _n))
for _n in (*_efficientnet_mod._VARIANTS, *_efficientnet_mod._V2_TABLES):
    register_model(_n, getattr(_efficientnet_mod, _n))
for _n in _convnext_mod._VARIANTS:
    register_model(_n, getattr(_convnext_mod, _n))
for _n in _swin_mod._VARIANTS:
    register_model(_n, getattr(_swin_mod, _n))
register_model("maxvit_t", _maxvit_mod.maxvit_t)


def model_names() -> list[str]:
    return sorted(_REGISTRY)


def create_model(arch: str, **kwargs: Any) -> nn.Module:
    """Build a model by name; raises with the available names on a miss."""
    if arch not in _REGISTRY:
        raise ValueError(f"Unknown arch '{arch}'. Available: "
                         f"{', '.join(model_names())}")
    return _REGISTRY[arch](**kwargs)
