"""Model zoo with a by-name registry.

Counterpart of ``tpudist/models/__init__.py``: ``create_model('resnet18',
num_classes=1000, ...)`` builds by name and an unknown name raises with
the list of those available. The port registers the ResNet family and the
ViT family so far.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from torch import nn

from tpudist_torch.models import resnet as _resnet_mod
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


def model_names() -> list[str]:
    return sorted(_REGISTRY)


def create_model(arch: str, **kwargs: Any) -> nn.Module:
    """Build a model by name; raises with the available names on a miss."""
    if arch not in _REGISTRY:
        raise ValueError(f"Unknown arch '{arch}'. Available: "
                         f"{', '.join(model_names())}")
    return _REGISTRY[arch](**kwargs)
