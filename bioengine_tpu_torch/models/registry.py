"""Builtin model registry: model-zoo style names -> ``nn.Module`` factories.

Counterpart of ``bioengine_tpu/models/registry.py``. Names arrive here with
their ported models; so far the U-Nets, the ViTs and ``cellpose``.
"""

from __future__ import annotations

from typing import Any, Callable

from torch import nn

_REGISTRY: dict[str, Callable[..., nn.Module]] = {}


def register_model(name: str):
    def deco(factory: Callable[..., nn.Module]):
        _REGISTRY[name] = factory
        return factory

    return deco


def get_model(name: str, **overrides: Any) -> nn.Module:
    if name not in _REGISTRY:
        raise KeyError(
            f"Unknown model '{name}'. Available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](**overrides)


def list_models() -> list[str]:
    return sorted(_REGISTRY)


@register_model("unet2d")
def _unet2d(**kw) -> nn.Module:
    from bioengine_tpu_torch.models.unet import UNet2D

    return UNet2D(**kw)


@register_model("unet3d")
def _unet3d(**kw) -> nn.Module:
    from bioengine_tpu_torch.models.unet3d import UNet3D

    return UNet3D(**kw)


@register_model("cellpose")
def _cellpose(**kw) -> nn.Module:
    from bioengine_tpu_torch.models.cellpose import CellposeNet

    return CellposeNet(**kw)


@register_model("vit-b14")
def _vit_b14(**kw) -> nn.Module:
    from bioengine_tpu_torch.models.vit import ViT

    return ViT(**kw)


@register_model("vit-s14")
def _vit_s14(**kw) -> nn.Module:
    from bioengine_tpu_torch.models.vit import ViT

    kw.setdefault("dim", 384)
    kw.setdefault("num_heads", 6)
    return ViT(**kw)
