"""3D U-Net, in PyTorch: the volumetric member of the segmentation family.

Counterpart of ``bioengine_tpu/models/unet3d.py``, built from the N-d
blocks of ``models/unet.py`` with the same arithmetic. Input and output
are NDHWC. ``z_strides[i]`` is the z pooling factor of level i (1 keeps z
resolution there, the anisotropic recipe for stacks coarser in z than in
xy): the pool and transposed-conv window is ``(zs, 2, 2)``. Blocks are
named ``ConvBlock3D_i``, as flax names them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from bioengine_tpu_torch.models.unet import UNet


class UNet3D(UNet):
    """in: (B, D, H, W, C_in) with H, W divisible by ``divisor`` and D by
    ``z_divisor``; out: (B, D, H, W, out_channels) f32 logits."""

    block_prefix = "ConvBlock3D"

    def __init__(
        self,
        features: Sequence[int] = (16, 32, 64),
        out_channels: int = 1,
        z_strides: Optional[Sequence[int]] = None,  # default: isotropic (all 2)
        in_channels: int = 1,
        dtype=torch.bfloat16,
    ):
        levels = len(features) - 1
        if z_strides is None:
            zs = (2,) * levels
        else:
            zs = tuple(int(s) for s in z_strides)
            if len(zs) != levels:
                raise ValueError(
                    f"z_strides needs {levels} entries (one per pooling "
                    f"level), got {len(zs)}"
                )
        super().__init__(
            features, out_channels, in_channels, 3, [(z, 2, 2) for z in zs], dtype
        )
        self.z_strides = zs

    @property
    def z_divisor(self) -> int:
        return math.prod(self.z_strides)
