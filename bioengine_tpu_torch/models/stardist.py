"""StarDist-style star-convex instance segmentation model, in PyTorch.

Counterpart of ``bioengine_tpu/models/stardist.py``, built on the U-Net of
``models/unet.py`` with the same arithmetic:

- ``StarDist2D``: the 2D U-Net body (``ConvBlock`` = conv, GroupNorm at
  ``min(32, f)`` groups, SiLU, twice; 2x2 max pool; a k = s = 2 transposed
  convolution with ``[up, skip]`` on channels) in ``dtype`` (bf16 by
  default), and two f32 1x1 heads fed by the stream promoted to f32:
  ``prob_head`` (the object-probability logit) and ``dist_head`` (``n_rays``
  radial distances through softplus). Input NHWC (B, H, W, C_in); output
  (B, H, W, 1 + n_rays) f32.
- The softplus is flax's, ``logaddexp(x, 0)``, not ``F.softplus`` (which
  returns x itself above 20).
- ``stardist_loss``: optax's sigmoid BCE on the probability plus 0.2 x the
  prob-weighted MAE of the rays, ``+ 1e-6`` in the denominator.
- ``make_stardist_train_step``: ``models.cellpose.make_loss_train_step``
  over ``stardist_loss`` (``torch.optim.AdamW``).

Submodules carry flax's names in flax's creation order (``ConvBlock_0`` ..
``ConvBlock_{2n}``, ``ConvTranspose_i``, ``prob_head``, ``dist_head``), so
``runtime.convert.state_dict_from_flax`` carries JAX weights over by name.
Polygon reconstruction lives in ``ops/stardist.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from bioengine_tpu_torch.models.cellpose import make_loss_train_step, sigmoid_binary_cross_entropy
from bioengine_tpu_torch.models.unet import Conv, UNet


class StarDist2D(UNet):
    """in: (B, H, W, C_in), H and W divisible by ``divisor``; out: (B, H,
    W, 1 + n_rays) f32: channel 0 is the probability logit, channels
    1..n_rays the ray distances in pixels."""

    def __init__(
        self,
        n_rays: int = 32,
        features: Sequence[int] = (32, 64, 128),
        in_channels: int = 1,
        dtype=torch.bfloat16,
    ):
        pools = [(2, 2)] * (len(features) - 1)
        super().__init__(features, int(n_rays), in_channels, 2, pools, dtype)
        self.n_rays = int(n_rays)

    def _add_head(self, ch: int, out_channels: int) -> None:
        self.prob_head = Conv(ch, 1, (1, 1), torch.float32)
        self.dist_head = Conv(ch, out_channels, (1, 1), torch.float32)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        dist = self.dist_head(x)
        return torch.cat([self.prob_head(x), torch.logaddexp(dist, dist.new_zeros(()))], dim=1)


def stardist_loss(
    pred: torch.Tensor, prob: torch.Tensor, dist: torch.Tensor, dist_weight: float = 0.2,
):
    """BCE on the object probability + prob-weighted MAE on the rays.

    pred: (B, H, W, 1 + n_rays); prob: (B, H, W) edt-normalised targets in
    [0, 1] (``ops.stardist.masks_to_stardist``); dist: (B, H, W, n_rays)
    target distances in pixels. Returns (loss, {"bce_loss", "dist_loss"})."""
    bce = torch.mean(sigmoid_binary_cross_entropy(pred[..., 0], prob))
    mask = prob[..., None]
    mae = torch.sum(torch.abs(pred[..., 1:] - dist) * mask) / (
        torch.sum(mask) * dist.shape[-1] + 1e-6
    )
    return bce + dist_weight * mae, {"bce_loss": bce, "dist_loss": mae}


def make_stardist_train_step():
    """StarDist train step ``(state, images, prob, dist) -> (state,
    metrics)`` over ``cellpose.TrainState``."""
    return make_loss_train_step(stardist_loss)
