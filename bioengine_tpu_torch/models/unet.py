"""2D U-Net, in PyTorch: the BioImage Model Zoo segmentation workhorse.

Counterpart of ``bioengine_tpu/models/unet.py`` with the same arithmetic:

- input and output are NHWC (permuted to NCHW inside);
- parameters are f32; each convolution casts its input and kernel to the
  compute ``dtype`` (default bf16), convolves, rounds to ``dtype`` and
  then adds the bias in ``dtype``, in flax ``nn.Conv``'s order;
- 3x3 convolutions with SAME padding; GroupNorm with ``min(32, f)``
  groups and eps 1e-6 whose statistics are f32, with var = E[x^2] - E[x]^2
  clipped at 0 (flax 0.12), output cast back to ``dtype``; SiLU;
  2x2 max pool;
- a 2x2, stride-2 transposed convolution, then ``[up, skip]`` on
  channels;
- the final 1x1 convolution runs in f32 (``unet.py:61``); a subclass
  replaces it through ``_add_head`` and ``_head`` (``models/stardist.py``).

Submodules carry flax's names in flax's creation order (``ConvBlock_0``
.. ``ConvBlock_{2n}``, ``ConvTranspose_i``, ``Conv_0``, and
``Conv_0, GroupNorm_0, Conv_1, GroupNorm_1`` inside a block), so
``runtime.convert.state_dict_from_flax`` carries JAX weights over by name.
Flax infers the input channels at ``init``; here they are
``in_channels``. The building blocks are N-d and serve ``unet3d.py`` too.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_CONV = {2: F.conv2d, 3: F.conv3d}
_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}
_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}


class Conv(nn.Module):
    """flax ``nn.Conv`` with SAME padding and stride 1: f32 parameters,
    product in ``dtype``, bias (unless ``use_bias=False``) added after the
    product is rounded."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel: Sequence[int], dtype=torch.bfloat16,
        use_bias: bool = True,
    ):
        super().__init__()
        self.kernel = tuple(kernel)
        self.padding = tuple(k // 2 for k in self.kernel)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x):
        dt = self.dtype
        y = _CONV[len(self.kernel)](x.to(dt), self.weight.to(dt), padding=self.padding)
        if self.bias is None:
            return y
        return y + self.bias.to(dt).view(-1, *([1] * len(self.kernel)))


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` with kernel == stride (non-overlapping
    upsampling). The weight is torch's (I, O, *k); the bridge flips it
    spatially against flax's kernel."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int], dtype=torch.bfloat16):
        super().__init__()
        self.kernel = tuple(kernel)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(in_ch, out_ch, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        dt = self.dtype
        y = _CONV_T[len(self.kernel)](x.to(dt), self.weight.to(dt), stride=self.kernel)
        return y + self.bias.to(dt).view(-1, *([1] * len(self.kernel)))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over channel-first input: f32 statistics,
    var = E[x^2] - E[x]^2 clipped at 0, y = (x - mean) * (rsqrt(var +
    eps) * scale) + bias in f32, cast to the input's dtype."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        xf = x.float()
        g = xf.reshape(x.shape[0], self.num_groups, -1)
        mean = g.mean(-1)
        var = ((g * g).mean(-1) - mean * mean).clamp_min(0.0)
        return self.normalize(xf, mean, var).to(x.dtype)

    def normalize(self, xf, mean, var):
        """f32 ``xf`` normalised with (B, groups) f32 statistics, scaled
        and shifted in f32 (``parallel/spatial.py`` passes statistics
        summed over a ring of height shards)."""
        B, C = xf.shape[:2]
        per_group = C // self.num_groups
        mean = mean.repeat_interleave(per_group, 1)
        mul = torch.rsqrt(var + self.eps).repeat_interleave(per_group, 1) * self.weight
        shape = (B, C) + (1,) * (xf.dim() - 2)
        return (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape[1:])


@torch.no_grad()
def reset_flax_scales(module: nn.Module, seed: int = 0) -> None:
    """Random weights from ``np.random.default_rng(seed)`` with flax's
    initialiser scales: kernels ~ N(0, 1/fan_in) (fan_in = input channels
    x window, for transposed kernels too; a Dense's input width), zero
    biases and zero-initialised tables (``pos_embed``, ``rel_pos_*``), unit
    norm scales and LayerScales."""
    rng = np.random.default_rng(seed)
    for name, p in module.named_parameters():
        module_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if leaf == "bias" or leaf.startswith(("pos_embed", "rel_pos_")):
            p.zero_()
        elif p.dim() == 1:  # norm scale, LayerScale
            p.fill_(1.0)
        else:
            is_t = isinstance(module.get_submodule(module_name), ConvTranspose)
            fan_in = (p.shape[0] if is_t else p.shape[1]) * math.prod(p.shape[2:])
            std = 1.0 / math.sqrt(fan_in)
            p.copy_(torch.from_numpy(rng.normal(0.0, std, p.shape).astype(np.float32)))


class ConvBlock(nn.Module):
    """(Conv 3^n -> GroupNorm -> SiLU) twice."""

    def __init__(self, in_ch: int, features: int, ndim: int = 2, dtype=torch.bfloat16):
        super().__init__()
        groups = min(32, features)
        self.Conv_0 = Conv(in_ch, features, (3,) * ndim, dtype)
        self.GroupNorm_0 = GroupNorm(groups, features)
        self.Conv_1 = Conv(features, features, (3,) * ndim, dtype)
        self.GroupNorm_1 = GroupNorm(groups, features)

    def forward(self, x):
        x = F.silu(self.GroupNorm_0(self.Conv_0(x)))
        return F.silu(self.GroupNorm_1(self.Conv_1(x)))


class UNet(nn.Module):
    """N-d encoder-decoder with skip connections over channels-last
    input; ``pools[i]`` is the pooling (and upsampling) window of level i.
    ``UNet2D`` and ``UNet3D`` fix ``ndim``, the pools and the block
    names."""

    block_prefix = "ConvBlock"

    def __init__(
        self,
        features: Sequence[int],
        out_channels: int,
        in_channels: int,
        ndim: int,
        pools: Sequence[tuple[int, ...]],
        dtype=torch.bfloat16,
    ):
        super().__init__()
        if isinstance(dtype, str):  # RDF architecture kwargs are JSON
            dtype = getattr(torch, dtype)
        self.features = tuple(int(f) for f in features)
        self.pools = [tuple(p) for p in pools]
        self.ndim = ndim
        self.dtype = dtype
        enc = self.features[:-1]
        blocks, ups = [], []
        ch = in_channels
        for feats in enc:
            blocks.append(ConvBlock(ch, feats, self.ndim, dtype))
            ch = feats
        blocks.append(ConvBlock(ch, self.features[-1], self.ndim, dtype))
        ch = self.features[-1]
        for feats, pool in zip(reversed(enc), reversed(self.pools)):
            ups.append(ConvTranspose(ch, feats, pool, dtype))
            blocks.append(ConvBlock(2 * feats, feats, self.ndim, dtype))
            ch = feats
        # flax numbers the blocks in creation order, decoder after bottleneck
        for i, block in enumerate(blocks):
            self.add_module(f"{self.block_prefix}_{i}", block)
        for i, up in enumerate(ups):
            self.add_module(f"ConvTranspose_{i}", up)
        self._add_head(ch, out_channels)

    def _add_head(self, ch: int, out_channels: int) -> None:
        """The f32 1x1 output convolution, created after the decoder."""
        self.Conv_0 = Conv(ch, out_channels, (1,) * self.ndim, torch.float32)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Decoder features (B, C, *spatial) in ``dtype`` -> f32 output."""
        return self.Conv_0(x.float())

    def _block(self, i: int) -> ConvBlock:
        return getattr(self, f"{self.block_prefix}_{i}")

    @property
    def divisor(self) -> int:
        """In-plane bucket divisor: pooling is 2x per level in y and x."""
        return 2 ** (len(self.features) - 1)

    def reset_parameters(self, seed: int = 0) -> None:
        reset_flax_scales(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, *spatial, C_in), spatial divisible by the pools ->
        (B, *spatial, out_channels) f32 logits."""
        perm = (0, x.dim() - 1, *range(1, x.dim() - 1))
        x = x.to(self.dtype).permute(perm)
        n = len(self.features) - 1
        skips = []
        for i, pool in enumerate(self.pools):
            x = self._block(i)(x)
            skips.append(x)
            x = _MAX_POOL[self.ndim](x, pool, pool)
        x = self._block(n)(x)
        for j, skip in enumerate(reversed(skips)):
            x = getattr(self, f"ConvTranspose_{j}")(x)
            x = self._block(n + 1 + j)(torch.cat([x, skip], dim=1))
        y = self._head(x)
        back = (0, *range(2, y.dim()), 1)
        return y.permute(back).contiguous()


class UNet2D(UNet):
    """in: (B, H, W, C_in) with H, W divisible by ``divisor``;
    out: (B, H, W, out_channels) f32 logits."""

    def __init__(
        self,
        features: Sequence[int] = (32, 64, 128, 256),
        out_channels: int = 1,
        in_channels: int = 1,
        dtype=torch.bfloat16,
    ):
        pools = [(2, 2)] * (len(features) - 1)
        super().__init__(features, out_channels, in_channels, 2, pools, dtype)
