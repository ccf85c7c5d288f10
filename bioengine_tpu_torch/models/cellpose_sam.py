"""Transformer-backbone Cellpose (the finetuning app's ``"sam"`` backbone),
in PyTorch.

Counterpart of ``bioengine_tpu/models/cellpose_sam.py`` with the same
arithmetic:

- a patch embedding, a 2-D sin-cos position table computed per grid in
  f32 and added in ``dtype``, and ``models/vit.Block``s with the inline
  attention (``attn_fn=None``: ``dtype`` softmax), as the app builds it;
- an f32 LayerNorm, then a style vector: the ``dtype`` mean over tokens
  divided by its f32 L2 norm + 1e-6 rounded to ``dtype``;
- log2(p) decoder stages of ``max(feats // 2, 32)`` channels: a 2x2
  stride-2 transposed conv, GroupNorm(min(32, feats)) (f32 statistics),
  SiLU, the style ``Dense`` as a per-channel bias, a 3x3 conv, SiLU;
- an f32 1x1 ``head`` conv: (B, H, W, 3) f32 logits (flow_y, flow_x,
  cellprob), the output contract of ``CellposeNet``.

Module names follow flax's (``block{i}``, ``norm``, ``up{s}``,
``up{s}_norm``, ``up{s}_style``, ``up{s}_conv``, ``head``), so
``runtime.convert.state_dict_from_flax`` carries JAX weights over by name.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from bioengine_tpu_torch.models.sam import PatchEmbed
from bioengine_tpu_torch.models.unet import Conv, ConvTranspose, GroupNorm, reset_flax_scales
from bioengine_tpu_torch.models.vit import Block, Dense, LayerNorm


def sincos_pos_embed_2d(h: int, w: int, dim: int, device=None) -> torch.Tensor:
    """(h*w, dim) f32 2-D sin-cos position table: half the channels encode
    y, half x."""
    if dim % 4:
        raise ValueError(f"pos embed dim must be divisible by 4, got {dim}")
    quarter = dim // 4
    f32 = torch.float32
    omega = 1.0 / (10000.0 ** (torch.arange(quarter, dtype=f32, device=device) / quarter))
    ys = torch.arange(h, dtype=f32, device=device)[:, None] * omega[None, :]
    xs = torch.arange(w, dtype=f32, device=device)[:, None] * omega[None, :]
    y = torch.cat([torch.sin(ys), torch.cos(ys)], dim=-1)  # (h, dim/2)
    x = torch.cat([torch.sin(xs), torch.cos(xs)], dim=-1)  # (w, dim/2)
    grid = torch.cat(
        [y[:, None, :].expand(h, w, dim // 2), x[None, :, :].expand(h, w, dim // 2)], dim=-1,
    )
    return grid.reshape(h * w, dim)


class CellposeSAM(nn.Module):
    """ViT-encoder cellpose: in (B, H, W, C) with H, W divisible by
    ``patch_size`` (a power of two); out (B, H, W, 3) f32 logits."""

    def __init__(
        self,
        patch_size: int = 8,
        dim: int = 256,
        depth: int = 8,
        num_heads: int = 8,
        mlp_ratio: float = 4.0,
        in_channels: int = 2,
        dtype=torch.bfloat16,
    ):
        super().__init__()
        if isinstance(dtype, str):  # RDF architecture kwargs are JSON
            dtype = getattr(torch, dtype)
        if patch_size & (patch_size - 1):
            raise ValueError(f"patch_size must be a power of two, got {patch_size}")
        self.patch_size, self.dim, self.depth, self.dtype = patch_size, dim, depth, dtype
        self.patch_embed = PatchEmbed(in_channels, dim, patch_size, dtype)
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, num_heads, mlp_ratio, dtype))
        self.norm = LayerNorm(dim)
        self.n_stages = int(math.log2(patch_size))
        feats = dim
        for s in range(self.n_stages):
            prev, feats = feats, max(feats // 2, 32)
            self.add_module(f"up{s}", ConvTranspose(prev, feats, (2, 2), dtype))
            self.add_module(f"up{s}_norm", GroupNorm(min(32, feats), feats))
            self.add_module(f"up{s}_style", Dense(dim, feats, dtype))
            self.add_module(f"up{s}_conv", Conv(feats, feats, (3, 3), dtype))
        self.head = Conv(feats, 3, (1, 1), torch.float32)

    @property
    def divisor(self) -> int:
        return self.patch_size

    def reset_parameters(self, seed: int = 0) -> None:
        reset_flax_scales(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        dt, p = self.dtype, self.patch_size
        gh, gw = H // p, W // p
        x = self.patch_embed(x.to(dt).permute(0, 3, 1, 2))  # (B, dim, gh, gw)
        x = x.flatten(2).transpose(1, 2)  # (B, gh * gw, dim), row-major as NHWC
        x = x + sincos_pos_embed_2d(gh, gw, self.dim, x.device).to(dt)[None]
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.norm(x).to(dt)

        # style: f32 sums to a dtype mean, divided by its f32 norm + 1e-6
        # rounded to dtype
        style = x.float().mean(1).to(dt)
        norm = torch.linalg.vector_norm(style.float(), dim=-1, keepdim=True)
        style = style / (norm + 1e-6).to(dt)

        x = x.transpose(1, 2).reshape(B, self.dim, gh, gw)
        for s in range(self.n_stages):
            x = getattr(self, f"up{s}")(x)
            x = F.silu(getattr(self, f"up{s}_norm")(x))
            x = x + getattr(self, f"up{s}_style")(style)[:, :, None, None]
            x = F.silu(getattr(self, f"up{s}_conv")(x))
        y = self.head(x.float())
        return y.permute(0, 2, 3, 1).contiguous()
