"""Vision Transformer embedder (DINOv2-compatible geometry), in PyTorch.

Counterpart of ``bioengine_tpu/models/vit.py`` with the same arithmetic:

- parameters are f32 and each product casts its input, weight and bias to
  ``dtype`` (flax ``nn.Dense(dtype=...)``);
- LayerNorm runs in f32 with eps 1e-6, GELU is the tanh approximation;
- ``y * ls`` multiplies a ``dtype`` activation by an f32 parameter, so the
  residual stream is ``dtype`` before block 0 and f32 from then on;
- input is NHWC and the output is the f32 CLS embedding.

Module names follow the flax ones (``block{i}.attn.qkv``,
``block{i}.mlp.Dense_0``), so ``runtime.convert.state_dict_from_flax``
carries JAX weights over by name. Unlike flax, the position embedding is
sized at construction, from ``img_size``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` whose product runs in ``dtype`` over f32 parameters."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.bfloat16):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """f32 LayerNorm with flax's eps."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )


class MlpBlock(nn.Module):
    """Dense → tanh GELU → Dense; input width ``out``, as in the ViT."""

    def __init__(self, hidden: int, out: int, dtype=torch.bfloat16):
        super().__init__()
        self.Dense_0 = Dense(out, hidden, dtype)
        self.Dense_1 = Dense(hidden, out, dtype)

    def forward(self, x):
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))


class Attention(nn.Module):
    def __init__(
        self,
        dim: int,
        num_heads: int,
        dtype=torch.bfloat16,
        # Optional kernel override: fn(q, k, v) -> out, shapes (B, H, N, d).
        attn_fn: Optional[Callable] = None,
        # softmax dtype of the inline path; None = follow ``dtype``
        softmax_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.attn_fn = attn_fn
        self.softmax_dtype = softmax_dtype
        self.qkv = Dense(dim, dim * 3, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x):
        B, N, _ = x.shape
        head_dim = self.dim // self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, head_dim)
        qkv = qkv.permute(2, 0, 3, 1, 4)  # (3, B, H, N, d)
        if self.attn_fn is not None:
            # one copy lays q, k and v out as contiguous (B, H, N, d)
            # blocks, the layout the attention kernel reads
            q, k, v = qkv.contiguous().unbind(0)
            out = self.attn_fn(q, k, v)
        else:
            q, k, v = qkv.unbind(0)
            sm_dtype = self.softmax_dtype or self.dtype
            logits = (q * head_dim**-0.5) @ k.transpose(-2, -1)
            weights = torch.softmax(logits.to(sm_dtype), dim=-1)
            out = weights.to(self.dtype) @ v
        out = out.transpose(1, 2).reshape(B, N, self.dim)
        return self.proj(out)


class Block(nn.Module):
    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        dtype=torch.bfloat16,
        attn_fn: Optional[Callable] = None,
        softmax_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, dtype, attn_fn, softmax_dtype)
        self.ls1 = nn.Parameter(torch.ones(dim))
        self.norm2 = LayerNorm(dim)
        self.mlp = MlpBlock(int(dim * mlp_ratio), dim, dtype)
        self.ls2 = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        # DINOv2 pre-norm + LayerScale; the f32 ls promotes the sum to f32
        x = x + self.attn(self.norm1(x)) * self.ls1
        return x + self.mlp(self.norm2(x)) * self.ls2


class ViT(nn.Module):
    """ViT-B/14 defaults match DINOv2-base (embed 768, 12 heads, 12 blocks)."""

    def __init__(
        self,
        patch_size: int = 14,
        dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        dtype=torch.bfloat16,
        attn_fn: Optional[Callable] = None,
        softmax_dtype: Optional[torch.dtype] = None,
        img_size: int = 224,
        in_channels: int = 3,
    ):
        super().__init__()
        if img_size % patch_size:
            raise ValueError(f"img_size {img_size} not divisible by {patch_size}")
        self.patch_size, self.dim, self.depth = patch_size, dim, depth
        self.dtype = dtype
        self.img_size = img_size
        n_patches = (img_size // patch_size) ** 2
        self.patch_embed = nn.Conv2d(in_channels, dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, dim))
        for i in range(depth):
            self.add_module(
                f"block{i}",
                Block(dim, num_heads, mlp_ratio, dtype, attn_fn, softmax_dtype),
            )
        self.norm = LayerNorm(dim)

    def blocks(self) -> list[Block]:
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Random weights from ``np.random.default_rng(seed)`` with flax's
        initialiser scales: products ~ N(0, 1/fan_in), zero biases, unit
        norms and LayerScales, zero CLS token, position embedding ~ N(0,
        0.02)."""
        rng = np.random.default_rng(seed)

        def fill(p: torch.Tensor, std: float) -> None:
            p.copy_(torch.from_numpy(rng.normal(0.0, std, p.shape).astype(np.float32)))

        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "pos_embed":
                fill(p, 0.02)
            elif name.startswith("patch_embed.") and leaf == "weight":
                fill(p, 1.0 / math.sqrt(p[0].numel()))
            elif leaf == "weight" and p.dim() == 2:
                fill(p, 1.0 / math.sqrt(p.shape[1]))
            elif leaf == "bias" or name == "cls_token":
                p.zero_()
            else:  # LayerNorm weights, ls1, ls2
                p.fill_(1.0)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) with H = W = ``img_size``.

        Returns the CLS embedding (B, dim) in f32."""
        B, H, W, _ = images.shape
        if (H, W) != (self.img_size, self.img_size):
            raise ValueError(
                f"expected {self.img_size}x{self.img_size} images, got {H}x{W}"
            )
        dt = self.dtype
        x = F.conv2d(
            images.to(dt).permute(0, 3, 1, 2),
            self.patch_embed.weight.to(dt),
            self.patch_embed.bias.to(dt),
            stride=self.patch_size,
        )  # (B, dim, gh, gw)
        x = x.flatten(2).transpose(1, 2)  # (B, gh * gw, dim), row-major as NHWC
        cls = self.cls_token.to(dt).expand(B, 1, self.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        for block in self.blocks():
            x = block(x)
        return self.norm(x)[:, 0].float()
