"""SAM ViT image encoder + cellpose readout (cpsam), in PyTorch.

Counterpart of ``bioengine_tpu/models/sam.py`` with the same arithmetic:
segment-anything's ImageEncoderViT (patch embedding, a learned position
table, pre-norm blocks whose attention adds a decomposed relative-position
bias, windowed blocks with periodic global ones, a 256-channel neck) and a
transposed-conv readout to cellpose's 3-channel map.

- Parameters are f32; each product casts its input, weight and bias to
  ``dtype`` (bf16 by default). LayerNorms run in f32 with eps 1e-6.
- ``SAMBlock`` has no LayerScale, so its residual stream stays in
  ``dtype``: ``shortcut + x`` is bf16 + bf16 (unlike ``models/vit.Block``,
  whose f32 LayerScale promotes the stream to f32). The MLP's GELU is the
  exact (erf) form.
- Attention is plain ``torch.matmul`` + ``torch.softmax`` in the JAX
  module's order: ``q * hd**-0.5`` in ``dtype``, the ``dtype`` product
  ``q @ k^T``, two ``dtype`` einsums against the gathered tables added
  through the 5-D (B*nh, H, W, H, W) view, the softmax in f32 rounded back
  to ``dtype``. No fused attention: the bias enters before the softmax.
- ``jax.image.resize`` (half-pixel centres, antialiased when it shrinks)
  is ``F.interpolate(..., align_corners=False, antialias=True)``: the
  rel-pos tables along their length only, ``pos_embed`` bilinearly.
- Windowed blocks pad the normed tokens with zeros up to whole windows;
  padded tokens take part in attention as keys, unmasked.
- Windowed blocks declare their tables at ``window_size``, global blocks
  at ``pretrain_grid``: a checkpoint's tables always load and are resized
  at use.

Input NHWC (B, H, W, 3), H and W divisible by ``patch_size``; output
(B, H, W, 3) f32 (flow_y, flow_x, cellprob logits). Module names follow
flax's (``encoder.block{i}.attn.qkv``, ``encoder.neck_conv1``, ``out``), so
``runtime.convert.state_dict_from_flax`` carries a converted cpsam
checkpoint over by name.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bioengine_tpu_torch.models.unet import Conv, ConvTranspose, reset_flax_scales
from bioengine_tpu_torch.models.vit import Dense, LayerNorm


def _resize_rel_pos(rel_pos: torch.Tensor, needed: int) -> torch.Tensor:
    """(L, head_dim) table -> (needed, head_dim), linear along L only."""
    if rel_pos.shape[0] == needed:
        return rel_pos
    table = F.interpolate(
        rel_pos.float()[None, None], size=(needed, rel_pos.shape[1]),
        mode="bilinear", align_corners=False, antialias=True,
    )
    return table[0, 0].to(rel_pos.dtype)


def _rel_pos_gather(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """SAM's get_rel_pos: (q_size, k_size, head_dim). The coordinates are
    f32 and truncated to integers, as the JAX module computes them."""
    max_dist = 2 * max(q_size, k_size) - 1
    table = _resize_rel_pos(rel_pos, max_dist)
    dev = table.device
    q = torch.arange(q_size, dtype=torch.float32, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k = torch.arange(k_size, dtype=torch.float32, device=dev)[None, :] * max(q_size / k_size, 1.0)
    coords = q - k + (k_size - 1) * max(q_size / k_size, 1.0)
    return table[coords.long()]


def _resize_pos_embed(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(1, G, G, dim) -> (1, gh, gw, dim), bilinear, antialiased."""
    if tuple(pos.shape[1:3]) == (gh, gw):
        return pos
    out = F.interpolate(
        pos.permute(0, 3, 1, 2), size=(gh, gw), mode="bilinear",
        align_corners=False, antialias=True,
    )
    return out.permute(0, 2, 3, 1)


class PatchEmbed(nn.Module):
    """flax ``nn.Conv`` with kernel == stride == ``patch``: channel-first
    in and out, product in ``dtype``, bias added after rounding."""

    def __init__(self, in_ch: int, dim: int, patch: int, dtype=torch.bfloat16):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        self.weight = nn.Parameter(torch.zeros(dim, in_ch, patch, patch))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        dt = self.dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), stride=self.patch)
        return y + self.bias.to(dt).view(-1, 1, 1)


class SAMAttention(nn.Module):
    """Multi-head attention over a (B, H, W, dim) grid with SAM's decomposed
    relative-position bias; tables stored at ``table_size``."""

    def __init__(self, dim: int, num_heads: int, table_size: int, dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        hd = dim // num_heads
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * table_size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * table_size - 1, hd))
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x):
        B, H, W, _ = x.shape
        nh, hd, dt = self.num_heads, self.dim // self.num_heads, self.dtype
        N = H * W
        qkv = self.qkv(x).reshape(B, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * nh, N, hd).unbind(0)
        attn = (q * hd**-0.5) @ k.transpose(-2, -1)  # (B*nh, N, N)

        Rh = _rel_pos_gather(H, H, self.rel_pos_h).to(dt)  # (H, H, hd)
        Rw = _rel_pos_gather(W, W, self.rel_pos_w).to(dt)  # (W, W, hd)
        q_r = q.reshape(B * nh, H, W, hd)
        bias_h = torch.einsum("bhwc,hkc->bhwk", q_r, Rh)
        bias_w = torch.einsum("bhwc,wkc->bhwk", q_r, Rw)
        attn = attn.reshape(B * nh, H, W, H, W)
        attn = attn + bias_h[:, :, :, :, None] + bias_w[:, :, :, None, :]
        attn = torch.softmax(attn.reshape(B * nh, N, N).float(), dim=-1).to(dt)

        out = (attn @ v).reshape(B, nh, N, hd).transpose(1, 2).reshape(B, H, W, self.dim)
        return self.proj(out)


def _window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B*nw, ws, ws, C), zero-padded at the bottom and
    right up to whole windows; also returns the padded (Hp, Wp)."""
    B, H, W, C = x.shape
    ph, pw = (-H) % ws, (-W) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).transpose(2, 3)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def _window_unpartition(x: torch.Tensor, ws: int, padded, orig) -> torch.Tensor:
    Hp, Wp = padded
    H, W = orig
    B = x.shape[0] // ((Hp // ws) * (Wp // ws))
    x = x.reshape(B, Hp // ws, Wp // ws, ws, ws, -1).transpose(2, 3)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


class SAMBlock(nn.Module):
    """Pre-norm block; ``window_size`` 0 = global attention."""

    def __init__(
        self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
        window_size: int = 0, table_size: int = 14, dtype=torch.bfloat16,
    ):
        super().__init__()
        self.window_size, self.dtype = window_size, dtype
        self.norm1 = LayerNorm(dim)
        self.attn = SAMAttention(dim, num_heads, table_size, dtype)
        self.norm2 = LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp_lin1 = Dense(dim, hidden, dtype)
        self.mlp_lin2 = Dense(hidden, dim, dtype)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x).to(self.dtype)
        if self.window_size > 0:
            ws = self.window_size
            win, padded = _window_partition(x, ws)
            x = _window_unpartition(self.attn(win), ws, padded, x.shape[1:3])
        else:
            x = self.attn(x)
        x = shortcut + x
        y = self.norm2(x).to(self.dtype)
        y = self.mlp_lin2(F.gelu(self.mlp_lin1(y)))
        return x + y


class SAMEncoder(nn.Module):
    """segment-anything ImageEncoderViT, NHWC: (B, H, W, C) -> (B, H/p,
    W/p, ``neck_dim``) f32 neck features."""

    def __init__(
        self,
        patch_size: int = 8,
        dim: int = 1024,
        depth: int = 24,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        window_size: int = 14,
        global_attn_indexes: Sequence[int] = (5, 11, 17, 23),
        neck_dim: int = 256,
        pretrain_grid: int = 32,
        in_channels: int = 3,
        dtype=torch.bfloat16,
    ):
        super().__init__()
        self.patch_size, self.depth, self.dtype = patch_size, depth, dtype
        self.patch_embed = PatchEmbed(in_channels, dim, patch_size, dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, pretrain_grid, pretrain_grid, dim))
        for i in range(depth):
            ws = 0 if i in global_attn_indexes else window_size
            self.add_module(f"block{i}", SAMBlock(
                dim, num_heads, mlp_ratio, ws,
                # checkpoints store windowed tables at the window extent
                # and global tables at the pretraining grid extent
                table_size=ws if ws > 0 else pretrain_grid, dtype=dtype,
            ))
        self.neck_conv1 = Conv(dim, neck_dim, (1, 1), dtype, use_bias=False)
        self.neck_norm1 = LayerNorm(neck_dim)
        self.neck_conv2 = Conv(neck_dim, neck_dim, (3, 3), dtype, use_bias=False)
        self.neck_norm2 = LayerNorm(neck_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, p = self.dtype, self.patch_size
        gh, gw = x.shape[1] // p, x.shape[2] // p
        x = self.patch_embed(x.to(dt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        # keyed off the table's own shape, so a checkpoint trained at
        # another grid still loads and is resized
        x = x + _resize_pos_embed(self.pos_embed, gh, gw).to(dt)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.neck_conv1(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = self.neck_norm1(x).to(dt)
        x = self.neck_conv2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.neck_norm2(x)


class CpSAM(nn.Module):
    """cpsam: ``SAMEncoder`` + an f32 transposed-conv readout (p x p kernel,
    stride p) to (B, H, W, 3) f32 logits. Defaults are the published ViT-L
    checkpoint shape (~303 M parameters); input is 3-channel (the
    finetuning app pads its [cyto, nucleus] batches with a zero channel)."""

    def __init__(
        self,
        patch_size: int = 8,
        dim: int = 1024,
        depth: int = 24,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        window_size: int = 14,
        global_attn_indexes: Sequence[int] = (5, 11, 17, 23),
        neck_dim: int = 256,
        pretrain_grid: int = 32,
        in_channels: int = 3,
        dtype=torch.bfloat16,
    ):
        super().__init__()
        if isinstance(dtype, str):  # RDF architecture kwargs are JSON
            dtype = getattr(torch, dtype)
        self.patch_size, self.dtype = patch_size, dtype
        self.encoder = SAMEncoder(
            patch_size, dim, depth, num_heads, mlp_ratio, window_size,
            tuple(global_attn_indexes), neck_dim, pretrain_grid, in_channels, dtype,
        )
        self.out = ConvTranspose(neck_dim, 3, (patch_size, patch_size), torch.float32)

    @property
    def divisor(self) -> int:
        return self.patch_size

    def reset_parameters(self, seed: int = 0) -> None:
        reset_flax_scales(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.encoder(x).float().permute(0, 3, 1, 2)
        return self.out(feats).permute(0, 2, 3, 1).contiguous()
