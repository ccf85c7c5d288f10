"""Cellpose-style flow-field segmentation model, in PyTorch.

Counterpart of ``bioengine_tpu/models/cellpose.py``, built from the
blocks of ``models/unet.py`` with the same arithmetic:

- ``CellposeNet``: a residual U-Net (pre-activation ``ResBlock``s) whose
  bottleneck's global average, L2-normalised, is a style vector that each
  decoder level adds as a per-channel bias (``StyleMod``). Input NHWC
  (B, H, W, C_in); output (B, H, W, 3) f32: flow_y, flow_x, cellprob logit.
- f32 parameters, products in ``dtype`` (bf16 by default), f32 GroupNorm
  statistics, the residual add in ``dtype``, the final 1x1 conv in f32.
- ``cellpose_loss``: MSE on 5x-scaled flows + BCE on the cell probability.
- ``make_train_step``: forward, loss, backward and one ``torch.optim.AdamW``
  step, the contract of the JAX ``make_train_step`` on one device.

The forward is written over an ops object that carries out its layers:
``LocalOps`` on one batch of whole images, ``parallel/lockstep.py``
``RingOps`` on height-split blocks over a mesh (the (dp, sp) train step).

Submodules carry flax's names in flax's creation order (``ResBlock_i``,
``ConvTranspose_j``, ``StyleMod_j.Dense_0``, ``Conv_0``; inside a block
``GroupNorm_0, Conv_0, GroupNorm_1, Conv_1`` and the 1x1 shortcut
``Conv_2``), so ``runtime.convert.state_dict_from_flax`` carries JAX
weights over by name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bioengine_tpu_torch.models.unet import Conv, ConvTranspose, GroupNorm, reset_flax_scales
from bioengine_tpu_torch.models.vit import Dense
from bioengine_tpu_torch.ops.flows import FLOW_SCALE
from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device


class LocalOps:
    """CellposeNet's layers on one batch of whole (B, C, H, W) images: a
    conv, a norm or any other layer is its module's own call, ``each`` a
    plain call, ``spatial_mean`` the f32 mean over (H, W)."""

    @staticmethod
    def layer(module, x, *args):
        return module(x, *args)

    conv = group_norm = layer

    @staticmethod
    def each(fn, *xs):
        return fn(*xs)

    @staticmethod
    def spatial_mean(x):
        return x.float().mean((2, 3))


class ResBlock(nn.Module):
    """GN -> SiLU -> Conv3x3, GN -> SiLU -> Conv3x3, plus a 1x1 shortcut
    when the channel count changes. The first norm sees the input's
    channels, so its group count must divide them: gcd(32, C_in)."""

    def __init__(self, in_ch: int, features: int, dtype=torch.bfloat16):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(math.gcd(32, in_ch), in_ch)
        self.Conv_0 = Conv(in_ch, features, (3, 3), dtype)
        self.GroupNorm_1 = GroupNorm(min(32, features), features)
        self.Conv_1 = Conv(features, features, (3, 3), dtype)
        if in_ch != features:
            self.Conv_2 = Conv(in_ch, features, (1, 1), dtype)

    def forward(self, x, ops=LocalOps):
        h = ops.conv(self.Conv_0, ops.each(F.silu, ops.group_norm(self.GroupNorm_0, x)))
        h = ops.conv(self.Conv_1, ops.each(F.silu, ops.group_norm(self.GroupNorm_1, h)))
        if hasattr(self, "Conv_2"):
            x = ops.conv(self.Conv_2, x)
        return ops.each(torch.add, x, h)


class StyleMod(nn.Module):
    """The global style vector, through a ``dtype`` Dense, added as a
    per-channel bias."""

    def __init__(self, style_dim: int, features: int, dtype=torch.bfloat16):
        super().__init__()
        self.Dense_0 = Dense(style_dim, features, dtype)

    def forward(self, x, style):
        return x + self.Dense_0(style)[:, :, None, None]


class CellposeNet(nn.Module):
    """Residual U-Net with a global style vector.

    in: (B, H, W, C) images, H/W divisible by 2**(len(features)-1).
    out: (B, H, W, 3) — flow_y, flow_x, cellprob logits (f32).
    """

    def __init__(
        self,
        features: Sequence[int] = (32, 64, 128, 256),
        in_channels: int = 2,
        dtype=torch.bfloat16,
    ):
        super().__init__()
        if isinstance(dtype, str):  # RDF architecture kwargs are JSON
            dtype = getattr(torch, dtype)
        self.features = tuple(int(f) for f in features)
        self.in_channels = int(in_channels)
        self.dtype = dtype
        enc = self.features[:-1]
        blocks, ch = [], self.in_channels
        for feats in self.features:  # encoder levels, then the bottleneck
            blocks.append(ResBlock(ch, feats, dtype))
            ch = feats
        for j, feats in enumerate(reversed(enc)):
            self.add_module(f"ConvTranspose_{j}", ConvTranspose(ch, feats, (2, 2), dtype))
            blocks.append(ResBlock(2 * feats, feats, dtype))
            self.add_module(f"StyleMod_{j}", StyleMod(self.features[-1], feats, dtype))
            ch = feats
        for i, block in enumerate(blocks):
            self.add_module(f"ResBlock_{i}", block)
        self.Conv_0 = Conv(ch, 3, (1, 1), torch.float32)

    @property
    def divisor(self) -> int:
        return 2 ** (len(self.features) - 1)

    def reset_parameters(self, seed: int = 0) -> None:
        reset_flax_scales(self, seed)

    def forward(self, x: torch.Tensor, ops=LocalOps) -> torch.Tensor:
        """``ops`` carries out the layers: ``LocalOps`` on ``x`` itself,
        ``parallel/lockstep.py`` ``RingOps`` on one height block per mesh
        entry (``x`` and the result then lists of blocks)."""
        dt = self.dtype
        x = ops.each(lambda t: t.to(dt).permute(0, 3, 1, 2), x)
        n = len(self.features) - 1
        skips = []
        for i in range(n):
            x = getattr(self, f"ResBlock_{i}")(x, ops)
            skips.append(x)
            x = ops.each(lambda t: F.max_pool2d(t, 2, 2), x)
        x = getattr(self, f"ResBlock_{n}")(x, ops)
        # style: global average of the bottleneck (f32 sums, a dtype
        # result), divided by its f32 L2 norm + 1e-6 rounded to dtype
        style = ops.each(lambda m: _unit_style(m.to(dt)), ops.spatial_mean(x))
        for j, skip in enumerate(reversed(skips)):
            x = ops.layer(getattr(self, f"ConvTranspose_{j}"), x)
            x = ops.each(lambda up, s: torch.cat([up, s], dim=1), x, skip)
            x = getattr(self, f"ResBlock_{n + 1 + j}")(x, ops)
            x = ops.layer(getattr(self, f"StyleMod_{j}"), x, style)
        y = ops.conv(self.Conv_0, ops.each(lambda t: t.float(), x))
        return ops.each(lambda t: t.permute(0, 2, 3, 1).contiguous(), y)


def _unit_style(style: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(style.float(), dim=-1, keepdim=True)
    return style / (norm + 1e-6).to(style.dtype)


def cellpose_loss(pred: torch.Tensor, flows: torch.Tensor, cellprob: torch.Tensor):
    """Cellpose objective: MSE on 5x-scaled flows + BCE on cell probability.

    pred: (B, H, W, 3); flows: (B, H, W, 2) target flow field in [-1, 1];
    cellprob: (B, H, W) binary target. Returns (loss, {"flow_loss",
    "bce_loss"})."""
    flow_loss = 0.5 * torch.mean((pred[..., :2] - FLOW_SCALE * flows) ** 2)
    bce = torch.mean(sigmoid_binary_cross_entropy(pred[..., 2], cellprob))
    return flow_loss + bce, {"flow_loss": flow_loss, "bce_loss": bce}


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise, in ``optax.sigmoid_binary_cross_entropy``'s form."""
    return -labels * F.logsigmoid(logits) - (1 - labels) * F.logsigmoid(-logits)


@dataclasses.dataclass
class TrainState:
    """The module being trained, its optimiser and the step count."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, module: nn.Module, learning_rate: float, weight_decay: float) -> "TrainState":
        """optax ``adamw(lr, weight_decay=wd)``: b1 0.9, b2 0.999, eps 1e-8
        added to sqrt(v_hat), decoupled decay on every parameter."""
        opt = torch.optim.AdamW(
            module.parameters(), lr=learning_rate, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=weight_decay,
        )
        return cls(module, opt)


class LossTrainStep:
    """A train step ``(state, images, *targets) -> (state, metrics)`` for
    a ``loss_call(pred, *targets) -> (loss, parts)``, in two phases: the
    gradients (forward, loss, backward) and the update (one optimiser
    step). ``parallel.data_parallel_step`` runs the same ``loss_call`` and
    ``update`` around a gradient phase of its own over several replicas."""

    def __init__(self, loss_call: Callable):
        self.loss_call = loss_call

    def gradients(self, state: TrainState, images: torch.Tensor, *targets: torch.Tensor):
        """Forward, loss and backward: the gradients land in
        ``state.module``'s ``.grad``; returns (loss, parts)."""
        state.module.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, parts = self.loss_call(state.module(images), *targets)
        loss.backward()
        return loss, parts

    @staticmethod
    def update(state: TrainState) -> None:
        state.optimizer.step()
        state.step += 1

    @staticmethod
    def metrics(loss: torch.Tensor, parts: dict) -> dict:
        return {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}

    def __call__(self, state: TrainState, images: torch.Tensor, *targets: torch.Tensor):
        loss, parts = self.gradients(state, images, *targets)
        self.update(state)
        return state, self.metrics(loss, parts)


def make_loss_train_step(loss_call: Callable) -> LossTrainStep:
    """A train step ``(state, images, *targets) -> (state, metrics)`` for
    any ``loss_call(pred, *targets) -> (loss, parts)``: forward, loss,
    backward, one optimiser step. ``state`` is updated in place; metrics
    are detached device tensors ``{"loss", **parts}``."""
    return LossTrainStep(loss_call)


def make_train_step():
    """Cellpose train step ``(state, images, flows, cellprob) -> (state,
    metrics)`` (see ``make_loss_train_step``)."""
    return make_loss_train_step(cellpose_loss)


@dataclasses.dataclass(frozen=True)
class CellposeConfig:
    features: tuple = (32, 64, 128, 256)
    in_channels: int = 2
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5


def create_model_and_state(
    config: CellposeConfig, seed: int = 0, device: DeviceLike = None,
) -> tuple[CellposeNet, TrainState]:
    """A seeded ``CellposeNet`` on ``device`` (``cuda:0`` by default) and
    its train state."""
    model = CellposeNet(features=config.features, in_channels=config.in_channels)
    model.reset_parameters(seed)
    model.to(resolve_device(device))
    return model, TrainState.create(model, config.learning_rate, config.weight_decay)
