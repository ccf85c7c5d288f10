"""CellposeNet's forward over height-split blocks, one layer at a time
across every entry of a mesh: the exact spatial split of the (dp, sp)
train step (``data_parallel.py`` ``data_parallel_step``), where JAX's
GSPMD splits the same layers.

The model's forward is written over an ops object (``models/cellpose.py``
``LocalOps``); ``RingOps`` carries it out with one value per mesh entry,
channels-first. Before every 3x3 convolution each block receives one row
from each ring neighbour at that layer's resolution (zeros at the ring's
ends: the unsharded SAME padding); GroupNorm and the style mean sum their
f32 statistics over the ring in ring order; every other layer is local.
Every copy is differentiable, so one ``backward`` carries each halo's
gradient to the neighbour that sent it. The result is the unsharded
forward within summation order.

A ring is the mesh entries that differ only along the split axis
(``Mesh.groups``), in axis order.
"""

from __future__ import annotations

import torch


def exchange_halo(xs: list, rings: list, dim: int, halo: int) -> list:
    """Each entry's tensor of ``xs`` grown by ``halo`` slices on each side
    of ``dim``: its upper ring neighbour's last ones before, its lower
    one's first ones after, each copied to the entry's device; the ring's
    two ends receive zeros."""
    out: list = [None] * len(xs)
    for ring in rings:
        for j, e in enumerate(ring):
            x = xs[e]
            zeros = torch.zeros_like(x.narrow(dim, 0, halo))
            above = xs[ring[j - 1]].narrow(dim, x.shape[dim] - halo, halo).to(x.device) if j > 0 else zeros
            below = xs[ring[j + 1]].narrow(dim, 0, halo).to(x.device) if j < len(ring) - 1 else zeros
            out[e] = torch.cat([above, x, below], dim=dim)
    return out


def ring_sum(parts: list) -> torch.Tensor:
    """A ring's parts summed in ring order on its first entry's device."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


class RingOps:
    """``LocalOps``' operations on (B, C, h, W) blocks, one per mesh entry,
    each layer run by its entry's own replica. The model's forward passes
    the first replica's modules; each is found in every replica by name."""

    def __init__(self, replicas, rings: list):
        self.replicas, self.rings = list(replicas), rings
        self._names = {m: name for name, m in self.replicas[0].named_modules()}

    def _entries(self, module) -> list:
        name = self._names[module]
        return [r.get_submodule(name) for r in self.replicas]

    def layer(self, module, xs: list, *args) -> list:
        """A layer that needs no neighbour's rows (a 1x1 conv, a
        ConvTranspose whose kernel is its stride, StyleMod)."""
        return [m(x, *(a[e] for a in args)) for e, (m, x) in enumerate(zip(self._entries(module), xs))]

    def conv(self, module, xs: list) -> list:
        """A k x k conv: k // 2 rows from each neighbour, then the module's
        own SAME conv, whose k // 2 rows at each end (against its zero
        padding) are cropped."""
        r = module.kernel[0] // 2
        if r == 0:
            return self.layer(module, xs)
        haloed = exchange_halo(xs, self.rings, 2, r)
        return [m(x)[:, :, r:-r] for m, x in zip(self._entries(module), haloed)]

    def group_norm(self, module, xs: list) -> list:
        """f32 sums of x and x^2 per (sample, group) over each entry's
        rows, summed over the ring and divided by the ring's count: the
        statistics every entry normalises with (``GroupNorm.normalize``)."""
        mods, out = self._entries(module), [None] * len(xs)
        for ring in self.rings:
            xf = [xs[e].float() for e in ring]
            flat = [x.reshape(x.shape[0], module.num_groups, -1) for x in xf]
            count = sum(g.shape[-1] for g in flat)
            mean = ring_sum([g.sum(-1) for g in flat]) / count
            var = (ring_sum([(g * g).sum(-1) for g in flat]) / count - mean * mean).clamp_min(0.0)
            for e, x in zip(ring, xf):
                out[e] = mods[e].normalize(x, mean.to(x.device), var.to(x.device)).to(xs[e].dtype)
        return out

    @staticmethod
    def each(fn, *xs) -> list:
        return [fn(*values) for values in zip(*xs)]

    def spatial_mean(self, xs: list) -> list:
        """The f32 mean over (H, W): each entry's sums added over its ring,
        divided by the ring's H x W, on every entry of the ring."""
        out: list = [None] * len(xs)
        for ring in self.rings:
            mean = ring_sum([xs[e].float().sum((2, 3)) for e in ring])
            mean = mean / sum(xs[e].shape[2] * xs[e].shape[3] for e in ring)
            for e in ring:
                out[e] = mean.to(xs[e].device)
        return out


def forward(replicas, rings: list, xs: list) -> list:
    """CellposeNet's forward over (B, h, W, C) blocks, block ``e`` on
    replica ``e``'s device, whose heights are split over ``rings``:
    (B, h, W, 3) f32 outputs, one per entry; differentiable.

    Every block's height must be a multiple of the model's ``divisor``, so
    that it stays even at each pooling level (GSPMD would reshard such a
    split instead)."""
    model, rows, n = replicas[0], xs[0].shape[1], len(rings[0])
    if rows % model.divisor:
        raise ValueError(
            f"image height {rows * n} over sp={n} gives shards of {rows} rows, "
            f"not a multiple of the model's divisor {model.divisor}"
        )
    return model(xs, RingOps(replicas, rings))
