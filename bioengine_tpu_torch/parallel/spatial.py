"""Spatial (image-domain) parallelism with halo exchange.

Counterpart of ``bioengine_tpu/parallel/spatial.py``. The first spatial
axis of the port's models' layout, image height of (B, H, W, C) or stack
depth of (B, D, H, W, C), is split over the mesh's ``sp`` axis. Each entry
receives ``halo`` rows (or slices) from its ring neighbours by explicit
device-to-device copies, the edge shards zeros, runs its replica of the
model on the haloed block, and crops the halo off. One process drives the
entries, in mesh order.

With halo >= the receptive radius the interior equals the unsharded
model's; a multi-layer model differs only within the receptive radius of
the GLOBAL borders, where block-level zero padding stands in for the
unsharded model's per-layer padding, and a model with spatially global
statistics (GroupNorm) computes them per block. A single convolution
matches everywhere.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from bioengine_tpu_torch.parallel.data_parallel import Replicated, Shards, place
from bioengine_tpu_torch.parallel.lockstep import exchange_halo
from bioengine_tpu_torch.parallel.mesh import Mesh, Placement, PartitionSpec as P


def halo_exchange(blocks: Shards, halo: int) -> list[torch.Tensor]:
    """Pad each block of ``blocks`` (split on array axis 1 over one mesh
    axis) with ``halo`` slices from its ring neighbours: the upper
    neighbour's last rows before, the lower one's first rows after, each
    copied to the block's device. Returns the blocks grown by 2*halo along
    axis 1, in entry order; edge shards receive zeros (as a zero-padded
    unsharded conv)."""
    if halo == 0:
        return list(blocks)
    return exchange_halo(list(blocks), blocks.mesh.groups(blocks.axis), 1, halo)


def spatial_shard_apply(
    apply_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh: Mesh,
    halo: int,
    axis: str = "sp",
    rank: int = 4,
) -> Callable[[Any, Any], torch.Tensor]:
    """Lift ``apply_fn(params, block)`` to a program split on its first
    spatial axis: (B,H,W,C) height-split at ``rank=4``, volumetric
    (B,D,H,W,C) depth-split at ``rank=5``.

    The wrapped fn takes the FULL array (or ``shard_image``'s blocks) and
    ``params`` (``replicate(mesh, module)``'s replicas, one per entry, or
    one value every entry uses); it splits axis 1 over ``axis``, exchanges
    halos, runs ``apply_fn`` per entry on the haloed block, crops the halo
    and returns the whole output on the mesh's first device. Over a mesh of
    several axes each ring along ``axis`` computes the same bits, so the
    first one's result is returned.

    ``halo`` must not exceed the local shard extent (global size /
    n_shards): the exchange reaches immediate ring neighbours only."""
    spec = _axis1_spec(axis, rank)
    n_shards = mesh.shape[axis]
    ring = mesh.groups(axis)[0]

    def wrapper(params, x):
        ndim = x[0].dim() if isinstance(x, Shards) else np.ndim(x)
        if ndim != rank:
            raise ValueError(
                f"spatial_shard_apply was built with rank={rank} but got a "
                f"rank-{ndim} input — pass rank={ndim} (4 for "
                f"(B,H,W,C) images, 5 for (B,D,H,W,C) volumes)"
            )
        blocks = x if isinstance(x, Shards) else place(Placement(mesh, spec), x)
        extent = blocks[0].shape[1]
        if halo > extent:
            raise ValueError(
                f"halo {halo} exceeds the local shard extent "
                f"{extent} (axis '{axis}' split {n_shards} ways) — "
                f"halo exchange reaches immediate neighbours only; use "
                f"fewer shards or a smaller halo"
            )
        haloed = halo_exchange(blocks, halo)
        outs = []
        for e in ring:
            p = params[e] if isinstance(params, Replicated) else params
            out = apply_fn(p, haloed[e])
            outs.append(out[:, halo:-halo] if halo else out)
        return torch.cat([o.to(mesh.devices[0]) for o in outs], dim=1)

    return wrapper


def _axis1_spec(axis: str, rank: int) -> P:
    """PartitionSpec sharding array axis 1 over ``axis``."""
    return P(None, axis, *([None] * (rank - 2)))


def shard_image(mesh: Mesh, image, axis: str = "sp") -> Shards:
    """Place (B, H, W, C) or (B, D, H, W, C) with axis 1 (height /
    depth) split over ``axis``: one block per entry, on its device."""
    return place(Placement(mesh, _axis1_spec(axis, np.ndim(image))), image)
