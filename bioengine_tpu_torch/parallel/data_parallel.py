"""Data-parallel training over a named mesh axis.

Counterpart of ``bioengine_tpu/parallel/data_parallel.py``. The JAX module
jits a pure step with the state replicated and the batch sharded over
``dp``, and XLA inserts the gradient all-reduce. Here one process drives
the whole device group:

- ``replicate`` gives one independent replica per mesh entry (a module, a
  train state, or a tree of tensors);
- ``shard_batch`` splits every leaf's leading dimension on the host into
  equal shards, one on each device; over a mesh of several axes (dp x tp,
  dp x sp) a placement splits one dimension over one axis and replicates
  over the others (``Shards``), or two dimensions over two axes
  (``P("dp", "sp")``: ``Blocks``, each entry its (batch part, height part)
  block), the entries holding their parts in the order of JAX's
  ``addressable_shards``;
- ``data_parallel_step`` is the step of the GLOBAL batch, JAX's
  semantics: each replica runs forward on its shard, the predictions are
  concatenated on the first device in shard order, the unchanged
  ``loss_call`` runs once over the whole batch and ``backward`` runs; each
  replica's gradients are summed onto the first replica in shard order by
  explicit device-to-device copies, one optimiser step runs there, and its
  parameters are copied to the others. After every step the replicas are
  equal bit for bit. Over a (dp, sp) mesh the images are split over both
  axes and the forward runs in lockstep over each sp ring
  (``parallel/lockstep.py``: halos before every 3x3 conv, GroupNorm and
  style statistics summed over the ring), which is the unsharded step
  within summation order, as GSPMD's is for JAX.

No ``torch.distributed`` process group and no DDP: the copies work the
same on the CPU, on one card and on several, and they fix the order of
the sums. DDP's rule, the mean of per-shard losses, would be a different
objective for a loss that is a ratio of sums over the batch
(``models/stardist.py`` ``stardist_loss``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from bioengine_tpu_torch.models.cellpose import CellposeNet, LossTrainStep, TrainState
from bioengine_tpu_torch.parallel import lockstep
from bioengine_tpu_torch.parallel.mesh import Mesh, Placement


class _PerEntry(tuple):
    """One value per mesh entry, in mesh order."""

    def __new__(cls, values, mesh: Mesh):
        obj = super().__new__(cls, values)
        obj.mesh = mesh
        return obj


class Shards(_PerEntry):
    """A tensor split over one mesh axis: one part per entry, on that
    entry's device, in mesh order. ``dim`` is the tensor's split dimension
    and ``axis`` the mesh axis; entries that differ only along other axes
    hold copies of the same part (replicated over them). With ``groups``
    > 1 the dimension is that many equal groups and a part is one slice of
    each (a fused qkv weight split by heads)."""

    def __new__(cls, values, mesh: Mesh, axis: str = "dp", dim: int = 0, groups: int = 1):
        obj = super().__new__(cls, values, mesh)
        obj.axis, obj.dim, obj.groups = axis, dim, groups
        return obj

    def parts(self) -> list:
        """One part per coordinate along ``axis``, in order."""
        coords = self.mesh.coords(self.axis)
        return [self[coords.index(j)] for j in range(self.mesh.shape[self.axis])]

    def gather(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole tensor on ``device`` (the mesh's first by default),
        parts concatenated in order; differentiable."""
        device = device or self.mesh.devices[0]
        parts = [s.to(device).chunk(self.groups, self.dim) for s in self.parts()]
        return torch.cat([p[g] for g in range(self.groups) for p in parts], dim=self.dim)


class Blocks(_PerEntry):
    """A tensor split on two dimensions over two mesh axes: dimension
    ``dims[k]`` over ``axes[k]``, one block per entry, on that entry's
    device, in mesh order; entries that differ only along other axes hold
    copies of the same block."""

    def __new__(cls, values, mesh: Mesh, axes: tuple, dims: tuple):
        obj = super().__new__(cls, values, mesh)
        obj.axes, obj.dims = axes, dims
        return obj

    def gather(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole tensor on ``device`` (the mesh's first by default),
        blocks concatenated in order; differentiable."""
        device = device or self.mesh.devices[0]
        (outer, inner), (d0, d1) = self.axes, self.dims
        at = {}
        for e, c in enumerate(zip(self.mesh.coords(outer), self.mesh.coords(inner))):
            at.setdefault(c, self[e])
        n0, n1 = self.mesh.shape[outer], self.mesh.shape[inner]
        rows = [torch.cat([at[i, j].to(device) for j in range(n1)], dim=d1) for i in range(n0)]
        return torch.cat(rows, dim=d0)


class Replicated(_PerEntry):
    """One copy of a value per mesh entry, in mesh order."""


@dataclasses.dataclass
class DataParallelTrainState(TrainState):
    """A ``TrainState`` over a mesh: ``module`` is the first replica and
    ``optimizer`` updates it; ``replicas`` holds every replica (the first
    included), one per mesh entry."""

    replicas: tuple = ()
    mesh: Optional[Mesh] = None

    def sync_replicas(self) -> None:
        """Copy the first replica's parameters and buffers to the others."""
        with torch.no_grad():
            first = self.replicas[0].state_dict()
            for replica in self.replicas[1:]:
                for name, t in replica.state_dict().items():
                    t.copy_(first[name])


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of dicts, lists and tuples, as
    ``jax.tree_util.tree_map`` walks them (None is an empty node);
    ``Shards`` and ``Replicated`` are leaves."""
    if isinstance(tree, _PerEntry):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    if tree is None:
        return None
    return fn(tree)


def _as_tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def host_parts(placement: Placement, x: Any) -> tuple[Callable, list]:
    """A leaf under a ``Placement``, still on the host: (a ``Shards`` or,
    for two split dimensions, a ``Blocks`` maker and each entry's part, for
    a spec that splits one or two dimensions, each over one mesh axis:
    equal parts along each, the same part on entries that differ only
    along the mesh's other axes) or
    (``Replicated`` and the whole leaf once per entry, for ``replicated``).
    Raises where a dimension does not divide, as JAX's sharded
    ``device_put`` does."""
    mesh, spec = placement.mesh, tuple(placement.spec)
    x = _as_tensor(x)
    split = [(dim, axis) for dim, axis in enumerate(spec) if axis is not None]
    if not split:
        return Replicated, [x] * mesh.size
    axes = [axis for _, axis in split]
    if len(split) > 2 or any(isinstance(a, tuple) for a in axes) or len(set(axes)) < len(axes):
        raise NotImplementedError(
            f"partition spec {spec}: a placement splits at most two dimensions, "
            "each over one mesh axis of its own"
        )
    for dim, axis in split:
        if axis not in mesh.axis_names:
            raise ValueError(f"partition spec {spec} names {axis!r}, not an axis of the mesh {mesh.shape}")
        n = mesh.shape[axis]
        if x.dim() <= dim or x.shape[dim] % n:
            where = "leading dimension" if dim == 0 else f"dimension {dim}"
            raise ValueError(
                f"{where} of shape {tuple(x.shape)} does not divide "
                f"into {axis}={n} equal shards"
            )
    coords = list(zip(*(mesh.coords(axis) for axis in axes)))
    blocks = {}
    for c in dict.fromkeys(coords):  # one view per block, shared by its entries
        block = x
        for (dim, axis), k in zip(split, c):
            block = block.chunk(mesh.shape[axis], dim)[k]
        blocks[c] = block
    parts = [blocks[c] for c in coords]
    (dim, axis), *second = split
    if second:
        return lambda values, mesh: Blocks(values, mesh, (axis, second[0][1]), (dim, second[0][0])), parts
    return lambda values, mesh: Shards(values, mesh, axis, dim), parts


def place(placement: Placement, x: Any) -> Any:
    """One leaf under a ``Placement``, each part on its device (a replicated
    leaf copied to each, so the copies are independent); a leaf already
    placed is returned as it is."""
    if isinstance(x, _PerEntry):
        return x
    kind, parts = host_parts(placement, x)
    mesh = placement.mesh
    return kind([p.to(d, copy=kind is Replicated) for p, d in zip(parts, mesh.devices)], mesh)


def shard_batch(mesh: Mesh, batch: Any, axis: str = "dp") -> Any:
    """Place a host pytree batch onto the mesh, leading dim sharded."""
    placement = Placement(mesh, (axis,))
    return tree_map(lambda x: place(placement, x), batch)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Replicate a train state, a module or a tree of tensors across the
    whole mesh, one independent replica per entry (stacked entries
    included). A ``TrainState`` becomes a ``DataParallelTrainState`` whose
    first replica is the state's own module, moved to the first device (an
    optimiser that already holds moments holds them there); a module
    becomes ``Replicated`` modules; a tree becomes ``Replicated`` trees."""
    first = mesh.devices[0]
    if isinstance(tree, DataParallelTrainState) and tree.mesh == mesh:
        return tree
    if isinstance(tree, TrainState):
        module = tree.module.to(first)
        replicas = (module, *(copy.deepcopy(module).to(d) for d in mesh.devices[1:]))
        return DataParallelTrainState(
            module=module, optimizer=tree.optimizer, step=tree.step,
            replicas=replicas, mesh=mesh,
        )
    if isinstance(tree, nn.Module):
        module = tree.to(first)
        return Replicated([module, *(copy.deepcopy(module).to(d) for d in mesh.devices[1:])], mesh)
    return Replicated(
        [tree_map(lambda x: _as_tensor(x).to(d, copy=True), tree) for d in mesh.devices], mesh
    )


def _sum_gradients(replicas) -> None:
    """Each replica's gradients summed onto the first, in shard order."""
    params = [list(r.parameters()) for r in replicas]
    for j, p0 in enumerate(params[0]):
        for other in params[1:]:
            g = other[j].grad
            if g is None:
                continue
            g = g.to(p0.device)
            if p0.grad is None:
                p0.grad = g.clone()
            else:
                p0.grad.add_(g)


def data_parallel_step(step: LossTrainStep, mesh: Mesh, axis: str = "dp") -> Callable:
    """A ``(state, *batch) -> (state, metrics)`` step of the global batch
    over ``mesh``; ``state`` is ``replicate(mesh, state)``'s and each batch
    leaf a tensor or a placed leaf (``shard_batch``'s, or over a (dp, sp)
    mesh ``P(axis, "sp")``'s). ``step`` is ``make_loss_train_step``'s
    (``make_train_step``, ``make_stardist_train_step``): its ``loss_call``
    runs once over the whole batch and its ``update`` on the first replica.

    The mesh holds ``axis`` and at most ``sp`` besides. With ``sp`` wider
    than 1 the images' height is split over it too and the forward runs in
    lockstep over each sp ring (CellposeNet only); at width 1 the step is
    the dp step."""
    if axis not in mesh.axis_names or set(mesh.axis_names) - {axis, "sp"}:
        raise NotImplementedError(
            f"a train step over the mesh {mesh.shape}: the batch splits over {axis!r} "
            "and image height over 'sp', and the step splits over no other axis"
        )
    spatial = mesh.shape.get("sp", 1) > 1
    placement = Placement(mesh, (axis, "sp") if spatial else (axis,))
    rings = mesh.groups("sp") if spatial else None

    def dp_step(state: DataParallelTrainState, images, *targets):
        if not isinstance(state, DataParallelTrainState) or state.mesh != mesh:
            raise TypeError("data_parallel_step takes replicate(mesh, state) of its own mesh")
        if spatial and not isinstance(state.module, CellposeNet):
            raise NotImplementedError(
                f"the forward split over sp is CellposeNet's; the model is a {type(state.module).__name__}"
            )
        images = place(placement, images)
        if spatial and (getattr(images, "axes", None), getattr(images, "dims", None)) != ((axis, "sp"), (0, 1)):
            raise ValueError(f"over a (dp, sp) mesh the images are split P({axis!r}, 'sp'): batch and height")
        targets = [place(placement, t).gather() for t in targets]
        state.optimizer.zero_grad(set_to_none=True)
        for replica in state.replicas:
            replica.train()
        for replica in state.replicas[1:]:
            replica.zero_grad(set_to_none=True)
        if spatial:
            pred = Blocks(lockstep.forward(state.replicas, rings, list(images)), mesh, images.axes, images.dims)
        else:
            pred = Shards([r(x) for r, x in zip(state.replicas, images)], mesh)
        loss, parts = step.loss_call(pred.gather(), *targets)
        loss.backward()
        _sum_gradients(state.replicas)
        step.update(state)
        state.sync_replicas()
        return state, step.metrics(loss, parts)

    return dp_step


def per_device_batch(global_batch: int, mesh: Mesh, axis: str = "dp") -> int:
    n = mesh.shape[axis]
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by {axis}={n}"
        )
    return global_batch // n
