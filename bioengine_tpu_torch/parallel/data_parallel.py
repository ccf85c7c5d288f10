"""Data-parallel training over a named mesh axis.

Counterpart of ``bioengine_tpu/parallel/data_parallel.py``. The JAX module
jits a pure step with the state replicated and the batch sharded over
``dp``, and XLA inserts the gradient all-reduce. Here one process drives
the whole device group:

- ``replicate`` gives one independent replica per mesh entry (a module, a
  train state, or a tree of tensors);
- ``shard_batch`` splits every leaf's leading dimension on the host into
  equal shards, one on each device; over a mesh of several axes (dp x tp,
  dp x sp) a placement splits one dimension over one axis, or over a tuple
  of axes (their product, row-major), and replicates over the others
  (``Shards``), or several dimensions (``P("dp", "sp")``: ``Blocks``, each
  entry its (batch part, height part) block), the entries holding their
  parts in the order of JAX's ``addressable_shards``; a spec naming one
  axis twice raises ``DuplicateSpecError``, as in JAX;
- ``data_parallel_step`` is the step of the GLOBAL batch, JAX's
  semantics: each replica at coordinate 0 of the mesh's other axes runs
  forward on its shard, the predictions are concatenated on the first
  device in shard order, the unchanged ``loss_call`` runs once over the
  whole batch and ``backward`` runs; those replicas' gradients are summed
  onto the first replica in shard order by explicit device-to-device
  copies, one optimiser step runs there, and its parameters are copied to
  every other replica. After every step the replicas are equal bit for
  bit. Over a (dp, sp) mesh CellposeNet's images are split over both axes
  and the forward runs in lockstep over each sp ring
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

    def over_tp(self, dim: int, groups: Optional[int] = None, bounds: Optional[tuple] = None) -> bool:
        """Whether this splits ``dim`` over ``tp`` alone (in ``groups``
        groups and at ``bounds``, where given): only a ``Shards`` does."""
        return False


class Shards(_PerEntry):
    """A tensor split over one mesh axis, or a tuple of axes: one part per
    entry, on that entry's device, in mesh order. ``dim`` is the tensor's
    split dimension and ``axis`` the mesh axis; entries that differ only
    along other axes hold copies of the same part (replicated over them).
    With ``groups`` > 1 the dimension is that many equal groups and a part
    is one slice of each (a fused qkv weight split by heads); ``bounds``,
    the n + 1 offsets within a group where the parts start (even when
    None), lets the parts differ in size (heads that do not divide)."""

    def __new__(cls, values, mesh: Mesh, axis="dp", dim: int = 0, groups: int = 1,
                bounds: Optional[tuple] = None):
        obj = super().__new__(cls, values, mesh)
        obj.axis, obj.dim, obj.groups, obj.bounds = axis, dim, groups, bounds
        return obj

    def over_tp(self, dim: int, groups: Optional[int] = None, bounds: Optional[tuple] = None) -> bool:
        return (self.axis == "tp" and self.dim == dim and groups in (None, self.groups)
                and (bounds is None or tuple(self.bounds or ()) == tuple(bounds)))

    def parts(self) -> list:
        """One part per coordinate along ``axis``, in order."""
        coords = self.mesh.coords(self.axis)
        return [self[coords.index(j)] for j in range(self.mesh.axis_size(self.axis))]

    def gather(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole tensor on ``device`` (the mesh's first by default),
        parts concatenated in order; differentiable."""
        device = device or self.mesh.devices[0]
        parts = [s.to(device).tensor_split(self.groups, self.dim) for s in self.parts()]
        return torch.cat([p[g] for g in range(self.groups) for p in parts], dim=self.dim)


class Blocks(_PerEntry):
    """A tensor split on several dimensions, each over a mesh axis or a
    tuple of axes: dimension ``dims[k]`` over ``axes[k]``, one block per
    entry, on that entry's device, in mesh order; entries that differ
    only along other axes hold copies of the same block."""

    def __new__(cls, values, mesh: Mesh, axes: tuple, dims: tuple):
        obj = super().__new__(cls, values, mesh)
        obj.axes, obj.dims = axes, dims
        return obj

    @property
    def spec(self) -> tuple:
        """The partition spec this placement follows."""
        out = [None] * (max(self.dims) + 1)
        for axis, dim in zip(self.axes, self.dims):
            out[dim] = axis
        return tuple(out)

    def _at(self) -> dict:
        at = {}
        for e, c in enumerate(zip(*(self.mesh.coords(a) for a in self.axes))):
            at.setdefault(c, self[e])
        return at

    def parts(self) -> list:
        """One block per combination of coordinates, in row-major order."""
        at = self._at()
        return [at[c] for c in sorted(at)]

    def gather(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole tensor on ``device`` (the mesh's first by default),
        blocks concatenated in order; differentiable."""
        device = device or self.mesh.devices[0]
        at = self._at()
        sizes = [self.mesh.axis_size(a) for a in self.axes]

        def cat(prefix: tuple) -> torch.Tensor:
            if len(prefix) == len(sizes):
                return at[prefix].to(device)
            level = len(prefix)
            return torch.cat([cat(prefix + (i,)) for i in range(sizes[level])], dim=self.dims[level])

        return cat(())


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


class DuplicateSpecError(ValueError):
    """A partition spec that names one mesh axis twice, as JAX's
    ``DuplicateSpecError`` (a ``ValueError``)."""


def _split_dims(mesh: Mesh, spec: tuple) -> list:
    """(dim, axis) of each split dimension of ``spec`` (an axis is a name
    or a tuple of names), checked against ``mesh`` as JAX's
    ``NamedSharding`` checks it: every name an axis of the mesh, none
    named twice."""
    split = [(dim, axis) for dim, axis in enumerate(spec) if axis not in (None, ())]
    seen = set()
    for _, axis in split:
        for name in axis if isinstance(axis, tuple) else (axis,):
            if name not in mesh.axis_names:
                raise ValueError(f"partition spec {spec} names {name!r}, not an axis of the mesh {mesh.shape}")
            if name in seen:
                raise DuplicateSpecError(
                    f"partition spec {spec} names the mesh axis {name!r} twice: a mesh axis "
                    "splits at most one dimension"
                )
            seen.add(name)
    return split


def host_parts(placement: Placement, x: Any) -> tuple[Callable, list]:
    """A leaf under a ``Placement``, still on the host: (a ``Shards``, or
    for several split dimensions a ``Blocks``, maker and each entry's
    part: equal parts along each split dimension, a dimension split over a
    tuple of axes as over their product in row-major order, the same part
    on entries that differ only along the mesh's other axes) or
    (``Replicated`` and the whole leaf once per entry, for ``replicated``).
    Raises where a dimension does not divide, as JAX's sharded
    ``device_put`` does, and ``DuplicateSpecError`` for a spec naming one
    axis twice."""
    mesh, spec = placement.mesh, tuple(placement.spec)
    x = _as_tensor(x)
    split = _split_dims(mesh, spec)
    if not split:
        return Replicated, [x] * mesh.size
    for dim, axis in split:
        n = mesh.axis_size(axis)
        if x.dim() <= dim or x.shape[dim] % n:
            where = "leading dimension" if dim == 0 else f"dimension {dim}"
            raise ValueError(
                f"{where} of shape {tuple(x.shape)} does not divide "
                f"into {axis}={n} equal shards"
            )
    coords = list(zip(*(mesh.coords(axis) for _, axis in split)))
    blocks = {}
    for c in dict.fromkeys(coords):  # one view per block, shared by its entries
        block = x
        for (dim, axis), k in zip(split, c):
            block = block.chunk(mesh.axis_size(axis), dim)[k]
        blocks[c] = block
    parts = [blocks[c] for c in coords]
    if len(split) == 1:
        (dim, axis), = split
        return lambda values, mesh: Shards(values, mesh, axis, dim), parts
    axes, dims = tuple(a for _, a in split), tuple(d for d, _ in split)
    return lambda values, mesh: Blocks(values, mesh, axes, dims), parts


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


def _whole(x: Any) -> Any:
    """A placed leaf's whole value on its mesh's first device; any other
    leaf as it is."""
    if isinstance(x, Replicated):
        return x[0]
    return x.gather() if isinstance(x, _PerEntry) else x


def data_parallel_step(step: LossTrainStep, mesh: Mesh, axis: str = "dp") -> Callable:
    """A ``(state, *batch) -> (state, metrics)`` step of the global batch
    over ``mesh``; ``state`` is ``replicate(mesh, state)``'s and each batch
    leaf a tensor or a placed leaf. ``step`` is ``make_loss_train_step``'s
    (``make_train_step``, ``make_stardist_train_step``): its ``loss_call``
    runs once over the whole batch and its ``update`` on the first replica.

    The batch splits over ``axis`` and the mesh's other axes replicate, as
    ``jit_data_parallel_step``'s constraints do over any mesh: the
    replicas at coordinate 0 of every other axis run the forward on their
    parts, and after the update every replica holds the first one's
    parameters. Over a mesh with ``sp`` wider than 1, CellposeNet's images
    (host arrays, or placed ``P(axis, "sp")``) are split on height too and
    its forward runs in lockstep over each sp ring; any other model, or
    images placed ``P(axis)``, takes the step with ``sp`` replicated."""
    if axis not in mesh.axis_names:
        raise ValueError(f"partition spec P({axis!r}) names {axis!r}, not an axis of the mesh {mesh.shape}")

    def firsts(keep: set) -> list:
        """The entries at coordinate 0 of every axis but ``keep``, in mesh
        order: entry 0 first."""
        return [e for e in range(mesh.size) if all(mesh.coords(a)[e] == 0 for a in mesh.axis_names if a not in keep)]

    lead = firsts({axis})  # one entry per coordinate along ``axis``
    batch = Placement(mesh, (axis,))
    spatial = axis != "sp" and mesh.shape.get("sp", 1) > 1
    blocks = Placement(mesh, (axis, "sp")) if spatial else None
    if spatial:
        # the lockstep runs one entry per (axis, sp) block; its rings are
        # lists of positions in ``lock``
        lock = firsts({axis, "sp"})
        at = {e: i for i, e in enumerate(lock)}
        rings = [[at[e] for e in ring] for ring in mesh.groups("sp") if ring[0] in at]
        block = {(mesh.coords(axis)[e], mesh.coords("sp")[e]): i for i, e in enumerate(lock)}
        source = [block[mesh.coords(axis)[e], mesh.coords("sp")[e]] for e in range(mesh.size)]

    def lockstep_images(state, images) -> bool:
        if not (spatial and isinstance(state.module, CellposeNet)):
            return False
        if not isinstance(images, _PerEntry):
            return True
        return isinstance(images, Blocks) and images.mesh == mesh and (images.axes, images.dims) == ((axis, "sp"), (0, 1))

    def dp_step(state: DataParallelTrainState, images, *targets):
        if not isinstance(state, DataParallelTrainState) or state.mesh != mesh:
            raise TypeError("data_parallel_step takes replicate(mesh, state) of its own mesh")
        split_height = lockstep_images(state, images)
        if split_height:
            images = place(blocks, images)
            targets = [place(blocks, t).gather() for t in targets]
            replicas = [state.replicas[e] for e in lock]
        else:
            placed = isinstance(images, Shards) and images.mesh == mesh and (images.axis, images.dim) == (axis, 0)
            images = images if placed else place(batch, _whole(images))
            targets = [place(batch, t).gather() for t in targets]
            replicas = [state.replicas[e] for e in lead]
        state.optimizer.zero_grad(set_to_none=True)
        for replica in replicas:
            replica.train()
        for replica in replicas[1:]:
            replica.zero_grad(set_to_none=True)
        if split_height:
            outs = lockstep.forward(replicas, rings, [images[e] for e in lock])
            pred = Blocks([outs[i] for i in source], mesh, images.axes, images.dims).gather()
        else:
            first = mesh.devices[0]
            pred = torch.cat([r(images[e]).to(first) for r, e in zip(replicas, lead)])
        loss, parts = step.loss_call(pred, *targets)
        loss.backward()
        _sum_gradients(replicas)
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
