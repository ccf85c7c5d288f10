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
  over the others, the entries holding their parts in the order of JAX's
  ``addressable_shards``;
- ``data_parallel_step`` is the step of the GLOBAL batch, JAX's
  semantics: each replica runs forward on its shard, the predictions are
  concatenated on the first device in shard order, the unchanged
  ``loss_call`` runs once over the whole batch and ``backward`` runs; each
  replica's gradients are summed onto the first replica in shard order by
  explicit device-to-device copies, one optimiser step runs there, and its
  parameters are copied to the others. After every step the replicas are
  equal bit for bit. The step runs over a mesh whose one axis is the data
  axis; the dp x sp step waits for ROADMAP A10d.

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

from bioengine_tpu_torch.models.cellpose import LossTrainStep, TrainState
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
    """A leaf under a ``Placement``, still on the host: (a ``Shards``
    maker and each entry's part, for a spec that splits one dimension over
    one mesh axis: equal parts along that axis, the same part on entries
    that differ only along other axes) or (``Replicated`` and the whole
    leaf once per entry, for ``replicated``). Raises where the dimension
    does not divide, as JAX's sharded ``device_put`` does."""
    mesh, spec = placement.mesh, tuple(placement.spec)
    x = _as_tensor(x)
    split = [(dim, axis) for dim, axis in enumerate(spec) if axis is not None]
    if not split:
        return Replicated, [x] * mesh.size
    if len(split) > 1 or isinstance(split[0][1], tuple):
        raise NotImplementedError(
            f"partition spec {spec}: a spec that splits over more than one "
            "mesh axis waits for the dp x sp train step (ROADMAP A10d)"
        )
    dim, axis = split[0]
    if axis not in mesh.axis_names:
        raise ValueError(f"partition spec {spec} names {axis!r}, not an axis of the mesh {mesh.shape}")
    n = mesh.shape[axis]
    if x.dim() <= dim or x.shape[dim] % n:
        where = "leading dimension" if dim == 0 else f"dimension {dim}"
        raise ValueError(
            f"{where} of shape {tuple(x.shape)} does not divide "
            f"into {axis}={n} equal shards"
        )
    parts = x.chunk(n, dim)

    def shards(values, mesh: Mesh) -> Shards:
        return Shards(values, mesh, axis, dim)

    return shards, [parts[c] for c in mesh.coords(axis)]


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
    leaf a tensor or ``shard_batch``'s ``Shards``. ``step`` is
    ``make_loss_train_step``'s (``make_train_step``,
    ``make_stardist_train_step``): its ``loss_call`` runs once over the
    whole batch and its ``update`` on the first replica."""
    if mesh.shape.get(axis) != mesh.size:
        raise NotImplementedError(
            f"a train step over {axis} of the mesh {mesh.shape}: the step over "
            "a mesh with more axes than the data axis waits for the exact dp x sp "
            "train step (ROADMAP A10d)"
        )
    placement = Placement(mesh, (axis,))

    def dp_step(state: DataParallelTrainState, images, *targets):
        if not isinstance(state, DataParallelTrainState) or state.mesh != mesh:
            raise TypeError("data_parallel_step takes replicate(mesh, state) of its own mesh")
        images = place(placement, images)
        targets = [place(placement, t).gather() for t in targets]
        state.optimizer.zero_grad(set_to_none=True)
        for replica in state.replicas:
            replica.train()
        for replica in state.replicas[1:]:
            replica.zero_grad(set_to_none=True)
        pred = Shards([r(x) for r, x in zip(state.replicas, images)], mesh).gather()
        loss, parts = step.loss_call(pred, *targets)
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
