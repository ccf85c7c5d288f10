"""Data-parallel training over a named mesh axis.

Counterpart of ``bioengine_tpu/parallel/data_parallel.py``. The JAX module
jits a pure step with the state replicated and the batch sharded over
``dp``, and XLA inserts the gradient all-reduce. Here one process drives
the whole device group:

- ``replicate`` gives one independent replica per mesh entry (a module, a
  train state, or a tree of tensors);
- ``shard_batch`` splits every leaf's leading dimension on the host into
  equal shards, one on each device;
- ``data_parallel_step`` is the step of the GLOBAL batch, JAX's
  semantics: each replica runs forward on its shard, the predictions are
  concatenated on the first device in shard order, the unchanged
  ``loss_call`` runs once over the whole batch and ``backward`` runs; each
  replica's gradients are summed onto the first replica in shard order by
  explicit device-to-device copies, one optimiser step runs there, and its
  parameters are copied to the others. After every step the replicas are
  equal bit for bit.

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
    """A tensor split over a mesh's entries: one shard per entry, on that
    entry's device, in mesh order."""

    def gather(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole tensor on ``device`` (the mesh's first by default),
        shards concatenated in order; differentiable."""
        device = device or self.mesh.devices[0]
        return torch.cat([s.to(device) for s in self])


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


def _dp_width(mesh: Mesh, axis: str) -> int:
    n = mesh.shape[axis]
    if n != mesh.size:
        raise NotImplementedError(
            f"sharding over {axis}={n} of the mesh {mesh.shape}: only a mesh "
            "whose one axis is the data axis is ported (ROADMAP A10b)"
        )
    return n


def _as_tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def host_parts(placement: Placement, x: Any) -> tuple[type, list]:
    """A leaf under a ``Placement``, still on the host: (``Shards`` and the
    leaf's equal shards, for a spec whose first entry names the mesh's one
    axis) or (``Replicated`` and the whole leaf once per entry, for
    ``replicated``). Raises where the leading dimension does not divide,
    as JAX's sharded ``device_put`` does."""
    mesh, spec = placement.mesh, tuple(placement.spec)
    x = _as_tensor(x)
    if not spec:
        return Replicated, [x] * mesh.size
    if spec[0] is None or any(s is not None for s in spec[1:]):
        raise NotImplementedError(
            f"partition spec {spec}: only the leading dimension over the data "
            "axis is ported (ROADMAP A10b)"
        )
    n = _dp_width(mesh, spec[0])
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(
            f"leading dimension of shape {tuple(x.shape)} does not divide "
            f"into {spec[0]}={n} equal shards"
        )
    return Shards, list(x.chunk(n))


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
    _dp_width(mesh, axis)
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
