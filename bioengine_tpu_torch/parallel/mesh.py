"""Device meshes for the PyTorch port.

Own copy of ``bioengine_tpu/parallel/mesh.py``. The framework's
parallelism axes:

- ``dp`` — data parallel (batch sharding; gradients summed across the
  replicas by explicit device-to-device copies)
- ``sp`` — spatial/sequence parallel (image tiles with halo exchange,
  or token-sequence shards for ring attention: ``parallel/spatial.py``,
  ``parallel/ring.py``)
- ``tp`` — tensor parallel (Megatron-style weight slices,
  ``parallel/tensor_parallel.py``)

A replica *owns* a mesh, and scaling happens in units of replicas, each
with a fixed device group. One process drives the whole group: each device
of the mesh holds a replica of the module, and batches are split on the
host into equal shards, one per device.

``MeshSpec`` and ``VirtualMeshSpec`` are statement-for-statement copies.
A port ``Mesh`` is ordered axis names and sizes over a flat list of
``torch.device``s, row-major. An explicit device list may repeat a device:
on the CPU, torch has one device, and a mesh of width N is N entries of
``cpu``; on one card a stacked ``[cuda:0, cuda:0]`` mesh runs two shards
there. Lease resolution (``runtime.devices.resolve_devices``) never stacks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence

import torch

from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device

@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh description, serializable into app manifests."""

    axes: Mapping[str, int]  # ordered axis name -> size; -1 = fill

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = dict(self.axes)
        fill_axes = [k for k, v in sizes.items() if v == -1]
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if n_devices % fixed:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes {sizes}"
            )
        remaining = n_devices // fixed
        if not fill_axes:
            if fixed != n_devices:
                raise ValueError(
                    f"Mesh {sizes} needs {fixed} devices, have {n_devices}"
                )
            return sizes
        if len(fill_axes) > 1:
            raise ValueError("At most one axis may be -1")
        sizes[fill_axes[0]] = remaining
        return sizes


@dataclasses.dataclass(frozen=True)
class VirtualMeshSpec:
    """Hardware-neutral mesh description for a whole DEPLOYMENT.

    The virtual-device layer (VirtualFlow's decoupling, PAPERS.md): a
    deployment declares ``stages`` (the cross-host pipeline axis — each
    stage placeable on a different host's chip lease) and per-stage
    ``axes`` (dp/tp over whatever chips that stage's lease resolves to,
    ``-1`` = fill). The SAME spec then maps onto a v5e-1, a v5e-8, a
    two-host mesh, or a forced-host-device CPU mesh: the planner
    (serving/mesh_plan.py) picks hosts, and each shard's engine resolves
    ``axes`` over its concrete lease via :meth:`stage_axes` — app code
    never names a topology.
    """

    stages: int = 1
    axes: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: {"dp": -1}
    )

    def stage_axes(self, n_devices: int) -> dict[str, int]:
        """Resolve the per-stage axes over one stage's concrete lease."""
        return MeshSpec(dict(self.axes)).resolve(n_devices)

    def shape(self, n_devices_per_stage: int) -> dict[str, int]:
        """The logical mesh shape this spec yields on a concrete
        topology — ``pp`` (pipeline/stage axis) first, then the
        resolved per-stage axes."""
        out: dict[str, int] = {}
        if self.stages > 1:
            out["pp"] = self.stages
        out.update(self.stage_axes(n_devices_per_stage))
        return out



class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: for each dimension of a value, the
    mesh axis it is split over, or None to keep it whole; dimensions past
    the spec's length are whole, and the empty spec is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over a flat, row-major list of devices."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Ordered axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, axis) -> int:
        """The size of ``axis``, or of a tuple of axes (their product)."""
        names = axis if isinstance(axis, tuple) else (axis,)
        return math.prod(self.shape[a] for a in names)

    def coords(self, axis) -> list[int]:
        """Each entry's coordinate along ``axis``, in mesh order; along a
        tuple of axes, their coordinates combined in row-major order (the
        order of JAX's ``addressable_shards`` for such a dimension)."""
        if isinstance(axis, tuple):
            out = [0] * self.size
            for a in axis:
                inner = self.coords(a)
                out = [c * self.shape[a] + k for c, k in zip(out, inner)]
            return out
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} is not in the mesh {self.shape}")
        at = self.axis_names.index(axis)
        stride = math.prod(self.sizes[at + 1 :])
        return [(e // stride) % self.sizes[at] for e in range(self.size)]

    def groups(self, axis: str) -> list[list[int]]:
        """The entries that differ only along ``axis``, one list per
        coordinate of the other axes (in mesh order), each ordered along
        ``axis``: the tp groups of a (dp, tp) mesh, the rings of ``sp``."""
        coords = self.coords(axis)
        n = self.shape[axis]
        firsts = [e for e in range(self.size) if coords[e] == 0]
        stride = math.prod(self.sizes[self.axis_names.index(axis) + 1 :])
        return [[e + j * stride for j in range(n)] for e in firsts]


@dataclasses.dataclass(frozen=True)
class Placement:
    """A mesh and a partition spec: the axis, or tuple of axes, each
    leading dimension is split over (``None`` keeps a dimension whole); an
    empty spec is replicated. ``prefetch_to_device(sharding=)`` and the
    data-parallel helpers take it as JAX's ``NamedSharding``."""

    mesh: Mesh
    spec: tuple = ()


def make_mesh(
    axes: Mapping[str, int],
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """Build a named Mesh over ``devices`` (default: every CUDA device,
    raising without CUDA). An explicit list may repeat a device."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(resolve_device(d) for d in devices)
    sizes = MeshSpec(axes).resolve(len(devices))
    return Mesh(tuple(sizes.keys()), tuple(sizes.values()), devices)


def sharding(mesh: Mesh, *spec) -> Placement:
    return Placement(mesh, tuple(spec))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def local_device_mesh(n: int = 1, axis: str = "dp", device: DeviceLike = None) -> Mesh:
    """A mesh over the first ``n`` local devices (single-replica case): the
    first ``n`` cards, or ``n`` entries of ``cpu`` with ``device="cpu"``."""
    base = resolve_device(device)
    if base.type == "cpu":
        return make_mesh({axis: n}, [base] * n)
    if n > torch.cuda.device_count():
        raise ValueError(f"a mesh of {n} cards, but {torch.cuda.device_count()} CUDA device(s) exist")
    return make_mesh({axis: n}, [torch.device("cuda", i) for i in range(n)])
