"""Mesh planning — placement POLICY for deployments bigger than one
host's lease, split from engine EXECUTION.

Every earlier serving layer places a REPLICA onto ONE host and stops at
the chips that host leases (PR 5 sharding, PR 8 scheduling, PR 11 warm
pools). This module plans one logical DEPLOYMENT across several hosts'
leases: a hardware-neutral :class:`MeshConfig` (the manifest's
``deployment_config.<dep>.mesh`` block) names the parallelism shape —
pipeline stages, per-stage chips, per-stage dp/tp axes — and
:func:`plan_mesh` maps it onto whatever topology is actually joined,
using the SAME pluggable cost-model contract the global scheduler's
replica placement rides (``ServeController.scorer_factory`` — the
feature dict is the interface, so a learned policy scores hosts the
day it scores replicas).

Topology portability (VirtualFlow's virtual-device decoupling, Maple's
portable-across-clusters placement — PAPERS.md): the same spec resolves
to

- one host with enough chips → all stages colocate there (the warm-
  affinity bonus pulls them together; activations still hop through the
  RPC plane, but loopback),
- several small hosts → stages span them, activations crossing hosts on
  the PR 3 zero-copy OOB transport,
- a forced-host-device CPU mesh → the same plan, exercised hermetically.

Execution lives in :mod:`bioengine_tpu_torch.serving.mesh_replica`
(``CrossHostEngine`` + ``MeshReplica``); this module never touches a
device.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Iterable, Optional

MESH_KINDS = ("pipeline", "dp", "tp")


class MeshPlanError(RuntimeError):
    """No plan satisfies the spec on the currently-joined topology.
    Carries ``chips_needed`` so the controller can enqueue a pending
    workload sized for the WHOLE mesh (the provisioner's scale-up
    signal), not one replica's slice."""

    def __init__(self, message: str, chips_needed: int = 0):
        super().__init__(message)
        self.chips_needed = chips_needed


@dataclass
class MeshConfig:
    """Hardware-neutral multi-host mesh spec (manifest:
    ``deployment_config.<dep>.mesh``).

    ``stages`` is the cross-host axis: each stage lands on (up to) one
    host's lease of ``chips_per_stage`` chips and holds ONLY its slice
    of the model — the axis that serves checkpoints bigger than any
    single lease. ``kind`` names how the driver composes shard outputs:

    - ``pipeline`` — stage k+1 consumes stage k's activations
      (sequential hops; the shard contract is
      ``stage_method(stage, inputs)`` returning the activation array),
    - ``dp`` — every shard holds the full model; the batch splits
      across shards and outputs concatenate,
    - ``tp`` — every shard computes a partial output from the full
      input; the driver sums (the host-mediated all-reduce of the
      Megatron two-layer block).

    ``axes`` is the PER-STAGE virtual-device spec resolved over each
    shard's concrete lease (parallel/mesh.py ``VirtualMeshSpec``), so
    within-host dp/tp ride the PR 5 engine unchanged. ``entry_methods``
    are the instance methods the mesh driver intercepts and fans across
    shards; everything else routes to stage 0.
    """

    stages: int = 2
    chips_per_stage: int = 1
    kind: str = "pipeline"
    axes: dict = field(default_factory=lambda: {"dp": -1})
    stage_method: str = "run_stage"
    entry_methods: tuple = ("predict",)
    # per-stage-hop budget; None defers to BIOENGINE_MESH_STAGE_TIMEOUT_S
    stage_timeout_s: Optional[float] = None
    # when only one capable host remains, re-plans may colocate every
    # stage there (degraded but serving) — 0 disables the fallback and
    # keeps the deployment down until a second host joins
    single_host_fallback: bool = True

    @classmethod
    def from_config(cls, cfg: dict) -> "MeshConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(cfg) - known)
        if unknown:
            raise ValueError(
                f"unknown mesh config keys: {unknown} "
                f"(accepted: {sorted(known)})"
            )
        out = cls()
        if "stages" in cfg:
            out.stages = int(cfg["stages"])
            if out.stages < 1:
                raise ValueError("mesh.stages must be >= 1")
        if "chips_per_stage" in cfg:
            out.chips_per_stage = int(cfg["chips_per_stage"])
            if out.chips_per_stage < 1:
                raise ValueError("mesh.chips_per_stage must be >= 1")
        if "kind" in cfg:
            out.kind = str(cfg["kind"])
            if out.kind not in MESH_KINDS:
                raise ValueError(
                    f"mesh.kind '{out.kind}' not in {list(MESH_KINDS)}"
                )
        if "axes" in cfg:
            axes = dict(cfg["axes"])
            for k, v in axes.items():
                if k not in ("dp", "tp"):
                    # the engine's virtual-device layer shards batches
                    # over dp and weights over tp; any other name (or a
                    # typo) would pass here only to fail every shard
                    # start at deploy time
                    raise ValueError(
                        f"mesh.axes names unsupported axis {k!r} "
                        "(per-stage axes are 'dp' and 'tp'; the stage "
                        "axis is 'stages')"
                    )
                if int(v) != -1 and int(v) < 1:
                    # -1 = fill; anything else must be a real width
                    # (negative sizes survive Python's modulo inside
                    # MeshSpec.resolve and would silently clamp to an
                    # unsharded engine downstream)
                    raise ValueError(
                        f"mesh.axes entry {k!r}: {v!r} invalid "
                        "(use -1 to fill, or a positive size)"
                    )
            out.axes = {k: int(v) for k, v in axes.items()}
        if "stage_method" in cfg:
            out.stage_method = str(cfg["stage_method"])
        if "entry_methods" in cfg:
            methods = cfg["entry_methods"]
            if isinstance(methods, str):
                methods = [methods]
            out.entry_methods = tuple(str(m) for m in methods)
            if not out.entry_methods:
                raise ValueError("mesh.entry_methods must not be empty")
        if "stage_timeout_s" in cfg and cfg["stage_timeout_s"] is not None:
            out.stage_timeout_s = float(cfg["stage_timeout_s"])
            if out.stage_timeout_s <= 0:
                raise ValueError("mesh.stage_timeout_s must be > 0")
        if "single_host_fallback" in cfg:
            out.single_host_fallback = bool(cfg["single_host_fallback"])
        # the axes spec must actually resolve over one stage's lease —
        # catching it here keeps the failure typed at BUILD time instead
        # of a raw ValueError at shard-engine construction (or worse,
        # from mesh_shape() inside a later get_app_status)
        try:
            out.mesh_shape()
        except ValueError as e:
            raise ValueError(
                f"mesh.axes {out.axes} do not resolve over "
                f"chips_per_stage={out.chips_per_stage}: {e}"
            ) from e
        return out

    @property
    def total_chips(self) -> int:
        return self.stages * self.chips_per_stage

    def resolved_stage_timeout_s(self) -> Optional[float]:
        if self.stage_timeout_s is not None:
            return self.stage_timeout_s
        raw = os.environ.get("BIOENGINE_MESH_STAGE_TIMEOUT_S", "")
        return float(raw) if raw else None

    def mesh_shape(self, n_devices_per_stage: Optional[int] = None) -> dict:
        """Logical shape for status surfaces: the stage axis plus the
        per-stage axes resolved over one lease."""
        from bioengine_tpu_torch.parallel.mesh import VirtualMeshSpec

        return VirtualMeshSpec(stages=self.stages, axes=self.axes).shape(
            n_devices_per_stage or self.chips_per_stage
        )


@dataclass
class ShardAssignment:
    """One stage of the plan pinned to a host. ``device_ids`` is filled
    when the controller leases the chips (plan first, lease second —
    the plan itself is side-effect free)."""

    stage: int
    host_id: str
    service_id: str
    n_chips: int
    device_ids: list[int] = field(default_factory=list)


@dataclass
class MeshPlan:
    config: MeshConfig
    shards: list[ShardAssignment]

    @property
    def hosts(self) -> list[str]:
        return sorted({s.host_id for s in self.shards})

    @property
    def cross_host(self) -> bool:
        return len(self.hosts) > 1

    def describe(self) -> dict:
        return {
            "kind": self.config.kind,
            "mesh_shape": self.config.mesh_shape(),
            "cross_host": self.cross_host,
            "hosts": self.hosts,
            "shards": [
                {
                    "stage": s.stage,
                    "host_id": s.host_id,
                    "n_chips": s.n_chips,
                    "device_ids": list(s.device_ids),
                }
                for s in self.shards
            ],
        }


def plan_mesh(
    config: MeshConfig,
    hosts: Iterable,
    scorer,
    avoid_hosts: Iterable[str] = (),
) -> MeshPlan:
    """Place every stage of ``config`` onto ``hosts`` (HostRecord-shaped:
    ``host_id`` / ``service_id`` / ``n_chips`` / ``free_chip_ids()``).

    Stage by stage, each candidate host is scored through the SAME
    feature-dict contract the global scheduler's replica placement uses
    (lower wins). ``load`` is the host's chip occupancy counting the
    chips THIS plan already took from it; ``signature_affinity`` marks
    a host that already carries one of this plan's stages — the warm-
    colocation pull that collapses the whole mesh onto one big host
    when it fits (activation hops stay loopback), while capacity
    naturally forces spanning when it doesn't. ``avoid_hosts`` carries
    hosts the current incident implicates (a degrade-triggered re-plan
    passes the dead host).
    """
    avoid = set(avoid_hosts)
    candidates = list(hosts)
    planned: dict[str, int] = {}           # host_id -> chips taken so far
    shards: list[ShardAssignment] = []
    for stage in range(config.stages):
        exclude: set[str] = set()
        if (
            config.stages > 1
            and not config.single_host_fallback
            and stage == config.stages - 1
            and len(planned) == 1
        ):
            # the operator declared the model does NOT fit one host
            # (e.g. per-host HBM would be oversubscribed even though
            # the chip count works out). Spanning must be a HARD
            # constraint, not a score nudge — affinity OR plain load
            # asymmetry could otherwise pull the last stage onto the
            # one host that already holds every other stage, and a
            # post-hoc rejection would refuse a deployment whose
            # spanning plan is feasible.
            exclude = set(planned)
        best = None
        best_score = None
        for h in candidates:
            if h.host_id in exclude:
                continue
            free = len(h.free_chip_ids()) - planned.get(h.host_id, 0)
            if free < config.chips_per_stage:
                continue
            features = {
                "load": (h.n_chips - free) / max(1, h.n_chips),
                "queued": 0,
                "max_ongoing": h.n_chips,
                "breaker_failures": 0,
                "signature_affinity": planned.get(h.host_id, 0) > 0,
                "avoided": h.host_id in avoid,
                "group_size": config.chips_per_stage,
            }
            s = scorer.score(features)
            if best_score is None or s < best_score:
                best, best_score = h, s
        if best is None:
            if exclude:
                raise MeshPlanError(
                    f"all {config.stages} stages would colocate on "
                    f"'{next(iter(exclude))}' but "
                    f"mesh.single_host_fallback is off and no second "
                    f"host has {config.chips_per_stage} free chips",
                    chips_needed=config.total_chips,
                )
            raise MeshPlanError(
                f"stage {stage}/{config.stages}: no joined mesh-capable "
                f"host has {config.chips_per_stage} free chips "
                f"(need {config.total_chips} total across "
                f"{config.stages} stages)",
                chips_needed=config.total_chips,
            )
        planned[best.host_id] = (
            planned.get(best.host_id, 0) + config.chips_per_stage
        )
        shards.append(
            ShardAssignment(
                stage=stage,
                host_id=best.host_id,
                service_id=best.service_id,
                n_chips=config.chips_per_stage,
            )
        )
    return MeshPlan(config=config, shards=shards)
