"""Cluster-state service: resource snapshots, history, replica registry,
dead-replica logs, pending-workload queue.

Replaces the reference's detached head-node proxy actor
(ref bioengine/cluster/proxy_actor.py — per-node resources :332-350,
pending workloads :105-165, serve-replica registry :473-561, dead-replica
log retrieval :563-738) with a plain in-process service exposed over the
framework's RPC plane. The 100-entry status-history ring mirrors
ref bioengine/cluster/ray_cluster.py:844-861,171.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import psutil

from bioengine_tpu_torch.cluster.topology import TpuTopology, detect_topology
from bioengine_tpu_torch.utils.logger import timestamp

HISTORY_MAX = 100


@dataclass
class ReplicaRecord:
    app_id: str
    deployment: str
    replica_id: str
    registered_at: float
    device_ids: list[int] = field(default_factory=list)
    alive: bool = True
    host_id: Optional[str] = None          # None = this (controller) host
    log_tail: deque = field(default_factory=lambda: deque(maxlen=500))


@dataclass
class PendingWorkload:
    workload_id: str
    resources: dict[str, float]            # {"chips": 1, "cpus": 2, "memory_gb": 8}
    submitted_at: float


@dataclass
class HostRecord:
    """A remote worker host that joined the cluster (multi-host mode).

    The reference's analog is a SLURM-launched Ray worker node joining
    the head (ref bioengine/cluster/slurm_workers.py:153-296) whose GPUs
    become schedulable; here a ``worker_host`` process registers its
    chips and the controller leases them per replica."""

    host_id: str
    service_id: str                        # RPC service the host answers on
    topology: dict
    registered_at: float
    chips_in_use: dict[int, str] = field(default_factory=dict)
    alive: bool = True
    worker_tag: Optional[str] = None       # provisioner job tag, if any
    # host wall clock minus controller wall clock, RTT-midpoint estimate
    # measured by the host at join/rejoin — merged incident timelines
    # and telemetry attribution de-skew with it
    clock_skew_s: float = 0.0

    @property
    def n_chips(self) -> int:
        return int(self.topology.get("n_chips", 0))

    def free_chip_ids(self) -> list[int]:
        all_ids = [c["device_id"] for c in self.topology.get("chips", [])]
        return [d for d in all_ids if d not in self.chips_in_use]


class ClusterState:
    """In-memory cluster state; the worker registers its methods as an
    RPC service so dashboards/CLIs read the same shape remotely."""

    def __init__(self, topology: Optional[TpuTopology] = None):
        self._topology = topology
        self._history: deque[dict] = deque(maxlen=HISTORY_MAX)
        self._replicas: dict[str, ReplicaRecord] = {}
        self._pending: dict[str, PendingWorkload] = {}
        self._chips_in_use: dict[int, str] = {}  # device_id -> replica_id
        self.hosts: dict[str, HostRecord] = {}   # remote worker hosts
        self.started_at = time.time()

    # ---- topology / resources ----------------------------------------------

    @property
    def topology(self) -> TpuTopology:
        if self._topology is None:
            self._topology = detect_topology()
        return self._topology

    def snapshot(self) -> dict[str, Any]:
        """One resource snapshot; appended to the history ring."""
        vm = psutil.virtual_memory()
        topo = self.topology
        chips = []
        for c in topo.chips:
            chips.append(
                {
                    "device_id": c.device_id,
                    "kind": c.kind,
                    "hbm_bytes": c.hbm_bytes,
                    "in_use_by": self._chips_in_use.get(c.device_id),
                }
            )
        snap = {
            "timestamp": time.time(),
            "iso_time": timestamp(),
            "cpu_percent": psutil.cpu_percent(interval=None),
            "memory": {
                "total_bytes": vm.total,
                "available_bytes": vm.available,
            },
            "chips": chips,
            "n_chips_free": sum(
                1 for c in topo.chips if c.device_id not in self._chips_in_use
            ),
            "n_replicas": sum(1 for r in self._replicas.values() if r.alive),
            "n_pending": len(self._pending),
            "hosts": {
                h.host_id: {
                    "alive": h.alive,
                    "n_chips": h.n_chips,
                    "n_chips_free": len(h.free_chip_ids()),
                    "worker_tag": h.worker_tag,
                    "clock_skew_s": h.clock_skew_s,
                }
                for h in self.hosts.values()
            },
        }
        self._history.append(snap)
        return snap

    def get_cluster_state(self) -> dict[str, Any]:
        """The aggregate view the worker's get_status embeds."""
        snap = self._history[-1] if self._history else self.snapshot()
        return {
            "topology": self.topology.as_dict(),
            "current": snap,
            "pending_workloads": [
                {
                    "workload_id": p.workload_id,
                    "resources": p.resources,
                    # display ages against displayed wall timestamps —
                    # not SLO measurements
                    # bioengine: ignore[BE-OBS-001]
                    "age_seconds": time.time() - p.submitted_at,
                }
                for p in self._pending.values()
            ],
            # bioengine: ignore[BE-OBS-001]
            "uptime_seconds": time.time() - self.started_at,
        }

    def history(self, n: int = HISTORY_MAX) -> list[dict]:
        return list(self._history)[-n:]

    # ---- chip accounting ----------------------------------------------------

    def acquire_chips(self, replica_id: str, n: int) -> list[int]:
        free = [
            c.device_id
            for c in self.topology.chips
            if c.device_id not in self._chips_in_use
        ]
        if len(free) < n:
            raise RuntimeError(
                f"need {n} chips, only {len(free)} free "
                f"({len(self._chips_in_use)} in use)"
            )
        taken = free[:n]
        for d in taken:
            self._chips_in_use[d] = replica_id
        return taken

    def release_chips(self, replica_id: str) -> None:
        for d in [
            d for d, r in self._chips_in_use.items() if r == replica_id
        ]:
            del self._chips_in_use[d]
        if os.environ.get("BIOENGINE_FUZZ_DRILL") == "1":
            # second half of the flag-gated drill defect (see
            # mark_host_dead): host-side lease reclamation is skipped,
            # so a dead host's chips leak until the host record is
            # replaced by a rejoin
            return
        for host in self.hosts.values():
            for d in [
                d for d, r in host.chips_in_use.items() if r == replica_id
            ]:
                del host.chips_in_use[d]

    def free_chips(self) -> int:
        """Free chips on THIS host (local placement budget)."""
        return self.topology.n_chips - len(self._chips_in_use)

    def cluster_free_chips(self) -> int:
        """Free chips across the whole cluster: local + joined hosts."""
        return self.free_chips() + sum(
            len(h.free_chip_ids()) for h in self.hosts.values() if h.alive
        )

    # ---- remote hosts (multi-host placement) --------------------------------

    def register_host(
        self,
        host_id: str,
        service_id: str,
        topology: dict,
        worker_tag: Optional[str] = None,
        clock_skew_s: float = 0.0,
    ) -> None:
        record = HostRecord(
            host_id=host_id,
            service_id=service_id,
            topology=dict(topology),
            registered_at=time.time(),
            worker_tag=worker_tag,
            clock_skew_s=float(clock_skew_s or 0.0),
        )
        previous = self.hosts.get(host_id)
        if previous is not None and previous.alive:
            # a live host rejoining (a connection blip) keeps the leases
            # held on it: a replica still starting there leased its chips
            # on the record this one replaces and is not yet among the
            # warm replicas the host reports, so a fresh table would
            # leave that replica routed with no lease behind it
            chips = {c["device_id"] for c in record.topology.get("chips", [])}
            record.chips_in_use = {
                d: rid for d, rid in previous.chips_in_use.items() if d in chips
            }
        self.hosts[host_id] = record

    def mark_host_dead(self, host_id: str) -> list[str]:
        """Drop a host; returns the replica_ids that were leased its
        chips so the controller can restart them elsewhere."""
        host = self.hosts.get(host_id)
        if host is None:
            return []
        host.alive = False
        orphans = sorted(set(host.chips_in_use.values()))
        if os.environ.get("BIOENGINE_FUZZ_DRILL") == "1":
            # Deliberate, flag-gated lease-accounting defect (the chaos
            # fuzzer's end-to-end drill): a dead host's lease table is
            # left populated, so every chip it held leaks forever. The
            # fuzzer must find this through the lease_conservation
            # universal invariant and shrink the failing schedule to a
            # minimal repro — proving the searcher + shrinker work on a
            # KNOWN bug, not just accidental ones. Never set this flag
            # outside the fuzz drill.
            return orphans
        host.chips_in_use.clear()
        return orphans

    def find_host_for_chips(self, n: int) -> Optional[HostRecord]:
        """Least-loaded-first host with >= n free chips."""
        candidates = [
            h
            for h in self.hosts.values()
            if h.alive and len(h.free_chip_ids()) >= n
        ]
        if not candidates:
            return None
        return min(candidates, key=lambda h: len(h.chips_in_use))

    def host_acquire_chips(
        self, host_id: str, replica_id: str, n: int
    ) -> list[int]:
        host = self.hosts.get(host_id)
        if host is None or not host.alive:
            raise RuntimeError(f"host '{host_id}' is not available")
        free = host.free_chip_ids()
        if len(free) < n:
            raise RuntimeError(
                f"host '{host_id}': need {n} chips, only {len(free)} free"
            )
        taken = free[:n]
        for d in taken:
            host.chips_in_use[d] = replica_id
        return taken

    def host_adopt_chips(
        self, host_id: str, replica_id: str, device_ids: list[int]
    ) -> None:
        """Re-lease SPECIFIC chips to a replica on a REJOINING host
        (its fresh HostRecord starts with an empty lease table; the
        replica's chips are already pinned by compiled programs, so the
        lease must land on the same device ids)."""
        host = self.hosts.get(host_id)
        if host is None or not host.alive:
            raise RuntimeError(f"host '{host_id}' is not available")
        for d in device_ids:
            owner = host.chips_in_use.get(d)
            if owner not in (None, replica_id):
                raise RuntimeError(
                    f"host '{host_id}' chip {d} already leased to {owner}"
                )
        for d in device_ids:
            host.chips_in_use[d] = replica_id
        # rejoin may follow a mark_host_dead that flagged the replica's
        # record dead; it is demonstrably alive again
        rec = self._replicas.get(replica_id)
        if rec is not None:
            rec.alive = True

    # ---- pending workloads (drive the autoscaler) ---------------------------

    def add_pending(self, workload_id: str, resources: dict[str, float]) -> None:
        self._pending[workload_id] = PendingWorkload(
            workload_id, resources, time.time()
        )

    def remove_pending(self, workload_id: str) -> None:
        self._pending.pop(workload_id, None)

    def pending(self) -> list[PendingWorkload]:
        return list(self._pending.values())

    # ---- replica registry + logs -------------------------------------------

    def register_replica(
        self,
        app_id: str,
        deployment: str,
        replica_id: str,
        device_ids: Optional[list[int]] = None,
        host_id: Optional[str] = None,
    ) -> None:
        self._replicas[replica_id] = ReplicaRecord(
            app_id=app_id,
            deployment=deployment,
            replica_id=replica_id,
            registered_at=time.time(),
            device_ids=device_ids or [],
            host_id=host_id,
        )

    def mark_replica_dead(self, replica_id: str) -> None:
        rec = self._replicas.get(replica_id)
        if rec:
            rec.alive = False
        self.release_chips(replica_id)

    def append_replica_log(self, replica_id: str, line: str) -> None:
        rec = self._replicas.get(replica_id)
        if rec:
            rec.log_tail.append(line)

    def get_replica_logs(
        self, app_id: str, include_dead: bool = True, max_lines: int = 200
    ) -> dict[str, list[str]]:
        """Per-replica log tails, INCLUDING dead replicas — parity with
        the reference's dead-replica log retrieval
        (ref bioengine/cluster/proxy_actor.py:563-738)."""
        out = {}
        for rec in self._replicas.values():
            if rec.app_id != app_id:
                continue
            if not rec.alive and not include_dead:
                continue
            label = f"{rec.deployment}/{rec.replica_id}" + (
                "" if rec.alive else " (dead)"
            )
            out[label] = list(rec.log_tail)[-max_lines:]
        return out

    def replicas(self, app_id: Optional[str] = None) -> list[ReplicaRecord]:
        return [
            r
            for r in self._replicas.values()
            if app_id is None or r.app_id == app_id
        ]

    # ---- RPC surface --------------------------------------------------------

    def service_methods(self) -> dict[str, Any]:
        return {
            "get_cluster_state": lambda context=None: self.get_cluster_state(),
            "get_history": lambda n=HISTORY_MAX, context=None: self.history(n),
        }
