"""TpuCluster — the compute-substrate manager.

The reference's RayCluster starts/attaches a Ray head, holds a lock
file with stale-PID detection, keeps a status-history ring, and drives
the SLURM autoscaler from its monitor loop (ref bioengine/cluster/
ray_cluster.py:158-163 modes, :394-478 lock, :844-861 history). Here
there is no external cluster runtime to babysit: the substrate is the
JAX-visible TPU topology plus optional provisioned workers, so this
class owns

- the workspace lock (one cluster manager per workspace dir, stale PIDs
  reclaimed),
- topology detection + the ClusterState service,
- the provisioner for ``slurm`` / ``gke`` modes (``single-machine`` and
  ``external`` use NullProvisioner),
- the monitor tick: snapshot -> scaling decision, mirroring
  ref ray_cluster.py monitor_cluster + slurm check_scaling.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Optional

from bioengine_tpu_torch.cluster.provisioner import (
    GkeProvisioner,
    NullProvisioner,
    Provisioner,
    SlurmProvisioner,
)
from bioengine_tpu_torch.cluster.state import ClusterState
from bioengine_tpu_torch.cluster.topology import TpuTopology, detect_topology
from bioengine_tpu_torch.utils.logger import create_logger

MODES = ("single-machine", "slurm", "gke", "external")


class ClusterLockError(RuntimeError):
    pass


class TpuCluster:
    def __init__(
        self,
        mode: str = "single-machine",
        workspace_dir: str | Path = "~/.bioengine",
        provisioner: Optional[Provisioner] = None,
        provisioner_config: Optional[dict] = None,
        log_file: Optional[str] = None,
        topology: Optional[TpuTopology] = None,
    ):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got '{mode}'")
        self.mode = mode
        self.workspace_dir = Path(workspace_dir).expanduser()
        self.logger = create_logger("cluster", log_file=log_file)
        self._lock_path = self.workspace_dir / "cluster.lock"
        self._locked = False
        self._topology = topology
        self.state: Optional[ClusterState] = None
        self.provisioner = provisioner or self._make_provisioner(
            provisioner_config or {}
        )
        self.is_ready = False

    def _make_provisioner(self, cfg: dict) -> Provisioner:
        if self.mode == "slurm":
            return SlurmProvisioner(**cfg)
        if self.mode == "gke":
            return GkeProvisioner(**cfg)
        return NullProvisioner()

    # ---- lock file (one manager per workspace) ------------------------------

    def _acquire_lock(self) -> None:
        self.workspace_dir.mkdir(parents=True, exist_ok=True)
        if self._lock_path.exists():
            try:
                pid = int(self._lock_path.read_text().strip() or "0")
            except ValueError:
                pid = 0
            if pid and _pid_alive(pid):
                raise ClusterLockError(
                    f"Workspace {self.workspace_dir} is managed by live "
                    f"process {pid} (remove {self._lock_path} if stale)"
                )
            self.logger.warning(
                f"Reclaiming stale cluster lock (pid {pid} is gone)"
            )
            self._lock_path.unlink()
        fd = os.open(self._lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        with os.fdopen(fd, "w") as f:
            f.write(str(os.getpid()))
        self._locked = True

    def _release_lock(self) -> None:
        if self._locked and self._lock_path.exists():
            self._lock_path.unlink()
        self._locked = False

    # ---- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._acquire_lock()
        try:
            topo = self._topology or detect_topology()
            self._topology = topo
            self.state = ClusterState(topo)
            self.state.snapshot()
            self.logger.info(
                f"Cluster up ({self.mode}): {topo.n_chips} "
                f"{topo.platform} chip(s) across {topo.n_hosts} host(s)"
            )
            self.is_ready = True
        except Exception:
            self._release_lock()
            raise

    def stop(self) -> None:
        self.is_ready = False
        try:
            self.provisioner.close_all()
        finally:
            self._release_lock()
        self.logger.info("Cluster stopped")

    def check_connection(self) -> bool:
        """Cheap liveness: can we still enumerate devices?"""
        if not self.is_ready or self.state is None:
            return False
        try:
            return self.state.topology.n_chips > 0
        except Exception:
            return False

    # ---- monitor tick -------------------------------------------------------

    def monitor_cluster(self) -> dict:
        """One monitoring tick: snapshot + scaling decision."""
        if self.state is None:
            raise RuntimeError("cluster not started")
        self.state.snapshot()
        idle_workers = self._idle_worker_ids()
        actions = self.provisioner.check_scaling(
            self.state.pending(), self.state.history(), idle_workers
        )
        for workload in list(self.state.pending()):
            # pending items are cleared by the serving controller once
            # placed; stale ones older than an hour are dropped here.
            # submitted_at is a displayed wall timestamp; an hour-scale
            # staleness gate tolerates NTP slew.
            # bioengine: ignore[BE-OBS-001]
            if time.time() - workload.submitted_at > 3600:
                self.state.remove_pending(workload.workload_id)
        return actions

    def _idle_worker_ids(self) -> set[str]:
        """Workers eligible for scale-down.

        Per-host idleness: a joined host with no live replica leased to
        it maps back to its backend job through the ``worker_tag`` it
        reported on join (the reference correlates idle Ray nodes to
        SLURM jobs the same way, ref slurm_workers.py:817-903). Workers
        whose host never joined stay un-cancellable here — the
        provisioner's own state polling reaps jobs that died before
        joining."""
        if self.state is None:
            return set()
        live_hosts = {
            r.host_id for r in self.state.replicas() if r.alive
        }  # may contain None = the controller host itself
        tag_to_worker = {
            w.worker_tag: w.worker_id
            for w in self.provisioner.active_workers()
            if w.worker_tag
        }
        idle = set()
        for host in self.state.hosts.values():
            if not host.alive or host.host_id in live_hosts:
                continue
            worker_id = tag_to_worker.get(host.worker_tag)
            if worker_id:
                idle.add(worker_id)
        return idle

    @property
    def status(self) -> dict:
        return {
            "mode": self.mode,
            "ready": self.is_ready,
            "topology": self._topology.as_dict() if self._topology else None,
            "workers": [
                {
                    "worker_id": w.worker_id,
                    "state": w.state,
                    "resources": w.resources,
                }
                for w in self.provisioner.workers.values()
            ],
            "state": self.state.get_cluster_state() if self.state else None,
        }


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
