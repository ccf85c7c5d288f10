"""Worker provisioners — the TPU answer to the reference's SLURM GPU
autoscaler (ref bioengine/cluster/slurm_workers.py).

A provisioner turns *pending workload pressure* into worker capacity:

- ``SlurmProvisioner`` submits sbatch jobs that start a BioEngine-TPU
  host process on a TPU partition node. Reproduces the reference's
  policy: scale UP when pending workloads exist, sized from the pending
  item's resource request, bounded by max_workers and a cooldown
  (ref slurm_workers.py:688-774); scale DOWN a worker only after it is
  idle across the whole recent status-history window
  (ref slurm_workers.py:817-903).
- ``GkeProvisioner`` targets GCP queued-resources / GKE node pools for
  real TPU slices (same policy, different backend verbs).
- ``NullProvisioner`` for single-machine / external modes.

Command execution goes through an injectable runner so policy is
hermetically testable without sbatch/gcloud.
"""

from __future__ import annotations

import abc
import subprocess
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Optional

from bioengine_tpu_torch.utils.logger import create_logger


@dataclass
class WorkerRecord:
    worker_id: str
    backend_job_id: str
    submitted_at: float
    resources: dict[str, float]
    state: str = "pending"          # pending | running | draining | gone
    # the tag the launched worker_host reports on join (--worker-tag);
    # ClusterState.HostRecord.worker_tag carries it back, so an idle
    # JOINED host can be mapped to the backend job to cancel (the
    # reference correlates via a slurm_job_id custom Ray resource,
    # ref slurm_workers.py:645-664)
    worker_tag: Optional[str] = None


@dataclass
class ScalingPolicy:
    max_workers: int = 4
    cooldown_seconds: float = 60.0
    idle_window_snapshots: int = 12   # consecutive idle snapshots before down
    default_resources: dict = field(
        default_factory=lambda: {"chips": 8, "cpus": 16, "memory_gb": 64}
    )


CommandRunner = Callable[[list[str]], "subprocess.CompletedProcess"]


def _real_runner(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60)


class Provisioner(abc.ABC):
    def __init__(self, policy: Optional[ScalingPolicy] = None):
        self.policy = policy or ScalingPolicy()
        self.workers: dict[str, WorkerRecord] = {}
        self._last_scale_up = float("-inf")  # monotonic clock
        self.join_server_url: Optional[str] = None
        self.join_token: Optional[str] = None
        self.logger = create_logger(self.__class__.__name__, log_file="off")

    def set_join_info(self, server_url: str, token: str) -> None:
        """Where provisioned worker_host processes should join: the
        controller's RPC url + an admin token. Embedded into launch
        scripts (the reference embeds the head node's Ray address the
        same way, ref slurm_workers.py:153-296)."""
        self.join_server_url = server_url
        self.join_token = token

    # -- backend verbs --------------------------------------------------------

    @abc.abstractmethod
    def _submit(self, resources: dict[str, float], worker_tag: str) -> str:
        """Start one worker carrying ``worker_tag``; return a backend
        job id."""

    @abc.abstractmethod
    def _cancel(self, backend_job_id: str) -> None: ...

    @abc.abstractmethod
    def _poll_state(self, backend_job_id: str) -> str:
        """'pending' | 'running' | 'gone'"""

    # -- policy ---------------------------------------------------------------

    def check_scaling(
        self,
        pending: list,
        history: list[dict],
        idle_worker_ids: Optional[set[str]] = None,
    ) -> dict:
        """One policy tick. Returns {"scaled_up": [...], "scaled_down": [...]}."""
        self._refresh_states()
        up, down = [], []
        active = [
            w for w in self.workers.values() if w.state in ("pending", "running")
        ]
        # Scale up: pending workloads + cooldown elapsed + below cap.
        if (
            pending
            and time.monotonic() - self._last_scale_up > self.policy.cooldown_seconds
            and len(active) < self.policy.max_workers
        ):
            item = pending[0]
            resources = dict(self.policy.default_resources)
            req = getattr(item, "resources", None) or {}
            resources.update({k: v for k, v in req.items() if v})
            worker_id = f"worker-{uuid.uuid4().hex[:8]}"
            worker_tag = worker_id.removeprefix("worker-")
            job_id = self._submit(resources, worker_tag)
            self.workers[worker_id] = WorkerRecord(
                worker_id=worker_id,
                backend_job_id=job_id,
                submitted_at=time.time(),
                resources=resources,
                worker_tag=worker_tag,
            )
            self._last_scale_up = time.monotonic()
            up.append(worker_id)
            self.logger.info(
                f"scale-up {worker_id} (job {job_id}) for pending "
                f"{getattr(item, 'workload_id', item)}"
            )
        # Scale down: a worker idle across the WHOLE recent window and no
        # pending demand. ``idle_worker_ids`` intersects per-snapshot idle
        # sets computed by the caller (the reference intersects idle-node
        # sets across its status history, slurm_workers.py:817-903).
        if not pending and idle_worker_ids:
            window = history[-self.policy.idle_window_snapshots :]
            if len(window) >= self.policy.idle_window_snapshots:
                for worker_id in sorted(idle_worker_ids):
                    w = self.workers.get(worker_id)
                    if w and w.state == "running":
                        self._cancel(w.backend_job_id)
                        w.state = "gone"
                        down.append(worker_id)
                        self.logger.info(f"scale-down {worker_id}")
        return {"scaled_up": up, "scaled_down": down}

    def _refresh_states(self) -> None:
        for w in self.workers.values():
            if w.state in ("pending", "running"):
                w.state = self._poll_state(w.backend_job_id)

    def close_all(self) -> None:
        for w in self.workers.values():
            if w.state in ("pending", "running"):
                try:
                    self._cancel(w.backend_job_id)
                except Exception as e:
                    self.logger.warning(f"cancel {w.worker_id}: {e}")
                w.state = "gone"
        # close_all is terminal teardown: drop the records too, or the
        # registry grows one dead entry per worker ever provisioned
        self.workers.clear()

    def active_workers(self) -> list[WorkerRecord]:
        return [
            w for w in self.workers.values() if w.state in ("pending", "running")
        ]


class NullProvisioner(Provisioner):
    """single-machine / external-cluster modes: capacity is fixed."""

    def _submit(self, resources, worker_tag):  # pragma: no cover - never called
        raise RuntimeError("NullProvisioner cannot scale")

    def _cancel(self, backend_job_id):
        pass

    def _poll_state(self, backend_job_id):
        return "gone"

    def check_scaling(self, pending, history, idle_worker_ids=None):
        return {"scaled_up": [], "scaled_down": []}


class SlurmProvisioner(Provisioner):
    """sbatch-backed workers on an HPC TPU/accelerator partition."""

    def __init__(
        self,
        partition: str = "tpu",
        time_limit: str = "4:00:00",
        worker_command: str = "python -m bioengine_tpu_torch.worker_host",
        container_image: Optional[str] = None,
        extra_sbatch_args: str = "",
        policy: Optional[ScalingPolicy] = None,
        runner: CommandRunner = _real_runner,
    ):
        super().__init__(policy)
        self.partition = partition
        self.time_limit = time_limit
        self.worker_command = worker_command
        self.container_image = container_image
        self.extra_sbatch_args = extra_sbatch_args
        self.runner = runner

    def build_sbatch_script(self, resources: dict[str, float], worker_tag: str) -> str:
        """The launch script: starts a bioengine host process that joins
        the cluster, tagged so a targeted shutdown can find it (the
        reference tags Ray workers with a slurm_job_id custom resource,
        ref slurm_workers.py:153-296)."""
        cmd = f"{self.worker_command} --worker-tag {worker_tag}"
        if self.container_image:
            cmd = (
                f"apptainer exec --bind $PWD {self.container_image} {cmd}"
            )
        cpus = int(resources.get("cpus", 8))
        mem = int(resources.get("memory_gb", 32))
        join_env = []
        if self.join_server_url:
            join_env.append(
                f"export BIOENGINE_SERVER_URL={self.join_server_url}"
            )
        if self.join_token:
            join_env.append(f"export BIOENGINE_ADMIN_TOKEN={self.join_token}")
        return "\n".join(
            [
                "#!/bin/bash",
                f"#SBATCH --job-name=bioengine-{worker_tag}",
                f"#SBATCH --partition={self.partition}",
                f"#SBATCH --cpus-per-task={cpus}",
                f"#SBATCH --mem={mem}G",
                f"#SBATCH --time={self.time_limit}",
                *(
                    [f"#SBATCH {self.extra_sbatch_args}"]
                    if self.extra_sbatch_args
                    else []
                ),
                "set -euo pipefail",
                *join_env,
                f"exec {cmd}",
            ]
        )

    def _submit(self, resources: dict[str, float], worker_tag: str) -> str:
        import tempfile

        script = self.build_sbatch_script(resources, worker_tag)
        with tempfile.NamedTemporaryFile(
            "w", suffix=".sbatch", prefix="bioengine-", delete=False
        ) as f:
            f.write(script)
            script_path = f.name
        proc = self.runner(["sbatch", "--parsable", script_path])
        if proc.returncode != 0:
            raise RuntimeError(f"sbatch failed: {proc.stderr}")
        return proc.stdout.strip().split(";")[0]

    def _cancel(self, backend_job_id: str) -> None:
        self.runner(["scancel", backend_job_id])

    def _poll_state(self, backend_job_id: str) -> str:
        proc = self.runner(
            ["squeue", "-j", backend_job_id, "-h", "-o", "%T"]
        )
        state = proc.stdout.strip().upper()
        if not state:
            return "gone"
        if state in ("PENDING", "CONFIGURING"):
            return "pending"
        if state in ("RUNNING", "COMPLETING"):
            return "running"
        return "gone"


class GkeProvisioner(Provisioner):
    """GCP queued-resources backed TPU slices (gcloud CLI).

    Uses ``gcloud compute tpus queued-resources`` verbs; requires gcloud
    auth on the controller host. Policy identical to SLURM.
    """

    def __init__(
        self,
        project: str,
        zone: str,
        accelerator_type: str = "v5litepod-8",
        runtime_version: str = "v2-alpha-tpuv5-lite",
        worker_command: str = "python -m bioengine_tpu_torch.worker_host",
        policy: Optional[ScalingPolicy] = None,
        runner: CommandRunner = _real_runner,
    ):
        super().__init__(policy)
        self.project = project
        self.zone = zone
        self.accelerator_type = accelerator_type
        self.runtime_version = runtime_version
        self.worker_command = worker_command
        self.runner = runner

    def build_startup_script(self, worker_tag: str) -> str:
        """What the TPU VM runs on boot: join THIS control plane as a
        worker host, tagged for targeted scale-down. Without this the
        provisioned node would sit idle forever — the GKE analog of the
        sbatch script's join env (ref slurm_workers.py:153-296)."""
        lines = ["#!/bin/bash", "set -euo pipefail"]
        if self.join_server_url:
            lines.append(
                f"export BIOENGINE_SERVER_URL={self.join_server_url}"
            )
        if self.join_token:
            lines.append(f"export BIOENGINE_ADMIN_TOKEN={self.join_token}")
        lines.append(
            f"exec {self.worker_command} --worker-tag {worker_tag}"
        )
        return "\n".join(lines)

    def _submit(self, resources: dict[str, float], worker_tag: str) -> str:
        name = f"bioengine-{worker_tag}"
        startup = self.build_startup_script(worker_tag)
        proc = self.runner(
            [
                "gcloud", "compute", "tpus", "queued-resources", "create",
                name,
                f"--project={self.project}",
                f"--zone={self.zone}",
                f"--accelerator-type={self.accelerator_type}",
                f"--runtime-version={self.runtime_version}",
                f"--node-id={name}",
                f"--metadata=startup-script={startup}",
            ]
        )
        if proc.returncode != 0:
            raise RuntimeError(f"queued-resources create failed: {proc.stderr}")
        return name

    def _cancel(self, backend_job_id: str) -> None:
        self.runner(
            [
                "gcloud", "compute", "tpus", "queued-resources", "delete",
                backend_job_id,
                f"--project={self.project}",
                f"--zone={self.zone}",
                "--quiet", "--force",
            ]
        )

    def _poll_state(self, backend_job_id: str) -> str:
        proc = self.runner(
            [
                "gcloud", "compute", "tpus", "queued-resources", "describe",
                backend_job_id,
                f"--project={self.project}",
                f"--zone={self.zone}",
                "--format=value(state.state)",
            ]
        )
        state = proc.stdout.strip().upper()
        if not state or proc.returncode != 0:
            return "gone"
        if state in ("WAITING_FOR_RESOURCES", "CREATING", "ACCEPTED", "PROVISIONING"):
            return "pending"
        if state == "ACTIVE":
            return "running"
        return "gone"
