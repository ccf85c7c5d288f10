"""The port's scenario engine (``bioengine_tpu_torch.testing``) against the
JAX package's: the catalog, the same scenario and seed through both engines
with equal outcome signatures and red sets, the problem finders of the
universal invariants on one hand-built cluster, the ``cuda`` default, and a
real controller process SIGKILLed and restarted while a port worker host on
the CPU rides through (the port's mirror of ``test_controller_recovery.py``
``TestRealSubprocessCrash``).

Each package keeps its own fault, flight and task registries: a scenario
run arms and reads only its own package's. Port hosts hold 8 CPU chips each
(``device="cpu", n_devices=8``), as many as the JAX conftest gives a JAX
host; host-less scenarios run the port with its default device, which they
never touch. ``tenant_flood`` runs at ``BIOENGINE_SCENARIO_SCALE=2.0`` on
both sides: every time constant doubles, the request plan does not.
"""

import asyncio
import inspect
import os
import signal
import socket
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from _torch_parity import few_torch_threads  # noqa: F401
from bioengine_tpu.cluster.state import ClusterState as JaxClusterState
from bioengine_tpu.cluster.state import HostRecord as JaxHostRecord
from bioengine_tpu.cluster.topology import ChipInfo as JaxChipInfo
from bioengine_tpu.cluster.topology import TpuTopology as JaxTopology
from bioengine_tpu.testing import faults as jax_faults
from bioengine_tpu.testing import invariants as jax_invariants
from bioengine_tpu.testing import scenarios as jax_scenarios
from bioengine_tpu.utils import tasks as jax_tasks
from bioengine_tpu_torch.cluster.state import ClusterState as TorchClusterState
from bioengine_tpu_torch.cluster.state import HostRecord as TorchHostRecord
from bioengine_tpu_torch.cluster.topology import ChipInfo as TorchChipInfo
from bioengine_tpu_torch.cluster.topology import TpuTopology as TorchTopology
from bioengine_tpu_torch.rpc.client import connect_to_server
from bioengine_tpu_torch.testing import faults as torch_faults
from bioengine_tpu_torch.testing import invariants as torch_invariants
from bioengine_tpu_torch.testing import scenarios as torch_scenarios
from bioengine_tpu_torch.utils import tasks as torch_tasks
from bioengine_tpu_torch.worker_host import WorkerHost

pytestmark = [pytest.mark.integration, pytest.mark.anyio]

REPO = Path(__file__).resolve().parent.parent
HOST_CHIPS = 8  # tests/conftest.py's virtual XLA CPU devices per JAX host


@pytest.fixture(autouse=True)
def _clean_faults():
    jax_faults.clear()
    torch_faults.clear()
    yield
    jax_faults.clear()
    torch_faults.clear()


def _red(result: dict) -> list:
    return sorted(k for k, v in result["invariants"].items() if v["required"] and not v["ok"])


def test_catalog_equals_the_jax_one():
    assert torch_scenarios.list_scenarios() == jax_scenarios.list_scenarios()
    assert set(torch_scenarios.NAMED_SCENARIOS) == set(jax_scenarios.NAMED_SCENARIOS)
    with pytest.raises(KeyError, match="unknown scenario"):
        torch_scenarios.get_scenario("nope")


def test_entry_points_default_to_cuda():
    for fn in (torch_scenarios.run_scenario, torch_scenarios.run_scenario_async):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda" and params["n_devices"].default is None


# (scenario, seed, defenses, scale): the JAX tests' cases
CASES = [
    ("slow_replica", 7, True, None),
    ("slow_replica", 7, False, None),
    ("controller_crash", 7, True, None),
    ("token_streaming", 7, True, None),
    ("hot_signature", 5, True, None),
    ("router_loss", 7, True, None),
    ("tenant_flood", 3, True, "2.0"),
]


@pytest.mark.parametrize(
    "name,seed,defenses,scale", CASES,
    ids=[f"{c[0]}-{'defended' if c[2] else 'undefended'}" for c in CASES],
)
async def test_same_seed_same_outcomes_as_jax(name, seed, defenses, scale, monkeypatch):
    if scale is not None:
        monkeypatch.setenv("BIOENGINE_SCENARIO_SCALE", scale)
    ref = await jax_scenarios.run_scenario_async(
        jax_scenarios.get_scenario(name), seed=seed, defenses=defenses
    )
    scenario = torch_scenarios.get_scenario(name)
    devices = {"device": "cpu", "n_devices": HOST_CHIPS} if scenario.n_hosts else {}
    ours = await torch_scenarios.run_scenario_async(scenario, seed=seed, defenses=defenses, **devices)
    assert torch_scenarios.outcome_signature(ours) == jax_scenarios.outcome_signature(ref)
    assert _red(ours) == _red(ref)
    assert ours["requests"] == ref["requests"] and ours["counts"] == ref["counts"]
    if defenses:
        assert ours["passed"], ours["invariants"]
    else:  # the acceptance proof's other direction: the degradation shows
        assert not ours["invariants"]["p99_recovery"]["ok"]
        assert ours["probations"] == 0 and ours["hedges"] == 0


async def test_host_scenario_on_cuda_raises_without_cuda(monkeypatch, tmp_path):
    """A host on ``cuda`` raises at its own start without CUDA: the run
    fails, it does not drop to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        await torch_scenarios.run_scenario_async(
            torch_scenarios.get_scenario("controller_crash"), seed=7, workdir=tmp_path
        )
    # a host-less scenario touches no device
    result = await torch_scenarios.run_scenario_async(torch_scenarios.get_scenario("hot_signature"), seed=5)
    assert result["passed"], result["invariants"]


# ---- the universal invariants' problem finders ---------------------------------


def _cluster(pkg):
    """One hand-built cluster in a package's own classes: a leaking dead
    host, a chip leased to a replica nobody routes, a lease mismatch, a
    local chip leased to a dead replica, and one clean replica."""
    state_cls, host_cls, topo_cls, chip_cls = pkg
    state = state_cls(topo_cls(chips=tuple(chip_cls(device_id=i, platform="cpu", kind="cpu", process_index=0) for i in range(2)),
                               n_hosts=1, platform="cpu"))
    chips = [{"device_id": i} for i in range(4)]
    state.hosts["h1"] = host_cls("h1", "svc-h1", {"n_chips": 4, "chips": chips}, 0.0,
                                 chips_in_use={0: "r-ok", 1: "r-gone", 2: "r-mis"})
    state.hosts["h2"] = host_cls("h2", "svc-h2", {"n_chips": 4, "chips": chips}, 0.0,
                                 chips_in_use={3: "r-dead-host"}, alive=False)
    state._chips_in_use = {0: "r-local-dead"}
    replicas = [SimpleNamespace(replica_id="r-ok", host_id="h1", device_ids=[0]),
                SimpleNamespace(replica_id="r-mis", host_id="h1", device_ids=[2, 3]),
                SimpleNamespace(replica_id="r-dead-host", host_id="h2", device_ids=[3]),
                SimpleNamespace(replica_id="r-nohost", host_id="h9", device_ids=[1]),
                SimpleNamespace(replica_id="r-local", host_id=None, device_ids=[1])]
    return SimpleNamespace(cluster_state=state, apps={"a": SimpleNamespace(replicas={"d": replicas})})


def _plane(controller, tasks_module, monkeypatch):
    class Sched:
        waiting, _open, _inflight = 2, [object()], []

    host = SimpleNamespace(connection=SimpleNamespace(_pending={"c1": None}))
    idle = SimpleNamespace(connection=None)
    controller._schedulers = {("a", "d"): Sched()}
    router = SimpleNamespace(router_id="r0", _schedulers={("a", "d"): Sched()})
    monkeypatch.setattr(tasks_module, "_BACKGROUND_TASKS",
                        [SimpleNamespace(done=lambda: False) for _ in range(17)])
    return SimpleNamespace(server=SimpleNamespace(_pending={"x": 1, "y": 2}), hosts={"h1": host, "h2": idle},
                           controller=controller, routers=[router])


def test_problem_finders_agree_with_jax(monkeypatch):
    jax_ctl = _cluster((JaxClusterState, JaxHostRecord, JaxTopology, JaxChipInfo))
    torch_ctl = _cluster((TorchClusterState, TorchHostRecord, TorchTopology, TorchChipInfo))
    lease = torch_invariants.lease_problems(torch_ctl)
    assert lease == jax_invariants.lease_problems(jax_ctl)
    assert len(lease) == 5, lease
    live = torch_invariants.liveness_problems(_plane(torch_ctl, torch_tasks, monkeypatch))
    assert live == jax_invariants.liveness_problems(_plane(jax_ctl, jax_tasks, monkeypatch))
    assert len(live) == 5, live
    assert list(torch_invariants.UNIVERSAL_INVARIANTS) == list(jax_invariants.UNIVERSAL_INVARIANTS)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_a_live_hosts_rejoin_keeps_the_leases_held_on_it(pkg):
    """A replica still starting on a host when the host rejoins after a
    blip leased its chip on the record the rejoin replaces. The port's
    ``register_host`` carries a live host's leases over; the JAX one starts
    the new record empty, which left such a replica routed with no lease
    (``lease_conservation`` red in blip_storm at one chip a host). After a
    host's death its rejoin starts empty in both."""
    state_cls, topo_cls = {"torch": (TorchClusterState, TorchTopology),
                           "jax": (JaxClusterState, JaxTopology)}[pkg]
    state = state_cls(topo_cls(chips=(), n_hosts=1, platform="cpu"))
    topology = {"n_chips": 2, "chips": [{"device_id": 0}, {"device_id": 1}]}
    state.register_host("h1", "svc-h1", topology)
    assert state.host_acquire_chips("h1", "r-starting", 1) == [0]
    state.register_host("h1", "svc-h1-again", topology)  # the blip rejoin
    assert state.hosts["h1"].chips_in_use == ({0: "r-starting"} if pkg == "torch" else {})
    assert state.hosts["h1"].service_id == "svc-h1-again"
    state.mark_host_dead("h1")
    state.register_host("h1", "svc-h1-new", topology)
    assert state.hosts["h1"].chips_in_use == {} and state.hosts["h1"].alive


# ---- a real controller process, SIGKILLed and restarted -------------------------

REC_MANIFEST = """\
name: Recovery App
id: rec-app
id_emoji: "\\U0001F9EA"
description: idempotent arithmetic for recovery traffic
type: tpu-serve
version: 1.0.0
deployments:
  - rec_dep:RecDep
authorized_users: ["*"]
deployment_config:
  rec_dep:
    num_replicas: 1
    min_replicas: 1
    max_replicas: 1
    chips: 1
    autoscale: false
"""

REC_SOURCE = '''\
from bioengine_tpu_torch.rpc import schema_method


class RecDep:
    @schema_method
    async def add(self, a: int, b: int, context=None):
        """Idempotent arithmetic."""
        return {"sum": a + b}
'''


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


async def _wait_marker(proc, marker: str, timeout: float = 60.0) -> str:
    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        assert remaining > 0, f"'{marker}' never printed"
        line = await asyncio.wait_for(proc.stdout.readline(), timeout=remaining)
        assert line, f"controller proc exited before '{marker}'"
        text = line.decode().strip()
        if text.startswith(marker):
            return text


async def _idempotent_add(client, a: int, b: int, budget_s: float = 30.0) -> tuple[dict, int]:
    """``route_call`` retried on any failure until it answers or the budget
    runs out, as a client retries an idempotent call; (result, retries)."""
    deadline = time.monotonic() + budget_s
    retries = 0
    while True:
        try:
            return await asyncio.wait_for(
                client.call("serve-router", "route_call", "rec-app", "rec_dep", "add", [a, b], {}), 5.0
            ), retries
        except Exception:  # noqa: BLE001 — the controller may be dead or recovering
            if time.monotonic() > deadline:
                raise
            retries += 1
            await asyncio.sleep(0.05)


async def test_kill_and_restart_real_controller_process(tmp_path):
    """``python -m bioengine_tpu_torch.testing.controller_proc`` is SIGKILLed
    mid-traffic and restarted on the same port and journal; the port's
    worker host (one CPU chip) rides through orphaned, rejoins the second
    life, and its replica is adopted without a restart; idempotent calls
    issued across the crash all answer."""
    port = _free_port()
    control_dir = tmp_path / "control"
    app_dir = tmp_path / "rec-src"
    app_dir.mkdir()
    (app_dir / "manifest.yaml").write_text(REC_MANIFEST)
    (app_dir / "rec_dep.py").write_text(REC_SOURCE)
    token = "subproc-admin-token"
    env = {**os.environ, "BIOENGINE_ADMIN_TOKEN": token, "BIOENGINE_RECONCILE_GRACE_S": "10",
           "PYTHONPATH": str(REPO)}

    async def spawn(extra):
        return await asyncio.create_subprocess_exec(
            sys.executable, "-m", "bioengine_tpu_torch.testing.controller_proc",
            "--port", str(port), "--control-dir", str(control_dir), *extra,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.DEVNULL, env=env,
        )

    proc1 = await spawn(["--deploy-dir", str(app_dir), "--app-id", "rec-app"])
    host = client = proc2 = None
    try:
        ready = await _wait_marker(proc1, "READY")
        assert "epoch=1" in ready
        host = WorkerHost(server_url=f"ws://127.0.0.1:{port}/ws", token=token, host_id="sub-h1",
                          workspace_dir=tmp_path / "ws-sub-h1", rejoin=True, orphan_grace_s=120.0,
                          device="cpu", n_devices=1)
        await host.start()
        host.connection.reconnect_max_backoff_s = 0.3
        await _wait_marker(proc1, "DEPLOYED")
        assert len(host.replicas) == 1
        instances = {rid: id(r.instance) for rid, r in host.replicas.items()}

        client = await connect_to_server({"server_url": f"ws://127.0.0.1:{port}/ws", "token": token,
                                          "reconnect": True})
        client.reconnect_max_backoff_s = 0.3
        answers, retries = [], 0

        async def traffic(n):
            nonlocal retries
            for i in range(n):
                out, tries = await _idempotent_add(client, i, 1)
                answers.append(out["sum"] == i + 1)
                retries += tries
                await asyncio.sleep(0.05)

        await traffic(4)
        crossing = asyncio.create_task(traffic(12))  # in flight across the crash
        await asyncio.sleep(0.1)
        proc1.send_signal(signal.SIGKILL)
        await proc1.wait()
        deadline = time.monotonic() + 10
        while host._orphaned_since is None and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        assert host._orphaned_since is not None

        proc2 = await spawn(["--recover"])
        ready2 = await _wait_marker(proc2, "READY")
        assert "epoch=2" in ready2 and "phase=RECOVERING" in ready2
        reconciled = await _wait_marker(proc2, "RECONCILED")
        assert "adopted=1" in reconciled and "replaced=0" in reconciled
        await crossing
        assert answers == [True] * 16 and retries > 0  # zero idempotent loss, and the crash was felt

        assert {rid: id(r.instance) for rid, r in host.replicas.items()} == instances
        deadline = time.monotonic() + 10
        while host.controller_epoch < 2 and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        assert host.controller_epoch == 2
        out, _ = await _idempotent_add(client, 40, 2)
        assert out["sum"] == 42
    finally:
        if client is not None:
            await client.disconnect()
        if host is not None:
            await host.stop()
        for proc in (proc1, proc2):
            if proc is not None and proc.returncode is None:
                proc.kill()
                await proc.wait()
