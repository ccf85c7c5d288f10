"""The cases of ``tests/test_multihost.py`` through both packages: a
``ServeController`` over a topology with no chips of its own, and worker
hosts that join it as subprocesses, ``python -m bioengine_tpu.worker_host
--platform cpu`` (4 virtual CPU devices) on the JAX plane and ``python -m
bioengine_tpu_torch.worker_host --device cpu --n-devices 4`` on the port's.

Each case is one ``async`` function of a package namespace and a control
plane. It makes the JAX test's assertions and returns what it observed:
placements, chip accounting, call results, error types and messages (ids
masked), the pending workload. ``test_same_outcomes`` runs it on each
plane in turn and requires the same observations; the cases whose JAX test
leaves its host alive share one host per plane
(``test_same_outcomes_on_a_shared_host``), so the file spawns few hosts. A rejoin case is added:
the server drops the host's connection, and the host rejoins and announces
its warm replica. Every host writes its
log into the test's directory; waits are bounded polls.
"""

import asyncio
import contextlib
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from _torch_parity import few_torch_threads, private_rpc_store  # noqa: F401
from bioengine_tpu.apps import builder as jax_builder
from bioengine_tpu.cluster import state as jax_state
from bioengine_tpu.cluster import topology as jax_topology
from bioengine_tpu.rpc import client as jax_client
from bioengine_tpu.rpc import server as jax_server
from bioengine_tpu.serving import controller as jax_controller
from bioengine_tpu.serving import remote as jax_remote
from bioengine_tpu.serving import replica as jax_replica
from bioengine_tpu.utils import permissions as jax_permissions
from bioengine_tpu.worker import code_executor as jax_executor
from bioengine_tpu_torch.apps import builder as torch_builder
from bioengine_tpu_torch.cluster import state as torch_state
from bioengine_tpu_torch.cluster import topology as torch_topology
from bioengine_tpu_torch.rpc import client as torch_client
from bioengine_tpu_torch.rpc import server as torch_server
from bioengine_tpu_torch.serving import controller as torch_controller
from bioengine_tpu_torch.serving import remote as torch_remote
from bioengine_tpu_torch.serving import replica as torch_replica
from bioengine_tpu_torch.utils import permissions as torch_permissions
from bioengine_tpu_torch.worker import code_executor as torch_executor

pytestmark = [pytest.mark.integration, pytest.mark.anyio]

REPO = Path(__file__).resolve().parent.parent
HOST_JOIN_S = 40
SHARED_HOST = "hs"
N_HOST_CHIPS = 4

# the JAX test's apps; each plane's copy imports its own package
CHIP_APP_MANIFEST = """\
name: Chip App
id: chip-app
id_emoji: "\U0001F9EA"
description: needs chips, so it must be placed on a worker host
type: tpu-serve
version: 1.0.0
deployments:
  - chip_deployment:ChipDeployment
authorized_users: ["*"]
deployment_config:
  chip_deployment:
    num_replicas: 1
    max_replicas: 2
    chips: 2
    autoscale: false
"""

CHIP_APP_SOURCE = '''\
import os
import socket

from bioengine_tpu.rpc import schema_method


class ChipDeployment:
    def __init__(self, tag: str = "none"):
        self.tag = tag

    async def async_init(self):
        self.pid = os.getpid()

    @schema_method
    async def where(self, context=None):
        """Report which process/host this replica runs in."""
        return {"pid": self.pid, "hostname": socket.gethostname(),
                "tag": self.tag}

    @schema_method
    async def add(self, a: int, b: int, context=None):
        """Add two ints (routing smoke check)."""
        return {"sum": a + b}
'''

COMPO_MANIFEST = """\
name: Compo App
id: compo-app
id_emoji: "\U0001F517"
description: remote entry composing a local sibling through the router
type: tpu-serve
version: 1.0.0
deployments:
  - entry_dep:EntryDep
  - backend_dep:BackendDep
authorized_users: ["*"]
deployment_config:
  entry_dep:
    chips: 2
    autoscale: false
  backend_dep:
    chips: 0
    autoscale: false
"""

COMPO_ENTRY = '''\
from bioengine_tpu.rpc import schema_method


class EntryDep:
    def __init__(self, backend_dep):
        self.backend = backend_dep

    @schema_method
    async def compute(self, x: int, context=None):
        """Delegate to the backend deployment via its handle."""
        doubled = await self.backend.call("double", x)
        return {"result": doubled["value"] + 1}
'''

COMPO_BACKEND = '''\
import os

from bioengine_tpu.rpc import schema_method


class BackendDep:
    def __init__(self):
        self.pid = os.getpid()

    @schema_method
    async def double(self, x: int, context=None):
        """Double a number; reports its pid for placement assertions."""
        return {"value": 2 * x, "pid": self.pid}
'''

RUN_CODE = (
    "import os\n"
    "def main():\n"
    "    return {'host': os.environ.get('BIOENGINE_HOST_ID'),\n"
    "            'chips': os.environ.get('BIOENGINE_LEASED_CHIPS')}\n"
)
SLOW_CODE = "import time\ndef main():\n    time.sleep(60)\n    return 'never'\n"


def _package(name, prefix, builder, state, topology, client, server, controller, remote, replica,
             permissions, executor, host_args, host_env):
    return SimpleNamespace(
        name=name, prefix=prefix, AppBuilder=builder.AppBuilder, ClusterState=state.ClusterState,
        TpuTopology=topology.TpuTopology, connect=client.connect_to_server, RpcServer=server.RpcServer,
        ServeController=controller.ServeController, DeploymentHandle=controller.DeploymentHandle,
        RemoteReplica=remote.RemoteReplica, ReplicaState=replica.ReplicaState,
        create_context=permissions.create_context, CodeExecutor=executor.CodeExecutor,
        host_args=host_args, host_env=host_env,
    )


PACKAGES = {
    "jax": _package(
        "jax", "bioengine_tpu", jax_builder, jax_state, jax_topology, jax_client, jax_server,
        jax_controller, jax_remote, jax_replica, jax_permissions, jax_executor,
        ["--platform", "cpu"],
        {"JAX_PLATFORMS": "cpu", "BIOENGINE_COMPILE_CACHE": "off",
         "XLA_FLAGS": f"--xla_force_host_platform_device_count={N_HOST_CHIPS}"},
    ),
    "torch": _package(
        "torch", "bioengine_tpu_torch", torch_builder, torch_state, torch_topology, torch_client,
        torch_server, torch_controller, torch_remote, torch_replica, torch_permissions, torch_executor,
        ["--device", "cpu", "--n-devices", str(N_HOST_CHIPS)], {},
    ),
}


def _error(exc: BaseException) -> tuple:
    """An error's type and message with generated ids masked."""
    text = re.sub(r"\b[0-9a-f]{8,}\b", "<id>", str(exc))
    return type(exc).__name__, re.sub(r"-[0-9a-f]{6,}\b", "-<id>", text)


def _write_app(pkg, root: Path, manifest: str, files: dict) -> Path:
    app_dir = root / "app-src"
    app_dir.mkdir(parents=True, exist_ok=True)
    (app_dir / "manifest.yaml").write_text(manifest)
    for name, text in files.items():
        (app_dir / name).write_text(text.replace("bioengine_tpu.", pkg.prefix + "."))
    return app_dir


class Plane:
    """The JAX test's ``control_plane`` fixture and ``_spawn_host``: an
    RpcServer, a controller with no chips of its own, and the hosts it
    spawned (stopped on exit, each with its log under ``root``)."""

    def __init__(self, pkg, root: Path):
        self.pkg, self.root = pkg, root
        self.hosts: list[subprocess.Popen] = []

    async def __aenter__(self):
        pkg = self.pkg
        self.server = pkg.RpcServer(host="127.0.0.1", admin_users=["admin"])
        await self.server.start()
        self.token = self.server.issue_token("admin", is_admin=True)
        self.controller = pkg.ServeController(
            pkg.ClusterState(pkg.TpuTopology(chips=(), n_hosts=1, platform="cpu")),
            health_check_period=3600,
        )
        self.controller.attach_rpc(self.server, admin_users=["admin"])
        await self.controller.start()
        return self

    async def __aexit__(self, *exc):
        for proc in self.hosts:
            if proc.poll() is None:
                proc.terminate()
            try:
                await asyncio.to_thread(proc.wait, 10)
            except subprocess.TimeoutExpired:
                proc.kill()
                await asyncio.to_thread(proc.wait, 10)
        await self.controller.stop()
        await self.server.stop()

    def spawn(self, host_id: str, **env) -> subprocess.Popen:
        pkg = self.pkg
        log = open(self.root / f"host-{host_id}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{pkg.prefix}.worker_host", "--server-url", self.server.url,
             # = form: a token_urlsafe value may start with '-'
             f"--token={self.token}", "--host-id", host_id, *pkg.host_args,
             "--workspace-dir", str(self.root / f"ws-{host_id}")],
            env={**os.environ, **pkg.host_env, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
                 "HOME": str(self.root / "home"), **env},
            stdout=log, stderr=subprocess.STDOUT,
        )
        log.close()
        self.hosts.append(proc)
        return proc

    async def wait_for_host(self, host_id: str, proc: subprocess.Popen):
        deadline = time.monotonic() + HOST_JOIN_S
        while time.monotonic() < deadline:
            host = self.controller.cluster_state.hosts.get(host_id)
            if host is not None and host.alive:
                return host
            if proc.poll() is not None:
                break
            await asyncio.sleep(0.1)
        log = (self.root / f"host-{host_id}.log").read_text()[-3000:]
        raise TimeoutError(f"host {host_id} never joined (rc {proc.poll()}): {log}")

    def admin(self):
        return self.pkg.create_context("admin")

    def executor(self):
        return self.pkg.CodeExecutor(
            admin_users=["admin"], cluster_state=self.controller.cluster_state,
            call_host=self.controller._call_host,
        )


def _healthy(plane, app_id: str, deployment: str) -> list:
    reps = plane.controller.apps[app_id].replicas[deployment]
    ok = (plane.pkg.ReplicaState.HEALTHY, plane.pkg.ReplicaState.TESTING)
    return [r for r in reps if r.state in ok]


# ---- the cases ----------------------------------------------------------------


async def join_place_route_and_failover(plane: Plane) -> dict:
    pkg, controller = plane.pkg, plane.controller
    app_dir = _write_app(pkg, plane.root, CHIP_APP_MANIFEST, {"chip_deployment.py": CHIP_APP_SOURCE})
    built = pkg.AppBuilder(workdir_root=plane.root / "apps").build(
        app_id="chip-app", local_path=app_dir,
        deployment_kwargs={"chip_deployment": {"tag": "multihost"}},
    )
    host1 = plane.spawn("h1")
    rec1 = await plane.wait_for_host("h1", host1)
    assert rec1.n_chips == N_HOST_CHIPS
    await controller.deploy("chip-app", built.specs)
    (replica,) = controller.apps["chip-app"].replicas["chip_deployment"]
    assert isinstance(replica, pkg.RemoteReplica) and replica.host_id == "h1"
    assert len(replica.device_ids) == 2 and len(rec1.chips_in_use) == 2
    assert controller.cluster_state.cluster_free_chips() == 2
    placed = {"host": replica.host_id, "device_ids": list(replica.device_ids),
              "chips_in_use": sorted(rec1.chips_in_use),
              "free": controller.cluster_state.cluster_free_chips()}

    handle = controller.get_handle("chip-app", "chip_deployment")
    where = await handle.call("where")
    assert where["pid"] == host1.pid and where["tag"] == "multihost"
    add = await handle.call("add", 20, 22)
    assert add["sum"] == 42

    host2 = plane.spawn("h2")
    await plane.wait_for_host("h2", host2)
    host1.send_signal(signal.SIGKILL)
    await asyncio.to_thread(host1.wait, 10)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        await controller.health_tick()
        healthy = _healthy(plane, "chip-app", "chip_deployment")
        if healthy and getattr(healthy[0], "host_id", None) == "h2":
            break
        await asyncio.sleep(0.3)
    assert not controller.cluster_state.hosts["h1"].alive
    healthy = _healthy(plane, "chip-app", "chip_deployment")
    assert len(healthy) == 1 and healthy[0].host_id == "h2"
    where2 = await handle.call("where")
    assert where2["pid"] == host2.pid
    rec2 = controller.cluster_state.hosts["h2"]
    return {
        "n_chips": rec1.n_chips, "placed": placed, "tag": where["tag"], "sum": add["sum"],
        "h1_alive": controller.cluster_state.hosts["h1"].alive,
        "after_failover": {"host": healthy[0].host_id, "device_ids": list(healthy[0].device_ids),
                           "h2_chips_in_use": sorted(rec2.chips_in_use),
                           "free": controller.cluster_state.cluster_free_chips(),
                           "pid_is_h2": where2["pid"] == host2.pid, "tag": where2["tag"]},
    }


async def remote_entry_composes_local_backend(plane: Plane) -> dict:
    """On the shared host: the chip-requiring entry lands there, its
    handle to the chip-free backend (local to the controller) routes back
    through ``serve-router.route_call``."""
    pkg, controller = plane.pkg, plane.controller
    app_dir = _write_app(pkg, plane.root / "compo", COMPO_MANIFEST,
                         {"entry_dep.py": COMPO_ENTRY, "backend_dep.py": COMPO_BACKEND})
    built = pkg.AppBuilder(workdir_root=plane.root / "compo-apps").build(
        app_id="compo-app", local_path=app_dir,
        make_handle=lambda name: pkg.DeploymentHandle(controller, "compo-app", name),
    )
    await controller.deploy("compo-app", built.specs)
    try:
        entry = controller.apps["compo-app"].replicas["entry_dep"][0]
        backend = controller.apps["compo-app"].replicas["backend_dep"][0]
        assert isinstance(entry, pkg.RemoteReplica) and entry.host_id == SHARED_HOST
        assert not isinstance(backend, pkg.RemoteReplica)
        result = await controller.get_handle("compo-app", "entry_dep").call("compute", 10)
        assert result["result"] == 21
        leased = sorted(controller.cluster_state.hosts[SHARED_HOST].chips_in_use)
    finally:
        await controller.undeploy("compo-app")  # the shared host's chips free again
    return {"entry_host": entry.host_id, "entry_remote": True, "backend_remote": False,
            "backend_chips": list(backend.device_ids), "leased": leased, "result": result}


async def no_host_no_chips_raises_and_enqueues_pending(plane: Plane) -> dict:
    pkg, controller = plane.pkg, plane.controller
    app_dir = _write_app(pkg, plane.root, CHIP_APP_MANIFEST, {"chip_deployment.py": CHIP_APP_SOURCE})
    built = pkg.AppBuilder(workdir_root=plane.root / "apps").build(app_id="chip-app2", local_path=app_dir)
    with pytest.raises(RuntimeError, match="none free") as raised:
        await controller.deploy("chip-app2", built.specs)
    pending = controller.cluster_state.pending()
    assert any(p.workload_id == "chip-app2/chip_deployment" for p in pending)
    return {"error": _error(raised.value),
            "pending": sorted((p.workload_id, sorted(p.resources.items())) for p in pending)}


async def run_code_without_a_host(plane: Plane) -> dict:
    """No chips requested: a local subprocess; chips requested with no
    host joined: a loud error."""
    executor, admin = plane.executor(), plane.admin()
    local = await executor.run_code(code=RUN_CODE, context=admin)
    assert local["status"] == "ok" and local["result"]["host"] is None
    with pytest.raises(RuntimeError, match="no joined host") as raised:
        await executor.run_code(code=RUN_CODE, remote_options={"num_chips": 2}, context=admin)
    return {"local": local["result"], "nothing_anywhere": _error(raised.value)}


async def run_code_dispatches_to_host_with_chips(plane: Plane) -> dict:
    """On the shared host: the run lands there with a leased chip set
    visible to the child process, and the lease is released after."""
    executor, admin = plane.executor(), plane.admin()
    seen: dict = {}
    result = await executor.run_code(code=RUN_CODE, remote_options={"num_chips": 2}, context=admin)
    assert result["status"] == "ok", result
    assert result["host_id"] == SHARED_HOST and result["result"] == {"host": SHARED_HOST, "chips": "0,1"}
    assert result["device_ids"] == [0, 1]
    hrec = plane.controller.cluster_state.hosts[SHARED_HOST]
    assert hrec.chips_in_use == {}
    seen["remote"] = {k: result[k] for k in ("status", "host_id", "result", "device_ids")}
    seen["released"] = dict(hrec.chips_in_use)
    with pytest.raises(RuntimeError, match="no joined host") as raised:
        await executor.run_code(code=RUN_CODE, remote_options={"num_chips": 64}, context=admin)
    seen["too_many"] = _error(raised.value)
    with pytest.raises(ValueError, match="unsupported remote_options") as raised:
        await executor.run_code(code=RUN_CODE, remote_options={"num_gpus": 1}, context=admin)
    seen["unknown_option"] = _error(raised.value)
    return seen


async def protected_host_service_rejects_non_admin(plane: Plane) -> dict:
    """On the shared host: anonymous callers cannot reach the host's
    verbs, the admin can."""
    svc_id = plane.controller.cluster_state.hosts[SHARED_HOST].service_id
    conn = await plane.pkg.connect({"server_url": plane.server.url})
    try:
        with pytest.raises(Exception, match="protected") as raised:
            await conn.call(svc_id, "describe")
    finally:
        await conn.disconnect()
    conn = await plane.pkg.connect({"server_url": plane.server.url, "token": plane.token})
    try:
        desc = await conn.call(svc_id, "describe")
    finally:
        await conn.disconnect()
    assert desc["host_id"] == SHARED_HOST
    return {"anonymous": _error(raised.value), "host_id": desc["host_id"], "keys": sorted(desc),
            "compile_tier": sorted(desc["compile_tier"]), "n_chips": desc["topology"]["n_chips"],
            "platform": desc["topology"]["platform"], "replicas": desc["replicas"],
            "orphaned": desc["orphaned"], "service_id": svc_id.split(":")[-1].split("/")[-1]}


async def run_code_host_death_fails_fast_and_releases_lease(plane: Plane) -> dict:
    executor = plane.executor()
    host = plane.spawn("hkill")
    await plane.wait_for_host("hkill", host)
    task = asyncio.create_task(executor.run_code(
        code=SLOW_CODE, remote_options={"num_chips": 1}, timeout=90.0, context=plane.admin()))
    deadline = time.monotonic() + 20
    hrec = plane.controller.cluster_state.hosts["hkill"]
    while not hrec.chips_in_use and time.monotonic() < deadline:
        await asyncio.sleep(0.1)
    assert hrec.chips_in_use, "run_code never leased chips"
    leased = dict(hrec.chips_in_use)
    host.kill()
    t0 = time.monotonic()
    with pytest.raises(ConnectionError) as raised:
        await task
    assert time.monotonic() - t0 < 20
    assert hrec.chips_in_use == {}
    return {"leased": sorted(leased), "error": type(raised.value).__name__, "released": dict(hrec.chips_in_use)}


async def host_rejoins_with_its_warm_replica(plane: Plane) -> dict:
    """The server closes the host's WebSocket (a network blip, no call in
    flight); the host reconnects, rejoins, announces its still-warm
    replica, and the controller re-adopts it: same process, same replica
    id, chips leased again, no second placement."""
    pkg, controller, server = plane.pkg, plane.controller, plane.server
    app_dir = _write_app(pkg, plane.root, CHIP_APP_MANIFEST, {"chip_deployment.py": CHIP_APP_SOURCE})
    built = pkg.AppBuilder(workdir_root=plane.root / "apps").build(app_id="chip-app", local_path=app_dir)
    host = plane.spawn("hr")
    rec = await plane.wait_for_host("hr", host)
    await controller.deploy("chip-app", built.specs)
    (replica,) = controller.apps["chip-app"].replicas["chip_deployment"]
    leased = dict(rec.chips_in_use)
    handle = controller.get_handle("chip-app", "chip_deployment")
    where = await handle.call("where")
    assert where["pid"] == host.pid

    svc_id = rec.service_id
    first_client = server._services[svc_id].owner_client
    await server._clients[first_client].close()
    rejoins: list = []
    deadline = time.monotonic() + 20
    while not rejoins and time.monotonic() < deadline:
        await asyncio.sleep(0.05)
        entry = server._services.get(svc_id)
        if entry is None or entry.owner_client == first_client:
            continue
        record = await controller._call_host(svc_id, "get_flight_record", limit=500)
        rejoins = [e["attrs"] for e in record["events"] if e["type"] == "host.rejoin"]
    assert rejoins == [{"host": "hr", "kept": 1, "dropped": 0}], rejoins
    rec = controller.cluster_state.hosts["hr"]
    (after,) = controller.apps["chip-app"].replicas["chip_deployment"]
    assert rec.alive and after is replica and dict(rec.chips_in_use) == leased
    again = await handle.call("where")
    assert again["pid"] == host.pid and host.poll() is None
    add = await handle.call("add", 1, 2)
    return {"chips": sorted(leased), "rejoin": rejoins[-1], "same_replica": after is replica,
            "same_pid": again["pid"] == where["pid"], "state": after.state.value, "sum": add["sum"]}


# cases that kill their host, watch it join, or need none: a fresh plane each
CASES = [
    join_place_route_and_failover,
    no_host_no_chips_raises_and_enqueues_pending,
    run_code_without_a_host,
    run_code_host_death_fails_fast_and_releases_lease,
    host_rejoins_with_its_warm_replica,
]
# cases whose JAX test leaves its host alive: one shared host per plane
SHARED_CASES = [
    remote_entry_composes_local_backend,
    run_code_dispatches_to_host_with_chips,
    protected_host_service_rejects_non_admin,
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
async def test_same_outcomes(case, tmp_path):
    seen = {}
    for name, pkg in PACKAGES.items():
        root = tmp_path / name
        root.mkdir()
        with private_rpc_store():
            async with Plane(pkg, root) as plane:
                seen[name] = await case(plane)
    assert seen["torch"] == seen["jax"]


@pytest.fixture(scope="module")
async def shared_planes(tmp_path_factory):
    """A plane per package with the host ``hs`` joined, both hosts spawned
    together; each plane's server has a shared-memory segment of its own."""
    with contextlib.ExitStack() as stores:
        async with contextlib.AsyncExitStack() as stack:
            planes = {}
            for name, pkg in PACKAGES.items():
                stores.enter_context(private_rpc_store())  # read once, at the server's start
                plane = Plane(pkg, tmp_path_factory.mktemp(f"shared-{name}"))
                planes[name] = await stack.enter_async_context(plane)
                plane.spawn(SHARED_HOST)
            for plane in planes.values():
                await plane.wait_for_host(SHARED_HOST, plane.hosts[0])
            yield planes


@pytest.mark.parametrize("case", SHARED_CASES, ids=lambda c: c.__name__)
async def test_same_outcomes_on_a_shared_host(case, shared_planes):
    seen = {name: await case(plane) for name, plane in shared_planes.items()}
    assert seen["torch"] == seen["jax"]

