"""The worker's cases of ``tests/test_worker.py`` through both packages: the
JAX ``BioEngineWorker`` serving ``apps/demo-app`` and the port's
``BioEngineWorker(device="cpu")`` serving ``bioengine_tpu_torch/apps/
bundles/demo-app``.

Each case is one ``async`` function of a package namespace. It makes the
JAX test's assertions and returns what it observed: results of
``run_code``, status keys, app ids and echoes, errors by type and
message. ``test_same_outcomes`` runs it on each package and requires the
same observations. Values that differ by platform are masked where they
are read: the JAX package sees 8 virtual CPU devices, the port one CPU
chip; ``memory_profile`` returns pprof bytes on one side and the CUDA
allocator's snapshot (empty without CUDA) on the other. Every worker runs
in a temporary workspace and ``HOME``, with geolocation and the JAX
compile cache off and the datasets discovery file in the temporary dir.
Waits are bounded polls, never fixed sleeps.
"""

import asyncio
import base64
import re
import time
from pathlib import Path
from types import SimpleNamespace

import aiohttp
import cloudpickle
import pytest
import torch

from _torch_parity import few_torch_threads, private_rpc_store  # noqa: F401
from bioengine_tpu.datasets import datasets as jax_datasets_mod
from bioengine_tpu.datasets import proxy_server as jax_proxy
from bioengine_tpu.rpc import client as jax_client
from bioengine_tpu.utils import flight as jax_flight
from bioengine_tpu.utils import permissions as jax_permissions
from bioengine_tpu.utils import tracing as jax_tracing
from bioengine_tpu.worker import __main__ as jax_main
from bioengine_tpu.worker import code_executor as jax_executor
from bioengine_tpu.worker import worker as jax_worker
from bioengine_tpu_torch.datasets import datasets as torch_datasets_mod
from bioengine_tpu_torch.datasets import proxy_server as torch_proxy
from bioengine_tpu_torch.rpc import client as torch_client
from bioengine_tpu_torch.utils import flight as torch_flight
from bioengine_tpu_torch.utils import permissions as torch_permissions
from bioengine_tpu_torch.utils import tracing as torch_tracing
from bioengine_tpu_torch.worker import __main__ as torch_main
from bioengine_tpu_torch.worker import code_executor as torch_executor
from bioengine_tpu_torch.worker import worker as torch_worker

pytestmark = [pytest.mark.end_to_end, pytest.mark.anyio]

REPO = Path(__file__).resolve().parent.parent


def _device_work_jax():
    import jax.numpy as jnp

    return float(jnp.ones((64, 64)).sum())


def _device_work_torch():
    return float(torch.ones(64, 64).sum())


PACKAGES = {
    "jax": SimpleNamespace(
        name="jax", Worker=jax_worker.BioEngineWorker, worker_kwargs={},
        CodeExecutor=jax_executor.CodeExecutor, create_context=jax_permissions.create_context,
        connect=jax_client.connect_to_server, main=jax_main, flight=jax_flight,
        tracing=jax_tracing, demo=REPO / "apps" / "demo-app", device_work=_device_work_jax,
        modules=(jax_proxy, jax_datasets_mod),
    ),
    "torch": SimpleNamespace(
        name="torch", Worker=torch_worker.BioEngineWorker, worker_kwargs={"device": "cpu"},
        CodeExecutor=torch_executor.CodeExecutor, create_context=torch_permissions.create_context,
        connect=torch_client.connect_to_server, main=torch_main, flight=torch_flight,
        tracing=torch_tracing, demo=REPO / "bioengine_tpu_torch" / "apps" / "bundles" / "demo-app",
        device_work=_device_work_torch, modules=(torch_proxy, torch_datasets_mod),
    ),
}


@pytest.fixture(autouse=True)
def hermetic(tmp_path, monkeypatch):
    """Temporary HOME, no geolocation, no JAX compile cache, the
    datasets discovery file of both packages under ``tmp_path``, and a
    shared-memory segment of the test's own for the RPC servers."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("BIOENGINE_DISABLE_GEOLOCATION", "1")
    monkeypatch.setenv("BIOENGINE_COMPILE_CACHE", "off")
    monkeypatch.delenv("BIOENGINE_TPU_DATA_SERVER", raising=False)
    monkeypatch.delenv("BIOENGINE_ADMIN_TOKEN", raising=False)
    for pkg in PACKAGES.values():
        for module in pkg.modules:
            monkeypatch.setattr(module, "DISCOVERY_FILE", tmp_path / pkg.name / "current_server")
    with private_rpc_store():
        yield


def _admin(pkg):
    return pkg.create_context("admin", workspace="bioengine")


def _anon(pkg):
    return pkg.create_context("anonymous")


def _run_result(result: dict) -> dict:
    """A run_code result without its wall time."""
    return {k: v for k, v in result.items() if k != "duration_s"}


def _error(exc: BaseException) -> tuple:
    return type(exc).__name__, re.sub(r"-[0-9a-f]{8}\b", "-<id>", str(exc))


async def _until(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, "condition not reached in time"
        await asyncio.sleep(0.01)


async def _start(pkg, ws: Path, **kw):
    kw.setdefault("admin_users", ["admin"])
    kw.setdefault("log_file", "off")
    kw.setdefault("monitoring_interval_seconds", 5.0)
    w = pkg.Worker(mode="single-machine", workspace_dir=ws, **pkg.worker_kwargs, **kw)
    await w.start()
    return w


class _LiveWorker:
    """The JAX test's ``worker`` fixture: a worker with the demo app as
    its startup application."""

    def __init__(self, pkg, tmp_path):
        self.pkg, self.tmp_path = pkg, tmp_path

    async def __aenter__(self):
        self.w = await _start(self.pkg, self.tmp_path / f"ws-{self.pkg.name}",
                              startup_applications=[{"local_path": str(self.pkg.demo)}],
                              monitoring_interval_seconds=0.2)
        return self.w

    async def __aexit__(self, *exc):
        if self.w.is_ready:
            await self.w.stop()


# ---- code executor ----------------------------------------------------------


async def run_code_modes(pkg, tmp_path):
    ex = pkg.CodeExecutor(admin_users=["admin"], default_timeout=60.0)
    admin = _admin(pkg)
    seen = {}
    seen["source"] = _run_result(await ex.run_code(
        code="def main(x, y):\n    print('working')\n    return x + y\n", args=[2, 3], context=admin))
    assert seen["source"]["result"] == 5 and "working" in seen["source"]["stdout"]
    seen["named"] = _run_result(await ex.run_code(
        code=("import asyncio\nasync def compute(n):\n    await asyncio.sleep(0)\n"
              "    return n * 2\ndef other():\n    return 'no'\n"),
        function_name="compute", args=[21], context=admin))
    assert seen["named"]["result"] == 42

    def work(a, b=1):
        return {"sum": a + b}

    payload = base64.b64encode(cloudpickle.dumps(work)).decode()
    seen["pickle"] = _run_result(await ex.run_code(
        function=payload, mode="pickle", args=[4], kwargs={"b": 6}, context=admin))
    assert seen["pickle"]["result"] == {"sum": 10}
    seen["error"] = _run_result(await ex.run_code(
        code="def main():\n    raise ValueError('boom')\n", context=admin))
    assert seen["error"]["status"] == "error" and "ValueError: boom" in seen["error"]["error"]
    seen["error"]["error"] = seen["error"]["error"].splitlines()[-1]  # traceback paths differ
    lines: list[str] = []
    streamed = await ex.run_code(
        code=("import sys\ndef main():\n    print('out1')\n"
              "    print('err1', file=sys.stderr)\n    print('out2')\n"),
        write_stdout=lines.append, write_stderr=lines.append, context=admin)
    seen["stream"] = (streamed["status"], sorted("".join(lines).split()))
    assert seen["stream"] == ("ok", ["err1", "out1", "out2"])
    seen["env"] = _run_result(await ex.run_code(
        code="import os\ndef main():\n    return os.environ['MY_FLAG']\n",
        remote_options={"env_vars": {"MY_FLAG": "on"}}, context=admin))
    assert seen["env"]["result"] == "on"
    with pytest.raises(PermissionError) as exc:
        await ex.run_code(code="def main():\n    return 1\n", context=_anon(pkg))
    seen["admin_check"] = _error(exc.value)
    huge = await ex.run_code(code="def main():\n    print('x' * 200000)\n    return 1\n",
                             context=admin)
    seen["huge"] = (huge["status"], huge["result"], len(huge["stdout"]))
    assert seen["huge"][:2] == ("ok", 1) and seen["huge"][2] >= 200000
    exited = await ex.run_code(code="import sys\nsys.exit(3)\ndef main():\n    return 1\n",
                               context=admin)
    seen["toplevel_exit"] = (exited["status"], "SystemExit" in exited["error"])
    assert seen["toplevel_exit"] == ("error", True)
    return seen


async def run_code_timeout(pkg, tmp_path):
    ex = pkg.CodeExecutor(admin_users=["admin"], default_timeout=60.0)
    result = await ex.run_code(code="import time\ndef main():\n    time.sleep(30)\n",
                               timeout=1.0, context=_admin(pkg))
    assert result["status"] == "timeout"
    return result["status"], result["result"]


# ---- the CLI ----------------------------------------------------------------


async def worker_arg_parsing(pkg, tmp_path):
    args = pkg.main.create_parser().parse_args([
        "--mode", "single-machine", "--admin-users", "alice", "bob",
        "--startup-applications", '[{"local_path": "apps/demo-app"}]', "--port", "1234",
    ])
    kwargs = pkg.main.worker_kwargs_from_args(args)
    assert kwargs["admin_users"] == ["alice", "bob"]
    assert kwargs["startup_applications"] == [{"local_path": "apps/demo-app"}]
    assert kwargs["port"] == 1234
    parse = pkg.main.parse_startup_applications
    assert parse(None) == [] and parse('{"a": 1}') == [{"a": 1}]
    with pytest.raises(ValueError) as exc:
        parse('["not-a-dict"]')
    kwargs.pop("device", None)  # the port's one more argument
    return kwargs, _error(exc.value)


# ---- a live worker ----------------------------------------------------------


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__ if tree is not None else None


async def status_and_calls(pkg, tmp_path):
    async with _LiveWorker(pkg, tmp_path) as worker:
        status = worker.get_status(context=_admin(pkg))
        assert status["worker"]["ready"] is True and status["worker"]["uptime_seconds"] >= 0
        assert status["cluster"]["ready"] is True
        (app_status,) = status["applications"].values()
        assert app_status["status"] == "RUNNING" and app_status["name"] == "Demo App"
        assert "ping" in app_status["available_methods"]
        topology = status["cluster"]["topology"]
        seen = {
            "platform": topology["platform"],
            "n_chips": topology["n_chips"] == (8 if pkg.name == "jax" else 1),
            "worker_keys": sorted(status["worker"]),
            "status_keys": sorted(status),
            "app_keys": sorted(app_status),
            "app": {k: app_status[k] for k in ("status", "name", "available_methods",
                                               "authorized_users")},
        }
        (app_id,) = worker.apps_manager.records
        echo = await worker.server.call_service_method(
            f"bioengine/{app_id}", "echo", kwargs={"message": "hi"})
        seen["echo"] = (echo["echo"], echo["greeting"])
        admin_caller = worker.server._tokens[worker.server.issue_token("admin")]
        ran = await worker.server.call_service_method(
            "bioengine/bioengine-worker", "run_code",
            kwargs={"code": "def main():\n    return 7\n"}, caller=admin_caller)
        seen["run_code_service"] = ran["result"]
        await _until(lambda: worker._monitor_errors == 0 and worker.is_ready)
        with pytest.raises(PermissionError) as exc:
            worker.get_logs(context=_anon(pkg))
        seen["logs_refused"] = _error(exc.value)
        seen["logs"] = type(worker.get_logs(context=_admin(pkg))).__name__

        base = f"http://{worker.server.host}:{worker.server.port}"
        async with aiohttp.ClientSession() as http:
            async with http.get(f"{base}/apps/_dashboard/") as r:
                seen["dashboard"] = (r.status, "Worker Dashboard" in await r.text())
            async with http.post(f"{base}/call/bioengine-worker/get_status", json={}) as r:
                bridged = (await r.json())["result"]
                seen["bridge_status"] = (bridged["worker"]["ready"], sorted(bridged))
            async with http.get(f"{base}/services") as r:
                seen["services"] = sorted(s["type"] for s in await r.json()
                                          if s["type"] == "bioengine-worker")
    assert seen["dashboard"] == (200, True)
    return seen


async def deploy_and_stop_app(pkg, tmp_path):
    async with _LiveWorker(pkg, tmp_path) as worker:
        admin = _admin(pkg)
        result = await worker.apps_manager.deploy_app(
            local_path=str(pkg.demo), deployment_kwargs={"demo_deployment": {"greeting": "Yo"}},
            context=admin)
        app_id = result["app_id"]
        echo = await worker.server.call_service_method(
            f"bioengine/{app_id}", "echo", kwargs={"message": "x"})
        assert echo["greeting"] == "Yo"
        await worker.apps_manager.stop_app(app_id, context=admin)
        assert app_id not in worker.apps_manager.records
        return {"methods": result["methods"], "name": result["name"],
                "echo": (echo["echo"], echo["greeting"]),
                "left": len(worker.apps_manager.records)}


async def profiling_verbs(pkg, tmp_path):
    async with _LiveWorker(pkg, tmp_path) as worker:
        admin, anon = _admin(pkg), _anon(pkg)
        seen = {}
        trace_dir = tmp_path / f"trace-{pkg.name}"
        with pytest.raises(PermissionError) as exc:
            worker.start_profiling(context=anon)
        seen["refused"] = _error(exc.value)
        started = worker.start_profiling(trace_dir=str(trace_dir), context=admin)
        with pytest.raises(RuntimeError) as exc:
            worker.start_profiling(context=admin)
        seen["twice"] = _error(exc.value)[0], str(exc.value).replace(str(trace_dir), "<dir>")
        pkg.device_work()
        stopped = worker.stop_profiling(context=admin)
        assert stopped["trace_dir"] == str(trace_dir)
        assert any(trace_dir.rglob("*")), "trace dir is empty"
        with pytest.raises(RuntimeError) as exc:
            worker.stop_profiling(context=admin)
        seen["idle"] = _error(exc.value)
        seen["flags"] = (started["profiling"], stopped["profiling"])
        mem = worker.memory_profile(context=admin)
        if pkg.name == "jax":
            assert len(base64.b64decode(mem["pprof_b64"])) > 0 and mem["devices"]
        else:  # no CUDA here: no device to report
            assert mem == {"allocator_snapshot_pickle_b64": "", "devices": []}

        (app_id,) = worker.apps_manager.records
        with pytest.raises(PermissionError):
            await worker.profile_replica(app_id, context=anon)
        with pytest.raises(ValueError) as exc:
            await worker.profile_replica(app_id, action="bogus", context=admin)
        seen["bogus"] = _error(exc.value)
        replica_dir = tmp_path / f"replica-trace-{pkg.name}"
        on = await worker.profile_replica(app_id, trace_dir=str(replica_dir), context=admin)
        assert on["profiling"] is True and on["host_id"] == "local" and on["replica_id"]
        off = await worker.profile_replica(app_id, action="stop", context=admin)
        assert off["profiling"] is False and any(replica_dir.rglob("*"))
        memory = await worker.profile_replica(app_id, action="memory", context=admin)
        assert set(memory) >= {"replica_id", "app_id", "deployment", "host_id", "devices"}
        with pytest.raises(KeyError) as exc:
            await worker.profile_replica(app_id, replica_id="nope", context=admin)
        seen["no_replica"] = _error(exc.value).__repr__().replace(app_id, "<app>")
        seen["replica_keys"] = (sorted(on), sorted(off))
        return seen


async def flight_bundle_and_traces(pkg, tmp_path):
    async with _LiveWorker(pkg, tmp_path) as worker:
        admin, anon = _admin(pkg), _anon(pkg)
        with pytest.raises(PermissionError):
            worker.get_flight_record(context=anon)
        pkg.flight.record("test.worker_verb", marker=1)
        record = worker.get_flight_record(limit=500, context=admin)
        assert record["recorder"] == pkg.flight.recorder_id()
        types = {e["type"] for e in record["events"]}
        assert {"test.worker_verb", "replica.place"} <= types
        assert worker.get_flight_record(since=time.time() + 60, context=admin)["events"] == []
        with pytest.raises(PermissionError):
            await worker.debug_bundle(context=anon)
        bundle = await worker.debug_bundle(context=admin)
        for key in ("events", "traces", "metrics", "cluster", "apps", "hosts", "worker"):
            assert key in bundle, key
        (app_status,) = bundle["apps"].values()
        assert "cost" in app_status and bundle["worker"]["ready"] is True

        pkg.tracing.clear_spans()
        for i in range(8):
            with pkg.tracing.span("verb.span", i=i):
                pass
        last3 = [s["attrs"]["i"] for s in worker.get_traces(name="verb.span", limit=3,
                                                             context=admin)]
        cursor = worker.get_traces(name="verb.span", max_spans=100, context=admin)[4]["started_at"]
        newer = [s["attrs"]["i"] for s in worker.get_traces(
            name="verb.span", max_spans=100, since=cursor, context=admin)]
        assert last3 == [5, 6, 7]
        return {"bundle_keys": sorted(bundle), "worker_keys": sorted(bundle["worker"]),
                "last3": last3, "newer": newer}


# ---- lifecycles -------------------------------------------------------------


async def stop_worker_over_websocket(pkg, tmp_path):
    w = await _start(pkg, tmp_path / f"ws3-{pkg.name}")
    token = w.server.issue_token("admin")
    conn = await pkg.connect({"server_url": w.server.url, "token": token})
    svc = await conn.get_service("bioengine-worker")
    result = await asyncio.wait_for(svc.stop_worker(), timeout=10.0)
    await conn.disconnect()
    await asyncio.wait_for(w._stop_event.wait(), timeout=10.0)
    assert not w.is_ready
    return result


async def graceful_stop_releases_the_lock(pkg, tmp_path):
    ws = tmp_path / f"ws2-{pkg.name}"
    w = await _start(pkg, ws)
    assert w.is_ready
    await w.stop()
    lock_left = (ws / "cluster.lock").exists()
    w2 = await _start(pkg, ws)
    ready = w2.is_ready
    await w2.stop()
    return {"ready": ready, "lock_left": lock_left, "stopped": w.is_ready}


async def restart_recovers_apps(pkg, tmp_path):
    ws = tmp_path / f"ws-recover-{pkg.name}"
    w = await _start(pkg, ws)
    result = await w.apps_manager.deploy_app(
        local_path=str(pkg.demo), app_id="persist-me",
        deployment_kwargs={"demo_deployment": {"greeting": "Back"}}, context=_admin(pkg))
    await w.stop()
    w2 = await _start(pkg, ws)
    try:
        assert "persist-me" in w2.apps_manager.records
        echo = await w2.server.call_service_method(
            "bioengine/persist-me", "echo", kwargs={"message": "again"})
    finally:
        await w2.stop()
    return result["app_id"], echo["echo"], echo["greeting"]


async def explicit_stop_forgets_apps(pkg, tmp_path):
    ws = tmp_path / f"ws-forget-{pkg.name}"
    w = await _start(pkg, ws)
    await w.apps_manager.deploy_app(local_path=str(pkg.demo), app_id="forget-me",
                                    context=_admin(pkg))
    await w.apps_manager.stop_app("forget-me", context=_admin(pkg))
    await w.stop()
    w2 = await _start(pkg, ws)
    try:
        return sorted(w2.apps_manager.records)
    finally:
        await w2.stop()


CASES = [
    run_code_modes,
    run_code_timeout,
    worker_arg_parsing,
    status_and_calls,
    deploy_and_stop_app,
    profiling_verbs,
    flight_bundle_and_traces,
    stop_worker_over_websocket,
    graceful_stop_releases_the_lock,
    restart_recovers_apps,
    explicit_stop_forgets_apps,
]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
async def test_same_outcomes(case, tmp_path):
    ours = await case(PACKAGES["torch"], tmp_path / "torch")
    assert ours == await case(PACKAGES["jax"], tmp_path / "jax")


# ---- the port's own -----------------------------------------------------------


def test_chip_env_names_the_cuda_devices():
    assert torch_executor.chip_env([0]) == {
        "CUDA_VISIBLE_DEVICES": "0", "BIOENGINE_LEASED_CHIPS": "0"}
    assert torch_executor.chip_env([1, 3])["CUDA_VISIBLE_DEVICES"] == "1,3"


async def test_run_code_with_a_chip_sees_only_its_lease(tmp_path):
    w = await _start(PACKAGES["torch"], tmp_path / "ws-lease")
    try:
        result = await w.code_executor.run_code(
            code=("import os\ndef main():\n    return os.environ.get('CUDA_VISIBLE_DEVICES'),"
                  " os.environ.get('BIOENGINE_LEASED_CHIPS'), os.environ.get('TPU_VISIBLE_CHIPS')\n"),
            remote_options={"num_chips": 1}, context=_admin(PACKAGES["torch"]))
        assert result["status"] == "ok", result
        assert tuple(result["result"]) == ("0", "0", None) and result["device_ids"] == [0]
        assert w.cluster.state.free_chips() == 1  # the lease is released
    finally:
        await w.stop()


async def test_default_device_raises_at_start_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = torch_worker.BioEngineWorker(workspace_dir=tmp_path / "ws-cuda", log_file="off")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        await w.start()
    assert not (tmp_path / "ws-cuda" / "cluster.lock").exists()
    w = torch_worker.BioEngineWorker(workspace_dir=tmp_path / "ws-cpu", log_file="off",
                                     device="cpu")
    await w.start()
    try:
        assert w.get_status(context=_admin(PACKAGES["torch"]))["cluster"]["topology"][
            "platform"] == "cpu"
    finally:
        await w.stop()
