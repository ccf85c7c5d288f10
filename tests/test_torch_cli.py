"""The cases of ``tests/test_cli.py`` through both CLIs: the JAX
``bioengine`` (``bioengine_tpu.cli``) against a live JAX worker serving
``apps/demo-app``, and the port's ``bioengine-torch``
(``bioengine_tpu_torch.cli``) against a live port worker
(``device="cpu"``, 8 CPU chips, as many as the JAX worker sees) serving
``bioengine_tpu_torch/apps/bundles/demo-app``, both through ``CliRunner``.

Each case runs the same command lines through each CLI against its own
worker and requires equal JSON outputs after masking what differs by
process: ids, URLs, tokens, paths, pids and times (``_mask``), and the
platform's names. ``cluster profile --memory`` is the one listed
difference: the port reports the CUDA allocator snapshot's size
(``allocator_snapshot_bytes``, 0 without CUDA) where the JAX CLI reports
``pprof_bytes``. ``models convert`` writes npz files that must be equal
member by member. ``scenarios`` and ``fuzz`` need no worker: both CLIs
run them in process, the port's hosts on ``--device cpu``, and their JSON
must be equal with the timings left out. The standalone uploader stays
JAX-only: its script is not ported; ``analyze`` is held against the JAX
analyzer in ``test_torch_analysis.py``. Each worker runs in a thread of
its own with its own event loop, workspace, ``HOME`` and shared-memory
segment, with geolocation and the JAX compile cache off.
"""

import asyncio
import json
import os
import re
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import chip_smoke
from _torch_parity import few_torch_threads, private_rpc_store  # noqa: F401
from bioengine_tpu.cli import cli as jax_cli
from bioengine_tpu.cli import utils as jax_utils
from bioengine_tpu.cluster import cluster as jax_cluster
from bioengine_tpu.datasets import datasets as jax_datasets_mod
from bioengine_tpu.datasets import proxy_server as jax_proxy
from bioengine_tpu.runtime import convert as jax_convert
from bioengine_tpu.serving import journal as jax_journal
from bioengine_tpu.worker import worker as jax_worker
from bioengine_tpu_torch.cli import cli as torch_cli
from bioengine_tpu_torch.cli import utils as torch_utils
from bioengine_tpu_torch.cluster import cluster as torch_cluster
from bioengine_tpu_torch.cluster.topology import detect_topology
from bioengine_tpu_torch.datasets import datasets as torch_datasets_mod
from bioengine_tpu_torch.datasets import proxy_server as torch_proxy
from bioengine_tpu_torch.runtime import convert as torch_convert
from bioengine_tpu_torch.serving import journal as torch_journal
from bioengine_tpu_torch.worker import worker as torch_worker

pytestmark = [pytest.mark.end_to_end]

REPO = Path(__file__).resolve().parent.parent
N_CHIPS = 8

PACKAGES = {
    "jax": SimpleNamespace(
        name="jax", main=jax_cli.main, utils=jax_utils, Worker=jax_worker.BioEngineWorker,
        worker_kwargs={}, demo=REPO / "apps" / "demo-app", convert=jax_convert,
        journal=jax_journal, cluster=jax_cluster, modules=(jax_proxy, jax_datasets_mod),
        prefix="bioengine_tpu",
    ),
    "torch": SimpleNamespace(
        name="torch", main=torch_cli.main, utils=torch_utils, Worker=torch_worker.BioEngineWorker,
        worker_kwargs={"device": "cpu"}, demo=REPO / "bioengine_tpu_torch" / "apps" / "bundles" / "demo-app",
        convert=torch_convert, journal=torch_journal, cluster=torch_cluster,
        modules=(torch_proxy, torch_datasets_mod), prefix="bioengine_tpu_torch",
    ),
}

# values that differ from process to process, masked by key
VOLATILE = re.compile(
    r"(^|_)(s|ms|ts|at|time|seconds|uptime|pid|pids|url|urls|token|path|dir|directory|written|"
    r"hostname|rss|bytes|mb|gb|percent|since|until|start|end|duration|latency|"
    r"threads|fds|memory|id|ids|lag|skew|offset|version|created|updated|last)(_|$)"
)
HEX_ID = re.compile(r"\b[0-9a-f]{6,}\b")
URL = re.compile(r"\b(?:wss?|https?)://[^\s'\"]+")
PATH = re.compile(r"(?:/[\w.@+-]+){2,}/?")


def _mask_text(text: str) -> str:
    text = text.replace("bioengine_tpu_torch", "bioengine_tpu")
    text = URL.sub("<url>", text)
    text = PATH.sub("<path>", text)
    return HEX_ID.sub("<id>", text)


def _mask(tree, key: str = ""):
    """A CLI's JSON output with what differs by process masked: values
    under volatile keys (times, ids, URLs, tokens, paths, pids, sizes), and
    ids, URLs and paths inside any string; floats are masked to their
    type (times and rates)."""
    if isinstance(tree, dict):
        return {_mask_text(str(k)): _mask(v, str(k).lower()) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_mask(v, key) for v in tree]
    if tree is None or isinstance(tree, bool):
        return tree
    if VOLATILE.search(key):
        return f"<{type(tree).__name__}>"
    if isinstance(tree, float):
        return "<float>"
    if isinstance(tree, str):
        return _mask_text(tree)
    return tree


# ---- live workers -------------------------------------------------------------


def _live_worker(pkg, root: Path):
    """A worker in a daemon thread with its own loop; returns its holder."""
    holder: dict = {"pkg": pkg}
    started = threading.Event()

    def run():
        async def serve():
            try:
                worker = pkg.Worker(
                    mode="single-machine", workspace_dir=root / "ws", admin_users=["admin"],
                    startup_applications=[{"local_path": str(pkg.demo)}],
                    monitoring_interval_seconds=5.0, log_file="off", **pkg.worker_kwargs,
                )
                if pkg.name == "torch":  # as many CPU chips as the JAX worker sees
                    worker.cluster._topology = detect_topology(device="cpu", n_devices=N_CHIPS)
                await worker.start()

                async def scale(image, factor: float = 2.0, context=None):
                    return {"out": np.asarray(image) * factor, "shape": list(np.shape(image))}

                worker.server.register_local_service(
                    {"id": "array-app", "config": {"visibility": "public"}, "scale": scale})
                holder.update(worker=worker, url=worker.server.url, loop=asyncio.get_running_loop(),
                              token=worker.server.issue_token("admin"))
            except BaseException as e:  # noqa: BLE001 — reported to the fixture
                holder["error"] = e
                started.set()
                raise
            started.set()
            await worker._stop_event.wait()

        asyncio.run(serve())

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(timeout=90), f"{pkg.name} worker failed to start"
    assert "error" not in holder, holder.get("error")
    holder["thread"] = thread
    return holder


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli-workers")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(tmp / "home"))
        mp.setenv("BIOENGINE_DISABLE_GEOLOCATION", "1")
        mp.setenv("BIOENGINE_COMPILE_CACHE", "off")
        for var in ("BIOENGINE_TPU_DATA_SERVER", "BIOENGINE_ADMIN_TOKEN", "BIOENGINE_SERVER_URL",
                    "BIOENGINE_TOKEN", "BIOENGINE_WORKSPACE", "BIOENGINE_CONTROL_DIR"):
            mp.delenv(var, raising=False)
        live = {}
        with private_rpc_store():
            for name, pkg in PACKAGES.items():
                for module in pkg.modules:
                    mp.setattr(module, "DISCOVERY_FILE", tmp / name / "current_server")
                with private_rpc_store():  # each worker's server its own segment
                    live[name] = _live_worker(pkg, tmp / name)
            try:
                yield live
            finally:
                for holder in live.values():
                    asyncio.run_coroutine_threadsafe(holder["worker"].stop(), holder["loop"]).result(60)
                    holder["thread"].join(timeout=10)


def _cli(holder, *args):
    result = CliRunner().invoke(
        holder["pkg"].main,
        # = form: a generated token may start with "-"
        list(args) + [f"--server-url={holder['url']}", f"--token={holder['token']}"],
        catch_exceptions=False,
    )
    assert result.exit_code == 0, (holder["pkg"].name, args, result.output)
    return json.loads(result.stdout)


def _both(workers, *args) -> dict:
    return {name: _cli(holder, *args) for name, holder in workers.items()}


def _diff(a, b, path="") -> list:
    if isinstance(a, dict) and isinstance(b, dict):
        return [d for k in sorted(set(a) | set(b), key=str)
                for d in _diff(a.get(k, "<absent>"), b.get(k, "<absent>"), f"{path}/{k}")]
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _diff(x, y, f"{path}[{i}]")]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"[:300]]


def _app_ids_in(tree, found: set) -> set:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "app_id" and isinstance(v, str):
                found.add(v)
            _app_ids_in(v, found)
    elif isinstance(tree, list):
        for v in tree:
            _app_ids_in(v, found)
    return found


def _unname(tree, ids: set):
    """Generated app ids (two random words) replaced by ``<app>``."""
    if isinstance(tree, dict):
        return {("<app>" if k in ids else k): _unname(v, ids) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unname(v, ids) for v in tree]
    if isinstance(tree, str):
        for app_id in ids:
            tree = tree.replace(app_id, "<app>")
    return tree


def _same(outs: dict):
    masked = {}
    for name, out in outs.items():
        ids = _app_ids_in(out, set()) - {"demo-app", "client-app"}
        masked[name] = _mask(_unname(out, ids))
    differ = _diff(masked["torch"], masked["jax"])
    assert not differ, "\n".join(differ)


def _app_ids(workers) -> dict:
    return {name: next(iter(h["worker"].apps_manager.records)) for name, h in workers.items()}


# ---- scenarios and fuzz: in process, no worker --------------------------------
# (first in the file: they run before the module's live workers start, whose
# threads would share this process with the scenarios' in-process hosts)

# invariants whose detail carries a measured sample (a queue's peak depth, a
# latency quantile): the verdict is compared, the sample is not
SAMPLED = ("bounded_queues", "slo_attainment", "p99_recovery")


@pytest.fixture
def logging_restored():
    """``scenarios run`` and ``fuzz`` silence logging below ERROR for the
    process (``logging.disable``), as in JAX; give it back after the test."""
    import logging

    level = logging.root.manager.disable
    yield
    logging.disable(level)


def _local(main, *args) -> tuple[int, dict]:
    result = CliRunner().invoke(main, list(args), catch_exceptions=False)
    return result.exit_code, json.loads(result.stdout)


def _untimed(out: dict) -> dict:
    """``scenarios run``'s JSON without its timings: wall and latency figures
    and the sampled invariants' details."""
    result = {k: v for k, v in out["result"].items() if k not in ("wall_s", "latency_ms", "phases")}
    result["invariants"] = {k: {f: x for f, x in v.items() if not (k in SAMPLED and f == "detail")}
                            for k, v in result["invariants"].items()}
    return {**out, "result": result}


def test_scenarios_list_equals_jax():
    outs = {name: _local(pkg.main, "scenarios", "list") for name, pkg in PACKAGES.items()}
    assert outs["torch"] == outs["jax"] and outs["torch"][0] == 0
    assert {"slow_replica", "controller_crash", "router_loss"} <= {s["name"] for s in outs["torch"][1]}


def test_scenarios_run_equals_jax(logging_restored, monkeypatch):
    """A scenario with worker hosts, the port's on ``--device cpu`` (8 CPU
    chips each, the JAX layout), through both CLIs with one seed.

    Both packages' flight event types follow the host's speed in this
    time-compressed scenario: a request still in flight when the
    controller is killed fails over (``request.failover``), and a measured
    service time about 4x the replica's 8 ms projects a wait that predicts
    a scale-up (``scale.predict``) after the restart, in either package.
    So the run gets a fixed budget, ``BIOENGINE_SCENARIO_SCALE=4.0``
    (every time constant 4x, the request plan unchanged: a tick is 80 ms,
    ten times the service time), and runs before the module's live workers
    start, so no thread of theirs shares the process with its hosts."""
    monkeypatch.setenv("BIOENGINE_SCENARIO_SCALE", "4.0")
    args = ["scenarios", "run", "controller_crash", "--seed", "7"]
    rc_jax, jax_out = _local(jax_cli.main, *args)
    rc, out = _local(torch_cli.main, *args, "--device", "cpu")
    assert rc == rc_jax == 0 and out["result"]["passed"]
    differ = _diff(_untimed(out), _untimed(jax_out))
    assert not differ, "\n".join(differ)


def test_fuzz_replay_equals_jax(logging_restored):
    path = str(REPO / "tests" / "fuzz_corpus" / "host_blip_drain_starvation.json")
    rc_jax, jax_out = _local(jax_cli.main, "fuzz", "--replay", path)
    rc, out = _local(torch_cli.main, "fuzz", "--replay", path, "--device", "cpu", "--n-devices", "8")
    assert rc == rc_jax == 0 and out == jax_out
    assert out["replays"][0]["matches_expect"] and out["replays"][0]["deterministic"] is True


def test_host_scenario_on_one_card_fails_with_a_placement_error(monkeypatch, logging_restored):
    """On a stood-in one-card ``torch.cuda`` a scenario whose replicas lease
    2 chips fails before it runs, naming the chip it lacks and ``--device
    cpu``; nothing is shrunk and nothing drops to the CPU. A host-less
    scenario runs on the default device, which it never touches."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i=0: (70 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    runner = CliRunner()
    path = str(REPO / "tests" / "fuzz_corpus" / "drill_lease_leak.json")
    for args in (["scenarios", "run", "slow_replica"], ["fuzz", "--replay", path]):
        result = runner.invoke(torch_cli.main, args)
        assert result.exit_code == 1, result.output
        assert "places replicas of 2 chips" in result.stderr and "holds 1 (1 chip(s) short)" in result.stderr
        assert "--device cpu" in result.stderr
    result = runner.invoke(torch_cli.main, ["scenarios", "run", "slow_replica", "--device", "cpu",
                                            "--n-devices", "1"])
    assert result.exit_code == 1 and "run it with --n-devices 2" in result.stderr
    rc, out = _local(torch_cli.main, "scenarios", "run", "hot_signature", "--seed", "5")
    assert rc == 0 and out["result"]["passed"]


# ---- pure helpers -----------------------------------------------------------


@pytest.mark.parametrize("pkg", list(PACKAGES.values()), ids=lambda p: p.name)
def test_helpers(pkg, tmp_path):
    import click

    u = pkg.utils
    assert [u.coerce_value(v) for v in ("3", "3.5", "true", '{"a": 1}', "[1,2]", "plain text")] == [
        3, 3.5, True, {"a": 1}, [1, 2], "plain text"]
    assert u.parse_kv_args(("x=1", "name=bob", 'cfg={"k": 2}')) == {"x": 1, "name": "bob", "cfg": {"k": 2}}
    with pytest.raises(click.UsageError):
        u.parse_kv_args(("novalue",))
    assert u.parse_env_args(("FLAG=true",)) == {"FLAG": "true"}
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    for suffix in (".npy", ".npz"):
        u.write_image(tmp_path / f"a{suffix}", arr)
        np.testing.assert_array_equal(u.read_image(tmp_path / f"a{suffix}"), arr)
    (tmp_path / "app" / ".git" / "objects").mkdir(parents=True)
    (tmp_path / "app" / "manifest.yaml").write_text("x: 1")
    (tmp_path / "app" / ".git" / "objects" / "blob").write_bytes(b"secret")
    (tmp_path / "app" / ".env").write_text("TOKEN=x")
    assert set(u.read_dir_files(tmp_path / "app")) == {"manifest.yaml"}


def test_helpers_agree(tmp_path, monkeypatch):
    """The token chain and the JSON-option parser of both CLIs."""
    import click

    monkeypatch.delenv("BIOENGINE_TOKEN", raising=False)
    monkeypatch.setenv("BIOENGINE_WORKSPACE", str(tmp_path))
    (tmp_path / "admin_token").write_text("from-file\n")
    for pkg in PACKAGES.values():
        u = pkg.utils
        assert u.resolve_token("flag") == "flag" and u.resolve_token(None) == "from-file"
        assert u.parse_json_opt('{"a": 1}', "--x") == {"a": 1}
        for bad in ("{bad", "[1]"):
            with pytest.raises(click.UsageError):
                u.parse_json_opt(bad, "--x")


def test_usage_errors(workers, monkeypatch):
    monkeypatch.delenv("BIOENGINE_SERVER_URL", raising=False)
    runner = CliRunner()
    for holder in workers.values():
        main = holder["pkg"].main
        result = runner.invoke(main, ["call", "any", "m", "--args", "{bad", "--server-url", holder["url"]])
        assert result.exit_code == 2 and "not valid JSON" in result.stderr
        result = runner.invoke(main, ["status"])
        assert result.exit_code != 0 and "server" in (result.stderr + str(result)).lower()


def test_command_tree():
    """The port's CLI has every command of the JAX CLI's, with the same
    options; ``scenarios run`` and ``fuzz`` also take ``--device`` and
    ``--n-devices`` (where the in-process worker hosts run)."""
    def tree(group):
        out = {}
        for name, cmd in group.commands.items():
            opts = sorted(o for p in cmd.params for o in getattr(p, "opts", []))
            out[name] = tree(cmd) if hasattr(cmd, "commands") else opts
        return out

    jax_tree = tree(jax_cli.main)
    for opts in (jax_tree["scenarios"]["run"], jax_tree["fuzz"]):
        opts[:] = sorted(opts + ["--device", "--n-devices"])
    assert tree(torch_cli.main) == jax_tree
    device = {p.name: p.default for p in torch_cli.main.commands["fuzz"].params}
    assert (device["device"], device["n_devices"]) == ("cuda", None)


# ---- commands against the live workers ----------------------------------------


def test_status(workers):
    outs = _both(workers, "status")
    assert all(o["worker"]["ready"] is True for o in outs.values())
    for o in outs.values():  # the platform's own descriptions
        o["worker"].pop("description", None)
        o["service"] = None
    _same(outs)


def test_cluster_status(workers):
    outs = _both(workers, "cluster", "status")
    assert [o["topology"]["n_chips"] for o in outs.values()] == [N_CHIPS, N_CHIPS]
    _same(outs)


def test_cluster_traces(workers):
    outs = _both(workers, "cluster", "traces", "--name", "deploy_app")
    for spans in outs.values():
        assert spans and spans[-1]["name"] == "deploy_app" and spans[-1]["duration_s"] >= 0
    _same(outs)


def test_cluster_profile_memory(workers):
    outs = _both(workers, "cluster", "profile", "--memory")
    assert outs["jax"]["devices"] and outs["jax"]["pprof_bytes"] > 0
    # no CUDA device here: the allocator snapshot is empty
    assert outs["torch"] == {"devices": [], "allocator_snapshot_bytes": 0}


def test_call_list_methods_and_args(workers):
    ids = _app_ids(workers)
    outs = {n: _cli(h, "call", ids[n], "--list-methods") for n, h in workers.items()}
    assert all("echo" in o["methods"] for o in outs.values())
    _same(outs)
    outs = {n: _cli(h, "call", ids[n], "echo", "--arg", "message=hello") for n, h in workers.items()}
    assert all(o["echo"] == "hello" for o in outs.values())
    _same(outs)
    outs = {n: _cli(h, "call", ids[n], "echo", "--args", '{"message": "via-json"}') for n, h in workers.items()}
    assert all(o["echo"] == "via-json" for o in outs.values())
    _same(outs)


def test_call_image_arg_and_output(workers, tmp_path):
    image = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    np.save(tmp_path / "in.npy", image)
    outs = {}
    for name, holder in workers.items():
        out = tmp_path / f"out-{name}.npy"
        outs[name] = _cli(holder, "call", "array-app", "scale", "--image-arg", f"image={tmp_path / 'in.npy'}",
                          "--arg", "factor=3", "--output", str(out))
        np.testing.assert_array_equal(np.load(out), image * 3)
    assert outs["torch"]["shape"] == [5, 7]
    _same(outs)


def test_apps_upload_list_run_status_logs_stop(workers):
    seen = {}
    for name, holder in workers.items():
        demo = str(holder["pkg"].demo)
        steps = {"upload": _cli(holder, "apps", "upload", demo)}
        assert steps["upload"]["artifact_id"] == "demo-app"
        steps["list"] = _cli(holder, "apps", "list")
        assert any(a["artifact_id"] == "demo-app" for a in steps["list"])
        steps["run"] = _cli(holder, "apps", "run", "--artifact-id", "demo-app",
                            "--deployment-kwargs", '{"demo_deployment": {"greeting": "CLI"}}')
        app_id = steps["run"]["app_id"]
        steps["status"] = _cli(holder, "apps", "status", app_id)
        assert steps["status"]["status"] in ("RUNNING", "DEPLOYING")
        steps["echo"] = _cli(holder, "call", app_id, "echo", "--arg", "message=x")
        assert steps["echo"]["greeting"] == "CLI"
        steps["logs"] = _cli(holder, "apps", "logs", app_id)
        steps["stop"] = _cli(holder, "apps", "stop", app_id)
        assert steps["stop"]["status"] == "STOPPED"
        # the replicas' log lines name their own package's loggers and timings
        steps["logs"] = {k: len(v) > 0 for k, v in steps["logs"].items()}
        steps["status"].pop("replica_logs", None)
        seen[name] = steps
    _same(seen)


def test_apps_upload_sends_file_contents_and_run_with_raw_env(workers, tmp_path):
    import shutil

    seen = {}
    for name, holder in workers.items():
        src = tmp_path / name / "client-only-app"
        shutil.copytree(holder["pkg"].demo, src)
        manifest = (src / "manifest.yaml").read_text().replace("demo-app", "client-app")
        (src / "manifest.yaml").write_text(manifest)
        up = _cli(holder, "apps", "upload", str(src))
        assert up["artifact_id"] == "client-app"
        assert "client-app" in holder["worker"].apps_manager.store.list_artifacts()
        ran = _cli(holder, "apps", "run", "--local-path", str(holder["pkg"].demo), "--env", "FLAG=true")
        env = _cli(holder, "call", ran["app_id"], "get_env", "--arg", "key=FLAG")
        assert env["value"] == "true"
        stopped = _cli(holder, "apps", "stop", ran["app_id"])
        seen[name] = {"upload": up, "run": ran, "env": env, "stop": stopped}
    _same(seen)


def test_apps_deploy(workers):
    seen = {}
    for name, holder in workers.items():
        deployed = _cli(holder, "apps", "deploy", str(holder["pkg"].demo))
        assert deployed["artifact_id"] == "demo-app" and "echo" in deployed["methods"]
        seen[name] = {"deploy": deployed, "stop": _cli(holder, "apps", "stop", deployed["app_id"])}
    _same(seen)


def test_slo_status_and_top(workers):
    outs = _both(workers, "slo", "status")
    assert all("deployments" in o and "auto_bundles" in o for o in outs.values())
    _same(outs)
    outs = _both(workers, "top")
    for o in outs.values():
        assert "telemetry" in o and "slo" in o and "store" in o["telemetry"]
        # series are sampled on each worker's own clock
        o["telemetry"]["deployments"] = sorted(o["telemetry"].get("deployments", {}))
        o["telemetry"]["store"] = sorted(o["telemetry"]["store"])
    _same(outs)


def test_debug_flight_and_bundle(workers, tmp_path):
    outs = _both(workers, "debug", "flight", "--limit", "20")
    for o in outs.values():
        assert isinstance(o["events"], list)
        # the ring holds what each process did, in its own timing
        o["events"] = sorted({e["type"] for e in o["events"]})
    assert set(outs["torch"]) == set(outs["jax"])
    outs = {n: _cli(h, "debug", "bundle", "-o", str(tmp_path / f"bundle-{n}.json")) for n, h in workers.items()}
    for name, o in outs.items():
        assert Path(o["written"]).is_file() and o["hosts_reachable"] == o["hosts_total"] == 0
        bundle = json.loads(Path(o["written"]).read_text())
        assert {"events", "traces", "hosts"} <= set(bundle)
        o.pop("events"), o.pop("traces"), o.pop("dumps")  # counts of each process's own rings
    _same(outs)


def test_debug_journal_offline(tmp_path):
    """``debug journal`` reads a directory written by each package's own
    ``ControlJournal``: the same records give the same report."""
    outs = {}
    for name, pkg in PACKAGES.items():
        directory = tmp_path / name
        journal = pkg.journal.ControlJournal(directory)
        journal.load()
        journal.mint_epoch()
        journal.set_snapshot_state(
            {"app-0": {"specs": [{"name": "main", "num_replicas": 2}], "acl": ["*"]}}, ["admin"])
        journal.write_snapshot()
        for seq in range(3):
            journal.append("deploy", {"app_id": f"app-{seq}", "token": "secret"})
        result = CliRunner().invoke(pkg.main, ["debug", "journal", "--dir", str(directory), "--tail", "5"],
                                    catch_exceptions=False)
        assert result.exit_code == 0, result.output
        outs[name] = json.loads(result.stdout)
        assert outs[name]["journal_records"] >= 3
    _same(outs)


def test_models_list():
    outs = {}
    for name, pkg in PACKAGES.items():
        result = CliRunner().invoke(pkg.main, ["models", "list"])
        assert result.exit_code == 0, result.output
        outs[name] = json.loads(result.stdout)
    assert "cpsam" in outs["jax"] and outs["torch"] == outs["jax"]


def _convert(pkg, ckpt: Path, out: Path, arch: str, *extra) -> dict:
    result = CliRunner().invoke(pkg.main, ["models", "convert", str(ckpt), str(out), "--arch", arch, *extra])
    assert result.exit_code == 0, result.output
    return json.loads(result.stdout.strip().splitlines()[-1])


def _npz_equal(a: Path, b: Path) -> list:
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
        return sorted(x.files)


@pytest.mark.parametrize("arch", ["dinov2", "cpsam"])
def test_models_convert(arch, tmp_path):
    if arch == "cpsam":
        sd = {k: torch.from_numpy(v) for k, v in jax_convert.synthetic_cpsam_state_dict(depth=2).items()}
    else:
        sd = chip_smoke.dinov2_hub_state_dict(0, depth=2, n_tokens=5, dim=32)
    ckpt = tmp_path / f"{arch}.pth"
    torch.save(sd, ckpt)
    infos = {name: _convert(pkg, ckpt, tmp_path / f"{name}.npz", arch) for name, pkg in PACKAGES.items()}
    members = _npz_equal(tmp_path / "jax.npz", tmp_path / "torch.npz")
    assert members and infos["torch"]["n_params"] == infos["jax"]["n_params"] > 0
    assert infos["torch"]["top_level"] == infos["jax"]["top_level"]


@pytest.mark.parametrize("mode", ["slurm", "gke"])
def test_cluster_modes_build_their_provisioner(mode, tmp_path):
    """``TpuCluster(mode="slurm"|"gke")`` builds its provisioner, whose
    launch script equals the JAX one after the prefix rename and execs the
    port's worker host."""
    config = {"gke": {"project": "proj", "zone": "us-central1-a"}}.get(mode, {})
    scripts = {}
    for name, pkg in PACKAGES.items():
        cluster = pkg.cluster.TpuCluster(mode=mode, workspace_dir=tmp_path / name, log_file="off",
                                         provisioner_config=config)
        prov = cluster.provisioner
        assert type(prov).__name__ == {"slurm": "SlurmProvisioner", "gke": "GkeProvisioner"}[mode]
        prov.set_join_info("ws://head:9527/ws", "tok")
        scripts[name] = (prov.build_sbatch_script({"cpus": 4, "memory_gb": 16}, "w1") if mode == "slurm"
                         else prov.build_startup_script("w1"))
    assert scripts["torch"] == scripts["jax"].replace("bioengine_tpu.", "bioengine_tpu_torch.")
    assert "exec python -m bioengine_tpu_torch.worker_host --worker-tag w1" in scripts["torch"]
