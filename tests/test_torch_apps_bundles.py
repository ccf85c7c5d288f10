"""Slice 10 on the CPU: every app bundle of the JAX repo served by the port's
worker, beside the JAX worker serving the JAX app.

Each scenario is one ``async`` function of a package namespace that starts
that package's ``BioEngineWorker`` (the port's with ``device="cpu"``),
deploys the app over a ``connect_to_server`` WebSocket client, drives it
and returns what it observed; the test runs it on both packages and holds
the observations equal (the ``test_same_outcomes`` pattern of
``tests/test_torch_worker.py``). Values that differ by platform or by
design are masked where they are read, with the reason beside them.

- cellpose-finetuning: the ten schema methods and their schemas; a
  ``FAST_CFG`` session (``tests/test_bundled_apps.py``) trained through the
  HTTP bridge as the browser frontend drives it, its statuses, ``infer``
  over the WebSocket equal to the deployed instance's in-process ``infer``
  bit for bit, the export read by the port's ``runtime/rdf.py``;
  ``stop_training``, ``restart_training`` and ``delete_session``.
- generate: unary over the WebSocket, the bridge and MCP equal to
  ``tests/fixtures_golden_decoder.npz``; the deployment handle's stream
  equal to unary and resumed (as ``tests/test_streaming.py`` does); the
  built specs' ``slo``; ``describe_engine``'s keys.
- fibsem-mito-analysis against the model-runner bundle with the tiny-unet
  package of ``tests/test_fibsem_app.py`` (features [8, 16], one f32
  ``jax_params`` npz for both); the app's model-runner calls go over the
  worker's wire with a worker-issued ``BIOENGINE_TOKEN``.
- composition-demo: ``fan_out``. gpu-test against the JAX ``tpu-test``.
- ``HttpCollectionSource`` and http(s) inputs against ``chip_smoke``'s
  loopback collection server (the real hub is never contacted).

Temporary workspaces and ``HOME``; geolocation and the JAX compile cache
off; waits are bounded polls.
"""

import asyncio
import dataclasses
import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace

import aiohttp
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from _torch_parity import few_torch_threads, private_rpc_store, seeded_flax_params  # noqa: F401
from bioengine_tpu.apps.builder import AppBuilder as JaxAppBuilder
from bioengine_tpu.datasets import datasets as jax_datasets_mod
from bioengine_tpu.datasets import proxy_server as jax_proxy
from bioengine_tpu.models.unet import UNet2D as JaxUNet2D
from bioengine_tpu.rpc.client import connect_to_server as jax_connect
from bioengine_tpu.runtime.convert import save_params_npz
from bioengine_tpu.serving import RequestOptions as JaxRequestOptions
from bioengine_tpu.worker.worker import BioEngineWorker as JaxWorker
from bioengine_tpu_torch.apps.builder import AppBuilder
from bioengine_tpu_torch.apps.cellpose_finetuning.service import CellposeFinetune
from bioengine_tpu_torch.apps.model_runner.entry import (
    EntryDeployment,
    HttpCollectionSource,
    LocalCollectionSource,
)
from bioengine_tpu_torch.datasets import datasets as torch_datasets_mod
from bioengine_tpu_torch.datasets import proxy_server as torch_proxy
from bioengine_tpu_torch.rpc import connect_to_server
from bioengine_tpu_torch.rpc.schema import is_schema_method
from bioengine_tpu_torch.runtime.rdf import load_model_rdf
from bioengine_tpu_torch.serving import RequestOptions
from bioengine_tpu_torch.worker import BioEngineWorker

pytestmark = [pytest.mark.end_to_end, pytest.mark.anyio]

REPO = Path(__file__).resolve().parent.parent
BUNDLES = REPO / "bioengine_tpu_torch" / "apps" / "bundles"
JAX_APPS = REPO / "apps"
FIXTURE = Path(__file__).parent / "fixtures_golden_decoder.npz"
GOLDEN_PROMPT = "the cell divides"
# tests/test_bundled_apps.py's FAST_CFG
FAST_CFG = {"features": [8, 16], "epochs": 2, "batch_size": 4, "tile": 32, "learning_rate": 1e-3}
FINETUNE_METHODS = [
    "get_default_config", "start_training", "stop_training", "restart_training",
    "get_training_status", "list_sessions", "delete_session", "infer", "infer_3d", "export_model",
]
PROPERTY_TOL = 1e-5

PACKAGES = {
    "jax": SimpleNamespace(
        name="jax", Worker=JaxWorker, worker_kwargs={}, connect=jax_connect, device={},
        RequestOptions=JaxRequestOptions,
        app=lambda name: JAX_APPS / {"gpu-test": "tpu-test"}.get(name, name),
    ),
    "torch": SimpleNamespace(
        name="torch", Worker=BioEngineWorker, worker_kwargs={"device": "cpu"},
        connect=connect_to_server, device={"device": "cpu"}, app=lambda name: BUNDLES / name,
        RequestOptions=RequestOptions,
    ),
}


@pytest.fixture(autouse=True)
def hermetic(tmp_path, monkeypatch):
    """Temporary HOME, no geolocation, no JAX compile cache, the datasets
    discovery file of both packages under ``tmp_path``, a shared-memory
    segment of the test's own, and no model collection or app token left
    in the environment (the builder applies an app's ``env_vars`` to
    ``os.environ``; setting them here makes the teardown remove them)."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("BIOENGINE_DISABLE_GEOLOCATION", "1")
    monkeypatch.setenv("BIOENGINE_COMPILE_CACHE", "off")
    monkeypatch.setenv("BIOENGINE_TOKEN", "")
    monkeypatch.delenv("BIOENGINE_TPU_DATA_SERVER", raising=False)
    monkeypatch.delenv("BIOENGINE_LOCAL_MODEL_PATH", raising=False)
    for module in (jax_proxy, jax_datasets_mod, torch_proxy, torch_datasets_mod):
        monkeypatch.setattr(module, "DISCOVERY_FILE", tmp_path / module.__name__ / "current_server")
    with private_rpc_store():
        yield


class _Served:
    """A package's worker in ``root`` and an admin WebSocket client of it:
    ``(worker, conn, svc)``, where ``svc`` is the worker's own service."""

    def __init__(self, pkg, root: Path):
        self.pkg, self.root = pkg, root

    async def __aenter__(self):
        self.worker = self.pkg.Worker(workspace_dir=self.root / "ws", log_file="off",
                                      admin_users=["admin"], **self.pkg.worker_kwargs)
        await self.worker.start()
        self.conn = await self.pkg.connect({"server_url": self.worker.server.url,
                                            "token": self.worker.server.issue_token("admin")})
        return self.worker, self.conn, await self.conn.get_service("bioengine-worker")

    async def __aexit__(self, *exc):
        await self.conn.disconnect()
        await self.worker.stop()


def _error(exc: BaseException) -> str:
    """A remote error's last line, its type named."""
    return str(exc).strip().splitlines()[-1]


async def _poll(call, done, timeout=120.0):
    deadline = time.monotonic() + timeout
    while True:
        out = await call()
        if done(out):
            return out
        assert time.monotonic() < deadline, out
        await asyncio.sleep(0.05)


def _instance(worker, app_id: str, deployment: str):
    (replica,) = worker.controller.apps[app_id].replicas[deployment]
    return replica.instance


async def _bridge(http, worker, app_id: str, method: str, token: str = None, **kwargs):
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    async with http.post(f"{worker.server.http_url}/call/{app_id}/{method}",
                         json={"kwargs": kwargs}, headers=headers) as r:
        body = await r.json()
        assert r.status == 200, body
        return body["result"]


# ---- cellpose-finetuning --------------------------------------------------------


def _synthetic_cells(n=2, size=64, seed=0):
    """tests/test_bundled_apps.py's gaussian-blob cells and instance masks."""
    rng = np.random.default_rng(seed)
    images, masks = [], []
    yy, xx = np.mgrid[:size, :size]
    for _ in range(n):
        img = rng.normal(0.1, 0.02, (size, size)).astype(np.float32)
        mask = np.zeros((size, size), np.int32)
        for lbl, (cy, cx) in enumerate([(16, 16), (16, 48), (48, 16), (48, 48)], start=1):
            disk = (yy - cy) ** 2 + (xx - cx) ** 2 < 8**2
            img[disk] += 1.0
            mask[disk] = lbl
        images.append(img)
        masks.append(mask)
    return images, masks


def _load_jax_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("method", FINETUNE_METHODS)
def test_finetuning_schema_equals_the_jax_apps(method):
    jax_cls = _load_jax_module(JAX_APPS / "cellpose-finetuning" / "main.py", "jax_cellpose_main").CellposeFinetune
    jax_methods = sorted(n for n in dir(jax_cls) if getattr(getattr(jax_cls, n), "__is_schema_method__", False))
    ours = sorted(n for n in dir(CellposeFinetune) if is_schema_method(getattr(CellposeFinetune, n)))
    assert ours == jax_methods == sorted(FINETUNE_METHODS)
    assert getattr(CellposeFinetune, method).__schema__ == getattr(jax_cls, method).__schema__


async def cellpose_outcomes(pkg, root: Path) -> dict:
    images, masks = _synthetic_cells()
    seen = {}
    async with _Served(pkg, root) as (worker, conn, svc):
        deployed = await svc.deploy_app(
            local_path=str(pkg.app("cellpose-finetuning")), app_id="cellpose-finetuning",
            deployment_kwargs={"main": {"sessions_root": str(root / "sessions"), **pkg.device}})
        seen["deployed"] = {k: deployed[k] for k in ("app_id", "service_id", "methods", "frontend_url")}
        app = await conn.get_service("cellpose-finetuning")
        user = worker.server.issue_token("browser")
        async with aiohttp.ClientSession() as http:
            # the frontend, and a session driven through the bridge as it drives one
            async with http.get(f"{worker.server.http_url}/apps/cellpose-finetuning/") as r:
                page = await r.text()
                seen["page"] = (r.status, "Cellpose Fine-Tuning" in page, 'data-tab="annotate"' in page)
            async with http.get(f"{worker.server.http_url}/apps/cellpose-finetuning/..%2f..%2fmanifest.yaml") as r:
                seen["page_escape"] = r.status in (403, 404)
            call = lambda method, **kw: _bridge(http, worker, "cellpose-finetuning", method, user, **kw)  # noqa: E731
            seen["default_config"] = await call("get_default_config")
            seen["started"] = await call("start_training", train_images=[i.tolist() for i in images],
                                         train_labels=[m.tolist() for m in masks], config=FAST_CFG,
                                         session_id="frontend-run")
            final = await _poll(lambda: call("get_training_status", session_id="frontend-run"),
                                lambda s: s["status"] in ("completed", "failed"))
            assert final["status"] == "completed", final.get("error")
            # the JAX app's data-parallel mesh spans 4 chips, the port's one device
            seen["final"] = {"keys": sorted(final), "status": final["status"],
                             "current_epoch": final["current_epoch"], "total_epochs": final["total_epochs"],
                             "steps_per_epoch": final["steps_per_epoch"], "n_losses": len(final["losses"])}
            sessions = await call("list_sessions")
            seen["sessions"] = [(s["session_id"], s["status"], s["snapshots"]) for s in sessions]
            bridged = await call("infer", session_id="frontend-run", images=[i.tolist() for i in images[:1]])
            seen["bridged_infer"] = (type(bridged["masks"][0]).__name__, len(bridged["masks"][0]),
                                     bridged["snapshot"])
        # infer over the WebSocket against the deployed instance in process
        wired = await app.infer(session_id="frontend-run", images=images)
        local = await _instance(worker, "cellpose-finetuning", "main").infer(
            session_id="frontend-run", images=images)
        assert all(np.array_equal(a, b) for a, b in zip(wired["masks"], local["masks"]))
        assert wired["n_cells"] == local["n_cells"] and wired["snapshot"] == local["snapshot"]
        assert np.array_equal(np.asarray(bridged["masks"][0]), wired["masks"][0])
        seen["infer"] = ([m.shape for m in wired["masks"]], [m.dtype.kind for m in wired["masks"]],
                         wired["snapshot"])
        exported = await app.export_model(session_id="frontend-run")
        rdf = load_model_rdf(Path(exported["model_path"]) / "rdf.yaml")
        seen["export"] = (exported["name"], exported["weights_format"], sorted(rdf.weights),
                          rdf.weights["jax_params"]["architecture"], rdf.inputs[0].axes)

        # stop, restart and delete (tests/test_bundled_apps.py's cases)
        await app.start_training(train_images=images, train_labels=masks,
                                 config={**FAST_CFG, "epochs": 50}, session_id="session-stop")
        await _poll(lambda: app.get_training_status(session_id="session-stop"),
                    lambda s: s.get("current_epoch", 0) >= 1)
        stopped = await app.stop_training(session_id="session-stop")
        seen["stopped"] = stopped["status"] in ("stopped", "completed")
        seen["restarted"] = await app.restart_training(session_id="session-stop")
        again = await _poll(lambda: app.get_training_status(session_id="session-stop"),
                            lambda s: s["status"] in ("training", "completed", "stopped", "failed"))
        seen["after_restart"] = again["status"] != "failed"
        await app.stop_training(session_id="session-stop")
        seen["deleted"] = [await app.delete_session(session_id=s) for s in ("session-stop", "frontend-run")]
        seen["dirs_left"] = sorted(p.name for p in (root / "sessions").iterdir() if p.name != "exports")
        with pytest.raises(Exception) as exc:
            await app.get_training_status(session_id="nope")
        seen["unknown"] = _error(exc.value)
        await svc.stop_app(app_id="cellpose-finetuning")
        seen["chips_free"] = worker.cluster.state.free_chips() == worker.cluster.state.topology.n_chips
    return seen


async def test_cellpose_finetuning_same_outcomes(tmp_path):
    ours = await cellpose_outcomes(PACKAGES["torch"], tmp_path / "torch")
    assert ours["final"]["status"] == "completed" and ours["final"]["n_losses"] == FAST_CFG["epochs"]
    assert ours["deployed"]["frontend_url"] == "/apps/cellpose-finetuning/"
    assert ours["page"] == (200, True, True) and ours["page_escape"]
    assert ours["deleted"] == [{"deleted": "session-stop"}, {"deleted": "frontend-run"}]
    assert ours == await cellpose_outcomes(PACKAGES["jax"], tmp_path / "jax")


@pytest.mark.parametrize("lease, card", [(None, 0), ([1], 1), ([2], None)])
async def test_the_finetuning_app_runs_on_its_leased_card(lease, card, tmp_path, monkeypatch):
    """A replica that leased card 1 of two trains and infers there; no
    lease keeps the constructor's device; a lease naming no card is
    refused; without CUDA the lease cannot resolve. Two cards are stood
    in for: nothing touches them before a session starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    app = CellposeFinetune(sessions_root=str(tmp_path / "sessions"), device="cuda")
    if lease is not None:
        app.bioengine_device_ids = lease
    if card is None:
        with pytest.raises(ValueError, match="refusing to remap"):
            await app.async_init()
        return
    await app.async_init()
    assert app.device == torch.device("cuda", card)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        await app.async_init()


# ---- generate ------------------------------------------------------------------------


def test_generate_bundle_keeps_the_slo_block(tmp_path):
    built = {
        name: builder(workdir_root=tmp_path / name, admin_users=["admin"], log_file="off").build(
            app_id="generate", local_path=str(path))
        for name, builder, path in (("jax", JaxAppBuilder, JAX_APPS / "generate"),
                                    ("torch", AppBuilder, BUNDLES / "generate"))
    }
    (jax_spec,), (spec,) = built["jax"].specs, built["torch"].specs
    assert spec.slo is not None and dataclasses.asdict(spec.slo) == dataclasses.asdict(jax_spec.slo)
    assert (spec.slo.inter_token_objective_s, spec.slo.latency_percentile, spec.slo.window_s) == (
        0.25, 95.0, 3600.0)
    assert sorted(built["torch"].schema_methods) == sorted(built["jax"].schema_methods) == [
        "describe_engine", "generate"]
    for field in ("chips_per_replica", "num_replicas", "max_replicas", "max_ongoing_requests"):
        assert getattr(spec, field) == getattr(jax_spec, field), field


async def generate_outcomes(pkg, root: Path) -> dict:
    golden = np.load(FIXTURE)["greedy_tokens"].tolist()[:16]
    seen = {}
    async with _Served(pkg, root) as (worker, conn, svc):
        deployed = await svc.deploy_app(local_path=str(pkg.app("generate")), app_id="generate",
                                        deployment_kwargs={"generate_deployment": dict(pkg.device)})
        seen["methods"] = deployed["methods"]
        app = await conn.get_service("generate")
        unary = await app.generate(prompt=GOLDEN_PROMPT, max_new_tokens=16)
        seen["unary"] = unary["tokens"] == golden
        user = worker.server.issue_token("someone")
        async with aiohttp.ClientSession() as http:
            bridged = await _bridge(http, worker, "generate", "generate", user,
                                    prompt=GOLDEN_PROMPT, max_new_tokens=16)
            async with http.post(f"{worker.server.http_url}/mcp/generate", json={
                    "jsonrpc": "2.0", "id": 1, "method": "tools/call",
                    "params": {"name": "generate",
                               "arguments": {"prompt": GOLDEN_PROMPT, "max_new_tokens": 16}}},
                    headers={"Authorization": f"Bearer {user}"}) as r:
                out = (await r.json())["result"]
                assert out["isError"] is False, out
                mcp = json.loads(out["content"][0]["text"])
        seen["bridge_mcp"] = bridged["tokens"] == mcp["tokens"] == unary["tokens"]
        # the stream through the handle of the deployed app
        handle = worker.controller.get_handle("generate")
        opts = pkg.RequestOptions(idempotent=True, deadline_s=120)
        streamed = [i["token"] async for i in handle.call_stream(
            "generate_stream", prompt=GOLDEN_PROMPT, max_new_tokens=16, options=opts)]
        resumed = [i async for i in handle.call_stream(
            "generate_stream", prompt=GOLDEN_PROMPT, max_new_tokens=16, resume_from=11, options=opts)]
        seen["stream"] = streamed == unary["tokens"]
        seen["resumed"] = [i["token"] for i in resumed] == golden[11:] and resumed[0]["index"] == 11
        described = await app.describe_engine()
        seen["describe_keys"] = sorted(described)
        seen["loop_keys"] = sorted(described["loop"])
        seen["engine_keys"] = set(described["engine"])
        seen["kv_drained"] = described["engine"]["kv"]["sequences"] == 0
        seen["n_devices"] = described["engine"]["n_devices"]
        await svc.stop_app(app_id="generate")
    return seen


async def test_generate_same_outcomes(tmp_path):
    ours = await generate_outcomes(PACKAGES["torch"], tmp_path / "torch")
    assert ours["unary"] and ours["bridge_mcp"] and ours["stream"] and ours["resumed"]
    ref = await generate_outcomes(PACKAGES["jax"], tmp_path / "jax")
    # the port's engine describes three more fields (ROADMAP, slice 7)
    assert ours.pop("engine_keys") - ref.pop("engine_keys") == {"device", "precision", "programs"}
    assert ours == ref


# ---- fibsem-mito-analysis over the model-runner --------------------------------------


def _synthetic_em(size=256, n_mito=6, seed=0):
    """tests/test_fibsem_app.py's EM-like image: dark elliptical blobs."""
    rng = np.random.default_rng(seed)
    img = rng.normal(170, 12, (size, size)).astype(np.float32)
    yy, xx = np.mgrid[:size, :size]
    for _ in range(n_mito):
        cy, cx = rng.integers(40, size - 40, 2)
        ry, rx = rng.integers(10, 22, 2)
        blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        img[blob] = rng.normal(60, 8, blob.sum())
    return img


@pytest.fixture
def seg_collection(tmp_path):
    """tests/test_fibsem_app.py's tiny-unet package (UNet2D features
    (8, 16), one output channel, NHWC) in f32, one ``jax_params`` npz
    served by both packages."""
    root = tmp_path / "seg_collection"
    d = root / "tiny-unet"
    d.mkdir(parents=True)
    model = JaxUNet2D(features=(8, 16), out_channels=1, dtype="float32")
    x = np.random.default_rng(0).normal(size=(1, 64, 64, 1)).astype(np.float32)
    params = seeded_flax_params(model, x.shape, seed=0)
    # a head bias that puts 40% of a normalised EM field's outputs above
    # the app's 0.5 threshold, so the analyses find instances to compare
    em = _synthetic_em(size=200)
    lo, hi = np.percentile(em, [1, 99])
    field = np.clip((em - lo) / (hi - lo + 1e-6), 0, 1)[None, ..., None]
    params["Conv_0"]["bias"] = np.zeros_like(params["Conv_0"]["bias"])
    raw = np.asarray(model.apply({"params": params}, jnp.asarray(field)))
    params["Conv_0"]["bias"] += np.float32(0.5 - np.quantile(raw, 0.6))
    save_params_npz(str(d / "weights.npz"), params)
    np.save(d / "test_input.npy", x)
    np.save(d / "test_output.npy", np.asarray(model.apply({"params": params}, jnp.asarray(x))))
    (d / "rdf.yaml").write_text(yaml.safe_dump({
        "type": "model", "name": "Tiny UNet", "description": "tiny segmentation test model",
        "tags": ["segmentation"],
        "inputs": [{"name": "input0", "axes": "byxc"}],
        "outputs": [{"name": "output0", "axes": "byxc"}],
        "test_inputs": ["test_input.npy"], "test_outputs": ["test_output.npy"],
        "documentation": "README.md",
        "weights": {"jax_params": {"source": "weights.npz", "architecture": {
            "name": "unet2d", "kwargs": {"features": [8, 16], "out_channels": 1, "dtype": "float32"}}}},
    }))
    (d / "README.md").write_text("# Tiny UNet")
    np.save(root / "field.npy", x)
    return root


async def fibsem_outcomes(pkg, root: Path, collection: Path, monkeypatch) -> dict:
    monkeypatch.setenv("BIOENGINE_LOCAL_MODEL_PATH", str(collection))
    seen = {}
    async with _Served(pkg, root) as (worker, conn, svc):
        mr = await svc.deploy_app(
            local_path=str(pkg.app("model-runner")), app_id="model-runner",
            deployment_kwargs={"entry_deployment": {"cache_dir": str(root / "cache"), **pkg.device},
                               **({"runtime_deployment": pkg.device} if pkg.device else {})})
        # an app's token, issued by the worker, reaches it through env_vars
        token = worker.server.issue_token("fibsem-app")
        fib = await svc.deploy_app(
            local_path=str(pkg.app("fibsem-mito-analysis")), app_id="fibsem-mito-analysis",
            deployment_kwargs={"analysis_deployment": {
                "model_runner_service": mr["service_id"], "model_id": "tiny-unet",
                "server_url": worker.server.url, "batch_size": 4, "input_layout": "NHWC"}},
            env_vars={"BIOENGINE_TOKEN": token})
        seen["deployed"] = (mr["service_id"], fib["service_id"], fib["methods"], fib["frontend_url"])
        app = await conn.get_service("fibsem-mito-analysis")
        pong = await app.ping()
        seen["ping"] = {k: pong[k] for k in ("status", "model", "model_runner")}
        for name, kwargs in (("small", {"image": _synthetic_em(size=128), "tile_size": 512}),
                             ("tiled", {"image": _synthetic_em(size=200), "tile_size": 128, "overlap": 32})):
            out = await app.analyze(**kwargs)
            out.pop("processing_time_s")
            out["labels"] = np.asarray(out["labels"])
            seen[name] = out
        for name, kwargs in (("rejects_3d", {"image": np.zeros((4, 8, 8))}),
                             ("rejects_overlap", {"image": _synthetic_em(size=200), "tile_size": 128,
                                                  "overlap": 128})):
            with pytest.raises(Exception) as exc:
                await app.analyze(**kwargs)
            seen[name] = _error(exc.value)
        async with aiohttp.ClientSession() as http:
            async with http.get(f"{worker.server.http_url}/apps/fibsem-mito-analysis/") as r:
                seen["page"] = (r.status, "FIB-SEM" in await r.text())
        await svc.stop_app(app_id="fibsem-mito-analysis")
        await svc.stop_app(app_id="model-runner")
        seen["chips_free"] = worker.cluster.state.free_chips() == worker.cluster.state.topology.n_chips
    return seen


async def test_fibsem_same_outcomes(seg_collection, tmp_path, monkeypatch):
    ours = await fibsem_outcomes(PACKAGES["torch"], tmp_path / "torch", seg_collection, monkeypatch)
    assert ours["ping"]["status"] == "ok" and ours["ping"]["model"] == "tiny-unet"
    assert "2-D" in ours["rejects_3d"] and "overlap" in ours["rejects_overlap"]
    assert ours["small"]["labels"].shape == (128, 128) and ours["tiled"]["labels"].shape == (200, 200)
    for name in ("small", "tiled"):
        assert ours[name]["n_mitochondria"] == len(ours[name]["properties"]["label"]) > 0
    ref = await fibsem_outcomes(PACKAGES["jax"], tmp_path / "jax", seg_collection, monkeypatch)
    for name in ("small", "tiled"):
        got, want = ours.pop(name), ref.pop(name)
        assert got["labels"].dtype == want["labels"].dtype
        np.testing.assert_array_equal(got.pop("labels"), want.pop("labels"))
        got_props, want_props = got.pop("properties"), want.pop("properties")
        assert got_props.keys() == want_props.keys() and got_props["label"] == want_props["label"]
        for key in got_props:
            np.testing.assert_allclose(got_props[key], want_props[key], rtol=0, atol=PROPERTY_TOL)
        assert got == want
    assert ours == ref


# ---- composition-demo and gpu-test -----------------------------------------------------


async def composition_and_probe_outcomes(pkg, root: Path) -> dict:
    seen = {}
    async with _Served(pkg, root) as (worker, conn, svc):
        deployed = await svc.deploy_app(local_path=str(pkg.app("composition-demo")), app_id="composition-demo")
        seen["composition_methods"] = deployed["methods"]
        seen["fan_out"] = await (await conn.get_service("composition-demo")).fan_out(value=7)
        async with aiohttp.ClientSession() as http:
            async with http.get(f"{worker.server.http_url}/apps/composition-demo/") as r:
                seen["page"] = (r.status, "Composition" in await r.text())
            seen["bridged"] = await _bridge(http, worker, "composition-demo", "fan_out", value=3)
        await svc.stop_app(app_id="composition-demo")

        name = "gpu-test" if pkg.name == "torch" else "tpu-test"
        deployed = await svc.deploy_app(local_path=str(pkg.app("gpu-test")), app_id=name,
                                        deployment_kwargs={"gpu_test_deployment": pkg.device} if pkg.device else None)
        app = await conn.get_service(name)
        pong = await app.ping()
        info = await (app.gpu_info() if pkg.name == "torch" else app.tpu_info())
        memory = await app.memory_info()
        # the probe's method and env keys name the platform: tpu_info and the
        # JAX/TPU variables there, gpu_info and the CUDA variables here
        seen["probe_methods"] = sorted(m.replace("tpu_info", "gpu_info") for m in deployed["methods"])
        seen["ping"] = (pong["status"], sorted(pong))
        seen["info_keys"] = sorted(info)
        seen["info"] = (info["error"], info["backend"], info["matmul_norm"])
        seen["device_keys"] = [sorted(d) for d in info["devices"]][:1]
        seen["memory_keys"] = [sorted(d) for d in memory["devices"]][:1]
        seen["n_devices"] = (info["device_count"], len(info["devices"]), len(memory["devices"]))
        seen["env"] = info["env"]
        await svc.stop_app(app_id=name)
    return seen


async def test_composition_and_gpu_test_same_outcomes(tmp_path):
    ours = await composition_and_probe_outcomes(PACKAGES["torch"], tmp_path / "torch")
    ref = await composition_and_probe_outcomes(PACKAGES["jax"], tmp_path / "jax")
    assert ours["fan_out"] == {"a": 14, "b": 107, "sum": 121}
    assert ours["info"] == ref["info"] == ("", "cpu", 16384.0)
    # the port's CPU worker has one chip, the JAX one 8 virtual devices
    assert ours.pop("n_devices") == (1, 1, 1) and ref.pop("n_devices") == (8, 8, 8)
    assert ours.pop("ping") == ("ok", ["cuda_visible_devices", "status", "uptime"])
    assert ref.pop("ping") == ("ok", ["jax_platforms", "status", "uptime"])
    assert set(ours.pop("env")) == {"CUDA_VISIBLE_DEVICES", "BIOENGINE_LEASED_CHIPS"}
    assert "JAX_PLATFORMS" in ref.pop("env")
    assert ours == ref


def test_bundle_frontends_are_the_jax_apps():
    for app in ("cellpose-finetuning", "cell-image-search", "fibsem-mito-analysis", "composition-demo"):
        ours = (BUNDLES / app / "frontend" / "index.html").read_bytes()
        assert ours == (JAX_APPS / app / "frontend" / "index.html").read_bytes(), app


# ---- HttpCollectionSource and http(s) inputs ----------------------------------------------


def _jax_http_source(url: str):
    module = _load_jax_module(JAX_APPS / "model-runner" / "entry_deployment.py", "jax_mr_entry")
    return module.HttpCollectionSource(url)


async def _sources(collection: Path, **throttle):
    server = chip_smoke.LoopbackCollection(str(collection), throttle=throttle)
    url = await server.start()
    return server, HttpCollectionSource(url), _jax_http_source(url)


async def _close(ours, ref, server):
    await ours.close()
    await ref._client.aclose()  # the JAX source has no close
    await server.stop()


async def test_http_source_lists_models_and_caches_checks(seg_collection, monkeypatch):
    server, ours, ref = await _sources(seg_collection)
    try:
        local = LocalCollectionSource(seg_collection)
        models = await ours.list_models()
        assert models == await ref.list_models() == await local.list_models()
        assert models[0]["model_id"] == "tiny-unet" and models[0]["tags"] == ["segmentation"]
        read = chip_smoke.LoopbackCollection.MANAGER + "read"
        checks = await ours.inference_checks()
        assert checks == await ref.inference_checks() == {"tiny-unet": {"status": "passed"}}
        assert await ours.is_published("tiny-unet") and not await ours.is_published("nope")
        assert server.hits[read] == 2  # one each: the rest within the TTL came from the cache
        monkeypatch.setattr(HttpCollectionSource, "CHECKS_TTL_SECONDS", 0)
        await ours.inference_checks()
        assert server.hits[read] == 3
    finally:
        await _close(ours, ref, server)


async def test_http_source_lists_and_fetches_files(seg_collection):
    server, ours, ref = await _sources(seg_collection)
    try:
        local = LocalCollectionSource(seg_collection)
        files = await ours.fetch_file_list("tiny-unet", False)
        assert files == await ref.fetch_file_list("tiny-unet", False) == await local.fetch_file_list(
            "tiny-unet", False)
        for f in files:
            body = await ours.fetch_file("tiny-unet", f["name"], False)
            assert body == await local.fetch_file("tiny-unet", f["name"], False) == await ref.fetch_file(
                "tiny-unet", f["name"], False)
            assert len(body) == f["size"]
    finally:
        await _close(ours, ref, server)


async def test_http_source_retries_429_and_not_404(seg_collection):
    files = chip_smoke.LoopbackCollection.ARTIFACTS + "tiny-unet/files/"
    server, ours, ref = await _sources(seg_collection, **{files: 2})
    try:
        t0 = time.monotonic()
        listed = await ours.fetch_file_list("tiny-unet", False)
        assert server.hits[files] == 3 and time.monotonic() - t0 >= 0.6  # 0.2 s, then 0.4 s
        assert "rdf.yaml" in [f["name"] for f in listed]
        server.throttle[files] = 4  # more 429s than the 4 tries
        with pytest.raises(RuntimeError, match="HTTP 429"):
            await ours.fetch_file_list("tiny-unet", False)
        missing = chip_smoke.LoopbackCollection.ARTIFACTS + "nope/files/"
        import httpx

        with pytest.raises(httpx.HTTPStatusError):
            await ours.fetch_file_list("nope", False)
        assert server.hits[missing] == 1  # a 404 is final
    finally:
        await _close(ours, ref, server)


async def _entry_infers(entry: EntryDeployment, inputs) -> dict:
    try:
        return await entry.infer(model_id="tiny-unet", inputs=inputs)
    finally:
        await entry.close()


async def test_entry_serves_the_http_collection_and_http_inputs(seg_collection, tmp_path, monkeypatch):
    x = np.load(seg_collection / "field.npy")
    server = chip_smoke.LoopbackCollection(str(seg_collection))
    url = await server.start()
    try:
        remote = EntryDeployment(collection_url=url, cache_dir=str(tmp_path / "http-cache"), device="cpu")
        assert isinstance(remote.model_cache.source, HttpCollectionSource)
        over_http = await _entry_infers(remote, {"input0": x})
        monkeypatch.setenv("BIOENGINE_LOCAL_MODEL_PATH", str(seg_collection))
        local = EntryDeployment(cache_dir=str(tmp_path / "local-cache"), device="cpu")
        assert isinstance(local.model_cache.source, LocalCollectionSource)
        inline = await _entry_infers(local, {"input0": x})
        # an http input: the same array fetched from the loopback server
        fetched = await _entry_infers(
            EntryDeployment(cache_dir=str(tmp_path / "local-cache"), device="cpu"),
            {"input0": f"{url}/field.npy"})
        assert server.hits["/field.npy"] == 1
        arrays = [k for k, v in inline.items() if isinstance(v, np.ndarray)]
        assert arrays == ["output0"] and over_http.keys() == fetched.keys() == inline.keys()
        for name in arrays:
            np.testing.assert_array_equal(over_http[name], inline[name])
            np.testing.assert_array_equal(fetched[name], inline[name])
        # the package came over HTTP, file for file (the cache adds its access stamp)
        cached = tmp_path / "http-cache" / "tiny-unet"
        for p in (seg_collection / "tiny-unet").iterdir():
            assert (cached / p.name).read_bytes() == p.read_bytes(), p.name
    finally:
        await server.stop()
