"""The model-runner served by the port's serving plane on the CPU: the
bundle ``bioengine_tpu_torch/apps/bundles/model-runner`` built by the
port's ``AppBuilder`` and deployed on the port's ``ServeController`` over
a one-chip CPU topology (the case of one H100: the runtime's
``max_replicas: 2`` finds no second chip).

Tolerances: served outputs of a seeded f32 UNet2D ``jax_params`` package
match the JAX app's ``RuntimeDeployment`` within 1e-4 max-abs (slice 2's
tolerance for f32 packages); a batched group matches the port's direct,
unbatched path within 1e-5. Groups flush by ``max_batch`` under a 60 s
timer wherever their composition is counted, so no count races a clock.
"""

import asyncio
import contextlib
import importlib.util
import inspect
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu.models.unet import UNet2D as JaxUNet2D
from bioengine_tpu.rpc.schema import is_schema_method as jax_is_schema_method
from bioengine_tpu.runtime.convert import save_params_npz
from bioengine_tpu_torch.apps import manifest as manifest_mod
from bioengine_tpu_torch.apps.builder import AppBuilder
from bioengine_tpu_torch.apps.model_runner.entry import EntryDeployment
from bioengine_tpu_torch.apps.model_runner.runtime import RuntimeDeployment
from bioengine_tpu_torch.cluster.state import ClusterState
from bioengine_tpu_torch.cluster.topology import detect_topology
from bioengine_tpu_torch.rpc.schema import is_schema_method
from bioengine_tpu_torch.serving import DeploymentHandle, DeploymentSpec, ReplicaState, ServeController

pytestmark = [pytest.mark.integration, pytest.mark.anyio]

REPO = Path(__file__).resolve().parent.parent
BUNDLE = REPO / "bioengine_tpu_torch" / "apps" / "bundles" / "model-runner"
APP_ID = "model-runner"
NEVER_MS = 60_000
JAX_TOL = 1e-4
BATCHED_TOL = 1e-5


def _load_by_file(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_app():
    """``apps/model-runner``'s two deployment modules (the directory name
    is not a package name)."""
    root = REPO / "apps" / "model-runner"
    return (
        _load_by_file("jax_mr_runtime_served", root / "runtime_deployment.py"),
        _load_by_file("jax_mr_entry_served", root / "entry_deployment.py"),
    )


def _write_package(d: Path, params, preprocessing):
    d.mkdir()
    save_params_npz(str(d / "weights.npz"), params)
    rdf = {
        "type": "model",
        "name": d.name,
        "description": "tiny f32 segmentation model",
        "inputs": [{"name": "raw", "axes": "byxc", "preprocessing": preprocessing}],
        "outputs": [{"name": "mask", "axes": "byxc", "postprocessing": [{"name": "sigmoid"}]}],
        "weights": {"jax_params": {
            "source": "weights.npz",
            "architecture": {"name": "unet2d",
                             "kwargs": {"features": [8, 16], "out_channels": 1, "dtype": "float32"}},
        }},
    }
    (d / "rdf.yaml").write_text(json.dumps(rdf, indent=1))
    return str(d)


@pytest.fixture(scope="module")
def collection(tmp_path_factory):
    """A local collection of two seeded f32 UNet2D packages written by the
    JAX package: ``tiny-per-sample`` (per-sample zero-mean in, sigmoid out:
    batchable) and ``tiny-global`` (batch-global zero-mean: never
    co-batched)."""
    root = tmp_path_factory.mktemp("served-collection")
    model = JaxUNet2D(features=(8, 16), out_channels=1, dtype="float32")
    params = seeded_flax_params(model, (1, 64, 64, 1), seed=0)
    return {
        "root": root,
        "per_sample": _write_package(root / "tiny-per-sample", params, [
            {"name": "zero_mean_unit_variance", "kwargs": {"mode": "per_sample"}}]),
        "global": _write_package(root / "tiny-global", params, [
            {"name": "zero_mean_unit_variance"}]),
    }


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 64, 64, 1)).astype(np.float32) for _ in range(n)]


async def _jax_outputs(package, images):
    jax_runtime, _ = _jax_app()
    dep = jax_runtime.RuntimeDeployment()
    try:
        return [(await dep.predict(package, {"raw": x}))["mask"] for x in images]
    finally:
        await dep.close()


async def _direct_outputs(package, images):
    dep = RuntimeDeployment(device="cpu")  # no async_init: no batcher
    try:
        return [(await dep.predict(package, {"raw": x}))["mask"] for x in images]
    finally:
        await dep.close()


def _bundle_copy(tmp_path, runtime_config=None) -> Path:
    """The bundle with ``deployment_config.runtime_deployment`` updated."""
    dst = tmp_path / "bundle"
    shutil.copytree(BUNDLE, dst)
    if runtime_config:
        manifest = json.loads((dst / "manifest.yaml").read_text())
        manifest["deployment_config"]["runtime_deployment"].update(runtime_config)
        (dst / "manifest.yaml").write_text(json.dumps(manifest))
    return dst


@contextlib.asynccontextmanager
async def _served(tmp_path, collection, monkeypatch, runtime_config=None):
    """Build the bundle with the port's AppBuilder and deploy it on a
    one-chip CPU topology; yields (controller, app, built)."""
    monkeypatch.setenv("BIOENGINE_LOCAL_MODEL_PATH", str(collection["root"]))
    controller = ServeController(ClusterState(detect_topology(device="cpu", n_devices=1)),
                                 health_check_period=3600)
    built = AppBuilder(workdir_root=tmp_path / "workdirs").build(
        APP_ID,
        local_path=_bundle_copy(tmp_path, runtime_config),
        deployment_kwargs={
            "runtime_deployment": {"device": "cpu"},
            "entry_deployment": {"device": "cpu", "cache_dir": str(tmp_path / "cache")},
        },
        make_handle=lambda name: DeploymentHandle(controller, APP_ID, name),
    )
    try:
        app = await controller.deploy(APP_ID, built.specs, acl=built.authorized_users)

        async def healthy():
            while any(r.state != ReplicaState.HEALTHY for reps in app.replicas.values() for r in reps):
                await asyncio.sleep(0.005)

        await asyncio.wait_for(healthy(), 30)
        yield controller, app, built
    finally:
        await controller.stop()


def _runtime(app):
    (replica,) = app.replicas["runtime_deployment"]
    return replica.instance


async def test_bundle_deploys_with_the_runtime_on_the_one_chip(tmp_path, collection, monkeypatch):
    async with _served(tmp_path, collection, monkeypatch) as (controller, app, built):
        assert [s.name for s in built.specs] == ["runtime_deployment", "entry_deployment"]
        leases = {name: [r.device_ids for r in reps] for name, reps in app.replicas.items()}
        assert leases == {"runtime_deployment": [[0]], "entry_deployment": [[]]}
        assert controller.cluster_state.free_chips() == 0
        runtime = _runtime(app)
        assert runtime.device.type == "cpu" and runtime._batcher is not None
        assert (runtime.batch_max, runtime.batch_wait_ms) == (8, 5.0)
        (entry_replica,) = app.replicas["entry_deployment"]
        assert isinstance(entry_replica.instance.runtime_deployment, DeploymentHandle)
        status = await controller.get_handle(APP_ID, "runtime_deployment").get_status()
        assert status["backend"] == "cpu" and status["device_count"] == 1


async def test_concurrent_predicts_batch_and_match_jax(tmp_path, collection, monkeypatch):
    package = collection["per_sample"]
    images = _images(8)
    want = await _jax_outputs(package, images)
    direct = await _direct_outputs(package, images)
    config = {"batching": {"max_batch": 4, "max_wait_ms": NEVER_MS}}
    async with _served(tmp_path, collection, monkeypatch, config) as (controller, app, _):
        handle = controller.get_handle(APP_ID, "runtime_deployment")
        served = await asyncio.gather(*(handle.predict(rdf_path=package, inputs={"raw": x}) for x in images))
        stats = _runtime(app)._batcher.stats
    assert stats["requests"] == 8 and stats["batches"] == 2 < stats["requests"]
    assert stats["occupancy"]["p50"] == 4
    for got, ref, dir_ in zip(served, want, direct):
        assert got["mask"].shape == ref.shape == (1, 64, 64, 1)
        assert got["_meta"]["backend"] == "cpu"
        np.testing.assert_allclose(got["mask"], ref, rtol=0, atol=JAX_TOL)
        np.testing.assert_allclose(got["mask"], dir_, rtol=0, atol=BATCHED_TOL)


async def test_entry_infer_and_predict_through_the_shipped_manifest(tmp_path, collection, monkeypatch):
    package = collection["per_sample"]
    images = _images(4, seed=1)
    want = await _jax_outputs(package, images)
    async with _served(tmp_path, collection, monkeypatch) as (controller, app, _):
        entry = controller.get_handle(APP_ID, "entry_deployment")
        runtime = controller.get_handle(APP_ID, "runtime_deployment")
        served = await asyncio.gather(
            entry.infer(model_id="tiny-per-sample", inputs=images[0]),
            entry.infer(model_id="tiny-per-sample", inputs={"raw": images[1]}),
            runtime.predict(rdf_path=package, inputs=images[2]),
            runtime.predict(rdf_path=package, inputs={"raw": images[3]}),
        )
        listed = await entry.search_models(ignore_checks=True)
        report = await entry.test(model_id="tiny-per-sample")
    for got, ref in zip(served, want):
        np.testing.assert_allclose(got["mask"], ref, rtol=0, atol=JAX_TOL)
    assert {m["model_id"] for m in listed} == {"tiny-per-sample", "tiny-global"}
    assert report["status"] == "passed" and report["backend"] == "cpu"


async def test_batch_global_processing_never_co_batches(tmp_path, collection, monkeypatch):
    package = collection["global"]
    images = _images(4, seed=2)
    want = await _jax_outputs(package, images)
    direct = await _direct_outputs(package, images)
    config = {"batching": {"max_batch": 4, "max_wait_ms": NEVER_MS}}
    async with _served(tmp_path, collection, monkeypatch, config) as (controller, app, _):
        handle = controller.get_handle(APP_ID, "runtime_deployment")
        served = await asyncio.gather(*(handle.predict(rdf_path=package, inputs={"raw": x}) for x in images))
        runtime = _runtime(app)
        (pipeline,) = runtime._pipelines.values()
        assert not runtime._batchable(pipeline, images[0])
        assert runtime._batcher.stats["requests"] == 0
    for got, ref, dir_ in zip(served, want, direct):
        np.testing.assert_allclose(got["mask"], ref, rtol=0, atol=JAX_TOL)
        np.testing.assert_array_equal(got["mask"], dir_)


async def test_max_batch_one_turns_the_batcher_off(tmp_path, collection, monkeypatch):
    package = collection["per_sample"]
    images = _images(3, seed=3)
    direct = await _direct_outputs(package, images)
    async with _served(tmp_path, collection, monkeypatch, {"batching": {"max_batch": 1}}) as (controller, app, _):
        handle = controller.get_handle(APP_ID, "runtime_deployment")
        served = await asyncio.gather(*(handle.predict(rdf_path=package, inputs=x) for x in images))
        assert _runtime(app)._batcher is None
    for got, dir_ in zip(served, direct):
        np.testing.assert_array_equal(got["mask"], dir_)


async def test_second_runtime_replica_becomes_a_pending_workload(tmp_path, collection, monkeypatch):
    """Three requests wait in a group that flushes at four: the runtime's
    load is 0.75 of its 4 slots, over the 0.7 target, so the controller
    wants a second replica; the one chip is leased, so it records a
    pending workload and the app keeps serving."""
    package = collection["per_sample"]
    images = _images(4, seed=4)
    config = {"batching": {"max_batch": 4, "max_wait_ms": NEVER_MS}}
    async with _served(tmp_path, collection, monkeypatch, config) as (controller, app, _):
        handle = controller.get_handle(APP_ID, "runtime_deployment")
        runtime = _runtime(app)
        waiting = [asyncio.create_task(handle.predict(rdf_path=package, inputs=x)) for x in images[:3]]

        async def parked():
            while runtime._batcher.stats["requests"] < 3:
                await asyncio.sleep(0.005)

        await asyncio.wait_for(parked(), 30)
        await controller.health_tick()
        state = controller.cluster_state
        assert [p.workload_id for p in state.pending()] == [f"{APP_ID}/runtime_deployment"]
        assert state.pending()[0].resources == {"chips": 1}
        assert len(app.replicas["runtime_deployment"]) == 1
        assert controller.get_app_status(APP_ID)["status"] == "RUNNING"
        last = await handle.predict(rdf_path=package, inputs=images[3])  # fills the group
        outs = [await t for t in waiting] + [last]
    assert all(o["mask"].shape == (1, 64, 64, 1) for o in outs)


async def test_undeploy_releases_the_chip_and_the_pipelines(tmp_path, collection, monkeypatch):
    async with _served(tmp_path, collection, monkeypatch) as (controller, app, _):
        handle = controller.get_handle(APP_ID, "runtime_deployment")
        await handle.predict(rdf_path=collection["per_sample"], inputs=_images(1)[0])
        runtime = _runtime(app)
        (pipeline,) = runtime._pipelines.values()
        await controller.undeploy(APP_ID)
        assert controller.cluster_state.free_chips() == 1
        assert runtime._pipelines == {} and runtime._batcher._closed
        assert pipeline.engine._dispatcher._closed
        assert not [k for k in pipeline.engine.cache.keys() if k[-1] == pipeline.engine._placement_key]


class InitFailsOnce(RuntimeDeployment):
    failures = 0

    async def async_init(self):
        if InitFailsOnce.failures == 0:
            InitFailsOnce.failures += 1
            raise RuntimeError("async_init failed on purpose")
        await super().async_init()


async def test_failed_async_init_releases_the_chip_and_a_retry_succeeds():
    InitFailsOnce.failures = 0
    controller = ServeController(ClusterState(detect_topology(device="cpu", n_devices=1)),
                                 health_check_period=3600)
    spec = DeploymentSpec(name="runtime_deployment", instance_factory=lambda: InitFailsOnce(device="cpu"),
                          chips_per_replica=1, autoscale=False)
    try:
        with pytest.raises(RuntimeError, match="async_init failed on purpose"):
            await controller.deploy("init-fails", [spec])
        assert controller.apps["init-fails"].status == "DEPLOY_FAILED"
        assert controller.cluster_state.free_chips() == 1
        app = await controller.deploy("init-fails", [spec])
        assert app.status == "RUNNING" and app.replicas["runtime_deployment"][0].device_ids == [0]
    finally:
        await controller.stop()


async def test_async_init_reads_the_lease_and_the_batch_config():
    dep = RuntimeDeployment(device="cpu")
    dep.bioengine_device_ids = [0]
    dep.bioengine_batch_config = {"max_batch": 2, "max_wait_ms": 7.0}
    await dep.async_init()
    assert dep.device.type == "cpu" and (dep.batch_max, dep.batch_wait_ms) == (2, 7.0)
    assert dep._batcher.max_batch == 2
    await dep.close()
    # the JAX rule on the CPU's 8 ids: a lease only partly among them is
    # refused; a lease of several ids is a group (a dp engine)
    refused = RuntimeDeployment(device="cpu")
    refused.bioengine_device_ids = [7, 8]
    with pytest.raises(ValueError, match="numbering conflict"):
        await refused.async_init()
    group = RuntimeDeployment(device="cpu")
    group.bioengine_device_ids = [1, 2]
    await group.async_init()
    assert group._devices == [torch.device("cpu")] * 2
    assert group.mesh_info()["lease"] == [1, 2] and group.mesh_info()["mesh_shape"] == {"dp": 2}
    await group.close()


def test_entry_closes_only_a_runtime_it_built(tmp_path, monkeypatch):
    monkeypatch.setenv("BIOENGINE_LOCAL_MODEL_PATH", str(tmp_path))

    class Handle:
        closed = False

        async def close(self):
            Handle.closed = True

    entry = EntryDeployment(runtime_deployment=Handle(), cache_dir=str(tmp_path / "cache"), device="cpu")
    asyncio.run(entry.close())
    assert not Handle.closed
    own = EntryDeployment(cache_dir=str(tmp_path / "cache"), device="cpu")
    asyncio.run(own.close())
    assert own._owns_runtime


def _schemas(cls, predicate):
    return {
        name: sorted(fn.__schema__["parameters"]["properties"])
        for name, fn in inspect.getmembers(cls, callable)
        if predicate(fn)
    }


def test_schema_methods_equal_the_jax_apps(tmp_path, collection, monkeypatch):
    jax_runtime, jax_entry = _jax_app()
    assert _schemas(RuntimeDeployment, is_schema_method) == _schemas(
        jax_runtime.RuntimeDeployment, jax_is_schema_method)
    assert _schemas(EntryDeployment, is_schema_method) == _schemas(
        jax_entry.EntryDeployment, jax_is_schema_method)
    monkeypatch.setenv("BIOENGINE_LOCAL_MODEL_PATH", str(collection["root"]))
    built = AppBuilder(workdir_root=tmp_path).build(
        APP_ID, local_path=BUNDLE, make_handle=lambda name: None,
        deployment_kwargs={"entry_deployment": {"device": "cpu", "cache_dir": str(tmp_path / "c")}})
    assert sorted(built.schema_methods) == sorted(_schemas(jax_entry.EntryDeployment, jax_is_schema_method))


def test_manifest_matches_the_jax_apps():
    ours = manifest_mod.load_manifest(BUNDLE)
    import yaml

    ref = yaml.safe_load((REPO / "apps" / "model-runner" / "manifest.yaml").read_text())
    assert [d.python_file for d in ours.deployments] == ["entry_deployment.py", "runtime_deployment.py"]
    assert ours.raw["deployments"] == ref["deployments"]
    assert ours.deployment_config == ref["deployment_config"]
    assert ours.raw["type"] in manifest_mod.ACCEPTED_TYPES
    assert manifest_mod.ACCEPTED_TYPES == ("tpu-serve", "ray-serve")


def test_remote_payload_carries_the_manifest(tmp_path, collection, monkeypatch):
    """The payload a worker host rebuilds the app from holds the bundle's
    manifest as YAML, which loads back to the same manifest."""
    import yaml

    monkeypatch.setenv("BIOENGINE_LOCAL_MODEL_PATH", str(collection["root"]))
    built = AppBuilder(workdir_root=tmp_path).build(
        APP_ID, local_path=BUNDLE, make_handle=lambda name: None,
        deployment_kwargs={"entry_deployment": {"device": "cpu", "cache_dir": str(tmp_path / "c")}})
    raw = manifest_mod.load_manifest(BUNDLE).raw
    for spec in built.specs:
        files = spec.remote_payload["files"]
        assert yaml.safe_load(files["manifest.yaml"]) == raw
        assert sorted(files) == ["entry_deployment.py", "manifest.yaml", "runtime_deployment.py"]
    (tmp_path / "shipped").mkdir()
    (tmp_path / "shipped" / "manifest.yaml").write_text(built.specs[0].remote_payload["files"]["manifest.yaml"])
    assert manifest_mod.load_manifest(tmp_path / "shipped").raw == raw
