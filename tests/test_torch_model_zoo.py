"""The port's model-runner on the zoo's own torch formats, and its entry
deployment, on the CPU: ``TorchRunner``, ``Pipeline`` on
``pytorch_state_dict`` (RDF 0.4 and 0.5 architectures) and ``torchscript``
packages against the JAX runtime's ``TorchFallbackRunner`` on the same
packages, and the ``TestModelRunner`` / ``TestModelCacheProtocol`` cases
of ``tests/test_bundled_apps.py`` on the port's ``EntryDeployment`` over
the ``model_collection`` packages written there, plus a TorchScript twin,
a 5-D module and ``chip_smoke.py``'s zoo U-Net package.

Tolerances: a torch module served by both runtimes on the CPU runs the
same f32 operations; the elementwise ``torch-square`` is held exactly, the
convolutional modules to 1e-5 max-abs (oneDNN picks its convolution
kernels by shape and thread count, so a module built twice, eager or
traced, sums in other orders: measured up to 4.2e-6 on outputs of
magnitude ~1). The jax_params models of the
collection are written in f32 here (the bundled-apps fixture's are bf16,
which the port matches to 10% of range only, see
``tests/test_torch_model_runner.py``), so ``test`` passes at rtol = atol =
1e-2 and ``infer`` matches JAX's compiled output to 1e-4.
"""

import asyncio
import importlib.util
import io
import os
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu.models.unet import UNet2D as JaxUNet2D
from bioengine_tpu.models.unet3d import UNet3D as JaxUNet3D
from bioengine_tpu.runtime.convert import save_params_npz
from bioengine_tpu_torch.apps.model_runner.entry import (
    STALE_DOWNLOAD_SECONDS,
    EntryDeployment,
    LocalCollectionSource,
    ModelCache,
)
from bioengine_tpu_torch.apps.model_runner.runtime import Pipeline, RuntimeDeployment
from bioengine_tpu_torch.runtime.torch_runner import PRECISION, TorchRunner, full_f32

REPO = Path(__file__).resolve().parent.parent

SQUARE_SOURCE = (
    "import torch\n"
    "class SquareNet(torch.nn.Module):\n"
    "    def __init__(self, scale=1.0):\n"
    "        super().__init__()\n"
    "        self.scale = torch.nn.Parameter(torch.tensor(float(scale)))\n"
    "    def forward(self, x):\n"
    "        return x * x * self.scale\n"
)
CONV3D_SOURCE = (
    "import torch\n"
    "class Conv3dNet(torch.nn.Module):\n"
    "    def __init__(self, channels=2):\n"
    "        super().__init__()\n"
    "        self.conv = torch.nn.Conv3d(1, channels, 3, padding=1)\n"
    "        self.head = torch.nn.Conv3d(channels, 1, 1)\n"
    "    def forward(self, x):\n"
    "        return (self.head(torch.relu(self.conv(x))), x)\n"
)


def _load_by_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rdf(name, weights, axes="byxc", **extra):
    return yaml.safe_dump({
        "type": "model", "name": name, "description": extra.pop("description", f"{name} test model"),
        "inputs": [{"name": "input0", "axes": axes}],
        "outputs": [{"name": "output0", "axes": axes}],
        "test_inputs": ["test_input.npy"], "test_outputs": ["test_output.npy"],
        "weights": weights, **extra,
    })


def _exec_module(source, name, **kwargs):
    namespace: dict = {}
    exec(source, namespace)
    module = namespace[name](**kwargs)
    return module


@pytest.fixture(scope="module")
def model_collection(tmp_path_factory):
    """``tests/test_bundled_apps.py``'s collection (tiny-unet, torch-square,
    tiny-unet3d, secret-model; the U-Nets in f32), plus torch-square-ts (a
    traced TorchScript twin of torch-square), torch-conv3d (a 5-D module with a
    tuple output, RDF 0.4 architecture) and zoo-unet (chip_smoke's
    plain-torch U-Net package, narrowed)."""
    root = tmp_path_factory.mktemp("collection")

    d = root / "tiny-unet"
    d.mkdir()
    model = JaxUNet2D(features=(8, 16), out_channels=1, dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=(1, 64, 64, 1)).astype(np.float32)
    params = seeded_flax_params(model, x.shape, seed=0)
    save_params_npz(str(d / "weights.npz"), params)
    np.save(d / "test_input.npy", x)
    np.save(d / "test_output.npy", np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x))))
    (d / "rdf.yaml").write_text(_rdf("Tiny UNet", {"jax_params": {
        "source": "weights.npz",
        "architecture": {"name": "unet2d", "kwargs": {
            "features": [8, 16], "out_channels": 1, "dtype": "float32"}},
    }}, description="tiny segmentation test model", tags=["segmentation", "nuclei"],
        documentation="README.md"))
    (d / "README.md").write_text("# Tiny UNet\ntest model docs")

    d = root / "torch-square"
    d.mkdir()
    (d / "arch.py").write_text(SQUARE_SOURCE)
    square = _exec_module(SQUARE_SOURCE, "SquareNet", scale=2.0)
    torch.save(square.state_dict(), d / "weights.pt")
    x = np.random.default_rng(1).normal(size=(1, 32, 32, 1)).astype(np.float32)
    np.save(d / "test_input.npy", x)
    np.save(d / "test_output.npy", (x * x * 2.0).astype(np.float32))
    (d / "rdf.yaml").write_text(_rdf("Torch Square", {"pytorch_state_dict": {
        "source": "weights.pt",
        "architecture": {"callable": "SquareNet", "source": "arch.py", "kwargs": {"scale": 2.0}},
    }}, description="elementwise square model"))

    ts = root / "torch-square-ts"
    ts.mkdir()
    torch.jit.trace(square, torch.ones(1, 1, 4, 4)).save(str(ts / "weights.torchscript.pt"))
    for f in ("test_input.npy", "test_output.npy"):
        (ts / f).write_bytes((d / f).read_bytes())
    (ts / "rdf.yaml").write_text(_rdf("Torch Square TS", {"torchscript": {
        "source": "weights.torchscript.pt"}}, description="elementwise square, scripted"))

    d = root / "tiny-unet3d"
    d.mkdir()
    model3d = JaxUNet3D(features=(2, 4), out_channels=1, dtype=jnp.float32)
    x3 = np.random.default_rng(2).normal(size=(1, 1, 8, 64, 64)).astype(np.float32)
    vol = np.transpose(x3, (0, 2, 3, 4, 1))
    params3d = seeded_flax_params(model3d, vol.shape, seed=0)
    expected3 = np.asarray(jax.jit(model3d.apply)({"params": params3d}, jnp.asarray(vol)))
    save_params_npz(str(d / "weights.npz"), params3d)
    np.save(d / "test_input.npy", x3)
    np.save(d / "test_output.npy", np.transpose(expected3, (0, 4, 1, 2, 3)))
    (d / "rdf.yaml").write_text(_rdf("Tiny UNet3D", {"jax_params": {
        "source": "weights.npz",
        "architecture": {"name": "unet3d", "kwargs": {
            "features": [2, 4], "out_channels": 1, "dtype": "float32"}},
    }}, axes="bczyx", description="tiny volumetric segmentation test model",
        tags=["segmentation", "3d"], documentation="README.md"))
    (d / "README.md").write_text("# Tiny UNet3D")

    d = root / "torch-conv3d"
    d.mkdir()
    (d / "model.py").write_text(CONV3D_SOURCE)
    conv3d = _exec_module(CONV3D_SOURCE, "Conv3dNet", channels=2)
    with torch.no_grad():
        for i, p in enumerate(conv3d.parameters()):
            p.copy_(torch.from_numpy(np.random.default_rng(10 + i).normal(0, 0.3, p.shape).astype(np.float32)))
    torch.save({"state_dict": conv3d.state_dict()}, d / "weights.pt")
    x5 = np.random.default_rng(3).normal(size=(1, 1, 6, 16, 16)).astype(np.float32)
    with torch.no_grad():
        y5 = conv3d(torch.from_numpy(x5))[0].numpy()
    np.save(d / "test_input.npy", x5)
    np.save(d / "test_output.npy", y5)
    (d / "rdf.yaml").write_text(_rdf("Torch Conv3d", {"pytorch_state_dict": {
        "source": "weights.pt", "architecture": "model.py:Conv3dNet", "kwargs": {"channels": 2},
    }}, axes="bczyx", description="volumetric torch module"))

    chip_smoke.write_zoo_collection(str(root / "zoo"), (4, 8), seed=5)
    (root / "zoo" / "zoo-unet").rename(root / "zoo-unet")

    d = root / "secret-model"
    d.mkdir()
    (d / "rdf.yaml").write_text(yaml.safe_dump({
        "type": "model", "name": "Secret", "description": "did not pass checks",
        "inputs": [{"name": "input0", "axes": "byxc"}],
        "outputs": [{"name": "output0", "axes": "byxc"}],
        "weights": {"jax_params": {"source": "missing.npz"}},
    }))

    passed = ["tiny-unet", "tiny-unet3d", "torch-square", "torch-square-ts", "torch-conv3d", "zoo-unet"]
    (root / "collection.yaml").write_text(yaml.safe_dump({"bioengine_inference": {
        **{m: {"status": "passed"} for m in passed}, "secret-model": {"status": "failed"},
    }}))
    return root


PASSED = {"tiny-unet", "tiny-unet3d", "torch-square", "torch-square-ts", "torch-conv3d", "zoo-unet"}


def _entry_run(model_collection, tmp_path, monkeypatch, body):
    """Run ``body(entry)`` on a fresh port EntryDeployment over the
    collection, on the CPU, and close it."""
    monkeypatch.setenv("BIOENGINE_LOCAL_MODEL_PATH", str(model_collection))

    async def drive():
        entry = EntryDeployment(cache_dir=str(tmp_path / "model-cache"), device="cpu")
        try:
            await entry.async_init()
            return await body(entry)
        finally:
            await entry.close()

    return asyncio.run(drive())


# ---- the torch formats: the port's runtime against the JAX runtime --------------


@pytest.mark.parametrize("model_id", ["torch-square", "torch-square-ts", "torch-conv3d", "zoo-unet"])
def test_torch_packages_served_by_both_runtimes(model_collection, model_id):
    package = model_collection / model_id
    raw = yaml.safe_load((package / "rdf.yaml").read_text())
    x = np.load(package / (
        "test_input.npy" if "test_inputs" in raw else raw["inputs"][0]["test_tensor"]["source"]))
    deployment = RuntimeDeployment(device="cpu")

    async def drive():
        try:
            report = await deployment.test(str(package), skip_cache=True)
            result = await deployment.predict(str(package / "rdf.yaml"), x)
            return report, result, await deployment.get_status()
        finally:
            await deployment.close()

    report, result, status = asyncio.run(drive())
    fmt = next(iter(raw["weights"]))
    assert report["status"] == "passed" and report["output_matches_expected"], report
    assert report["backend"] == result["_meta"]["backend"] == "torch"
    assert report["weights_format"] == result["_meta"]["weights_format"] == fmt
    assert {p["precision"] for p in status["loaded_pipelines"]} == {PRECISION}
    out = next(v for k, v in result.items() if k != "_meta")
    jax_rt = _load_by_path(f"jax_mr_rt_{model_id}", REPO / "apps" / "model-runner" / "runtime_deployment.py")
    pipeline = jax_rt.Pipeline(package)
    try:
        assert pipeline.backend == "torch"
        ref = next(iter(pipeline.predict(x).values()))
    finally:
        pipeline.close()
    assert out.shape == ref.shape == x.shape[:1] + ref.shape[1:]
    if model_id.startswith("torch-square"):
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_zoo_unet_twin_formats_agree(model_collection):
    """chip_smoke's package: the state dict and its traced twin, selected
    by ``weights_format``, against the module built from ``arch.py``."""
    package = model_collection / "zoo-unet"
    x = np.random.default_rng(4).standard_normal((2, 1, 64, 64)).astype(np.float32)
    outs = {}
    for fmt in ("pytorch_state_dict", "torchscript"):
        pipe = Pipeline(package, fmt, device="cpu")
        try:
            assert pipe.backend == "torch" and pipe.engine.describe() == {
                "kind": "module" if fmt == "pytorch_state_dict" else "torchscript",
                "device": "cpu", "precision": PRECISION, "runs": 0}
            assert pipe.load_info["weights_seconds"] >= 0 and pipe.pipeline_stats() == {}
            outs[fmt] = pipe.predict({"raw": x})["mask"]
            assert pipe.engine.runs == 1
        finally:
            pipe.close()
    module = chip_smoke.zoo_unet((4, 8), seed=5)
    with torch.no_grad():
        ref = module(torch.from_numpy(x)).numpy()
    for out in outs.values():
        assert out.shape == x.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_torch_runner_contract():
    """Channels-last in and out for 4-D and 5-D input, a tuple output's
    first element, TF32 off only inside the forward, and the one worker."""
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append((tuple(x.shape), torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return [x * 2.0, x]

    runner = TorchRunner(module=Probe(), device="cpu")
    try:
        before = torch.backends.cudnn.allow_tf32
        img = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
        np.testing.assert_array_equal(runner.predict(img), img * 2.0)
        vol = np.ones((1, 2, 3, 4, 2), np.float32)
        np.testing.assert_array_equal(runner.submit(runner.predict, vol).result(), vol * 2.0)
        assert seen == [((2, 5, 3, 4), False, False), ((1, 2, 2, 3, 4), False, False)]
        assert torch.backends.cudnn.allow_tf32 == before and runner.runs == 2
        assert runner.describe()["precision"] == PRECISION
    finally:
        runner.close()
    with pytest.raises(ValueError, match="module or a torchscript path"):
        TorchRunner(device="cpu")
    with full_f32():
        assert not torch.backends.cudnn.allow_tf32


def test_torch_weights_without_architecture_fail(tmp_path):
    (tmp_path / "weights.pt").write_bytes(b"")
    (tmp_path / "rdf.yaml").write_text(_rdf("No Arch", {"pytorch_state_dict": {"source": "weights.pt"}}))
    with pytest.raises(ValueError, match="without architecture"):
        Pipeline(tmp_path, device="cpu")
    (tmp_path / "rdf.yaml").write_text(_rdf("Bad Callable", {"pytorch_state_dict": {
        "source": "weights.pt", "architecture": {"source": "arch.py", "callable": "Nope"}}}))
    (tmp_path / "arch.py").write_text(SQUARE_SOURCE)
    with pytest.raises(ValueError, match="'Nope' not found"):
        Pipeline(tmp_path, device="cpu")


# ---- TestModelRunner's cases on the port's EntryDeployment ------------------------


def test_search_models(model_collection, tmp_path, monkeypatch):
    async def body(entry):
        return (await entry.search_models(), await entry.search_models(keywords=["nuclei"]),
                await entry.search_models(ignore_checks=True, limit=20))

    checked, nuclei, everything = _entry_run(model_collection, tmp_path, monkeypatch, body)
    assert {m["model_id"] for m in checked} == PASSED  # checks filter applied
    assert [m["model_id"] for m in nuclei] == ["tiny-unet"]
    assert {m["model_id"] for m in everything} == PASSED | {"secret-model"}


def test_rdf_and_documentation(model_collection, tmp_path, monkeypatch):
    async def body(entry):
        return (await entry.get_model_rdf(model_id="tiny-unet"),
                await entry.get_model_documentation(model_id="tiny-unet"),
                await entry.get_model_documentation(model_id="torch-square"))

    rdf, doc, none_doc = _entry_run(model_collection, tmp_path, monkeypatch, body)
    assert rdf["name"] == "Tiny UNet" and "Tiny UNet" in doc and none_doc is None


def test_validate(model_collection, tmp_path, monkeypatch):
    async def body(entry):
        good = await entry.validate(rdf_dict={
            "name": "m", "type": "model",
            "inputs": [{"axes": "byxc"}], "outputs": [{"axes": "byxc"}],
            "weights": {"jax_params": {"source": "w.npz"}},
        })
        return good, await entry.validate(rdf_dict={"name": "m"})

    good, bad = _entry_run(model_collection, tmp_path, monkeypatch, body)
    assert good["success"] and not bad["success"] and "inputs" in bad["details"]


def test_model_test_and_report_cache(model_collection, tmp_path, monkeypatch):
    async def body(entry):
        report = await entry.test(model_id="tiny-unet")
        again = await entry.test(model_id="tiny-unet")
        torch_report = await entry.test(model_id="torch-conv3d")
        return report, again, torch_report

    report, again, torch_report = _entry_run(model_collection, tmp_path, monkeypatch, body)
    assert report["status"] == "passed" and report["backend"] == "cpu"
    assert report["output_matches_expected"] is True
    assert (tmp_path / "model-cache" / "tiny-unet" / ".test_cache.json").exists()
    assert again == report
    assert torch_report["status"] == "passed" and torch_report["backend"] == "torch"


def test_infer_jax_models(model_collection, tmp_path, monkeypatch):
    async def body(entry):
        outs = {}
        for model_id in ("tiny-unet", "tiny-unet3d"):
            x = np.load(model_collection / model_id / "test_input.npy")
            outs[model_id] = await entry.infer(model_id=model_id, inputs=x)
        return outs

    outs = _entry_run(model_collection, tmp_path, monkeypatch, body)
    for model_id, out in outs.items():
        expected = np.load(model_collection / model_id / "test_output.npy")
        assert out["_meta"]["backend"] == "cpu"
        assert np.asarray(out["output0"]).shape == expected.shape
        np.testing.assert_allclose(out["output0"], expected, rtol=1e-4, atol=1e-4)


def test_infer_torch_formats(model_collection, tmp_path, monkeypatch):
    x = np.full((1, 32, 32, 1), 3.0, np.float32)
    x5 = np.load(model_collection / "torch-conv3d" / "test_input.npy")

    async def body(entry):
        return (await entry.infer(model_id="torch-square", inputs=x),
                await entry.infer(model_id="torch-square-ts", inputs={"input0": x}),
                await entry.infer(model_id="torch-conv3d", inputs=x5),
                await entry.infer(model_id="zoo-unet", inputs=np.zeros((1, 1, 32, 32), np.float32),
                                  weights_format="torchscript"))

    square, square_ts, conv3d, zoo = _entry_run(model_collection, tmp_path, monkeypatch, body)
    for out in (square, square_ts):
        assert out["_meta"]["backend"] == "torch"
        np.testing.assert_allclose(out["output0"], np.full_like(x, 18.0), rtol=1e-5)
    assert square_ts["_meta"]["weights_format"] == "torchscript"
    np.testing.assert_allclose(
        conv3d["output0"], np.load(model_collection / "torch-conv3d" / "test_output.npy"), rtol=0, atol=1e-5)
    assert zoo["_meta"]["weights_format"] == "torchscript" and zoo["mask"].shape == (1, 1, 32, 32)


def test_unpublished_model_rejected(model_collection, tmp_path, monkeypatch):
    async def body(entry):
        with pytest.raises(ValueError, match="inference check"):
            await entry.infer(model_id="secret-model", inputs=np.zeros((1, 32, 32, 1), np.float32))

    _entry_run(model_collection, tmp_path, monkeypatch, body)


def test_upload_roundtrip(model_collection, tmp_path, monkeypatch):
    x = np.full((1, 32, 32, 1), 2.0, np.float32)
    buf = io.BytesIO()
    np.save(buf, x)

    async def body(entry):
        slot = await entry.get_upload_url(file_type=".npy")
        await entry.upload_image(file_path=slot["file_path"], data=buf.getvalue())
        out = await entry.infer(model_id="torch-square", inputs=slot["file_path"])
        saved = await entry.infer(model_id="torch-square", inputs={"input0": slot["file_path"]},
                                  return_download_url=True)
        with pytest.raises(ValueError, match="file_type"):
            await entry.get_upload_url(file_type=".exe")
        with pytest.raises(FileNotFoundError, match="not found or expired"):
            await entry.infer(model_id="torch-square", inputs="temp/missing.npy")
        return out, saved, entry._uploads_dir

    out, saved, uploads = _entry_run(model_collection, tmp_path, monkeypatch, body)
    np.testing.assert_allclose(out["output0"], np.full_like(x, 8.0), rtol=1e-5)
    np.testing.assert_allclose(np.load(uploads / saved["output0"]), np.full_like(x, 8.0), rtol=1e-5)


def test_upload_traversal_rejected(model_collection, tmp_path, monkeypatch):
    async def body(entry):
        for evil in ("../../etc/shadow", "../uploads-evil/x.npy"):
            with pytest.raises(ValueError, match="escapes"):
                await entry.upload_image(file_path=evil, data=b"x")
            with pytest.raises(ValueError, match="escapes"):
                await entry.infer(model_id="torch-square", inputs=evil)

    _entry_run(model_collection, tmp_path, monkeypatch, body)


def test_list_cached_models(model_collection, tmp_path, monkeypatch):
    async def body(entry):
        await entry.infer(model_id="tiny-unet", inputs=np.zeros((1, 64, 64, 1), np.float32))
        return await entry.list_cached_models()

    cached = _entry_run(model_collection, tmp_path, monkeypatch, body)
    (row,) = [m for m in cached if m["model_id"] == "tiny-unet"]
    assert row["size_bytes"] > 0 and row["last_access"] > 0 and row["in_use"] is False


# ---- TestModelCacheProtocol's cases ------------------------------------------------


def test_lru_eviction_respects_in_use(model_collection, tmp_path):
    async def drive():
        cache = ModelCache(tmp_path / "cache", LocalCollectionSource(model_collection), max_size_bytes=1)
        pkg = await cache.get_model_package("tiny-unet", allow_unpublished=True)
        async with pkg:
            # tiny-unet is in use: fetching another model must not evict it
            await cache.get_model_package("torch-square", allow_unpublished=True)
            assert pkg.path.exists()
            assert list((tmp_path / "cache").glob(".inuse-tiny-unet-*"))
            with pytest.raises(RuntimeError, match="while it is in use"):
                await cache.get_model_package("tiny-unet", allow_unpublished=True, skip_cache=True)
        assert not list((tmp_path / "cache").glob(".inuse-*"))
        # not in use anymore: the next download evicts the LRU package
        await cache.get_model_package("torch-square", allow_unpublished=True, skip_cache=True)

    asyncio.run(drive())
    assert not (tmp_path / "cache" / "tiny-unet").exists()


def test_stale_marker_recovery(model_collection, tmp_path):
    cache = ModelCache(tmp_path / "cache", LocalCollectionSource(model_collection))
    marker = cache._marker("tiny-unet", False)
    marker.touch()
    old = time.time() - STALE_DOWNLOAD_SECONDS - 10
    os.utime(marker, (old, old))
    pkg = asyncio.run(cache.get_model_package("tiny-unet", allow_unpublished=True))
    assert pkg.path.exists() and not marker.exists()
    assert (pkg.path / "weights.npz").exists() and not list((tmp_path / "cache").glob(".tmp-*"))


def test_url_as_model_id_rejected(model_collection, tmp_path):
    cache = ModelCache(tmp_path / "cache", LocalCollectionSource(model_collection))
    for bad in ("https://example.com/model", "a/b"):
        with pytest.raises(ValueError, match="not a model id"):
            asyncio.run(cache.get_model_package(bad))


def test_collection_reads_json_without_pyyaml(model_collection, tmp_path, monkeypatch):
    """The card's machine may lack PyYAML: chip_smoke writes rdf.yaml and
    collection.yaml as JSON, which the source reads either way."""
    root = tmp_path / "zoo"
    chip_smoke.write_zoo_collection(str(root), (4, 8), seed=6)
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml fails
    source = LocalCollectionSource(root)
    models = asyncio.run(source.list_models())
    assert [m["model_id"] for m in models] == ["zoo-unet"]
    assert asyncio.run(source.is_published("zoo-unet"))
