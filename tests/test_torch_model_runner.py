"""The port's model-runner (``Pipeline``/``RuntimeDeployment``) on the CPU,
serving ``jax_params`` packages written by the JAX package, as
``tests/test_bundled_apps.py`` writes them, plus the RDF cases of
``tests/test_runtime.py``.

Tolerances: f32 packages match the JAX ``Pipeline`` to 1e-4 max-abs and
pass the package ``test`` (rtol = atol = 1e-2, as the JAX runtime checks).
bf16 packages match the JAX ``Pipeline`` to 10% of the output's largest
magnitude: bf16 rounds at other places in XLA's fused CPU program than in
PyTorch, and JAX's own jitted and eager bf16 forwards of the tiny U-Net
differ by ~1% of that range. So a bf16 package whose expected outputs come
from JAX's compiled program can fail the 1e-2 check when the port serves
it; the test holds the reported error to the same 10% bound.
"""

import asyncio
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bioengine_tpu.models.unet import UNet2D as JaxUNet2D
from bioengine_tpu.models.unet3d import UNet3D as JaxUNet3D
from bioengine_tpu.runtime.convert import flatten_params, save_params_npz
from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu_torch.apps.model_runner.runtime import (
    Pipeline,
    RuntimeDeployment,
    _normalize_oom,
)
from bioengine_tpu_torch.runtime.rdf import (
    _axes_string,
    apply_processing,
    canonical_layout,
    from_nhwc,
    load_model_rdf,
    to_nhwc,
)
from bioengine_tpu_torch.runtime.weight_stream import write_manifest

REPO = Path(__file__).resolve().parent.parent


def _jax_runtime():
    """``apps/model-runner/runtime_deployment.py`` (its directory name is
    not a package name)."""
    path = REPO / "apps" / "model-runner" / "runtime_deployment.py"
    spec = importlib.util.spec_from_file_location("jax_model_runner_runtime", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_package(d: Path, name, arch, kwargs, params, x, expected, axes):
    d.mkdir()
    save_params_npz(str(d / "weights.npz"), params)
    np.save(d / "test_input.npy", x)
    np.save(d / "test_output.npy", expected)
    (d / "rdf.yaml").write_text(yaml.safe_dump({
        "type": "model",
        "name": name,
        "description": "tiny segmentation test model",
        "inputs": [{"name": "input0", "axes": axes}],
        "outputs": [{"name": "output0", "axes": axes}],
        "test_inputs": ["test_input.npy"],
        "test_outputs": ["test_output.npy"],
        "weights": {"jax_params": {
            "source": "weights.npz",
            "architecture": {"name": arch, "kwargs": kwargs},
        }},
    }))
    return d


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    """The tiny-unet and tiny-unet3d packages of test_bundled_apps.py, as
    written there (bf16 defaults, expected outputs from JAX's jit), and
    the same two in f32."""
    root = tmp_path_factory.mktemp("collection")
    out = {}
    for dtype in ("bfloat16", "float32"):
        kw = {"features": [8, 16], "out_channels": 1}
        if dtype == "float32":
            kw["dtype"] = dtype
        model = JaxUNet2D(**{**kw, "features": (8, 16)})
        x = np.random.default_rng(0).normal(size=(1, 64, 64, 1)).astype(np.float32)
        params = seeded_flax_params(model, x.shape, seed=0)
        expected = np.asarray(
            jax.jit(lambda p, a: model.apply({"params": p}, a))(params, jnp.asarray(x))
        )
        out[f"unet2d-{dtype}"] = _write_package(
            root / f"tiny-unet-{dtype}", "Tiny UNet", "unet2d", kw, params, x, expected, "byxc"
        )
        kw3 = {"features": [2, 4], "out_channels": 1}
        if dtype == "float32":
            kw3["dtype"] = dtype
        model3 = JaxUNet3D(**{**kw3, "features": (2, 4)})
        # exact bucket sizes: GroupNorm statistics are volume-global
        x3 = np.random.default_rng(2).normal(size=(1, 1, 8, 64, 64)).astype(np.float32)
        vol = np.transpose(x3, (0, 2, 3, 4, 1))
        params3 = seeded_flax_params(model3, vol.shape, seed=0)
        expected3 = np.asarray(
            jax.jit(lambda p, a: model3.apply({"params": p}, a))(params3, jnp.asarray(vol))
        )
        out[f"unet3d-{dtype}"] = _write_package(
            root / f"tiny-unet3d-{dtype}", "Tiny UNet3D", "unet3d", kw3, params3, x3,
            np.transpose(expected3, (0, 4, 1, 2, 3)), "bczyx",
        )
    return out


def _jax_predict(package, x, blocksize=None):
    pipe = _jax_runtime().Pipeline(package, None, blocksize)
    try:
        return next(iter(pipe.predict(x).values()))
    finally:
        pipe.close()


@pytest.mark.parametrize("name", ["unet2d-float32", "unet3d-float32", "unet2d-bfloat16", "unet3d-bfloat16"])
def test_port_serves_jax_packages(packages, name):
    package = packages[name]
    x = np.load(package / "test_input.npy")
    expected = np.load(package / "test_output.npy")
    deployment = RuntimeDeployment(device="cpu")

    async def drive():
        try:
            report = await deployment.test(str(package / "rdf.yaml"), skip_cache=True)
            result = await deployment.predict(str(package / "rdf.yaml"), {"input0": x})
            return report, result
        finally:
            await deployment.close()

    report, result = asyncio.run(drive())
    out = result["output0"]
    ref = _jax_predict(package, x)
    assert out.shape == ref.shape == expected.shape
    assert report["output_shape"] == list(expected.shape)
    assert report["backend"] == "cpu" and result["_meta"]["backend"] == "cpu"
    assert report["weights_format"] == "jax_params" and not report["synthesized_input"]
    if name.endswith("float32"):
        assert report["status"] == "passed" and report["output_matches_expected"]
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    else:
        bound = 0.1 * np.abs(ref).max()
        assert np.abs(out - ref).max() <= bound
        assert report.get("max_abs_error", 0.0) <= bound


def test_tiled_blocksize_matches_jax(packages):
    """``default_blocksize_parameter`` 32 tiles the 64^2 test image."""
    package = packages["unet2d-float32"]
    x = np.load(package / "test_input.npy")
    pipe = Pipeline(package, None, 32, device="cpu")
    try:
        out = pipe.predict(x)["output0"]
        assert pipe.engine.pipeline_stats.runs == 1  # took the tiled path
    finally:
        pipe.close()
    np.testing.assert_allclose(out, _jax_predict(package, x, 32), rtol=0, atol=1e-4)


def test_streamed_manifest_equals_eager(packages, tmp_path):
    src = packages["unet2d-float32"]
    package = tmp_path / "streamed"
    package.mkdir()
    for f in src.iterdir():
        if f.is_file() and not f.name.startswith("."):
            (package / f.name).write_bytes(f.read_bytes())
    with np.load(package / "weights.npz") as data:
        write_manifest(package / "weights.npz", {k: data[k] for k in data.files})
        n_keys = len(data.files)
    x = np.load(package / "test_input.npy")
    eager = Pipeline(src, device="cpu")
    streamed = Pipeline(package, device="cpu")
    try:
        assert streamed.load_info == {"streamed": True, "manifest_keys": n_keys}
        out = streamed.predict(x)["output0"]  # waits for the weights
        np.testing.assert_array_equal(out, eager.predict(x)["output0"])
        info = streamed.cold_start_info()
        assert info["stream_done"] and info["bytes_loaded"] > 0
        assert not eager.load_info["streamed"]
    finally:
        eager.close()
        streamed.close()

    # a manifest that disagrees with the checkpoint fails the load loudly
    bad = json.loads((package / "weights.npz.manifest.json").read_text())
    bad["Conv_0/bias"]["dtype"] = "float64"
    (package / "weights.npz.manifest.json").write_text(json.dumps(bad))
    broken = Pipeline(package, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="streamed weight load failed"):
            broken.predict(x)
    finally:
        broken.close()


def test_test_report_is_cached_on_weight_mtimes(packages, monkeypatch):
    from bioengine_tpu_torch.utils import compile_cache

    # a cold process: no kernel-library cache enabled by an earlier test
    # (an eager CPU program writes no entry, so an enabled cache would
    # count its build as a cache hit)
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    package = packages["unet3d-float32"]
    deployment = RuntimeDeployment(device="cpu")

    async def drive():
        try:
            first = await deployment.test(str(package), skip_cache=True)
            (package / ".test_cache.json").write_text(json.dumps({
                "stamp": deployment._weights_stamp(package),
                "report": {"status": "from-cache"},
            }))
            cached = await deployment.test(str(package))
            fresh = await deployment.test(str(package), skip_cache=True)
            status = await deployment.get_status()
            views = (deployment.mesh_info(), deployment.pipeline_stats(),
                     deployment.cold_start_info())
            return first, cached, fresh, status, views
        finally:
            await deployment.close()

    first, cached, fresh, status, (mesh, stats, cold) = asyncio.run(drive())
    (key,) = mesh["engines"]
    assert key.startswith("Tiny UNet3D@tiny-unet3d-float32#")
    assert mesh["lease"] == [0] and mesh["mesh_shape"] is None
    assert mesh["engines"][key]["programs"]["live"] == 1
    assert set(stats) == set(cold) == {key} and stats[key]["runs"] == 0
    assert cold[key]["streamed"] is False and cold[key]["real_compiles"] == 1
    assert first["status"] == "passed"
    assert cached == {"status": "from-cache"}
    assert fresh["status"] == "passed"
    assert status["backend"] == "cpu" and status["device_count"] == 1
    assert [p["model"] for p in status["loaded_pipelines"]] == [
        "Tiny UNet3D@tiny-unet3d-float32"
    ]


def test_torch_weight_formats_are_not_ported_yet(tmp_path):
    """The zoo's torch formats are served now (``tests/test_torch_model_zoo.py``
    holds them against the JAX runtime): a ``pytorch_state_dict`` entry
    without an architecture is refused by name, and ``test`` reports it;
    with one, the package is served on the ``"torch"`` backend."""
    (tmp_path / "weights.pt").write_bytes(b"")
    rdf = {
        "type": "model", "name": "Torch Square",
        "inputs": [{"name": "input0", "axes": "byxc"}],
        "outputs": [{"name": "output0", "axes": "byxc"}],
        "weights": {"pytorch_state_dict": {"source": "weights.pt"}},
    }
    (tmp_path / "rdf.yaml").write_text(yaml.safe_dump(rdf))
    with pytest.raises(ValueError, match="without architecture"):
        Pipeline(tmp_path, device="cpu")
    report = asyncio.run(RuntimeDeployment(device="cpu").test(str(tmp_path)))
    assert report["status"] == "failed" and "without architecture" in report["error"]

    (tmp_path / "arch.py").write_text(
        "import torch\n"
        "class SquareNet(torch.nn.Module):\n"
        "    def __init__(self, scale=1.0):\n"
        "        super().__init__()\n"
        "        self.scale = torch.nn.Parameter(torch.tensor(float(scale)))\n"
        "    def forward(self, x):\n"
        "        return x * x * self.scale\n"
    )
    torch.save({"scale": torch.tensor(2.0)}, tmp_path / "weights.pt")
    rdf["weights"]["pytorch_state_dict"]["architecture"] = "arch.py:SquareNet"
    (tmp_path / "rdf.yaml").write_text(yaml.safe_dump(rdf))
    pipe = Pipeline(tmp_path, device="cpu")
    try:
        assert pipe.backend == "torch" and pipe.weights_format == "pytorch_state_dict"
        out = pipe.predict(np.full((1, 8, 8, 1), 3.0, np.float32))["output0"]
        np.testing.assert_array_equal(out, np.full((1, 8, 8, 1), 18.0, np.float32))
    finally:
        pipe.close()


def test_normalize_oom():
    err = _normalize_oom(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"))
    assert isinstance(err, RuntimeError)
    assert str(err).startswith("CUDA out of memory while executing the model")
    assert "default_blocksize_parameter" in str(err)
    other = ValueError("shape")
    assert _normalize_oom(other) is other


class TestRDF:
    def test_load_and_axes(self, tmp_path):
        rdf = {
            "name": "test-unet",
            "type": "model",
            "inputs": [{
                "name": "raw", "axes": "bcyx",
                "preprocessing": [{"name": "zero_mean_unit_variance", "kwargs": {}}],
            }],
            "outputs": [{"name": "mask", "axes": "bcyx"}],
            "weights": {"pytorch_state_dict": {"source": "weights.pt"}},
        }
        p = tmp_path / "rdf.yaml"
        p.write_text(yaml.safe_dump(rdf))
        model = load_model_rdf(p)
        assert model.name == "test-unet"
        assert model.preferred_weights[0] == "pytorch_state_dict"
        assert model.inputs[0].preprocessing[0]["name"] == "zero_mean_unit_variance"

    def test_json_rdf_without_yaml(self, tmp_path, monkeypatch):
        rdf = {
            "type": "model", "name": "json-unet",
            "inputs": [{"name": "raw", "axes": "byxc"}],
            "outputs": [{"name": "mask", "axes": "byxc"}],
            "weights": {"jax_params": {"source": "weights.npz"}},
        }
        p = tmp_path / "rdf.yaml"
        p.write_text(json.dumps(rdf))
        monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml fails
        model = load_model_rdf(p)
        assert model.name == "json-unet" and model.inputs[0].axes == "byxc"
        p.write_text(yaml.safe_dump(rdf))  # block YAML is not JSON
        with pytest.raises(ValueError, match="PyYAML is not installed"):
            load_model_rdf(p)

    def test_to_from_nhwc_roundtrip(self):
        x = np.random.rand(2, 3, 10, 12).astype(np.float32)  # bcyx
        nhwc = to_nhwc(x, "bcyx")
        assert nhwc.shape == (2, 10, 12, 3)
        np.testing.assert_array_equal(from_nhwc(nhwc, "bcyx"), x)

    def test_volumetric_axes_roundtrip(self):
        assert canonical_layout("bczyx") == "bzyxc"
        assert canonical_layout("byxc") == "byxc"
        x = np.random.rand(2, 3, 5, 10, 12).astype(np.float32)  # bczyx
        vol = to_nhwc(x, "bczyx")
        assert vol.shape == (2, 5, 10, 12, 3)
        np.testing.assert_array_equal(from_nhwc(vol, "bczyx"), x)
        y = np.random.rand(4, 6, 8).astype(np.float32)
        assert to_nhwc(y, "bzyx").shape == (1, 4, 6, 8, 1)

    def test_unsupported_axes_rejected_loudly(self):
        with pytest.raises(ValueError, match="not support"):
            to_nhwc(np.zeros((1, 3, 2, 8, 9), np.float32), "btcyx")

    def test_axes_dict_form(self):
        axes = [
            {"type": "batch"},
            {"type": "channel"},
            {"type": "space", "id": "y"},
            {"type": "space", "id": "x"},
        ]
        assert _axes_string(axes) == "bcyx"

    def test_processing_ops(self):
        x = np.random.rand(1, 8, 8, 1).astype(np.float32) * 100
        out = apply_processing(x, [{"name": "zero_mean_unit_variance", "kwargs": {}}])
        assert abs(out.mean()) < 1e-4
        out2 = apply_processing(
            x, [{"name": "scale_range", "kwargs": {"min_percentile": 1, "max_percentile": 99}}]
        )
        assert out2.min() >= -0.1 and out2.max() <= 1.1
        sig = apply_processing(np.zeros((1, 2, 2, 1)), [{"name": "sigmoid"}])
        assert sig.dtype == np.float32 and np.all(sig == 0.5)
        with pytest.raises(NotImplementedError):
            apply_processing(x, [{"name": "nonexistent_op"}])


def test_flax_params_round_trip_through_a_port_written_package(tmp_path):
    """The port writes a jax_params package (reverse bridge + its own
    npz writer) that the JAX Pipeline serves with the same output."""
    from bioengine_tpu_torch.models.unet import UNet2D
    from bioengine_tpu_torch.runtime.convert import (
        flax_params_from_state_dict,
        save_params_npz as port_save,
        unflatten_params,
    )

    model = UNet2D(features=(4, 8), dtype=torch.float32)
    model.reset_parameters(9)
    flat = flax_params_from_state_dict(model.state_dict())
    d = tmp_path / "port-written"
    d.mkdir()
    port_save(str(d / "weights.npz"), unflatten_params(flat))
    (d / "rdf.yaml").write_text(json.dumps({
        "type": "model", "name": "port-written",
        "inputs": [{"name": "x", "axes": "byxc"}],
        "outputs": [{"name": "y", "axes": "byxc"}],
        "weights": {"jax_params": {"source": "weights.npz", "architecture": {
            "name": "unet2d", "kwargs": {"features": [4, 8], "dtype": "float32"},
        }}},
    }))
    x = np.random.default_rng(3).normal(size=(1, 64, 64, 1)).astype(np.float32)
    with torch.inference_mode():
        direct = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(_jax_predict(d, x), direct, rtol=0, atol=1e-4)
    assert set(flatten_params(unflatten_params(flat))) == set(flat)
