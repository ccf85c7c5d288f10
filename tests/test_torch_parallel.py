"""The port's data parallelism (``bioengine_tpu_torch/parallel/``) against
the JAX package's on the CPU.

JAX runs on the 8 forced host devices of ``tests/conftest.py``; the port's
CPU mesh of width N is N entries of ``cpu``, one process driving them, each
entry a replica. Held against JAX on the same inputs and bridged weights:

- ``MeshSpec``/``VirtualMeshSpec`` answers and errors, ``per_device_batch``,
  ``MeshConfig.mesh_shape``, ``resolve_devices`` (``TestResolveDevices``);
- the dp train step against ``jit_data_parallel_step`` on a dp mesh of 4
  and of 8, in ``tests/test_parallel.py``'s setup (CellposeNet (4, 8), f32,
  SGD 1e-2, 8 x 16^2): loss within rtol 2e-4, parameters within rtol 1e-4,
  atol 1e-6; the same for StarDist's ratio loss;
- the dp = 4 engine against JAX's dp = 4 engine in
  ``tests/test_sharded_engine.py``'s cases, f32 within 1e-4 max-abs
  (``test_torch_engine.py``'s: the two sides differ only in summation
  order inside the model);
- the embedder at dp = 4 against the JAX embedder, a narrow f32 ViT, min
  cosine 0.9999 (``test_torch_cell_image_search.py``'s bound);
- a cellpose session on an 8-id lease against the JAX app on its 8
  devices, losses within rtol 0.02 (``test_torch_cellpose_finetuning.py``'s);
- the model-runner's ``RuntimeDeployment`` on a K-chip lease beside
  ``tests/test_sharded_engine.py``'s ``MeshAwareApp``: the lease reaches the
  instance as a dp mesh, and a killed replica returns every chip.
"""

import asyncio
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu.models.cellpose import CellposeNet as JaxCellposeNet
from bioengine_tpu.models.cellpose import TrainState as JaxTrainState
from bioengine_tpu.models.cellpose import make_train_step as jax_make_train_step
from bioengine_tpu.models.stardist import StarDist2D as JaxStarDist2D
from bioengine_tpu.models.stardist import make_stardist_train_step as jax_make_stardist_train_step
from bioengine_tpu.models.unet import UNet2D as JaxUNet2D
from bioengine_tpu.models import vit as jax_vit
from bioengine_tpu.parallel import data_parallel as jax_dp
from bioengine_tpu.parallel import mesh as jax_mesh
from bioengine_tpu.runtime.convert import save_params_npz
from bioengine_tpu.runtime.engine import EngineConfig as JaxEngineConfig
from bioengine_tpu.runtime.engine import InferenceEngine as JaxEngine
from bioengine_tpu.runtime.engine import resolve_devices as jax_resolve_devices
from bioengine_tpu.runtime.program_cache import CompiledProgramCache as JaxCache
from bioengine_tpu.serving.mesh_plan import MeshConfig as JaxMeshConfig
from bioengine_tpu_torch.apps.cell_image_search.embedder import ViTEmbedder
from bioengine_tpu_torch.apps.cellpose_finetuning.service import CellposeFinetune
from bioengine_tpu_torch.models.cellpose import CellposeNet, TrainState, make_train_step
from bioengine_tpu_torch.models.stardist import StarDist2D, make_stardist_train_step
from bioengine_tpu_torch.models.unet import UNet2D
from bioengine_tpu_torch.parallel import data_parallel as dp
from bioengine_tpu_torch.parallel import mesh
from bioengine_tpu_torch.parallel.tensor_parallel import CONV_TP_RULES
from bioengine_tpu_torch.runtime import convert
from bioengine_tpu_torch.runtime.buckets import bucket_batch
from bioengine_tpu_torch.runtime.checkpoints import CheckpointService
from bioengine_tpu_torch.runtime.devices import resolve_devices
from bioengine_tpu_torch.runtime.engine import EngineConfig, InferenceEngine
from bioengine_tpu_torch.runtime.program_cache import CompiledProgramCache
from bioengine_tpu_torch.serving.mesh_plan import MeshConfig

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-4, 1e-6
ENGINE_TOL = dict(rtol=1e-5, atol=1e-4)


def cpu_mesh(n: int, axis: str = "dp") -> mesh.Mesh:
    return mesh.make_mesh({axis: n}, ["cpu"] * n)


def outcome(fn, *args):
    """(answer) or (error type, message), to compare both packages'."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001
        return (type(e).__name__, str(e))


# ---- mesh specs, shards ---------------------------------------------------------

RESOLVE_CASES = [
    ({"dp": -1}, 8), ({"dp": -1}, 1), ({"dp": 2, "tp": -1}, 8), ({"dp": 4, "tp": 2}, 8),
    ({"dp": 2, "sp": 2, "tp": -1}, 8), ({"dp": 3}, 8), ({"dp": 4}, 8), ({"dp": -1, "tp": -1}, 8),
    ({"tp": 3, "dp": -1}, 6), ({"tp": 3, "dp": -1}, 8),
]


@pytest.mark.parametrize("axes, n", RESOLVE_CASES)
def test_mesh_spec_resolve_matches_jax(axes, n):
    ours = outcome(lambda: mesh.MeshSpec(axes).resolve(n))
    assert ours == outcome(lambda: jax_mesh.MeshSpec(axes).resolve(n))
    if ours[0] == "ok":
        assert list(ours[1]) == list(axes)  # axis order kept


@pytest.mark.parametrize("stages, axes", [(1, None), (2, None), (3, {"dp": -1, "tp": 2}), (2, {"tp": 4})])
def test_virtual_mesh_spec_matches_jax(stages, axes):
    kw = {"stages": stages} if axes is None else {"stages": stages, "axes": axes}
    ours, ref = mesh.VirtualMeshSpec(**kw), jax_mesh.VirtualMeshSpec(**kw)
    for n in (1, 2, 4, 6, 8):
        assert outcome(ours.stage_axes, n) == outcome(ref.stage_axes, n)
        assert outcome(ours.shape, n) == outcome(ref.shape, n)


@pytest.mark.parametrize("cfg", [
    {"stages": 3, "chips_per_stage": 2, "axes": {"dp": -1, "tp": 2}},
    {"stages": 1, "chips_per_stage": 4},
    {"stages": 2, "chips_per_stage": 8, "kind": "dp", "axes": {"dp": 2, "tp": -1}},
])
def test_mesh_config_mesh_shape_matches_jax(cfg):
    ours, ref = MeshConfig.from_config(cfg), JaxMeshConfig.from_config(cfg)
    assert ours.mesh_shape() == ref.mesh_shape()
    for n in (2, 4, 8):
        assert outcome(ours.mesh_shape, n) == outcome(ref.mesh_shape, n)
    with pytest.raises(ValueError, match="do not resolve"):
        MeshConfig.from_config({"chips_per_stage": 3, "axes": {"dp": 2}})


def test_mesh_and_per_device_batch_match_jax():
    for n in (1, 2, 4, 8):
        ours, ref = cpu_mesh(n), jax_mesh.make_mesh({"dp": n}, jax.devices()[:n])
        assert ours.shape == dict(ref.shape) and ours.size == n
        for b in (8, 11, 16, 3):
            assert outcome(dp.per_device_batch, b, ours) == outcome(jax_dp.per_device_batch, b, ref)
    grid = mesh.make_mesh({"dp": 2, "tp": -1}, ["cpu"] * 8)
    assert grid.shape == {"dp": 2, "tp": 4} and grid.axis_names == ("dp", "tp")
    assert mesh.local_device_mesh(4, device="cpu") == cpu_mesh(4)
    assert mesh.sharding(grid, "dp").spec == ("dp",) and mesh.replicated(grid).spec == ()


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh({"dp": -1})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.local_device_mesh(1)
    assert cpu_mesh(2).devices == (torch.device("cpu"),) * 2


def test_shard_batch_shapes_and_divisibility():
    m4 = cpu_mesh(4)
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(8, 16, 16, 2)).astype(np.float32), {"p": np.arange(8)})
    ours = dp.shard_batch(m4, batch)
    ref = jax_dp.shard_batch(jax_mesh.make_mesh({"dp": 4}, jax.devices()[:4]), batch)
    assert isinstance(ours, tuple) and isinstance(ours[0], dp.Shards) and isinstance(ours[1]["p"], dp.Shards)
    for leaf, jleaf in ((ours[0], ref[0]), (ours[1]["p"], ref[1]["p"])):
        jshards = sorted(jleaf.addressable_shards, key=lambda s: s.index[0].start or 0)
        assert [tuple(s.shape) for s in leaf] == [tuple(s.data.shape) for s in jshards]
        for s, js in zip(leaf, jshards):
            np.testing.assert_array_equal(s.numpy(), np.asarray(js.data))
        np.testing.assert_array_equal(leaf.gather().numpy(), np.asarray(jleaf))
    with pytest.raises(ValueError, match="does not divide"):
        dp.shard_batch(m4, np.zeros((6, 2)))
    with pytest.raises(ValueError):
        jax_dp.shard_batch(jax_mesh.make_mesh({"dp": 4}, jax.devices()[:4]), np.zeros((6, 2)))
    # over (dp 2, tp 2) the batch splits over dp and each part sits on
    # both entries of its tp group, in JAX's addressable_shards order
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    ours = dp.shard_batch(mesh.make_mesh({"dp": 2, "tp": 2}, ["cpu"] * 4), x)
    ref = jax_dp.shard_batch(jax_mesh.make_mesh({"dp": 2, "tp": 2}, jax.devices()[:4]), x)
    jshards = sorted(ref.addressable_shards, key=lambda s: s.device.id)
    assert [s.tolist() for s in ours] == [np.asarray(js.data).tolist() for js in jshards]
    np.testing.assert_array_equal(ours.gather().numpy(), x)


def test_replicate_gives_independent_replicas():
    m = cpu_mesh(3)
    module = CellposeNet(features=(4, 8), dtype=torch.float32)
    reps = dp.replicate(m, module)
    assert isinstance(reps, dp.Replicated) and len(reps) == 3 and reps[0] is module
    assert reps[1] is not reps[2] and reps[1].Conv_0.weight is not module.Conv_0.weight
    assert all(torch.equal(a, b) for r in reps[1:] for a, b in zip(module.parameters(), r.parameters()))
    tree = dp.replicate(m, {"w": torch.ones(2)})
    tree[0]["w"].add_(1)
    assert float(tree[1]["w"][0]) == 1.0


# ---- the dp train step against jit_data_parallel_step ---------------------------

def _batch(rng, n=8, size=16, stardist_rays=None):
    images = rng.normal(size=(n, size, size, 2)).astype(np.float32)
    if stardist_rays:
        prob = rng.random((n, size, size)).astype(np.float32)
        dist = (4 * rng.random((n, size, size, stardist_rays))).astype(np.float32)
        return images, prob, dist
    flows = rng.normal(size=(n, size, size, 2)).astype(np.float32)
    prob = rng.integers(0, 2, size=(n, size, size)).astype(np.float32)
    return images, flows, prob


def _models(kind):
    if kind == "cellpose":
        jax_model = JaxCellposeNet(features=(4, 8), dtype=jnp.float32)
        port = CellposeNet(features=(4, 8), dtype=torch.float32)
        return jax_model, port, jax_make_train_step, make_train_step, None
    jax_model = JaxStarDist2D(n_rays=8, features=(4, 8), dtype=jnp.float32)
    port = StarDist2D(n_rays=8, features=(4, 8), in_channels=2, dtype=torch.float32)
    return jax_model, port, jax_make_stardist_train_step, make_stardist_train_step, 8


@pytest.mark.parametrize("kind", ["cellpose", "stardist"])
@pytest.mark.parametrize("width", [4, 8])
def test_dp_step_matches_jit_data_parallel_step(kind, width):
    """``tests/test_parallel.py``'s dp guarantee, held across packages: one
    SGD step of the global batch, JAX's dp mesh against the port's."""
    jax_model, port, jax_make, make, rays = _models(kind)
    p0 = jax_model.init(jax.random.key(0), jnp.zeros((1, 16, 16, 2)))["params"]
    port.load_state_dict(convert.state_dict_from_flax(jax.tree.map(np.asarray, p0)))
    batch = _batch(np.random.default_rng(1), stardist_rays=rays)

    jmesh = jax_mesh.make_mesh({"dp": width}, jax.devices()[:width])
    jstep = jax_dp.jit_data_parallel_step(jax_make(), jmesh, donate_state=False)
    jstate = jax_dp.replicate(jmesh, JaxTrainState.create(jax_model.apply, p0, optax.sgd(1e-2)))
    jstate, jmetrics = jstep(jstate, *jax_dp.shard_batch(jmesh, tuple(jnp.asarray(a) for a in batch)))

    m = cpu_mesh(width)
    state = dp.replicate(m, TrainState(port, torch.optim.SGD(port.parameters(), lr=1e-2)))
    step = dp.data_parallel_step(make(), m)
    state, metrics = step(state, *dp.shard_batch(m, tuple(torch.from_numpy(a) for a in batch)))

    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=LOSS_RTOL)
    want = convert.state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    got = state.module.state_dict()
    assert got.keys() == want.keys() and state.step == 1
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)
    for replica in state.replicas[1:]:
        assert all(torch.equal(a, b) for a, b in zip(state.module.parameters(), replica.parameters()))


@pytest.mark.parametrize("kind", ["cellpose", "stardist"])
def test_dp_step_is_the_step_of_the_global_batch(kind):
    """The port's dp = 4 step against its own single-device step over 3
    SGD steps (StarDist's ``mae`` is a ratio of sums over the batch, so a
    mean of shard losses would differ; SGD, as ``tests/test_parallel.py``
    says, because Adam turns last-bit differences of near-zero gradients
    into sign flips); the replicas bit-equal after every step; dp = 1
    through the mesh bit for bit the single step."""
    _, port, _, make, rays = _models(kind)
    port.reset_parameters(3)
    batches = [_batch(np.random.default_rng(s), stardist_rays=rays) for s in range(3)]
    states = {}
    for name, width in (("single", None), ("dp1", 1), ("dp4", 4)):
        module = StarDist2D(n_rays=8, features=(4, 8), in_channels=2, dtype=torch.float32) \
            if kind == "stardist" else CellposeNet(features=(4, 8), dtype=torch.float32)
        module.load_state_dict(port.state_dict())
        state = TrainState(module, torch.optim.SGD(module.parameters(), lr=1e-2))
        step = make()
        if width:
            m = cpu_mesh(width)
            state, step = dp.replicate(m, state), dp.data_parallel_step(step, m)
        losses = []
        for b in batches:
            state, metrics = step(state, *(torch.from_numpy(a) for a in b))
            losses.append(float(metrics["loss"]))
            if width:
                for replica in state.replicas[1:]:
                    assert all(torch.equal(a, r) for a, r in zip(state.module.parameters(), replica.parameters()))
        states[name] = (state, losses)
    single, dp1, dp4 = states["single"], states["dp1"], states["dp4"]
    assert dp1[1] == single[1]
    assert all(torch.equal(a, b) for a, b in zip(single[0].module.parameters(), dp1[0].module.parameters()))
    np.testing.assert_allclose(dp4[1], single[1], rtol=LOSS_RTOL)
    for a, b in zip(single[0].module.parameters(), dp4[0].module.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_dp_step_refuses_an_unreplicated_state():
    m = cpu_mesh(2)
    step = dp.data_parallel_step(make_train_step(), m)
    module = CellposeNet(features=(4, 8), dtype=torch.float32)
    with pytest.raises(TypeError, match="replicate"):
        step(TrainState.create(module, 1e-3, 0.0), *(torch.from_numpy(a) for a in _batch(np.random.default_rng(0))))


def test_checkpoint_restore_onto_replicas(tmp_path):
    """``tests/test_runtime.py``'s restore onto a dp-replicated template:
    every replica filled, each on its mesh entry, AdamW moments included."""
    m = cpu_mesh(4)
    module = CellposeNet(features=(4, 8), dtype=torch.float32)
    module.reset_parameters(1)
    state = dp.replicate(m, TrainState.create(module, 1e-3, 1e-4))
    step = dp.data_parallel_step(make_train_step(), m)
    state, _ = step(state, *(torch.from_numpy(a) for a in _batch(np.random.default_rng(2))))
    with CheckpointService(tmp_path / "ckpt") as ckpt:
        ckpt.save(7, state)
        ckpt.wait()
        fresh = CellposeNet(features=(4, 8), dtype=torch.float32)
        fresh.reset_parameters(9)
        template = dp.replicate(m, TrainState.create(fresh, 1e-3, 1e-4))
        restored = ckpt.restore(7, template)
        modules = ckpt.restore(7, dp.replicate(m, CellposeNet(features=(4, 8), dtype=torch.float32)))
    assert restored is template and restored.step == 1 and len(restored.replicas) == 4
    for replica in (*restored.replicas, *modules):
        assert all(torch.equal(a, b) for a, b in zip(state.module.parameters(), replica.parameters()))
    want, got = state.optimizer.state_dict()["state"], restored.optimizer.state_dict()["state"]
    assert want.keys() == got.keys()
    assert all(torch.equal(want[i][k], got[i][k]) for i in want for k in ("exp_avg", "exp_avg_sq"))


# ---- the engine against JAX's sharded engine -------------------------------------

@pytest.fixture(scope="module")
def unet():
    jax_model = JaxUNet2D(features=(4, 8), out_channels=1, dtype=jnp.float32)
    params = seeded_flax_params(jax_model, (1, 64, 64, 1), seed=0)
    port = UNet2D(features=(4, 8), out_channels=1, in_channels=1, dtype=torch.float32)
    port.load_state_dict(convert.state_dict_from_flax(params))
    return jax_model, params, port


def _engines(unet, width, config=None, cache=None):
    jax_model, params, port = unet
    jax_engine = JaxEngine(
        "sharded-test", lambda p, x: jax_model.apply({"params": p}, x), params,
        divisor=jax_model.divisor if hasattr(jax_model, "divisor") else 2,
        config=JaxEngineConfig(**config) if config else None,
        cache=JaxCache(), devices=jax.devices()[:width],
    )
    ours = InferenceEngine(
        "sharded-test", port, divisor=port.divisor, config=EngineConfig(**config) if config else None,
        cache=cache if cache is not None else CompiledProgramCache(), devices=["cpu"] * width,
    )
    return jax_engine, ours


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(7).standard_normal((3, 70, 70, 1)).astype(np.float32)


@pytest.mark.parametrize("case", ["planar", "tiled", "serial_tiled"])
def test_dp4_engine_matches_jax(unet, images, case):
    config = {"planar": None, "tiled": dict(max_tile=64, tile=48, tile_overlap=8, tile_batch=4),
              "serial_tiled": dict(max_tile=64, tile=48, tile_overlap=8, pipeline_depth=0)}[case]
    jax_engine, ours = _engines(unet, 4, config)
    try:
        assert ours.mesh_shape == jax_engine.mesh_shape == {"dp": 4}
        run = (lambda e: e.predict_serial(images)) if case == "serial_tiled" else (lambda e: e.predict(images))
        got, want = run(ours), run(jax_engine)
        assert got.shape == want.shape == images.shape
        np.testing.assert_allclose(got, want, **ENGINE_TOL)
        # and against the port's own one-device engine
        one = InferenceEngine("one", unet[2], divisor=2, config=EngineConfig(**config) if config else None,
                              cache=CompiledProgramCache(), device="cpu")
        np.testing.assert_allclose(got, run(one), **ENGINE_TOL)
    finally:
        jax_engine.close()
        ours.close()


def test_uneven_batch_pads_to_dp_multiple_and_crops(unet):
    jax_engine, ours = _engines(unet, 4)
    try:
        rng = np.random.default_rng(0)
        for b in (1, 3, 5):
            x = rng.standard_normal((b, 64, 64, 1)).astype(np.float32)
            got = ours.predict(x)
            assert got.shape[0] == b
            np.testing.assert_allclose(got, jax_engine.predict(x), **ENGINE_TOL)
        ours_dims = {key[1] for key in ours.cache.keys() if key[-1].split("@")[0] == "dp4"}
        jax_dims = {key[1] for key in jax_engine.cache._programs if key[-1].split("@")[0] == "dp4"}
        assert ours_dims == jax_dims == {4, 8}
        assert [bucket_batch(b, multiple_of=4) for b in (1, 3, 5)] == [4, 4, 8]
    finally:
        jax_engine.close()
        ours.close()


def test_dp_padding_rows_do_not_contaminate(unet):
    _, ours = _engines(unet, 4)
    x4 = np.random.default_rng(1).standard_normal((4, 64, 64, 1)).astype(np.float32)
    full = ours.predict(x4)
    np.testing.assert_allclose(ours.predict(x4[:3]), full[:3], rtol=1e-6, atol=1e-7)


def test_program_keys_separate_per_mesh_shape_and_device_group(unet, images):
    cache = CompiledProgramCache()
    port = unet[2]
    e1 = InferenceEngine("keys", port, divisor=2, cache=cache, device="cpu")
    e4 = InferenceEngine("keys", port, divisor=2, cache=cache, device_ids=[0, 1, 2, 3], device="cpu")
    e4b = InferenceEngine("keys", port, divisor=2, cache=cache, device_ids=[4, 5, 6, 7], device="cpu")
    e1.predict(images)
    e4.predict(images)
    e4b.predict(images)
    tags = sorted(key[-1].split("@")[0] for key in cache.keys())
    assert tags == ["1dev", "dp4", "dp4"]
    assert len({key[1:-2] for key in cache.keys() if key[-1].startswith("dp4")}) == 1
    assert cache.stats.misses == 3
    # a program reads its engine's replicas' parameters: never shared
    assert len({key[-1] for key in cache.keys()}) == 3
    d = e4.describe()
    assert d["mesh"] == {"dp": 4} and d["device_ids"] == [0, 1, 2, 3] and len(d["per_chip"]) == 4
    assert e4b.describe()["device_ids"] == [4, 5, 6, 7]
    e4.close()
    assert sorted(key[-1].split("@")[0] for key in cache.keys()) == ["1dev", "dp4"]


def test_engine_mesh_axes():
    fn = UNet2D(features=(4, 8), out_channels=1, in_channels=1, dtype=torch.float32)
    eng = InferenceEngine("axes", fn, divisor=2, devices=["cpu"] * 4, mesh_axes={"dp": -1},
                          cache=CompiledProgramCache())
    assert eng.mesh_shape == {"dp": 4} and eng.dp == 4
    with pytest.raises(ValueError, match="unsupported engine axes"):
        InferenceEngine("axes", fn, devices=["cpu"] * 4, mesh_axes={"sp": -1})
    # a tp axis needs rules, as in the JAX engine; with them the group is
    # a (dp, tp) mesh (the tp cases: test_torch_parallel_layer.py)
    with pytest.raises(ValueError, match="without tp_rules"):
        InferenceEngine("axes", fn, devices=["cpu"] * 4, mesh_axes={"dp": -1, "tp": 2})
    tp_eng = InferenceEngine("axes", fn, divisor=2, devices=["cpu"] * 4, mesh_axes={"dp": -1, "tp": 2},
                             tp_rules=CONV_TP_RULES, cache=CompiledProgramCache())
    assert tp_eng.mesh_shape == {"dp": 2, "tp": 2} and (tp_eng.dp, tp_eng.tp) == (2, 2)
    with pytest.raises(ValueError, match="not divisible"):
        InferenceEngine("axes", fn, devices=["cpu"] * 4, mesh_axes={"dp": 3})
    assert InferenceEngine("axes", fn, device="cpu", mesh_axes={"dp": -1}).mesh_shape is None


# ---- resolve_devices: TestResolveDevices ------------------------------------------

@pytest.mark.parametrize("ids", [
    [2, 0], [1001, 1002, 1003, 1004], list(range(1000, 1099)), list(range(99)), None, [], [7], [0, 1, 2, 3],
])
def test_resolve_devices_matches_jax(ids):
    """On the CPU the port's answer is JAX's width on its 8 forced devices,
    every entry ``cpu``, and its errors are JAX's."""
    ours = outcome(resolve_devices, ids, "cpu")
    ref = outcome(jax_resolve_devices, ids)
    if ref[0] == "ok":
        assert ours == ("ok", [torch.device("cpu")] * len(ref[1]))
    else:
        assert ours == ref


def test_resolve_devices_on_cuda_never_remaps(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_devices([1, 0], "cuda") == [torch.device("cuda", 1), torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="numbering conflict"):
        resolve_devices([1, 2], "cuda")
    with pytest.raises(ValueError, match="refusing to remap"):
        resolve_devices([5, 6], "cuda")
    with pytest.raises(ValueError, match="repeat"):
        resolve_devices([1, 1], "cuda")


# ---- the embedder and the fine-tuning app --------------------------------------------

TINY_VIT = dict(patch_size=28, dim=64, depth=2, num_heads=2)


def _load_app_module(stem, app):
    if stem in sys.modules:
        return sys.modules[stem]
    spec = importlib.util.spec_from_file_location(stem, REPO / "apps" / app / f"{stem}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[stem] = module
    spec.loader.exec_module(module)
    return module


def test_embedder_dp4_matches_jax(tmp_path, monkeypatch):
    """Both embedders see 8 devices and a bucket of 4: dp = 4 on each."""
    _load_app_module("normalizer", "cell-image-search")
    jax_embedder = _load_app_module("embedder", "cell-image-search")
    weights = str(tmp_path / "vit.npz")
    save_params_npz(weights, seeded_flax_params(jax_vit.ViT(**TINY_VIT, dtype=jnp.float32), (1, 224, 224, 3), seed=5))
    wide = jax_vit.ViT
    monkeypatch.setattr(jax_vit, "ViT", lambda **kw: wide(**{**kw, **TINY_VIT, "dtype": jnp.float32}))
    rng = np.random.default_rng(3)
    crops = [rng.gamma(2.0, 300.0, size=(224, 224, 2)).astype(np.uint16) for _ in range(10)]
    ref = jax_embedder.ViTEmbedder(weights_path=weights, batch_bucket=4)
    want = ref.embed_batch(crops)
    ours = ViTEmbedder(weights_path=weights, batch_bucket=4, devices=["cpu"] * 8,
                       model_overrides={**TINY_VIT, "dtype": "float32"})
    got = ours.embed_batch(crops)
    assert dict(ref._mesh.shape) == {"dp": ours.dp} == {"dp": 4}
    assert got.shape == want.shape == (10, 64)
    assert np.sum(got * want, axis=1).min() >= 0.9999
    # the one-device embedder, the same weights: the shards change nothing
    one = ViTEmbedder(weights_path=weights, batch_bucket=4, device="cpu",
                      model_overrides={**TINY_VIT, "dtype": "float32"})
    np.testing.assert_allclose(got, one.embed_batch(crops), rtol=1e-5, atol=1e-6)
    assert ours.programs.keys()[0][1] == "cpu,cpu,cpu,cpu" and one.programs.keys()[0][1] == "cpu"
    assert len(ours._replicas) == 4 and ours.forward_count == 3


def test_cellpose_session_on_an_8_id_lease_matches_the_jax_app(tmp_path):
    """A session on a lease of 8 CPU ids trains at dp = 8, as the JAX app on
    its 8 forced devices does, from the same pretrained weights."""
    from test_torch_cellpose_finetuning import FAST_CFG, LOSS_RTOL as APP_LOSS_RTOL, _load_by_path, _train

    jax_model = JaxCellposeNet(features=(8, 16))
    init = jax.jit(jax_model.init)(jax.random.key(7), jnp.zeros((1, 32, 32, 2), jnp.float32))["params"]
    pretrained = tmp_path / "pretrained.npz"
    save_params_npz(str(pretrained), init)
    cfg = {**FAST_CFG, "pretrained_path": str(pretrained), "seed": 3, "batch_size": 8}
    jax_app = _load_by_path("jax_cellpose_app_dp", REPO / "apps" / "cellpose-finetuning" / "main.py")
    jax_app = jax_app.CellposeFinetune(sessions_root=str(tmp_path / "jax"))
    port_app = CellposeFinetune(sessions_root=str(tmp_path / "port"), device="cpu")
    port_app.bioengine_device_ids = list(range(8))

    async def drive():
        await port_app.async_init()
        return await _train(jax_app, "dp", config=cfg), await _train(port_app, "dp", config=cfg)

    jax_final, port_final = asyncio.run(drive())
    assert len(port_app.devices) == 8
    assert jax_final["status"] == port_final["status"] == "completed", (jax_final, port_final)
    assert jax_final["mesh"] == port_final["mesh"] == {"dp": 8}
    np.testing.assert_allclose(port_final["losses"], jax_final["losses"], rtol=APP_LOSS_RTOL)


# ---- the model-runner's lease: TestShardedReplicaLifecycle ----------------------

def _planes():
    """(name, ServeController over an explicit 8-chip CPU topology,
    DeploymentSpec, ReplicaState, instance factory) for each package: the
    JAX test's ``MeshAwareApp`` and the port's ``RuntimeDeployment``."""
    from bioengine_tpu.cluster.state import ClusterState as JaxClusterState
    from bioengine_tpu.cluster.topology import ChipInfo, TpuTopology
    from bioengine_tpu import serving as jax_serving
    from bioengine_tpu_torch.apps.model_runner.runtime import RuntimeDeployment
    from bioengine_tpu_torch.cluster.state import ClusterState
    from bioengine_tpu_torch.cluster.topology import detect_topology
    from bioengine_tpu_torch import serving
    from test_sharded_engine import MeshAwareApp

    topo = TpuTopology(chips=tuple(ChipInfo(device_id=i, platform="cpu", kind="virtual", process_index=0)
                                   for i in range(8)), n_hosts=1, platform="cpu")
    return [
        ("jax", jax_serving.ServeController(JaxClusterState(topo), health_check_period=3600),
         jax_serving.DeploymentSpec, jax_serving.ReplicaState, MeshAwareApp),
        ("torch", serving.ServeController(ClusterState(detect_topology(device="cpu", n_devices=8)),
                                          health_check_period=3600),
         serving.DeploymentSpec, serving.ReplicaState, lambda: RuntimeDeployment(device="cpu")),
    ]


@pytest.mark.anyio
@pytest.mark.parametrize("chips", [4, 2])
async def test_the_lease_reaches_the_runtime_as_a_mesh(chips):
    """A K-chip replica's lease reaches the instance, and its describe and
    the app status carry the dp mesh, on both planes."""
    seen = {}
    for name, controller, Spec, _, factory in _planes():
        try:
            app = await controller.deploy(
                "mesh-app", [Spec(name="rt", instance_factory=factory, chips_per_replica=chips, autoscale=False)])
            replica = app.replicas["rt"][0]
            mesh = replica.describe()["mesh"]
            [shape] = controller.get_app_status("mesh-app")["deployments"]["rt"]["mesh_shapes"].values()
            seen[name] = (len(replica.device_ids), mesh["mesh_shape"], shape)
            if name == "torch":
                assert mesh["lease"] == list(replica.device_ids)
                assert replica.instance._devices == [torch.device("cpu")] * chips
        finally:
            await controller.stop()
    assert seen["torch"] == seen["jax"] == (chips, {"dp": chips}, {"dp": chips})


@pytest.mark.anyio
async def test_a_killed_dp_replica_returns_every_chip():
    """Kill a 4-chip replica: all 4 chips come back, the restarted replica
    leases 4 again, the undeploy leaks nothing; on both planes."""
    seen = {}
    for name, controller, Spec, State, factory in _planes():
        state = controller.cluster_state
        try:
            app = await controller.deploy(
                "mesh-app3", [Spec(name="rt", instance_factory=factory, chips_per_replica=4, autoscale=False)])
            free = [state.free_chips()]
            old = app.replicas["rt"][0]
            old.state = State.UNHEALTHY
            await controller.health_tick()
            await asyncio.sleep(0.05)
            new = app.replicas["rt"][0]
            assert new.replica_id != old.replica_id
            free.append(state.free_chips())
            await controller.undeploy("mesh-app3")
            free.append(state.free_chips())
            seen[name] = (len(old.device_ids), len(new.device_ids), free)
            if name == "torch":
                assert new.instance.mesh_info()["mesh_shape"] == {"dp": 4}
        finally:
            await controller.stop()
    assert seen["torch"] == seen["jax"] == (4, 4, [4, 4, 8])
