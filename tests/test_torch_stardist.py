"""The PyTorch port's StarDist family against the JAX package: ``StarDist2D``
against flax on bridged weights, ``stardist_loss`` and its gradients
against ``jax.grad``, the train step's AdamW against ``optax.adamw``, the
host polygon ops of ``ops/stardist.py`` bit for bit, the registry name,
the model served by both runtimes, and the stardist cases of
``tests/test_models.py`` and ``tests/test_bundled_apps.py``
(``TestStardistBackbone``, ``test_stardist_export_roundtrips_through_
model_runner``) on ``CellposeFinetune(device="cpu")``, beside the JAX app
loaded by file.

Tolerances: f32 forward to 1e-5 max-abs (measured 4.8e-6: the same f32
arithmetic in another summation order). bf16 forward to 10% of the
output's largest magnitude, as the U-Nets are held (measured ~1.4%: XLA's
fused CPU program keeps some bf16 intermediates in f32). The loss and its
parts to 2e-6 relative of the JAX function's f32 reduction. f32 gradients
to 1e-4 of the largest gradient. The train step's parameter update to
1e-6 of ``optax.adamw`` given the step's own gradients. The host ops are
numpy copies and held bit for bit. Two apps trained from one
``pretrained_path`` with one seed draw identical tiles; their per-epoch
losses agree to 2% (bf16 rounding, as for the cellpose backbones; measured
2.3e-5 and 1.8e-5 relative over two epochs).
"""

import asyncio
import importlib.util
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu.models import get_model as jax_get_model
from bioengine_tpu.models.stardist import StarDist2D as JaxStarDist2D
from bioengine_tpu.models.stardist import stardist_loss as jax_stardist_loss
from bioengine_tpu.ops import stardist as jax_ops
from bioengine_tpu.runtime import convert as jax_convert
from bioengine_tpu_torch.apps.cellpose_finetuning import service
from bioengine_tpu_torch.apps.cellpose_finetuning.service import CellposeFinetune
from bioengine_tpu_torch.apps.model_runner.entry import EntryDeployment
from bioengine_tpu_torch.apps.model_runner.runtime import RuntimeDeployment
from bioengine_tpu_torch.models import registry
from bioengine_tpu_torch.models.cellpose import TrainState
from bioengine_tpu_torch.models.stardist import StarDist2D, make_stardist_train_step, stardist_loss
from bioengine_tpu_torch.ops import stardist as ops
from bioengine_tpu_torch.runtime import convert
from bioengine_tpu_torch.runtime.rdf import load_model_rdf

REPO = Path(__file__).resolve().parent.parent
FEATURES = (8, 16, 32)
N_RAYS = 8
SHAPE = (2, 32, 32, 2)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LOSS_RTOL = 0.02


def _load_by_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port(params, dtype):
    model = StarDist2D(n_rays=N_RAYS, features=FEATURES, in_channels=SHAPE[-1], dtype=dtype)
    model.load_state_dict(convert.state_dict_from_flax(params))
    return model


def _targets(seed=2):
    """Two disks' prob and ray targets, tiled over the batch."""
    masks = np.zeros(SHAPE[1:3], np.int32)
    yy, xx = np.mgrid[: SHAPE[1], : SHAPE[2]]
    masks[(yy - 10) ** 2 + (xx - 12) ** 2 < 36] = 1
    masks[(yy - 22) ** 2 + (xx - 20) ** 2 < 49] = 2
    prob, dist = ops.masks_to_stardist(masks, n_rays=N_RAYS)
    rng = np.random.default_rng(seed)
    prob = np.stack([prob, np.flipud(prob)]).astype(np.float32)
    dist = np.stack([dist, dist[::-1] + rng.uniform(0, 1, dist.shape)]).astype(np.float32)
    return prob, dist


# ---- the model, its loss and its train step against JAX --------------------------


@pytest.fixture(scope="module")
def init_params():
    """flax ``init`` of StarDist2D: its tree is the one every dtype builds
    (parameters are f32 whatever the compute dtype)."""
    model = JaxStarDist2D(n_rays=N_RAYS, features=FEATURES, in_channels=2)
    return jax.jit(model.init)(jax.random.key(0), jnp.zeros(SHAPE, jnp.float32))["params"]


@pytest.mark.parametrize("init", ["init", "seeded"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stardist_matches_flax(dtype, init, init_params):
    jdt, tdt = DTYPES[dtype]
    jax_model = JaxStarDist2D(n_rays=N_RAYS, features=FEATURES, in_channels=2, dtype=jdt)
    if init == "init":
        params = init_params
    else:
        params = seeded_flax_params(jax_model, SHAPE, seed=3)
    x = _inputs(SHAPE)
    ref = np.asarray(jax.jit(jax_model.apply)({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        out = _port(params, tdt).eval()(torch.from_numpy(x)).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape == SHAPE[:3] + (1 + N_RAYS,)
    assert out[..., 1:].min() >= 0.0
    if dtype == "f32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    else:
        assert np.abs(out - ref).max() <= 0.1 * np.abs(ref).max()


def test_module_tree_follows_flax_creation_order():
    jax_model = JaxStarDist2D(n_rays=N_RAYS, features=FEATURES)
    flat = jax_convert.flatten_params(seeded_flax_params(jax_model, SHAPE, seed=0))
    model = StarDist2D(n_rays=N_RAYS, features=FEATURES, in_channels=2)
    assert [n for n, _ in model.named_children()] == [
        "ConvBlock_0", "ConvBlock_1", "ConvBlock_2", "ConvBlock_3", "ConvBlock_4",
        "ConvTranspose_0", "ConvTranspose_1", "prob_head", "dist_head",
    ]
    state = convert.state_dict_from_flax(flat)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()
    }
    back = convert.flax_params_from_state_dict(model.state_dict())
    assert {k: v.shape for k, v in back.items()} == {k: v.shape for k, v in flat.items()}
    assert flat["dist_head/kernel"].shape == (1, 1, 8, N_RAYS)
    assert model.divisor == 4 and model.n_rays == N_RAYS
    assert model.prob_head.dtype == model.dist_head.dtype == torch.float32


def test_softplus_is_flax_logaddexp():
    """Flax's softplus is logaddexp(x, 0), which the port computes;
    ``F.softplus`` would return x itself above 20, where log1p(exp(-x)) <
    2.1e-9 is already below half an f32 ulp of x."""
    x = np.array([-40.0, -3.0, 0.0, 3.0, 19.5, 20.5, 40.0], np.float32)
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    model = StarDist2D(n_rays=len(x), features=(4, 8), in_channels=1, dtype=torch.float32)
    with torch.no_grad():
        model.dist_head.weight.zero_()
        model.dist_head.bias.copy_(torch.from_numpy(x))
        got = model._head(torch.zeros(1, 4, 1, 1))[0, 1:, 0, 0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=0)


def test_stardist_loss_matches_jax():
    rng = np.random.default_rng(0)
    pred = np.concatenate(
        [rng.normal(0, 3, SHAPE[:3] + (1,)), rng.uniform(0, 12, SHAPE[:3] + (N_RAYS,))], -1
    ).astype(np.float32)
    prob, dist = _targets()
    ref_loss, ref_parts = jax_stardist_loss(*(jnp.asarray(a) for a in (pred, prob, dist)))
    loss, parts = stardist_loss(*(torch.from_numpy(a) for a in (pred, prob, dist)))
    assert set(parts) == set(ref_parts) == {"bce_loss", "dist_loss"}
    assert abs(loss.item() - float(ref_loss)) <= 2e-6 * abs(float(ref_loss))
    for k in parts:
        assert abs(parts[k].item() - float(ref_parts[k])) <= 2e-6 * abs(float(ref_parts[k]))
    # an all-background batch: the MAE's denominator is the 1e-6 alone
    zero = np.zeros_like(prob)
    ref0 = jax_stardist_loss(*(jnp.asarray(a) for a in (pred, zero, dist)))[1]["dist_loss"]
    got0 = stardist_loss(*(torch.from_numpy(a) for a in (pred, zero, dist)))[1]["dist_loss"]
    assert float(ref0) == got0.item() == 0.0


def test_f32_gradients_match_jax_grad():
    jax_model = JaxStarDist2D(n_rays=N_RAYS, features=FEATURES, dtype=jnp.float32)
    params = seeded_flax_params(jax_model, SHAPE, seed=4)
    x = _inputs(SHAPE)
    prob, dist = _targets()

    def loss_fn(p):
        pred = jax_model.apply({"params": p}, jnp.asarray(x))
        return jax_stardist_loss(pred, jnp.asarray(prob), jnp.asarray(dist))[0]

    ref = convert.state_dict_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params)))
    model = _port(params, torch.float32)
    loss, _ = stardist_loss(model(torch.from_numpy(x)), torch.from_numpy(prob), torch.from_numpy(dist))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert grads.keys() == ref.keys()
    scale = max(g.abs().max().item() for g in ref.values())
    err = max((grads[k] - ref[k]).abs().max().item() for k in ref)
    assert err <= 1e-4 * scale, (err, scale)


def test_train_step_update_is_optax_adamw():
    """One ``make_stardist_train_step`` step moves the parameters as
    ``optax.adamw`` moves them on the step's own gradients."""
    jax_model = JaxStarDist2D(n_rays=N_RAYS, features=FEATURES, dtype=jnp.float32)
    params = seeded_flax_params(jax_model, SHAPE, seed=5)
    model = _port(params, torch.float32)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    lr, wd = 1e-2, 1e-2
    state = TrainState.create(model, lr, wd)
    prob, dist = _targets()
    state, metrics = make_stardist_train_step()(
        state, *(torch.from_numpy(a) for a in (_inputs(SHAPE), prob, dist)))
    assert set(metrics) == {"loss", "bce_loss", "dist_loss"} and state.step == 1
    p0 = {k: jnp.asarray(v.numpy()) for k, v in before.items()}
    g = {k: jnp.asarray(p.grad.numpy()) for k, p in model.named_parameters()}
    tx = optax.adamw(lr, weight_decay=wd)
    want = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(g, p0)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=0, atol=1e-6)


def test_stardist_train_step_reduces_loss():
    """``tests/test_models.py``'s case: 8 Adam steps at lr 1e-3 on a disk."""
    masks = np.zeros((32, 32), np.int32)
    yy, xx = np.mgrid[:32, :32]
    masks[(yy - 16) ** 2 + (xx - 16) ** 2 < 64] = 1
    prob_t, dist_t = ops.masks_to_stardist(masks, n_rays=8)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        ((masks > 0)[None, ..., None] + 0.05 * rng.normal(size=(2, 32, 32, 1))).astype(np.float32))
    prob = torch.from_numpy(prob_t).expand(2, 32, 32)
    dist = torch.from_numpy(dist_t).expand(2, 32, 32, 8)
    model = StarDist2D(n_rays=8, features=(8, 16))
    model.reset_parameters(0)
    state = TrainState.create(model, 1e-3, 0.0)  # AdamW without decay is Adam
    step = make_stardist_train_step()
    losses = []
    for _ in range(8):
        state, metrics = step(state, images, prob, dist)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses


def test_registry_builds_stardist2d():
    model = registry.get_model("stardist2d", n_rays=16, features=(8, 16))
    assert isinstance(model, StarDist2D) and model.divisor == 2
    model.reset_parameters(0)
    with torch.inference_mode():
        y = model(torch.zeros(2, 32, 32, 1))
    assert y.shape == (2, 32, 32, 17) and y.dtype == torch.float32
    assert float(y[..., 1:].min()) >= 0.0
    assert registry.get_model("stardist2d", dtype="float32").dtype == torch.float32


# ---- the host polygon ops, bit for bit ------------------------------------------


def _disks(size, centres_radii):
    masks = np.zeros((size, size), np.int32)
    yy, xx = np.mgrid[:size, :size]
    for lbl, (cy, cx, r) in enumerate(centres_radii, start=1):
        masks[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = lbl
    return masks


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_rays", [8, 32])
def test_ray_angles_and_targets_bit_for_bit(n_rays):
    _same(ops.ray_angles(n_rays), jax_ops.ray_angles(n_rays))
    masks = _disks(64, [(20, 20, 10), (44, 44, 8), (1, 50, 9)])
    for max_dist in (64, 6):
        got = ops.masks_to_stardist(masks, n_rays=n_rays, max_dist=max_dist)
        want = jax_ops.masks_to_stardist(masks, n_rays=n_rays, max_dist=max_dist)
        for a, b in zip(got, want):
            _same(a, b)
    prob, dist = got
    assert abs(dist[20, 20].mean() - min(10, max_dist)) < 2.5


def test_render_polygon_bit_for_bit():
    rng = np.random.default_rng(3)
    canvas = np.zeros((40, 40), np.int32)
    canvas[10:20, 10:20] = 7
    for cy, cx in ((15, 15), (0, 39), (30, 5)):
        dists = rng.uniform(2, 12, 16).astype(np.float32)
        a, b = canvas.copy(), canvas.copy()
        assert ops._render_polygon(a, cy, cx, dists, 3) == jax_ops._render_polygon(b, cy, cx, dists, 3)
        _same(a, b)


def test_targets_and_reconstruction_roundtrip():
    """``tests/test_models.py``'s two-disk round trip, through both."""
    masks = _disks(64, [(20, 20, 10), (44, 44, 8)])
    prob, dist = ops.masks_to_stardist(masks, n_rays=32)
    rec = ops.polygons_to_masks(prob, dist, prob_threshold=0.5)
    _same(rec, jax_ops.polygons_to_masks(prob, dist, prob_threshold=0.5))
    assert rec.max() == 2
    for lbl in (1, 2):
        ref = masks == lbl
        ious = [np.mean((rec == r) & ref) / max(np.mean((rec == r) | ref), 1e-9)
                for r in range(1, rec.max() + 1)]
        assert max(ious) > 0.75, (lbl, max(ious))


def test_border_cells_not_suppressed():
    masks = np.zeros((48, 48), np.int32)
    yy, xx = np.mgrid[:48, :48]
    masks[(yy - 1) ** 2 + (xx - 24) ** 2 < 81] = 1
    prob, dist = ops.masks_to_stardist(masks, n_rays=32)
    rec = ops.polygons_to_masks(prob, dist, prob_threshold=0.5)
    _same(rec, jax_ops.polygons_to_masks(prob, dist, prob_threshold=0.5))
    assert rec.max() == 1


def test_candidate_overflow_grid_subsamples():
    masks = np.zeros((96, 96), np.int32)
    yy, xx = np.mgrid[:96, :96]
    lbl = 0
    for cy in range(8, 96, 16):
        for cx in range(8, 96, 16):
            lbl += 1
            masks[(yy - cy) ** 2 + (xx - cx) ** 2 < 36] = lbl
    prob, dist = ops.masks_to_stardist(masks, n_rays=16)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rec = ops.polygons_to_masks(prob, dist, prob_threshold=0.1, max_candidates=50)
        want = jax_ops.polygons_to_masks(prob, dist, prob_threshold=0.1, max_candidates=50)
    assert [str(w.message) for w in caught if "grid-subsampled" in str(w.message)] and len(caught) == 2
    assert str(caught[0].message) == str(caught[1].message)
    _same(rec, want)
    assert rec.max() == lbl


def test_empty_and_logit_paths():
    empty = ops.polygons_to_masks(np.zeros((16, 16), np.float32), np.zeros((16, 16, 8), np.float32))
    assert empty.shape == (16, 16) and empty.max() == 0 and empty.dtype == np.int32
    pred = np.full((16, 16, 9), -10.0, np.float32)
    assert ops.predictions_to_masks_stardist(pred).max() == 0
    # a noisy prediction with rays: candidates, NMS and size filtering
    rng = np.random.default_rng(7)
    pred = np.concatenate(
        [rng.normal(0, 2, (48, 48, 1)), rng.uniform(0, 9, (48, 48, 16))], -1).astype(np.float32)
    for kw in ({}, {"prob_threshold": 0.9, "nms_iou_threshold": 0.1, "min_size": 4}):
        got = ops.predictions_to_masks_stardist(pred, **kw)
        _same(got, jax_ops.predictions_to_masks_stardist(pred, **kw))
    assert got.max() >= 1


# ---- StarDist2D through both model-runners ---------------------------------------


def test_stardist_package_served_by_port_and_jax_runtime(tmp_path):
    kw = {"n_rays": N_RAYS, "features": list(FEATURES)}
    jax_model = jax_get_model("stardist2d", **kw)
    x = _inputs((1, 64, 64, 2), seed=6)
    params = seeded_flax_params(jax_model, x.shape, seed=7)
    jax_convert.save_params_npz(str(tmp_path / "weights.npz"), params)
    (tmp_path / "rdf.yaml").write_text(yaml.safe_dump({
        "type": "model", "name": "Tiny StarDist",
        "inputs": [{"name": "input0", "axes": "byxc"}],
        "outputs": [{"name": "output0", "axes": "byxc"}],
        "weights": {"jax_params": {"source": "weights.npz",
                                   "architecture": {"name": "stardist2d", "kwargs": kw}}},
    }))
    deployment = RuntimeDeployment(device="cpu")

    async def drive():
        try:
            return await deployment.predict(str(tmp_path / "rdf.yaml"), {"input0": x})
        finally:
            await deployment.close()

    port = asyncio.run(drive())["output0"]
    jax_rt = _load_by_path("jax_mr_rt_stardist", REPO / "apps" / "model-runner" / "runtime_deployment.py")
    pipeline = jax_rt.Pipeline(tmp_path)
    try:
        ref = pipeline.predict(x)["output0"]
    finally:
        pipeline.close()
    assert port.shape == ref.shape == (1, 64, 64, 1 + N_RAYS)
    assert np.abs(port - ref).max() <= 0.1 * np.abs(ref).max()


# ---- the app: TestStardistBackbone and the export served by the model-runner -----

APP_CFG = {  # TestStardistBackbone.CFG
    "backbone": "stardist",
    "features": [8, 16],
    "n_rays": 8,
    "epochs": 50,
    "batch_size": 4,
    "tile": 32,
    "learning_rate": 2e-3,
}
EXPORT_CFG = {**APP_CFG, "epochs": 2, "learning_rate": 1e-3}


def _synthetic_cells(n=2, size=64, seed=0):
    """``tests/test_bundled_apps.py``'s bright-disk cells."""
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


async def _train(app, session_id, config):
    images, masks = _synthetic_cells()
    started = await app.start_training(
        train_images=images, train_labels=masks, config=config, session_id=session_id)
    assert started == {"session_id": session_id, "status": "started"}
    for _ in range(2400):
        status = await app.get_training_status(session_id=session_id)
        if status["status"] in ("completed", "failed"):
            return status
        await asyncio.sleep(0.05)
    raise TimeoutError(status)


def test_stardist_session_train_infer_export(tmp_path):
    app = CellposeFinetune(sessions_root=str(tmp_path / "sessions"), device="cpu")
    images, _ = _synthetic_cells()

    async def drive():
        final = await _train(app, "stardist-run", APP_CFG)
        out = await app.infer(session_id="stardist-run", images=images[:1], cellprob_threshold=-3.0)
        with pytest.raises(RuntimeError, match="do_3D|polygons"):
            await app.infer_3d(session_id="stardist-run", volumes=[np.zeros((4, 32, 32), np.float32)])
        exported = await app.export_model(session_id="stardist-run", model_name="stardist-export")
        return final, out, exported

    final, out, exported = asyncio.run(drive())
    assert final["status"] == "completed", final.get("error")
    assert final["losses"][-1] < final["losses"][0]
    assert out["masks"][0].shape == (64, 64) and out["n_cells"][0] >= 1
    assert out["n_cells"] == [int(out["masks"][0].max())]

    export_dir = Path(exported["model_path"])
    rdf = load_model_rdf(export_dir / "rdf.yaml")
    assert rdf.raw["tags"][0] == "stardist" and "8 ray distances" in rdf.description
    arch = rdf.weights["jax_params"]["architecture"]
    assert arch == {"name": "stardist2d", "kwargs": {"n_rays": 8, "features": [8, 16], "in_channels": 2}}
    # the export builds in the JAX registry, and the port serves it as
    # _predict_raw computes it (64^2 is its own bucket)
    params = jax_convert.load_params_npz(str(export_dir / "weights.npz"))
    pred = jax_get_model(arch["name"], **arch["kwargs"]).apply(
        {"params": params}, jnp.zeros((1, 32, 32, 2), jnp.float32))
    assert pred.shape == (1, 32, 32, 9)
    x = app._prepare_images(images[:1])
    deployment = RuntimeDeployment(device="cpu")

    async def serve():
        try:
            return await deployment.predict(str(export_dir / "rdf.yaml"), {"input0": x})
        finally:
            await deployment.close()

    served = asyncio.run(serve())["output0"]
    np.testing.assert_allclose(served, app._predict_raw(app.sessions["stardist-run"], x), rtol=0, atol=1e-5)


def test_odd_n_rays_rejected_synchronously(tmp_path):
    app = CellposeFinetune(sessions_root=str(tmp_path / "sessions"), device="cpu")
    images, masks = _synthetic_cells()
    for bad in (7, 8.9, 0):
        with pytest.raises(ValueError, match="n_rays must be an even"):
            asyncio.run(app.start_training(
                train_images=images, train_labels=masks,
                config={**APP_CFG, "n_rays": bad}, session_id="stardist-odd"))
    assert app.sessions == {} and not (tmp_path / "sessions" / "stardist-odd").exists()


def test_stardist_export_roundtrips_through_model_runner(tmp_path, monkeypatch):
    """The export dir's parent is a collection: the port's EntryDeployment
    serves it, and agrees with the JAX Pipeline on the same package."""
    app = CellposeFinetune(sessions_root=str(tmp_path / "sessions"), device="cpu")
    images, _ = _synthetic_cells()

    async def train_and_export():
        final = await _train(app, "sd-export", EXPORT_CFG)
        return final, await app.export_model(session_id="sd-export", model_name="sd-served")

    final, exported = asyncio.run(train_and_export())
    assert final["status"] == "completed", final.get("error")
    monkeypatch.setenv("BIOENGINE_LOCAL_MODEL_PATH", str(Path(exported["model_path"]).parent))
    x = np.stack([images[0], np.zeros_like(images[0])], axis=-1)[None].astype(np.float32)

    async def serve():
        entry = EntryDeployment(cache_dir=str(tmp_path / "model-cache"), device="cpu")
        try:
            await entry.async_init()
            return await entry.infer(model_id="sd-served", inputs=x)
        finally:
            await entry.close()

    out = asyncio.run(serve())
    assert out["_meta"]["backend"] == "cpu"
    assert np.asarray(out["output0"]).shape == (1, 64, 64, 9)
    jax_rt = _load_by_path("jax_mr_rt_sd_export", REPO / "apps" / "model-runner" / "runtime_deployment.py")
    pipeline = jax_rt.Pipeline(Path(exported["model_path"]))
    try:
        ref = pipeline.predict(x)["output0"]
    finally:
        pipeline.close()
    assert np.abs(out["output0"] - ref).max() <= 0.1 * np.abs(ref).max()


def test_jax_app_and_port_train_alike(tmp_path):
    """Both apps from one ``pretrained_path`` with one seed: identical
    tiles, ray-permuting flips in the same draw order, per-epoch losses
    within LOSS_RTOL."""
    jax_model = JaxStarDist2D(n_rays=8, features=(8, 16), in_channels=2)
    init = jax.jit(jax_model.init)(jax.random.key(7), jnp.zeros((1, 32, 32, 2), jnp.float32))["params"]
    pretrained = tmp_path / "pretrained.npz"
    jax_convert.save_params_npz(str(pretrained), init)
    cfg = {**EXPORT_CFG, "pretrained_path": str(pretrained), "seed": 3}
    jax_app = _load_by_path("jax_cellpose_app_stardist", REPO / "apps" / "cellpose-finetuning" / "main.py")
    jax_svc = jax_app.CellposeFinetune(sessions_root=str(tmp_path / "jax"))
    port_svc = CellposeFinetune(sessions_root=str(tmp_path / "port"), device="cpu")

    async def drive():
        return await _train(jax_svc, "parity", cfg), await _train(port_svc, "parity", cfg)

    jax_final, port_final = asyncio.run(drive())
    assert jax_final["status"] == port_final["status"] == "completed", (jax_final, port_final)
    assert len(port_final["losses"]) == 2
    np.testing.assert_allclose(port_final["losses"], jax_final["losses"], rtol=LOSS_RTOL)
    # both apps wrote the same targets
    with np.load(tmp_path / "jax" / "parity" / "data" / "train.npz") as a, \
            np.load(tmp_path / "port" / "parity" / "data" / "train.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["dist", "images", "prob"]
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert service._arch_entry(port_svc.sessions["parity"].config) == jax_app._arch_entry(
        jax_svc.sessions["parity"].config)
