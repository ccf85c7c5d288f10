"""The PyTorch port's flow ops against the JAX package's.

- The flow cases of ``tests/test_runtime.py`` (``TestFlows`` and
  ``test_predictions_to_masks_rescales_network_flows``) and the golden
  cases of ``tests/test_models.py`` (``TestGoldenFlows``, against the
  independent ``fixtures_golden_flows.npz``), run through both packages.
- ``follow_flows`` / ``follow_flows_3d`` of the port against JAX's on the
  same fields: positions within 1e-3 px on at least 99.9% of the pixels
  (voxels). The floor at integer positions and FMA contraction may round
  differently in XLA's CPU program and PyTorch's, and Euler steps near a
  sink amplify it (measured: equal on the golden field; up to 4e-4 px on
  smooth random fields).
- ``masks_to_flows``, ``aggregate_orthogonal_flows`` and
  ``filter_and_relabel`` equal to JAX's bit for bit; ``masks_from_flows``
  gives the same labels on the fixture.
"""

from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from _torch_parity import few_torch_threads  # noqa: F401
from bioengine_tpu.ops import flows as jax_flows
from bioengine_tpu_torch.ops import flows as port_flows

GOLDEN = Path(__file__).parent / "fixtures_golden_flows.npz"
POSITION_TOL = 1e-3  # px
POSITION_SHARE = 0.999

PACKAGES = {
    "jax": SimpleNamespace(
        follow=lambda f, n_iter=200: np.asarray(jax_flows.follow_flows(jnp.asarray(f), n_iter=n_iter)),
        follow_3d=lambda f, n_iter=200: np.asarray(jax_flows.follow_flows_3d(jnp.asarray(f), n_iter=n_iter)),
        masks_from_flows=jax_flows.masks_from_flows,
        predictions_to_masks=jax_flows.predictions_to_masks,
        mod=jax_flows,
    ),
    "torch": SimpleNamespace(
        follow=lambda f, n_iter=200: port_flows.follow_flows(torch.from_numpy(f), n_iter=n_iter).numpy(),
        follow_3d=lambda f, n_iter=200: port_flows.follow_flows_3d(torch.from_numpy(f), n_iter=n_iter).numpy(),
        masks_from_flows=lambda *a, **kw: port_flows.masks_from_flows(*a, device="cpu", **kw),
        predictions_to_masks=lambda *a, **kw: port_flows.predictions_to_masks(*a, device="cpu", **kw),
        mod=port_flows,
    ),
}


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as d:
        return {k: d[k] for k in d.files}


def _two_squares():
    masks = np.zeros((48, 48), np.int32)
    masks[6:20, 6:20] = 1
    masks[28:44, 28:44] = 2
    return masks


def _best_ious(rec, masks):
    return [
        max(
            np.sum((rec == r) & (masks == lbl)) / max(np.sum((rec == r) | (masks == lbl)), 1)
            for r in range(1, rec.max() + 1)
        )
        for lbl in range(1, masks.max() + 1)
    ]


# ---- tests/test_runtime.py TestFlows, through both packages ---------------------


def test_masks_to_flows_unit_norm_inside(pkg):
    masks = np.zeros((32, 32), np.int32)
    masks[8:24, 8:24] = 1
    flows = pkg.mod.masks_to_flows(masks)
    mag = np.sqrt(flows[0] ** 2 + flows[1] ** 2)
    assert mag[masks > 0].mean() > 0.5
    assert mag[masks == 0].max() == 0.0


def test_follow_flows_converges_to_center(pkg):
    yy, xx = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    flow = np.stack([np.clip(8 - yy, -1, 1), np.clip(8 - xx, -1, 1)]).astype(np.float32)
    p = pkg.follow(flow, n_iter=40)
    assert np.abs(p[0] - 8).max() < 1.5
    assert np.abs(p[1] - 8).max() < 1.5


def test_masks_from_flows_two_cells(pkg):
    masks = _two_squares()
    flows = pkg.mod.masks_to_flows(masks)
    cellprob = np.where(masks > 0, 5.0, -5.0).astype(np.float32)
    rec = pkg.masks_from_flows(flows, cellprob, n_iter=100)
    assert rec.max() == 2
    assert min(_best_ious(rec, masks)) > 0.7


def test_follow_flows_3d_converges_to_center(pkg):
    zz, yy, xx = np.meshgrid(np.arange(11), np.arange(11), np.arange(11), indexing="ij")
    flow = np.stack([np.clip(5 - a, -1, 1) for a in (zz, yy, xx)]).astype(np.float32)
    p = pkg.follow_3d(flow, n_iter=30)
    assert np.abs(p - 5).max() < 1.5


def test_aggregate_orthogonal_flows_recovers_field(pkg):
    rng = np.random.default_rng(0)
    D, H, W = 4, 5, 6
    F = rng.normal(size=(3, D, H, W)).astype(np.float32)  # dz, dy, dx
    cp = rng.normal(size=(D, H, W)).astype(np.float32)
    pred_yx = np.stack([F[1], F[2], cp], axis=-1)
    pred_zx = np.transpose(np.stack([F[0], F[2], cp], axis=-1), (1, 0, 2, 3))
    pred_zy = np.transpose(np.stack([F[0], F[1], cp], axis=-1), (2, 0, 1, 3))
    flow, cellprob = pkg.mod.aggregate_orthogonal_flows(pred_yx, pred_zx, pred_zy)
    np.testing.assert_allclose(flow, F, rtol=1e-6)
    np.testing.assert_allclose(cellprob, cp, rtol=1e-6)
    with pytest.raises(ValueError, match="disagree"):
        pkg.mod.aggregate_orthogonal_flows(pred_yx, pred_zx[:-1], pred_zy)


def test_masks_from_flows_3d_two_cells(pkg):
    D = H = W = 24
    masks = np.zeros((D, H, W), np.int32)
    masks[4:10, 4:10, 4:10] = 1
    masks[14:21, 14:21, 14:21] = 2
    centers = {1: (7.0, 7.0, 7.0), 2: (17.0, 17.0, 17.0)}
    zz, yy, xx = np.meshgrid(np.arange(D), np.arange(H), np.arange(W), indexing="ij")
    flow = np.zeros((3, D, H, W), np.float32)
    for lbl, (cz, cy, cx) in centers.items():
        sel = masks == lbl
        vec = np.stack([cz - zz, cy - yy, cx - xx]).astype(np.float32)
        norm = np.sqrt((vec**2).sum(0)) + 1e-6
        for d in range(3):
            flow[d][sel] = (vec[d] / norm)[sel]
    cellprob = np.where(masks > 0, 5.0, -5.0).astype(np.float32)
    rec = pkg.masks_from_flows(flow, cellprob, n_iter=60)
    assert rec.max() == 2
    assert min(_best_ious(rec, masks)) > 0.7


def test_predictions_to_masks_rescales_network_flows(pkg):
    masks = _two_squares()
    flows = pkg.mod.masks_to_flows(masks)
    pred = np.concatenate(
        [np.moveaxis(flows * 5.0, 0, -1), np.where(masks > 0, 5.0, -5.0)[..., None]],
        axis=-1,
    ).astype(np.float32)
    assert pkg.predictions_to_masks(pred, n_iter=100).max() == 2


def test_empty_foreground_gives_no_cells(pkg):
    flow = np.zeros((2, 16, 16), np.float32)
    rec = pkg.masks_from_flows(flow, np.full((16, 16), -1.0, np.float32))
    assert rec.shape == (16, 16) and rec.dtype == np.int32 and rec.max() == 0


# ---- tests/test_models.py TestGoldenFlows, through both packages ----------------


def test_target_flows_match_independent_solve(pkg, golden):
    masks = golden["masks"].astype(np.int32)
    ours = pkg.mod.masks_to_flows(masks)
    interior = ndimage.binary_erosion(masks > 0, iterations=2)
    cos = (ours * golden["flows"]).sum(0)[interior]
    assert cos.mean() > 0.97, cos.mean()
    assert np.quantile(cos, 0.1) > 0.85, np.quantile(cos, 0.1)


def test_follow_flows_matches_independent_euler(pkg, golden):
    ours = pkg.follow(golden["flows"])
    fg = golden["masks"] > 0
    err = np.sqrt(((ours - golden["sinks"]) ** 2).sum(0))[fg]
    assert np.median(err) < 1.0, np.median(err)
    assert err.mean() < 2.0, err.mean()


def test_masks_reconstructed_from_independent_flows(pkg, golden):
    masks = golden["masks"].astype(np.int32)
    cellprob_logits = np.where(masks > 0, 8.0, -8.0).astype(np.float32)
    rec = pkg.masks_from_flows(golden["flows"], cellprob_logits)
    assert rec.max() == masks.max(), (rec.max(), masks.max())
    assert min(_best_ious(rec, masks)) > 0.8


# ---- the port against the JAX package on the same inputs ------------------------


def _smooth_field(shape, seed, sigma):
    rng = np.random.default_rng(seed)
    f = np.stack([ndimage.gaussian_filter(rng.normal(size=shape[1:]), sigma) for _ in range(shape[0])])
    return (f / np.abs(f).max()).astype(np.float32)


def _assert_positions_agree(port, ref):
    assert port.shape == ref.shape and port.dtype == np.float32
    dist = np.sqrt(((port - ref) ** 2).sum(0))
    assert np.mean(dist <= POSITION_TOL) >= POSITION_SHARE, dist.max()


@pytest.mark.parametrize("field", ["golden", "smooth_96x80"])
def test_follow_flows_positions_match_jax(field, golden):
    flow = golden["flows"] if field == "golden" else _smooth_field((2, 96, 80), 0, 4)
    _assert_positions_agree(PACKAGES["torch"].follow(flow), PACKAGES["jax"].follow(flow))


def test_follow_flows_3d_positions_match_jax():
    flow = _smooth_field((3, 12, 20, 16), 1, 3)
    _assert_positions_agree(PACKAGES["torch"].follow_3d(flow), PACKAGES["jax"].follow_3d(flow))


def test_follow_flows_keeps_the_device_and_f32():
    flow = torch.from_numpy(_smooth_field((2, 8, 8), 2, 1)).double()
    p = port_flows.follow_flows(flow, n_iter=3)
    assert p.dtype == torch.float32 and p.device == flow.device and p.shape == (2, 8, 8)


def test_masks_to_flows_bit_for_bit(golden):
    for masks in (golden["masks"].astype(np.int32), _two_squares()):
        np.testing.assert_array_equal(port_flows.masks_to_flows(masks), jax_flows.masks_to_flows(masks))
    masks = _two_squares()
    np.testing.assert_array_equal(
        port_flows.masks_to_flows(masks, n_iter=7), jax_flows.masks_to_flows(masks, n_iter=7)
    )


def test_aggregate_orthogonal_flows_bit_for_bit():
    rng = np.random.default_rng(3)
    D, H, W = 5, 6, 7
    preds = (
        rng.normal(size=(D, H, W, 3)).astype(np.float32),
        rng.normal(size=(H, D, W, 3)).astype(np.float32),
        rng.normal(size=(W, D, H, 3)).astype(np.float32),
    )
    for port, ref in zip(port_flows.aggregate_orthogonal_flows(*preds), jax_flows.aggregate_orthogonal_flows(*preds)):
        np.testing.assert_array_equal(port, ref)


def test_filter_and_relabel_bit_for_bit():
    rng = np.random.default_rng(4)
    masks = rng.integers(0, 9, size=(40, 40)).astype(np.int32)
    masks[masks == 3] = 0  # an id gap
    for min_size in (1, 150, 190):
        out = port_flows.filter_and_relabel(masks, min_size)
        np.testing.assert_array_equal(out, jax_flows.filter_and_relabel(masks, min_size))
        assert out.max() == len(np.unique(out[out > 0]))


def test_masks_from_flows_same_labels_on_fixture(golden):
    masks = golden["masks"].astype(np.int32)
    cellprob = np.where(masks > 0, 8.0, -8.0).astype(np.float32)
    np.testing.assert_array_equal(
        port_flows.masks_from_flows(golden["flows"], cellprob, device="cpu"),
        jax_flows.masks_from_flows(golden["flows"], cellprob),
    )


def test_masks_from_flows_3d_same_labels():
    flow = _smooth_field((3, 12, 20, 16), 5, 3)
    cellprob = _smooth_field((1, 12, 20, 16), 6, 3)[0]
    np.testing.assert_array_equal(
        port_flows.masks_from_flows(flow, cellprob, min_size=3, n_iter=50, device="cpu"),
        jax_flows.masks_from_flows(flow, cellprob, min_size=3, n_iter=50),
    )
