"""The PyTorch port's SAM encoder and ``CpSAM`` against the flax modules of
``bioengine_tpu/models/sam.py``, on weights carried over by
``state_dict_from_flax``, and against the independent forward of
``tests/fixtures_golden_cpsam.npz``.

Tolerances: the resizes, the rel-pos gather and the window partition to
1e-6 (the same f32 interpolation weights; the partition is a layout and
is held bit for bit). f32 forward to 1e-4 max-abs (plain f32 arithmetic
in another summation order). bf16 forward to 10% of the output's range,
as the other ported models are held (XLA's fused CPU program keeps some
bf16 intermediates in f32 where PyTorch rounds them). The golden fixture
at the JAX test's own bounds (encoder rtol = atol = 1e-3, output rtol
1e-3 and atol 2e-3). f32 gradients of ``cellpose_loss`` to 1e-4 of the
largest gradient.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioengine_tpu.models import sam as jax_sam
from bioengine_tpu.models.cellpose import cellpose_loss as jax_cellpose_loss
from bioengine_tpu.runtime import convert as jax_convert
from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu_torch.models import sam
from bioengine_tpu_torch.models.cellpose import cellpose_loss
from bioengine_tpu_torch.models.sam import CpSAM
from bioengine_tpu_torch.runtime import convert

# tests/test_models.py:233-236
TINY = dict(
    patch_size=8, dim=32, depth=2, num_heads=2, window_size=2,
    global_attn_indexes=(1,), neck_dim=16, pretrain_grid=4,
)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
GOLDEN = Path(__file__).resolve().parent / "fixtures_golden_cpsam.npz"


def _inputs(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port(params, dtype):
    model = CpSAM(**TINY, dtype=dtype)
    model.load_state_dict(convert.state_dict_from_flax(params))
    return model


# ---- tables: resize and gather ---------------------------------------------------


@pytest.mark.parametrize("needed", [15, 7, 3], ids=["larger", "equal", "smaller"])
def test_resize_rel_pos_matches_jax(needed):
    table = _inputs((7, 16))  # stored at table_size 4
    ref = np.asarray(jax_sam._resize_rel_pos(jnp.asarray(table), needed))
    out = sam._resize_rel_pos(torch.from_numpy(table), needed).numpy()
    assert out.shape == ref.shape == (needed, 16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [8, 4, 2, 1], ids=["larger", "equal", "smaller", "one"])
def test_rel_pos_gather_matches_jax(size):
    table = _inputs((7, 16), seed=2)
    ref = np.asarray(jax_sam._rel_pos_gather(size, size, jnp.asarray(table)))
    out = sam._rel_pos_gather(size, size, torch.from_numpy(table)).numpy()
    assert out.shape == ref.shape == (size, size, 16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("grid", [(6, 6), (4, 4), (2, 3), (8, 2)])
def test_pos_embed_resize_matches_jax(grid):
    """``jax.image.resize(..., "bilinear")`` antialiases when it shrinks;
    the port's antialiased ``F.interpolate`` agrees both ways."""
    pos = _inputs((1, 4, 4, 8), seed=3)
    ref = np.asarray(jax.image.resize(jnp.asarray(pos), (1, *grid, 8), method="bilinear"))
    out = sam._resize_pos_embed(torch.from_numpy(pos), *grid).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw", [(5, 3), (4, 4), (7, 2)])
def test_window_partition_pads_with_zeros_like_jax(hw):
    x = _inputs((2, *hw, 4), seed=4)
    ref, ref_padded = jax_sam._window_partition(jnp.asarray(x), 2)
    out, padded = sam._window_partition(torch.from_numpy(x), 2)
    assert padded == ref_padded
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    back = sam._window_unpartition(out, 2, padded, hw)
    np.testing.assert_array_equal(back.numpy(), x)
    jax_back = jax_sam._window_unpartition(ref, 2, ref_padded, hw)
    np.testing.assert_array_equal(np.asarray(jax_back), x)


# ---- the model ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize(
    "hw", [(40, 24), (16, 16), (32, 32)],
    # 5x3 pads to whole windows and is below the pretrain grid in x; 2x2
    # is below it in both; 4x4 is the pretrain grid
    ids=["padded_and_smaller", "smaller", "pretrain_grid"],
)
def test_forward_matches_flax(dtype, hw):
    jdt, tdt = DTYPES[dtype]
    jax_model = jax_sam.CpSAM(**TINY, dtype=jdt)
    shape = (2, *hw, 3)
    params = seeded_flax_params(jax_model, shape, seed=5)
    x = _inputs(shape)
    ref = np.asarray(jax.jit(jax_model.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = _port(params, tdt)(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == shape and out.dtype == np.float32
    if dtype == "f32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    else:
        assert np.abs(out - ref).max() <= 0.1 * np.ptp(ref)


def test_bridge_covers_the_state_dict_exactly():
    params = seeded_flax_params(jax_sam.CpSAM(**TINY), (1, 32, 32, 3))
    model = CpSAM(**TINY)
    state = convert.state_dict_from_flax(params)
    assert set(state) == set(model.state_dict())
    back = convert.flax_params_from_state_dict(state)
    flat = jax_convert.flatten_params(params)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def _golden_params():
    sd = jax_convert.synthetic_cpsam_state_dict(**TINY)
    return convert.convert_state_dict(sd, convert.cpsam_name_map(depth=2))


def test_golden_encoder_activations():
    golden = np.load(GOLDEN)
    model = CpSAM(**TINY, dtype=torch.float32)
    model.load_state_dict(convert.state_dict_from_flax(_golden_params()))
    with torch.no_grad():
        feats = model.encoder(torch.from_numpy(golden["input"])).numpy()
    np.testing.assert_allclose(feats, golden["encoder"], rtol=1e-3, atol=1e-3)


def test_golden_readout():
    golden = np.load(GOLDEN)
    model = CpSAM(**TINY, dtype=torch.float32)
    model.load_state_dict(convert.state_dict_from_flax(_golden_params()))
    with torch.no_grad():
        out = model(torch.from_numpy(golden["input"])).numpy()
    assert out.shape == golden["output"].shape
    np.testing.assert_allclose(out, golden["output"], rtol=1e-3, atol=2e-3)


def test_f32_gradients_match_jax_grad():
    shape = (2, 40, 24, 3)
    jax_model = jax_sam.CpSAM(**TINY, dtype=jnp.float32)
    params = seeded_flax_params(jax_model, shape, seed=6)
    x = _inputs(shape)
    rng = np.random.default_rng(7)
    flows = rng.uniform(-1, 1, shape[:3] + (2,)).astype(np.float32)
    cellprob = rng.integers(0, 2, shape[:3]).astype(np.float32)

    def loss_fn(p):
        return jax_cellpose_loss(jax_model.apply({"params": p}, jnp.asarray(x)),
                                 jnp.asarray(flows), jnp.asarray(cellprob))[0]

    ref = convert.state_dict_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params)))
    model = _port(params, torch.float32)
    loss, _ = cellpose_loss(model(torch.from_numpy(x)), torch.from_numpy(flows), torch.from_numpy(cellprob))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert grads.keys() == ref.keys()
    # the tables are reached too: the rel-pos bias and the resized pos_embed
    assert grads["encoder.block1.attn.rel_pos_h"].abs().max() > 0
    assert grads["encoder.pos_embed"].abs().max() > 0
    scale = max(g.abs().max().item() for g in ref.values())
    err = max((grads[k] - ref[k]).abs().max().item() for k in ref)
    assert err <= 1e-4 * scale, (err, scale)


def test_reset_parameters_uses_flax_scales():
    a, b = CpSAM(**TINY), CpSAM(**TINY)
    a.reset_parameters(3)
    b.reset_parameters(3)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    # flax declares the tables zeros
    assert torch.all(sa["encoder.pos_embed"] == 0)
    assert torch.all(sa["encoder.block1.attn.rel_pos_w"] == 0)
    assert torch.all(sa["encoder.neck_norm2.weight"] == 1)
    assert torch.all(sa["out.bias"] == 0)
    # transposed readout: fan_in = input channels x window
    std = sa["out.weight"].std().item()
    assert abs(std - (16 * 64) ** -0.5) < 0.2 * (16 * 64) ** -0.5
    assert a.divisor == 8 and a.encoder.block0.attn.rel_pos_h.shape == (3, 16)
    assert a.encoder.block1.attn.rel_pos_h.shape == (7, 16)
