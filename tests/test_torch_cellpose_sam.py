"""The PyTorch port's ``CellposeSAM`` (the finetuning app's ``"sam"``
backbone) against the flax module of ``bioengine_tpu/models/cellpose_sam.py``,
on weights carried over by ``state_dict_from_flax``; and the registry's
transformer entries.

Tolerances: the sin-cos table to 1e-5 (f32 ``pow``/``sin``/``cos`` of two
libraries, arguments up to ~60). f32 forward to 1e-4 max-abs. bf16 forward
to 10% of the output's range, as the other ported models are held. f32
train-step gradients to 1e-4 of the largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioengine_tpu.models.cellpose import cellpose_loss as jax_cellpose_loss
from bioengine_tpu.models.cellpose_sam import CellposeSAM as JaxCellposeSAM
from bioengine_tpu.models.cellpose_sam import sincos_pos_embed_2d as jax_sincos
from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu_torch.apps.model_runner.runtime import _input_channels
from bioengine_tpu_torch.models import registry
from bioengine_tpu_torch.models.cellpose import TrainState, make_train_step
from bioengine_tpu_torch.models.cellpose_sam import CellposeSAM, sincos_pos_embed_2d
from bioengine_tpu_torch.runtime import convert

# tests/test_models.py:107
ARCH = dict(patch_size=4, dim=64, depth=2, num_heads=4)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port(params, dtype, **arch):
    model = CellposeSAM(**{**ARCH, **arch}, dtype=dtype)
    model.load_state_dict(convert.state_dict_from_flax(params))
    return model


@pytest.mark.parametrize("grid", [(8, 8), (16, 12), (1, 5)])
def test_sincos_table_matches_jax(grid):
    ref = np.asarray(jax_sincos(*grid, 64))
    out = sincos_pos_embed_2d(*grid, 64).numpy()
    assert out.shape == ref.shape == (grid[0] * grid[1], 64)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize(
    "shape",
    # the model test's 32^2 and the variable tile sizes of
    # tests/test_models.py:128-141 (one param set, other grids)
    [(2, 32, 32, 2), (1, 64, 48, 2), (1, 16, 80, 2)],
    ids=["32x32", "64x48", "16x80"],
)
def test_forward_matches_flax(dtype, shape):
    jdt, tdt = DTYPES[dtype]
    jax_model = JaxCellposeSAM(**ARCH, dtype=jdt)
    params = seeded_flax_params(jax_model, (1, 32, 32, 2), seed=5)
    x = _inputs(shape)
    ref = np.asarray(jax.jit(jax_model.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = _port(params, tdt)(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == shape[:3] + (3,) and out.dtype == np.float32
    if dtype == "f32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    else:
        assert np.abs(out - ref).max() <= 0.1 * np.ptp(ref)


def test_bridge_covers_the_state_dict_exactly():
    params = seeded_flax_params(JaxCellposeSAM(**ARCH), (1, 32, 32, 2))
    state = convert.state_dict_from_flax(params)
    model = CellposeSAM(**ARCH)
    assert set(state) == set(model.state_dict())
    # decoder widths max(feats // 2, 32): 64 -> 32 -> 32
    assert model.up0.weight.shape == (64, 32, 2, 2) and model.up1.weight.shape == (32, 32, 2, 2)
    assert model.up1_norm.num_groups == 32 and model.divisor == 4
    flat = convert.flax_params_from_state_dict(state)
    ref = convert.flatten_params(params)
    assert set(flat) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k])
    with pytest.raises(ValueError, match="power of two"):
        CellposeSAM(patch_size=6)


def test_f32_train_step_gradients_match_jax_grad():
    shape = (2, 32, 32, 2)
    jax_model = JaxCellposeSAM(**ARCH, dtype=jnp.float32)
    params = seeded_flax_params(jax_model, shape, seed=6)
    x = _inputs(shape)
    rng = np.random.default_rng(7)
    flows = rng.uniform(-1, 1, shape[:3] + (2,)).astype(np.float32)
    cellprob = rng.integers(0, 2, shape[:3]).astype(np.float32)

    def loss_fn(p):
        return jax_cellpose_loss(jax_model.apply({"params": p}, jnp.asarray(x)),
                                 jnp.asarray(flows), jnp.asarray(cellprob))[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    ref = convert.state_dict_from_flax(jax.tree.map(np.asarray, ref_grads))
    model = _port(params, torch.float32)
    # the port's train step: forward, loss, backward, one AdamW update
    state = TrainState.create(model, 1e-3, 1e-5)
    _, metrics = make_train_step()(state, *(torch.from_numpy(a) for a in (x, flows, cellprob)))
    assert abs(float(metrics["loss"]) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert grads.keys() == ref.keys()
    scale = max(g.abs().max().item() for g in ref.values())
    err = max((grads[k] - ref[k]).abs().max().item() for k in ref)
    assert err <= 1e-4 * scale, (err, scale)


def test_registry():
    sam = registry.get_model("cellpose-sam", **ARCH, in_channels=3)
    assert isinstance(sam, CellposeSAM) and sam.patch_embed.weight.shape[1] == 3
    cpsam = registry.get_model(
        "cpsam", patch_size=8, dim=32, depth=3, num_heads=2, window_size=2,
        global_attn_indexes=[0, 2], neck_dim=16, pretrain_grid=4, dtype="float32",
    )
    assert cpsam.encoder.block0.window_size == 0 and cpsam.encoder.block1.window_size == 2
    assert cpsam.encoder.block2.window_size == 0 and cpsam.dtype == torch.float32
    # the model-runner reads the input channels off the patch embedding
    assert _input_channels(sam.state_dict()) == 3
    assert _input_channels(cpsam.state_dict()) == 3
    assert _input_channels(CellposeSAM(**ARCH).state_dict()) == 2
