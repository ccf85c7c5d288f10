"""The PyTorch port's CellposeNet, loss and train step against the flax
model and optax, on weights carried over by ``state_dict_from_flax``.

Tolerances: f32 forward to 1e-4 max-abs (plain f32 arithmetic in another
summation order). bf16 forward to 10% of the output's largest magnitude,
as the U-Nets are held (XLA's fused CPU program keeps some bf16
intermediates in f32 where PyTorch rounds them). ``cellpose_loss``'s parts
to 1e-6 of a float64 mean of the JAX terms (see the test for XLA's own
f32 mean). f32 gradients to 1e-4 of the largest gradient. One AdamW
update against ``optax.adamw`` on identical gradients to 1e-6: the update
rule is held on its own, because near-zero gradients make m/sqrt(v) flip
sign on rounding noise, so parameters after several independently
computed steps are not comparable at a tight tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bioengine_tpu.models.cellpose import CellposeNet as JaxCellposeNet
from bioengine_tpu.models.cellpose import cellpose_loss as jax_cellpose_loss
from bioengine_tpu.runtime import convert as jax_convert
from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu_torch.apps.model_runner.runtime import _input_channels
from bioengine_tpu_torch.models import registry
from bioengine_tpu_torch.models.cellpose import (
    CellposeConfig,
    CellposeNet,
    TrainState,
    cellpose_loss,
    create_model_and_state,
    make_train_step,
)
from bioengine_tpu_torch.runtime import convert

FEATURES = (8, 16, 32)
SHAPE = (2, 32, 32, 2)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def init_params():
    """flax ``init`` of CellposeNet(FEATURES): its tree is the one every
    dtype builds (parameters are f32 whatever the compute dtype)."""
    model = JaxCellposeNet(features=FEATURES)
    return jax.jit(model.init)(jax.random.key(0), jnp.zeros(SHAPE, jnp.float32))["params"]


def _flax_params(init: str, jax_model, init_params):
    if init == "init":
        return init_params
    return seeded_flax_params(jax_model, SHAPE, seed=3)


def _port(params, dtype):
    model = CellposeNet(features=FEATURES, dtype=dtype)
    model.load_state_dict(convert.state_dict_from_flax(params))
    return model


def _targets(seed=2):
    rng = np.random.default_rng(seed)
    flows = rng.uniform(-1, 1, SHAPE[:3] + (2,)).astype(np.float32)
    cellprob = (rng.random(SHAPE[:3]) < 0.4).astype(np.float32)
    return flows, cellprob


@pytest.mark.parametrize("init", ["init", "seeded"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cellpose_matches_flax(dtype, init, init_params):
    jdt, tdt = DTYPES[dtype]
    jax_model = JaxCellposeNet(features=FEATURES, dtype=jdt)
    params = _flax_params(init, jax_model, init_params)
    x = _inputs(SHAPE)
    ref = np.asarray(jax.jit(jax_model.apply)({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        out = _port(params, tdt).eval()(torch.from_numpy(x)).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape == SHAPE[:3] + (3,)
    if dtype == "f32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    else:
        assert np.abs(out - ref).max() <= 0.1 * np.abs(ref).max()


def test_key_cover_both_ways(init_params):
    params = init_params
    flat = jax_convert.flatten_params(params)
    model = CellposeNet(features=FEATURES)
    state = convert.state_dict_from_flax(params)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    back = convert.flax_params_from_state_dict(model.state_dict())
    assert {k: v.shape for k, v in back.items()} == {k: v.shape for k, v in flat.items()}
    # the 1x1 shortcut is Conv_2, created last, and only where channels change
    assert "ResBlock_0/Conv_2/kernel" in flat and "ResBlock_1/Conv_2/kernel" in flat
    assert "StyleMod_1/Dense_0/kernel" in flat and flat["StyleMod_1/Dense_0/kernel"].shape == (32, 8)
    assert "ResBlock_3/Conv_2/kernel" in flat  # [up, skip] = 32 channels -> 16


def test_module_tree_follows_flax_creation_order():
    model = CellposeNet(features=FEATURES)
    assert sorted(n for n, _ in model.named_children()) == sorted([
        "ResBlock_0", "ResBlock_1", "ResBlock_2", "ResBlock_3", "ResBlock_4",
        "ConvTranspose_0", "ConvTranspose_1", "StyleMod_0", "StyleMod_1", "Conv_0",
    ])
    assert [n for n, _ in model.ResBlock_0.named_children()] == [
        "GroupNorm_0", "Conv_0", "GroupNorm_1", "Conv_1", "Conv_2",
    ]
    assert not hasattr(CellposeNet(features=(8, 8)).ResBlock_1, "Conv_2")
    # group counts: gcd(32, C_in) for the first norm, min(32, f) for the second
    assert model.ResBlock_0.GroupNorm_0.num_groups == 2
    assert model.ResBlock_3.GroupNorm_0.num_groups == 32  # [up, skip]: 2 x 16
    assert model.ResBlock_4.GroupNorm_0.num_groups == 16  # 2 x 8
    assert model.ResBlock_2.GroupNorm_1.num_groups == 32
    assert model.ResBlock_0.GroupNorm_1.num_groups == 8
    assert model.divisor == 4


def test_cellpose_loss_matches_optax():
    """Each part to 1e-6 (relative) of the mean, taken in float64, of the
    JAX package's own elementwise terms (optax's BCE, jnp's squared flow
    error); the loss and parts as the JAX function reduces them in f32 to
    2e-6: XLA's f32 mean of these 2048 BCE terms is itself 1.0e-6 off the
    float64 mean (PyTorch's is 5e-8 off)."""
    rng = np.random.default_rng(0)
    pred = rng.normal(0, 3, SHAPE[:3] + (3,)).astype(np.float32)
    flows, cellprob = _targets()
    ref_loss, ref_parts = jax_cellpose_loss(jnp.asarray(pred), jnp.asarray(flows), jnp.asarray(cellprob))
    exact = {
        "flow_loss": 0.5 * np.asarray((jnp.asarray(pred[..., :2]) - 5.0 * jnp.asarray(flows)) ** 2, np.float64).mean(),
        "bce_loss": np.asarray(optax.sigmoid_binary_cross_entropy(
            jnp.asarray(pred[..., 2]), jnp.asarray(cellprob)), np.float64).mean(),
    }
    loss, parts = cellpose_loss(*(torch.from_numpy(a) for a in (pred, flows, cellprob)))
    assert set(parts) == set(ref_parts) == {"flow_loss", "bce_loss"}
    assert abs(loss.item() - float(ref_loss)) <= 2e-6 * abs(float(ref_loss))
    for k in parts:
        assert abs(parts[k].item() - exact[k]) <= 1e-6 * abs(exact[k])
        assert abs(parts[k].item() - float(ref_parts[k])) <= 2e-6 * abs(float(ref_parts[k]))


def test_f32_gradients_match_jax_grad():
    jax_model = JaxCellposeNet(features=FEATURES, dtype=jnp.float32)
    params = seeded_flax_params(jax_model, SHAPE, seed=4)
    x = _inputs(SHAPE)
    flows, cellprob = _targets()

    def loss_fn(p):
        return jax_cellpose_loss(jax_model.apply({"params": p}, jnp.asarray(x)),
                                 jnp.asarray(flows), jnp.asarray(cellprob))[0]

    ref = convert.state_dict_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params)))
    model = _port(params, torch.float32)
    loss, _ = cellpose_loss(model(torch.from_numpy(x)), torch.from_numpy(flows), torch.from_numpy(cellprob))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert grads.keys() == ref.keys()
    scale = max(g.abs().max().item() for g in ref.values())
    err = max((grads[k] - ref[k]).abs().max().item() for k in ref)
    assert err <= 1e-4 * scale, (err, scale)


def test_adamw_update_matches_optax():
    """One update of each rule from the same parameters and gradients, and
    a second update on the same gradients from the first's state."""
    rng = np.random.default_rng(5)
    shapes = {"a": (4, 3, 3, 3), "b": (7,), "c": (5, 6)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [
        {k: rng.normal(0, 1e-2, size=s).astype(np.float32) for k, s in shapes.items()}
        for _ in range(2)
    ]
    lr, wd = 1e-2, 1e-2
    tx = optax.adamw(lr, weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()})
    state = TrainState.create(module, lr, wd)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k])
        state.optimizer.step()
        for k in params:
            np.testing.assert_allclose(module[k].detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)


def test_train_step_reduces_loss():
    """``tests/test_models.py``'s train-step case: 6 steps at lr 1e-2."""
    cfg = CellposeConfig(features=FEATURES, learning_rate=1e-2)
    model, state = create_model_and_state(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(2, 32, 32, 2)).astype(np.float32))
    flows = torch.zeros(2, 32, 32, 2)
    cellprob = torch.zeros(2, 32, 32)
    step = make_train_step()
    state, m0 = step(state, images, flows, cellprob)
    for _ in range(5):
        state, m = step(state, images, flows, cellprob)
    assert set(m) == {"loss", "flow_loss", "bce_loss"}
    assert float(m["loss"]) < float(m0["loss"])
    assert state.step == 6 and state.module is model


def test_reset_parameters_is_seeded():
    a, b, c = (CellposeNet(features=(8, 16)) for _ in range(3))
    a.reset_parameters(3)
    b.reset_parameters(3)
    c.reset_parameters(4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["ResBlock_0.Conv_0.weight"], sc["ResBlock_0.Conv_0.weight"])
    assert torch.all(sa["ResBlock_1.GroupNorm_0.weight"] == 1)
    assert torch.all(sa["StyleMod_0.Dense_0.bias"] == 0)


def test_registry_and_runtime_channels():
    assert "cellpose" in registry.list_models()
    model = registry.get_model("cellpose")
    assert isinstance(model, CellposeNet)
    assert model.features == (32, 64, 128, 256) and model.in_channels == 2
    assert registry.get_model("cellpose", dtype="float32").dtype == torch.float32
    # the model-runner reads the input channels from ResBlock_0.Conv_0
    state = CellposeNet(features=(8, 16), in_channels=3).state_dict()
    assert _input_channels(state) == 3
