"""The port's exact dp x sp train step (``parallel/data_parallel.py``
``data_parallel_step`` over a (dp, sp) mesh, whose forward is
``parallel/lockstep.py``'s) against JAX's GSPMD step and
against the port's own single-device step, on the CPU.

JAX runs on the 8 forced host devices of ``tests/conftest.py`` and jits
``make_train_step()`` with the images split ``P("dp", "sp", None, None)``,
as ``__graft_entry__.py`` does; the port's CPU mesh of width N is N entries
of ``cpu``. SGD, as ``tests/test_torch_parallel.py`` says: Adam turns
last-bit differences of near-zero gradients into sign flips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu.models.cellpose import CellposeNet as JaxCellposeNet
from bioengine_tpu.models.cellpose import TrainState as JaxTrainState
from bioengine_tpu.models.cellpose import make_train_step as jax_make_train_step
from bioengine_tpu.parallel import mesh as jax_mesh
from bioengine_tpu_torch.models import unet
from bioengine_tpu_torch.models.cellpose import CellposeNet, TrainState, make_train_step
from bioengine_tpu_torch.models.stardist import StarDist2D, make_stardist_train_step
from bioengine_tpu_torch.parallel import data_parallel as dp
from bioengine_tpu_torch.parallel.mesh import make_mesh
from bioengine_tpu_torch.parallel import lockstep
from bioengine_tpu_torch.runtime import convert

LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-4, 1e-6  # the dp test's bounds
FEATURES = (8, 16, 32)


def cpu_mesh(axes: dict):
    return make_mesh(axes, ["cpu"] * int(np.prod(list(axes.values()))))


def _batch(seed: int, n: int = 8, size: int = 32):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, size, size, 2)).astype(np.float32)
    flows = rng.normal(size=(n, size, size, 2)).astype(np.float32)
    prob = rng.integers(0, 2, size=(n, size, size)).astype(np.float32)
    return images, flows, prob


def _sgd_state(module, mesh=None):
    state = TrainState(module, torch.optim.SGD(module.parameters(), lr=1e-2))
    return dp.replicate(mesh, state) if mesh is not None else state


def _seeded(seed: int = 3) -> CellposeNet:
    model = CellposeNet(features=FEATURES, dtype=torch.float32)
    model.reset_parameters(seed)
    return model


@pytest.mark.parametrize("axes", [{"dp": 4, "sp": 2}, {"dp": 2, "sp": 4}], ids=["dp4_sp2", "dp2_sp4"])
def test_dp_sp_step_matches_jax_gspmd_step(axes):
    jax_model = JaxCellposeNet(features=FEATURES, in_channels=2, dtype=jnp.float32)
    p0 = seeded_flax_params(jax_model, (1, 32, 32, 2))
    batch = _batch(1)
    jm = jax_mesh.make_mesh(axes, jax.devices()[:8])
    repl = NamedSharding(jm, JP())
    img = NamedSharding(jm, JP("dp", "sp", None, None))
    prob = NamedSharding(jm, JP("dp", "sp", None))
    jstate = jax.device_put(JaxTrainState.create(jax_model.apply, p0, optax.sgd(1e-2)), repl)
    jstep = jax.jit(jax_make_train_step(), in_shardings=(repl, img, img, prob))
    jstate, jmetrics = jstep(jstate, *(jax.device_put(jnp.asarray(a), s) for a, s in zip(batch, (img, img, prob))))

    port = CellposeNet(features=FEATURES, dtype=torch.float32)
    port.load_state_dict(convert.state_dict_from_flax(jax.tree.map(np.asarray, p0)))
    m = cpu_mesh(axes)
    state, metrics = dp.data_parallel_step(make_train_step(), m)(_sgd_state(port, m), *batch)

    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=LOSS_RTOL)
    want = convert.state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    got = state.module.state_dict()
    assert got.keys() == want.keys() and state.step == 1 and len(state.replicas) == 8
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)
    for replica in state.replicas[1:]:
        assert all(torch.equal(a, b) for a, b in zip(state.module.parameters(), replica.parameters()))


def test_dp_sp_step_is_the_single_device_step(monkeypatch):
    """Forward, loss, gradients and every GroupNorm's statistics of the
    (dp 2, sp 2) step against one device's, within summation order."""
    images, flows, prob = _batch(2)
    stats = []
    normalize = unet.GroupNorm.normalize

    def recording(self, xf, mean, var):
        stats.append((mean.detach().clone(), var.detach().clone()))
        return normalize(self, xf, mean, var)

    monkeypatch.setattr(unet.GroupNorm, "normalize", recording)
    single = _sgd_state(_seeded())
    loss, _ = make_train_step().gradients(single, *(torch.from_numpy(a) for a in (images, flows, prob)))
    whole_stats, stats[:] = list(stats), []

    m = cpu_mesh({"dp": 2, "sp": 2})
    state = _sgd_state(_seeded(), m)
    state, metrics = dp.data_parallel_step(make_train_step(), m)(state, images, flows, prob)
    # every entry normalises with its ring's statistics, the rings in dp
    # order: ring j holds batch rows [4j, 4j + 4)
    assert len(stats) == 4 * len(whole_stats)
    for layer, (mean, var) in enumerate(whole_stats):
        for j, ring in enumerate(m.groups("sp")):
            for k in range(len(ring)):
                got_mean, got_var = stats[4 * layer + 2 * j + k]
                np.testing.assert_allclose(got_mean.numpy(), mean[4 * j : 4 * j + 4].numpy(), rtol=1e-5, atol=1e-6)
                np.testing.assert_allclose(got_var.numpy(), var[4 * j : 4 * j + 4].numpy(), rtol=1e-5, atol=1e-6)

    np.testing.assert_allclose(float(metrics["loss"]), float(loss.detach()), rtol=1e-5)
    for (name, a), b in zip(single.module.named_parameters(), state.module.parameters()):
        np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)

    monkeypatch.setattr(unet.GroupNorm, "normalize", normalize)
    model = _seeded()
    with torch.no_grad():
        whole = model(torch.from_numpy(images))
        blocks = dp.place(dp.Placement(m, ("dp", "sp")), images)
        outs = lockstep.forward(dp.replicate(m, model), m.groups("sp"), list(blocks))
        out = dp.Blocks(outs, m, blocks.axes, blocks.dims).gather()
    assert out.shape == whole.shape
    assert float((out - whole).abs().max()) <= 1e-5


def test_sp_of_width_one_is_the_dp_step_bit_for_bit():
    batches = [_batch(s) for s in range(2)]
    results = []
    for axes in ({"dp": 8}, {"dp": 8, "sp": 1}):
        m = cpu_mesh(axes)
        state, step = _sgd_state(_seeded(), m), dp.data_parallel_step(make_train_step(), m)
        losses = [float(step(state, *b)[1]["loss"]) for b in batches]
        results.append((losses, [p.detach().clone() for p in state.module.parameters()]))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(a, b) for a, b in zip(results[0][1], results[1][1]))


def test_dp_sp_refusals():
    m = cpu_mesh({"dp": 2, "sp": 4})
    step = dp.data_parallel_step(make_train_step(), m)
    # 24 rows over sp = 4: shards of 6, not a multiple of the divisor 4
    with pytest.raises(ValueError, match="shards of 6 rows, not a multiple of the model's divisor 4"):
        step(_sgd_state(_seeded(), m), *_batch(0, size=24))
    stardist = StarDist2D(n_rays=8, features=(4, 8), in_channels=2, dtype=torch.float32)
    rng = np.random.default_rng(0)
    images = rng.normal(size=(4, 16, 16, 2)).astype(np.float32)
    prob = rng.random((4, 16, 16)).astype(np.float32)
    dist = rng.random((4, 16, 16, 8)).astype(np.float32)
    m22 = cpu_mesh({"dp": 2, "sp": 2})
    with pytest.raises(NotImplementedError, match="the model is a StarDist2D"):
        dp.data_parallel_step(make_stardist_train_step(), m22)(_sgd_state(stardist, m22), images, prob, dist)
    # images placed otherwise than split on batch and height
    flows = rng.normal(size=(4, 16, 16, 2)).astype(np.float32)
    with pytest.raises(ValueError, match="split P\\('dp', 'sp'\\): batch and height"):
        dp.data_parallel_step(make_train_step(), m22)(_sgd_state(_seeded(), m22), dp.shard_batch(m22, images), flows, prob)
