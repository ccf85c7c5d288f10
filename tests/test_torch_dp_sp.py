"""The port's exact dp x sp train step (``parallel/data_parallel.py``
``data_parallel_step`` over a (dp, sp) mesh, whose forward is
``parallel/lockstep.py``'s) against JAX's GSPMD step and
against the port's own single-device step, on the CPU; and the step over
any mesh, the axes besides dp replicated (StarDist2D over (dp, sp),
CellposeNet and StarDist2D over (dp, tp)), against JAX's
``jit_data_parallel_step`` over the same mesh.

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
from bioengine_tpu.models.stardist import StarDist2D as JaxStarDist2D
from bioengine_tpu.models.stardist import make_stardist_train_step as jax_make_stardist_train_step
from bioengine_tpu.parallel import data_parallel as jax_dp
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


def _models(kind: str):
    """The flax model and the port's with the same seeded weights, the two
    train-step makers, and StarDist's ray count (None for cellpose)."""
    if kind == "cellpose":
        jax_model = JaxCellposeNet(features=(4, 8), in_channels=2, dtype=jnp.float32)
        port = CellposeNet(features=(4, 8), dtype=torch.float32)
        makers, rays = (jax_make_train_step, make_train_step), None
    else:
        jax_model = JaxStarDist2D(n_rays=8, features=(4, 8), dtype=jnp.float32)
        port = StarDist2D(n_rays=8, features=(4, 8), in_channels=2, dtype=torch.float32)
        makers, rays = (jax_make_stardist_train_step, make_stardist_train_step), 8
    p0 = seeded_flax_params(jax_model, (1, 16, 16, 2))
    port.load_state_dict(convert.state_dict_from_flax(jax.tree.map(np.asarray, p0)))
    return jax_model, p0, port, makers, rays


def _step_batch(seed: int, rays=None, n: int = 8, size: int = 16):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, size, size, 2)).astype(np.float32)
    if rays:
        return images, rng.random((n, size, size)).astype(np.float32), \
            (4 * rng.random((n, size, size, rays))).astype(np.float32)
    return images, rng.normal(size=(n, size, size, 2)).astype(np.float32), \
        rng.integers(0, 2, size=(n, size, size)).astype(np.float32)


def _held_to_jit_data_parallel_step(kind: str, axes: dict, place=None) -> None:
    """One SGD step of ``data_parallel_step`` over a CPU mesh of ``axes``
    against JAX's ``jit_data_parallel_step`` over the same mesh (state
    replicated, every batch leaf split over dp, the other axes replicated),
    the dp test's bounds; ``place`` places the images first. Only the
    replicas at coordinate 0 of the replicated axes run the forward (sp
    too is split for CellposeNet's host images: its lockstep)."""
    jax_model, p0, port, (jax_make, make), rays = _models(kind)
    batch = _step_batch(1, rays)
    n = int(np.prod(list(axes.values())))
    jm = jax_mesh.make_mesh(axes, jax.devices()[:n])
    jstep = jax_dp.jit_data_parallel_step(jax_make(), jm, donate_state=False)
    jstate = jax_dp.replicate(jm, JaxTrainState.create(jax_model.apply, p0, optax.sgd(1e-2)))
    jstate, jmetrics = jstep(jstate, *(jnp.asarray(a) for a in batch))

    m = cpu_mesh(axes)
    images = batch[0] if place is None else place(m, batch[0])
    state = _sgd_state(port, m)
    ran = set()
    for e, replica in enumerate(state.replicas):
        for module in replica.modules():
            module.register_forward_hook(lambda *_, e=e: ran.add(e))
    state, metrics = dp.data_parallel_step(make(), m)(state, images, *batch[1:])
    keep = {"dp", "sp"} if kind == "cellpose" and place is None else {"dp"}
    assert ran == {e for e in range(n) if all(m.coords(a)[e] == 0 for a in axes if a not in keep)}
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=LOSS_RTOL)
    want = convert.state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    got = state.module.state_dict()
    assert got.keys() == want.keys() and state.step == 1 and len(state.replicas) == n
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)
    for replica in state.replicas[1:]:
        assert all(torch.equal(a, b) for a, b in zip(state.module.parameters(), replica.parameters()))


@pytest.mark.parametrize("kind, axes", [
    ("cellpose", {"dp": 2, "tp": 2}),
    ("stardist", {"dp": 2, "tp": 2}),
    ("cellpose", {"tp": 2, "dp": 2}),
    ("stardist", {"dp": 2, "sp": 2}),
    ("stardist", {"dp": 2, "sp": 2, "tp": 2}),
    ("cellpose", {"dp": 2, "sp": 2, "tp": 2}),
], ids=["cellpose_dp2_tp2", "stardist_dp2_tp2", "cellpose_tp2_dp2", "stardist_dp2_sp2", "stardist_dp2_sp2_tp2",
        "cellpose_dp2_sp2_tp2"])
def test_step_over_any_mesh_matches_jit_data_parallel_step(kind, axes):
    """The step over a mesh whose other axes replicate, as
    ``jit_data_parallel_step``'s constraints make them: refused by the port
    for any axis but dp and sp, and for any model but CellposeNet over sp,
    until slice 18. CellposeNet's lockstep over (dp, sp, tp) runs on the
    tp coordinate 0 alone."""
    _held_to_jit_data_parallel_step(kind, axes)


def test_dp_sp_refusals():
    """The divisor refusal stays. StarDist2D over (dp 2, sp 2), and
    CellposeNet with its images placed ``P("dp")`` there, were refused
    until slice 18: each now takes the step with sp replicated, as JAX's
    ``jit_data_parallel_step`` does, held against it."""
    m = cpu_mesh({"dp": 2, "sp": 4})
    step = dp.data_parallel_step(make_train_step(), m)
    # 24 rows over sp = 4: shards of 6, not a multiple of the divisor 4
    with pytest.raises(ValueError, match="shards of 6 rows, not a multiple of the model's divisor 4"):
        step(_sgd_state(_seeded(), m), *_batch(0, size=24))
    _held_to_jit_data_parallel_step("stardist", {"dp": 2, "sp": 2})
    _held_to_jit_data_parallel_step("cellpose", {"dp": 2, "sp": 2}, place=dp.shard_batch)
