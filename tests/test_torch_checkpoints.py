"""The port's ``runtime/checkpoints.py`` against the JAX package's
orbax-backed service: ``test_runtime.py``'s ``TestCheckpointService`` cases
on the port's ``TrainState``; the same save sequences (steps,
``save_interval_steps``, ``force``, ``max_to_keep``) fed to both services
with equal ``save`` returns, ``steps()`` and ``latest_step()``; a flax
``CellposeNet`` state and its bridged port state, each saved and restored
by its own service, equal bit for bit after bridging back; and a save
followed at once by an in-place train step, whose checkpoint must hold the
state as it was at ``save``. The restore onto a data-parallel state's
replicas is in ``test_torch_parallel.py``.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bioengine_tpu.models.cellpose import CellposeNet as JaxCellposeNet
from bioengine_tpu.models.cellpose import TrainState as JaxTrainState
from bioengine_tpu.runtime.checkpoints import CheckpointService as JaxCheckpointService
from bioengine_tpu_torch.models.cellpose import (
    CellposeConfig,
    CellposeNet,
    TrainState,
    create_model_and_state,
    make_train_step,
)
from bioengine_tpu_torch.runtime import checkpoints
from bioengine_tpu_torch.runtime.checkpoints import CheckpointService
from bioengine_tpu_torch.runtime.convert import flax_params_from_state_dict, state_dict_from_flax

from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401

FEATURES = (4, 8)
SHAPE = (1, 16, 16, 2)
LR, WD = 1e-3, 1e-4


def _tiny_state(seed=0):
    _, state = create_model_and_state(CellposeConfig(features=FEATURES, learning_rate=LR), seed=seed,
                                      device="cpu")
    return state


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32))
    flows = torch.from_numpy(rng.uniform(-1, 1, SHAPE[:3] + (2,)).astype(np.float32))
    cellprob = torch.from_numpy((rng.random(SHAPE[:3]) > 0.5).astype(np.float32))
    return images, flows, cellprob


def _host_copy(state: TrainState) -> dict:
    return checkpoints._snapshot(state)


def _assert_state_equal(a: dict, b: dict):
    """Two snapshots (``_snapshot``) equal bit for bit."""
    assert a["step"] == b["step"]
    assert a["module"].keys() == b["module"].keys()
    for k in a["module"]:
        assert torch.equal(a["module"][k], b["module"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        assert sa[i].keys() == sb[i].keys()
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]


class TestCheckpointService:
    def test_save_restore_roundtrip(self, tmp_path):
        state = _tiny_state()
        step = make_train_step()
        step(state, *_batch())  # AdamW moments that are not zero
        with CheckpointService(tmp_path / "ckpt") as ckpt:
            fresh = _tiny_state(seed=1)
            assert ckpt.restore_latest(fresh) is None  # empty dir
            ckpt.save(0, state)
            ckpt.wait()
            restored = ckpt.restore_latest(fresh)
        assert restored is fresh
        _assert_state_equal(_host_copy(restored), _host_copy(state))
        assert restored.step == state.step == 1

    def test_retention_keeps_newest(self, tmp_path):
        state = _tiny_state()
        with CheckpointService(tmp_path / "ckpt", max_to_keep=2) as ckpt:
            for step in range(5):
                ckpt.save(step, state)
            ckpt.wait()
            assert ckpt.steps() == [3, 4]
            assert ckpt.latest_step() == 4
        assert sorted(os.listdir(tmp_path / "ckpt")) == ["3", "4"]
        # a new service over the directory finds the committed steps
        with CheckpointService(tmp_path / "ckpt", max_to_keep=2) as again:
            assert again.steps() == [3, 4]

    def test_modules_and_trees(self, tmp_path):
        module = CellposeNet(features=FEATURES)
        module.reset_parameters(3)
        tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "n": 5,
                "parts": [torch.ones(2, dtype=torch.bfloat16), (torch.zeros(1, dtype=torch.int64), 2.5)]}
        with CheckpointService(tmp_path / "ckpt") as ckpt:
            ckpt.save(1, module)
            ckpt.save(2, tree)
            ckpt.wait()
            other = CellposeNet(features=FEATURES)
            other.reset_parameters(4)
            assert ckpt.restore(1, other) is other
            template = {"w": torch.zeros(2, 3, dtype=torch.float64), "n": 0,
                        "parts": [torch.zeros(2, dtype=torch.bfloat16), (torch.ones(1, dtype=torch.int64), 0.0)]}
            w = template["w"]
            got = ckpt.restore(2, template)
            with pytest.raises(FileNotFoundError):
                ckpt.restore(9, template)
        for k, v in module.state_dict().items():
            assert torch.equal(other.state_dict()[k], v), k
        assert got["w"] is w and got["w"].dtype == torch.float64  # the template's tensor and dtype
        assert torch.equal(got["w"], tree["w"].double()) and got["n"] == 5
        assert torch.equal(got["parts"][0], tree["parts"][0]) and got["parts"][1][1] == 2.5
        assert isinstance(got["parts"][1], tuple) and torch.equal(got["parts"][1][0], tree["parts"][1][0])

    def test_save_then_step_keeps_the_saved_state(self, tmp_path, monkeypatch):
        """The train step updates parameters and moments in place: a save
        followed at once by a step must still write the state at ``save``.
        The writer is slowed so the step lands before the write."""
        real_save = torch.save

        def slow_save(obj, f):
            time.sleep(0.3)
            real_save(obj, f)

        monkeypatch.setattr(torch, "save", slow_save)
        state = _tiny_state()
        step = make_train_step()
        step(state, *_batch(1))
        with CheckpointService(tmp_path / "ckpt") as ckpt:
            at_save = _host_copy(state)
            assert ckpt.save(state.step, state)
            step(state, *_batch(2))
            after = _host_copy(state)
            assert not torch.equal(at_save["module"]["Conv_0.weight"], after["module"]["Conv_0.weight"])
            ckpt.wait()
            restored = ckpt.restore_latest(_tiny_state(seed=5))
        _assert_state_equal(_host_copy(restored), at_save)
        # and the step after the restore equals the uninterrupted step
        step(restored, *_batch(2))
        _assert_state_equal(_host_copy(restored), after)

    def test_an_interrupted_write_is_not_a_step(self, tmp_path):
        d = tmp_path / "ckpt"
        (d / ".6.tmp-123").mkdir(parents=True)
        (d / ".6.tmp-123" / "state.pt").write_bytes(b"half")
        (d / "7").mkdir()  # no state file: never committed
        with CheckpointService(d) as ckpt:
            assert ckpt.steps() == [] and ckpt.latest_step() is None
        assert not (d / ".6.tmp-123").exists()


# ---- the same save sequences through orbax and the port -----------------------

SEQUENCES = {
    "every_step_keep3": (3, 1, [(s, False) for s in range(6)]),
    "interval3_keep2": (2, 3, [(0, False), (1, False), (2, False), (3, False), (4, True), (5, False),
                              (6, False), (6, False), (5, True), (8, False), (9, False), (12, False)]),
    "interval2_first_off_interval": (3, 2, [(1, False), (2, False), (3, False), (4, False), (4, False),
                                            (3, False), (7, True), (8, False)]),
    "force_existing": (5, 1, [(0, False), (1, False), (1, True), (2, False)]),
}


def _run_sequence(service, state, seq):
    out = []
    for step, force in seq:
        try:
            out.append(bool(service.save(step, state, force=force)))
        except ValueError:
            out.append("exists")
    service.wait()
    return out, service.steps(), service.latest_step()


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_save_decisions_match_orbax(name, tmp_path):
    keep, interval, seq = SEQUENCES[name]
    jax_state = {"w": jnp.arange(4, dtype=jnp.float32)}
    port_state = {"w": torch.arange(4, dtype=torch.float32)}
    with JaxCheckpointService(tmp_path / "orbax", max_to_keep=keep, save_interval_steps=interval) as ref:
        want = _run_sequence(ref, jax_state, seq)
    with CheckpointService(tmp_path / "port", max_to_keep=keep, save_interval_steps=interval) as ours:
        got = _run_sequence(ours, port_state, seq)
    assert got == want
    assert sorted(int(p) for p in os.listdir(tmp_path / "port")) == got[1]


def _adam_state(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
               if hasattr(s, "mu")]
    return adam


def test_bridged_cellpose_state_restores_bit_for_bit(tmp_path):
    """A flax CellposeNet train state with seeded AdamW moments and its
    bridge into the port (parameters by ``state_dict_from_flax``, moments
    the same way), each through its own service: the restores, bridged
    back to flax names, are equal bit for bit."""
    model = JaxCellposeNet(features=FEATURES)
    params = seeded_flax_params(model, SHAPE, seed=3)
    tx = optax.adamw(LR, weight_decay=WD)
    jax_state = JaxTrainState.create(model.apply, params, tx)
    rng = np.random.default_rng(7)
    adam = _adam_state(jax_state.opt_state)
    mu = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    nu = jax.tree.map(lambda p: rng.random(size=p.shape).astype(np.float32), params)
    new_adam = adam._replace(count=jnp.asarray(7, jnp.int32), mu=jax.tree.map(jnp.asarray, mu),
                             nu=jax.tree.map(jnp.asarray, nu))
    opt_state = jax.tree_util.tree_map(lambda s: new_adam if s is adam else s, jax_state.opt_state,
                                       is_leaf=lambda x: x is adam)
    jax_state = jax_state.replace(step=jnp.asarray(7, jnp.int32), opt_state=opt_state)

    module = CellposeNet(features=FEATURES)
    module.load_state_dict(state_dict_from_flax(params))
    port_state = TrainState.create(module, LR, WD)
    by_name = dict(module.named_parameters())
    exp_avg, exp_avg_sq = state_dict_from_flax(mu), state_dict_from_flax(nu)
    for name, p in by_name.items():
        port_state.optimizer.state[p] = {"step": torch.tensor(7.0), "exp_avg": exp_avg[name].clone(),
                                         "exp_avg_sq": exp_avg_sq[name].clone()}
    port_state.step = 7

    with JaxCheckpointService(tmp_path / "orbax") as ref:
        ref.save(7, jax_state)
        ref.wait()
        jax_restored = ref.restore(7, JaxTrainState.create(model.apply, jax.tree.map(jnp.zeros_like, params), tx))
    with CheckpointService(tmp_path / "port") as ours:
        ours.save(7, port_state)
        ours.wait()
        fresh = CellposeNet(features=FEATURES)
        fresh.reset_parameters(11)
        port_restored = ours.restore(7, TrainState.create(fresh, LR, WD))

    def flat(tree):
        return {k: np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    restored_adam = _adam_state(jax_restored.opt_state)
    opt = port_restored.optimizer
    named = dict(port_restored.module.named_parameters())
    bridged = {
        "params": flax_params_from_state_dict(port_restored.module.state_dict()),
        "mu": flax_params_from_state_dict({n: opt.state[p]["exp_avg"] for n, p in named.items()}),
        "nu": flax_params_from_state_dict({n: opt.state[p]["exp_avg_sq"] for n, p in named.items()}),
    }
    from bioengine_tpu.runtime.convert import flatten_params

    for key, tree in (("params", jax_restored.params), ("mu", restored_adam.mu), ("nu", restored_adam.nu)):
        want = {k: np.asarray(v) for k, v in flatten_params(tree).items()}
        assert bridged[key].keys() == want.keys(), key
        for k in want:
            assert bridged[key][k].dtype == want[k].dtype and np.array_equal(bridged[key][k], want[k]), (key, k)
    assert int(jax_restored.step) == port_restored.step == 7
    assert int(restored_adam.count) == int(opt.state[named["Conv_0.weight"]]["step"].item()) == 7
    assert flat(jax_restored.params).keys() == flat(params).keys()
