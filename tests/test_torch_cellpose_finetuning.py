"""The port's ``CellposeFinetune`` on the CPU, through the cases of
``tests/test_bundled_apps.py`` (``TestCellposeFinetune``,
``TestCellposeSettled``) with its ``FAST_CFG`` and synthetic cells, and
against the JAX app (``apps/cellpose-finetuning/main.py``) and the JAX
model-runner.

Tolerances: started from the same ``pretrained_path`` with the same seed,
the two apps train on identical tiles; their per-epoch mean losses agree
to 2% (relative; measured 0.07% and 0.3% over two epochs). Both compute
in bf16, where XLA's fused CPU program and PyTorch round at other places
(~1% of a forward's range), and AdamW's m/sqrt(v) turns rounding noise
on near-zero gradients into full-size updates. A port export served by
the port's ``RuntimeDeployment`` and by the JAX ``Pipeline`` agrees to 10%
of the output's range (bf16, as the U-Nets are held); served by the port
it equals ``_predict_raw`` at a size that is its own bucket (64^2) to
1e-5.
"""

import asyncio
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import few_torch_threads  # noqa: F401
from bioengine_tpu.models.cellpose import CellposeNet as JaxCellposeNet
from bioengine_tpu.runtime import convert as jax_convert
from bioengine_tpu_torch.apps.cellpose_finetuning import service
from bioengine_tpu_torch.apps.cellpose_finetuning.service import (
    CellposeFinetune,
    TrainingSession,
)
from bioengine_tpu_torch.apps.model_runner.runtime import RuntimeDeployment
from bioengine_tpu_torch.models.cellpose import CellposeNet
from bioengine_tpu_torch.runtime import convert
from bioengine_tpu_torch.runtime.rdf import load_model_rdf

REPO_APPS = Path(__file__).resolve().parent.parent / "apps"
FAST_CFG = {
    "features": [8, 16],
    "epochs": 2,
    "batch_size": 4,
    "tile": 32,
    "learning_rate": 1e-3,
}
LOSS_RTOL = 0.02


def _synthetic_cells(n=2, size=64, seed=0):
    """Images with bright disk cells + matching instance masks, drawn as
    ``tests/test_bundled_apps.py`` draws them."""
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


def _load_by_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


async def wait_for_status(app, session_id, states, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        status = await app.get_training_status(session_id=session_id)
        if status["status"] in states:
            return status
        await asyncio.sleep(0.05)
    raise TimeoutError(f"session never reached {states}: {status}")


async def _train(app, session_id, config=FAST_CFG, **cells):
    images, masks = _synthetic_cells(**cells)
    started = await app.start_training(
        train_images=images, train_labels=masks, config=config, session_id=session_id,
    )
    assert started == {"session_id": session_id, "status": "started"}
    return await wait_for_status(app, session_id, {"completed", "failed"})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One FAST_CFG session, trained to completion."""
    root = tmp_path_factory.mktemp("cellpose") / "sessions"
    app = CellposeFinetune(sessions_root=str(root), device="cpu")
    final = asyncio.run(_train(app, "session-test"))
    return SimpleNamespace(app=app, root=root, final=final)


# ---- TestCellposeFinetune's cases ---------------------------------------------


def test_full_session_lifecycle(trained):
    app, final = trained.app, trained.final
    assert final["status"] == "completed", final.get("error")
    assert final["current_epoch"] == 2 and len(final["losses"]) == 2
    assert final["losses"][-1] < final["losses"][0]
    assert final["mesh"] == {"dp": 1} and final["steps_per_epoch"] == 2

    async def drive():
        sessions = await app.list_sessions()
        out = await app.infer(session_id="session-test", images=_synthetic_cells()[0][:1])
        exported = await app.export_model(session_id="session-test")
        return sessions, out, exported

    sessions, out, exported = asyncio.run(drive())
    assert sessions[0]["session_id"] == "session-test" and sessions[0]["snapshots"] == 2
    assert out["masks"][0].shape == (64, 64) and out["masks"][0].dtype == np.int32
    assert out["snapshot"] == "epoch_0001.npz"
    assert out["n_cells"] == [int(out["masks"][0].max())]
    export_dir = Path(exported["model_path"])
    assert (export_dir / "rdf.yaml").exists() and (export_dir / "weights.npz").exists()
    assert exported["weights_format"] == "jax_params"
    rdf = load_model_rdf(export_dir / "rdf.yaml")
    assert rdf.weights["jax_params"]["architecture"] == {
        "name": "cellpose", "kwargs": {"features": [8, 16], "in_channels": 2},
    }
    models = trained.root / "session-test" / "models"
    assert (models / "train_state.pt").exists() and not list(models.glob("*.tmp"))


def test_export_served_by_port_and_jax_runtime(trained):
    app = trained.app
    exported = asyncio.run(app.export_model(session_id="session-test", model_name="served"))
    export_dir = Path(exported["model_path"])
    img = _synthetic_cells()[0][0]
    x = np.stack([np.stack([img, np.zeros_like(img)], -1)])
    deployment = RuntimeDeployment(device="cpu")

    async def drive():
        try:
            return await deployment.predict(str(export_dir / "rdf.yaml"), {"input0": x})
        finally:
            await deployment.close()

    port = asyncio.run(drive())["output0"]
    assert port.shape == (1, 64, 64, 3)
    session = app.sessions["session-test"]
    raw = app._predict_raw(session, x)
    np.testing.assert_allclose(port, raw, rtol=0, atol=1e-5)

    jax_rt = _load_by_path("jax_mr_rt", REPO_APPS / "model-runner" / "runtime_deployment.py")
    pipeline = jax_rt.Pipeline(export_dir)
    try:
        ref = pipeline.predict(x)["output0"]
    finally:
        pipeline.close()
    assert ref.shape == port.shape
    assert np.abs(port - ref).max() <= 0.1 * np.abs(ref).max()


def test_export_rdf_is_json_without_pyyaml(trained, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml fails
    exported = asyncio.run(trained.app.export_model(session_id="session-test", model_name="json"))
    text = (Path(exported["model_path"]) / "rdf.yaml").read_text()
    assert json.loads(text)["weights"]["jax_params"]["architecture"]["name"] == "cellpose"
    assert load_model_rdf(Path(exported["model_path"]) / "rdf.yaml").name == "json"


def test_infer_3d_do3d_recipe(trained):
    app = trained.app
    vol = np.full((8, 32, 32), 0.1, np.float32)
    vol[2:6, 10:22, 10:22] = 1.0

    async def drive():
        outs = [
            await app.infer_3d(session_id="session-test", volumes=[vol.tolist()], anisotropy=a)
            for a in (1.0, 2.0, 0.05)
        ]
        with pytest.raises(ValueError, match="grayscale volumes"):
            await app.infer_3d(session_id="session-test", volumes=[np.zeros((4, 4)).tolist()])
        with pytest.raises(ValueError, match="anisotropy"):
            await app.infer_3d(session_id="session-test", volumes=[vol.tolist()], anisotropy=0.0)
        return outs

    outs = asyncio.run(drive())
    m = np.asarray(outs[0]["masks"][0])
    assert m.shape == (8, 32, 32) and m.dtype.kind in "iu"
    assert outs[0]["n_cells"] == [int(m.max())]
    # anisotropic stacks come back at the caller's depth; extreme
    # downsampling clamps to >= 1 plane
    for out in outs[1:]:
        assert np.asarray(out["masks"][0]).shape == (8, 32, 32)
        assert out["n_cells"] == [int(np.asarray(out["masks"][0]).max())]


def test_stop_restart_and_live_inference(tmp_path):
    app = CellposeFinetune(sessions_root=str(tmp_path / "sessions"), device="cpu")
    images, masks = _synthetic_cells()

    async def drive():
        await app.start_training(
            train_images=images, train_labels=masks,
            config={**FAST_CFG, "epochs": 50}, session_id="session-stop",
        )
        deadline = time.time() + 120
        while (await app.get_training_status(session_id="session-stop")).get("current_epoch", 0) < 1:
            assert time.time() < deadline
            await asyncio.sleep(0.05)
        # live inference against the running session
        live = await app.infer(session_id="session-stop", images=images[:1])
        stopped = await app.stop_training(session_id="session-stop")
        epochs_done = len(app.sessions["session-stop"].snapshots())
        restarted = await app.restart_training(session_id="session-stop")
        status = await wait_for_status(app, "session-stop", {"training", "completed", "stopped", "failed"})
        await app.stop_training(session_id="session-stop")
        return live, stopped, epochs_done, restarted, status

    live, stopped, epochs_done, restarted, status = asyncio.run(drive())
    assert live["masks"][0].shape == (64, 64) and live["snapshot"] is not None
    assert stopped["status"] in ("stopped", "completed")
    assert restarted == {"session_id": "session-stop", "status": "restarted"}
    assert status["status"] != "failed", status.get("error")
    assert status["current_epoch"] >= epochs_done  # resumed, not restarted from 0
    assert (tmp_path / "sessions" / "session-stop" / "models" / "train_state.pt").exists()


def test_resume_without_train_state_starts_from_latest(tmp_path):
    """The JAX app's msgpack train state is not readable here: a session
    without ``train_state.pt`` resumes from ``latest.npz`` with a fresh
    optimiser."""
    app = CellposeFinetune(sessions_root=str(tmp_path / "sessions"), device="cpu")
    final = asyncio.run(_train(app, "s", config={**FAST_CFG, "epochs": 1}))
    assert final["status"] == "completed"
    session = app.sessions["s"]
    session.train_state_path.unlink()
    session.config = {**session.config, "epochs": 2}
    asyncio.run(app.restart_training(session_id="s"))
    final = asyncio.run(wait_for_status(app, "s", {"completed", "failed"}))
    assert final["status"] == "completed", final.get("error")
    assert session.snapshots() == ["epoch_0000.npz", "epoch_0001.npz"]
    assert len(final["losses"]) == 2


def test_pretrained_of_another_architecture_fails_the_session(tmp_path):
    other = CellposeNet(features=(8, 16, 32))
    pretrained = tmp_path / "other.npz"
    convert.save_params_npz(str(pretrained), convert.flax_params_from_state_dict(other.state_dict()))
    app = CellposeFinetune(sessions_root=str(tmp_path / "sessions"), device="cpu")
    final = asyncio.run(_train(app, "s", config={**FAST_CFG, "pretrained_path": str(pretrained)}))
    assert final["status"] == "failed"
    assert "does not match the configured architecture" in final["error"]
    assert "ResBlock_" in final["error"]  # names the keys


def test_odd_image_size_tile_aligned(tmp_path):
    app = CellposeFinetune(sessions_root=str(tmp_path / "sessions"), device="cpu")
    cfg = {**FAST_CFG, "features": [8, 16, 32], "tile": 30, "epochs": 1}
    final = asyncio.run(_train(app, "session-odd", config=cfg, size=70))
    assert final["status"] == "completed", final.get("error")


def test_session_id_reuse_starts_fresh(tmp_path):
    app = CellposeFinetune(sessions_root=str(tmp_path / "sessions"), device="cpu")

    async def drive():
        await _train(app, "session-reuse", n=1)
        final = await _train(app, "session-reuse", config={**FAST_CFG, "epochs": 1}, n=1)
        return final, await app.list_sessions()

    final, sessions = asyncio.run(drive())
    assert final["status"] == "completed" and final["current_epoch"] == 1
    entry = next(s for s in sessions if s["session_id"] == "session-reuse")
    assert entry["snapshots"] == 1


def test_unknown_session_rejected(tmp_path):
    app = CellposeFinetune(sessions_root=str(tmp_path), device="cpu")
    with pytest.raises(KeyError, match="unknown session"):
        asyncio.run(app.get_training_status(session_id="nope"))


def test_delete_session(tmp_path):
    app = CellposeFinetune(sessions_root=str(tmp_path / "sessions"), device="cpu")

    async def drive():
        await _train(app, "session-del", n=1)
        return await app.delete_session(session_id="session-del")

    assert asyncio.run(drive()) == {"deleted": "session-del"}
    assert not (tmp_path / "sessions" / "session-del").exists()


def test_sessions_recovered_after_restart(tmp_path):
    root = tmp_path / "sessions"
    TrainingSession(root, "running", {}).write_status(status="training")
    (root / ".gone.deleting-1234").mkdir()
    app = CellposeFinetune(sessions_root=str(root), device="cpu")
    assert app.sessions["running"].read_status()["status"] == "interrupted"
    assert app.sessions["running"].config == service.DEFAULT_CONFIG
    assert not (root / ".gone.deleting-1234").exists()


# ---- TestCellposeSettled's cases: the status-file / task wind-down race ---------


def _settled_session(tmp_path, status):
    s = TrainingSession(tmp_path, "s1", {})
    s.write_status(status=status)
    return s


def test_terminal_status_waits_for_task_windup(tmp_path):
    async def drive():
        app = CellposeFinetune(sessions_root=str(tmp_path), device="cpu")
        s = _settled_session(tmp_path, "completed")
        s.task = asyncio.create_task(asyncio.sleep(0.3))  # still winding down
        app.sessions["s1"] = s
        return s, await app.delete_session(session_id="s1")

    s, out = asyncio.run(drive())
    assert out == {"deleted": "s1"} and not s.dir.exists()


def test_running_session_rejected_immediately(tmp_path):
    async def drive():
        app = CellposeFinetune(sessions_root=str(tmp_path), device="cpu")
        s = _settled_session(tmp_path, "training")
        s.task = asyncio.create_task(asyncio.sleep(30))
        app.sessions["s1"] = s
        try:
            with pytest.raises(RuntimeError, match="stop session"):
                await app.delete_session(session_id="s1")
            with pytest.raises(RuntimeError, match="still running"):
                await app.restart_training(session_id="s1")
        finally:
            s.task.cancel()

    asyncio.run(drive())


def test_preparing_session_not_deletable(tmp_path):
    async def drive():
        app = CellposeFinetune(sessions_root=str(tmp_path), device="cpu")
        s = _settled_session(tmp_path, "initializing")
        s.preparing = True
        app.sessions["s1"] = s
        with pytest.raises(RuntimeError, match="stop session"):
            await app.delete_session(session_id="s1")

    asyncio.run(drive())


def test_concurrent_deletes_serialized(tmp_path):
    async def drive():
        app = CellposeFinetune(sessions_root=str(tmp_path), device="cpu")
        s = _settled_session(tmp_path, "completed")
        s.task = asyncio.create_task(asyncio.sleep(0.3))
        app.sessions["s1"] = s
        results = await asyncio.gather(
            app.delete_session(session_id="s1"),
            app.delete_session(session_id="s1"),
            return_exceptions=True,
        )
        return results, app._locks

    results, locks = asyncio.run(drive())
    oks = [r for r in results if r == {"deleted": "s1"}]
    errs = [r for r in results if isinstance(r, KeyError)]
    assert len(oks) == 1 and len(errs) == 1, results
    assert locks == {}  # the per-session lock entry is reclaimed


def test_readopted_session_deletable(tmp_path):
    app = CellposeFinetune(sessions_root=str(tmp_path), device="cpu")
    app.sessions["s1"] = _settled_session(tmp_path, "interrupted")
    assert asyncio.run(app.delete_session(session_id="s1")) == {"deleted": "s1"}


# ---- backbones not ported yet ----------------------------------------------------


@pytest.mark.parametrize("backbone", ["sam", "cpsam", "stardist"])
def test_unported_backbones_refused_before_data_preparation(backbone, tmp_path, monkeypatch):
    app = CellposeFinetune(sessions_root=str(tmp_path / "sessions"), device="cpu")

    def prepared(*_):
        raise AssertionError("data preparation ran")

    monkeypatch.setattr(app, "_prepare_training_data", prepared)
    images, masks = _synthetic_cells(n=1)
    with pytest.raises(NotImplementedError, match="A8"):
        asyncio.run(app.start_training(
            train_images=images, train_labels=masks,
            config={"backbone": backbone}, session_id="refused",
        ))
    assert app.sessions == {} and not (tmp_path / "sessions" / "refused").exists()

    # a session re-adopted from disk whose config names the backbone
    other = TrainingSession(tmp_path / "sessions", "adopted", {"backbone": backbone})
    (other.dir / "config.json").write_text(json.dumps({**service.DEFAULT_CONFIG, "backbone": backbone}))
    other.write_status(status="completed")
    other.latest_path.write_bytes(b"")
    app = CellposeFinetune(sessions_root=str(tmp_path / "sessions"), device="cpu")
    for call in (
        app.infer(session_id="adopted", images=images),
        app.infer_3d(session_id="adopted", volumes=[np.zeros((4, 32, 32))]),
        app.export_model(session_id="adopted"),
        app.restart_training(session_id="adopted"),
    ):
        with pytest.raises(NotImplementedError, match="A8"):
            asyncio.run(call)


def test_default_config_is_the_jax_apps():
    jax_app = _load_by_path("jax_cellpose_app_defaults", REPO_APPS / "cellpose-finetuning" / "main.py")
    assert service.DEFAULT_CONFIG == jax_app.DEFAULT_CONFIG
    assert asyncio.run(CellposeFinetune.get_default_config(None)) == jax_app.DEFAULT_CONFIG


# ---- the JAX app and the port, trained from the same weights ---------------------


def test_jax_app_and_port_train_alike(tmp_path):
    jax_model = JaxCellposeNet(features=(8, 16))
    init = jax.jit(jax_model.init)(jax.random.key(7), jnp.zeros((1, 32, 32, 2), jnp.float32))["params"]
    pretrained = tmp_path / "pretrained.npz"
    jax_convert.save_params_npz(str(pretrained), init)
    cfg = {**FAST_CFG, "pretrained_path": str(pretrained), "seed": 3}

    jax_app_mod = _load_by_path("jax_cellpose_app", REPO_APPS / "cellpose-finetuning" / "main.py")
    jax_app = jax_app_mod.CellposeFinetune(sessions_root=str(tmp_path / "jax"))
    port_app = CellposeFinetune(sessions_root=str(tmp_path / "port"), device="cpu")

    async def drive():
        return await _train(jax_app, "parity", config=cfg), await _train(port_app, "parity", config=cfg)

    jax_final, port_final = asyncio.run(drive())
    assert jax_final["status"] == port_final["status"] == "completed", (jax_final, port_final)
    np.testing.assert_allclose(port_final["losses"], jax_final["losses"], rtol=LOSS_RTOL)

    # each app's latest.npz loads in the other
    jax_latest = tmp_path / "jax" / "parity" / "models" / "latest.npz"
    port_latest = tmp_path / "port" / "parity" / "models" / "latest.npz"
    model = CellposeNet(features=(8, 16))
    model.load_state_dict(convert.state_dict_from_flax(convert.load_params_npz(str(jax_latest))))
    params = jax_convert.load_params_npz(str(port_latest))
    assert jax.tree.structure(params) == jax.tree.structure(init)
    x = np.random.default_rng(0).normal(size=(1, 32, 32, 2)).astype(np.float32)
    out = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    assert out.shape == (1, 32, 32, 3) and np.isfinite(out).all()
