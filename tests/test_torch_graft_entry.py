"""The port's dry run (``bioengine_tpu_torch/graft_entry.py``) beside
``__graft_entry__.py``, on the CPU: each phase handed JAX's weights gives
JAX's loss or outputs within the bound of that phase's parity test, and the
whole ``dryrun_multichip(8, device="cpu")`` prints JAX's mesh shapes,
output shapes and transfer bytes.

JAX runs each phase's computation on the 8 forced host devices of
``tests/conftest.py`` (``jax.jit`` of the loss where the phase is a train
step: the loss is read before the update). The whole JAX dry run takes
~90 s on this CPU, so its OK line's fields are taken from the JAX objects
it builds (meshes, ``jax.eval_shape`` of its forwards, ``CrossHostEngine``
over the same payloads), not from running it.
"""

import asyncio
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu.models.cellpose import CellposeNet as JaxCellposeNet
from bioengine_tpu.models.cellpose import cellpose_loss as jax_cellpose_loss
from bioengine_tpu.models.sam import CpSAM as JaxCpSAM
from bioengine_tpu.models.unet import UNet2D as JaxUNet2D
from bioengine_tpu.models.unet3d import UNet3D as JaxUNet3D
from bioengine_tpu.models.vit import ViT as JaxViT
from bioengine_tpu.parallel import mesh as jax_mesh
from bioengine_tpu.parallel import spatial as jax_spatial
from bioengine_tpu.parallel import tensor_parallel as jax_tp
from bioengine_tpu.runtime import convert as jax_convert
from bioengine_tpu.runtime.engine import EngineConfig as JaxEngineConfig
from bioengine_tpu.runtime.engine import InferenceEngine as JaxEngine
from bioengine_tpu.runtime.program_cache import CompiledProgramCache as JaxCache
from bioengine_tpu.serving.mesh_plan import MeshConfig as JaxMeshConfig
from bioengine_tpu.serving.mesh_replica import CrossHostEngine as JaxCrossHostEngine
from bioengine_tpu_torch import graft_entry
from bioengine_tpu_torch.runtime import convert

N = 8
CPU = [torch.device("cpu")] * N
LOSS_RTOL = 2e-4  # tests/test_torch_parallel.py's dp step
ENGINE_TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_torch_parallel.py's dp engine


def _bridged(params) -> dict:
    return convert.state_dict_from_flax(jax.tree.map(np.asarray, params))


def _jax_loss(model, params, *batch) -> float:
    loss = jax.jit(lambda p, x, f, c: jax_cellpose_loss(model.apply({"params": p}, x), f, c)[0])
    return float(loss(params, *(jnp.asarray(a) for a in batch)))


def _draws(rng, *shapes_kinds):
    """The dry run's draws: ``("n", shape)`` normal, ``("i", shape)`` 0/1."""
    return [(rng.normal(size=s) if k == "n" else rng.integers(0, 2, size=s)).astype(np.float32)
            for k, s in shapes_kinds]


def test_cellpose_dp_sp_phase_gives_jax_loss():
    model = JaxCellposeNet(features=(8, 16, 32), in_channels=2, dtype=jnp.float32)
    params = seeded_flax_params(model, (1, 32, 32, 2))
    mesh, batch, loss, state = graft_entry.cellpose_dp_sp(CPU, np.random.default_rng(0), _bridged(params))
    assert mesh.shape == {"dp": 4, "sp": 2} and batch == 8 and state.step == 1
    want = _jax_loss(model, params, *_draws(np.random.default_rng(0), ("n", (8, 32, 32, 2)),
                                            ("n", (8, 32, 32, 2)), ("i", (8, 32, 32))))
    np.testing.assert_allclose(loss, want, rtol=LOSS_RTOL)


def test_tp_vit_phase_gives_jax_embeddings():
    vit = JaxViT(**graft_entry.VIT, dtype=jnp.float32)
    params = seeded_flax_params(vit, (1, 32, 32, 3))
    mesh, emb = graft_entry.tp_vit(CPU, np.random.default_rng(0), _bridged(params))
    (x,) = _draws(np.random.default_rng(0), ("n", (8, 32, 32, 3)))
    jm = jax_mesh.make_mesh({"dp": 4, "tp": 2}, jax.devices()[:N])
    apply_fn, sharded = jax_tp.make_tp_apply(vit, jm, params)
    want = np.asarray(apply_fn(sharded, jnp.asarray(x)))
    assert mesh.shape == dict(jm.shape) and emb.shape == want.shape
    np.testing.assert_allclose(emb, want, rtol=2e-4, atol=2e-4)  # test_vit_tp_matches_single_device's


def test_sp_unet3d_phase_gives_jax_output():
    unet3d = JaxUNet3D(features=(2, 4), out_channels=1, dtype=jnp.float32)
    params = seeded_flax_params(unet3d, (1, 4, 16, 16, 1))
    out = graft_entry.sp_unet3d(CPU, np.random.default_rng(0), _bridged(params))
    (vol,) = _draws(np.random.default_rng(0), ("n", (1, 4 * N, 16, 16, 1)))
    jm = jax_mesh.make_mesh({"sp": N}, jax.devices()[:N])
    fn = jax_spatial.spatial_shard_apply(lambda p, v: unet3d.apply({"params": p}, v), jm, halo=4, rank=5)
    want = np.asarray(fn(params, jax_spatial.shard_image(jm, jnp.asarray(vol))))
    assert out.shape == want.shape == (1, 4 * N, 16, 16, 1)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)  # the spatial tests' multi-layer bound


def test_cpsam_dp_phase_gives_jax_loss():
    """Both packages convert the same synthetic checkpoint: no weights to hand over."""
    loss = graft_entry.cpsam_dp(CPU, np.random.default_rng(0))
    model = JaxCpSAM(dtype=jnp.float32, **graft_entry.CPSAM_TINY)
    params = jax_convert.convert_state_dict(
        jax_convert.synthetic_cpsam_state_dict(**graft_entry.CPSAM_TINY), jax_convert.cpsam_name_map(depth=2),
        strict=True)
    want = _jax_loss(model, params, *_draws(np.random.default_rng(0), ("n", (N, 16, 16, 3)),
                                            ("n", (N, 16, 16, 2)), ("i", (N, 16, 16))))
    np.testing.assert_allclose(loss, want, rtol=LOSS_RTOL)


def test_dp_serving_phase_gives_jax_engine_output():
    unet = JaxUNet2D(features=(4, 8), out_channels=1, dtype=jnp.float32)
    params = seeded_flax_params(unet, (1, 32, 32, 1))
    mesh_shape, out = graft_entry.dp_serving(CPU, np.random.default_rng(0), _bridged(params))
    (x,) = _draws(np.random.default_rng(0), ("n", (N + 1, 32, 32, 1)))
    engine = JaxEngine("dryrun-serving", lambda p, v: unet.apply({"params": p}, v), params, divisor=unet.divisor,
                       config=JaxEngineConfig(max_tile=64), cache=JaxCache(), devices=jax.devices()[:N])
    try:
        want = engine.predict(x)
        assert mesh_shape == engine.mesh_shape == {"dp": N}
    finally:
        engine.close()
    np.testing.assert_allclose(out, want, **ENGINE_TOL)


def _jax_cross_host_bytes(n: int) -> int:
    """JAX's ``CrossHostEngine`` over the dry run's payloads, its stages
    computed in numpy (the bytes count what crosses, not who computes)."""
    half = max(1, n // 2)

    async def stage(shard, method, args, timeout_s):
        return np.asarray(args[1], np.float32)

    xce = JaxCrossHostEngine(JaxMeshConfig(stages=2, chips_per_stage=half), 2, stage)
    asyncio.run(xce.run(np.zeros((2 * half, 16, 16, graft_entry.STAGE_CHANNELS), np.float32)))
    return xce.stats()["transfer_bytes"]


def test_cross_host_phase_moves_jax_bytes():
    stats = graft_entry.cross_host(CPU, np.random.default_rng(0))
    assert stats["stage_calls"] == 2 and stats["transfer_bytes"] == _jax_cross_host_bytes(N)


def test_dryrun_multichip_prints_jax_shapes(capsys):
    line = graft_entry.dryrun_multichip(N, device="cpu")
    assert capsys.readouterr().out.strip() == line
    fields = dict(re.findall(r"(\w+)=(\{[^}]*\}|\([^)]*\)|\S+)", line.removeprefix("dryrun_multichip OK: ")))
    devs = jax.devices()[:N]
    vit = JaxViT(**graft_entry.VIT, dtype=jnp.float32)
    tp_out = jax.eval_shape(lambda x: vit.init_with_output(jax.random.key(1), x)[0],
                            jnp.zeros((8, 32, 32, 3), jnp.float32)).shape
    unet3d = JaxUNet3D(features=(2, 4), out_channels=1, dtype=jnp.float32)
    sp3d_out = jax.eval_shape(lambda v: unet3d.init_with_output(jax.random.key(2), v)[0],
                              jnp.zeros((1, 4 * N, 16, 16, 1), jnp.float32)).shape
    want = {
        "mesh": str(dict(jax_mesh.make_mesh({"dp": 4, "sp": 2}, devs).shape)), "batch": "8", "step": "1",
        "tp_mesh": str(dict(jax_mesh.make_mesh({"dp": 4, "tp": 2}, devs).shape)), "tp_out": str(tp_out),
        "sp3d_out": str(sp3d_out), "serving_mesh": str({"dp": N}), "serving_parity_ok": "True",
        "cross_host_stages": "2", "cross_host_parity_ok": "True",
        "cross_host_transfer_bytes": str(_jax_cross_host_bytes(N)),
    }
    assert {k: fields[k] for k in want} == want
    assert np.isfinite(float(fields["loss"])) and np.isfinite(float(fields["cpsam_dp_loss"]))


def test_dryrun_on_an_odd_count_builds_sp_1_and_refuses_too_few_devices():
    mesh, batch, _, _ = graft_entry.cellpose_dp_sp([torch.device("cpu")] * 3, np.random.default_rng(0))
    assert mesh.shape == {"dp": 3, "sp": 1} and batch == 6
    with pytest.raises(RuntimeError, match="need 4 devices, found 2"):
        graft_entry.dryrun_multichip(4, devices=["cpu", "cpu"])
