"""Entry points: a single-device forward and the multi-device dry run.

Counterpart of ``__graft_entry__.py``. ``dryrun_multichip`` runs the same
seven phases, in the same order, with the same shapes, meshes and checks:

1. CellposeNet (8, 16, 32) f32, one AdamW step of batch dp * 2 on 32^2
   over a (dp, sp) mesh: the batch split over dp and image height over sp
   (``parallel.data_parallel_step``, whose forward over sp runs in
   lockstep over each sp ring, ``parallel/lockstep.py``: the unsharded
   step);
2. a ViT (patch 8, dim 64, depth 2, 4 heads) forward over a (dp, tp) mesh
   through ``make_tp_apply`` (head dim 16: inline attention, as in JAX);
3. UNet3D (2, 4) depth-split over sp = n with ``halo=4, rank=5``;
4. a dp step of a tiny CpSAM from a converted synthetic checkpoint;
5. the dp engine over every device against the one-device engine on an
   uneven batch;
6. ``CrossHostEngine`` over two engine groups against the composed
   reference;
7. the ``dryrun_multichip OK: ...`` line.

The inputs come from one ``np.random.default_rng(0)`` in JAX's draw order;
the weights from numpy seeds (``reset_parameters``), the CpSAM's from
``synthetic_cpsam_state_dict``. Each phase is a function of its devices,
its inputs' generator and, where it has them, weights (a state dict), so
a test can hand it weights bridged from JAX.

Run: ``python -m bioengine_tpu_torch.graft_entry 4`` (the first 4 cards)
or ``... 8 --device cpu`` (8 ``cpu`` entries).
"""

from __future__ import annotations

import argparse
import asyncio
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from bioengine_tpu_torch.models.cellpose import CellposeNet, TrainState, make_train_step
from bioengine_tpu_torch.models.sam import CpSAM
from bioengine_tpu_torch.models.unet import UNet2D
from bioengine_tpu_torch.models.unet3d import UNet3D
from bioengine_tpu_torch.models.vit import ViT
from bioengine_tpu_torch.parallel.data_parallel import data_parallel_step, replicate
from bioengine_tpu_torch.parallel.mesh import Mesh, make_mesh
from bioengine_tpu_torch.parallel.spatial import shard_image, spatial_shard_apply
from bioengine_tpu_torch.parallel.tensor_parallel import make_tp_apply
from bioengine_tpu_torch.runtime.convert import (
    convert_state_dict,
    cpsam_name_map,
    state_dict_from_flax,
    synthetic_cpsam_state_dict,
)
from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device
from bioengine_tpu_torch.runtime.engine import EngineConfig, InferenceEngine
from bioengine_tpu_torch.runtime.program_cache import CompiledProgramCache
from bioengine_tpu_torch.serving.mesh_plan import MeshConfig
from bioengine_tpu_torch.serving.mesh_replica import CrossHostEngine

CELLPOSE_HW = (32, 32)
VIT = dict(patch_size=8, dim=64, depth=2, num_heads=4)
CPSAM_TINY = dict(
    patch_size=8, dim=32, depth=2, num_heads=2, window_size=2,
    global_attn_indexes=(1,), neck_dim=16, pretrain_grid=4,
)
STAGE_CHANNELS = 8
LEARNING_RATE = 1e-4
WEIGHT_DECAY = 1e-4  # optax.adamw's default


def entry(device: DeviceLike = "cuda"):
    """(fn, example_args): the forward of the flagship model, CellposeNet
    (32, 64, 128, 256) on a 256^2 two-channel tile; ``fn(params,
    images)`` runs the model with ``params`` (a state dict)."""
    dev = resolve_device(device)
    model = CellposeNet(features=(32, 64, 128, 256), in_channels=2)
    model.reset_parameters(0)
    model.to(dev).eval()

    def fn(params, images):
        return torch.func.functional_call(model, params, (images,))

    example_args = (dict(model.state_dict()), torch.zeros((1, 256, 256, 2), device=dev))
    return fn, example_args


def _loaded(model: nn.Module, state_dict: Optional[dict], seed: int) -> nn.Module:
    if state_dict is None:
        model.reset_parameters(seed)
    else:
        model.load_state_dict(state_dict)
    return model


def cellpose_dp_sp(devices: Sequence[torch.device], rng: np.random.Generator,
                   state_dict: Optional[dict] = None) -> tuple[Mesh, int, float, TrainState]:
    """Phase 1: one AdamW step of CellposeNet (8, 16, 32) f32 over a
    (dp, sp) mesh (sp = 2 for an even device count, else 1), images and
    flows ``P("dp", "sp", None, None)``, cell probabilities ``P("dp",
    "sp", None)``. Returns (mesh, batch, loss, state)."""
    n = len(devices)
    sp = 2 if n % 2 == 0 else 1
    mesh = make_mesh({"dp": n // sp, "sp": sp}, devices)
    model = _loaded(CellposeNet(features=(8, 16, 32), in_channels=2, dtype=torch.float32), state_dict, 0)
    state = replicate(mesh, TrainState.create(model.to(devices[0]), LEARNING_RATE, WEIGHT_DECAY))
    batch = mesh.shape["dp"] * 2
    images = rng.normal(size=(batch, *CELLPOSE_HW, 2)).astype(np.float32)
    flows = rng.normal(size=(batch, *CELLPOSE_HW, 2)).astype(np.float32)
    cellprob = rng.integers(0, 2, size=(batch, *CELLPOSE_HW)).astype(np.float32)
    state, metrics = data_parallel_step(make_train_step(), mesh)(state, images, flows, cellprob)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    return mesh, batch, loss, state


def tp_vit(devices: Sequence[torch.device], rng: np.random.Generator,
           state_dict: Optional[dict] = None) -> tuple[Mesh, np.ndarray]:
    """Phase 2: the ViT's forward with Megatron-sharded weights over a
    (dp, tp) mesh (tp = 2 for an even device count, else 1). Returns
    (mesh, embeddings)."""
    n = len(devices)
    tp = 2 if n % 2 == 0 else 1
    mesh = make_mesh({"dp": n // tp, "tp": tp}, devices)
    x = rng.normal(size=(mesh.shape["dp"] * 2, 32, 32, 3)).astype(np.float32)
    vit = _loaded(ViT(**VIT, dtype=torch.float32, img_size=32), state_dict, 1)
    apply_fn, sharded = make_tp_apply(vit.to(devices[0]).eval(), mesh)
    emb = apply_fn(sharded, x).cpu().numpy()
    if not np.isfinite(emb).all():
        raise RuntimeError("non-finite TP embeddings")
    return mesh, emb


def sp_unet3d(devices: Sequence[torch.device], rng: np.random.Generator,
              state_dict: Optional[dict] = None) -> np.ndarray:
    """Phase 3: UNet3D (2, 4) depth-split over sp = n, explicit halos of
    4 slices (``spatial_shard_apply(rank=5)``). Returns the output."""
    n = len(devices)
    mesh = make_mesh({"sp": n}, devices)
    vol = rng.normal(size=(1, 4 * n, 16, 16, 1)).astype(np.float32)
    unet3d = _loaded(UNet3D(features=(2, 4), out_channels=1, dtype=torch.float32), state_dict, 2)
    fn = spatial_shard_apply(lambda m, v: m(v), mesh, halo=4, rank=5)
    with torch.no_grad():
        out = fn(replicate(mesh, unet3d.eval()), shard_image(mesh, vol)).cpu().numpy()
    if not np.isfinite(out).all():
        raise RuntimeError("non-finite 3D sp output")
    return out


def cpsam_dp(devices: Sequence[torch.device], rng: np.random.Generator,
             state_dict: Optional[dict] = None) -> float:
    """Phase 4: one AdamW step of a tiny CpSAM over a dp mesh of every
    device, its weights converted from a synthetic torch-layout cpsam
    checkpoint (``convert_state_dict`` with ``cpsam_name_map``). Returns
    the loss."""
    n = len(devices)
    mesh = make_mesh({"dp": n}, devices)
    if state_dict is None:
        state_dict = state_dict_from_flax(convert_state_dict(
            synthetic_cpsam_state_dict(**CPSAM_TINY), cpsam_name_map(depth=2), strict=True))
    model = CpSAM(dtype=torch.float32, **CPSAM_TINY)
    model.load_state_dict(state_dict)
    state = replicate(mesh, TrainState.create(model.to(devices[0]), LEARNING_RATE, WEIGHT_DECAY))
    imgs = rng.normal(size=(n, 16, 16, 3)).astype(np.float32)
    flows = rng.normal(size=(n, 16, 16, 2)).astype(np.float32)
    prob = rng.integers(0, 2, size=(n, 16, 16)).astype(np.float32)
    _, metrics = data_parallel_step(make_train_step(), mesh)(state, imgs, flows, prob)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite cpsam loss {loss}")
    return loss


def dp_serving(devices: Sequence[torch.device], rng: np.random.Generator,
               state_dict: Optional[dict] = None) -> tuple[dict, np.ndarray]:
    """Phase 5: the dp engine over every device against the one-device
    engine on an uneven batch (the dp padding and crop-back), UNet2D (4, 8)
    f32, within rtol 1e-5, atol 1e-6. Returns (the engine's mesh shape,
    its output)."""
    n = len(devices)
    model = _loaded(UNet2D(features=(4, 8), out_channels=1, dtype=torch.float32), state_dict, 3)
    x = rng.normal(size=(n + 1, 32, 32, 1)).astype(np.float32)
    cache, cfg = CompiledProgramCache(), EngineConfig(max_tile=64)
    e1 = InferenceEngine("dryrun-serving", model, divisor=model.divisor, config=cfg, cache=cache,
                         devices=devices[:1])
    ek = InferenceEngine("dryrun-serving", model, divisor=model.divisor, config=cfg, cache=cache,
                         devices=devices)
    try:
        y1 = e1.predict(x)
        yk = ek.predict(x)
        np.testing.assert_allclose(yk, y1, rtol=1e-5, atol=1e-6)
        return ek.mesh_shape, yk
    finally:
        e1.close()
        ek.close()


class _Stage(nn.Module):
    """A channel-mixing stage, ``x @ w + b`` (ReLU after the first)."""

    def __init__(self, w: np.ndarray, b: np.ndarray, relu: bool):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(w), requires_grad=False)
        self.b = nn.Parameter(torch.from_numpy(b), requires_grad=False)
        self.relu = relu

    def forward(self, x):
        y = x @ self.w + self.b
        return torch.relu(y) if self.relu else y


def cross_host(devices: Sequence[torch.device], rng: np.random.Generator) -> dict:
    """Phase 6: ``CrossHostEngine`` composing two stage engines, each over
    its half of the devices with ``mesh_axes={"dp": -1}``, against the
    composed reference within rtol 1e-4, atol 1e-5. Returns its stats."""
    n = len(devices)
    stage_w = []
    for k in range(2):
        r = np.random.default_rng(40 + k)
        stage_w.append((
            np.asarray(r.normal(size=(STAGE_CHANNELS, STAGE_CHANNELS)) * 0.2, np.float32),
            np.asarray(r.normal(size=(STAGE_CHANNELS,)) * 0.1, np.float32),
        ))
    half = max(1, n // 2)
    groups = [devices[:half], devices[half:] or devices[:1]]
    engines = [
        InferenceEngine(f"dryrun-mesh-s{k}", _Stage(*stage_w[k], relu=k == 0), cache=CompiledProgramCache(),
                        devices=groups[k], mesh_axes={"dp": -1})
        for k in range(2)
    ]

    async def call_stage(shard, method, args, timeout_s):
        return engines[shard].predict(np.asarray(args[1], np.float32))

    xce = CrossHostEngine(MeshConfig(stages=2, chips_per_stage=half), 2, call_stage)
    x = rng.normal(size=(2 * half, 16, 16, STAGE_CHANNELS)).astype(np.float32)
    try:
        out = np.asarray(asyncio.run(xce.run(x)))
        ref = np.maximum(x @ stage_w[0][0] + stage_w[0][1], 0.0) @ stage_w[1][0] + stage_w[1][1]
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    finally:
        for e in engines:
            e.close()
    return xce.stats()


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda",
                     devices: Optional[Sequence[DeviceLike]] = None) -> str:
    """The multi-device dry run over ``n_devices`` mesh entries: the
    first ``n_devices`` cards, ``n_devices`` entries of ``cpu`` with
    ``device="cpu"``, or an explicit ``devices`` list (which may repeat a
    card). Prints and returns the ``dryrun_multichip OK: ...`` line; any
    failed check raises."""
    if devices is None:
        base = resolve_device(device)
        if base.type == "cpu":
            devices = [base] * n_devices
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())][:n_devices]
    devices = [resolve_device(d) for d in devices][:n_devices]
    if len(devices) != n_devices:
        raise RuntimeError(f"need {n_devices} devices, found {len(devices)}")
    rng = np.random.default_rng(0)

    mesh, batch, loss, state = cellpose_dp_sp(devices, rng)
    tp_mesh, emb = tp_vit(devices, rng)
    u3_out = sp_unet3d(devices, rng)
    cp_loss = cpsam_dp(devices, rng)
    srv_mesh, _ = dp_serving(devices, rng)
    transfer = cross_host(devices, rng)

    line = (
        f"dryrun_multichip OK: mesh={mesh.shape} batch={batch} "
        f"loss={loss:.4f} step={int(state.step)} "
        f"tp_mesh={tp_mesh.shape} tp_out={tuple(emb.shape)} "
        f"sp3d_out={tuple(u3_out.shape)} cpsam_dp_loss={cp_loss:.4f} "
        f"serving_mesh={srv_mesh} serving_parity_ok=True "
        f"cross_host_stages=2 cross_host_parity_ok=True "
        f"cross_host_transfer_bytes={transfer['transfer_bytes']}"
    )
    print(line)
    return line


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_devices", nargs="?", type=int, default=8)
    parser.add_argument("--device", default="cuda", help="cuda (the first n cards) or cpu")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)


if __name__ == "__main__":
    main()
