"""Cellpose fine-tuning on PyTorch — training sessions, live inference, export.

Counterpart of ``CellposeFinetune`` in ``apps/cellpose-finetuning/main.py``
for every backbone the JAX app trains: ``"unet"``
(``models/cellpose.py`` ``CellposeNet``), ``"sam"``
(``models/cellpose_sam.py`` ``CellposeSAM``), ``"cpsam"``
(``models/sam.py`` ``CpSAM``, the SAM ViT-L encoder of the pretrained
Cellpose-SAM model, fine-tuned from a checkpoint converted by
``runtime.convert.convert_checkpoint``) and ``"stardist"``
(``models/stardist.py`` ``StarDist2D``, star-convex polygons). The
session protocol is the JAX app's: a directory per session with
``config.json``, ``status.json`` (written atomically), a ``STOP`` file
checked per batch, per-epoch snapshots as flat npz in flax names (the
``jax_params`` format either package serves), ``latest.npz`` swapped in
by an atomic rename, and restart from the latest snapshot.

- Training runs ``make_train_step`` (``make_stardist_train_step`` for
  stardist; ``torch.optim.AdamW``) in a thread, data parallel as the JAX
  app trains (``parallel.data_parallel_step`` over ``replicate`` and
  ``shard_batch``): dp is the largest power of two, at most the leased
  devices, that divides ``batch_size`` (the JAX app counts its host's
  chips; the port counts its lease), and the status reports ``mesh``; over
  batches drawn exactly as the JAX app draws them from
  ``np.random.default_rng(seed)``, flips included (for stardist they
  permute the rays). Targets come once per session from
  ``ops.flows.masks_to_flows``, or ``ops.stardist.masks_to_stardist``.
- The full train state (module, optimiser, step) goes to
  ``models/train_state.pt``; the JAX app's ``train_state.msgpack`` is flax
  serialisation, so a resume without the port's file starts a fresh
  optimiser from ``latest.npz``, as the JAX app does without its own.
- ``infer`` / ``infer_3d`` keep one module per architecture on the device,
  apart from the one being trained, and copy each request's snapshot into
  it with ``load_state_dict``; flow following runs on the device.
  Stardist reconstructs polygons on the host and refuses ``infer_3d``.
- ``export_model`` writes a ``jax_params`` package that the port's
  ``RuntimeDeployment`` and the JAX model-runner both serve.

cpsam is a 3-channel model: its batches get a zero third channel at the
model boundary, in training, ``infer`` and ``infer_3d``; its export is
served with 3-channel input. The service methods are the JAX app's ten
``@schema_method``s, with its docstrings (the published schemas are built
from them) and ``context``, so the worker serves the app from its bundle
(``apps/bundles/cellpose-finetuning``). ``async_init`` resolves the
replica's lease: training runs over the leased devices, ``infer`` and
``infer_3d`` on the first of them. Entry points run on ``cuda:0`` unless given ``device="cpu"``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import shutil
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from bioengine_tpu_torch.models.cellpose import CellposeNet, TrainState, make_train_step
from bioengine_tpu_torch.models.cellpose_sam import CellposeSAM
from bioengine_tpu_torch.models.sam import CpSAM
from bioengine_tpu_torch.models.stardist import StarDist2D, make_stardist_train_step
from bioengine_tpu_torch.parallel.data_parallel import data_parallel_step, replicate, shard_batch
from bioengine_tpu_torch.parallel.mesh import make_mesh
from bioengine_tpu_torch.ops.flows import (
    FLOW_SCALE,
    aggregate_orthogonal_flows,
    filter_and_relabel,
    masks_from_flows,
    masks_to_flows,
    predictions_to_masks,
)
from bioengine_tpu_torch.ops.stardist import masks_to_stardist, predictions_to_masks_stardist
from bioengine_tpu_torch.runtime.buckets import bucket_shape, crop_to, pad_to
from bioengine_tpu_torch.runtime.convert import (
    flax_params_from_state_dict,
    load_params_npz,
    save_params_npz,
    state_dict_from_flax,
)
from bioengine_tpu_torch.rpc import schema_method
from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device, resolve_devices

# session states with no train thread behind them anymore
_TERMINAL_STATES = ("completed", "failed", "stopped", "interrupted")

# the JAX app's defaults, so both apps read one config the same way
DEFAULT_CONFIG = {
    # "unet" = CellposeNet, "sam" = CellposeSAM, "cpsam" = CpSAM (set
    # "pretrained_path" to a converted cpsam checkpoint), "stardist" =
    # StarDist2D (prob + ray-distance heads, star-convex polygons)
    "backbone": "unet",
    "features": [32, 64, 128, 256],      # unet/stardist backbones
    "patch_size": 8,                      # sam/cpsam backbones
    "dim": 256,
    "depth": 8,
    "num_heads": 8,
    "n_rays": 32,                         # stardist backbone (even)
    "max_dist": 64,                       # stardist ray-length cap (px)
    "pretrained_path": None,              # flat-npz jax_params to start from
    "learning_rate": 1e-4,
    "weight_decay": 1e-5,
    "epochs": 10,
    "batch_size": 8,
    "tile": 128,
    "seed": 0,
}

# cpsam-only architecture knobs, overridable in config; the defaults in
# models/sam.py are the ViT-L checkpoint shape
_CPSAM_KEYS = (
    "window_size", "global_attn_indexes", "neck_dim", "pretrain_grid",
    "mlp_ratio",
)

# the pretrained cpsam checkpoint shape (ViT-L @ patch 8): for backbone
# "cpsam" these beat DEFAULT_CONFIG's small unet/sam sizes wherever the
# caller did not set the key, so {"backbone": "cpsam", "pretrained_path":
# ...} builds the model the checkpoint fits
_CPSAM_ARCH_DEFAULTS = {
    "patch_size": 8, "dim": 1024, "depth": 24, "num_heads": 16,
    "tile": 256,
}


def _merge_config(config: Optional[dict]) -> dict:
    config = dict(config or {})
    cfg = {**DEFAULT_CONFIG, **config}
    if cfg.get("backbone") == "cpsam":
        for k, v in _CPSAM_ARCH_DEFAULTS.items():
            if k not in config:
                cfg[k] = v
    if cfg.get("backbone") == "stardist":
        # refused here, before target derivation, and 8.9 is not 8
        n_rays = float(cfg["n_rays"])
        if not n_rays.is_integer() or n_rays < 2 or int(n_rays) % 2:
            raise ValueError(
                f"n_rays must be an even integer >= 2, got {cfg['n_rays']}"
            )
        cfg["n_rays"] = int(n_rays)
    return cfg


def _model_channels(cfg: dict) -> int:
    """cpsam is a 3-channel model (its pretrained patch embedding is);
    the app's prepared batches are [cyto, nucleus]."""
    return 3 if cfg.get("backbone") == "cpsam" else 2


def _to_model_channels(x: np.ndarray, cfg: dict) -> np.ndarray:
    """Pad (..., 2) batches with zero channels up to the model's input."""
    c = _model_channels(cfg)
    if x.shape[-1] == c:
        return x
    pad = np.zeros((*x.shape[:-1], c - x.shape[-1]), x.dtype)
    return np.concatenate([x, pad], axis=-1)


def build_model(cfg: dict) -> tuple[nn.Module, int]:
    """(model, divisor) for the configured backbone, on the CPU. The
    cellpose family (unet, sam, cpsam) shares one output contract, (B, H,
    W, 3) flow and cellprob logits; stardist emits (B, H, W, 1 + n_rays)
    probability logit and rays, and has its own targets, step, flips and
    post-processing."""
    backbone = cfg.get("backbone", "unet")
    if backbone == "cpsam":
        kw = {k: cfg[k] for k in _CPSAM_KEYS if k in cfg}
        model = CpSAM(
            patch_size=int(cfg.get("patch_size", 8)),
            dim=int(cfg.get("dim", 1024)),
            depth=int(cfg.get("depth", 24)),
            num_heads=int(cfg.get("num_heads", 16)),
            **kw,
        )
    elif backbone == "sam":
        model = CellposeSAM(
            patch_size=int(cfg.get("patch_size", 8)),
            dim=int(cfg.get("dim", 256)),
            depth=int(cfg.get("depth", 8)),
            num_heads=int(cfg.get("num_heads", 8)),
            in_channels=2,
        )
    elif backbone == "stardist":
        # n_rays is even (_merge_config): the horizontal flip maps ray r
        # to (n_rays/2 - r) mod n_rays, a bijection only then
        model = StarDist2D(
            n_rays=int(cfg["n_rays"]), features=tuple(cfg["features"]), in_channels=2,
        )
    else:
        model = CellposeNet(features=tuple(cfg["features"]), in_channels=2)
    return model, model.divisor


def _arch_entry(cfg: dict) -> dict:
    """rdf.yaml architecture stanza: the registry name + kwargs the
    model-runner rebuilds the model from."""
    backbone = cfg.get("backbone", "unet")
    if backbone == "cpsam":
        kw = {
            "patch_size": int(cfg.get("patch_size", 8)),
            "dim": int(cfg.get("dim", 1024)),
            "depth": int(cfg.get("depth", 24)),
            "num_heads": int(cfg.get("num_heads", 16)),
        }
        for k in _CPSAM_KEYS:
            if k in cfg:
                kw[k] = list(cfg[k]) if k == "global_attn_indexes" else cfg[k]
        return {"name": "cpsam", "kwargs": kw}
    if backbone == "sam":
        return {
            "name": "cellpose-sam",
            "kwargs": {
                "patch_size": int(cfg.get("patch_size", 8)),
                "dim": int(cfg.get("dim", 256)),
                "depth": int(cfg.get("depth", 8)),
                "num_heads": int(cfg.get("num_heads", 8)),
                "in_channels": 2,
            },
        }
    if backbone == "stardist":
        return {
            "name": "stardist2d",
            "kwargs": {
                "n_rays": int(cfg["n_rays"]),
                "features": list(cfg["features"]),
                "in_channels": 2,
            },
        }
    return {
        "name": "cellpose",
        "kwargs": {"features": list(cfg["features"]), "in_channels": 2},
    }


def _arch_key(cfg: dict) -> tuple:
    """Everything in a session's config that shapes its model: the key of
    live inference's module cache."""
    return (
        cfg.get("backbone", "unet"),
        tuple(cfg["features"]),
        cfg.get("patch_size"), cfg.get("dim"),
        cfg.get("depth"), cfg.get("num_heads"),
        cfg.get("n_rays"),
        # cpsam-only knobs change the architecture too
        *(
            tuple(cfg[k]) if isinstance(cfg.get(k), (list, tuple)) else cfg.get(k)
            for k in _CPSAM_KEYS
        ),
    )


def _load_pretrained(model: nn.Module, path: str) -> None:
    """Flat-npz ``jax_params`` into ``model``. Position and rel-pos tables
    are declared at their checkpoint extent and resized at use, so every
    leaf must match exactly; a checkpoint that does not is refused, naming
    the missing, unexpected and mis-shaped keys."""
    state = state_dict_from_flax(load_params_npz(path))
    got = {k: tuple(v.shape) for k, v in state.items()}
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    bad = [
        f"{k}: checkpoint {got[k]} vs model {want[k]}"
        for k in sorted(set(got) & set(want))
        if got[k] != want[k]
    ]
    if missing or extra or bad:
        raise ValueError(
            "pretrained_path does not match the configured architecture: "
            f"missing={missing[:5]} unexpected={extra[:5]} "
            f"shape_mismatch={bad[:5]}"
        )
    model.load_state_dict(state)


def _dump_rdf(rdf: dict) -> str:
    """YAML where PyYAML imports, else JSON (which is valid YAML)."""
    try:
        import yaml
    except ImportError:
        return json.dumps(rdf, indent=1)
    return yaml.safe_dump(rdf)


class TrainingSession:
    """One fine-tune run: a directory with status.json, snapshots, STOP."""

    def __init__(self, root: Path, session_id: str, config: dict):
        self.session_id = session_id
        self.dir = root / session_id
        self.models_dir = self.dir / "models"
        self.data_dir = self.dir / "data"
        self.models_dir.mkdir(parents=True, exist_ok=True)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.config = config
        self.task: asyncio.Task | None = None
        # True while start_training is still writing this session's data
        self.preparing = False

    # ---- status.json protocol ---------------------------------------------

    @property
    def status_path(self) -> Path:
        return self.dir / "status.json"

    @property
    def stop_path(self) -> Path:
        return self.dir / "STOP"

    def read_status(self) -> dict:
        try:
            return json.loads(self.status_path.read_text())
        except (OSError, json.JSONDecodeError):
            return {"session_id": self.session_id, "status": "unknown"}

    def write_status(self, **updates) -> dict:
        status = self.read_status()
        status.update(updates, session_id=self.session_id, updated_at=time.time())
        tmp = self.status_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(status))
        tmp.rename(self.status_path)
        return status

    def stop_requested(self) -> bool:
        return self.stop_path.exists()

    # ---- snapshots -----------------------------------------------------------

    def snapshot_path(self, epoch: int) -> Path:
        return self.models_dir / f"epoch_{epoch:04d}.npz"

    @property
    def latest_path(self) -> Path:
        return self.models_dir / "latest.npz"

    def save_snapshot(self, epoch: int, state_dict) -> None:
        """The module's weights as a flat npz in flax names."""
        path = self.snapshot_path(epoch)
        save_params_npz(str(path), flax_params_from_state_dict(state_dict))
        tmp = self.latest_path.with_suffix(".npz.tmp")
        shutil.copyfile(path, tmp)
        tmp.rename(self.latest_path)  # atomic: live inference never sees a partial file

    def snapshots(self) -> list[str]:
        return sorted(p.name for p in self.models_dir.glob("epoch_*.npz"))

    @property
    def train_state_path(self) -> Path:
        """Module, optimiser moments and step, so a resume continues AdamW
        where it left off instead of re-warming."""
        return self.models_dir / "train_state.pt"

    def save_train_state(self, state: TrainState) -> None:
        tmp = self.train_state_path.with_suffix(".pt.tmp")
        torch.save(
            {
                "module": state.module.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step,
            },
            tmp,
        )
        tmp.rename(self.train_state_path)


class CellposeFinetune:
    def __init__(
        self,
        sessions_root: str = "~/.bioengine/cellpose-sessions",
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.devices = [self.device]
        self.sessions_root = Path(sessions_root).expanduser()
        self.sessions_root.mkdir(parents=True, exist_ok=True)
        self.sessions: dict[str, TrainingSession] = {}
        # serializes start/stop/restart/delete per session id — the busy
        # check can suspend (waiting out a task wind-down), so without
        # a lock two callers could both pass it and then both mutate.
        # value = [lock, refcount]; the entry is reclaimed when the last
        # holder/waiter leaves, so ids probed once don't accumulate
        self._locks: dict[str, list] = {}
        # one inference module per architecture (_arch_key), never the one
        # being trained; the lock covers the cache, the weight copy and
        # the forward, so concurrent requests never mix snapshots
        self._infer_models: dict[tuple, nn.Module] = {}
        self._infer_lock = threading.Lock()
        self._recover_sessions()

    async def async_init(self):
        """The replica lifecycle injects the leased chip group
        (``bioengine_device_ids``) before this runs (``resolve_devices``: a
        lease naming no such device is refused, never remapped): training
        is data parallel over the group, ``infer`` and ``infer_3d`` run on
        its first device."""
        lease = getattr(self, "bioengine_device_ids", None)
        self.devices = resolve_devices(list(lease) if lease else None, self.device)
        self.device = self.devices[0]

    @contextlib.asynccontextmanager
    async def _lifecycle_lock(self, session_id: str):
        entry = self._locks.setdefault(session_id, [asyncio.Lock(), 0])
        entry[1] += 1
        try:
            async with entry[0]:
                yield
        finally:
            entry[1] -= 1
            if entry[1] == 0 and self._locks.get(session_id) is entry:
                del self._locks[session_id]

    def _recover_sessions(self) -> None:
        """Re-adopt session dirs from a previous life of the app; training
        threads do not survive, so running sessions become 'interrupted'."""
        for d in self.sessions_root.iterdir():
            if d.name.startswith("."):
                # a '.{name}.deleting-*' dir is a failed start_training's
                # renamed-away tree whose threaded rmtree didn't finish —
                # sweep it, never adopt it; other hidden dirs are not ours
                if ".deleting-" in d.name and d.is_dir():
                    shutil.rmtree(d, ignore_errors=True)
                continue
            if (d / "status.json").exists():
                try:
                    cfg = json.loads((d / "config.json").read_text())
                except (OSError, json.JSONDecodeError):
                    cfg = dict(DEFAULT_CONFIG)
                s = TrainingSession(self.sessions_root, d.name, cfg)
                if s.read_status().get("status") == "training":
                    s.write_status(
                        status="interrupted",
                        error="worker restarted during training",
                    )
                self.sessions[d.name] = s

    async def check_health(self):
        if not self.sessions_root.exists():
            raise RuntimeError("sessions root vanished")

    # ---- data handling ---------------------------------------------------------

    @staticmethod
    def _prepare_images(images: list) -> np.ndarray:
        """-> (N, H, W, 2) float32, per-image 1-99 percentile normalized.
        Grayscale gets a zero second channel (cellpose channel
        convention: [cyto, nucleus])."""
        out = []
        for img in images:
            # always copy: normalization below is in-place and must not
            # write through to the caller's array
            a = np.array(img, np.float32, copy=True)
            if a.ndim == 2:
                a = np.stack([a, np.zeros_like(a)], axis=-1)
            elif a.ndim == 3 and a.shape[-1] == 1:
                a = np.concatenate([a, np.zeros_like(a)], axis=-1)
            elif a.ndim == 3 and a.shape[-1] > 2:
                a = a[..., :2]
            # per-channel percentiles — mixed-bit-depth channels must each
            # land in [0, 1]
            for c in range(a.shape[-1]):
                lo, hi = np.percentile(a[..., c], [1, 99])
                a[..., c] = (a[..., c] - lo) / max(hi - lo, 1e-6)
            out.append(a)
        return np.stack(out)

    def _prepare_training_data(
        self, session: TrainingSession, images: list, labels: list
    ) -> None:
        """Normalize images, derive the backbone's targets from the masks
        (flow fields, or edt-prob and ray distances for stardist), persist
        to the session's data dir (restart_training reuses them)."""
        x = self._prepare_images(images)
        masks = np.stack([np.asarray(m) for m in labels]).astype(np.int32)
        if masks.shape[:3] != x.shape[:3]:
            raise ValueError(
                f"images {x.shape[:3]} and labels {masks.shape[:3]} disagree"
            )
        cfg = session.config
        if cfg.get("backbone") == "stardist":
            # one mask per thread: the stepped gathers are numpy passes
            # that release the GIL; the arrays are the loop's
            n_rays, max_dist = int(cfg["n_rays"]), int(cfg["max_dist"])
            workers = max(1, min(len(masks), os.cpu_count() or 1, 8))
            with ThreadPoolExecutor(workers) as pool:
                pairs = list(pool.map(
                    lambda m: masks_to_stardist(m, n_rays=n_rays, max_dist=max_dist), masks))
            targets = {
                "prob": np.stack([p for p, _ in pairs]),        # (N, H, W)
                "dist": np.stack([d for _, d in pairs]),        # (N, H, W, R)
            }
        else:
            flows = np.stack([masks_to_flows(m) for m in masks])
            targets = {
                "flows": np.moveaxis(flows, 1, -1),             # (N, H, W, 2)
                "cellprob": (masks > 0).astype(np.float32),     # (N, H, W)
            }
        np.savez(session.data_dir / "train.npz", images=x, **targets)

    # ---- the train loop (runs in a thread) ---------------------------------------

    def _train_loop(self, session: TrainingSession, resume: bool) -> None:
        cfg = session.config
        dev = self.device
        stardist = cfg.get("backbone") == "stardist"
        with np.load(session.data_dir / "train.npz") as data:
            images = data["images"]
            if stardist:
                t_a, t_b = data["prob"], data["dist"]          # (N,H,W), (N,H,W,R)
            else:
                t_a, t_b = data["flows"], data["cellprob"]     # (N,H,W,2), (N,H,W)
        n, H, W = images.shape[:3]
        model, divisor = build_model(cfg)
        # tile must divide through the encoder or the decoder misaligns
        tile = min(cfg["tile"], H, W)
        if tile < divisor:
            raise ValueError(
                f"images ({H}x{W}) smaller than the model's minimum tile "
                f"{divisor} for this backbone config"
            )
        tile = (tile // divisor) * divisor
        # dp over every leased device that divides the batch
        batch = cfg["batch_size"]
        dp = 1
        while dp * 2 <= len(self.devices) and batch % (dp * 2) == 0:
            dp *= 2
        mesh = make_mesh({"dp": dp}, self.devices[:dp])

        rng = np.random.default_rng(cfg["seed"])
        start_epoch = 0
        saved = None
        if resume and session.latest_path.exists():
            start_epoch = len(session.snapshots())
            if session.train_state_path.exists():
                saved = torch.load(session.train_state_path, map_location=dev, weights_only=True)
                model.load_state_dict(saved["module"])
            else:
                model.load_state_dict(state_dict_from_flax(load_params_npz(str(session.latest_path))))
        elif cfg.get("pretrained_path"):
            _load_pretrained(model, cfg["pretrained_path"])
        else:
            model.reset_parameters(cfg["seed"])
        model.to(dev)
        state = TrainState.create(model, cfg["learning_rate"], cfg["weight_decay"])
        if saved is not None:
            state.optimizer.load_state_dict(saved["optimizer"])
            state.step = int(saved["step"])
        state = replicate(mesh, state)
        if stardist:
            step = data_parallel_step(make_stardist_train_step(), mesh)
            R = t_b.shape[-1]
            # flips permute ray indices: rays live at angles 2*pi*r/R with
            # direction (sin, cos); x -> -x maps theta to pi - theta (index
            # R/2 - r), y -> -y maps theta to -theta (index -r)
            h_perm = (R // 2 - np.arange(R)) % R
            v_perm = (-np.arange(R)) % R
        else:
            step = data_parallel_step(make_train_step(), mesh)

        def sample_batch():
            # the JAX app's draws, in its order, so both apps see one stream
            idx = rng.integers(0, n, size=batch)
            ys = rng.integers(0, H - tile + 1, size=batch)
            xs = rng.integers(0, W - tile + 1, size=batch)
            bi = np.empty((batch, tile, tile, 2), np.float32)
            ba = np.empty((batch, tile, tile, *t_a.shape[3:]), np.float32)
            bb = np.empty((batch, tile, tile, *t_b.shape[3:]), np.float32)
            for j, (i, y0, x0) in enumerate(zip(idx, ys, xs)):
                sl = np.s_[y0 : y0 + tile, x0 : x0 + tile]
                im, ta, tb = images[i][sl], t_a[i][sl], t_b[i][sl]
                if rng.random() < 0.5:  # horizontal flip
                    im, ta, tb = im[:, ::-1], ta[:, ::-1], tb[:, ::-1]
                    if stardist:
                        tb = tb[..., h_perm]
                    else:
                        ta = ta * np.array([1.0, -1.0], np.float32)  # x-flow
                if rng.random() < 0.5:  # vertical flip
                    im, ta, tb = im[::-1], ta[::-1], tb[::-1]
                    if stardist:
                        tb = tb[..., v_perm]
                    else:
                        ta = ta * np.array([-1.0, 1.0], np.float32)  # y-flow
                bi[j], ba[j], bb[j] = im, ta, tb
            return _to_model_channels(bi, cfg), ba, bb

        steps_per_epoch = max(1, n * max(H // tile, 1) * max(W // tile, 1) // batch)
        session.write_status(
            status="training",
            total_epochs=cfg["epochs"],
            current_epoch=start_epoch,
            steps_per_epoch=steps_per_epoch,
            mesh={"dp": dp},
        )
        losses = session.read_status().get("losses", [])
        for epoch in range(start_epoch, cfg["epochs"]):
            epoch_losses = []
            for _ in range(steps_per_epoch):
                if session.stop_requested():
                    session.write_status(status="stopped", current_epoch=epoch)
                    return
                sharded = shard_batch(mesh, tuple(torch.from_numpy(a) for a in sample_batch()))
                state, metrics = step(state, *sharded)
                epoch_losses.append(float(metrics["loss"]))
            mean_loss = float(np.mean(epoch_losses))
            losses.append(mean_loss)
            # per-epoch snapshot feeds live inference
            session.save_snapshot(epoch, model.state_dict())
            session.save_train_state(state)
            session.write_status(
                status="training",
                current_epoch=epoch + 1,
                losses=losses,
                last_loss=mean_loss,
            )
        session.write_status(status="completed", current_epoch=cfg["epochs"])

    async def _run_training(self, session: TrainingSession, resume: bool):
        try:
            await asyncio.to_thread(self._train_loop, session, resume)
        except Exception as e:
            session.write_status(status="failed", error=str(e))

    # ---- service API ------------------------------------------------------------

    @schema_method
    async def get_default_config(self, context=None):
        """Training hyperparameters and their defaults."""
        return dict(DEFAULT_CONFIG)

    @schema_method
    async def start_training(
        self,
        train_images: list,
        train_labels: list,
        config: dict | None = None,
        session_id: str | None = None,
        context=None,
    ):
        """Start a fine-tuning session. ``train_images``: list of (H, W)
        or (H, W, C) arrays; ``train_labels``: instance-label masks of
        the same spatial shape. Returns the session id to poll with
        ``get_training_status``."""
        cfg = _merge_config(config)
        session_id = session_id or f"session-{uuid.uuid4().hex[:8]}"
        async with self._lifecycle_lock(session_id):
            existing = self.sessions.get(session_id)
            if existing is not None and await self._busy(existing):
                raise RuntimeError(f"session '{session_id}' already training")
            # a reused id is a fresh run: stale snapshots/data would poison
            # restart_training's epoch counting and live inference
            old_dir = self.sessions_root / session_id
            if old_dir.exists():
                await asyncio.to_thread(shutil.rmtree, old_dir)
            session = TrainingSession(self.sessions_root, session_id, cfg)
            # claim the id with ``preparing`` set before releasing the
            # lock — other mutators fail fast instead of queueing for
            # the whole data preparation below
            session.preparing = True
            self.sessions[session_id] = session
        try:
            (session.dir / "config.json").write_text(json.dumps(cfg))
            session.write_status(
                status="initializing", started_at=time.time(), losses=[],
                n_images=len(train_images),
            )
            await asyncio.to_thread(
                self._prepare_training_data,
                session, train_images, train_labels,
            )
            # spawn before clearing ``preparing`` so there is no instant
            # where the session is neither preparing nor tracked by a task
            session.task = asyncio.create_task(
                self._run_training(session, False)
            )
        except BaseException:
            self.sessions.pop(session_id, None)
            # don't leave a half-initialized dir for _recover_sessions to
            # re-adopt: rename it away at once (atomic, cheap), delete the
            # renamed tree in a thread
            doomed = session.dir.with_name(
                f".{session.dir.name}.deleting-{uuid.uuid4().hex[:8]}"
            )
            try:
                session.dir.rename(doomed)
            except OSError:
                doomed = None
            if doomed is not None:
                await asyncio.to_thread(
                    shutil.rmtree, doomed, ignore_errors=True
                )
            raise
        finally:
            session.preparing = False
        return {"session_id": session_id, "status": "started"}

    @schema_method
    async def stop_training(self, session_id: str, context=None):
        """Request a graceful stop (checked per batch, like the
        reference's stop-file, ref main.py:1278-1360)."""
        async with self._lifecycle_lock(session_id):
            session = self._get_session(session_id)
            session.stop_path.touch()
            if session.task:
                await asyncio.wait([session.task], timeout=30)
            return session.read_status()

    @schema_method
    async def restart_training(self, session_id: str, context=None):
        """Resume a stopped/interrupted/failed session from its latest
        snapshot (ref main.py:4117)."""
        async with self._lifecycle_lock(session_id):
            session = self._get_session(session_id)
            if await self._busy(session):
                raise RuntimeError(f"session '{session_id}' is still running")
            if not (session.data_dir / "train.npz").exists():
                raise RuntimeError(
                    f"session '{session_id}' has no persisted training data"
                )
            session.stop_path.unlink(missing_ok=True)
            session.write_status(status="initializing", error=None)
            session.task = asyncio.create_task(
                self._run_training(session, True)
            )
        return {"session_id": session_id, "status": "restarted"}

    @schema_method
    async def get_training_status(self, session_id: str, context=None):
        """The session's status.json: state, epoch progress, losses."""
        return self._get_session(session_id).read_status()

    @schema_method
    async def list_sessions(self, context=None):
        """All sessions with their current status and snapshot count."""
        return [
            {**s.read_status(), "snapshots": len(s.snapshots())}
            for s in self.sessions.values()
        ]

    async def _busy(self, session) -> bool:
        """True if the session must not be mutated right now.

        status.json is written from inside the train thread, so a
        terminal status can land a beat before the asyncio task itself
        completes — callers that gate on "not training" wait out that
        wind-down here instead of rejecting a session the status file
        already reports finished. Callers must hold the session's
        lifecycle lock: this method can suspend, and the lock is what
        keeps a concurrent mutator from acting in that window.

        A task-less, non-preparing session (re-adopted after an app
        restart, including one that crashed mid-initialization) has
        nothing running in this process and is never busy."""
        if session.preparing:
            return True
        if session.task is None or session.task.done():
            return False
        if session.read_status().get("status") not in _TERMINAL_STATES:
            return True
        try:
            await asyncio.wait_for(asyncio.shield(session.task), timeout=30)
        except asyncio.TimeoutError:
            return True
        return False

    @schema_method
    async def delete_session(self, session_id: str, context=None):
        """Remove a session directory (must not be training)."""
        async with self._lifecycle_lock(session_id):
            session = self._get_session(session_id)
            if await self._busy(session):
                raise RuntimeError(f"stop session '{session_id}' first")
            # deregister first so infer/export on this id fail fast
            # instead of racing the threaded rmtree below
            self.sessions.pop(session_id, None)
            await asyncio.to_thread(
                shutil.rmtree, session.dir, ignore_errors=True
            )
        return {"deleted": session_id}

    @schema_method
    async def infer(
        self,
        session_id: str,
        images: list,
        cellprob_threshold: float = 0.0,
        min_size: int = 15,
        context=None,
    ):
        """Segment images with the session's latest snapshot — live
        inference against a training run works because snapshots are
        written atomically per epoch."""
        session = self._get_session(session_id)
        if not session.latest_path.exists():
            raise RuntimeError(
                f"session '{session_id}' has no snapshot yet"
            )
        try:
            masks = await asyncio.to_thread(
                self._infer, session, images, cellprob_threshold, min_size
            )
        except FileNotFoundError as exc:
            # an in-flight call can race delete_session's threaded rmtree
            # after the id is deregistered — surface a clean error
            raise RuntimeError(f"session '{session_id}' was deleted") from exc
        return {
            "masks": masks,
            "n_cells": [int(m.max()) for m in masks],
            "snapshot": session.snapshots()[-1] if session.snapshots() else None,
        }

    def _load_snapshot(self, session) -> dict:
        """The latest snapshot as a ``state_dict`` (CPU tensors)."""
        return state_dict_from_flax(load_params_npz(str(session.latest_path)))

    def _predict_raw(self, session, x: np.ndarray, state=None) -> np.ndarray:
        """(N, H, W, 2) prepared batch -> raw network output: (N, H, W, 3)
        (dy, dx, cellprob logits), or (N, H, W, 1 + n_rays) (probability
        logit, ray distances) for stardist. ``state`` preloaded via
        ``_load_snapshot`` keeps multi-pass callers (infer_3d's three
        orientations) on ONE snapshot even while training is writing new
        ones; None loads the latest."""
        cfg = session.config
        if state is None:
            state = self._load_snapshot(session)
        x = _to_model_channels(x, cfg)
        H, W = x.shape[1:3]
        key = _arch_key(cfg)
        with self._infer_lock:
            model = self._infer_models.get(key)
            if model is None:
                model, _ = build_model(cfg)
                # inference-module memo: bounded by distinct architecture
                # keys, and evicting on session delete would rebuild the
                # module for siblings sharing the arch
                # bioengine: ignore[BE-LIFE-401]
                model = self._infer_models[key] = model.to(self.device).eval()
            model.load_state_dict(state)
            bh, bw = bucket_shape((H, W), divisor=model.divisor)
            batch = torch.from_numpy(np.ascontiguousarray(pad_to(x, (bh, bw))))
            with torch.inference_mode():
                pred = model(batch.to(self.device)).cpu().numpy()
        return crop_to(pred, (H, W))

    def _infer(self, session, images, cellprob_threshold, min_size):
        pred = self._predict_raw(session, self._prepare_images(images))
        if session.config.get("backbone") == "stardist":
            # the caller's threshold is a logit for both families (0.0 =
            # probability 0.5); stardist's NMS takes a probability
            prob_threshold = float(1.0 / (1.0 + np.exp(-cellprob_threshold)))
            return [
                predictions_to_masks_stardist(p, prob_threshold=prob_threshold, min_size=min_size)
                for p in pred
            ]
        return [
            predictions_to_masks(
                p, cellprob_threshold=cellprob_threshold, min_size=min_size,
                device=self.device,
            )
            for p in pred
        ]

    @schema_method
    async def infer_3d(
        self,
        session_id: str,
        volumes: list,
        cellprob_threshold: float = 0.0,
        min_size: int = 15,
        anisotropy: float = 1.0,
        context=None,
    ):
        """Segment (D, H, W) grayscale volumes with the session's 2D
        model via the cellpose ``do_3D`` recipe: the network runs over
        yx, zx, and zy slice orientations, shared flow components are
        averaged into one (dz, dy, dx) field, and voxels are followed
        to 3D sinks (ops/flows.py). ``anisotropy`` = z-spacing /
        xy-spacing: the stack is resampled along z by this factor first
        so cells appear isotropic to the 2D network, and the masks are
        resampled back. The reference delegates all of this to the
        upstream cellpose library; here it is first-class and the flow
        following runs jitted on TPU."""
        session = self._get_session(session_id)
        if session.config.get("backbone") == "stardist":
            raise RuntimeError(
                "infer_3d needs flow-field outputs (the cellpose do_3D "
                "recipe); the stardist backbone predicts 2D polygons — "
                "use infer per z-slice instead"
            )
        if not session.latest_path.exists():
            raise RuntimeError(f"session '{session_id}' has no snapshot yet")
        if anisotropy <= 0:
            raise ValueError(f"anisotropy must be positive, got {anisotropy}")
        try:
            masks = await asyncio.to_thread(
                self._infer_3d, session, volumes, cellprob_threshold,
                min_size, anisotropy,
            )
        except FileNotFoundError as exc:
            # same delete_session race as ``infer``
            raise RuntimeError(f"session '{session_id}' was deleted") from exc
        return {
            "masks": masks,
            "n_cells": [int(m.max()) for m in masks],
            "snapshot": session.snapshots()[-1] if session.snapshots() else None,
        }

    def _infer_3d(
        self, session, volumes, cellprob_threshold, min_size, anisotropy=1.0
    ):
        from scipy import ndimage as ndi

        # one snapshot for the whole request: the three orientation
        # passes must not mix weights while training writes new epochs
        state = self._load_snapshot(session)
        out = []
        for vol in volumes:
            v = np.array(vol, np.float32, copy=True)
            if v.ndim != 3:
                raise ValueError(
                    f"infer_3d expects (D, H, W) grayscale volumes, "
                    f"got shape {v.shape}"
                )
            orig_depth = v.shape[0]
            if anisotropy != 1.0:
                # make voxels isotropic for the 2D net's zx/zy passes;
                # the explicit factor guarantees >= 1 output plane
                new_depth = max(1, int(round(orig_depth * anisotropy)))
                v = ndi.zoom(v, (new_depth / orig_depth, 1.0, 1.0), order=1)
            # actual resampling ratio: min_size scales by this, not by the
            # raw parameter
            depth_ratio = v.shape[0] / orig_depth
            # normalize the whole volume once — per-slice percentile
            # normalization would flicker along the slicing axis
            lo, hi = np.percentile(v, [1, 99])
            v = (v - lo) / max(hi - lo, 1e-6)
            preds = []
            for axes in ((0, 1, 2), (1, 0, 2), (2, 0, 1)):  # yx, zx, zy
                slices = np.ascontiguousarray(np.transpose(v, axes))
                x = np.stack([slices, np.zeros_like(slices)], axis=-1)
                preds.append(self._predict_raw(session, x, state=state))
            flow, cellprob = aggregate_orthogonal_flows(*preds)
            masks = masks_from_flows(
                flow / FLOW_SCALE,
                cellprob,
                cellprob_threshold=cellprob_threshold,
                min_size=max(1, int(round(min_size * depth_ratio))),
                device=self.device,
            )
            if masks.shape[0] != orig_depth:
                # nearest-neighbour back to the caller's z sampling —
                # labels must not be interpolated
                masks = ndi.zoom(
                    masks, (orig_depth / masks.shape[0], 1.0, 1.0), order=0
                )
                masks = masks[:orig_depth]
                if masks.shape[0] < orig_depth:
                    masks = np.pad(
                        masks,
                        ((0, orig_depth - masks.shape[0]), (0, 0), (0, 0)),
                        mode="edge",
                    )
                # resampling can erase whole instances: re-filter and
                # re-label so n_cells == masks.max() stays truthful
                masks = filter_and_relabel(masks, min_size)
            out.append(masks)
        return out

    @schema_method
    async def export_model(
        self,
        session_id: str,
        model_name: str | None = None,
        context=None,
    ):
        """Package the session's latest snapshot as a model-runner-ready
        ``jax_params`` model directory (rdf.yaml + weights.npz + test
        tensors) — the TPU analog of the reference's BioImage Model Zoo
        export (ref main.py:4413+, model_template.py:18)."""
        session = self._get_session(session_id)
        cfg = session.config
        if not session.latest_path.exists():
            raise RuntimeError(f"session '{session_id}' has no snapshot")
        stardist = cfg.get("backbone") == "stardist"
        family = "stardist" if stardist else "cellpose"
        name = model_name or f"{family}-{session_id}"
        export_dir = self.sessions_root / "exports" / name
        export_dir.mkdir(parents=True, exist_ok=True)
        await asyncio.to_thread(
            shutil.copyfile, session.latest_path, export_dir / "weights.npz"
        )
        rdf = {
            "type": "model",
            "name": name,
            "description": (
                f"StarDist star-convex polygon model (prob + "
                f"{cfg.get('n_rays')} ray distances) fine-tuned in "
                f"BioEngine session {session_id}"
                if stardist
                else f"Cellpose flow-field model fine-tuned in BioEngine "
                f"session {session_id}"
            ),
            "tags": [family, "segmentation", "fine-tuned"],
            "inputs": [{"name": "input0", "axes": "byxc"}],
            "outputs": [{"name": "output0", "axes": "byxc"}],
            "weights": {
                "jax_params": {
                    "source": "weights.npz",
                    "architecture": _arch_entry(cfg),
                }
            },
            "training": {
                "session_id": session_id,
                "config": cfg,
                "final_loss": session.read_status().get("last_loss"),
            },
        }
        (export_dir / "rdf.yaml").write_text(_dump_rdf(rdf))
        return {
            "model_path": str(export_dir),
            "name": name,
            "weights_format": "jax_params",
        }

    def _get_session(self, session_id: str) -> TrainingSession:
        if session_id not in self.sessions:
            raise KeyError(
                f"unknown session '{session_id}' "
                f"(have: {sorted(self.sessions)})"
            )
        return self.sessions[session_id]
