"""Ingestion: dataset → cell crops → embeddings on the device → index.

Counterpart of ``apps/cell-image-search/ingestion.py``: session
directories with an atomically written ``status.json`` and a
``stop_requested`` file, crop extraction around nuclei (Otsu threshold +
labelled blobs, the grid fallback below 10 blobs), batched embedding,
``run_ingestion`` with the same flush per bucket, stop check per image,
status cadence and metadata rows, and the ``dataset_registry.json`` of
ingestion sources. Sources are the synthetic generator, local directories
of npy/npz/png/tif images, and the framework's datasets plane through any
client with ``list_files``/``get_file`` passed in (the plane's own client
is not ported yet). The index is the port's ``index.build_index``, trained
on the embedder's device; metadata rows stay JSON.
"""

from __future__ import annotations

import asyncio
import json
import time
from enum import Enum
from pathlib import Path
from typing import Any, Optional

import numpy as np

from bioengine_tpu_torch.apps.cell_image_search.index import build_index
from bioengine_tpu_torch.apps.cell_image_search.normalizer import (
    decode_image_bytes,
    percentile_stretch,
)
from bioengine_tpu_torch.runtime.devices import DeviceLike


class IngestionStatus(str, Enum):
    WAITING = "waiting"
    PREPARING = "preparing"
    RUNNING = "running"
    BUILDING_INDEX = "building_index"
    COMPLETED = "completed"
    STOPPED = "stopped"
    FAILED = "failed"


def session_dir(workspace_dir: str | Path, session_id: str) -> Path:
    return Path(workspace_dir).expanduser() / "sessions" / session_id


def write_status(
    workspace_dir: str | Path,
    session_id: str,
    status: IngestionStatus,
    message: str,
    n_embedded: Optional[int] = None,
    n_total: Optional[int] = None,
    throughput_per_sec: Optional[float] = None,
    elapsed_seconds: Optional[float] = None,
    dataset_name: str = "",
    log_lines: Optional[list[str]] = None,
    **extra: Any,
) -> None:
    """Counters default to None = keep the previous values, so a
    terminal FAILED/STOPPED write never wipes accumulated progress."""
    path = session_dir(workspace_dir, session_id) / "status.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    existing: dict = {}
    if path.exists():
        try:
            existing = json.loads(path.read_text())
        except (OSError, ValueError):
            existing = {}  # unreadable/corrupt status: start fresh
    prev_log = existing.get("log_tail", [])
    if log_lines:
        prev_log = (prev_log + list(log_lines))[-20:]
    if n_embedded is None:
        n_embedded = existing.get("n_embedded", 0)
    if n_total is None:
        n_total = existing.get("n_total", 0)
    if throughput_per_sec is None:
        throughput_per_sec = existing.get("throughput_per_sec", 0.0)
    if elapsed_seconds is None:
        elapsed_seconds = existing.get("elapsed_seconds", 0.0)
    data = {
        **existing,
        "status": status.value,
        "message": message,
        "dataset_name": dataset_name or existing.get("dataset_name", ""),
        "n_embedded": n_embedded,
        "n_total": n_total,
        "progress_pct": round(100.0 * n_embedded / max(n_total, 1), 1),
        "throughput_per_sec": round(throughput_per_sec, 1),
        "elapsed_seconds": round(elapsed_seconds, 1),
        "eta_seconds": round(
            max(n_total - n_embedded, 0) / max(throughput_per_sec, 0.1)
        ),
        "log_tail": prev_log,
        "updated_at": time.time(),
        **extra,
    }
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(data, indent=2))
    tmp.replace(path)  # atomic — readers never see a partial file


def read_status(workspace_dir: str | Path, session_id: str) -> dict:
    path = session_dir(workspace_dir, session_id) / "status.json"
    if not path.exists():
        return {
            "status": IngestionStatus.WAITING.value,
            "message": "Not started",
        }
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return {"status": "unknown", "message": "Error reading status"}


def is_stop_requested(workspace_dir: str | Path, session_id: str) -> bool:
    return (session_dir(workspace_dir, session_id) / "stop_requested").exists()


def request_stop(workspace_dir: str | Path, session_id: str) -> None:
    p = session_dir(workspace_dir, session_id) / "stop_requested"
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text("1")


# ---------------------------------------------------------------------------
# crop extraction
# ---------------------------------------------------------------------------


def _otsu_threshold(img_u8: np.ndarray) -> float:
    """Otsu's method on a uint8 image (scipy/numpy — skimage-free)."""
    hist = np.bincount(img_u8.ravel(), minlength=256).astype(np.float64)
    total = hist.sum()
    w0 = np.cumsum(hist)
    w1 = total - w0
    mu = np.cumsum(hist * np.arange(256))
    mu_t = mu[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        between = (mu_t * w0 - mu) ** 2 / (w0 * w1)
    between[~np.isfinite(between)] = -1
    return float(np.argmax(between))


def extract_cell_crops(
    image: np.ndarray,
    crop_size: int = 224,
    n_crops: int = 100,
    min_area: int = 200,
    dna_channel: int = 0,
) -> list[np.ndarray]:
    """Find nuclei (threshold + connected components on the DNA
    channel) and crop ``crop_size`` windows around their centroids;
    grid fallback when segmentation finds <10 blobs."""
    from scipy import ndimage

    H, W = image.shape[:2]
    half = crop_size // 2
    centroids: list[tuple[int, int]] = []
    try:
        dna = (
            image[..., dna_channel] if image.ndim == 3 else image
        ).astype(np.float32)
        dna_u8 = percentile_stretch(dna)
        mask = dna_u8 > _otsu_threshold(dna_u8)
        labels, n_labels = ndimage.label(mask)
        if n_labels:
            areas = ndimage.sum_labels(
                np.ones_like(labels), labels, index=np.arange(1, n_labels + 1)
            )
            keep = np.where(areas > min_area)[0] + 1
            if keep.size:
                coms = ndimage.center_of_mass(mask, labels, keep.tolist())
                order = np.argsort(-areas[keep - 1])
                centroids = [
                    (int(coms[j][0]), int(coms[j][1])) for j in order
                ][:n_crops]
    except Exception:
        centroids = []
    if len(centroids) < 10:
        stride = max(
            crop_size, min(H, W) // max(1, int(np.sqrt(n_crops)))
        )
        # range() starts at the first valid centre (half)
        centroids = [
            (y, x)
            for y in range(half, H - half + 1, stride)
            for x in range(half, W - half + 1, stride)
        ][:n_crops]
    crops = []
    for cy, cx in centroids[:n_crops]:
        y0, y1 = cy - half, cy + half
        x0, x1 = cx - half, cx + half
        if y0 < 0 or y1 > H or x0 < 0 or x1 > W:
            continue
        crops.append(image[y0:y1, x0:x1])
    return crops


def make_synthetic_images(
    n_images: int = 8, size: int = 896, n_cells: int = 30, seed: int = 0
):
    """Generator of (name, (H, W) float32) synthetic fluorescence fields
    with gaussian-blob nuclei — the egress-free demo/test source."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: size, : size]
    for i in range(n_images):
        img = rng.normal(40, 5, (size, size)).astype(np.float32)
        for _ in range(n_cells):
            cy, cx = rng.integers(60, size - 60, 2)
            r = rng.integers(12, 25)
            blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r**2)))
            img += 400.0 * blob.astype(np.float32)
        yield f"synthetic_{i:04d}", img


def iter_local_images(path: str | Path):
    """Yield (name, array) from a directory of npy/npz/png/tif files."""
    base = Path(path).expanduser()
    exts = {".npy", ".npz", ".png", ".jpg", ".jpeg", ".tif", ".tiff"}
    for f in sorted(base.rglob("*")):
        if not f.is_file() or f.suffix.lower() not in exts:
            continue
        if f.suffix.lower() == ".npy":
            yield f.name, np.load(f)
        elif f.suffix.lower() == ".npz":
            with np.load(f) as data:
                for key in data.files:
                    yield f"{f.name}:{key}", data[key]
        else:
            yield f.name, decode_image_bytes(f.read_bytes())


async def iter_dataset_images(datasets_client, dataset_name: str):
    """Async generator of (name, array) from a datasets-plane client (any
    object with async ``list_files``/``get_file``). ``.zarr`` arrays yield
    2-D planes (or (C, H, W) channel stacks when the leading axis is
    small); other image files decode from bytes."""
    files = await datasets_client.list_files(dataset_name)
    img_exts = (".png", ".jpg", ".jpeg", ".tif", ".tiff")
    for f in files:
        fname = f["name"] if isinstance(f, dict) else f
        if fname.endswith(".zarr"):
            handle = await datasets_client.get_file(dataset_name, fname)
            if hasattr(handle, "read"):
                arrays = [handle]
            else:
                arrays = [
                    await handle.array(m) for m in await handle.members()
                ]
            for arr in arrays:
                if arr.ndim == 2:
                    yield fname, await arr.read()
                elif arr.ndim == 3 and arr.shape[0] <= 5:
                    # (C, H, W) multichannel plane
                    yield fname, await arr.read()
                else:
                    # iterate the leading axis as separate planes
                    for z in range(arr.shape[0]):
                        plane = await arr.read((slice(z, z + 1),))
                        yield f"{fname}[{z}]", np.squeeze(plane, axis=0)
        elif fname.lower().endswith(img_exts):
            data = await datasets_client.get_file(dataset_name, fname)
            yield fname, decode_image_bytes(data)


# ---------------------------------------------------------------------------
# ingestion runner
# ---------------------------------------------------------------------------


async def run_ingestion(
    *,
    workspace_dir: str | Path,
    session_id: str,
    dataset: dict,
    embedder,
    crop_size: int = 224,
    n_crops_per_image: int = 50,
    batch_bucket: int = 64,
    status_every: float = 2.0,
    device: DeviceLike = None,
) -> dict:
    """Stream images → crops → embeddings, then build the index.

    ``dataset``: {"name", "source": "synthetic"|"local"|"datasets",
    "path"/"n_images"/"client"...}. Embedding runs in a thread (PyTorch
    releases the GIL while the device works); status.json updates
    atomically for pollers; the stop file aborts between images. The index
    trains on ``device`` (the card unless ``device="cpu"``)."""
    t0 = time.time()
    ws = Path(workspace_dir).expanduser()
    name = dataset.get("name", "dataset")
    write_status(
        ws, session_id, IngestionStatus.PREPARING,
        f"Preparing ingestion of '{name}'", dataset_name=name,
    )

    async def _as_async(sync_iter):
        # pull each item off-loop: local-source iteration np.loads /
        # PNG-decodes full images, which would stall query traffic
        # sharing this event loop
        it = iter(sync_iter)
        sentinel = object()
        while True:
            item = await asyncio.to_thread(next, it, sentinel)
            if item is sentinel:
                return
            yield item

    source = dataset.get("source", "synthetic")
    est_total = 0
    if source == "synthetic":
        images = _as_async(
            make_synthetic_images(
                n_images=int(dataset.get("n_images", 8)),
                size=int(dataset.get("image_size", 896)),
                seed=int(dataset.get("seed", 0)),
            )
        )
        est_total = int(dataset.get("n_images", 8)) * n_crops_per_image
    elif source == "local":
        images = _as_async(iter_local_images(dataset["path"]))
    elif source == "datasets":
        client = dataset.get("client")
        if client is None:
            raise ValueError(
                "source 'datasets' needs the deployment's datasets client"
            )
        images = iter_dataset_images(client, dataset["name"])
    else:
        raise ValueError(f"unknown ingestion source '{source}'")

    embeddings: list[np.ndarray] = []
    metadata: list[dict] = []
    pending: list[np.ndarray] = []
    pending_meta: list[dict] = []
    n_embedded = 0
    last_status = 0.0

    def flush():
        nonlocal n_embedded
        if not pending:
            return
        embs = embedder.embed_batch(pending, batch_size=batch_bucket)
        embeddings.append(embs)
        metadata.extend(pending_meta)
        n_embedded += len(pending)
        pending.clear()
        pending_meta.clear()

    async for img_name, img in images:
        if is_stop_requested(ws, session_id):
            write_status(
                ws, session_id, IngestionStatus.STOPPED,
                "Stopped by user", n_embedded=n_embedded,
                n_total=max(est_total, n_embedded),
                elapsed_seconds=time.time() - t0,
            )
            return {"status": "stopped", "n_embedded": n_embedded}
        crops = extract_cell_crops(
            img, crop_size=crop_size, n_crops=n_crops_per_image
        )
        for j, crop in enumerate(crops):
            pending.append(crop)
            pending_meta.append(
                {"dataset": name, "image": img_name, "crop": j}
            )
            if len(pending) >= batch_bucket:
                await asyncio.to_thread(flush)
        now = time.time()
        if now - last_status > status_every:
            last_status = now
            write_status(
                ws, session_id, IngestionStatus.RUNNING,
                f"Embedding '{img_name}'",
                n_embedded=n_embedded,
                n_total=max(est_total, n_embedded + len(pending)),
                throughput_per_sec=n_embedded / max(now - t0, 1e-6),
                elapsed_seconds=now - t0,
                dataset_name=name,
            )
    await asyncio.to_thread(flush)

    if n_embedded == 0:
        write_status(
            ws, session_id, IngestionStatus.FAILED,
            "No cells found in dataset",
            elapsed_seconds=time.time() - t0,
        )
        return {"status": "failed", "n_embedded": 0}

    write_status(
        ws, session_id, IngestionStatus.BUILDING_INDEX,
        f"Building index over {n_embedded} cells",
        n_embedded=n_embedded, n_total=n_embedded,
        elapsed_seconds=time.time() - t0,
    )

    all_embeddings = np.vstack(embeddings)
    stats = await asyncio.to_thread(
        build_index, all_embeddings, metadata, ws, device=device
    )
    elapsed = time.time() - t0
    write_status(
        ws, session_id, IngestionStatus.COMPLETED,
        f"Ingested {n_embedded} cells in {elapsed:.1f}s",
        n_embedded=n_embedded, n_total=n_embedded,
        throughput_per_sec=n_embedded / max(elapsed, 1e-6),
        elapsed_seconds=elapsed,
        index=stats,
    )
    return {"status": "completed", "n_embedded": n_embedded, **stats}


# ---------------------------------------------------------------------------
# dataset registry
# ---------------------------------------------------------------------------


def registry_path(workspace_dir: str | Path) -> Path:
    return Path(workspace_dir).expanduser() / "dataset_registry.json"


def load_registry(workspace_dir: str | Path) -> list[dict]:
    p = registry_path(workspace_dir)
    if not p.exists():
        return []
    try:
        return json.loads(p.read_text())
    except (OSError, ValueError):
        return []


def save_registry(workspace_dir: str | Path, registry: list[dict]) -> None:
    p = registry_path(workspace_dir)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(registry, indent=2))
    tmp.replace(p)


def upsert_registry(workspace_dir: str | Path, entry: dict) -> None:
    registry = load_registry(workspace_dir)
    registry = [r for r in registry if r.get("name") != entry.get("name")]
    registry.append(entry)
    save_registry(workspace_dir, registry)
