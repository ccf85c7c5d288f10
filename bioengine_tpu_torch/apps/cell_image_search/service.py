"""Cell Morphology Search Engine on PyTorch.

Counterpart of ``CellImageSearch`` in ``apps/cell-image-search/main.py``,
with the same ``@schema_method``s (each takes ``context``): ``ping``,
``get_index_stats``; ``list_datasets`` / ``add_dataset`` /
``remove_dataset``; ``start_ingestion`` / ``get_ingestion_status`` /
``stop_ingestion`` / ``get_active_sessions``; ``search`` with the query's
position on the 2-D map; ``get_umap_preview`` and
``project_query_onto_umap``. The embedder runs on the card (the
flash-attention kernel in every bucket), index training on the same device.
The datasets-plane client is ``bioengine_datasets``: passed in as
``datasets_client``, or attached by the app builder when the worker
deploys the bundle (``apps/bundles/cell-image-search``).
"""

from __future__ import annotations

import asyncio
import os
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from bioengine_tpu_torch.apps.cell_image_search.embedder import ViTEmbedder
from bioengine_tpu_torch.apps.cell_image_search.index import (
    compute_projection,
    load_index,
    project_query,
    search_index,
)
from bioengine_tpu_torch.apps.cell_image_search.ingestion import (
    IngestionStatus,
    load_registry,
    make_synthetic_images,
    read_status,
    request_stop,
    run_ingestion,
    save_registry,
    session_dir,
    upsert_registry,
    write_status,
)
from bioengine_tpu_torch.apps.cell_image_search.normalizer import (
    decode_image_bytes,
)
from bioengine_tpu_torch.rpc import schema_method
from bioengine_tpu_torch.runtime.devices import (
    DeviceLike,
    device_name,
    resolve_device,
    resolve_devices,
)


class CellImageSearch:
    def __init__(
        self,
        workspace_dir: str = "~/.bioengine/cell-image-search",
        weights_path: Optional[str] = None,
        batch_bucket: int = 64,
        crop_size: int = 224,
        n_crops_per_image: int = 50,
        device: DeviceLike = None,
        seed: int = 0,
        model_overrides: Optional[dict[str, Any]] = None,
        # a datasets-plane client (async list_datasets/list_files/get_file,
        # ``available``) for the 'datasets' source; without one the app
        # builder attaches the worker's
        datasets_client: Any = None,
    ):
        self.device = resolve_device(device)
        self.devices = [self.device]
        self.workspace_dir = Path(workspace_dir).expanduser()
        self.workspace_dir.mkdir(parents=True, exist_ok=True)
        self.embedder = ViTEmbedder(
            weights_path=weights_path,
            batch_bucket=batch_bucket,
            device=self.device,
            seed=seed,
            model_overrides=model_overrides,
        )
        self.crop_size = crop_size
        self.n_crops_per_image = n_crops_per_image
        if datasets_client is not None:
            self.bioengine_datasets = datasets_client
        self.started_at = time.time()
        self._index = None
        self._metadata: Optional[list[dict]] = None
        self._index_info: dict = {}
        self._sessions: dict[str, asyncio.Task] = {}
        self._index_lock = asyncio.Lock()

    # ---- lifecycle hooks --------------------------------------------------

    async def async_init(self):
        """The replica lifecycle injects the leased chip group
        (``bioengine_device_ids``) before this runs (``resolve_devices``: a
        lease naming no such device is refused, never remapped). The
        embedder is data parallel over the group; the index and ingestion
        run on its first device."""
        lease = getattr(self, "bioengine_device_ids", None)
        self.devices = resolve_devices(list(lease) if lease else None, self.device)
        self.device = self.devices[0]
        self.embedder.devices = self.devices  # the model loads on first use
        await self._try_load_index()

    async def test_deployment(self):
        """Embed one synthetic field and check the embedding. The field is
        drawn at the model's input size, so no resize (and no Pillow) is
        needed."""
        _, img = next(
            iter(make_synthetic_images(n_images=1, size=self.embedder.INPUT_SIZE))
        )
        emb = await asyncio.to_thread(self.embedder.embed_single, img)
        if emb.shape != (self.embedder.embed_dim,):
            raise RuntimeError(f"embedding shape {emb.shape}")
        norm = float(np.linalg.norm(emb))
        if abs(norm - 1.0) >= 1e-3:
            raise RuntimeError(f"embedding not unit-norm: {norm}")

    async def check_health(self):
        if not self.embedder.loaded:
            raise RuntimeError("embedder not loaded")

    async def _try_load_index(self) -> bool:
        try:
            index, metadata, info = await asyncio.to_thread(
                load_index, self.workspace_dir, self.device
            )
        except FileNotFoundError:
            return False
        self._index, self._metadata, self._index_info = index, metadata, info
        return True

    # ---- status -----------------------------------------------------------

    @schema_method
    async def ping(self, context=None):
        """Liveness + device summary."""
        cuda = self.device.type == "cuda"
        return {
            "status": "ok",
            "uptime_seconds": time.time() - self.started_at,
            "backend": self.device.type,
            "device_name": device_name(self.device),
            "n_devices": torch.cuda.device_count() if cuda else 1,
            "embedder_loaded": self.embedder.loaded,
            "pretrained": self.embedder.pretrained,
            "index_loaded": self._index is not None,
        }

    @schema_method
    async def get_index_stats(self, context=None):
        """Index size/type/build stats, or {loaded: False}."""
        if self._index is None and not await self._try_load_index():
            return {"loaded": False, "n_cells": 0}
        return {
            "loaded": True,
            "n_cells": self._index.ntotal,
            "index_type": self._index.kind,
            **self._index_info,
        }

    # ---- dataset registry --------------------------------------------------

    @schema_method
    async def list_datasets(self, context=None):
        """Registered ingestion sources + datasets-plane datasets."""
        registered = load_registry(self.workspace_dir)
        remote = []
        client = getattr(self, "bioengine_datasets", None)
        if client is not None and client.available:
            try:
                remote = await client.list_datasets()
            except Exception:  # the plane is optional: list what is local
                remote = []
        return {"registered": registered, "data_server": remote}

    @schema_method
    async def add_dataset(
        self,
        name: str,
        source: str = "synthetic",
        path: Optional[str] = None,
        n_images: int = 8,
        image_size: int = 896,
        context=None,
    ):
        """Register an ingestion source. source: 'synthetic' (demo
        generator), 'local' (directory on the worker), or 'datasets'
        (a dataset served by the framework's data server)."""
        if source not in ("synthetic", "local", "datasets"):
            raise ValueError(f"unknown source '{source}'")
        if source == "local" and not path:
            raise ValueError("source 'local' requires path")
        entry = {
            "name": name,
            "source": source,
            "path": path,
            "n_images": n_images,
            "image_size": image_size,
            "added_at": time.time(),
        }
        upsert_registry(self.workspace_dir, entry)
        return {"added": True, "dataset": entry}

    @schema_method
    async def remove_dataset(self, name: str, context=None):
        """Drop a dataset from the registry."""
        registry = load_registry(self.workspace_dir)
        kept = [r for r in registry if r.get("name") != name]
        save_registry(self.workspace_dir, kept)
        return {"removed": len(kept) < len(registry)}

    # ---- ingestion ---------------------------------------------------------

    @schema_method
    async def start_ingestion(
        self,
        dataset_name: str,
        session_id: Optional[str] = None,
        n_crops_per_image: Optional[int] = None,
        context=None,
    ):
        """Launch background ingestion of a registered dataset; returns
        the session id to poll with get_ingestion_status."""
        entry = next(
            (
                r
                for r in load_registry(self.workspace_dir)
                if r.get("name") == dataset_name
            ),
            None,
        )
        if entry is None:
            raise ValueError(
                f"dataset '{dataset_name}' not registered — add_dataset first"
            )
        session_id = session_id or f"ingest-{int(time.time())}"
        live = self._sessions.get(session_id)
        if live is not None and not live.done():
            raise RuntimeError(f"session '{session_id}' already running")
        # prune finished task handles so the registry tracks only live
        # runs — session history lives on disk (status.json), not here
        for sid in [s for s, t in self._sessions.items() if t.done()]:
            self._sessions.pop(sid, None)
        # fresh session dir per run
        sdir = session_dir(self.workspace_dir, session_id)
        if sdir.exists():
            # rename synchronously so a concurrent start for the same
            # session_id can't pass the liveness guard mid-delete and
            # race on the session dir; delete the renamed tree off-loop
            doomed = sdir.with_name(f".{sdir.name}.deleting-{os.getpid()}")
            sdir.rename(doomed)
            await asyncio.to_thread(shutil.rmtree, doomed)
        write_status(
            self.workspace_dir, session_id,
            IngestionStatus.WAITING, "Queued",
            dataset_name=dataset_name,
        )
        dataset = dict(entry)
        if dataset["source"] == "datasets":
            dataset["client"] = getattr(self, "bioengine_datasets", None)

        async def _run():
            try:
                async with self._index_lock:
                    await run_ingestion(
                        workspace_dir=self.workspace_dir,
                        session_id=session_id,
                        dataset=dataset,
                        embedder=self.embedder,
                        crop_size=self.crop_size,
                        n_crops_per_image=(
                            n_crops_per_image or self.n_crops_per_image
                        ),
                        batch_bucket=self.embedder.batch_bucket,
                        device=self.device,
                    )
                    await self._try_load_index()
            except Exception as e:  # the session's status carries the error
                write_status(
                    self.workspace_dir, session_id,
                    IngestionStatus.FAILED, f"Error: {e}",
                )

        self._sessions[session_id] = asyncio.create_task(_run())
        return {"session_id": session_id, "status": "started"}

    @schema_method
    async def get_ingestion_status(self, session_id: str, context=None):
        """Poll a session's status.json."""
        return read_status(self.workspace_dir, session_id)

    @schema_method
    async def stop_ingestion(self, session_id: str, context=None):
        """Request a running session to stop (between images)."""
        request_stop(self.workspace_dir, session_id)
        return {"session_id": session_id, "stop_requested": True}

    @schema_method
    async def get_active_sessions(self, context=None):
        """All known sessions with their latest status."""
        root = session_dir(self.workspace_dir, "x").parent
        sessions = {}
        if root.exists():
            for d in sorted(root.iterdir()):
                # skip '.{name}.deleting-*' rename-away trees (crashed
                # mid-delete) and other hidden dirs — not sessions
                if d.is_dir() and not d.name.startswith("."):
                    sessions[d.name] = read_status(self.workspace_dir, d.name)
        return sessions

    # ---- search ------------------------------------------------------------

    @schema_method
    async def search(
        self,
        image: Any = None,
        image_bytes: Optional[bytes] = None,
        top_k: int = 20,
        context=None,
    ):
        """Find morphologically similar cells. ``image`` is any microscopy
        array (1-5 channels); ``image_bytes`` a PNG/JPEG/TIFF (needs
        Pillow). Returns ranked matches with their metadata and the query's
        position on the 2-D map (None before ``get_umap_preview``)."""
        if self._index is None and not await self._try_load_index():
            raise RuntimeError("no index built yet — run ingestion first")
        if image is None and image_bytes is None:
            raise ValueError("provide image or image_bytes")
        if image is None:
            image = decode_image_bytes(image_bytes)
        t0 = time.time()
        query = await asyncio.to_thread(
            self.embedder.embed_single, np.asarray(image)
        )
        t_embed = time.time() - t0
        t0 = time.time()
        results = await asyncio.to_thread(
            search_index, self._index, self._metadata, query, top_k
        )
        t_search = time.time() - t0
        return {
            "results": results,
            "n_results": len(results),
            "embed_ms": round(t_embed * 1000, 2),
            "search_ms": round(t_search * 1000, 2),
            "query_projection": project_query(self.workspace_dir, query),
        }

    # ---- projection (UMAP-analog) -----------------------------------------

    @schema_method
    async def get_umap_preview(
        self,
        n_samples: int = 10_000,
        force_recompute: bool = False,
        context=None,
    ):
        """2-D projection of an index sample for the dashboard scatter
        (PCA projector, cached with components so queries map into the
        same space)."""
        return await asyncio.to_thread(
            compute_projection,
            self.workspace_dir,
            n_samples,
            42,
            force_recompute,
            self.device,
        )

    @schema_method
    async def project_query_onto_umap(self, image: Any, context=None):
        """Embed an image and return its position on the cached 2-D map."""
        query = await asyncio.to_thread(
            self.embedder.embed_single, np.asarray(image)
        )
        pos = project_query(self.workspace_dir, query)
        if pos is None:
            raise RuntimeError(
                "no projection cache — call get_umap_preview first"
            )
        return pos
