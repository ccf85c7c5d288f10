"""Cell Morphology Search Engine on PyTorch.

Counterpart of ``CellImageSearch`` in ``apps/cell-image-search/main.py``:
``test_deployment``, ``check_health``, ``ping``, ``get_index_stats`` and
``search``, as plain ``async`` methods. Ingestion sessions, the dataset
registry, the 2-D projection and the RPC serving plane are not ported yet;
an index is built with ``index.build_index`` from embeddings of
``embedder.embed_batch``.
"""

from __future__ import annotations

import asyncio
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from bioengine_tpu_torch.apps.cell_image_search.embedder import ViTEmbedder
from bioengine_tpu_torch.apps.cell_image_search.index import (
    load_index,
    search_index,
)
from bioengine_tpu_torch.apps.cell_image_search.ingestion import (
    make_synthetic_images,
)
from bioengine_tpu_torch.runtime.devices import (
    DeviceLike,
    device_name,
    resolve_device,
)


class CellImageSearch:
    def __init__(
        self,
        workspace_dir: str = "~/.bioengine/cell-image-search",
        weights_path: Optional[str] = None,
        batch_bucket: int = 64,
        device: DeviceLike = None,
        seed: int = 0,
        model_overrides: Optional[dict[str, Any]] = None,
    ):
        self.device = resolve_device(device)
        self.workspace_dir = Path(workspace_dir).expanduser()
        self.workspace_dir.mkdir(parents=True, exist_ok=True)
        self.embedder = ViTEmbedder(
            weights_path=weights_path,
            batch_bucket=batch_bucket,
            device=self.device,
            seed=seed,
            model_overrides=model_overrides,
        )
        self.started_at = time.time()
        self._index = None
        self._metadata: Optional[list[dict]] = None
        self._index_info: dict = {}

    # ---- lifecycle hooks --------------------------------------------------

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

    async def ping(self):
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

    async def get_index_stats(self):
        """Index size/type/build stats, or {loaded: False}."""
        if self._index is None and not await self._try_load_index():
            return {"loaded": False, "n_cells": 0}
        return {
            "loaded": True,
            "n_cells": self._index.ntotal,
            "index_type": self._index.kind,
            **self._index_info,
        }

    # ---- search ------------------------------------------------------------

    async def search(self, image: Any, top_k: int = 20):
        """Find morphologically similar cells. ``image`` is any microscopy
        array (1-5 channels) of the model's input size. Returns ranked
        matches with their metadata."""
        if self._index is None and not await self._try_load_index():
            raise RuntimeError("no index built yet — run ingestion first")
        if image is None:
            raise ValueError("provide image")
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
        }
