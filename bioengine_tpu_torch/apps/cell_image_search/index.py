"""Exact inner-product index for cell-embedding similarity search.

Counterpart of the FlatIP branch of ``apps/cell-image-search/index.py``:
the corpus lives on the device in bf16 and a query is one product plus
top-k (``ops.knn.topk_inner_product``). Persistence keeps the same
``cell_search_index.npz`` and ``index_info.json`` under
``<workspace>/index``; metadata is JSON rows in ``metadata.json`` where the
JAX app writes parquet, since the card's machine has no pandas. The IVF and
PQ indexes are not ported yet: ``build_index`` refuses the corpus sizes
that would select them.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from bioengine_tpu_torch.ops.knn import topk_inner_product
from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

# above this corpus size the JAX app switches to IVF/PQ indexes
FLAT_MAX_CELLS = 100_000


def index_dir(workspace_dir: str | Path) -> Path:
    return Path(workspace_dir).expanduser() / "index"


def _topk_pad(
    parts_s: list[np.ndarray], parts_i: list[np.ndarray], top_k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k over concatenated candidate (scores, ids), padded to
    ``top_k`` with (-inf, -1)."""
    if not parts_s:
        return (
            np.full(top_k, -np.inf, np.float32),
            np.full(top_k, -1, np.int64),
        )
    scores = np.concatenate(parts_s)
    ids = np.concatenate(parts_i)
    k = min(top_k, scores.size)
    sel = np.argpartition(-scores, k - 1)[:k]
    sel = sel[np.argsort(-scores[sel])]
    s = np.full(top_k, -np.inf, np.float32)
    i = np.full(top_k, -1, np.int64)
    s[:k], i[:k] = scores[sel], ids[sel]
    return s, i


class FlatIPIndex:
    """Exact inner-product search; corpus lives on the device in bf16."""

    kind = "FlatIP"

    def __init__(self, embeddings: np.ndarray, device: DeviceLike = None):
        self.embeddings = np.ascontiguousarray(embeddings, np.float32)
        self.device = device
        self._device_corpus: Optional[torch.Tensor] = None

    @property
    def ntotal(self) -> int:
        return len(self.embeddings)

    def search(self, query: np.ndarray, top_k: int):
        if self._device_corpus is None:
            self._device_corpus = torch.from_numpy(self.embeddings).to(
                resolve_device(self.device), torch.bfloat16
            )
        corpus = self._device_corpus
        q = torch.from_numpy(np.atleast_2d(query).astype(np.float32))
        k = min(top_k, self.ntotal)
        s, i = topk_inner_product(corpus, q.to(corpus.device), k)
        return s.cpu().numpy(), i.cpu().numpy()

    def save(self, path: Path):
        np.savez_compressed(path, kind=self.kind, embeddings=self.embeddings)

    @classmethod
    def load(cls, data, device: DeviceLike = None) -> "FlatIPIndex":
        return cls(data["embeddings"], device)


_KINDS = {FlatIPIndex.kind: FlatIPIndex}


def build_index(
    embeddings: np.ndarray,
    metadata: list[dict[str, Any]],
    workspace_dir: str | Path,
    n_cells_total: Optional[int] = None,
) -> dict[str, Any]:
    """Build and persist a FlatIP index over ``embeddings`` with one
    metadata row per embedding."""
    t0 = time.time()
    n, d = embeddings.shape
    if len(metadata) != n:
        raise ValueError(f"{len(metadata)} metadata rows for {n} embeddings")
    n_target = n_cells_total or n
    if n_target >= FLAT_MAX_CELLS:
        raise NotImplementedError(
            f"{n_target} cells would select an IVF/PQ index, which the "
            f"PyTorch port does not have yet (FlatIP below {FLAT_MAX_CELLS})"
        )
    out = index_dir(workspace_dir)
    out.mkdir(parents=True, exist_ok=True)
    index = FlatIPIndex(embeddings)
    index_path = out / "cell_search_index.npz"
    index.save(index_path)
    (out / "metadata.json").write_text(json.dumps(metadata))
    elapsed = time.time() - t0
    stats = {
        "n_cells": n,
        "embed_dim": d,
        "index_type": index.kind,
        "index_size_mb": index_path.stat().st_size / 1024**2,
        "build_seconds": elapsed,
        "build_time_iso": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    (out / "index_info.json").write_text(json.dumps(stats, indent=2))
    logger.info("built %s index: n=%d in %.1fs", index.kind, n, elapsed)
    return stats


def load_index(workspace_dir: str | Path, device: DeviceLike = None):
    """→ (index, metadata rows, info) or raises FileNotFoundError."""
    out = index_dir(workspace_dir)
    path = out / "cell_search_index.npz"
    if not path.exists():
        raise FileNotFoundError(f"no index at {path}")
    with np.load(path, allow_pickle=False) as data:
        kind = str(data["kind"])
        if kind not in _KINDS:
            raise NotImplementedError(
                f"index kind {kind} is not ported yet (have {sorted(_KINDS)})"
            )
        index = _KINDS[kind].load(data, device)
    metadata = json.loads((out / "metadata.json").read_text())
    info = json.loads((out / "index_info.json").read_text())
    return index, metadata, info


def search_index(index, metadata, query_embedding, top_k=20):
    """→ list of result dicts with rank/score/index_id and the metadata
    row's fields."""
    scores, ids = index.search(query_embedding, top_k)
    scores, ids = scores[0], ids[0]
    results = []
    for rank, (score, idx) in enumerate(zip(scores, ids)):
        if idx < 0 or not np.isfinite(score):
            continue
        meta = metadata[int(idx)] if metadata and idx < len(metadata) else {}
        results.append(
            {"rank": rank + 1, "score": float(score), "index_id": int(idx),
             **meta}
        )
    return results
