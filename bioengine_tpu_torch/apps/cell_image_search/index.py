"""Vector index for cell-embedding similarity search, in PyTorch.

Counterpart of ``apps/cell-image-search/index.py``, with the same kinds,
size thresholds, on-disk format and search arithmetic:

- **FlatIP** (< 100K cells): the corpus on the device in bf16, one product
  plus top-k per query batch (``ops.knn.topk_inner_product``).
- **IVFFlat** (< 5M): a k-means coarse quantizer, the corpus stored
  list-sorted so each probed list is a contiguous slice, exact inner
  products over the ``nprobe`` nearest lists. Search is the JAX class's host
  numpy, bit for bit.
- **IVFPQ** (>= 5M on the CPU): the coarse quantizer plus residual product
  quantization, 96 sub-quantizers x 8 bits (96 bytes a vector); asymmetric
  search from the query itself over the probed lists, host numpy as on the
  JAX side.
- **PQFlatTPU** (>= 5M on a card; the name is kept so either app loads the
  other's npz): the same 8-bit codes resident on the card as an (M, N)
  uint8 plane, every code scanned per query (``ops.knn.pq_scan_topk``).

Training (k-means, PQ codebooks) and encoding run on the device through
``ops.kmeans``, where the JAX app calls scikit-learn's ``MiniBatchKMeans``
on the host. PQ training takes at most ``TRAIN_MAX_ROWS`` rows and encoding
streams ``ENCODE_ROWS`` at a time, so a PQ build's device memory does not
grow with the corpus. Persistence is the same ``cell_search_index.npz`` and
``index_info.json`` under ``<workspace>/index``; metadata is JSON rows in
``metadata.json`` where the JAX app writes parquet (the card's machine has
no pandas). The 2-D map is an exact PCA (SVD in float64) cached as
``projection_cache.npz`` with the JAX app's keys.
"""

from __future__ import annotations

import colorsys
import json
import logging
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from bioengine_tpu_torch.ops import kmeans as km
from bioengine_tpu_torch.ops.knn import pq_scan_topk, topk_inner_product
from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

# the JAX app's size thresholds (index.py:553-555)
FLAT_MAX_CELLS = 100_000
IVFFLAT_MAX_CELLS = 5_000_000
# rows the PQ and IVFPQ coarse quantizers train on
TRAIN_MAX_ROWS = 1_000_000
# rows uploaded per PQ encoding chunk (192 MiB of f32 at 768 dims)
ENCODE_ROWS = 1 << 16


def index_dir(workspace_dir: str | Path) -> Path:
    return Path(workspace_dir).expanduser() / "index"


def _topk_pad(
    parts_s: list[np.ndarray], parts_i: list[np.ndarray], top_k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k over concatenated candidate (scores, ids), padded to
    ``top_k`` with (-inf, -1) — shared by the probed-list index kinds."""
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


def _list_bounds(assignments: np.ndarray, nlist: int):
    """Stable list order of ``assignments`` -> (order, (nlist, 2) bounds of
    each list's slice in that order)."""
    order = np.argsort(assignments, kind="stable")
    sorted_assign = assignments[order]
    starts = np.searchsorted(sorted_assign, np.arange(nlist))
    ends = np.searchsorted(sorted_assign, np.arange(nlist), side="right")
    return order, np.stack([starts, ends], axis=1)


# ---------------------------------------------------------------------------
# index variants
# ---------------------------------------------------------------------------


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

    def reconstruct(self, ids: np.ndarray) -> np.ndarray:
        return self.embeddings[ids]

    def save(self, path: Path):
        np.savez_compressed(path, kind=self.kind, embeddings=self.embeddings)

    @classmethod
    def load(cls, data, device: DeviceLike = None) -> "FlatIPIndex":
        return cls(data["embeddings"], device)


class IVFFlatIndex:
    """Coarse-quantized exact search: k-means lists, probe the nearest
    ``nprobe`` lists, exact IP over their members on the host.

    Embeddings are stored list-sorted so each probed list is a CONTIGUOUS
    slice: scoring is ``nprobe`` dense matvecs instead of a corpus-sized
    fancy-index gather per query."""

    kind = "IVFFlat"

    def __init__(
        self,
        embeddings: np.ndarray,
        centroids: np.ndarray,
        assignments: np.ndarray,
        nprobe: int = 16,
    ):
        embeddings = np.ascontiguousarray(embeddings, np.float32)
        self.centroids = centroids.astype(np.float32)
        self.assignments = assignments.astype(np.int32)
        self.nprobe = nprobe
        order, self._list_bounds = _list_bounds(assignments, len(centroids))
        self._order = order.astype(np.int64)       # sorted pos -> orig id
        self._sorted_emb = np.ascontiguousarray(embeddings[order])
        self._pos = np.empty(len(order), np.int64)  # orig id -> sorted pos
        self._pos[order] = np.arange(len(order))
        self.build_info: dict[str, float] = {}

    @classmethod
    def build(
        cls,
        embeddings: np.ndarray,
        nlist: int,
        nprobe: int = 16,
        n_init: int = 3,
        device: DeviceLike = None,
    ) -> "IVFFlatIndex":
        """k-means on ``device`` (the card unless ``device="cpu"``)."""
        t0 = time.perf_counter()
        centroids, assignments = km.kmeans(
            embeddings, nlist, random_state=0, n_init=n_init, device=device
        )
        t1 = time.perf_counter()
        index = cls(embeddings, centroids, assignments, nprobe)
        index.build_info = {
            "kmeans_seconds": t1 - t0, "sort_seconds": time.perf_counter() - t1,
        }
        return index

    @property
    def ntotal(self) -> int:
        return len(self._sorted_emb)

    def search(self, query: np.ndarray, top_k: int):
        q = np.atleast_2d(query).astype(np.float32)
        nprobe = min(self.nprobe, len(self.centroids))
        # probe selection: q @ centroids^T (tiny — numpy)
        cscores = q @ self.centroids.T
        probes = np.argpartition(-cscores, nprobe - 1, axis=1)[:, :nprobe]
        all_s, all_i = [], []
        for row, plist in enumerate(probes):
            parts_s, parts_i = [], []
            for p in plist:
                s0, s1 = self._list_bounds[p]
                if s1 <= s0:
                    continue
                # contiguous slice: a dense matvec, no gather
                parts_s.append(self._sorted_emb[s0:s1] @ q[row])
                parts_i.append(self._order[s0:s1])
            s, i = _topk_pad(parts_s, parts_i, top_k)
            all_s.append(s)
            all_i.append(i)
        return np.stack(all_s), np.stack(all_i)

    def reconstruct(self, ids: np.ndarray) -> np.ndarray:
        return self._sorted_emb[self._pos[np.asarray(ids)]]

    def save(self, path: Path):
        np.savez_compressed(
            path,
            kind=self.kind,
            # original-row order keeps the on-disk format stable
            embeddings=self._sorted_emb[self._pos],
            centroids=self.centroids,
            assignments=self.assignments,
            nprobe=self.nprobe,
        )

    @classmethod
    def load(cls, data, device: DeviceLike = None) -> "IVFFlatIndex":
        return cls(
            data["embeddings"],
            data["centroids"],
            data["assignments"],
            int(data["nprobe"]),
        )


def _upload(rows: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rows, np.float32), device=dev)


def _residuals(
    x: torch.Tensor, coarse: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows x (n, d) minus their nearest coarse centre (k, d) ->
    (residuals, assignments (n,))."""
    assign = km.nearest_centroids(x[None], coarse[None])[0][0]
    return x - coarse[assign], assign


def _subspaces(x: torch.Tensor, M: int) -> torch.Tensor:
    """(n, d) -> (M, n, d / M): one k-means problem per subspace."""
    n, d = x.shape
    return x.reshape(n, M, d // M).permute(1, 0, 2).contiguous()


def _train_pq(
    vectors: np.ndarray,
    M: int,
    ksub_max: int,
    train_n: Optional[int] = None,
    device: DeviceLike = None,
    coarse: Optional[torch.Tensor] = None,
) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Per-subspace PQ training + full encode, shared by IVFPQIndex (on
    residuals to the ``coarse`` centres, (k, d) on the device) and
    PQFlatIndex (on the raw rows of ``vectors`` (N, d), on the host).

    All M subspaces train at once on ``device`` over the first
    ``train_len`` rows, subspace m seeded with ``m``. Encoding streams
    ``ENCODE_ROWS`` rows at a time to the device and brings their uint8
    codes back, so device memory is the training sample plus one chunk
    whatever N is. Returns (codebooks (M, ksub, dsub), codes (N, M) uint8,
    the rows' coarse assignments (N,) or None)."""
    dev = resolve_device(device)
    n, d = vectors.shape
    if d % M:
        raise ValueError(f"dim {d} not divisible by m={M}")
    train_len = min(train_n or min(n, TRAIN_MAX_ROWS), n)
    ksub = min(ksub_max, train_len)

    def rows(r0: int, r1: int) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = _upload(vectors[r0:r1], dev)
        return (x, None) if coarse is None else _residuals(x, coarse)

    train = _subspaces(rows(0, train_len)[0], M)
    codebooks = km.fit(train, ksub, list(range(M)))
    del train
    codes = np.empty((n, M), np.uint8)
    assignments = None if coarse is None else np.empty(n, np.int64)
    for r0 in range(0, n, ENCODE_ROWS):
        r1 = min(n, r0 + ENCODE_ROWS)
        x, assign = rows(r0, r1)
        labels, _ = km.nearest_centroids(_subspaces(x, M), codebooks)
        codes[r0:r1] = labels.T.to(torch.uint8).cpu().numpy()
        if assign is not None:
            assignments[r0:r1] = assign.cpu().numpy()
    return codebooks.cpu().numpy(), codes, assignments


class IVFPQIndex:
    """IVF + product quantization: 96 bytes/vector (m=96 subspaces x
    8 bits), asymmetric-distance search over probed lists."""

    kind = "IVFPQ"
    M = 96          # sub-quantizers; 768 / 96 = 8 dims each
    KSUB = 256      # 8-bit codebooks

    def __init__(
        self,
        centroids: np.ndarray,
        codebooks: np.ndarray,      # (M, KSUB, dsub)
        codes: np.ndarray,          # (N, M) uint8, list-sorted order
        ids: np.ndarray,            # (N,) original ids, list-sorted
        list_bounds: np.ndarray,    # (nlist, 2)
        nprobe: int = 32,
    ):
        self.centroids = centroids.astype(np.float32)
        self.codebooks = codebooks.astype(np.float32)
        self.codes = codes
        self.ids = ids
        self.list_bounds = list_bounds
        self.nprobe = nprobe
        self.dsub = codebooks.shape[-1]
        self.build_info: dict[str, float] = {}

    @classmethod
    def build(
        cls,
        embeddings: np.ndarray,
        nlist: int,
        nprobe: int = 32,
        train_n: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "IVFPQIndex":
        """Coarse k-means on the first ``train_len`` rows, then residual PQ
        training and streamed encoding (``_train_pq``), on ``device`` (the
        card unless ``device="cpu"``). ``pq_seconds`` includes the coarse
        assignment of every row, made chunk by chunk with the encoding."""
        dev = resolve_device(device)
        n, d = embeddings.shape
        train_len = train_n or min(n, TRAIN_MAX_ROWS)
        t0 = time.perf_counter()
        train = _upload(embeddings[:train_len], dev)
        centres = km.fit(train[None], nlist, [0], n_init=3)[0]
        del train
        t1 = time.perf_counter()
        codebooks, codes, assignments = _train_pq(
            embeddings, cls.M, cls.KSUB, train_len, dev, coarse=centres
        )
        t2 = time.perf_counter()
        order, bounds = _list_bounds(assignments, nlist)
        index = cls(
            centres.cpu().numpy(),
            codebooks,
            codes[order],
            order.astype(np.int64),
            bounds,
            nprobe,
        )
        index.build_info = {
            "coarse_seconds": t1 - t0, "pq_seconds": t2 - t1,
            "sort_seconds": time.perf_counter() - t2,
        }
        return index

    @property
    def ntotal(self) -> int:
        return len(self.codes)

    def search(self, query: np.ndarray, top_k: int):
        q = np.atleast_2d(query).astype(np.float32)
        nprobe = min(self.nprobe, len(self.centroids))
        cscores = q @ self.centroids.T
        probes = np.argpartition(-cscores, nprobe - 1, axis=1)[:, :nprobe]
        # flat-LUT layout: one 1-D gather of (codes + per-subspace offset)
        # over the concatenated probed lists' (contiguous) code blocks
        offs = (np.arange(self.M, dtype=np.int32) * self.codebooks.shape[1])
        all_s, all_i = [], []
        for row, plist in enumerate(probes):
            qr = q[row]
            # ADC table from q itself: x_hat = c + r_hat, so
            # q·x_hat = q·c + q·r_hat; building it from q - c would add a
            # spurious -c·r_hat ranking term. Built once per query.
            lut = np.einsum(
                "mkd,md->mk",
                self.codebooks,
                qr.reshape(self.M, self.dsub),
            ).ravel()  # (M * KSUB,)
            bounds = self.list_bounds[plist]
            live = bounds[:, 1] > bounds[:, 0]
            if not live.any():
                s, i = _topk_pad([], [], top_k)
                all_s.append(s)
                all_i.append(i)
                continue
            bounds = bounds[live]
            lens = bounds[:, 1] - bounds[:, 0]
            codes = np.concatenate(
                [self.codes[s0:s1] for s0, s1 in bounds]
            )  # (Ltot, M)
            ids = np.concatenate([self.ids[s0:s1] for s0, s1 in bounds])
            scores = lut[codes.astype(np.int32) + offs].sum(axis=1)
            # q·c base term: reuse the coarse scores already computed
            scores += np.repeat(cscores[row, plist[live]], lens)
            s, i = _topk_pad([scores], [ids], top_k)
            all_s.append(s)
            all_i.append(i)
        return np.stack(all_s), np.stack(all_i)

    def reconstruct(self, ids: np.ndarray) -> np.ndarray:
        """Approximate reconstruction from codes (for projections)."""
        pos = np.empty_like(self.ids)
        pos[self.ids] = np.arange(len(self.ids))
        out = np.empty((len(ids), self.M * self.dsub), np.float32)
        # list centroid of each id
        list_of_pos = np.zeros(len(self.ids), np.int32)
        for li, (s0, s1) in enumerate(self.list_bounds):
            list_of_pos[s0:s1] = li
        for j, ident in enumerate(np.asarray(ids)):
            p = pos[ident]
            code = self.codes[p]
            resid = self.codebooks[np.arange(self.M), code]  # (M, dsub)
            out[j] = self.centroids[list_of_pos[p]] + resid.reshape(-1)
        return out

    def save(self, path: Path):
        np.savez_compressed(
            path,
            kind=self.kind,
            centroids=self.centroids,
            codebooks=self.codebooks,
            codes=self.codes,
            ids=self.ids,
            list_bounds=self.list_bounds,
            nprobe=self.nprobe,
        )

    @classmethod
    def load(cls, data, device: DeviceLike = None) -> "IVFPQIndex":
        return cls(
            data["centroids"],
            data["codebooks"],
            data["codes"],
            data["ids"],
            data["list_bounds"],
            int(data["nprobe"]),
        )


class PQFlatIndex:
    """Device-resident PQ flat scan over every code.

    Codes live on the device as an (M, N) uint8 plane: at 96 bytes a vector
    58M cells are ~5.5 GB, so search needs no coarse quantizer and loses no
    recall to unprobed lists. Per query the ADC table (M x 256 inner
    products) is built on the host with the JAX class's ``einsum``; the scan
    adds its entries subspace by subspace and takes top-k on the device
    (``ops.knn.pq_scan_topk``), so only (Q, k) scores and ids come back."""

    kind = "PQFlatTPU"
    M = 96
    KSUB = 256
    # cap on the transient (Q_chunk, N) f32 score plane the scan holds on
    # the device: query batches chunk to keep it under this budget
    # (20M codes -> 26 queries a chunk)
    SCORE_BUDGET_BYTES = 2 << 30

    def __init__(
        self,
        codebooks: np.ndarray,     # (M, KSUB, dsub)
        codes: np.ndarray,         # (N, M) uint8
        ids: Optional[np.ndarray] = None,
        device: DeviceLike = None,
    ):
        self.codebooks = codebooks.astype(np.float32)
        self.codes = codes
        self.ids = (
            ids.astype(np.int64)
            if ids is not None
            else np.arange(len(codes), dtype=np.int64)
        )
        self.dsub = codebooks.shape[-1]
        self.device = device
        self._codes_dev: Optional[torch.Tensor] = None
        self.build_info: dict[str, float] = {}

    @classmethod
    def build(
        cls,
        embeddings: np.ndarray,
        train_n: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "PQFlatIndex":
        """PQ training and encoding on ``device`` (the card unless
        ``device="cpu"``); the codes are searched there too."""
        t0 = time.perf_counter()
        codebooks, codes, _ = _train_pq(
            embeddings, cls.M, cls.KSUB, train_n, device
        )
        if codebooks.shape[1] < cls.KSUB:  # tiny corpora: pad to 8-bit
            codebooks = np.pad(
                codebooks,
                ((0, 0), (0, cls.KSUB - codebooks.shape[1]), (0, 0)),
            )
        index = cls(codebooks, codes, device=device)
        index.build_info = {"pq_seconds": time.perf_counter() - t0}
        return index

    @property
    def ntotal(self) -> int:
        return len(self.codes)

    def codes_on_device(self) -> torch.Tensor:
        """The (M, N) uint8 code plane on the index's device, uploaded once
        and transposed there (a strided numpy transpose of 20M x 96 bytes
        takes seconds)."""
        if self._codes_dev is None:
            codes = torch.from_numpy(np.ascontiguousarray(self.codes))
            self._codes_dev = codes.to(resolve_device(self.device)).T.contiguous()
        return self._codes_dev

    def search(self, query: np.ndarray, top_k: int):
        codes_t = self.codes_on_device()
        q = np.atleast_2d(query).astype(np.float32)
        k = min(top_k, self.ntotal)
        q_chunk = max(1, int(self.SCORE_BUDGET_BYTES // (self.ntotal * 4)))
        out_s = np.full((len(q), top_k), -np.inf, np.float32)
        out_i = np.full((len(q), top_k), -1, np.int64)
        for c0 in range(0, len(q), q_chunk):
            qc = q[c0 : c0 + q_chunk]
            luts = np.einsum(
                "mkd,qmd->qmk",
                self.codebooks,
                qc.reshape(len(qc), self.M, self.dsub),
            )
            s, i = pq_scan_topk(
                torch.from_numpy(luts).to(codes_t.device), codes_t, k
            )
            out_s[c0 : c0 + len(qc), :k] = s.cpu().numpy()
            out_i[c0 : c0 + len(qc), :k] = self.ids[i.cpu().numpy()]
        return out_s, out_i

    def reconstruct(self, ids: np.ndarray) -> np.ndarray:
        pos = np.empty(int(self.ids.max()) + 1, np.int64)
        pos[self.ids] = np.arange(len(self.ids))
        code = self.codes[pos[np.asarray(ids)]]          # (B, M)
        resid = self.codebooks[
            np.arange(self.M)[None, :], code
        ]                                                 # (B, M, dsub)
        return resid.reshape(len(code), -1).astype(np.float32)

    def save(self, path: Path):
        np.savez_compressed(
            path,
            kind=self.kind,
            codebooks=self.codebooks,
            codes=self.codes,
            ids=self.ids,
        )

    @classmethod
    def load(cls, data, device: DeviceLike = None) -> "PQFlatIndex":
        return cls(data["codebooks"], data["codes"], data["ids"], device)


_KINDS = {
    c.kind: c
    for c in (FlatIPIndex, IVFFlatIndex, IVFPQIndex, PQFlatIndex)
}


# ---------------------------------------------------------------------------
# build / load / search / project — the JAX app's module API
# ---------------------------------------------------------------------------


def select_index(
    n_target: int, n: int, device: DeviceLike = None
) -> tuple[str, Optional[int]]:
    """(kind, nlist) for a corpus that will hold ``n_target`` cells, built
    from ``n`` now: the JAX app's thresholds and ``nlist`` rules. At 5M and
    more the codes stay on a card when the device resolves to one
    (``PQFlatTPU``), as the JAX app keeps them on a TPU; IVFPQ otherwise."""
    if n_target < FLAT_MAX_CELLS:
        return FlatIPIndex.kind, None
    if n_target < IVFFLAT_MAX_CELLS:
        return IVFFlatIndex.kind, min(4096, max(64, int(np.sqrt(n_target))), n)
    if resolve_device(device).type == "cuda":
        return PQFlatIndex.kind, None
    return IVFPQIndex.kind, min(65536, max(4096, int(np.sqrt(n_target))), n)


def build_index(
    embeddings: np.ndarray,
    metadata: list[dict[str, Any]],
    workspace_dir: str | Path,
    n_cells_total: Optional[int] = None,
    device: DeviceLike = None,
) -> dict[str, Any]:
    """Auto-select FlatIP/IVFFlat/IVFPQ/PQFlatTPU by target size, build
    (training on ``device``, the card unless ``device="cpu"``; a FlatIP
    build trains nothing) and persist with one metadata row per embedding.
    The stats add the build's split (``build_split_seconds``: training,
    sorting, saving) to the JAX app's keys."""
    t0 = time.time()
    n, d = embeddings.shape
    if len(metadata) != n:
        raise ValueError(f"{len(metadata)} metadata rows for {n} embeddings")
    kind, nlist = select_index(n_cells_total or n, n, device)
    out = index_dir(workspace_dir)
    out.mkdir(parents=True, exist_ok=True)

    if kind == FlatIPIndex.kind:
        index = FlatIPIndex(embeddings, device)
    elif kind == IVFFlatIndex.kind:
        index = IVFFlatIndex.build(embeddings, nlist, device=device)
    elif kind == PQFlatIndex.kind:
        index = PQFlatIndex.build(embeddings, device=device)
    else:
        index = IVFPQIndex.build(embeddings, nlist, device=device)

    index_path = out / "cell_search_index.npz"
    t_save = time.perf_counter()
    index.save(index_path)
    (out / "metadata.json").write_text(json.dumps(metadata))
    split = {**getattr(index, "build_info", {}),
             "save_seconds": time.perf_counter() - t_save}
    elapsed = time.time() - t0
    stats = {
        "n_cells": n,
        "embed_dim": d,
        "index_type": index.kind,
        "index_size_mb": index_path.stat().st_size / 1024**2,
        "build_seconds": elapsed,
        "build_time_iso": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "build_split_seconds": split,
    }
    (out / "index_info.json").write_text(json.dumps(stats, indent=2))
    logger.info("built %s index: n=%d in %.1fs", index.kind, n, elapsed)
    return stats


def load_index(workspace_dir: str | Path, device: DeviceLike = None):
    """→ (index, metadata rows, info) or raises FileNotFoundError. A
    FlatIP corpus or PQ code plane moves to ``device`` at its first
    search."""
    out = index_dir(workspace_dir)
    path = out / "cell_search_index.npz"
    if not path.exists():
        raise FileNotFoundError(f"no index at {path}")
    with np.load(path, allow_pickle=False) as data:
        kind = str(data["kind"])
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


def _pca_2d(vecs: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact PCA of the rows -> (coords (n, 2), mean (d,), components
    (2, d)), f32 as sklearn keeps them for f32 input. An SVD of the centred
    sample in float64, with sklearn's sign rule (each component's entry of
    largest magnitude is positive)."""
    x = np.asarray(vecs, np.float64)
    mean = x.mean(axis=0)
    _, _, vt = np.linalg.svd(x - mean, full_matrices=False)
    comps = vt[:2]
    big = np.argmax(np.abs(comps), axis=1)
    comps = comps * np.sign(comps[np.arange(len(comps)), big])[:, None]
    coords = (x - mean) @ comps.T
    return (
        coords.astype(np.float32),
        mean.astype(np.float32),
        comps.astype(np.float32),
    )


def _label_column(rows: list[dict]) -> Optional[str]:
    """The first of moa_class, compound, label that any row carries."""
    return next(
        (c for c in ("moa_class", "compound", "label")
         if any(c in r for r in rows)),
        None,
    )


def _label(row: dict, column: str) -> str:
    """A row's label as pandas' ``astype(str)`` reads it from a DataFrame
    of the rows: a missing value is ``"nan"``."""
    return str(row[column]) if column in row else "nan"


def compute_projection(
    workspace_dir: str | Path,
    n_samples: int = 10_000,
    random_state: int = 42,
    force_recompute: bool = False,
    device: DeviceLike = None,
) -> dict[str, Any]:
    """2-D map of a random sample for the dashboard scatter plot: PCA fit
    once and cached with its components, so queries project into the same
    space in O(d). The sample is the JAX app's
    (``np.sort(default_rng(random_state).choice(...))``) and the cache has
    its keys, so either app reads the other's."""
    out = index_dir(workspace_dir)
    cache = out / "projection_cache.npz"
    if cache.exists() and not force_recompute:
        with np.load(cache, allow_pickle=False) as data:
            return {
                "x": data["x"].tolist(),
                "y": data["y"].tolist(),
                "labels": data["labels"].tolist(),
                "colors": data["colors"].tolist(),
                "n_total": int(data["n_total"]),
            }
    try:
        index, rows, _ = load_index(workspace_dir, device)
    except FileNotFoundError:
        return {"x": [], "y": [], "labels": [], "colors": [], "n_total": 0}

    n_total = index.ntotal
    n_samples = min(n_samples, n_total)
    rng = np.random.default_rng(random_state)
    sample = np.sort(rng.choice(n_total, size=n_samples, replace=False))
    coords, mean, components = _pca_2d(index.reconstruct(sample))

    labels = ["unknown"] * n_samples
    colors = ["#888888"] * n_samples
    label_col = _label_column(rows)
    if label_col is not None:
        uniques = list(dict.fromkeys(_label(r, label_col) for r in rows))
        palette = _generate_palette(len(uniques))
        cmap = {u: palette[i % len(palette)] for i, u in enumerate(uniques)}
        for i, idx in enumerate(sample):
            if idx < len(rows):
                lbl = _label(rows[int(idx)], label_col)
                labels[i] = lbl
                colors[i] = cmap.get(lbl, "#888888")

    np.savez(
        cache,
        x=coords[:, 0], y=coords[:, 1],
        labels=np.array(labels), colors=np.array(colors),
        n_total=np.array(n_total),
        mean=mean, components=components,
    )
    return {
        "x": coords[:, 0].tolist(),
        "y": coords[:, 1].tolist(),
        "labels": labels,
        "colors": colors,
        "n_total": n_total,
    }


def project_query(
    workspace_dir: str | Path, query_embedding: np.ndarray
) -> Optional[dict[str, float]]:
    """Project a query embedding onto the cached 2-D map."""
    cache = index_dir(workspace_dir) / "projection_cache.npz"
    if not cache.exists():
        return None
    with np.load(cache, allow_pickle=False) as data:
        if "components" not in data:
            return None
        xy = (query_embedding - data["mean"]) @ data["components"].T
    return {"x": float(xy[0]), "y": float(xy[1])}


def _generate_palette(n: int) -> list[str]:
    """n visually-spread hex colors (golden-angle hue walk)."""
    colors = []
    for i in range(max(n, 1)):
        h = (i * 0.61803398875) % 1.0
        r, g, b = colorsys.hsv_to_rgb(h, 0.65, 0.95)
        colors.append(f"#{int(r*255):02x}{int(g*255):02x}{int(b*255):02x}")
    return colors
