"""Exact k-nearest-neighbour search by inner product, and the PQ code scan.

Counterparts of ``bioengine_tpu/ops/knn.py:topk_inner_product`` (a plain
large product, no kernel of its own, then top-k), of ``ShardedKnnIndex``
(the corpus split over a mesh axis, each device's partial top-k merged on
the host) and of ``PQFlatIndex``'s jitted scan in
``apps/cell-image-search/index.py`` (a plain ``lax.scan`` over subspaces,
no Pallas).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bioengine_tpu_torch.parallel.data_parallel import place
from bioengine_tpu_torch.parallel.mesh import Mesh, Placement
from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device
from bioengine_tpu_torch.runtime.pipeline import torch_dtype

# corpus rows widened to f32 at a time (bounds the transient copy)
CHUNK_ROWS = 1 << 16


def topk_inner_product(
    corpus: torch.Tensor, queries: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """corpus (N, d), queries (Q, d) -> (scores (Q, k) f32, ids (Q, k)).

    Queries are rounded to the corpus dtype (bf16 halves the resident
    corpus) and the products are summed in f32: both operands are widened
    to f32, where a bf16 x bf16 product is exact, chunk by chunk."""
    q = queries.to(corpus.dtype).float()
    scores = torch.cat(
        [
            q @ corpus[i : i + CHUNK_ROWS].float().T
            for i in range(0, corpus.shape[0], CHUNK_ROWS)
        ],
        dim=1,
    )
    return torch.topk(scores, k, dim=1)


class ShardedKnnIndex:
    """Flat inner-product index with the corpus split over a mesh axis.

    Each device scores its corpus shard with ``topk_inner_product`` (k_local
    = min(k, shard rows)), then the host merges the k * n_shards candidates:
    the payload that leaves a device is O(Q*k), not O(N). With ``mesh=None``
    the whole corpus lives on ``device`` (``cuda`` unless ``device="cpu"``).
    """

    def __init__(
        self,
        corpus: np.ndarray,
        mesh: Optional[Mesh] = None,
        axis: str = "dp",
        dtype=torch.bfloat16,
        device: DeviceLike = None,
    ):
        self.n, self.d = corpus.shape
        self.mesh = mesh
        self.axis = axis
        dtype = dtype if isinstance(dtype, torch.dtype) else torch_dtype(dtype)
        if mesh is not None:
            n_shards = mesh.shape[axis]
            pad = (-self.n) % n_shards
            self._pad = pad
            padded = np.pad(corpus, ((0, pad), (0, 0)))
            # one shard per coordinate along the axis: the first entry
            # holding it (entries along other axes hold copies)
            shards = place(Placement(mesh, (axis, None)), torch.from_numpy(padded).to(dtype))
            self.corpus = shards.parts()
        else:
            self._pad = 0
            self.corpus = torch.as_tensor(corpus).to(resolve_device(device), dtype)

    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """-> (scores (Q, k), indices (Q, k)) as numpy, global ids."""
        k = min(k, self.n)
        q = torch.as_tensor(np.asarray(queries, np.float32))
        if q.dim() == 1:
            q = q[None]
        if self.mesh is None:
            s, i = topk_inner_product(self.corpus, q.to(self.corpus.device), k)
            return s.cpu().numpy(), i.cpu().numpy()

        n_shards = len(self.corpus)
        shard_n = self.corpus[0].shape[0]
        k_local = min(k, shard_n)
        found = [topk_inner_product(blk, q.to(blk.device), k_local) for blk in self.corpus]
        s = np.stack([f[0].cpu().numpy() for f in found])  # (n_shards, Q, k_local)
        i = np.stack([f[1].cpu().numpy() for f in found])
        # globalize ids and merge the n_shards * k candidates per query
        offsets = (np.arange(n_shards) * shard_n)[:, None, None]
        i = i + offsets
        s = np.moveaxis(s, 0, 1).reshape(q.shape[0], -1)  # (Q, n_shards*k)
        i = np.moveaxis(i, 0, 1).reshape(q.shape[0], -1)
        # padded rows score over zero-vectors; mask them out
        valid = i < self.n
        s = np.where(valid, s, -np.inf)
        order = np.argsort(-s, axis=1)[:, :k]
        rows = np.arange(q.shape[0])[:, None]
        return s[rows, order], i[rows, order]


def pq_scan_topk(
    luts: torch.Tensor, codes_t: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric-distance scan of every code, then top-k.

    luts (Q, M, KSUB) f32 tables of query-codeword inner products, codes_t
    (M, N) uint8 on the same device -> (scores (Q, k) f32, positions (Q, k)
    int64). Scores start at 0 and add subspace by subspace, the ``lax.scan``
    order of the JAX index, so they match it in f32. Each subspace's codes
    are widened to int32 for the gather (a uint8 index tensor would be a
    boolean mask); only one (N,) row is widened at a time."""
    per_subspace = luts.transpose(0, 1).contiguous()  # (M, Q, KSUB)
    acc = torch.zeros(
        (luts.shape[0], codes_t.shape[1]), dtype=torch.float32, device=luts.device
    )
    for lut_m, codes_m in zip(per_subspace, codes_t):
        acc += lut_m.index_select(1, codes_m.int())
    return torch.topk(acc, k, dim=1)
