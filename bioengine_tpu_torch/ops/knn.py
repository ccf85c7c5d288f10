"""Exact k-nearest-neighbour search by inner product, and the PQ code scan.

Counterparts of ``bioengine_tpu/ops/knn.py:topk_inner_product`` (a plain
large product, no kernel of its own, then top-k) and of ``PQFlatIndex``'s
jitted scan in ``apps/cell-image-search/index.py`` (a plain ``lax.scan``
over subspaces, no Pallas). The sharded index is not ported yet.
"""

from __future__ import annotations

import torch

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
