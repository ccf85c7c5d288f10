"""Exact k-nearest-neighbour search by inner product.

Counterpart of ``bioengine_tpu/ops/knn.py:topk_inner_product``: a plain
large product (no kernel of its own) followed by top-k. The sharded index
is not ported yet.
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
