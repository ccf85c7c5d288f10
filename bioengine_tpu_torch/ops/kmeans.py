"""k-means on the device: nearest-centroid assignment, k-means++ seeding and
Lloyd iterations.

Counterpart of the ``sklearn.cluster.MiniBatchKMeans`` fits and predicts of
``apps/cell-image-search/index.py`` (the IVF coarse quantizers at :152 and
:275, the PQ sub-quantizers at :227). The card's machine has no
scikit-learn, and mini-batch updates would not use the card well, so this is
plain Lloyd in f32 with TF32 off: every iteration assigns all training rows
to their nearest centre and moves each centre to the mean of its rows.

- Seeding is k-means++ on a sample of the rows, drawn from
  ``np.random.default_rng(random_state)`` on the host (the first centre, the
  sample and one uniform per later centre), so the CPU and the card start
  from the same centres outside ties of the f32 distances. ``n_init``
  seedings are scored by their inertia over the sample and the best one is
  refined, as ``MiniBatchKMeans`` chooses among its ``n_init`` inits.
- Iterations stop when the squared shift of the centres falls to ``tol``
  times the mean per-feature variance of the data (sklearn's tolerance
  rule), or after ``max_iter`` (25, FAISS's default for IVF and PQ
  training, which the reference's index used).
- A cluster left empty is reseeded from the rows farthest from their centre.
- The card's centre sums add in a fixed order, so a fit repeats bit for
  bit.
- ``n_clusters == n`` is allowed.

Every function takes a batch of independent problems, ``x`` of shape
(S, n, d): the 96 PQ subspaces train at once. Distances are chunked over the
rows so that no (S, rows, k) f32 block exceeds ``DIST_BUDGET_BYTES`` (at 1M
rows x 96 subspaces x 256 centres one block would be 98 GB).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device
from bioengine_tpu_torch.runtime.torch_runner import full_f32

# cap on one (subspaces, rows, centres) f32 distance block; on the CPU a
# block small enough to stay in cache is ~3x faster
DIST_BUDGET_BYTES = 1 << 30
CPU_DIST_BUDGET_BYTES = 1 << 22
# rows k-means++ seeds from: MiniBatchKMeans's init_size (3 x its 4096-row
# batch), or 3 x n_clusters where that is larger
INIT_ROWS = 3 * 4096


def nearest_centroids(
    x: torch.Tensor, centres: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (S, n, d), centres (S, k, d), both f32 on one device ->
    (labels (S, n) int64, squared distance to the nearest centre (S, n))."""
    S, n, _ = x.shape
    c_sq = (centres * centres).sum(-1)[:, None, :]  # (S, 1, k)
    ct = centres.transpose(1, 2)
    labels = torch.empty((S, n), dtype=torch.int64, device=x.device)
    mind = torch.empty((S, n), dtype=torch.float32, device=x.device)
    budget = DIST_BUDGET_BYTES if x.is_cuda else CPU_DIST_BUDGET_BYTES
    step = max(1, budget // (4 * S * centres.shape[1]))
    # TF32 off: the card and the CPU assign the same rows outside ties
    with full_f32():
        for r0 in range(0, n, step):
            xc = x[:, r0 : r0 + step]
            # ||c||^2 - 2 x.c; ||x||^2 does not change the argmin
            d = torch.baddbmm(c_sq, xc, ct, alpha=-2.0)
            m, lab = d.min(dim=-1)
            labels[:, r0 : r0 + step] = lab
            mind[:, r0 : r0 + step] = (m + (xc * xc).sum(-1)).clamp_min_(0.0)
    return labels, mind


def _plusplus(
    x: torch.Tensor, k: int, rngs: Sequence[np.random.Generator]
) -> torch.Tensor:
    """k-means++ over each problem's rows x (S, m, d) -> centres (S, k, d).
    Each centre after the first is the row at which the cumulative squared
    distance to the centres so far passes a uniform draw of its total."""
    S, m, d = x.shape
    first = torch.tensor([int(r.integers(m)) for r in rngs], device=x.device)
    u = torch.from_numpy(np.stack([r.random(k - 1) for r in rngs])).to(x.device)
    rows = torch.arange(S, device=x.device)
    centres = torch.empty((S, k, d), dtype=x.dtype, device=x.device)
    centres[:, 0] = x[rows, first]
    d2 = ((x - centres[:, :1]) ** 2).sum(-1).double()
    for j in range(1, k):
        cum = d2.cumsum(-1)
        target = (u[:, j - 1] * cum[:, -1])[:, None]
        # right side: a row already chosen (distance 0) is never drawn again
        pick = torch.searchsorted(cum, target, right=True)[:, 0].clamp_(max=m - 1)
        centres[:, j] = x[rows, pick]
        d2 = torch.minimum(d2, ((x - centres[:, j : j + 1]) ** 2).sum(-1).double())
    return centres


def _seed(
    x: torch.Tensor, k: int, rngs: Sequence[np.random.Generator], n_init: int
) -> torch.Tensor:
    """The best of ``n_init`` k-means++ seedings of each problem, by inertia
    over its seeding sample."""
    S, n, _ = x.shape
    m = min(n, max(3 * k, INIT_ROWS))
    rows = torch.arange(S, device=x.device)[:, None]
    if m < n:
        picks = np.stack([np.sort(r.choice(n, size=m, replace=False)) for r in rngs])
        sample = x[rows, torch.from_numpy(picks).to(x.device)]
    else:
        sample = x
    best, best_inertia = None, None
    for _ in range(n_init):
        centres = _plusplus(sample, k, rngs)
        inertia = nearest_centroids(sample, centres)[1].double().sum(-1)
        if best is None:
            best, best_inertia = centres, inertia
        else:
            better = inertia < best_inertia
            best[better] = centres[better]
            best_inertia = torch.minimum(best_inertia, inertia)
    return best


def lloyd_step(x: torch.Tensor, centres: torch.Tensor) -> torch.Tensor:
    """One Lloyd update of each problem in x (S, n, d) f32 from centres
    (S, k, d): every row to its nearest centre, each centre to the mean of
    its rows; a cluster left empty takes the rows farthest from their
    centres."""
    S, n, d = x.shape
    k = centres.shape[1]
    labels, mind = nearest_centroids(x, centres)
    flat = (labels + (torch.arange(S, device=x.device) * k)[:, None]).reshape(-1)
    sums = torch.zeros((S * k, d), dtype=torch.float32, device=x.device)
    if x.is_cuda:
        # index_add_ adds with float atomics on the card, so every build
        # would differ; index_put_ sorts the labels and adds in that order
        sums.index_put_((flat,), x.reshape(S * n, d), accumulate=True)
    else:
        sums.index_add_(0, flat, x.reshape(S * n, d))
    counts = torch.bincount(flat, minlength=S * k).reshape(S, k)
    new = sums.reshape(S, k, d) / counts.clamp_min(1)[..., None]
    empty = counts == 0
    if bool(empty.any()):
        for s in torch.nonzero(empty.any(dim=1)).flatten().tolist():
            holes = torch.nonzero(empty[s]).flatten()
            far = torch.topk(mind[s], len(holes)).indices
            new[s, holes] = x[s, far]
    return new


def fit(
    x: torch.Tensor,
    n_clusters: int,
    random_states: Sequence[int],
    n_init: int = 1,
    max_iter: int = 25,
    tol: float = 1e-4,
) -> torch.Tensor:
    """Lloyd k-means of each problem in x (S, n, d) f32, seeded from
    ``np.random.default_rng(random_states[s])`` -> centres (S, k, d).
    The labels are ``nearest_centroids(x, centres)``, for the callers that
    need them."""
    S, n, d = x.shape
    if not 1 <= n_clusters <= n:
        raise ValueError(f"n_clusters={n_clusters} for {n} rows")
    if len(random_states) != S:
        raise ValueError(f"{len(random_states)} random states for {S} problems")
    x = x.float().contiguous()
    rngs = [np.random.default_rng(r) for r in random_states]
    centres = _seed(x, n_clusters, rngs, n_init)
    # sklearn's tolerance: tol x the mean per-feature variance of the data
    limit = tol * x.var(dim=1, unbiased=False).mean(-1)  # (S,)
    for _ in range(max_iter):
        new = lloyd_step(x, centres)
        shift = ((new - centres) ** 2).sum(dim=(1, 2))
        centres = new
        if bool((shift <= limit).all()):
            break
    return centres


def kmeans(
    x: np.ndarray,
    n_clusters: int,
    random_state: int = 0,
    n_init: int = 1,
    max_iter: int = 25,
    tol: float = 1e-4,
    device: DeviceLike = None,
) -> tuple[np.ndarray, np.ndarray]:
    """k-means of the rows of x (n, d) on ``device`` ->
    (centres (k, d) f32, labels (n,) int64) on the host."""
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)[None]
    centres = fit(xt, n_clusters, [random_state], n_init, max_iter, tol)
    labels, _ = nearest_centroids(xt, centres)
    return centres[0].cpu().numpy(), labels[0].cpu().numpy()

