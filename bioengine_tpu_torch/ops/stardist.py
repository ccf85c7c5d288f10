"""StarDist star-convex polygon ops: training targets and reconstruction.

Own numpy copy of ``bioengine_tpu/ops/stardist.py``, held bit for bit
against it: host code around the ``models.stardist.StarDist2D`` forward.

- ``masks_to_stardist``: per-pixel (prob, ray-distance) training targets
  from an instance-label image, as ``max_dist`` stepped gathers per ray.
- ``polygons_to_masks``: greedy prob-ordered NMS over thresholded
  candidates (spatially grid-subsampled above ``max_candidates``) and
  polygon rasterisation back to an instance-label image;
  ``filter_and_relabel`` is the port's own, from ``ops/flows.py``.
- ``predictions_to_masks_stardist``: the network output (probability
  logit, rays) through ``polygons_to_masks``.
"""

from __future__ import annotations

import warnings

import numpy as np

from bioengine_tpu_torch.ops.flows import filter_and_relabel


def ray_angles(n_rays: int) -> np.ndarray:
    return (2.0 * np.pi / n_rays) * np.arange(n_rays, dtype=np.float32)


def masks_to_stardist(
    masks: np.ndarray, n_rays: int = 32, max_dist: int = 64
) -> tuple[np.ndarray, np.ndarray]:
    """Instance labels (H, W) int -> (prob (H, W), dist (H, W, n_rays)).

    prob is the per-instance edt-normalized distance transform (the
    upstream StarDist recipe): 1.0 on each instance's medial axis,
    falling to ~0 at its boundary. A model trained on this target peaks
    at object centers, so the greedy prob-ordered NMS in
    ``polygons_to_masks`` picks medial-axis pixels as polygon centers
    instead of arbitrary interior ones.
    dist[y, x, r] = steps along ray r until the label under the ray
    differs from the label at (y, x), capped at ``max_dist``.
    """
    from scipy import ndimage

    H, W = masks.shape
    yy, xx = np.mgrid[:H, :W]
    dist = np.zeros((H, W, n_rays), np.float32)
    inside = masks > 0
    prob = np.zeros((H, W), np.float32)
    # find_objects gets every bounding box in ONE image pass; the
    # per-label work below is then proportional to box area, not H*W
    for lbl, slc in enumerate(ndimage.find_objects(masks), start=1):
        if slc is None:
            continue
        box = masks[slc] == lbl
        # pad so instance pixels touching the crop edge still measure a
        # distance-to-background; edt is per-instance so touching
        # neighbours form a boundary (a global edt would merge them)
        d = ndimage.distance_transform_edt(np.pad(box, 1))[1:-1, 1:-1]
        peak = d.max()
        if peak > 0:
            prob[slc][box] = (d / peak)[box].astype(np.float32)
    for r, ang in enumerate(ray_angles(n_rays)):
        dy, dx = np.sin(ang), np.cos(ang)
        still = inside.copy()
        for t in range(1, max_dist + 1):
            fy = np.round(yy + t * dy).astype(np.int64)
            fx = np.round(xx + t * dx).astype(np.int64)
            in_image = (fy >= 0) & (fy < H) & (fx >= 0) & (fx < W)
            py = np.clip(fy, 0, H - 1)
            px = np.clip(fx, 0, W - 1)
            # leaving the image counts as leaving the instance
            same = still & in_image & (masks[py, px] == masks)
            dist[..., r][same] = t
            still = same
            if not still.any():
                break
    return prob, dist


def _render_polygon(
    canvas: np.ndarray, cy: int, cx: int, dists: np.ndarray, label: int
) -> tuple[int, int]:
    """Rasterize one star-convex polygon: a pixel belongs to the
    instance if its distance from the center is below the (angularly
    interpolated) ray distance in its direction. Paints only unclaimed
    pixels; returns (painted, blocked) pixel counts, where blocked =
    in-image polygon pixels already claimed by accepted instances."""
    H, W = canvas.shape
    n_rays = len(dists)
    rmax = int(np.ceil(dists.max()))
    y0, y1 = max(0, cy - rmax), min(H, cy + rmax + 1)
    x0, x1 = max(0, cx - rmax), min(W, cx + rmax + 1)
    if y0 >= y1 or x0 >= x1:
        return 0, 0
    yy, xx = np.mgrid[y0:y1, x0:x1]
    dy = (yy - cy).astype(np.float32)
    dx = (xx - cx).astype(np.float32)
    rad = np.sqrt(dy * dy + dx * dx)
    ang = np.arctan2(dy, dx) % (2.0 * np.pi)
    # linear interpolation between neighbouring rays
    pos = ang / (2.0 * np.pi) * n_rays
    i0 = np.floor(pos).astype(np.int64) % n_rays
    i1 = (i0 + 1) % n_rays
    w1 = (pos - np.floor(pos)).astype(np.float32)
    boundary = dists[i0] * (1.0 - w1) + dists[i1] * w1
    inside = rad <= boundary
    blocked = inside & (canvas[y0:y1, x0:x1] != 0)
    sel = inside & ~blocked
    canvas[y0:y1, x0:x1][sel] = label
    return int(sel.sum()), int(blocked.sum())


def polygons_to_masks(
    prob: np.ndarray,
    dist: np.ndarray,
    prob_threshold: float = 0.5,
    nms_iou_threshold: float = 0.4,
    min_size: int = 15,
    max_candidates: int = 10_000,
) -> np.ndarray:
    """(prob (H, W) in [0, 1], dist (H, W, n_rays)) -> instance labels.

    Greedy NMS in probability order: a candidate is accepted unless its
    center already lies inside an accepted instance or its rendered
    overlap with existing instances exceeds ``nms_iou_threshold`` of
    its own area (render-based suppression — simpler than upstream's
    polygon-IoU but equivalent for the thresholded pipeline)."""
    H, W = prob.shape
    cand = np.argwhere(prob > prob_threshold)
    if len(cand) == 0:
        return np.zeros((H, W), np.int32)
    if len(cand) > max_candidates:
        # subsample SPATIALLY (per-cell argmax on a stride grid sized to
        # the budget) rather than by a global prob cutoff: a global
        # top-k drops every candidate of any cell whose peak prob falls
        # below the k-th pixel, silently losing whole instances on
        # large dense images. A grid keeps one (locally best) candidate
        # per neighbourhood everywhere — the same idea as upstream
        # StarDist's ``grid`` candidate subsampling.
        n_orig = len(cand)
        p = prob[cand[:, 0], cand[:, 1]]
        stride = max(2, int(np.ceil(np.sqrt(n_orig / max_candidates))))
        n_cols = (W + stride - 1) // stride
        cell = (cand[:, 0] // stride) * n_cols + cand[:, 1] // stride
        by_cell = np.lexsort((-p, cell))
        # within-cell rank by prob: every cell's best candidate outranks
        # ANY cell's second-best, so truncating to the budget keeps one
        # locally-max candidate per neighbourhood everywhere before
        # spending budget on runners-up — no instance loses its peak
        # unless there are more occupied cells than budget
        c_sorted = cell[by_cell]
        is_first = np.ones(n_orig, bool)
        is_first[1:] = c_sorted[1:] != c_sorted[:-1]
        first = np.maximum.accumulate(
            np.where(is_first, np.arange(n_orig), 0)
        )
        rank = np.arange(n_orig) - first
        final = np.lexsort((-p[by_cell], rank))[:max_candidates]
        cand = cand[by_cell[final]]
        warnings.warn(
            f"polygons_to_masks: {n_orig} candidates exceeded "
            f"max_candidates={max_candidates}; grid-subsampled "
            f"(stride {stride}) to {len(cand)}",
            stacklevel=2,
        )
    order = np.argsort(-prob[cand[:, 0], cand[:, 1]], kind="stable")
    cand = cand[order]
    canvas = np.zeros((H, W), np.int32)
    label = 0
    for cy, cx in cand:
        if canvas[cy, cx] != 0:
            continue  # center already claimed: suppressed
        dists = dist[cy, cx]
        if dists.max() < 1.0:
            continue
        label += 1
        painted, blocked = _render_polygon(
            canvas, int(cy), int(cx), dists, label
        )
        # actual overlap with accepted instances, measured against the
        # IN-IMAGE polygon footprint — image-border clipping must not
        # count as overlap or edge cells get systematically suppressed
        covered = blocked / max(painted + blocked, 1)
        if painted == 0 or covered > nms_iou_threshold:
            canvas[canvas == label] = 0
            label -= 1
    return filter_and_relabel(canvas, min_size)


def predictions_to_masks_stardist(
    pred: np.ndarray,
    prob_threshold: float = 0.5,
    nms_iou_threshold: float = 0.4,
    min_size: int = 15,
) -> np.ndarray:
    """Network output (H, W, 1 + n_rays) -> instance labels. Channel 0
    is the probability LOGIT (models.stardist.StarDist2D)."""
    prob = 1.0 / (1.0 + np.exp(-pred[..., 0]))
    return polygons_to_masks(
        prob,
        pred[..., 1:],
        prob_threshold=prob_threshold,
        nms_iou_threshold=nms_iou_threshold,
        min_size=min_size,
    )
