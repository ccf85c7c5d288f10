"""Crop extraction and the synthetic image source.

Copies of ``_otsu_threshold``, ``extract_cell_crops`` and
``make_synthetic_images`` from ``apps/cell-image-search/ingestion.py``
(numpy/scipy). The ingestion sessions, status files and dataset registry
are not ported yet.
"""

from __future__ import annotations

import numpy as np

from bioengine_tpu_torch.apps.cell_image_search.normalizer import (
    percentile_stretch,
)


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
