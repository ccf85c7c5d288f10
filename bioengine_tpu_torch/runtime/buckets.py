"""Shape bucketing: every spatial size rounds up to a bucket on a ladder.

Own copy of ``bioengine_tpu/runtime/buckets.py``. Inputs are zero-padded
to the bucket and outputs cropped back, so a workload of mixed image sizes
builds a small, bounded number of programs (CUDA graphs in the port's
engine) instead of one per shape.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

# Default spatial ladder, growing ~1.5x so padding waste is bounded by ~55%
# worst case, typically <20%.
DEFAULT_LADDER = (64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048)


def bucket_dim(size: int, ladder: Sequence[int] = DEFAULT_LADDER, divisor: int = 1) -> int:
    """Smallest ladder entry >= size that is divisible by ``divisor``.

    Off-ladder fallback, always divisible by ``divisor`` so pooled model
    shapes stay whole: 128-steps when ``divisor`` divides 128, else
    geometric quantization to divisor * 2^k (log-many buckets, <2x padding)
    for divisors like 5 that divide no ladder entry.
    """
    for b in ladder:
        if b >= size and b % divisor == 0:
            return b
    if divisor <= 128 and 128 % divisor == 0:
        return math.ceil(size / 128) * 128
    units = math.ceil(size / divisor)
    return divisor * (1 << max(0, math.ceil(math.log2(units))))


def bucket_shape(
    hw: tuple[int, int],
    ladder: Sequence[int] = DEFAULT_LADDER,
    divisor: int = 1,
) -> tuple[int, int]:
    return (
        bucket_dim(hw[0], ladder, divisor),
        bucket_dim(hw[1], ladder, divisor),
    )


def bucket_batch(
    n: int,
    ladder: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
    multiple_of: int = 1,
) -> int:
    """Smallest batch-ladder entry >= n, additionally divisible by
    ``multiple_of`` (a data-parallel width: every device gets an equal
    shard)."""
    m = max(int(multiple_of), 1)
    for b in ladder:
        if b >= n and b % m == 0:
            return b
    ceil64 = math.ceil(n / 64) * 64
    if ceil64 % m == 0:
        return ceil64
    # geometric quantization on units of m: log-many buckets, <2x padding
    units = math.ceil(n / m)
    return m * (1 << max(0, math.ceil(math.log2(units))))


def pad_to(x: np.ndarray, target_hw: tuple[int, int], axes: tuple[int, int] = (1, 2)) -> np.ndarray:
    """Zero-pad spatial axes up to target (the bioimageio tiling
    convention; reflective padding would bias conv models' borders)."""
    pads = [(0, 0)] * x.ndim
    for ax, tgt in zip(axes, target_hw):
        if x.shape[ax] > tgt:
            raise ValueError(f"axis {ax} size {x.shape[ax]} exceeds bucket {tgt}")
        pads[ax] = (0, tgt - x.shape[ax])
    if all(p == (0, 0) for p in pads):
        return x
    return np.pad(x, pads)


def fill_bucketed(dst: np.ndarray, x: np.ndarray) -> None:
    """In-place counterpart of ``pad_to`` + batch padding: write ``x``
    into ``dst``'s leading corner and zero everything else. ``dst`` is a
    reusable staging buffer (``runtime/pipeline.py`` ``StagingPool``)."""
    if x.ndim != dst.ndim:
        raise ValueError(f"rank mismatch: {x.shape} into {dst.shape}")
    for got, have in zip(x.shape, dst.shape):
        if got > have:
            raise ValueError(f"{x.shape} exceeds staging buffer {dst.shape}")
    dst.fill(0)
    dst[tuple(slice(0, s) for s in x.shape)] = x


def crop_to(x: np.ndarray, hw: tuple[int, int], axes: tuple[int, int] = (1, 2)) -> np.ndarray:
    slices = [slice(None)] * x.ndim
    for ax, tgt in zip(axes, hw):
        slices[ax] = slice(0, tgt)
    return x[tuple(slices)]
