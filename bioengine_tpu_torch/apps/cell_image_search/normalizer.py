"""Microscopy image normalization for ViT embedding.

A copy of ``apps/cell-image-search/normalizer.py``: uint8/uint16/float
inputs, 1-5 channel fluorescence, percentile stretch, 5-channel Cell
Painting → RGB composite, ImageNet scaling. Pure numpy on the host; the
model consumes the (B, 224, 224, 3) float32 output (NHWC, as the JAX
model takes it). A resize and ``decode_image_bytes`` need Pillow, which the
main path's 224² crops never call for; without it they raise a clear error.
"""

from __future__ import annotations

import numpy as np

# JUMP Cell Painting channel order (0-based):
# 0=DNA(DAPI), 1=ER, 2=RNA(SYTO), 3=AGP, 4=Mito
JUMP_CH_DNA = 0
JUMP_CH_ER = 1
JUMP_CH_RNA = 2
JUMP_CH_AGP = 3
JUMP_CH_MITO = 4

# Standard Cell Painting RGB composite: R=AGP, G=ER, B=DNA
JUMP_RGB_CHANNELS = [JUMP_CH_AGP, JUMP_CH_ER, JUMP_CH_DNA]

# ImageNet statistics (DINOv2 input convention), applied after [0, 1]
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def percentile_stretch(
    img: np.ndarray, plow: float = 1.0, phigh: float = 99.0
) -> np.ndarray:
    """Stretch one channel to [0, 255] uint8 with percentile clipping —
    robust to shot noise and hot pixels."""
    lo = np.percentile(img, plow)
    hi = np.percentile(img, phigh)
    if hi <= lo:
        hi = lo + 1.0
    stretched = (img.astype(np.float32) - lo) / (hi - lo)
    return (np.clip(stretched, 0.0, 1.0) * 255.0).astype(np.uint8)


def to_rgb_uint8(img: np.ndarray) -> np.ndarray:
    """Any (H, W), (H, W, C<=5) or (C<=5, H, W) image → (H, W, 3) uint8.

    1 channel → grayscale replicated; 2 → [ch0, ch1, ch0]; 3 → as-is;
    4/5 → Cell Painting composite (AGP, ER, DNA), falling back to the
    first three channels when fewer exist.
    """
    a = np.asarray(img)
    if a.ndim == 2:
        g = percentile_stretch(a)
        return np.stack([g, g, g], axis=-1)
    if a.ndim != 3:
        raise ValueError(f"expected 2D or 3D image, got shape {a.shape}")
    # channels-first heuristic: small leading axis
    if a.shape[0] <= 5 and a.shape[0] < min(a.shape[1:]):
        a = np.moveaxis(a, 0, -1)
    c = a.shape[-1]
    if c == 1:
        return to_rgb_uint8(a[..., 0])
    if c == 2:
        ch0 = percentile_stretch(a[..., 0])
        ch1 = percentile_stretch(a[..., 1])
        return np.stack([ch0, ch1, ch0], axis=-1)
    if c == 3:
        return np.stack([percentile_stretch(a[..., i]) for i in range(3)], -1)
    if c in (4, 5):
        picks = [ch for ch in JUMP_RGB_CHANNELS if ch < c]
        while len(picks) < 3:
            picks.append(picks[-1])
        return np.stack(
            [percentile_stretch(a[..., ch]) for ch in picks], axis=-1
        )
    raise ValueError(f"unsupported channel count {c}")


def resize_rgb(img_rgb: np.ndarray, size: int = 224) -> np.ndarray:
    """(H, W, 3) uint8 → (size, size, 3) uint8 (bilinear)."""
    if img_rgb.shape[:2] == (size, size):
        return img_rgb
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            f"resizing a {img_rgb.shape[0]}x{img_rgb.shape[1]} image to "
            f"{size}x{size} needs Pillow, which is not installed; pass "
            f"{size}x{size} crops"
        ) from exc

    return np.asarray(
        Image.fromarray(img_rgb).resize((size, size), Image.BILINEAR)
    )


def to_model_input(img: np.ndarray, size: int = 224) -> np.ndarray:
    """Any microscopy image → (size, size, 3) float32, ImageNet-scaled —
    one row of the embedder's NHWC batch."""
    rgb = resize_rgb(to_rgb_uint8(img), size)
    x = rgb.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def decode_image_bytes(data: bytes) -> np.ndarray:
    """PNG/JPEG/TIFF bytes → numpy array (any dtype/channels)."""
    import io

    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            "decoding image bytes needs Pillow, which is not installed; "
            "pass the image as an array"
        ) from exc

    return np.asarray(Image.open(io.BytesIO(data)))
