"""Flow-field ops for cellpose-style segmentation, in PyTorch.

Counterpart of ``bioengine_tpu/ops/flows.py``:

- ``masks_to_flows`` (host, numpy): per-instance heat diffusion from the
  instance's median pixel; the training targets are the normalised
  gradient of the heat map. An own copy, bit for bit the JAX package's.
- ``follow_flows`` / ``follow_flows_3d`` (device, torch): Euler
  integration of every pixel (voxel) through the flow field, on the flow
  tensor's device. Positions stay f32; each step clamps, floors, indexes
  and weights in the JAX order and gathers the field through one flat
  index. JAX runs the steps as a ``lax.scan``; here they are a plain
  Python loop of ``n_iter`` steps (about 30 small ops each).
- ``masks_from_flows`` (device follow, host clustering): the follow runs
  on ``device``; the final positions come back as numpy for the scipy
  sink clustering (``cluster_sinks``), which is dimension-agnostic.
- ``aggregate_orthogonal_flows``: the cellpose ``do_3D`` recipe, 2D
  outputs over yx/zx/zy slices -> one 3D flow field.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device

# Training targets scale unit-norm flows by this factor (see
# ``models.cellpose.cellpose_loss``); raw network flow output must be
# divided by it before Euler integration.
FLOW_SCALE = 5.0


def masks_to_flows(masks: np.ndarray, n_iter: int | None = None) -> np.ndarray:
    """Compute (2, H, W) target flows from an instance-label image.

    For each instance, diffuse heat from the instance's median pixel and
    take the normalized gradient — the cellpose training-target recipe.
    """
    H, W = masks.shape
    flows = np.zeros((2, H, W), np.float32)
    for lbl in np.unique(masks):
        if lbl == 0:
            continue
        ys, xs = np.nonzero(masks == lbl)
        y0, y1 = ys.min(), ys.max() + 1
        x0, x1 = xs.min(), xs.max() + 1
        # pad the crop by 1 so diffusion has a zero boundary
        crop = (masks[y0:y1, x0:x1] == lbl)
        h = np.zeros((crop.shape[0] + 2, crop.shape[1] + 2), np.float64)
        cy = int(np.median(ys)) - y0 + 1
        cx = int(np.median(xs)) - x0 + 1
        inside = np.pad(crop, 1)
        iters = n_iter or 2 * max(crop.shape)
        for _ in range(iters):
            h[cy, cx] += 1.0
            h_new = 0.25 * (
                h[:-2, 1:-1] + h[2:, 1:-1] + h[1:-1, :-2] + h[1:-1, 2:]
            )
            h[1:-1, 1:-1] = np.where(inside[1:-1, 1:-1], h_new, 0.0)
        hlog = np.log1p(h[1:-1, 1:-1])
        gy, gx = np.gradient(hlog)
        norm = np.sqrt(gy**2 + gx**2) + 1e-10
        flows[0, y0:y1, x0:x1][crop] = (gy / norm)[crop]
        flows[1, y0:y1, x0:x1][crop] = (gx / norm)[crop]
    return flows


def _grid(shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """(ndim, prod(shape)) f32 pixel coordinates in C order."""
    axes = [torch.arange(n, dtype=torch.float32, device=device) for n in shape]
    return torch.stack([g.reshape(-1) for g in torch.meshgrid(*axes, indexing="ij")])


def _bilinear_sample(flow: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Sample every channel of ``flow`` (C, H, W) at float positions
    p = (2, N), clamped to the image: (C, N)."""
    H, W = flow.shape[1:]
    y = p[0].clamp(0.0, H - 1.0)
    x = p[1].clamp(0.0, W - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = torch.clamp_max(y0 + 1, H - 1)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    wy = y - y0
    wx = x - x0
    field = flow.reshape(flow.shape[0], -1)
    v00 = field[:, y0 * W + x0]
    v01 = field[:, y0 * W + x1]
    v10 = field[:, y1 * W + x0]
    v11 = field[:, y1 * W + x1]
    return (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )


def follow_flows(flow: torch.Tensor, n_iter: int = 200, step: float = 1.0) -> torch.Tensor:
    """Integrate every pixel through the flow field on ``flow``'s device.

    flow: (2, H, W) f32 flows (dy, dx). Returns the final positions
    (2, H, W) f32 on the same device."""
    H, W = flow.shape[1:]
    flow = flow.float()
    p = _grid((H, W), flow.device)
    for _ in range(n_iter):
        d = _bilinear_sample(flow, p)
        p = torch.stack([
            (p[0] + step * d[0]).clamp(0.0, H - 1.0),
            (p[1] + step * d[1]).clamp(0.0, W - 1.0),
        ])
    return p.reshape(2, H, W)


def _trilinear_sample(flow: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Sample every channel of ``flow`` (C, D, H, W) at float positions
    p = (3, N), clamped to the volume: (C, N)."""
    D, H, W = flow.shape[1:]
    z = p[0].clamp(0.0, D - 1.0)
    y = p[1].clamp(0.0, H - 1.0)
    x = p[2].clamp(0.0, W - 1.0)
    z0 = torch.floor(z).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    z1 = torch.clamp_max(z0 + 1, D - 1)
    y1 = torch.clamp_max(y0 + 1, H - 1)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    wz, wy, wx = z - z0, y - y0, x - x0
    field = flow.reshape(flow.shape[0], -1)
    out = 0.0
    for zi, wzi in ((z0, 1 - wz), (z1, wz)):
        for yi, wyi in ((y0, 1 - wy), (y1, wy)):
            for xi, wxi in ((x0, 1 - wx), (x1, wx)):
                out = out + field[:, (zi * H + yi) * W + xi] * wzi * wyi * wxi
    return out


def follow_flows_3d(flow: torch.Tensor, n_iter: int = 200, step: float = 1.0) -> torch.Tensor:
    """Integrate every voxel through a (3, D, H, W) flow field (dz, dy,
    dx) on ``flow``'s device. Returns final positions (3, D, H, W)."""
    D, H, W = flow.shape[1:]
    flow = flow.float()
    p = _grid((D, H, W), flow.device)
    limits = torch.tensor([[D - 1.0], [H - 1.0], [W - 1.0]], dtype=torch.float32, device=flow.device)
    zero = torch.zeros((), dtype=torch.float32, device=flow.device)
    for _ in range(n_iter):
        p = torch.clamp(p + step * _trilinear_sample(flow, p), zero, limits)
    return p.reshape(3, D, H, W)


def aggregate_orthogonal_flows(
    pred_yx: np.ndarray, pred_zx: np.ndarray, pred_zy: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Combine per-orientation 2D network outputs over a (D, H, W)
    volume into a 3D flow field — the cellpose ``do_3D`` recipe.

    pred_yx: (D, H, W, 3) — z-slices:  channels (dy, dx, cellprob)
    pred_zx: (H, D, W, 3) — y-slices:  channels (dz, dx, cellprob)
    pred_zy: (W, D, H, 3) — x-slices:  channels (dz, dy, cellprob)

    Returns (flow (3, D, H, W) in (dz, dy, dx) order, cellprob (D, H, W));
    each flow component is the mean of its two contributing orientations,
    cellprob the mean of all three.
    """
    yx = np.asarray(pred_yx, np.float32)                     # [z, y, x, c]
    zx = np.transpose(np.asarray(pred_zx, np.float32), (1, 0, 2, 3))  # [z, y, x, c]
    zy = np.transpose(np.asarray(pred_zy, np.float32), (1, 2, 0, 3))  # [z, y, x, c]
    if not (yx.shape == zx.shape == zy.shape):
        raise ValueError(
            f"orientation outputs disagree after realignment: "
            f"{yx.shape} vs {zx.shape} vs {zy.shape}"
        )
    flow = np.stack(
        [
            (zx[..., 0] + zy[..., 0]) / 2.0,   # dz
            (yx[..., 0] + zy[..., 1]) / 2.0,   # dy
            (yx[..., 1] + zx[..., 1]) / 2.0,   # dx
        ]
    )
    cellprob = (yx[..., 2] + zx[..., 2] + zy[..., 2]) / 3.0
    return flow, cellprob


def predictions_to_masks(
    pred: np.ndarray,
    cellprob_threshold: float = 0.0,
    min_size: int = 15,
    n_iter: int = 200,
    device: DeviceLike = None,
) -> np.ndarray:
    """Network output (H, W, 3) -> instance masks. Flows are divided by
    ``FLOW_SCALE`` (the 5x training-target scale) before following."""
    flow = np.moveaxis(pred[..., :2], -1, 0) / FLOW_SCALE
    return masks_from_flows(
        flow,
        pred[..., 2],
        cellprob_threshold=cellprob_threshold,
        min_size=min_size,
        n_iter=n_iter,
        device=device,
    )


def masks_from_flows(
    flow: np.ndarray,
    cellprob: np.ndarray,
    cellprob_threshold: float = 0.0,
    min_size: int = 15,
    n_iter: int = 200,
    device: DeviceLike = None,
) -> np.ndarray:
    """Postprocess *unit-scale* flows + cellprob logits -> instance labels.

    flow (2, H, W) + cellprob (H, W) for planar data, or (3, D, H, W) +
    (D, H, W) for volumes. The follow runs on ``device`` (``cuda:0`` by
    default); the sink clustering runs on the host."""
    fg = cellprob > cellprob_threshold
    if not fg.any():
        return np.zeros_like(cellprob, dtype=np.int32)
    dev = resolve_device(device)
    follow = follow_flows if flow.shape[0] == 2 else follow_flows_3d
    p = follow(torch.as_tensor(np.asarray(flow, np.float32), device=dev), n_iter=n_iter)
    return cluster_sinks(p.cpu().numpy(), fg, min_size)


def cluster_sinks(p: np.ndarray, fg: np.ndarray, min_size: int) -> np.ndarray:
    """Final positions p (ndim, *spatial) of the foreground ``fg`` ->
    instance labels: round each foreground pixel's sink, dilate the sinks
    so nearby convergence points merge into one seed blob, label the blobs
    and hand each pixel its sink's label."""
    spatial = fg.shape
    sinks = np.zeros(spatial, bool)
    idx = tuple(
        np.clip(np.round(p[d][fg]).astype(int), 0, spatial[d] - 1)
        for d in range(len(spatial))
    )
    sinks[idx] = True
    seed_labels, _ = ndimage.label(ndimage.binary_dilation(sinks, iterations=2))
    masks = np.zeros(spatial, np.int32)
    masks[fg] = seed_labels[idx]
    return filter_and_relabel(masks, min_size)


def filter_and_relabel(masks: np.ndarray, min_size: int) -> np.ndarray:
    """Drop instances smaller than ``min_size`` pixels/voxels and
    re-label the rest densely 1..N. Re-run after any resampling of a
    label image: resampling can erase instances, leaving id gaps that
    make ``masks.max()`` lie about the cell count."""
    labels, counts = np.unique(masks[masks > 0], return_counts=True)
    small = set(labels[counts < min_size].tolist())
    if small:
        masks = np.where(np.isin(masks, list(small)), 0, masks)
    out = np.zeros_like(masks)
    for i, lbl in enumerate(np.unique(masks[masks > 0]), start=1):
        out[masks == lbl] = i
    return out
