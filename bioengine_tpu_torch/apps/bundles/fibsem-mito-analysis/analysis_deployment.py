"""Mitochondria Analysis — tiled 2D EM segmentation, TPU edition.

Capability parity with the reference
(ref apps/fibsem-mito-analysis/analysis_deployment.py:1-286): tile a
large EM image, delegate probability-map inference to the deployed
model-runner service, stitch with Gaussian-blended accumulation,
threshold → close → split → per-instance morphology.

TPU redesign:
- **Batched tile inference**: the reference round-trips one tile per
  request through S3 (ref :88-108). Here tiles are stacked into one
  (N, 1, t, t) array and sent in a single RPC — the model-runner's
  runtime executes the whole batch as one jitted XLA call, keeping the
  MXU fed instead of paying per-tile dispatch + network latency.
- **App→app composition over the framework RPC** (the reference's
  Hypha get_service pattern): arrays travel in-band, no S3 presign hop.
- Post-processing is scipy/numpy only (no skimage in the image):
  Otsu-free fixed threshold as in the reference, small-object removal
  via labeled areas, binary closing, instance splitting by
  distance-transform peaks + nearest-peak assignment, and
  moments-based regionprops (area / centroid / axis lengths /
  eccentricity — same fields as skimage's).
"""

from __future__ import annotations

import asyncio
import os
import time
from datetime import datetime
from typing import Optional

import numpy as np

from bioengine_tpu_torch.rpc import schema_method


class MitoAnalysis:
    def __init__(
        self,
        model_runner_service: str = "bioengine/model-runner",
        model_id: str = "tiny-unet",
        server_url: Optional[str] = None,
        batch_size: int = 8,
        input_layout: str = "NCHW",
    ) -> None:
        self.start_time = time.time()
        self.model_runner_service = model_runner_service
        self.model_id = model_id
        if input_layout not in ("NCHW", "NHWC"):
            raise ValueError(f"input_layout must be NCHW or NHWC")
        self.input_layout = input_layout
        self.server_url = server_url or os.environ.get(
            "BIOENGINE_SERVER_URL"
        )
        self.batch_size = batch_size
        self._model_runner = None
        self._connection = None

    # ---- lifecycle ---------------------------------------------------------

    async def async_init(self) -> None:
        from bioengine_tpu_torch.rpc.client import connect_to_server

        if self.server_url is None:
            raise RuntimeError(
                "no server_url configured (param or BIOENGINE_SERVER_URL)"
            )
        token = os.environ.get("BIOENGINE_TOKEN") or os.environ.get(
            "HYPHA_TOKEN"
        )
        self._connection = await connect_to_server(
            {"server_url": self.server_url, "token": token}
        )
        self._model_runner = await self._connection.get_service(
            self.model_runner_service
        )

    async def test_deployment(self) -> None:
        test_img = np.random.rand(64, 64).astype(np.float32)
        prob = await self._infer_batch(test_img[None])
        assert prob.shape == (1, 64, 64), f"unexpected shape {prob.shape}"

    async def check_health(self) -> None:
        if self._model_runner is None:
            raise RuntimeError("model-runner not connected")

    async def close(self) -> None:
        if self._connection is not None:
            await self._connection.disconnect()
            self._connection = None

    # ---- inference ---------------------------------------------------------

    async def _infer_batch(self, tiles: np.ndarray) -> np.ndarray:
        """(N, h, w) float32 → (N, h, w) probability maps, one RPC."""
        if self.input_layout == "NCHW":
            inp = tiles[:, None].astype(np.float32)  # (N, 1, h, w)
        else:
            inp = tiles[..., None].astype(np.float32)  # (N, h, w, 1)
        result = await self._model_runner.infer(
            model_id=self.model_id, inputs=inp
        )
        out = result[next(iter(result))] if isinstance(result, dict) else result
        out = np.asarray(out, np.float32)
        # normalize layouts: (N,1,h,w) / (N,h,w,1) / (N,h,w)
        if out.ndim == 4 and out.shape[1] == 1:
            out = out[:, 0]
        elif out.ndim == 4 and out.shape[-1] == 1:
            out = out[..., 0]
        return out

    async def _infer_tiled(
        self,
        image_norm: np.ndarray,
        tile_size: int = 512,
        overlap: int = 64,
    ) -> np.ndarray:
        """Tile → batched inference → Gaussian-blended stitch
        (ref analysis_deployment.py:110-157, batched here)."""
        H, W = image_norm.shape
        if not 0 <= overlap < tile_size:
            raise ValueError(
                f"overlap ({overlap}) must be in [0, tile_size={tile_size})"
            )
        stride = tile_size - overlap

        yy = np.linspace(-1, 1, tile_size)
        xx = np.linspace(-1, 1, tile_size)
        weight_win = np.outer(
            np.exp(-2 * yy**2), np.exp(-2 * xx**2)
        ).astype(np.float32)

        coords = [
            (y0, x0)
            for y0 in range(0, H, stride)
            for x0 in range(0, W, stride)
        ]
        tiles = np.empty((len(coords), tile_size, tile_size), np.float32)
        spans = []
        for n, (y0, x0) in enumerate(coords):
            y1, x1 = min(y0 + tile_size, H), min(x0 + tile_size, W)
            tile = image_norm[y0:y1, x0:x1]
            th, tw = tile.shape
            if th < tile_size or tw < tile_size:
                tile = np.pad(
                    tile,
                    ((0, tile_size - th), (0, tile_size - tw)),
                    mode="reflect",
                )
            tiles[n] = tile
            spans.append((y0, x0, th, tw))

        prob_acc = np.zeros((H, W), np.float64)
        weight_acc = np.zeros((H, W), np.float64)
        for i in range(0, len(tiles), self.batch_size):
            probs = await self._infer_batch(tiles[i : i + self.batch_size])
            for j, prob in enumerate(probs):
                y0, x0, th, tw = spans[i + j]
                w = weight_win[:th, :tw]
                prob_acc[y0 : y0 + th, x0 : x0 + tw] += prob[:th, :tw] * w
                weight_acc[y0 : y0 + th, x0 : x0 + tw] += w
        return np.divide(
            prob_acc,
            weight_acc,
            out=np.zeros_like(prob_acc),
            where=weight_acc > 0,
        ).astype(np.float32)

    # ---- post-processing (scipy/numpy only) --------------------------------

    @staticmethod
    def _remove_small(binary: np.ndarray, min_size: int) -> np.ndarray:
        from scipy import ndimage as ndi

        labels, n = ndi.label(binary)
        if not n:
            return binary
        areas = ndi.sum_labels(
            np.ones_like(labels), labels, index=np.arange(1, n + 1)
        )
        keep = np.zeros(n + 1, bool)
        keep[1:] = areas >= min_size
        return keep[labels]

    @staticmethod
    def _peak_markers(
        dist: np.ndarray, mask: np.ndarray, min_distance: int = 8
    ) -> np.ndarray:
        """Local maxima of the distance transform → labeled markers."""
        from scipy import ndimage as ndi

        size = 2 * min_distance + 1
        maxf = ndi.maximum_filter(dist, size=size)
        peaks = (dist == maxf) & mask & (dist > 1.0)
        markers, _ = ndi.label(peaks)
        return markers

    @classmethod
    def _prob_to_instances(cls, prob: np.ndarray) -> np.ndarray:
        """Threshold → close → remove small → distance peaks →
        nearest-peak instance assignment (watershed analog,
        ref analysis_deployment.py:161-177)."""
        from scipy import ndimage as ndi

        binary = cls._remove_small(prob > 0.5, min_size=300)
        if not binary.any():
            return np.zeros(prob.shape, np.int32)
        closed = ndi.binary_closing(
            binary, structure=ndi.generate_binary_structure(2, 2),
            iterations=2,
        )
        dist = ndi.distance_transform_edt(closed)
        markers = cls._peak_markers(dist, closed)
        if markers.max() == 0:
            labels, _ = ndi.label(closed)
            return labels.astype(np.int32)
        # assign every mask pixel to its nearest marker (voronoi split
        # by euclidean distance — the watershed approximation)
        _, (iy, ix) = ndi.distance_transform_edt(
            markers == 0, return_indices=True
        )
        labels = np.where(closed, markers[iy, ix], 0)
        return labels.astype(np.int32)

    @staticmethod
    def _region_properties(labels: np.ndarray, pixel_um: float) -> dict:
        """Moments-based per-instance morphology — area, centroid,
        major/minor axis lengths, eccentricity, aspect ratio (the
        skimage.regionprops fields the reference reports,
        ref analysis_deployment.py:259-276)."""
        from scipy import ndimage as ndi

        n = int(labels.max())
        out = {
            "label": [], "area_um2": [], "aspect_ratio": [],
            "eccentricity": [], "centroid_y": [], "centroid_x": [],
        }
        # per-label bounding boxes: each instance is measured on its own
        # window instead of rescanning the full image per label
        slices = ndi.find_objects(labels) if n else []
        for lbl, sl in enumerate(slices, start=1):
            if sl is None:
                continue
            ys, xs = np.nonzero(labels[sl] == lbl)
            area = len(ys)
            if area == 0:
                continue
            ys = ys + sl[0].start
            xs = xs + sl[1].start
            cy, cx = ys.mean(), xs.mean()
            dy, dx = ys - cy, xs - cx
            # central second moments (+1/12 pixel-integration term,
            # matching skimage's definition)
            myy = dy @ dy / area + 1 / 12
            mxx = dx @ dx / area + 1 / 12
            mxy = dy @ dx / area
            common = np.sqrt(((mxx - myy) / 2) ** 2 + mxy**2)
            l1 = (mxx + myy) / 2 + common
            l2 = (mxx + myy) / 2 - common
            major = 4 * np.sqrt(max(l1, 0))
            minor = 4 * np.sqrt(max(l2, 0))
            ecc = np.sqrt(1 - l2 / l1) if l1 > 0 else 0.0
            out["label"].append(lbl)
            out["area_um2"].append(float(area) * pixel_um**2)
            out["aspect_ratio"].append(float(major / (minor + 1e-6)))
            out["eccentricity"].append(float(ecc))
            out["centroid_y"].append(float(cy))
            out["centroid_x"].append(float(cx))
        return out

    # ---- public API --------------------------------------------------------

    @schema_method
    async def ping(self, context=None) -> dict:
        """Service status + the delegated model."""
        return {
            "status": "ok",
            "model": self.model_id,
            "model_runner": self.model_runner_service,
            "uptime_s": round(time.time() - self.start_time, 1),
            "timestamp": datetime.now().isoformat(),
        }

    @schema_method
    async def analyze(
        self,
        image,
        pixel_size_nm: float = 5.0,
        tile_size: int = 512,
        overlap: int = 64,
        context=None,
    ) -> dict:
        """Segment mitochondria in a 2D grayscale EM image.

        ``image``: (H, W) array (uint8 or float). Returns instance
        ``labels`` (H x W int32 array), per-instance ``properties`` (area_um2,
        aspect_ratio, eccentricity, centroids), ``n_mitochondria``,
        ``image_shape``, ``pixel_size_nm``, ``model``, and
        ``processing_time_s``.
        """
        t0 = time.time()
        image_np = np.asarray(image, np.float32)
        if image_np.ndim != 2:
            raise ValueError(
                f"expected 2-D image, got shape {image_np.shape}"
            )
        H, W = image_np.shape
        p1, p99 = np.percentile(image_np, [1, 99])
        image_norm = np.clip(
            (image_np - p1) / (p99 - p1 + 1e-6), 0, 1
        ).astype(np.float32)

        if H <= tile_size and W <= tile_size:
            prob = (await self._infer_batch(image_norm[None]))[0]
        else:
            prob = await self._infer_tiled(
                image_norm, tile_size=tile_size, overlap=overlap
            )

        labels = self._prob_to_instances(prob)
        n_mito = int(labels.max())
        pixel_um = pixel_size_nm / 1000.0
        properties = self._region_properties(labels, pixel_um)

        return {
            # int32 ndarray — the RPC codec carries arrays natively; a
            # nested-list blowup of a 4k x 4k label image would be
            # hundreds of MB of Python objects
            "labels": labels,
            "properties": properties,
            "n_mitochondria": n_mito,
            "image_shape": [H, W],
            "pixel_size_nm": pixel_size_nm,
            "model": self.model_id,
            "processing_time_s": round(time.time() - t0, 2),
        }
