"""ViT embedder for cell crops, in PyTorch.

Counterpart of ``apps/cell-image-search/embedder.py``: DINOv2-geometry
ViT-B/14 at 224², bf16 products, batches padded to a fixed bucket, CLS
embeddings L2-normalised. Attention goes through ``ops.flash_attention``,
the hand-written kernel on the card (the JAX embedder's rule of taking the
kernel only at 1024 tokens and more was measured on a TPU and does not
apply). Without ``weights_path`` the weights are random, from
``np.random.default_rng(seed)``; with one, they are a flat ``jax_params``
npz of the flax ViT, carried over by ``state_dict_from_flax``.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from bioengine_tpu_torch.apps.cell_image_search.normalizer import to_model_input
from bioengine_tpu_torch.models.vit import ViT
from bioengine_tpu_torch.ops.attention import make_attn_fn
from bioengine_tpu_torch.runtime.convert import (
    load_params_npz,
    state_dict_from_flax,
)
from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


class ViTEmbedder:
    EMBED_DIM = 768
    INPUT_SIZE = 224

    def __init__(
        self,
        weights_path: Optional[str] = None,
        batch_bucket: int = 128,
        device: DeviceLike = None,
        seed: int = 0,
        # None = the flash-attention kernel; pass another fn(q, k, v) to
        # compare against it
        attn_fn: Optional[Callable] = None,
        # ViT constructor overrides, to shrink the model in CPU tests
        model_overrides: Optional[dict[str, Any]] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.weights_path = weights_path
        self.batch_bucket = batch_bucket
        self.seed = seed
        self.attn_fn = attn_fn or make_attn_fn()
        self.model_overrides = dict(model_overrides or {})
        self.embed_dim = self.model_overrides.get("dim", self.EMBED_DIM)
        self.pretrained = weights_path is not None
        self.forward_count = 0  # bucket forwards run so far
        self._model: Optional[ViT] = None
        self._lock = threading.Lock()  # guards loading and forward_count

    @property
    def loaded(self) -> bool:
        return self._model is not None

    def load(self) -> None:
        with self._lock:
            if self._model is None:
                self._model = self._build()

    def _build(self) -> ViT:
        kw = {"patch_size": 14, "dim": 768, "depth": 12, "num_heads": 12}
        kw.update(self.model_overrides)
        model = ViT(img_size=self.INPUT_SIZE, attn_fn=self.attn_fn, **kw)
        if self.weights_path:
            state = state_dict_from_flax(load_params_npz(self.weights_path))
            model.load_state_dict(state)
            logger.info("loaded ViT weights from %s", self.weights_path)
        else:
            model.reset_parameters(self.seed)
            logger.warning(
                "no weights_path — running a randomly initialised ViT "
                "(seed %d; embeddings are not DINOv2)", self.seed,
            )
        model = model.to(self.device).eval()
        logger.info(
            "ViT embedder ready: device=%s pretrained=%s",
            self.device, self.pretrained,
        )
        return model

    def embed_batch(
        self, images_rgb: list[np.ndarray], batch_size: Optional[int] = None
    ) -> np.ndarray:
        """List of (H, W, 3)-ish microscopy arrays → (N, dim) float32
        L2-normalised. Batches pad to ``batch_bucket`` rows."""
        self.load()
        bucket = batch_size or self.batch_bucket
        prepped = np.stack(
            [to_model_input(img, self.INPUT_SIZE) for img in images_rgb]
        )
        out = []
        for i in range(0, len(prepped), bucket):
            chunk = prepped[i : i + bucket]
            n = len(chunk)
            if n < bucket:
                chunk = np.pad(chunk, ((0, bucket - n), (0, 0), (0, 0), (0, 0)))
            x = torch.from_numpy(chunk).to(self.device)
            with self._lock, torch.inference_mode():
                emb = self._model(x)
                emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-9)
                self.forward_count += 1
            out.append(emb[:n].cpu().numpy())
        return np.vstack(out)

    def embed_single(self, image_rgb: np.ndarray) -> np.ndarray:
        return self.embed_batch([image_rgb])[0]
