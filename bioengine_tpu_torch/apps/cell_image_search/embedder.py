"""ViT embedder for cell crops, in PyTorch.

Counterpart of ``apps/cell-image-search/embedder.py``: DINOv2-geometry
ViT-B/14 at 224², bf16 products, batches padded to a fixed bucket, CLS
embeddings L2-normalised. Attention goes through ``ops.flash_attention``,
the hand-written kernel on the card (the JAX embedder's rule of taking the
kernel only at 1024 tokens and more was measured on a TPU and does not
apply). Without ``weights_path`` the weights are random, from
``np.random.default_rng(seed)``; with one, they are a flat ``jax_params``
npz of the flax ViT, carried over by ``state_dict_from_flax``.

The built model becomes the one program of the embedder's
``CompiledProgramCache`` once its kernels are loaded: on the card that
loads the flash kernel's library, so the cache tags it as it tags a graph
build, a persistent hit when the library came from the compile cache's
directory (or the tier) and a real build when nvcc had to run.

Over a device group (``devices``, the replica's lease) the embedder is
data parallel as the JAX one is: dp is the largest power of two, at most
the group's size, that divides ``batch_bucket``; each of the first dp
devices holds a replica of the ViT, a bucket splits into dp equal shards,
each replica embeds its shard with the flash kernel in its attention slot
(launched on its shard's device), and the embeddings are concatenated in
order on the first device.
"""

from __future__ import annotations

import logging
import threading
import copy
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from bioengine_tpu_torch.apps.cell_image_search.normalizer import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    to_model_input,
)
from bioengine_tpu_torch.models.vit import ViT
from bioengine_tpu_torch.ops import attention
from bioengine_tpu_torch.ops.attention import make_attn_fn
from bioengine_tpu_torch.runtime.convert import (
    load_params_npz,
    state_dict_from_flax,
)
from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device
from bioengine_tpu_torch.runtime.program_cache import CompiledProgramCache

logger = logging.getLogger(__name__)


def model_input(rgb: torch.Tensor) -> torch.Tensor:
    """(n, 224, 224, 3) uint8 RGB crops, on any device -> the rows
    ``to_model_input`` makes of them (ImageNet-scaled float32, the same
    operations in the same order), computed where the crops are: a batch
    streamed onto the card is scaled there."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(rgb.device)
    std = torch.from_numpy(IMAGENET_STD).to(rgb.device)
    return (rgb.float() / 255.0 - mean) / std


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
        # ("dtype" may be a torch dtype or its name, e.g. "float32")
        model_overrides: Optional[dict[str, Any]] = None,
        # the device group (a lease); None = [device]. Entries may repeat
        # a device (a stacked mesh)
        devices: Optional[Sequence[DeviceLike]] = None,
    ) -> None:
        self.devices = [resolve_device(d) for d in devices] if devices else [resolve_device(device)]
        self.weights_path = weights_path
        self.batch_bucket = batch_bucket
        self.seed = seed
        self.flash = attn_fn is None
        self.attn_fn = attn_fn or make_attn_fn()
        self.model_overrides = dict(model_overrides or {})
        self.embed_dim = self.model_overrides.get("dim", self.EMBED_DIM)
        self.pretrained = weights_path is not None
        self.forward_count = 0  # bucket forwards run so far
        self._model: Optional[ViT] = None
        self._replicas: list = []
        self._lock = threading.Lock()  # guards loading and forward_count
        self.programs = CompiledProgramCache(max_programs=1)

    @property
    def device(self) -> torch.device:
        """The group's first device: inputs, outputs and the first replica."""
        return self.devices[0]

    @property
    def dp(self) -> int:
        """The largest power of two <= the group's size that divides the bucket."""
        dp = 1
        while dp * 2 <= len(self.devices) and self.batch_bucket % (dp * 2) == 0:
            dp *= 2
        return dp

    @property
    def loaded(self) -> bool:
        return self._model is not None

    def load(self) -> None:
        with self._lock:
            if self._model is None:
                model = self._build()
                group = ",".join(str(d) for d in self.devices[: self.dp])
                key = ("vit-embedder", group, str(self.model_overrides))
                self._replicas = self.programs.get_or_compile(key, lambda: self._prepare(model))
                self._model = self._replicas[0]

    def _prepare(self, model: ViT) -> list:
        """The program: the built model and its replicas on the group's
        other devices, once the kernels are loaded (on the card, the flash
        kernel's library from the compile cache, built with nvcc only if
        missing; a launch selects its shard's device)."""
        if self.flash and self.device.type == "cuda":
            attention.load_kernel()
        return [model] + [copy.deepcopy(model).to(d) for d in self.devices[1 : self.dp]]

    def _build(self) -> ViT:
        kw = {"patch_size": 14, "dim": 768, "depth": 12, "num_heads": 12}
        kw.update(self.model_overrides)
        if isinstance(kw.get("dtype"), str):  # by name, as deployment kwargs carry it
            kw["dtype"] = getattr(torch, kw["dtype"])
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
            out.append(self._forward(x)[:n].cpu().numpy())
        return np.vstack(out)

    def embed_tensor(self, x: torch.Tensor) -> torch.Tensor:
        """A batch of model input already on the embedder's device, (n,
        224, 224, 3) float32 as ``to_model_input`` makes its rows, n at most
        the bucket -> (n, dim) L2-normalised embeddings, on the device. The
        batch pads to ``batch_bucket`` rows with zeros, as ``embed_batch``
        pads."""
        self.load()
        n = x.shape[0]
        if n > self.batch_bucket:
            raise ValueError(f"{n} rows exceed the bucket of {self.batch_bucket}")
        if n < self.batch_bucket:
            x = torch.cat([x, x.new_zeros((self.batch_bucket - n, *x.shape[1:]))])
        return self._forward(x)[:n]

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        dp = len(self._replicas)
        if x.shape[0] % dp:
            raise ValueError(f"a bucket of {x.shape[0]} rows does not split into dp={dp} shards")
        with self._lock, torch.inference_mode():
            embs = []
            for replica, shard, dev in zip(self._replicas, x.chunk(dp), self.devices):
                emb = replica(shard.to(dev))
                embs.append(emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-9))
            emb = embs[0] if dp == 1 else torch.cat([e.to(self.device) for e in embs])
            self.forward_count += 1
        return emb

    def embed_single(self, image_rgb: np.ndarray) -> np.ndarray:
        return self.embed_batch([image_rgb])[0]
