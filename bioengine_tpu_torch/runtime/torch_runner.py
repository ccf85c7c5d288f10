"""Zoo torch models (``pytorch_state_dict``, ``torchscript``) on the port's device.

Counterpart of ``bioengine_tpu/runtime/torch_fallback.py``'s
``TorchFallbackRunner``, which runs these formats on the host CPU; here
the same module runs on the card (or on the CPU when asked), behind the
same ``predict`` contract:

- channels-last numpy in and out, (B, H, W, C) images and (B, D, H, W, C)
  volumes, permuted to the module's channels-first layout inside;
- a tuple or list output means its first element;
- the whole array goes through the module in one call: no buckets, no
  tiling, as the reference does;
- the forward runs in f32 with TF32 off for cuDNN and cuBLAS (a zoo
  package's test tensors are the CPU's f32 answers), stated by
  ``describe()``;
- one worker thread with a lock serialises device use, as the inference
  engine's dispatch thread does.

Entry points run on ``cuda`` unless given ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
from torch import nn

from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device

PRECISION = "float32, TF32 off (cuDNN and cuBLAS)"


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the block;
    the previous settings come back after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = matmul.allow_tf32
    with cudnn.flags(
        enabled=cudnn.enabled, benchmark=cudnn.benchmark,
        deterministic=cudnn.deterministic, allow_tf32=False,
    ):
        matmul.allow_tf32 = False
        try:
            yield
        finally:
            matmul.allow_tf32 = before


class TorchRunner:
    """``predict(channels-last numpy) -> channels-last numpy`` through a
    torch module or a TorchScript file, on ``device``."""

    def __init__(
        self,
        module: Optional[nn.Module] = None,
        torchscript_path: Optional[str] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if module is None:
            if torchscript_path is None:
                raise ValueError("need a module or a torchscript path")
            module = torch.jit.load(torchscript_path, map_location=self.device)
        self.kind = "module" if torchscript_path is None else "torchscript"
        self.module = module.eval().to(self.device)
        self.runs = 0
        self._lock = threading.Lock()
        self._worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="torch-runner")

    def predict(self, images: np.ndarray) -> np.ndarray:
        if images.ndim == 5:
            to_cf, to_cl = (0, 4, 1, 2, 3), (0, 2, 3, 4, 1)
        else:
            to_cf, to_cl = (0, 3, 1, 2), (0, 2, 3, 1)
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).permute(*to_cf)
        with self._lock, full_f32(), torch.no_grad():
            y = self.module(x.to(self.device))
            if isinstance(y, (list, tuple)):
                y = y[0]
            out = y.detach().permute(*to_cl).cpu().numpy()
            self.runs += 1
        return out

    def submit(self, fn, *args, **kwargs) -> Future:
        """Run ``fn`` on the runner's one worker thread."""
        return self._worker.submit(fn, *args, **kwargs)

    def describe(self) -> dict:
        return {
            "kind": self.kind,
            "device": str(self.device),
            "precision": PRECISION,
            "runs": self.runs,
        }

    def close(self) -> None:
        self._worker.shutdown(wait=False)
