"""Minimal GPU sanity-check deployment, the twin of ``apps/tpu-test``:
the same three schema methods and result keys. The device probe lists the
visible CUDA devices and runs one 128x128 bf16 matmul on the replica's
leased card; the environment report covers the CUDA variables that the
worker sets for a leased process (``worker/code_executor.py``
``chip_env``) in place of the TPU/JAX ones. Runs on ``cuda`` unless given
``device="cpu"``.
"""

import os
import time

import torch

from bioengine_tpu_torch.rpc import schema_method
from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device, resolve_devices

_CUDA_ENV_KEYS = ("CUDA_VISIBLE_DEVICES", "BIOENGINE_LEASED_CHIPS")


class GpuTest:
    def __init__(self, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.start_time = time.time()

    async def async_init(self) -> None:
        """The replica lifecycle injects the leased chip
        (``bioengine_device_ids``) before this runs; the matmul runs there."""
        lease = getattr(self, "bioengine_device_ids", None)
        (self.device,) = resolve_devices(list(lease) if lease else None, self.device)

    def _visible_devices(self) -> list[dict]:
        if self.device.type == "cuda":
            return [
                {
                    "id": i,
                    "platform": "gpu",
                    "device_kind": torch.cuda.get_device_name(i),
                    "process_index": 0,
                }
                for i in range(torch.cuda.device_count())
            ]
        return [{"id": 0, "platform": "cpu", "device_kind": "cpu", "process_index": 0}]

    @schema_method
    async def ping(self, context=None):
        """Cheap liveness probe; does not touch the device."""
        return {
            "status": "ok",
            "uptime": time.time() - self.start_time,
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        }

    @schema_method
    async def gpu_info(self, context=None):
        """Enumerate the visible CUDA devices and run one matmul on the
        leased card.

        Returns the backend, the device list (kind/id/process), and the
        result norm of a 128x128 bf16 matmul as proof the device executes.
        """
        try:
            devices = self._visible_devices()
            x = torch.ones((128, 128), dtype=torch.bfloat16, device=self.device)
            norm = float(torch.linalg.norm((x @ x).float()))
            return {
                "backend": self.device.type,
                "device_count": len(devices),
                "devices": devices,
                "matmul_norm": norm,
                "env": {k: os.environ.get(k) for k in _CUDA_ENV_KEYS},
                "error": "",
            }
        except Exception as e:  # report instead of failing the health check
            return {
                "backend": None,
                "device_count": 0,
                "devices": [],
                "matmul_norm": None,
                "env": {k: os.environ.get(k) for k in _CUDA_ENV_KEYS},
                "error": str(e),
            }

    @schema_method
    async def memory_info(self, context=None):
        """Per-device memory stats of the caching allocator
        (``torch.cuda.memory_stats``); None where the backend has none."""
        if self.device.type != "cuda":
            return {"devices": [
                {"id": 0, "bytes_in_use": None, "bytes_limit": None, "peak_bytes_in_use": None}
            ]}
        stats = []
        for i in range(torch.cuda.device_count()):
            s = torch.cuda.memory_stats(i)
            stats.append(
                {
                    "id": i,
                    "bytes_in_use": s.get("allocated_bytes.all.current", 0),
                    "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
                    "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
                }
            )
        return {"devices": stats}
