"""Device topology over CUDA.

Counterpart of ``bioengine_tpu/cluster/topology.py``, with the same
names: a "chip" is one CUDA device, its ``kind`` the device's name and
its ``hbm_bytes`` the device's total memory. ``detect_topology`` runs on
``cuda`` unless asked for the CPU, and raises where CUDA is absent.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ChipInfo:
    device_id: int
    platform: str              # "tpu" | "cpu" | ...
    kind: str                  # e.g. "TPU v5 lite"
    process_index: int
    hbm_bytes: Optional[int] = None
    hbm_used_bytes: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class TpuTopology:
    chips: tuple[ChipInfo, ...]
    n_hosts: int
    platform: str

    @property
    def n_chips(self) -> int:
        return len(self.chips)

    @property
    def chips_per_host(self) -> int:
        return max(1, self.n_chips // max(1, self.n_hosts))

    def local_chips(self, process_index: Optional[int] = None) -> list[ChipInfo]:
        pi = (
            process_index
            if process_index is not None
            else int(os.environ.get("TPU_PROCESS_INDEX", 0))
        )
        return [c for c in self.chips if c.process_index == pi]

    def default_mesh_axes(self) -> dict[str, int]:
        """dp-major default: all chips data-parallel. Apps override via
        their manifest's mesh spec."""
        return {"dp": self.n_chips}

    def as_dict(self) -> dict:
        return {
            "platform": self.platform,
            "n_chips": self.n_chips,
            "n_hosts": self.n_hosts,
            "chips": [dataclasses.asdict(c) for c in self.chips],
        }


def detect_topology(device: DeviceLike = "cuda", n_devices: Optional[int] = None) -> TpuTopology:
    """Enumerate the visible CUDA devices (``torch.cuda``), or with
    ``device="cpu"`` a topology of ``n_devices`` (default 1) CPU chips for
    tests. ``n_devices`` on ``cuda`` takes the first ``n`` devices. Raises
    when CUDA is asked for and absent: it never returns CPU chips
    unasked."""
    base = resolve_device(device)
    if base.type == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        chips = tuple(
            ChipInfo(device_id=i, platform="cpu", kind="cpu", process_index=0)
            for i in range(n)
        )
        return TpuTopology(chips=chips, n_hosts=1, platform="cpu")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 0 < n <= count:
        raise ValueError(f"n_devices={n_devices}: {count} CUDA device(s) exist")
    chips = []
    for i in range(n):
        free, total = torch.cuda.mem_get_info(i)
        chips.append(
            ChipInfo(
                device_id=i,
                platform="gpu",
                kind=torch.cuda.get_device_name(i),
                process_index=0,
                hbm_bytes=int(total),
                hbm_used_bytes=int(total - free),
            )
        )
    return TpuTopology(chips=tuple(chips), n_hosts=1, platform="gpu")
