"""Device resolution for the port's entry points.

Counterpart of ``bioengine_tpu/runtime/engine.py:resolve_devices`` for one
device: entry points run on the card unless the caller asks for the CPU, and
never drop to the CPU on their own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0``; ``"cuda"`` -> ``cuda:0``; ``"cpu"`` -> cpu.

    Raises when a CUDA device is asked for (or implied by ``None``) and is
    not there."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path"
        )
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device cuda:{index} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) exist"
        )
    return torch.device("cuda", index)


def device_name(device: Optional[torch.device]) -> str:
    if device is not None and device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
