"""Device resolution for the port's entry points.

Counterpart of ``bioengine_tpu/runtime/engine.py:resolve_devices`` and
``mesh_cache_tag`` for one device: entry points run on the card unless the
caller asks for the CPU, and never drop to the CPU on their own.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

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


def resolve_devices(
    device_ids: Optional[Sequence[int]], device: DeviceLike = None
) -> list[torch.device]:
    """A replica's leased device ids -> the engine's device group, on
    ``device``'s backend (``resolve_device`` rules).

    Counterpart of ``bioengine_tpu/runtime/engine.py:resolve_devices`` for
    one device: no lease means ``device``; a lease of one id must name a
    device that exists (on the CPU, only id 0), and is refused otherwise,
    as the JAX version refuses on a real backend: remapping would stack
    disjoint leases onto one device. A lease of several ids needs the
    parallel layer (ROADMAP A10)."""
    base = resolve_device(device)
    if not device_ids:
        return [base]
    ids = [int(i) for i in device_ids]
    if len(ids) > 1:
        raise NotImplementedError(
            f"lease ids {ids}: a multi-device engine needs the parallel "
            "layer, not yet ported (ROADMAP A10)"
        )
    (i,) = ids
    count = torch.cuda.device_count() if base.type == "cuda" else 1
    if not 0 <= i < count:
        raise ValueError(
            f"lease id {i} matches no local {base.type} device (ids "
            f"0..{count - 1}); refusing to remap"
        )
    return [torch.device("cuda", i) if base.type == "cuda" else base]


def mesh_cache_tag(dp: int, tp: int = 1) -> str:
    """The one definition of device-group shape in cache keys (program
    cache and model-runner pipelines): '1dev' for one device, 'dp4',
    'dp2xtp2'. Two engines of different shapes never share a program."""
    dp, tp = max(int(dp), 1), max(int(tp), 1)
    if dp * tp == 1:
        return "1dev"
    return f"dp{dp}" + (f"xtp{tp}" if tp > 1 else "")


def device_name(device: Optional[torch.device]) -> str:
    if device is not None and device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
