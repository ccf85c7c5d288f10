"""Device resolution for the port's entry points.

Counterpart of ``bioengine_tpu/runtime/engine.py:resolve_devices`` and
``mesh_cache_tag``: entry points run on the card unless the caller asks
for the CPU, and never drop to the CPU on their own.
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


# The CPU stands for this many host devices, ids 0..7: the width of the
# forced host-device CPU mesh the JAX package is exercised on
CPU_DEVICE_COUNT = 8


def resolve_devices(
    device_ids: Optional[Sequence[int]], device: DeviceLike = None
) -> list[torch.device]:
    """A replica's leased device ids -> the engine's device group, on
    ``device``'s backend (``resolve_device`` rules).

    Counterpart of ``bioengine_tpu/runtime/engine.py:resolve_devices``: no
    lease means ``device``. On ``cuda`` a lease maps by index onto the
    cards; an id with no card, a repeated id or a lease that only partly
    matches raises: remapping would stack disjoint leases onto one card
    while the controller's accounting shows them separate. On ``cpu``,
    where torch has one device, the lease is matched against the ids
    0..``CPU_DEVICE_COUNT - 1`` by the same rules, with JAX's CPU-only
    width-preserving fallback for a lease none of whose ids exist; a lease
    of N ids gives N entries of ``cpu``."""
    base = resolve_device(device)
    if not device_ids:
        return [base]
    ids = [int(i) for i in device_ids]
    if len(set(ids)) != len(ids):
        raise ValueError(f"lease ids {ids} repeat a device — refusing to stack a lease onto one chip")
    cpu = base.type == "cpu"
    local = list(range(CPU_DEVICE_COUNT if cpu else torch.cuda.device_count()))
    matched = [i for i in ids if i in local]
    if len(matched) == len(ids):
        return [base if cpu else torch.device("cuda", i) for i in ids]
    if matched:
        raise ValueError(
            f"lease ids {ids} only partially match local device ids "
            f"{local} — chip numbering conflict"
        )
    if not cpu:
        raise ValueError(
            f"lease ids {ids} match no local device ids {local} on a "
            f"{base.type} backend — refusing to remap (disjoint leases would "
            "stack onto the same chips); the width-preserving fallback is CPU-only"
        )
    if len(ids) > len(local):
        raise ValueError(
            f"lease names {len(ids)} chips but only {len(local)} local devices exist"
        )
    return [base] * len(ids)


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
