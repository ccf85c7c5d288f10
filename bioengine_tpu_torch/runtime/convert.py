"""Weight formats: the flat ``jax_params`` npz and the bridge between flax
parameter trees and the port's ``state_dict``s, both ways.

Own copies of ``flatten_params`` / ``unflatten_params`` /
``load_params_npz`` / ``save_params_npz`` from
``bioengine_tpu/runtime/convert.py``, so a weight file either package
writes loads in the other. Tensors cross as numpy arrays.

Module paths keep their flax names (``block3/mlp/Dense_0`` ->
``block3.mlp.Dense_0``). The kernel rule follows the module's name and
then its rank:

- ``ConvTranspose_*``: flax (k..., I, O) <-> torch (I, O, k...), flipped
  in every spatial axis. Flax's SAME-padded transposed convolution with
  kernel == stride gives ``out[s*i + t] = x[i] K[s-1-t]`` and torch's
  ``out[s*i + t] = x[i] W[t]`` (the flip ``convert.py:31-33`` of the JAX
  package applies in the other direction);
- any other rank >= 3 kernel is a convolution: (k..., I, O) <-> (O, I, k...);
- a rank-2 kernel is a Dense: (I, O) <-> (O, I).

Norm ``scale`` <-> ``weight`` (a rank-1 ``weight`` on the way back);
everything else is copied.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def flatten_params(
    tree: Mapping[str, Any], prefix: str = ""
) -> dict[str, np.ndarray]:
    """Nested params dict -> {"a/b/c": array} for npz storage."""
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_params(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten_params(flat: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """Inverse of ``flatten_params``."""
    params: dict[str, Any] = {}
    for key, value in flat.items():
        node = params
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)
    return params


def save_params_npz(path: str, params: Mapping[str, Any]) -> None:
    np.savez(path, **flatten_params(params))


def load_params_npz(path: str) -> dict[str, Any]:
    with np.load(path) as data:
        return unflatten_params({k: data[k] for k in data.files})


def _is_transposed(path: list[str]) -> bool:
    return bool(path) and path[-1].startswith("ConvTranspose")


def state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax params (nested or flat, numpy) -> the port's ``state_dict``
    with the same module names."""
    flat = flatten_params(params)  # a flat dict passes through as it is
    state: dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        arr = np.array(value, np.float32)  # a writable copy
        if leaf == "kernel":
            leaf = "weight"
            n = arr.ndim
            if _is_transposed(path):
                spatial = tuple(range(n - 2))
                arr = np.flip(arr, spatial).transpose(n - 2, n - 1, *spatial)
            elif n >= 3:
                arr = arr.transpose(n - 1, n - 2, *range(n - 2))
            elif n == 2:
                arr = arr.T
            else:
                raise ValueError(f"{key}: unexpected kernel rank {n}")
        elif leaf == "scale":
            leaf = "weight"
        state[".".join([*path, leaf])] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def flax_params_from_state_dict(
    state: Mapping[str, torch.Tensor],
) -> dict[str, np.ndarray]:
    """Inverse of ``state_dict_from_flax``: the port's ``state_dict`` ->
    a flat {"a/b/c": f32 array} in flax names, ready for
    ``save_params_npz`` (the JAX package's ``jax_params`` format)."""
    flat: dict[str, np.ndarray] = {}
    for key, value in state.items():
        *path, leaf = key.split(".")
        arr = value.detach().cpu().float().numpy()
        n = arr.ndim
        if leaf == "weight" and n == 1:
            leaf = "scale"
        elif leaf == "weight":
            leaf = "kernel"
            if _is_transposed(path):
                arr = np.flip(arr.transpose(*range(2, n), 0, 1), tuple(range(n - 2)))
            elif n >= 3:
                arr = arr.transpose(*range(2, n), 1, 0)
            else:
                arr = arr.T
        flat["/".join([*path, leaf])] = np.ascontiguousarray(arr)
    return flat
