"""Weight formats: the flat ``jax_params`` npz and the bridge from flax
parameter trees to the port's ``state_dict``s.

Own copies of ``flatten_params`` / ``unflatten_params`` /
``load_params_npz`` from ``bioengine_tpu/runtime/convert.py``, so a
weight file the JAX package writes loads here. Tensors cross as numpy arrays.
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


def load_params_npz(path: str) -> dict[str, Any]:
    with np.load(path) as data:
        return unflatten_params({k: data[k] for k in data.files})


def vit_state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax ``bioengine_tpu.models.vit.ViT`` params (nested or flat, numpy)
    -> ``state_dict`` of ``bioengine_tpu_torch.models.vit.ViT``.

    Module paths keep their flax names (``block3/mlp/Dense_0`` ->
    ``block3.mlp.Dense_0``). Dense kernels (I, O) become (O, I) weights,
    the patch-embed conv kernel (kh, kw, I, O) becomes (O, I, kh, kw),
    LayerNorm ``scale`` becomes ``weight``; everything else is copied."""
    flat = flatten_params(params)  # a flat dict passes through as it is
    state: dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        arr = np.array(value, np.float32)  # a writable copy
        if leaf == "kernel":
            leaf = "weight"
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{key}: unexpected kernel rank {arr.ndim}")
        elif leaf == "scale":
            leaf = "weight"
        state[".".join([*path, leaf])] = torch.from_numpy(np.ascontiguousarray(arr))
    return state
