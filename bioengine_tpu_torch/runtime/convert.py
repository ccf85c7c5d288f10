"""Weight formats: torch checkpoints into the flat ``jax_params`` npz, and
the bridge between flax parameter trees and the port's ``state_dict``s,
both ways.

Own copies of ``bioengine_tpu/runtime/convert.py``'s checkpoint half
(``conv_kernel`` .. ``convert_checkpoint``: a torch ``.pth`` through a name
map into flax names, written as the same npz the JAX converter writes) and
of its ``flatten_params`` / ``unflatten_params`` / ``load_params_npz`` /
``save_params_npz``, so a weight file either package writes loads in the
other. Tensors cross as numpy arrays.

Module paths keep their flax names (``block3/mlp/Dense_0`` ->
``block3.mlp.Dense_0``). The kernel rule follows the module's name and
then its rank:

- a transposed convolution (``ConvTranspose_*``, and CellposeSAM's
  ``up{i}`` and CpSAM's ``out``, which flax names by hand): flax
  (k..., I, O) <-> torch (I, O, k...), flipped in every spatial axis.
  Flax's SAME-padded transposed convolution with kernel == stride gives
  ``out[s*i + t] = x[i] K[s-1-t]`` and torch's ``out[s*i + t] = x[i]
  W[t]`` (``conv_transpose_kernel`` applies the flip in the other
  direction);
- any other rank >= 3 kernel is a convolution: (k..., I, O) <-> (O, I, k...);
- a rank-2 kernel is a Dense: (I, O) <-> (O, I).

Norm ``scale`` <-> ``weight`` (a rank-1 ``weight`` on the way back);
everything else is copied.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping

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


# ---- torch checkpoints -> flax names ------------------------------------------


def conv_kernel(w: np.ndarray) -> np.ndarray:
    """(O, I, kH, kW) -> (kH, kW, I, O)."""
    return np.transpose(w, (2, 3, 1, 0))


def conv_transpose_kernel(w: np.ndarray) -> np.ndarray:
    """torch (I, O, kH, kW) -> flax (kH, kW, I, O), spatially flipped."""
    return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]


def linear_kernel(w: np.ndarray) -> np.ndarray:
    """(O, I) -> (I, O)."""
    return np.transpose(w)


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Read a torch checkpoint into numpy arrays (CPU, no grad state)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in obj.items()}


Rule = tuple[str, Callable[[np.ndarray], np.ndarray]]


def convert_state_dict(
    state_dict: Mapping[str, np.ndarray],
    name_map: "Mapping[str, Rule | None]",
    strict: bool = True,
) -> dict[str, Any]:
    """Convert ``state_dict`` into a nested params dict in flax names.

    ``name_map``: torch key -> ("flax/nested/path", transform), or
    ``None`` for keys the checkpoint is known to carry but the model
    deliberately doesn't use (DINOv2's ``mask_token``). Keys in the state
    dict but not in the map raise under ``strict``, naming themselves;
    otherwise they are skipped."""
    params: dict[str, Any] = {}
    unmapped = []
    for tkey, tensor in state_dict.items():
        if tkey not in name_map:
            unmapped.append(tkey)
            continue
        rule = name_map[tkey]
        if rule is None:
            continue  # known key, deliberately dropped
        fpath, transform = rule
        node = params
        parts = fpath.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(transform(np.asarray(tensor)))
    if strict and unmapped:
        raise KeyError(
            f"{len(unmapped)} torch keys had no mapping, e.g. {unmapped[:5]}"
        )
    return params


def _ident(w: np.ndarray) -> np.ndarray:
    return w


def dinov2_name_map(depth: int = 12) -> "dict[str, Rule | None]":
    """Name map: DINOv2 torch checkpoint -> the ViT's flax names."""
    m: "dict[str, Rule | None]" = {
        "cls_token": ("cls_token", lambda w: w.reshape(1, 1, -1)),
        # in every published DINOv2 checkpoint; the ViT never masks patches
        "mask_token": None,
        "pos_embed": ("pos_embed", _ident),
        "patch_embed.proj.weight": ("patch_embed/kernel", conv_kernel),
        "patch_embed.proj.bias": ("patch_embed/bias", _ident),
        "norm.weight": ("norm/scale", _ident),
        "norm.bias": ("norm/bias", _ident),
    }
    for i in range(depth):
        t, f = f"blocks.{i}", f"block{i}"
        m.update({
            f"{t}.norm1.weight": (f"{f}/norm1/scale", _ident),
            f"{t}.norm1.bias": (f"{f}/norm1/bias", _ident),
            f"{t}.attn.qkv.weight": (f"{f}/attn/qkv/kernel", linear_kernel),
            f"{t}.attn.qkv.bias": (f"{f}/attn/qkv/bias", _ident),
            f"{t}.attn.proj.weight": (f"{f}/attn/proj/kernel", linear_kernel),
            f"{t}.attn.proj.bias": (f"{f}/attn/proj/bias", _ident),
            f"{t}.ls1.gamma": (f"{f}/ls1", _ident),
            f"{t}.ls2.gamma": (f"{f}/ls2", _ident),
            f"{t}.norm2.weight": (f"{f}/norm2/scale", _ident),
            f"{t}.norm2.bias": (f"{f}/norm2/bias", _ident),
            f"{t}.mlp.fc1.weight": (f"{f}/mlp/Dense_0/kernel", linear_kernel),
            f"{t}.mlp.fc1.bias": (f"{f}/mlp/Dense_0/bias", _ident),
            f"{t}.mlp.fc2.weight": (f"{f}/mlp/Dense_1/kernel", linear_kernel),
            f"{t}.mlp.fc2.bias": (f"{f}/mlp/Dense_1/bias", _ident),
        })
    return m


def cpsam_name_map(depth: int = 24) -> dict[str, Rule]:
    """Name map: cpsam torch checkpoint -> ``models.sam.CpSAM``'s flax names.

    cpsam is segment-anything's ImageEncoderViT under ``encoder.``
    (patch_embed.proj, pos_embed, blocks.N.{norm1, attn.qkv,
    attn.rel_pos_h/w, attn.proj, norm2, mlp.lin1/lin2}, neck.0..3) plus a
    transposed-conv 3-channel readout ``out``."""
    m: dict[str, Rule] = {
        "encoder.patch_embed.proj.weight": ("encoder/patch_embed/kernel", conv_kernel),
        "encoder.patch_embed.proj.bias": ("encoder/patch_embed/bias", _ident),
        # SAM stores pos_embed as (1, gh, gw, dim) already, NHWC
        "encoder.pos_embed": ("encoder/pos_embed", _ident),
        "encoder.neck.0.weight": ("encoder/neck_conv1/kernel", conv_kernel),
        "encoder.neck.1.weight": ("encoder/neck_norm1/scale", _ident),
        "encoder.neck.1.bias": ("encoder/neck_norm1/bias", _ident),
        "encoder.neck.2.weight": ("encoder/neck_conv2/kernel", conv_kernel),
        "encoder.neck.3.weight": ("encoder/neck_norm2/scale", _ident),
        "encoder.neck.3.bias": ("encoder/neck_norm2/bias", _ident),
        "out.weight": ("out/kernel", conv_transpose_kernel),
        "out.bias": ("out/bias", _ident),
    }
    for i in range(depth):
        t, f = f"encoder.blocks.{i}", f"encoder/block{i}"
        m.update({
            f"{t}.norm1.weight": (f"{f}/norm1/scale", _ident),
            f"{t}.norm1.bias": (f"{f}/norm1/bias", _ident),
            f"{t}.attn.qkv.weight": (f"{f}/attn/qkv/kernel", linear_kernel),
            f"{t}.attn.qkv.bias": (f"{f}/attn/qkv/bias", _ident),
            f"{t}.attn.proj.weight": (f"{f}/attn/proj/kernel", linear_kernel),
            f"{t}.attn.proj.bias": (f"{f}/attn/proj/bias", _ident),
            f"{t}.attn.rel_pos_h": (f"{f}/attn/rel_pos_h", _ident),
            f"{t}.attn.rel_pos_w": (f"{f}/attn/rel_pos_w", _ident),
            f"{t}.norm2.weight": (f"{f}/norm2/scale", _ident),
            f"{t}.norm2.bias": (f"{f}/norm2/bias", _ident),
            f"{t}.mlp.lin1.weight": (f"{f}/mlp_lin1/kernel", linear_kernel),
            f"{t}.mlp.lin1.bias": (f"{f}/mlp_lin1/bias", _ident),
            f"{t}.mlp.lin2.weight": (f"{f}/mlp_lin2/kernel", linear_kernel),
            f"{t}.mlp.lin2.bias": (f"{f}/mlp_lin2/bias", _ident),
        })
    return m


def synthetic_cpsam_state_dict(
    patch_size: int = 8,
    dim: int = 32,
    depth: int = 2,
    num_heads: int = 2,
    window_size: int = 2,
    global_attn_indexes=(1,),
    neck_dim: int = 16,
    pretrain_grid: int = 4,
    mlp_ratio: float = 4.0,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """A torch-layout cpsam checkpoint of standard-normal tensors from
    ``np.random.default_rng(seed)``, at any size, in the JAX package's draw
    order (so both packages draw the same tensors). The default is a tiny
    config; the published ViT-L shape is patch 8, dim 1024, depth 24,
    heads 16, window 14, global (5, 11, 17, 23), grid 32, neck 256."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    hd, mlp = dim // num_heads, int(dim * mlp_ratio)
    sd = {
        "encoder.patch_embed.proj.weight": f32(dim, 3, patch_size, patch_size),
        "encoder.patch_embed.proj.bias": f32(dim),
        "encoder.pos_embed": f32(1, pretrain_grid, pretrain_grid, dim),
        "encoder.neck.0.weight": f32(neck_dim, dim, 1, 1),
        "encoder.neck.1.weight": f32(neck_dim),
        "encoder.neck.1.bias": f32(neck_dim),
        "encoder.neck.2.weight": f32(neck_dim, neck_dim, 3, 3),
        "encoder.neck.3.weight": f32(neck_dim),
        "encoder.neck.3.bias": f32(neck_dim),
        "out.weight": f32(neck_dim, 3, patch_size, patch_size),
        "out.bias": f32(3),
    }
    for i in range(depth):
        s = window_size if i not in global_attn_indexes else pretrain_grid
        t = f"encoder.blocks.{i}"
        sd.update({
            f"{t}.norm1.weight": f32(dim),
            f"{t}.norm1.bias": f32(dim),
            f"{t}.attn.qkv.weight": f32(3 * dim, dim),
            f"{t}.attn.qkv.bias": f32(3 * dim),
            f"{t}.attn.proj.weight": f32(dim, dim),
            f"{t}.attn.proj.bias": f32(dim),
            f"{t}.attn.rel_pos_h": f32(2 * s - 1, hd),
            f"{t}.attn.rel_pos_w": f32(2 * s - 1, hd),
            f"{t}.norm2.weight": f32(dim),
            f"{t}.norm2.bias": f32(dim),
            f"{t}.mlp.lin1.weight": f32(mlp, dim),
            f"{t}.mlp.lin1.bias": f32(mlp),
            f"{t}.mlp.lin2.weight": f32(dim, mlp),
            f"{t}.mlp.lin2.bias": f32(dim),
        })
    return sd


ARCH_NAME_MAPS: dict[str, Callable[[int], dict[str, Rule]]] = {
    "cpsam": cpsam_name_map,
    "dinov2": dinov2_name_map,
}


def infer_depth(state_dict: Mapping[str, np.ndarray]) -> int:
    """Transformer depth from the highest ``blocks.N.`` index."""
    idx = [
        int(m.group(1))
        for k in state_dict
        for m in [re.search(r"blocks\.(\d+)\.", k)]
        if m
    ]
    if not idx:
        raise ValueError("no 'blocks.N.' keys — not a ViT state dict?")
    return max(idx) + 1


def convert_checkpoint(
    arch: str,
    checkpoint_path: str,
    out_path: str,
    depth: int | None = None,
    strict: bool = True,
) -> dict[str, Any]:
    """Torch checkpoint file -> flat-npz ``jax_params`` at ``out_path`` (the
    weight format of the finetuning app's ``pretrained_path``, the
    model-runner's packages and the embedder's weights). Returns the
    converted tree."""
    if arch not in ARCH_NAME_MAPS:
        raise ValueError(f"unknown arch '{arch}' — have {sorted(ARCH_NAME_MAPS)}")
    sd = load_torch_state_dict(checkpoint_path)
    if depth is None:
        depth = infer_depth(sd)
    params = convert_state_dict(sd, ARCH_NAME_MAPS[arch](depth), strict=strict)
    save_params_npz(out_path, params)
    return params


def count_params(params: Any) -> int:
    """Scalars in a nested params tree (the leaves of ``flatten_params``)."""
    return sum(int(np.prod(np.shape(x))) for x in flatten_params(params).values())


# ---- flax trees <-> the port's state_dicts ------------------------------------


# flax names of the transposed convolutions of the ported models
_TRANSPOSED = re.compile(r"ConvTranspose(_\d+)?|up\d+|out")


def _is_transposed(path: list[str]) -> bool:
    return bool(path) and _TRANSPOSED.fullmatch(path[-1]) is not None


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
