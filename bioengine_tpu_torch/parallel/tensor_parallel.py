"""Tensor parallelism: Megatron-style weight slices over the ``tp`` axis.

Counterpart of ``bioengine_tpu/parallel/tensor_parallel.py``. The JAX
module states the Megatron layout as ``PartitionSpec`` rules over the
param tree and lets GSPMD insert the all-reduces. Here one process drives
each tp group and runs the layout by hand:

- the rules are the JAX regexes over the port's dotted parameter names,
  with specs in the port's layout (an ``nn.Linear`` weight is (out, in), a
  convolution's (cout, cin, *k)): each names the same logical dimension
  as the JAX rule names for the bridged parameter. A third element of a
  rule splits the dimension as that many equal groups, each group sliced
  alike: a fused qkv weight is split by heads, so entry s holds the q, k
  and v rows of heads [s·H/tp, (s+1)·H/tp), the Megatron layout;
- ``shard_params`` gives every mesh entry its slice (1/tp of each matched
  tensor), as JAX places them, and each tp group one copy of each
  replicated tensor, on the group's home (first) entry: the group runs its
  whole layers there;
- ``tp_group_modules`` builds, per tp group, a copy of the model whose
  matched layers hold the group's slices. A ViT attention block runs its
  H/tp heads on each entry, through the model's ``attn_fn`` (the flash
  kernel on the card), and the MLP its hidden columns; the row-parallel
  partial products (``attn.proj``, ``mlp.Dense_1``) are summed onto the
  group's first entry in shard order and the bias is added once. A
  convolution computes its cout/tp output channels on each entry from the
  whole input, and the channels are gathered in shard order (GSPMD's
  result for ``CONV_TP_RULES``). The layers the rules leave whole run
  once, on the group's first entry; each tp layer copies its input from
  there to the group, so every entry computes on the same bits.

Collectives are explicit device-to-device copies in a fixed order, so a
result does not depend on timing; no ``torch.distributed``.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bioengine_tpu_torch.models import unet as unet_mod
from bioengine_tpu_torch.models import vit as vit_mod
from bioengine_tpu_torch.parallel.data_parallel import Replicated, Shards
from bioengine_tpu_torch.parallel.mesh import Mesh, PartitionSpec as P

# Megatron layout for the ViT blocks: column-parallel qkv and MLP up (split
# by output features; qkv as three groups, so by heads), row-parallel
# attn out and MLP down (split by input features), so each block needs one
# sum per product pair. LayerNorm, LayerScale, embeddings stay whole.
VIT_TP_RULES: list[tuple] = [
    (r"attn\.qkv\.weight$", P("tp", None), 3),
    (r"attn\.qkv\.bias$", P("tp"), 3),
    (r"attn\.proj\.weight$", P(None, "tp")),
    (r"mlp\.Dense_0\.weight$", P("tp", None)),
    (r"mlp\.Dense_0\.bias$", P("tp")),
    (r"mlp\.Dense_1\.weight$", P(None, "tp")),
]

# UNet2D / CellposeNet convolutions: split output channels (a weight is
# (cout, cin, kh, kw)).
CONV_TP_RULES: list[tuple] = [
    (r"Conv_\d+\.weight$", P("tp")),
    (r"Conv_\d+\.bias$", P("tp")),
]


def _named(params: Any) -> dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.state_dict())
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            for k, v in params.items()}


def _match(rules: Sequence[tuple], name: str) -> tuple[P, int]:
    """(spec, groups) of the first rule whose regex matches ``name``."""
    for rule in rules:
        if re.search(rule[0], name):
            return P(*rule[1]), (rule[2] if len(rule) > 2 else 1)
    return P(), 1


def _divisible(spec: P, shape: tuple, mesh: Optional[Mesh], groups: int = 1) -> bool:
    """A spec is usable only when every split dim divides by its mesh axis
    size (times its groups): a 1-channel output conv never splits on tp."""
    if mesh is None:
        return True
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        if any(a not in mesh.shape for a in axes):
            return False  # axis absent from this mesh: replicate
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if dim >= len(shape) or shape[dim] % (size * groups) != 0:
            return False
    return True


def _layout(params: Any, rules: Sequence[tuple], mesh: Optional[Mesh]) -> dict[str, tuple[P, int]]:
    out = {}
    for name, leaf in _named(params).items():
        spec, groups = _match(rules, name)
        if not _divisible(spec, tuple(leaf.shape), mesh, groups):
            spec, groups = P(), 1
        out[name] = (spec, groups)
    return out


def tp_param_specs(params: Any, rules: Sequence[tuple], mesh: Optional[Mesh] = None) -> dict[str, P]:
    """Name -> ``PartitionSpec`` for ``params`` (a state dict or a module):
    the first rule whose regex matches the dotted name wins; unmatched
    params, and matched ones whose shapes don't divide by the mesh axis,
    are replicated (``P()``)."""
    return {name: spec for name, (spec, _) in _layout(params, rules, mesh).items()}


def tp_slice(x: torch.Tensor, dim: int, n: int, j: int, groups: int = 1) -> torch.Tensor:
    """Part ``j`` of ``n`` of ``x`` along ``dim``: with ``groups`` > 1 the
    dimension is that many equal groups, and the part is the j-th slice of
    each, concatenated (a fused qkv weight's heads)."""
    return torch.cat([g.chunk(n, dim)[j] for g in x.chunk(groups, dim)], dim)


def shard_params(mesh: Mesh, params: Any, rules: Sequence[tuple]) -> tuple[dict, dict]:
    """Place ``params`` onto the mesh per the rules: a split parameter as
    ``Shards`` (entry e holds the slice of its coordinate along the axis),
    a replicated one as ``Replicated``: one copy per tp group, on its home
    entry, which every entry of the group refers to. Returns (sharded,
    specs)."""
    named = _named(params)
    layout = _layout(named, rules, mesh)
    home = {e: g[0] for g in tp_groups(mesh) for e in g}
    sharded = {}
    for name, x in named.items():
        spec, groups = layout[name]
        split = [(d, a) for d, a in enumerate(spec) if a is not None]
        if not split:
            copies = {h: x.to(mesh.devices[h], copy=True) for h in sorted(set(home.values()))}
            sharded[name] = Replicated([copies[home[e]] for e in range(mesh.size)], mesh)
            continue
        (dim, axis), = split
        n = mesh.shape[axis]
        parts = [tp_slice(x, dim, n, j, groups).contiguous() for j in range(n)]
        sharded[name] = Shards(
            [parts[c].to(d, copy=True) for c, d in zip(mesh.coords(axis), mesh.devices)],
            mesh, axis, dim, groups,
        )
    return sharded, {name: spec for name, (spec, _) in layout.items()}


@torch.no_grad()
def reshard_into(sharded: Mapping[str, Any], params: Any) -> None:
    """Copy a full state dict into ``shard_params``'s tensors in place, by
    the same layout (addresses unchanged: captured graphs stay valid)."""
    for name, x in _named(params).items():
        leaf = sharded[name]
        if isinstance(leaf, Shards):
            n = leaf.mesh.shape[leaf.axis]
            for c, t in zip(leaf.mesh.coords(leaf.axis), leaf):
                t.copy_(tp_slice(x, leaf.dim, n, c, leaf.groups))
        else:
            for t in {id(t): t for t in leaf}.values():
                t.copy_(x)


def shard_fraction(sharded: Mapping[str, Any]) -> float:
    """Diagnostic: the first entry's bytes / the whole params' bytes, about
    1/tp of the big matrices plus the replicated smalls; proves the
    weights are distributed, not replicated."""
    total = local = 0
    for leaf in sharded.values():
        first = leaf[0] if isinstance(leaf, (Shards, Replicated)) else leaf
        local += first.nbytes
        total += first.nbytes * (leaf.mesh.shape[leaf.axis] if isinstance(leaf, Shards) else 1)
    return local / total


# ---- the tp layers -----------------------------------------------------------------


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _sum_onto(parts: list, device: torch.device) -> torch.Tensor:
    """Partial products summed onto ``device`` in shard order."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


class _RowDense(nn.Module):
    """A row-parallel slice of a ``vit.Dense``: this entry's input columns'
    product, in the layer's compute dtype, without the bias."""

    def __init__(self, weight: torch.Tensor, dtype: torch.dtype):
        super().__init__()
        self.weight = _param(weight)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt))


class _RowParallelGroup(nn.Module):
    """A column- then row-parallel block over a tp group: each entry's
    shard runs on the group's copy of the input, the partial products are
    summed onto the input's device in shard order, and the row-parallel
    product's bias is added once."""

    def forward(self, x):
        parts = [m(x.to(d)) for m, d in zip(self.shards, self.devices)]
        return _sum_onto(parts, x.device) + self.bias.to(self.dtype)


class TPAttention(_RowParallelGroup):
    """A ViT attention block over a tp group: entry s runs heads
    [s·H/tp, (s+1)·H/tp) through the block's ``attn_fn`` and its slice of
    ``proj``."""

    def __init__(self, attn: "vit_mod.Attention", devices: list, qkv_w: list, qkv_b: list,
                 proj_w: list, proj_b: torch.Tensor):
        super().__init__()
        tp = len(devices)
        if attn.num_heads % tp:
            raise ValueError(f"{attn.num_heads} heads do not split over tp={tp}")
        self.devices = devices
        self.dtype = attn.dtype
        self.shards = nn.ModuleList()
        for w, b, pw in zip(qkv_w, qkv_b, proj_w):
            with torch.device("meta"):
                local = vit_mod.Attention(attn.dim // tp, attn.num_heads // tp, attn.dtype,
                                          attn.attn_fn, attn.softmax_dtype)
            local.qkv.weight, local.qkv.bias = _param(w), _param(b)
            local.proj = _RowDense(pw, attn.dtype)
            self.shards.append(local)
        self.bias = _param(proj_b)


class TPMlp(_RowParallelGroup):
    """A ViT MLP over a tp group: entry s computes its hidden columns and
    its slice of ``Dense_1``."""

    def __init__(self, mlp: "vit_mod.MlpBlock", devices: list, w0: list, b0: list, w1: list,
                 b1: torch.Tensor):
        super().__init__()
        dt = mlp.Dense_0.compute_dtype
        self.devices = devices
        self.dtype = dt
        self.shards = nn.ModuleList()
        for w, b, w_down in zip(w0, b0, w1):
            with torch.device("meta"):
                local = vit_mod.MlpBlock(w.shape[0], w.shape[1], dt)
            local.Dense_0.weight, local.Dense_0.bias = _param(w), _param(b)
            local.Dense_1 = _RowDense(w_down, dt)
            self.shards.append(local)
        self.bias = _param(b1)


class TPConv(nn.Module):
    """A U-Net convolution over a tp group: entry s computes output
    channels [s·C/tp, (s+1)·C/tp) from the whole input; the channels are
    gathered on the first entry in shard order."""

    def __init__(self, conv: "unet_mod.Conv", devices: list, weights: list, biases: list):
        super().__init__()
        self.devices = devices
        self.shards = nn.ModuleList()
        for w, b in zip(weights, biases):
            with torch.device("meta"):
                local = unet_mod.Conv(w.shape[1], w.shape[0], conv.kernel, conv.dtype,
                                      use_bias=b is not None)
            local.weight = _param(w)
            if b is not None:
                local.bias = _param(b)
            self.shards.append(local)

    def forward(self, x):
        return torch.cat([m(x.to(d)).to(x.device) for m, d in zip(self.shards, self.devices)], dim=1)


_TP_TYPES = (vit_mod.Attention, vit_mod.MlpBlock, unet_mod.Conv)


def _tp_layer(sub: nn.Module, prefix: str, split: Mapping[str, Shards], entries: list, devices: list,
              sharded: Mapping[str, Any], home: int) -> Optional[nn.Module]:
    """The tp form of an attention block, an MLP or a convolution whose
    parameters the rules split; None where they split none of them."""
    mine = [prefix + n for n, _ in sub.named_parameters() if prefix + n in split]
    if not mine:
        return None

    def parts(name, want_dim):
        leaf = split.get(prefix + name)
        if leaf is None or leaf.dim != want_dim:
            raise ValueError(
                f"{mine}: the tp rules split a layout the port's {type(sub).__name__} "
                "does not run (column parallel, then row parallel)"
            )
        return [leaf[e] for e in entries]

    if isinstance(sub, vit_mod.Attention):
        return TPAttention(sub, devices, parts("qkv.weight", 0), parts("qkv.bias", 0),
                           parts("proj.weight", 1), sharded[prefix + "proj.bias"][home])
    if isinstance(sub, vit_mod.MlpBlock):
        return TPMlp(sub, devices, parts("Dense_0.weight", 0), parts("Dense_0.bias", 0),
                     parts("Dense_1.weight", 1), sharded[prefix + "Dense_1.bias"][home])
    biases = parts("bias", 0) if sub.bias is not None else [None] * len(entries)
    return TPConv(sub, devices, parts("weight", 0), biases)


def tp_groups(mesh: Mesh) -> list[list[int]]:
    """The mesh's tp groups, in mesh order (each entry alone where the mesh
    has no tp axis); a group's first entry is its home."""
    return mesh.groups("tp") if "tp" in mesh.axis_names else [[e] for e in range(mesh.size)]


def tp_group_modules(model: nn.Module, mesh: Mesh, sharded: Mapping[str, Any]) -> list[nn.Module]:
    """One copy of ``model`` per tp group (``tp_groups``), over
    ``shard_params``' tensors: the matched layers hold the group's slices,
    the rest the home entry's copies. Each takes its input on its home's
    device and returns its output there."""
    split = {n: leaf for n, leaf in sharded.items() if isinstance(leaf, Shards)}
    out = []
    for entries in tp_groups(mesh):
        home, devices = entries[0], [mesh.devices[e] for e in entries]
        module = copy.deepcopy(model)
        for prefix, sub in list(module.named_modules()):
            if not isinstance(sub, _TP_TYPES):
                continue
            layer = _tp_layer(sub, prefix + ".", split, entries, devices, sharded, home)
            if layer is not None:
                parent, _, leaf = prefix.rpartition(".")
                setattr(module.get_submodule(parent), leaf, layer)
        for name, _ in list(module.named_parameters()):
            if name in split:
                raise ValueError(f"{name}: split by the tp rules, but no tp layer holds it")
            if name in sharded:
                owner, _, leaf = name.rpartition(".")
                setattr(module.get_submodule(owner), leaf, _param(sharded[name][home]))
        for name, buf in list(module.named_buffers()):
            owner, _, leaf = name.rpartition(".")
            own = sharded[name][home] if name in sharded else buf.to(devices[0])
            module.get_submodule(owner)._buffers[leaf] = own
        out.append(module.eval())
    return out


def make_tp_apply(
    model: nn.Module,
    mesh: Mesh,
    params: Any = None,
    rules: Sequence[tuple] = VIT_TP_RULES,
    data_spec: Optional[P] = None,
    out_spec: Optional[P] = None,
) -> tuple[Callable, dict]:
    """``model``'s forward with Megatron-sharded weights over ``mesh``.

    ``params`` is a state dict (default: the model's own). ``data_spec``
    defaults to batch-sharding over ``dp`` when the mesh has that axis
    (replicated over ``tp``), else replicated: each tp group runs its part
    of the batch, and a replicated batch runs on the first group (every
    group would compute the same bits). Returns (apply_fn, sharded_params);
    ``apply_fn(params, x)`` gives the output on the mesh's first device, in
    batch order, and copies ``params`` in first when they are not the
    sharded params it was built over (a full state dict)."""
    if data_spec is None:
        data_spec = P("dp") if "dp" in mesh.axis_names else P()
    if out_spec is None:
        out_spec = data_spec
    if tuple(out_spec) != tuple(data_spec):
        raise ValueError(f"out_spec {out_spec} must equal data_spec {data_spec}: the output follows the batch")
    sharded, _ = shard_params(mesh, params if params is not None else model, rules)
    modules = tp_group_modules(model, mesh, sharded)
    batch_axis = data_spec[0] if len(data_spec) else None
    if any(a is not None for a in tuple(data_spec)[1:]) or batch_axis not in (None, "dp"):
        raise ValueError(f"data_spec {data_spec}: the batch splits over dp or not at all")

    homes = [mesh.devices[g[0]] for g in tp_groups(mesh)]

    def apply_fn(p, x):
        if p is not sharded:
            reshard_into(sharded, p)
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        with torch.no_grad():
            if batch_axis is None:
                return modules[0](x.to(homes[0]))
            outs = [m(part.to(h)) for m, part, h in zip(modules, x.chunk(len(modules)), homes)]
            return torch.cat([o.to(mesh.devices[0]) for o in outs])

    return apply_fn, sharded
