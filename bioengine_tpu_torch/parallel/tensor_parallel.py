"""Tensor parallelism: weight slices over the ``tp`` axis.

Counterpart of ``bioengine_tpu/parallel/tensor_parallel.py``. The JAX
module states the layout as ``PartitionSpec`` rules over the param tree
and lets GSPMD partition whatever they split. Here one process drives
each tp group and runs the layout by hand:

- the rules are the JAX regexes over the port's dotted parameter names,
  with specs in the port's layout (an ``nn.Linear`` weight is (out, in), a
  convolution's (cout, cin, *k), a transposed convolution's (cin, cout,
  *k)): each names the same logical dimension as the JAX rule names for
  the bridged parameter, and is used where its dimensions divide, JAX's
  ``_divisible``. A third element of a rule splits the dimension as that
  many equal groups, each group sliced alike: a fused qkv weight is split
  by heads;
- ``shard_params`` gives every mesh entry its slice of each split tensor
  of a module, as JAX places them, and each tp group one copy of each
  replicated tensor, on the group's home (first) entry: the group runs its
  whole layers there. It splits a ViT attention's ``qkv`` and ``proj`` at
  head boundaries: entry s holds heads [⌊s·H/tp⌋, ⌊(s+1)·H/tp⌋), so heads
  that do not divide by tp split unevenly, and an entry may hold none;
- ``tp_group_modules`` builds, per tp group, a copy of the model whose
  split layers run on the group:
  - a ViT attention split by heads runs each entry's heads through the
    model's ``attn_fn`` (the flash kernel on the card); with ``proj`` split
    on the same heads (the Megatron layout) each entry's partial product
    is summed onto the home in shard order and the bias added once, else
    the heads' outputs are gathered on the home and ``proj`` runs as its
    own split says;
  - a ViT MLP split on ``Dense_0``'s outputs and ``Dense_1``'s inputs
    alike keeps each entry's hidden columns on the entry, the partial
    products summed as above;
  - any other ``nn.Linear``, ``unet.Conv`` or ``unet.ConvTranspose`` split
    on its output features runs column parallel (each entry its outputs
    from the whole input, gathered on the home in order), on its input
    features row parallel (each entry its slice of the input, the partial
    products summed onto the home in shard order, the bias added once);
  - any other split tensor (a norm's scale, an embedding,
    ``patch_embed``, a layer-scale, or a split over another axis) is
    gathered onto the home each time the group's model runs.
  The layers left whole run once, on the home; each tp layer copies its
  input from there to the group, so every entry computes on the same
  bits.

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
from bioengine_tpu_torch.parallel.data_parallel import Blocks, Replicated, Shards, _split_dims, host_parts
from bioengine_tpu_torch.parallel.mesh import Mesh, PartitionSpec as P, Placement

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


def _divisible(spec: P, shape: tuple, mesh: Optional[Mesh]) -> bool:
    """A spec is usable only when every split dim divides by its mesh axis
    size (e.g. a 1-channel output conv can never split on tp), JAX's
    rule."""
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
        if dim >= len(shape) or shape[dim] % size != 0:
            return False
    return True


def _layout(params: Any, rules: Sequence[tuple], mesh: Optional[Mesh]) -> dict[str, tuple[P, int]]:
    out = {}
    for name, leaf in _named(params).items():
        spec, groups = _match(rules, name)
        if not _divisible(spec, tuple(leaf.shape), mesh):
            spec, groups = P(), 1
        out[name] = (spec, groups)
    return out


def tp_param_specs(params: Any, rules: Sequence[tuple], mesh: Optional[Mesh] = None) -> dict[str, P]:
    """Name -> ``PartitionSpec`` for ``params`` (a state dict or a module):
    the first rule whose regex matches the dotted name wins; unmatched
    params, and matched ones whose shapes don't divide by the mesh axis,
    are replicated (``P()``)."""
    return {name: spec for name, (spec, _) in _layout(params, rules, mesh).items()}


def _even(length: int, n: int) -> tuple:
    """The n + 1 offsets of ``n`` parts of ``length``, as even as they go."""
    return tuple(j * length // n for j in range(n + 1))


def tp_slice(x: torch.Tensor, dim: int, n: int, j: int, groups: int = 1,
             bounds: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Part ``j`` of ``n`` of ``x`` along ``dim``: with ``groups`` > 1 the
    dimension is that many equal groups, and the part is the j-th slice of
    each, concatenated (a fused qkv weight's heads); ``bounds`` are the
    n + 1 offsets within a group where the parts start (even by
    default)."""
    b = bounds or _even(x.shape[dim] // groups, n)
    if groups == 1:
        return x.narrow(dim, b[j], b[j + 1] - b[j])
    return torch.cat([g.narrow(dim, b[j], b[j + 1] - b[j]) for g in x.tensor_split(groups, dim)], dim)


def _head_bounds(model: nn.Module, over_tp: Mapping[str, tuple], mesh: Mesh) -> dict[str, tuple]:
    """Each ViT attention whose ``qkv`` is split by heads over ``tp``,
    regrouped at head boundaries: entry s holds heads [⌊s·H/tp⌋,
    ⌊(s+1)·H/tp⌋). Name -> bounds for its ``qkv`` weight and bias and
    ``proj``'s input columns, where they are split so. ``over_tp`` maps
    each tensor split over ``tp`` alone to its (dimension, groups)."""
    out = {}
    for prefix, sub in model.named_modules():
        if not isinstance(sub, vit_mod.Attention):
            continue
        pre = prefix + "." if prefix else ""
        if over_tp.get(pre + "qkv.weight") != (0, 3):
            continue
        n, hd = mesh.shape["tp"], sub.dim // sub.num_heads
        bounds = tuple(hd * (j * sub.num_heads // n) for j in range(n + 1))
        for name, split in (("qkv.weight", (0, 3)), ("qkv.bias", (0, 3)), ("proj.weight", (1, 1))):
            if over_tp.get(pre + name) == split:
                out[pre + name] = bounds
    return out


def shard_params(mesh: Mesh, model: nn.Module, rules: Sequence[tuple]) -> tuple[dict, dict]:
    """Place ``model``'s state onto the mesh per the rules: a split tensor
    as ``Shards`` (entry e holds the slice of its coordinate along the
    axis; a ViT attention's split by heads at head boundaries), or
    ``Blocks`` for a spec splitting several dimensions; a replicated one as
    ``Replicated``: one copy per tp group, on its home entry, which every
    entry of the group refers to. Returns (sharded, specs); a state dict
    is copied in afterwards with ``reshard_into``."""
    named = _named(model)
    layout = _layout(named, rules, mesh)
    splits = {name: _split_dims(mesh, tuple(spec)) for name, (spec, _) in layout.items()}
    bounds = _head_bounds(model, {name: (split[0][0], layout[name][1]) for name, split in splits.items()
                                  if [axis for _, axis in split] == ["tp"]}, mesh)
    home = {e: g[0] for g in tp_groups(mesh) for e in g}
    sharded = {}
    for name, x in named.items():
        spec, groups = layout[name]
        split = splits[name]
        if not split:
            copies = {h: x.to(mesh.devices[h], copy=True) for h in sorted(set(home.values()))}
            sharded[name] = Replicated([copies[home[e]] for e in range(mesh.size)], mesh)
        elif len(split) == 1 and not isinstance(split[0][1], tuple):
            (dim, axis), = split
            n = mesh.shape[axis]
            b = bounds.get(name) or _even(x.shape[dim] // groups, n)
            parts = [tp_slice(x, dim, n, j, groups, b).contiguous() for j in range(n)]
            sharded[name] = Shards(
                [parts[c].to(d, copy=True) for c, d in zip(mesh.coords(axis), mesh.devices)],
                mesh, axis, dim, groups, b,
            )
        else:  # several dimensions, or a tuple of axes: JAX's placement
            kind, parts = host_parts(Placement(mesh, tuple(spec)), x)
            sharded[name] = kind([p.to(d, copy=True) for p, d in zip(parts, mesh.devices)], mesh)
    return sharded, {name: spec for name, (spec, _) in layout.items()}


@torch.no_grad()
def reshard_into(sharded: Mapping[str, Any], params: Any) -> None:
    """Copy a full state dict into ``shard_params``'s tensors in place, by
    the same layout (addresses unchanged: captured graphs stay valid)."""
    for name, x in _named(params).items():
        leaf = sharded[name]
        if isinstance(leaf, Shards):
            n = leaf.mesh.axis_size(leaf.axis)
            for c, t in zip(leaf.mesh.coords(leaf.axis), leaf):
                t.copy_(tp_slice(x, leaf.dim, n, c, leaf.groups, leaf.bounds))
        elif isinstance(leaf, Blocks):
            _, parts = host_parts(Placement(leaf.mesh, leaf.spec), x)
            for t, part in zip(leaf, parts):
                t.copy_(part)
        else:
            for t in {id(t): t for t in leaf}.values():
                t.copy_(x)


def shard_fraction(sharded: Mapping[str, Any]) -> float:
    """Diagnostic: the first entry's bytes / the whole params' bytes, about
    1/tp of the big matrices plus the replicated smalls; proves the
    weights are distributed, not replicated."""
    total = local = 0
    for leaf in sharded.values():
        first = leaf[0] if isinstance(leaf, (Shards, Blocks, Replicated)) else leaf
        local += first.nbytes
        split = isinstance(leaf, (Shards, Blocks))
        total += sum(p.nbytes for p in leaf.parts()) if split else first.nbytes
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


class _Leaf:
    """One leaf of ``shard_params`` as a tp group reads it when its layer
    runs: the whole tensor on the group's home, or tp entry s's slice
    (the entry's own part where the leaf is split that way over tp)."""

    def __init__(self, leaf: Any, entries: list, home: torch.device):
        self.leaf, self.entries, self.home = leaf, entries, home

    def whole(self) -> torch.Tensor:
        if isinstance(self.leaf, Replicated):
            return self.leaf[self.entries[0]]
        return self.leaf.gather(self.home)

    def part(self, s: int, dim: int, groups: int, bounds: tuple) -> torch.Tensor:
        if self.leaf.over_tp(dim, groups, bounds):
            return self.leaf[self.entries[s]]
        return tp_slice(self.whole(), dim, len(bounds) - 1, s, groups, bounds)


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return t if t is None or dtype is None else t.to(dtype)


def _add_bias(y: torch.Tensor, bias: Optional[_Leaf], dtype) -> torch.Tensor:
    """A row-parallel Dense's bias, added once to the summed partials."""
    return y if bias is None else y + bias.whole().to(dtype)


class _Product(nn.Module):
    """The product of a ``nn.Linear`` (a ``vit.Dense`` in its compute
    dtype), a ``unet.Conv`` or a ``unet.ConvTranspose`` over a given
    weight and bias, in the layer's own arithmetic; ``feature`` is the
    dimension of its input and output features."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        if isinstance(layer, unet_mod.Conv):
            conv = unet_mod._CONV[len(layer.kernel)]
            self.fn = lambda x, w, b: _conv_bias(conv(x, w, padding=layer.padding), b)
        elif isinstance(layer, unet_mod.ConvTranspose):
            conv_t = unet_mod._CONV_T[len(layer.kernel)]
            self.fn = lambda x, w, b: _conv_bias(conv_t(x, w, stride=layer.kernel), b)
        else:
            self.fn = F.linear
        self.feature = -1 if isinstance(layer, nn.Linear) else 1
        self.dtype = getattr(layer, "compute_dtype", getattr(layer, "dtype", None))
        if not isinstance(self.dtype, torch.dtype):
            self.dtype = None

    def forward(self, x, w, b=None):
        dt = self.dtype
        return self.fn(_cast(x, dt), _cast(w, dt), _cast(b, dt))


def _conv_bias(y: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """A U-Net convolution's bias, added after the product is rounded."""
    return y if b is None else y + b.view(-1, *([1] * (y.dim() - 2)))


class _Part(nn.Module):
    """Entry s's product of a split layer: its weight part and, given a
    bias leaf, the entry's slice of the bias (by ``bounds`` and
    ``groups``, as the weight's output rows are), through ``_Product``."""

    def __init__(self, layer: nn.Module, weight: torch.Tensor, s: int, bounds: tuple, groups: int = 1,
                 bias: Optional[_Leaf] = None):
        super().__init__()
        self.product, self.weight = _Product(layer), _param(weight)
        self.s, self.bounds, self.groups, self.bias = s, bounds, groups, bias

    def forward(self, x):
        b = None if self.bias is None else self.bias.part(self.s, 0, self.groups, self.bounds).to(x.device)
        return self.product(x, self.weight, b)


# (output, input) dimension of each kind of split layer's weight
_DIMS = {nn.Linear: (0, 1), unet_mod.Conv: (0, 1), unet_mod.ConvTranspose: (1, 0)}


def _dims(layer: nn.Module) -> Optional[tuple]:
    return next((d for kind, d in _DIMS.items() if isinstance(layer, kind)), None)


class TPSplitLayer(nn.Module):
    """A ``nn.Linear``, ``unet.Conv`` or ``unet.ConvTranspose`` over a tp
    group, split on its output features (column parallel: entry s computes
    its outputs from the whole input, gathered on the home in order) or on
    its input features (row parallel: entry s takes its slice of the
    input, and the partial products are summed onto the home in shard
    order). The bias is the entries' own where it is split alike, else
    added once, on the home."""

    def __init__(self, layer: nn.Module, devices: list, weight: Shards, entries: list,
                 bias: Optional[_Leaf], column: bool):
        super().__init__()
        self.devices, self.column = devices, column
        self.dim, self.groups, self.bounds = weight.dim, weight.groups, tuple(weight.bounds)
        self.bias = bias
        self.bias_split = column and bias is not None and bias.leaf.over_tp(0, self.groups, self.bounds)
        own = bias if self.bias_split else None
        self.parts = nn.ModuleList(_Part(layer, weight[e], s, self.bounds, self.groups, own)
                                   for s, e in enumerate(entries))

    def forward(self, x):
        feature, groups, bounds = self.parts[0].product.feature, self.groups, self.bounds
        outs = []
        for s, (part, d) in enumerate(zip(self.parts, self.devices)):
            if part.weight.shape[self.dim] == 0:
                continue  # an entry with no part adds nothing
            xs = x if self.column else tp_slice(x, feature, len(bounds) - 1, s, groups, bounds)
            outs.append(part(xs.to(d)))
        if self.column:
            pieces = [o.to(x.device).tensor_split(groups, feature) for o in outs]
            y = torch.cat([p[g] for g in range(groups) for p in pieces], feature)
        else:
            y = _sum_onto(outs, x.device)
        if self.bias is None or self.bias_split:
            return y
        b = _cast(self.bias.whole(), self.parts[0].product.dtype)
        return y + (b if feature == -1 else b.view(-1, *([1] * (y.dim() - 2))))


class TPAttention(nn.Module):
    """A ViT attention block over a tp group, split by heads: entry s runs
    its heads (``bounds``, head-aligned) through the block's ``attn_fn``.
    With ``proj`` split on the same heads, entry s takes its slice of
    ``proj`` and the partial products are summed onto the home in shard
    order, the bias added once; else the heads' outputs are gathered on
    the home in head order and ``proj`` (whole, or a ``TPSplitLayer``)
    runs on them. An entry with no heads adds nothing."""

    def __init__(self, attn: "vit_mod.Attention", devices: list, entries: list, qkv_w: Shards,
                 qkv_b: _Leaf, proj_w: Optional[Shards], proj_b: Optional[_Leaf], proj: nn.Module):
        super().__init__()
        hd = attn.dim // attn.num_heads
        self.devices, self.dtype = devices, attn.dtype
        self.bounds = tuple(qkv_w.bounds)
        self.row = proj_w is not None
        self.heads = nn.ModuleList()
        for s, e in enumerate(entries):
            width = self.bounds[s + 1] - self.bounds[s]
            with torch.device("meta"):
                local = vit_mod.Attention(max(width, hd), max(width // hd, 1), attn.dtype,
                                          attn.attn_fn, attn.softmax_dtype)
            local.dim, local.num_heads = width, width // hd
            local.qkv = _Part(attn.qkv, qkv_w[e], s, self.bounds, qkv_w.groups, qkv_b)
            local.proj = _Part(attn.proj, proj_w[e], s, self.bounds) if self.row else nn.Identity()
            self.heads.append(local)
        self.proj_b = proj_b
        self.proj = None if self.row else proj

    def forward(self, x):
        outs = [m(x.to(d)) for m, d in zip(self.heads, self.devices) if m.dim > 0]
        if self.row:
            return _add_bias(_sum_onto(outs, x.device), self.proj_b, self.dtype)
        return self.proj(torch.cat([o.to(x.device) for o in outs], -1))


class TPMlp(nn.Module):
    """A ViT MLP over a tp group, ``Dense_0`` split on its outputs and
    ``Dense_1`` on its inputs by the same bounds: entry s computes its
    hidden columns and its slice of ``Dense_1``, summed onto the home in
    shard order, the bias added once."""

    def __init__(self, mlp: "vit_mod.MlpBlock", devices: list, entries: list, w0: Shards, b0: _Leaf,
                 w1: Shards, b1: _Leaf):
        super().__init__()
        self.devices, self.dtype = devices, mlp.Dense_0.compute_dtype
        bounds = tuple(w0.bounds)
        self.up = nn.ModuleList(_Part(mlp.Dense_0, w0[e], s, bounds, 1, b0) for s, e in enumerate(entries))
        self.down = nn.ModuleList(_Part(mlp.Dense_1, w1[e], s, bounds) for s, e in enumerate(entries))
        self.b1 = b1

    def forward(self, x):
        outs = [down(F.gelu(up(x.to(d)), approximate="tanh"))
                for up, down, d in zip(self.up, self.down, self.devices) if up.weight.shape[0]]
        return _add_bias(_sum_onto(outs, x.device), self.b1, self.dtype)


def _tp_split(sharded: Mapping[str, Any], name: str, dim: int, groups: Optional[int] = None,
              bounds: Optional[tuple] = None) -> Optional[Shards]:
    """The leaf ``name`` where it is split over tp alone on ``dim`` (in
    ``groups`` groups and at ``bounds``, where given)."""
    leaf = sharded.get(name)
    return leaf if leaf is not None and leaf.over_tp(dim, groups, bounds) else None


def _tp_layer(sub: nn.Module, pre: str, sharded: Mapping[str, Any], entries: list, devices: list,
              build: Callable) -> Optional[nn.Module]:
    """The tp form of ``sub`` (at ``pre``) where the rules split it in a
    layout a tp layer runs; None where they do not (its split tensors, if
    any, are then gathered each time the group's model runs). A ViT
    attention's ``qkv`` split by heads at other than head boundaries
    (``shard_params`` never splits it so) raises."""
    leaf = lambda name: _Leaf(sharded[pre + name], entries, devices[0]) if pre + name in sharded else None  # noqa: E731
    if isinstance(sub, vit_mod.Attention):
        qkv = _tp_split(sharded, pre + "qkv.weight", 0, 3)
        if qkv is None:
            return None
        hd = sub.dim // sub.num_heads
        if any(b % hd for b in qkv.bounds):
            raise ValueError(f"{pre}qkv.weight is split over tp at {tuple(qkv.bounds)}, not at the head "
                             f"boundaries of heads {hd} wide: place it with shard_params")
        proj = _tp_split(sharded, pre + "proj.weight", 1, 1, qkv.bounds)
        return TPAttention(sub, devices, entries, qkv, leaf("qkv.bias"), proj, leaf("proj.bias"),
                           build(sub.proj, pre + "proj.") if proj is None else None)
    if isinstance(sub, vit_mod.MlpBlock):
        w0 = _tp_split(sharded, pre + "Dense_0.weight", 0, 1)
        w1 = None if w0 is None else _tp_split(sharded, pre + "Dense_1.weight", 1, 1, w0.bounds)
        if w1 is None:
            return None
        return TPMlp(sub, devices, entries, w0, leaf("Dense_0.bias"), w1, leaf("Dense_1.bias"))
    dims = _dims(sub)
    if dims is None:
        return None
    out_dim, in_dim = dims
    weight = _tp_split(sharded, pre + "weight", out_dim) or _tp_split(sharded, pre + "weight", in_dim)
    if weight is None:
        return None
    return TPSplitLayer(sub, devices, weight, entries, leaf("bias"), column=weight.dim == out_dim)


def _gather_on_call(module: nn.Module, gathered: list, device: torch.device) -> None:
    """Each ``(owner, name, leaf)`` of ``gathered``: ``owner.<name>`` becomes
    the whole of a split leaf, gathered onto ``device`` each time
    ``module`` (the group's model, which may read it without calling
    ``owner``) runs."""
    def gather(*_):
        for owner, name, leaf in gathered:
            setattr(owner, name, leaf.gather(device))

    for owner, name, _ in gathered:
        owner._parameters.pop(name, None)
        owner._buffers.pop(name, None)
    gather()
    module.register_forward_pre_hook(gather)


def tp_groups(mesh: Mesh) -> list[list[int]]:
    """The mesh's tp groups, in mesh order (each entry alone where the mesh
    has no tp axis); a group's first entry is its home."""
    return mesh.groups("tp") if "tp" in mesh.axis_names else [[e] for e in range(mesh.size)]


def tp_group_modules(model: nn.Module, mesh: Mesh, sharded: Mapping[str, Any]) -> list[nn.Module]:
    """One copy of ``model`` per tp group (``tp_groups``), over
    ``shard_params``' tensors: the layers the rules split hold the group's
    slices, the rest the home entry's copies, and any other split tensor
    is gathered onto the home each time the copy runs. Each copy takes its
    input on its home's device and returns its output there."""
    out = []
    for entries in tp_groups(mesh):
        home, devices = entries[0], [mesh.devices[e] for e in entries]
        module = copy.deepcopy(model)

        def build(sub, pre):
            return _tp_layer(sub, pre, sharded, entries, devices, build) or sub

        replaced: list[str] = []
        for prefix, sub in list(module.named_modules()):
            if any(prefix.startswith(r) for r in replaced):
                continue  # inside a layer already replaced
            pre = prefix + "." if prefix else ""
            layer = _tp_layer(sub, pre, sharded, entries, devices, build)
            if layer is None:
                continue
            if not prefix:
                module = layer
                break
            parent, _, leaf = prefix.rpartition(".")
            setattr(module.get_submodule(parent), leaf, layer)
            replaced.append(pre)
        gathered = []
        for name, _ in list(module.named_parameters()):
            if name not in sharded:
                continue  # a tp layer's own slices
            owner, _, leaf = name.rpartition(".")
            if isinstance(sharded[name], Replicated):
                setattr(module.get_submodule(owner), leaf, _param(sharded[name][home]))
            else:
                gathered.append((module.get_submodule(owner), leaf, sharded[name]))
        for name, buf in list(module.named_buffers()):
            owner, _, leaf = name.rpartition(".")
            if isinstance(sharded.get(name), (Shards, Blocks)):
                gathered.append((module.get_submodule(owner), leaf, sharded[name]))
                continue
            own = sharded[name][home] if name in sharded else buf.to(devices[0])
            module.get_submodule(owner)._buffers[leaf] = own
        if gathered:
            _gather_on_call(module, gathered, devices[0])
        out.append(module.eval())
    return out


def _batch_rows(mesh: Mesh, groups: list, spec: tuple, batch: int) -> list[torch.Tensor]:
    """The batch rows each tp group runs under ``spec``: the parts its
    entries hold along the batch, in order; a batch replicated is run by
    the first group only (every group would compute the same bits)."""
    axis = spec[0] if spec else None
    if axis in (None, ()):
        return [torch.arange(batch)] + [torch.arange(0)] * (len(groups) - 1)
    n = mesh.axis_size(axis)
    coords, size = mesh.coords(axis), batch // n
    return [torch.cat([torch.arange(c * size, (c + 1) * size) for c in sorted({coords[e] for e in g})])
            for g in groups]


def make_tp_apply(
    model: nn.Module,
    mesh: Mesh,
    params: Any = None,
    rules: Sequence[tuple] = VIT_TP_RULES,
    data_spec: Optional[P] = None,
    out_spec: Optional[P] = None,
) -> tuple[Callable, dict]:
    """``model``'s forward with tensor-parallel weights over ``mesh``.

    ``params`` is a state dict (default: the model's own), placed by the
    layout the rules give the model. ``data_spec`` defaults to
    batch-sharding over ``dp`` when the mesh has that axis (replicated
    over ``tp``), else replicated; any spec JAX takes is taken: each tp
    group runs the batch rows its entries hold (all of them for a batch
    split over ``tp``, the first group all for a replicated one), and a
    split of another dimension is run whole. ``out_spec`` may differ.
    Returns (apply_fn, sharded_params); ``apply_fn(params, x)`` gives the
    whole output on the mesh's first device, in batch order, and copies
    ``params`` in first when they are not the sharded params it was built
    over (a full state dict)."""
    if data_spec is None:
        data_spec = P("dp") if "dp" in mesh.axis_names else P()
    if out_spec is None:
        out_spec = data_spec
    data_spec, out_spec = tuple(data_spec), tuple(out_spec)
    _split_dims(mesh, out_spec)
    sharded, _ = shard_params(mesh, model, rules)
    if params is not None:
        reshard_into(sharded, params)
    modules = tp_group_modules(model, mesh, sharded)
    homes = [mesh.devices[g[0]] for g in tp_groups(mesh)]

    def apply_fn(p, x):
        if p is not sharded:
            reshard_into(sharded, p)
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        host_parts(Placement(mesh, data_spec), x)  # JAX's checks: axes, divisibility
        rows = _batch_rows(mesh, tp_groups(mesh), data_spec, x.shape[0])
        with torch.no_grad():
            outs = [m(x[r].to(h)) for m, r, h in zip(modules, rows, homes) if len(r)]
            y = torch.cat([o.to(mesh.devices[0]) for o in outs])
            order = torch.cat([r for r in rows if len(r)])
            if torch.equal(order, torch.arange(len(order))):
                return y
            return torch.empty_like(y).index_copy_(0, order.to(y.device), y)

    return apply_fn, sharded
