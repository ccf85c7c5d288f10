"""The rest of the port's parallel layer against the JAX package's on the CPU:
tensor parallelism (``parallel/tensor_parallel.py`` and the engine's tp
path), spatial halo exchange (``parallel/spatial.py``), ring attention
(``parallel/ring.py``), the sharded FlatIP index (``ops/knn.py``
``ShardedKnnIndex``) and placement over meshes of several axes.

JAX runs on the 8 forced host devices of ``tests/conftest.py``; the port's
CPU mesh of width N is N entries of ``cpu``, one process driving them.
Each case mirrors a JAX test (``tests/test_parallel.py`` ``TestSpatial``,
``TestRingAttention`` and ``TestTensorParallel``;
``tests/test_sharded_engine.py`` ``TestTensorParallel``;
``tests/test_cell_image_search.py``'s sharded index) on the same inputs and
bridged weights, with its tolerances. The configurations JAX runs and the
port refused until slice 18 (head counts that do not divide by tp, rules
on any layout, any ``make_tp_apply`` specs, a dimension split over a tuple
of axes, several split dimensions) are held against JAX's results on
seeded weights at rtol and atol 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as jnn
from jax.sharding import NamedSharding, PartitionSpec as JP

from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu.models.unet import UNet2D as JaxUNet2D
from bioengine_tpu.models.vit import ViT as JaxViT
from bioengine_tpu.ops import knn as jax_knn
from bioengine_tpu.parallel import data_parallel as jax_dp
from bioengine_tpu.parallel import mesh as jax_mesh
from bioengine_tpu.parallel import ring as jax_ring
from bioengine_tpu.parallel import spatial as jax_spatial
from bioengine_tpu.parallel import tensor_parallel as jax_tp
from bioengine_tpu.runtime.engine import InferenceEngine as JaxEngine
from bioengine_tpu.runtime.program_cache import CompiledProgramCache as JaxCache
from bioengine_tpu_torch.models.unet import UNet2D
from bioengine_tpu_torch.models.vit import ViT
from bioengine_tpu_torch.ops import knn
from bioengine_tpu_torch.parallel import data_parallel as dp
from bioengine_tpu_torch.parallel import make_mesh, ring, spatial
from bioengine_tpu_torch.parallel import tensor_parallel as tp
from bioengine_tpu_torch.parallel.mesh import PartitionSpec as P
from bioengine_tpu_torch.runtime import convert
from bioengine_tpu_torch.runtime.engine import InferenceEngine
from bioengine_tpu_torch.runtime.program_cache import CompiledProgramCache


def cpu_mesh(axes: dict) -> "dp.Mesh":
    n = int(np.prod(list(axes.values())))
    return make_mesh(axes, ["cpu"] * n)


def jax_mesh_of(axes: dict):
    n = int(np.prod(list(axes.values())))
    return jax_mesh.make_mesh(axes, jax.devices()[:n])


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


# ---- spatial: TestSpatial ---------------------------------------------------------

def _flax_conv(features, kernel, x, seed=0):
    conv = jnn.Conv(features, kernel, padding="SAME", dtype=jnp.float32)
    return conv, conv.init(jax.random.key(seed), x)


def _port_conv_apply(params_list):
    """A port stack of f32 convolutions (+ SiLU between them when more
    than one), bridged from flax kernels, taking channels-last input."""
    silu = len(params_list) > 1

    def apply_fn(_, x):
        ndim = x.dim() - 2
        y = x.movedim(-1, 1)
        for p in params_list:
            w = _t(p["kernel"]).permute(ndim + 1, ndim, *range(ndim))
            conv = F.conv2d if ndim == 2 else F.conv3d
            y = conv(y, w, _t(p["bias"]), padding=tuple(k // 2 for k in w.shape[2:]))
            if silu:
                y = F.silu(y)
        return y.movedim(1, -1)

    return apply_fn


@pytest.mark.parametrize("shape, kernel, halo, rank, feats", [
    ((1, 64, 32, 3), (5, 5), 2, 4, 4),
    ((1, 32, 12, 10, 2), (3, 3, 3), 1, 5, 2),
], ids=["halo_conv", "volume_depth_sharded_conv"])
def test_spatial_conv_matches_jax_and_unsharded(shape, kernel, halo, rank, feats):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    conv, params = _flax_conv(feats, kernel, jnp.asarray(x))
    jm = jax_mesh_of({"sp": 8})
    ref = np.asarray(jax_spatial.spatial_shard_apply(lambda p, v: conv.apply(p, v), jm, halo=halo, rank=rank)(
        params, jax_spatial.shard_image(jm, jnp.asarray(x))))
    apply_fn = _port_conv_apply([jax.tree.map(np.asarray, params["params"])])
    m = cpu_mesh({"sp": 8})
    out = spatial.spatial_shard_apply(apply_fn, m, halo=halo, rank=rank)(None, spatial.shard_image(m, x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), apply_fn(None, torch.from_numpy(x)).numpy(), rtol=1e-5, atol=1e-5)


def test_volume_multilayer_conv_stack_interior_exact():
    class Stack(jnn.Module):
        @jnn.compact
        def __call__(self, x):
            for feats in (2, 4, 1):
                x = jnn.silu(jnn.Conv(feats, (3, 3, 3), padding="SAME", dtype=jnp.float32)(x))
            return x

    model = Stack()
    x = np.random.default_rng(1).normal(size=(1, 32, 16, 16, 1)).astype(np.float32)
    params = model.init(jax.random.key(0), jnp.asarray(x))
    r = 3
    jm = jax_mesh_of({"sp": 8})
    jax_out = np.asarray(jax_spatial.spatial_shard_apply(lambda p, v: model.apply(p, v), jm, halo=r, rank=5)(
        params, jax_spatial.shard_image(jm, jnp.asarray(x))))
    layers = [jax.tree.map(np.asarray, params["params"][f"Conv_{i}"]) for i in range(3)]
    apply_fn = _port_conv_apply(layers)
    m = cpu_mesh({"sp": 8})
    out = spatial.spatial_shard_apply(apply_fn, m, halo=r, rank=5)(None, x).numpy()
    ref = apply_fn(None, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out[:, r:-r], ref[:, r:-r], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, jax_out, rtol=1e-4, atol=1e-4)


def test_halo_exceeding_shard_extent_and_rank_mismatch_raise_as_jax():
    x = np.zeros((1, 32, 8, 8, 1), np.float32)  # local depth 4
    jm, m = jax_mesh_of({"sp": 8}), cpu_mesh({"sp": 8})
    msgs = []
    for fn, mesh_, place in ((jax_spatial.spatial_shard_apply, jm, jax_spatial.shard_image),
                             (spatial.spatial_shard_apply, m, spatial.shard_image)):
        with pytest.raises(ValueError, match="exceeds the local shard") as e1:
            fn(lambda p, v: v, mesh_, halo=6, rank=5)({}, place(mesh_, x))
        with pytest.raises(ValueError, match="rank=4") as e2:
            fn(lambda p, v: v, mesh_, halo=1, rank=5)({}, np.zeros((1, 32, 8, 1), np.float32))
        msgs.append((str(e1.value), str(e2.value)))
    assert msgs[0] == msgs[1]


def test_insufficient_halo_differs():
    x = np.random.default_rng(1).normal(size=(1, 64, 16, 1)).astype(np.float32)
    conv, params = _flax_conv(2, (5, 5), jnp.asarray(x))
    apply_fn = _port_conv_apply([jax.tree.map(np.asarray, params["params"])])
    m = cpu_mesh({"sp": 8})
    out = spatial.spatial_shard_apply(apply_fn, m, halo=0)(None, x).numpy()
    ref = apply_fn(None, torch.from_numpy(x)).numpy()
    assert not np.allclose(out, ref, atol=1e-5)
    jm = jax_mesh_of({"sp": 8})
    jax_out = np.asarray(jax_spatial.spatial_shard_apply(lambda p, v: conv.apply(p, v), jm, halo=0)(
        params, jax_spatial.shard_image(jm, jnp.asarray(x))))
    np.testing.assert_allclose(out, jax_out, rtol=1e-5, atol=1e-5)


def test_halo_exchange_on_a_dp_sp_mesh():
    """Each ring along sp exchanges within itself: the (dp 2, sp 4)
    placement holds JAX's blocks, and the result equals the sp = 4 one."""
    x = np.random.default_rng(4).normal(size=(1, 32, 8, 2)).astype(np.float32)
    conv, params = _flax_conv(2, (3, 3), jnp.asarray(x))
    apply_fn = _port_conv_apply([jax.tree.map(np.asarray, params["params"])])
    m = cpu_mesh({"dp": 2, "sp": 4})
    blocks = spatial.shard_image(m, x)
    jblocks = jax.device_put(jnp.asarray(x), NamedSharding(jax_mesh_of({"dp": 2, "sp": 4}), JP(None, "sp")))
    for ours, js in zip(blocks, sorted(jblocks.addressable_shards, key=lambda s: s.device.id)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(js.data))
    out = spatial.spatial_shard_apply(apply_fn, m, halo=1)(None, blocks).numpy()
    ref = spatial.spatial_shard_apply(apply_fn, cpu_mesh({"sp": 4}), halo=1)(None, x).numpy()
    np.testing.assert_array_equal(out, ref)


# ---- ring attention: TestRingAttention --------------------------------------------

def test_ring_matches_reference_and_jax():
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 4, 64, 16)).astype(np.float32) for _ in range(3))
    out = ring.make_ring_attention(cpu_mesh({"sp": 8}))(*map(torch.from_numpy, (q, k, v))).numpy()
    ref = ring.reference_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    jax_out = np.asarray(jax_ring.make_ring_attention(jax_mesh_of({"sp": 8}))(q, k, v))
    np.testing.assert_allclose(out, jax_out, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ref, np.asarray(jax_ring.reference_attention(q, k, v)), rtol=1e-4, atol=1e-5)


def test_ring_bf16_inputs():
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(1, 2, 32, 8)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out = ring.make_ring_attention(cpu_mesh({"sp": 8}))(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    ref = ring.reference_attention(tq, tk, tv)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(), rtol=5e-2, atol=5e-2)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jax_out = np.asarray(jax_ring.make_ring_attention(jax_mesh_of({"sp": 8}))(jq, jk, jv), np.float32)
    np.testing.assert_allclose(out.float().numpy(), jax_out, rtol=5e-2, atol=5e-2)


def test_vit_with_ring_attention_matches_jax_dense():
    """98x126 would need a non-square ViT; the port's ViT is square, so
    56x56 with patch 8: 7x7 = 49 patches + cls = 50 tokens, 2-way sp."""
    x = np.random.default_rng(3).normal(size=(1, 56, 56, 3)).astype(np.float32)
    cfg = dict(patch_size=8, dim=32, depth=1, num_heads=2)
    dense = JaxViT(**cfg, dtype=jnp.float32)
    params = dense.init(jax.random.key(0), jnp.asarray(x))["params"]
    ref = np.asarray(dense.apply({"params": params}, jnp.asarray(x)))
    ours = ViT(**cfg, dtype=torch.float32, img_size=56, attn_fn=ring.make_ring_attention(cpu_mesh({"sp": 2})))
    ours.load_state_dict(convert.state_dict_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        out = ours(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="do not split"):
        ring.make_ring_attention(cpu_mesh({"sp": 4}))(*[torch.zeros(1, 1, 50, 8)] * 3)


# ---- tensor parallelism: TestTensorParallel -----------------------------------------

def _tiny_vit():
    cfg = dict(patch_size=8, dim=64, depth=2, num_heads=4)
    jax_model = JaxViT(**cfg, dtype=jnp.float32, softmax_dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=(8, 32, 32, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, jax_model.init(jax.random.key(0), jnp.asarray(x[:1]))["params"])
    model = ViT(**cfg, dtype=torch.float32, softmax_dtype=torch.float32, img_size=32)
    model.load_state_dict(convert.state_dict_from_flax(params))
    return jax_model, params, model.eval(), x


def test_vit_tp_matches_single_device():
    jax_model, params, model, x = _tiny_vit()
    expected = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    apply_fn, sharded = tp.make_tp_apply(model, cpu_mesh({"tp": 4}), None, tp.VIT_TP_RULES)
    out = apply_fn(sharded, x).numpy()
    np.testing.assert_allclose(out, expected, rtol=2e-4, atol=2e-4)
    # another state dict copied in before the call, as JAX's functional apply
    other = {k: v * 1.01 for k, v in model.state_dict().items()}
    model2 = ViT(patch_size=8, dim=64, depth=2, num_heads=4, dtype=torch.float32,
                 softmax_dtype=torch.float32, img_size=32)
    model2.load_state_dict(other)
    with torch.no_grad():
        np.testing.assert_allclose(apply_fn(other, x).numpy(), model2.eval()(torch.from_numpy(x)).numpy(),
                                   rtol=2e-4, atol=2e-4)


def _bridged_spec(name_parts, spec, rank):
    """A JAX spec of a flax leaf in the port's layout: the bridge's
    transposition applied to the spec padded to the leaf's rank."""
    full = tuple(spec) + (None,) * (rank - len(spec))
    if name_parts[-1] == "kernel" and rank >= 2:
        perm = [rank - 1, rank - 2, *range(rank - 2)]
        full = tuple(full[i] for i in perm)
    return full


def _padded(spec, rank):
    return tuple(spec) + (None,) * (rank - len(spec))


@pytest.mark.parametrize("which", ["vit", "unet"])
def test_tp_param_specs_equal_jax_through_the_bridge(which):
    if which == "vit":
        _, params, model, _ = _tiny_vit()
        rules, jrules = tp.VIT_TP_RULES, jax_tp.VIT_TP_RULES
    else:
        # the specs depend on the shapes only
        jax_model = JaxUNet2D(features=(8, 16), out_channels=1, dtype=jnp.float32)
        shapes = jax.eval_shape(jax_model.init, jax.random.key(0), jnp.zeros((1, 32, 32, 1)))["params"]
        params = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
        model = UNet2D(features=(8, 16), out_channels=1, in_channels=1, dtype=torch.float32)
        rules, jrules = tp.CONV_TP_RULES, jax_tp.CONV_TP_RULES
    for m, jm in ((None, None), (cpu_mesh({"tp": 4}), jax_mesh_of({"tp": 4}))):
        ours = tp.tp_param_specs(model, rules, m)
        flat = convert.flatten_params(params)
        jspecs = jax_tp.tp_param_specs(params, jrules, jm)
        theirs = {}
        for key, arr in flat.items():
            path = key.split("/")
            spec = jspecs
            for p in path:
                spec = spec[p]
            name = ".".join(path[:-1] + ["weight" if path[-1] in ("kernel", "scale") else path[-1]])
            theirs[name] = _bridged_spec(path, spec, arr.ndim)
        state = model.state_dict()
        assert set(ours) == set(theirs)
        for name, spec in ours.items():
            assert _padded(spec, state[name].dim()) == theirs[name], name


def test_weights_actually_sharded():
    _, params, model, _ = _tiny_vit()
    specs = tp.tp_param_specs(model, tp.VIT_TP_RULES)
    assert specs["block0.attn.qkv.weight"] == P("tp", None)
    assert specs["block0.mlp.Dense_1.weight"] == P(None, "tp")
    assert specs["norm.weight"] == P()
    m = cpu_mesh({"tp": 4})
    sharded, _ = tp.shard_params(m, model, tp.VIT_TP_RULES)
    jsharded, _ = jax_tp.shard_params(jax_mesh_of({"tp": 4}), params, jax_tp.VIT_TP_RULES)
    qkv = sharded["block0.attn.qkv.weight"]
    # JAX's (64, 48) kernel shard, in the port's (out, in) layout
    assert jsharded["block0"]["attn"]["qkv"]["kernel"].addressable_shards[0].data.shape == (64, 48)
    assert tuple(qkv[0].shape) == (48, 64)
    # entry s holds the q, k and v rows of heads [s, s + 1) (16 rows each)
    full = model.state_dict()["block0.attn.qkv.weight"]
    for s in range(4):
        want = torch.cat([full[g * 64 + s * 16 : g * 64 + (s + 1) * 16] for g in range(3)])
        assert torch.equal(qkv[s], want)
    assert torch.equal(qkv.gather(), full)
    assert tp.shard_fraction(sharded) < 0.55
    assert tp.shard_fraction(sharded) == pytest.approx(jax_tp.shard_fraction(jsharded))


def test_dp_tp_combined():
    jax_model, params, model, x = _tiny_vit()
    expected = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    m = cpu_mesh({"dp": 2, "tp": 4})
    apply_fn, sharded = tp.make_tp_apply(model, m)
    out = apply_fn(sharded, x).numpy()
    np.testing.assert_allclose(out, expected, rtol=2e-4, atol=2e-4)
    jax_fn, jsharded = jax_tp.make_tp_apply(jax_model, jax_mesh_of({"dp": 2, "tp": 4}), params)
    np.testing.assert_allclose(out, np.asarray(jax_fn(jsharded, jnp.asarray(x))), rtol=2e-4, atol=2e-4)


def test_replicated_leaves_live_once_per_tp_group():
    _, _, model, _ = _tiny_vit()
    model.register_buffer("calib", torch.ones(3))
    m = cpu_mesh({"dp": 2, "tp": 4})
    sharded, _ = tp.shard_params(m, model, tp.VIT_TP_RULES)
    norm = sharded["norm.weight"]
    # one copy per tp group, on its home entry; split leaves keep a part per entry
    assert all(norm[e] is norm[0] for e in range(4)) and all(norm[e] is norm[4] for e in range(4, 8))
    assert norm[0] is not norm[4] and torch.equal(norm[0], norm[4])
    qkv = sharded["block0.attn.qkv.weight"]
    assert len({id(t) for t in qkv}) == 8
    modules = tp.tp_group_modules(model, m, sharded)
    for module, home in zip(modules, (0, 4)):
        assert module.norm.weight.data_ptr() == sharded["norm.weight"][home].data_ptr()
        assert module.calib is sharded["calib"][home]
    # a state dict copied in reaches every group's parameters and buffers
    state = {k: v + 1 for k, v in model.state_dict().items()}
    tp.reshard_into(sharded, state)
    for module in modules:
        assert torch.equal(module.norm.weight, state["norm.weight"])
        assert torch.equal(module.calib, state["calib"])


def _seeded_vit(num_heads: int, dim: int, depth: int = 2, seed: int = 0, img: int = 32):
    """A flax ViT and the port's, with the same seeded f32 weights (biases,
    norms and tables drawn too), and 8 images of ``img``^2."""
    cfg = dict(patch_size=8, dim=dim, depth=depth, num_heads=num_heads)
    jax_model = JaxViT(**cfg, dtype=jnp.float32, softmax_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, seeded_flax_params(jax_model, (1, img, img, 3), seed))
    model = ViT(**cfg, dtype=torch.float32, softmax_dtype=torch.float32, img_size=img)
    model.load_state_dict(convert.state_dict_from_flax(params))
    x = np.random.default_rng(seed + 1).normal(size=(8, img, img, 3)).astype(np.float32)
    return jax_model, params, model.eval(), x


def _single(model, x) -> np.ndarray:
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def test_heads_that_do_not_split_over_tp_refuse():
    """Heads whose qkv columns do not divide over tp: 5 heads of 4 at tp = 8
    (60 columns). The rule is refused and qkv left whole, as JAX's
    ``_divisible`` leaves it (so is ``proj``'s 20 input columns); the MLP's
    80 still split. The result is JAX's and one device's."""
    jax_model, params, model, x = _seeded_vit(num_heads=5, dim=20, depth=1)
    jspecs = jax_tp.tp_param_specs(params, jax_tp.VIT_TP_RULES, jax_mesh_of({"tp": 8}))
    ours = tp.tp_param_specs(model, tp.VIT_TP_RULES, cpu_mesh({"tp": 8}))
    assert jspecs["block0"]["attn"]["qkv"]["kernel"] == JP() and ours["block0.attn.qkv.weight"] == P()
    assert jspecs["block0"]["attn"]["proj"]["kernel"] == JP() and ours["block0.attn.proj.weight"] == P()
    assert ours["block0.mlp.Dense_0.weight"] == P("tp", None)
    apply_fn, sharded = tp.make_tp_apply(model, cpu_mesh({"tp": 8}))
    qkv = sharded["block0.attn.qkv.weight"]
    assert isinstance(qkv, dp.Replicated) and all(t is qkv[0] for t in qkv)
    module, = tp.tp_group_modules(model, cpu_mesh({"tp": 8}), sharded)
    assert isinstance(module.block0.attn, type(model.block0.attn))
    assert isinstance(module.block0.mlp, tp.TPMlp)
    jfn, jsharded = jax_tp.make_tp_apply(jax_model, jax_mesh_of({"tp": 8}), params)
    out = apply_fn(sharded, x).numpy()
    np.testing.assert_allclose(out, np.asarray(jfn(jsharded, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, _single(model, x), rtol=1e-5, atol=1e-5)


def test_heads_that_do_not_divide_tp_match_jax():
    """6 heads at tp = 4 (qkv's 144 rows divide by tp, so the spec splits as
    JAX's does) ran in JAX and were refused by the port until slice 18: now
    each entry holds whole heads, [⌊s·6/4⌋, ⌊(s+1)·6/4⌋) = 1, 2, 1, 2 of them,
    through ``make_tp_apply`` and the engine, held against JAX's."""
    jax_model, params, model, x = _seeded_vit(num_heads=6, dim=48, depth=1)
    jspecs = jax_tp.tp_param_specs(params, jax_tp.VIT_TP_RULES, jax_mesh_of({"tp": 4}))
    ours = tp.tp_param_specs(model, tp.VIT_TP_RULES, cpu_mesh({"tp": 4}))
    assert jspecs["block0"]["attn"]["qkv"]["kernel"] == JP(None, "tp")
    assert ours["block0.attn.qkv.weight"] == P("tp", None)
    apply_fn, sharded = tp.make_tp_apply(model, cpu_mesh({"tp": 4}))
    qkv, proj = sharded["block0.attn.qkv.weight"], sharded["block0.attn.proj.weight"]
    assert [t.shape[0] for t in qkv] == [3 * 8 * h for h in (1, 2, 1, 2)]
    assert [t.shape[1] for t in proj] == [8 * h for h in (1, 2, 1, 2)]
    full = model.state_dict()["block0.attn.qkv.weight"]
    assert torch.equal(qkv[1], torch.cat([full[g * 48 + 8 : g * 48 + 24] for g in range(3)]))
    assert torch.equal(qkv.gather(), full) and torch.equal(proj.gather(), model.state_dict()["block0.attn.proj.weight"])
    jfn, jsharded = jax_tp.make_tp_apply(jax_model, jax_mesh_of({"tp": 4}), params)
    expected = np.asarray(jfn(jsharded, jnp.asarray(x)))
    out = apply_fn(sharded, x).numpy()
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, _single(model, x), rtol=1e-5, atol=1e-5)
    # the entry holding 1 head of 6 holds less than JAX's even quarter (a
    # listed difference): qkv and proj at 1/6, the MLP at 1/4
    state = model.state_dict()
    whole = sum(t.nbytes for t in state.values())
    split = {"block0.attn.qkv.weight": 1 / 6, "block0.attn.qkv.bias": 1 / 6, "block0.attn.proj.weight": 1 / 6,
             "block0.mlp.Dense_0.weight": 1 / 4, "block0.mlp.Dense_0.bias": 1 / 4, "block0.mlp.Dense_1.weight": 1 / 4}
    local = sum(t.nbytes * split.get(k, 1) for k, t in state.items())
    assert tp.shard_fraction(sharded) == pytest.approx(local / whole)
    assert jax_tp.shard_fraction(jsharded) > tp.shard_fraction(sharded)
    # the engine's tp, at the engine's smallest spatial bucket
    jax_model, params, model, x = _seeded_vit(num_heads=6, dim=48, depth=1, img=64)
    jtp = JaxEngine("vit6", lambda p, v: jax_model.apply({"params": p}, v), params, cache=JaxCache(),
                    devices=jax.devices()[:4], tp=4, tp_rules=jax_tp.VIT_TP_RULES)
    etp = InferenceEngine("vit6", model, cache=CompiledProgramCache(), devices=["cpu"] * 4, tp=4,
                          tp_rules=tp.VIT_TP_RULES)
    try:
        assert etp.mesh_shape == jtp.mesh_shape == {"dp": 1, "tp": 4}
        ours = etp.predict(x)
        np.testing.assert_allclose(ours, np.asarray(jtp.predict(x)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ours, _single(model, x), rtol=1e-5, atol=1e-5)
    finally:
        etp.close()
        jtp.close()


def test_qkv_split_off_head_boundaries_raises():
    """``shard_params`` splits qkv at head boundaries; a qkv split evenly
    across heads (6 heads at tp = 4: 36 rows a group, 9 each) placed by
    hand is refused when the group's model is built, not run whole."""
    _, _, model, _ = _seeded_vit(num_heads=6, dim=48, depth=1)
    m = cpu_mesh({"tp": 4})
    sharded, _ = tp.shard_params(m, model, tp.VIT_TP_RULES)
    full, even = model.state_dict()["block0.attn.qkv.weight"], (0, 12, 24, 36, 48)
    sharded["block0.attn.qkv.weight"] = dp.Shards(
        [tp.tp_slice(full, 0, 4, j, 3, even) for j in range(4)], m, "tp", 0, 3, even)
    with pytest.raises(ValueError, match=r"block0\.attn\.qkv\.weight is split over tp at \(0, 12, 24, 36, 48\), "
                                         "not at the head boundaries of heads 8 wide"):
        tp.tp_group_modules(model, m, sharded)


@pytest.mark.parametrize("heads, dim, width", [(12, 48, 8), (2, 16, 4)], ids=["12_heads_tp8", "2_heads_tp4"])
def test_uneven_heads_match_jax(heads, dim, width):
    """ViT-B/14's 12 heads at tp = 8 (2 or 1 a shard; 2304 of its columns
    divide by 8, as 144 do here), and 2 heads at tp = 4, where two entries
    hold none and add nothing: JAX's GSPMD result, and one device's."""
    jax_model, params, model, x = _seeded_vit(num_heads=heads, dim=dim)
    m = cpu_mesh({"tp": width})
    apply_fn, sharded = tp.make_tp_apply(model, m)
    hd = dim // heads
    counts = [(s + 1) * heads // width - s * heads // width for s in range(width)]
    assert [t.shape[0] for t in sharded["block1.attn.qkv.weight"]] == [3 * hd * c for c in counts]
    assert 0 in counts or min(counts) == 1
    jfn, jsharded = jax_tp.make_tp_apply(jax_model, jax_mesh_of({"tp": width}), params)
    out = apply_fn(sharded, x).numpy()
    np.testing.assert_allclose(out, np.asarray(jfn(jsharded, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, _single(model, x), rtol=1e-5, atol=1e-5)
    # the layers run each entry's heads: every entry with heads, no other
    (group,) = tp.tp_group_modules(model, m, sharded)
    assert isinstance(group.block0.attn, tp.TPAttention)
    assert [h.num_heads for h in group.block0.attn.heads] == counts


# rules on layouts beyond the Megatron one: (port rules, JAX rules, model)
_VIT_QKV = [(r"attn\.qkv\.weight$", P("tp", None), 3), (r"attn\.qkv\.bias$", P("tp"), 3)]
_JAX_QKV = [(r"attn/qkv/kernel$", JP(None, "tp")), (r"attn/qkv/bias$", JP("tp"))]
LAYOUT_CASES = {
    "vit_proj_column": (
        _VIT_QKV + [(r"attn\.proj\.weight$", P("tp", None)), (r"attn\.proj\.bias$", P("tp"))] + tp.VIT_TP_RULES[3:],
        _JAX_QKV + [(r"attn/proj/kernel$", JP(None, "tp")), (r"attn/proj/bias$", JP("tp"))]
        + jax_tp.VIT_TP_RULES[3:],
        "vit"),
    "vit_rows_and_contiguous_qkv": (
        [(r"attn\.qkv\.weight$", P("tp", None)), (r"mlp\.Dense_0\.weight$", P(None, "tp"))],
        [(r"attn/qkv/kernel$", JP(None, "tp")), (r"mlp/Dense_0/kernel$", JP("tp", None))],
        "vit"),
    "vit_norms_and_embeddings": (
        [(r"^norm\.weight$", P("tp")), (r"norm1\.bias$", P("tp")), (r"patch_embed\.weight$", P("tp")),
         (r"ls1$", P("tp")), (r"pos_embed$", P(None, None, "tp")), (r"cls_token$", P(None, None, "tp"))]
        + tp.VIT_TP_RULES,
        [(r"^norm/scale$", JP("tp")), (r"norm1/bias$", JP("tp")), (r"patch_embed/kernel$", JP(None, None, None, "tp")),
         (r"ls1$", JP("tp")), (r"pos_embed$", JP(None, None, "tp")), (r"cls_token$", JP(None, None, "tp"))]
        + jax_tp.VIT_TP_RULES,
        "vit"),
    "unet_conv_input_channels": (
        [(r"Conv_\d+\.weight$", P(None, "tp"))],
        [(r"Conv_\d+/kernel$", JP(None, None, "tp", None))],
        "unet"),
    "unet_conv_transpose_outputs": (
        [(r"ConvTranspose_\d+\.weight$", P(None, "tp")), (r"ConvTranspose_\d+\.bias$", P("tp"))],
        [(r"ConvTranspose_\d+/kernel$", JP(None, None, None, "tp")), (r"ConvTranspose_\d+/bias$", JP("tp"))],
        "unet"),
    "unet_conv_transpose_inputs_and_norms": (
        [(r"ConvTranspose_\d+\.weight$", P("tp")), (r"GroupNorm_\d+\.weight$", P("tp"))] + tp.CONV_TP_RULES,
        [(r"ConvTranspose_\d+/kernel$", JP(None, None, "tp", None)), (r"GroupNorm_\d+/scale$", JP("tp"))]
        + jax_tp.CONV_TP_RULES,
        "unet"),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_rules_on_any_layout_match_jax(case):
    """A rule splitting any Linear or convolution on its outputs (column
    parallel) or inputs (row parallel), or any other tensor (gathered where
    its module runs), through the port's tp layers against JAX's GSPMD
    result and one device's, on bridged seeded weights."""
    rules, jrules, kind = LAYOUT_CASES[case]
    if kind == "vit":
        jax_model, params, model, x = _seeded_vit(num_heads=4, dim=48)
    else:
        jax_model = JaxUNet2D(features=(8, 16), out_channels=1, dtype=jnp.float32)
        params = jax.tree.map(np.asarray, seeded_flax_params(jax_model, (1, 32, 32, 1)))
        model = UNet2D(features=(8, 16), out_channels=1, in_channels=1, dtype=torch.float32).eval()
        model.load_state_dict(convert.state_dict_from_flax(params))
        x = np.random.default_rng(1).normal(size=(4, 32, 32, 1)).astype(np.float32)
    m = cpu_mesh({"tp": 4})
    apply_fn, sharded = tp.make_tp_apply(model, m, None, rules, data_spec=P())
    jfn, jsharded = jax_tp.make_tp_apply(jax_model, jax_mesh_of({"tp": 4}), params, jrules, data_spec=JP())
    assert tp.shard_fraction(sharded) == pytest.approx(jax_tp.shard_fraction(jsharded))
    assert sum(isinstance(leaf, dp.Shards) for leaf in sharded.values()) >= 2
    out = apply_fn(sharded, x).numpy()
    np.testing.assert_allclose(out, np.asarray(jfn(jsharded, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, _single(model, x), rtol=1e-5, atol=1e-5)
    # a state dict copied in reaches the gathered tensors too
    scaled = {k: v * 0.5 for k, v in model.state_dict().items()}
    other = copy.deepcopy(model)
    other.load_state_dict(scaled)
    np.testing.assert_allclose(apply_fn(scaled, x).numpy(), _single(other, x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axes, data_spec, out_spec", [
    ({"tp": 4}, ("tp",), None),
    ({"dp": 2, "tp": 2}, (("dp", "tp"),), None),
    ({"dp": 2, "tp": 2}, (("tp", "dp"),), None),
    ({"dp": 2, "tp": 2}, ("dp",), ()),
    ({"dp": 2, "tp": 2}, (None, "tp"), None),
], ids=["tp", "dp_tp", "tp_dp", "dp_out_replicated", "height_over_tp"])
def test_make_tp_apply_takes_jax_specs(axes, data_spec, out_spec):
    """Any data and output spec JAX's ``make_tp_apply`` takes: the port
    returns the same array, whole, on the mesh's first device."""
    jax_model, params, model, x = _seeded_vit(num_heads=4, dim=48)
    kw = {} if out_spec is None else {"out_spec": P(*out_spec)}
    apply_fn, sharded = tp.make_tp_apply(model, cpu_mesh(axes), data_spec=P(*data_spec), **kw)
    jkw = {} if out_spec is None else {"out_spec": JP(*out_spec)}
    jfn, jsharded = jax_tp.make_tp_apply(jax_model, jax_mesh_of(axes), params, data_spec=JP(*data_spec), **jkw)
    out = apply_fn(sharded, x)
    assert out.device == torch.device("cpu") and tuple(out.shape) == (8, 48)
    np.testing.assert_allclose(out.numpy(), np.asarray(jfn(jsharded, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    if data_spec[0] is not None:  # a batch that does not divide refuses, as JAX's jit does
        with pytest.raises(ValueError, match="does not divide"):
            apply_fn(sharded, x[:3])


def test_conv_rules_on_unet():
    jax_model = JaxUNet2D(features=(8, 16), out_channels=1, dtype=jnp.float32)
    x = np.random.default_rng(1).normal(size=(4, 32, 32, 1)).astype(np.float32)
    params = jax.tree.map(np.asarray, jax_model.init(jax.random.key(0), jnp.asarray(x[:1]))["params"])
    expected = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    model = UNet2D(features=(8, 16), out_channels=1, in_channels=1, dtype=torch.float32)
    model.load_state_dict(convert.state_dict_from_flax(params))
    apply_fn, sharded = tp.make_tp_apply(model.eval(), cpu_mesh({"tp": 4}), None, tp.CONV_TP_RULES, data_spec=P())
    # the 1-channel head does not split: it stays whole, as in JAX
    assert isinstance(sharded["Conv_0.weight"], dp.Replicated)
    assert isinstance(sharded["ConvBlock_0.Conv_0.weight"], dp.Shards)
    out = apply_fn(sharded, x).numpy()
    np.testing.assert_allclose(out, expected, rtol=2e-4, atol=2e-4)


# ---- the engine's tp path: tests/test_sharded_engine.py TestTensorParallel -------------

def test_tp_engine_matches_single_and_jax():
    cfg = dict(patch_size=8, dim=64, depth=2, num_heads=4)
    jvit = JaxViT(**cfg, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jvit.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)))["params"])
    x = np.random.default_rng(2).standard_normal((4, 64, 64, 3)).astype(np.float32)
    model = ViT(**cfg, dtype=torch.float32, img_size=64)
    model.load_state_dict(convert.state_dict_from_flax(params))
    jtp = JaxEngine("vit-tp", lambda p, v: jvit.apply({"params": p}, v), params, cache=JaxCache(),
                    devices=jax.devices()[:4], tp=2, tp_rules=jax_tp.VIT_TP_RULES)
    e1 = InferenceEngine("vit-tp", model, cache=CompiledProgramCache(), device="cpu")
    etp = InferenceEngine("vit-tp", model, cache=CompiledProgramCache(), devices=["cpu"] * 4, tp=2,
                          tp_rules=tp.VIT_TP_RULES)
    axes = InferenceEngine("vit-tp", model, cache=CompiledProgramCache(), devices=["cpu"] * 4,
                           mesh_axes={"dp": -1, "tp": 2}, tp_rules=tp.VIT_TP_RULES)
    try:
        assert etp.mesh_shape == jtp.mesh_shape == {"dp": 2, "tp": 2} == axes.mesh_shape
        assert etp._mesh_key == jtp._mesh_key == "dp2xtp2"
        assert tp.shard_fraction(etp.params) < 0.9
        assert tp.shard_fraction(etp.params) == pytest.approx(jax_tp.shard_fraction(jtp.params))
        out = etp.predict(x)
        np.testing.assert_allclose(out, e1.predict(x), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out, np.asarray(jtp.predict(x)), rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(axes.predict(x), out)
        # streamed weights re-shard by the rules, in place
        scaled = {k: v * 0.5 for k, v in model.state_dict().items()}
        before = etp.params["block0.attn.qkv.weight"][1].data_ptr()
        etp.begin_param_streaming()
        etp.complete_param_streaming(scaled)
        assert etp.params["block0.attn.qkv.weight"][1].data_ptr() == before
        ref = ViT(**cfg, dtype=torch.float32, img_size=64)
        ref.load_state_dict(scaled)
        e_ref = InferenceEngine("vit-ref", ref, cache=CompiledProgramCache(), device="cpu")
        np.testing.assert_allclose(etp.predict(x), e_ref.predict(x), rtol=1e-4, atol=1e-5)
        e_ref.close()
    finally:
        for e in (e1, etp, axes, jtp):
            e.close()


def test_tp_refusals_match_jax():
    unet = UNet2D(features=(4, 8), out_channels=1, in_channels=1, dtype=torch.float32)
    jmodel = JaxUNet2D(features=(4, 8), out_channels=1)
    # each refusal comes before the params are placed: their shapes do
    jparams = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 64, 64, 1)))["params"]
    jfn = lambda p, v: jmodel.apply({"params": p}, v)  # noqa: E731
    for kw, match in ((dict(tp=3), "tp=3"), (dict(tp=2), "without tp_rules"),
                      (dict(tp=2, mesh_axes={"dp": -1}), "not both")):
        with pytest.raises(ValueError, match=match) as ours:
            InferenceEngine("t", unet, devices=["cpu"] * 4, cache=CompiledProgramCache(), **kw)
        with pytest.raises(ValueError, match=match) as theirs:
            JaxEngine("t", jfn, jparams, devices=jax.devices()[:4], cache=JaxCache(), **kw)
        assert str(ours.value).split(" — ")[0] == str(theirs.value).split(" — ")[0]


# ---- the sharded FlatIP index: tests/test_cell_image_search.py ---------------------

def _random_unit(n, d=32, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("axes", [{"dp": 8}, {"dp": 2, "tp": 4}])
def test_sharded_index_matches_flat_and_jax(axes):
    corpus, q = _random_unit(1000, seed=7), _random_unit(3, seed=8)
    flat = knn.ShardedKnnIndex(corpus, mesh=None, dtype=np.float32, device="cpu")
    sharded = knn.ShardedKnnIndex(corpus, mesh=cpu_mesh(axes), axis="dp", dtype=np.float32)
    s1, i1 = flat.search(q, 9)
    s2, i2 = sharded.search(q, 9)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, atol=1e-5)
    js, ji = jax_knn.ShardedKnnIndex(corpus, mesh=jax_mesh_of(axes), axis="dp", dtype=np.float32).search(q, 9)
    np.testing.assert_array_equal(i2, ji)
    np.testing.assert_allclose(s2, js, atol=1e-5)


def test_sharded_uneven_corpus():
    corpus, q = _random_unit(37, seed=9), _random_unit(2, seed=10)
    idx = knn.ShardedKnnIndex(corpus, mesh=cpu_mesh({"dp": 8}), axis="dp", dtype=np.float32)
    s, i = idx.search(q, 40)  # k > n clamps
    assert i.shape == (2, 37)
    assert (i < 37).all() and (i >= 0).all()
    js, ji = jax_knn.ShardedKnnIndex(corpus, mesh=jax_mesh_of({"dp": 8}), axis="dp", dtype=np.float32).search(q, 40)
    np.testing.assert_array_equal(i, ji)
    # bf16 corpus (the default): the same ids as JAX's apart from ties
    s16, i16 = knn.ShardedKnnIndex(corpus, mesh=cpu_mesh({"dp": 8})).search(q, 5)
    js16, _ = jax_knn.ShardedKnnIndex(corpus, mesh=jax_mesh_of({"dp": 8})).search(q, 5)
    np.testing.assert_allclose(s16, js16, atol=1e-5)


# ---- placement over meshes of several axes ----------------------------------------------

@pytest.mark.parametrize("axes, spec", [
    ({"dp": 2, "tp": 2}, ("dp",)),
    ({"dp": 2, "sp": 2}, ("dp",)),
    ({"dp": 2, "sp": 4}, (None, "sp")),
    ({"dp": 4, "tp": 2}, (None, None, "tp")),
    ({"dp": 2, "sp": 2}, ("dp", "sp")),
    ({"dp": 2, "sp": 4}, ("dp", "sp")),
    ({"dp": 2, "sp": 4}, (("dp", "sp"),)),
    ({"dp": 2, "sp": 4}, (("sp", "dp"),)),
    ({"dp": 2, "sp": 2, "tp": 2}, ("dp", "sp", "tp")),
    ({"dp": 2, "sp": 2, "tp": 2}, (("tp", "dp"), None, "sp")),
    ({"dp": 2, "sp": 2, "tp": 2}, (None, ("sp", "tp"))),
])
def test_placement_follows_jax_addressable_shards(axes, spec):
    x = np.arange(8 * 8 * 4, dtype=np.float32).reshape(8, 8, 4)
    m = cpu_mesh(axes)
    ours = dp.place(dp.Placement(m, spec), x)
    theirs = jax.device_put(jnp.asarray(x), NamedSharding(jax_mesh_of(axes), JP(*spec)))
    jshards = sorted(theirs.addressable_shards, key=lambda s: s.device.id)
    assert len(ours) == len(jshards) == m.size
    for o, js in zip(ours, jshards):
        np.testing.assert_array_equal(o.numpy(), np.asarray(js.data))
    np.testing.assert_array_equal(ours.gather().numpy(), x)
    if spec == ("dp",):
        batch = dp.shard_batch(m, (x, {"p": np.arange(8)}))
        jbatch = jax_dp.shard_batch(jax_mesh_of(axes), (x, {"p": np.arange(8)}))
        for leaf, jleaf in ((batch[0], jbatch[0]), (batch[1]["p"], jbatch[1]["p"])):
            for o, js in zip(leaf, sorted(jleaf.addressable_shards, key=lambda s: s.device.id)):
                np.testing.assert_array_equal(o.numpy(), np.asarray(js.data))


def test_two_axis_spec_and_multi_axis_train_step_still_raise():
    """What still raises: a spec naming one axis twice, over two
    dimensions or in a tuple, as JAX's ``DuplicateSpecError`` (the port's
    a ``ValueError``); a dimension that does not divide its axes; and the
    train step over a mesh without its axis, as JAX's ``P("dp")`` over
    such a mesh."""
    m = cpu_mesh({"dp": 2, "sp": 2})
    jm = jax_mesh_of({"dp": 2, "sp": 2})
    for spec, axis in ((("dp", "dp"), "dp"), (("sp", ("dp", "sp")), "sp")):
        with pytest.raises(ValueError, match=f"names the mesh axis '{axis}' twice") as ours:
            dp.place(dp.Placement(m, spec), np.zeros((4, 4)))
        with pytest.raises(Exception, match=f"duplicate entries for `{axis}`") as theirs:
            NamedSharding(jm, JP(*spec))
        assert type(ours.value).__name__ == type(theirs.value).__name__ == "DuplicateSpecError"
    with pytest.raises(ValueError, match="does not divide"):
        dp.place(dp.Placement(m, (None, "sp")), np.zeros((4, 3)))
    with pytest.raises(ValueError, match="does not divide"):
        dp.place(dp.Placement(m, ("dp", "sp")), np.zeros((4, 3)))
    with pytest.raises(ValueError, match="does not divide"):
        dp.place(dp.Placement(m, (("dp", "sp"),)), np.zeros((6, 3)))
    from bioengine_tpu_torch.models.cellpose import make_train_step

    with pytest.raises(ValueError, match="'dp', not an axis of the mesh"):
        dp.data_parallel_step(make_train_step(), cpu_mesh({"sp": 2, "tp": 2}))
    with pytest.raises(ValueError):
        jax.lax.with_sharding_constraint(jnp.zeros(4), NamedSharding(jax_mesh_of({"sp": 2, "tp": 2}), JP("dp")))


def test_two_axis_and_tuple_specs_and_dp_tp_step():
    """A spec splitting two dimensions over two axes places each entry's
    block; a tuple of axes for one dimension (refused before slice 18)
    places as JAX's ``addressable_shards``, the product in row-major
    order, and the train step over a (dp, tp) mesh (refused before slice
    18) runs, tp replicated: the dp = 2 step bit for bit."""
    m = cpu_mesh({"dp": 2, "sp": 2})
    jm = jax_mesh_of({"dp": 2, "sp": 2})
    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    placed = dp.place(dp.Placement(m, ("dp", "sp")), x)
    assert [t.tolist() for t in placed] == [x[:2, :2].tolist(), x[:2, 2:].tolist(),
                                            x[2:, :2].tolist(), x[2:, 2:].tolist()]
    np.testing.assert_array_equal(placed.gather().numpy(), x)
    y = np.arange(16, dtype=np.float32).reshape(8, 2)
    tup = dp.place(dp.Placement(m, (("dp", "sp"),)), y)
    jtup = jax.device_put(jnp.asarray(y), NamedSharding(jm, JP(("dp", "sp"))))
    assert [t.tolist() for t in tup] == [np.asarray(s.data).tolist() for s in
                                         sorted(jtup.addressable_shards, key=lambda s: s.device.id)]
    assert [t.tolist() for t in tup] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]], [[8, 9], [10, 11]], [[12, 13], [14, 15]]]
    np.testing.assert_array_equal(tup.gather().numpy(), y)
    from bioengine_tpu_torch.models.cellpose import CellposeNet, TrainState, make_train_step

    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(4, 16, 16, 2)).astype(np.float32), rng.normal(size=(4, 16, 16, 2)).astype(np.float32),
             rng.integers(0, 2, size=(4, 16, 16)).astype(np.float32))
    results = []
    for axes in ({"dp": 2}, {"dp": 2, "tp": 2}):
        model = CellposeNet(features=(4, 8), dtype=torch.float32)
        model.reset_parameters(1)
        mesh_ = cpu_mesh(axes)
        state = dp.replicate(mesh_, TrainState(model, torch.optim.SGD(model.parameters(), lr=1e-2)))
        state, metrics = dp.data_parallel_step(make_train_step(), mesh_)(state, *batch)
        results.append((float(metrics["loss"]), [p.detach().clone() for p in state.module.parameters()]))
        for replica in state.replicas[1:]:
            assert all(torch.equal(a, b) for a, b in zip(state.module.parameters(), replica.parameters()))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(a, b) for a, b in zip(results[0][1], results[1][1]))
