"""The PyTorch port's ViT against the flax ViT, on weights carried over by
``state_dict_from_flax``.

Kernel path: the port with ``make_attn_fn()`` (its plain version on the
CPU) against JAX with ``make_attn_fn()`` (the Pallas kernel in interpreter
mode). Inline path: each side's own einsum attention. f32 to 1e-4 max-abs;
bf16 to per-row cosine >= 0.9999, the fidelity bar of the JAX suite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioengine_tpu.models.vit import ViT as JaxViT
from bioengine_tpu.ops.pallas.attention import make_attn_fn as jax_make_attn_fn
from bioengine_tpu.runtime import convert as jax_convert
from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu_torch.models import registry
from bioengine_tpu_torch.models.vit import ViT
from bioengine_tpu_torch.ops.attention import make_attn_fn
from bioengine_tpu_torch.runtime import convert

TINY = dict(patch_size=14, dim=64, depth=2, num_heads=2)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def tiny_init():
    """``model.init`` params of the tiny flax ViT, as numpy (param dtype
    is f32 whatever the compute dtype)."""
    params = jax.jit(JaxViT(**TINY).init)(
        jax.random.key(0), jnp.zeros((1, 56, 56, 3))
    )["params"]
    return jax.tree.map(np.asarray, params)


def _perturbed(params, noise=0.05, seed=0):
    """``params`` plus seeded noise on every leaf, so zero biases, unit
    norms and LayerScales are exercised by the bridge too."""
    rng = np.random.default_rng(seed)
    flat = {
        k: (v + noise * rng.normal(size=v.shape)).astype(np.float32)
        for k, v in sorted(jax_convert.flatten_params(params).items())
    }
    return jax_convert.unflatten_params(flat)


def _cosine_rows(a, b):
    return np.sum(a * b, 1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


def _images(seed, batch, size):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, size, size, 3)).astype(np.float32)


def _port_forward(params, images, **cfg):
    model = ViT(img_size=images.shape[1], **cfg)
    model.load_state_dict(convert.state_dict_from_flax(params))
    with torch.no_grad():
        return model(torch.from_numpy(images)).numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("path", ["kernel", "inline"])
def test_tiny_vit_matches_jax(tiny_init, dtype, path):
    jdt, tdt = DTYPES[dtype]
    images = _images(4, 2, 56)
    jax_model = JaxViT(
        **TINY, dtype=jdt, attn_fn=jax_make_attn_fn() if path == "kernel" else None
    )
    # bf16 rounds at other places in XLA's CPU products than in PyTorch's
    # (XLA rounds x @ w before adding the bias): noise on the init would
    # measure that, so bf16 runs on the plain init
    params = _perturbed(tiny_init) if dtype == "f32" else tiny_init
    ref = np.asarray(
        jax.jit(jax_model.apply)({"params": params}, jnp.asarray(images))
    )
    out = _port_forward(
        params, images, **TINY, dtype=tdt,
        attn_fn=make_attn_fn() if path == "kernel" else None,
    )
    assert out.dtype == np.float32 and out.shape == (2, 64)
    if dtype == "f32":
        np.testing.assert_allclose(out, ref, atol=1e-4)
    else:
        assert _cosine_rows(out, ref).min() >= 0.9999


def test_vit_b14_geometry_f32_matches_jax():
    """Full ViT-B/14 widths at batch 1, both sides on their inline
    attention with an f32 softmax, on seeded weights."""
    images = _images(11, 1, 224)
    jax_model = JaxViT(dtype=jnp.float32, softmax_dtype=jnp.float32)
    params = seeded_flax_params(jax_model, images.shape, seed=12)
    ref = np.asarray(
        jax.jit(jax_model.apply)({"params": params}, jnp.asarray(images))
    )
    out = _port_forward(params, images, dtype=torch.float32, softmax_dtype=torch.float32)
    assert out.shape == (1, 768)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_bridge_covers_every_parameter(tiny_init):
    params = _perturbed(tiny_init)
    state = convert.state_dict_from_flax(params)
    model = ViT(**TINY, img_size=56)
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == expected
    # flat and nested inputs give the same state_dict
    flat_state = convert.state_dict_from_flax(jax_convert.flatten_params(params))
    assert all(torch.equal(flat_state[k], state[k]) for k in state)
    # conv kernel (kh, kw, I, O) -> (O, I, kh, kw)
    np.testing.assert_array_equal(
        state["patch_embed.weight"].numpy(),
        params["patch_embed"]["kernel"].transpose(3, 2, 0, 1),
    )


def test_loads_the_jax_npz_format(tiny_init, tmp_path):
    params = _perturbed(tiny_init)
    jax_convert.save_params_npz(str(tmp_path / "jax.npz"), params)
    loaded = convert.load_params_npz(str(tmp_path / "jax.npz"))
    expected = jax_convert.flatten_params(params)
    by_port = convert.flatten_params(loaded)
    assert by_port.keys() == expected.keys()
    for key in expected:
        np.testing.assert_array_equal(by_port[key], expected[key])
    assert convert.unflatten_params(by_port).keys() == loaded.keys()


def test_reset_parameters_is_seeded():
    a, b, c = (ViT(**TINY, img_size=56) for _ in range(3))
    a.reset_parameters(3)
    b.reset_parameters(3)
    c.reset_parameters(4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["block0.attn.qkv.weight"], sc["block0.attn.qkv.weight"])
    assert torch.all(sa["cls_token"] == 0) and torch.all(sa["block1.ls2"] == 1)


def test_registry():
    # every name of the JAX registry
    assert registry.list_models() == [
        "cellpose", "cellpose-sam", "cpsam", "stardist2d", "unet2d", "unet3d", "vit-b14", "vit-s14",
    ]
    small = registry.get_model("vit-s14", depth=1, img_size=28)
    assert small.dim == 384 and small.block0.attn.num_heads == 6
    assert registry.get_model("vit-b14", depth=1, img_size=28).dim == 768
    assert registry.get_model("stardist2d").n_rays == 32
    with pytest.raises(KeyError, match="Available"):
        registry.get_model("no-such-model")


def test_rejects_other_image_sizes():
    model = ViT(**TINY, img_size=56)
    with pytest.raises(ValueError):
        model(torch.zeros(1, 42, 42, 3))
