"""The PyTorch port's U-Nets against the flax U-Nets, on weights carried
over by ``state_dict_from_flax``.

Tolerances: f32 to 1e-4 max-abs (both sides are plain f32 arithmetic in
another summation order; measured ~4e-6). bf16 to 10% of the output's
largest magnitude: XLA's fused CPU program keeps some bf16 intermediates
in f32 where PyTorch rounds them, and JAX's own jitted and eager bf16
forwards of these models differ by ~1% of that range (measured ~0.03 on
outputs of magnitude ~2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bioengine_tpu.models import get_model as jax_get_model
from bioengine_tpu.runtime import convert as jax_convert
from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu_torch.models import registry
from bioengine_tpu_torch.models.unet import UNet2D
from bioengine_tpu_torch.models.unet3d import UNet3D
from bioengine_tpu_torch.runtime import convert

CASES = {
    # name: (registry name, kwargs, input shape)
    "unet2d_8_16": ("unet2d", dict(features=(8, 16)), (2, 32, 32, 1)),
    "unet2d_8_16_32": ("unet2d", dict(features=(8, 16, 32), out_channels=2), (1, 32, 32, 3)),
    "unet3d_4_8": ("unet3d", dict(features=(4, 8)), (1, 8, 16, 16, 1)),
    "unet3d_4_8_z1": ("unet3d", dict(features=(4, 8), z_strides=(1,)), (1, 4, 16, 16, 2)),
}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def port_model(name, kw, in_channels, params, dtype):
    model = registry.get_model(name, **kw, in_channels=in_channels, dtype=dtype)
    model.load_state_dict(convert.state_dict_from_flax(params))
    return model.eval()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_unet_matches_flax(case, dtype):
    name, kw, shape = CASES[case]
    jdt, tdt = DTYPES[dtype]
    jax_model = jax_get_model(name, **kw, dtype=jdt)
    params = seeded_flax_params(jax_model, shape, seed=3)
    x = _inputs(shape)
    ref = np.asarray(jax.jit(jax_model.apply)({"params": params}, jnp.asarray(x)))
    model = port_model(name, kw, shape[-1], params, tdt)
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    if dtype == "f32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    else:
        assert np.abs(out - ref).max() <= 0.1 * np.abs(ref).max()


def test_unet_shapes():
    model = registry.get_model("unet2d", features=(8, 16, 32), out_channels=2)
    model.reset_parameters(0)
    with torch.inference_mode():
        y = model(torch.zeros(2, 64, 64, 1))
    assert y.shape == (2, 64, 64, 2) and y.dtype == torch.float32
    assert model.divisor == 4


def test_unet3d_shapes_isotropic():
    model = registry.get_model("unet3d", features=(4, 8), out_channels=2)
    assert model.divisor == 2 and model.z_divisor == 2
    model.reset_parameters(0)
    with torch.inference_mode():
        y = model(torch.zeros(1, 8, 16, 16, 1))
    assert y.shape == (1, 8, 16, 16, 2) and y.dtype == torch.float32


def test_unet3d_anisotropic_z_strides():
    model = registry.get_model("unet3d", features=(4, 8, 16), z_strides=(1, 2))
    assert model.divisor == 4 and model.z_divisor == 2
    model.reset_parameters(0)
    with torch.inference_mode():
        y = model(torch.zeros(1, 4, 16, 16, 1))
    assert y.shape == (1, 4, 16, 16, 1)
    with pytest.raises(ValueError, match="z_strides"):
        registry.get_model("unet3d", features=(4, 8, 16), z_strides=(1,))


def test_module_tree_follows_flax_creation_order():
    model = UNet2D(features=(8, 16, 32))
    top = [n for n, _ in model.named_children()]
    assert sorted(top) == sorted([
        "ConvBlock_0", "ConvBlock_1", "ConvBlock_2", "ConvBlock_3",
        "ConvBlock_4", "ConvTranspose_0", "ConvTranspose_1", "Conv_0",
    ])
    assert [n for n, _ in model.ConvBlock_3.named_children()] == [
        "Conv_0", "GroupNorm_0", "Conv_1", "GroupNorm_1",
    ]
    # the first decoder block takes [up, skip]: 2 x 16 channels
    assert model.ConvBlock_3.Conv_0.weight.shape == (16, 32, 3, 3)
    assert model.ConvTranspose_0.weight.shape == (32, 16, 2, 2)
    # same names, same shapes as the flax tree
    jax_model = jax_get_model("unet2d", features=(8, 16, 32))
    flax_flat = jax_convert.flatten_params(seeded_flax_params(jax_model, (1, 32, 32, 1)))
    state = convert.state_dict_from_flax(flax_flat)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()
    }
    assert [n for n, _ in UNet3D(features=(4, 8)).named_children()][0] == "ConvBlock3D_0"


def test_bridge_round_trip_with_flip():
    jax_model = jax_get_model("unet3d", features=(4, 8, 16), z_strides=(1, 2))
    params = seeded_flax_params(jax_model, (1, 4, 16, 16, 1), seed=5)
    flat = jax_convert.flatten_params(params)
    state = convert.state_dict_from_flax(params)
    # transposed conv: flax (kz, ky, kx, I, O) -> torch (I, O, kz, ky, kx),
    # flipped in every spatial axis
    k = flat["ConvTranspose_1/kernel"]
    assert k.shape == (1, 2, 2, 8, 4)
    np.testing.assert_array_equal(
        state["ConvTranspose_1.weight"].numpy(),
        k[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2),
    )
    # convolution: (k..., I, O) -> (O, I, k...); GroupNorm scale -> weight
    np.testing.assert_array_equal(
        state["ConvBlock3D_0.Conv_1.weight"].numpy(),
        flat["ConvBlock3D_0/Conv_1/kernel"].transpose(4, 3, 0, 1, 2),
    )
    np.testing.assert_array_equal(
        state["ConvBlock3D_0.GroupNorm_0.weight"].numpy(),
        flat["ConvBlock3D_0/GroupNorm_0/scale"],
    )
    back = convert.flax_params_from_state_dict(state)
    assert back.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])


def test_transposed_conv_flip_matches_flax():
    """One flax ConvTranspose (2x2, stride 2, SAME) against torch's
    conv_transpose2d on the bridged weight: out[2i+t] = x[i] K[1-t]."""
    from flax import linen as nn

    layer = nn.ConvTranspose(3, (2, 2), strides=(2, 2), dtype=jnp.float32)
    x = _inputs((1, 5, 4, 2))
    params = seeded_flax_params(layer, x.shape, seed=7)
    ref = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    state = convert.state_dict_from_flax({"ConvTranspose_0": params})
    out = F.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        state["ConvTranspose_0.weight"],
        state["ConvTranspose_0.bias"],
        stride=2,
    ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_reset_parameters_is_seeded():
    a, b, c = (UNet2D(features=(8, 16)) for _ in range(3))
    a.reset_parameters(3)
    b.reset_parameters(3)
    c.reset_parameters(4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = "ConvBlock_0.Conv_0.weight"
    assert not torch.equal(sa[w], sc[w])
    assert torch.all(sa["ConvBlock_1.GroupNorm_0.weight"] == 1)
    assert torch.all(sa["ConvTranspose_0.bias"] == 0)
    # N(0, 1/fan_in): fan_in of a 3x3 conv over 16 channels is 144
    std = sa["ConvBlock_2.Conv_0.weight"].std().item()
    assert abs(std - (1 / (2 * 8 * 9)) ** 0.5) < 0.02


def test_registry_names():
    assert {"unet2d", "unet3d"} <= set(registry.list_models())
    assert isinstance(registry.get_model("unet2d"), UNet2D)
    assert registry.get_model("unet2d").features == (32, 64, 128, 256)
    m3 = registry.get_model("unet3d")
    assert isinstance(m3, UNet3D) and m3.features == (16, 32, 64)
    assert registry.get_model("unet2d", dtype="float32").dtype == torch.float32
