"""The PyTorch port's flash attention against the JAX Pallas kernel.

Replays every case of tests/test_ops_pallas.py: the same numpy inputs go
to the JAX kernel (interpreter mode on the CPU) and to the port's
``flash_attention``, which takes its plain PyTorch version for CPU tensors.
Tolerances are the JAX suite's: 2e-5 in f32, 2e-2 in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioengine_tpu.ops.pallas.attention import (
    _reference_attention as jax_reference_attention,
)
from bioengine_tpu.ops.pallas.attention import flash_attention as jax_flash
from bioengine_tpu.ops.pallas.attention import make_attn_fn as jax_make_attn_fn
from _torch_parity import emulate_wgmma_attention, few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu_torch.ops import attention

TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _run_jax(arrays, dtype=jnp.float32, **kw):
    out = jax_flash(*(jnp.asarray(a, dtype) for a in arrays), **kw)
    return np.asarray(out.astype(jnp.float32))


def _run_port(arrays, dtype=jnp.float32, **kw):
    q, k, v = (torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays)
    return attention.flash_attention(q, k, v, **kw).float().numpy()


class TestFlashAttentionParity:
    @pytest.mark.parametrize("n", [128, 200, 257])
    def test_matches_jax(self, n):
        arrays = _inputs(0, (2, 3, n, 64))
        np.testing.assert_allclose(
            _run_port(arrays), _run_jax(arrays), atol=2e-5, rtol=2e-5
        )

    def test_causal(self):
        arrays = _inputs(1, (1, 2, 200, 32))
        np.testing.assert_allclose(
            _run_port(arrays, causal=True),
            _run_jax(arrays, causal=True),
            atol=2e-5,
            rtol=2e-5,
        )

    def test_bf16(self):
        arrays = _inputs(2, (1, 2, 130, 64))
        out = _run_port(arrays, jnp.bfloat16)
        ref = _run_jax(arrays, jnp.bfloat16)
        np.testing.assert_allclose(out, ref, atol=2e-2)

    @pytest.mark.parametrize(
        "n, block_q, block_k",
        [(100, 128, 96), (300, 128, 256)],
        ids=["non_dividing_blocks", "nonsquare_blocks"],
    )
    def test_jax_block_shapes(self, n, block_q, block_k):
        """The JAX kernel at its block sizes; the port at its own tiling."""
        arrays = _inputs(6 if n == 100 else 3, (1, 1, n, 64))
        np.testing.assert_allclose(
            _run_port(arrays),
            _run_jax(arrays, block_q=block_q, block_k=block_k),
            atol=2e-5,
            rtol=2e-5,
        )

    @pytest.mark.parametrize("causal", [False, True])
    def test_reference_matches_jax_reference(self, causal):
        arrays = _inputs(7, (2, 2, 70, 32))
        ref = jax_reference_attention(
            *(jnp.asarray(a) for a in arrays), causal
        )
        out = attention.reference_attention(
            *(torch.from_numpy(a) for a in arrays), causal
        )
        np.testing.assert_allclose(
            out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5
        )

    def test_vit_integration(self):
        """The port's attention fills the port ViT's attn_fn slot and
        matches the JAX ViT with the JAX kernel in that slot."""
        from bioengine_tpu.models.vit import ViT as JaxViT
        from bioengine_tpu_torch.models.vit import ViT
        from bioengine_tpu_torch.runtime.convert import state_dict_from_flax

        images = np.random.default_rng(4).normal(size=(1, 56, 56, 3))
        images = images.astype(np.float32)
        cfg = dict(patch_size=14, dim=64, depth=2, num_heads=2)
        jax_model = JaxViT(**cfg, attn_fn=jax_make_attn_fn())
        params = seeded_flax_params(jax_model, images.shape)
        ref = np.asarray(
            jax.jit(jax_model.apply)({"params": params}, jnp.asarray(images))
        )

        state = state_dict_from_flax(params)
        flash = ViT(**cfg, img_size=56, attn_fn=attention.make_attn_fn())
        base = ViT(**cfg, img_size=56)
        flash.load_state_dict(state)
        base.load_state_dict(state)
        with torch.no_grad():
            out_flash = flash(torch.from_numpy(images)).numpy()
            out_base = base(torch.from_numpy(images)).numpy()
        cos = np.sum(out_flash * ref) / np.linalg.norm(out_flash) / np.linalg.norm(ref)
        assert cos >= 0.9999
        np.testing.assert_allclose(out_base, out_flash, atol=5e-2)

    @pytest.mark.parametrize("causal", [False, True])
    def test_grads_match_jax(self, causal):
        arrays = _inputs(5, (1, 1, 128, 64))

        def loss(q, k, v):
            return jnp.sum(jax_flash(q, k, v, causal=causal) ** 2)

        jax_grads = jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in arrays)
        )
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
        (attention.flash_attention(q, k, v, causal=causal) ** 2).sum().backward()
        for port, ref in zip((q.grad, k.grad, v.grad), jax_grads):
            assert np.isfinite(port.numpy()).all()
            np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-4)


class TestWrapperContract:
    def test_cpu_tensors_take_the_plain_version(self):
        arrays = _inputs(8, (1, 2, 40, 64))
        before = attention.launch_count
        q, k, v = (torch.from_numpy(a) for a in arrays)
        out = attention.flash_attention(q, k, v)
        assert attention.launch_count == before
        np.testing.assert_array_equal(
            out.numpy(), attention.reference_attention(q, k, v).numpy()
        )

    def test_make_attn_fn_passes_causal(self):
        arrays = [torch.from_numpy(a) for a in _inputs(9, (1, 1, 33, 32))]
        fn = attention.make_attn_fn(causal=True)
        torch.testing.assert_close(
            fn(*arrays), attention.reference_attention(*arrays, causal=True)
        )

    @pytest.mark.parametrize(
        "dtype, d, error",
        [(torch.float16, 64, TypeError), (torch.float32, 48, ValueError)],
    )
    def test_kernel_rejects_what_it_does_not_take(self, dtype, d, error):
        """Checked before any CUDA call, so this runs without a card."""
        q = torch.zeros(1, 1, 8, d, dtype=dtype)
        with pytest.raises(error):
            attention._launch(q, q, q, False)

    def test_shape_mismatch_raises(self):
        q = torch.zeros(1, 1, 8, 32)
        with pytest.raises(ValueError):
            attention.flash_attention(q, torch.zeros(1, 1, 9, 32), q)


class TestLaunchPlan:
    """The launch plan the wrapper hands the C entry point, which refuses
    any other (csrc/flash_attn_fwd.cu plan_for)."""

    # the main path's shape and the test suites' shapes
    SHAPES = [
        (64, 12, 257, 64),
        (2, 3, 128, 64),
        (2, 3, 200, 64),
        (2, 3, 257, 64),
        (1, 2, 200, 32),
        (1, 2, 130, 64),
        (1, 1, 100, 64),
        (1, 1, 300, 64),
        (2, 4, 190, 128),
        (1, 2, 77, 128),
        (2, 2, 70, 32),
        (2, 3, 1, 32),
        (2, 3, 65, 128),
    ]

    def test_main_path_shape(self):
        plan = attention.launch_plan((64, 12, 257, 64), torch.bfloat16)
        assert plan.path == "wgmma"
        assert plan.q_tiles == 5
        assert plan.grid == 64 * 12 * 5
        assert plan.threads == 128 + 32

    @pytest.mark.parametrize("shape", SHAPES, ids=str)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
    def test_tiles_cover_every_row_once(self, shape, dtype):
        B, H, N, _ = shape
        plan = attention.launch_plan(shape, dtype)
        assert plan.q_tiles == -(-N // attention.BLOCK_Q)
        assert (plan.q_tiles - 1) * attention.BLOCK_Q < N <= plan.q_tiles * attention.BLOCK_Q
        assert plan.grid == B * H * plan.q_tiles

    @pytest.mark.parametrize("shape", [(64, 12, 257, 64), (2, 3, 65, 32)], ids=str)
    def test_tiles_of_one_head_are_adjacent(self, shape):
        B, H, _, _ = shape
        plan = attention.launch_plan(shape, torch.bfloat16)
        order = [plan.block_tile(b) for b in range(plan.grid)]
        assert order == [
            (bh, t) for bh in range(B * H) for t in range(plan.q_tiles)
        ]

    def test_grid_is_linear_past_the_grid_y_limit(self):
        """More than 65535 query tiles of one head: one linear grid axis."""
        plan = attention.launch_plan((1, 1, 64 * 70_000, 64), torch.bfloat16)
        assert plan.q_tiles == 70_000 and plan.grid == 70_000

    @pytest.mark.parametrize("d", attention.HEAD_DIMS)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
    def test_shared_memory_fits_a_block(self, dtype, d):
        plan = attention.launch_plan((1, 1, 257, d), dtype)
        assert 0 < plan.smem_bytes <= 232_448  # 227 KB, an H100 block's most

    @pytest.mark.parametrize(
        "dtype, path",
        [(torch.float32, "cuda_core_f32"), (torch.bfloat16, "wgmma")],
        ids=str,
    )
    def test_path_follows_dtype(self, dtype, path):
        for d in attention.HEAD_DIMS:
            assert attention.launch_plan((2, 3, 257, d), dtype).path == path

    @pytest.mark.parametrize(
        "shape, dtype, error",
        [
            ((1, 1, 64, 64), torch.float16, TypeError),
            ((1, 1, 64, 64), torch.float64, TypeError),
            ((1, 1, 64, 48), torch.bfloat16, ValueError),
            ((1, 1, 64, 256), torch.float32, ValueError),
            ((1, 1, 0, 64), torch.bfloat16, ValueError),
        ],
        ids=["f16", "f64", "d48", "d256", "n0"],
    )
    def test_refuses_what_the_kernel_does_not_take(self, shape, dtype, error):
        with pytest.raises(error):
            attention.launch_plan(shape, dtype)


class TestWgmmaEmulation:
    """A plain emulation of the bf16 path's tiling and rounding (64 x 64
    tiles, exp2 with the folded scale, P rounded to bf16 before P V, l in
    f32) against the JAX kernel in bf16, at the JAX suite's bf16 tolerance."""

    @pytest.mark.parametrize(
        "shape, causal",
        [
            ((2, 3, 257, 64), False),
            ((2, 3, 257, 32), False),
            ((2, 3, 257, 128), False),
            ((2, 3, 257, 64), True),
        ],
        ids=["n257_d64", "d32", "d128", "causal"],
    )
    def test_matches_jax_bf16(self, shape, causal):
        arrays = _inputs(10, shape)
        ref = _run_jax(arrays, jnp.bfloat16, causal=causal)
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
        out = emulate_wgmma_attention(q, k, v, causal)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2)

    @pytest.mark.parametrize("n", [1, 64, 65])
    def test_tile_edges_match_the_plain_version(self, n):
        arrays = _inputs(11, (1, 2, n, 64))
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
        np.testing.assert_allclose(
            emulate_wgmma_attention(q, k, v).float().numpy(),
            attention.reference_attention(q, k, v).float().numpy(),
            atol=2e-2,
        )
