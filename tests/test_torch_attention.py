"""The PyTorch port's flash attention against the JAX Pallas kernel.

Replays every case of tests/test_ops_pallas.py: the same numpy inputs go
to the JAX kernel (interpreter mode on the CPU) and to the port's
``flash_attention``, which takes its plain PyTorch version for CPU tensors.
Tolerances are the JAX suite's: 2e-5 in f32, 2e-2 in bf16; in f16, 2.5e-3,
a little over one f16 ulp at the outputs' largest magnitudes (2 to 4, where
the ulp is 2^-9 = 1.95e-3), since both sides round once to f16 from f32
sums taken in different orders. Beside the suite's cases, every dtype the
Pallas kernel takes (f32, bf16, f16) at head dims that are not multiples of
the kernel's tiles (1 to 300), which the port's kernel runs at a padded
width.
"""

import functools

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
from _torch_parity import (  # noqa: F401
    emulate_tf32x3_attention,
    emulate_wgmma_attention,
    few_torch_threads,
    seeded_flax_params,
    split_tf32,
    tf32_round,
)
from bioengine_tpu_torch.ops import attention

TORCH_DTYPES = {
    jnp.float32: torch.float32,
    jnp.bfloat16: torch.bfloat16,
    jnp.float16: torch.float16,
}
JAX_DTYPES = {t: j for j, t in TORCH_DTYPES.items()}
# (atol, rtol) by dtype: the JAX suite's in f32 and bf16; f16 as above
TOLERANCE = {
    torch.float32: (2e-5, 2e-5),
    torch.bfloat16: (2e-2, 0.0),
    torch.float16: (2.5e-3, 0.0),
}
# head dims off the kernel's tiles: 1 and 16 (Dp 32), 48 (64), 80 and 100
# (128; 100 also pads its rows to 104 or 100 for TMA), 192 (the 16-bit path's
# Dp 192, f32's wide path), 300 (the wide path in every dtype)
WIDTHS = (1, 16, 48, 80, 100, 192, 300)


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _run_jax(arrays, dtype=jnp.float32, **kw):
    out = jax_flash(*(jnp.asarray(a, dtype) for a in arrays), **kw)
    return np.asarray(out.astype(jnp.float32))


def _run_port(arrays, dtype=jnp.float32, **kw):
    q, k, v = (torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays)
    return attention.flash_attention(q, k, v, **kw).float().numpy()


@functools.lru_cache(maxsize=None)
def _width_case(dtype: torch.dtype, d: int, causal: bool):
    """Inputs (1, 2, 70, d) from a seed, and the JAX kernel's output on them
    in ``dtype`` (f32), computed once per module."""
    arrays = _inputs(20 + d, (1, 2, 70, d))
    return arrays, _run_jax(arrays, JAX_DTYPES[dtype], causal=causal)


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
    @pytest.mark.parametrize("d", WIDTHS)
    @pytest.mark.parametrize(
        "dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str
    )
    def test_matches_jax_at_every_width(self, dtype, d, causal):
        """Every dtype the JAX kernel takes, at head dims it pads (to 128 on
        the TPU) and the port's kernel runs at a padded width or on its wide
        path; f16 against JAX's own f16 output."""
        arrays, ref = _width_case(dtype, d, causal)
        out = _run_port(arrays, JAX_DTYPES[dtype], causal=causal)
        atol, rtol = TOLERANCE[dtype]
        np.testing.assert_allclose(out, ref, atol=atol, rtol=rtol)

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

    @pytest.mark.parametrize(
        "dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"]
    )
    def test_vit_head_dim_80(self, dtype):
        """ViT-H/14's head dim (80) at a narrow width: the port's ViT with the
        flash attn_fn against the JAX ViT with the JAX kernel in that slot,
        weights bridged by ``state_dict_from_flax``, in bf16 and in f16.
        Cosine >= 0.9999 and max abs within the dtype's product rounding
        over two blocks (5e-2 bf16, 1e-2 f16; the embeddings are O(1))."""
        from bioengine_tpu.models.vit import ViT as JaxViT
        from bioengine_tpu_torch.models.vit import ViT
        from bioengine_tpu_torch.runtime.convert import state_dict_from_flax

        images = np.random.default_rng(21).normal(size=(2, 56, 56, 3))
        images = images.astype(np.float32)
        cfg = dict(patch_size=14, dim=160, depth=2, num_heads=2)
        jax_model = JaxViT(**cfg, dtype=JAX_DTYPES[dtype], attn_fn=jax_make_attn_fn())
        params = seeded_flax_params(jax_model, images.shape)
        ref = np.asarray(
            jax.jit(jax_model.apply)({"params": params}, jnp.asarray(images))
        )
        port = ViT(**cfg, dtype=dtype, img_size=56, attn_fn=attention.make_attn_fn())
        port.load_state_dict(state_dict_from_flax(params))
        with torch.no_grad():
            out = port(torch.from_numpy(images)).numpy()
        assert out.dtype == np.float32 and np.isfinite(out).all()
        cos = np.sum(out * ref, axis=1) / np.linalg.norm(out, axis=1) / np.linalg.norm(ref, axis=1)
        assert cos.min() >= 0.9999
        atol = 5e-2 if dtype == torch.bfloat16 else 1e-2
        np.testing.assert_allclose(out, ref, atol=atol)

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
        [
            (torch.float64, 64, TypeError),
            (torch.int32, 64, TypeError),
            (torch.float32, attention.MAX_HEAD_DIM + 1, ValueError),
            (torch.float16, 2 * attention.MAX_HEAD_DIM, ValueError),
        ],
        ids=["f64", "int32", "f32_above_cap", "f16_above_cap"],
    )
    def test_kernel_rejects_what_it_does_not_take(self, dtype, d, error):
        """What still raises on the card: dtypes the JAX kernel does not take
        either, and head dims above the wide path's cap. Checked before any
        CUDA call, so this runs without a card."""
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

    # the main path's shapes (ViT-B/14, ViT-H/14) and the test suites' shapes
    SHAPES = [
        (64, 12, 257, 64),
        (64, 16, 257, 80),
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
        (1, 2, 70, 1),
        (2, 3, 65, 100),
        (2, 3, 257, 192),
        (2, 3, 257, 300),
        (1, 2, 33, 1024),
    ]
    ALL_DTYPES = [torch.float32, torch.bfloat16, torch.float16]

    @pytest.mark.parametrize(
        "dtype, path, threads, block_q",
        # 16-bit: a consumer warpgroup and a producer warp; f32: two consumer
        # warpgroups of 64 query rows each and a splitter warpgroup
        [
            (torch.bfloat16, "wgmma", 128 + 32, 64),
            (torch.float32, "tf32x3", 2 * 128 + 128, 128),
            (torch.float16, "wgmma", 128 + 32, 64),
        ],
        ids=str,
    )
    def test_main_path_shape(self, dtype, path, threads, block_q):
        plan = attention.launch_plan((64, 12, 257, 64), dtype)
        assert plan.path == path
        assert plan.block_q == block_q
        assert plan.q_tiles == -(-257 // block_q)
        assert plan.grid == 64 * 12 * plan.q_tiles
        assert plan.threads == threads
        assert (plan.dp, plan.ld) == (64, 64)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
    def test_vit_h14_shape(self, dtype):
        """ViT-H/14's head dim 80 runs the 16-bit path at Dp = 128, with no
        padding in memory (80 x 2 B rows are 16-byte multiples)."""
        plan = attention.launch_plan((64, 16, 257, 80), dtype)
        assert (plan.path, plan.dp, plan.ld) == ("wgmma", 128, 80)
        assert plan.grid == 64 * 16 * 5

    @pytest.mark.parametrize("shape", SHAPES, ids=str)
    @pytest.mark.parametrize("dtype", ALL_DTYPES, ids=str)
    def test_tiles_cover_every_row_once(self, shape, dtype):
        B, H, N, _ = shape
        plan = attention.launch_plan(shape, dtype)
        assert plan.block_q % (attention.BLOCK_Q if plan.path != "wide" else 16) == 0
        assert plan.q_tiles == -(-N // plan.block_q)
        assert (plan.q_tiles - 1) * plan.block_q < N <= plan.q_tiles * plan.block_q
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

    # 16-bit: Q and a 2-stage ring of K and V, 8 KB boxes, Dp / 64 of them a
    # tile (Dp = 32 pads its box); f32: Q big and small for each consumer (2,
    # 1 at Dp = 128), a landing ring of f32 K and V (2 deep at Dp = 32, else
    # 1), a 2-deep working ring of K big and small and V^T big and small (key
    # tiles of 32 rows at Dp = 128); both + 128 B of barriers + 1 KB to
    # align. Wide: Q and O of 16 rows x Dp f32, a 64 x 65 f32 chunk and P
    # (16 x 64), Dp = d rounded up to 64
    SMEM_BYTES = {
        (torch.bfloat16, 32): 5 * 8192 + 1152,
        (torch.bfloat16, 64): 5 * 8192 + 1152,
        (torch.bfloat16, 128): 10 * 8192 + 1152,
        (torch.bfloat16, 192): 15 * 8192 + 1152,
        (torch.bfloat16, 256): 20 * 8192 + 1152,
        (torch.float16, 32): 5 * 8192 + 1152,
        (torch.float16, 64): 5 * 8192 + 1152,
        (torch.float16, 128): 10 * 8192 + 1152,
        (torch.float16, 192): 15 * 8192 + 1152,
        (torch.float16, 256): 20 * 8192 + 1152,
        (torch.float32, 32): 2 * 2 * 8192 + (4 + 8) * 8192 + 1152,
        (torch.float32, 64): 2 * 2 * 16384 + (2 + 8) * 16384 + 1152,
        (torch.float32, 128): 2 * 32768 + (2 + 8) * 16384 + 1152,
        # the wide path at d = 192 (f32 only), 320, 512 and its cap
        (torch.float32, 192): 4 * (2 * 16 * 192 + 64 * 65 + 16 * 64),
        (torch.float32, 320): 4 * (2 * 16 * 320 + 64 * 65 + 16 * 64),
        (torch.bfloat16, 512): 4 * (2 * 16 * 512 + 64 * 65 + 16 * 64),
        (torch.float16, 1024): 4 * (2 * 16 * 1024 + 64 * 65 + 16 * 64),
    }

    @pytest.mark.parametrize("dtype, d", list(SMEM_BYTES), ids=str)
    def test_shared_memory_fits_a_block(self, dtype, d):
        """Every padded width of both tensor-core paths, and the wide path
        up to its cap."""
        plan = attention.launch_plan((1, 1, 257, d), dtype)
        assert plan.dp == d
        assert plan.smem_bytes == self.SMEM_BYTES[(dtype, d)]
        assert 0 < plan.smem_bytes <= 232_448  # 227 KB, an H100 block's most

    @pytest.mark.parametrize("dtype", ALL_DTYPES, ids=str)
    def test_every_head_dim_has_a_padded_width(self, dtype):
        """d = 1 .. the cap: Dp is the least width of the path's set (or the
        next 64 columns on the wide path) that holds d, and the row pitch in
        memory is a multiple of 16 bytes on the TMA paths, d on the wide."""
        itemsize = torch.empty((), dtype=dtype).element_size()
        for d in range(1, attention.MAX_HEAD_DIM + 1):
            plan = attention.launch_plan((1, 1, 8, d), dtype)
            if plan.path == "wide":
                assert (plan.dp, plan.ld) == (-(-d // 64) * 64, d)
                continue
            widths = attention.TF32X3_WIDTHS if plan.path == "tf32x3" else attention.WGMMA_WIDTHS
            assert plan.dp == min(w for w in widths if w >= d)
            assert d <= plan.ld <= plan.dp and (plan.ld * itemsize) % 16 == 0
            assert plan.ld - d < 16 // itemsize

    @pytest.mark.parametrize("dtype", ALL_DTYPES, ids=str)
    def test_plans_name_the_kernels_the_source_instantiates(self, dtype):
        """Each plan names one of ``kernel_instantiations``, the one of its
        path, type and Dp; d = 1 .. the cap reaches every one of the type's."""
        code = attention._DTYPE_CODES[dtype]
        named = set()
        for d in range(1, attention.MAX_HEAD_DIM + 1):
            plan = attention.launch_plan((1, 1, 8, d), dtype)
            args = f"{code}" if plan.path == "wide" else f"{code},{plan.dp}"
            if plan.path == "tf32x3":
                args = f"{plan.dp}"
            assert plan.kernel == f"flash_attn_{plan.path}_kernel<{args}>"
            named.add(plan.kernel)
        every = attention.kernel_instantiations()
        assert len(set(every)) == len(every) == 2 * 5 + 3 + 3
        # the path's widths and the wide kernel; the three types' sets are
        # disjoint (their codes differ), so together they are all 16
        widths = attention.TF32X3_WIDTHS if dtype == torch.float32 else attention.WGMMA_WIDTHS
        assert named <= set(every) and len(named) == len(widths) + 1

    @pytest.mark.parametrize(
        "dtype, path, widest",
        [
            (torch.float32, "tf32x3", 128),
            (torch.bfloat16, "wgmma", 256),
            (torch.float16, "wgmma", 256),
        ],
        ids=["torch.float32-tf32x3", "torch.bfloat16-wgmma", "torch.float16-wgmma"],
    )
    def test_path_follows_dtype(self, dtype, path, widest):
        """The tensor-core path of the dtype up to its widest Dp, the wide
        path above it."""
        for d in range(1, attention.MAX_HEAD_DIM + 1):
            want = path if d <= widest else "wide"
            assert attention.launch_plan((2, 3, 257, d), dtype).path == want

    @pytest.mark.parametrize(
        "shape, dtype, error",
        [
            ((1, 1, 64, 64), torch.float64, TypeError),
            ((1, 1, 64, 64), torch.int32, TypeError),
            ((1, 1, 64, 1025), torch.float32, ValueError),
            ((1, 1, 64, 4096), torch.bfloat16, ValueError),
            ((1, 1, 64, 0), torch.float16, ValueError),
            ((1, 1, 0, 64), torch.bfloat16, ValueError),
        ],
        ids=["f64", "int32", "d1025", "d4096", "d0", "n0"],
    )
    def test_refuses_what_the_kernel_does_not_take(self, shape, dtype, error):
        with pytest.raises(error):
            attention.launch_plan(shape, dtype)

    def test_cap_is_named_in_the_error(self):
        with pytest.raises(ValueError, match=str(attention.MAX_HEAD_DIM)):
            attention.launch_plan((1, 1, 8, attention.MAX_HEAD_DIM + 1), torch.float32)


class TestWgmmaEmulation:
    """A plain emulation of the 16-bit path's tiling and rounding (64 x 64
    tiles, exp2 with the folded scale, P rounded to the input's type before
    P V, l in f32) against the JAX kernel in bf16 and f16, at the JAX suite's
    bf16 tolerance and this file's f16 one."""

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

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("n", [129, 257])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
    def test_last_query_tile_of_one_row(self, dtype, n, causal):
        """n = 129 and 257: a head's last 64-row query tile holds one real
        row; against the JAX kernel in the same dtype."""
        arrays = _inputs(30 + n, (2, 3, n, 64))
        ref = _run_jax(arrays, JAX_DTYPES[dtype], causal=causal)
        q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
        out = emulate_wgmma_attention(q, k, v, causal)
        assert out.dtype == dtype
        np.testing.assert_allclose(out.float().numpy(), ref, atol=TOLERANCE[dtype][0])

    @pytest.mark.parametrize("n", [1, 64, 65])
    def test_tile_edges_match_the_plain_version(self, n):
        arrays = _inputs(11, (1, 2, n, 64))
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
        np.testing.assert_allclose(
            emulate_wgmma_attention(q, k, v).float().numpy(),
            attention.reference_attention(q, k, v).float().numpy(),
            atol=2e-2,
        )

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("d", [w for w in WIDTHS if w <= 256])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
    def test_matches_jax_at_padded_widths(self, dtype, d, causal):
        """The path's rounding in bf16 and in f16 at the head dims it runs at
        a padded width (zero columns add nothing; the scale is the true
        d^-1/2), against the JAX kernel in the same dtype."""
        arrays, ref = _width_case(dtype, d, causal)
        q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
        out = emulate_wgmma_attention(q, k, v, causal)
        assert out.dtype == dtype
        np.testing.assert_allclose(out.float().numpy(), ref, atol=TOLERANCE[dtype][0])


class TestTf32x3Emulation:
    """A plain emulation of the f32 path's arithmetic (3xTF32 products from
    tf32 halves rounded by cvt.rna, q scaled before its split, 64-row query
    tiles, key tiles trimmed to 8-key blocks, exp, P split before P V)
    against the JAX kernel in f32, at the JAX suite's f32 tolerance."""

    @pytest.mark.parametrize(
        "shape, causal",
        [
            ((2, 3, 128, 64), False),
            ((2, 3, 200, 64), False),
            ((2, 3, 257, 64), False),
            ((1, 2, 200, 32), True),
            ((2, 4, 190, 128), False),
            ((1, 2, 1, 64), False),
            ((1, 2, 64, 64), False),
            ((1, 2, 65, 64), False),
            ((1, 2, 300, 64), False),
        ],
        ids=["n128", "n200", "n257", "causal_d32", "d128", "n1", "n64", "n65", "n300"],
    )
    def test_matches_jax_f32(self, shape, causal):
        arrays = _inputs(12, shape)
        ref = _run_jax(arrays, causal=causal)
        out = emulate_tf32x3_attention(*(torch.from_numpy(a) for a in arrays), causal)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("d", [w for w in WIDTHS if w <= 128])
    def test_matches_jax_at_padded_widths(self, d, causal):
        """The path at the head dims it runs at a padded width (Dp 32, 64 or
        128, key tiles of 32 rows at 128)."""
        arrays, ref = _width_case(torch.float32, d, causal)
        out = emulate_tf32x3_attention(*(torch.from_numpy(a) for a in arrays), causal)
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)

    def test_one_tf32_pass_is_outside_the_tolerance(self):
        """The negative control: big·big alone misses 2e-5, so the test
        above can fail."""
        arrays = _inputs(12, (2, 3, 257, 64))
        ref = _run_jax(arrays)
        tensors = [torch.from_numpy(a) for a in arrays]
        one_pass = emulate_tf32x3_attention(*tensors, passes=1).numpy()
        three = emulate_tf32x3_attention(*tensors).numpy()
        assert not np.allclose(one_pass, ref, atol=2e-5, rtol=2e-5)
        assert np.abs(one_pass - ref).max() > 10 * np.abs(three - ref).max()


class TestTf32Rounding:
    """``tf32_round`` is cvt.rna.tf32.f32: nearest, ties away from zero."""

    def test_exact_values_stay(self):
        x = torch.tensor([0.0, -0.0, 1.0, -3.0, 0.5, 1 + 2**-10, 2.0**-126, -(2.0**100)])
        assert torch.equal(tf32_round(x).view(torch.int32), x.view(torch.int32))

    @pytest.mark.parametrize("sign", [1.0, -1.0])
    def test_ties_round_away_from_zero(self, sign):
        x = torch.tensor([1 + 2**-11, 1 + 3 * 2**-11, 1 + 2**-11 - 2**-23]) * sign
        expected = torch.tensor([1 + 2**-10, 1 + 2 * 2**-10, 1.0]) * sign
        np.testing.assert_array_equal(tf32_round(x).numpy(), expected.numpy())

    def test_inf_and_nan_pass_through(self):
        x = torch.tensor([float("inf"), float("-inf"), float("nan")])
        out = tf32_round(x)
        assert out[0] == float("inf") and out[1] == float("-inf")
        assert torch.isnan(out[2])

    def test_split_holds_x_to_2_pow_minus_22(self):
        x = torch.from_numpy(np.random.default_rng(13).standard_normal(4096, np.float32))
        big, small = split_tf32(x)
        for half in (big, small):
            assert not (half.view(torch.int32) & 0x1FFF).any()
        assert (torch.abs(x - big) <= 2.0**-11 * torch.abs(x)).all()
        assert (torch.abs(x - big - small) <= 2.0**-22 * torch.abs(x)).all()
