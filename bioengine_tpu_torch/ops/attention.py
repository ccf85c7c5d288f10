"""Fused flash-attention forward: the hand-written CUDA kernel and its
plain PyTorch version.

Counterpart of ``bioengine_tpu/ops/pallas/attention.py``. On a CUDA tensor
``flash_attention`` launches ``csrc/flash_attn_fwd.cu`` or raises; on a CPU
tensor it computes ``reference_attention``. Like the Pallas kernel it takes
float32, bfloat16 and float16 at any head dim d, up to ``MAX_HEAD_DIM``
(the wide path's shared memory; the Pallas kernel's own limit is its VMEM
scratch), and any N, causal or not; other dtypes raise. The backward
recomputes through ``reference_attention``, as the JAX custom VJP does; a
fused backward kernel is later work.

The kernel has three paths, chosen by dtype and d (``launch_plan``):
- ``wgmma`` (bf16 and f16, d <= 256): both products on the tensor cores in
  the input's type, tiles loaded by TMA, at a padded width Dp in
  ``WGMMA_WIDTHS``;
- ``tf32x3`` (f32, d <= 128): each product as 3xTF32 (big and small tf32
  halves of each operand, big·big + big·small + small·big summed in f32),
  which holds f32 inputs within the JAX suite's 2e-5 of the f32 reference;
  a splitter warpgroup splits K and V while two consumer warpgroups (one at
  Dp = 128) compute, so an f32 block covers 128 query rows; Dp in
  ``TF32X3_WIDTHS``;
- ``wide`` (f32 above 128, 16-bit above 256): exact f32 FMA on the CUDA
  cores, K and V streamed through shared memory in column chunks.
The tensor-core paths compute Dp columns, the ones past d read as zeros
(TMA's fill), as the Pallas kernel pads d to 128. TMA wants a row pitch of
16-byte multiples, so for a d whose rows are not (d = 100 in bf16, say) the
wrapper pads q, k and v with zero columns to ``plan.ld`` and slices the
output, as the Pallas kernel's ``_pad_to`` pads. The kernel takes
contiguous (B*H, N, ld) rows at 16-byte-aligned addresses, so the wrapper
makes q, k and v so (a no-op for the ViT, which lays them out so).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from bioengine_tpu_torch.ops import _build

NEG_INF = -1e30

KERNEL_NAME = "flash_attn_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Launch geometry, as csrc/flash_attn_fwd.cu has it
BLOCK_Q = 64  # query rows per consumer warpgroup (and key rows per wgmma tile)
WGMMA_WIDTHS = (32, 64, 128, 192, 256)  # padded widths Dp of the 16-bit path
TF32X3_WIDTHS = (32, 64, 128)  # and of the f32 path
MAX_HEAD_DIM = 1024  # the wide path's cap: its Q and O rows live in shared memory
_PATH_CODES = {"tf32x3": 0, "wgmma": 1, "wide": 2}
_WGMMA_THREADS = 128 + 32  # one consumer warpgroup + one producer warp
_WGMMA_STAGES = 2  # depth of the K/V ring in shared memory
_TF32X3_WORK_STAGES = 2  # depth of the ring of split K and V^T tiles
_WGMMA_BOX_BYTES = 64 * 64 * 2  # one 64-row x 64-column 16-bit TMA box
_WIDE_BLOCK_Q = 16  # query rows per block of the wide path: 2 per warp
_WIDE_BLOCK_K = 64  # key rows per tile
_WIDE_COLS = 64  # K or V columns per shared chunk (rows of 65 floats)
_WIDE_THREADS = 256
_MAX_GRID = 2**31 - 1

# Kernel launches so far; chip_smoke.py resets and reads it.
launch_count = 0


def reference_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Plain attention in f32, output in q's dtype. q, k, v: (B, H, N, d)."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    scale = q.shape[-1] ** -0.5
    s = (qf * scale) @ kf.transpose(-2, -1)
    if causal:
        n = q.shape[2]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return (p @ vf).to(q.dtype)


@dataclass(frozen=True)
class LaunchPlan:
    """How ``flash_attn_fwd`` is launched for one call; the C entry point
    refuses any plan other than the one it computes itself."""

    path: str  # "wgmma" (16-bit), "tf32x3" (f32) or "wide" (CUDA cores)
    dp: int  # padded width the kernel computes (columns past d are zeros)
    ld: int  # row pitch of q, k, v and out in memory: d, or d padded for TMA
    q_tiles: int  # query tiles of ``block_q`` rows per (batch, head)
    grid: int  # blocks, one per (batch * head, query tile)
    threads: int  # per block
    smem_bytes: int  # dynamic shared memory per block
    block_q: int  # query rows per block: 64 per consumer warpgroup, 16 wide
    kernel: str  # the instantiation it launches, as ``kernel_instantiations`` names it

    def block_tile(self, block: int) -> tuple[int, int]:
        """(batch * head, query tile) of a block: the tiles of one head are
        adjacent in launch order, so they share its K and V through L2."""
        return divmod(block, self.q_tiles)


def _check_kernel_input(dtype: torch.dtype, d: int) -> None:
    if dtype not in _DTYPE_CODES:
        raise TypeError(
            f"flash_attention kernel takes float32, bfloat16 or float16, got {dtype}"
        )
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention kernel takes head dim 1 to {MAX_HEAD_DIM} (the "
            f"wide path's cap), got {d}"
        )


def _kernel(path: str, code: int, dp: int) -> str:
    """The template instance of csrc/flash_attn_fwd.cu a plan launches,
    named as nvcc's ``-Xptxas -v`` log names it once demangled to its
    integer arguments."""
    if path == "wgmma":
        return f"flash_attn_wgmma_kernel<{code},{dp}>"
    if path == "tf32x3":
        return f"flash_attn_tf32x3_kernel<{dp}>"
    return f"flash_attn_wide_kernel<{code}>"


def kernel_instantiations() -> list[str]:
    """Every kernel csrc/flash_attn_fwd.cu instantiates: the 16-bit path per
    (dtype code, Dp), the f32 path per Dp, the wide path per dtype code."""
    codes = _DTYPE_CODES
    return (
        [_kernel("wgmma", codes[t], dp)
         for t in (torch.bfloat16, torch.float16) for dp in WGMMA_WIDTHS]
        + [_kernel("tf32x3", codes[torch.float32], dp) for dp in TF32X3_WIDTHS]
        + [_kernel("wide", code, 0) for code in codes.values()]
    )


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def launch_plan(shape, dtype: torch.dtype) -> LaunchPlan:
    """The launch plan for q, k, v of ``shape`` (B, H, N, d) in ``dtype``.
    Raises TypeError or ValueError for what the kernel does not take."""
    B, H, N, d = shape
    _check_kernel_input(dtype, d)
    if B * H < 1 or N < 1:
        raise ValueError(
            f"flash_attention kernel takes a non-empty shape, got {tuple(shape)}"
        )
    if dtype == torch.float32 and d <= TF32X3_WIDTHS[-1]:
        # f32: each consumer's Q big and small, the landing ring of f32 K and
        # V tiles, the working ring of K big and small and V^T big and small,
        # 4 B each; a splitter warpgroup beside the consumers
        path, ld = "tf32x3", _round_up(d, 4)  # 16-byte rows
        dp = next(w for w in TF32X3_WIDTHS if w >= d)
        consumers = tf32x3_consumers(dp)
        tile = tf32x3_block_k(dp) * dp
        stages = 2 * tf32x3_land_stages(dp) + 4 * _TF32X3_WORK_STAGES
        smem = 4 * (2 * consumers * BLOCK_Q * dp + stages * tile) + 128 + 1024
        threads, block_q = 128 * (consumers + 1), consumers * BLOCK_Q
    elif dtype != torch.float32 and d <= WGMMA_WIDTHS[-1]:
        # 16-bit: Q, then a ring of K and V tiles, each tile one box per 64
        # columns (Dp = 32 pads its box to 64), then the barriers and 1 KB
        # to align
        path, ld = "wgmma", _round_up(d, 8)  # 16-byte rows
        dp = next(w for w in WGMMA_WIDTHS if w >= d)
        boxes = (1 + 2 * _WGMMA_STAGES) * max(1, dp // 64)
        threads, smem = _WGMMA_THREADS, boxes * _WGMMA_BOX_BYTES + 128 + 1024
        block_q = BLOCK_Q
    else:
        # the wide path: Q and O of 16 rows x Dp, one K or V chunk of 64 rows
        # of 65 floats, and P (16 x 64), all f32; plain loads at any pitch
        path, ld, dp = "wide", d, _round_up(d, _WIDE_COLS)
        threads, block_q = _WIDE_THREADS, _WIDE_BLOCK_Q
        smem = 4 * (
            2 * _WIDE_BLOCK_Q * dp
            + _WIDE_BLOCK_K * (_WIDE_COLS + 1)
            + _WIDE_BLOCK_Q * _WIDE_BLOCK_K
        )
    q_tiles = -(-N // block_q)
    grid = B * H * q_tiles
    if grid > _MAX_GRID:
        raise ValueError(f"{grid} blocks exceed the grid's {_MAX_GRID}")
    kernel = _kernel(path, _DTYPE_CODES[dtype], dp)
    return LaunchPlan(path, dp, ld, q_tiles, grid, threads, smem, block_q, kernel)


# The f32 (``tf32x3``) path's geometry per padded width, so that its shared
# memory fits a block: consumer warpgroups of 64 query rows each, key rows
# per tile, and f32 K/V tiles the TMA keeps in flight.


def tf32x3_consumers(dp: int) -> int:
    return 1 if dp == 128 else 2


def tf32x3_block_k(dp: int) -> int:
    return 32 if dp == 128 else 64


def tf32x3_land_stages(dp: int) -> int:
    return 2 if dp == 32 else 1


def load_kernel():
    """The kernel's library and entry point, loaded from the compile cache
    (built there first if missing)."""
    lib = _build.load(KERNEL_NAME)
    fn = lib.flash_attn_fwd
    if not fn.argtypes:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib, fn


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, contiguous at a 16-byte-aligned address (TMA's rule)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    global launch_count
    _check_kernel_input(q.dtype, q.shape[-1])
    if q.numel() == 0:
        return torch.empty_like(q)
    B, H, N, d = q.shape
    plan = launch_plan(q.shape, q.dtype)
    if plan.ld != d:
        # zero columns, which add nothing to q k^T and give zero columns of out
        q, k, v = (F.pad(x, (0, plan.ld - d)) for x in (q, k, v))
    q, k, v = (_aligned(x) for x in (q, k, v))
    out = torch.empty_like(q)
    lib, fn = load_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * H, N, d, plan.ld, plan.dp, d**-0.5, int(causal),
            _DTYPE_CODES[q.dtype], _PATH_CODES[plan.path], plan.q_tiles,
            plan.grid, plan.threads, plan.smem_bytes, stream,
        )
    if err != 0:
        msg = lib.flash_attn_error_string(err).decode()
        raise RuntimeError(f"flash_attn_fwd launch failed: {msg} ({err})")
    launch_count += 1
    return out if plan.ld == d else out[..., :d].contiguous()


def _forward(q, k, v, causal: bool) -> torch.Tensor:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            "flash_attention takes self-attention q, k, v of one shape "
            f"(B, H, N, d); got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"mixed devices {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = reference_attention(q, k, v, ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False
) -> torch.Tensor:
    """Fused attention. q, k, v: (B, H, N, d) -> (B, H, N, d) in q's dtype.
    Differentiable; the backward recomputes through ``reference_attention``."""
    return _FlashAttention.apply(q, k, v, causal)


def make_attn_fn(**kwargs):
    """Adapter for ``models.vit.Attention(attn_fn=...)``: (q, k, v) -> out."""

    def attn_fn(q, k, v):
        return flash_attention(q, k, v, **kwargs)

    return attn_fn
