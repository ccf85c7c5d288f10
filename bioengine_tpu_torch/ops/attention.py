"""Fused flash-attention forward: the hand-written CUDA kernel and its
plain PyTorch version.

Counterpart of ``bioengine_tpu/ops/pallas/attention.py``. On a CUDA tensor
``flash_attention`` launches ``csrc/flash_attn_fwd.cu`` (f32 or bf16, head
dim 32, 64 or 128) or raises; on a CPU tensor it computes
``reference_attention``. The backward recomputes through
``reference_attention``, as the JAX custom VJP does; a fused backward kernel
is later work.

The kernel has two paths, chosen by dtype (``launch_plan``), both on the
tensor cores with tiles loaded by TMA: bf16 (``wgmma``) runs both products
in bf16; f32 (``tf32x3``) runs each product as 3xTF32 (big and small tf32
halves of each operand, big·big + big·small + small·big summed in f32), which
holds f32 inputs within the JAX suite's 2e-5 of the f32 reference; a
splitter warpgroup splits K and V while two consumer warpgroups (one at
d = 128) compute, so an f32 block covers 128 query rows. The
kernel takes contiguous (B*H, N, d) rows at 16-byte-aligned addresses, so the
wrapper makes q, k and v so (a no-op for the ViT, which lays them out so).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from bioengine_tpu_torch.ops import _build

NEG_INF = -1e30

KERNEL_NAME = "flash_attn_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)

# Launch geometry, as csrc/flash_attn_fwd.cu has it
BLOCK_Q = 64  # query rows per block (and key rows per tile of the bf16 path)
PATHS = {torch.float32: "tf32x3", torch.bfloat16: "wgmma"}
_PATH_CODES = {"tf32x3": 0, "wgmma": 1}
_WGMMA_THREADS = 128 + 32  # one consumer warpgroup + one producer warp
_WGMMA_STAGES = 2  # depth of the K/V ring in shared memory
_TF32X3_WORK_STAGES = 2  # depth of the ring of split K and V^T tiles
_WGMMA_BOX_BYTES = 64 * 64 * 2  # one 64-row x 64-column bf16 TMA box
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

    path: str  # "wgmma" (bf16) or "tf32x3" (f32), both on the tensor cores
    q_tiles: int  # query tiles of ``block_q`` rows per (batch, head)
    grid: int  # blocks, one per (batch * head, query tile)
    threads: int  # per block
    smem_bytes: int  # dynamic shared memory per block
    block_q: int  # query rows per block: 64 per consumer warpgroup

    def block_tile(self, block: int) -> tuple[int, int]:
        """(batch * head, query tile) of a block: the tiles of one head are
        adjacent in launch order, so they share its K and V through L2."""
        return divmod(block, self.q_tiles)


def _check_kernel_input(dtype: torch.dtype, d: int) -> None:
    if dtype not in PATHS:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16, got {dtype}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel takes head dim in {HEAD_DIMS}, got {d}"
        )


def launch_plan(shape, dtype: torch.dtype) -> LaunchPlan:
    """The launch plan for q, k, v of ``shape`` (B, H, N, d) in ``dtype``.
    Raises TypeError or ValueError for what the kernel does not take."""
    B, H, N, d = shape
    _check_kernel_input(dtype, d)
    if B * H < 1 or N < 1:
        raise ValueError(
            f"flash_attention kernel takes a non-empty shape, got {tuple(shape)}"
        )
    path = PATHS[dtype]
    if path == "wgmma":
        # Q, then a ring of K and V tiles, each tile one box per 64 columns
        # (d = 32 pads its box to 64), then the barriers and 1 KB to align
        boxes = (1 + 2 * _WGMMA_STAGES) * max(1, d // 64)
        threads, smem = _WGMMA_THREADS, boxes * _WGMMA_BOX_BYTES + 128 + 1024
        block_q = BLOCK_Q
    else:
        # f32: each consumer's Q big and small, the landing ring of f32 K and
        # V tiles, the working ring of K big and small and V^T big and small,
        # 4 B each; a splitter warpgroup beside the consumers
        consumers = tf32x3_consumers(d)
        tile = tf32x3_block_k(d) * d
        stages = 2 * tf32x3_land_stages(d) + 4 * _TF32X3_WORK_STAGES
        smem = 4 * (2 * consumers * BLOCK_Q * d + stages * tile) + 128 + 1024
        threads, block_q = 128 * (consumers + 1), consumers * BLOCK_Q
    q_tiles = -(-N // block_q)
    grid = B * H * q_tiles
    if grid > _MAX_GRID:
        raise ValueError(f"{grid} blocks exceed the grid's {_MAX_GRID}")
    return LaunchPlan(path, q_tiles, grid, threads, smem, block_q)


# The f32 (``tf32x3``) path's geometry per head dim, so that its shared
# memory fits a block: consumer warpgroups of 64 query rows each, key rows
# per tile, and f32 K/V tiles the TMA keeps in flight.


def tf32x3_consumers(d: int) -> int:
    return 1 if d == 128 else 2


def tf32x3_block_k(d: int) -> int:
    return 32 if d == 128 else 64


def tf32x3_land_stages(d: int) -> int:
    return 2 if d == 32 else 1


def load_kernel():
    """The kernel's library and entry point, loaded from the compile cache
    (built there first if missing)."""
    lib = _build.load(KERNEL_NAME)
    fn = lib.flash_attn_fwd
    if not fn.argtypes:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib, fn


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, contiguous at a 16-byte-aligned address (TMA's rule, both paths)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    global launch_count
    _check_kernel_input(q.dtype, q.shape[-1])
    if q.numel() == 0:
        return torch.empty_like(q)
    B, H, N, d = q.shape
    plan = launch_plan(q.shape, q.dtype)
    q, k, v = (_aligned(x) for x in (q, k, v))
    out = torch.empty_like(q)
    lib, fn = load_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * H, N, d, d**-0.5, int(causal), _DTYPE_CODES[q.dtype],
            _PATH_CODES[plan.path], plan.q_tiles, plan.grid, plan.threads,
            plan.smem_bytes, stream,
        )
    if err != 0:
        msg = lib.flash_attn_error_string(err).decode()
        raise RuntimeError(f"flash_attn_fwd launch failed: {msg} ({err})")
    launch_count += 1
    return out


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
