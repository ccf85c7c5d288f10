"""Fused flash-attention forward: the hand-written CUDA kernel and its
plain PyTorch version.

Counterpart of ``bioengine_tpu/ops/pallas/attention.py``. On a CUDA tensor
``flash_attention`` launches ``csrc/flash_attn_fwd.cu`` (f32 or bf16, head
dim 32, 64 or 128) or raises; on a CPU tensor it computes
``reference_attention``. The backward recomputes through
``reference_attention``, as the JAX custom VJP does; a fused backward kernel
is later work.

The kernel takes contiguous (B*H, N, d) rows, so the wrapper makes q, k and v
contiguous (a no-op for the ViT, which lays them out so).
"""

from __future__ import annotations

import ctypes

import torch

from bioengine_tpu_torch.ops import _build

NEG_INF = -1e30

KERNEL_NAME = "flash_attn_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)

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


def _kernel():
    lib = _build.load(KERNEL_NAME)
    fn = lib.flash_attn_fwd
    if not fn.argtypes:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    global launch_count
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}"
        )
    B, H, N, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel takes head dim in {HEAD_DIMS}, got {d}"
        )
    q, k, v = (x.contiguous() for x in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib, fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * H, N, d, d**-0.5, int(causal), _DTYPE_CODES[q.dtype], stream,
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
