"""Shared inputs and emulations for the PyTorch port's parity tests."""

import contextlib
import math
import os
import secrets

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioengine_tpu.runtime import convert as jax_convert


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Hold PyTorch to 2 CPU threads while a module runs: the suite runs
    files side by side in several worker processes, and timing-bound tests
    in other files share the cores. Import it into a test module to use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def private_rpc_store():
    """Point the RPC servers started inside at a shared-memory segment of
    their own (``BIOENGINE_RPC_STORE_NAME``, named for this process and
    call) in place of the host-wide default ``bioengine-rpc``, and unlink
    the segment on the way out, so that runs side by side never share or
    evict each other's objects and none outlives its test."""
    name = f"bioengine-rpc-test-{os.getpid()}-{secrets.token_hex(4)}"
    before = os.environ.get("BIOENGINE_RPC_STORE_NAME")
    os.environ["BIOENGINE_RPC_STORE_NAME"] = name
    try:
        yield name
    finally:
        if before is None:
            os.environ.pop("BIOENGINE_RPC_STORE_NAME", None)
        else:
            os.environ["BIOENGINE_RPC_STORE_NAME"] = before
        with contextlib.suppress(FileNotFoundError):
            os.unlink(f"/dev/shm/{name}")


def retry_jax_store_load(store) -> None:
    """Clear a cached failure of the JAX package's native store
    (``bioengine_tpu.native.store``) once its library is on disk. That
    module caches its first attempt, and its ``make`` writes the library in
    place: in a fresh checkout a test worker that loads it half-written
    keeps the failure for every later test it runs. The port's own store
    builds under a lock and is not retried here."""
    if store._lib_tried and store._lib is None and store._LIB_PATH.exists():
        store._lib_tried = False


def seeded_flax_params(model, image_shape, seed=0):
    """Params for a flax ``model`` drawn from ``np.random.default_rng(seed)``
    in the tree ``model.init`` would build (shaped by ``jax.eval_shape``, so
    nothing is compiled): kernels ~ N(0, 1/fan_in), every other leaf ~
    N(base, 0.02) with base 1 for norm scales and LayerScales, else 0."""
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros(image_shape, jnp.float32)
    )["params"]
    flat = jax_convert.flatten_params(
        jax.tree.map(lambda s: np.empty(s.shape, np.float32), shapes)
    )
    rng = np.random.default_rng(seed)
    out = {}
    for key, arr in sorted(flat.items()):
        if key.endswith("kernel"):
            std, base = 1.0 / np.sqrt(np.prod(arr.shape[:-1])), 0.0
        else:
            std = 0.02
            base = 1.0 if key.endswith(("scale", "ls1", "ls2")) else 0.0
        out[key] = (base + std * rng.normal(size=arr.shape)).astype(np.float32)
    return jax_convert.unflatten_params(out)


def emulate_wgmma_attention(q, k, v, causal=False, block=64):
    """Plain PyTorch emulation of the rounding of the 16-bit (wgmma) path of
    ``bioengine_tpu_torch/csrc/flash_attn_fwd.cu``, for CPU tests, in q's
    dtype (bfloat16 or float16): 64 x 64 tiles; S = Q K^T as f32 sums of
    16-bit products (the zero columns up to the padded width add nothing);
    a running max in log2 units with log2(e) d^-1/2 of the true d folded
    into one multiplier and ``exp2``; l summed in f32 from the unrounded P;
    P rounded to the 16-bit type before P V; O / l rounded once to it.
    q, k, v: (B, H, N, d) -> (B, H, N, d) in q's dtype."""
    n, d = q.shape[2], q.shape[3]
    half = q.dtype if q.dtype in (torch.bfloat16, torch.float16) else torch.bfloat16
    qf, kf, vf = (x.to(half).float() for x in (q, k, v))
    c = d**-0.5 * math.log2(math.e)
    out = torch.empty(qf.shape)
    for q0 in range(0, n, block):
        rows = torch.arange(q0, min(q0 + block, n))
        qt = qf[:, :, q0 : q0 + block]
        m = torch.full(qt.shape[:-1], -1e30)
        l = torch.zeros(qt.shape[:-1])
        o = torch.zeros(qt.shape)
        for k0 in range(0, min(n, q0 + block) if causal else n, block):
            cols = torch.arange(k0, min(k0 + block, n))
            keep = cols[None, :] <= rows[:, None] if causal else torch.ones(
                len(rows), len(cols), dtype=torch.bool
            )
            s = (qt @ kf[:, :, k0 : k0 + block].transpose(-2, -1)).masked_fill(
                ~keep, -1e30
            )
            m_new = torch.maximum(m, s.amax(-1) * c)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * c - m_new[..., None]).masked_fill(~keep, 0.0)
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + p.to(half).float() @ vf[
                :, :, k0 : k0 + block
            ]
            m = m_new
        safe_l = torch.where(l == 0, 1.0, l)[..., None]
        out[:, :, q0 : q0 + block] = torch.where(l[..., None] == 0, 0.0, o / safe_l)
    return out.to(half)


def tf32_round(x):
    """x (float32) rounded to tf32 as ``cvt.rna.tf32.f32`` does: to the
    nearest value with 10 mantissa bits, ties away from zero, the low 13 bits
    zero; inf and nan pass through. Bit operations on the int32 view, the
    same two the kernel's ``tf32_rna`` does for every finite x and inf."""
    bits = x.contiguous().view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    # adding half an ulp to the magnitude's bits rounds it half up; the sign
    # bit is left alone, so ties go away from zero
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(special, bits, rounded).view(torch.float32)


def split_tf32(x):
    """(big, small): big = tf32(x), small = tf32(x - big); x - big is exact."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def _product_3xtf32(a, b, passes=3):
    """a @ b from tf32 halves: small(a) big(b) + big(a) small(b) + big(a)
    big(b) summed in f32, small terms first; ``passes=1`` is big(a) big(b)
    alone (one TF32 pass)."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    if passes == 1:
        return a_big @ b_big
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def emulate_tf32x3_attention(q, k, v, causal=False, passes=3):
    """Plain PyTorch emulation of the f32 (tf32x3) path of
    ``bioengine_tpu_torch/csrc/flash_attn_fwd.cu``, for CPU tests: q scaled
    by d^-1/2 before its split; 64-row query tiles and key tiles of 64 rows
    (32 at Dp = 128), rows past n zero as TMA fills them; both products as
    3xTF32 (``passes=1``: one TF32 pass, big·big alone); the
    online softmax in f32 with ``exp``; P split before P V; O / l once.
    Key tiles follow the padded width: 32 rows for d above 64 (Dp = 128).
    q, k, v: (B, H, N, d) float32 -> (B, H, N, d) float32."""
    n, d = q.shape[2], q.shape[3]
    block_k = 32 if d > 64 else 64
    qs = q.float() * d**-0.5
    kf, vf = k.float(), v.float()
    out = torch.empty(qs.shape)
    for q0 in range(0, n, 64):
        rows = torch.arange(q0, min(q0 + 64, n))
        qt = qs[:, :, q0 : q0 + 64]
        m = torch.full(qt.shape[:-1], -1e30)
        l = torch.zeros(qt.shape[:-1])
        o = torch.zeros(qt.shape)
        kv_len = min(n, q0 + 64) if causal else n
        for k0 in range(0, kv_len, block_k):
            k1 = k0 + block_k
            cols = torch.arange(k0, k1)
            keep = cols[None, :] < n
            if causal:
                keep = keep & (cols[None, :] <= rows[:, None])
            kt, vt = kf[:, :, k0:k1], vf[:, :, k0:k1]
            if k1 > n:  # TMA fills rows past n with zeros
                pad = (0, 0, 0, k1 - n)
                kt, vt = torch.nn.functional.pad(kt, pad), torch.nn.functional.pad(vt, pad)
            s = _product_3xtf32(qt, kt.transpose(-2, -1), passes).masked_fill(~keep, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None]).masked_fill(~keep, 0.0)
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + _product_3xtf32(p, vt, passes)
            m = m_new
        safe_l = torch.where(l == 0, 1.0, l)[..., None]
        out[:, :, q0 : q0 + 64] = torch.where(l[..., None] == 0, 0.0, o / safe_l)
    return out
