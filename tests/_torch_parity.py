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
    """Plain PyTorch emulation of the rounding of the bf16 (wgmma) path of
    ``bioengine_tpu_torch/csrc/flash_attn_fwd.cu``, for CPU tests: 64 x 64
    tiles; S = Q K^T as f32 sums of bf16 products; a running max in log2
    units with log2(e) d^-1/2 folded into one multiplier and ``exp2``; l
    summed in f32 from the unrounded P; P rounded to bf16 before P V; O / l
    rounded once to bf16. q, k, v: (B, H, N, d) -> (B, H, N, d) bf16."""
    n, d = q.shape[2], q.shape[3]
    qf, kf, vf = (x.to(torch.bfloat16).float() for x in (q, k, v))
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
            o = o * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[
                :, :, k0 : k0 + block
            ]
            m = m_new
        safe_l = torch.where(l == 0, 1.0, l)[..., None]
        out[:, :, q0 : q0 + block] = torch.where(l[..., None] == 0, 0.0, o / safe_l)
    return out.to(torch.bfloat16)
