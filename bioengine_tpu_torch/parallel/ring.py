"""Ring attention: sequence/context parallelism over the mesh.

Counterpart of ``bioengine_tpu/parallel/ring.py``. The token axis is split
over the ``sp`` mesh axis. Each entry keeps its query block; the K/V
blocks pass to the next entry around the ring n - 1 times (explicit
device-to-device copies), while a streaming-softmax accumulator (running
max, normalizer, weighted sum: the flash-attention recurrence, in f32)
folds in one block per step. The last block is folded after the loop,
and the result is cast back to q's dtype.

These are plain blockwise products, as in the JAX module: no kernel of
the port and no library attention call. One process drives the entries,
in mesh order.
"""

from __future__ import annotations

import torch

from bioengine_tpu_torch.parallel.data_parallel import Shards
from bioengine_tpu_torch.parallel.mesh import Mesh


def _block_attn(q, k, v, m_prev, l_prev, o_prev, scale):
    """One streaming-softmax update. q/k/v: (B, H, Nq, d)/(B, H, Nk, d)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale          # (B,H,Nq,Nk)
    m_cur = s.amax(dim=-1)                                      # (B,H,Nq)
    m_new = torch.maximum(m_prev, m_cur)
    p = torch.exp(s - m_new[..., None])
    l_new = l_prev * torch.exp(m_prev - m_new) + p.sum(-1)
    o_new = o_prev * torch.exp(m_prev - m_new)[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p, v
    )
    return m_new, l_new, o_new


def ring_attention(q: Shards, k: Shards, v: Shards) -> list[torch.Tensor]:
    """Exact attention with q, k and v split on the token axis over one
    mesh axis: each a ``Shards`` of (B, H, N_local, d) blocks, one per
    entry of a ring (a mesh of that one axis). Returns the output blocks
    (B, H, N_local, d), one per entry on its device. Non-causal
    (bidirectional: image and embedding workloads)."""
    n = len(q)
    devices = [blk.device for blk in q]
    scale = q[0].shape[-1] ** -0.5
    qf = [blk.float() for blk in q]
    m = [torch.full(blk.shape[:3], -torch.inf, dtype=torch.float32, device=blk.device) for blk in q]
    l = [torch.zeros(blk.shape[:3], dtype=torch.float32, device=blk.device) for blk in q]
    o = [torch.zeros(blk.shape, dtype=torch.float32, device=blk.device) for blk in q]
    kv = list(zip(k, v))

    def fold(i, k_blk, v_blk):
        m[i], l[i], o[i] = _block_attn(qf[i], k_blk.float(), v_blk.float(), m[i], l[i], o[i], scale)

    # n - 1 fold+rotate steps, then the final block folded outside the
    # loop: one K/V hop fewer per attention call
    for _ in range(n - 1):
        for i in range(n):
            fold(i, *kv[i])
        # entry j's K/V move one hop, to entry j + 1
        kv = [tuple(t.to(devices[i]) for t in kv[(i - 1) % n]) for i in range(n)]
    for i in range(n):
        fold(i, *kv[i])
    return [(o[i] / l[i][..., None]).to(q[i].dtype) for i in range(n)]


def make_ring_attention(mesh: Mesh, axis: str = "sp"):
    """Full-sequence attention with tokens split over ``axis``:
    (B, H, N, d) x3 -> (B, H, N, d), on q's device. N must divide by the
    axis size.

    Drop-in for ``bioengine_tpu_torch.models.vit.Attention(attn_fn=...)``
    when a replica owns several devices and sequences exceed one. Over a
    mesh of several axes the first ring along ``axis`` runs it."""
    ring = mesh.groups(axis)[0]
    devices = [mesh.devices[e] for e in ring]
    ring_mesh = Mesh((axis,), (len(ring),), tuple(devices))

    def fn(q, k, v):
        n = len(devices)
        if q.shape[2] % n:
            raise ValueError(f"{q.shape[2]} tokens do not split over {axis}={n}")
        blocks = [
            Shards([p.to(d) for p, d in zip(t.chunk(n, dim=2), devices)], ring_mesh, axis, 2)
            for t in (q, k, v)
        ]
        out = ring_attention(*blocks)
        return torch.cat([blk.to(q.device) for blk in out], dim=2)

    return fn


def reference_attention(q, k, v):
    """Unsharded reference for tests: same math, one device."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
