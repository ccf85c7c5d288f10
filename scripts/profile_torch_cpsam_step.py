#!/usr/bin/env python3
"""Where a cpsam train step's time goes on one NVIDIA GPU.

Run from the root of a checkout on a machine with CUDA:
``python3 scripts/profile_torch_cpsam_step.py``. Builds the port's CpSAM at
the published ViT-L shape (patch 8, dim 1024, depth 24, 16 heads, window
14, global blocks 5/11/17/23; seeded weights, the rel-pos and position
tables drawn at 0.02) and, at the finetuning app's batch of 8 x 256^2 in
bf16, prints:

- the forward, forward + backward and full AdamW step times (CUDA events,
  mean of 10 after 3 warm-up);
- a ``torch.profiler`` breakdown of one step's device time by op and
  input shape, and the share of it spent on the attention's N x N tensors
  (the (B*heads, N, N) logits, their 5-D bias sum, casts and softmax, and
  the products that read or write them);
- one SAMAttention forward + backward at the windowed (72 windows of 14^2)
  and global (8 x 32^2) shapes, against the same function through
  ``F.scaled_dot_product_attention`` with the decomposed bias materialised
  as its mask (the library call; used nowhere in the port).

The last line is one JSON object of those numbers.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bioengine_tpu_torch.models.cellpose import TrainState, make_train_step  # noqa: E402
from bioengine_tpu_torch.models.sam import CpSAM, SAMAttention, _rel_pos_gather  # noqa: E402

BATCH, TILE = 8, 256
ITERS, WARMUP = 10, 3


def cuda_ms(fn) -> float:
    for _ in range(WARMUP):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def dev_us(e) -> float:
    return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))


def seeded(model: torch.nn.Module, seed: int = 0) -> None:
    model.reset_parameters(seed)
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "rel_pos" in name or "pos_embed" in name:
                p.copy_(torch.from_numpy(rng.normal(0, 0.02, p.shape).astype(np.float32)))


def sdpa_with_bias(attn: SAMAttention, x: torch.Tensor) -> torch.Tensor:
    """SAMAttention's function through SDPA, its decomposed bias
    materialised as a (B*heads, N, N) mask."""
    B, H, W, _ = x.shape
    nh, hd, dt = attn.num_heads, attn.dim // attn.num_heads, attn.dtype
    qkv = attn.qkv(x).reshape(B, H * W, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, B * nh, H * W, hd).unbind(0)
    Rh = _rel_pos_gather(H, H, attn.rel_pos_h).to(dt)
    Rw = _rel_pos_gather(W, W, attn.rel_pos_w).to(dt)
    q_r = q.reshape(B * nh, H, W, hd)
    bias = (torch.einsum("bhwc,hkc->bhwk", q_r, Rh)[:, :, :, :, None]
            + torch.einsum("bhwc,wkc->bhwk", q_r, Rw)[:, :, :, None, :])
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias.reshape(B * nh, H * W, H * W))
    return attn.proj(out.reshape(B, nh, H * W, hd).transpose(1, 2).reshape(B, H, W, attn.dim))


def attention_case(label: str, shape, table: int) -> dict:
    attn = SAMAttention(1024, 16, table).cuda()
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.03, p.shape).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda().bfloat16().requires_grad_()
    g = torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda().bfloat16()
    out = {}
    for name, fn in (("plain", attn), ("sdpa_mask", lambda t: sdpa_with_bias(attn, t))):
        def fwd_bwd(fn=fn):
            x.grad = None
            fn(x).backward(g)
        with torch.no_grad():
            out[f"{name}_fwd_ms"] = cuda_ms(lambda fn=fn: fn(x))
        out[f"{name}_fwd_bwd_ms"] = cuda_ms(fwd_bwd)
    with torch.no_grad():
        diff = (attn(x).float() - sdpa_with_bias(attn, x).float()).abs().max().item()
    out["sdpa_vs_plain_max_abs"] = diff
    print(f"SAMAttention {label} {tuple(shape)}: " + json.dumps(out))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_cpsam_step: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)

    model = CpSAM()
    seeded(model)
    model.cuda()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((BATCH, TILE, TILE, 3), np.float32)).cuda()
    flows = torch.from_numpy(rng.uniform(-1, 1, (BATCH, TILE, TILE, 2)).astype(np.float32)).cuda()
    cellprob = torch.from_numpy(rng.integers(0, 2, (BATCH, TILE, TILE)).astype(np.float32)).cuda()
    state = TrainState.create(model, 1e-4, 1e-5)
    step = make_train_step()

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        model(x).float().sum().backward()

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model(x))
    fwd_bwd_ms = cuda_ms(fwd_bwd)
    step_ms = cuda_ms(lambda: step(state, x, flows, cellprob))
    print(f"[{card}] cpsam ViT-L, {BATCH} x {TILE}^2, bf16: forward {fwd_ms:.3f} ms, forward + "
          f"backward {fwd_bwd_ms:.3f} ms, train step (AdamW) {step_ms:.3f} ms "
          f"(CUDA events, mean of {ITERS} after {WARMUP} warm-up)")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        step(state, x, flows, cellprob)
        torch.cuda.synchronize()
    averages = prof.key_averages(group_by_input_shape=True)
    ops = sorted((e for e in averages if e.key.startswith("aten::")), key=dev_us, reverse=True)
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy = sum(dev_us(e) for e in kernels)
    # an N x N tensor of the attention: the windowed (72*16, 196, 196) or
    # global (8*16, 1024, 1024) logits, in any view (3-D or 5-D)
    nn_sizes = {72 * 16 * 196 * 196, 8 * 16 * 1024 * 1024}

    def touches_nn(e) -> bool:
        return any(
            s and all(isinstance(d, int) for d in s) and int(np.prod(s)) in nn_sizes
            for s in e.input_shapes if isinstance(s, list)
        )

    nn_us = sum(dev_us(e) for e in ops if touches_nn(e))
    print(f"[{card}] profiler, one step: kernels busy {busy / 1e3:.3f} ms; ops on the attention's "
          f"N x N tensors {nn_us / 1e3:.3f} ms ({100 * nn_us / busy:.1f}%); top 20 (op, input shapes):")
    top = []
    for e in ops[:20]:
        shapes = [s for s in e.input_shapes if s][:3]
        print(f"[{card}]   {dev_us(e) / 1e3:9.3f} ms {100 * dev_us(e) / busy:5.1f}% x{e.count:<4} "
              f"{e.key} {shapes}{' N x N' if touches_nn(e) else ''}")
        top.append({"op": e.key, "shapes": shapes, "ms": dev_us(e) / 1e3, "count": e.count,
                    "nn": touches_nn(e)})
    del state, model
    torch.cuda.empty_cache()

    windowed = attention_case("windowed", (72, 14, 14, 1024), 14)
    global_ = attention_case("global", (8, 32, 32, 1024), 32)
    print(json.dumps({
        "card": card, "forward_ms": fwd_ms, "forward_backward_ms": fwd_bwd_ms, "step_ms": step_ms,
        "busy_ms": busy / 1e3, "nn_ms": nn_us / 1e3, "nn_share": nn_us / busy, "top": top,
        "attention_windowed": windowed, "attention_global": global_,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
