#!/usr/bin/env python3
"""Where a ViT-B/14 embedding bucket's time goes on one NVIDIA GPU.

Run from the root of a checkout on a machine with CUDA:
``python3 scripts/profile_torch_embed.py``. Builds the port's ViT-B/14
(224², bf16, flash-attention kernel, seeded weights) and prints, for one
bucket of 64 synthetic cell crops: the host's normalisation time, the
device forward time (CUDA events), and a ``torch.profiler`` breakdown of
device time by kernel over three forwards, with the kernels' share of the
forward's device time. The last line is one JSON object of those numbers.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bioengine_tpu_torch.apps.cell_image_search.ingestion import (  # noqa: E402
    extract_cell_crops,
    make_synthetic_images,
)
from bioengine_tpu_torch.apps.cell_image_search.normalizer import (  # noqa: E402
    to_model_input,
)
from bioengine_tpu_torch.models.vit import ViT  # noqa: E402
from bioengine_tpu_torch.ops.attention import make_attn_fn  # noqa: E402

BUCKET = 64
N_PROFILED = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_embed: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)

    crops = []
    for _, field in make_synthetic_images(n_images=8, size=896, seed=0):
        crops += extract_cell_crops(field, crop_size=224, n_crops=50)
    crops = (crops * (BUCKET // len(crops) + 1))[:BUCKET]
    t0 = time.perf_counter()
    batch = np.stack([to_model_input(c) for c in crops])
    host_prep_ms = (time.perf_counter() - t0) * 1e3

    model = ViT(attn_fn=make_attn_fn())
    model.reset_parameters(0)
    model = model.to("cuda").eval()
    x = torch.from_numpy(batch).to("cuda")
    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            model(x)
        end.record()
        torch.cuda.synchronize()
        forward_ms = start.elapsed_time(end) / 10

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(N_PROFILED):
                model(x)
            torch.cuda.synchronize()

    by_kernel: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type.name == "CUDA":
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + evt.device_time_total / 1e3
    busy_ms = sum(by_kernel.values()) / N_PROFILED
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    print(f"[{card}] bucket of {BUCKET}: host normalisation {host_prep_ms:.2f} ms, "
          f"device forward {forward_ms:.3f} ms (CUDA events, mean of 10)")
    # busy share: kernel time per profiled forward over the CUDA-event
    # forward time (the profiler's own start-up makes its wall clock useless)
    print(f"[{card}] profiled {N_PROFILED} forwards: kernels {busy_ms:.3f} ms per "
          f"forward, {100 * busy_ms / forward_ms:.1f}% of the forward's device time")
    for name, ms in top:
        share = 100 * ms / N_PROFILED / max(busy_ms, 1e-9)
        print(f"  {ms / N_PROFILED:9.3f} ms/forward  {share:5.1f}%  {name[:100]}")
    print(json.dumps({
        "card": card,
        "bucket": BUCKET,
        "host_prep_ms": host_prep_ms,
        "forward_ms": forward_ms,
        "profiled_forwards": N_PROFILED,
        "kernel_ms_per_forward": busy_ms if by_kernel else None,
        "top_kernels_ms_per_forward": {k[:100]: v / N_PROFILED for k, v in top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
