#!/usr/bin/env python3
"""Flash-attention kernels in profiler traces of a tensor-parallel engine.

Run from the root of a checkout on a machine with CUDA:
``python3 scripts/profile_torch_tp_traces.py [--traces N]``. Builds the
port's ViT-B/14 (224², bf16, flash-attention kernel, seeded weights) behind
``InferenceEngine`` on one device, at tp = 2 with ``VIT_TP_RULES`` on two
stacked ``cuda:0`` entries, and at dp 2 x tp 2 on four, and prints for each:

- the kernel wrapper's launches while the engine builds its CUDA graphs
  (``GRAPH_WARMUP_ITERS`` warm-up forwards and a capture per dp shard);
- the ``flash_attn`` kernels in ``torch.profiler`` traces of one
  ``engine.predict`` (graph replays), each the active step of a schedule
  with one warm-up step: N plain traces, N with 50 ms of idle time around
  the call, and three-step traces;
- for the tp engines, the engine's eager programs on the same group (the
  form a tp group across cards gets): launches per forward, kernels in a
  trace, max abs to the graphs' output and ms per request (CUDA events).

The last line is one JSON object of those numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bioengine_tpu_torch.models.vit import ViT  # noqa: E402
from bioengine_tpu_torch.ops import attention  # noqa: E402
from bioengine_tpu_torch.parallel.tensor_parallel import VIT_TP_RULES  # noqa: E402
from bioengine_tpu_torch.runtime.engine import (  # noqa: E402
    GRAPH_WARMUP_ITERS,
    EngineConfig,
    InferenceEngine,
)
from bioengine_tpu_torch.runtime.program_cache import CompiledProgramCache  # noqa: E402

BUCKET = 64
DEPTH = 12
SEED = 0


def flash_in_trace(fn, pad_s: float = 0.0, steps: int = 1) -> int:
    """``flash_attn`` kernel events in the active steps of a profiler
    schedule whose warm-up step runs ``fn`` once before."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=steps),
            on_trace_ready=lambda p: p.export_chrome_trace(path),
        ) as prof:
            for _ in range(1 + steps):
                time.sleep(pad_s)
                fn()
                torch.cuda.synchronize()
                time.sleep(pad_s)
                prof.step()
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return sum(1 for e in events if e.get("cat") == "kernel" and "flash_attn" in e.get("name", ""))


def cuda_ms(fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--traces", type=int, default=12, help="plain and padded traces per engine")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_tp_traces: needs CUDA", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dev0 = torch.device("cuda", 0)
    vit = ViT(attn_fn=attention.make_attn_fn(), depth=DEPTH)
    vit.reset_parameters(SEED)
    x = np.random.default_rng(SEED).standard_normal((BUCKET, 224, 224, 3)).astype(np.float32)
    meshes = {"single": dict(device="cuda"), "tp2": dict(devices=[dev0] * 2, mesh_axes={"tp": 2}),
              "dp2tp2": dict(devices=[dev0] * 4, mesh_axes={"dp": 2, "tp": 2})}
    out: dict = {"card": card, "graph_warmup_iters": GRAPH_WARMUP_ITERS}
    for key, kw in meshes.items():
        engine = InferenceEngine("tp-traces", vit, config=EngineConfig(ladder=(224,)),
                                 cache=CompiledProgramCache(),
                                 tp_rules=VIT_TP_RULES if key != "single" else None, **kw)
        try:
            before = attention.launch_count
            graph_out = engine.predict(x)
            r: dict = {"build_launches": attention.launch_count - before}
            predict = lambda: engine.predict(x)  # noqa: E731
            r["plain"] = [flash_in_trace(predict) for _ in range(args.traces)]
            r["padded_50ms"] = [flash_in_trace(predict, pad_s=0.05) for _ in range(args.traces)]
            r["three_steps"] = [flash_in_trace(predict, steps=3) for _ in range(3)]
            if key != "single":
                eager = engine._capture_group((BUCKET, 224, 224, 3), np.float32, eager=True)
                run = lambda: engine._launch(eager, x)[0].result()  # noqa: E731
                before = attention.launch_count
                eager_out = run()
                r["eager_launches"] = attention.launch_count - before
                r["eager_vs_graph_max_abs"] = float(
                    np.abs(eager_out.astype(np.float32) - graph_out.astype(np.float32)).max())
                r["eager_ms"] = cuda_ms(run)
                r["eager_traces"] = [flash_in_trace(run) for _ in range(4)]
        finally:
            engine.close()
        out[key] = r
        print(f"[{card}] {key}: " + json.dumps(r))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
