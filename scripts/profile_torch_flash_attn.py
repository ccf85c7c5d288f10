#!/usr/bin/env python3
"""Where a tile of the flash-attention kernel's f32 (tf32x3) path spends its
cycles, on one NVIDIA GPU.

Run from the root of a checkout on a machine with CUDA and nvcc:
``python3 scripts/profile_torch_flash_attn.py``. Builds a second copy of
``bioengine_tpu_torch/csrc/flash_attn_fwd.cu`` with ``-DFLASH_ATTN_PROBES``
(clock64 probes between the phases of a tile; the library the port loads is
built without them) into ``build/torch_kernels/probes/``, and prints, for
the ViT-B/14 main shape (64, 12, 257, 64) and for head dims 128 and 32: the
cycles per key tile of each phase of the first consumer warpgroup (waiting
for a split tile, for its turn, issuing and waiting for S, softmax and P's
split, the same for P V) and of the splitter warpgroup (waiting for a free
stage, for the landed K, splitting K, releasing K's landing stage, the same
for V), summed over blocks by one thread of each;
the probed copy's time and its max abs error against the plain version
beside the port's kernel's time. Then the main shape's kernel, plain
version and SDPA are timed in turns (plain, kernel, SDPA, SDPA, kernel,
plain). The last line is one JSON object of those numbers.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bioengine_tpu_torch.ops import _build, attention  # noqa: E402

SHAPES = [(64, 12, 257, 64), (64, 12, 257, 128), (64, 12, 257, 32)]
PHASES = [
    "consumer: wait for a split tile", "consumer: wait for its turn (S)",
    "consumer: issue S", "consumer: wait for S", "consumer: softmax and P's split",
    "consumer: wait for its turn (P V)", "consumer: issue P V",
    "consumer: wait for P V, free the stage",
    "splitter: wait for a free stage", "splitter: wait for K to land", "splitter: split K",
    "splitter: release K's landing stage", "splitter: wait for V to land",
    "splitter: split V, publish the stage", "splitter: release V's landing stage",
]
ITERS = 20


def cuda_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_probed() -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "flash_attn_fwd-probes.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DFLASH_ATTN_PROBES", "-o", str(lib_path),
           str(_build.CSRC_DIR / "flash_attn_fwd.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.flash_attn_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.flash_attn_fwd.restype = ctypes.c_int
    lib.flash_attn_read_probes.argtypes = [ctypes.c_void_p]
    lib.flash_attn_read_probes.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_flash_attn: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build_probed()
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card, "shapes": {}}
    for shape in SHAPES:
        q, k, v = (torch.randn(shape, device="cuda", generator=gen) for _ in range(3))
        out = torch.empty_like(q)
        B, H, N, d = shape
        plan = attention.launch_plan(shape, torch.float32)

        def probed():
            err = lib.flash_attn_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, N, d,
                d**-0.5, 0, 0, attention._PATH_CODES[plan.path], plan.q_tiles, plan.grid,
                plan.threads, plan.smem_bytes, torch.cuda.current_stream().cuda_stream,
            )
            if err != 0:
                raise RuntimeError(f"probed flash_attn_fwd failed ({err})")

        probed()
        sums = (ctypes.c_ulonglong * 16)()
        lib.flash_attn_read_probes(sums)  # zeroes them
        for _ in range(5):
            probed()
        if lib.flash_attn_read_probes(sums) != 0:
            raise RuntimeError("reading the probes failed")
        tiles = sums[15]
        cycles = {name: sums[i] / tiles for i, name in enumerate(PHASES)}
        err = (out - attention.reference_attention(q, k, v)).abs().max().item()
        row = {
            "cycles_per_tile": cycles,
            "consumer_cycles": sum(list(cycles.values())[:8]),
            "splitter_cycles": sum(list(cycles.values())[8:]),
            "probed_ms": cuda_ms(probed),
            "kernel_ms": cuda_ms(lambda: attention.flash_attention(q, k, v)),
            "probed_max_abs_err": err,
        }
        print(f"[{card}] {shape} f32 (tf32x3), cycles per key tile, first consumer and "
              f"splitter: " + ", ".join(f"{n} {c:.0f}" for n, c in cycles.items()))
        print(f"[{card}] {shape}: consumer {row['consumer_cycles']:.0f}, splitter "
              f"{row['splitter_cycles']:.0f} cycles a tile; probed copy {row['probed_ms']:.4f} ms "
              f"(max abs err {err:.3e}), the port's kernel {row['kernel_ms']:.4f} ms")
        if shape == SHAPES[0]:
            fns = {
                "plain": lambda: attention.reference_attention(q, k, v),
                "kernel": lambda: attention.flash_attention(q, k, v),
                "sdpa": lambda: F.scaled_dot_product_attention(q, k, v),
            }
            turns = {name: [] for name in fns}
            for name in ("plain", "kernel", "sdpa", "sdpa", "kernel", "plain"):
                turns[name].append(cuda_ms(fns[name]))
            row["turns_ms"] = turns
            print(f"[{card}] {shape} in turns (CUDA events, mean of {ITERS}): "
                  + ", ".join(f"{n} {ms}" for n, ms in turns.items()))
        result["shapes"][str(shape)] = row
        del q, k, v, out
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
