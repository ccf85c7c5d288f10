#!/usr/bin/env python3
"""This checkout's flash-attention kernel against another checkout's, in
turns, on one NVIDIA GPU.

Run from the root of a checkout on a machine with CUDA and nvcc:
``python3 scripts/compare_torch_flash_attn.py <other checkout>``, the other
checkout being, say, a parent commit unpacked with ``git archive``. Builds
both ``bioengine_tpu_torch/csrc/flash_attn_fwd.cu`` with the port's nvcc
flags into a temporary directory, loads each with its own
``ops/attention.py`` (its own launch plan), holds both against the plain
version on the same inputs, and times them with SDPA in turns (SDPA, this,
other, other, this, SDPA; CUDA events, mean of 20 after 3 warm-ups) at the
ViT-B/14 and ViT-H/14 shapes in bf16 and f16, drawn on the card from a
seed. Prints the card's name and power limit first and one JSON object of
the numbers last.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bioengine_tpu_torch.ops import _build, attention  # noqa: E402

SHAPES = [
    ((64, 12, 257, 64), torch.bfloat16),
    ((64, 12, 257, 64), torch.float16),
    ((64, 16, 257, 80), torch.bfloat16),
    ((64, 16, 257, 80), torch.float16),
]
ORDER = ("sdpa", "this", "other", "other", "this", "sdpa")
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


def load(root: Path, name: str, out_dir: Path):
    """The attention module of the checkout at ``root``, its kernel built
    from that checkout's source and loaded in place of the cache's."""
    spec = importlib.util.spec_from_file_location(
        f"attention_{name}", root / "bioengine_tpu_torch" / "ops" / "attention.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    lib_path = out_dir / f"flash_attn_fwd-{name}.so"
    done = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
         str(root / "bioengine_tpu_torch" / "csrc" / "flash_attn_fwd.cu")],
        capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {root}:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attn_error_string.argtypes = [ctypes.c_int]
    lib.flash_attn_error_string.restype = ctypes.c_char_p
    module.load_kernel = lambda: (lib, fn)
    return module


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_torch_flash_attn: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    this_root = Path(__file__).resolve().parent.parent
    with tempfile.TemporaryDirectory(prefix="flash_attn_compare_") as tmp:
        mods = {"this": load(this_root, "this", Path(tmp)),
                "other": load(Path(sys.argv[1]).resolve(), "other", Path(tmp))}
        gen = torch.Generator(device="cuda").manual_seed(0)
        result = {"card": card, "other": sys.argv[1], "shapes": {}}
        for shape, dtype in SHAPES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
            ref = attention.reference_attention(q, k, v).float()
            fns = {"sdpa": lambda: F.scaled_dot_product_attention(q, k, v),
                   **{name: (lambda m=m: m.flash_attention(q, k, v)) for name, m in mods.items()}}
            err = {name: (mods[name].flash_attention(q, k, v).float() - ref).abs().max().item()
                   for name in mods}
            turns = {name: [] for name in fns}
            for name in ORDER:
                turns[name].append(cuda_ms(fns[name]))
            row = {"max_abs_err": err, "ms_turns": turns}
            result["shapes"][f"{tuple(shape)} {str(dtype).split('.')[-1]}"] = row
            print(f"[{card}] {tuple(shape)} {dtype}: ms in turns {json.dumps(turns)}; max abs err "
                  f"against the plain version {json.dumps(err)}")
            del q, k, v, ref
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
