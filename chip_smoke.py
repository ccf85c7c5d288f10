#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. device: CUDA must be there; prints the card's name and power limit;
2. build: nvcc builds every kernel under bioengine_tpu_torch/csrc, and
   ptxas's registers, shared memory and spills are printed per kernel;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and the test suite's, with CUDA-event times; for flash
   attention both paths, bf16 on the tensor cores (wgmma) and f32 on the
   CUDA cores;
4. the main path: cell-image-search at ViT-B/14 width (dim 768, depth 12,
   heads 12, 224², bf16, bucket 64, weights from a numpy seed) ingests
   synthetic fields, builds a FlatIP index and answers ping,
   get_index_stats and 8 searches, with the kernels' launch counts read
   around it and the embeddings held against the plain attention path;
5. the device time of one bucket forward through the kernel and through
   the plain attention, in turns;
6. the model-runner path (slice 2): ``jax_params`` packages written here
   from seeded weights (UNet2D at the registry's width (32, 64, 128, 256),
   UNet3D (16, 32, 64) with z strides (1, 2)) served through
   ``RuntimeDeployment`` on the card: ``test``, a 512^2 request, a batch
   of 4 at 1024^2, a tiled 2048^2 request (25 tiles of 512 in chunks of 16
   through the pipelined engine), a tiled 96 x 256^2 volume and
   ``get_status``; checks that the pipelined result equals the serial one
   bit for bit, that a graph replay equals the eager forward, that the
   program cache holds one graph per (bucket, batch bucket) and a repeated
   request builds none, and that a streamed-weights package gives the
   eager one's output; prints request times, megapixels/s, graph-capture
   seconds, pipeline stage seconds, peak memory and a profiler top-10;
7. the cellpose fine-tuning path (slice 3): ``CellposeFinetune`` trains
   ``CellposeNet`` (32, 64, 128, 256) in bf16 for 3 epochs at 8 x 256^2 on
   16 synthetic 512^2 fields of ellipse cells (loss must fall); a train
   step timed with CUDA events and profiled; one f32 step (TF32 off) on
   the card against the CPU, and the bf16 step's loss against it; ``infer``
   on 2 x 512^2 and 1024^2 split into forward, ``follow_flows`` and host
   clustering, with the card's follow held against the CPU's; ``infer_3d``
   on a 32 x 256^2 stack at anisotropy 1 and 2; ``export_model`` served by
   ``RuntimeDeployment`` against ``_predict_raw``; one ``cellpose`` JSON
   line of the numbers;
8. the transformer backbones (slice 4): a torch-layout cpsam checkpoint at
   the published ViT-L shape (~303 M parameters, seeded, scaled to flax's
   initialiser scales) converted by ``convert_checkpoint``; ``CellposeFinetune``
   fine-tunes ``"cpsam"`` from it at the app's defaults (8 x 256^2, bf16,
   lr 1e-4) for 3 epochs on the 16 fields (loss must fall), then
   ``"sam"`` (CellposeSAM, dim 256, depth 8, 8 heads, 8 x 128^2); for each:
   a step timed and profiled, the f32 step on the card against the CPU
   (cpsam: a depth-2 cut at full width, 2 x 128^2), ``infer`` on 2 x 512^2
   and ``infer_3d`` on 32 x 256^2, the export served by
   ``RuntimeDeployment`` against ``_predict_raw``; the attention kernel's
   count stays 0; one ``cellpose_cpsam`` and one ``cellpose_sam`` JSON line;
9. StarDist and the zoo's torch formats (slice 5): ``CellposeFinetune``
   trains ``"stardist"`` (StarDist2D (32, 64, 128, 256), 32 rays, bf16, lr
   1e-4) for 3 epochs at 8 x 256^2 on the 16 fields (loss must fall); a
   step timed and profiled; the f32 step on the card against the CPU;
   ``infer`` on 2 x 512^2 split into forward and host polygon NMS and
   rendering; the export served by ``RuntimeDeployment`` against
   ``_predict_raw``. Then a zoo package whose own ``arch.py`` is a
   plain-torch UNet2D (32, 64, 128, 256), seeded, with a
   ``pytorch_state_dict`` entry and a traced ``torchscript`` twin, served
   by ``EntryDeployment`` over a ``LocalCollectionSource``: ``test`` for
   both formats, a 512^2 request and a batch of 4 at 1024^2 in each,
   held against the module on the CPU (f32, TF32 off inside the runner);
   request ms, load s and peak memory; the attention kernel's count
   stays 0; one ``zoo`` JSON line;
10. one JSON line of the kernels' numbers;
11. the result line ``{"ok": true, "device": {...}}``, printed last.

Any failed check exits non-zero before the result line. f32 comparisons
run with TF32 off for both cuBLAS and cuDNN, so the plain versions are full
f32.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from bioengine_tpu_torch.apps.cell_image_search.embedder import ViTEmbedder
from bioengine_tpu_torch.apps.cell_image_search.index import build_index
from bioengine_tpu_torch.apps.cell_image_search.ingestion import (
    extract_cell_crops,
    make_synthetic_images,
)
from bioengine_tpu_torch.apps.cell_image_search.service import CellImageSearch
from bioengine_tpu_torch.apps.cellpose_finetuning import service as finetune_service
from bioengine_tpu_torch.apps.cellpose_finetuning.service import CellposeFinetune
from bioengine_tpu_torch.apps.model_runner.entry import EntryDeployment
from bioengine_tpu_torch.apps.model_runner.runtime import RuntimeDeployment
from bioengine_tpu_torch.models.cellpose import (
    CellposeConfig,
    CellposeNet,
    TrainState,
    create_model_and_state,
    make_train_step,
)
from bioengine_tpu_torch.models.unet import UNet2D
from bioengine_tpu_torch.models.unet3d import UNet3D
from bioengine_tpu_torch.models.vit import ViT
from bioengine_tpu_torch.ops import _build, attention
from bioengine_tpu_torch.ops.flows import (
    FLOW_SCALE,
    aggregate_orthogonal_flows,
    cluster_sinks,
    follow_flows,
    follow_flows_3d,
    masks_to_flows,
    predictions_to_masks,
)
from bioengine_tpu_torch.models.cellpose_sam import CellposeSAM
from bioengine_tpu_torch.models.sam import CpSAM
from bioengine_tpu_torch.models.stardist import StarDist2D, make_stardist_train_step
from bioengine_tpu_torch.ops.stardist import predictions_to_masks_stardist
from bioengine_tpu_torch.runtime.convert import (
    convert_checkpoint,
    convert_state_dict,
    cpsam_name_map,
    flatten_params,
    flax_params_from_state_dict,
    save_params_npz,
    state_dict_from_flax,
    synthetic_cpsam_state_dict,
    unflatten_params,
)
from bioengine_tpu_torch.runtime.rdf import apply_processing, from_nhwc, to_nhwc
from bioengine_tpu_torch.runtime.weight_stream import write_manifest

SEED = 0
BUCKET = 64
VIT_DEPTH = 12
N_FIELDS = 4
N_SEARCHES = 8
TOP_K = 10
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the test suite's tolerances (tests/test_ops_pallas.py): (atol, rtol)
TOLERANCE = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 0.0)}
ATTENTION_CASES = [
    # (label, (B, H, N, d), dtype, causal)
    ("vit_b14_main_path", (BUCKET, 12, 257, 64), torch.bfloat16, False),
    ("vit_b14_main_path_f32", (BUCKET, 12, 257, 64), torch.float32, False),
    ("n128", (2, 3, 128, 64), torch.float32, False),
    ("n200", (2, 3, 200, 64), torch.float32, False),
    ("n257", (2, 3, 257, 64), torch.float32, False),
    ("causal_d32", (1, 2, 200, 32), torch.float32, True),
    ("n300", (1, 1, 300, 64), torch.float32, False),
    ("d128", (2, 4, 190, 128), torch.float32, False),
    ("d128_causal_bf16", (1, 2, 77, 128), torch.bfloat16, True),
] + [
    # the bf16 (wgmma) path at every head dim, across tile edges and ragged ends
    (f"bf16_d{d}_n{n}", (2, 3, n, d), torch.bfloat16, False)
    for d in (32, 64, 128)
    for n in (1, 64, 65, 257, 300)
] + [
    (f"bf16_d{d}_n257_causal", (2, 3, 257, d), torch.bfloat16, True)
    for d in (32, 64, 128)
]
MAIN_CASE = "vit_b14_main_path"


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters``
    back-to-back calls."""
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


def attention_bound_ms(shape, dtype) -> tuple[float, str]:
    """Least time for one call: q, k, v read once and o written once over
    HBM bandwidth, against 4*B*H*N^2*d FLOP over the type's peak."""
    B, H, N, d = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    t_bytes = 4 * B * H * N * d * itemsize / PEAK_BYTES_PER_S
    t_ops = 4 * B * H * N * N * d / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_device() -> tuple[str, str]:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(
        f"device: {name}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}"
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for cuBLAS and cuDNN (f32 comparisons are full f32)")
    return card, name


def ptxas_report(log: str) -> dict:
    """Registers, static shared memory and spill bytes of each kernel, from
    nvcc's ``-Xptxas -v`` log, keyed by a short name such as
    ``flash_attn_wgmma_kernel<64>``."""

    def short(mangled: str) -> str:
        # the kernel's name is the identifier before its template arguments,
        # prefixed by its length
        m = re.search(r"ILi(\d+)E", mangled)
        if m:
            end = m.start()
            for size in range(1, end):
                digits = str(size)
                if mangled[end - size - len(digits):end - size] == digits:
                    return f"{mangled[end - size:end]}<{m.group(1)}>"
        return mangled

    report: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line)
        if m:
            current = report.setdefault(short(m.group(1)), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_store_bytes"] = int(m.group(1))
            current["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            current["static_smem_bytes"] = int(m.group(1))
    return report


def phase_build(card: str) -> dict:
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(
        f"build: {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s: {[p.name for p in libs]}"
    )
    ptxas = {}
    for name in _build.kernel_names():
        log = _build.build_log(name)
        for line in log.splitlines():
            if "warning" in line.lower():
                print(f"build: {name}: {line.strip()}")
        ptxas[name] = ptxas_report(log)
        for kernel, info in ptxas[name].items():
            print(f"[{card}] ptxas {name}: {kernel} {json.dumps(info)}")
    wgmma = ptxas.get(attention.KERNEL_NAME, {}).get("flash_attn_wgmma_kernel<64>")
    check(wgmma is not None and "registers" in wgmma, "no ptxas report for the wgmma kernel")
    return ptxas


def phase_kernels(card: str) -> dict:
    """Each attention case: the kernel against the plain version, both on
    the card. Returns the main path's numbers."""
    rng = np.random.default_rng(SEED)
    main = {}
    for label, shape, dtype, causal in ATTENTION_CASES:
        q, k, v = (
            torch.from_numpy(rng.standard_normal(shape, np.float32)).to("cuda", dtype)
            for _ in range(3)
        )
        out = attention.flash_attention(q, k, v, causal=causal)
        ref = attention.reference_attention(q, k, v, causal)
        torch.cuda.synchronize()
        check(out.dtype == dtype and out.shape == q.shape, f"{label}: output {out.dtype} {tuple(out.shape)}")
        diff = (out.float() - ref.float()).abs()
        atol, rtol = TOLERANCE[dtype]
        max_abs = diff.max().item()
        within = bool((diff <= atol + rtol * ref.float().abs()).all().item())
        check(bool(torch.isfinite(out).all().item()), f"{label}: non-finite output")
        check(within, f"{label}: max abs err {max_abs} over atol {atol} rtol {rtol}")
        line = {
            "case": label, "shape": list(shape), "dtype": str(dtype).split(".")[-1],
            "causal": causal, "path": attention.launch_plan(shape, dtype).path,
            "max_abs_err": max_abs, "atol": atol, "rtol": rtol,
        }
        if label.startswith(MAIN_CASE):
            line["kernel_ms"] = cuda_ms(lambda: attention.flash_attention(q, k, v))
            line["plain_ms"] = cuda_ms(lambda: attention.reference_attention(q, k, v))
            line["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v)
            )
            line["bound_ms"], line["bound_by"] = attention_bound_ms(shape, dtype)
            line["card"] = card
            if label == MAIN_CASE:
                main = line
        print("attention " + json.dumps(line))
        del q, k, v, out, ref, diff
    return main


def synthetic_crops(seed: int, n_fields: int) -> list[np.ndarray]:
    crops = []
    for _, field in make_synthetic_images(n_images=n_fields, size=896, seed=seed):
        crops += extract_cell_crops(field, crop_size=224, n_crops=50)
    return crops


async def drive_main_path(svc: CellImageSearch, crops, queries, workspace: str) -> dict:
    """The slice as a user drives it; returns what the checks need."""
    t0 = time.perf_counter()
    await svc.test_deployment()  # builds the model from the seed; first forward
    t_first = time.perf_counter() - t0
    await svc.check_health()

    t0 = time.perf_counter()
    emb = svc.embedder.embed_batch(crops)
    t_ingest = time.perf_counter() - t0
    rows = [{"dataset": "synthetic", "crop": j} for j in range(len(crops))]
    build_index(emb, rows, workspace)
    stats = await svc.get_index_stats()
    pong = await svc.ping()

    found, search_ms = [], []
    for q in queries:
        t0 = time.perf_counter()
        found.append(await svc.search(q, top_k=TOP_K))
        search_ms.append((time.perf_counter() - t0) * 1e3)

    # throughput over full buckets: the crops repeated to 3 x BUCKET images
    full = (crops * (3 * BUCKET // len(crops) + 1))[: 3 * BUCKET]
    t0 = time.perf_counter()
    bucket_emb = svc.embedder.embed_batch(full)
    t_buckets = time.perf_counter() - t0
    return {
        "emb": emb, "bucket_emb": bucket_emb, "stats": stats, "ping": pong,
        "found": found, "search_ms": search_ms, "t_first": t_first,
        "t_ingest": t_ingest, "t_buckets": t_buckets,
    }


def phase_main_path(card: str) -> int:
    crops = synthetic_crops(SEED, N_FIELDS)
    check(len(crops) > TOP_K, f"only {len(crops)} crops from {N_FIELDS} fields")
    probe = 5
    queries = [crops[probe]] + synthetic_crops(SEED + 1, 1)[: N_SEARCHES - 1]
    check(len(queries) == N_SEARCHES, f"{len(queries)} queries")
    print(f"main path: ViT-B/14 (768 wide, {VIT_DEPTH} deep, 12 heads, 224^2, bf16), "
          f"bucket {BUCKET}, {len(crops)} crops from {N_FIELDS} synthetic 896^2 fields")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workspace:
        svc = CellImageSearch(
            workspace_dir=workspace, batch_bucket=BUCKET, device="cuda", seed=SEED,
            model_overrides={"depth": VIT_DEPTH},
        )
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        attention.launch_count = 0
        r = asyncio.run(drive_main_path(svc, crops, queries, workspace))
        launches = attention.launch_count
        forwards = svc.embedder.forward_count
        embed_dim = svc.embedder.embed_dim

    print(f"main path: {forwards} bucket forwards, flash_attn_fwd launches {launches}")
    check(launches > 0, "the main path launched no flash_attn_fwd kernel")
    check(launches == VIT_DEPTH * forwards, f"{launches} launches for {forwards} forwards")

    emb = r["emb"]
    check(emb.shape == (len(crops), embed_dim) and np.isfinite(emb).all(), f"embeddings {emb.shape}")
    check(np.isfinite(r["bucket_emb"]).all(), "non-finite embeddings in the full buckets")
    norms = np.linalg.norm(emb, axis=1)
    check(np.abs(norms - 1).max() <= 1e-3, f"norms off by {np.abs(norms - 1).max()}")
    check(r["stats"]["loaded"] and r["stats"]["n_cells"] == len(crops), f"stats {r['stats']}")
    check(r["stats"]["index_type"] == "FlatIP", f"stats {r['stats']}")
    check(r["ping"]["status"] == "ok" and r["ping"]["backend"] == "cuda", f"ping {r['ping']}")
    print("ping " + json.dumps(r["ping"]))
    for i, found in enumerate(r["found"]):
        scores = [x["score"] for x in found["results"]]
        check(found["n_results"] == TOP_K, f"search {i}: {found['n_results']} results")
        check(all(np.isfinite(scores)) and scores == sorted(scores, reverse=True),
              f"search {i}: scores {scores}")
    top = r["found"][0]["results"][0]
    check(top["index_id"] == probe and top["crop"] == probe and top["score"] >= 0.99,
          f"corpus crop {probe} came back as {top}")

    # for comparison only: the same weights with the plain attention
    plain = ViTEmbedder(
        batch_bucket=BUCKET, device="cuda", seed=SEED,
        attn_fn=attention.reference_attention, model_overrides={"depth": VIT_DEPTH},
    )
    ref = plain.embed_batch(crops[:BUCKET])
    cos = np.sum(ref * emb[:BUCKET], axis=1)
    print(f"kernel vs plain attention embeddings: min cosine {cos.min():.6f} over {len(cos)} rows")
    check(cos.min() >= 0.999, f"min cosine {cos.min()}")

    n_bucket_images = 3 * BUCKET
    print(f"[{card}] embed: model build + first forward {r['t_first']:.3f} s; "
          f"{len(crops) / r['t_ingest']:.1f} images/s over {len(crops)} crops; "
          f"{n_bucket_images / r['t_buckets']:.1f} images/s over 3 full buckets of {BUCKET}")
    ms = np.array(r["search_ms"])
    svc_ms = [(f["embed_ms"], f["search_ms"]) for f in r["found"]]
    print(f"[{card}] search: {ms.mean():.2f} ms mean per request over {len(ms)} "
          f"(min {ms.min():.2f}, max {ms.max():.2f}); service embed/search ms {svc_ms}")
    print(f"[{card}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_forward(card: str) -> dict:
    """Device time of one bucket forward of ViT-B/14 (bf16, bucket 64) with
    the kernel and with the plain attention in its place, same weights, in
    turns: kernel, plain, plain, kernel."""
    models = {}
    for label, attn_fn in (
        ("kernel", attention.make_attn_fn()),
        ("plain", attention.reference_attention),
    ):
        model = ViT(depth=VIT_DEPTH, attn_fn=attn_fn)
        model.reset_parameters(SEED)
        models[label] = model.to("cuda").eval()
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(
        rng.standard_normal((BUCKET, 224, 224, 3), np.float32)
    ).to("cuda")
    times: dict[str, list[float]] = {"kernel": [], "plain": []}
    with torch.inference_mode():
        for label in ("kernel", "plain", "plain", "kernel"):
            times[label].append(cuda_ms(lambda: models[label](x), iters=10, warmup=2))
    out = {label: sum(ms) / len(ms) for label, ms in times.items()}
    print(f"[{card}] bucket forward (ViT-B/14, {VIT_DEPTH} deep, bf16, {BUCKET} images), "
          f"CUDA events, mean of 10 after 2 warm-up: kernel {times['kernel']} ms, "
          f"plain attention {times['plain']} ms")
    return out


# ---- slice 2: the model-runner path ------------------------------------------

UNET2D_FEATURES = (32, 64, 128, 256)  # the registry's default, bench.py:204
UNET3D_FEATURES = (16, 32, 64)  # bench.py:232
UNET3D_Z_STRIDES = (1, 2)
VOLUME = (1, 96, 256, 256, 1)  # (B, Z, Y, X, C)
MR_REPEATS = {"512": 5, "4x1024": 5, "2048": 3, "volume": 3}
# bf16 on the card against an f32 forward of the same weights on the CPU:
# 8 GroupNorm layers of bf16 rounding, held to 10% of the output's range
# (the tolerance of tests/test_torch_unet.py for bf16)
MR_BF16_VS_F32 = 0.1


def write_unet_package(root: str, name: str, model, arch: str, kwargs: dict,
                       axes: str, manifest: bool = False) -> str:
    """A ``jax_params`` package of ``model``'s weights: flax-named npz via
    the reverse bridge, ``rdf.yaml`` as JSON text; per-sample zero-mean
    in, sigmoid out."""
    d = f"{root}/{name}"
    os.makedirs(d)
    flat = flax_params_from_state_dict(model.state_dict())
    save_params_npz(f"{d}/weights.npz", unflatten_params(flat))
    if manifest:
        write_manifest(f"{d}/weights.npz", flat)
    rdf = {
        "type": "model", "name": name, "description": "seeded chip_smoke model",
        "inputs": [{"name": "raw", "axes": axes, "preprocessing": [
            {"name": "zero_mean_unit_variance", "kwargs": {"mode": "per_sample"}},
        ]}],
        "outputs": [{"name": "mask", "axes": axes, "postprocessing": [{"name": "sigmoid"}]}],
        "weights": {"jax_params": {"source": "weights.npz",
                                   "architecture": {"name": arch, "kwargs": kwargs}}},
    }
    with open(f"{d}/rdf.yaml", "w") as f:
        f.write(json.dumps(rdf, indent=1))
    return d


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


async def _timed(device: str, repeats: int, call):
    """(result of the last call, per-call host ms) over ``repeats`` calls,
    each ending with its result on the host."""
    ms, out = [], None
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        out = await call()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def _engine_of(deployment: RuntimeDeployment, package: str):
    (pipeline,) = [p for p in deployment._pipelines.values() if str(p.package_path) == package]
    return pipeline, pipeline.engine


async def drive_model_runner(dep: RuntimeDeployment, device: str, pkgs: dict, inputs: dict) -> dict:
    """The model-runner as a user drives it; returns what the checks and
    the report need."""
    r: dict = {"ms": {}, "inputs": inputs}
    for key in ("unet2d", "unet3d"):
        t0 = time.perf_counter()
        r[f"test_{key}"] = await dep.test(pkgs[key], skip_cache=True)
        r[f"test_{key}_s"] = time.perf_counter() - t0
    for key in ("512", "4x1024", "2048", "volume"):
        pkg = pkgs["unet3d" if key == "volume" else "unet2d"]
        t0 = time.perf_counter()
        await dep.predict(pkg, {"raw": inputs[key]})  # builds the request's graphs
        r[f"first_{key}_s"] = time.perf_counter() - t0
    r["pipe2d"], engine2d = _engine_of(dep, pkgs["unet2d"])
    r["pipe3d"], engine3d = _engine_of(dep, pkgs["unet3d"])
    misses_before = engine2d.cache.stats.misses
    for key in ("512", "4x1024", "2048", "volume"):
        pkg = pkgs["unet3d" if key == "volume" else "unet2d"]
        engine = engine3d if key == "volume" else engine2d
        before = engine.pipeline_stats.as_dict()
        out, ms = await _timed(device, MR_REPEATS[key],
                               lambda pkg=pkg, key=key: dep.predict(pkg, {"raw": inputs[key]}))
        after = engine.pipeline_stats.as_dict()
        r[key], r["ms"][key] = out, ms
        r[f"stages_{key}"] = {
            k: (after[k] - before[k]) / MR_REPEATS[key]
            for k in after if k.endswith("_seconds")
        }
        r[f"overlap_{key}"] = (
            after["compute_seconds"] - before["compute_seconds"]
        ) / max(after["wall_seconds"] - before["wall_seconds"], 1e-12)
    r["repeat_misses"] = engine2d.cache.stats.misses - misses_before
    r["streamed"] = await dep.predict(pkgs["unet2d_streamed"], {"raw": inputs["512"]})
    r["status"] = await dep.get_status()
    r["describe2d"], r["describe3d"] = engine2d.describe(), engine3d.describe()
    return r


def phase_model_runner(card: str, device: str = "cuda") -> dict:
    """Slice 2 at full width: write the packages, drive RuntimeDeployment,
    check, and print the numbers beside the card's name and power limit."""
    rng = np.random.default_rng(SEED)
    unet2d = UNet2D(features=UNET2D_FEATURES)
    unet2d.reset_parameters(SEED)
    unet3d = UNet3D(features=UNET3D_FEATURES, z_strides=UNET3D_Z_STRIDES)
    unet3d.reset_parameters(SEED + 1)
    inputs = {
        "512": rng.standard_normal((1, 512, 512, 1), np.float32),
        "4x1024": rng.standard_normal((4, 1024, 1024, 1), np.float32),
        "2048": rng.standard_normal((1, 2048, 2048, 1), np.float32),
        "volume": rng.standard_normal(VOLUME, np.float32),
    }
    print(f"model runner: UNet2D {UNET2D_FEATURES} and UNet3D {UNET3D_FEATURES} "
          f"z_strides {UNET3D_Z_STRIDES}, bf16, weights from seeds {SEED} and "
          f"{SEED + 1}; requests 512^2, 4 x 1024^2, 2048^2 (tiled), volume {VOLUME[1:4]} (tiled)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mr_") as root:
        kw2d = {"features": list(UNET2D_FEATURES)}
        kw3d = {"features": list(UNET3D_FEATURES), "z_strides": list(UNET3D_Z_STRIDES)}
        pkgs = {
            "unet2d": write_unet_package(root, "unet2d", unet2d, "unet2d", kw2d, "byxc"),
            "unet2d_streamed": write_unet_package(
                root, "unet2d_streamed", unet2d, "unet2d", kw2d, "byxc", manifest=True),
            "unet3d": write_unet_package(root, "unet3d", unet3d, "unet3d", kw3d, "bzyxc"),
        }
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        dep = RuntimeDeployment(device=device)
        try:
            attention.launch_count = 0
            r = asyncio.run(drive_model_runner(dep, device, pkgs, inputs))
            launches = attention.launch_count
            peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
            print(f"model runner: flash_attn_fwd launches {launches} (the U-Nets run no attention)")
            checks = check_model_runner(card, device, pkgs, inputs, r, unet2d)
            report_model_runner(card, device, r, checks, peak)
        finally:
            asyncio.run(dep.close())
    return {"launches": launches, **checks}


def check_model_runner(card, device, pkgs, inputs, r, unet2d) -> dict:
    for key in ("unet2d", "unet3d"):
        rep = r[f"test_{key}"]
        check(rep["status"] == "passed" and rep["backend"] == device, f"test {key}: {rep}")
    check(r["test_unet2d"]["output_shape"] == [1, 64, 64, 1], f"test: {r['test_unet2d']}")
    for key in ("512", "4x1024", "2048", "volume"):
        out = r[key]["mask"]
        check(out.shape == inputs[key].shape, f"{key}: output {out.shape} for {inputs[key].shape}")
        check(bool(np.isfinite(out).all()) and out.min() >= 0 and out.max() <= 1,
              f"{key}: outputs outside [0, 1] after the sigmoid")
        check(r[key]["_meta"]["backend"] == device, f"{key}: {r[key]['_meta']}")
    check(np.array_equal(r["streamed"]["mask"], r["512"]["mask"]),
          "the streamed-weights package differs from the eager one")
    status = r["status"]
    check(status["backend"] == device and len(status["loaded_pipelines"]) == 3, f"status {status}")

    # the program cache: one graph per (bucket, batch bucket), none rebuilt
    pipe2d, engine2d = r["pipe2d"], r["pipe2d"].engine
    engine3d = r["pipe3d"].engine
    shapes2d = sorted(k[1:5] for k in engine2d.cache.keys() if k[0] == engine2d.model_id)
    shapes3d = sorted(k[1:6] for k in engine2d.cache.keys() if k[0] == engine3d.model_id)
    want2d = sorted([(1, 64, 64, 1), (1, 512, 512, 1), (4, 1024, 1024, 1), (16, 512, 512, 1)])
    want3d = sorted([(1, 16, 64, 64, 1), (4, 32, 256, 256, 1)])
    check(shapes2d == want2d, f"UNet2D programs {shapes2d}, expected {want2d}")
    check(shapes3d == want3d, f"UNet3D programs {shapes3d}, expected {want3d}")
    check(r["repeat_misses"] == 0, f"repeated requests built {r['repeat_misses']} programs")

    # the tiled 2048^2 request: pipelined == serial, bit for bit
    x = apply_processing(to_nhwc(inputs["2048"], "byxc"), pipe2d.input_spec.preprocessing)
    t0 = time.perf_counter()
    piped = engine2d.predict(x)
    t1 = time.perf_counter()
    serial = engine2d.predict_serial(x)
    t2 = time.perf_counter()
    print(f"[{card}] engine alone, 2048^2 (pre-processed input): predict (pipelined) "
          f"{(t1 - t0) * 1e3:.3f} ms, predict_serial {(t2 - t1) * 1e3:.3f} ms")
    check(np.array_equal(piped, serial), "pipelined 2048^2 differs from the serial path: "
          f"max abs {np.abs(piped - serial).max()}")
    served = apply_processing(piped, pipe2d.output_spec.postprocessing)
    check(np.array_equal(served, r["2048"]["mask"]), "predict() differs from the engine's result")

    # one graph replay == the eager forward of the same module, same bucket
    program = engine2d._program((16, 512, 512, 1), np.float32)
    chunk = np.ascontiguousarray(
        np.stack([x[0, i:i + 512, j:j + 512] for i in (0, 448, 896, 1344) for j in (0, 448, 896, 1344)])
    )
    staged = engine2d._staging_pool.acquire(chunk.shape, chunk.dtype)
    staged[...] = chunk
    replayed = engine2d._launch(program, staged)[0].result().copy()
    engine2d._staging_pool.release(staged)
    with torch.no_grad():
        eager = engine2d.module(torch.from_numpy(chunk).to(device)).float().cpu().numpy()
    replay_err = float(np.abs(replayed - eager).max())
    check(replay_err == 0.0, f"graph replay differs from the eager forward by {replay_err}")

    # the card's bf16 forward against an f32 forward of the same weights on
    # the CPU, on the test's 64^2 input
    small = np.random.default_rng(0).standard_normal((1, 64, 64, 1)).astype(np.float32)
    ref32 = UNet2D(features=UNET2D_FEATURES, dtype=torch.float32)
    ref32.load_state_dict(unet2d.state_dict())
    with torch.inference_mode():
        want = ref32(torch.from_numpy(small)).numpy()
    got = engine2d.predict(small)
    bf16_err = float(np.abs(got - want).max())
    bound = MR_BF16_VS_F32 * float(np.abs(want).max())
    check(bf16_err <= bound, f"card bf16 vs CPU f32: max abs {bf16_err} over {bound}")
    print(f"[{card}] model runner checks: pipelined == serial (2048^2, 25 tiles, bit for bit); "
          f"graph replay == eager (16 x 512^2, max abs {replay_err}); programs 2D {shapes2d}, "
          f"3D {shapes3d}, repeated requests built {r['repeat_misses']}; streamed == eager; "
          f"card bf16 vs CPU f32 max abs {bf16_err:.4g} (bound {bound:.4g})")
    return {"replay_err": replay_err, "bf16_vs_f32": bf16_err,
            "program": program, "chunk": chunk, "engine2d": engine2d}


def report_model_runner(card, device, r, checks, peak) -> None:
    mp = {"512": 512 * 512 / 1e6, "4x1024": 4 * 1024 * 1024 / 1e6,
          "2048": 2048 * 2048 / 1e6, "volume": float(np.prod(VOLUME[1:4])) / 1e6}
    for key, unit in (("512", "MP"), ("4x1024", "MP"), ("2048", "MP"), ("volume", "MVox")):
        ms = np.array(r["ms"][key])
        print(f"[{card}] model runner {key}: {ms.mean():.3f} ms mean per request over "
              f"{len(ms)} after a warm-up call (min {ms.min():.3f}, max {ms.max():.3f}); "
              f"{mp[key] / (ms.mean() / 1e3):.2f} {unit}/s; first call {r[f'first_{key}_s']:.3f} s")
        stages = {k.removesuffix("_seconds"): round(v * 1e3, 3) for k, v in r[f"stages_{key}"].items()}
        if key in ("2048", "volume"):
            pipe = r["pipe3d" if key == "volume" else "pipe2d"]
            pre, post = host_processing_ms(pipe, r["inputs"][key], r[key]["mask"])
            print(f"[{card}] model runner {key}: pipeline stage ms per request {json.dumps(stages)}, "
                  f"overlap efficiency {r[f'overlap_{key}']:.4f}; host pre-processing "
                  f"{pre:.3f} ms, post-processing {post:.3f} ms")
    for which in ("describe2d", "describe3d"):
        for k, s in r[which]["programs"]["compile_seconds"].items():
            print(f"[{card}] graph capture: {k} {s} s")
    print(f"[{card}] model runner test(): unet2d {r['test_unet2d_s']:.3f} s, "
          f"unet3d {r['test_unet3d_s']:.3f} s (package load + first graphs)")
    print(f"[{card}] model runner peak device memory {peak / 2**30:.2f} GiB")
    print("model runner status " + json.dumps(r["status"]))
    if device != "cuda":
        return
    # where a 16-tile chunk's time goes on the card
    program, chunk, engine = checks["program"], checks["chunk"], checks["engine2d"]
    host = torch.from_numpy(chunk).pin_memory()
    dev = torch.empty_like(host, device="cuda")
    back = torch.empty(program.static_out.shape, dtype=program.static_out.dtype, pin_memory=True)
    h2d = cuda_ms(lambda: dev.copy_(host, non_blocking=True), iters=20)
    d2h = cuda_ms(lambda: back.copy_(program.static_out, non_blocking=True), iters=20)
    replay = cuda_ms(program.graph.replay, iters=10, warmup=2)
    with torch.no_grad():
        eager = cuda_ms(lambda: engine.module(dev), iters=5, warmup=1)
    print(f"[{card}] 16 x 512^2 chunk, CUDA events: H2D {h2d:.3f} ms, graph replay {replay:.3f} ms, "
          f"eager forward {eager:.3f} ms, D2H {d2h:.3f} ms")
    with torch.no_grad():
        print_profile(card, "eager forward of one 16 x 512^2 chunk", lambda: engine.module(dev))


def print_profile(card: str, what: str, fn) -> list[dict]:
    """``torch.profiler`` over one call of ``fn``: the kernels' busy time
    and the top 10 aten ops by device time, printed and returned."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))

    averages = prof.key_averages()
    # device events are the kernels; the aten ops that launched them carry
    # the same time as their self device time, so each list sums alone
    kernels = [e for e in averages if str(e.device_type).endswith("CUDA")]
    ops = sorted((e for e in averages if e.key.startswith("aten::")), key=dev_us, reverse=True)
    total = sum(dev_us(e) for e in kernels)
    print(f"[{card}] profiler, {what}: kernels busy "
          f"{total / 1e3:.3f} ms ({len(kernels)} kernel names); top 10 aten ops by device time:")
    top = []
    for e in ops[:10]:
        print(f"[{card}]   {dev_us(e) / 1e3:9.3f} ms {100 * dev_us(e) / max(total, 1e-9):5.1f}% "
              f"x{e.count:<4} {e.key}")
        top.append({"op": e.key, "ms": dev_us(e) / 1e3, "count": e.count})
    return [{"busy_ms": total / 1e3}] + top


def host_processing_ms(pipeline, x: np.ndarray, y: np.ndarray, repeats: int = 3) -> tuple[float, float]:
    """Median host ms of the pipeline's input side (axes + pre-processing)
    and output side (post-processing + axes) for one request's arrays."""
    spec_in, spec_out = pipeline.input_spec, pipeline.output_spec
    pre, post = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        apply_processing(to_nhwc(x, spec_in.axes), spec_in.preprocessing)
        t1 = time.perf_counter()
        from_nhwc(apply_processing(y, spec_out.postprocessing), spec_out.axes)
        t2 = time.perf_counter()
        pre.append((t1 - t0) * 1e3)
        post.append((t2 - t1) * 1e3)
    return float(np.median(pre)), float(np.median(post))


# ---- slice 3: cellpose fine-tuning -------------------------------------------

CELLPOSE_FEATURES = (32, 64, 128, 256)  # the app's default backbone, bench.py:1057
CELLPOSE_FIELDS = 16  # synthetic 512^2 two-channel training fields
CELLPOSE_FIELD = 512
CELLPOSE_CELLS = 60  # ellipse cells per 512^2 field
CELLPOSE_CFG = {"tile": 256, "batch_size": 8, "epochs": 3}  # 8 steps an epoch
CELLPOSE_TIMED_STEPS = 20
CELLPOSE_INFER_REPEATS = 3
CELLPOSE_VOLUME = (32, 256, 256)
# card against CPU, f32 with TF32 off: loss relative, gradients against the
# largest gradient; the bf16 step's loss against the f32 one
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_TOL = 1e-4
STEP_BF16_RTOL = 0.02
# follow_flows on the card against the CPU, on the same raw prediction
FOLLOW_POS_TOL = 1e-3  # px
FOLLOW_POS_SHARE = 0.999
FOLLOW_MASK_AGREE = 0.995
# the export served by RuntimeDeployment against _predict_raw, 512^2 (its
# own bucket in both), as a share of the output's range
EXPORT_TOL = 1e-3


def synthetic_cell_fields(n: int, size: int, n_cells: int, seed: int):
    """(n, size, size, 2) float32 fields (cytoplasm, nucleus) of ellipse
    cells on a noisy background, and their (n, size, size) int32 instance
    masks; cells drawn later never cover earlier ones."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0.1, 0.02, (n, size, size, 2)).astype(np.float32)
    masks = np.zeros((n, size, size), np.int32)
    for i in range(n):
        for lbl in range(1, n_cells + 1):
            cy, cx = rng.uniform(12, size - 12, 2)
            a, b = rng.uniform(7, 14, 2)
            theta = rng.uniform(0, np.pi)
            r = int(np.ceil(max(a, b))) + 1
            ys = slice(max(int(cy) - r, 0), min(int(cy) + r + 1, size))
            xs = slice(max(int(cx) - r, 0), min(int(cx) + r + 1, size))
            dy, dx = np.meshgrid(np.arange(ys.start, ys.stop) - cy,
                                 np.arange(xs.start, xs.stop) - cx, indexing="ij")
            u = dy * np.cos(theta) + dx * np.sin(theta)
            v = -dy * np.sin(theta) + dx * np.cos(theta)
            free = ((u / a) ** 2 + (v / b) ** 2 < 1) & (masks[i, ys, xs] == 0)
            masks[i, ys, xs][free] = lbl
            images[i, ys, xs, 0][free] += rng.uniform(0.6, 1.2)
            images[i, ys, xs, 1][free & ((u / a) ** 2 + (v / b) ** 2 < 0.25)] += 1.0
    return images, masks


def synthetic_cell_volume(shape, n_cells: int, seed: int) -> np.ndarray:
    """A (D, H, W) float32 grayscale stack of bright ellipsoid cells."""
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.1, 0.02, shape).astype(np.float32)
    zz, yy, xx = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    for _ in range(n_cells):
        c = [rng.uniform(6, s - 6) for s in shape]
        radii = rng.uniform(5, 10, 3)
        inside = sum(((g - ci) / ri) ** 2 for g, ci, ri in zip((zz, yy, xx), c, radii)) < 1
        vol[inside] += rng.uniform(0.6, 1.2)
    return vol


def _device_ms(device: str, fn, iters: int, warmup: int = 1) -> float:
    """CUDA-event ms per call on the card, host ms on the CPU."""
    if device == "cuda":
        return cuda_ms(fn, iters=iters, warmup=warmup)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _matched_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Share of the pixels labelled in ``a`` whose label in ``b`` is the
    one that overlaps their ``a`` label most."""
    fg = a > 0
    if not fg.any():
        return 1.0
    pairs, counts = np.unique(np.stack([a[fg], b[fg]]), axis=1, return_counts=True)
    best: dict[int, int] = {}
    for (la, _), n in zip(pairs.T, counts):
        best[la] = max(best.get(la, 0), int(n))
    return sum(best.values()) / int(fg.sum())


async def drive_cellpose(svc: CellposeFinetune, images, masks, config: dict,
                         session_id: str = "smoke", timeout_s: float = 600) -> dict:
    """The app as a user drives it: start, poll until done, list."""
    t0 = time.perf_counter()
    await svc.start_training(
        train_images=list(images), train_labels=list(masks), config=config,
        session_id=session_id,
    )
    t_prep = time.perf_counter() - t0
    deadline = time.time() + timeout_s
    polls = 0
    while True:
        status = await svc.get_training_status(session_id=session_id)
        polls += 1
        if status["status"] in ("completed", "failed", "stopped"):
            break
        check(time.time() < deadline, f"training did not finish in {timeout_s} s: {status}")
        await asyncio.sleep(0.1)
    sessions = [s for s in await svc.list_sessions() if s["session_id"] == session_id]
    return {"status": status, "t_prep": t_prep, "t_total": time.perf_counter() - t0,
            "polls": polls, "sessions": sessions}


def _train_batch(images, masks, n: int, tile: int, device: str):
    """The first ``n`` fields' top-left tiles with their flow targets, as
    device tensors (images, flows, cellprob)."""
    bi = np.ascontiguousarray(CellposeFinetune._prepare_images(list(images[:n]))[:, :tile, :tile])
    # flows of the whole fields, as the app derives them, then cropped
    bf = np.stack([np.moveaxis(masks_to_flows(m), 0, -1)[:tile, :tile] for m in masks[:n]])
    bp = (masks[:n, :tile, :tile] > 0).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (bi, bf, bp)]


def cellpose_step_parity(card: str, images, masks, device: str) -> dict:
    """One train step at 2 x 128^2 of an f32 model (TF32 off) on the card
    and on the CPU, same weights and batch; and the bf16 step's loss."""
    model = CellposeNet(features=CELLPOSE_FEATURES, dtype=torch.float32)
    model.reset_parameters(SEED + 2)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def build(dtype):
        m = CellposeNet(features=CELLPOSE_FEATURES, dtype=dtype)
        m.load_state_dict(start)
        return m

    return train_step_parity(card, "cellpose train step, 2 x 128^2", build,
                             lambda where: _train_batch(images, masks, 2, 128, where), device)


def train_step_parity(card: str, what: str, build, batch, device: str,
                      make_step=make_train_step) -> dict:
    """One train step (``make_step()``) of ``build(torch.float32)`` (TF32
    off) on the card and on the CPU, same weights and ``batch(where)``; and
    the loss of the bf16 step ``build(torch.bfloat16)`` on the card against
    the f32 one."""
    out = {}
    for where, dtype in (("cpu", torch.float32), (device, torch.float32), (device, torch.bfloat16)):
        m = build(dtype)
        state = TrainState.create(m.to(where), 1e-4, 1e-5)
        _, metrics = make_step()(state, *batch(where))
        out[(where, dtype)] = (
            float(metrics["loss"]),
            {k: p.grad.detach().cpu() for k, p in m.named_parameters()},
        )
    loss_cpu, g_cpu = out[("cpu", torch.float32)]
    loss_dev, g_dev = out[(device, torch.float32)]
    loss_bf16, _ = out[(device, torch.bfloat16)]
    scale = max(g.abs().max().item() for g in g_cpu.values())
    grad_err = max((g_dev[k] - g_cpu[k]).abs().max().item() for k in g_cpu)
    loss_rel = abs(loss_dev - loss_cpu) / abs(loss_cpu)
    bf16_rel = abs(loss_bf16 - loss_dev) / abs(loss_dev)
    print(f"[{card}] {what}, f32 (TF32 off): card loss {loss_dev!r}, CPU "
          f"loss {loss_cpu!r} (rel {loss_rel:.3g}, bound {STEP_LOSS_RTOL}); gradients max abs "
          f"diff {grad_err:.3g} of largest {scale:.3g} (bound {STEP_GRAD_TOL} of it); bf16 step "
          f"loss {loss_bf16!r} (rel {bf16_rel:.3g} to f32, bound {STEP_BF16_RTOL})")
    check(np.isfinite([loss_cpu, loss_dev, loss_bf16]).all(), "non-finite step loss")
    check(loss_rel <= STEP_LOSS_RTOL, f"card vs CPU step loss rel {loss_rel}")
    check(grad_err <= STEP_GRAD_TOL * scale, f"card vs CPU gradients {grad_err} of {scale}")
    check(bf16_rel <= STEP_BF16_RTOL, f"bf16 vs f32 step loss rel {bf16_rel}")
    return {"loss_rel": loss_rel, "grad_err_rel": grad_err / scale, "bf16_loss_rel": bf16_rel}


def time_cellpose_step(card: str, images, masks, device: str) -> dict:
    """ms per train step (CUDA events over CELLPOSE_TIMED_STEPS steps after
    3 warm-up steps) at batch_size x tile^2, bf16, and a profile of one."""
    batch, tile = CELLPOSE_CFG["batch_size"], CELLPOSE_CFG["tile"]
    _, state = create_model_and_state(CellposeConfig(features=CELLPOSE_FEATURES), seed=SEED, device=device)
    tensors = _train_batch(images, masks, batch, tile, device)
    return time_train_step(card, f"cellpose train step, {batch} x {tile}^2, bf16, CellposeNet "
                           f"{CELLPOSE_FEATURES}", state, tensors, device)


def time_train_step(card: str, what: str, state: TrainState, tensors, device: str,
                    make_step=make_train_step) -> dict:
    """ms per train step (CUDA events over CELLPOSE_TIMED_STEPS steps after
    3 warm-up steps), peak device memory, and a profile of one step."""
    batch = tensors[0].shape[0]
    step = make_step()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ms = _device_ms(device, lambda: step(state, *tensors), iters=CELLPOSE_TIMED_STEPS, warmup=3)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    r = {"step_ms": ms, "tiles_per_s": batch / (ms / 1e3), "step_peak_gib": peak / 2**30}
    print(f"[{card}] {what}: {ms:.3f} ms per step (mean of {CELLPOSE_TIMED_STEPS} after 3 warm-up), "
          f"{r['tiles_per_s']:.1f} tiles/s, peak device memory {r['step_peak_gib']:.2f} GiB")
    if device == "cuda":
        r["profile"] = print_profile(card, f"one {what}", lambda: step(state, *tensors))
        r["busy_share"] = r["profile"][0]["busy_ms"] / ms
        print(f"[{card}] {what}: device busy {100 * r['busy_share']:.1f}% of a step "
              f"(profiled busy ms over the CUDA-event step time)")
    return r


async def _timed_requests(device: str, calls: dict, repeats: int) -> dict:
    """For each key: a warm-up call, then ``repeats`` timed calls, all on
    one event loop (so ``to_thread`` reuses warm worker threads, with their
    CUDA library handles, as a long-lived server does). Returns {key:
    (first result, last result, host ms per timed call)}."""
    out = {}
    for key, call in calls.items():
        first = await call()
        ms, last = [], first
        for _ in range(repeats):
            _sync(device)
            t0 = time.perf_counter()
            last = await call()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[key] = (first, last, ms)
    return out


def _host_ms(fn) -> tuple[object, float]:
    t0 = time.perf_counter()
    result = fn()
    return result, (time.perf_counter() - t0) * 1e3


def time_cellpose_infer(card: str, svc: CellposeFinetune, fields: dict, device: str,
                        session_id: str = "smoke", label: str = "cellpose") -> dict:
    """``infer`` per request (host clock), split into host pre-processing,
    ``_predict_raw`` (snapshot load, copy in, forward, copy out; its
    forward alone by device clock) and per image ``predictions_to_masks``
    (``follow_flows`` by device clock, host clustering); the card's follow
    held against the CPU's on the same raw prediction."""
    session = svc.sessions[session_id]
    calls = {
        key: (lambda imgs=imgs: svc.infer(session_id=session_id, images=imgs))
        for key, imgs in fields.items()
    }
    timed = asyncio.run(_timed_requests(device, calls, CELLPOSE_INFER_REPEATS))
    r: dict = {}
    for key, imgs in fields.items():
        first, out, ms = timed[key]
        for img, m, n in zip(imgs, out["masks"], out["n_cells"]):
            check(m.shape == img.shape[:2] and m.dtype == np.int32, f"infer {key}: mask {m.shape}")
            check(n == int(m.max()), f"infer {key}: n_cells {n} vs max {m.max()}")
        check(out["n_cells"] == first["n_cells"], f"infer {key}: repeated calls disagree")
        x, prep = _host_ms(lambda: svc._prepare_images(imgs))
        pred, raw = _host_ms(lambda: svc._predict_raw(session, x))
        model = svc._infer_models[finetune_service._arch_key(session.config)]
        xt = torch.from_numpy(finetune_service._to_model_channels(x, session.config)).to(device)
        with torch.inference_mode():
            fwd = _device_ms(device, lambda: model(xt), iters=5)
        _, to_masks = _host_ms(lambda: [predictions_to_masks(p, device=device) for p in pred])
        flow = torch.from_numpy(np.ascontiguousarray(np.moveaxis(pred[0, ..., :2], -1, 0) / FLOW_SCALE))
        flow_dev = flow.to(device)
        follow = _device_ms(device, lambda: follow_flows(flow_dev), iters=3)
        fg = pred[0, ..., 2] > 0.0
        p_dev = follow_flows(flow_dev).cpu().numpy()
        _, cluster = _host_ms(lambda: cluster_sinks(p_dev, fg, 15))
        r[key] = {"request_ms": float(np.mean(ms)), "request_ms_all": ms, "prepare_ms": prep,
                  "predict_raw_ms": raw, "forward_ms": fwd, "masks_ms": to_masks,
                  "follow_ms_per_image": follow, "cluster_ms_per_image": cluster,
                  "n_cells": out["n_cells"]}
        clock = "device" if device == "cuda" else "host"
        print(f"[{card}] {label} infer {key}: {np.mean(ms):.3f} ms mean per request over {len(ms)} "
              f"after a warm-up call ({[round(t, 3) for t in ms]}); host pre-processing {prep:.3f} ms, "
              f"_predict_raw {raw:.3f} ms (forward {fwd:.3f} ms {clock}), predictions_to_masks "
              f"{to_masks:.3f} ms for {len(imgs)} image(s): follow_flows {follow:.3f} ms {clock} and "
              f"host clustering {cluster:.3f} ms per image; n_cells {out['n_cells']}")
        if key == "2x512":
            p_cpu = follow_flows(flow).numpy()
            dist = np.sqrt(((p_dev - p_cpu) ** 2).sum(0))
            share = float(np.mean(dist <= FOLLOW_POS_TOL))
            agree = _matched_agreement(cluster_sinks(p_cpu, fg, 15), cluster_sinks(p_dev, fg, 15))
            r["follow_vs_cpu"] = {"max_px": float(dist.max()), "share_within": share,
                                  "mask_agreement": agree, "fg_pixels": int(fg.sum())}
            print(f"[{card}] {label} follow_flows card vs CPU, 512^2: max {dist.max():.3g} px, "
                  f"{100 * share:.4f}% within {FOLLOW_POS_TOL} px (bound {100 * FOLLOW_POS_SHARE}%); "
                  f"masks agree on {100 * agree:.4f}% of {int(fg.sum())} foreground pixels "
                  f"(bound {100 * FOLLOW_MASK_AGREE}%)")
            check(share >= FOLLOW_POS_SHARE, f"follow positions: {share} within {FOLLOW_POS_TOL} px")
            check(agree >= FOLLOW_MASK_AGREE, f"follow masks agree on {agree}")
    return r


def time_cellpose_infer_3d(card: str, svc: CellposeFinetune, device: str, session_id: str = "smoke",
                           anisotropies=(1.0, 2.0), label: str = "cellpose") -> dict:
    """``infer_3d`` per request (host clock, after a warm-up call), and
    ``follow_flows_3d`` alone (device clock) on the field it followed."""
    vol = synthetic_cell_volume(CELLPOSE_VOLUME, 40, SEED + 5)
    session = svc.sessions[session_id]
    calls = {
        a: (lambda a=a: svc.infer_3d(session_id=session_id, volumes=[vol], anisotropy=a))
        for a in anisotropies
    }
    timed = asyncio.run(_timed_requests(device, calls, 1))
    r = {}
    for anisotropy, (_, out, (ms,)) in timed.items():
        m = out["masks"][0]
        check(m.shape == CELLPOSE_VOLUME, f"infer_3d: masks {m.shape}")
        check(out["n_cells"] == [int(m.max())], f"infer_3d: n_cells {out['n_cells']}")
        # the follow alone, on the field the request followed
        depth = max(1, int(round(vol.shape[0] * anisotropy)))
        v = ndimage.zoom(vol, (depth / vol.shape[0], 1.0, 1.0), order=1) if anisotropy != 1.0 else vol
        lo, hi = np.percentile(v, [1, 99])
        v = (v - lo) / max(hi - lo, 1e-6)
        state = svc._load_snapshot(session)
        preds = []
        for axes in ((0, 1, 2), (1, 0, 2), (2, 0, 1)):
            s = np.ascontiguousarray(np.transpose(v, axes))
            preds.append(svc._predict_raw(session, np.stack([s, np.zeros_like(s)], -1), state=state))
        flow, _ = aggregate_orthogonal_flows(*preds)
        flow_dev = torch.from_numpy(flow / FLOW_SCALE).to(device)
        follow = _device_ms(device, lambda: follow_flows_3d(flow_dev), iters=1)
        r[str(anisotropy)] = {"request_ms": ms, "follow_3d_ms": follow, "n_cells": out["n_cells"],
                              "followed_shape": list(flow.shape[1:])}
        print(f"[{card}] {label} infer_3d {CELLPOSE_VOLUME} anisotropy {anisotropy}: {ms:.3f} ms "
              f"(after a warm-up call); follow_flows_3d over {list(flow.shape[1:])} "
              f"{follow:.3f} ms ({100 * follow / ms:.1f}% of the request); n_cells {out['n_cells']}")
    return r


def check_cellpose_export(card: str, svc: CellposeFinetune, field: np.ndarray, device: str,
                          session_id: str = "smoke", label: str = "cellpose") -> dict:
    exported = asyncio.run(svc.export_model(session_id=session_id))
    session = svc.sessions[session_id]
    # the served model takes the model's channels (cpsam: a zero third one)
    x = finetune_service._to_model_channels(svc._prepare_images([field]), session.config)
    dep = RuntimeDeployment(device=device)

    async def serve():
        try:
            return await dep.predict(exported["model_path"], {"input0": x})
        finally:
            await dep.close()

    t0 = time.perf_counter()
    served = asyncio.run(serve())
    t_serve = time.perf_counter() - t0
    out = served["output0"]
    raw = svc._predict_raw(session, x)
    err = float(np.abs(out - raw).max())
    span = float(raw.max() - raw.min())
    print(f"[{card}] {label} export served by RuntimeDeployment: output {out.shape}, max abs "
          f"{err:.4g} against _predict_raw (bound {EXPORT_TOL} x range {span:.4g}); package load + "
          f"first 512^2 request {t_serve:.3f} s")
    check(served["_meta"]["backend"] == device, f"served on {served['_meta']}")
    check(out.shape == raw.shape and out.shape[:3] == (1, CELLPOSE_FIELD, CELLPOSE_FIELD),
          f"served output {out.shape}, _predict_raw {raw.shape}")
    check(bool(np.isfinite(out).all()), "served output not finite")
    check(err <= EXPORT_TOL * span, f"served vs _predict_raw: {err} over {EXPORT_TOL * span}")
    return {"served_vs_raw_max_abs": err, "output_range": span}


def phase_cellpose(card: str, device: str = "cuda") -> dict:
    """Slice 3 at full width: train, check the card against the CPU, infer
    in 2D and 3D, export and serve; print the numbers beside the card."""
    t0 = time.perf_counter()
    images, masks = synthetic_cell_fields(CELLPOSE_FIELDS, CELLPOSE_FIELD, CELLPOSE_CELLS, SEED)
    big, _ = synthetic_cell_fields(1, 2 * CELLPOSE_FIELD, 4 * CELLPOSE_CELLS, SEED + 1)
    print(f"cellpose: CellposeNet {CELLPOSE_FEATURES}, bf16, {CELLPOSE_FIELDS} synthetic "
          f"{CELLPOSE_FIELD}^2 fields of ~{CELLPOSE_CELLS} cells drawn in "
          f"{time.perf_counter() - t0:.2f} s; config {CELLPOSE_CFG}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cp_") as root:
        svc = CellposeFinetune(sessions_root=root, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        attention.launch_count = 0
        r = asyncio.run(drive_cellpose(
            svc, images, masks, {"features": list(CELLPOSE_FEATURES), "seed": SEED, **CELLPOSE_CFG}))
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        status = r["status"]
        losses = status.get("losses", [])
        print(f"cellpose: status {status['status']}, epochs {status.get('current_epoch')}, "
              f"steps/epoch {status.get('steps_per_epoch')}, losses {losses}")
        check(status["status"] == "completed", f"training ended {status}")
        check(status["current_epoch"] == CELLPOSE_CFG["epochs"], f"epochs {status}")
        want_steps = CELLPOSE_FIELDS * (CELLPOSE_FIELD // CELLPOSE_CFG["tile"]) ** 2 // CELLPOSE_CFG["batch_size"]
        check(status["steps_per_epoch"] == want_steps, f"steps per epoch {status['steps_per_epoch']}")
        check(len(losses) == CELLPOSE_CFG["epochs"] and np.isfinite(losses).all(), f"losses {losses}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        check(r["sessions"][0]["snapshots"] == CELLPOSE_CFG["epochs"], f"sessions {r['sessions']}")
        n_steps = CELLPOSE_CFG["epochs"] * status["steps_per_epoch"]
        print(f"[{card}] cellpose training: data preparation (start_training, host) "
              f"{r['t_prep']:.3f} s; {n_steps} steps + 3 snapshots {r['t_total'] - r['t_prep']:.3f} s "
              f"host clock; peak device memory {peak / 2**30:.2f} GiB")
        timed = time_cellpose_step(card, images, masks, device)
        parity = cellpose_step_parity(card, images, masks, device)
        infer = time_cellpose_infer(
            card, svc, {"2x512": [images[0], images[1]], "1024": [big[0]]}, device)
        infer_3d = time_cellpose_infer_3d(card, svc, device)
        export = check_cellpose_export(card, svc, images[2], device)
        launches = attention.launch_count
    print(f"cellpose: flash_attn_fwd launches {launches} over the phase (CellposeNet runs no attention)")
    line = {
        "card": card, "features": list(CELLPOSE_FEATURES), **CELLPOSE_CFG,
        "data_prep_s": r["t_prep"], "train_s": r["t_total"] - r["t_prep"], "losses": losses,
        "train_peak_gib": peak / 2**30, **timed, "step_parity": parity,
        "infer": infer, "infer_3d": infer_3d, "export": export,
        "flash_attn_fwd_launches": launches,
    }
    print("cellpose " + json.dumps(line))
    return {"launches": launches, **line}


# ---- slice 4: the transformer backbones (cpsam, CellposeSAM) ------------------

# the published cpsam checkpoint shape: the app's "cpsam" defaults
# (apps/cellpose-finetuning/main.py:83-86) and models/sam.py's for the rest
CPSAM_ARCH = {
    "patch_size": 8, "dim": 1024, "depth": 24, "num_heads": 16, "window_size": 14,
    "global_attn_indexes": (5, 11, 17, 23), "neck_dim": 256, "pretrain_grid": 32,
}
# the f32 card-vs-CPU step: a depth-2 cut at full width, block 1 global
CPSAM_PARITY_ARCH = {**CPSAM_ARCH, "depth": 2, "global_attn_indexes": (1,)}
# config keys set beside the backbone; empty on the card, so both run at
# the app's defaults (cpsam: ViT-L, tile 256; sam: dim 256, depth 8, heads
# 8, patch 8, tile 128; both batch 8, lr 1e-4). A CPU rehearsal narrows
# them (and CPSAM_ARCH to match).
CPSAM_OVERRIDES: dict = {}
SAM_OVERRIDES: dict = {}
TRANSFORMER_EPOCHS = 3


def scaled_cpsam_state_dict(seed: int, **arch) -> dict[str, np.ndarray]:
    """``synthetic_cpsam_state_dict`` at flax's initialiser scales: weights
    by 1/sqrt(fan_in) (a transposed kernel's fan_in is its input channels x
    window), biases 0, norm scales 1, ``pos_embed`` and ``rel_pos_*`` by
    0.02. Unscaled standard-normal weights blow up a 24-block model."""
    sd = synthetic_cpsam_state_dict(**arch, seed=seed)
    for key, w in sd.items():
        if key.endswith("bias"):
            w[...] = 0.0
        elif key.endswith(("pos_embed", "rel_pos_h", "rel_pos_w")):
            w *= 0.02
        elif w.ndim == 1:  # LayerNorm scales
            w[...] = 1.0
        else:
            fan_in = (w.shape[0] if key == "out.weight" else w.shape[1]) * int(np.prod(w.shape[2:]))
            w *= fan_in ** -0.5
    return sd


def write_cpsam_checkpoint(card: str, root: str) -> tuple[str, dict]:
    """A torch-layout cpsam checkpoint at CPSAM_ARCH, written as a .pth and
    converted by the port's ``convert_checkpoint``; returns the npz path."""
    t0 = time.perf_counter()
    sd = scaled_cpsam_state_dict(SEED + 10, **CPSAM_ARCH)
    t_draw = time.perf_counter() - t0
    pth, npz = f"{root}/cpsam.pth", f"{root}/cpsam_jax_params.npz"
    t0 = time.perf_counter()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = convert_checkpoint("cpsam", pth, npz)
    t_convert = time.perf_counter() - t0
    flat = flatten_params(params)
    n_params = sum(int(v.size) for v in flat.values())
    check(len(flat) == len(sd) and n_params == sum(int(v.size) for v in sd.values()),
          f"converted {len(flat)} leaves of {len(sd)}")
    info = {"n_params": n_params, "pth_bytes": os.path.getsize(pth), "draw_s": t_draw,
            "torch_save_s": t_save, "convert_s": t_convert}
    print(f"[{card}] cpsam checkpoint: {n_params} parameters, {info['pth_bytes']} bytes; drawn in "
          f"{t_draw:.2f} s, torch.save {t_save:.2f} s, convert_checkpoint {t_convert:.2f} s")
    return npz, info


def _model_batch(images, masks, n: int, tile: int, cfg: dict, device: str):
    """``_train_batch`` with the model's input channels."""
    bi, bf, bp = _train_batch(images, masks, n, tile, "cpu")
    bi = torch.from_numpy(finetune_service._to_model_channels(bi.numpy(), cfg))
    return [t.to(device) for t in (bi, bf, bp)]


def _check_training(label: str, r: dict, cfg: dict, fields: int, field: int) -> list:
    status = r["status"]
    losses = status.get("losses", [])
    print(f"{label}: status {status['status']}, epochs {status.get('current_epoch')}, "
          f"steps/epoch {status.get('steps_per_epoch')}, losses {losses}")
    check(status["status"] == "completed", f"{label}: training ended {status}")
    check(status["current_epoch"] == TRANSFORMER_EPOCHS, f"{label}: epochs {status}")
    want_steps = fields * (field // cfg["tile"]) ** 2 // cfg["batch_size"]
    check(status["steps_per_epoch"] == want_steps, f"{label}: steps per epoch {status['steps_per_epoch']}")
    check(len(losses) == TRANSFORMER_EPOCHS and np.isfinite(losses).all(), f"{label}: losses {losses}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    check(r["sessions"][0]["snapshots"] == TRANSFORMER_EPOCHS, f"{label}: sessions {r['sessions']}")
    return losses


def run_transformer_backbone(card: str, svc: CellposeFinetune, label: str, config: dict,
                             images, masks, device: str, build_parity, parity_tile: int) -> dict:
    """One backbone through the user's path: train, time a step, the f32
    card-vs-CPU step, infer, infer_3d, export served by RuntimeDeployment."""
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    r = asyncio.run(drive_cellpose(svc, images, masks, config, session_id=label))
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    cfg = svc.sessions[label].config
    fields, field = images.shape[0], images.shape[1]
    losses = _check_training(label, r, cfg, fields, field)
    n_steps = TRANSFORMER_EPOCHS * r["status"]["steps_per_epoch"]
    print(f"[{card}] {label} training: data preparation (start_training, host) {r['t_prep']:.3f} s; "
          f"{n_steps} steps + {TRANSFORMER_EPOCHS} snapshots {r['t_total'] - r['t_prep']:.3f} s host "
          f"clock; peak device memory {peak / 2**30:.2f} GiB")

    # c. one train step at the app's batch and tile, from the session's
    # starting point (the converted checkpoint, or the seed)
    model, _ = finetune_service.build_model(cfg)
    if cfg.get("pretrained_path"):
        finetune_service._load_pretrained(model, cfg["pretrained_path"])
    else:
        model.reset_parameters(cfg["seed"])
    state = TrainState.create(model.to(device), cfg["learning_rate"], cfg["weight_decay"])
    batch, tile = cfg["batch_size"], cfg["tile"]
    timed = time_train_step(
        card, f"{label} train step, {batch} x {tile}^2, bf16", state,
        _model_batch(images, masks, batch, tile, cfg, device), device)
    del model, state
    _release(device)

    # d. f32 on the card against the CPU, 2 x parity_tile^2
    parity = train_step_parity(
        card, f"{label} train step, 2 x {parity_tile}^2", build_parity,
        lambda where: _model_batch(images, masks, 2, parity_tile, cfg, where), device)

    # e. live inference; f. the export served
    infer = time_cellpose_infer(card, svc, {"2x512": [images[0], images[1]]}, device,
                                session_id=label, label=label)
    infer_3d = time_cellpose_infer_3d(card, svc, device, session_id=label, anisotropies=(1.0,), label=label)
    export = check_cellpose_export(card, svc, images[2], device, session_id=label, label=label)
    svc._infer_models.clear()
    _release(device)
    return {
        "card": card, "backbone": cfg["backbone"], "arch": finetune_service._arch_entry(cfg)["kwargs"],
        "tile": tile, "batch_size": batch,
        "learning_rate": cfg["learning_rate"], "epochs": TRANSFORMER_EPOCHS,
        "data_prep_s": r["t_prep"], "train_s": r["t_total"] - r["t_prep"], "losses": losses,
        "train_peak_gib": peak / 2**30, **timed, "step_parity": parity,
        "infer": infer, "infer_3d": infer_3d, "export": export,
    }


def _release(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def phase_cellpose_transformers(card: str, device: str = "cuda") -> dict:
    """Slice 4 at full width: a cpsam checkpoint converted and fine-tuned
    (ViT-L, 8 x 256^2), then CellposeSAM at the app's defaults; each
    checked against the CPU, inferred in 2D and 3D, exported and served;
    one JSON line per backbone."""
    images, masks = synthetic_cell_fields(CELLPOSE_FIELDS, CELLPOSE_FIELD, CELLPOSE_CELLS, SEED)
    print(f"cellpose transformers: cpsam {CPSAM_ARCH} from a converted synthetic checkpoint, "
          f"then CellposeSAM at the app's defaults; {CELLPOSE_FIELDS} synthetic {CELLPOSE_FIELD}^2 "
          f"fields, {TRANSFORMER_EPOCHS} epochs each")
    lines = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tf_") as root:
        attention.launch_count = 0
        npz, ckpt = write_cpsam_checkpoint(card, root)
        svc = CellposeFinetune(sessions_root=f"{root}/sessions", device=device)

        parity_sd = scaled_cpsam_state_dict(SEED + 11, **CPSAM_PARITY_ARCH)
        parity_state = state_dict_from_flax(convert_state_dict(
            parity_sd, cpsam_name_map(CPSAM_PARITY_ARCH["depth"])))

        def build_cpsam(dtype):
            m = CpSAM(**CPSAM_PARITY_ARCH, dtype=dtype)
            m.load_state_dict(parity_state)
            return m

        cpsam_cfg = {"backbone": "cpsam", "pretrained_path": npz, "epochs": TRANSFORMER_EPOCHS,
                     "seed": SEED, **CPSAM_OVERRIDES}
        lines["cpsam"] = run_transformer_backbone(
            card, svc, "cpsam", cpsam_cfg, images, masks, device, build_cpsam, 128)
        # the session loaded the checkpoint leaf by leaf at exact shapes;
        # its config is the ViT-L one
        widths = ("patch_size", "dim", "depth", "num_heads")
        cfg = svc.sessions["cpsam"].config
        check([cfg[k] for k in widths] == [CPSAM_ARCH[k] for k in widths],
              f"cpsam session config {cfg} is not the checkpoint's {CPSAM_ARCH}")
        lines["cpsam"]["checkpoint"] = ckpt

        sam_cfg = {"backbone": "sam", "epochs": TRANSFORMER_EPOCHS, "seed": SEED, **SAM_OVERRIDES}
        sam_start = finetune_service.build_model(finetune_service._merge_config(sam_cfg))[0]
        sam_start.reset_parameters(SEED + 12)
        sam_state = {k: v.clone() for k, v in sam_start.state_dict().items()}

        def build_sam(dtype):
            cfg = finetune_service._merge_config(sam_cfg)
            m = CellposeSAM(patch_size=cfg["patch_size"], dim=cfg["dim"], depth=cfg["depth"],
                            num_heads=cfg["num_heads"], in_channels=2, dtype=dtype)
            m.load_state_dict(sam_state)
            return m

        lines["sam"] = run_transformer_backbone(
            card, svc, "sam", sam_cfg, images, masks, device, build_sam, 128)
        launches = attention.launch_count
    print(f"cellpose transformers: flash_attn_fwd launches {launches} over the phase "
          "(SAMAttention adds a rel-pos bias before its softmax; CellposeSAM's blocks take the "
          "inline attention, as the JAX app builds them)")
    check(launches == 0, f"the transformer backbones launched flash_attn_fwd {launches} times")
    for label, line in lines.items():
        print(f"cellpose_{label} " + json.dumps(line))
    return {"launches": launches, **lines}


# ---- slice 5: StarDist and the zoo's torch formats ---------------------------

# the app's stardist defaults (features, n_rays 32, max_dist 64, lr 1e-4)
# at the cellpose phase's batch and tile; the CPU rehearsal narrows them
STARDIST_CFG = {"backbone": "stardist", "features": [32, 64, 128, 256], "n_rays": 32, **CELLPOSE_CFG}
STARDIST_PARITY_TILE = 128
# a zoo package whose own architecture file is a plain-torch 2D U-Net at
# the registry UNet2D's widths; requests in its axes (bcyx)
ZOO_FEATURES = (32, 64, 128, 256)
ZOO_TEST_SHAPE = (1, 1, 256, 256)
ZOO_REQUESTS = {"512": (1, 1, 512, 512), "4x1024": (4, 1, 1024, 1024)}
ZOO_REPEATS = 5
# the card (f32, TF32 off) against the CPU, as a share of the output's range
ZOO_CARD_VS_CPU = 1e-4

ZOO_UNET_SOURCE = '''\
"""A plain-torch 2D U-Net, as a BioImage Model Zoo package ships its
architecture: NCHW, (conv 3x3, GroupNorm, SiLU) twice per level, 2x2 max
pool, 2x2 transposed convolution, [up, skip] on channels, 1x1 head."""
import torch
from torch import nn


class Block(nn.Sequential):
    def __init__(self, cin, cout):
        super().__init__(
            nn.Conv2d(cin, cout, 3, padding=1), nn.GroupNorm(min(32, cout), cout), nn.SiLU(),
            nn.Conv2d(cout, cout, 3, padding=1), nn.GroupNorm(min(32, cout), cout), nn.SiLU(),
        )


class UNet2D(nn.Module):
    def __init__(self, in_channels=1, out_channels=1, features=(32, 64, 128, 256)):
        super().__init__()
        ch = in_channels
        self.down = nn.ModuleList()
        for f in features[:-1]:
            self.down.append(Block(ch, f))
            ch = f
        self.bottom = Block(ch, features[-1])
        ch = features[-1]
        self.up = nn.ModuleList()
        self.dec = nn.ModuleList()
        for f in reversed(features[:-1]):
            self.up.append(nn.ConvTranspose2d(ch, f, 2, stride=2))
            self.dec.append(Block(2 * f, f))
            ch = f
        self.head = nn.Conv2d(ch, out_channels, 1)

    def forward(self, x):
        skips = []
        for block in self.down:
            x = block(x)
            skips.append(x)
            x = nn.functional.max_pool2d(x, 2)
        x = self.bottom(x)
        for up, dec, skip in zip(self.up, self.dec, skips[::-1]):
            x = dec(torch.cat([up(x), skip], 1))
        return self.head(x)
'''


def zoo_unet(features, seed: int) -> torch.nn.Module:
    """``ZOO_UNET_SOURCE``'s U-Net with weights from ``np.random.default_rng
    (seed)``: kernels ~ N(0, 1/fan_in), zero biases, unit norm scales."""
    namespace: dict = {}
    exec(ZOO_UNET_SOURCE, namespace)
    module = namespace["UNet2D"](features=tuple(features)).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1:
                p.fill_(0.0 if name.endswith("bias") else 1.0)
            else:
                transposed = isinstance(module.get_submodule(name.rsplit(".", 1)[0]), torch.nn.ConvTranspose2d)
                fan_in = (p.shape[0] if transposed else p.shape[1]) * int(np.prod(p.shape[2:]))
                p.copy_(torch.from_numpy(rng.normal(0.0, fan_in ** -0.5, p.shape).astype(np.float32)))
    return module


def write_zoo_collection(root: str, features, seed: int) -> tuple[str, torch.nn.Module]:
    """A one-model collection under ``root``: ``zoo-unet`` with its own
    ``arch.py``, a ``pytorch_state_dict`` entry, a ``torchscript`` twin
    (the same module, traced) and test tensors computed by the module on
    the CPU in f32; ``rdf.yaml`` and ``collection.yaml`` as JSON text.
    Returns the package dir and the module."""
    d = f"{root}/zoo-unet"
    os.makedirs(d)
    module = zoo_unet(features, seed)
    with open(f"{d}/arch.py", "w") as f:
        f.write(ZOO_UNET_SOURCE)
    torch.save(module.state_dict(), f"{d}/weights.pt")
    x = np.random.default_rng(seed + 1).standard_normal(ZOO_TEST_SHAPE, np.float32)
    with torch.no_grad():
        torch.jit.trace(module, torch.from_numpy(x)).save(f"{d}/weights_torchscript.pt")
        y = module(torch.from_numpy(x)).numpy()
    np.save(f"{d}/test_input.npy", x)
    np.save(f"{d}/test_output.npy", y)
    rdf = {
        "type": "model", "format_version": "0.5.3", "name": "zoo-unet",
        "description": "plain-torch 2D U-Net, seeded weights", "tags": ["segmentation"],
        "inputs": [{"name": "raw", "axes": "bcyx", "test_tensor": {"source": "test_input.npy"}}],
        "outputs": [{"name": "mask", "axes": "bcyx", "test_tensor": {"source": "test_output.npy"}}],
        "weights": {
            "pytorch_state_dict": {
                "source": "weights.pt",
                "architecture": {"source": "arch.py", "callable": "UNet2D",
                                 "kwargs": {"features": list(features)}},
            },
            "torchscript": {"source": "weights_torchscript.pt"},
        },
    }
    with open(f"{d}/rdf.yaml", "w") as f:
        f.write(json.dumps(rdf, indent=1))
    with open(f"{root}/collection.yaml", "w") as f:
        f.write(json.dumps({"bioengine_inference": {"zoo-unet": {"status": "passed"}}}))
    return d, module


def _stardist_batch(session, n: int, tile: int, device: str):
    """The first ``n`` fields' top-left tiles with the targets the session
    derived, as device tensors (images, prob, dist)."""
    with np.load(session.data_dir / "train.npz") as data:
        arrays = [np.ascontiguousarray(data[k][:n, :tile, :tile]) for k in ("images", "prob", "dist")]
    return [torch.from_numpy(a).to(device) for a in arrays]


def time_stardist_infer(card: str, svc: CellposeFinetune, imgs, device: str, session_id: str) -> dict:
    """``infer`` per request (host clock, mean after a warm-up call on one
    event loop), split into host pre-processing, ``_predict_raw`` (its
    forward alone by device clock) and host polygon NMS and rendering."""
    session = svc.sessions[session_id]
    timed = asyncio.run(_timed_requests(
        device, {"2x512": lambda: svc.infer(session_id=session_id, images=imgs)}, CELLPOSE_INFER_REPEATS))
    first, out, ms = timed["2x512"]
    for img, m, n in zip(imgs, out["masks"], out["n_cells"]):
        check(m.shape == img.shape[:2] and m.dtype == np.int32, f"stardist infer: mask {m.shape}")
        check(n == int(m.max()), f"stardist infer: n_cells {n} vs max {m.max()}")
    check(out["n_cells"] == first["n_cells"], "stardist infer: repeated calls disagree")
    x, prep = _host_ms(lambda: svc._prepare_images(imgs))
    pred, raw = _host_ms(lambda: svc._predict_raw(session, x))
    model = svc._infer_models[finetune_service._arch_key(session.config)]
    xt = torch.from_numpy(x).to(device)
    with torch.inference_mode():
        fwd = _device_ms(device, lambda: model(xt), iters=5)
    masks, nms = _host_ms(lambda: [predictions_to_masks_stardist(p) for p in pred])
    check([int(m.max()) for m in masks] == out["n_cells"], "stardist infer: host split disagrees")
    n_cand = [int((p[..., 0] > 0.0).sum()) for p in pred]
    clock = "device" if device == "cuda" else "host"
    print(f"[{card}] stardist infer 2x512: {np.mean(ms):.3f} ms mean per request over {len(ms)} after a "
          f"warm-up call ({[round(t, 3) for t in ms]}); host pre-processing {prep:.3f} ms, _predict_raw "
          f"{raw:.3f} ms (forward {fwd:.3f} ms {clock}), polygon NMS + rendering {nms:.3f} ms host for "
          f"{len(imgs)} images ({n_cand} candidates above probability 0.5); n_cells {out['n_cells']}")
    return {"request_ms": float(np.mean(ms)), "request_ms_all": ms, "prepare_ms": prep,
            "predict_raw_ms": raw, "forward_ms": fwd, "nms_render_ms": nms,
            "candidates": n_cand, "n_cells": out["n_cells"]}


def run_stardist(card: str, root: str, images, masks, device: str) -> dict:
    """StarDist through the app: train at the app's defaults, time and
    profile a step, the f32 step on the card against the CPU, infer, and
    the export served by RuntimeDeployment."""
    svc = CellposeFinetune(sessions_root=f"{root}/sessions", device=device)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    label = "stardist"
    r = asyncio.run(drive_cellpose(svc, images, masks, {**STARDIST_CFG, "seed": SEED}, session_id=label))
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    session = svc.sessions[label]
    cfg = session.config
    losses = _check_training(label, r, cfg, images.shape[0], images.shape[1])
    n_steps = cfg["epochs"] * r["status"]["steps_per_epoch"]
    print(f"[{card}] stardist training: data preparation (start_training, host; masks_to_stardist on "
          f"{images.shape[0]} fields) {r['t_prep']:.3f} s; {n_steps} steps + {cfg['epochs']} snapshots "
          f"{r['t_total'] - r['t_prep']:.3f} s host clock; peak device memory {peak / 2**30:.2f} GiB")

    model, _ = finetune_service.build_model(cfg)
    model.reset_parameters(cfg["seed"])
    state = TrainState.create(model.to(device), cfg["learning_rate"], cfg["weight_decay"])
    batch, tile = cfg["batch_size"], cfg["tile"]
    timed = time_train_step(
        card, f"stardist train step, {batch} x {tile}^2, bf16, StarDist2D {cfg['features']} "
        f"n_rays {cfg['n_rays']}", state, _stardist_batch(session, batch, tile, device), device,
        make_step=make_stardist_train_step)
    del model, state
    _release(device)

    start = finetune_service.build_model(cfg)[0]
    start.reset_parameters(SEED + 20)
    start_state = {k: v.clone() for k, v in start.state_dict().items()}

    def build(dtype):
        m = StarDist2D(n_rays=cfg["n_rays"], features=tuple(cfg["features"]), in_channels=2, dtype=dtype)
        m.load_state_dict(start_state)
        return m

    parity = train_step_parity(
        card, f"stardist train step, 2 x {STARDIST_PARITY_TILE}^2", build,
        lambda where: _stardist_batch(session, 2, STARDIST_PARITY_TILE, where), device,
        make_step=make_stardist_train_step)
    infer = time_stardist_infer(card, svc, [images[0], images[1]], device, label)
    export = check_cellpose_export(card, svc, images[2], device, session_id=label, label=label)
    svc._infer_models.clear()
    _release(device)
    return {
        "card": card, "arch": finetune_service._arch_entry(cfg)["kwargs"], "tile": tile,
        "batch_size": batch, "learning_rate": cfg["learning_rate"], "epochs": cfg["epochs"],
        "data_prep_s": r["t_prep"], "train_s": r["t_total"] - r["t_prep"], "losses": losses,
        "train_peak_gib": peak / 2**30, **timed, "step_parity": parity, "infer": infer, "export": export,
    }


async def drive_zoo(entry: EntryDeployment, package: str, inputs: dict) -> dict:
    """The zoo package as a user drives it: ``test`` for each format, then
    each request (a warm-up call, then ZOO_REPEATS timed calls) in each
    format through ``EntryDeployment.infer``."""
    await entry.async_init()
    r: dict = {"ms": {}, "first_s": {}}
    r["test"] = {"pytorch_state_dict": await entry.test("zoo-unet", skip_cache=True)}
    # EntryDeployment.test serves the preferred format; the twin is tested
    # on the cached package through the runtime
    r["test"]["torchscript"] = await entry.runtime_deployment.test(
        package, weights_format="torchscript", skip_cache=True)
    for fmt in ("pytorch_state_dict", "torchscript"):
        for key, x in inputs.items():
            def call(fmt=fmt, x=x):
                return entry.infer(model_id="zoo-unet", inputs={"raw": x}, weights_format=fmt)

            t0 = time.perf_counter()
            await call()
            r["first_s"][f"{fmt}/{key}"] = time.perf_counter() - t0
            out, ms = await _timed(entry.runtime_deployment.backend, ZOO_REPEATS, call)
            r[f"{fmt}/{key}"], r["ms"][f"{fmt}/{key}"] = out, ms
    r["status"] = await entry.runtime_deployment.get_status()
    r["load"] = {p.weights_format: p.load_info for p in entry.runtime_deployment._pipelines.values()}
    return r


def run_zoo(card: str, root: str, device: str) -> dict:
    """Both zoo torch formats served on the card through EntryDeployment
    over a LocalCollectionSource, held against the module on the CPU."""
    collection = f"{root}/collection"
    os.makedirs(collection)
    package, module = write_zoo_collection(collection, ZOO_FEATURES, SEED + 30)
    rng = np.random.default_rng(SEED + 31)
    inputs = {key: rng.standard_normal(shape, np.float32) for key, shape in ZOO_REQUESTS.items()}
    os.environ["BIOENGINE_LOCAL_MODEL_PATH"] = collection
    # PyTorch's default lets cuDNN use TF32: the runner turns it off itself
    tf32_before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    entry = EntryDeployment(cache_dir=f"{root}/model-cache", device=device)
    try:
        r = asyncio.run(drive_zoo(entry, str(entry.model_cache._package_dir("zoo-unet", False)), inputs))
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    finally:
        asyncio.run(entry.close())
        torch.backends.cudnn.allow_tf32 = tf32_before
        del os.environ["BIOENGINE_LOCAL_MODEL_PATH"]

    for fmt, rep in r["test"].items():
        check(rep["status"] == "passed" and rep.get("output_matches_expected") and rep["backend"] == "torch"
              and rep["weights_format"] == fmt, f"zoo test {fmt}: {rep}")
    # the card against the module on the CPU: the 512^2 request and the
    # first image of the batch (GroupNorm is per sample)
    with torch.no_grad():
        want = {"512": module(torch.from_numpy(inputs["512"])).numpy(),
                "4x1024": module(torch.from_numpy(inputs["4x1024"][:1])).numpy()}
    errs = {}
    for fmt in ("pytorch_state_dict", "torchscript"):
        for key, x in inputs.items():
            out = r[f"{fmt}/{key}"]
            check(out["_meta"]["backend"] == "torch" and out["_meta"]["weights_format"] == fmt,
                  f"zoo {fmt} {key}: {out['_meta']}")
            y = out["mask"]
            check(y.shape == x.shape and bool(np.isfinite(y).all()), f"zoo {fmt} {key}: output {y.shape}")
            ref = want[key]
            err = float(np.abs(y[: len(ref)] - ref).max())
            span = float(ref.max() - ref.min())
            errs[f"{fmt}/{key}"] = {"max_abs": err, "range": span}
            check(err <= ZOO_CARD_VS_CPU * span, f"zoo {fmt} {key}: card vs CPU {err} over "
                  f"{ZOO_CARD_VS_CPU} x range {span}")
    status = r["status"]
    check({p["weights_format"] for p in status["loaded_pipelines"]} == {"pytorch_state_dict", "torchscript"}
          and all(p["backend"] == "torch" and "TF32 off" in p["precision"] for p in status["loaded_pipelines"]),
          f"zoo status {status}")
    print(f"zoo: plain-torch UNet2D {ZOO_FEATURES} in f32, its own arch.py; cuDNN TF32 allowed around the "
          f"requests (PyTorch's default), turned off by the runner; test: "
          + ", ".join(f"{fmt} {rep['status']} ({rep['duration_seconds']} s)" for fmt, rep in r["test"].items()))
    mp = {key: float(np.prod(shape)) / shape[1] / 1e6 for key, shape in ZOO_REQUESTS.items()}
    for name, ms in r["ms"].items():
        fmt, key = name.split("/")
        ms = np.array(ms)
        print(f"[{card}] zoo {fmt} {key}: {ms.mean():.3f} ms mean per request over {len(ms)} after a "
              f"warm-up call (min {ms.min():.3f}, max {ms.max():.3f}); {mp[key] / (ms.mean() / 1e3):.2f} MP/s; "
              f"first call {r['first_s'][name]:.3f} s; card vs CPU max abs {errs[name]['max_abs']:.3g} of "
              f"range {errs[name]['range']:.4g}")
    for fmt, info in r["load"].items():
        print(f"[{card}] zoo {fmt} load (build + weights onto the card): {info['weights_seconds']} s")
    print(f"[{card}] zoo peak device memory {peak / 2**30:.2f} GiB")
    return {"card": card, "features": list(ZOO_FEATURES), "precision": status["loaded_pipelines"][0]["precision"],
            "request_ms": {k: float(np.mean(v)) for k, v in r["ms"].items()}, "request_ms_all": r["ms"],
            "first_request_s": r["first_s"], "load_s": {k: v["weights_seconds"] for k, v in r["load"].items()},
            "test": {k: v["status"] for k, v in r["test"].items()}, "card_vs_cpu": errs,
            "peak_gib": peak / 2**30}


def phase_zoo(card: str, device: str = "cuda") -> dict:
    """Slice 5 at full width: StarDist2D through the app, then the zoo's
    torch formats through the entry deployment; one ``zoo`` JSON line."""
    images, masks = synthetic_cell_fields(CELLPOSE_FIELDS, CELLPOSE_FIELD, CELLPOSE_CELLS, SEED)
    print(f"zoo phase: StarDist2D {STARDIST_CFG['features']} n_rays {STARDIST_CFG['n_rays']}, bf16, on "
          f"{CELLPOSE_FIELDS} synthetic {CELLPOSE_FIELD}^2 fields, config {STARDIST_CFG}; then a zoo "
          f"package (plain-torch UNet2D {ZOO_FEATURES}) in pytorch_state_dict and torchscript")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as root:
        attention.launch_count = 0
        stardist = run_stardist(card, root, images, masks, device)
        zoo = run_zoo(card, root, device)
        launches = attention.launch_count
    print(f"zoo phase: flash_attn_fwd launches {launches} (StarDist2D and the zoo U-Net run no attention)")
    check(launches == 0, f"the zoo phase launched flash_attn_fwd {launches} times")
    print("zoo " + json.dumps({"stardist": stardist, "zoo": zoo, "flash_attn_fwd_launches": launches}))
    return {"launches": launches, "stardist": stardist, "zoo": zoo}


def main() -> int:
    card, name = phase_device()
    ptxas = phase_build(card)
    main_case = phase_kernels(card)
    launches = phase_main_path(card)
    forward = phase_forward(card)
    model_runner = phase_model_runner(card)
    cellpose = phase_cellpose(card)
    transformers = phase_cellpose_transformers(card)
    zoo = phase_zoo(card)
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "bioengine_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "bioengine_tpu/ops/pallas/attention.py:36",
        "path": main_case["path"],
        "launches": launches,
        # slices 2-5 launch no attention kernel: their counts stay 0
        "launches_by_path": {"cell_image_search": launches,
                             "model_runner": model_runner["launches"],
                             "cellpose": cellpose["launches"],
                             "cellpose_transformers": transformers["launches"],
                             "zoo": zoo["launches"]},
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"],
        "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "forward_ms": forward["kernel"],
        "forward_plain_ms": forward["plain"],
        "ptxas": ptxas[attention.KERNEL_NAME],
        "smem_bytes": attention.launch_plan(main_case["shape"], torch.bfloat16).smem_bytes,
        "card": card,
    }]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
