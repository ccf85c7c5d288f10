#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. device: CUDA must be there; prints the card's name and power limit;
2. build: nvcc builds every kernel under bioengine_tpu_torch/csrc, and
   ptxas's registers, shared memory and spills are printed per kernel;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and the test suite's, with CUDA-event times; for flash
   attention both paths, bf16 (wgmma) and f32 (3xTF32), both on the tensor
   cores, at every head dim across tile edges; the f32 main case is timed in
   turns beside the plain version and SDPA (plain, kernel, SDPA, SDPA,
   kernel, plain), with SDPA's own error against the plain version;
4. the main path: cell-image-search at ViT-B/14 width (dim 768, depth 12,
   heads 12, 224², bf16, bucket 64, weights from a numpy seed) ingests
   synthetic fields, builds a FlatIP index and answers ping,
   get_index_stats and 8 searches, with the kernels' launch counts read
   around it and the embeddings held against the plain attention path;
   then the same in float32 (``phase_main_path_f32``, ``model_overrides``
   ``{"dtype": "float32"}``, TF32 off): 12 launches per forward, min cosine
   0.99999 against the plain-attention embedder, and images/s and one
   bucket forward's device ms with the kernel, the plain attention and
   SDPA (a yardstick only) as ``attn_fn``, in turns;
5. cell-image-search at corpus scale (slice 6), ``phase_index``: the app
   at the same width registers a synthetic dataset of 8 896^2 fields,
   ingests it in a background session (FlatIP), stops a second session of
   64 fields, lists sessions and datasets, removes one, computes the 2-D
   map, projects a query and answers 8 searches with their
   ``query_projection`` (a corpus crop must come back first); then a seeded
   1M x 768 mixture of 10,000 components with 64 perturbed queries and
   exact f32 top-10 on the card: ``build_index`` IVFFlat over 200K (nlist
   447; k-means, sort and save seconds, npz size) reloaded and served by
   the app, IVFFlat nlist 1000 and IVFPQ nlist 4096 over 1M (training
   seconds on the card, host search ms at Q = 1 and 64, recall@10 held
   to floors), the card's nearest-centroid assignment and one Lloyd update
   against the CPU's on a 20K-row sample and two k-means fits on the card
   bit for bit, ``build_index`` of the 1M rows
   for a 20M-cell target and of 5M real rows, which must both pick
   ``PQFlatTPU`` on the card with the same peak device memory (training
   takes 1M rows, encoding streams chunks); the 1M build's codes plus
   seeded uniform ones make 20M codes (1.92 GB) on the card: scan ms at
   Q = 1 and per 26-query chunk against the bytes bound, scores against
   the numpy ADC sums within 1e-5, self ranks, recall floor, peak memory;
   the attention kernel's count read around the phase;
6. the device time of one bucket forward through the kernel and through
   the plain attention, in turns;
7. the model-runner path (slice 2): ``jax_params`` packages written here
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
8. the cellpose fine-tuning path (slice 3): ``CellposeFinetune`` trains
   ``CellposeNet`` (32, 64, 128, 256) in bf16 for 3 epochs at 8 x 256^2 on
   16 synthetic 512^2 fields of ellipse cells (loss must fall); a train
   step timed with CUDA events and profiled; one f32 step (TF32 off) on
   the card against the CPU, and the bf16 step's loss against it; ``infer``
   on 2 x 512^2 and 1024^2 split into forward, ``follow_flows`` and host
   clustering, with the card's follow held against the CPU's; ``infer_3d``
   on a 32 x 256^2 stack at anisotropy 1 and 2; ``export_model`` served by
   ``RuntimeDeployment`` against ``_predict_raw``; one ``cellpose`` JSON
   line of the numbers;
9. the transformer backbones (slice 4): a torch-layout cpsam checkpoint at
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
10. StarDist and the zoo's torch formats (slice 5): ``CellposeFinetune``
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
11. token generation (slice 7): the ``generate`` app at the repo's
   decoder (``DecoderConfig()``, seed 0) on the card: ``async_init``,
   ``test_deployment``, ``generate_stream("the cell divides", 32)`` equal
   to the golden fixture's greedy tokens, ``resume_from=10`` the suffix,
   unary ``generate`` the stream, the KV drained; the engine alone:
   prefill and step logits through its graphs against the fixture (2e-4)
   and the CPU port (1e-5), a co-batch of 3 prompts across KV buckets
   equal to the CPU port's tokens, one graph per bucket and none built on
   repeat, one steady step's host ms beside its graph's device ms;
   bench.py's token-streaming legs (8 bulk streams x 48 tokens, one
   interactive stream, a join mid-batch); then ``DecoderConfig(d_model
   768, 12 heads, 12 layers, d_ff 3072)``: 16 greedy tokens and logits
   against the CPU port (1e-3), the throughput leg and a steady step;
   the attention kernel's count stays 0; one ``decode`` JSON line;
12. the serving plane (slice 8), ``phase_serving``: whether aiohttp,
   msgpack, yaml and psutil import here; ``detect_topology()`` against
   ``torch.cuda``; the model-runner bundle built by ``AppBuilder`` and
   deployed on ``ServeController(ClusterState(detect_topology()))`` with
   the UNet2D/UNet3D packages of step 7 in a local collection: the runtime
   replica holds one chip (chip 0 on one card) on its ``cuda:i``, the entry
   none; 10 timed rounds of 32 concurrent 512^2 predicts through the
   runtime's handle as shipped (batching max 8 / 5 ms,
   ``max_ongoing_requests`` 4), with 8 requests let in, and with
   ``max_batch: 1``, each output within 2e-2 of the direct
   ``RuntimeDeployment.predict``, with the median requests/s and its
   spread, batches, occupancy, queue wait p50/p99, and one more round
   under ``torch.profiler`` whose device busy time (the union of its
   kernels, copies and memsets) over its wall is the busy share; the
   entry's tiled 2048^2 ``infer`` and the 96 x 256^2 volume
   beside 16 replays (graph captures beside replays), each equal to its
   direct result bit for bit; a load that wants a second runtime replica,
   a pending workload on one chip; the undeploy, after which the allocated
   device memory is back within 64 MiB and the chips are free; a deployment
   whose ``async_init`` raises fails typed, frees the chip and deploys on
   retry; the attention kernel's count stays 0; one ``serving`` JSON line;
13. the worker (slice 9), ``phase_worker``: whether httpx, cloudpickle and
   aiohttp import, whether the native shm store built, which codecs load;
   a Zarr dataset of 16 synthetic 896^2 fields (zstd where it loads) under
   the worker's ``datasets_dir``; ``BioEngineWorker(device="cuda")`` in
   process, driven over a ``connect_to_server`` WebSocket client:
   ``get_status`` names the card; the cell-image-search bundle deployed
   through the apps manager at ViT-B/14 width (bucket 64), ingesting the
   dataset from the worker's own datasets plane; 16 searches over the
   WebSocket, the same 16 through the HTTP ``/call`` bridge and on the
   deployed instance in process, all equal, and one MCP ``tools/call``;
   ms per search on each path and the wire's cost; the flash kernel's
   launches equal 12 x the app's forwards; ``start_profiling`` /
   ``stop_profiling`` around 2 searches (the trace holds a ``flash_attn``
   kernel) and ``memory_profile``; the model-runner bundle deployed through
   the same worker (after the search app's undeploy: one card) with 16
   512^2 f32 predicts over the wire against the direct predicts and the
   in-process handle, with bytes and ms per request and the path (shm or
   wire frames) that carried them; ``run_code`` with one chip sees one
   card; the worker stops, its lock is released, the allocated memory is
   back within 64 MiB; the searches equal, bit for bit,
   ``CellImageSearch(device="cuda")`` built here on the same seed over the
   worker's index; then ``python -m bioengine_tpu_torch.worker`` as a
   subprocess answers ``/health/liveness``, names the card through the
   bridge with its admin token and exits 0 on SIGTERM; one ``worker`` JSON
   line;
14. one JSON line of the kernels' numbers;
15. the result line ``{"ok": true, "device": {...}}``, printed last.

Any failed check exits non-zero before the result line. f32 comparisons
run with TF32 off for both cuBLAS and cuDNN, so the plain versions are full
f32.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import importlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import aiohttp
import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from bioengine_tpu_torch.apps.builder import AppBuilder
from bioengine_tpu_torch.apps.cell_image_search.embedder import ViTEmbedder
from bioengine_tpu_torch.apps.cell_image_search.index import (
    IVFFLAT_MAX_CELLS,
    IVFFlatIndex,
    IVFPQIndex,
    PQFlatIndex,
    build_index,
    load_index,
)
from bioengine_tpu_torch.apps.cell_image_search.ingestion import (
    extract_cell_crops,
    make_synthetic_images,
)
from bioengine_tpu_torch.apps.cell_image_search.service import CellImageSearch
from bioengine_tpu_torch.apps.cellpose_finetuning import service as finetune_service
from bioengine_tpu_torch.apps.cellpose_finetuning.service import CellposeFinetune
from bioengine_tpu_torch.apps.generate.service import GenerateDeployment
from bioengine_tpu_torch.apps.model_runner.entry import EntryDeployment
from bioengine_tpu_torch.apps.model_runner.runtime import RuntimeDeployment
from bioengine_tpu_torch.cluster.state import ClusterState
from bioengine_tpu_torch.cluster.topology import detect_topology
from bioengine_tpu_torch.datasets import codecs, zarr_codec
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
from bioengine_tpu_torch.ops import kmeans
from bioengine_tpu_torch.ops.knn import pq_scan_topk, topk_inner_product
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
from bioengine_tpu_torch.runtime.buckets import bucket_batch, bucket_dim
from bioengine_tpu_torch.runtime.decode_engine import (
    DecodeEngine,
    DecoderConfig,
    init_decoder_params,
)
from bioengine_tpu_torch.runtime.program_cache import CompiledProgramCache
from bioengine_tpu_torch.runtime.rdf import apply_processing, from_nhwc, to_nhwc
from bioengine_tpu_torch.runtime.weight_stream import write_manifest
from bioengine_tpu_torch.serving.decode import DecodeLoop
from bioengine_tpu_torch.native import store as native_store
from bioengine_tpu_torch.rpc import connect_to_server
from bioengine_tpu_torch.serving import DeploymentHandle, DeploymentSpec, ReplicaState, ServeController
from bioengine_tpu_torch.worker.worker import BioEngineWorker

SEED = 0
BUCKET = 64
VIT_DEPTH = 12
N_FIELDS = 4
N_SEARCHES = 8
TOP_K = 10
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores, dense TF32 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32_FLOPS = 495e12
F32_COSINE_FLOOR = 0.99999  # f32 kernel vs plain-attention embeddings
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
] + [
    # the f32 (tf32x3) path at every head dim, across tile edges and ragged ends
    (f"f32_d{d}_n{n}", (2, 3, n, d), torch.float32, False)
    for d in (32, 64, 128)
    for n in (1, 64, 65, 257, 300)
] + [
    (f"f32_d{d}_n257_causal", (2, 3, 257, d), torch.float32, True)
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
    HBM bandwidth, against 4*B*H*N^2*d FLOP over the peak of the products'
    type. f32-grade products on the tensor cores are 3xTF32: three tf32
    products each at the TF32 peak (``attention_cuda_core_ms`` gives the same
    work on the CUDA cores)."""
    B, H, N, d = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    t_bytes = 4 * B * H * N * d * itemsize / PEAK_BYTES_PER_S
    flops = 4 * B * H * N * N * d
    t_ops = 3 * flops / PEAK_TF32_FLOPS if dtype == torch.float32 else flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_cuda_core_ms(shape) -> float:
    """4*B*H*N^2*d f32 FLOP over the CUDA cores' f32 peak, in ms."""
    B, H, N, d = shape
    return 4 * B * H * N * N * d / PEAK_FLOPS[torch.float32] * 1e3


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
    for kernel in ("flash_attn_wgmma_kernel<64>", *(
        f"flash_attn_tf32x3_kernel<{d}>" for d in attention.HEAD_DIMS
    )):
        info = ptxas.get(attention.KERNEL_NAME, {}).get(kernel)
        check(info is not None and "registers" in info, f"no ptxas report for {kernel}")
    return ptxas


def time_in_turns(fns: dict, order, device: str = "cuda") -> dict:
    """ms per call of each named fn (CUDA events on the card, mean of 20
    after 3 warm-ups), timed in ``order``: name -> list of ms."""
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(_device_ms(device, fns[name], iters=20, warmup=3))
    return times


def phase_kernels(card: str) -> dict:
    """Each attention case: the kernel against the plain version, both on
    the card. Returns the main path's numbers by dtype."""
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
        if label == MAIN_CASE:
            line["kernel_ms"] = cuda_ms(lambda: attention.flash_attention(q, k, v))
            line["plain_ms"] = cuda_ms(lambda: attention.reference_attention(q, k, v))
            line["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v)
            )
        elif label.startswith(MAIN_CASE):
            # f32: in turns, plain, kernel, SDPA, SDPA, kernel, plain
            times = time_in_turns(
                {
                    "plain": lambda: attention.reference_attention(q, k, v),
                    "kernel": lambda: attention.flash_attention(q, k, v),
                    "library": lambda: F.scaled_dot_product_attention(q, k, v),
                },
                ("plain", "kernel", "library", "library", "kernel", "plain"),
            )
            for name, ms in times.items():
                line[f"{name}_ms"] = sum(ms) / len(ms)
                line[f"{name}_ms_turns"] = ms
            lib = F.scaled_dot_product_attention(q, k, v)
            # the library's own f32 attention against the same plain version
            line["library_max_abs_err"] = (lib.float() - ref.float()).abs().max().item()
            line["bound_cuda_core_ms"] = attention_cuda_core_ms(shape)
            del lib
        if label.startswith(MAIN_CASE):
            line["bound_ms"], line["bound_by"] = attention_bound_ms(shape, dtype)
            line["card"] = card
            main[dtype] = line
        print("attention " + json.dumps(line))
        del q, k, v, out, ref, diff
    return main


def synthetic_crops(seed: int, n_fields: int, size: int = 896) -> list[np.ndarray]:
    crops = []
    for _, field in make_synthetic_images(n_images=n_fields, size=size, seed=seed):
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
    crops, queries, probe = main_path_inputs()
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
    check_main_path(r, crops, probe, launches, forwards, embed_dim)

    # for comparison only: the same weights with the plain attention
    plain = ViTEmbedder(
        batch_bucket=BUCKET, device="cuda", seed=SEED,
        attn_fn=attention.reference_attention, model_overrides={"depth": VIT_DEPTH},
    )
    ref = plain.embed_batch(crops[:BUCKET])
    cos = np.sum(ref * r["emb"][:BUCKET], axis=1)
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


def main_path_inputs() -> tuple[list, list, int]:
    """The crops of N_FIELDS synthetic fields, N_SEARCHES queries (the first
    one a corpus crop) and that crop's index."""
    crops = synthetic_crops(SEED, N_FIELDS)
    check(len(crops) > TOP_K, f"only {len(crops)} crops from {N_FIELDS} fields")
    probe = 5
    queries = [crops[probe]] + synthetic_crops(SEED + 1, 1)[: N_SEARCHES - 1]
    check(len(queries) == N_SEARCHES, f"{len(queries)} queries")
    return crops, queries, probe


def check_main_path(r: dict, crops, probe: int, launches: int, forwards: int,
                    embed_dim: int, device: str = "cuda") -> None:
    check(launches > 0, "the main path launched no flash_attn_fwd kernel")
    check(launches == VIT_DEPTH * forwards, f"{launches} launches for {forwards} forwards")
    emb = r["emb"]
    check(emb.shape == (len(crops), embed_dim) and np.isfinite(emb).all(), f"embeddings {emb.shape}")
    check(np.isfinite(r["bucket_emb"]).all(), "non-finite embeddings in the full buckets")
    norms = np.linalg.norm(emb, axis=1)
    check(np.abs(norms - 1).max() <= 1e-3, f"norms off by {np.abs(norms - 1).max()}")
    check(r["stats"]["loaded"] and r["stats"]["n_cells"] == len(crops), f"stats {r['stats']}")
    check(r["stats"]["index_type"] == "FlatIP", f"stats {r['stats']}")
    check(r["ping"]["status"] == "ok" and r["ping"]["backend"] == device, f"ping {r['ping']}")
    print("ping " + json.dumps(r["ping"]))
    for i, found in enumerate(r["found"]):
        scores = [x["score"] for x in found["results"]]
        check(found["n_results"] == TOP_K, f"search {i}: {found['n_results']} results")
        check(all(np.isfinite(scores)) and scores == sorted(scores, reverse=True),
              f"search {i}: scores {scores}")
    top = r["found"][0]["results"][0]
    check(top["index_id"] == probe and top["crop"] == probe and top["score"] >= 0.99,
          f"corpus crop {probe} came back as {top}")


MAIN_F32_VIT = {"depth": VIT_DEPTH}  # ViT-B/14 at full width


def phase_main_path_f32(card: str, device: str = "cuda") -> dict:
    """The main path in float32: the service with ``"dtype": "float32"`` in
    its model overrides (TF32 off, so the ViT's GEMMs are full f32) runs its
    attention through the kernel's tf32x3 path."""
    crops, queries, probe = main_path_inputs()
    overrides = {**MAIN_F32_VIT, "dtype": "float32"}
    print(f"main path f32: ViT-B/14 (768 wide, {VIT_DEPTH} deep, 12 heads, 224^2, float32), "
          f"bucket {BUCKET}, {len(crops)} crops from {N_FIELDS} synthetic 896^2 fields")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f32_") as workspace:
        svc = CellImageSearch(
            workspace_dir=workspace, batch_bucket=BUCKET, device=device, seed=SEED,
            model_overrides=overrides,
        )
        _sync(device)
        attention.launch_count = 0
        r = asyncio.run(drive_main_path(svc, crops, queries, workspace))
        launches = attention.launch_count
        forwards = svc.embedder.forward_count
        embed_dim = svc.embedder.embed_dim
    print(f"main path f32: {forwards} bucket forwards, flash_attn_fwd launches {launches}")
    # on the CPU (a rehearsal) the wrapper takes the plain version: no launch
    check_main_path(r, crops, probe, launches if device == "cuda" else VIT_DEPTH * forwards,
                    forwards, embed_dim, device)
    check(svc.embedder._model.dtype == torch.float32, f"model dtype {svc.embedder._model.dtype}")

    # for comparison only: the same weights with the plain attention, and
    # with SDPA (a yardstick; the port never calls it)
    embedders = {
        "kernel": svc.embedder,
        "plain": ViTEmbedder(batch_bucket=BUCKET, device=device, seed=SEED,
                             attn_fn=attention.reference_attention, model_overrides=overrides),
        "sdpa": ViTEmbedder(batch_bucket=BUCKET, device=device, seed=SEED,
                            attn_fn=F.scaled_dot_product_attention, model_overrides=overrides),
    }
    ref = embedders["plain"].embed_batch(crops[:BUCKET])
    cos = np.sum(ref * r["emb"][:BUCKET], axis=1)
    sdpa_cos = np.sum(ref * embedders["sdpa"].embed_batch(crops[:BUCKET]), axis=1)
    print(f"f32 kernel vs plain attention embeddings: min cosine {cos.min():.8f}, max abs "
          f"{np.abs(ref - r['emb'][:BUCKET]).max():.3e} over {len(cos)} rows "
          f"(SDPA vs plain: min cosine {sdpa_cos.min():.8f})")
    check(cos.min() >= F32_COSINE_FLOOR, f"f32 min cosine {cos.min()} under {F32_COSINE_FLOOR}")

    full = (crops * (3 * BUCKET // len(crops) + 1))[: 3 * BUCKET]
    order = ("kernel", "plain", "sdpa", "sdpa", "plain", "kernel")
    rates = {name: [] for name in embedders}
    for name in order:
        t0 = time.perf_counter()
        embedders[name].embed_batch(full)
        rates[name].append(len(full) / (time.perf_counter() - t0))
    x = torch.from_numpy(
        np.random.default_rng(SEED).standard_normal((BUCKET, 224, 224, 3), np.float32)
    ).to(device)
    with torch.inference_mode():
        forward_ms = time_in_turns(
            {name: (lambda e=e: e._model(x)) for name, e in embedders.items()}, order, device
        )
    print(f"[{card}] f32 embed, 3 full buckets of {BUCKET} (host clock), in turns {order}: "
          f"images/s kernel {rates['kernel']}, plain attention {rates['plain']}, SDPA {rates['sdpa']}")
    print(f"[{card}] f32 bucket forward (CUDA events, mean of 20 after 3 warm-up), same turns: "
          f"ms kernel {forward_ms['kernel']}, plain attention {forward_ms['plain']}, "
          f"SDPA {forward_ms['sdpa']}")
    out = {"launches": launches, "forwards": forwards, "min_cosine": float(cos.min()),
           "images_per_s": rates, "forward_ms": forward_ms, "card": card}
    print("main_path_f32 " + json.dumps(out))
    del embedders, svc, x
    _release(device)
    return out


# ---- slice 6: cell-image-search at corpus scale ------------------------------

INGEST_IMAGES = 8  # synthetic 896^2 fields of the ingested dataset
INGEST_IMAGE_SIZE = 896
STOP_IMAGES = 64  # the dataset whose session is stopped
INDEX_VIT = {"depth": VIT_DEPTH}  # ViT-B/14 at full width
INDEX_N = 1_000_000  # corpus vectors, 768 wide
INDEX_DIM = 768
INDEX_CLUSTERS = 10_000  # mixture components the corpus is drawn from
INDEX_SPREAD = 1.0  # noise norm around a component's unit centre
INDEX_QUERIES = 64
QUERY_SPREAD = 0.1  # noise norm of a query around its corpus vector
INDEX_IVF_ROWS = 200_000  # the build_index IVFFlat corpus (nlist 447)
IVFFLAT_NLIST, IVFFLAT_NPROBE = 1000, 16
IVFPQ_NLIST = 4096
PQ_TOTAL = 20_000_000  # codes on the card: the real ones plus seeded uniform codes
PQ_SELF_QUERIES = 8
RECALL_K = 10
# the card's PQ scan against the numpy ADC sums of the JAX class's search
PQ_SCORE_TOL = 1e-5
# recall@10 floors on the 1M mixture, set under the first readings on the
# card (0.905, 0.416-0.419, 0.498-0.500; PERF.md): a wrong assignment or
# update in training shows as lost recall
RECALL_FLOOR = {"ivfflat": 0.85, "ivfpq": 0.35, "pqflat": 0.45}
# the card's k-means against the CPU's: sample rows, seeded centres among
# them, two nearest squared distances closer than KMEANS_TIE_TOL are a
# tie, updated centres within KMEANS_TOL
KMEANS_ROWS, KMEANS_CENTRES = 20_000, 1000
KMEANS_TIE_TOL, KMEANS_TOL = 1e-6, 1e-5
# build_index of PQ_BUILD_ROWS real rows, the least corpus whose codes stay
# on the card; its peak device memory may exceed the 1M build's (both train
# on 1M rows) by PQ_MEMORY_SLACK at most: every row on the card in f32
# twice with its labels and distances would add ~7 KB a row, 28 GB
PQ_BUILD_ROWS = IVFFLAT_MAX_CELLS
PQ_MEMORY_SLACK = 64 << 20
INDEX_TIMEOUT_S = 900


def mixture_corpus(n: int, d: int, n_clusters: int, seed: int, device: str) -> torch.Tensor:
    """(n, d) f32 unit rows, each a unit centre of one of ``n_clusters``
    seeded components plus isotropic noise of norm ~INDEX_SPREAD, drawn on
    ``device`` from a seeded generator: neighbours exist, so recall means
    something."""
    g = torch.Generator(device=device).manual_seed(seed)
    centres = torch.randn((n_clusters, d), generator=g, device=device)
    centres /= centres.norm(dim=1, keepdim=True)
    which = torch.randint(n_clusters, (n,), generator=g, device=device)
    x = centres[which]
    x += torch.randn((n, d), generator=g, device=device) * (INDEX_SPREAD / d ** 0.5)
    return x / x.norm(dim=1, keepdim=True)


def recall_at_k(found: np.ndarray, truth: np.ndarray) -> float:
    k = truth.shape[1]
    return float(np.mean([len(set(f[:k]) & set(t)) / k for f, t in zip(found, truth)]))


async def _poll_session(svc: CellImageSearch, sid: str, until) -> dict:
    deadline = time.time() + INDEX_TIMEOUT_S
    while True:
        status = await svc.get_ingestion_status(session_id=sid)
        if until(status):
            return status
        check(time.time() < deadline, f"session {sid}: {status}")
        await asyncio.sleep(0.1)


async def drive_index_service(svc: CellImageSearch, queries) -> dict:
    """The app's own flow: register, ingest in the background, stop a second
    session, list, map, search; returns what the checks need."""
    r: dict = {}
    done = ("completed", "failed", "stopped")
    await svc.async_init()
    await svc.add_dataset("demo", source="synthetic", n_images=INGEST_IMAGES,
                          image_size=INGEST_IMAGE_SIZE)
    t0 = time.perf_counter()
    await svc.start_ingestion("demo", session_id="demo")
    r["demo"] = await _poll_session(svc, "demo", lambda s: s["status"] in done)
    r["t_ingest"] = time.perf_counter() - t0
    r["stats"] = await svc.get_index_stats()

    await svc.add_dataset("stopme", source="synthetic", n_images=STOP_IMAGES,
                          image_size=INGEST_IMAGE_SIZE)
    await svc.start_ingestion("stopme", session_id="stopme")
    r["before_stop"] = await _poll_session(
        svc, "stopme", lambda s: s["status"] in done or s.get("n_embedded", 0) > 0)
    r["stop"] = await svc.stop_ingestion("stopme")
    r["stopped"] = await _poll_session(svc, "stopme", lambda s: s["status"] in done)
    r["sessions"] = await svc.get_active_sessions()
    r["datasets"] = await svc.list_datasets()
    r["removed"] = await svc.remove_dataset("stopme")
    r["datasets_after"] = await svc.list_datasets()

    t0 = time.perf_counter()
    r["preview"] = await svc.get_umap_preview()
    r["t_preview"] = time.perf_counter() - t0
    r["projected"] = await svc.project_query_onto_umap(queries[0])
    r["found"], r["search_ms"] = [], []
    for q in queries:
        t0 = time.perf_counter()
        r["found"].append(await svc.search(image=q, top_k=TOP_K))
        r["search_ms"].append((time.perf_counter() - t0) * 1e3)
    return r


def check_index_service(card: str, r: dict, crops, probe: int) -> None:
    demo, stats = r["demo"], r["stats"]
    check(demo["status"] == "completed", f"ingestion session: {demo}")
    check(demo["n_embedded"] == len(crops), f"{demo['n_embedded']} embedded, {len(crops)} crops")
    check(stats["loaded"] and stats["index_type"] == "FlatIP" and stats["n_cells"] == len(crops),
          f"stats {stats}")
    before = r["before_stop"]
    check(before["status"] == "running" and before["n_embedded"] > 0,
          f"the second session before its stop: {before}")
    check(r["stop"]["stop_requested"], f"stop_ingestion: {r['stop']}")
    check(r["stopped"]["status"] == "stopped", f"stopped session: {r['stopped']}")
    check(set(r["sessions"]) == {"demo", "stopme"}, f"sessions {sorted(r['sessions'])}")
    check({d["name"] for d in r["datasets"]["registered"]} == {"demo", "stopme"}, "registry")
    check(r["removed"] == {"removed": True}, f"remove_dataset: {r['removed']}")
    check([d["name"] for d in r["datasets_after"]["registered"]] == ["demo"], "registry after remove")
    preview = r["preview"]
    check(preview["n_total"] == len(crops) and len(preview["x"]) == len(crops)
          and np.isfinite(preview["x"]).all() and np.isfinite(preview["y"]).all(),
          f"preview of {preview['n_total']} cells")
    check(set(r["projected"]) == {"x", "y"}, f"projection {r['projected']}")
    for i, found in enumerate(r["found"]):
        scores = [x["score"] for x in found["results"]]
        check(found["n_results"] == TOP_K and scores == sorted(scores, reverse=True),
              f"search {i}: {found['n_results']} results")
        proj = found["query_projection"]
        check(proj is not None and np.isfinite([proj["x"], proj["y"]]).all(),
              f"search {i}: query_projection {proj}")
    top = r["found"][0]["results"][0]
    check(top["index_id"] == probe and top["image"] == "synthetic_0000" and top["crop"] == probe
          and top["score"] >= 0.99, f"corpus crop {probe} came back as {top}")
    pos, first = r["projected"], r["found"][0]["query_projection"]
    check(abs(pos["x"] - first["x"]) + abs(pos["y"] - first["y"]) <= 1e-3,
          f"project_query_onto_umap {pos} vs search {first}")
    ms = np.array(r["search_ms"])
    print(f"[{card}] index service: ingested {demo['n_embedded']} crops of {INGEST_IMAGES} "
          f"{INGEST_IMAGE_SIZE}^2 fields in {r['t_ingest']:.3f} s (session {demo['elapsed_seconds']} s, "
          f"{demo['throughput_per_sec']} crops/s, FlatIP); stopped session at "
          f"{r['stopped']['n_embedded']} of ~{STOP_IMAGES * 50} crops; preview "
          f"{r['t_preview']:.3f} s; search {ms.mean():.2f} ms mean over {len(ms)} "
          f"(min {ms.min():.2f}, max {ms.max():.2f}) with query_projection")


def index_corpus_scale(card: str, svc: CellImageSearch, workspace: str, query_image,
                       device: str) -> dict:
    """The four index kinds over a seeded 1M x 768 mixture: builds timed,
    searches timed against exact f32 top-10 on the device, the PQ scan held
    against the numpy ADC and read at 20M codes."""
    out: dict = {}
    t0 = time.perf_counter()
    emb_dev = mixture_corpus(INDEX_N, INDEX_DIM, INDEX_CLUSTERS, SEED, device)
    emb = emb_dev.cpu().numpy()
    rng = np.random.default_rng(SEED)
    qids = rng.choice(INDEX_N, size=INDEX_QUERIES, replace=False)
    q = emb[qids] + QUERY_SPREAD * rng.standard_normal((INDEX_QUERIES, INDEX_DIM)).astype(
        np.float32) / INDEX_DIM ** 0.5
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    _, truth = topk_inner_product(emb_dev, torch.from_numpy(q).to(device), RECALL_K)
    truth = truth.cpu().numpy()
    del emb_dev
    out["t_data"] = time.perf_counter() - t0
    check(np.mean(truth[:, 0] == qids) >= 0.99, "perturbed queries lost their own vector")
    print(f"[{card}] index corpus: {INDEX_N} x {INDEX_DIM} f32 unit vectors from {INDEX_CLUSTERS} "
          f"seeded components, {INDEX_QUERIES} perturbed queries, exact top-{RECALL_K} on the "
          f"device; {out['t_data']:.3f} s")

    # IVFFlat through build_index, served by the app after a reload
    n_ivf = min(INDEX_IVF_ROWS, INDEX_N)
    rows = [{"crop": j} for j in range(n_ivf)]
    stats = build_index(emb[:n_ivf], rows, workspace, n_cells_total=INDEX_IVF_ROWS, device=device)
    check(stats["index_type"] == "IVFFlat", f"build_index at {INDEX_IVF_ROWS}: {stats}")

    async def reload_and_search():
        await svc.async_init()
        return await svc.get_index_stats(), await svc.search(image=query_image, top_k=TOP_K)

    served_stats, served = asyncio.run(reload_and_search())
    check(served_stats["index_type"] == "IVFFlat" and served_stats["n_cells"] == n_ivf,
          f"served stats {served_stats}")
    check(served["n_results"] == TOP_K, f"served search: {served['n_results']} results")
    out["build_index_ivfflat"] = {k: stats[k] for k in ("build_seconds", "index_size_mb",
                                                        "build_split_seconds")}
    print(f"[{card}] build_index IVFFlat over {n_ivf}: nlist "
          f"{len(svc._index.centroids)}, {stats['build_seconds']:.3f} s "
          f"{json.dumps(stats['build_split_seconds'])}, npz {stats['index_size_mb']:.1f} MB; "
          f"served search {served['search_ms']} ms (embed {served['embed_ms']} ms)")

    # IVFFlat over the whole corpus
    ivf = IVFFlatIndex.build(emb, IVFFLAT_NLIST, nprobe=IVFFLAT_NPROBE, device=device)
    _, ms1 = _host_ms(lambda: [ivf.search(qq, RECALL_K) for qq in q])
    (_, ids), ms64 = _host_ms(lambda: ivf.search(q, RECALL_K))
    out["ivfflat"] = {**ivf.build_info, "search_ms_q1": ms1 / INDEX_QUERIES,
                      "search_ms_q64": ms64, "recall_at_10": recall_at_k(ids, truth)}
    del ivf
    print(f"[{card}] IVFFlat nlist {IVFFLAT_NLIST} nprobe {IVFFLAT_NPROBE} over {INDEX_N}: "
          f"{json.dumps(out['ivfflat'])}")
    check_recall("ivfflat", out["ivfflat"]["recall_at_10"])

    # IVFPQ over the whole corpus
    ivfpq = IVFPQIndex.build(emb, IVFPQ_NLIST, device=device)
    _, ms1 = _host_ms(lambda: [ivfpq.search(qq, RECALL_K) for qq in q])
    (_, ids), ms64 = _host_ms(lambda: ivfpq.search(q, RECALL_K))
    out["ivfpq"] = {**ivfpq.build_info, "search_ms_q1": ms1 / INDEX_QUERIES,
                    "search_ms_q64": ms64, "recall_at_10": recall_at_k(ids, truth)}
    del ivfpq
    print(f"[{card}] IVFPQ nlist {IVFPQ_NLIST} nprobe 32, 96 x 8 bits over {INDEX_N}: "
          f"{json.dumps(out['ivfpq'])}")
    check_recall("ivfpq", out["ivfpq"]["recall_at_10"])
    out["kmeans_vs_cpu"] = kmeans_card_vs_cpu(card, emb, device)
    out["pqflat"] = pqflat_at_scale(card, emb, q, qids, truth, workspace, device)
    return out


def check_recall(kind: str, recall: float) -> None:
    check(recall >= RECALL_FLOOR[kind], f"{kind} recall@10 {recall} under {RECALL_FLOOR[kind]}")


def _clear_of_ties(x: np.ndarray, centres: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(nearest centre of each row, whether its two nearest squared
    distances differ by more than KMEANS_TIE_TOL), in float64 on the host."""
    x64, c64 = x.astype(np.float64), centres.astype(np.float64)
    d2 = (x64 * x64).sum(1)[:, None] - 2 * x64 @ c64.T + (c64 * c64).sum(1)[None]
    two = np.partition(d2, 1, axis=1)[:, :2]
    return d2.argmin(1), two[:, 1] - two[:, 0] > KMEANS_TIE_TOL


def kmeans_card_vs_cpu(card: str, emb: np.ndarray, device: str) -> dict:
    """The card's nearest-centroid labels against float64 argmins, one
    Lloyd update from the same seeded centres against the CPU's, ties
    aside, and two k-means fits on the card bit for bit: what the builds'
    training runs on, checked directly."""
    rng = np.random.default_rng(SEED + 3)
    x = emb[np.sort(rng.choice(len(emb), size=KMEANS_ROWS, replace=False))]
    centres = x[np.sort(rng.choice(KMEANS_ROWS, size=KMEANS_CENTRES, replace=False))]
    want, clear = _clear_of_ties(x, centres)
    got = {}
    for where in (device, "cpu"):
        xt = torch.from_numpy(x).to(where)[None]
        ct = torch.from_numpy(centres).to(where)[None]
        labels = kmeans.nearest_centroids(xt, ct)[0][0].cpu().numpy()
        got[where] = labels, kmeans.lloyd_step(xt, ct)[0].cpu().numpy()
    labels, new = got[device]
    cpu_labels, cpu_new = got["cpu"]
    # a build is the same on every run: k-means twice on the device
    xt = torch.from_numpy(x).to(device)[None]
    fits = [kmeans.fit(xt, KMEANS_CENTRES, [SEED]).cpu().numpy() for _ in range(2)]
    check(np.array_equal(*fits), f"k-means on {device} differs between two runs")
    del xt
    wrong = int((labels[clear] != want[clear]).sum())
    check(clear.mean() > 0.99 and wrong == 0,
          f"nearest_centroids on {device}: {wrong} of {int(clear.sum())} clear rows off the argmin")
    check(np.array_equal(cpu_labels[clear], want[clear]), "nearest_centroids on the CPU")
    # clusters no tied row joins have the same members on both sides
    touched = np.zeros(KMEANS_CENTRES, bool)
    touched[labels[~clear]] = touched[cpu_labels[~clear]] = True
    err = float(np.abs(new[~touched] - cpu_new[~touched]).max())
    check(err <= KMEANS_TOL, f"Lloyd update on {device} vs the CPU: {err}")
    r = {"rows": KMEANS_ROWS, "centres": KMEANS_CENTRES, "ties": int((~clear).sum()),
         "label_mismatches": wrong, "lloyd_max_abs_err": err}
    print(f"[{card}] k-means on {device} vs the CPU over {KMEANS_ROWS} x {INDEX_DIM} rows and "
          f"{KMEANS_CENTRES} seeded centres: {json.dumps(r)}")
    return r


def _build_peak(device: str, build) -> tuple[dict, int]:
    """(build(), its peak device bytes above what was allocated before)."""
    _release(device)
    base = torch.cuda.memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    stats = build()
    _sync(device)
    return stats, (torch.cuda.max_memory_allocated() - base if device == "cuda" else 0)


def build_index_at_threshold(card: str, emb: np.ndarray, workspace: str, device: str,
                             peak_1m: int) -> dict:
    """build_index of PQ_BUILD_ROWS real rows (the corpus's, then seeded
    mixture parts drawn on the device): the kind, the split and a peak
    device memory no larger than the 1M build's, since both train on 1M
    rows and the encoding streams chunks."""
    n = max(PQ_BUILD_ROWS, len(emb))
    t0 = time.perf_counter()
    big = np.empty((n, INDEX_DIM), np.float32)
    big[: len(emb)] = emb
    for i, r0 in enumerate(range(len(emb), n, len(emb))):
        r1 = min(n, r0 + len(emb))
        big[r0:r1] = mixture_corpus(r1 - r0, INDEX_DIM, INDEX_CLUSTERS, SEED + 10 + i,
                                    device).cpu().numpy()
    rows = [{"crop": j} for j in range(n)]
    t_data = time.perf_counter() - t0
    # n itself at full size; the smallest target that selects a PQ kind
    target = max(n, IVFFLAT_MAX_CELLS)
    stats, peak = _build_peak(device, lambda: build_index(
        big, rows, os.path.join(workspace, "pq_threshold"), n_cells_total=target, device=device))
    del big, rows
    want = "PQFlatTPU" if device == "cuda" else "IVFPQ"
    check(stats["index_type"] == want and stats["n_cells"] == n,
          f"build_index of {n} rows on {device}: {stats}")
    check(peak - peak_1m <= PQ_MEMORY_SLACK,
          f"build_index peak {peak} B at {n} rows, {peak_1m} B at {len(emb)}")
    r = {"rows": n, "data_s": t_data, "build_seconds": stats["build_seconds"],
         "build_split_seconds": stats["build_split_seconds"], "npz_mb": stats["index_size_mb"],
         "peak_bytes": peak, "peak_bytes_1m": peak_1m}
    print(f"[{card}] build_index of {n} real rows ({t_data:.3f} s to draw): "
          f"{stats['index_type']}, {stats['build_seconds']:.3f} s "
          f"{json.dumps(stats['build_split_seconds'])}, npz {stats['index_size_mb']:.1f} MB; "
          f"peak device memory {peak / 2**30:.3f} GiB above the baseline against "
          f"{peak_1m / 2**30:.3f} GiB at {len(emb)} rows ({peak - peak_1m} B more)")
    return r


def pqflat_at_scale(card: str, emb, q, qids, truth, workspace: str, device: str) -> dict:
    """build_index of the corpus's rows for a 20M-cell target (the card
    keeps the codes), then the scan over those codes padded to 20M."""
    rows = [{"crop": j} for j in range(len(emb))]
    pq_ws = os.path.join(workspace, "pq")
    stats, peak = _build_peak(device, lambda: build_index(
        emb, rows, pq_ws, n_cells_total=PQ_TOTAL, device=device))
    want = "PQFlatTPU" if device == "cuda" else "IVFPQ"
    check(stats["index_type"] == want, f"build_index at {PQ_TOTAL} on {device}: {stats}")
    out = {"build_index": stats["build_split_seconds"], "build_index_seconds": stats["build_seconds"],
           "npz_mb": stats["index_size_mb"], "build_index_rows": stats["n_cells"],
           "build_peak_bytes": peak}
    print(f"[{card}] build_index of {stats['n_cells']} rows for {PQ_TOTAL} cells: "
          f"{stats['index_type']}, {stats['build_seconds']:.3f} s "
          f"{json.dumps(stats['build_split_seconds'])}, npz {stats['index_size_mb']:.1f} MB, "
          f"peak device memory {peak / 2**30:.3f} GiB above the baseline")
    out["threshold"] = build_index_at_threshold(card, emb, workspace, device, peak)
    if device == "cuda":
        real, _, _ = load_index(pq_ws, device)
        out.update(pqflat_scan(card, real, emb, q, qids, truth, device))
    return out


def pqflat_scan(card: str, real: PQFlatIndex, emb, q, qids, truth, device: str) -> dict:
    """The PQ scan over ``real``'s codes padded with seeded uniform codes to
    PQ_TOTAL: scores against the numpy ADC sums, self ranks, times against
    the bytes bound, peak memory."""
    n_real = real.ntotal
    rng = np.random.default_rng(SEED + 7)
    fill = np.frombuffer(rng.bytes((PQ_TOTAL - n_real) * real.M), np.uint8)
    codes = np.concatenate([real.codes, fill.reshape(-1, real.M)])
    big = PQFlatIndex(real.codebooks, codes, device=device)
    del fill, codes
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    codes_t = big.codes_on_device()
    _sync(device)
    t_upload = time.perf_counter() - t0

    # the card's scores on the real codes against the numpy ADC sums
    s, ids = big.search(q[:2], RECALL_K)
    offs = np.arange(real.M) * real.KSUB
    for row in range(2):
        lut = np.einsum("mkd,md->mk", real.codebooks, q[row].reshape(real.M, real.dsub)).ravel()
        adc = lut[real.codes.astype(np.int32) + offs].sum(axis=1)
        check(bool((ids[row] < n_real).all()), f"query {row}: a uniform code in the top {RECALL_K}")
        err = float(np.abs(s[row] - adc[ids[row]]).max())
        check(err <= PQ_SCORE_TOL, f"query {row}: card vs numpy ADC {err}")
        ref = -np.sort(-adc)[:RECALL_K]
        check(float(np.abs(s[row] - ref).max()) <= PQ_SCORE_TOL,
              f"query {row}: top scores {s[row]} vs {ref}")
    # a corpus vector's own code ranks first among all of them
    selves = qids[:PQ_SELF_QUERIES]
    _, own = big.search(emb[selves], 1)
    check(np.array_equal(own[:, 0], selves), f"self ranks: {own[:, 0]} for {selves}")

    _, host_q1 = _host_ms(lambda: big.search(q[:1], RECALL_K), repeats=5)
    (_, ids64), host_q64 = _host_ms(lambda: big.search(q, RECALL_K), repeats=2)
    q_chunk = min(len(q), max(1, int(big.SCORE_BUDGET_BYTES // (big.ntotal * 4))))
    luts = torch.from_numpy(np.einsum("mkd,qmd->qmk", big.codebooks,
                                      q.reshape(len(q), big.M, big.dsub))).to(device)
    dev_q1 = _device_ms(device, lambda: pq_scan_topk(luts[:1], codes_t, RECALL_K), iters=5)
    dev_chunk = _device_ms(device, lambda: pq_scan_topk(luts[:q_chunk], codes_t, RECALL_K), iters=3)
    n_chunks = -(-len(q) // q_chunk)
    code_bytes = big.ntotal * big.M
    bound_q1 = code_bytes / PEAK_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    r = {
        "codes": big.ntotal, "code_bytes": code_bytes, "upload_s": t_upload, "q_chunk": q_chunk,
        "host_ms_q1": host_q1, "host_ms_q64": host_q64, "host_ms_per_query_q64": host_q64 / len(q),
        "device_ms_q1": dev_q1, "device_ms_chunk": dev_chunk,
        "device_ms_per_query_chunked": dev_chunk / q_chunk,
        "bound_ms_q1": bound_q1, "bound_ms_q64": n_chunks * bound_q1, "bound_by": "bytes",
        "recall_at_10": recall_at_k(ids64, truth), "peak_gib": peak / 2**30,
    }
    print(f"[{card}] PQFlat scan over {big.ntotal} codes ({code_bytes / 1e9:.2f} GB on the device; "
          f"{n_real} real + seeded uniform): {json.dumps(r)}")
    print(f"[{card}] PQFlat scan bound: the codes read once per query chunk at "
          f"{PEAK_BYTES_PER_S / 1e12} TB/s = {bound_q1:.4f} ms per chunk; Q=1 device "
          f"{dev_q1:.3f} ms ({dev_q1 / bound_q1:.1f}x the bound), {q_chunk}-query chunk "
          f"{dev_chunk:.3f} ms; peak device memory {peak / 2**30:.2f} GiB")
    check_recall("pqflat", r["recall_at_10"])
    return r


def phase_index(card: str, device: str = "cuda") -> dict:
    """Slice 6: the app's ingestion sessions, registry, map and search at
    ViT-B/14 width, then the four index kinds at corpus scale; the attention
    kernel's count read around the whole phase."""
    crops = synthetic_crops(SEED, INGEST_IMAGES, INGEST_IMAGE_SIZE)
    probe = 5
    queries = [crops[probe]] + synthetic_crops(SEED + 1, 1)[: N_SEARCHES - 1]
    print(f"index phase: ViT {INDEX_VIT} (768 wide, 12 heads, 224^2, bf16), bucket {BUCKET}; "
          f"ingestion of {INGEST_IMAGES} synthetic {INGEST_IMAGE_SIZE}^2 fields "
          f"({len(crops)} crops); corpus {INDEX_N} x {INDEX_DIM}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_index_") as workspace:
        svc = CellImageSearch(workspace_dir=workspace, batch_bucket=BUCKET, device=device,
                              seed=SEED, model_overrides=INDEX_VIT)
        attention.launch_count = 0
        r = asyncio.run(drive_index_service(svc, queries))
        check_index_service(card, r, crops, probe)
        scale = index_corpus_scale(card, svc, workspace, queries[1], device)
        launches = attention.launch_count
        forwards = svc.embedder.forward_count
    print(f"index phase: {forwards} bucket forwards, flash_attn_fwd launches {launches}")
    if device == "cuda":
        check(launches > 0, "the index phase launched no flash_attn_fwd kernel")
        check(launches == svc.embedder.model_overrides.get("depth", VIT_DEPTH) * forwards,
              f"{launches} launches for {forwards} forwards")
    line = {"service_search_ms": r["search_ms"], "ingest_s": r["t_ingest"],
            "ingested": r["demo"]["n_embedded"], "forwards": forwards,
            "flash_attn_fwd_launches": launches, **scale, "card": card}
    print("index " + json.dumps(line))
    return {"launches": launches, **line}


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


def _host_ms(fn, repeats: int = 1) -> tuple[object, float]:
    """(result of the last call, mean host ms) over ``repeats`` calls."""
    t0 = time.perf_counter()
    for _ in range(repeats):
        result = fn()
    return result, (time.perf_counter() - t0) * 1e3 / repeats


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


# ---- slice 7: token generation ------------------------------------------------

DECODE_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                              "fixtures_golden_decoder.npz")
DECODE_PROMPT = "the cell divides"
DECODE_RESUME = 10
DECODE_GOLDEN_TOL = 2e-4  # the JAX package's own tolerance against the fixture
DECODE_CARD_VS_CPU = 1e-5
# bench.py _bench_token_streaming: 8 bulk streams x 48 new tokens
DECODE_STREAMS = 8
DECODE_NEW_TOKENS = 48
DECODE_BENCH_PROMPT = "the cell divides and grows"[:16]
# three prompts of different lengths, grown from the 16 bucket to the 128 one
DECODE_CO_PROMPTS = ("a", "the cell divides", "mitochondria fuse and divide again")
DECODE_CO_STEPS = 48
DECODE_STEADY_STEPS = 20
# the wider decoder: a value of the JAX engine's DecoderConfig, not a new model
DECODE_WIDE = DecoderConfig(d_model=768, n_heads=12, n_layers=12, d_ff=3072, max_len=512)
DECODE_WIDE_TOKENS = 16
DECODE_WIDE_CARD_VS_CPU = 1e-3


def _decode_logits(engine: DecodeEngine, prompt: list) -> tuple[np.ndarray, np.ndarray]:
    """Prefill and first-step logits through the engine's own programs
    (graphs on the card); the sequence is finished after."""
    T = len(prompt)
    t_pad = bucket_dim(T, engine._len_ladder, divisor=engine.kv.block_size)
    padded = np.zeros((t_pad,), np.int64)
    padded[:T] = prompt
    with engine._lock, engine._device_scope():
        logits, K, V = engine._prefill_program(t_pad)(tokens=padded, length=T)
        prefill = logits.cpu().numpy()
        engine.kv.write_prefill("logits", K[:, :T], V[:, :T])
        table, lengths = engine.kv.block_table(["logits"], t_pad, pad_batch=1)
        tok = np.array([int(np.argmax(prefill))])
        step = engine._step_program(1, t_pad)(tokens=tok, lengths=lengths, table=table)[0]
        step = step[0].cpu().numpy()
    engine.finish("logits")
    return prefill, step


def _co_batch(engine: DecodeEngine, prompts, steps: int) -> dict:
    """The prompts join one step apart and generate ``steps`` tokens each
    in one co-batch, as the decode loop drives it."""
    last, out = {}, {}
    for step in range(steps + len(prompts)):
        if step < len(prompts):
            sid = f"co{step}"
            last[sid] = engine.prefill(sid, [ord(c) % 256 for c in prompts[step]])
            out[sid] = [last[sid]]
        ids = [s for s in last if len(out[s]) < steps]
        if ids:
            for s, t in zip(ids, engine.step(ids, [last[s] for s in ids])):
                last[s] = t
                out[s].append(t)
    for s in last:
        engine.finish(s)
    return out


def _quantile(vals: list, q: float) -> float:
    s = sorted(vals)
    return s[min(int(len(s) * q), len(s) - 1)] if s else 0.0


async def _drain_timed(stream) -> dict:
    toks, gaps, ttft = [], [], 0.0
    t_sub = time.perf_counter()
    t_prev = None
    async for tok in stream.tokens():
        now = time.perf_counter()
        if t_prev is None:
            ttft = now - t_sub
        else:
            gaps.append(now - t_prev)
        t_prev = now
        toks.append(tok)
    return {"tokens": toks, "ttft_s": ttft, "gaps": gaps}


async def decode_traffic(engine: DecodeEngine, legs=("throughput", "inter_token", "join")) -> dict:
    """bench.py's token-streaming legs over ``engine``; each leg runs once
    untimed first."""
    prompt = [ord(c) % 256 for c in DECODE_BENCH_PROMPT]

    async def throughput() -> dict:
        loop = DecodeLoop(engine, name="smoke-tp", max_active=DECODE_STREAMS, interactive_reserve=0)
        t0 = time.perf_counter()
        outs = await asyncio.gather(*[
            _drain_timed(loop.submit(prompt, DECODE_NEW_TOKENS, klass="bulk"))
            for _ in range(DECODE_STREAMS)
        ])
        wall = time.perf_counter() - t0
        stats = loop.stats
        await loop.close()
        total = sum(len(o["tokens"]) for o in outs)
        check(all(o["tokens"] == outs[0]["tokens"] for o in outs), "bulk streams of one prompt differ")
        return {"streams": DECODE_STREAMS, "new_tokens_each": DECODE_NEW_TOKENS,
                "tokens_per_s": total / wall, "batch_occupancy": stats["occupancy"]["mean"],
                "steps": stats["steps"], "wall_s": wall, "tokens": outs[0]["tokens"]}

    async def inter_token() -> dict:
        loop = DecodeLoop(engine, name="smoke-it", max_active=2)
        out = await _drain_timed(loop.submit(prompt, DECODE_NEW_TOKENS, klass="interactive"))
        await loop.close()
        gaps_ms = [1e3 * g for g in out["gaps"]]
        return {"ttft_ms": 1e3 * out["ttft_s"], "inter_token_p50_ms": _quantile(gaps_ms, 0.5),
                "inter_token_p99_ms": _quantile(gaps_ms, 0.99)}

    async def join() -> dict:
        loop = DecodeLoop(engine, name="smoke-join", max_active=4, interactive_reserve=1)
        long_stream = loop.submit(prompt, 2 * DECODE_NEW_TOKENS, klass="bulk")
        long_task = asyncio.create_task(_drain_timed(long_stream))
        while loop.stats["tokens"] < 8:
            await asyncio.sleep(0.001)
        t0 = time.perf_counter()
        short_stream = loop.submit(prompt, 8, klass="interactive")
        short = await _drain_timed(short_stream)
        short_wall = time.perf_counter() - t0
        long_still_running = int(not long_task.done())
        long_out = await long_task
        await loop.close()
        return {"joined_mid_batch": int(short_stream.joined_mid_batch),
                "mid_batch_ttft_ms": 1e3 * short["ttft_s"], "short_wall_ms": 1e3 * short_wall,
                "long_still_running": long_still_running, "long_tokens": len(long_out["tokens"])}

    run = {"throughput": throughput, "inter_token": inter_token, "join": join}
    out = {}
    for leg in legs:
        await run[leg]()  # untimed: builds every program the leg touches
        out[leg] = await run[leg]()
    return out


def decode_steady_step(engine: DecodeEngine, device: str) -> dict:
    """One steady step of 8 sequences in the (8, 64) bucket: host ms of
    ``engine.step`` (ending with the logits on the host) beside the
    device ms of the step graph's replay alone (CUDA events)."""
    prompt = [ord(c) % 256 for c in DECODE_BENCH_PROMPT]
    ids = [f"steady{i}" for i in range(DECODE_STREAMS)]
    last = [engine.prefill(s, prompt) for s in ids]
    while engine.kv.sequence_length(ids[0]) < 36:
        last = engine.step(ids, last)
    t_pad = bucket_dim(engine.kv.sequence_length(ids[0]), engine._len_ladder,
                       divisor=engine.kv.block_size)
    host = []
    for _ in range(DECODE_STEADY_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        last = engine.step(ids, last)
        host.append((time.perf_counter() - t0) * 1e3)
    check(engine.kv.sequence_length(ids[0]) <= t_pad, "the steady steps left their bucket")
    program = engine._step_program(bucket_batch(len(ids)), t_pad)
    with engine._device_scope():
        replay = (program.graph.replay if program.graph is not None
                  else lambda: program.fn(**program.inputs))
        device_ms = _device_ms(device, replay, iters=50, warmup=3)
    # least time for the replayed step: every weight read once and the
    # cached K and V of the sequences' real lengths, against 2 flops per
    # weight and row plus the attention's 4 per cached entry and channel
    cached = sum(engine.kv.sequence_length(s) - 1 for s in ids)
    for s in ids:
        engine.finish(s)
    cfg = engine.config
    n_params = sum(p.numel() for p in engine.model.parameters())
    step_bytes = 4 * (n_params + 2 * cfg.n_layers * cached * cfg.d_model)
    step_flops = 2 * len(ids) * (n_params - cfg.max_len * cfg.d_model) + (
        4 * cfg.n_layers * cached * cfg.d_model)
    t_bytes, t_ops = step_bytes / PEAK_BYTES_PER_S, step_flops / PEAK_FLOPS[torch.float32]
    host_ms = float(np.median(host))
    return {"bucket": [bucket_batch(len(ids)), t_pad], "host_ms": host_ms,
            "host_ms_all": host, "device_ms": device_ms,
            "device_share": device_ms / host_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


async def drive_generate(device: str, fx: dict) -> dict:
    """The generate app as a user drives it, in one event loop."""
    app = GenerateDeployment(device=device)
    t0 = time.perf_counter()
    await app.async_init()
    await app.test_deployment()
    await app.check_health()
    r = {"init_s": time.perf_counter() - t0}
    n = len(fx["greedy_tokens"])
    items = [i async for i in app.generate_stream(DECODE_PROMPT, n)]
    r["stream"] = [i["token"] for i in items]
    r["indices"] = [i["index"] for i in items]
    resumed = [i async for i in app.generate_stream(DECODE_PROMPT, n, resume_from=DECODE_RESUME)]
    r["resumed"] = [i["token"] for i in resumed]
    r["unary"] = await app.generate(DECODE_PROMPT, max_new_tokens=n)
    r["describe"] = await app.describe_engine()
    await app.close()
    return r


def decode_engine_checks(card: str, device: str, fx: dict) -> dict:
    """The engine alone at the repo's decoder: logits against the fixture
    and the CPU port, a co-batch across KV buckets against the CPU port,
    and the program cache's graphs per bucket."""
    cache = CompiledProgramCache(max_programs=64)
    engine = DecodeEngine(model_id="smoke-decode", device=device, cache=cache)
    cpu = DecodeEngine(model_id="smoke-decode-cpu", device="cpu", cache=CompiledProgramCache(64))
    prompt = fx["prompt"].astype(np.int64).tolist()
    prefill, step = _decode_logits(engine, prompt)
    prefill_cpu, step_cpu = _decode_logits(cpu, prompt)
    err = {
        "prefill_vs_fixture": float(np.abs(prefill - fx["prefill_logits"]).max()),
        "step_vs_fixture": float(np.abs(step - fx["step_logits"]).max()),
        "prefill_vs_cpu": float(np.abs(prefill - prefill_cpu).max()),
        "step_vs_cpu": float(np.abs(step - step_cpu).max()),
    }
    print(f"[{card}] decode: logits max abs err {json.dumps(err)}")
    for key in ("prefill_vs_fixture", "step_vs_fixture"):
        check(err[key] <= DECODE_GOLDEN_TOL, f"decode {key} {err[key]} over {DECODE_GOLDEN_TOL}")
    for key in ("prefill_vs_cpu", "step_vs_cpu"):
        check(err[key] <= DECODE_CARD_VS_CPU, f"decode {key} {err[key]} over {DECODE_CARD_VS_CPU}")
    cache.evict(lambda key: True)
    cpu.cache.evict(lambda key: True)
    misses = cache.stats.misses
    t0 = time.perf_counter()
    co = _co_batch(engine, DECODE_CO_PROMPTS, DECODE_CO_STEPS)
    first_s = time.perf_counter() - t0
    co_cpu = _co_batch(cpu, DECODE_CO_PROMPTS, DECODE_CO_STEPS)
    check(co == co_cpu, f"co-batch tokens differ from the CPU port's: {co} vs {co_cpu}")
    keys = sorted(k[1:-1] for k in cache.keys())
    check(keys == sorted(k[1:-1] for k in cpu.cache.keys()), f"program keys {keys}")
    kv_buckets = sorted({k[2] for k in keys if k[0] == "decode_step"})
    check(len(kv_buckets) >= 2, f"the co-batch touched KV buckets {kv_buckets} only")
    built = cache.stats.misses - misses
    check(len(keys) == len(set(keys)) == built, f"{built} builds for {len(keys)} keys")
    misses = cache.stats.misses
    t0 = time.perf_counter()
    check(_co_batch(engine, DECODE_CO_PROMPTS, DECODE_CO_STEPS) == co, "repeated co-batch tokens differ")
    repeat_s = time.perf_counter() - t0
    check(cache.stats.misses == misses, f"repeating the co-batch built {cache.stats.misses - misses} programs")
    check(engine.kv.stats["sequences"] == 0, f"kv not drained: {engine.kv.stats}")
    graphs = sum(1 for k in cache.keys() if cache.get_or_compile(k, None).graph is not None)
    check(device != "cuda" or graphs == len(keys), f"{graphs} graphs for {len(keys)} programs")
    steady = decode_steady_step(engine, device)
    engine.close()
    print(f"[{card}] decode: co-batch of {len(DECODE_CO_PROMPTS)} prompts x {DECODE_CO_STEPS} tokens "
          f"equals the CPU port's; {len(keys)} programs {keys}; first pass {first_s:.3f} s "
          f"(builds), repeat {repeat_s:.3f} s (0 builds); steady step {json.dumps(steady)}")
    return {"logits_err": err, "programs": len(keys), "kv_buckets": kv_buckets,
            "co_first_s": first_s, "co_repeat_s": repeat_s,
            "graph_build_s": cache.stats.cumulative_compile_seconds, "steady_step": steady}


def decode_wide(card: str, device: str) -> dict:
    """The same engine and loop at the wider DecoderConfig: 16 greedy
    tokens and the logits against the CPU port, then the throughput leg."""
    t0 = time.perf_counter()
    params = init_decoder_params(SEED, DECODE_WIDE)
    engine = DecodeEngine(model_id="smoke-wide", params=params, config=DECODE_WIDE, device=device,
                          cache=CompiledProgramCache(64))
    build_s = time.perf_counter() - t0
    cpu = DecodeEngine(model_id="smoke-wide-cpu", params=params, config=DECODE_WIDE, device="cpu",
                       cache=CompiledProgramCache(64))
    del params
    n_params = sum(p.numel() for p in engine.model.parameters())
    prompt = [ord(c) % 256 for c in DECODE_PROMPT]
    prefill, step = _decode_logits(engine, prompt)
    prefill_cpu, step_cpu = _decode_logits(cpu, prompt)
    err = {"prefill_vs_cpu": float(np.abs(prefill - prefill_cpu).max()),
           "step_vs_cpu": float(np.abs(step - step_cpu).max())}
    for key, e in err.items():
        check(e <= DECODE_WIDE_CARD_VS_CPU, f"wide decode {key} {e} over {DECODE_WIDE_CARD_VS_CPU}")
    toks = [engine.prefill("wide", prompt)]
    toks_cpu = [cpu.prefill("wide", prompt)]
    while len(toks) < DECODE_WIDE_TOKENS:
        toks += engine.step(["wide"], toks[-1:])
        toks_cpu += cpu.step(["wide"], toks_cpu[-1:])
    engine.finish("wide")
    cpu.finish("wide")
    check(toks == toks_cpu, f"wide greedy tokens differ from the CPU port's: {toks} vs {toks_cpu}")
    del cpu
    legs = asyncio.run(decode_traffic(engine, legs=("throughput",)))
    steady = decode_steady_step(engine, device)
    pool_bytes = 2 * engine.kv.k_pool.numel() * engine.kv.k_pool.element_size()
    engine.close()
    print(f"[{card}] decode wide {dataclasses.asdict(DECODE_WIDE)}: {n_params} parameters, "
          f"pools {pool_bytes / 2**30:.3f} GiB, logits err {json.dumps(err)}, {len(toks)} greedy tokens "
          f"equal the CPU port's; throughput {json.dumps({k: v for k, v in legs['throughput'].items() if k != 'tokens'})}; "
          f"steady step {json.dumps(steady)}")
    return {"config": dataclasses.asdict(DECODE_WIDE), "parameters": n_params,
            "build_s": build_s, "pool_gib": pool_bytes / 2**30, "logits_err": err,
            "throughput": {k: v for k, v in legs["throughput"].items() if k != "tokens"},
            "steady_step": steady}


def phase_decode(card: str, device: str = "cuda") -> dict:
    """Slice 7: the generate app, the engine alone and bench.py's traffic
    at the repo's decoder, then the wider decoder; one ``decode`` JSON
    line."""
    fx = dict(np.load(DECODE_FIXTURE))
    print(f"decode phase: DecoderConfig() {dataclasses.asdict(DecoderConfig())}, seed {SEED}, on {device}; "
          f"then DecoderConfig {dataclasses.asdict(DECODE_WIDE)}")
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    attention.launch_count = 0
    app = asyncio.run(drive_generate(device, fx))
    golden = fx["greedy_tokens"].tolist()
    check(app["stream"] == golden, f"generate_stream {app['stream']} != fixture {golden}")
    check(app["indices"] == list(range(len(golden))), f"stream indices {app['indices']}")
    check(app["resumed"] == golden[DECODE_RESUME:], f"resume_from={DECODE_RESUME} gave {app['resumed']}")
    check(app["unary"]["tokens"] == golden, f"unary generate {app['unary']}")
    kv = app["describe"]["engine"]["kv"]
    check(kv["sequences"] == 0 and kv["blocks_in_use"] == 0, f"kv not drained: {kv}")
    check(app["describe"]["engine"]["device"].startswith(device), f"app engine on {app['describe']['engine']['device']}")
    print(f"[{card}] decode app: async_init + test_deployment {app['init_s']:.3f} s; the stream equals the "
          f"fixture's {len(golden)} tokens, resume_from={DECODE_RESUME} the suffix, unary the stream; "
          f"kv drained; programs {app['describe']['engine']['programs']}")
    checks = decode_engine_checks(card, device, fx)
    engine = DecodeEngine(model_id="smoke-traffic", device=device, cache=CompiledProgramCache(64))
    traffic = asyncio.run(decode_traffic(engine))
    engine.close()
    tp, join = traffic["throughput"], traffic["join"]
    check(join["joined_mid_batch"] == 1 and join["long_still_running"] == 1, f"join leg {join}")
    check(tp["batch_occupancy"] > DECODE_STREAMS / 2, f"throughput occupancy {tp['batch_occupancy']}")
    tp = {k: v for k, v in tp.items() if k != "tokens"}
    print(f"[{card}] decode traffic: {json.dumps({**traffic, 'throughput': tp})}")
    wide = decode_wide(card, device)
    launches = attention.launch_count
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    check(launches == 0, f"the decode phase launched flash_attn_fwd {launches} times")
    print(f"decode phase: flash_attn_fwd launches {launches} (the decoder has no kernel slot)")
    out = {"card": card, "app_init_s": app["init_s"], **checks, "throughput": tp,
           "inter_token": traffic["inter_token"], "join_mid_batch": join, "wide": wide,
           "peak_gib": peak / 2**30, "flash_attn_fwd_launches": launches}
    print("decode " + json.dumps(out))
    return out


# ---- slice 8: the serving plane -------------------------------------------------

SERVE_BUNDLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bioengine_tpu_torch",
                            "apps", "bundles", "model-runner")
SERVE_APP = "model-runner"
SERVE_REQUESTS = 32  # concurrent 512^2 predicts per timed round
SERVE_IMAGE = 512
SERVE_WARM_ROUNDS = 2  # untimed rounds first, so the timed ones build no graph
SERVE_TIMED_ROUNDS = 10  # timed rounds per leg: the median rate and its spread
SERVE_REPLAYS = 16  # 512^2 predicts replaying beside the tiled requests' captures
SERVE_LOAD_REQUESTS = 8  # concurrent tiled 2048^2 infers that fill the runtime's 4 slots
SERVE_TOL = TOLERANCE[torch.bfloat16][0]  # batched vs direct, bf16 packages
SERVE_MEMORY_SLACK = 64 << 20
SERVE_HEALTHY_TIMEOUT_S = 300
WIRE_PACKAGES = ("aiohttp", "msgpack", "yaml", "psutil")  # the RPC wire's and the plane's
# the legs of the 512^2 round: the bundle as shipped (batching max 8 / 5 ms
# under max_ongoing_requests 4), then with 8 requests let into the replica
# at once, then with the batcher off
SERVE_LEGS = (
    ("shipped", {}),
    ("max_ongoing_8", {"max_ongoing_requests": 8}),
    ("max_batch_1", {"batching": {"max_batch": 1}}),
)


class _InitFailsOnce(RuntimeDeployment):
    """A runtime deployment whose first ``async_init`` raises."""

    failures = 0

    async def async_init(self):
        if _InitFailsOnce.failures == 0:
            _InitFailsOnce.failures += 1
            raise RuntimeError("async_init failed on purpose")
        await super().async_init()


def _wire_packages() -> dict:
    found = {}
    for name in WIRE_PACKAGES:
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    return found


def _serve_bundle(root: str, leg: str, runtime_config: dict) -> str:
    """The bundle with ``deployment_config.runtime_deployment`` updated."""
    dst = os.path.join(root, f"bundle_{leg}")
    shutil.copytree(SERVE_BUNDLE, dst)
    path = os.path.join(dst, "manifest.yaml")
    with open(path) as f:
        manifest = json.load(f)
    manifest["deployment_config"]["runtime_deployment"].update(runtime_config)
    with open(path, "w") as f:
        json.dump(manifest, f)
    return dst


async def _deploy_bundle(controller, root: str, leg: str, runtime_config: dict, device: str):
    built = AppBuilder(workdir_root=os.path.join(root, "workdirs")).build(
        SERVE_APP,
        local_path=_serve_bundle(root, leg, runtime_config),
        deployment_kwargs={
            "runtime_deployment": {"device": device},
            "entry_deployment": {"device": device, "cache_dir": os.path.join(root, "cache")},
        },
        make_handle=lambda name: DeploymentHandle(controller, SERVE_APP, name),
    )
    t0 = time.perf_counter()
    app = await controller.deploy(SERVE_APP, built.specs, acl=built.authorized_users)
    await _until_healthy(app)
    return app, time.perf_counter() - t0


async def _until_healthy(app) -> None:
    async def wait():
        while any(r.state != ReplicaState.HEALTHY for reps in app.replicas.values() for r in reps):
            check(not any(r.state == ReplicaState.UNHEALTHY for reps in app.replicas.values() for r in reps),
                  f"a replica went unhealthy: {[r.last_error for reps in app.replicas.values() for r in reps]}")
            await asyncio.sleep(0.01)

    await asyncio.wait_for(wait(), SERVE_HEALTHY_TIMEOUT_S)


async def _until(predicate, timeout: float = 60.0) -> None:
    async def wait():
        while not predicate():
            await asyncio.sleep(0.001)

    await asyncio.wait_for(wait(), timeout)


def _runtime_instance(app) -> RuntimeDeployment:
    (replica,) = app.replicas["runtime_deployment"]
    return replica.instance


async def _predict_round(handle, package: str, images) -> tuple[list, float]:
    t0 = time.perf_counter()
    outs = await asyncio.gather(*(handle.predict(rdf_path=package, inputs={"raw": x}) for x in images))
    return [o["mask"] for o in outs], time.perf_counter() - t0


def _device_busy_ms(prof) -> tuple[float, float]:
    """(union, sum) in ms of the device activities (kernels, copies,
    memsets) a ``torch.profiler`` run recorded: the union is the time the
    card was busy at all, the sum counts overlapping work twice."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    union, total, cur_start, cur_end = 0.0, 0.0, None, None
    for a, b in spans:
        total += b - a
        if cur_end is None or a > cur_end:
            if cur_end is not None:
                union += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    if cur_end is not None:
        union += cur_end - cur_start
    return union / 1e3, total / 1e3


async def _profiled_round(handle, package: str, images) -> tuple[list, float, float, float]:
    """One round under ``torch.profiler``: (outputs, wall s, busy ms, summed ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        outs, wall = await _predict_round(handle, package, images)
        torch.cuda.synchronize()
    busy, summed = _device_busy_ms(prof)
    return outs, wall, busy, summed


def _max_abs(outs, direct) -> float:
    return max(float(np.abs(o - d).max()) for o, d in zip(outs, direct))


async def _serve_leg(card, controller, root, leg, config, package, images, direct, device, n_chips) -> dict:
    app, deploy_s = await _deploy_bundle(controller, root, leg, config, device)
    runtime = _runtime_instance(app)
    leases = {name: [list(r.device_ids) for r in reps] for name, reps in app.replicas.items()}
    (lease,) = leases["runtime_deployment"]
    check(leases["entry_deployment"] == [[]] and len(lease) == 1 and (n_chips > 1 or lease == [0]),
          f"{leg}: leases {leases} on {n_chips} chip(s)")
    check(str(runtime.device) == (f"cuda:{lease[0]}" if device == "cuda" else "cpu"),
          f"{leg}: the runtime replica leased {lease} runs on {runtime.device}")
    handle = controller.get_handle(SERVE_APP, "runtime_deployment")
    for _ in range(SERVE_WARM_ROUNDS):
        await _predict_round(handle, package, images)
    b = runtime._batcher
    rates, walls, batches, err = [], [], [], 0.0
    for _ in range(SERVE_TIMED_ROUNDS):
        n0 = b.stats["batches"] if b is not None else 0
        _sync(device)
        outs, wall = await _predict_round(handle, package, images)
        _sync(device)
        batches.append(b.stats["batches"] - n0 if b is not None else len(images))
        rates.append(len(images) / wall)
        walls.append(wall * 1e3)
        err = max(err, _max_abs(outs, direct))
    n_requests = len(images) * SERVE_TIMED_ROUNDS
    if b is not None:
        occupancy = list(b._occupancy_samples)[-sum(batches):]
        waits = sorted(list(b._wait_samples)[-n_requests:])
        wait_p50, wait_p99 = _quantile(waits, 0.5) * 1e3, _quantile(waits, 0.99) * 1e3
    else:
        occupancy, wait_p50, wait_p99 = [1] * n_requests, 0.0, 0.0
    check(err <= SERVE_TOL, f"{leg}: served vs direct max abs {err} over {SERVE_TOL}")
    check(sum(occupancy) == n_requests, f"{leg}: occupancy {occupancy} for {n_requests} requests")
    hist = {str(k): occupancy.count(k) for k in sorted(set(occupancy))}
    r = {"deploy_s": deploy_s, "rounds": SERVE_TIMED_ROUNDS,
         "requests_per_s": statistics.median(rates), "requests_per_s_min": min(rates),
         "requests_per_s_max": max(rates), "requests_per_s_by_round": rates,
         "wall_ms_median": statistics.median(walls), "batches_by_round": batches,
         "occupancy": hist, "queue_wait_ms_p50": wait_p50, "queue_wait_ms_p99": wait_p99,
         "max_abs_vs_direct": err, "batch_max": runtime.batch_max,
         "max_ongoing": app.specs["runtime_deployment"].max_ongoing_requests}
    print(f"[{card}] serving {leg} (batch max {r['batch_max']}, max_ongoing {r['max_ongoing']}): "
          f"{SERVE_TIMED_ROUNDS} rounds of {len(images)} concurrent {SERVE_IMAGE}^2 predicts, requests/s "
          f"median {r['requests_per_s']:.2f} (min {min(rates):.2f}, max {max(rates):.2f}; round wall median "
          f"{r['wall_ms_median']:.3f} ms); batches per round {batches}, occupancy {json.dumps(hist)}; "
          f"queue wait p50 {wait_p50:.3f} ms, p99 {wait_p99:.3f} ms; max abs vs direct {err:.6g} "
          f"(tolerance {SERVE_TOL}); deploy + self-test {deploy_s:.3f} s")
    if device == "cuda":
        outs, wall, busy, summed = await _profiled_round(handle, package, images)
        check(busy > 0, f"{leg}: the profiler recorded no device activity in a served round")
        err = max(err, _max_abs(outs, direct))
        check(err <= SERVE_TOL, f"{leg}: profiled round max abs {err} over {SERVE_TOL}")
        r.update(profiled_wall_ms=wall * 1e3, busy_ms=busy, busy_sum_ms=summed,
                 busy_share=busy / (wall * 1e3))
        print(f"[{card}] serving {leg}: one more round under torch.profiler, wall {wall * 1e3:.3f} ms "
              f"(unprofiled median {r['wall_ms_median']:.3f} ms); device busy (union of kernels, copies "
              f"and memsets) {busy:.3f} ms, summed {summed:.3f} ms; busy share {r['busy_share']:.4f} "
              "of that round's wall")
    return {"app": app, "runtime": runtime, **r}


async def drive_serving(card: str, device: str, root: str, pkgs: dict, inputs: dict, direct: dict) -> dict:
    topo = detect_topology(device=device)
    n_chips = topo.n_chips
    controller = ServeController(ClusterState(topo), health_check_period=3600)
    state = controller.cluster_state
    r: dict = {"n_chips": n_chips, "legs": {}}
    try:
        for leg, config in SERVE_LEGS:
            if leg != SERVE_LEGS[0][0]:
                await controller.undeploy(SERVE_APP)
                check(state.free_chips() == n_chips,
                      f"undeploy before {leg} left {state.free_chips()} of {n_chips} chips free")
            res = await _serve_leg(card, controller, root, leg, config, pkgs["unet2d"],
                                   inputs["images"], direct["images"], device, n_chips)
            app, runtime = res.pop("app"), res.pop("runtime")
            r["legs"][leg] = res

        # the tiled 2048^2 request and the volume through the entry, with
        # 512^2 predicts replaying beside their graph captures; batching is
        # off in this deployment, so each must equal its direct result
        entry = controller.get_handle(SERVE_APP, "entry_deployment")
        handle = controller.get_handle(SERVE_APP, "runtime_deployment")
        replays = inputs["images"][:SERVE_REPLAYS]
        t0 = time.perf_counter()
        tiled, volume, *side = await asyncio.gather(
            entry.infer(model_id="unet2d", inputs={"raw": inputs["2048"]}),
            entry.infer(model_id="unet3d", inputs={"raw": inputs["volume"]}),
            *(handle.predict(rdf_path=pkgs["unet2d"], inputs={"raw": x}) for x in replays),
        )
        r["concurrent_s"] = time.perf_counter() - t0
        check(np.array_equal(tiled["mask"], direct["2048"]), "entry infer 2048^2 differs from the direct result: "
              f"max abs {np.abs(tiled['mask'] - direct['2048']).max()}")
        check(np.array_equal(volume["mask"], direct["volume"]), "entry infer volume differs from the direct "
              f"result: max abs {np.abs(volume['mask'] - direct['volume']).max()}")
        side_err = max(float(np.abs(o["mask"] - d).max()) for o, d in zip(side, direct["images"]))
        check(side_err <= SERVE_TOL, f"replays beside the captures: max abs {side_err}")
        r["side_max_abs"] = side_err
        print(f"[{card}] serving: entry infer 2048^2 (tiled) and {VOLUME[1:4]} volume concurrently with "
              f"{len(replays)} {SERVE_IMAGE}^2 replays in {r['concurrent_s']:.3f} s (first calls: graph "
              f"captures beside replays); both equal their direct results bit for bit; replays max abs "
              f"{side_err:.6g}")

        # load: the runtime's 4 slots fill with tiled requests; the
        # controller wants a second replica, which on one chip finds none
        # free and is a pending workload, and on more chips is placed
        load = [asyncio.create_task(entry.infer(model_id="unet2d", inputs={"raw": inputs["2048"]}))
                for _ in range(SERVE_LOAD_REQUESTS)]
        (replica,) = app.replicas["runtime_deployment"]
        await _until(lambda: replica.load >= 1.0)
        r["load_at_tick"] = replica.load
        await controller.health_tick()
        pending = [(p.workload_id, p.resources) for p in state.pending()]
        n_runtime = len(app.replicas["runtime_deployment"])
        loaded = await asyncio.gather(*load)
        if n_chips == 1:
            check(pending == [(f"{SERVE_APP}/runtime_deployment", {"chips": 1})],
                  f"pending workloads {pending}")
            check(n_runtime == 1, f"{n_runtime} runtime replicas on one chip")
        else:
            check(not pending and n_runtime == 2, f"{n_runtime} runtime replicas on {n_chips} chips, "
                  f"pending {pending}")
        check(app.status == "RUNNING", f"app {app.status}")
        check(all(np.array_equal(o["mask"], direct["2048"]) for o in loaded), "a loaded 2048^2 request differs")
        r["pending"] = pending
        print(f"[{card}] serving: {SERVE_LOAD_REQUESTS} concurrent 2048^2 infers, runtime load "
              f"{r['load_at_tick']:.2f} at the health tick on {n_chips} chip(s): {n_runtime} runtime "
              f"replica(s), pending workloads {pending}; the app stays {app.status}")

        # undeploy frees the card and the chip
        del replica, runtime, app
        await controller.undeploy(SERVE_APP)
        r["free_chips_after_undeploy"] = state.free_chips()
        check(state.free_chips() == n_chips and not state._chips_in_use,
              f"undeploy left chips in use: {state._chips_in_use}")

        # a deployment whose async_init raises: typed failure, chip back, retry serves
        _InitFailsOnce.failures = 0
        spec = DeploymentSpec(name="runtime_deployment", instance_factory=lambda: _InitFailsOnce(device=device),
                              chips_per_replica=1, autoscale=False)
        try:
            await controller.deploy("init-fails", [spec])
            check(False, "a deployment whose async_init raises deployed")
        except RuntimeError as e:
            check("async_init failed on purpose" in str(e), f"deploy failed with {e!r}")
            r["init_failure"] = f"{type(e).__name__}: {e}"
        check(controller.apps["init-fails"].status == "DEPLOY_FAILED" and state.free_chips() == n_chips,
              f"failed deploy: status {controller.apps['init-fails'].status}, free {state.free_chips()}")
        retry = await controller.deploy("init-fails", [spec])
        (rep,) = retry.replicas["runtime_deployment"]
        out = await controller.get_handle("init-fails").predict(rdf_path=pkgs["unet2d"],
                                                                 inputs={"raw": inputs["images"][0]})
        check(len(rep.device_ids) == 1 and float(np.abs(out["mask"] - direct["images"][0]).max()) <= SERVE_TOL,
              f"the retried deploy: lease {rep.device_ids}")
        rep_lease = rep.device_ids
        del rep, retry
        await controller.undeploy("init-fails")
        check(state.free_chips() == n_chips, "the retried deploy's chip was not released")
        print(f"[{card}] serving: a deployment whose async_init raises failed typed ({r['init_failure']}), "
              f"released the chip; the retry leased chip {rep_lease} and served")
    finally:
        await controller.stop()
    return r


def phase_serving(card: str, device: str = "cuda") -> dict:
    """Slice 8: the model-runner bundle built by the port's AppBuilder and
    served by its ServeController on the card; one ``serving`` JSON line."""
    found = _wire_packages()
    print(f"[{card}] serving: packages of the plane and the RPC wire importable here: {json.dumps(found)}")
    if device == "cuda":
        topo = detect_topology()
        check(topo.n_chips == torch.cuda.device_count() and topo.platform == "gpu", f"topology {topo.as_dict()}")
        chip = topo.chips[0]
        total = torch.cuda.mem_get_info(0)[1]
        check(chip.kind == torch.cuda.get_device_name(0) and chip.hbm_bytes == total,
              f"chip 0 {chip} against {torch.cuda.get_device_name(0)}, {total} B")
        print(f"[{card}] serving: detect_topology() {topo.n_chips} chip(s); chip 0 '{chip.kind}', "
              f"hbm {chip.hbm_bytes} B ({chip.hbm_used_bytes} B in use)")
    rng = np.random.default_rng(SEED)
    unet2d = UNet2D(features=UNET2D_FEATURES)
    unet2d.reset_parameters(SEED)
    unet3d = UNet3D(features=UNET3D_FEATURES, z_strides=UNET3D_Z_STRIDES)
    unet3d.reset_parameters(SEED + 1)
    inputs = {
        "images": [rng.standard_normal((1, SERVE_IMAGE, SERVE_IMAGE, 1), np.float32)
                   for _ in range(SERVE_REQUESTS)],
        "2048": rng.standard_normal((1, 2048, 2048, 1), np.float32),
        "volume": rng.standard_normal(VOLUME, np.float32),
    }
    before_env = os.environ.get("BIOENGINE_LOCAL_MODEL_PATH")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as root:
        collection = os.path.join(root, "collection")
        os.makedirs(collection)
        pkgs = {
            "unet2d": write_unet_package(collection, "unet2d", unet2d, "unet2d",
                                         {"features": list(UNET2D_FEATURES)}, "byxc"),
            "unet3d": write_unet_package(collection, "unet3d", unet3d, "unet3d",
                                         {"features": list(UNET3D_FEATURES),
                                          "z_strides": list(UNET3D_Z_STRIDES)}, "bzyxc"),
        }
        del unet2d, unet3d
        # the direct path: RuntimeDeployment.predict with no replica and no batcher
        dep = RuntimeDeployment(device=device)

        async def direct_results():
            return {
                "images": [(await dep.predict(pkgs["unet2d"], {"raw": x}))["mask"] for x in inputs["images"]],
                "2048": (await dep.predict(pkgs["unet2d"], {"raw": inputs["2048"]}))["mask"],
                "volume": (await dep.predict(pkgs["unet3d"], {"raw": inputs["volume"]}))["mask"],
            }

        try:
            direct = asyncio.run(direct_results())
        finally:
            asyncio.run(dep.close())
        del dep
        gc.collect()
        if device == "cuda":
            torch.cuda.synchronize()
        base = torch.cuda.memory_allocated() if device == "cuda" else 0
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        os.environ["BIOENGINE_LOCAL_MODEL_PATH"] = collection
        attention.launch_count = 0
        try:
            r = asyncio.run(drive_serving(card, device, root, pkgs, inputs, direct))
        finally:
            if before_env is None:
                os.environ.pop("BIOENGINE_LOCAL_MODEL_PATH", None)
            else:
                os.environ["BIOENGINE_LOCAL_MODEL_PATH"] = before_env
        launches = attention.launch_count
        gc.collect()
        if device == "cuda":
            torch.cuda.synchronize()
            after, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
            check(after - base <= SERVE_MEMORY_SLACK, f"after undeploy {after} B allocated against "
                  f"{base} B before the deploy (slack {SERVE_MEMORY_SLACK} B)")
            print(f"[{card}] serving: device memory allocated {base} B before the deploy, peak {peak} B "
                  f"while deployed, {after} B after the undeploys ({(after - base) / 2**20:.3f} MiB "
                  f"apart, limit 64 MiB); chip released")
            r["memory_before"], r["memory_peak"], r["memory_after"] = base, peak, after
        else:
            print("serving: device memory not measured on the CPU")
    check(launches == 0, f"the serving phase launched flash_attn_fwd {launches} times")
    print(f"[{card}] serving phase: flash_attn_fwd launches {launches} (the U-Nets run no attention)")
    out = {"card": card, **r, "wire_packages": found, "flash_attn_fwd_launches": launches}
    print("serving " + json.dumps(out))
    return out


# ---- slice 9: the worker over the wire -----------------------------------------

WORKER_BUNDLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bioengine_tpu_torch",
                              "apps", "bundles")
WORKER_CIS = "cell-image-search"
WORKER_FIELDS = 16  # synthetic 896^2 fields of the Zarr dataset the worker serves
WORKER_FIELD_SIZE = 896
WORKER_CROPS_PER_FIELD = 50
WORKER_VIT = {"depth": VIT_DEPTH}  # ViT-B/14 at full width
WORKER_SEARCHES = 16
WORKER_ROUNDS = 3  # timed rounds over the queries (and the predicts), the paths interleaved call by call
WORKER_PROFILED_SEARCHES = 2
WORKER_PREDICTS = 16  # 512^2 f32 predicts through the model-runner over the wire
WORKER_INGEST_TIMEOUT_S = 600
WORKER_CLI_START_S = 60
WORKER_CLI_STOP_S = 30
WORKER_PROBES = ("httpx", "cloudpickle", "aiohttp")


def write_cell_dataset(datasets_dir: str, name: str, n_fields: int, size: int, seed: int,
                       compressor) -> np.ndarray:
    """A datasets-plane dataset: ``<name>/fields.zarr`` holding the array
    ``raw`` of ``n_fields`` synthetic fields (N, size, size) float32, one
    chunk a field; returns the fields."""
    fields = np.stack([img for _, img in make_synthetic_images(n_images=n_fields, size=size, seed=seed)])
    root = os.path.join(datasets_dir, name)
    os.makedirs(root)
    with open(os.path.join(root, "manifest.yaml"), "w") as f:
        f.write("description: synthetic fluorescence fields\nauthorized_users: ['*']\n")
    zarr_codec.write_group(os.path.join(root, "fields.zarr"))
    zarr_codec.write_array(os.path.join(root, "fields.zarr"), "raw", fields,
                           chunks=(1, size, size), compressor=compressor)
    return fields


def _codecs_loaded() -> dict:
    loaded = {}
    for name, fn in (("zstd", lambda: codecs.zstd_compress(b"probe", 3)),
                     ("lz4", lambda: codecs.lz4_compress(b"probe")),
                     ("blosc", lambda: codecs.blosc_compress(b"probe"))):
        try:
            fn()
            loaded[name] = True
        except codecs.CodecUnavailable:
            loaded[name] = False
    return loaded


def _results(found: dict) -> list:
    """A search's ranked results without its timings."""
    return [dict(r) for r in found["results"]]


def _spread(ms: list) -> dict:
    q1, _, q3 = statistics.quantiles(ms, n=4)
    return {"n": len(ms), "median": statistics.median(ms), "q1": q1, "q3": q3, "min": min(ms), "max": max(ms)}


def _fmt(s: dict) -> str:
    return (f"median {s['median']:.3f} ms (quartiles {s['q1']:.3f}-{s['q3']:.3f}, min {s['min']:.3f}, "
            f"max {s['max']:.3f}, n {s['n']})")


def _codec_seconds(*stats) -> float:
    """Encode plus decode seconds that ``RpcStats`` counted so far."""
    return sum(st.encode_seconds + st.decode_seconds for st in stats)


async def _interleaved(paths: dict, inputs: list, rounds: int, codec_stats: tuple) -> dict:
    """Each input through every path, call after call, for ``rounds``
    rounds, the paths' order turned by one each round, so drift on the
    host falls on every path alike. Returns per path the outputs (round
    by round) and the ms of each call, and per call of the ``"websocket"``
    path the ms that ``RpcStats`` counted encoding and decoding."""
    names = list(paths)
    out = {n: {"outs": [], "ms": []} for n in names}
    codec_ms = []
    for rnd in range(rounds):
        order = names[rnd % len(names):] + names[:rnd % len(names)]
        for x in inputs:
            for n in order:
                c0 = _codec_seconds(*codec_stats)
                t0 = time.perf_counter()
                out[n]["outs"].append(await paths[n](x))
                out[n]["ms"].append((time.perf_counter() - t0) * 1e3)
                if n == "websocket":
                    codec_ms.append((_codec_seconds(*codec_stats) - c0) * 1e3)
    out["codec_ms"] = codec_ms
    return out


def _paired(a: list, b: list) -> dict:
    """Spread of the call-by-call differences a - b."""
    return _spread([x - y for x, y in zip(a, b)])


def _json_ms(request: dict, response) -> float:
    """ms of the JSON work of one bridged call, done alone: the client's
    encode of the request and the server's parse of it, the server's
    encode of ``{"result": response}`` and the client's parse of it."""
    t0 = time.perf_counter()
    json.loads(json.dumps(request))
    json.loads(json.dumps({"result": response}))
    return (time.perf_counter() - t0) * 1e3


def _rpc_delta(before: dict, after: dict) -> dict:
    keys = ("bytes_in", "bytes_out", "frames_in", "frames_out", "chunked_msgs_in", "chunked_msgs_out",
            "shm_gets", "shm_get_bytes", "shm_puts", "shm_put_bytes", "shm_fallbacks")
    return {k: after[k] - before[k] for k in keys}


def _carried_by(delta: dict) -> str:
    if delta["shm_gets"] or delta["shm_puts"]:
        return "shm" if not delta["shm_fallbacks"] else "shm and wire frames"
    return "wire frames"


async def _http_json(http, method: str, url: str, token: str = None, body=None):
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    async with http.request(method, url, json=body, headers=headers) as r:
        return r.status, await r.json()


def _trace_kernels(trace_dir: str) -> list:
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f).get("traceEvents", [])
    return sorted({e["name"] for e in events if e.get("cat") == "kernel"})


async def drive_worker(card: str, device: str, root: str, queries, collection: str, direct_masks,
                       mr_inputs) -> dict:
    """The worker's main path, in process so the launch counter is readable.
    Returns the numbers and what the checks after it need."""
    ws, datasets_dir = os.path.join(root, "worker"), os.path.join(root, "datasets")
    worker = BioEngineWorker(mode="single-machine", device=device, port=0, workspace_dir=ws,
                             datasets_dir=datasets_dir, admin_users=["admin"], log_file="off",
                             monitoring_interval_seconds=60.0)
    r: dict = {}
    t0 = time.perf_counter()
    await worker.start()
    r["start_s"] = time.perf_counter() - t0
    server = worker.server
    base = server.http_url
    admin = server.issue_token("admin")
    user = server.issue_token("smoke-user")
    conn = await connect_to_server({"server_url": server.url, "token": admin})
    http = aiohttp.ClientSession()
    try:
        svc = await conn.get_service("bioengine-worker")
        status = await svc.get_status()
        topo = status["cluster"]["topology"]
        want = ("gpu", torch.cuda.get_device_name(0), torch.cuda.device_count()) if device == "cuda" \
            else ("cpu", "cpu", 1)
        got = (topo["platform"], topo["chips"][0]["kind"], topo["n_chips"])
        check(got == want, f"get_status over the wire: topology {got}, expected {want}")
        print(f"[{card}] worker: started in {r['start_s']:.3f} s on {server.url}; get_status over the "
              f"WebSocket: platform {got[0]!r}, kind {got[1]!r}, {got[2]} chip(s); datasets served at "
              f"{status['datasets']['server_url']}")

        # cell-image-search from its bundle, over the wire, ingesting the
        # worker's own datasets plane
        attention.launch_count = 0
        t0 = time.perf_counter()
        deployed = await svc.deploy_app(
            local_path=os.path.join(WORKER_BUNDLES, WORKER_CIS), app_id=WORKER_CIS,
            deployment_kwargs={"main": {"workspace_dir": os.path.join(root, "cis"), "device": device,
                                        "seed": SEED, "batch_bucket": BUCKET,
                                        "n_crops_per_image": WORKER_CROPS_PER_FIELD,
                                        "model_overrides": WORKER_VIT}})
        r["cis_deploy_s"] = time.perf_counter() - t0
        check(deployed["app_id"] == WORKER_CIS and "search" in deployed["methods"], f"deploy_app {deployed}")
        (replica,) = worker.controller.apps[WORKER_CIS].replicas["main"]
        check(list(replica.device_ids) == [0], f"the replica leased {replica.device_ids}")
        instance = replica.instance
        app = await conn.get_service(WORKER_CIS)
        await app.add_dataset(name="cells", source="datasets")
        listed = await app.list_datasets()
        check([d["name"] for d in listed["data_server"]] == ["cells"], f"list_datasets {listed}")
        t0 = time.perf_counter()
        await app.start_ingestion(dataset_name="cells", session_id="worker")
        while True:
            st = await app.get_ingestion_status(session_id="worker")
            if st["status"] in ("completed", "failed", "stopped"):
                break
            check(time.perf_counter() - t0 < WORKER_INGEST_TIMEOUT_S, f"ingestion stuck: {st}")
            await asyncio.sleep(0.05)
        r["ingest_s"] = time.perf_counter() - t0
        check(st["status"] == "completed" and st["n_embedded"] > 0, f"ingestion {st}")
        stats = await app.get_index_stats()
        check(stats["loaded"] and stats["n_cells"] == st["n_embedded"] and stats["index_type"] == "FlatIP",
              f"index stats {stats}")
        r["n_cells"] = stats["n_cells"]
        print(f"[{card}] worker: {WORKER_CIS} deployed from its bundle over the wire (deploy_app answered "
              f"in {r['cis_deploy_s']:.3f} s; the replica's self-test runs after), chip {replica.device_ids}; "
              f"ingested {WORKER_FIELDS} {WORKER_FIELD_SIZE}^2 fields from the worker's datasets plane into "
              f"{r['n_cells']} cells ({stats['index_type']}) in {r['ingest_s']:.3f} s")

        # the same 16 searches over the WebSocket, the HTTP bridge and in
        # process, interleaved call by call; one MCP call
        url = f"{base}/call/{WORKER_CIS}/search"

        async def bridge(q):
            status_code, body = await _http_json(http, "POST", url, user,
                                                 {"kwargs": {"image": q.tolist(), "top_k": TOP_K}})
            check(status_code == 200, f"bridge status {status_code}: {body}")
            return body["result"]

        paths = {"websocket": lambda q: app.search(image=q, top_k=TOP_K), "bridge": bridge,
                 "in_process": lambda q: instance.search(image=q, top_k=TOP_K)}
        for call in paths.values():  # one untimed call per path
            await call(queries[0])
        timed = await _interleaved(paths, queries, WORKER_ROUNDS, (server.stats, conn.codec.stats))
        status_code, mcp = await _http_json(
            http, "POST", f"{base}/mcp/{WORKER_CIS}", user,
            {"jsonrpc": "2.0", "id": 1, "method": "tools/call",
             "params": {"name": "search", "arguments": {"image": queries[0].tolist(), "top_k": TOP_K}}})
        check(status_code == 200 and not mcp["result"]["isError"], f"MCP tools/call: {status_code} {mcp}")
        mcp_found = json.loads(mcp["result"]["content"][0]["text"])
        ws_found = timed["websocket"]["outs"][:len(queries)]
        for i, (a, b, c) in enumerate(zip(*(timed[n]["outs"] for n in paths))):
            check(_results(a) == _results(b) == _results(c) == _results(ws_found[i % len(queries)]),
                  f"search {i}: WebSocket, bridge and in-process results differ, or differ between rounds")
            check(len(a["results"]) == TOP_K, f"search {i}: {len(a['results'])} results")
        check(_results(mcp_found) == _results(ws_found[0]), "MCP tools/call search differs")
        # the 2-D map over the wire: host arrays and lists, never tensors
        preview = await app.get_umap_preview(n_samples=r["n_cells"])
        xy = np.array([preview["x"], preview["y"]], np.float64)
        check(xy.shape == (2, r["n_cells"]) and np.isfinite(xy).all(), f"map preview of {xy.shape}")
        pos = await app.project_query_onto_umap(image=queries[0])
        check(set(pos) == {"x", "y"} and np.isfinite([pos["x"], pos["y"]]).all(), f"query position {pos}")
        projected = await app.search(image=queries[0], top_k=TOP_K)
        check(projected["query_projection"] == pos and _results(projected) == _results(ws_found[0]),
              "a search after the map differs or carries another position")
        local_ms = timed["in_process"]["ms"]
        r["search_ms"] = {n: _spread(timed[n]["ms"]) for n in paths}
        r["wire_ms"] = {n: _paired(timed[n]["ms"], local_ms) for n in ("websocket", "bridge")}
        r["wire_ms"]["websocket_codec"] = _spread(timed["codec_ms"])
        r["wire_ms"]["bridge_json_alone"] = _spread(
            [_json_ms({"kwargs": {"image": q.tolist(), "top_k": TOP_K}}, f) for q, f in zip(queries, ws_found)])
        w = r["wire_ms"]
        print(f"[{card}] worker: {WORKER_SEARCHES} searches (top {TOP_K}, 224^2 float64 queries, "
              f"{queries[0].nbytes} B each) x {WORKER_ROUNDS} rounds, the three paths interleaved call by call, "
              f"equal over the WebSocket, the HTTP bridge and in process, and MCP tools/call equals the first; "
              f"the map preview ({r['n_cells']} points) and the query's position came back over the wire; ms per "
              f"search: WebSocket {_fmt(r['search_ms']['websocket'])}; bridge {_fmt(r['search_ms']['bridge'])}; "
              f"in process {_fmt(r['search_ms']['in_process'])}; the wire's cost, call minus the in-process "
              f"call beside it: WebSocket {_fmt(w['websocket'])}, of which RpcStats encode+decode "
              f"{_fmt(w['websocket_codec'])}; bridge {_fmt(w['bridge'])}, against JSON encode+parse of the same "
              f"bodies done alone {_fmt(w['bridge_json_alone'])}")

        # the worker's verbs: a profiler trace around 2 searches, memory
        trace_dir = os.path.join(root, "trace")
        started = await svc.start_profiling(trace_dir=trace_dir)
        for q in queries[:WORKER_PROFILED_SEARCHES]:
            await app.search(image=q, top_k=TOP_K)
        stopped = await svc.stop_profiling()
        check(started["profiling"] and not stopped["profiling"] and stopped["trace_dir"] == trace_dir,
              f"profiling verbs {started} {stopped}")
        kernels = _trace_kernels(trace_dir)
        flash = [k for k in kernels if "flash_attn" in k]
        if device == "cuda":
            check(flash, f"the worker's trace holds no flash_attn kernel; kernels {kernels[:20]}")
        r["trace_kernels"] = len(kernels)
        r["trace_flash_kernels"] = flash
        mem = await svc.memory_profile()
        if device == "cuda":
            (dev,) = mem["devices"]
            check(dev["kind"] == torch.cuda.get_device_name(0)
                  and dev["memory_stats"]["allocated_bytes.all.current"] > 0
                  and len(mem["allocator_snapshot_pickle_b64"]) > 0, f"memory_profile {dev['kind']}")
            r["memory_profile_allocated"] = dev["memory_stats"]["allocated_bytes.all.current"]
        print(f"[{card}] worker: start/stop_profiling around {WORKER_PROFILED_SEARCHES} searches wrote "
              f"{os.path.join(trace_dir, 'trace.json')} with {len(kernels)} kernel names, flash: {flash}; "
              f"memory_profile: {r.get('memory_profile_allocated', 'no CUDA device')} B allocated, "
              f"allocator snapshot {len(mem['allocator_snapshot_pickle_b64'])} base64 chars")

        r["launches"] = attention.launch_count
        r["forwards"] = instance.embedder.forward_count
        r["found"] = ws_found
        r["cis_workspace"] = os.path.join(root, "cis")
        del instance, replica
        await svc.stop_app(app_id=WORKER_CIS)
        r["allocated_after_cis"], r["cublas_released_after_cis"] = _allocated(device)
        check(worker.cluster.state.free_chips() == worker.cluster.state.topology.n_chips,
              "the undeploy left the chip leased")

        # the model-runner from its bundle: 512^2 f32 predicts over the wire
        before_env = os.environ.get("BIOENGINE_LOCAL_MODEL_PATH")
        os.environ["BIOENGINE_LOCAL_MODEL_PATH"] = collection
        try:
            mr = await svc.deploy_app(
                local_path=os.path.join(WORKER_BUNDLES, SERVE_APP), app_id=SERVE_APP,
                deployment_kwargs={"runtime_deployment": {"device": device},
                                   "entry_deployment": {"device": device,
                                                        "cache_dir": os.path.join(root, "mr-cache")}})
            check(mr["app_id"] == SERVE_APP and "infer" in mr["methods"], f"model-runner deploy {mr}")
            runner = await conn.get_service(SERVE_APP)
            entry = worker.controller.get_handle(SERVE_APP, "entry_deployment")
            predict_paths = {"websocket": lambda x: runner.infer(model_id="unet2d", inputs={"raw": x}),
                             "in_process": lambda x: entry.infer(model_id="unet2d", inputs={"raw": x})}
            for call in predict_paths.values():  # one untimed call per path
                await call(mr_inputs[0])
            rpc0 = server.stats.as_dict()
            timed = await _interleaved(predict_paths, mr_inputs, WORKER_ROUNDS, (server.stats, conn.codec.stats))
            delta = _rpc_delta(rpc0, server.stats.as_dict())
            wire_out, local_out = timed["websocket"]["outs"], timed["in_process"]["outs"]
            n = len(wire_out)
            err = max(float(np.abs(o["mask"] - direct_masks[i % len(mr_inputs)]).max())
                      for i, o in enumerate(wire_out))
            check(err <= SERVE_TOL, f"predicts over the wire: max abs {err} against direct (tolerance {SERVE_TOL})")
            check(all(np.array_equal(a["mask"], b["mask"]) for a, b in zip(wire_out, local_out)),
                  "a predict over the wire differs from the same predict in process")
            wire_ms, local_mr_ms = timed["websocket"]["ms"], timed["in_process"]["ms"]
            r["predict"] = {"max_abs_vs_direct": err, "ms_wire": _spread(wire_ms),
                            "ms_in_process": _spread(local_mr_ms), "wire_ms": _paired(wire_ms, local_mr_ms),
                            "codec_ms": _spread(timed["codec_ms"]),
                            "request_bytes": mr_inputs[0].nbytes, "response_bytes": wire_out[0]["mask"].nbytes,
                            "server_rpc_per_request": {k: v / n for k, v in delta.items()},
                            "carried_by": _carried_by(delta)}
            p = r["predict"]
            print(f"[{card}] worker: model-runner deployed from its bundle over the wire; {len(mr_inputs)} "
                  f"{SERVE_IMAGE}^2 f32 predicts (entry infer) x {WORKER_ROUNDS} rounds over the WebSocket and "
                  f"in process, interleaved call by call, max abs {err:.6g} against the direct "
                  f"RuntimeDeployment.predict (tolerance {SERVE_TOL}), equal to the in-process handle's bit for "
                  f"bit; {p['request_bytes']} B in and {p['response_bytes']} B out a request, carried by "
                  f"{p['carried_by']} (server per request: {json.dumps(p['server_rpc_per_request'])}); ms per "
                  f"request: WebSocket {_fmt(p['ms_wire'])}; in process {_fmt(p['ms_in_process'])}; the wire's "
                  f"cost, call minus the in-process call beside it: {_fmt(p['wire_ms'])}, of which RpcStats "
                  f"encode+decode {_fmt(p['codec_ms'])}")
            await svc.stop_app(app_id=SERVE_APP)
            r["allocated_after_model_runner"], r["cublas_released_after_model_runner"] = _allocated(device)
        finally:
            if before_env is None:
                os.environ.pop("BIOENGINE_LOCAL_MODEL_PATH", None)
            else:
                os.environ["BIOENGINE_LOCAL_MODEL_PATH"] = before_env

        # run_code with one leased chip sees only that card
        code = ("import os\ndef main():\n    import torch\n"
                "    n = torch.cuda.device_count()\n"
                "    return os.environ.get('CUDA_VISIBLE_DEVICES'), n, "
                "torch.cuda.get_device_name(0) if n else None\n")
        ran = await svc.run_code(code=code, remote_options={"num_chips": 1}, timeout=300)
        check(ran["status"] == "ok", f"run_code: {ran.get('error')} {ran.get('stderr', '')[-2000:]}")
        seen = tuple(ran["result"])
        want = ("0", 1, torch.cuda.get_device_name(0)) if device == "cuda" else ("0", 0, None)
        check(seen == want and ran["device_ids"] == [0], f"run_code with one chip saw {seen}, expected {want}")
        r["run_code"] = {"seen": list(seen), "duration_s": ran["duration_s"]}
        print(f"[{card}] worker: run_code with num_chips 1 leased {ran['device_ids']}; the subprocess saw "
              f"CUDA_VISIBLE_DEVICES={seen[0]!r}, {seen[1]} device(s), {seen[2]!r} ({ran['duration_s']:.3f} s)")
        r["rpc"] = server.describe()
    finally:
        await http.close()
        await conn.disconnect()
        await worker.stop()
    check(not os.path.exists(os.path.join(ws, "cluster.lock")), "the cluster lock outlived the worker")
    return r


def _allocated(device: str) -> tuple[int, int]:
    """(bytes the caching allocator holds after a collection with the
    cuBLAS workspaces released, the bytes that release freed); (0, 0) on
    the CPU. Each thread that runs a GEMM gets a cuBLAS workspace that
    stays allocated while the thread lives and after it ends. The app's
    searches and predicts run on the executor threads of the event loop
    that runs them: after an undeploy these are the worker's, still alive
    and kept by it, and the release frees theirs too (the next GEMM on such
    a thread allocates a new one). The freed bytes are reported beside
    every reading, so what the memory check leaves out is on the record."""
    gc.collect()
    if device != "cuda":
        return 0, 0
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    after = torch.cuda.memory_allocated()
    return after, held - after


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _unlink_shm(name: str) -> None:
    try:
        os.unlink(f"/dev/shm/{name}")
    except FileNotFoundError:
        pass


def worker_cli(card: str, device: str, root: str, store_name: str) -> dict:
    """``python -m bioengine_tpu_torch.worker`` as a subprocess: liveness,
    get_status through the bridge with the admin token it wrote, SIGTERM.
    Its RPC server's shared-memory segment is ``store_name``, unlinked
    after."""
    import signal
    import urllib.request

    port, ws = _free_port(), os.path.join(root, "cli")
    cmd = [sys.executable, "-m", "bioengine_tpu_torch.worker", "--mode", "single-machine", "--host",
           "127.0.0.1", "--port", str(port), "--workspace-dir", ws, "--log-file", "off"]
    if device != "cuda":
        cmd += ["--device", device]
    env = {**os.environ, "BIOENGINE_RPC_STORE_NAME": store_name, "PYTHONPATH": os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH", "")])}
    base = f"http://127.0.0.1:{port}"
    log_path = os.path.join(root, "cli.log")

    def log_tail() -> str:
        with open(log_path) as f:
            return f.read()[-3000:]

    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                check(False, f"the worker CLI exited with {proc.returncode}: {log_tail()}")
            check(time.perf_counter() - t0 < WORKER_CLI_START_S, "the worker CLI did not answer within 60 s")
            try:
                with urllib.request.urlopen(f"{base}/health/liveness", timeout=2) as resp:
                    if resp.status == 200:
                        break
            except OSError:
                time.sleep(0.2)
        live_s = time.perf_counter() - t0
        with open(os.path.join(ws, "admin_token")) as f:
            token = f.read().strip()
        req = urllib.request.Request(f"{base}/call/bioengine-worker/get_status", data=b"{}", method="POST",
                                     headers={"Authorization": f"Bearer {token}",
                                              "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            status = json.load(resp)["result"]
        kind = status["cluster"]["topology"]["chips"][0]["kind"]
        want = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
        check(kind == want, f"the CLI worker names {kind!r}, expected {want!r}")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=WORKER_CLI_STOP_S)
        except subprocess.TimeoutExpired:
            rc = None
        check(rc is not None, f"the worker CLI did not stop within {WORKER_CLI_STOP_S} s of SIGTERM")
        stop_s = time.perf_counter() - t1
        if rc != 0:
            check(False, f"the worker CLI exited {rc} on SIGTERM: {log_tail()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        _unlink_shm(store_name)
    print(f"[{card}] worker: `python -m bioengine_tpu_torch.worker` answered /health/liveness after "
          f"{live_s:.3f} s; get_status over the bridge with its admin token names {kind!r}; SIGTERM ended it "
          f"with exit 0 in {stop_s:.3f} s")
    return {"liveness_s": live_s, "stop_s": stop_s, "kind": kind}


def phase_worker(card: str, device: str = "cuda") -> dict:
    """Slice 9: the worker in process on the card, driven over the wire
    (WebSocket, HTTP bridge, MCP); then its CLI as a subprocess. One
    ``worker`` JSON line."""
    os.environ["BIOENGINE_DISABLE_GEOLOCATION"] = "1"  # no egress
    t_phase = time.perf_counter()
    probes = {}
    for name in WORKER_PROBES:
        try:
            importlib.import_module(name)
            probes[name] = True
        except ImportError:
            probes[name] = False
    loaded = _codecs_loaded()
    store = native_store.native_available()
    compressor = "zstd" if loaded["zstd"] else None
    print(f"[{card}] worker: importable here {json.dumps(probes)}; native shm store "
          f"{'built' if store else 'not built (in-process fallback)'}; codecs loaded {json.dumps(loaded)}; "
          f"the dataset is written {compressor or 'uncompressed'}")
    check(all(probes.values()), f"packages the worker needs are missing: {probes}")
    rng = np.random.default_rng(SEED + 9)
    unet2d = UNet2D(features=UNET2D_FEATURES)
    unet2d.reset_parameters(SEED)
    mr_inputs = [rng.standard_normal((1, SERVE_IMAGE, SERVE_IMAGE, 1), np.float32)
                 for _ in range(WORKER_PREDICTS)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_worker_") as root:
        fields = write_cell_dataset(os.path.join(root, "datasets"), "cells", WORKER_FIELDS,
                                    WORKER_FIELD_SIZE, SEED + 9, compressor)
        crops = []
        for field in fields:  # query crops of the dataset's own fields, float64 (exact in JSON)
            crops += extract_cell_crops(field, crop_size=224, n_crops=WORKER_SEARCHES - len(crops))
            if len(crops) >= WORKER_SEARCHES:
                break
        queries = [c.astype(np.float64) for c in crops[:WORKER_SEARCHES]]
        check(len(queries) == WORKER_SEARCHES, f"{len(queries)} query crops")
        collection = os.path.join(root, "collection")
        os.makedirs(collection)
        pkg = write_unet_package(collection, "unet2d", unet2d, "unet2d",
                                 {"features": list(UNET2D_FEATURES)}, "byxc")
        del unet2d
        dep = RuntimeDeployment(device=device)

        async def direct():
            return [(await dep.predict(pkg, {"raw": x}))["mask"] for x in mr_inputs]

        try:
            direct_masks = asyncio.run(direct())
        finally:
            asyncio.run(dep.close())
        del dep
        base, released_before = _allocated(device)
        # the worker's RPC server gets a shared-memory segment of this run's
        # own, not the host-wide default another run may be using
        store_name = f"bioengine-rpc-smoke-{os.getpid()}"
        os.environ["BIOENGINE_RPC_STORE_NAME"] = store_name
        try:
            r = asyncio.run(drive_worker(card, device, root, queries, collection, direct_masks, mr_inputs))
        finally:
            del os.environ["BIOENGINE_RPC_STORE_NAME"]
            _unlink_shm(store_name)
        after, released_after = _allocated(device)
        if device == "cuda":
            r["memory_before"], r["memory_after"] = base, after
            r["cublas_released_before"], r["cublas_released_after_stop"] = released_before, released_after
            print(f"[{card}] worker: device memory allocated {base} B before the worker; "
                  f"{r['allocated_after_cis']} B after the search app's undeploy, "
                  f"{r['allocated_after_model_runner']} B after the model-runner's, {after} B after the "
                  f"worker's stop ({(after - base) / 2**20:.3f} MiB apart, limit 64 MiB); cuBLAS workspaces "
                  f"released before these readings: {released_before}, {r['cublas_released_after_cis']}, "
                  f"{r['cublas_released_after_model_runner']} and {released_after} B (the two after the "
                  "undeploys are the worker's live executor threads'); cluster lock released")
            check(after - base <= SERVE_MEMORY_SLACK, f"after the undeploys {after} B allocated against {base} B "
                  f"before the worker (slack {SERVE_MEMORY_SLACK} B)")

        # the searches over the wire against the app built here on the same
        # seed over the index the worker wrote
        found, forwards, launches = r.pop("found"), r.pop("forwards"), r.pop("launches")
        # the plain attention on the CPU launches nothing
        want = WORKER_VIT.get("depth", VIT_DEPTH) * forwards if device == "cuda" else 0
        check(launches == want and forwards > 0 and (launches > 0 or device != "cuda"),
              f"flash_attn_fwd launches {launches} on the worker path, {forwards} forwards")
        ref = CellImageSearch(workspace_dir=r.pop("cis_workspace"), device=device, seed=SEED,
                              batch_bucket=BUCKET, model_overrides=WORKER_VIT)

        async def reference():
            await ref.async_init()
            return [await ref.search(image=q, top_k=TOP_K) for q in queries]

        mine = asyncio.run(reference())
        for i, (a, b) in enumerate(zip(found, mine)):
            pairs = [(x["index_id"], x["score"]) for x in a["results"]]
            check(pairs == [(x["index_id"], x["score"]) for x in b["results"]],
                  f"search {i} over the wire differs from CellImageSearch(device={device!r}) in process")
        del ref, mine
        print(f"[{card}] worker: {WORKER_SEARCHES} searches over the wire equal, ids and scores bit for bit, "
              f"CellImageSearch(device={device!r}) built here on seed {SEED} over the worker's index; "
              f"flash_attn_fwd launches {launches} = {WORKER_VIT.get("depth", VIT_DEPTH)} x {forwards} forwards")
        r["cli"] = worker_cli(card, device, root, f"{store_name}-cli")
    r["phase_s"] = time.perf_counter() - t_phase
    out = {"card": card, **r, "flash_attn_fwd_launches": launches, "forwards": forwards,
           "packages": probes, "codecs": loaded, "native_store": store, "dataset_compressor": compressor}
    print(f"[{card}] worker phase: {r['phase_s']:.3f} s")
    print("worker " + json.dumps(out, default=str))
    return out


def main() -> int:
    card, name = phase_device()
    ptxas = phase_build(card)
    main_cases = phase_kernels(card)
    main_case, f32_case = main_cases[torch.bfloat16], main_cases[torch.float32]
    launches = phase_main_path(card)
    main_f32 = phase_main_path_f32(card)
    index = phase_index(card)
    forward = phase_forward(card)
    model_runner = phase_model_runner(card)
    cellpose = phase_cellpose(card)
    transformers = phase_cellpose_transformers(card)
    zoo = phase_zoo(card)
    decode = phase_decode(card)
    serving = phase_serving(card)
    worker = phase_worker(card)
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "bioengine_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "bioengine_tpu/ops/pallas/attention.py:36",
        "path": main_case["path"],
        "launches": launches,
        # slices 2-5, 7 and 8 launch no attention kernel: their counts stay 0
        "launches_by_path": {"cell_image_search": launches,
                             "cell_image_search_f32": main_f32["launches"],
                             "index": index["launches"],
                             "model_runner": model_runner["launches"],
                             "cellpose": cellpose["launches"],
                             "cellpose_transformers": transformers["launches"],
                             "zoo": zoo["launches"],
                             "decode": decode["flash_attn_fwd_launches"],
                             "serving": serving["flash_attn_fwd_launches"],
                             "worker": worker["flash_attn_fwd_launches"]},
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"],
        "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "forward_ms": forward["kernel"],
        "forward_plain_ms": forward["plain"],
        # the f32 (tf32x3) path at the same shape, timed in turns
        "f32": {key: f32_case[key] for key in (
            "path", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_cuda_core_ms", "max_abs_err", "library_max_abs_err")},
        "ptxas": ptxas[attention.KERNEL_NAME],
        "smem_bytes": attention.launch_plan(main_case["shape"], torch.bfloat16).smem_bytes,
        "f32_smem_bytes": attention.launch_plan(f32_case["shape"], torch.float32).smem_bytes,
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
