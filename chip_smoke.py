#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. device: CUDA must be there; prints the card's name and power limit;
2. build: nvcc builds every kernel under bioengine_tpu_torch/csrc, and
   ptxas's registers, shared memory and spills are printed per kernel;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and the test suite's, with CUDA-event times; for flash
   attention its three paths: bf16 and f16 (wgmma) and f32 (3xTF32) on the
   tensor cores at every padded width (head dims 1 to 256, 16-bit, and 1 to
   128, f32), and the wide path on the CUDA cores (f32 160 and 256, 16-bit
   320 to 1024), each at n 1, 65 and 257 and causal; every instantiation
   must be launched and within its tolerance (2e-5 f32, 2e-2 bf16, 2.5e-3
   f16); the f32 and f16 ViT-B/14 cases and the ViT-H/14 cases (64, 16, 257,
   80) in bf16 and f16 are timed in turns beside the plain version and SDPA
   (plain, kernel, SDPA, SDPA, kernel, plain), with SDPA's own error against
   the plain version;
4. the main path: cell-image-search at ViT-B/14 width (dim 768, depth 12,
   heads 12, 224², bf16, bucket 64, weights from a numpy seed) ingests
   synthetic fields, builds a FlatIP index and answers ping,
   get_index_stats and 8 searches, with the kernels' launch counts read
   around it and the embeddings held against the plain attention path;
   then the same in float32 (``phase_main_path_f32``, ``model_overrides``
   ``{"dtype": "float32"}``, TF32 off): 12 launches per forward, min cosine
   0.99999 against the plain-attention embedder, and images/s and one
   bucket forward's device ms with the kernel, the plain attention and
   SDPA (a yardstick only) as ``attn_fn``, in turns; then ``phase_vit_h14``:
   ``ViTEmbedder`` at ViT-H/14 widths (1280, 32 blocks, 16 heads of 80,
   seeded weights) in bf16 and with ``"dtype": "float16"`` on the same
   state dict, 32 launches per bucket forward, min cosine 0.999 against the
   same model with the plain attention, images/s and peak memory of each;
5. cell-image-search at corpus scale (slice 6), ``phase_index``: the app
   at the same width registers a synthetic dataset of 8 896^2 fields,
   ingests it in a background session (FlatIP), stops a second session of
   64 fields, lists sessions and datasets, removes one, computes the 2-D
   map, projects a query and answers 8 searches with their
   ``query_projection`` (a corpus crop must come back first); then a seeded
   1M x 768 mixture of 10,000 components with 64 perturbed queries and
   exact f32 top-10 on the card: ``build_index`` IVFFlat over 100K (nlist
   316; k-means, sort and save seconds, npz size) reloaded and served by
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
   lr 1e-4) for 2 epochs on the 16 fields (loss must fall), then
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
14. every app bundle on the worker (slice 10), ``phase_apps``: one
   ``BioEngineWorker(device="cuda")`` in process, driven over a
   ``connect_to_server`` WebSocket client, deploys and undeploys each
   bundle in turn on the one card: gpu-test (``gpu_info`` names the card,
   a bf16 128x128 matmul's norm is 16384.0; ``memory_info``); generate at
   ``DecoderConfig()`` (unary over the WebSocket, the HTTP bridge and MCP
   equal to the golden fixture, the deployment handle's ``generate_stream``
   and its resume, 8 unary calls x 2 rounds over the WebSocket and on the
   handle in turns, TTFT and inter-token p50/p95/p99 of 8 concurrent handle
   streams of 64 tokens, a cold round and a warm one, beside the bundle's
   250 ms objective); cellpose-finetuning (``start_training`` over the wire
   with step 8's CellposeNet session, polled to ``completed``; ``infer`` of
   2 x 512^2 over the WebSocket equal to the deployed instance's in-process
   ``infer``, masks bit for bit and the network's output within 1e-5; ms
   per ``infer`` on both paths; ``export_model``; the frontend; the peak
   memory of the leased card); the model-runner fetching the UNet2D
   package of step 7 from a loopback HTTP collection through
   ``HttpCollectionSource``, with fibsem-mito-analysis (chips 0) beside it
   calling it over the wire with a worker-issued token: ``analyze`` of a
   2048^2 EM-like field (25 tiles of 512, overlap 64) equal, labels bit
   for bit, to the same analysis made here from the entry handle's
   predictions, with its ms split into the model-runner calls and the
   host's work, and an http input equal to the inline array;
   composition-demo's ``fan_out(7)``; after every undeploy the chips are
   free and the allocated memory is back within 64 MiB; the attention
   kernel's count stays 0; one ``apps`` JSON line;
15. worker hosts and the CLI (slice 11), ``phase_hosts``: an ``RpcServer``
   and a ``ServeController`` with no chips of its own in process;
   ``python -m bioengine_tpu_torch.worker_host`` with no device flag joins
   with the card as its one chip; the cell-image-search bundle at ViT-B/14
   width is placed on it as a ``RemoteReplica`` leasing the chip, ingests 8
   synthetic 896^2 fields from a local directory, and answers 16 searches x
   2 rounds through the controller's handle, each equal in ids and scores,
   bit for bit, to ``CellImageSearch(device="cuda")`` built here over the
   index the host wrote, with ms per search through the host and in
   process in turns and the hop's cost; the host's own ``torch.profiler``
   trace around 2 searches holds 12 ``flash_attn`` kernel events per
   bucket forward and its ``memory_profile`` names the card; the shared
   compile-cache tier (slice 13): h1 starts with an empty kernel cache
   (``BIOENGINE_COMPILE_CACHE``), builds the flash kernel's library with
   nvcc (its embedder build tagged a real build) and its publish loop puts
   the entry on the controller's tier; a client times the list, fetch and
   install a joining host does; a second host h2 joins on the same card
   with an empty cache and no nvcc (``PATH`` without it, ``CUDA_HOME`` an
   empty directory: a probe process there fails to find it), fetches the
   entry (``describe()["compile_tier"]["fetched"]``, the same bytes as h1's,
   no nvcc log, a ``program.cache_fetch`` event, its embedder build tagged
   a persistent hit); h1 is SIGKILLed, health ticks re-place the replica on
   h2 and the searches are equal again, and h2's own trace holds 12
   ``flash_attn`` events per bucket forward; then ``python -m bioengine_tpu_torch.worker``
   as a subprocess with a third host joined, driven by ``python -m
   bioengine_tpu_torch.cli`` (``cluster status`` 2 chips across 2 hosts,
   ``status``, ``apps deploy`` of gpu-test, ``call gpu_info``, ``apps
   stop``, ``cluster profile --memory``, ``debug bundle`` 1 of 1 hosts,
   ``models convert --arch dinov2`` of a seeded ViT-B/14 checkpoint whose
   npz loads as the embedder's weights), each exiting 0; the hosts and the
   worker exit 0 on SIGTERM and the card's used memory is back within 64
   MiB; one ``hosts`` JSON line;
16. the scenario engine, the fuzzer and the controller process (slice 12),
   ``phase_scenarios``: (a) each catalog scenario with worker hosts
   (slow_replica with defenses on and off, preemption_storm, diurnal_wave,
   blip_storm, controller_crash, token_streaming) at one chip a replica
   (``dataclasses.replace``, as bench.py cuts it for one device), its
   in-process hosts on the card and then on one CPU chip at seed 7 (every
   time constant doubled, ``BIOENGINE_SCENARIO_SCALE=2.0``): equal
   outcome signatures, every required invariant green with defenses, and
   ``p99_recovery`` red without; the host-less ones (hot_signature,
   tenant_flood, fleet_scale, router_loss) once; each run's wall time and
   red set; (b) ``python -m bioengine_tpu_torch.cli`` ``scenarios list``,
   ``scenarios run router_loss --device cuda --check-determinism`` and
   ``fuzz --replay tests/fuzz_corpus/host_blip_drain_starvation.json
   --device cpu --n-devices 8`` exit 0 (the replay's signature equal to the
   pinned one), and ``scenarios run slow_replica --device cuda`` on one card
   exits non-zero with the placement error; (c) ``python -m
   bioengine_tpu_torch.testing.controller_proc`` deploys the
   cell-image-search bundle as shipped (ViT-B/14, bf16, bucket 64) onto a
   ``WorkerHost(device="cuda")`` in this process, which ingests 8 896^2
   fields and answers 16 searches; the controller is SIGKILLed under
   idempotent searches and its ``--recover`` life prints ``RECONCILED
   adopted=1 replaced=0``; every search across the crash and 16 after it
   equal the 16 before bit for bit, none failed, and the host's
   ``torch.profiler`` trace of the 16 after holds 12 ``flash_attn`` events
   per bucket forward; the times from the SIGKILL to ``RECONCILED`` and to
   the first answered search; one ``scenarios`` JSON line;
17. device prefetch (slice 13), ``phase_prefetch``: 512 seeded 224^2 RGB
   crops (uint8, as ``to_rgb_uint8`` makes them) in a zarr array on the
   datasets plane (a ``DatasetsServer`` on loopback), streamed in 8
   batches of 64 by ``ZarrBatchLoader(prefetch_batches=2)`` onto the card,
   scaled there (``model_input``) and embedded by the cell-image-search
   ``ViTEmbedder`` (ViT-B/14, bf16): every run equal bit for bit to the
   rows uploaded whole; images/s with the prefetch and with synchronous
   uploads of the same host batches, in turns; the same from host memory
   (``prefetch_to_device`` over the batches, 4 passes a run); in a
   ``torch.profiler`` run of each, the batch copies are ``Memcpy HtoD
   (Pinned -> Device)`` on a stream other than the ``flash_attn`` kernels',
   with the share of copy time that overlaps kernels; 12 launches per
   batch; one ``prefetch`` JSON line;
18. train-state checkpoints (slice 13), ``phase_checkpoints``: a
   ``CellposeNet`` (32, 64, 128, 256) ``TrainState`` on the card saved by
   ``CheckpointService`` before each of 5 steps at 8 x 256^2 with
   ``max_to_keep=2`` (cuDNN deterministic): ``steps()`` is [3, 4],
   ``restore_latest`` onto a fresh state gives the parameters and AdamW
   moments of step 4 bit for bit, and a step after it equals the
   uninterrupted step 5 bit for bit; a step taken right after ``save``
   leaves the checkpoint as saved; ``save``'s return and commit ms and the
   bytes a step; one ``checkpoints`` JSON line;
19. data parallelism (slice 14), ``phase_data_parallel``: (a) dp = 1
   through the mesh code on ``cuda:0`` (``make_mesh({"dp": 1})``), bit for
   bit the single-device path: the UNet2D (32, 64, 128, 256) bf16 engine
   on 8 x 512^2 and a tiled 2048^2 (512/64), the ViT-B/14 bf16 embedder on
   a bucket of 64, and 3 CellposeNet (32, 64, 128, 256) steps at 8 x 256^2
   (``data_parallel_step`` against ``make_train_step``, cuDNN
   deterministic); (b) a stacked dp = 2 mesh ``[cuda:0, cuda:0]`` from an
   explicit ``make_mesh``, each shard a replica with a CUDA graph of its
   own: the engine within phase 7's bf16 bound, 24 flash launches per
   bucket forward (12 per shard, also counted in a ``torch.profiler``
   trace) with embeddings within phase 4's min cosine, 5 dp CellposeNet
   steps with losses within the bf16 tolerance, their batches streamed by
   ``prefetch_to_device(sharding=)`` (a copy stream per device) equal to
   ``shard_batch``'s, the replicas equal bit for bit after every step and
   a ``CheckpointService`` save restored onto a fresh dp state bit for
   bit; (c) ``resolve_devices([0], "cuda")``, and a
   two-id lease refused on a one-card machine; ms per request, images/s
   and ms per step for each; one ``data_parallel`` JSON line;
20. the rest of the parallel layer (slice 15), ``phase_parallel_layer``,
   each multi-device leg on a stacked mesh of ``cuda:0`` entries: (a)
   ``DecodeEngine`` dp: the repo's decoder at dp = 1 through the mesh and
   at dp = 2 gives the fixture's greedy tokens; the 768 x 12 decoder with
   8 concurrent sequences of mixed prompt lengths through ``DecodeLoop``,
   dp = 2 tokens equal dp = 1's bit for bit, step logits within 1e-5,
   every pool drained; (b) tensor parallelism: ViT-B/14 bf16, bucket 64,
   ``VIT_TP_RULES`` through ``InferenceEngine`` at tp = 2 and dp 2 x tp 2:
   min cosine 0.999 to one device, ``shard_fraction`` < 0.6, 24 and 48
   flash launches per eager forward and as many ``flash_attn`` kernels in
   its profiler trace; UNet2D (32, 64, 128, 256) bf16 with
   ``CONV_TP_RULES`` at tp = 2 within phase 7's bf16 bound; (c) spatial:
   UNet3D (16, 32, 64) on 96 x 256^2 depth-split over sp = 2 (halo 16)
   against the haloed blocks built on the host, and an f32 conv stack's
   interior within 1e-4 of the unsharded forward; (d) ring attention in
   the ViT-B/14 f32 ``attn_fn`` slot at 518^2 (1,370 tokens) within 1e-4
   of the inline attention, beside the flash path, peak memory each; (e)
   ``ShardedKnnIndex`` over the seeded 1M x 768 corpus, top-10 ids equal to
   ``topk_inner_product``'s apart from ties; one ``parallel_layer`` JSON
   line;
21. the exact dp x sp train step and the dry run (slice 16),
   ``phase_dryrun``: (a) CellposeNet (32, 64, 128, 256) at the
   cellpose-finetuning defaults, 8 x 256^2 of synthetic fields, bf16 and
   then f32 (TF32 off): ``data_parallel_step`` over a stacked dp 2 x sp 2
   mesh of four ``cuda:0`` entries against the single-device step on the
   same seeded weights and batch, the loss's relative difference, each
   summed gradient's cosine and relative L2 held to bounds
   (``DRY_BOUNDS``), ms per step (CUDA events) and peak memory for both;
   (b) ``graft_entry.dryrun_multichip(4, devices=[cuda:0] * 4)`` to its
   OK line, whose meshes, shapes and transfer bytes must be the JAX dry
   run's for 4 devices; (c) no flash launch on the path; one ``dryrun``
   JSON line;
22. the static analyzer (slice 17), ``phase_analysis``: (a) the port's
   gate, ``bioengine_tpu_torch.analysis.__main__.main(["bioengine_tpu_torch",
   "--cache", tmp, "--stats-json", tmp])`` in a fresh interpreter, must
   return 0 against ``.analyze-torch-baseline.json``, with its wall
   seconds, files indexed and findings baselined; (b) each BE-GRAPH rule's
   fixture (``tests/torch_analysis_fixtures/fx_graph_*.py``, imported by
   path) on the card: every seeded positive shows its rule's hazard under
   ``torch.cuda.graph`` (capture raises for 101, 102, 103 and 105; for 104
   the side effect happens once at capture and 3 replays leave it so), and
   every negative captures and replays 3 times on fresh inputs bit for bit
   equal to eager; (c) no flash launch on the path; one ``analysis`` JSON
   line; then the seconds of every phase;
23. one JSON line of the kernels' numbers;
24. the result line ``{"ok": true, "device": {...}}``, printed last.

Any failed check exits non-zero before the result line. f32 comparisons
run with TF32 off for both cuBLAS and cuDNN, so the plain versions are full
f32.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import re
import runpy
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import aiohttp
import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from bioengine_tpu_torch import graft_entry
from bioengine_tpu_torch.apps.builder import AppBuilder
from bioengine_tpu_torch.apps.cell_image_search.embedder import ViTEmbedder, model_input
from bioengine_tpu_torch.apps.cell_image_search.index import (
    IVFFLAT_MAX_CELLS,
    FlatIPIndex,
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
from bioengine_tpu_torch.apps.model_runner.entry import EntryDeployment, HttpCollectionSource
from bioengine_tpu_torch.apps.model_runner.runtime import RuntimeDeployment
from bioengine_tpu_torch.cluster.state import ClusterState
from bioengine_tpu_torch.cluster.topology import TpuTopology, detect_topology
from bioengine_tpu_torch.apps.cell_image_search.normalizer import to_rgb_uint8
from bioengine_tpu_torch.datasets import (
    ChunkCache,
    DatasetsServer,
    HttpZarrStore,
    RemoteZarrArray,
    ZarrBatchLoader,
    codecs,
    prefetch_to_device,
    zarr_codec,
)
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
from bioengine_tpu_torch.ops.knn import ShardedKnnIndex, pq_scan_topk, topk_inner_product
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
from bioengine_tpu_torch.runtime.checkpoints import CheckpointService
from bioengine_tpu_torch.runtime.devices import resolve_devices
from bioengine_tpu_torch.runtime.engine import GRAPH_WARMUP_ITERS, EngineConfig, InferenceEngine, _tile_starts
from bioengine_tpu_torch.parallel.data_parallel import Shards, data_parallel_step, replicate, shard_batch
from bioengine_tpu_torch.parallel.mesh import PartitionSpec as P, make_mesh, sharding
from bioengine_tpu_torch.parallel.ring import make_ring_attention
from bioengine_tpu_torch.parallel.spatial import spatial_shard_apply
from bioengine_tpu_torch.parallel.tensor_parallel import CONV_TP_RULES, VIT_TP_RULES, shard_fraction
from bioengine_tpu_torch.runtime.decode_engine import (
    DecodeEngine,
    DecoderConfig,
    init_decoder_params,
)
from bioengine_tpu_torch.runtime.program_cache import CompiledProgramCache
from bioengine_tpu_torch.runtime.rdf import apply_processing, from_nhwc, load_model_rdf, parse_rdf_text, to_nhwc
from bioengine_tpu_torch.runtime.weight_stream import write_manifest
from bioengine_tpu_torch.serving.decode import DecodeLoop
from bioengine_tpu_torch.native import store as native_store
from bioengine_tpu_torch.rpc import connect_to_server
from bioengine_tpu_torch.rpc.server import RpcServer
from bioengine_tpu_torch.serving.compile_tier import CompileCacheTier
from bioengine_tpu_torch.serving.remote import RemoteReplica
from bioengine_tpu_torch.serving import (
    DeploymentHandle,
    DeploymentSpec,
    ReplicaState,
    RequestOptions,
    ServeController,
)
from bioengine_tpu_torch.testing import fuzz, scenarios
from bioengine_tpu_torch.utils import compile_cache
from bioengine_tpu_torch.worker.worker import BioEngineWorker
from bioengine_tpu_torch.worker_host import WorkerHost

SEED = 0
BUCKET = 64
VIT_DEPTH = 12
N_FIELDS = 4
N_SEARCHES = 8
TOP_K = 10
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores, dense TF32 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
PEAK_TF32_FLOPS = 495e12
F32_COSINE_FLOOR = 0.99999  # f32 kernel vs plain-attention embeddings
# the test suite's tolerances (tests/test_ops_pallas.py): (atol, rtol); f16
# a little over one f16 ulp at the outputs' largest magnitudes (2 to 4: 2^-9)
TOLERANCE = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 0.0), torch.float16: (2.5e-3, 0.0)}
# head dims off the tensor-core paths' tiles, run at a padded width Dp
PADDED_16BIT_DIMS = (1, 8, 16, 40, 48, 72, 80, 96, 100, 112, 160, 192, 256)
PADDED_F32_DIMS = (1, 16, 40, 80, 96, 100)
# the wide path (CUDA cores): f32 above 128, 16-bit above 256
WIDE_DIMS = {torch.float32: (160, 256), torch.bfloat16: (320, 512, 1024), torch.float16: (320, 512, 1024)}
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


def _width_cases(dtype, dims) -> list:
    """Each head dim at n 1, 65 and 257 and causal at 257, (2, 3) heads."""
    name = DTYPE_NAMES[dtype]
    return [(f"{name}_d{d}_n{n}", (2, 3, n, d), dtype, False) for d in dims for n in (1, 65, 257)] + [
        (f"{name}_d{d}_n257_causal", (2, 3, 257, d), dtype, True) for d in dims
    ]


ATTENTION_CASES = [
    # (label, (B, H, N, d), dtype, causal)
    ("vit_b14_main_path", (BUCKET, 12, 257, 64), torch.bfloat16, False),
    ("vit_b14_main_path_f32", (BUCKET, 12, 257, 64), torch.float32, False),
    # ViT-H/14's attention (16 heads of 80) in bf16 and f16, and ViT-B/14's in f16
    ("vit_h14_main_path_bf16", (BUCKET, 16, 257, 80), torch.bfloat16, False),
    ("vit_h14_main_path_f16", (BUCKET, 16, 257, 80), torch.float16, False),
    ("vit_b14_main_path_f16", (BUCKET, 12, 257, 64), torch.float16, False),
    # the same ViT-H/14 attention in f32 (tf32x3 at Dp 128), and the wide path
    # at bucket shapes: f32 with 8 heads of 160, bf16 with 4 heads of 320
    ("vit_h14_main_path_f32", (BUCKET, 16, 257, 80), torch.float32, False),
    ("wide_f32_d160", (BUCKET, 8, 257, 160), torch.float32, False),
    ("wide_bf16_d320", (BUCKET, 4, 257, 320), torch.bfloat16, False),
    # the 16-bit path's other padded widths at ViT-B/14's bucket shape
    ("vit_b14_width_d32_bf16", (BUCKET, 12, 257, 32), torch.bfloat16, False),
    ("vit_b14_width_d192_bf16", (BUCKET, 12, 257, 192), torch.bfloat16, False),
    ("vit_b14_width_d256_bf16", (BUCKET, 12, 257, 256), torch.bfloat16, False),
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
] + [
    # f16 (wgmma .f16) at the bf16 cases' widths and edges
    (f"f16_d{d}_n{n}", (2, 3, n, d), torch.float16, False)
    for d in (32, 64, 128)
    for n in (1, 64, 65, 257, 300)
] + [
    (f"f16_d{d}_n257_causal", (2, 3, 257, d), torch.float16, True)
    for d in (32, 64, 128)
] + [
    # every other head dim: padded widths of both tensor-core paths, then the
    # wide path up to its cap
    case
    for dtype, dims in (
        (torch.bfloat16, PADDED_16BIT_DIMS),
        (torch.float16, PADDED_16BIT_DIMS),
        (torch.float32, PADDED_F32_DIMS),
        *WIDE_DIMS.items(),
    )
    for case in _width_cases(dtype, dims)
]
MAIN_CASE = "vit_b14_main_path"
# timed in turns against SDPA: plain, kernel, SDPA, SDPA, kernel, plain
TIMED_WIDTHS = ("vit_b14_width_d32_bf16", "vit_b14_width_d192_bf16", "vit_b14_width_d256_bf16")
TURNS_CASES = (MAIN_CASE, "vit_b14_main_path_f32", "vit_h14_main_path_bf16", "vit_h14_main_path_f16",
               "vit_b14_main_path_f16", "vit_h14_main_path_f32", "wide_f32_d160",
               "wide_bf16_d320") + TIMED_WIDTHS


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
    """Least time for one call, from the function and the inputs' type alone,
    whatever path the kernel takes: q, k, v read once and o written once
    over HBM bandwidth, against 4*B*H*N^2*d FLOP at the tensor cores' peak
    for the type: 16-bit products at the bf16/f16 peak, f32-grade ones as
    3xTF32 (three tf32 products each at the TF32 peak)."""
    B, H, N, d = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    t_bytes = 4 * B * H * N * d * itemsize / PEAK_BYTES_PER_S
    flops = 4 * B * H * N * N * d
    if dtype == torch.float32:
        t_ops = 3 * flops / PEAK_TF32_FLOPS
    else:
        t_ops = flops / PEAK_FLOPS[dtype]
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
    ``flash_attn_wgmma_kernel<1,64>`` (its integer template arguments)."""

    def short(mangled: str) -> str:
        # the kernel's name is the identifier before its template arguments,
        # prefixed by its length
        m = re.search(r"I((?:Li-?\d+E)+)E", mangled)
        if m:
            end = m.start()
            args = ",".join(re.findall(r"Li(-?\d+)E", m.group(1)))
            for size in range(1, end):
                digits = str(size)
                if mangled[end - size - len(digits):end - size] == digits:
                    return f"{mangled[end - size:end]}<{args}>"
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
    for kernel in attention.kernel_instantiations():
        info = ptxas.get(attention.KERNEL_NAME, {}).get(kernel)
        check(info is not None and "registers" in info, f"no ptxas report for {kernel}")
    return ptxas


def time_in_turns(fns: dict, order, device: str = "cuda", iters: int = 20) -> dict:
    """ms per call of each named fn (CUDA events on the card, mean of
    ``iters`` after 3 warm-ups), timed in ``order``: name -> list of ms."""
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(_device_ms(device, fns[name], iters=iters, warmup=3))
    return times


def phase_kernels(card: str) -> dict:
    """Each attention case: the kernel against the plain version, both on
    the card. Returns the timed cases' numbers by label, and under
    ``"instantiations"`` each kernel's cases, worst error and tolerance."""
    # inputs drawn on the card from a seed: the bucket shapes' 12-21 M values
    # a tensor would take seconds to draw on the host
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main = {}
    per_kernel: dict[str, dict] = {}
    for label, shape, dtype, causal in ATTENTION_CASES:
        q, k, v = (
            torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3)
        )
        before = attention.launch_count
        out = attention.flash_attention(q, k, v, causal=causal)
        check(attention.launch_count == before + 1, f"{label}: the wrapper launched no kernel")
        ref = attention.reference_attention(q, k, v, causal)
        torch.cuda.synchronize()
        check(out.dtype == dtype and out.shape == q.shape, f"{label}: output {out.dtype} {tuple(out.shape)}")
        diff = (out.float() - ref.float()).abs()
        atol, rtol = TOLERANCE[dtype]
        max_abs = diff.max().item()
        within = bool((diff <= atol + rtol * ref.float().abs()).all().item())
        check(bool(torch.isfinite(out).all().item()), f"{label}: non-finite output")
        check(within, f"{label}: max abs err {max_abs} over atol {atol} rtol {rtol}")
        plan = attention.launch_plan(shape, dtype)
        kernel = plan.kernel
        line = {
            "case": label, "shape": list(shape), "dtype": str(dtype).split(".")[-1],
            "causal": causal, "path": plan.path, "dp": plan.dp, "ld": plan.ld, "kernel": kernel,
            "max_abs_err": max_abs, "atol": atol, "rtol": rtol,
        }
        seen = per_kernel.setdefault(kernel, {"cases": 0, "max_abs_err": 0.0, "atol": atol, "rtol": rtol})
        seen["cases"] += 1
        seen["max_abs_err"] = max(seen["max_abs_err"], max_abs)
        if label in TURNS_CASES:
            # in turns, plain, kernel, SDPA, SDPA, kernel, plain
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
            # the library's own attention against the same plain version
            line["library_max_abs_err"] = (lib.float() - ref.float()).abs().max().item()
            line["bound_cuda_core_ms"] = attention_cuda_core_ms(shape)
            del lib
        if label in TURNS_CASES:
            line["bound_ms"], line["bound_by"] = attention_bound_ms(shape, dtype)
            line["card"] = card
            main[label] = line
        print("attention " + json.dumps(line))
        del q, k, v, out, ref, diff
    missing = [name for name in attention.kernel_instantiations() if name not in per_kernel]
    check(not missing, f"no attention case launched {missing}")
    print(f"[{card}] attention: {len(ATTENTION_CASES)} cases over {len(per_kernel)} kernels, "
          "each within its tolerance: " + json.dumps(per_kernel))
    main["instantiations"] = per_kernel
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
MAIN_F32_TIMED_FORWARDS = 10  # bucket forwards per turn (CUDA events)


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
            {name: (lambda e=e: e._model(x)) for name, e in embedders.items()}, order, device,
            iters=MAIN_F32_TIMED_FORWARDS,
        )
    print(f"[{card}] f32 embed, 3 full buckets of {BUCKET} (host clock), in turns {order}: "
          f"images/s kernel {rates['kernel']}, plain attention {rates['plain']}, SDPA {rates['sdpa']}")
    print(f"[{card}] f32 bucket forward (CUDA events, mean of {MAIN_F32_TIMED_FORWARDS} after 3 warm-up), "
          f"same turns: "
          f"ms kernel {forward_ms['kernel']}, plain attention {forward_ms['plain']}, "
          f"SDPA {forward_ms['sdpa']}")
    out = {"launches": launches, "forwards": forwards, "min_cosine": float(cos.min()),
           "images_per_s": rates, "forward_ms": forward_ms, "card": card}
    print("main_path_f32 " + json.dumps(out))
    del embedders, svc, x
    _release(device)
    return out


# ---- ViT-H/14 widths: head dim 80 in bf16 and f16 ----------------------------

# ViT-H/14 (Dosovitskiy et al., ICLR 2021, Table 1): width 1280, 32 blocks, 16
# heads of 80, MLP 5120 (the ViT's ratio 4), patch 14 at 224^2 (257 tokens);
# the repo's ViT module, its DINOv2 LayerScale kept
VIT_H14 = {"dim": 1280, "depth": 32, "num_heads": 16}
VIT_H14_TIMED = 3  # bucket forwards per turn
VIT_H14_COSINE_FLOOR = 0.999  # flash vs plain attention embeddings, bf16 and f16


def phase_vit_h14(card: str, device: str = "cuda") -> dict:
    """The ViT at ViT-H/14 widths through ``ViTEmbedder`` (seeded weights,
    bucket 64), once in bfloat16 and once with ``"dtype": "float16"`` on the
    same state dict (the seed's draws, checked by per-tensor sums; the two
    embedders are built at once, and a leg's peak memory leaves out the other
    leg's weights while both are on the card): each
    bucket forward launches the kernel once per block at head dim 80 (Dp
    128); the embeddings are held against the same model with the plain
    ``reference_attention`` in its attention slots (min cosine >= 0.999);
    images/s from CUDA events over bucket forwards in turns (kernel, plain,
    plain, kernel) and the peak memory of each. One ``vit_h14`` JSON line."""
    crops = synthetic_crops(SEED, N_FIELDS)[:BUCKET]
    x = torch.from_numpy(
        np.random.default_rng(SEED).standard_normal((BUCKET, 224, 224, 3), np.float32)
    ).to(device)
    depth = VIT_H14["depth"]
    legs, flash_embs, fingerprint = {}, {}, None
    print(f"vit_h14: ViT (width {VIT_H14['dim']}, {depth} blocks, {VIT_H14['num_heads']} heads of "
          f"{VIT_H14['dim'] // VIT_H14['num_heads']}, patch 14, 224^2), bucket {BUCKET}, "
          f"{len(crops)} crops; bf16 then f16")
    embedders = {dtype: ViTEmbedder(batch_bucket=BUCKET, device=device, seed=SEED,
                                    model_overrides={**VIT_H14, "dtype": dtype})
                 for dtype in ("bfloat16", "float16")}
    # each seeded build draws its weights on the host (numpy releases the GIL
    # while it fills an array): both at once
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(embedders)) as pool:
        for build in [pool.submit(emb.load) for emb in embedders.values()]:
            build.result()
    build_s = time.perf_counter() - t0
    for dtype in ("bfloat16", "float16"):
        emb = embedders.pop(dtype)
        model = emb._model
        check(model.dtype == getattr(torch, dtype), f"{dtype}: model dtype {model.dtype}")
        sums = torch.stack([p.double().sum() for p in model.state_dict().values()]).cpu()
        fingerprint = sums if fingerprint is None else fingerprint
        check(torch.equal(sums, fingerprint), f"{dtype}: the state dict is not the bfloat16 leg's")
        # the other leg's weights, still on the card, are not this leg's memory
        resident = sum(p.numel() * p.element_size() for e in embedders.values()
                       for p in e._model.parameters())

        def use(attn_fn):
            for block in model.blocks():
                block.attn.attn_fn = attn_fn

        def peak_reset():
            _sync(device)
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()

        def peak() -> int:
            return torch.cuda.max_memory_allocated() - resident if device == "cuda" else 0

        peak_reset()
        attention.launch_count = 0
        forwards0 = emb.forward_count
        flash = emb.embed_batch(crops)
        launches = attention.launch_count
        forwards = emb.forward_count - forwards0
        peak_flash = peak()
        want = depth * forwards if device == "cuda" else 0
        check(forwards > 0 and launches == want,
              f"{dtype}: {launches} flash launches for {forwards} bucket forwards, expected {want}")
        check(flash.shape == (len(crops), VIT_H14["dim"]) and np.isfinite(flash).all(),
              f"{dtype}: embeddings {flash.shape}")
        check(np.abs(np.linalg.norm(flash, axis=1) - 1).max() <= 1e-3, f"{dtype}: norms")

        # the same model with the plain attention in every block's slot
        use(attention.reference_attention)
        peak_reset()
        plain = emb.embed_batch(crops)
        peak_plain = peak()
        check(attention.launch_count == launches, f"{dtype}: the plain attention launched the kernel")
        cos = np.sum(flash * plain, axis=1)
        check(cos.min() >= VIT_H14_COSINE_FLOOR,
              f"{dtype}: min cosine {cos.min()} to the plain attention under {VIT_H14_COSINE_FLOOR}")

        attn = {"kernel": emb.attn_fn, "plain": attention.reference_attention}
        ms: dict[str, list] = {"kernel": [], "plain": []}
        for turn in ("kernel", "plain", "plain", "kernel"):
            use(attn[turn])
            ms[turn].append(_device_ms(device, lambda: emb.embed_tensor(x), iters=VIT_H14_TIMED))
        use(emb.attn_fn)
        leg = {
            "launches": launches, "forwards": forwards, "min_cosine": float(cos.min()),
            "bucket_ms": ms,
            "images_per_s": {k: [BUCKET * 1e3 / t for t in v] for k, v in ms.items()},
            "peak_gib": {"kernel": peak_flash / 2**30, "plain": peak_plain / 2**30},
        }
        print(f"[{card}] vit_h14 {dtype}: {launches} flash launches for {forwards} bucket forwards; "
              f"min cosine to the plain attention {cos.min():.6f}; bucket ms in turns {ms}; "
              f"images/s kernel {leg['images_per_s']['kernel']}, plain {leg['images_per_s']['plain']}; "
              f"peak {leg['peak_gib']['kernel']:.2f} GiB (plain {leg['peak_gib']['plain']:.2f})")
        legs[dtype] = leg
        flash_embs[dtype] = flash
        del emb, model, flash, plain
        _release(device)
    cross = np.sum(flash_embs["bfloat16"] * flash_embs["float16"], axis=1)
    out = {"card": card, **legs, "bf16_vs_f16_min_cosine": float(cross.min()), "build_s": build_s}
    print(f"[{card}] vit_h14: bf16 vs f16 kernel embeddings, min cosine {cross.min():.6f}; both "
          f"embedders built at once in {build_s:.1f} s")
    print("vit_h14 " + json.dumps(out))
    del x
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
INDEX_IVF_ROWS = 100_000  # the build_index IVFFlat corpus (nlist 316), the smallest that build_index serves as IVFFlat
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
CELLPOSE_TIMED_STEPS = 10
CELLPOSE_INFER_REPEATS = 1  # timed requests after a warm-up call
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
TRANSFORMER_EPOCHS = 2  # each cpsam epoch saves a 1.2 GB snapshot


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
    check(status["current_epoch"] == cfg["epochs"], f"{label}: epochs {status}")
    want_steps = fields * (field // cfg["tile"]) ** 2 // cfg["batch_size"]
    check(status["steps_per_epoch"] == want_steps, f"{label}: steps per epoch {status['steps_per_epoch']}")
    check(len(losses) == cfg["epochs"] and np.isfinite(losses).all(), f"{label}: losses {losses}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    check(r["sessions"][0]["snapshots"] == cfg["epochs"], f"{label}: sessions {r['sessions']}")
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
    n_steps = cfg["epochs"] * r["status"]["steps_per_epoch"]
    print(f"[{card}] {label} training: data preparation (start_training, host) {r['t_prep']:.3f} s; "
          f"{n_steps} steps + {cfg['epochs']} snapshots {r['t_total'] - r['t_prep']:.3f} s host "
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
WORKER_ROUNDS = 2  # timed rounds over the queries (and the predicts), the paths interleaved call by call
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


def _repo_env(**extra) -> dict:
    """This process's environment with the checkout on ``PYTHONPATH``."""
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH", "")]), **extra}


def _log_tail(path: str) -> str:
    with open(path) as f:
        return f.read()[-3000:]


def start_worker_cli(device: str, ws: str, log_path: str, store_name: str) -> tuple:
    """``python -m bioengine_tpu_torch.worker`` as a subprocess on a free
    port, its RPC server's shared-memory segment ``store_name``; waits until
    ``/health/liveness`` answers. Returns the process, its port, the admin
    token it wrote and the seconds it took to answer."""
    import urllib.request

    port = _free_port()
    cmd = [sys.executable, "-m", "bioengine_tpu_torch.worker", "--mode", "single-machine", "--host",
           "127.0.0.1", "--port", str(port), "--workspace-dir", ws, "--log-file", "off"]
    if device != "cuda":
        cmd += ["--device", device]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, env=_repo_env(BIOENGINE_RPC_STORE_NAME=store_name), stdout=log,
                                stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                check(False, f"the worker CLI exited with {proc.returncode}: {_log_tail(log_path)}")
            check(time.perf_counter() - t0 < WORKER_CLI_START_S, "the worker CLI did not answer within 60 s")
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/health/liveness", timeout=2) as resp:
                    if resp.status == 200:
                        break
            except OSError:
                time.sleep(0.2)
        with open(os.path.join(ws, "admin_token")) as f:
            token = f.read().strip()
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    return proc, port, token, time.perf_counter() - t0


def worker_cli(card: str, device: str, root: str, store_name: str) -> dict:
    """``python -m bioengine_tpu_torch.worker`` as a subprocess: liveness,
    get_status through the bridge with the admin token it wrote, SIGTERM.
    Its RPC server's shared-memory segment is ``store_name``, unlinked
    after."""
    import urllib.request

    log_path = os.path.join(root, "cli.log")
    proc, port, token, live_s = start_worker_cli(device, os.path.join(root, "cli"), log_path, store_name)
    base = f"http://127.0.0.1:{port}"
    try:
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
            check(False, f"the worker CLI exited {rc} on SIGTERM: {_log_tail(log_path)}")
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


# ---- slice 10: every app bundle on the worker ----------------------------------


class LoopbackCollection:
    """A model collection on disk (``root/<model_id>/rdf.yaml`` and files)
    served over loopback HTTP in the layout of the bioimage.io endpoints
    that ``HttpCollectionSource`` reads: the artifact manager's ``list``
    and ``read`` under ``/public/services/artifact-manager/`` (every
    model's inference check ``passed``), a model's file list at
    ``/bioimage-io/artifacts/{id}/files/`` and its files below it; any
    other file under ``root`` at ``/{path}`` (an http(s) input).
    ``throttle`` maps a request path to the number of 429 answers it gets
    before it is served; ``hits`` counts the requests of each path."""

    ARTIFACTS = "/bioimage-io/artifacts/"
    MANAGER = "/public/services/artifact-manager/"

    def __init__(self, root: str, throttle: dict | None = None):
        self.root = os.path.abspath(root)
        self.throttle = dict(throttle or {})
        self.hits: dict[str, int] = {}
        self.url = None
        self._runner = None

    def _models(self) -> list[str]:
        return sorted(d for d in os.listdir(self.root) if os.path.isfile(os.path.join(self.root, d, "rdf.yaml")))

    def _file(self, base: str, rel: str):
        path = os.path.normpath(os.path.join(base, rel))
        if not path.startswith(base + os.sep) or not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    async def _handle(self, request):
        from aiohttp import web

        path = request.path
        self.hits[path] = self.hits.get(path, 0) + 1
        if self.throttle.get(path, 0) > 0:
            self.throttle[path] -= 1
            return web.Response(status=429)
        if path == self.MANAGER + "list":
            rows = []
            for m in self._models():
                with open(os.path.join(self.root, m, "rdf.yaml")) as f:
                    rdf = parse_rdf_text(f.read()) or {}
                rows.append({"alias": m, "manifest": {
                    k: rdf[k] for k in ("name", "description", "tags") if k in rdf}})
            return web.json_response(rows)
        if path == self.MANAGER + "read":
            return web.json_response({"manifest": {"bioengine_inference": {
                m: {"status": "passed"} for m in self._models()}}})
        if path.startswith(self.ARTIFACTS):
            model_id, sep, rel = path[len(self.ARTIFACTS):].partition("/files/")
            model_dir = os.path.join(self.root, model_id)
            if not sep or model_id not in self._models():
                return web.Response(status=404)
            if not rel:
                return web.json_response([
                    {"name": n, "size": os.path.getsize(os.path.join(model_dir, n)),
                     "type": "directory" if os.path.isdir(os.path.join(model_dir, n)) else "file"}
                    for n in sorted(os.listdir(model_dir))])
            body = self._file(model_dir, rel)
        else:
            body = self._file(self.root, path.lstrip("/"))
        return web.Response(status=404) if body is None else web.Response(body=body)

    async def start(self) -> str:
        from aiohttp import web

        app = web.Application()
        app.router.add_get("/{tail:.*}", self._handle)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, "127.0.0.1", 0)
        await site.start()
        self.url = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
        return self.url

    async def stop(self) -> None:
        await self._runner.cleanup()


APPS_UNARY_CALLS = 8  # unary generate calls a round, over the WebSocket and on the handle in turns
APPS_ROUNDS = 2
APPS_INFER_ROUNDS = 8  # cellpose infers over the wire and in process in turns (~0.4 s each on the card)
APPS_STREAMS = 8  # concurrent handle streams of APPS_STREAM_TOKENS tokens
APPS_STREAM_TOKENS = 64
APPS_INTER_TOKEN_MS = 250  # the generate bundle's slo: inter_token_ms
APPS_FLOW_TOL = 1e-5  # the network's raw output, wire request against in-process request
APPS_EM_SIZE = 2048  # fibsem's synthetic EM field: 25 tiles of 512 at overlap 64
APPS_EM_TILE, APPS_EM_OVERLAP, APPS_EM_BATCH = 512, 64, 8
APPS_EM_MITO = 120
APPS_EM_REPEATS = 2
APPS_MEMORY_SLACK = 64 << 20
APPS_TRAIN_TIMEOUT_S = 600


def synthetic_em_field(size: int, n_mito: int, seed: int) -> np.ndarray:
    """A (size, size) float32 EM-like field: bright ellipses of random
    orientation on a noisy background."""
    rng = np.random.default_rng(seed)
    img = rng.normal(60, 12, (size, size)).astype(np.float32)
    for _ in range(n_mito):
        cy, cx = rng.uniform(40, size - 40, 2)
        a, b = rng.uniform(12, 40), rng.uniform(8, 20)
        theta = rng.uniform(0, np.pi)
        r = int(np.ceil(max(a, b))) + 1
        ys = slice(max(int(cy) - r, 0), min(int(cy) + r + 1, size))
        xs = slice(max(int(cx) - r, 0), min(int(cx) + r + 1, size))
        dy, dx = np.meshgrid(np.arange(ys.start, ys.stop) - cy, np.arange(xs.start, xs.stop) - cx,
                             indexing="ij")
        u = dy * np.cos(theta) + dx * np.sin(theta)
        v = -dy * np.sin(theta) + dx * np.cos(theta)
        inside = (u / a) ** 2 + (v / b) ** 2 < 1
        img[ys, xs][inside] = rng.normal(170, 8, int(inside.sum()))
    return img


class _TimedRunner:
    """Forwards ``infer`` to a model-runner service and adds up the ms of
    each call (the fibsem app's app->app calls)."""

    def __init__(self, runner):
        self.runner, self.ms = runner, []

    async def infer(self, **kwargs):
        t0 = time.perf_counter()
        out = await self.runner.infer(**kwargs)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def _replica_of(worker, app_id: str, deployment: str):
    (replica,) = worker.controller.apps[app_id].replicas[deployment]
    return replica


def _gaps(stamps: list) -> list:
    return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]


async def _handle_stream(handle, options, **kwargs) -> dict:
    t0 = time.perf_counter()
    tokens, stamps = [], []
    async for item in handle.call_stream("generate_stream", options=options, **kwargs):
        stamps.append(time.perf_counter())
        tokens.append(item["token"])
    return {"tokens": tokens, "ttft_ms": (stamps[0] - t0) * 1e3, "gaps_ms": _gaps(stamps)}


async def drive_apps(card: str, device: str, root: str, fields, masks, em, collection: str,
                     probe: np.ndarray) -> dict:
    """Every app bundle on one worker over the wire, one after another on
    the one card (the model-runner and fibsem together). Returns the
    numbers; every check is made here."""
    worker = BioEngineWorker(mode="single-machine", device=device, port=0,
                             workspace_dir=os.path.join(root, "worker"), admin_users=["admin"],
                             log_file="off", monitoring_interval_seconds=60.0)
    await worker.start()
    server = worker.server
    conn = await connect_to_server({"server_url": server.url, "token": server.issue_token("admin")})
    user = server.issue_token("smoke-user")
    http = aiohttp.ClientSession()
    collection_server = LoopbackCollection(collection)
    r: dict = {"memory_after_undeploy": {}}
    state = worker.cluster.state
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    base, _ = _allocated(device)

    async def undeploy(*app_ids: str) -> None:
        for app_id in app_ids:
            await svc.stop_app(app_id=app_id)
        what = " and ".join(app_ids)
        check(state.free_chips() == state.topology.n_chips, f"undeploying {what} left a chip leased")
        held, released = _allocated(device)
        r["memory_after_undeploy"][what] = {"allocated": held, "cublas_released": released}
        check(held - base <= APPS_MEMORY_SLACK, f"after undeploying {what}: {held} B allocated against "
              f"{base} B before (slack {APPS_MEMORY_SLACK} B)")

    async def bridge(app_id: str, method: str, **kwargs):
        status_code, body = await _http_json(http, "POST", f"{server.http_url}/call/{app_id}/{method}", user,
                                             {"kwargs": kwargs})
        check(status_code == 200, f"bridge {app_id}.{method}: {status_code} {body}")
        return body["result"]

    try:
        svc = await conn.get_service("bioengine-worker")
        await collection_server.start()

        # gpu-test: the device probe over the wire
        await svc.deploy_app(local_path=os.path.join(WORKER_BUNDLES, "gpu-test"), app_id="gpu-test",
                             deployment_kwargs={"gpu_test_deployment": {"device": device}})
        probe_app = await conn.get_service("gpu-test")
        pong, info, memory = await probe_app.ping(), await probe_app.gpu_info(), await probe_app.memory_info()
        want = ("cuda", 1, kind, 16384.0, "") if device == "cuda" else ("cpu", 1, "cpu", 16384.0, "")
        got = (info["backend"], info["device_count"], info["devices"][0]["device_kind"], info["matmul_norm"],
               info["error"])
        check(pong["status"] == "ok" and got == want, f"gpu_info over the WebSocket {got}, expected {want}")
        check(len(memory["devices"]) == 1, f"memory_info {memory}")
        r["gpu_test"] = {"gpu_info": info, "memory_info": memory}
        print(f"[{card}] apps: gpu-test over the WebSocket: backend {info['backend']!r}, {info['device_count']} "
              f"device(s) {info['devices'][0]['device_kind']!r}, bf16 128x128 matmul norm {info['matmul_norm']}, "
              f"env {info['env']}; memory_info {json.dumps(memory['devices'])}")
        await undeploy("gpu-test")

        # generate at the app's own width, DecoderConfig()
        golden = np.load(DECODE_FIXTURE)["greedy_tokens"].tolist()
        n = len(golden)
        await svc.deploy_app(local_path=os.path.join(WORKER_BUNDLES, "generate"), app_id="generate",
                             deployment_kwargs={"generate_deployment": {"device": device}})
        gen = await conn.get_service("generate")
        handle = worker.controller.get_handle("generate")
        opts = RequestOptions(idempotent=True, deadline_s=120)
        unary = await gen.generate(prompt=DECODE_PROMPT, max_new_tokens=n)
        bridged = await bridge("generate", "generate", prompt=DECODE_PROMPT, max_new_tokens=n)
        status_code, mcp = await _http_json(
            http, "POST", f"{server.http_url}/mcp/generate", user,
            {"jsonrpc": "2.0", "id": 1, "method": "tools/call",
             "params": {"name": "generate", "arguments": {"prompt": DECODE_PROMPT, "max_new_tokens": n}}})
        check(status_code == 200 and not mcp["result"]["isError"], f"MCP tools/call: {status_code} {mcp}")
        mcp_tokens = json.loads(mcp["result"]["content"][0]["text"])["tokens"]
        check(unary["tokens"] == bridged["tokens"] == mcp_tokens == golden,
              "unary generate over the WebSocket, the bridge or MCP differs from the fixture")
        streamed = await _handle_stream(handle, opts, prompt=DECODE_PROMPT, max_new_tokens=n)
        resumed = [i async for i in handle.call_stream("generate_stream", prompt=DECODE_PROMPT, max_new_tokens=n,
                                                        resume_from=DECODE_RESUME, options=opts)]
        check(streamed["tokens"] == golden, f"the handle's stream {streamed['tokens']} != fixture {golden}")
        check([i["token"] for i in resumed] == golden[DECODE_RESUME:]
              and [i["index"] for i in resumed] == list(range(DECODE_RESUME, n)),
              f"resume_from={DECODE_RESUME} through the handle gave {resumed}")
        described = await gen.describe_engine()
        engine = described["engine"]
        want_dev = "cuda:0" if device == "cuda" else "cpu"
        check(engine["device"] == want_dev and engine["device_ids"] == [0], f"describe_engine {engine['device']}")
        paths = {"websocket": lambda p: gen.generate(prompt=p, max_new_tokens=n),
                 "in_process": lambda p: handle.call("generate", prompt=p, max_new_tokens=n)}
        timed = await _interleaved(paths, [DECODE_PROMPT] * APPS_UNARY_CALLS, APPS_ROUNDS,
                                   (server.stats, conn.codec.stats))
        check(all(o["tokens"] == golden for name in paths for o in timed[name]["outs"]),
              "an interleaved unary generate differs from the fixture")
        stream_rounds = {}
        for when in ("cold", "warm"):  # the cold round captures the batch buckets' graphs
            streams = await asyncio.gather(*(
                _handle_stream(handle, opts, prompt=DECODE_PROMPT, max_new_tokens=APPS_STREAM_TOKENS)
                for _ in range(APPS_STREAMS)))
            check(all(s["tokens"] == streams[0]["tokens"] and len(s["tokens"]) == APPS_STREAM_TOKENS
                      for s in streams), "the concurrent streams differ")
            check(streams[0]["tokens"][:n] == golden, "a concurrent stream's prefix differs from the fixture")
            gaps = [g for s in streams for g in s["gaps_ms"]]
            stream_rounds[when] = {
                "ttft_ms": _spread([s["ttft_ms"] for s in streams]),
                "inter_token_ms": {"p50": _quantile(gaps, 0.5), "p95": _quantile(gaps, 0.95),
                                   "p99": _quantile(gaps, 0.99), "max": max(gaps), "n": len(gaps)}}
        kv = (await gen.describe_engine())["engine"]["kv"]
        check(kv["sequences"] == 0, f"the KV cache holds {kv['sequences']} sequences after the streams")
        r["generate"] = {
            "unary_ms": {name: _spread(timed[name]["ms"]) for name in paths},
            "wire_ms": _paired(timed["websocket"]["ms"], timed["in_process"]["ms"]),
            "codec_ms": _spread(timed["codec_ms"]),
            "tokens_per_call": n, "streams": APPS_STREAMS, "stream_tokens": APPS_STREAM_TOKENS,
            **{f"streams_{when}": v for when, v in stream_rounds.items()},
            "slo_inter_token_ms": APPS_INTER_TOKEN_MS, "engine": {k: engine[k] for k in ("device", "programs")},
        }
        g = r["generate"]
        rounds_text = "; ".join(
            f"{when}: TTFT {_fmt(v['ttft_ms'])}, inter-token p50 {v['inter_token_ms']['p50']:.3f} ms, p95 "
            f"{v['inter_token_ms']['p95']:.3f}, p99 {v['inter_token_ms']['p99']:.3f}, max "
            f"{v['inter_token_ms']['max']:.3f} over {v['inter_token_ms']['n']} gaps"
            for when, v in stream_rounds.items())
        print(f"[{card}] apps: generate (DecoderConfig(), seed 0) from its bundle: unary over the WebSocket, the "
              f"bridge and MCP equal the fixture's {n} tokens; the handle's stream equals them and "
              f"resume_from={DECODE_RESUME} gives the suffix; describe_engine: {engine['device']} ({kind}); "
              f"{APPS_UNARY_CALLS} unary calls x {APPS_ROUNDS} rounds in turns, ms per call: WebSocket "
              f"{_fmt(g['unary_ms']['websocket'])}; handle in process {_fmt(g['unary_ms']['in_process'])}; "
              f"the wire's cost, call minus the handle's call beside it: {_fmt(g['wire_ms'])}, of which "
              f"RpcStats encode+decode {_fmt(g['codec_ms'])}; two rounds of {APPS_STREAMS} concurrent handle "
              f"streams of {APPS_STREAM_TOKENS} tokens, {rounds_text}; the bundle's slo: p95 <= "
              f"{APPS_INTER_TOKEN_MS} ms")
        del handle
        await undeploy("generate")

        # cellpose fine-tuning from its bundle, over the wire
        cfg = {"features": list(CELLPOSE_FEATURES), "seed": SEED, **CELLPOSE_CFG}
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(0)
        peak_before = torch.cuda.max_memory_allocated(0) if device == "cuda" else 0
        deployed = await svc.deploy_app(
            local_path=os.path.join(WORKER_BUNDLES, "cellpose-finetuning"), app_id="cellpose-finetuning",
            deployment_kwargs={"main": {"device": device, "sessions_root": os.path.join(root, "sessions")}})
        replica = _replica_of(worker, "cellpose-finetuning", "main")
        instance = replica.instance
        check(list(replica.device_ids) == [0] and str(instance.device) == want_dev,
              f"the fine-tuning replica leased {replica.device_ids}, computes on {instance.device}")
        cp = await conn.get_service("cellpose-finetuning")
        t0 = time.perf_counter()
        await cp.start_training(train_images=list(fields), train_labels=list(masks), config=cfg,
                                session_id="apps")
        t_start = time.perf_counter() - t0
        polls = 0
        while True:
            status = await cp.get_training_status(session_id="apps")
            polls += 1
            if status["status"] in ("completed", "failed", "stopped"):
                break
            check(time.perf_counter() - t0 < APPS_TRAIN_TIMEOUT_S, f"training stuck: {status}")
            await asyncio.sleep(0.1)
        t_train = time.perf_counter() - t0
        want_steps = CELLPOSE_FIELDS * (CELLPOSE_FIELD // CELLPOSE_CFG["tile"]) ** 2 // CELLPOSE_CFG["batch_size"]
        losses = status.get("losses", [])
        check(status["status"] == "completed" and status["current_epoch"] == CELLPOSE_CFG["epochs"]
              and status["steps_per_epoch"] == want_steps, f"training over the wire ended {status}")
        check(len(losses) == CELLPOSE_CFG["epochs"] and np.isfinite(losses).all() and losses[-1] < losses[0],
              f"losses {losses}")
        peak = torch.cuda.max_memory_allocated(0) if device == "cuda" else 0
        if device == "cuda":
            check(peak > peak_before, f"training left the leased card's peak at {peak} B ({peak_before} before)")
        # infer over the wire against the same call on the deployed instance;
        # the network's raw output of each request is recorded on the way
        raw = {"websocket": [], "in_process": []}
        predict_raw = instance._predict_raw
        where = {"path": None}

        def recording_predict_raw(session, x, state=None):
            out = predict_raw(session, x, state)
            raw[where["path"]].append(out)
            return out

        instance._predict_raw = recording_predict_raw
        images = [fields[0], fields[1]]

        def infer_path(name, call):
            async def run(x):
                where["path"] = name
                return await call(x)
            return run

        infer_paths = {"websocket": infer_path("websocket", lambda x: cp.infer(session_id="apps", images=x)),
                       "in_process": infer_path("in_process", lambda x: instance.infer(session_id="apps", images=x))}
        for call in infer_paths.values():  # one untimed call per path
            await call(images)
        timed = await _interleaved(infer_paths, [images], APPS_INFER_ROUNDS, (server.stats, conn.codec.stats))
        instance._predict_raw = predict_raw
        for a, b in zip(timed["websocket"]["outs"], timed["in_process"]["outs"]):
            check(all(np.array_equal(x, y) for x, y in zip(a["masks"], b["masks"]))
                  and a["n_cells"] == b["n_cells"], "infer over the WebSocket differs from the in-process infer")
        flow_err = max(float(np.abs(a - b).max()) for a, b in zip(raw["websocket"], raw["in_process"]))
        check(flow_err <= APPS_FLOW_TOL, f"the network's output over the wire vs in process: max abs {flow_err}")
        exported = await cp.export_model(session_id="apps")
        rdf = load_model_rdf(os.path.join(exported["model_path"], "rdf.yaml"))
        check(rdf.weights["jax_params"]["architecture"]["name"] == "cellpose", f"exported rdf {rdf.weights}")
        async with http.get(f"{server.http_url}/apps/cellpose-finetuning/") as resp:
            page = await resp.text()
        check(resp.status == 200 and "Cellpose Fine-Tuning" in page and deployed["frontend_url"] ==
              "/apps/cellpose-finetuning/", f"frontend {resp.status}")
        await cp.delete_session(session_id="apps")
        r["cellpose"] = {
            "start_training_s": t_start, "train_s": t_train, "polls": polls, "losses": losses,
            "steps": CELLPOSE_CFG["epochs"] * want_steps, "peak_gib": peak / 2**30,
            "infer_ms": {name: _spread(timed[name]["ms"]) for name in infer_paths},
            "wire_ms": _paired(timed["websocket"]["ms"], timed["in_process"]["ms"]),
            "n_cells": timed["websocket"]["outs"][0]["n_cells"], "flow_max_abs": flow_err,
        }
        c = r["cellpose"]
        print(f"[{card}] apps: cellpose-finetuning from its bundle (CellposeNet {CELLPOSE_FEATURES}, {cfg}): "
              f"start_training over the WebSocket answered in {t_start:.3f} s ({CELLPOSE_FIELDS} {CELLPOSE_FIELD}^2 "
              f"fields), {c['steps']} steps done at {t_train:.3f} s after {polls} polls; losses {losses}; peak "
              f"{c['peak_gib']:.2f} GiB on the leased {instance.device}; infer 2 x {CELLPOSE_FIELD}^2 over the "
              f"WebSocket equals the in-process infer (masks bit for bit, n_cells {c['n_cells']}; the network's "
              f"output max abs {flow_err:.3g}, tolerance {APPS_FLOW_TOL}); ms per infer: WebSocket "
              f"{_fmt(c['infer_ms']['websocket'])}; in process {_fmt(c['infer_ms']['in_process'])}; the wire's "
              f"cost {_fmt(c['wire_ms'])}; export_model's rdf.yaml read by runtime/rdf.py; the frontend answers")
        del replica, instance, predict_raw, recording_predict_raw, infer_paths
        await undeploy("cellpose-finetuning")

        # the model-runner from the loopback collection, with fibsem beside it
        local_root = os.environ.pop("BIOENGINE_LOCAL_MODEL_PATH", None)
        try:
            mr = await svc.deploy_app(
                local_path=os.path.join(WORKER_BUNDLES, SERVE_APP), app_id=SERVE_APP,
                deployment_kwargs={"runtime_deployment": {"device": device},
                                   "entry_deployment": {"device": device, "collection_url": collection_server.url,
                                                        "cache_dir": os.path.join(root, "mr-cache")}})
        finally:
            if local_root is not None:
                os.environ["BIOENGINE_LOCAL_MODEL_PATH"] = local_root
        entry_instance = _replica_of(worker, SERVE_APP, "entry_deployment").instance
        check(isinstance(entry_instance.model_cache.source, HttpCollectionSource),
              f"the entry reads {type(entry_instance.model_cache.source).__name__}")
        del entry_instance
        fib = await svc.deploy_app(
            local_path=os.path.join(WORKER_BUNDLES, "fibsem-mito-analysis"), app_id="fibsem-mito-analysis",
            deployment_kwargs={"analysis_deployment": {
                "model_runner_service": mr["service_id"], "model_id": "unet2d", "server_url": server.url,
                "batch_size": APPS_EM_BATCH, "input_layout": "NHWC"}},
            env_vars={"BIOENGINE_TOKEN": server.issue_token("fibsem-app")})
        fib_replica = _replica_of(worker, "fibsem-mito-analysis", "analysis_deployment")
        check(list(fib_replica.device_ids) == [] and state.free_chips() == state.topology.n_chips - 1,
              f"fibsem leased {fib_replica.device_ids}; free chips {state.free_chips()}")
        fibsem = await conn.get_service("fibsem-mito-analysis")
        timer = _TimedRunner(fib_replica.instance._model_runner)
        fib_replica.instance._model_runner = timer
        analyses, analyze_ms, runner_ms = [], [], []
        for _ in range(APPS_EM_REPEATS):
            timer.ms.clear()
            t0 = time.perf_counter()
            analyses.append(await fibsem.analyze(image=em, tile_size=APPS_EM_TILE, overlap=APPS_EM_OVERLAP))
            analyze_ms.append((time.perf_counter() - t0) * 1e3)
            runner_ms.append(sum(timer.ms))
        n_calls = len(timer.ms)
        fib_replica.instance._model_runner = timer.runner
        del fib_replica, timer
        # the same analysis here, from the entry handle's predictions in process
        bundle = runpy.run_path(os.path.join(WORKER_BUNDLES, "fibsem-mito-analysis", "analysis_deployment.py"))
        ref = bundle["MitoAnalysis"](model_id="unet2d", batch_size=APPS_EM_BATCH, input_layout="NHWC")
        ref._model_runner = worker.controller.get_handle(SERVE_APP, "entry_deployment")
        want = await ref.analyze(image=em, tile_size=APPS_EM_TILE, overlap=APPS_EM_OVERLAP)
        for got in analyses:
            check(np.array_equal(np.asarray(got["labels"]), want["labels"])
                  and got["n_mitochondria"] == want["n_mitochondria"] and got["properties"] == want["properties"],
                  "fibsem's analysis over the wire differs from the one made here from the entry's predictions")
        check(want["n_mitochondria"] > 0, "the analysis found no instance")
        del ref
        # an http input against the same array inline
        runner = await conn.get_service(SERVE_APP)
        inline = await runner.infer(model_id="unet2d", inputs={"raw": probe})
        fetched = await runner.infer(model_id="unet2d", inputs={"raw": f"{collection_server.url}/probe.npy"})
        check(np.array_equal(inline["mask"], fetched["mask"]), "an http input's result differs from the inline one")
        check(collection_server.hits.get("/probe.npy") == 1 and collection_server.hits.get(
            LoopbackCollection.ARTIFACTS + "unet2d/files/weights.npz") == 1,
            f"the loopback collection served {collection_server.hits}")
        tiles = len(range(0, APPS_EM_SIZE, APPS_EM_TILE - APPS_EM_OVERLAP)) ** 2
        r["fibsem"] = {
            "image": APPS_EM_SIZE, "tiles": tiles, "batch_size": APPS_EM_BATCH, "runner_calls": n_calls,
            "analyze_ms": analyze_ms, "model_runner_ms": runner_ms,
            "host_ms": [a - b for a, b in zip(analyze_ms, runner_ms)],
            "n_mitochondria": want["n_mitochondria"], "collection_hits": collection_server.hits,
        }
        f = r["fibsem"]
        print(f"[{card}] apps: model-runner (UNet2D {UNET2D_FEATURES}, bf16) fetched from the loopback "
              f"collection through HttpCollectionSource, fibsem-mito-analysis (chips 0) beside it calling it over "
              f"the wire with a worker-issued token: analyze of a {APPS_EM_SIZE}^2 field ({tiles} tiles of "
              f"{APPS_EM_TILE}, overlap {APPS_EM_OVERLAP}, {n_calls} model-runner calls of up to {APPS_EM_BATCH}) "
              f"found {f['n_mitochondria']} instances, labels equal bit for bit to the analysis made here from the "
              f"entry handle's predictions; ms per analyze {[round(x, 3) for x in analyze_ms]}, of which the "
              f"model-runner calls {[round(x, 3) for x in runner_ms]} and the host's tiling, stitch and "
              f"post-processing {[round(x, 3) for x in f['host_ms']]}; an http input equals the inline array")
        await undeploy("fibsem-mito-analysis", SERVE_APP)

        # composition-demo
        await svc.deploy_app(local_path=os.path.join(WORKER_BUNDLES, "composition-demo"), app_id="composition-demo")
        fanned = await (await conn.get_service("composition-demo")).fan_out(value=7)
        check(fanned == {"a": 14, "b": 107, "sum": 121}, f"fan_out(7) {fanned}")
        r["composition"] = fanned
        print(f"[{card}] apps: composition-demo fan_out(7) over the WebSocket {fanned}")
        await undeploy("composition-demo")
    finally:
        await http.close()
        await collection_server.stop()
        await conn.disconnect()
        await worker.stop()
    r["memory_before"] = base
    return r


def phase_apps(card: str, device: str = "cuda") -> dict:
    """Slice 10: every app bundle on the worker, on the card, over the wire:
    gpu-test, generate, cellpose-finetuning, the model-runner from a
    loopback collection with fibsem-mito-analysis beside it, and
    composition-demo, one after another. One ``apps`` JSON line."""
    os.environ["BIOENGINE_DISABLE_GEOLOCATION"] = "1"  # no egress
    t_phase = time.perf_counter()
    fields, masks = synthetic_cell_fields(CELLPOSE_FIELDS, CELLPOSE_FIELD, CELLPOSE_CELLS, SEED)
    em = synthetic_em_field(APPS_EM_SIZE, APPS_EM_MITO, SEED + 10)
    unet2d = UNet2D(features=UNET2D_FEATURES)
    unet2d.reset_parameters(SEED)
    probe = np.random.default_rng(SEED + 10).standard_normal((1, SERVE_IMAGE, SERVE_IMAGE, 1), np.float32)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_apps_") as root:
        collection = os.path.join(root, "collection")
        os.makedirs(collection)
        write_unet_package(collection, "unet2d", unet2d, "unet2d", {"features": list(UNET2D_FEATURES)}, "byxc")
        del unet2d
        np.save(os.path.join(collection, "probe.npy"), probe)
        store_name = f"bioengine-rpc-smoke-apps-{os.getpid()}"
        os.environ["BIOENGINE_RPC_STORE_NAME"] = store_name
        attention.launch_count = 0
        try:
            r = asyncio.run(drive_apps(card, device, root, fields, masks, em, collection, probe))
        finally:
            del os.environ["BIOENGINE_RPC_STORE_NAME"]
            _unlink_shm(store_name)
        launches = attention.launch_count
    check(launches == 0, f"the apps phase launched flash_attn_fwd {launches} times")
    r["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] apps: device memory allocated {r['memory_before']} B before the worker, after each undeploy "
          f"{json.dumps(r['memory_after_undeploy'])} (limit +{APPS_MEMORY_SLACK} B); flash_attn_fwd launches "
          f"{launches} (none of these apps has an attention kernel slot)")
    out = {"card": card, **r, "flash_attn_fwd_launches": launches}
    print(f"[{card}] apps phase: {r['phase_s']:.3f} s")
    print("apps " + json.dumps(out, default=str))
    return out


# ---- slice 11: worker hosts and the CLI -----------------------------------------


HOSTS_FIELDS = 8  # synthetic 896^2 fields in a local directory both hosts read
HOSTS_CROPS_PER_FIELD = 50
HOSTS_VIT = {"depth": VIT_DEPTH}  # ViT-B/14 at full width
HOSTS_SEARCHES = 16
HOSTS_ROUNDS = 1  # rounds over the queries, through the host and in process in turns
HOSTS_PROFILED_SEARCHES = 2
HOSTS_JOIN_S = 120
HOSTS_HEALTHY_S = 300
HOSTS_STOP_S = 30
HOSTS_MEMORY_SLACK = 64 << 20
HOSTS_CLI_S = 120  # one CLI command, models convert at full width included
HOSTS_CONVERT_DEPTH = 12  # the seeded DINOv2 ViT-B/14 checkpoint converted by the CLI
HOSTS_TIER_PUBLISH_S = "1"  # h1's BIOENGINE_COMPILE_TIER_PUBLISH_S: its publish loop's period


def _host_cmd(server_url: str, token: str, host_id: str, ws: str, device: str) -> list:
    cmd = [sys.executable, "-m", "bioengine_tpu_torch.worker_host", "--server-url", server_url,
           f"--token={token}", "--host-id", host_id, "--workspace-dir", ws]
    return cmd + (["--device", device] if device != "cuda" else [])  # no flag: the card


class _Hosts:
    """Worker-host subprocesses, each logging to ``<root>/<id>.log``."""

    def __init__(self, root: str):
        self.root, self.procs = root, {}

    def spawn(self, host_id: str, cmd: list, **env) -> subprocess.Popen:
        with open(os.path.join(self.root, f"{host_id}.log"), "w") as log:
            self.procs[host_id] = subprocess.Popen(cmd, env=_repo_env(**env), stdout=log, stderr=subprocess.STDOUT)
        return self.procs[host_id]

    def log(self, host_id: str) -> str:
        return _log_tail(os.path.join(self.root, f"{host_id}.log"))

    def stop(self, host_id: str) -> int:
        """SIGTERM, and the exit code within HOSTS_STOP_S (None past it)."""
        proc = self.procs[host_id]
        proc.send_signal(signal.SIGTERM)
        try:
            return proc.wait(timeout=HOSTS_STOP_S)
        except subprocess.TimeoutExpired:
            return None

    def kill_all(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


async def _wait_join(hosts: _Hosts, host_id: str, joined) -> float:
    """Poll ``joined()`` until it is true; ms from now."""
    t0 = time.perf_counter()
    while not joined():
        proc = hosts.procs[host_id]
        check(proc.poll() is None, f"host {host_id} exited with {proc.returncode}: {hosts.log(host_id)}")
        check(time.perf_counter() - t0 < HOSTS_JOIN_S, f"host {host_id} did not join: {hosts.log(host_id)}")
        await asyncio.sleep(0.05)
    return (time.perf_counter() - t0) * 1e3


def _flash_events(trace_dir: str, within: str = None) -> int:
    """The trace's ``flash_attn`` kernel events; with ``within``, those that
    start inside the range annotated with that name."""
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f).get("traceEvents", [])
    lo, hi = -float("inf"), float("inf")
    if within is not None:
        (span,) = [e for e in events if e.get("name") == within and e.get("cat") == "user_annotation"]
        lo, hi = span["ts"], span["ts"] + span["dur"]
    return sum(1 for e in events if e.get("cat") == "kernel" and "flash_attn" in e.get("name", "")
               and lo <= e.get("ts", 0) <= hi)


def _flash_event_census(trace_dir: str) -> dict:
    """The trace's events whose name holds ``flash_attn``, counted by
    category, with the first and last one's start (us)."""
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if "flash_attn" in str(e.get("name", ""))]
    census: dict = {}
    for e in events:
        census[e.get("cat")] = census.get(e.get("cat"), 0) + 1
    starts = sorted(e.get("ts", 0) for e in events if e.get("cat") == "kernel")
    return {"by_category": census, "first_last_ts": starts[:1] + starts[-1:]}


def _no_nvcc_env(root: str) -> dict:
    """A PATH without any directory that holds nvcc and CUDA_HOME at an
    empty directory: ``_build._nvcc()`` raises in a process started with
    these, so a kernel library it loads cannot have been built there."""
    empty = os.path.join(root, "no-cuda")
    os.makedirs(empty, exist_ok=True)
    path = os.pathsep.join(d for d in os.environ.get("PATH", "").split(os.pathsep)
                           if d and not os.path.isfile(os.path.join(d, "nvcc")))
    return {"PATH": path, "CUDA_HOME": empty}


def _embedder_builds(record: dict) -> list:
    """The ``cache_hit`` tags of the embedder's builds in a host's flight
    record (``program.compile`` events of the ``vit-embedder`` program)."""
    return [e["attrs"]["cache_hit"] for e in record["events"]
            if e["type"] == "program.compile" and "vit-embedder" in e["attrs"]["key"]]


async def _timed_tier_fetch(server_url: str, token: str, name: str, directory: str) -> tuple[float, bytes]:
    """What a joining host's ``_sync_compile_cache`` does for one entry,
    timed here by a client of the same controller: list the tier, fetch
    the entry, install it with ``write_entry``. (seconds, the bytes)."""
    conn = await connect_to_server({"server_url": server_url, "token": token})
    try:
        t0 = time.perf_counter()
        listing = await conn.call("serve-router", "compile_cache_list")
        blob = bytes(await conn.call("serve-router", "compile_cache_fetch", name))
        check(name in listing and compile_cache.write_entry(name, blob, directory),
              f"the timed fetch of {name} from the tier failed")
        return time.perf_counter() - t0, blob
    finally:
        await conn.disconnect()


HOSTS_WARM_THREADS = 4


def _warm_reference(device: str, query) -> None:
    """This process computes the reference: ViT-B/14 bucket forwards and
    FlatIP top-k on the event loop's worker threads. Run the same work once,
    on as many threads at a time, before the reading the phase is held to:
    CUDA loads modules on a kernel's first launch, and each thread that
    runs a GEMM or a convolution takes cuBLAS and cuDNN handles from
    PyTorch's pools (kept by the pool when the thread ends), so these count
    in that reading and the check measures what the hosts leave."""
    import concurrent.futures

    warm = ViTEmbedder(device=device, seed=SEED, batch_bucket=BUCKET, model_overrides=HOSTS_VIT)
    warm.load()
    dim = HOSTS_VIT.get("dim", 768)  # ViT-B/14
    corpus = FlatIPIndex(np.random.default_rng(SEED).standard_normal((256, dim), np.float32), device=device)

    def work(_):
        vec = warm.embed_batch([query])
        corpus.search(vec[0], TOP_K)

    with concurrent.futures.ThreadPoolExecutor(HOSTS_WARM_THREADS) as pool:
        list(pool.map(work, range(HOSTS_WARM_THREADS)))


def _used_bytes(device: str) -> int:
    """The card's used memory (total - free) after this process has
    released what it caches; 0 on the CPU."""
    gc.collect()
    if device != "cuda":
        return 0
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return total - free


async def drive_hosts(card: str, device: str, root: str, fields_dir: str, queries, hosts: _Hosts) -> dict:
    """A controller with no chips of its own in process; worker hosts as
    subprocesses serve cell-image-search from the card."""
    r: dict = {}
    server = RpcServer(host="127.0.0.1", admin_users=["admin"])
    await server.start()
    token = server.issue_token("admin", is_admin=True)
    controller = ServeController(ClusterState(TpuTopology(chips=(), n_hosts=1, platform="gpu")),
                                 health_check_period=3600)
    controller.compile_tier = CompileCacheTier(os.path.join(root, "tier"))
    controller.attach_rpc(server, admin_users=["admin"])
    await controller.start()
    state = controller.cluster_state
    shared = os.path.join(root, "cis")  # the index path both hosts' replicas get
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    # each host's kernel-library cache starts empty: h1 builds the flash
    # kernel with nvcc and publishes it; h2, with no nvcc, fetches it
    kernels = {h: os.path.join(root, f"kernels-{h}") for h in ("h1", "h2")}
    entry = _build.entry_name(attention.KERNEL_NAME)
    try:
        def alive(host_id):
            return lambda: host_id in state.hosts and state.hosts[host_id].alive

        hosts.spawn("h1", _host_cmd(server.url, token, "h1", os.path.join(root, "ws-h1"), device),
                    BIOENGINE_COMPILE_CACHE=kernels["h1"], BIOENGINE_COMPILE_TIER_PUBLISH_S=HOSTS_TIER_PUBLISH_S)
        r["join_ms"] = await _wait_join(hosts, "h1", alive("h1"))
        h1 = state.hosts["h1"]
        chips = h1.topology["chips"]
        check(h1.n_chips == 1 and chips[0]["kind"] == kind and not state.topology.n_chips,
              f"h1 joined with {h1.n_chips} chip(s) {[c['kind'] for c in chips]}, expected 1 {kind!r}")
        print(f"[{card}] hosts: `python -m bioengine_tpu_torch.worker_host` with no device flag joined the "
              f"controller (no chips of its own) in {r['join_ms']:.3f} ms from spawn with 1 chip, {chips[0]['kind']!r}")

        built = AppBuilder(workdir_root=os.path.join(root, "apps")).build(
            app_id=WORKER_CIS, local_path=os.path.join(WORKER_BUNDLES, WORKER_CIS),
            deployment_kwargs={"main": {"workspace_dir": shared, "device": device, "seed": SEED,
                                        "batch_bucket": BUCKET, "n_crops_per_image": HOSTS_CROPS_PER_FIELD,
                                        "model_overrides": HOSTS_VIT}})
        t0 = time.perf_counter()
        await controller.deploy(WORKER_CIS, built.specs)
        r["deploy_ms"] = (time.perf_counter() - t0) * 1e3
        (replica,) = controller.apps[WORKER_CIS].replicas["main"]
        check(isinstance(replica, RemoteReplica) and replica.host_id == "h1" and list(replica.device_ids) == [0]
              and h1.chips_in_use == {0: replica.replica_id},
              f"the replica is a {type(replica).__name__} on {getattr(replica, 'host_id', None)} with chips "
              f"{replica.device_ids}; h1 leases {h1.chips_in_use}")
        handle = controller.get_handle(WORKER_CIS, "main")
        await handle.call("add_dataset", name="cells", source="local", path=fields_dir)
        t0 = time.perf_counter()
        await handle.call("start_ingestion", dataset_name="cells", session_id="hosts")
        while True:
            st = await handle.call("get_ingestion_status", session_id="hosts")
            if st["status"] in ("completed", "failed", "stopped"):
                break
            check(time.perf_counter() - t0 < WORKER_INGEST_TIMEOUT_S, f"ingestion stuck: {st}")
            await asyncio.sleep(0.05)
        r["ingest_ms"] = (time.perf_counter() - t0) * 1e3
        check(st["status"] == "completed" and st["n_embedded"] > 0, f"ingestion {st}")
        stats = await handle.call("get_index_stats")
        check(stats["loaded"] and stats["n_cells"] == st["n_embedded"], f"index stats {stats}")
        r["n_cells"] = stats["n_cells"]
        print(f"[{card}] hosts: {WORKER_CIS} (ViT-B/14, bucket {BUCKET}) placed on h1 as a RemoteReplica "
              f"leasing its chip {replica.device_ids} (deploy {r['deploy_ms']:.3f} ms); h1 ingested "
              f"{HOSTS_FIELDS} {WORKER_FIELD_SIZE}^2 fields from a local directory into {r['n_cells']} cells "
              f"({stats['index_type']}) in {r['ingest_ms']:.3f} ms")

        # the same searches in this process, on the same seed over the index h1 wrote
        ref = CellImageSearch(workspace_dir=shared, device=device, seed=SEED, batch_bucket=BUCKET,
                              model_overrides=HOSTS_VIT)
        await ref.async_init()
        paths = {"host": lambda q: handle.call("search", image=q, top_k=TOP_K),
                 "in_process": lambda q: ref.search(image=q, top_k=TOP_K)}
        for call in paths.values():  # one untimed call per path
            await call(queries[0])
        timed = await _interleaved(paths, queries, HOSTS_ROUNDS, ())
        for i, (a, b) in enumerate(zip(timed["host"]["outs"], timed["in_process"]["outs"])):
            check(_results(a) == _results(b) and len(a["results"]) == TOP_K,
                  f"search {i % len(queries)} through h1 differs from CellImageSearch(device={device!r}) here")
        mine = timed["in_process"]["outs"][:len(queries)]
        r["search_ms"] = {n: _spread(timed[n]["ms"]) for n in paths}
        r["hop_ms"] = _paired(timed["host"]["ms"], timed["in_process"]["ms"])
        print(f"[{card}] hosts: {len(queries)} searches x {HOSTS_ROUNDS} rounds through the controller's "
              f"handle to h1 and on CellImageSearch(device={device!r}) here, in turns, equal in ids and scores "
              f"bit for bit; ms per search: through h1 {_fmt(r['search_ms']['host'])}; in process "
              f"{_fmt(r['search_ms']['in_process'])}; the hop, call minus the in-process call beside it: "
              f"{_fmt(r['hop_ms'])}")

        # the kernel in h1's process, read from its own trace
        trace_dir = os.path.join(root, "h1-trace")
        forwards0 = ref.embedder.forward_count
        for q in queries[:HOSTS_PROFILED_SEARCHES]:
            await ref.search(image=q, top_k=TOP_K)
        forwards = ref.embedder.forward_count - forwards0  # bucket forwards of these searches
        started = await controller._call_host(h1.service_id, "start_profiling", trace_dir=trace_dir)
        for q in queries[:HOSTS_PROFILED_SEARCHES]:
            await handle.call("search", image=q, top_k=TOP_K)
        stopped = await controller._call_host(h1.service_id, "stop_profiling")
        check(started["profiling"] and not stopped["profiling"] and stopped["trace_dir"] == trace_dir,
              f"h1's profiling verbs {started} {stopped}")
        r["flash_launches"] = _flash_events(trace_dir)
        depth = HOSTS_VIT.get("depth", VIT_DEPTH)
        want = depth * forwards if device == "cuda" else 0
        check(r["flash_launches"] == want and forwards > 0,
              f"h1's trace holds {r['flash_launches']} flash_attn kernel events, expected {depth} x {forwards}")
        mem = await controller._call_host(h1.service_id, "memory_profile")
        if device == "cuda":
            (dev,) = mem["devices"]
            r["h1_allocated"] = dev["memory_stats"]["allocated_bytes.all.current"]
            check(dev["kind"] == kind and r["h1_allocated"] > 0, f"h1's memory_profile: {dev['kind']}")
        print(f"[{card}] hosts: h1's torch.profiler trace around {HOSTS_PROFILED_SEARCHES} searches holds "
              f"{r['flash_launches']} flash_attn kernel events = {depth} x {forwards} bucket forwards; h1's "
              f"memory_profile: {r.get('h1_allocated', 'no CUDA device')} B allocated on {kind!r}")
        if device == "cuda":
            r["tier"] = await hosts_tier_publish(card, controller, h1, kernels["h1"], entry, server.url, token, root)

        # failover: h2 on the same card, h1 killed; h2 has no nvcc and an
        # empty kernel cache, so the library it serves with is the tier's
        h2_env = {"BIOENGINE_COMPILE_CACHE": kernels["h2"], **_no_nvcc_env(root)}
        if device == "cuda":
            probe = subprocess.run([sys.executable, "-c", "from bioengine_tpu_torch.ops import _build; _build._nvcc()"],
                                   env=_repo_env(**h2_env), capture_output=True, text=True, timeout=120)
            check(probe.returncode != 0 and "nvcc not found" in probe.stderr,
                  f"nvcc is reachable in h2's environment: rc {probe.returncode} {probe.stderr[-500:]}")
        hosts.spawn("h2", _host_cmd(server.url, token, "h2", os.path.join(root, "ws-h2"), device), **h2_env)
        r["join_ms_h2"] = await _wait_join(hosts, "h2", alive("h2"))
        hosts.procs["h1"].send_signal(signal.SIGKILL)
        await asyncio.to_thread(hosts.procs["h1"].wait, 30)
        t0 = time.perf_counter()
        while True:
            await controller.health_tick()
            reps = controller.apps[WORKER_CIS].replicas["main"]
            healthy = [x for x in reps if x.state in (ReplicaState.HEALTHY, ReplicaState.TESTING)]
            if healthy and getattr(healthy[0], "host_id", None) == "h2":
                break
            check(time.perf_counter() - t0 < HOSTS_HEALTHY_S, f"no healthy replica on h2: {hosts.log('h2')}")
            await asyncio.sleep(0.1)
        r["failover_ms"] = (time.perf_counter() - t0) * 1e3
        check(not state.hosts["h1"].alive and state.hosts["h2"].chips_in_use == {0: healthy[0].replica_id},
              f"after the failover h1 alive {state.hosts['h1'].alive}, h2 leases {state.hosts['h2'].chips_in_use}")
        again = [await handle.call("search", image=queries[0], top_k=TOP_K)]  # builds h2's ViT
        r["first_search_ms"] = (time.perf_counter() - t0) * 1e3
        again += [await handle.call("search", image=q, top_k=TOP_K) for q in queries[1:]]
        for i, (a, b) in enumerate(zip(again, mine)):
            check(_results(a) == _results(b), f"search {i} through h2 differs from the in-process app")
        print(f"[{card}] hosts: h2 joined in {r['join_ms_h2']:.3f} ms; h1 SIGKILLed; health_tick re-placed the "
              f"replica on h2 (same card, same index path) and it was healthy {r['failover_ms']:.3f} ms after the "
              f"kill; its first search (which builds the ViT there) answered {r['first_search_ms']:.3f} ms after the "
              f"kill; the {len(queries)} searches through h2 equal the in-process app bit for bit")
        if device == "cuda":
            h2 = state.hosts["h2"]
            r["tier"].update(await hosts_tier_fetched(card, controller, h2, kernels, entry, handle, queries,
                                                      forwards, root))
        await controller.undeploy(WORKER_CIS)
        check(state.hosts["h2"].chips_in_use == {}, f"h2 still leases {state.hosts['h2'].chips_in_use}")
        rc = await asyncio.to_thread(hosts.stop, "h2")  # the loop answers its deregister_host
        check(rc == 0, f"h2 exited {rc} on SIGTERM: {hosts.log('h2')}")
        deadline = time.perf_counter() + HOSTS_STOP_S
        while "h2" in state.hosts and state.hosts["h2"].alive:
            check(time.perf_counter() < deadline, "h2 is still registered after its exit")
            await asyncio.sleep(0.05)
        r["h2_exit"] = rc
    finally:
        hosts.kill_all()
        await controller.stop()
        await server.stop()
    return r


async def hosts_tier_publish(card: str, controller, h1, kernels_h1: str, entry: str, server_url: str,
                             token: str, root: str) -> dict:
    """h1 built the flash kernel's library with nvcc into its empty cache
    and its publish loop put the entry on the controller's tier."""
    r: dict = {"entry": entry}
    lib = os.path.join(kernels_h1, entry)
    log = _build.build_log(attention.KERNEL_NAME, kernels_h1)
    r["nvcc_s_h1"] = _build.build_seconds(log)
    check(os.path.isfile(lib) and r["nvcc_s_h1"] is not None,
          f"h1 left no library {entry} or no nvcc log in its cache {sorted(os.listdir(kernels_h1))}")
    builds = _embedder_builds(await controller._call_host(h1.service_id, "get_flight_record", limit=None))
    check(builds[:1] == [False], f"h1's first embedder build is tagged {builds}, expected a real build (False)")
    t0 = time.perf_counter()
    while entry not in controller.compile_tier.list():
        check(time.perf_counter() - t0 < HOSTS_JOIN_S, f"h1 never published {entry}: {controller.compile_tier.list()}")
        await asyncio.sleep(0.1)
    r["publish_wait_s"] = time.perf_counter() - t0
    with open(lib, "rb") as f:
        r["bytes"] = len(f.read())
    desc = await controller._call_host(h1.service_id, "describe")
    check(desc["compile_tier"]["cache_dir"] == kernels_h1 and desc["compile_tier"]["published"] >= 1,
          f"h1's compile_tier {desc['compile_tier']}")
    probe = os.path.join(root, "kernels-probe")
    r["fetch_s"], blob = await _timed_tier_fetch(server_url, token, entry, probe)
    check(blob == open(lib, "rb").read(), "the tier's bytes differ from h1's library")
    print(f"[{card}] hosts: h1 built {entry} with nvcc in {r['nvcc_s_h1']} s into its empty cache (its embedder "
          f"build tagged a real build); its publish loop put the entry on the controller's tier "
          f"({r['bytes']} B, seen {r['publish_wait_s']:.3f} s after the check began); listing and fetching it over "
          f"the tier's RPC and installing it, as a joining host does, took {r['fetch_s']:.6f} s here")
    return r


async def hosts_tier_fetched(card: str, controller, h2, kernels: dict, entry: str, handle, queries, forwards: int,
                             root: str) -> dict:
    """h2, without nvcc, fetched the library from the tier, loaded it and
    serves the searches with the kernel in its own process."""
    r: dict = {}
    desc = await controller._call_host(h2.service_id, "describe")
    tier = desc["compile_tier"]
    check(tier["cache_dir"] == kernels["h2"] and tier["fetched"] >= 1, f"h2's compile_tier {tier}")
    r["fetched_h2"] = tier["fetched"]
    got = os.path.join(kernels["h2"], entry)
    check(os.path.isfile(got) and open(got, "rb").read() == open(os.path.join(kernels["h1"], entry), "rb").read(),
          f"h2's cache {sorted(os.listdir(kernels['h2']))} lacks h1's {entry} or holds other bytes")
    check(not _build.build_log(attention.KERNEL_NAME, kernels["h2"]), "nvcc wrote a log in h2's cache")
    record = await controller._call_host(h2.service_id, "get_flight_record", limit=None)
    fetches = [e for e in record["events"] if e["type"] == "program.cache_fetch" and e["attrs"]["entry"] == entry]
    builds = _embedder_builds(record)
    check(len(fetches) == 1 and builds and all(builds),
          f"h2's flight record: {len(fetches)} program.cache_fetch of {entry}; embedder builds tagged {builds}")
    r["h2_embedder_builds"] = builds
    trace_dir = os.path.join(root, "h2-trace")
    started = await controller._call_host(h2.service_id, "start_profiling", trace_dir=trace_dir)
    for q in queries[:HOSTS_PROFILED_SEARCHES]:
        await handle.call("search", image=q, top_k=TOP_K)
    stopped = await controller._call_host(h2.service_id, "stop_profiling")
    check(started["profiling"] and not stopped["profiling"], f"h2's profiling verbs {started} {stopped}")
    r["flash_launches_h2"] = _flash_events(trace_dir)
    depth = HOSTS_VIT.get("depth", VIT_DEPTH)
    check(r["flash_launches_h2"] == depth * forwards,
          f"h2's trace holds {r['flash_launches_h2']} flash_attn kernel events, expected {depth} x {forwards}")
    print(f"[{card}] hosts: h2 (no nvcc on its PATH, CUDA_HOME empty) fetched {tier['fetched']} entry from the tier "
          f"into its empty cache, the same bytes as h1's and no nvcc log beside them; its embedder builds are "
          f"tagged persistent hits {builds}; its own torch.profiler trace around {HOSTS_PROFILED_SEARCHES} searches "
          f"holds {r['flash_launches_h2']} flash_attn kernel events = {depth} x {forwards} bucket forwards")
    return r


def _cli(args: list, server_url: str, token: str, cwd: str, env: dict = None) -> tuple[int, dict, float]:
    """``python -m bioengine_tpu_torch.cli <args>``: exit code, its JSON
    (the last line) and its wall ms. ``env``: the process's environment
    (default this process's, with the checkout on ``PYTHONPATH``)."""
    cmd = [sys.executable, "-m", "bioengine_tpu_torch.cli", *args]
    if server_url:
        cmd += [f"--server-url={server_url}", f"--token={token}"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, env=env if env is not None else _repo_env(), cwd=cwd, capture_output=True,
                         text=True, timeout=HOSTS_CLI_S)
    ms = (time.perf_counter() - t0) * 1e3
    check(out.returncode == 0, f"bioengine-torch {' '.join(args)} exited {out.returncode}: {out.stderr[-2000:]}")
    text = out.stdout.strip()
    try:
        payload = json.loads(text)
    except json.JSONDecodeError:
        payload = json.loads(text.splitlines()[-1])
    return out.returncode, payload, ms


def dinov2_hub_state_dict(seed: int, depth: int, n_tokens: int, dim: int = 768) -> dict:
    """A seeded ViT-B/14 state dict under DINOv2's torch-hub key names
    (``mask_token`` included), its position table ``n_tokens`` long."""
    rng = np.random.default_rng(seed)
    shapes = {"cls_token": (1, 1, dim), "pos_embed": (1, n_tokens, dim), "mask_token": (1, dim),
              "patch_embed.proj.weight": (dim, 3, 14, 14), "patch_embed.proj.bias": (dim,),
              "norm.weight": (dim,), "norm.bias": (dim,)}
    for i in range(depth):
        b = f"blocks.{i}."
        shapes.update({b + "norm1.weight": (dim,), b + "norm1.bias": (dim,),
                       b + "attn.qkv.weight": (3 * dim, dim), b + "attn.qkv.bias": (3 * dim,),
                       b + "attn.proj.weight": (dim, dim), b + "attn.proj.bias": (dim,),
                       b + "ls1.gamma": (dim,), b + "ls2.gamma": (dim,),
                       b + "norm2.weight": (dim,), b + "norm2.bias": (dim,),
                       b + "mlp.fc1.weight": (4 * dim, dim), b + "mlp.fc1.bias": (4 * dim,),
                       b + "mlp.fc2.weight": (dim, 4 * dim), b + "mlp.fc2.bias": (dim,)})
    return {k: torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 0.02) for k, s in shapes.items()}


def hosts_cli(card: str, device: str, root: str, store_name: str, query) -> dict:
    """The port's worker as a subprocess, a host h3 joined to it, and
    ``python -m bioengine_tpu_torch.cli`` against both."""
    r: dict = {"commands": {}}
    hosts = _Hosts(root)
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    url, token = None, None

    def run(name: str, *args, server: bool = True):
        rc, payload, ms = _cli(list(args), url if server else "", token, root)
        r["commands"][name] = {"rc": rc, "ms": ms}
        return payload

    # models convert of a seeded DINOv2 ViT-B/14 checkpoint at full width
    # (no server) in a second lane, beside the worker's commands; its
    # position table fits the embedder's 224^2 input (257 tokens)
    ckpt, npz = os.path.join(root, "dinov2_vitb14.pth"), os.path.join(root, "dinov2_vitb14.npz")
    n_tokens = (ViTEmbedder.INPUT_SIZE // 14) ** 2 + 1
    sd = dinov2_hub_state_dict(SEED, HOSTS_CONVERT_DEPTH, n_tokens)
    want = sum(v.numel() for k, v in sd.items() if k != "mask_token")  # the ViT has no mask token
    torch.save(sd, ckpt)
    del sd
    lane = concurrent.futures.ThreadPoolExecutor(1)
    converted_f = lane.submit(run, "models convert", "models", "convert", ckpt, npz, "--arch", "dinov2",
                              server=False)
    worker, port, token, _ = start_worker_cli(device, os.path.join(root, "cli-worker"),
                                              os.path.join(root, "cli-worker.log"), store_name)
    url = f"ws://127.0.0.1:{port}/ws"
    try:

        hosts.spawn("h3", _host_cmd(url, token, "h3", os.path.join(root, "ws-h3"), device))
        t0 = time.perf_counter()
        while True:  # the worker's own chips in its topology, a joined host's in state.current.hosts
            cluster = run("cluster status", "cluster", "status")
            joined = cluster["state"]["current"].get("hosts") or {}
            if "h3" in joined and joined["h3"]["alive"]:
                break
            check(hosts.procs["h3"].poll() is None, f"h3 exited: {hosts.log('h3')}")
            check(time.perf_counter() - t0 < HOSTS_JOIN_S, f"h3 never showed in cluster status: {cluster}")
            time.sleep(0.2)
        topo = cluster["topology"]
        n_chips = topo["n_chips"] + sum(h["n_chips"] for h in joined.values())
        n_hosts = topo["n_hosts"] + len(joined)
        check((n_chips, n_hosts) == (2, 2) and {c["kind"] for c in topo["chips"]} == {kind},
              f"cluster status: {n_chips} chips across {n_hosts} hosts, {[c['kind'] for c in topo['chips']]}")
        status = run("status", "status")
        check(status["cluster"]["topology"]["chips"][0]["kind"] == kind, "status does not name the card")
        gpu_test = os.path.join(WORKER_BUNDLES, "gpu-test")
        if device == "cuda":
            deployed = run("apps deploy", "apps", "deploy", gpu_test)
        else:  # the CPU rehearsal passes the bundle its device
            deployed = run("apps deploy", "apps", "run", "--local-path", gpu_test, "--deployment-kwargs",
                           json.dumps({"gpu_test_deployment": {"device": device}}))
        info = run("call gpu_info", "call", deployed["app_id"], "gpu_info")
        names = [d.get("device_kind") for d in info.get("devices", [])]
        check(not info["error"] and (device != "cuda" or names == [kind]), f"gpu_info: {info}")
        run("apps stop", "apps", "stop", deployed["app_id"])
        mem = run("cluster profile --memory", "cluster", "profile", "--memory")
        check(device != "cuda" or (mem["allocator_snapshot_bytes"] > 0 and mem["devices"][0]["kind"] == kind),
              f"cluster profile --memory: {mem.get('allocator_snapshot_bytes')} B")
        bundle = run("debug bundle", "debug", "bundle", "-o", os.path.join(root, "bundle.json"))
        check((bundle["hosts_reachable"], bundle["hosts_total"]) == (1, 1), f"debug bundle: {bundle}")

        converted = converted_f.result()
        check(converted["top_level"] and converted["n_params"] == want,
              f"models convert: {converted['n_params']} parameters, expected {want}")
        emb = ViTEmbedder(weights_path=npz, device=device, model_overrides={"depth": HOSTS_CONVERT_DEPTH})
        vec = emb.embed_batch([query])
        check(vec.shape == (1, 768) and np.isfinite(vec).all(), f"the converted weights embed to {vec.shape}")
        del emb
        r.update(n_params=converted["n_params"], cluster_chips=n_chips, cluster_hosts=n_hosts,
                 gpu_info_devices=names, allocator_snapshot_bytes=mem["allocator_snapshot_bytes"],
                 bundle_hosts=[bundle["hosts_reachable"], bundle["hosts_total"]])
        rc_h3 = hosts.stop("h3")
        check(rc_h3 == 0, f"h3 exited {rc_h3} on SIGTERM: {hosts.log('h3')}")
        r["h3_exit"] = rc_h3
        worker.send_signal(signal.SIGTERM)
        try:
            r["worker_exit"] = worker.wait(timeout=HOSTS_STOP_S)
        except subprocess.TimeoutExpired:
            r["worker_exit"] = None
        check(r["worker_exit"] == 0, f"the worker exited {r['worker_exit']} on SIGTERM")
    finally:
        lane.shutdown(wait=True)
        hosts.kill_all()
        if worker.poll() is None:
            worker.kill()
            worker.wait()
        _unlink_shm(store_name)
    ms = {k: round(v["ms"], 3) for k, v in r["commands"].items()}
    print(f"[{card}] hosts: `python -m bioengine_tpu_torch.worker` with host h3 joined: cluster status reports "
          f"{r['cluster_chips']} chips across {r['cluster_hosts']} hosts, status and gpu_info name {kind!r}, "
          f"cluster profile --memory reports a {r['allocator_snapshot_bytes']} B allocator snapshot, debug bundle "
          f"{r['bundle_hosts'][0]} of {r['bundle_hosts'][1]} hosts reachable; models convert --arch dinov2 "
          f"reported {r['n_params']} parameters and its npz loaded as the embedder's weights_path; every command "
          f"exited 0 (ms {json.dumps(ms)}); h3 and the worker exited 0 on SIGTERM")
    return r


def hosts_fields(root: str) -> tuple[str, list]:
    """HOSTS_FIELDS synthetic 896^2 fields as ``.npy`` files in
    ``<root>/fields`` (a local dataset) and HOSTS_SEARCHES query crops cut
    from them."""
    fields_dir = os.path.join(root, "fields")
    os.makedirs(fields_dir)
    crops = []
    for name, field in make_synthetic_images(n_images=HOSTS_FIELDS, size=WORKER_FIELD_SIZE, seed=SEED + 11):
        np.save(os.path.join(fields_dir, f"{name}.npy"), field)
        if len(crops) < HOSTS_SEARCHES:
            crops += extract_cell_crops(field, crop_size=224, n_crops=HOSTS_SEARCHES - len(crops))
    queries = [c.astype(np.float64) for c in crops[:HOSTS_SEARCHES]]
    check(len(queries) == HOSTS_SEARCHES, f"{len(queries)} query crops")
    return fields_dir, queries


def phase_hosts(card: str, device: str = "cuda") -> dict:
    """Slice 11: worker hosts on the card. A controller with no chips of its
    own here; ``python -m bioengine_tpu_torch.worker_host`` subprocesses
    serve cell-image-search (the flash kernel in their own process) and fail
    over; then the CLI against a worker subprocess with a host joined. One
    ``hosts`` JSON line."""
    os.environ["BIOENGINE_DISABLE_GEOLOCATION"] = "1"  # no egress
    t_phase = time.perf_counter()
    try:
        importlib.import_module("click")
        has_click = True
    except ImportError:
        has_click = False
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hosts_") as root:
        fields_dir, queries = hosts_fields(root)
        _warm_reference(device, queries[0])
        base = _used_bytes(device)
        store_name = f"bioengine-rpc-smoke-hosts-{os.getpid()}"
        os.environ["BIOENGINE_RPC_STORE_NAME"] = store_name
        attention.launch_count = 0
        hosts = _Hosts(root)
        # the CLI against its own worker subprocess and host h3 (processes,
        # ports, segment and files of their own) in a second lane, beside
        # h1 and h2 on the controller here
        with concurrent.futures.ThreadPoolExecutor(1) as lane:
            cli = lane.submit(hosts_cli, card, device, root, f"{store_name}-cli", queries[0]) if has_click else None
            try:
                r = asyncio.run(drive_hosts(card, device, root, fields_dir, queries, hosts))
            finally:
                try:
                    cli_r = cli.result() if cli is not None else None
                finally:
                    del os.environ["BIOENGINE_RPC_STORE_NAME"]
                    _unlink_shm(store_name)
        if not has_click:
            print("cli: click absent")
        r["cli"] = cli_r
    after = _used_bytes(device)
    r["used_before"], r["used_after"] = base, after
    check(after - base <= HOSTS_MEMORY_SLACK, f"the card's used memory {after} B after the phase against {base} B "
          f"before it (slack {HOSTS_MEMORY_SLACK} B)")
    r["phase_s"] = time.perf_counter() - t_phase
    reserved = torch.cuda.memory_reserved() if device == "cuda" else 0
    print(f"[{card}] hosts: the card's used memory {base} B before the phase, {after} B after "
          f"({(after - base) / 2**20:.3f} MiB apart, limit 64 MiB; this process's allocator reserves {reserved} B "
          f"after it); flash_attn_fwd launches in this process "
          f"{attention.launch_count} (the in-process reference app's)")
    out = {"card": card, "join_ms": r["join_ms"], "deploy_ms": r["deploy_ms"],
           "ms_per_search_host": r["search_ms"]["host"]["median"],
           "ms_per_search_in_process": r["search_ms"]["in_process"]["median"],
           "hop_ms": r["hop_ms"]["median"], "failover_ms_to_healthy": r["failover_ms"],
           "failover_ms_to_first_search": r["first_search_ms"],
           "flash_launches_h1": r["flash_launches"],
           # slice 13: h1's nvcc build, the tier's entry, h2's library fetched from it
           "tier": {k: r.get("tier", {}).get(k) for k in ("entry", "bytes", "nvcc_s_h1", "fetch_s", "fetched_h2",
                                                          "flash_launches_h2")},
           "cli": None if r["cli"] is None else {k: v["rc"] for k, v in r["cli"]["commands"].items()},
           "detail": r}
    print(f"[{card}] hosts phase: {r['phase_s']:.3f} s")
    print("hosts " + json.dumps(out, default=str))
    return out


# ---- slice 12: the scenario engine, the fuzzer and the controller process ----

SCENARIO_SEED = 7
# the catalog's scenarios with worker hosts, (name, defenses): each runs with
# its hosts on the card and on one CPU chip, at one chip a replica
SCENARIO_HOST_RUNS = (("slow_replica", True), ("slow_replica", False), ("preemption_storm", True),
                      ("diurnal_wave", True), ("blip_storm", True), ("controller_crash", True),
                      ("token_streaming", True))
SCENARIO_HOSTLESS = ("hot_signature", "tenant_flood", "fleet_scale", "router_loss")
SCENARIO_REPLAY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fuzz_corpus",
                               "host_blip_drain_starvation.json")
SCENARIO_CLI_S = 300  # one scenarios or fuzz command
# BIOENGINE_SCENARIO_SCALE for parts (a) and (b): every time constant of a
# run doubled, its request plan (and so its signature) unchanged; at 1.0 a
# host stall on the card's shared machine once flipped a latency verdict of
# one leg of slow_replica
SCENARIO_SCALE = "2.0"
CRASH_TOKEN = "chip-smoke-controller-token"
CRASH_GRACE_S = 60  # BIOENGINE_RECONCILE_GRACE_S: how long the second life waits for hosts to rejoin
CRASH_MARKER_S = 300  # a controller process's READY / DEPLOYED / RECONCILED
CRASH_CALL_S = 60  # one attempt of an idempotent call
CRASH_BUDGET_S = 180  # one idempotent call's attempts, across the crash
CRASH_PACE_S = 0.05  # between searches across the crash
CRASH_RANGE = "chip_smoke.searches_after_recovery"  # the profiler range of the searches counted


def signature_diff(a: dict, b: dict) -> str:
    """Where two scenario results' outcome signatures part: the invariant
    verdicts that differ and the first requests whose outcome class does."""
    verdicts = {k: (v["ok"], b["invariants"].get(k, {}).get("ok")) for k, v in a["invariants"].items()
                if v["ok"] != b["invariants"].get(k, {}).get("ok")}
    outcomes = [(i, x, y) for i, (x, y) in enumerate(zip(a["outcomes"], b["outcomes"])) if x != y]
    return (f"verdicts {verdicts}; {len(outcomes)} outcome(s) differ, first {outcomes[:5]}; "
            f"details {[(k, a['invariants'][k]['detail'], b['invariants'][k]['detail']) for k in verdicts]}")


async def scenario_catalog(card: str, device: str) -> dict:
    """(a) Each scenario with hosts, cut to one chip a replica as bench.py's
    gray-failure stage cuts it for one device (``chips_per_replica`` 2 does
    not fit one card), with its in-process hosts on ``device`` and on one CPU
    chip at the same seed; then the host-less ones once on ``device``, which
    they never touch."""
    r: dict = {"host_runs": {}, "hostless": {}}
    for name, defenses in SCENARIO_HOST_RUNS:
        scenario = dataclasses.replace(scenarios.get_scenario(name), chips_per_replica=1)
        legs = {}
        for leg, where in (("card", {"device": device}), ("cpu", {"device": "cpu", "n_devices": 1})):
            t0 = time.perf_counter()
            res = await scenarios.run_scenario_async(scenario, seed=SCENARIO_SEED, defenses=defenses, **where)
            legs[leg] = {"s": time.perf_counter() - t0, "red": sorted(fuzz.red_set(res)), "passed": res["passed"],
                         "signature": scenarios.outcome_signature(res), "requests": res["requests"],
                         "p99_recovery": res["invariants"].get("p99_recovery", {}).get("ok"), "result": res}
        card_leg, cpu_leg = legs["card"], legs["cpu"]
        key = f"{name}{'' if defenses else '_undefended'}"
        check(card_leg["signature"] == cpu_leg["signature"],
              f"{key}: the outcome signature with hosts on {device} differs from the one on the CPU: "
              f"{signature_diff(card_leg['result'], cpu_leg['result'])}")
        for leg in legs.values():
            del leg["result"]
        if defenses:
            check(card_leg["passed"] and cpu_leg["passed"], f"{key}: red {card_leg['red']} / {cpu_leg['red']}")
        else:  # the acceptance proof's other direction: the same incident, undefended, shows
            check(card_leg["p99_recovery"] is False and cpu_leg["p99_recovery"] is False,
                  f"{key}: p99_recovery held without defenses")
        r["host_runs"][key] = legs
        print(f"[{card}] scenarios: {key} (chips_per_replica 1, seed {SCENARIO_SEED}, "
              f"scale {os.environ.get('BIOENGINE_SCENARIO_SCALE', '1')}), hosts on {device}: "
              f"{card_leg['s']:.3f} s, red {card_leg['red']}, p99_recovery ok {card_leg['p99_recovery']}")
        print(f"[{card}] scenarios: {key}, hosts on one CPU chip: {cpu_leg['s']:.3f} s, red {cpu_leg['red']}; "
              f"outcome signature ({card_leg['requests']} requests) equal to the {device} leg's")
    for name in SCENARIO_HOSTLESS:
        t0 = time.perf_counter()
        res = await scenarios.run_scenario_async(scenarios.get_scenario(name), seed=SCENARIO_SEED, device=device)
        run = {"s": time.perf_counter() - t0, "red": sorted(fuzz.red_set(res)), "requests": res["requests"]}
        check(res["passed"], f"{name}: red {run['red']}")
        r["hostless"][name] = run
        print(f"[{card}] scenarios: {name} (no hosts): {run['s']:.3f} s, red {run['red']}, {run['requests']} requests")
    return r


def scenario_commands(card: str, device: str, root: str, env: dict) -> dict:
    """(b) ``bioengine-torch scenarios`` and ``fuzz`` as subprocesses in the
    environment ``env``; a host scenario at 2 chips a replica on fewer chips
    fails with the placement error, nothing shrunk. The same replay in
    this process is ``scenario_replay``'s."""
    r: dict = {"commands": {}}

    def run(name: str, *args):
        rc, payload, ms = _cli(list(args), "", "", root, env)
        r["commands"][name] = {"rc": rc, "ms": ms}
        return payload

    # slow_replica leases 2 chips a replica: on one card it must not run
    have = torch.cuda.device_count() if device == "cuda" else 1
    args = ["scenarios", "run", "slow_replica", "--device", device] + (["--n-devices", "1"] if device == "cpu" else [])

    def slow_replica():
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "bioengine_tpu_torch.cli", *args], env=env, cwd=root,
                             capture_output=True, text=True, timeout=SCENARIO_CLI_S)
        r["commands"]["scenarios run slow_replica"] = {"rc": out.returncode, "ms": (time.perf_counter() - t0) * 1e3}
        return out

    # the list and the placement error (process starts, no scenario run) in
    # a second lane beside the two runs, each command still its own process
    with concurrent.futures.ThreadPoolExecutor(1) as lane:
        listed_f = lane.submit(run, "scenarios list", "scenarios", "list")
        out_f = lane.submit(slow_replica)
        routed = run("scenarios run router_loss", "scenarios", "run", "router_loss", "--device", device,
                     "--check-determinism")
        replay = run("fuzz --replay", "fuzz", "--replay", SCENARIO_REPLAY, "--device", "cpu", "--n-devices", "8")
        listed, out = listed_f.result(), out_f.result()
    check({s["name"] for s in listed} == set(scenarios.NAMED_SCENARIOS), f"scenarios list: {len(listed)} rows")
    check(routed["deterministic"] is True and routed["result"]["passed"], f"router_loss: {routed['result']}")
    (row,) = replay["replays"]
    check(row["matches_expect"] and row["deterministic"] is True, f"fuzz --replay: {row}")
    fix = "--device cpu" if device == "cuda" else "--n-devices 2"
    if have < 2:
        error = out.stderr.strip().splitlines()[-1] if out.stderr.strip() else ""
        check(out.returncode != 0 and "places replicas of 2 chips" in error and fix in error,
              f"slow_replica on {have} chip(s) exited {out.returncode}: {out.stderr[-2000:]}")
        r["placement_error"] = error
    else:
        check(out.returncode == 0, f"slow_replica on {have} cards exited {out.returncode}: {out.stderr[-2000:]}")
        r["placement_error"] = None
    ms = {k: round(v["ms"], 3) for k, v in r["commands"].items()}
    print(f"[{card}] scenarios: `bioengine-torch scenarios list` ({len(listed)} scenarios), `scenarios run "
          f"router_loss --device {device} --check-determinism` (identical) and `fuzz --replay "
          f"{os.path.basename(SCENARIO_REPLAY)} --device cpu --n-devices 8` exited 0 as the artifact expects; "
          f"`{' '.join(args)}` on {have} chip(s) exited "
          f"{out.returncode}: {r['placement_error']!r} (ms {json.dumps(ms)})")
    return r


def scenario_replay(card: str) -> None:
    """(b) the pinned fuzz artifact replayed in this process on 8 CPU
    chips: the outcome signature and red set the artifact pins."""
    pinned = fuzz.load_artifact(SCENARIO_REPLAY)
    verdict = asyncio.run(fuzz.replay_artifact(pinned, check_determinism=False, device="cpu", n_devices=8))
    check(verdict["signature"] == pinned["outcome_signature"] and verdict["red"] == pinned["expect"]["red"],
          "the replay's outcome signature differs from the one the artifact pins")
    print(f"[{card}] scenarios: {os.path.basename(SCENARIO_REPLAY)} replayed in process, its signature equal "
          "to the pinned one")


async def _marker(proc, marker: str, log: str) -> tuple[str, float]:
    """The controller process's next stdout line starting with ``marker``,
    and when it came (perf_counter)."""
    deadline = time.perf_counter() + CRASH_MARKER_S
    while True:
        remaining = deadline - time.perf_counter()
        check(remaining > 0, f"the controller process never printed {marker}: {_log_tail(log)}")
        try:
            line = await asyncio.wait_for(proc.stdout.readline(), timeout=remaining)
        except asyncio.TimeoutError:
            line = None
        check(bool(line), f"the controller process ended before {marker}: {_log_tail(log)}")
        text = line.decode().strip()
        if text.startswith(marker):
            return text, time.perf_counter()


async def drive_controller_crash(card: str, device: str, root: str, fields_dir: str, queries) -> dict:
    """(c) ``python -m bioengine_tpu_torch.testing.controller_proc`` deploys
    the port's cell-image-search bundle as shipped onto a worker host in this
    process on ``device``; it is SIGKILLed under idempotent search traffic and
    its ``--recover`` life adopts the warm replica."""
    r: dict = {}
    port = _free_port()
    url = f"ws://127.0.0.1:{port}/ws"
    control_dir = os.path.join(root, "control")
    env = _repo_env(BIOENGINE_ADMIN_TOKEN=CRASH_TOKEN, BIOENGINE_RECONCILE_GRACE_S=str(CRASH_GRACE_S))
    logs = [os.path.join(root, f"controller-{i}.log") for i in (1, 2)]

    async def spawn(life: int, *extra):
        with open(logs[life - 1], "w") as log:
            return await asyncio.create_subprocess_exec(
                sys.executable, "-m", "bioengine_tpu_torch.testing.controller_proc", "--port", str(port),
                "--control-dir", control_dir, *extra, stdout=asyncio.subprocess.PIPE, stderr=log, env=env)

    async def search(client, q) -> tuple[dict, int]:
        """route_call's search, retried as a client retries an idempotent
        call until it answers or CRASH_BUDGET_S runs out; (result, retries)."""
        deadline = time.perf_counter() + CRASH_BUDGET_S
        retries = 0
        while True:
            try:
                return await asyncio.wait_for(client.call(
                    "serve-router", "route_call", WORKER_CIS, "main", "search", [],
                    {"image": q, "top_k": TOP_K}), CRASH_CALL_S), retries
            except Exception as e:  # noqa: BLE001 — the controller is dead or recovering
                check(time.perf_counter() < deadline, f"an idempotent search failed for good: {e!r}")
                retries += 1
                await asyncio.sleep(CRASH_PACE_S)

    bundle = os.path.join(WORKER_BUNDLES, WORKER_CIS)
    proc1 = await spawn(1, "--deploy-dir", bundle, "--app-id", WORKER_CIS)
    proc2 = host = client = None
    try:
        ready, _ = await _marker(proc1, "READY", logs[0])
        check("epoch=1" in ready, ready)
        host = WorkerHost(server_url=url, token=CRASH_TOKEN, host_id="c1", workspace_dir=os.path.join(root, "ws-c1"),
                          rejoin=True, orphan_grace_s=600.0, device=device)
        t0 = time.perf_counter()
        await host.start()
        host.connection.reconnect_max_backoff_s = 0.3
        _, t_deployed = await _marker(proc1, "DEPLOYED", logs[0])
        r["join_deploy_ms"] = (t_deployed - t0) * 1e3
        ((rid, replica),) = host.replicas.items()
        instance = replica.instance
        embedder = instance.embedder
        check(instance.device.type == device and host.topology.n_chips == 1,
              f"the replica computes on {instance.device}; the host holds {host.topology.n_chips} chip(s)")

        client = await connect_to_server({"server_url": url, "token": CRASH_TOKEN, "reconnect": True})
        client.reconnect_max_backoff_s = 0.3

        async def call(method, **kwargs):
            return await client.call("serve-router", "route_call", WORKER_CIS, "main", method, [], kwargs)

        await call("add_dataset", name="cells", source="local", path=fields_dir)
        t0 = time.perf_counter()
        await call("start_ingestion", dataset_name="cells", session_id="crash")
        while True:
            st = await call("get_ingestion_status", session_id="crash")
            if st["status"] in ("completed", "failed", "stopped"):
                break
            check(time.perf_counter() - t0 < WORKER_INGEST_TIMEOUT_S, f"ingestion stuck: {st}")
            await asyncio.sleep(0.05)
        r["ingest_ms"] = (time.perf_counter() - t0) * 1e3
        stats = await call("get_index_stats")
        check(st["status"] == "completed" and stats["n_cells"] == st["n_embedded"] > 0, f"ingestion {st} {stats}")
        r["n_cells"] = stats["n_cells"]
        vit = embedder._model
        r["model"] = {"dim": vit.dim, "depth": vit.depth, "patch": vit.patch_size, "dtype": str(vit.dtype),
                      "bucket": embedder.batch_bucket}
        check(device != "cuda" or r["model"] == {"dim": 768, "depth": VIT_DEPTH, "patch": 14,
                                                 "dtype": "torch.bfloat16", "bucket": BUCKET},
              f"the bundle as shipped built {r['model']}, expected ViT-B/14 in bf16 at bucket {BUCKET}")
        before = [(await search(client, q))[0] for q in queries]

        # idempotent searches in flight across the SIGKILL and the recovery
        answers: list = []  # (perf_counter, query index, result, retries)
        stop = asyncio.Event()

        async def traffic():
            i = 0
            while not stop.is_set():
                out, tries = await search(client, queries[i % len(queries)])
                answers.append((time.perf_counter(), i % len(queries), out, tries))
                i += 1
                await asyncio.sleep(CRASH_PACE_S)

        crossing = asyncio.create_task(traffic())
        await asyncio.sleep(0.5)
        t_kill = time.perf_counter()
        proc1.send_signal(signal.SIGKILL)
        await proc1.wait()
        proc2 = await spawn(2, "--recover")
        ready2, _ = await _marker(proc2, "READY", logs[1])
        check("epoch=2" in ready2 and "phase=RECOVERING" in ready2, ready2)
        reconciled, t_reconciled = await _marker(proc2, "RECONCILED", logs[1])
        r["reconciled"] = reconciled
        r["kill_to_reconciled_ms"] = (t_reconciled - t_kill) * 1e3
        while sum(1 for a in answers if a[0] > t_reconciled) < len(queries):
            if crossing.done():
                await crossing  # its failure, raised here
            await asyncio.sleep(0.05)
        stop.set()
        await crossing
        after_kill = [a for a in answers if a[0] > t_kill]
        r["kill_to_first_answer_ms"] = (after_kill[0][0] - t_kill) * 1e3
        r["crossing"] = {"answered": len(answers), "after_kill": len(after_kill),
                         "retries": sum(a[3] for a in answers), "failed": 0}
        counts = dict(kv.split("=") for kv in reconciled.split()[1:])
        check(counts == {"adopted": "1", "replaced": "0", "dropped": "0"},
              f"the second life reconciled {reconciled!r}, expected the warm replica adopted")
        check(host.replicas.get(rid) is not None and host.replicas[rid].instance is instance,
              "the replica was rebuilt across the crash")
        check(r["crossing"]["retries"] > 0, "no search felt the crash")
        for _, i, out, _ in answers:
            check(_results(out) == _results(before[i]), f"search {i} across the crash differs from before it")
        t0 = time.perf_counter()
        while host.controller_epoch < 2:
            check(time.perf_counter() - t0 < HOSTS_JOIN_S, f"the host serves epoch {host.controller_epoch}")
            await asyncio.sleep(0.05)

        # the searches after the recovery, under the host's own profiler; a
        # search before and after them keeps the trace's edges off them, and
        # the kernels counted are those inside their annotated range
        trace_dir = os.path.join(root, "c1-trace")
        host.start_profiling(trace_dir=trace_dir)
        await search(client, queries[0])
        forwards0, launches0 = embedder.forward_count, attention.launch_count
        with torch.profiler.record_function(CRASH_RANGE):
            after = [(await search(client, q))[0] for q in queries]
        forwards = embedder.forward_count - forwards0
        r["window_launches"] = attention.launch_count - launches0
        await search(client, queries[0])
        host.stop_profiling()
        for i, (a, b) in enumerate(zip(after, before)):
            check(_results(a) == _results(b) and len(a["results"]) == TOP_K,
                  f"search {i} after the recovery differs from before the crash")
        r["depth"] = depth = vit.depth
        r["flash_events"] = _flash_events(trace_dir, within=CRASH_RANGE)
        check(r["flash_events"] == (depth * forwards if device == "cuda" else 0) and forwards > 0,
              f"the trace of the searches holds {r['flash_events']} flash_attn events, expected {depth} x {forwards} "
              f"({r['window_launches']} launches counted in the window; {_flash_event_census(trace_dir)})")
        r["forwards"] = embedder.forward_count
    finally:
        if client is not None:
            await client.disconnect()
        if host is not None:
            await host.stop()
        for proc in (proc1, proc2):
            if proc is not None and proc.returncode is None:
                proc.kill()
                await proc.wait()
    print(f"[{card}] scenarios: `python -m bioengine_tpu_torch.testing.controller_proc --deploy-dir` the "
          f"{WORKER_CIS} bundle as shipped (ViT {r['model']}) onto host c1 in this process on "
          f"{device} (join and deploy {r['join_deploy_ms']:.3f} ms); {r['n_cells']} cells ingested in "
          f"{r['ingest_ms']:.3f} ms; {len(queries)} searches, then SIGKILL under idempotent searches: "
          f"{r['reconciled']} {r['kill_to_reconciled_ms']:.3f} ms after the kill, the first search answered "
          f"{r['kill_to_first_answer_ms']:.3f} ms after it; {r['crossing']['answered']} searches across the crash "
          f"({r['crossing']['retries']} retried attempts, 0 failed) and {len(queries)} after the recovery equal the "
          f"{len(queries)} before bit for bit; the trace of those {len(queries)} holds {r['flash_events']} "
          f"flash_attn kernel events")
    return r


def phase_scenarios(card: str, device: str = "cuda") -> dict:
    """Slice 12: (a) the scenario catalog with worker hosts on the card and on
    the CPU, equal outcome signatures; (b) the ``scenarios`` and ``fuzz``
    commands; (c) a real controller process SIGKILLed and recovered with the
    flash kernel on the path. One ``scenarios`` JSON line."""
    os.environ["BIOENGINE_DISABLE_GEOLOCATION"] = "1"  # no egress
    t_phase = time.perf_counter()
    store_name = f"bioengine-rpc-smoke-scenarios-{os.getpid()}"
    os.environ["BIOENGINE_RPC_STORE_NAME"] = store_name
    home = os.environ.get("HOME")
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_scenarios_") as root:
            os.environ["BIOENGINE_SCENARIO_SCALE"] = SCENARIO_SCALE
            attention.launch_count = 0
            catalog = asyncio.run(scenario_catalog(card, device))
            scenario_launches = attention.launch_count
            check(scenario_launches == 0, f"the synthetic app launched flash_attn_fwd {scenario_launches} times")
            # (b)'s commands are processes of their own, in the catalog's
            # environment, in a second lane beside (c); its in-process replay
            # comes after (c), whose host shares this process's registries
            with concurrent.futures.ThreadPoolExecutor(1) as lane:
                commands_f = lane.submit(scenario_commands, card, device, root, _repo_env())
                del os.environ["BIOENGINE_SCENARIO_SCALE"]
                fields_dir, queries = hosts_fields(root)
                # the bundle's default workspace_dir is ~/.bioengine/cell-image-search
                os.environ["HOME"] = root
                attention.launch_count = 0
                try:
                    crash = asyncio.run(drive_controller_crash(card, device, root, fields_dir, queries))
                finally:
                    crash_launches = attention.launch_count
                    commands = commands_f.result()
            check(crash_launches == (crash["depth"] * crash["forwards"] if device == "cuda" else 0),
                  f"flash_attn_fwd launched {crash_launches} times for {crash['forwards']} bucket forwards")
            if home is None:
                os.environ.pop("HOME", None)
            else:
                os.environ["HOME"] = home
            os.environ["BIOENGINE_SCENARIO_SCALE"] = SCENARIO_SCALE
            scenario_replay(card)
    finally:
        os.environ.pop("BIOENGINE_RPC_STORE_NAME", None)
        os.environ.pop("BIOENGINE_SCENARIO_SCALE", None)
        if home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = home
        _unlink_shm(store_name)
    phase_s = time.perf_counter() - t_phase
    out = {"card": card,
           "host_runs_s": {k: {leg: round(v["s"], 3) for leg, v in legs.items()}
                           for k, legs in catalog["host_runs"].items()},
           "hostless_s": {k: round(v["s"], 3) for k, v in catalog["hostless"].items()},
           "commands": {k: v["rc"] for k, v in commands["commands"].items()},
           "kill_to_reconciled_ms": crash["kill_to_reconciled_ms"],
           "kill_to_first_answer_ms": crash["kill_to_first_answer_ms"],
           "crossing": crash["crossing"], "flash_events": crash["flash_events"],
           "flash_attn_fwd_launches": {"scenarios": scenario_launches, "controller_crash": crash_launches},
           "phase_s": phase_s}
    print(f"[{card}] scenarios phase: {phase_s:.3f} s; flash_attn_fwd launches: {scenario_launches} in the "
          f"scenario runs, {crash_launches} on the controller-crash path")
    print("scenarios " + json.dumps(out, default=str))
    return out


# ---- slice 13: device prefetch and train-state checkpoints --------------------

PREFETCH_BATCHES = 8  # bucket-64 batches of 224^2 RGB crops, streamed per run
PREFETCH_DEPTH = 2  # ZarrBatchLoader(prefetch_batches=...)
PREFETCH_SOURCE_CROPS = 128  # distinct crops cut from synthetic fields; rows mix three of them
PREFETCH_VIT = {"depth": VIT_DEPTH}  # ViT-B/14 at full width, bf16
PREFETCH_TURNS = ("prefetch", "sync", "sync", "prefetch")
PREFETCH_MEMORY_PASSES = 4  # passes over the batches in a run of the in-memory leg
CKPT_STEPS = 5  # train steps, a save before each
CKPT_KEEP = 2
CKPT_TIMED_SAVES = 3


def prefetch_rows(n: int, seed: int) -> np.ndarray:
    """``n`` seeded 224^2 RGB crops, (n, 224, 224, 3) uint8 as the app's
    ``to_rgb_uint8`` makes them: each row's channels are three crops of
    synthetic fields (rotated and flipped at random), so every row differs."""
    crops = []
    for i, (_, field) in enumerate(make_synthetic_images(n_images=64, size=WORKER_FIELD_SIZE, n_cells=60,
                                                         seed=seed)):
        crops += extract_cell_crops(field, crop_size=224, n_crops=PREFETCH_SOURCE_CROPS - len(crops))
        if len(crops) >= PREFETCH_SOURCE_CROPS:
            break
    check(len(crops) >= 3, f"{len(crops)} source crops")
    rng = np.random.default_rng(seed)
    rows = np.empty((n, 224, 224, 3), np.uint8)
    for i in range(n):
        picks = [np.rot90(crops[j], rng.integers(4)) for j in rng.choice(len(crops), 3, replace=False)]
        rows[i] = to_rgb_uint8(np.stack([p[:, ::-1] if rng.integers(2) else p for p in picks], axis=-1))
    return rows


class _LoopThread:
    """An event loop on a thread of its own (the datasets server's)."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        self.loop.close()


async def _open_rows(url: str) -> RemoteZarrArray:
    """The dataset's array, over a fresh chunk cache (each run reads every
    chunk over HTTP). The loader reads on its own thread's event loop,
    through a client the store keeps for that loop."""
    store = HttpZarrStore(url, cache=ChunkCache())
    return await RemoteZarrArray.open(store, "rgb")


def _stream_embed(source, embedder: ViTEmbedder, mode: str, device: str) -> tuple[torch.Tensor, float]:
    """Every row through the embedder, batch by batch. ``source`` is the
    dataset's URL (the batches read by ``ZarrBatchLoader`` from the
    datasets plane) or a list of host batches already in memory.
    ``prefetch`` streams the batches onto the card over pinned memory and
    a copy stream (``ZarrBatchLoader.__iter__``, or ``prefetch_to_device``
    for batches in memory); ``sync`` uploads each host batch from pageable
    memory before its forward. (embeddings on the device, wall s)."""
    if isinstance(source, str):
        arr = asyncio.run(_open_rows(source))
        loader = ZarrBatchLoader(arr, batch_size=BUCKET, prefetch_batches=PREFETCH_DEPTH, device=device)
    _sync(device)
    t0 = time.perf_counter()
    if mode == "prefetch":
        batches = iter(loader) if isinstance(source, str) else prefetch_to_device(
            iter(source), size=PREFETCH_DEPTH, device=device)
    else:
        host = loader.host_batches() if isinstance(source, str) else iter(source)
        batches = (torch.from_numpy(b).to(device) for b in host)
    out = torch.cat([embedder.embed_tensor(model_input(b)) for b in batches])
    _sync(device)
    return out, time.perf_counter() - t0


def _profiled_stream(source, warm: list, embedder: ViTEmbedder, device: str,
                     path: str) -> tuple[torch.Tensor, dict, int]:
    """One ``prefetch`` run as the active step of a ``torch.profiler``
    schedule whose warm-up step streams the batches ``warm`` (the tracer
    records nothing until it is running, and the in-memory leg's first
    copies start within a millisecond of the profiler's start); its
    embeddings, the batches' copies read from the active step's trace
    (``_copy_overlap``) and its flash_attn_fwd launches."""
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
        on_trace_ready=lambda p: p.export_chrome_trace(path),
    ) as prof:
        _stream_embed(warm, embedder, "prefetch", device)
        prof.step()
        launches0 = attention.launch_count
        out, _ = _stream_embed(source, embedder, "prefetch", device)
        launches = attention.launch_count - launches0
        prof.step()
    return out, _copy_overlap(path, BUCKET * 224 * 224 * 3), launches


def _copy_overlap(trace_path: str, batch_bytes: int) -> dict:
    """From a ``torch.profiler`` Chrome trace: the batches' host-to-device
    copies (memcpy events of ``batch_bytes``), their kinds and streams, the
    streams of the flash_attn kernels, and the share of the copies' time
    that overlaps some kernel."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")
              and e.get("args", {}).get("bytes") == batch_bytes]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    flash_streams = sorted({e["args"].get("stream") for e in kernels if "flash_attn" in e["name"]})
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    merged: list = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    htod = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    copy_us = sum(e["dur"] for e in copies)
    overlap_us = sum(max(0.0, min(b, e["ts"] + e["dur"]) - max(a, e["ts"])) for e in copies for a, b in merged)
    return {"copies": len(copies), "kinds": sorted({e["name"] for e in copies}),
            "flash_events": sum(1 for e in kernels if "flash_attn" in e["name"]),
            "copy_streams": sorted({e["args"].get("stream") for e in copies}), "flash_streams": flash_streams,
            "copy_us": copy_us, "overlap_us": overlap_us, "htod_sample": [
                {"name": e["name"], "args": e.get("args")} for e in htod[:3]],
            "overlap_share": overlap_us / copy_us if copy_us else 0.0}


def phase_prefetch(card: str, device: str = "cuda") -> dict:
    """Slice 13: a seeded zarr dataset of 224^2 RGB crops on the datasets
    plane, streamed by ``ZarrBatchLoader(prefetch_batches=2)`` onto the
    card and embedded by the cell-image-search ViT-B/14 (bf16, bucket 64);
    then the same batches from host memory through ``prefetch_to_device``,
    where the card and not the plane sets the pace. One ``prefetch`` JSON
    line."""
    t_phase = time.perf_counter()
    n = PREFETCH_BATCHES * BUCKET
    rows = prefetch_rows(n, SEED + 13)
    r: dict = {"rows": n}
    loop = _LoopThread()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prefetch_") as root:
        ds = os.path.join(root, "data", "crops")
        os.makedirs(ds)
        with open(os.path.join(ds, "manifest.yaml"), "w") as f:
            f.write("description: 224^2 RGB cell crops\nauthorized_users: ['*']\n")
        zarr_codec.write_group(os.path.join(ds, "crops.zarr"))
        zarr_codec.write_array(os.path.join(ds, "crops.zarr"), "rgb", rows, chunks=(1, 224, 224, 3))
        server = DatasetsServer(os.path.join(root, "data"), host="127.0.0.1", write_discovery_file=False)
        loop.run(server.start())
        try:
            url = f"{server.url}/data/crops/crops.zarr"
            emb = ViTEmbedder(device=device, seed=SEED, batch_bucket=BUCKET, model_overrides=PREFETCH_VIT)
            # the same rows uploaded whole, embedded bucket by bucket
            whole = torch.from_numpy(rows).to(device)
            ref = torch.cat([emb.embed_tensor(model_input(whole[i:i + BUCKET])) for i in range(0, n, BUCKET)])
            del whole
            host = [rows[i:i + BUCKET] for i in range(0, n, BUCKET)]
            # in turns, from the datasets plane and from host memory (a run
            # there passes over the batches PREFETCH_MEMORY_PASSES times)
            for source, label, passes in ((url, "plane", 1), (host * PREFETCH_MEMORY_PASSES, "memory",
                                                                PREFETCH_MEMORY_PASSES)):
                times: dict = {"prefetch": [], "sync": []}
                for mode in PREFETCH_TURNS:
                    out, wall = _stream_embed(source, emb, mode, device)
                    check(out.shape == (passes * n, ref.shape[1]) and torch.equal(out, ref.repeat(passes, 1)),
                          f"{label} {mode}: the embeddings differ from those of the rows uploaded whole")
                    times[mode].append(passes * n / wall)
                r[f"images_per_s_{label}"] = times
            r["flash_attn_fwd_launches"] = 0
            if device == "cuda":
                for source, label in ((url, "plane"), (host, "memory")):
                    out, t, launches = _profiled_stream(source, host[:2], emb, device,
                                                        os.path.join(root, f"{label}-trace.json"))
                    r["flash_attn_fwd_launches"] += launches
                    check(torch.equal(out, ref), f"the profiled {label} run's embeddings differ from the whole upload's")
                    check(t["copies"] == PREFETCH_BATCHES and t["kinds"] == ["Memcpy HtoD (Pinned -> Device)"],
                          f"the {label} batches' copies in the trace: {t['copies']} of {t['kinds']}, expected "
                          f"{PREFETCH_BATCHES} pinned; {t['flash_events']} flash_attn events beside them; "
                          f"host-to-device copies seen: {t['htod_sample']}")
                    check(t["flash_streams"] and not set(t["copy_streams"]) & set(t["flash_streams"]),
                          f"{label}: copies on streams {t['copy_streams']}, flash_attn kernels on {t['flash_streams']}")
                    r[f"trace_{label}"] = t
            depth = PREFETCH_VIT.get("depth", VIT_DEPTH)
            want = 2 * depth * PREFETCH_BATCHES if device == "cuda" else 0
            check(r["flash_attn_fwd_launches"] == want,
                  f"{r['flash_attn_fwd_launches']} flash_attn_fwd launches on the two prefetch runs, expected {want}")
        finally:
            loop.run(server.stop())
            loop.close()
    med = {(label, k): statistics.median(v) for label in ("plane", "memory")
           for k, v in r[f"images_per_s_{label}"].items()}
    share = {label: r.get(f"trace_{label}", {}).get("overlap_share") for label in ("plane", "memory")}
    for label, what in (("plane", "from the datasets plane by ZarrBatchLoader"),
                        ("memory", "from host memory by prefetch_to_device")):
        t = r.get(f"trace_{label}", {})
        print(f"[{card}] prefetch: {n} 224^2 RGB crops ({PREFETCH_BATCHES} batches of {BUCKET}) streamed {what} "
              f"(prefetch_batches={PREFETCH_DEPTH}) and embedded by ViT-B/14 (bf16): equal bit for bit to the rows "
              f"uploaded whole in every run; images/s in turns {json.dumps(r[f'images_per_s_{label}'])} (median "
              f"prefetch {med[label, 'prefetch']:.3f}, synchronous uploads {med[label, 'sync']:.3f}); the profiled "
              f"run's {t.get('copies')} batch copies are {t.get('kinds')} on streams {t.get('copy_streams')}, the "
              f"flash_attn kernels on {t.get('flash_streams')}; copy time {t.get('copy_us')} us, of it overlapping "
              f"kernels {t.get('overlap_us')} us (share {share[label]})")
    print(f"[{card}] prefetch: flash_attn_fwd launches {r['flash_attn_fwd_launches']} on the two profiled runs "
          f"(their active steps)")
    r["phase_s"] = time.perf_counter() - t_phase
    out = {"card": card, "images_per_s": {f"{a}_{b}": v for (a, b), v in med.items()},
           "copy_overlap_share": share, "flash_attn_fwd_launches": r["flash_attn_fwd_launches"], "detail": r}
    print(f"[{card}] prefetch phase: {r['phase_s']:.3f} s")
    print("prefetch " + json.dumps(out, default=str))
    return out


def _state_on_host(state: TrainState) -> dict:
    """Parameters, AdamW moments and step, copied to the host."""
    opt = state.optimizer.state_dict()
    return {"step": state.step,
            "module": {k: v.detach().cpu().clone() for k, v in state.module.state_dict().items()},
            "moments": {i: {k: v.detach().cpu().clone() for k, v in s.items()} for i, s in opt["state"].items()}}


def _states_equal(a: dict, b: dict) -> bool:
    return (a["step"] == b["step"] and a["module"].keys() == b["module"].keys()
            and all(torch.equal(a["module"][k], b["module"][k]) for k in a["module"])
            and a["moments"].keys() == b["moments"].keys()
            and all(a["moments"][i].keys() == b["moments"][i].keys()
                    and all(torch.equal(a["moments"][i][k], b["moments"][i][k]) for k in a["moments"][i])
                    for i in a["moments"]))


def phase_checkpoints(card: str, device: str = "cuda") -> dict:
    """Slice 13: ``CheckpointService`` over a ``CellposeNet`` train state
    at the registry's default width on the card. One ``checkpoints`` JSON
    line."""
    t_phase = time.perf_counter()
    n = CELLPOSE_CFG["batch_size"]
    images, masks = synthetic_cell_fields(n, CELLPOSE_FIELD, CELLPOSE_CELLS, SEED + 13)
    base = _train_batch(images, masks, n, CELLPOSE_CFG["tile"], device)
    batches = [[torch.roll(t, i, 0) for t in base] for i in range(CKPT_STEPS)]  # the fields in turn
    cfg = CellposeConfig(features=CELLPOSE_FEATURES)
    step = make_train_step()
    r: dict = {}
    launches0 = attention.launch_count
    deterministic = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
            _, state = create_model_and_state(cfg, seed=SEED, device=device)
            with CheckpointService(os.path.join(root, "every-step"), max_to_keep=CKPT_KEEP) as ckpt:
                for i in range(CKPT_STEPS):
                    check(ckpt.save(i, state), f"save {i} was skipped")
                    if i == CKPT_STEPS - 1:
                        at_last_save = _state_on_host(state)
                    step(state, *batches[i])
                ckpt.wait()
                uninterrupted = _state_on_host(state)
                r["steps"] = ckpt.steps()
                check(r["steps"] == list(range(CKPT_STEPS - CKPT_KEEP, CKPT_STEPS)),
                      f"steps() {r['steps']} after {CKPT_STEPS} saves with max_to_keep={CKPT_KEEP}")
                _, fresh = create_model_and_state(cfg, seed=SEED + 1, device=device)
                restored = ckpt.restore_latest(fresh)
            where = {str(p.device) for p in restored.module.parameters()} | {
                str(v.device) for s in restored.optimizer.state.values() for k, v in s.items() if k != "step"}
            check(where == {str(torch.device(device, 0) if device == "cuda" else device)},
                  f"restored tensors on {where}")
            check(_states_equal(_state_on_host(restored), at_last_save),
                  f"the state restored from step {CKPT_STEPS - 1} differs from the state saved there")
            step(restored, *batches[CKPT_STEPS - 1])
            check(_states_equal(_state_on_host(restored), uninterrupted),
                  f"the step after the restore differs from the uninterrupted step {CKPT_STEPS}")
            # a save followed at once by a step, before the write is done
            with CheckpointService(os.path.join(root, "save-then-step")) as ckpt:
                at_save = _state_on_host(state)
                ckpt.save(state.step, state)
                step(state, *batches[0])
                ckpt.wait()
                _, fresh = create_model_and_state(cfg, seed=SEED + 2, device=device)
                check(_states_equal(_state_on_host(ckpt.restore_latest(fresh)), at_save),
                      "a step taken right after save changed the checkpoint")
                # timed saves: the host return of save, and its commit
                save_ms, commit_ms = [], []
                for j in range(CKPT_TIMED_SAVES):
                    _sync(device)
                    t0 = time.perf_counter()
                    ckpt.save(state.step + 1 + j, state)
                    save_ms.append((time.perf_counter() - t0) * 1e3)
                    ckpt.wait()
                    commit_ms.append((time.perf_counter() - t0) * 1e3)
                r["bytes"] = os.path.getsize(os.path.join(root, "save-then-step", str(ckpt.latest_step()),
                                                          "state.pt"))
            r["save_ms"], r["commit_ms"] = save_ms, commit_ms
            r["n_params"] = sum(p.numel() for p in state.module.parameters())
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
    r["flash_attn_fwd_launches"] = attention.launch_count - launches0
    check(r["flash_attn_fwd_launches"] == 0, f"{r['flash_attn_fwd_launches']} flash launches training CellposeNet")
    r["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] checkpoints: CellposeNet {CELLPOSE_FEATURES} ({r['n_params']} parameters) train state on "
          f"{device}, saved before each of {CKPT_STEPS} steps ({n} x {CELLPOSE_CFG['tile']}^2, cuDNN deterministic) "
          f"with max_to_keep={CKPT_KEEP}: steps() {r['steps']}; restore_latest onto a fresh state equals the "
          f"parameters and AdamW moments at step {CKPT_STEPS - 1} bit for bit, and the step after it the "
          f"uninterrupted step {CKPT_STEPS}; a step right after save leaves the checkpoint as saved; save returns "
          f"in {[round(x, 3) for x in save_ms]} ms, committed in {[round(x, 3) for x in commit_ms]} ms, "
          f"{r['bytes']} B a step")
    out = {"card": card, "save_ms": statistics.median(save_ms), "commit_ms": statistics.median(commit_ms),
           "bytes": r["bytes"], "flash_attn_fwd_launches": r["flash_attn_fwd_launches"], "detail": r}
    print(f"[{card}] checkpoints phase: {r['phase_s']:.3f} s")
    print("checkpoints " + json.dumps(out, default=str))
    return out


# ---- slice 14: data parallelism -----------------------------------------------

DP_UNET_FEATURES = UNET2D_FEATURES  # the registry's default, bf16
DP_DIRECT = (8, 512)  # a direct request of 8 x 512^2
DP_TILED = 2048  # a tiled request: 25 tiles of 512 at overlap 64
DP_VIT = {"depth": VIT_DEPTH}  # ViT-B/14 at full width, bf16, bucket BUCKET
DP_CELLPOSE_FEATURES = CELLPOSE_FEATURES
DP_STEPS_DP1 = 3  # CellposeNet steps at dp = 1, bit for bit the single-device step
DP_STEPS = 5  # CellposeNet steps at the stacked dp = 2, a save and restore among them
DP_SAVE_AT = 3
DP_REPEATS = 5  # timed requests, bucket forwards and steps per reading
# the stacked dp = 2 mesh runs each shard at half the batch, so cuDNN and
# cuBLAS may pick other algorithms than at the whole batch: its engine is
# held to phase_model_runner's bf16 bound (MR_BF16_VS_F32 of the largest
# output), its embeddings to phase_main_path's min cosine, its losses to
# the bf16 tolerance of the kernel checks, relative
DP_EMBED_MIN_COS = 0.999
DP_LOSS_RTOL = TOLERANCE[torch.bfloat16][0]


def _dp_requests(engine, direct: np.ndarray, tiled: np.ndarray, device: str) -> tuple[dict, dict]:
    """The engine's outputs for the direct and the tiled request, and the
    host ms of each (mean of DP_REPEATS after the first call)."""
    outs, ms = {}, {}
    for key, x in (("direct", direct), ("tiled", tiled)):
        outs[key] = engine.predict(x)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(DP_REPEATS):
            engine.predict(x)
        _sync(device)
        ms[key] = (time.perf_counter() - t0) * 1e3 / DP_REPEATS
    return outs, ms


TRACE_RANGE = "chip_smoke.traced_call"  # the record_function range around a traced call
TRACE_GUARD_S = 0.05  # idle host time between a traced call and the trace window's edges


def _dp_trace_flash(card: str, fn, device: str, path: str) -> int:
    """``flash_attn`` kernels that one call of ``fn`` launched, read from a
    ``torch.profiler`` trace: the active step of a schedule whose warm-up
    step runs ``fn`` once before (a trace misses kernels that start right at
    the profiler's start). The call runs inside ``TRACE_RANGE``, apart from
    the window's edges by ``TRACE_GUARD_S`` on each side, and a kernel
    counts only where the runtime call that launched it (its
    ``correlation``) ran on this thread inside that range. A count of the
    window's kernels alone took in one of the warm-up call's kernels, or
    left out one of the traced call's, in some runs on the H100 (49 of 48,
    23 of 24)."""
    if device != "cuda":
        return 0
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
        on_trace_ready=lambda p: p.export_chrome_trace(path),
    ) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_GUARD_S)
        prof.step()
        time.sleep(TRACE_GUARD_S)
        with torch.profiler.record_function(TRACE_RANGE):
            fn()
            torch.cuda.synchronize()
        time.sleep(TRACE_GUARD_S)
        prof.step()
    with open(path) as f:
        return _kernels_launched_in(json.load(f).get("traceEvents", []), TRACE_RANGE, "flash_attn")


def _kernels_launched_in(events: list, range_name: str, kernel: str) -> int:
    """Kernel events named like ``kernel`` whose launching runtime call
    (matched by ``correlation``) lies inside a ``range_name`` range, on that
    range's thread."""
    ranges = [(e.get("tid"), e["ts"], e["ts"] + e.get("dur", 0)) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") == range_name]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})
                and any(e.get("tid") == tid and a <= e["ts"] <= b for tid, a, b in ranges)}
    return sum(1 for e in events if e.get("cat") == "kernel" and kernel in e.get("name", "")
               and e.get("args", {}).get("correlation") in launched)


def _replicas_equal(state) -> bool:
    first = list(state.replicas[0].parameters())
    return all(torch.equal(a, b) for r in state.replicas[1:] for a, b in zip(first, r.parameters()))


def phase_data_parallel(card: str, device: str = "cuda") -> dict:
    """Slice 14: the parallel layer's data parallelism through the entry
    points, at full width: (a) dp = 1 through the mesh code on the card,
    bit for bit the single-device path, for the UNet2D engine, the ViT-B/14
    embedder and CellposeNet steps; (b) a stacked dp = 2 mesh [cuda:0,
    cuda:0] from an explicit ``make_mesh``, each shard a replica of its
    own, against (a); (c) lease resolution on this machine's cards. One
    ``data_parallel`` JSON line."""
    t_phase = time.perf_counter()
    dev0 = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    mesh1 = make_mesh({"dp": 1}, [dev0])
    mesh2 = make_mesh({"dp": 2}, [dev0, dev0])
    rng = np.random.default_rng(SEED + 14)
    r: dict = {"mesh1": mesh1.shape, "mesh2": mesh2.shape}
    deterministic = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    attention.launch_count = 0
    try:
        # -- the UNet2D engine: a direct 8 x 512^2 and a tiled 2048^2 request
        unet = UNet2D(features=DP_UNET_FEATURES)
        unet.reset_parameters(SEED)
        n, size = DP_DIRECT
        direct = rng.standard_normal((n, size, size, 1), np.float32)
        tiled = rng.standard_normal((1, DP_TILED, DP_TILED, 1), np.float32)
        engines = {
            "single": InferenceEngine("dp-unet", unet, divisor=unet.divisor, cache=CompiledProgramCache(),
                                      device=device),
            "dp1": InferenceEngine("dp-unet", unet, divisor=unet.divisor, cache=CompiledProgramCache(),
                                   devices=mesh1.devices),
            "dp2": InferenceEngine("dp-unet", unet, divisor=unet.divisor, cache=CompiledProgramCache(),
                                   devices=mesh2.devices),
        }
        unet_out, unet_ms = {}, {}
        try:
            for key, engine in engines.items():
                unet_out[key], unet_ms[key] = _dp_requests(engine, direct, tiled, device)
            check(engines["dp2"].mesh_shape == {"dp": 2} and engines["dp1"].mesh_shape is None,
                  f"engine meshes {engines['dp2'].mesh_shape}, {engines['dp1'].mesh_shape}")
            programs = sorted(k[1] for k in engines["dp2"].cache.keys())
            cfg = engines["dp2"].config
            n_tiles = len(_tile_starts(DP_TILED, cfg.tile, cfg.tile_overlap)) ** 2
            chunks = [min(cfg.tile_batch, n_tiles - i) for i in range(0, n_tiles, cfg.tile_batch)]
            want = sorted({bucket_batch(b, multiple_of=2) for b in [n, *chunks]})
            check(programs == want, f"the dp = 2 engine's batch buckets {programs}, expected {want}")
            r["unet_dp2_programs"] = programs
        finally:
            for engine in engines.values():
                engine.close()
        for key in ("direct", "tiled"):
            ref = unet_out["single"][key]
            check(np.array_equal(unet_out["dp1"][key], ref), f"UNet {key}: dp = 1 through the mesh differs from "
                  f"the single-device engine by {np.abs(unet_out['dp1'][key] - ref).max()}")
            err = float(np.abs(unet_out["dp2"][key] - ref).max())
            bound = MR_BF16_VS_F32 * float(np.abs(ref).max())
            check(unet_out["dp2"][key].shape == ref.shape and err <= bound,
                  f"UNet {key}: stacked dp = 2 vs one device max abs {err} over {bound}")
            r[f"unet_{key}_dp2_err"], r[f"unet_{key}_bound"] = err, bound
        r["unet_ms"] = unet_ms
        print(f"[{card}] data parallel: UNet2D {DP_UNET_FEATURES} bf16, {n} x {size}^2 direct and {DP_TILED}^2 "
              f"tiled (512/64): dp = 1 through the mesh equal to the single-device engine bit for bit; stacked "
              f"dp = 2 [{dev0}, {dev0}] max abs {r['unet_direct_dp2_err']:.4g} direct, "
              f"{r['unet_tiled_dp2_err']:.4g} tiled (bounds {r['unet_direct_bound']:.4g}, "
              f"{r['unet_tiled_bound']:.4g}); ms per request (host, mean of {DP_REPEATS}) " + json.dumps(
                  {k: {q: round(v, 3) for q, v in ms.items()} for k, ms in unet_ms.items()}))

        # -- the ViT-B/14 embedder, a bucket of BUCKET rows
        x = model_input(torch.from_numpy(rng.integers(0, 256, (BUCKET, 224, 224, 3), dtype=np.uint8)).to(dev0))
        embedders = {
            "single": ViTEmbedder(device=device, seed=SEED, batch_bucket=BUCKET, model_overrides=DP_VIT),
            "dp1": ViTEmbedder(devices=mesh1.devices, seed=SEED, batch_bucket=BUCKET, model_overrides=DP_VIT),
            "dp2": ViTEmbedder(devices=mesh2.devices, seed=SEED, batch_bucket=BUCKET, model_overrides=DP_VIT),
        }
        emb, per_forward, images_per_s = {}, {}, {}
        for key, e in embedders.items():
            emb[key] = e.embed_tensor(x)
            before = attention.launch_count
            e.embed_tensor(x)
            per_forward[key] = attention.launch_count - before
            images_per_s[key] = BUCKET / (_device_ms(device, lambda: e.embed_tensor(x), iters=DP_REPEATS) / 1e3)
        check(embedders["dp2"].dp == 2 and len(embedders["dp2"]._replicas) == 2, "the stacked embedder's dp")
        depth = DP_VIT.get("depth", VIT_DEPTH)
        want = {"single": depth, "dp1": depth, "dp2": 2 * depth} if device == "cuda" else dict.fromkeys(emb, 0)
        check(per_forward == want, f"flash_attn_fwd launches per bucket forward {per_forward}, expected {want}")
        check(torch.equal(emb["dp1"], emb["single"]), "ViT: dp = 1 through the mesh differs from one device")
        cos = float((emb["dp2"].float() * emb["single"].float()).sum(-1).min())
        check(emb["dp2"].shape == emb["single"].shape and cos >= DP_EMBED_MIN_COS,
              f"ViT: stacked dp = 2 min cosine {cos} to one device, bound {DP_EMBED_MIN_COS}")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as root:
            traced = _dp_trace_flash(card, lambda: embedders["dp2"].embed_tensor(x), device,
                                     os.path.join(root, "dp2-forward.json"))
        check(traced == want["dp2"], f"{traced} flash_attn kernel events in the trace of one stacked dp = 2 "
              f"bucket forward, expected {want['dp2']}")
        r.update(vit_launches_per_forward=per_forward, vit_traced_flash_events=traced, vit_dp2_min_cos=cos,
                 vit_images_per_s=images_per_s)
        del embedders
        print(f"[{card}] data parallel: ViT-B/14 bf16, bucket {BUCKET}: dp = 1 through the mesh equal to one "
              f"device bit for bit; stacked dp = 2 min cosine {cos:.6f} (bound {DP_EMBED_MIN_COS}); flash_attn_fwd "
              f"launches per bucket forward {per_forward}, {traced} flash_attn kernels in the profiler trace of "
              f"one stacked forward; images/s (CUDA events, {DP_REPEATS} forwards) "
              f"{json.dumps({k: round(v, 3) for k, v in images_per_s.items()})}")

        # -- CellposeNet steps, 8 x 256^2
        cfg = CellposeConfig(features=DP_CELLPOSE_FEATURES)
        nb, tile = CELLPOSE_CFG["batch_size"], CELLPOSE_CFG["tile"]
        # images and cell probabilities of synthetic fields; the flow
        # targets are drawn from the phase's seed (this step parity needs
        # no masks_to_flows, which raises on a one-pixel instance: ROADMAP C1)
        images, masks = synthetic_cell_fields(nb, CELLPOSE_FIELD, CELLPOSE_CELLS, SEED + 14)
        bi = np.ascontiguousarray(CellposeFinetune._prepare_images(list(images))[:, :tile, :tile])
        bf = rng.uniform(-1, 1, (nb, tile, tile, 2)).astype(np.float32)
        bp = (masks[:, :tile, :tile] > 0).astype(np.float32)
        host_batches = [[np.roll(a, i, 0) for a in (bi, bf, bp)] for i in range(DP_STEPS)]
        batches = [[torch.from_numpy(a).to(dev0) for a in hb] for hb in host_batches]
        # the dp = 2 steps take their batches from the prefetch, placed over
        # the mesh (pinned staging and a copy stream per device)
        streamed = prefetch_to_device(iter(host_batches), size=2, sharding=sharding(mesh2, "dp"))
        _, single = create_model_and_state(cfg, seed=SEED, device=device)
        single_step = make_train_step()
        _, s1 = create_model_and_state(cfg, seed=SEED, device=device)
        dp1, dp1_step = replicate(mesh1, s1), data_parallel_step(make_train_step(), mesh1)
        _, s2 = create_model_and_state(cfg, seed=SEED, device=device)
        dp2, dp2_step = replicate(mesh2, s2), data_parallel_step(make_train_step(), mesh2)
        losses: dict = {"single": [], "dp1": [], "dp2": []}
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_ckpt_") as root, \
                CheckpointService(os.path.join(root, "dp2")) as ckpt:
            for i in range(DP_STEPS):
                losses["single"].append(float(single_step(single, *batches[i])[1]["loss"]))
                if i < DP_STEPS_DP1:
                    losses["dp1"].append(float(dp1_step(dp1, *batches[i])[1]["loss"]))
                    check(losses["dp1"][i] == losses["single"][i] and all(
                        torch.equal(a, b) for a, b in zip(single.module.parameters(), dp1.module.parameters())),
                        f"CellposeNet step {i + 1}: dp = 1 through the mesh differs from the single step")
                if i == DP_SAVE_AT:
                    check(ckpt.save(dp2.step, dp2), "the dp state's save was skipped")
                    saved = _state_on_host(dp2)
                placed = next(streamed)
                check(all(isinstance(leaf, Shards) and all(torch.equal(a, b) for a, b in zip(leaf, ref))
                          for leaf, ref in zip(placed, shard_batch(mesh2, batches[i]))),
                      f"CellposeNet step {i + 1}: the prefetched batch differs from shard_batch's")
                losses["dp2"].append(float(dp2_step(dp2, *placed)[1]["loss"]))
                check(_replicas_equal(dp2), f"CellposeNet step {i + 1}: the dp = 2 replicas differ")
                rel = abs(losses["dp2"][i] - losses["single"][i]) / abs(losses["single"][i])
                check(np.isfinite(losses["dp2"][i]) and rel <= DP_LOSS_RTOL,
                      f"CellposeNet step {i + 1}: stacked dp = 2 loss {losses['dp2'][i]} vs one device "
                      f"{losses['single'][i]} (rel {rel}, bound {DP_LOSS_RTOL})")
            _, fresh = create_model_and_state(cfg, seed=SEED + 1, device=device)
            restored = ckpt.restore(DP_SAVE_AT, replicate(mesh2, fresh))
            check(_states_equal(_state_on_host(restored), saved) and _replicas_equal(restored),
                  f"the dp = 2 state restored from step {DP_SAVE_AT} differs from the state saved there")
        r["step_losses"] = losses
        r["step_loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(losses["dp2"], losses["single"]))
        step_ms = {
            "single": _device_ms(device, lambda: single_step(single, *batches[0]), iters=DP_REPEATS),
            "dp1": _device_ms(device, lambda: dp1_step(dp1, *batches[0]), iters=DP_REPEATS),
            "dp2": _device_ms(device, lambda: dp2_step(dp2, *batches[0]), iters=DP_REPEATS),
        }
        r["step_ms"] = step_ms
        print(f"[{card}] data parallel: CellposeNet {DP_CELLPOSE_FEATURES} bf16, {nb} x {tile}^2 (cuDNN "
              f"deterministic): {DP_STEPS_DP1} steps at dp = 1 through the mesh equal to the single-device step "
              f"bit for bit; {DP_STEPS} stacked dp = 2 steps, losses {losses['dp2']} against {losses['single']} "
              f"(max rel {r['step_loss_rel']:.3g}, bound {DP_LOSS_RTOL}), the replicas equal bit for bit after "
              f"every step, their batches streamed by prefetch_to_device(sharding=) equal to shard_batch's; a "
              f"CheckpointService save at step {DP_SAVE_AT} restored onto a fresh dp = 2 state bit "
              f"for bit, AdamW moments included, every replica filled; ms per step (CUDA events, {DP_REPEATS} "
              f"steps) {json.dumps({k: round(v, 3) for k, v in step_ms.items()})}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
    launches = attention.launch_count

    # -- lease resolution on this machine
    if device == "cuda":
        check(resolve_devices([0], "cuda") == [torch.device("cuda", 0)], "resolve_devices([0], 'cuda')")
        if torch.cuda.device_count() == 1:
            try:
                got = resolve_devices([0, 1], "cuda")
            except ValueError as e:
                r["two_id_lease"] = f"refused: {e}"
            else:
                raise SmokeFailure(f"resolve_devices([0, 1], 'cuda') gave {got} on a one-card machine")
        else:
            got = resolve_devices([0, 1], "cuda")
            check(got == [torch.device("cuda", 0), torch.device("cuda", 1)], f"a two-card lease {got}")
            r["two_id_lease"] = [str(d) for d in got]
        print(f"[{card}] data parallel: resolve_devices([0], 'cuda') -> [cuda:0]; [0, 1] on "
              f"{torch.cuda.device_count()} card(s): {r['two_id_lease']}")
    r["flash_attn_fwd_launches"] = launches
    r["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] data parallel: flash_attn_fwd launches {launches} on the path")
    print(f"[{card}] data parallel phase: {r['phase_s']:.3f} s")
    out = {"card": card, "flash_attn_fwd_launches": launches, "unet_ms": r["unet_ms"],
           "vit_images_per_s": r["vit_images_per_s"], "step_ms": r["step_ms"], "detail": r}
    print("data_parallel " + json.dumps(out, default=str))
    return out


# ---- slice 15: the rest of the parallel layer ---------------------------------------
PL_DECODE_PROMPTS = (5, 12, 23, 31, 40, 57, 64, 90)  # 8 concurrent sequences, mixed prompt lengths
PL_DECODE_NEW = 24  # new tokens each
PL_DECODE_LOGITS_TOL = 1e-5  # stacked dp = 2 step logits against dp = 1
PL_VIT = {"depth": VIT_DEPTH}  # ViT-B/14 bf16 at full width, a bucket of BUCKET
PL_TP_MIN_COS = DP_EMBED_MIN_COS
PL_SHARD_FRACTION = 0.6
PL_UNET_FEATURES = UNET2D_FEATURES  # CONV_TP_RULES over UNet2D, bf16
PL_UNET_DIRECT = (8, 512)
PL_UNET3D_FEATURES = UNET3D_FEATURES
PL_VOLUME = VOLUME  # the model-runner's volume, depth-split over sp = 2
PL_HALO = 16  # >= UNet3D (16, 32, 64)'s receptive radius in depth at z strides (1, 2): 14 slices
PL_SPATIAL_DEF_TOL = 1e-3  # against the haloed blocks built on the host, share of max |ref|
PL_STACK_FEATURES = 64  # the f32 three-layer 3x3x3 conv + SiLU stack
PL_STACK_RADIUS = 3
PL_STACK_TOL = 1e-4
PL_RING_VIT = {"depth": VIT_DEPTH}  # ViT-B/14 f32 (TF32 off) at 518^2: 37^2 + 1 = 1370 tokens
PL_RING_SIZE = 518
PL_RING_BUCKET = 8
PL_RING_TOL = 1e-4
PL_KNN_QUERIES = 64
PL_KNN_K = 10
PL_KNN_SCORE_TOL = 2.0 ** -8  # bf16 resolution at unit scores
PL_REPEATS = 3
# slice 18: tp = 8 on ViT-B/14's 12 heads (2 or 1 a shard), a UNet2D with
# its convolutions split on their input channels (row parallel), and train
# steps over meshes with axes besides the batch's
PL_TP8 = 8
PL_LAYOUT_FEATURES = UNET2D_FEATURES  # f32 (TF32 off), held to one device at PL_STACK_TOL
PL_LAYOUT_DIRECT = (4, 512)
PL_LAYOUT_RULES = [(r"Conv_\d+\.weight$", P(None, "tp"))]
PL_TRAIN_MESHES = (("cellpose", {"dp": 2, "tp": 2}), ("stardist", {"dp": 2, "tp": 2}),
                   ("stardist", {"dp": 2, "sp": 2}))
PL_TRAIN_STEPS = 2  # steps of each train leg, each against one device's at DP_LOSS_RTOL
# the first step's summed gradients (of the same seeded weights) against
# one device's, per tensor (min cosine, max relative L2; _grad_agreement):
# a step that summed a part of the dp gradients misses them by far more
# than the loss shows (half of them: relative L2 0.59, the loss 2e-5).
# Later steps' weights differ by AdamW's rounding, which moves near-zero
# gradients (a GroupNorm bias) by percents. The bounds sit 8-10x above
# the H100's readings (min cosine 1 - 3.2e-6, max relative L2 0.0026;
# PERF.md section 6)
PL_TRAIN_GRAD_BOUNDS = (0.99997, 0.02)


def _entry_step_logits(engine: DecodeEngine, ids: list, toks: list) -> np.ndarray:
    """One co-batch step's logits in the caller's row order, the engine's
    step stopped before its KV writes (rows grouped by the entry each
    sequence is pinned to)."""
    rows: dict = {}
    for r, sid in enumerate(ids):
        rows.setdefault(engine._entry_of(sid), []).append(r)
    out = np.empty((len(ids), engine.config.vocab), np.float32)
    for e, rs in sorted(rows.items()):
        with engine._device_scope(e):
            (logits, _, _), _, _ = engine._launch_step(e, [ids[r] for r in rs], [toks[r] for r in rs])
            out[rs] = logits[: len(rs)].cpu().numpy()
    return out


async def _pl_decode_loop(engine: DecodeEngine, prompts: list) -> tuple[list, float]:
    loop = DecodeLoop(engine, name="smoke-pl", max_active=len(prompts), interactive_reserve=0)
    t0 = time.perf_counter()
    outs = await asyncio.gather(*[_drain_timed(loop.submit(p, PL_DECODE_NEW, klass="bulk")) for p in prompts])
    wall = time.perf_counter() - t0
    await loop.close()
    toks = [o["tokens"] for o in outs]
    return toks, sum(len(t) for t in toks) / wall


def _pl_decode(card: str, device: str, dev0: torch.device, fx: dict) -> dict:
    r: dict = {}
    golden = fx["greedy_tokens"].tolist()
    for key, devices in (("dp1", [dev0]), ("dp2", [dev0, dev0])):
        engine = DecodeEngine(model_id=f"pl-golden-{key}", devices=devices, mesh_axes={"dp": -1},
                              cache=CompiledProgramCache())
        toks = [engine.prefill("golden", [int(t) for t in fx["prompt"]])]
        while len(toks) < len(golden):
            toks.extend(engine.step(["golden"], [toks[-1]]))
        engine.finish("golden")
        check(toks == golden, f"golden decoder at {key}: {toks} != the fixture's {golden}")
        check(engine.kv.stats["blocks_in_use"] == 0, f"golden decoder at {key}: kv not drained")
        engine.close()
    params = init_decoder_params(SEED, DECODE_WIDE)
    rng = np.random.default_rng(SEED + 15)
    prompts = [[int(t) for t in rng.integers(32, 127, n)] for n in PL_DECODE_PROMPTS]
    tokens, per_s, blocks, programs, logits = {}, {}, {}, {}, {}
    for key, devices in (("dp1", [dev0]), ("dp2", [dev0, dev0])):
        engine = DecodeEngine(model_id=f"pl-wide-{key}", params=params, config=DECODE_WIDE, devices=devices,
                              mesh_axes={"dp": -1}, cache=CompiledProgramCache(64))
        asyncio.run(_pl_decode_loop(engine, prompts))  # builds the buckets' programs
        tokens[key], per_s[key] = asyncio.run(_pl_decode_loop(engine, prompts))
        ids = [f"l{i}" for i in range(len(prompts))]
        first = [engine.prefill(sid, p) for sid, p in zip(ids, prompts)]
        blocks[key] = [p.stats["blocks_in_use"] for p in engine.pools]
        logits[key] = _entry_step_logits(engine, ids, first)
        for sid in ids:
            engine.finish(sid)
        drained = [p.stats["blocks_in_use"] for p in engine.pools]
        check(drained == [0] * len(devices), f"wide decoder at {key}: pools hold {drained} blocks after the runs")
        programs[key] = engine.describe()["programs"]
        engine.close()
    check(tokens["dp2"] == tokens["dp1"], "wide decoder: stacked dp = 2 tokens differ from dp = 1")
    err = float(np.abs(logits["dp2"] - logits["dp1"]).max())
    check(err <= PL_DECODE_LOGITS_TOL, f"wide decoder: step logits max abs {err} over {PL_DECODE_LOGITS_TOL}")
    check(sum(blocks["dp2"]) == sum(blocks["dp1"]) and min(blocks["dp2"]) > 0,
          f"wide decoder: blocks per device {blocks}")
    r.update(tokens_per_s=per_s, blocks_per_device=blocks, programs=programs, step_logits_err=err)
    print(f"[{card}] parallel layer decode: DecoderConfig() at dp = 1 through the mesh and stacked dp = 2 "
          f"[{dev0}, {dev0}] gives the fixture's {len(golden)} greedy tokens; {dataclasses.asdict(DECODE_WIDE)} "
          f"with {len(prompts)} concurrent sequences (prompts {list(PL_DECODE_PROMPTS)}, {PL_DECODE_NEW} new "
          f"tokens each) through DecodeLoop: stacked dp = 2 tokens equal dp = 1's bit for bit, step logits max "
          f"abs {err:.3g} (bound {PL_DECODE_LOGITS_TOL}), blocks per device after prefill {blocks}, every pool "
          f"drained to 0; tokens/s (host, warm) {json.dumps({k: round(v, 3) for k, v in per_s.items()})}; "
          f"programs {programs}")
    return r


def _min_cosine(a: np.ndarray, b: np.ndarray) -> float:
    """The least cosine between matching rows of ``a`` and ``b``."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    return float((np.sum(a * b, 1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)).min())


def _pl_tp(card: str, device: str, dev0: torch.device, rng) -> dict:
    r: dict = {}
    vit = ViT(attn_fn=attention.make_attn_fn(), **PL_VIT)
    vit.reset_parameters(SEED)
    x = rng.standard_normal((BUCKET, 224, 224, 3)).astype(np.float32)
    cfg = EngineConfig(ladder=(224,))
    meshes = {"single": dict(device=device), "tp2": dict(devices=[dev0] * 2, mesh_axes={"tp": 2}),
              "dp2tp2": dict(devices=[dev0] * 4, mesh_axes={"dp": 2, "tp": 2}),
              "tp8": dict(devices=[dev0] * PL_TP8, mesh_axes={"tp": PL_TP8})}
    engines = {k: InferenceEngine("pl-vit", vit, config=cfg, cache=CompiledProgramCache(),
                                  tp_rules=VIT_TP_RULES if k != "single" else None, **kw)
               for k, kw in meshes.items()}
    # a forward launches the kernel once a block on every tp shard holding
    # heads: at tp = 8, 12 heads split 2, 1, 2, 1, ... (slice 18)
    shards = {"tp2": 2, "dp2tp2": 4, "tp8": PL_TP8}
    depth = PL_VIT.get("depth", VIT_DEPTH)
    want = {k: n * depth if device == "cuda" else 0 for k, n in shards.items()}
    # a graph replay does not call the kernel's wrapper: building a shard's
    # program runs its forward GRAPH_WARMUP_ITERS times and captures it once
    want_build = {k: (GRAPH_WARMUP_ITERS + 1) * v for k, v in want.items()}
    emb, ms, eager_ms, per_forward, build, traced, replay_traced, fraction = {}, {}, {}, {}, {}, {}, {}, {}
    eager_cos, eager_vs_graph = {}, {}
    bucket = (BUCKET, 224, 224, 3)
    try:
        for key, engine in engines.items():
            before = attention.launch_count
            emb[key] = engine.predict(x)
            built = attention.launch_count - before
            t0 = time.perf_counter()
            for _ in range(PL_REPEATS):
                engine.predict(x)
            ms[key] = (time.perf_counter() - t0) * 1e3 / PL_REPEATS
            if key == "single":
                continue
            build[key] = built
            check(engine.mesh_shape == {"dp": engine.dp, "tp": engine.tp} and engine.dp * engine.tp == shards[key],
                  f"{key}: mesh {engine.mesh_shape}")
            fraction[key] = shard_fraction(engine.params)
            check(fraction[key] < PL_SHARD_FRACTION, f"{key}: shard_fraction {fraction[key]}")
            # the engine's eager programs, which a tp group across cards gets,
            # built on this stacked group (a CPU engine's program is eager)
            eager = (engine._capture_group(bucket, np.float32, eager=True) if device == "cuda"
                     else engine._program(bucket, np.float32))
            run_eager = lambda: engine._launch(eager, x)[0].result()  # noqa: E731
            before = attention.launch_count
            out = run_eager()
            per_forward[key] = attention.launch_count - before
            eager_vs_graph[key] = float(np.abs(out.astype(np.float32) - emb[key].astype(np.float32)).max())
            eager_cos[key] = _min_cosine(out, emb["single"])
            eager_ms[key] = _device_ms(device, run_eager, iters=PL_REPEATS)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_pl_") as root:
                replay_traced[key] = _dp_trace_flash(card, lambda: engine.predict(x), device,
                                                     os.path.join(root, f"{key}-replay.json"))
                traced[key] = _dp_trace_flash(card, run_eager, device, os.path.join(root, f"{key}-eager.json"))
    finally:
        for engine in engines.values():
            engine.close()
    check(build == want_build, f"flash_attn_fwd launches building the tp engines' graphs {build}, "
          f"expected {want_build}")
    check(replay_traced == want, f"flash_attn kernels in the traces of one engine.predict (graph replays) "
          f"{replay_traced}, expected {want}")
    check(per_forward == want, f"flash_attn_fwd launches per eager tp forward {per_forward}, expected {want}")
    check(traced == want, f"flash_attn kernels in the traces of one eager tp forward {traced}, expected {want}")
    for key, c in eager_cos.items():
        check(c >= PL_TP_MIN_COS, f"ViT {key} eager programs: min cosine {c} to one device, bound {PL_TP_MIN_COS}")
    cos = {}
    for key in shards:
        a, b = emb[key], emb["single"]
        cos[key] = _min_cosine(a, b)
        check(a.shape == b.shape and cos[key] >= PL_TP_MIN_COS,
              f"ViT {key}: min cosine {cos[key]} to one device, bound {PL_TP_MIN_COS}")
    images_per_s = {k: BUCKET / (v / 1e3) for k, v in ms.items()}
    r.update(vit_min_cos=cos, shard_fraction=fraction, build_launches=build, replay_traced=replay_traced,
             launches_per_forward=per_forward, traced=traced, eager_min_cos=eager_cos, eager_vs_graph=eager_vs_graph,
             vit_ms_per_request=ms, vit_eager_ms=eager_ms, vit_images_per_s=images_per_s)
    print(f"[{card}] parallel layer tp: ViT-B/14 bf16, bucket {BUCKET}, VIT_TP_RULES through InferenceEngine "
          f"at {{'tp': 2}} on [{dev0}] x 2, {{'dp': 2, 'tp': 2}} on [{dev0}] x 4 and {{'tp': {PL_TP8}}} on "
          f"[{dev0}] x {PL_TP8} (stacked; 12 heads at tp = {PL_TP8}: 2, 1, 2, 1, ... a shard): min cosine to one "
          f"device {json.dumps({k: round(v, 6) for k, v in cos.items()})} (bound {PL_TP_MIN_COS}); "
          f"shard_fraction {json.dumps({k: round(v, 4) for k, v in fraction.items()})} (bound "
          f"{PL_SHARD_FRACTION}); flash_attn_fwd launches building the graphs {build} ({GRAPH_WARMUP_ITERS} "
          f"warm-up forwards and a capture), flash_attn kernels in a profiler trace of one engine.predict (graph "
          f"replays) {replay_traced}; the engine's eager programs on the same group: launches per forward "
          f"{per_forward}, kernels in a trace of one {traced}, min cosine to one device "
          f"{json.dumps({k: round(v, 6) for k, v in eager_cos.items()})}, max abs to the graphs' output "
          f"{json.dumps(eager_vs_graph)}; ms per request (host, graph replays, mean of {PL_REPEATS}) "
          f"{json.dumps({k: round(v, 3) for k, v in ms.items()})}, eager ms per request (CUDA events) "
          f"{json.dumps({k: round(v, 3) for k, v in eager_ms.items()})}, "
          f"images/s {json.dumps({k: round(v, 3) for k, v in images_per_s.items()})}")

    unet = UNet2D(features=PL_UNET_FEATURES)
    unet.reset_parameters(SEED)
    n, size = PL_UNET_DIRECT
    direct = rng.standard_normal((n, size, size, 1), np.float32)
    single = InferenceEngine("pl-unet", unet, divisor=unet.divisor, cache=CompiledProgramCache(), device=device)
    tp2 = InferenceEngine("pl-unet", unet, divisor=unet.divisor, cache=CompiledProgramCache(),
                          devices=[dev0] * 2, mesh_axes={"tp": 2}, tp_rules=CONV_TP_RULES)
    out, unet_ms = {}, {}
    try:
        for key, engine in (("single", single), ("tp2", tp2)):
            out[key] = engine.predict(direct)
            t0 = time.perf_counter()
            for _ in range(PL_REPEATS):
                engine.predict(direct)
            unet_ms[key] = (time.perf_counter() - t0) * 1e3 / PL_REPEATS
        unet_fraction = shard_fraction(tp2.params)
    finally:
        single.close()
        tp2.close()
    err = float(np.abs(out["tp2"] - out["single"]).max())
    bound = MR_BF16_VS_F32 * float(np.abs(out["single"]).max())
    check(out["tp2"].shape == out["single"].shape and err <= bound,
          f"UNet2D CONV_TP_RULES tp = 2: max abs {err} to one device over {bound}")
    r.update(unet_err=err, unet_bound=bound, unet_ms=unet_ms, unet_shard_fraction=unet_fraction)
    print(f"[{card}] parallel layer tp: UNet2D {PL_UNET_FEATURES} bf16 with CONV_TP_RULES at tp = 2 (stacked), "
          f"{n} x {size}^2: max abs {err:.4g} to one device (bound {bound:.4g}, phase 7's bf16 share of the "
          f"output's range); shard_fraction {unet_fraction:.4f}; ms per request (host, mean of {PL_REPEATS}) "
          f"{json.dumps({k: round(v, 3) for k, v in unet_ms.items()})}")
    return r


class _ConvStack(torch.nn.Module):
    """Three 3x3x3 convolutions, each followed by SiLU, f32, channels-last
    (B, D, H, W, C) in and out."""

    def __init__(self, features: int):
        super().__init__()
        from bioengine_tpu_torch.models.unet import Conv, reset_flax_scales

        self.convs = torch.nn.ModuleList(
            Conv(cin, features, (3, 3, 3), torch.float32) for cin in (1, features, features))
        reset_flax_scales(self, SEED)

    def forward(self, x):
        y = x.movedim(-1, 1)
        for conv in self.convs:
            y = F.silu(conv(y))
        return y.movedim(1, -1)


def _pl_layout(card: str, device: str, dev0: torch.device, rng) -> dict:
    """UNet2D in f32 with every convolution split on its input channels
    (row parallel: each shard convolves its channels, the partials summed
    in shard order, the bias once) through InferenceEngine at tp = 2."""
    unet = UNet2D(features=PL_LAYOUT_FEATURES, dtype=torch.float32)
    unet.reset_parameters(SEED)
    n, size = PL_LAYOUT_DIRECT
    x = rng.standard_normal((n, size, size, 1), np.float32)
    single = InferenceEngine("pl-unet-rows", unet, divisor=unet.divisor, cache=CompiledProgramCache(), device=device)
    rows = InferenceEngine("pl-unet-rows", unet, divisor=unet.divisor, cache=CompiledProgramCache(),
                           devices=[dev0] * 2, mesh_axes={"tp": 2}, tp_rules=PL_LAYOUT_RULES)
    out, ms = {}, {}
    try:
        row_split = sorted(k for k, leaf in rows.params.items() if isinstance(leaf, Shards) and leaf.dim == 1)
        check(len(row_split) > 0 and all(k.endswith("weight") for k in row_split),
              f"the input-channel rule split {row_split}")
        for key, engine in (("single", single), ("tp2_rows", rows)):
            out[key] = engine.predict(x)
            t0 = time.perf_counter()
            for _ in range(PL_REPEATS):
                engine.predict(x)
            ms[key] = (time.perf_counter() - t0) * 1e3 / PL_REPEATS
    finally:
        single.close()
        rows.close()
    err = float(np.abs(out["tp2_rows"] - out["single"]).max())
    check(out["tp2_rows"].shape == out["single"].shape and err <= PL_STACK_TOL,
          f"UNet2D f32 with its convolutions split on input channels at tp = 2: max abs {err} to one device "
          f"over {PL_STACK_TOL}")
    print(f"[{card}] parallel layer rule layout: UNet2D {PL_LAYOUT_FEATURES} f32 (TF32 off), {n} x {size}^2, "
          f"rules {[(r, tuple(spec)) for r, spec in PL_LAYOUT_RULES]} ({len(row_split)} convolutions row "
          f"parallel, the 1-channel input conv whole) at tp = 2 (stacked): max abs {err:.4g} to one device "
          f"(bound {PL_STACK_TOL}); ms per request (host, graph replays, mean of {PL_REPEATS}) "
          f"{json.dumps({k: round(v, 3) for k, v in ms.items()})}")
    return {"err": err, "bound": PL_STACK_TOL, "row_split": len(row_split), "ms": ms}


def _pl_train(card: str, device: str, dev0: torch.device, rng) -> dict:
    """CellposeNet and StarDist2D steps over (dp 2, tp 2), and StarDist2D
    over (dp 2, sp 2), on stacked meshes of ``dev0``: the batch over dp,
    the other axis replicated, as ``jit_data_parallel_step`` runs them;
    each against one device's step with the same seeded weights and
    batches: the losses at phase_data_parallel's bound and the first
    step's summed gradients per tensor at PL_TRAIN_GRAD_BOUNDS."""
    nb, tile = CELLPOSE_CFG["batch_size"], CELLPOSE_CFG["tile"]
    images, masks = synthetic_cell_fields(nb, CELLPOSE_FIELD, CELLPOSE_CELLS, SEED + 18)
    bi = np.ascontiguousarray(CellposeFinetune._prepare_images(list(images))[:, :tile, :tile])
    rays = STARDIST_CFG["n_rays"]
    targets = {
        "cellpose": (rng.uniform(-1, 1, (nb, tile, tile, 2)).astype(np.float32),
                     (masks[:, :tile, :tile] > 0).astype(np.float32)),
        "stardist": ((masks[:, :tile, :tile] > 0).astype(np.float32),
                     rng.uniform(0, 16, (nb, tile, tile, rays)).astype(np.float32)),
    }
    cfg = CellposeConfig(features=DP_CELLPOSE_FEATURES)

    def state(kind: str) -> TrainState:
        if kind == "cellpose":
            return create_model_and_state(cfg, seed=SEED, device=device)[1]
        model = StarDist2D(n_rays=rays, features=STARDIST_CFG["features"], in_channels=bi.shape[-1])
        model.reset_parameters(SEED)
        return TrainState.create(model.to(dev0), cfg.learning_rate, cfg.weight_decay)

    makers = {"cellpose": make_train_step, "stardist": make_stardist_train_step}
    r: dict = {}
    for kind, axes in PL_TRAIN_MESHES:
        key = f"{kind}_" + "_".join(f"{a}{n}" for a, n in axes.items())
        batch = [torch.from_numpy(a).to(dev0) for a in (bi, *targets[kind])]
        mesh = make_mesh(axes, [dev0] * math.prod(axes.values()))
        single, single_step = state(kind), makers[kind]()
        split, split_step = replicate(mesh, state(kind)), data_parallel_step(makers[kind](), mesh)
        losses: dict = {"single": [], "split": []}
        min_cos, max_rel = PL_TRAIN_GRAD_BOUNDS
        for i in range(PL_TRAIN_STEPS):
            losses["single"].append(float(single_step(single, *batch)[1]["loss"]))
            losses["split"].append(float(split_step(split, *batch)[1]["loss"]))
            check(_replicas_equal(split), f"{key} step {i + 1}: the replicas differ")
            if i == 0:  # .grad keeps the step's summed gradients
                g = _grad_agreement(single.module, split.module)
        check(g["min_cos"] >= min_cos and g["max_rel_l2"] <= max_rel and g["zero_norms_ok"],
              f"{key} step 1 gradients: min cosine {g['min_cos']} at {g['min_cos_at']} (bound {min_cos}), max "
              f"relative L2 {g['max_rel_l2']} at {g['max_rel_l2_at']} (bound {max_rel}), zero by structure "
              f"{g['zero_by_structure']} below {g['floor']}: {g['zero_norms_ok']}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["split"], losses["single"]))
        check(all(np.isfinite(losses["split"])) and rel <= DP_LOSS_RTOL,
              f"{key}: losses {losses['split']} against one device's {losses['single']} (max rel {rel}, bound "
              f"{DP_LOSS_RTOL})")

        ms = {"single": _device_ms(device, lambda: single_step(single, *batch), iters=PL_REPEATS),
              "split": _device_ms(device, lambda: split_step(split, *batch), iters=PL_REPEATS)}
        r[key] = {"losses": losses, "max_rel": rel, "grads": g, "ms": ms, "replicas": len(split.replicas)}
        del single, split
        gc.collect()
        print(f"[{card}] parallel layer train: {kind} bf16, {nb} x {tile}^2, over {axes} on [{dev0}] x "
              f"{mesh.size} (batch over dp, the other axis replicated): {PL_TRAIN_STEPS} steps, losses "
              f"{losses['split']} against one device's {losses['single']} (max rel {rel:.3g}, bound {DP_LOSS_RTOL}), "
              f"step 1's summed gradients per tensor min cosine {g['min_cos']:.8f} ({g['min_cos_at']}, bound "
              f"{min_cos}), max relative L2 {g['max_rel_l2']:.3g} ({g['max_rel_l2_at']}, bound {max_rel}), "
              f"the {mesh.size} replicas equal bit for bit after every step; ms per step (CUDA events, "
              f"{PL_REPEATS} steps) {json.dumps({k: round(v, 3) for k, v in ms.items()})}")
    return r


def _pl_spatial(card: str, device: str, dev0: torch.device, rng) -> dict:
    r: dict = {}
    mesh = make_mesh({"sp": 2}, [dev0, dev0])
    vol = rng.standard_normal(PL_VOLUME, np.float32)
    xt = torch.from_numpy(vol).to(dev0)
    unet = UNet3D(features=PL_UNET3D_FEATURES, z_strides=UNET3D_Z_STRIDES)
    unet.reset_parameters(SEED)
    replicas = replicate(mesh, unet.to(dev0).eval())
    run = spatial_shard_apply(lambda m, blk: m(blk), mesh, halo=PL_HALO, rank=5)
    with torch.no_grad():
        sharded = run(replicas, xt)
        # the definition: each zero-edged haloed block built on the host,
        # run by one replica, cropped and concatenated
        depth = vol.shape[1] // 2
        padded = np.pad(vol, ((0, 0), (PL_HALO, PL_HALO), (0, 0), (0, 0), (0, 0)))
        blocks = [unet(torch.from_numpy(padded[:, j * depth : j * depth + depth + 2 * PL_HALO]).to(dev0))
                  for j in range(2)]
        ref = torch.cat([b[:, PL_HALO:-PL_HALO] for b in blocks], dim=1)
        whole = unet(xt)
        unet_ms = _device_ms(device, lambda: run(replicas, xt), iters=PL_REPEATS)
        whole_ms = _device_ms(device, lambda: unet(xt), iters=PL_REPEATS)
    err = float((sharded.float() - ref.float()).abs().max())
    bound = PL_SPATIAL_DEF_TOL * float(ref.float().abs().max())
    check(sharded.shape == whole.shape and err <= bound,
          f"UNet3D sp = 2: max abs {err} to the haloed blocks built on the host, over {bound}")
    r_ = PL_HALO
    interior = float((sharded.float() - whole.float())[:, r_:-r_].abs().max())
    del sharded, ref, whole, blocks, replicas

    stack = _ConvStack(PL_STACK_FEATURES).to(dev0).eval()
    stack_replicas = replicate(mesh, stack)
    run_stack = spatial_shard_apply(lambda m, blk: m(blk), mesh, halo=PL_STACK_RADIUS, rank=5)
    with torch.no_grad():
        got = run_stack(stack_replicas, xt)
        want = stack(xt)
        stack_ms = _device_ms(device, lambda: run_stack(stack_replicas, xt), iters=PL_REPEATS)
        stack_whole_ms = _device_ms(device, lambda: stack(xt), iters=PL_REPEATS)
    rr = PL_STACK_RADIUS
    stack_err = float((got - want)[:, rr:-rr].abs().max())
    check(got.shape == want.shape and stack_err <= PL_STACK_TOL,
          f"f32 conv stack sp = 2: interior max abs {stack_err} over {PL_STACK_TOL}")
    del got, want, stack_replicas
    r.update(unet3d_err=err, unet3d_bound=bound, unet3d_interior_vs_whole=interior, unet3d_ms=unet_ms,
             unet3d_whole_ms=whole_ms, stack_err=stack_err, stack_ms=stack_ms, stack_whole_ms=stack_whole_ms)
    print(f"[{card}] parallel layer spatial: UNet3D {PL_UNET3D_FEATURES} bf16 on {PL_VOLUME} depth-split over "
          f"stacked sp = 2 with halo {PL_HALO}: max abs {err:.4g} to the zero-edged haloed blocks built on the "
          f"host (bound {bound:.4g}); {interior:.4g} to the unsharded forward beyond the halo (GroupNorm's "
          f"statistics are per block); ms per volume (CUDA events) sharded {unet_ms:.3f}, whole {whole_ms:.3f}; "
          f"the f32 3x3x3 conv + SiLU stack ({PL_STACK_FEATURES} features, TF32 off, halo {PL_STACK_RADIUS}): "
          f"interior max abs {stack_err:.4g} to the unsharded forward (bound {PL_STACK_TOL}), ms per volume "
          f"sharded {stack_ms:.3f}, whole {stack_whole_ms:.3f}")
    return r


def _pl_ring(card: str, device: str, dev0: torch.device, rng) -> dict:
    mesh = make_mesh({"sp": 2}, [dev0, dev0])
    dense = ViT(img_size=PL_RING_SIZE, dtype=torch.float32, softmax_dtype=torch.float32, **PL_RING_VIT)
    dense.reset_parameters(SEED)
    dense = dense.to(dev0).eval()
    ring_fn = make_ring_attention(mesh)
    flash_fn = attention.make_attn_fn()
    x = torch.from_numpy(rng.standard_normal((PL_RING_BUCKET, PL_RING_SIZE, PL_RING_SIZE, 3), np.float32)).to(dev0)

    def with_attn(fn):
        for block in dense.blocks():
            block.attn.attn_fn = fn

    out, ms, peak = {}, {}, {}
    with torch.no_grad():
        for key, fn in (("inline", None), ("ring", ring_fn), ("flash", flash_fn)):
            with_attn(fn)
            if device == "cuda":
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            before = attention.launch_count
            out[key] = dense(x)
            if key == "ring":
                check(attention.launch_count == before, "the ring path launched flash_attn_fwd")
            peak[key] = (torch.cuda.max_memory_allocated() - base) if device == "cuda" else 0
            ms[key] = _device_ms(device, lambda: dense(x), iters=2)
        with_attn(None)
    err = float((out["ring"] - out["inline"]).abs().max())
    flash_err = float((out["flash"] - out["inline"]).abs().max())
    check(out["ring"].shape == out["inline"].shape and err <= PL_RING_TOL,
          f"ring ViT: max abs {err} to the inline attention over {PL_RING_TOL}")
    tokens = (PL_RING_SIZE // 14) ** 2 + 1
    print(f"[{card}] parallel layer ring: ViT-B/14 f32 (TF32 off) at {PL_RING_SIZE}^2 ({tokens} tokens), bucket "
          f"{PL_RING_BUCKET}, make_ring_attention over stacked sp = 2 in the attn_fn slot: max abs {err:.4g} to "
          f"the inline attention (bound {PL_RING_TOL}), the flash path {flash_err:.4g}; ms per forward (CUDA "
          f"events) {json.dumps({k: round(v, 3) for k, v in ms.items()})}; peak memory above the start, bytes "
          f"{json.dumps(peak)}")
    return {"ring_err": err, "flash_err": flash_err, "ring_ms": ms, "ring_peak_bytes": peak, "tokens": tokens}


def _pl_knn(card: str, device: str, dev0: torch.device) -> dict:
    corpus = mixture_corpus(INDEX_N, INDEX_DIM, INDEX_CLUSTERS, SEED, device)
    g = torch.Generator(device=device).manual_seed(SEED + 15)
    qids = torch.randperm(INDEX_N, generator=g, device=device)[:PL_KNN_QUERIES]
    queries = corpus[qids] + torch.randn((PL_KNN_QUERIES, INDEX_DIM), generator=g, device=device) * 0.01
    flat_s, flat_i = topk_inner_product(corpus.to(torch.bfloat16), queries, PL_KNN_K)
    flat_s, flat_i = flat_s.cpu().numpy(), flat_i.cpu().numpy()
    host = corpus.cpu().numpy()
    q = queries.cpu().numpy()
    del corpus
    found, ms = {}, {}
    for key, mesh in (("mesh_none", None), ("dp2", make_mesh({"dp": 2}, [dev0, dev0]))):
        index = ShardedKnnIndex(host, mesh=mesh, device=device)
        found[key] = index.search(q, PL_KNN_K)
        t0 = time.perf_counter()
        for _ in range(PL_REPEATS):
            index.search(q, PL_KNN_K)
        ms[key] = (time.perf_counter() - t0) * 1e3 / PL_REPEATS
        del index
    r = {"ms_per_batch": ms}
    for key, (s, i) in found.items():
        score_err = float(np.abs(s - flat_s).max())
        ties = 0
        for row in range(PL_KNN_QUERIES):
            if set(i[row]) != set(flat_i[row]):
                # ids may differ only where scores tie at the k-th place
                kth = flat_s[row, -1]
                odd = [c for c in range(PL_KNN_K) if i[row, c] not in set(flat_i[row])]
                check(all(abs(s[row, c] - kth) <= PL_KNN_SCORE_TOL for c in odd),
                      f"sharded index {key}: query {row} ids {i[row]} against {flat_i[row]}")
                ties += 1
        check(score_err <= PL_KNN_SCORE_TOL, f"sharded index {key}: scores max abs {score_err} over {PL_KNN_SCORE_TOL}")
        r[key] = {"score_err": score_err, "rows_differing_by_ties": ties}
    print(f"[{card}] parallel layer knn: phase_index's seeded {INDEX_N} x {INDEX_DIM} corpus (bf16) as "
          f"ShardedKnnIndex over stacked dp = 2 and with mesh=None against topk_inner_product: top-{PL_KNN_K} ids "
          f"equal apart from ties ({json.dumps({k: r[k]['rows_differing_by_ties'] for k in found})} rows), "
          f"scores max abs {json.dumps({k: r[k]['score_err'] for k in found})} (bound {PL_KNN_SCORE_TOL}); ms "
          f"per {PL_KNN_QUERIES}-query batch (host) {json.dumps({k: round(v, 3) for k, v in ms.items()})}")
    return r


def phase_parallel_layer(card: str, device: str = "cuda") -> dict:
    """Slice 15: the rest of the parallel layer through its entry points at
    full width, each multi-device leg on a stacked mesh of ``cuda:0``
    entries (one card): (a) dp in the decode engine (the golden decoder at
    dp = 1 and 2, the 768 x 12 decoder with 8 concurrent sequences through
    ``DecodeLoop``); (b) tensor parallelism: ViT-B/14 bf16 through
    ``InferenceEngine`` with ``VIT_TP_RULES`` at tp = 2 and dp 2 x tp 2 (the
    flash kernel on every tp shard), and at tp = 8, where ViT-B/14's 12
    heads split 2, 1, 2, 1, ... a shard (slice 18), UNet2D with
    ``CONV_TP_RULES``, and in f32 with its convolutions split on input
    channels (slice 18); train steps over (dp 2, tp 2) and (dp 2, sp 2)
    against one device's (slice 18); (c)
    spatial halo exchange: UNet3D depth-split over sp = 2, and an f32 conv
    stack; (d) ring attention in the ViT's ``attn_fn`` slot at 1,370 tokens;
    (e) the sharded FlatIP index over 1M rows. One ``parallel_layer`` JSON
    line."""
    t_phase = time.perf_counter()
    dev0 = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    rng = np.random.default_rng(SEED + 15)
    r: dict = {}
    deterministic = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    attention.launch_count = 0
    legs_s: dict = {}
    try:
        for name, leg in (("decode", lambda: _pl_decode(card, device, dev0, dict(np.load(DECODE_FIXTURE)))),
                          ("tp", lambda: _pl_tp(card, device, dev0, rng)),
                          ("layout", lambda: _pl_layout(card, device, dev0, rng)),
                          ("train", lambda: _pl_train(card, device, dev0, rng)),
                          ("spatial", lambda: _pl_spatial(card, device, dev0, rng)),
                          ("ring", lambda: _pl_ring(card, device, dev0, rng)),
                          ("knn", lambda: _pl_knn(card, device, dev0))):
            t0 = time.perf_counter()
            r[name] = leg()
            legs_s[name] = time.perf_counter() - t0
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
    launches = attention.launch_count
    if device == "cuda":
        check(launches > 0, "the parallel layer's path launched flash_attn_fwd no time")
    r["flash_attn_fwd_launches"] = launches
    r["legs_s"] = legs_s
    r["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] parallel layer: flash_attn_fwd launches {launches} on the path; legs (s) "
          f"{json.dumps({k: round(v, 3) for k, v in legs_s.items()})}")
    print(f"[{card}] parallel layer phase: {r['phase_s']:.3f} s")
    out = {"card": card, "flash_attn_fwd_launches": launches,
           "tp_launches_per_forward": r["tp"]["launches_per_forward"], "tp_min_cos": r["tp"]["vit_min_cos"],
           "layout_err": r["layout"]["err"],
           "train_max_rel": {k: v["max_rel"] for k, v in r["train"].items()},
           "train_grad": {k: (v["grads"]["min_cos"], v["grads"]["max_rel_l2"]) for k, v in r["train"].items()},
           "decode_tokens_per_s": r["decode"]["tokens_per_s"], "vit_images_per_s": r["tp"]["vit_images_per_s"],
           "ring_ms": r["ring"]["ring_ms"], "detail": r}
    print("parallel_layer " + json.dumps(out, default=str))
    return out


# ---- slice 16: the exact dp x sp train step and the dry run --------------------------
DRY_FEATURES = CELLPOSE_FEATURES  # the cellpose-finetuning backbone (apps/cellpose-finetuning/main.py:52)
DRY_MESH = {"dp": 2, "sp": 2}  # four entries of one card: the batch over dp, image height over sp
DRY_STEPS = 5  # timed steps per leg, after one warm-up step
DRY_ENTRIES = 4  # the dry run's mesh, stacked on the card
# (loss rtol, min cosine, max relative L2) of the dp x sp step's summed
# gradients against one device's, per tensor; f32 with TF32 off is the
# unsharded step within summation order, bf16 rounds its activations
# after every layer, so a rounding can flip wherever the order differs.
# f32's loss rtol and cosine are the contract's; the other bounds sit 6-17x
# above the H100's readings (f32 relative L2 6.99e-6; bf16 loss 1.22e-5,
# cosine 1 - 5.7e-6, relative L2 0.0034; PERF.md section 6)
DRY_BOUNDS = {torch.float32: (1e-5, 0.99999, 1e-4), torch.bfloat16: (2e-4, 0.9999, 0.02)}
# a conv bias feeding a GroupNorm of one channel per group has a zero
# gradient in exact arithmetic: a tensor whose one-device gradient norm is
# below this share of the whole gradient's norm is rounding noise on both
# sides, and is held to stay below it there instead of to a cosine
DRY_ZERO_GRAD = 1e-4


def _grad_agreement(single, split) -> dict:
    """Per-tensor cosine and relative L2 of ``split``'s gradients against
    ``single``'s (f64 on the host); the tensors that are zero by structure
    (below DRY_ZERO_GRAD of the whole norm) apart."""
    ga = {k: p.grad.detach().double().cpu().flatten() for k, p in single.named_parameters()}
    gb = {k: p.grad.detach().double().cpu().flatten() for k, p in split.named_parameters()}
    floor = DRY_ZERO_GRAD * float(torch.sqrt(sum(g.dot(g) for g in ga.values())))
    zero = sorted(k for k, g in ga.items() if float(g.norm()) < floor)
    cos = {k: float(ga[k].dot(gb[k]) / (ga[k].norm() * gb[k].norm())) for k in ga if k not in zero}
    rel = {k: float((gb[k] - ga[k]).norm() / ga[k].norm()) for k in ga if k not in zero}
    return {"min_cos": min(cos.values()), "min_cos_at": min(cos, key=cos.get),
            "max_rel_l2": max(rel.values()), "max_rel_l2_at": max(rel, key=rel.get), "floor": floor,
            "zero_by_structure": zero, "zero_norms_ok": all(max(float(ga[k].norm()), float(gb[k].norm())) < floor
                                                            for k in zero)}


def _dry_step_leg(card: str, device: str, dev0: torch.device, dtype, batch) -> dict:
    """The dp 2 x sp 2 CellposeNet step on a stacked mesh of four ``dev0``
    entries against the single-device step, same seeded weights and batch:
    loss, summed gradients, ms per step and peak memory of each."""
    mesh = make_mesh(DRY_MESH, [dev0] * DRY_ENTRIES)
    cfg = CellposeConfig(features=DRY_FEATURES)

    def state():
        model = CellposeNet(features=DRY_FEATURES, dtype=dtype)
        model.reset_parameters(SEED + 16)
        return TrainState.create(model.to(dev0), cfg.learning_rate, cfg.weight_decay)

    steps = {"single": (state(), make_train_step())}
    steps["dp2_sp2"] = (replicate(mesh, state()), data_parallel_step(make_train_step(), mesh))
    r: dict = {"loss": {}, "peak_mib": {}, "ms": {}}
    for key, (st, step) in steps.items():
        _release(device)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated() if device == "cuda" else 0
        r["loss"][key] = float(step(st, *batch)[1]["loss"])  # .grad keeps the seeded weights' gradients
        r["peak_mib"][key] = (torch.cuda.max_memory_allocated() - start) / 2**20 if device == "cuda" else 0.0
    r["grads"] = _grad_agreement(steps["single"][0].module, steps["dp2_sp2"][0].module)
    for key, (st, step) in steps.items():
        r["ms"][key] = _device_ms(device, lambda: step(st, *batch), iters=DRY_STEPS)
    r["loss_rel"] = abs(r["loss"]["dp2_sp2"] - r["loss"]["single"]) / abs(r["loss"]["single"])
    loss_rtol, min_cos, max_rel = DRY_BOUNDS[dtype]
    g = r["grads"]
    name = str(dtype).removeprefix("torch.")
    print(f"[{card}] dry run: CellposeNet {DRY_FEATURES} {name}, {tuple(batch[0].shape)}: dp 2 x sp 2 on "
          f"{DRY_ENTRIES} x {dev0} against one device, loss {r['loss']['dp2_sp2']!r} vs {r['loss']['single']!r} "
          f"(rel {r['loss_rel']:.3g}, bound {loss_rtol}); summed gradients per tensor min cosine "
          f"{g['min_cos']:.8f} ({g['min_cos_at']}, bound {min_cos}), max relative L2 {g['max_rel_l2']:.3g} "
          f"({g['max_rel_l2_at']}, bound {max_rel}); zero by structure (both sides below {g['floor']:.3g}): "
          f"{g['zero_by_structure']}; ms per step (CUDA events, {DRY_STEPS} after a warm-up) "
          f"{json.dumps({k: round(v, 3) for k, v in r['ms'].items()})}; peak MiB above the start "
          f"{json.dumps({k: round(v, 1) for k, v in r['peak_mib'].items()})}")
    check(np.isfinite(list(r["loss"].values())).all() and r["loss_rel"] <= loss_rtol,
          f"{name} dp x sp step loss rel {r['loss_rel']} to one device, bound {loss_rtol}")
    check(g["min_cos"] >= min_cos and g["max_rel_l2"] <= max_rel,
          f"{name} dp x sp gradients: min cosine {g['min_cos']} at {g['min_cos_at']} (bound {min_cos}), max "
          f"relative L2 {g['max_rel_l2']} at {g['max_rel_l2_at']} (bound {max_rel})")
    check(g["zero_norms_ok"], f"{name}: a gradient zero by structure {g['zero_by_structure']} rose above "
          f"{g['floor']}")
    return r


def _dry_batch(dev0: torch.device, rng) -> list:
    """8 x 256^2 tiles of synthetic cell fields with their cell
    probabilities, flow targets drawn from ``rng`` (as phase_data_parallel)."""
    nb, tile = CELLPOSE_CFG["batch_size"], CELLPOSE_CFG["tile"]
    images, masks = synthetic_cell_fields(nb, CELLPOSE_FIELD, CELLPOSE_CELLS, SEED + 16)
    bi = np.ascontiguousarray(CellposeFinetune._prepare_images(list(images))[:, :tile, :tile])
    bf = rng.uniform(-1, 1, (nb, tile, tile, 2)).astype(np.float32)
    bp = (masks[:, :tile, :tile] > 0).astype(np.float32)
    return [torch.from_numpy(a).to(dev0) for a in (bi, bf, bp)]


def _dry_expected(n: int) -> dict:
    """The OK line's fields of ``dryrun_multichip(n)``, as the JAX dry run
    prints them for ``n`` devices."""
    sp = tp = 2 if n % 2 == 0 else 1
    half = max(1, n // 2)
    stage_bytes = 2 * half * 16 * 16 * graft_entry.STAGE_CHANNELS * 4  # f32 in, f32 out of each stage
    return {"mesh": str({"dp": n // sp, "sp": sp}), "batch": str(n // sp * 2), "step": "1",
            "tp_mesh": str({"dp": n // tp, "tp": tp}), "tp_out": str((n // tp * 2, graft_entry.VIT["dim"])),
            "sp3d_out": str((1, 4 * n, 16, 16, 1)), "serving_mesh": str({"dp": n}), "serving_parity_ok": "True",
            "cross_host_stages": "2", "cross_host_parity_ok": "True",
            "cross_host_transfer_bytes": str(2 * 2 * stage_bytes)}


def phase_dryrun(card: str, device: str = "cuda") -> dict:
    """Slice 16: (a) CellposeNet at the cellpose-finetuning width, bf16 and
    then f32 (TF32 off), 8 x 256^2: the exact dp 2 x sp 2 train step on a
    stacked mesh of four card entries against the single-device step on the
    same weights and batch; (b) ``graft_entry.dryrun_multichip`` over four
    stacked entries to its OK line, parsed and checked; (c) the flash
    kernel's launches around the phase, which must be none: CellposeNet has
    no attention, and the dry run's ViT (16 tokens, head dim 16) runs its
    attention inline, as JAX's does. One ``dryrun`` JSON line."""
    t_phase = time.perf_counter()
    dev0 = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    rng = np.random.default_rng(SEED + 16)
    r: dict = {}
    deterministic = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    attention.launch_count = 0
    try:
        batch = _dry_batch(dev0, rng)
        for dtype in (torch.bfloat16, torch.float32):
            r[str(dtype).removeprefix("torch.")] = _dry_step_leg(card, device, dev0, dtype, batch)
            gc.collect()
            _release(device)
        t0 = time.perf_counter()
        line = graft_entry.dryrun_multichip(DRY_ENTRIES, devices=[dev0] * DRY_ENTRIES)
        r["dryrun_s"] = time.perf_counter() - t0
        check(line.startswith("dryrun_multichip OK: "), f"the dry run printed {line!r}")
        fields = dict(re.findall(r"(\w+)=(\{[^}]*\}|\([^)]*\)|\S+)", line.removeprefix("dryrun_multichip OK: ")))
        want = _dry_expected(DRY_ENTRIES)
        got = {k: fields.get(k) for k in want}
        check(got == want, f"the dry run's OK line {got}, expected {want}")
        check(np.isfinite([float(fields["loss"]), float(fields["cpsam_dp_loss"])]).all(),
              f"the dry run's losses {fields['loss']}, {fields['cpsam_dp_loss']}")
        r["dryrun_fields"] = fields
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
    # no attention kernel on this path: CellposeNet has none, and the dry
    # run's ViT is a 16-token, head-dim-16 ViT with inline attention, as in
    # JAX (the kernel takes head dims 32, 64 and 128)
    launches = attention.launch_count
    check(launches == 0, f"the dry-run path launched flash_attn_fwd {launches} times, expected none")
    r["flash_attn_fwd_launches"] = launches
    r["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] dry run: dryrun_multichip({DRY_ENTRIES}) over {DRY_ENTRIES} x {dev0} in {r['dryrun_s']:.3f} s, "
          f"its OK line as the JAX dry run's for {DRY_ENTRIES} devices; flash_attn_fwd launches {launches}")
    print(f"[{card}] dry run phase: {r['phase_s']:.3f} s")
    out = {"card": card, "flash_attn_fwd_launches": launches,
           "step_ms": {k: r[k]["ms"] for k in ("bfloat16", "float32")},
           "peak_mib": {k: r[k]["peak_mib"] for k in ("bfloat16", "float32")}, "detail": r}
    print("dryrun " + json.dumps(out, default=str))
    return out



# ---- slice 17: the static analyzer and its capture rules on the card ----------

ANALYSIS_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                 "torch_analysis_fixtures")
# each BE-GRAPH rule, its fixture, and whether its positives raise at capture
# (BE-GRAPH-104's capture succeeds: its mutation runs once and never on replay)
GRAPH_RULE_FIXTURES = {
    "BE-GRAPH-101": ("fx_graph_branch.py", True),
    "BE-GRAPH-102": ("fx_graph_hostcopy.py", True),
    "BE-GRAPH-103": ("fx_graph_coercion.py", True),
    "BE-GRAPH-104": ("fx_graph_closure.py", False),
    "BE-GRAPH-105": ("fx_graph_shape.py", True),
}
GRAPH_CASE_SHAPE = (4, 8)  # float32 input of every fixture case
GRAPH_REPLAYS = 3


def _load_by_path(path: str):
    spec = importlib.util.spec_from_file_location(f"chip_smoke_{os.path.basename(path)[:-3]}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _graph_input(device: str, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(GRAPH_CASE_SHAPE).astype(np.float32)).to(device)


def _capture_case(fn, x: torch.Tensor, stream):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        out = fn(x)
    return graph, out


def _capture_raises(call) -> str:
    """The first line of what ``call`` raised while capturing, or "" if it
    captured; the device is synchronised after a raise either way."""
    try:
        call()
    except Exception as exc:  # the hazard under test: any error counts, recorded
        while exc.__context__ is not None:  # the capture's end re-raises: show the cause
            exc = exc.__context__
        return f"{type(exc).__name__}: {str(exc).strip().splitlines()[0][:160]}"
    finally:
        torch.cuda.synchronize()
    return ""


def _graph_rule_cases(rule: str, fixture: str, raises: bool, device: str, seed: int) -> dict:
    """Every case of one BE-GRAPH fixture on ``device``: each ``pos_*`` runs
    eagerly and then under capture (it must raise, or, for BE-GRAPH-104,
    its side effect must happen once at capture and never on replay); each
    ``block_pos_*`` holds its own capture block, judged alike; each
    ``neg_*`` is captured and replayed on fresh inputs, bit for bit equal to
    eager on the same stream. On the CPU every case runs eagerly only."""
    module = _load_by_path(os.path.join(ANALYSIS_FIXTURES, fixture))
    names = sorted(n for n in vars(module) if n.startswith(("pos_", "neg_", "block_pos_")))
    r: dict = {"fixture": fixture, "positives": {}, "negatives": {}}
    x = _graph_input(device, seed)
    for name in names:
        fn = getattr(module, name)
        positive = not name.startswith("neg_")
        if device != "cuda":
            if not name.startswith("block_pos_"):
                fn(x.clone())
            (r["positives"] if positive else r["negatives"])[name] = "eager only (capture needs CUDA)"
            continue
        if positive:
            if name.startswith("pos_"):
                fn(x.clone())  # the case is valid code: it runs eagerly
                call = lambda: _capture_case(fn, x.clone(), torch.cuda.Stream())  # noqa: E731
            else:
                call = lambda: fn(x.clone(), stream=torch.cuda.Stream())  # noqa: E731
            if raises:
                err = _capture_raises(call)
                check(bool(err), f"{rule} {name}: capture did not raise")
                r["positives"][name] = err
            else:
                module.reset()
                graph, _ = call()
                torch.cuda.synchronize()
                captured = module.effects()
                for _ in range(GRAPH_REPLAYS):
                    graph.replay()
                torch.cuda.synchronize()
                replayed = module.effects()
                check(captured == 1 and replayed == 1,
                      f"{rule} {name}: side effects {captured} after capture, {replayed} after "
                      f"{GRAPH_REPLAYS} replays (expected 1 and 1)")
                r["positives"][name] = {"after_capture": captured, "after_replays": replayed}
                del graph
            continue
        static_x = x.clone()
        fn(static_x.clone())  # warm-up, eager
        torch.cuda.synchronize()
        graph, out = _capture_case(fn, static_x, torch.cuda.Stream())
        torch.cuda.synchronize()
        equal = []
        for i in range(GRAPH_REPLAYS):
            fresh = _graph_input(device, seed + 1 + i)
            static_x.copy_(fresh)
            graph.replay()
            want = fn(fresh)
            equal.append(bool(out.shape == want.shape and torch.equal(out, want)))
        check(all(equal), f"{rule} {name}: replays equal to eager {equal}")
        r["negatives"][name] = f"{GRAPH_REPLAYS} replays bit for bit"
        del graph, out
    return r


def phase_analysis(card: str, device: str = "cuda") -> dict:
    """Slice 17: (a) the port's analyzer gate over ``bioengine_tpu_torch``
    against ``.analyze-torch-baseline.json`` (a fresh cache), its wall
    seconds, files indexed and findings baselined; (b) each BE-GRAPH rule's
    fixture run under ``torch.cuda.graph`` on the card: every seeded
    positive shows the hazard its rule names, every negative replays bit for
    bit equal to eager; (c) the flash kernel's launches around the phase,
    which must be none. One ``analysis`` JSON line."""
    t_phase = time.perf_counter()
    attention.launch_count = 0
    r: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_analysis_") as tmp:
        stats_path = os.path.join(tmp, "stats.json")
        argv = ["bioengine_tpu_torch", "--cache", os.path.join(tmp, "cache.json"), "--stats-json", stats_path]
        # main(argv) in a fresh interpreter: its index pool forks a process
        # that holds no CUDA context and none of this run's threads; the
        # baseline's paths are relative to the checkout's root
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", "import sys; from bioengine_tpu_torch.analysis.__main__ import main; "
             f"sys.exit(main({argv!r}))"],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=300)
        r["gate_s"] = time.perf_counter() - t0
        rc = proc.returncode
        check(rc == 0, f"the port's analyzer gate exited {rc}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        with open(stats_path) as f:
            stats = json.load(f)
    check(stats["files_cached"] == 0 and stats["files_indexed"] == stats["files_total"] > 0,
          f"the gate's scan was not cold: {stats}")
    r["gate"] = {k: stats[k] for k in ("wall_s", "files_total", "files_indexed", "findings", "jobs")}
    print(f"[{card}] analysis gate: rc {rc} in {r['gate_s']:.3f} s (analyzer wall {stats['wall_s']} s), "
          f"{stats['files_indexed']} files indexed, {stats['findings']} findings, all baselined")
    r["rules"] = {}
    for i, (rule, (fixture, raises)) in enumerate(GRAPH_RULE_FIXTURES.items()):
        t0 = time.perf_counter()
        cases = _graph_rule_cases(rule, fixture, raises, device, SEED + 17 + 10 * i)
        cases["s"] = time.perf_counter() - t0
        r["rules"][rule] = cases
        pos, neg = cases["positives"], len(cases["negatives"])
        if device != "cuda":
            shown = f"{len(pos)} positives and {neg} negatives ran eagerly (capture needs CUDA)"
        elif raises:
            shown = (f"{len(pos)} positives raised under capture (e.g. {next(iter(pos.values()))}); {neg} "
                     f"negatives captured, {GRAPH_REPLAYS} replays on fresh inputs bit for bit equal to eager")
        else:
            shown = (f"{len(pos)} positives captured with their side effect once, unchanged by "
                     f"{GRAPH_REPLAYS} replays; {neg} negatives captured, {GRAPH_REPLAYS} replays on fresh "
                     f"inputs bit for bit equal to eager")
        print(f"[{card}] {rule} ({fixture}): {shown} ({cases['s']:.3f} s)")
    # nothing in this slice has attention: the analyzer reads source, and the
    # fixtures' cases are elementwise ops and reductions
    launches = attention.launch_count
    check(launches == 0, f"the analysis path launched flash_attn_fwd {launches} times, expected none")
    r["flash_attn_fwd_launches"] = launches
    r["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] analysis phase: {r['phase_s']:.3f} s; flash_attn_fwd launches {launches}")
    out = {"card": card, "gate": r["gate"], "gate_s": r["gate_s"],
           "rules": {k: {"positives": v["positives"], "negatives": len(v["negatives"]), "s": v["s"]}
                     for k, v in r["rules"].items()},
           "flash_attn_fwd_launches": launches, "phase_s": r["phase_s"]}
    print("analysis " + json.dumps(out, default=str))
    return out


def main() -> int:
    # every controller this run starts keeps its compile-cache tier in a
    # temporary directory (the default is under the home directory)
    tier_root = tempfile.TemporaryDirectory(prefix="chip_smoke_tier_")
    os.environ.setdefault("BIOENGINE_COMPILE_TIER_DIR", tier_root.name)
    card, name = phase_device()
    phase_s: dict = {}

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        phase_s[phase.__name__.removeprefix("phase_")] = round(time.perf_counter() - t0, 3)
        return out

    # nvcc (~15 s of one host core) beside the first phase that runs no
    # kernel of the port's; the kernel checks wait for it
    with concurrent.futures.ThreadPoolExecutor(1) as nvcc_lane:
        build = nvcc_lane.submit(timed, phase_build, card)
        model_runner = timed(phase_model_runner, card)
        ptxas = build.result()
    main_cases = timed(phase_kernels, card)
    main_case, f32_case = main_cases[MAIN_CASE], main_cases["vit_b14_main_path_f32"]
    launches = timed(phase_main_path, card)
    main_f32 = timed(phase_main_path_f32, card)
    vit_h14 = timed(phase_vit_h14, card)
    index = timed(phase_index, card)
    forward = timed(phase_forward, card)
    cellpose = timed(phase_cellpose, card)
    transformers = timed(phase_cellpose_transformers, card)
    zoo = timed(phase_zoo, card)
    decode = timed(phase_decode, card)
    serving = timed(phase_serving, card)
    worker = timed(phase_worker, card)
    apps = timed(phase_apps, card)
    hosts = timed(phase_hosts, card)
    scenario_runs = timed(phase_scenarios, card)
    prefetch = timed(phase_prefetch, card)
    checkpoints = timed(phase_checkpoints, card)
    data_parallel = timed(phase_data_parallel, card)
    parallel_layer = timed(phase_parallel_layer, card)
    dryrun = timed(phase_dryrun, card)
    analysis = timed(phase_analysis, card)
    print(f"[{card}] seconds per phase {json.dumps(phase_s)}")
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "bioengine_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "bioengine_tpu/ops/pallas/attention.py:36",
        "path": main_case["path"],
        "launches": launches,
        # slices 2-5, 7, 8 and 10 launch no attention kernel: their counts stay 0
        "launches_by_path": {"cell_image_search": launches,
                             "cell_image_search_f32": main_f32["launches"],
                             # slice 19: ViT-H/14 widths, head dim 80
                             "vit_h14_bf16": vit_h14["bfloat16"]["launches"],
                             "vit_h14_f16": vit_h14["float16"]["launches"],
                             "index": index["launches"],
                             "model_runner": model_runner["launches"],
                             "cellpose": cellpose["launches"],
                             "cellpose_transformers": transformers["launches"],
                             "zoo": zoo["launches"],
                             "decode": decode["flash_attn_fwd_launches"],
                             "serving": serving["flash_attn_fwd_launches"],
                             "worker": worker["flash_attn_fwd_launches"],
                             "apps": apps["flash_attn_fwd_launches"],
                             # slice 11: read from worker host h1's own trace
                             "hosts": hosts["flash_launches_h1"],
                             # slice 12: the synthetic app has no attention; the
                             # controller process's crash drives cell-image-search
                             **scenario_runs["flash_attn_fwd_launches"],
                             # slice 13: host h2's own trace, from the library it
                             # fetched through the tier; the batches streamed by
                             # the prefetch loader; the checkpoints have no attention
                             "hosts_h2_fetched_library": hosts["tier"]["flash_launches_h2"],
                             "prefetch": prefetch["flash_attn_fwd_launches"],
                             "checkpoints": checkpoints["flash_attn_fwd_launches"],
                             # slice 14: the ViT embedder at dp = 1 through the
                             # mesh and on a stacked dp = 2 mesh (the U-Net and
                             # CellposeNet have no attention)
                             "data_parallel": data_parallel["flash_attn_fwd_launches"],
                             # slice 15: ViT-B/14 at tp = 2 and dp 2 x tp 2 (the
                             # kernel on every tp shard), the f32 flash path beside
                             # the ring; decode, spatial, ring and knn have none
                             "parallel_layer": parallel_layer["flash_attn_fwd_launches"],
                             # slice 16: none, checked: CellposeNet has no attention and
                             # the dry run's ViT (16 tokens, head dim 16) runs it inline
                             "dryrun": dryrun["flash_attn_fwd_launches"],
                             # slice 17: none, checked: the analyzer reads source, and
                             # the capture fixtures' cases have no attention
                             "analysis": analysis["flash_attn_fwd_launches"]},
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
        # slice 19: ViT-B/14's attention in f16, timed in turns
        "f16": {key: main_cases["vit_b14_main_path_f16"][key] for key in (
            "path", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "library_max_abs_err")},
        # every kernel the source instantiates: its cases, worst error and tolerance
        "instantiations": main_cases["instantiations"],
        # the padded f32 width and the wide path, timed in turns at bucket shapes
        # no main path runs (launches 0 there)
        "timed_off_path": {label: {key: main_cases[label][key] for key in (
            "shape", "dtype", "path", "dp", "kernel", "kernel_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "max_abs_err")}
            for label in ("vit_h14_main_path_f32", "wide_f32_d160", "wide_bf16_d320") + TIMED_WIDTHS},
        "ptxas": ptxas[attention.KERNEL_NAME],
        "smem_bytes": attention.launch_plan(main_case["shape"], torch.bfloat16).smem_bytes,
        "f32_smem_bytes": attention.launch_plan(f32_case["shape"], torch.float32).smem_bytes,
        "card": card,
    }] + [{
        # slice 19: the ViT-H/14 legs (head dim 80, Dp 128), one per dtype;
        # launches from each leg's bucket forwards
        "name": f"flash_attn_fwd ({name}, head dim 80)",
        "route": "cuda",
        "source": "bioengine_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "bioengine_tpu/ops/pallas/attention.py:36",
        "kernel": case["kernel"],
        "path": case["path"],
        "launches": vit_h14[dtype]["launches"],
        "max_abs_err": case["max_abs_err"],
        "ms": case["kernel_ms"],
        "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"],
        "bound_by": case["bound_by"],
        "library_ms": case["library_ms"],
        "ms_turns": case["kernel_ms_turns"],
        "library_ms_turns": case["library_ms_turns"],
        "images_per_s": vit_h14[dtype]["images_per_s"],
        "min_cosine": vit_h14[dtype]["min_cosine"],
        "ptxas": ptxas[attention.KERNEL_NAME].get(case["kernel"]),
        "smem_bytes": attention.launch_plan(case["shape"], getattr(torch, dtype)).smem_bytes,
        "card": card,
    } for name, dtype, case in (
        ("bf16", "bfloat16", main_cases["vit_h14_main_path_bf16"]),
        ("f16", "float16", main_cases["vit_h14_main_path_f16"]),
    )]}))
    tier_root.cleanup()
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
