"""The inference engine: bucketed, tiled prediction over one device.

Counterpart of ``bioengine_tpu/runtime/engine.py`` with the same contract:

request -> shape bucket -> program cache -> padded batch on the device ->
forward -> crop back. Images larger than ``max_tile`` run tiled with
overlap and linear-ramp stitching, in chunks of ``tile_batch`` tiles,
through the overlapped pipeline (``runtime/pipeline.py``): a staging
thread cuts chunk k+1 while the device computes chunk k and a stitch
thread blends chunk k-1. ``predict_serial`` is the strictly serial path,
the parity baseline; both give bit-identical output.

A program is built per (model, bucket shape, dtype, placement):

- on the card, a CUDA graph captured over a static input buffer of the
  bucket's shape and its static output, after warm-up forwards on a side
  stream (so cuDNN has chosen its algorithms), PyTorch's documented
  pattern. It is the counterpart of ``jit`` + ``donate_argnums``: one
  fixed pair of device buffers per bucket, no allocation per chunk. Each
  launch copies the staged (pinned) host chunk into the static input,
  replays the graph and copies the static output into a fresh pinned host
  buffer, all on one stream, before it returns; so chunk k+1's replay
  cannot overwrite chunk k's result before it is read. A capture that
  fails raises; nothing falls back to an eager forward.
- on the CPU, the module's forward under ``torch.inference_mode()``.

The engine holds an ``nn.Module`` (its params live inside it) on one
device; multi-device meshes wait for the parallel layer (ROADMAP A10).
Zero-padding to buckets perturbs models whose normalisation uses
spatially global statistics (GroupNorm): padded zeros enter the moments,
as in the JAX engine. Feed exact bucket sizes when bit-faithful outputs
matter.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from bioengine_tpu_torch.runtime.buckets import (
    DEFAULT_LADDER,
    bucket_batch,
    bucket_dim,
    crop_to,
    fill_bucketed,
    pad_to,
)
from bioengine_tpu_torch.runtime.devices import (
    DeviceLike,
    mesh_cache_tag,
    resolve_devices,
)
from bioengine_tpu_torch.runtime.pipeline import (
    DispatchExecutor,
    PipelineStats,
    StagingPool,
    run_pipeline,
    torch_dtype,
)
from bioengine_tpu_torch.runtime.program_cache import (
    CompiledProgramCache,
    default_program_cache,
)
from bioengine_tpu_torch.utils import tracing

# forwards on a side stream before capture: cuDNN picks its algorithms
# and the caching allocator settles, so the capture records steady state
GRAPH_WARMUP_ITERS = 3


@dataclasses.dataclass
class EngineConfig:
    max_tile: int = 1024          # images above this tile-and-stitch
    tile: int = 512
    tile_overlap: int = 64
    ladder: tuple = DEFAULT_LADDER
    # tiled predictions run their tiles through the device in chunks of
    # this many; an unbounded tile batch would run out of device memory
    tile_batch: int = 16
    # volumetric (B, D, H, W, C) inputs: z gets its own, smaller ladder
    # and its own tile size
    max_tile_z: int = 64          # volumes deeper than this tile in z too
    tile_z: int = 32
    tile_overlap_z: int = 8
    ladder_z: tuple = (8, 16, 24, 32, 48, 64, 96, 128)
    # chunks dispatched but not yet read back (2 = double buffering);
    # 0 disables overlap (the serial path)
    pipeline_depth: int = 2
    # staged host chunks cut ahead of dispatch (bounds host memory)
    pipeline_prefetch: int = 2
    # part of the program key, as in the JAX engine; on the card every
    # program reuses its graph's fixed input and output buffers whatever
    # the value (the counterpart of donate_argnums)
    donate_buffers: bool = True


class _Done:
    """A finished launch (CPU): the host result is already there."""

    def __init__(self, host: np.ndarray):
        self._host = host

    def result(self) -> np.ndarray:
        return self._host


class _Readback:
    """A launch in flight on the card: ``result`` waits for its
    device-to-host copy and returns the pinned host buffer as numpy."""

    def __init__(self, host: torch.Tensor, done: torch.cuda.Event):
        self._host, self._done = host, done

    def result(self) -> np.ndarray:
        self._done.synchronize()
        return self._host.numpy()


class _ForwardProgram:
    """CPU program: the module's forward on a view of the staged chunk."""

    def __init__(self, module: nn.Module):
        self.module = module

    def put(self, host: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(host)

    def launch(self, x: torch.Tensor) -> _Done:
        with torch.inference_mode():
            y = self.module(x)
        if y.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
            y = y.clone()  # the staging buffer goes back to its pool
        return _Done(y.numpy())


class _GraphProgram:
    """Card program: a CUDA graph over fixed input and output buffers."""

    def __init__(self, graph, static_in: torch.Tensor, static_out: torch.Tensor):
        self.graph, self.static_in, self.static_out = graph, static_in, static_out

    def put(self, host: np.ndarray) -> torch.Tensor:
        with torch.cuda.device(self.static_in.device):
            self.static_in.copy_(torch.from_numpy(host), non_blocking=True)
        return self.static_in

    def launch(self, x: torch.Tensor) -> _Readback:
        out = self.static_out
        with torch.cuda.device(out.device):
            self.graph.replay()
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return _Readback(host, done)


class InferenceEngine:
    """Wraps one ``nn.Module`` behind bucketed per-shape programs.

    ``module(images)``: (B, H, W, C) -> (B, H, W, C_out), dense spatial
    outputs; volumetric models take (B, D, H, W, C) and route through the
    z-aware bucket/tile path. Global-output models (embedders returning
    (B, D)) must be fed exact-bucket-sized inputs: zero-padding would
    change a global embedding silently, so the engine raises instead.

    The engine moves the module to its device once, at construction, and
    never again: a captured graph reads parameter addresses, so new
    weights are copied into the existing tensors
    (``complete_param_streaming``). Programs live in the (shared)
    ``CompiledProgramCache``.
    """

    def __init__(
        self,
        model_id: str,
        module: nn.Module,
        divisor: int = 1,
        z_divisor: int = 1,
        config: Optional[EngineConfig] = None,
        cache: Optional[CompiledProgramCache] = None,
        device: DeviceLike = None,
        device_ids: Optional[Sequence[int]] = None,
    ):
        self.model_id = model_id
        self.divisor = divisor
        self.z_divisor = z_divisor
        self.config = config or EngineConfig()
        self.cache = cache if cache is not None else default_program_cache
        self.devices = resolve_devices(device_ids, device)
        self.device = self.devices[0]
        self.module = module.to(self.device).eval().requires_grad_(False)
        self.pipeline_stats = PipelineStats(depth=self.config.pipeline_depth)
        self._staging_pool = StagingPool(pinned=self.device.type == "cuda")
        self._dispatcher = DispatchExecutor(f"dispatch-{model_id}")
        # put + launch of one chunk are one step on the device's stream:
        # two threads interleaving them would mix two chunks in one graph's
        # static buffers
        self._launch_lock = threading.Lock()
        # graph captures and parameter copies never overlap
        self._params_lock = threading.Lock()
        # streamed weight loading (runtime/weight_stream.py): an engine
        # built over a skeleton builds and warms its programs while the
        # real bytes land; prediction gates on this event
        self._params_ready = threading.Event()
        self._params_ready.set()
        self._params_error: Optional[BaseException] = None

    # ---- device group -------------------------------------------------------

    @property
    def mesh_shape(self) -> Optional[dict[str, int]]:
        """None: the port's engine runs on one device."""
        return None

    @property
    def _mesh_key(self) -> str:
        return mesh_cache_tag(len(self.devices))

    @property
    def _placement_key(self) -> str:
        """Program identity: the group's shape, its devices and this
        engine's module. A captured graph reads the module's parameter
        addresses, so engines never share a program, even under one
        ``model_id`` (the cache entry holds the module, so its id is not
        reused while the entry lives)."""
        devices = ",".join(str(d) for d in self.devices)
        return f"{self._mesh_key}@{devices}#{id(self.module):x}"

    # ---- streamed weight loading --------------------------------------------

    def begin_param_streaming(self) -> None:
        """Mark the current params as a skeleton: programs may build and
        warm against them, but prediction blocks until
        :meth:`complete_param_streaming`."""
        self._params_error = None
        self._params_ready.clear()

    def complete_param_streaming(self, state_dict) -> None:
        """Copy the real checkpoint into the module's existing tensors
        (addresses unchanged, so captured graphs stay valid) and release
        gated predictions."""
        with self._params_lock, torch.no_grad():
            self.module.load_state_dict(state_dict)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._params_ready.set()

    def fail_param_streaming(self, exc: BaseException) -> None:
        """Loader died: release waiters with the error."""
        self._params_error = exc
        self._params_ready.set()

    @property
    def params_resident(self) -> bool:
        return self._params_ready.is_set() and self._params_error is None

    _weight_stream_timeout_s: Optional[float] = None

    def _wait_params_ready(self) -> None:
        if self._params_ready.is_set() and self._params_error is None:
            return
        timeout = InferenceEngine._weight_stream_timeout_s
        if timeout is None:
            timeout = InferenceEngine._weight_stream_timeout_s = float(
                os.environ.get("BIOENGINE_WEIGHT_STREAM_TIMEOUT_S", "600")
            )
        if not self._params_ready.wait(timeout):
            raise RuntimeError(
                f"model '{self.model_id}': streamed weights not resident "
                f"after {timeout}s"
            )
        if self._params_error is not None:
            raise RuntimeError(
                f"model '{self.model_id}': streamed weight load failed: "
                f"{self._params_error}"
            ) from self._params_error

    def describe(self) -> dict:
        """Device group, memory and per-program build cost."""
        per_chip = {}
        for d in self.devices:
            entry: dict[str, Any] = {"platform": d.type}
            if d.type == "cuda":
                entry["bytes_in_use"] = torch.cuda.memory_allocated(d)
                entry["bytes_limit"] = torch.cuda.get_device_properties(d).total_memory
            per_chip[str(d)] = entry
        mine = {
            k: v
            for k, v in self.cache.compile_info_snapshot().items()
            if k.endswith(f"'{self._placement_key}')")
        }
        cache_stats = self.cache.stats_dict()
        real_compiles = [v["seconds"] for v in mine.values() if not v["cache_hit"]]
        return {
            "device_ids": [d.index or 0 for d in self.devices],
            "n_devices": len(self.devices),
            "mesh": self.mesh_shape,
            "per_chip": per_chip,
            "params_resident": self.params_resident,
            "programs": {
                "live": len(mine),
                "compile_seconds": {k: round(v["seconds"], 3) for k, v in mine.items()},
                "cache_hits": {k: v["cache_hit"] for k, v in mine.items()},
                "persistent_hits": sum(1 for v in mine.values() if v["cache_hit"]),
                "real_compiles": len(real_compiles),
                "real_compile_seconds": round(sum(real_compiles), 3),
                "cache_hit_rate": cache_stats["hit_rate"],
            },
        }

    def close(self) -> None:
        """Release the async dispatch thread and this engine's programs
        (their graphs hold device memory); idempotent."""
        self._dispatcher.close()
        placement = self._placement_key
        self.cache.evict(lambda key: key[-1] == placement)

    def submit(self, fn: Callable, *args: Any, **kwargs: Any):
        """Run ``fn`` on the engine's dispatch thread; returns a
        ``concurrent.futures.Future``."""
        return self._dispatcher.submit(fn, *args, **kwargs)

    # ---- program management -------------------------------------------------

    def program_key(self, shape: tuple[int, ...], dtype) -> tuple:
        return (
            self.model_id, *shape, np.dtype(dtype).name,
            bool(self.config.donate_buffers), self._placement_key,
        )

    def _program(self, shape: tuple[int, ...], dtype):
        shape = tuple(int(s) for s in shape)
        if self.device.type == "cuda":
            build = lambda: self._capture(shape, dtype)  # noqa: E731
        else:
            build = lambda: _ForwardProgram(self.module)  # noqa: E731
        return self.cache.get_or_compile(self.program_key(shape, dtype), build)

    def _capture(self, shape: tuple[int, ...], dtype) -> _GraphProgram:
        dev = self.device
        with self._params_lock, torch.cuda.device(dev), torch.no_grad():
            static_in = torch.zeros(shape, dtype=torch_dtype(dtype), device=dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUP_ITERS):
                    self.module(static_in)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # thread_local: other threads (another engine's pipeline, a
            # weight loader) may use CUDA while this thread captures
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                static_out = self.module(static_in)
            torch.cuda.synchronize(dev)
        return _GraphProgram(graph, static_in, static_out)

    def _launch(self, program, staged: np.ndarray):
        """Copy the staged chunk in and launch it; returns the handle and
        the seconds the copy and the launch took to enqueue."""
        with self._launch_lock:
            t0 = time.perf_counter()
            x = program.put(staged)
            t1 = time.perf_counter()
            handle = program.launch(x)
        return handle, t1 - t0, time.perf_counter() - t1

    def warmup(self, shapes: list[tuple[int, ...]], dtype=np.float32):
        for shape in shapes:
            B, *rest = shape
            self._program((bucket_batch(B), *rest), dtype)

    # ---- prediction ---------------------------------------------------------

    def _axis_specs(self, ndim: int) -> list["_AxisSpec"]:
        """Per-spatial-axis tiling/bucketing parameters: 4D (B, H, W, C) ->
        [y, x]; 5D (B, D, H, W, C) -> [z, y, x] with z on its own ladder."""
        cfg = self.config
        xy = _AxisSpec(cfg.tile, cfg.tile_overlap, cfg.ladder, self.divisor, cfg.max_tile)
        if ndim == 5:
            z = _AxisSpec(
                cfg.tile_z, cfg.tile_overlap_z, cfg.ladder_z,
                self.z_divisor, cfg.max_tile_z,
            )
            return [z, xy, xy]
        return [xy, xy]

    def _validate(self, images: np.ndarray) -> np.ndarray:
        images = np.asarray(images)
        if images.ndim not in (4, 5):
            raise ValueError(
                f"expected (B, H, W, C) or (B, D, H, W, C), got {images.shape}"
            )
        return images

    def _needs_tiling(self, images: np.ndarray, specs: list["_AxisSpec"]) -> bool:
        spatial = images.shape[1:-1]
        return any(size > spec.max_tile for size, spec in zip(spatial, specs))

    def predict(self, images: np.ndarray) -> np.ndarray:
        """images: (B, H, W, C) or (B, D, H, W, C) host array -> model
        output, cropped back to the original spatial size. Inputs larger
        than the per-axis ``max_tile`` run overlap-tiled through the
        overlapped pipeline; ``pipeline_depth=0`` takes the serial path.

        Under a sampled trace the prediction records an ``engine.predict``
        span whose attrs carry the per-stage ``stage_seconds`` and the
        prediction's ``chip_seconds`` (wall seconds x device count).
        Chip-seconds also feed the request-scoped accumulator on every
        call, sampled or not."""
        ctx = tracing.current_trace()
        width = len(self.devices)
        t0 = time.monotonic()
        if ctx is None or not ctx.sampled:
            try:
                return self._predict_impl(images)
            finally:
                tracing.add_chip_seconds((time.monotonic() - t0) * width)
        before = self.pipeline_stats.as_dict()
        try:
            with tracing.span(
                "engine.predict",
                model=self.model_id,
                batch=int(np.asarray(images).shape[0]),
                mesh=self._mesh_key,
                devices=width,
            ) as record:
                out = self._predict_impl(images)
                after = self.pipeline_stats.as_dict()
                record["attrs"]["stage_seconds"] = {
                    k.removesuffix("_seconds"): round(after[k] - before[k], 6)
                    for k in (
                        "cut_seconds", "put_seconds", "dispatch_seconds",
                        "compute_seconds", "readback_seconds", "stitch_seconds",
                    )
                }
                record["attrs"]["chip_seconds"] = round(
                    (time.monotonic() - t0) * width, 6
                )
            return out
        finally:
            tracing.add_chip_seconds((time.monotonic() - t0) * width)

    def _predict_impl(self, images: np.ndarray) -> np.ndarray:
        images = self._validate(images)
        specs = self._axis_specs(images.ndim)
        if self._needs_tiling(images, specs):
            if self.config.pipeline_depth > 0:
                return self._predict_tiled_pipelined(images, specs)
            return np.stack([self._predict_tiled(item, specs) for item in images])
        return self._predict_direct(images, specs)

    def predict_serial(self, images: np.ndarray) -> np.ndarray:
        """The strictly serial path: one chunk cut, copied, computed, read
        back and stitched at a time, one batch item after another. The
        parity baseline of the pipelined path."""
        images = self._validate(images)
        specs = self._axis_specs(images.ndim)
        if self._needs_tiling(images, specs):
            return np.stack([self._predict_tiled(item, specs) for item in images])
        return self._predict_direct(images, specs)

    async def predict_async(self, images: np.ndarray) -> np.ndarray:
        """Async front door: ``predict`` on the engine's dispatch thread."""
        import asyncio

        fn = tracing.carry(tracing.current_trace(), self.predict)
        return await asyncio.wrap_future(self.submit(fn, images))

    def _predict_direct(self, x: np.ndarray, specs: list["_AxisSpec"]) -> np.ndarray:
        """Bucket every spatial axis, pad into a reusable staging buffer,
        run the bucket's program, crop back."""
        B = x.shape[0]
        C = x.shape[-1]
        spatial = x.shape[1:-1]
        axes = tuple(range(1, x.ndim - 1))
        buckets = tuple(
            bucket_dim(size, spec.ladder, spec.divisor)
            for size, spec in zip(spatial, specs)
        )
        bb = bucket_batch(B)
        staged = self._staging_pool.acquire((bb, *buckets, C), x.dtype)
        fill_bucketed(staged, x)
        program = self._program(staged.shape, staged.dtype)
        # the gate sits AFTER the build: under streamed loading the first
        # request's capture overlaps the weight transfer
        self._wait_params_ready()
        out = self._launch(program, staged)[0].result()
        # released only once its copy to the device is done; a buffer of
        # a failed launch is dropped, never reused under a pending copy
        self._staging_pool.release(staged)
        out = out[:B]
        if out.ndim == len(spatial) + 2:
            out = crop_to(out, spatial, axes=axes)
        elif buckets != spatial:
            raise ValueError(
                f"model '{self.model_id}' returns a global output "
                f"(shape {out.shape}) but the input {spatial} was padded to "
                f"bucket {buckets}: padding corrupts global outputs. "
                f"Resize inputs to a bucket size."
            )
        return out

    # ---- tiling geometry (shared by the serial and pipelined paths) ---------

    def _tile_plan(self, spatial: tuple[int, ...], specs: list["_AxisSpec"]) -> "_TilePlan":
        tsizes = [min(s.tile, max(size, 1)) for s, size in zip(specs, spatial)]
        overlaps = [min(s.overlap, max(t - 1, 0)) for s, t in zip(specs, tsizes)]
        starts_per_axis = [
            _tile_starts(size, t, o) for size, t, o in zip(spatial, tsizes, overlaps)
        ]
        coords = list(itertools.product(*starts_per_axis))
        buckets = tuple(
            bucket_dim(t, spec.ladder, spec.divisor) for t, spec in zip(tsizes, specs)
        )
        return _TilePlan(tsizes, overlaps, coords, buckets)

    def _predict_tiled(self, item: np.ndarray, specs: list["_AxisSpec"]) -> np.ndarray:
        """Overlap-tile one (H, W, C) image or (D, H, W, C) stack and
        stitch with a separable linear ramp. Tiles run through the
        bucketed direct path in chunks of ``tile_batch``."""
        spatial = item.shape[:-1]
        plan = self._tile_plan(spatial, specs)
        tsizes, overlaps, coords = plan.tsizes, plan.overlaps, plan.coords
        spatial_axes = tuple(range(1, len(tsizes) + 1))

        def cut(start) -> np.ndarray:
            sl = tuple(slice(s0, s0 + t) for s0, t in zip(start, tsizes))
            return pad_to(item[sl][None], tuple(tsizes), axes=spatial_axes)[0]

        chunk = max(int(self.config.tile_batch), 1)
        ramp = _ramp_nd(tsizes, overlaps)
        acc = None
        weight = np.zeros((*spatial, 1), np.float32)
        for i in range(0, len(coords), chunk):
            batch = np.stack([cut(s) for s in coords[i : i + chunk]])
            out = self._predict_direct(batch, specs)
            if out.ndim != len(spatial) + 2:
                raise ValueError(
                    f"tiled prediction requires dense spatial outputs, "
                    f"model '{self.model_id}' returned {out.shape}"
                )
            if acc is None:
                acc = np.zeros((*spatial, out.shape[-1]), np.float32)
            for tile_out, start in zip(out, coords[i : i + chunk]):
                dst = tuple(
                    slice(s0, min(s0 + t, size))
                    for s0, t, size in zip(start, tsizes, spatial)
                )
                src = tuple(slice(0, s.stop - s.start) for s in dst)
                acc[dst] += tile_out[src] * ramp[src]
                weight[dst] += ramp[src]
        return acc / np.maximum(weight, 1e-8)

    def _predict_tiled_pipelined(
        self, images: np.ndarray, specs: list["_AxisSpec"]
    ) -> np.ndarray:
        """All batch items' tiles stream through one overlapped pipeline.
        Chunk composition equals the serial path's (per item, tiles in
        coordinate order, ``tile_batch`` per chunk), so the result is
        bit-identical to ``predict_serial``."""
        cfg = self.config
        B = images.shape[0]
        C = images.shape[-1]
        spatial = images.shape[1:-1]
        plan = self._tile_plan(spatial, specs)
        tsizes, overlaps, coords, buckets = (
            plan.tsizes, plan.overlaps, plan.coords, plan.buckets,
        )
        chunk = max(int(cfg.tile_batch), 1)
        ramp = _ramp_nd(tsizes, overlaps)

        # dst/src slices and the blend weight are the same for every item;
        # the weight is summed in tile order, as the serial path sums it
        dst_src = []
        weight = np.zeros((*spatial, 1), np.float32)
        for start in coords:
            dst = tuple(
                slice(s0, min(s0 + t, size))
                for s0, t, size in zip(start, tsizes, spatial)
            )
            src = tuple(slice(0, s.stop - s.start) for s in dst)
            dst_src.append((dst, src))
            weight[dst] += ramp[src]

        descs = [
            (b, i0, min(i0 + chunk, len(coords)))
            for b in range(B)
            for i0 in range(0, len(coords), chunk)
        ]
        # build every program the run needs before its threads start, so
        # no graph capture runs beside the staging thread
        for n in sorted({i1 - i0 for _, i0, i1 in descs}):
            self._program(
                (bucket_batch(n), *buckets, C), images.dtype
            )
        pool = self._staging_pool
        stats = self.pipeline_stats
        state: dict[str, Any] = {"acc": None}

        def fill(desc):
            b, i0, i1 = desc
            n = i1 - i0
            item = images[b]
            buf = pool.acquire(
                (bucket_batch(n), *buckets, C), images.dtype
            )
            tile_region = tuple(slice(0, t) for t in tsizes)
            for j, start in enumerate(coords[i0:i1]):
                sl = tuple(slice(s0, s0 + t) for s0, t in zip(start, tsizes))
                buf[(j, *tile_region)] = item[sl]
                # reused buffers hold stale data: zero the pad margin
                # between the tile extent and the bucket extent
                for ax, (t, bkt) in enumerate(zip(tsizes, buckets)):
                    if bkt > t:
                        idx = [j, *([slice(None)] * (len(buckets) + 1))]
                        idx[1 + ax] = slice(t, bkt)
                        buf[tuple(idx)] = 0
            buf[n:] = 0  # stale rows from a previous, fuller chunk
            return buf, n

        def dispatch(desc, staged):
            buf, n = staged
            program = self._program(buf.shape, buf.dtype)
            self._wait_params_ready()  # streamed loading: see _predict_direct
            handle, put_s, dispatch_s = self._launch(program, buf)
            stats.add(put_seconds=put_s, dispatch_seconds=dispatch_s)
            return handle, buf, n

        def force(handle):
            out, buf, n = handle
            host = out.result()
            # the chunk's copy to the device precedes its readback on the
            # stream, so its pinned staging buffer is free again
            pool.release(buf)
            return host[:n]

        def stitch(desc, host):
            b, i0, i1 = desc
            if host.ndim != len(spatial) + 2:
                raise ValueError(
                    f"tiled prediction requires dense spatial outputs, "
                    f"model '{self.model_id}' returned {host.shape}"
                )
            if state["acc"] is None:
                state["acc"] = np.zeros((B, *spatial, host.shape[-1]), np.float32)
            acc_b = state["acc"][b]
            for tile_out, (dst, src) in zip(host, dst_src[i0:i1]):
                acc_b[dst] += tile_out[src] * ramp[src]

        run_pipeline(
            descs,
            fill=fill,
            dispatch=dispatch,
            force=force,
            stitch=stitch,
            depth=cfg.pipeline_depth,
            prefetch=cfg.pipeline_prefetch,
            stats=stats,
        )
        stats.add(items=B)
        return state["acc"] / np.maximum(weight, 1e-8)


@dataclasses.dataclass(frozen=True)
class _AxisSpec:
    """Tiling/bucketing parameters for one spatial axis."""

    tile: int
    overlap: int
    ladder: tuple
    divisor: int
    max_tile: int


@dataclasses.dataclass(frozen=True)
class _TilePlan:
    """Shared tiling geometry: clamped tile sizes/overlaps, tile start
    coordinates (row-major), and the spatial bucket the tiles pad to."""

    tsizes: list[int]
    overlaps: list[int]
    coords: list[tuple[int, ...]]
    buckets: tuple[int, ...]


def _tile_starts(size: int, tile: int, overlap: int) -> list[int]:
    """Start offsets covering [0, size) with ``overlap`` between tiles;
    the last tile is clamped so it ends exactly at ``size``."""
    stride = max(tile - overlap, 1)
    starts = {
        min(s, max(size - tile, 0))
        for s in range(0, max(size - overlap, 1), stride)
    }
    return sorted(starts)


def _ramp_1d(tile: int, overlap: int) -> np.ndarray:
    """Linear edge ramp of length ``tile``, 1.0 in the interior."""
    r = np.ones(tile, np.float32)
    if overlap > 0:
        edge = np.linspace(1.0 / (overlap + 1), 1.0, overlap, dtype=np.float32)
        r[:overlap] = edge
        r[-overlap:] = edge[::-1]
    return r


def _ramp_nd(tiles: list[int], overlaps: list[int]) -> np.ndarray:
    """Separable blend ramp over N spatial axes, shape (*tiles, 1)."""
    ramp = np.ones((), np.float32)
    for t, o in zip(tiles, overlaps):
        ramp = ramp[..., None] * _ramp_1d(t, o)
    return ramp[..., None]
