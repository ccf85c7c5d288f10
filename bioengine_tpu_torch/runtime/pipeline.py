"""Overlapped inference pipeline: bounded-depth asynchronous dispatch.

Own copy of ``bioengine_tpu/runtime/pipeline.py``, same semantics:

    staging thread   cut/pad chunk k+1 into a reusable staging buffer
    caller thread    copy in + launch chunk k (returns at once),
                     wait for the readback of chunk k-depth+1
    stitch thread    ramp-blend chunk k-depth into the accumulator

``run_pipeline`` keeps at most ``depth`` chunks in flight on the device
and at most ``prefetch`` staged chunks on the host, and accounts every
stage in a ``PipelineStats``. ``StagingPool`` recycles host staging
buffers per (shape, dtype); for an engine on the card it hands out
page-locked (pinned) buffers, numpy views of
``torch.empty(..., pin_memory=True)``, so host-to-device copies run
asynchronously. ``DispatchExecutor`` is the async front door: one
long-lived dispatch thread per engine. Every live ``PipelineStats``
folds into the ``pipeline_*`` process metrics at scrape time.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from bioengine_tpu_torch.utils import metrics


def _collect_pipelines(instances: list) -> list:
    """Fold every live PipelineStats into process totals for the metrics
    plane: the same objects ``describe()`` reads per engine, summed to the
    device-busy/overlap signal a scheduler wants per worker."""
    fields = (
        "runs", "chunks", "items", "cut_seconds", "put_seconds",
        "dispatch_seconds", "compute_seconds", "readback_seconds",
        "stitch_seconds", "wall_seconds",
    )
    totals = dict.fromkeys(fields, 0.0)
    for st in instances:
        with st._lock:
            for f in fields:
                totals[f] += getattr(st, f)
    return [
        metrics.Sample(
            f"pipeline_{name}",
            round(value, 4),
            kind="counter",
            help=f"overlapped-pipeline cumulative {name.replace('_', ' ')}",
        )
        for name, value in totals.items()
    ]


_PIPELINE_STATS = metrics.InstanceSet("pipeline_stats", _collect_pipelines)


class PipelineStats:
    """Cumulative per-stage accounting for one engine's pipeline.

    ``compute_seconds`` is the estimated device-busy time: chunks run one
    after another on one device, so chunk *i* occupies it from max(its
    dispatch, the previous readback completing) until its own readback
    completes. ``overlap_efficiency`` = device-busy / wall; 1.0 means the
    device never waited on the host.
    """

    _FIELDS = (
        "runs",
        "chunks",
        "items",
        "cut_seconds",
        "put_seconds",
        "dispatch_seconds",
        "compute_seconds",
        "readback_seconds",
        "stitch_seconds",
        "wall_seconds",
    )

    def __init__(self, depth: int = 0):
        self._lock = threading.Lock()
        self.depth = depth
        self.max_in_flight = 0
        for name in self._FIELDS:
            setattr(self, name, 0)
        _PIPELINE_STATS.add(self)

    def add(self, **deltas: float) -> None:
        with self._lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)

    def observe_in_flight(self, n: int) -> None:
        with self._lock:
            if n > self.max_in_flight:
                self.max_in_flight = n

    @property
    def overlap_efficiency(self) -> float:
        with self._lock:
            wall = self.wall_seconds
            busy = self.compute_seconds
        return busy / wall if wall > 0 else 0.0

    def as_dict(self) -> dict:
        with self._lock:
            d = {name: getattr(self, name) for name in self._FIELDS}
            d["depth"] = self.depth
            d["max_in_flight"] = self.max_in_flight
        for key in list(d):
            if key.endswith("_seconds"):
                d[key] = round(d[key], 4)
        d["overlap_efficiency"] = round(self.overlap_efficiency, 4)
        return d


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


class StagingPool:
    """Free-list of reusable host staging buffers keyed by (shape, dtype).

    ``acquire`` hands back a released buffer when one is there (its
    contents are STALE: the caller overwrites the rows it uses and zeroes
    the rest) and allocates otherwise. With ``pinned`` the buffers are
    page-locked; a buffer may go back to the pool only once the copy that
    reads it has finished."""

    def __init__(self, pinned: bool = False):
        self.pinned = pinned
        self._free: dict[tuple, list[np.ndarray]] = {}
        self._lock = threading.Lock()
        self.allocated = 0  # lifetime allocations (reuse effectiveness)

    def acquire(self, shape: tuple, dtype) -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            stack = self._free.get(key)
            if stack:
                return stack.pop()
            self.allocated += 1
        if not self.pinned:
            return np.zeros(shape, dtype)
        return torch.zeros(tuple(shape), dtype=torch_dtype(dtype), pin_memory=True).numpy()

    def release(self, buf: np.ndarray) -> None:
        key = (buf.shape, buf.dtype.str)
        with self._lock:
            self._free.setdefault(key, []).append(buf)


class DispatchExecutor:
    """One long-lived dispatch thread per engine. Coroutines submit whole
    predictions here and await the future; one thread serialises device
    access instead of a thread per call."""

    def __init__(self, name: str = "engine-dispatch"):
        self._name = name
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._closed = False

    def submit(self, fn: Callable, *args: Any, **kwargs: Any) -> Future:
        with self._lock:
            if self._closed:
                # terminal: a submit after close must not start a new thread
                raise RuntimeError(f"dispatcher '{self._name}' is closed")
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=self._name
                )
            return self._pool.submit(fn, *args, **kwargs)

    def close(self) -> None:
        """Terminal and idempotent; already-submitted work still runs."""
        with self._lock:
            self._closed = True
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)


_DONE = object()


def run_pipeline(
    descs: Iterable[Any],
    *,
    fill: Callable[[Any], Any],
    dispatch: Callable[[Any, Any], Any],
    force: Callable[[Any], Any],
    stitch: Callable[[Any, Any], None],
    depth: int,
    stats: PipelineStats,
    prefetch: Optional[int] = None,
) -> None:
    """Stream ``descs`` through fill -> dispatch -> force -> stitch.

    - ``fill(desc)`` (staging thread): host prep, returns the staged payload.
    - ``dispatch(desc, staged)`` (caller thread): hand the chunk to the
      device, return a handle WITHOUT waiting for the device.
    - ``force(handle)`` (caller thread): wait until the result is on the
      host, return it.
    - ``stitch(desc, host)`` (stitch thread): fold the result into the
      caller's accumulator.

    At most ``depth`` dispatched-but-unforced chunks exist at any time and
    at most ``prefetch`` staged chunks wait on the host. An exception in
    any stage aborts the pipeline and re-raises in the caller. Returns
    when every desc has been stitched."""
    depth = max(int(depth), 1)
    prefetch = depth if prefetch is None else max(int(prefetch), 1)
    cut_q: queue.Queue = queue.Queue(maxsize=prefetch)
    stitch_q: queue.Queue = queue.Queue(maxsize=depth + 1)
    stop = threading.Event()
    errors: list[BaseException] = []

    def _put(q: queue.Queue, item: Any) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def cut_worker() -> None:
        try:
            for desc in descs:
                if stop.is_set():
                    return
                t0 = time.perf_counter()
                staged = fill(desc)
                stats.add(cut_seconds=time.perf_counter() - t0)
                if not _put(cut_q, (desc, staged)):
                    return
            _put(cut_q, _DONE)
        except BaseException as exc:  # noqa: BLE001 — re-raised in caller
            errors.append(exc)
            stop.set()

    def stitch_worker() -> None:
        try:
            while not stop.is_set():
                try:
                    item = stitch_q.get(timeout=0.05)
                except queue.Empty:
                    continue
                if item is _DONE:
                    return
                desc, host = item
                t0 = time.perf_counter()
                stitch(desc, host)
                stats.add(stitch_seconds=time.perf_counter() - t0)
        except BaseException as exc:  # noqa: BLE001 — re-raised in caller
            errors.append(exc)
            stop.set()

    cut_t = threading.Thread(target=cut_worker, name="pipeline-cut", daemon=True)
    stitch_t = threading.Thread(
        target=stitch_worker, name="pipeline-stitch", daemon=True
    )
    cut_t.start()
    stitch_t.start()

    window: deque = deque()  # (desc, handle, dispatch_done_at)
    last_force_done: Optional[float] = None
    t_wall = time.perf_counter()

    def force_oldest() -> None:
        nonlocal last_force_done
        desc, handle, dispatched_at = window.popleft()
        t0 = time.perf_counter()
        host = force(handle)
        done = time.perf_counter()
        busy_from = dispatched_at
        if last_force_done is not None and last_force_done > busy_from:
            busy_from = last_force_done
        stats.add(
            readback_seconds=done - t0,
            compute_seconds=max(done - busy_from, 0.0),
        )
        last_force_done = done
        _put(stitch_q, (desc, host))

    try:
        while not stop.is_set():
            try:
                item = cut_q.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is _DONE:
                break
            desc, staged = item
            handle = dispatch(desc, staged)
            window.append((desc, handle, time.perf_counter()))
            stats.add(chunks=1)
            stats.observe_in_flight(len(window))
            if len(window) >= depth:
                force_oldest()
        while window and not stop.is_set():
            force_oldest()
        _put(stitch_q, _DONE)
    except BaseException:
        stop.set()
        raise
    finally:
        # unbounded joins: both workers exit promptly once the stream ends
        # or ``stop`` is set, and the caller reads the accumulator right
        # after this returns
        cut_t.join()
        stitch_t.join()
        stats.add(wall_seconds=time.perf_counter() - t_wall, runs=1)
    if errors:
        raise errors[0]
