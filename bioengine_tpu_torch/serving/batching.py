"""Continuous batching for inference replicas.

Named in the north star (BASELINE.json: "route inference requests to TPU
replicas with continuous batching") and absent from the reference, which
forwards each request individually to the torch pipeline
(ref apps/model-runner/runtime_deployment.py:234-312).

Requests accumulate in an async queue; a drainer groups them by a
caller-provided signature (e.g. model id + shape bucket) and invokes the
batch function once per group. Groups close when ``max_batch`` is
reached or ``max_wait_ms`` elapses since the group's first request —
latency is bounded while the TPU sees large batches. Pairs with the
shape-bucketed InferenceEngine: batching by bucket signature means one
compiled program per flush.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Hashable, Optional

from bioengine_tpu_torch.utils import metrics, tracing
from bioengine_tpu_torch.utils.tasks import spawn_supervised

# One source for the batching knob defaults: the in-replica batcher,
# the operator-facing manifest knobs (deployment_config.<dep>.batching,
# surfaced through DeploymentSpec and injected as
# ``instance.bioengine_batch_config``), and the controller scheduler's
# cross-replica groups all read these instead of re-hardcoding.
DEFAULT_MAX_BATCH = 8
DEFAULT_MAX_WAIT_MS = 10.0


@dataclass
class PendingRequest:
    payload: Any
    future: asyncio.Future
    enqueued_at: float = field(default_factory=time.monotonic)
    # sampled-trace identity captured at submit: queue-wait is only
    # measurable at flush time, so the span is recorded retroactively
    # against the submitter's trace (None when unsampled — free).
    # parent_span is the submitter's enclosing span (replica.execute)
    # — the flush task's contextvars can't provide it
    trace_ctx: Any = None
    parent_span: Optional[str] = None


def _collect_batchers(instances: list) -> list:
    """Fold live ContinuousBatcher stats into process metrics: request
    and batch counters plus queue-wait quantiles. The stats dict stays
    the one bookkeeper; this is a scrape-time reader."""
    requests = batches = batched = 0
    waits: list[float] = []
    occupancy: list[int] = []
    for b in instances:
        requests += b._stats["requests"]
        batches += b._stats["batches"]
        batched += b._stats["batched_requests"]
        waits.extend(b._wait_samples)
        occupancy.extend(b._occupancy_samples)
    out = [
        metrics.Sample(
            "batcher_requests_total", requests, kind="counter",
            help="requests submitted to continuous batchers",
        ),
        metrics.Sample(
            "batcher_batches_total", batches, kind="counter",
            help="batch flushes executed",
        ),
        metrics.Sample(
            "batcher_batched_requests_total", batched, kind="counter",
            help="requests served through a batched flush",
        ),
    ]
    if waits:
        waits.sort()
        out.append(
            metrics.Sample(
                "batcher_queue_wait_ms",
                round(1000 * waits[len(waits) // 2], 3),
                {"quantile": "p50"},
                help="recent queue wait before flush",
            )
        )
        out.append(
            metrics.Sample(
                "batcher_queue_wait_ms",
                round(
                    1000
                    * waits[min(int(len(waits) * 0.95), len(waits) - 1)],
                    3,
                ),
                {"quantile": "p95"},
                help="recent queue wait before flush",
            )
        )
    if occupancy:
        # per-flush group size over a recent window — how full the
        # batches the TPU actually saw were (the throughput half of the
        # batching trade; queue_wait is the latency half)
        occupancy.sort()
        for q, idx in (
            ("p50", len(occupancy) // 2),
            ("p95", min(int(len(occupancy) * 0.95), len(occupancy) - 1)),
        ):
            out.append(
                metrics.Sample(
                    "batcher_occupancy",
                    occupancy[idx],
                    {"quantile": q},
                    help="recent per-flush batch size",
                )
            )
        out.append(
            metrics.Sample(
                "batcher_occupancy",
                round(sum(occupancy) / len(occupancy), 3),
                {"quantile": "mean"},
                help="recent per-flush batch size",
            )
        )
    return out


_BATCHERS = metrics.InstanceSet("continuous_batcher", _collect_batchers)


BatchFn = Callable[[Hashable, list[Any]], Awaitable[list[Any]]]


class ContinuousBatcher:
    """``submit(signature, payload)`` -> awaitable per-request result.

    ``batch_fn(signature, payloads) -> results`` runs once per flushed
    group; results map 1:1 onto payload order.
    """

    def __init__(
        self,
        batch_fn: BatchFn,
        max_batch: int = DEFAULT_MAX_BATCH,
        max_wait_ms: float = DEFAULT_MAX_WAIT_MS,
    ):
        self.batch_fn = batch_fn
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._groups: dict[Hashable, list[PendingRequest]] = {}
        self._flush_tasks: dict[Hashable, asyncio.Task] = {}
        self._inflight_flushes: set[asyncio.Task] = set()
        self._stats = {"requests": 0, "batches": 0, "batched_requests": 0}
        # queue-wait samples (seconds), recorded per request at group
        # flush; bounded so stats cost stays flat under load
        self._wait_samples: deque[float] = deque(maxlen=1024)
        # per-flush group sizes over the same bounded window — the
        # occupancy histogram GET /metrics serves as batcher_occupancy
        self._occupancy_samples: deque[int] = deque(maxlen=1024)
        self._closed = False
        _BATCHERS.add(self)

    async def submit(self, signature: Hashable, payload: Any) -> Any:
        if self._closed:
            raise RuntimeError("batcher is closed")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        group = self._groups.setdefault(signature, [])
        ctx = tracing.current_trace()
        sampled = ctx is not None and ctx.sampled
        group.append(
            PendingRequest(
                payload,
                fut,
                trace_ctx=ctx if sampled else None,
                parent_span=tracing.current_span_id() if sampled else None,
            )
        )
        self._stats["requests"] += 1
        if len(group) >= self.max_batch:
            self._cancel_timer(signature)
            # NEVER run the flush inside the submitting coroutine: if
            # this submitter is cancelled while batch_fn is mid-flight,
            # the cancellation would kill the batch and strand every
            # other future in the group. A supervised task's lifetime
            # is independent of any one submitter.
            self._spawn_flush(signature)
        elif signature not in self._flush_tasks:
            self._flush_tasks[signature] = asyncio.create_task(
                self._timed_flush(signature)
            )
        return await fut

    def _spawn_flush(self, signature: Hashable) -> None:
        # pop the group SYNCHRONOUSLY (same event-loop tick as the
        # size check): if the pop waited for the spawned task's first
        # run, a burst of submits in one tick would all see a full
        # group and batch_fn would receive more than max_batch
        group = self._groups.pop(signature, [])
        if not group:
            return
        task = spawn_supervised(
            self._run_batch(signature, group),
            name=f"batcher-flush-{signature!r}",
        )
        self._inflight_flushes.add(task)
        task.add_done_callback(self._inflight_flushes.discard)

    async def _timed_flush(self, signature: Hashable) -> None:
        try:
            await asyncio.sleep(self.max_wait_ms / 1000.0)
            # Deregister BEFORE the (awaitable) flush: a request arriving
            # for this signature while batch_fn runs must see no timer
            # and schedule its own, or it would wait forever. The flush
            # itself runs detached for the same reason as in submit —
            # close() cancelling this timer must not kill a mid-flight
            # batch_fn.
            self._flush_tasks.pop(signature, None)
            self._spawn_flush(signature)
        except asyncio.CancelledError:
            self._flush_tasks.pop(signature, None)
            raise

    def _cancel_timer(self, signature: Hashable) -> None:
        task = self._flush_tasks.pop(signature, None)
        if task:
            task.cancel()

    async def _flush(self, signature: Hashable) -> None:
        group = self._groups.pop(signature, [])
        if not group:
            return
        await self._run_batch(signature, group)

    async def _run_batch(
        self, signature: Hashable, group: list[PendingRequest]
    ) -> None:
        self._stats["batches"] += 1
        self._stats["batched_requests"] += len(group)
        self._occupancy_samples.append(len(group))
        now = time.monotonic()
        now_wall = time.time()
        self._wait_samples.extend(now - r.enqueued_at for r in group)
        for r in group:
            if r.trace_ctx is not None:
                wait = now - r.enqueued_at
                # parent = the submitter's enclosing span, started_at
                # back-dated to the enqueue — the span sorts where the
                # wait actually happened in the tree
                tracing.record_span(
                    "batch.queue",
                    wait,
                    started_at=now_wall - wait,
                    parent_id=r.parent_span,
                    ctx=r.trace_ctx,
                    batch_size=len(group),
                )
        try:
            results = await self.batch_fn(
                signature, [r.payload for r in group]
            )
            if len(results) != len(group):
                raise RuntimeError(
                    f"batch_fn returned {len(results)} results for "
                    f"{len(group)} requests"
                )
            for req, res in zip(group, results):
                if not req.future.done():
                    req.future.set_result(res)
        except Exception as e:
            for req in group:
                if not req.future.done():
                    req.future.set_exception(e)

    async def close(self) -> None:
        self._closed = True
        for signature in list(self._groups):
            self._cancel_timer(signature)
            await self._flush(signature)
        # drain flushes already in flight — close() is a real barrier,
        # not a fire-and-forget (results land before shutdown proceeds)
        while self._inflight_flushes:
            await asyncio.gather(
                *list(self._inflight_flushes), return_exceptions=True
            )

    @property
    def stats(self) -> dict:
        s = dict(self._stats)
        s["avg_batch_size"] = (
            s["batched_requests"] / s["batches"] if s["batches"] else 0.0
        )
        # how long requests sat in the queue before their group flushed
        # (from PendingRequest.enqueued_at) — the latency cost of
        # batching, observable next to the throughput win
        waits = sorted(self._wait_samples)
        if waits:
            s["queue_wait_ms"] = {
                "p50": round(1000 * waits[len(waits) // 2], 3),
                "p95": round(1000 * waits[min(int(len(waits) * 0.95), len(waits) - 1)], 3),
                "samples": len(waits),
            }
        else:
            s["queue_wait_ms"] = {"p50": 0.0, "p95": 0.0, "samples": 0}
        occ = sorted(self._occupancy_samples)
        if occ:
            s["occupancy"] = {
                "p50": occ[len(occ) // 2],
                "p95": occ[min(int(len(occ) * 0.95), len(occ) - 1)],
                "mean": round(sum(occ) / len(occ), 3),
                "samples": len(occ),
            }
        else:
            s["occupancy"] = {"p50": 0, "p95": 0, "mean": 0.0, "samples": 0}
        return s
