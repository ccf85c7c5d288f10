"""Replica — one health-checked instance of an app deployment pinned to
a device set.

The reference's unit is a Ray Serve replica actor wrapped by AppBuilder:
``__init__`` registers the replica, ``async_init`` does async setup,
``test_deployment`` runs once in the background, ``check_health``
orchestrates init -> test -> datasets ping -> user health check
(ref bioengine/apps/builder.py:532-890). This class reproduces that
lifecycle chain without Ray: the instance is a plain Python object
constructed from the app build, pinned to chips accounted in
ClusterState, driven by the controller's health loop.

Scaling stays XLA-friendly: a replica owns a FIXED device set for its
whole life, so its compiled programs never re-shard (SURVEY.md §7
"Replica elasticity vs. XLA's static world" — scale in units of whole
replicas).
"""

from __future__ import annotations

import asyncio
import enum
import os
import time
import traceback
import uuid
from typing import Any, Callable, Optional

from bioengine_tpu_torch.serving.errors import ReplicaUnavailableError
from bioengine_tpu_torch.utils import flight, metrics, tracing
from bioengine_tpu_torch.utils.logger import create_logger

DEFAULT_DRAIN_TIMEOUT_S = float(
    os.environ.get("BIOENGINE_DRAIN_TIMEOUT_S", "30")
)

# per-replica request telemetry: the counter REPLACES the old private
# _total_requests int (describe() reads it back — one bookkeeper), the
# histograms are what GET /metrics serves labeled by deployment+replica
REPLICA_REQUESTS = metrics.counter(
    "replica_requests_total",
    "requests executed by a replica instance",
    ("app", "deployment", "replica"),
)
REPLICA_LATENCY = metrics.histogram(
    "replica_request_seconds",
    "instance method execution time on the replica (post-semaphore)",
    ("app", "deployment", "replica"),
)
REPLICA_PARK = metrics.histogram(
    "replica_park_seconds",
    "time a call waited on the replica's request semaphore",
    ("app", "deployment", "replica"),
)
# the cost feature the future scheduler consumes (ROADMAP item 1):
# device-seconds per request = engine wall seconds x mesh width,
# accumulated HOST-side where the replica executes (utils/tracing.py
# chip accumulator; engines feed it from predict). Always on — this is
# accounting, not optional telemetry.
CHIP_SECONDS = metrics.counter(
    "chip_seconds_total",
    "device-seconds consumed serving requests (engine wall time x mesh width)",
    ("app", "deployment", "method"),
)


class ReplicaState(str, enum.Enum):
    STARTING = "STARTING"
    INITIALIZING = "INITIALIZING"
    TESTING = "TESTING"
    HEALTHY = "HEALTHY"
    UNHEALTHY = "UNHEALTHY"
    # gray failure: alive and passing health checks but a latency
    # outlier vs its deployment siblings (serving/outlier.py). Routable
    # — the replica CAN serve — but the router/scheduler soft-eject it
    # from the scored pick, sending only a trickle of probe traffic
    # until its latency recovers. Assigned controller-side (like
    # breaker ejections); health checks preserve it, latency evidence
    # clears it.
    PROBATION = "PROBATION"
    DRAINING = "DRAINING"          # no new calls; in-flight may finish
    STOPPED = "STOPPED"

# states a replica will EXECUTE new calls in (PROBATION serves probe /
# last-resort traffic — slow is not dead); the router and scheduler
# additionally skip PROBATION in their scored picks
ROUTABLE_STATES = (
    ReplicaState.HEALTHY,
    ReplicaState.TESTING,
    ReplicaState.PROBATION,
)


class ReplicaStateMixin:
    """``state`` as a flight-recorded property: every lifecycle
    transition (including ones assigned from the controller — breaker
    ejections, drains) lands in the postmortem ring with from/to and
    the replica's identity. Shared by :class:`Replica` and
    :class:`bioengine_tpu_torch.serving.remote.RemoteReplica` so local and
    remote replicas leave the same evidence trail."""

    _state: Optional[ReplicaState] = None

    @property
    def state(self) -> ReplicaState:
        return self._state

    @state.setter
    def state(self, value: ReplicaState) -> None:
        old = self._state
        self._state = value
        if old is None or old == value:
            return
        flight.record(
            "replica.state",
            replica=getattr(self, "replica_id", "?"),
            app=getattr(self, "app_id", "?"),
            deployment=getattr(self, "deployment_name", "?"),
            host=getattr(self, "host_id", None),
            **{"from": old.value, "to": value.value},
        )


class Replica(ReplicaStateMixin):
    def __init__(
        self,
        app_id: str,
        deployment_name: str,
        instance_factory: Callable[[], Any],
        device_ids: Optional[list[int]] = None,
        max_ongoing_requests: int = 10,
        log_sink: Optional[Callable[[str, str], None]] = None,
        drain_timeout_s: float = DEFAULT_DRAIN_TIMEOUT_S,
        batch_config: Optional[dict] = None,
        mesh_shard: Optional[dict] = None,
    ):
        self.app_id = app_id
        self.deployment_name = deployment_name
        self.replica_id = f"{deployment_name}-{uuid.uuid4().hex[:8]}"
        self.device_ids = device_ids or []
        self.state = ReplicaState.STARTING
        self.max_ongoing_requests = max_ongoing_requests
        self.drain_timeout_s = drain_timeout_s
        self.batch_config = dict(batch_config) if batch_config else None
        self.mesh_shard = dict(mesh_shard) if mesh_shard else None
        self._instance_factory = instance_factory
        self.instance: Any = None
        self._semaphore = asyncio.Semaphore(max_ongoing_requests)
        self._ongoing = 0
        self._queued = 0          # callers parked on the semaphore
        self._idle_event = asyncio.Event()
        self._idle_event.set()
        # label children bind in start(): worker_host reassigns
        # replica_id between construction and start, and the metric
        # identity must match the controller's
        self._requests_total: Optional[metrics.CounterChild] = None
        self._m_latency: Optional[metrics.HistogramChild] = None
        self._m_park: Optional[metrics.HistogramChild] = None
        # chip-seconds accounting: per-method counter children (labels
        # resolved once) + a replica-lifetime total describe() reads
        self._m_chip: dict[str, metrics.CounterChild] = {}
        self._chip_seconds = 0.0
        self._test_task: Optional[asyncio.Task] = None
        self._test_error: Optional[str] = None
        self._init_done = False
        self.started_at = time.time()
        self._started_mono = time.monotonic()
        # time-to-first-request breakdown — the number the whole
        # cold-start machinery (compile tier, streamed weights, warm
        # pool) exists to shrink. ttfr_seconds is construction -> first
        # COMPLETED request; init_seconds is the instance build +
        # async_init slice of it. Promoted warm-pool standbys re-anchor
        # at promotion (promote -> first request is the span that
        # matters to the autoscaler).
        self.ttfr: dict[str, Any] = {}
        self.promoted_from_warm_pool = False
        self._first_request_done = False
        self.last_error: Optional[str] = None
        self._log_sink = log_sink
        self.logger = create_logger(f"replica.{self.replica_id}", log_file="off")

    def _log(self, line: str) -> None:
        self.logger.info(line)
        if self._log_sink:
            self._log_sink(self.replica_id, line)

    # ---- lifecycle chain ----------------------------------------------------

    async def start(self) -> None:
        """Construct the instance and run async_init; schedule the
        one-shot background test (the reference runs test_deployment in
        the background and only reports healthy after it passes,
        ref builder.py:739-890)."""
        try:
            self.state = ReplicaState.INITIALIZING
            labels = (self.app_id, self.deployment_name, self.replica_id)
            self._requests_total = REPLICA_REQUESTS.labels(*labels)
            self._m_latency = REPLICA_LATENCY.labels(*labels)
            self._m_park = REPLICA_PARK.labels(*labels)
            self._log("constructing deployment instance")
            self.instance = self._instance_factory()
            if self.device_ids:
                # hand the leased chip group to the instance BEFORE
                # async_init so mesh-aware deployments (model-runner's
                # RuntimeDeployment) can build their device mesh over
                # exactly the chips this replica owns instead of
                # defaulting to jax.devices()[0]
                try:
                    self.instance.bioengine_device_ids = list(self.device_ids)
                except Exception as e:  # noqa: BLE001 — slots/frozen instances opt out
                    # not fatal (the instance may not be mesh-aware), but
                    # a K-chip lease that can't reach the instance means
                    # K-1 idle chips — make that diagnosable
                    self._log(
                        "could not inject device lease "
                        f"{list(self.device_ids)} into instance ({e}); "
                        "replica will run single-device"
                    )
            if self.batch_config:
                # operator-tuned batching knobs from the deployment
                # spec/manifest, injected BEFORE async_init (same
                # contract as the device lease) so instances that build
                # a ContinuousBatcher there pick them up instead of
                # their constructor defaults
                try:
                    self.instance.bioengine_batch_config = dict(
                        self.batch_config
                    )
                except Exception as e:  # noqa: BLE001 — slots/frozen instances opt out
                    self._log(
                        f"could not inject batch config "
                        f"{self.batch_config} into instance ({e})"
                    )
            if self.mesh_shard:
                # cross-host mesh placement (serving/mesh_plan.py): tell
                # the instance WHICH slice of the model this replica
                # holds ({stage, n_stages, kind, axes}) before
                # async_init — same injection contract as the device
                # lease, so a shard builds only its stage's engine and
                # params over its own chips
                try:
                    self.instance.bioengine_mesh_shard = dict(
                        self.mesh_shard
                    )
                except Exception as e:  # noqa: BLE001 — slots/frozen instances opt out
                    self._log(
                        f"could not inject mesh shard {self.mesh_shard} "
                        f"into instance ({e}); replica will build the "
                        f"full model"
                    )
            if hasattr(self.instance, "async_init"):
                await _maybe_await(self.instance.async_init())
            self._init_done = True
            self.ttfr["init_seconds"] = round(
                time.monotonic() - self._started_mono, 4
            )
            if hasattr(self.instance, "test_deployment"):
                self.state = ReplicaState.TESTING
                self._test_task = asyncio.create_task(self._run_test())
            else:
                self.state = ReplicaState.HEALTHY
            self._log(f"replica started (state={self.state})")
        except Exception as e:
            self.last_error = "".join(traceback.format_exception(e))[-2000:]
            self.state = ReplicaState.UNHEALTHY
            self._log(f"replica start failed: {e}")
            flight.record(
                "replica.error",
                severity="error",
                replica=self.replica_id,
                app=self.app_id,
                deployment=self.deployment_name,
                phase="start",
                error=str(e)[:500],
            )
            flight.dump("replica_error", replica=self.replica_id)
            raise

    async def _run_test(self) -> None:
        try:
            self._log("running test_deployment")
            await _maybe_await(self.instance.test_deployment())
            self.state = ReplicaState.HEALTHY
            self._log("test_deployment passed")
        except Exception as e:
            self._test_error = "".join(traceback.format_exception(e))[-2000:]
            self.state = ReplicaState.UNHEALTHY
            self.last_error = self._test_error
            self._log(f"test_deployment failed: {e}")
            flight.record(
                "replica.error",
                severity="error",
                replica=self.replica_id,
                app=self.app_id,
                deployment=self.deployment_name,
                phase="test_deployment",
                error=str(e)[:500],
            )
            flight.dump("replica_error", replica=self.replica_id)

    async def check_health(self) -> ReplicaState:
        """init done -> test passed -> user check_health."""
        if self.state in (
            ReplicaState.STOPPED,
            ReplicaState.UNHEALTHY,
            ReplicaState.DRAINING,
        ):
            return self.state
        if not self._init_done:
            return self.state
        if self._test_task and not self._test_task.done():
            return self.state  # still TESTING
        if self._test_error:
            return ReplicaState.UNHEALTHY
        if hasattr(self.instance, "check_health"):
            try:
                await _maybe_await(self.instance.check_health())
                # gray failure is INVISIBLE to health checks by
                # definition — a passing check must not clear a
                # controller-assigned PROBATION; only latency evidence
                # from probe traffic does (serving/outlier.py)
                if self.state != ReplicaState.PROBATION:
                    self.state = ReplicaState.HEALTHY
            except Exception as e:
                self.last_error = str(e)
                self.state = ReplicaState.UNHEALTHY
                self._log(f"user check_health failed: {e}")
        return self.state

    async def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Reject new calls, let in-flight requests finish (bounded).
        Returns True when the replica is idle, False on timeout with
        requests still running (the caller stops it anyway)."""
        if self.state in (
            ReplicaState.HEALTHY,
            ReplicaState.TESTING,
            ReplicaState.PROBATION,
            ReplicaState.INITIALIZING,
        ):
            self.state = ReplicaState.DRAINING
            self._log(f"draining ({self._ongoing} in-flight)")
            flight.record(
                "replica.drain",
                replica=self.replica_id,
                app=self.app_id,
                deployment=self.deployment_name,
                in_flight=self._ongoing,
            )
        if self._ongoing == 0:
            return True
        timeout = self.drain_timeout_s if timeout_s is None else timeout_s
        try:
            await asyncio.wait_for(self._idle_event.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            self._log(
                f"drain timed out after {timeout}s "
                f"({self._ongoing} requests stranded)"
            )
            flight.record(
                "replica.drain",
                severity="warning",
                replica=self.replica_id,
                app=self.app_id,
                deployment=self.deployment_name,
                timed_out=True,
                stranded=self._ongoing,
            )
            return False

    async def stop(self, drain_timeout_s: Optional[float] = None) -> None:
        # graceful path: a routable replica drains before it stops, so
        # undeploy/autoscale-down never strand in-flight requests
        if self.state in (
            ReplicaState.HEALTHY,
            ReplicaState.TESTING,
            ReplicaState.PROBATION,
            ReplicaState.DRAINING,
        ):
            await self.drain(drain_timeout_s)
        self.state = ReplicaState.STOPPED
        if self._test_task:
            self._test_task.cancel()
        if self.instance is not None and hasattr(self.instance, "close"):
            try:
                await _maybe_await(self.instance.close())
            except Exception as e:
                self._log(f"close() raised: {e}")
        self._log("replica stopped")

    # ---- request path -------------------------------------------------------

    async def call(self, method: str, *args, **kwargs) -> Any:
        """Invoke a method on the instance under the request semaphore.
        Semaphore occupancy IS the load signal (the reference had to fake
        HTTP traffic so Ray Serve's autoscaler could see WebRTC load,
        ref apps/proxy_deployment.py:405-442 — here the controller reads
        ``load`` directly)."""
        # TESTING is routable: init completed, the one-shot background
        # test is still running — same window in which the reference's
        # Serve replicas already accept handle calls (ref builder.py:739-811)
        if self.state not in ROUTABLE_STATES:
            raise ReplicaUnavailableError(
                f"replica {self.replica_id} not healthy ({self.state})"
            )
        fn = getattr(self.instance, method, None)
        if fn is None:
            raise AttributeError(
                f"{self.deployment_name} has no method '{method}'"
            )
        m_on = metrics.metrics_enabled()
        self._queued += 1
        t_park = time.monotonic()
        try:
            with tracing.trace_span("replica.park", replica=self.replica_id):
                await self._semaphore.acquire()
        finally:
            self._queued -= 1
        if m_on and self._m_park is not None:
            self._m_park.observe(time.monotonic() - t_park)
        try:
            # re-check after the (possibly long) semaphore wait: a drain
            # or stop that happened while this call was parked must not
            # let it execute against a torn-down instance — the typed
            # rejection makes the router fail it over instead
            if self.state not in ROUTABLE_STATES:
                raise ReplicaUnavailableError(
                    f"replica {self.replica_id} not healthy ({self.state})"
                )
            self._ongoing += 1
            self._idle_event.clear()
            if self._requests_total is not None:
                self._requests_total.inc()
            first = not self._first_request_done
            t_exec = time.monotonic()
            # chip-seconds accumulate here, where app/deployment/method
            # labels exist: engines called (directly or through the
            # batcher/dispatch thread) add wall x mesh-width into the
            # request-scoped accumulator. Batched flushes attribute the
            # whole batch's device time to the submitter whose context
            # the flush task inherited — totals stay exact, per-method
            # attribution amortizes across co-batched requests.
            acc, cs_token = tracing.start_chip_accounting()
            try:
                with tracing.trace_span(
                    "replica.execute",
                    replica=self.replica_id,
                    method=method,
                ):
                    result = await _maybe_await(fn(*args, **kwargs))
                if first and not self._first_request_done:
                    self._first_request_done = True
                    now = time.monotonic()
                    self.ttfr["first_request_seconds"] = round(
                        now - t_exec, 4
                    )
                    self.ttfr["ttfr_seconds"] = round(
                        now - self._started_mono, 4
                    )
                    # the closing event of the scale-up→first-request
                    # flight timeline (replica.place / warmpool.promote
                    # opened it, program.compile sits in between)
                    flight.record(
                        "replica.first_request",
                        replica=self.replica_id,
                        app=self.app_id,
                        deployment=self.deployment_name,
                        method=method,
                        ttfr_seconds=self.ttfr["ttfr_seconds"],
                        warm_pool=self.promoted_from_warm_pool,
                    )
                return result
            finally:
                tracing.stop_chip_accounting(cs_token)
                if acc.seconds > 0.0:
                    self._chip_seconds += acc.seconds
                    child = self._m_chip.get(method)
                    if child is None:
                        child = self._m_chip[method] = CHIP_SECONDS.labels(
                            self.app_id, self.deployment_name, method
                        )
                    child.inc(acc.seconds)
                if m_on and self._m_latency is not None:
                    self._m_latency.observe(time.monotonic() - t_exec)
                self._ongoing -= 1
                if self._ongoing == 0:
                    self._idle_event.set()
        finally:
            self._semaphore.release()

    async def call_stream(self, method: str, *args, **kwargs):
        """Streaming twin of :meth:`call`: the instance method returns
        an async iterator (a generate-style endpoint backed by
        ``serving/decode.py``) and items are yielded to the caller as
        they are produced. The semaphore slot is held for the WHOLE
        stream — an in-flight generation occupies replica capacity
        exactly like a unary call, so ``load`` and the autoscaler see
        it — and chip-seconds accounting closes when the stream does
        (the decode loop books fair-share device time into the
        request-scoped accumulator per emitted token)."""
        if self.state not in ROUTABLE_STATES:
            raise ReplicaUnavailableError(
                f"replica {self.replica_id} not healthy ({self.state})"
            )
        fn = getattr(self.instance, method, None)
        if fn is None:
            raise AttributeError(
                f"{self.deployment_name} has no method '{method}'"
            )
        m_on = metrics.metrics_enabled()
        self._queued += 1
        t_park = time.monotonic()
        try:
            with tracing.trace_span("replica.park", replica=self.replica_id):
                await self._semaphore.acquire()
        finally:
            self._queued -= 1
        if m_on and self._m_park is not None:
            self._m_park.observe(time.monotonic() - t_park)
        try:
            if self.state not in ROUTABLE_STATES:
                raise ReplicaUnavailableError(
                    f"replica {self.replica_id} not healthy ({self.state})"
                )
            self._ongoing += 1
            self._idle_event.clear()
            if self._requests_total is not None:
                self._requests_total.inc()
            t_exec = time.monotonic()
            acc, cs_token = tracing.start_chip_accounting()
            try:
                with tracing.trace_span(
                    "replica.stream",
                    replica=self.replica_id,
                    method=method,
                ):
                    result = await _maybe_await(fn(*args, **kwargs))
                    if hasattr(result, "__aiter__"):
                        async for item in result:
                            yield item
                    else:
                        # unary method called through the stream path:
                        # a one-item stream keeps the envelope uniform
                        yield result
                if not self._first_request_done:
                    self._first_request_done = True
                    now = time.monotonic()
                    self.ttfr["first_request_seconds"] = round(
                        now - t_exec, 4
                    )
                    self.ttfr["ttfr_seconds"] = round(
                        now - self._started_mono, 4
                    )
                    flight.record(
                        "replica.first_request",
                        replica=self.replica_id,
                        app=self.app_id,
                        deployment=self.deployment_name,
                        method=method,
                        ttfr_seconds=self.ttfr["ttfr_seconds"],
                        warm_pool=self.promoted_from_warm_pool,
                    )
            finally:
                tracing.stop_chip_accounting(cs_token)
                if acc.seconds > 0.0:
                    self._chip_seconds += acc.seconds
                    child = self._m_chip.get(method)
                    if child is None:
                        child = self._m_chip[method] = CHIP_SECONDS.labels(
                            self.app_id, self.deployment_name, method
                        )
                    child.inc(acc.seconds)
                if m_on and self._m_latency is not None:
                    self._m_latency.observe(time.monotonic() - t_exec)
                self._ongoing -= 1
                if self._ongoing == 0:
                    self._idle_event.set()
        finally:
            self._semaphore.release()

    async def call_bounded(
        self,
        method: str,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        timeout_s: Optional[float] = None,
    ) -> Any:
        """``call`` with a per-attempt time budget (the request path's
        entry point — a kwarg-free envelope so app methods may use any
        parameter names)."""
        coro = self.call(method, *args, **(kwargs or {}))
        if timeout_s is None:
            return await coro
        return await asyncio.wait_for(coro, timeout_s)

    async def call_batch(
        self,
        method: str,
        requests: list,
        timeout_s: Optional[float] = None,
        wire: bool = False,
    ) -> list:
        """Execute a controller-coalesced group of compatible calls.
        Each member runs the NORMAL per-call path (semaphore slot,
        routability re-check, metrics, chip accounting) concurrently —
        so all K land in the same event-loop window and an instance
        with its own ``ContinuousBatcher`` merges them into one forward
        — while per-member failures stay isolated: one member's
        exception never poisons its groupmates. Returns one envelope
        per request, in order: ``{"ok": True, "result": ...}`` or a
        failure carrying the real exception object (in-process path) /
        its type name + message (``wire=True``, the ``__batch__`` RPC
        verb — the same type-name contract RemoteError classification
        already rides)."""

        async def one(r: dict) -> dict:
            try:
                result = await self.call(
                    method, *(r.get("args") or ()), **(r.get("kwargs") or {})
                )
                return {"ok": True, "result": result}
            except Exception as e:  # noqa: BLE001 — per-member isolation is the point
                if wire:
                    return {
                        "ok": False,
                        "type": type(e).__name__,
                        "error": str(e),
                    }
                return {"ok": False, "exception": e}

        gathered = asyncio.gather(*(one(r) for r in requests))
        if timeout_s is None:
            return await gathered
        return await asyncio.wait_for(gathered, timeout_s)

    def mark_promoted(self) -> None:
        """Warm-pool standby → serving replica: re-anchor the TTFR
        clock at promotion (the pool already paid init/compile/load;
        the span an operator cares about is promote → first request)."""
        self.promoted_from_warm_pool = True
        self.ttfr["standby_seconds"] = round(
            time.monotonic() - self._started_mono, 4
        )
        self._started_mono = time.monotonic()
        self._first_request_done = False

    @property
    def load(self) -> float:
        return self._ongoing / max(1, self.max_ongoing_requests)

    def describe(self) -> dict:
        d = {
            "replica_id": self.replica_id,
            "deployment": self.deployment_name,
            "state": self.state.value,
            "device_ids": self.device_ids,
            "ongoing_requests": self._ongoing,
            "queued_requests": self._queued,
            # backed by the process-wide metrics registry (same counter
            # GET /metrics serves) — describe() is a reader, not a
            # second bookkeeper
            "total_requests": (
                int(self._requests_total.value)
                if self._requests_total is not None
                else 0
            ),
            "load": self.load,
            # device-seconds this replica's requests consumed (engine
            # wall x mesh width) — the per-replica slice of the
            # chip_seconds_total{app,deployment,method} counter
            "chip_seconds_total": round(self._chip_seconds, 6),
            # monotonic, not wall — an NTP step must not age a replica
            "uptime_seconds": time.monotonic() - self._started_mono,
            "last_error": self.last_error,
        }
        # cold-start surface: the replica-level TTFR breakdown plus the
        # per-pipeline weights/compile detail from deployments that
        # expose ``cold_start_info()`` (model-runner's RuntimeDeployment)
        cold: dict = dict(self.ttfr)
        cold["promoted_from_warm_pool"] = self.promoted_from_warm_pool
        cs_fn = getattr(self.instance, "cold_start_info", None)
        if callable(cs_fn):
            try:
                cold["pipelines"] = cs_fn()
            except Exception as e:  # noqa: BLE001 — stats never break health
                cold["pipelines"] = {"error": str(e)}
        d["cold_start"] = cold
        # deployments that run the overlapped inference pipeline expose
        # a sync ``pipeline_stats()`` (e.g. model-runner's
        # RuntimeDeployment); surface it so the controller's
        # get_app_status shows cut/put/compute/readback/stitch seconds
        # and overlap efficiency per replica
        stats_fn = getattr(self.instance, "pipeline_stats", None)
        if callable(stats_fn):
            try:
                d["pipeline_stats"] = stats_fn()
            except Exception as e:  # noqa: BLE001 — stats never break health
                d["pipeline_stats"] = {"error": str(e)}
        # mesh-aware deployments report how their leased chip group is
        # actually used (mesh shape + per-chip utilization) so the
        # controller can see sharding health, not just chip accounting
        mesh_fn = getattr(self.instance, "mesh_info", None)
        if callable(mesh_fn):
            try:
                d["mesh"] = mesh_fn()
            except Exception as e:  # noqa: BLE001 — stats never break health
                d["mesh"] = {"error": str(e)}
        # deployments that hold their own control-plane connection
        # (data proxies, federated apps) expose ``rpc_stats()`` — the
        # transport counters ride the same describe path so
        # get_app_status shows per-replica bytes moved and shm hit-rate
        rpc_fn = getattr(self.instance, "rpc_stats", None)
        if callable(rpc_fn):
            try:
                d["rpc_stats"] = rpc_fn()
            except Exception as e:  # noqa: BLE001 — stats never break health
                d["rpc_stats"] = {"error": str(e)}
        return d


async def _maybe_await(value):
    if asyncio.iscoroutine(value):
        return await value
    return value
