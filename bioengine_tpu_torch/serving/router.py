"""Router tier — the request path, split out of the controller.

Every request used to funnel through the single ``ServeController``
process; that process was the ceiling no chip count could raise. This
module is the horizontal half of the fix (ROADMAP item 2): the entire
request path — replica pick/score, the ``DeploymentHandle`` retry loop,
hedging, the circuit breaker, outlier probation, scheduler attach —
lives in :class:`RouterCore`, a mixin BOTH planes speak:

- ``ServeController(RouterCore)`` keeps the in-process path
  bit-compatible: same attribute names, same methods, same metrics.
- :class:`StandaloneRouter` is ``RouterCore`` over a locally cached,
  epoch-stamped **routing table** instead of live placement state. N of
  them scale the data plane out while the controller shrinks to
  intent + placement + table publication.

The routing table (``bioengine.routing-table/v1``) carries the replica
set with lifecycle states, mesh/host membership, per-deployment
scheduler configs, and breaker/probation hints. The controller's
:class:`RoutingTablePublisher` versions it monotonically and serves
diffs (``since_version``) over the existing RPC plane
(``serve-router.get_routing_table``); every table is stamped with the
PR 15 journal epoch, so a wedged-then-revived old controller's push is
rejected typed (:class:`~bioengine_tpu_torch.serving.errors.StaleTableError`)
and can never regress a router's newer view. A router keeps serving
from its last-good table through a controller crash/restart and
reports the table's staleness age (``router_table_staleness_seconds``).

Failure model: routers are stateless per request. Killing one loses
nothing — its gate refuses new requests typed-retryable
(:class:`~bioengine_tpu_torch.serving.errors.RouterClosedError`), so clients
fail over to a sibling router through the same PR 4 typed-retry
machinery that fails requests over between replicas. The ``router_loss``
scenario pins that at zero idempotent-request loss.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import time
from dataclasses import dataclass, field
from collections import defaultdict
from typing import Any, Callable, Optional

from bioengine_tpu_torch.rpc.protocol import RemoteError
from bioengine_tpu_torch.serving.errors import (
    AdmissionRejectedError,
    DeadlineExceeded,
    FailureKind,
    NoHealthyReplicasError,
    ReplicaUnavailableError,
    RetryableTransportError,
    RouterClosedError,
    RouterSaturatedError,
    StaleTableError,
    classify_exception,
    is_caller_timeout,
    is_retryable,
)
from bioengine_tpu_torch.serving.outlier import (
    DeploymentLatencyTracker,
    OutlierConfig,
    REPLICA_PROBATIONS,
    record_probation_event,
)
from bioengine_tpu_torch.serving.remote import RemoteReplica
from bioengine_tpu_torch.serving.replica import (
    ROUTABLE_STATES,
    Replica,
    ReplicaState,
)
from bioengine_tpu_torch.serving.scheduler import (
    DeploymentScheduler,
    HeuristicCostModel,
    SchedulingConfig,
)
from bioengine_tpu_torch.utils import flight, metrics, tracing
from bioengine_tpu_torch.utils.backoff import full_jitter_delay
from bioengine_tpu_torch.utils.logger import create_logger
from bioengine_tpu_torch.utils.tasks import spawn_supervised

TABLE_SCHEMA = "bioengine.routing-table/v1"

# ---- request-path metrics (process-wide, utils/metrics.py) ---------------
# e2e latency is what the SLO dashboard reads; outcome/failover counters
# are what the future global scheduler keys on (ROADMAP item 1)
REQUEST_E2E = metrics.histogram(
    "request_e2e_seconds",
    "end-to-end DeploymentHandle.call latency (route + retries + execute)",
    ("app", "deployment", "method"),
)
REQUEST_OUTCOMES = metrics.counter(
    "requests_total",
    "completed DeploymentHandle.call requests by outcome",
    ("app", "deployment", "outcome"),
)
REQUEST_FAILOVERS = metrics.counter(
    "request_failovers_total",
    "attempts retried on another replica after a transport failure",
    ("app", "deployment"),
)
ROUTE_WAIT = metrics.histogram(
    "route_wait_seconds",
    "time spent picking (or waiting for) a routable replica",
    ("app", "deployment"),
)
BREAKER_TRIPS = metrics.counter(
    "breaker_trips_total",
    "circuit-breaker ejections (replica marked UNHEALTHY)",
    ("app", "deployment"),
)
REQUEST_HEDGES = metrics.counter(
    "request_hedges_total",
    "hedge attempts launched for idempotent calls, by winning attempt",
    ("app", "deployment", "winner"),
)
# token-streaming request path (DeploymentHandle.call_stream):
# inter_token_seconds is the generative-serving SLO signal (slo.py's
# inter_token_ms objective reads its buckets) — the FIRST item's gap is
# time-to-first-token and lands in ttft_seconds instead, so inter-token
# percentiles aren't polluted by prefill+route time
TOKENS_GENERATED = metrics.counter(
    "tokens_generated_total",
    "stream items yielded to callers by DeploymentHandle.call_stream",
    ("app", "deployment"),
)
INTER_TOKEN = metrics.histogram(
    "inter_token_seconds",
    "gap between consecutive stream items at the caller edge",
    ("app", "deployment"),
)
TTFT = metrics.histogram(
    "ttft_seconds",
    "call_stream start to first item (route + prefill + first frame)",
    ("app", "deployment"),
)
STREAM_RESUMES = metrics.counter(
    "stream_resumes_total",
    "mid-stream failovers resumed on another replica (idempotent calls)",
    ("app", "deployment"),
)


@dataclass(frozen=True)
class RequestOptions:
    """Per-request envelope for ``DeploymentHandle.call``.

    ``deadline_s`` bounds the WHOLE request (every attempt + backoff);
    ``timeout_s`` bounds one attempt and is propagated to the serving
    host so remote work is aborted there too. ``idempotent`` opts the
    call into transparent failover: transport/placement errors retry
    on another healthy replica with exponential backoff + full jitter.
    Non-idempotent calls surface the first transport error exactly
    once, typed (``RetryableTransportError``) — never silently retried,
    because the outcome on the dead replica is ambiguous.

    ``priority`` and ``tenant`` only matter on deployments with a
    global scheduler attached: the priority class picks the
    weighted-fair queue (``interactive`` / ``bulk`` / ``background`` by
    default) and the tenant id counts against the per-tenant admission
    quota.

    ``hedge`` opts an **idempotent** call into request hedging (the
    gray-failure tail defense): when the first attempt is still
    running after a p95-derived delay (override: ``hedge_delay_s``), a
    second attempt launches on a DIFFERENT replica; the first result
    wins and the loser is cancelled — never counted against the
    breaker or the latency outlier detector (a loser cancelled by the
    winner is not replica-failure evidence). Hedging a non-idempotent
    call would double side effects, so that combination is rejected at
    construction — hedges can never fire for non-idempotent calls.
    Hedging applies to ROUTER-path deployments only: on a deployment
    with a ``scheduling:`` config the global scheduler owns placement
    (probation rides its scorer feature dict instead) and ``hedge`` is
    ignored."""

    timeout_s: Optional[float] = None
    deadline_s: Optional[float] = None
    idempotent: bool = False
    max_attempts: int = 4
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    priority: Optional[str] = None     # scheduler class; None = default
    tenant: Optional[str] = None       # admission quota bucket
    hedge: bool = False                # idempotent-only tail hedging
    hedge_delay_s: Optional[float] = None  # None = deployment p95

    def __post_init__(self):
        if self.hedge and not self.idempotent:
            raise ValueError(
                "RequestOptions(hedge=True) requires idempotent=True — "
                "a hedge is a silent second execution, which a "
                "non-idempotent call can never tolerate"
            )

    @classmethod
    def from_env(cls) -> "RequestOptions":
        env = os.environ.get
        return cls(
            max_attempts=int(env("BIOENGINE_REQUEST_MAX_ATTEMPTS", "4")),
            backoff_base_s=float(env("BIOENGINE_REQUEST_BACKOFF_BASE_S", "0.05")),
            backoff_cap_s=float(env("BIOENGINE_REQUEST_BACKOFF_CAP_S", "2.0")),
        )

    @classmethod
    def defaults(cls) -> "RequestOptions":
        """Env-derived defaults, read once (this sits on the hot path)."""
        global _DEFAULT_OPTIONS
        if _DEFAULT_OPTIONS is None:
            _DEFAULT_OPTIONS = cls.from_env()
        return _DEFAULT_OPTIONS


_DEFAULT_OPTIONS: Optional[RequestOptions] = None


class DeploymentHandle:
    """Client-side handle: route calls to healthy replicas (least-loaded,
    round-robin tie-break). The composition mechanism: entry deployments
    receive handles to their sibling deployments as init kwargs, same as
    the reference's DeploymentHandle binding (ref apps/builder.py:1474-1508).

    Fault tolerance: each call runs under a :class:`RequestOptions`
    envelope (pass ``options=RequestOptions(...)`` per call, or bind
    defaults with :meth:`with_options`). Transport/placement failures on
    idempotent calls fail over to another replica; during a restart
    window the router WAITS (bounded by the deadline) for a healthy
    replica instead of raising instantly.

    ``controller`` is any :class:`RouterCore` — the in-process
    ``ServeController`` or a :class:`StandaloneRouter`; the handle is
    identical either way (that IS the seam)."""

    def __init__(
        self,
        controller: "RouterCore",
        app_id: str,
        deployment: str,
        options: Optional[RequestOptions] = None,
    ):
        self._controller = controller
        self.app_id = app_id
        self.deployment = deployment
        self._options = options
        self._rr = itertools.count()
        # labeled children resolved once — labels() costs a few us of
        # str()/tuple/lock per lookup, paid per request otherwise
        self._m_route_wait = ROUTE_WAIT.labels(app_id, deployment)
        self._m_failovers = REQUEST_FAILOVERS.labels(app_id, deployment)
        self._m_e2e: dict[str, Any] = {}       # method -> histogram child
        self._m_outcomes: dict[str, Any] = {}  # outcome -> counter child
        self._m_hedges: dict[str, Any] = {}    # winner -> counter child
        # prebuilt span-attr template: the route span's attrs never
        # change for a handle, so the unsampled hot path must not
        # allocate a kwargs dict per request just to throw it away
        self._ts_route = {"app": app_id, "deployment": deployment}

    def with_options(self, options: RequestOptions) -> "DeploymentHandle":
        """A sibling handle whose calls default to ``options``."""
        return DeploymentHandle(
            self._controller, self.app_id, self.deployment, options
        )

    async def call(self, method: str, *args, **kwargs) -> Any:
        # the envelope rides a reserved kwarg, but ONLY when it is an
        # actual RequestOptions — an app method's own `options` kwarg
        # passes through untouched
        options = kwargs.pop("options", None)
        if options is not None and not isinstance(options, RequestOptions):
            kwargs["options"] = options
            options = None
        options = options or self._options or RequestOptions.defaults()

        # Observability wrapper. A trace context is minted here (the
        # client edge of the serve path) and rides the contextvar
        # through routing, the RPC envelope (capability-negotiated),
        # the host's replica, batcher, and engine — get_traces
        # reassembles one cross-process tree per trace_id. Head
        # sampling (BIOENGINE_TRACE_SAMPLE) keeps the unsampled path
        # at one id mint + a few counter bumps; BIOENGINE_TRACING=0
        # removes even that (the bench's baseline leg) — but metrics
        # and slow-request logging have their OWN knobs and keep
        # working with tracing off. If a sampled trace is ALREADY
        # active (a composition call routed back through serve-router),
        # nest under it instead of minting.
        parent = tracing.current_trace()
        ctx = parent if parent is not None else tracing.maybe_start_trace()
        token = (
            tracing.activate(ctx)
            if ctx is not None and parent is None
            else None
        )
        # standalone routers gate admission here (closed → typed
        # failover to a sibling router; saturated → typed shed); the
        # in-process controller keeps the gate at None, so its cost on
        # that path is one attribute load and a None check
        gate = self._controller._router_gate
        entered = False
        t0 = time.monotonic()
        outcome = "ok"
        try:
            if gate is not None:
                gate.enter()
                entered = True
            if ctx is not None and ctx.sampled:
                with tracing.span(
                    "request",
                    app=self.app_id,
                    deployment=self.deployment,
                    method=method,
                    trace_root=parent is None,
                ) as record:
                    result = await self._call_attempts(
                        method, args, kwargs, options
                    )
                    # per-request device cost on the TRACE ROOT: the sum
                    # of every engine.predict under this trace_id (local
                    # spans plus the ones absorbed off RESULT frames),
                    # each already engine wall-seconds x mesh width.
                    # Nested composition spans don't stamp — the whole
                    # trace's cost belongs to exactly one root.
                    if parent is None:
                        cs = tracing.trace_attr_sum(
                            ctx.trace_id, "engine.predict", "chip_seconds"
                        )
                        if cs:
                            record["attrs"]["chip_seconds"] = round(cs, 6)
                    return result
            return await self._call_attempts(method, args, kwargs, options)
        except Exception as e:
            kind = classify_exception(e)
            outcome = {
                FailureKind.APPLICATION: "app_error",
                FailureKind.DEADLINE: "deadline",
            }.get(kind, "transport_error")
            if isinstance(e, AdmissionRejectedError):
                # load shedding is its own outcome: an SLO dashboard
                # must tell "we said no" apart from "the app broke"
                outcome = "rejected"
            if kind is FailureKind.DEADLINE:
                # the evidence of WHY the budget was blown (breaker
                # trips, re-placements, parks) is in the ring right now
                # — snapshot it before it wraps
                flight.record(
                    "deadline.exceeded",
                    severity="error",
                    app=self.app_id,
                    deployment=self.deployment,
                    method=method,
                    trace_id=ctx.trace_id if ctx else None,
                    error=str(e)[:500],
                )
                flight.dump(
                    "deadline_exceeded",
                    app=self.app_id,
                    deployment=self.deployment,
                )
            raise
        finally:
            if entered:
                gate.leave()
            duration = time.monotonic() - t0
            if token is not None:
                tracing.deactivate(token)
            if metrics.metrics_enabled():
                e2e = self._m_e2e.get(method)
                if e2e is None:
                    e2e = self._m_e2e[method] = REQUEST_E2E.labels(
                        self.app_id, self.deployment, method
                    )
                e2e.observe(duration)
                out_c = self._m_outcomes.get(outcome)
                if out_c is None:
                    out_c = self._m_outcomes[outcome] = REQUEST_OUTCOMES.labels(
                        self.app_id, self.deployment, outcome
                    )
                out_c.inc()
            slow_ms = tracing.slow_request_threshold_ms()
            if slow_ms > 0 and duration * 1000.0 >= slow_ms:
                # structured + trace_id-stamped: grep the log line,
                # then get_traces(trace_id=...) for the breakdown
                # (trace_id=- when tracing is globally disabled)
                self._controller.logger.warning(
                    "slow_request "
                    f"trace_id={ctx.trace_id if ctx else '-'} "
                    f"app={self.app_id} "
                    f"deployment={self.deployment} method={method} "
                    f"duration_ms={duration * 1000.0:.1f} "
                    f"outcome={outcome} "
                    f"sampled={ctx.sampled if ctx else False}"
                )
                flight.record(
                    "request.slow",
                    severity="warning",
                    app=self.app_id,
                    deployment=self.deployment,
                    method=method,
                    duration_ms=round(duration * 1000.0, 1),
                    outcome=outcome,
                    trace_id=ctx.trace_id if ctx else None,
                )

    async def call_stream(self, method: str, *args, **kwargs):
        """Streaming twin of :meth:`call`: routes to one replica and
        yields items (tokens) as they arrive. Streams bypass the
        request scheduler's coalescing — step-level batching happens
        INSIDE the replica's decode loop (serving/decode.py), which is
        the whole point — but reuse the same replica pick, breaker
        bookkeeping, and failover discipline.

        Mid-stream transport failure on an idempotent call resumes on
        another replica with ``resume_from=<items already yielded>``:
        greedy decoding is deterministic, so the new replica regenerates
        and skips the prefix — the caller sees an uninterrupted,
        exactly-once token sequence (``decode.stream_resume`` in the
        flight ring marks the seam). Non-idempotent streams fail typed
        instead. Application errors are never retried."""
        options = kwargs.pop("options", None)
        if options is not None and not isinstance(options, RequestOptions):
            kwargs["options"] = options
            options = None
        options = options or self._options or RequestOptions.defaults()

        parent = tracing.current_trace()
        ctx = parent if parent is not None else tracing.maybe_start_trace()
        token = (
            tracing.activate(ctx)
            if ctx is not None and parent is None
            else None
        )
        m_on = metrics.metrics_enabled()
        deadline = (
            time.monotonic() + options.deadline_s
            if options.deadline_s is not None
            else None
        )
        tried: set[str] = set()
        yielded = 0
        base_resume = int(kwargs.get("resume_from", 0) or 0)
        attempt = 0
        t0 = time.monotonic()
        t_last: Optional[float] = None
        outcome = "ok"
        try:
            while True:
                attempt += 1
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise DeadlineExceeded(
                        f"deadline exhausted after {attempt - 1} attempt(s) "
                        f"for {self.app_id}/{self.deployment}.{method}"
                    )
                t_route = time.monotonic()
                with tracing.trace_span_t("route", self._ts_route):
                    replica = await self._controller._pick_replica_wait(
                        self.app_id, self.deployment, avoid=tried,
                        deadline=deadline,
                    )
                if m_on:
                    self._m_route_wait.observe(time.monotonic() - t_route)
                attempt_kwargs = kwargs
                if yielded > 0:
                    attempt_kwargs = dict(kwargs)
                    attempt_kwargs["resume_from"] = base_resume + yielded
                got_any_this_attempt = False
                try:
                    with (
                        tracing.span(
                            "stream_attempt",
                            replica=replica.replica_id,
                            attempt=attempt,
                        )
                        if tracing.sampled()
                        else tracing.NOOP_SPAN
                    ):
                        async for item in replica.call_stream(
                            method, *args, **attempt_kwargs
                        ):
                            now = time.monotonic()
                            if yielded == 0:
                                if m_on:
                                    self._m_ttft().observe(now - t0)
                            elif t_last is not None and m_on:
                                self._m_inter_token().observe(now - t_last)
                            t_last = now
                            yielded += 1
                            got_any_this_attempt = True
                            if m_on:
                                self._m_tokens().inc()
                            yield item
                    self._controller._breaker_success(replica)
                    return
                except Exception as e:
                    kind = classify_exception(e)
                    if kind is FailureKind.APPLICATION:
                        raise
                    if not is_caller_timeout(e):
                        self._controller._breaker_failure(replica, e)
                    tried.add(replica.replica_id)
                    if isinstance(e, DeadlineExceeded):
                        raise
                    remaining = (
                        None
                        if deadline is None
                        else deadline - time.monotonic()
                    )
                    if remaining is not None and remaining <= 0:
                        raise DeadlineExceeded(
                            f"deadline exhausted after {attempt} attempt(s): {e}"
                        ) from e
                    # once items have been yielded, ONLY an idempotent
                    # stream may resume (deterministic regeneration);
                    # before first item the not-executed rule applies
                    not_executed = isinstance(
                        e, ReplicaUnavailableError
                    ) and not isinstance(e, RemoteError)
                    if not options.idempotent and not (
                        not_executed and not got_any_this_attempt
                    ):
                        raise RetryableTransportError(
                            f"{self.app_id}/{self.deployment}.{method} "
                            f"stream failed on {replica.replica_id} after "
                            f"{yielded} item(s) (non-idempotent, not "
                            f"resumed): {e}"
                        ) from e
                    if attempt >= options.max_attempts:
                        raise RetryableTransportError(
                            f"{self.app_id}/{self.deployment}.{method} "
                            f"stream failed after {attempt} attempts "
                            f"({yielded} item(s) delivered): {e}"
                        ) from e
                    if m_on:
                        self._m_failovers.inc()
                    if yielded > 0:
                        if m_on:
                            self._m_resumes().inc()
                        flight.record(
                            "decode.stream_resume",
                            severity="warning",
                            app=self.app_id,
                            deployment=self.deployment,
                            method=method,
                            replica=replica.replica_id,
                            resume_from=base_resume + yielded,
                            attempt=attempt,
                            error=str(e)[:300],
                        )
                    else:
                        flight.record(
                            "request.failover",
                            severity="warning",
                            app=self.app_id,
                            deployment=self.deployment,
                            method=method,
                            replica=replica.replica_id,
                            attempt=attempt,
                            error=str(e)[:300],
                        )
                    delay = full_jitter_delay(
                        attempt - 1,
                        options.backoff_base_s,
                        options.backoff_cap_s,
                    )
                    if remaining is not None:
                        delay = min(delay, max(0.0, remaining))
                    await asyncio.sleep(delay)
        except Exception as e:
            kind = classify_exception(e)
            outcome = {
                FailureKind.APPLICATION: "app_error",
                FailureKind.DEADLINE: "deadline",
            }.get(kind, "transport_error")
            raise
        finally:
            if token is not None:
                tracing.deactivate(token)
            if m_on:
                e2e = self._m_e2e.get(method)
                if e2e is None:
                    e2e = self._m_e2e[method] = REQUEST_E2E.labels(
                        self.app_id, self.deployment, method
                    )
                e2e.observe(time.monotonic() - t0)
                out_c = self._m_outcomes.get(outcome)
                if out_c is None:
                    out_c = self._m_outcomes[outcome] = REQUEST_OUTCOMES.labels(
                        self.app_id, self.deployment, outcome
                    )
                out_c.inc()

    # stream-metric children resolved lazily (streams are opt-in per
    # deployment — a unary-only handle never materializes them)
    def _m_tokens(self):
        child = self.__dict__.get("_m_tokens_c")
        if child is None:
            child = self.__dict__["_m_tokens_c"] = TOKENS_GENERATED.labels(
                self.app_id, self.deployment
            )
        return child

    def _m_inter_token(self):
        child = self.__dict__.get("_m_inter_token_c")
        if child is None:
            child = self.__dict__["_m_inter_token_c"] = INTER_TOKEN.labels(
                self.app_id, self.deployment
            )
        return child

    def _m_ttft(self):
        child = self.__dict__.get("_m_ttft_c")
        if child is None:
            child = self.__dict__["_m_ttft_c"] = TTFT.labels(
                self.app_id, self.deployment
            )
        return child

    def _m_resumes(self):
        child = self.__dict__.get("_m_resumes_c")
        if child is None:
            child = self.__dict__["_m_resumes_c"] = STREAM_RESUMES.labels(
                self.app_id, self.deployment
            )
        return child

    async def _call_attempts(
        self, method: str, args: tuple, kwargs: dict, options: RequestOptions
    ) -> Any:
        deadline = (
            time.monotonic() + options.deadline_s
            if options.deadline_s is not None
            else None
        )
        key = (self.app_id, self.deployment)
        tried: set[str] = set()
        attempt = 0
        while True:
            attempt += 1
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise DeadlineExceeded(
                    f"deadline exhausted after {attempt - 1} attempt(s) "
                    f"for {self.app_id}/{self.deployment}.{method}"
                )
            scheduler = self._controller._schedulers.get(key)
            replica = None
            if scheduler is None:
                t_route = time.monotonic()
                with tracing.trace_span_t("route", self._ts_route):
                    replica = await self._controller._pick_replica_wait(
                        self.app_id, self.deployment, avoid=tried,
                        deadline=deadline,
                    )
                if metrics.metrics_enabled():
                    self._m_route_wait.observe(time.monotonic() - t_route)
                # the wait above may have parked through most of the
                # budget — recompute so the attempt (and the host-side
                # timeout it propagates) cannot overrun the deadline
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise DeadlineExceeded(
                            f"deadline exhausted while waiting for a replica "
                            f"of {self.app_id}/{self.deployment}"
                        )
            budget = _min_defined(options.timeout_s, remaining)
            self._controller._queue_depth[key] += 1
            # hedged attempts do their own breaker/latency bookkeeping
            # per sub-attempt (a cancelled loser must feed NEITHER) —
            # the outer handlers skip theirs to avoid double counting
            hedged = (
                scheduler is None
                and replica is not None
                and options.hedge
                and options.idempotent
            )
            try:
                if hedged:
                    result = await self._hedged_attempt(
                        replica, method, args, kwargs, options,
                        budget, deadline, tried, attempt,
                    )
                    return result
                # attempt attrs vary per call — gate the kwargs-dict
                # build on the sampled check instead of templating
                with (
                    tracing.span(
                        "attempt",
                        replica=replica.replica_id
                        if replica
                        else "scheduler",
                        attempt=attempt,
                    )
                    if tracing.sampled()
                    else tracing.NOOP_SPAN
                ):
                    if scheduler is None:
                        t_attempt = time.monotonic()
                        result = await replica.call_bounded(
                            method, args, kwargs, timeout_s=budget
                        )
                        # successful-attempt service time feeds the
                        # gray-failure outlier EWMA (failures measure
                        # the transport, not the replica)
                        self._controller._note_attempt_latency(
                            replica, time.monotonic() - t_attempt
                        )
                    else:
                        # the scheduler owns admission, fair queueing,
                        # group coalescing, and the scored replica pick
                        # for this attempt; breaker bookkeeping happens
                        # inside its dispatch (it saw the replica, we
                        # did not)
                        result = await scheduler.submit(
                            method,
                            args,
                            kwargs,
                            options=options,
                            timeout_s=budget,
                            deadline=deadline,
                            avoid=frozenset(tried),
                        )
                if replica is not None:
                    self._controller._breaker_success(replica)
                return result
            except Exception as e:
                kind = classify_exception(e)
                if kind is FailureKind.APPLICATION:
                    raise  # the app ran and failed — never retried
                # a timeout of the CALLER's own budget says nothing
                # about replica health — only genuine transport/placement
                # failures feed the circuit breaker
                if (
                    replica is not None
                    and not hedged
                    and not is_caller_timeout(e)
                ):
                    self._controller._breaker_failure(replica, e)
                # scheduler-dispatched failures stamp the serving
                # replica on the exception so failover can avoid it
                rid = (
                    replica.replica_id
                    if replica is not None
                    else getattr(e, "replica_id", None)
                )
                if rid is not None:
                    tried.add(rid)
                if isinstance(e, DeadlineExceeded):
                    raise
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    # the overall budget is gone — surface it AS a
                    # deadline on every path (a non-idempotent attempt
                    # whose timeout WAS the deadline cut included)
                    raise DeadlineExceeded(
                        f"deadline exhausted after {attempt} attempt(s): {e}"
                    ) from e
                # a LOCAL ReplicaUnavailableError was raised by the
                # routability check BEFORE anything was sent — zero
                # ambiguity, so even non-idempotent calls fail over
                not_executed = isinstance(
                    e, ReplicaUnavailableError
                ) and not isinstance(e, RemoteError)
                if not options.idempotent and not not_executed:
                    raise RetryableTransportError(
                        f"{self.app_id}/{self.deployment}.{method} failed in "
                        f"transport on {rid or 'scheduler'} (non-idempotent "
                        f"call, not retried): {e}"
                    ) from e
                if attempt >= options.max_attempts:
                    raise RetryableTransportError(
                        f"{self.app_id}/{self.deployment}.{method} failed "
                        f"after {attempt} attempts: {e}"
                    ) from e
                if metrics.metrics_enabled():
                    self._m_failovers.inc()
                flight.record(
                    "request.failover",
                    severity="warning",
                    app=self.app_id,
                    deployment=self.deployment,
                    method=method,
                    replica=rid,
                    attempt=attempt,
                    error=str(e)[:300],
                )
                # exponential backoff with FULL jitter, clamped to the
                # remaining deadline budget
                delay = full_jitter_delay(
                    attempt - 1, options.backoff_base_s, options.backoff_cap_s
                )
                if remaining is not None:
                    delay = min(delay, max(0.0, remaining))
                await asyncio.sleep(delay)
            finally:
                # router-state leak discipline: undeploy sweeps this
                # entry, but an in-flight retry's increment (defaultdict)
                # can resurrect it — so the decrement clamps at zero
                # (never a persistent negative, even when old-generation
                # decrements interleave with a redeploy) and a key whose
                # app is gone is swept here instead of lingering
                depth = self._controller._queue_depth
                if key in depth:
                    if depth[key] > 0:
                        depth[key] -= 1
                    if (
                        depth[key] <= 0
                        and self.app_id not in self._controller.apps
                    ):
                        depth.pop(key, None)

    # ---- request hedging (gray-failure tail defense) ------------------------

    async def _hedged_attempt(
        self,
        primary,
        method: str,
        args: tuple,
        kwargs: dict,
        options: RequestOptions,
        budget: Optional[float],
        deadline: Optional[float],
        tried: set,
        attempt: int,
    ) -> Any:
        """One attempt with tail hedging: run on ``primary``; if it is
        still in flight after the p95-derived delay, launch the SAME
        call on a different replica — first result wins, the loser is
        cancelled. Only reachable for idempotent calls (RequestOptions
        enforces that at construction; the router re-checks).

        Bookkeeping discipline — the satellite bug this pins: the
        cancelled loser feeds NEITHER the circuit breaker NOR the
        outlier EWMA (a loser cancelled by the winner is not replica-
        failure evidence, the same class of bug as the caller-budget
        breaker exemption). Only genuinely-failed sub-attempts strike
        the breaker; only the winner's wall time feeds the EWMA. Both
        sub-attempts open sibling ``attempt`` spans under the one
        trace_id, so `get_traces` shows the hedge as two children of
        the same request."""
        controller = self._controller

        async def run(target, label: str, timeout_s: Optional[float]):
            t0 = time.monotonic()
            # span opened INSIDE the task: each sub-attempt becomes its
            # own sibling under the request/route span (create_task
            # copies the context, so both inherit the same parent)
            with tracing.trace_span(
                "attempt",
                replica=target.replica_id,
                attempt=attempt,
                hedge=label,
            ):
                result = await target.call_bounded(
                    method, args, kwargs, timeout_s=timeout_s
                )
            return result, time.monotonic() - t0

        # a probe-routed request (primary in PROBATION) is the trickle
        # the recovery loop lives on: it hedges AT ONCE (delay 0 — the
        # probe exists to measure the replica, not to make one unlucky
        # caller pay the gray-latency tax), and on any exit the probe
        # attempt is DETACHED to finish in the background instead of
        # cancelled — cancelling it would throw away the one latency
        # measurement the probe exists to take, freezing the replica
        # in probation forever once every caller hedges. Bounded by
        # the attempt's own timeout budget; chip/semaphore accounting
        # settles on its normal completion path.
        probing = primary.state == ReplicaState.PROBATION
        t_primary = asyncio.create_task(run(primary, "primary", budget))
        t_hedge: Optional[asyncio.Task] = None
        detached: set = set()

        async def resolve_primary_only() -> Any:
            try:
                result, dt = await t_primary
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                # same breaker discipline as the scheduler paths: only
                # TRANSPORT-classified failures are replica-health
                # evidence — an app error (bad client input) or the
                # caller's own budget expiring must never eject a
                # healthy replica
                if not is_caller_timeout(exc) and is_retryable(exc):
                    controller._breaker_failure(primary, exc)
                raise
            controller._note_attempt_latency(primary, dt)
            controller._breaker_success(primary)
            return result

        # ONE try/finally owns both attempt tasks for the whole hedged
        # call: a caller cancellation anywhere in here (wait_for around
        # handle.call, client disconnect) must cancel the in-flight
        # attempts too — cancelling the awaiter never cancels a Task
        try:
            delay = (
                0.0
                if probing
                else controller.hedge_delay_s(
                    self.app_id, self.deployment, options
                )
            )
            done, _ = await asyncio.wait({t_primary}, timeout=delay)
            if done:
                # resolved inside the hedge window — no hedge needed;
                # this path costs one asyncio.wait over a direct await
                return await resolve_primary_only()
            try:
                hedge_replica = controller._pick_replica(
                    self.app_id,
                    self.deployment,
                    avoid=set(tried) | {primary.replica_id},
                )
            except (NoHealthyReplicasError, KeyError):
                hedge_replica = None
            hedge_budget = budget
            if deadline is not None:
                hedge_budget = _min_defined(
                    options.timeout_s, deadline - time.monotonic()
                )
                if hedge_budget is not None and hedge_budget <= 0:
                    hedge_replica = None
            if (
                hedge_replica is None
                or hedge_replica.replica_id == primary.replica_id
            ):
                # nobody distinct to hedge on (single-replica
                # deployment, or everything else already tried) — ride
                # the primary
                return await resolve_primary_only()
            t_hedge = asyncio.create_task(
                run(hedge_replica, "hedge", hedge_budget)
            )
            owners = {t_primary: primary, t_hedge: hedge_replica}
            primary_exc: Optional[BaseException] = None
            hedge_exc: Optional[BaseException] = None
            pending = set(owners)
            while pending:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED
                )
                for t in done:
                    target = owners[t]
                    exc = t.exception()
                    if exc is None:
                        result, dt = t.result()
                        winner = "primary" if t is t_primary else "hedge"
                        controller._note_attempt_latency(target, dt)
                        controller._breaker_success(target)
                        if t is t_hedge and not t_primary.done():
                            # the primary is about to be cancelled (or
                            # detached, if probing): not a failure, not
                            # a sample — but the hedge-loss STREAK is
                            # the signal that catches a gray replica
                            # whose own samples hedging dried up
                            controller._note_hedge_loss(primary)
                        self._record_hedge(
                            winner, delay, primary, hedge_replica, method
                        )
                        return result
                    # a GENUINE sub-attempt failure (the loser-cancel
                    # path never reaches here — cancellation happens in
                    # the finally below): transport-classified only,
                    # like every other dispatch path
                    if not is_caller_timeout(exc) and is_retryable(exc):
                        controller._breaker_failure(target, exc)
                    tried.add(target.replica_id)
                    if t is t_primary:
                        primary_exc = exc
                    else:
                        hedge_exc = exc
            # both attempts failed — surface the PRIMARY's error so the
            # outer retry loop classifies exactly what an unhedged
            # attempt would have raised (the hedge replica already sits
            # in `tried` for the next failover pick)
            self._record_hedge(
                "none", delay, primary, hedge_replica, method
            )
            final = primary_exc if primary_exc is not None else hedge_exc
            raise final
        finally:
            if probing and not t_primary.done():
                detached.add(t_primary)
                spawn_supervised(
                    self._settle_probe(t_primary, primary),
                    name=f"hedge-probe-{self.app_id}-{self.deployment}",
                    logger=self._controller.logger,
                )
            live = [
                t
                for t in (t_primary, t_hedge)
                if t is not None and t not in detached
            ]
            for t in live:
                if not t.done():
                    t.cancel()
            # let the cancelled loser unwind its finallys (semaphore
            # slot, ongoing counter, chip accounting) before returning;
            # its CancelledError is swallowed HERE and never fed to the
            # breaker or the outlier EWMA
            if live:
                await asyncio.gather(*live, return_exceptions=True)

    async def _settle_probe(self, task: asyncio.Task, target) -> None:
        """Await a detached probe attempt and bank its evidence: a
        successful completion feeds the outlier EWMA (the probe's whole
        point), a genuine transport failure feeds the breaker, and the
        caller who detached it is long gone either way."""
        controller = self._controller
        try:
            result, dt = await task
        except asyncio.CancelledError:
            return
        except Exception as exc:  # noqa: BLE001 — classified below
            if not is_caller_timeout(exc) and classify_exception(
                exc
            ) is FailureKind.TRANSPORT:
                controller._breaker_failure(target, exc)
            return
        controller._note_attempt_latency(target, dt)

    def _record_hedge(
        self, winner: str, delay: float, primary, hedge_replica, method: str
    ) -> None:
        if metrics.metrics_enabled():
            child = self._m_hedges.get(winner)
            if child is None:
                child = self._m_hedges[winner] = REQUEST_HEDGES.labels(
                    self.app_id, self.deployment, winner
                )
            child.inc()
        flight.record(
            "request.hedge",
            app=self.app_id,
            deployment=self.deployment,
            method=method,
            winner=winner,
            delay_ms=round(delay * 1000.0, 2),
            primary=primary.replica_id,
            hedge=hedge_replica.replica_id,
        )

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)

        async def invoke(*args, **kwargs):
            return await self.call(name, *args, **kwargs)

        invoke.__name__ = name
        return invoke


def _min_defined(*values: Optional[float]) -> Optional[float]:
    present = [v for v in values if v is not None]
    return min(present) if present else None


class _RouterGate:
    """Admission gate for a standalone router. ``enter()`` refuses
    typed: a CLOSED router (kill/drain) raises
    :class:`RouterClosedError` — retryable, so the client's failover
    loop moves to a sibling router; a SATURATED one raises
    :class:`RouterSaturatedError` — non-retryable backpressure (every
    sibling shares the same replica pool, failing over just moves the
    overload). The in-process controller never builds one."""

    __slots__ = ("router_id", "max_inflight", "inflight", "closed")

    def __init__(self, router_id: str, max_inflight: Optional[int] = None):
        self.router_id = router_id
        self.max_inflight = max_inflight
        self.inflight = 0
        self.closed = False

    def enter(self) -> None:
        if self.closed:
            raise RouterClosedError(
                f"router {self.router_id} is closed to new requests"
            )
        if (
            self.max_inflight is not None
            and self.inflight >= self.max_inflight
        ):
            raise RouterSaturatedError(
                f"router {self.router_id} at its inflight cap "
                f"({self.max_inflight})"
            )
        self.inflight += 1

    def leave(self) -> None:
        if self.inflight > 0:
            self.inflight -= 1


class RouterCore:
    """The request path as a mixin — everything between "a handle was
    called" and "a replica ran it": pick/score, bounded wait, circuit
    breaker, latency-outlier probation, hedging support, scheduler
    attach. ``ServeController`` inherits it (in-process plane,
    bit-compatible attribute names); :class:`StandaloneRouter` inherits
    it over a cached routing table. The host class provides ``apps``
    (``app_id -> AppDeployment``-shaped objects with ``.specs`` and
    ``.replicas``) and ``logger``, then calls :meth:`_init_router_core`
    during its own ``__init__``.

    This is the ONE copy of the routing logic (the satellite-6
    contract): the breaker's caller-timeout exemption lives in
    ``DeploymentHandle`` / here, the scored argmin lives in
    ``scheduler._best_replica`` — neither is duplicated per plane."""

    # standalone routers install a _RouterGate; the controller keeps the
    # class-level None (one attr load + None check on its hot path)
    _router_gate: Optional[_RouterGate] = None

    def _init_router_core(
        self,
        breaker_threshold: Optional[int] = None,
        outlier_config: Optional[OutlierConfig] = None,
    ) -> None:
        # per-replica circuit breaker: K consecutive transport failures
        # eject the replica immediately (no waiting for the health tick)
        self.breaker_threshold = (
            breaker_threshold
            if breaker_threshold is not None
            else int(os.environ.get("BIOENGINE_BREAKER_THRESHOLD", "3"))
        )
        # routable-replica wait during restart windows when the request
        # carries no deadline (read once — this sits on the hot path)
        self.pick_replica_grace_s = float(
            os.environ.get("BIOENGINE_PICK_REPLICA_WAIT_S", "10")
        )
        self._wake_health = asyncio.Event()   # breaker trips ring this
        self._queue_depth: dict[tuple[str, str], int] = defaultdict(int)
        self._rr_counters: dict[tuple[str, str], itertools.count] = {}
        self._breaker_counts: dict[str, int] = {}
        # when each breaker last TRIPPED (monotonic) — a standalone
        # router uses this to hold its local UNHEALTHY verdict against
        # a routing table that still says HEALTHY (the table is the
        # controller's view; the router saw the failures first-hand)
        self._breaker_tripped: dict[str, float] = {}
        # gray-failure defense (serving/outlier.py): per-deployment
        # latency trackers feeding the PROBATION soft-ejection + the
        # p95-derived hedge delay; created lazily on first observation,
        # swept at undeploy like every other router-state dict
        self.outlier_config = outlier_config or OutlierConfig.from_env()
        self._outliers: dict[tuple[str, str], DeploymentLatencyTracker] = {}
        # global schedulers, one per deployment that opted in via
        # DeploymentSpec.scheduling; created at deploy, closed at
        # undeploy. scorer_factory is the pluggable placement policy —
        # swap in a learned scorer without touching the scheduler.
        self._schedulers: dict[tuple[str, str], DeploymentScheduler] = {}
        self.scorer_factory: Callable[[], Any] = HeuristicCostModel
        self._replicas_changed = asyncio.Event()

    # ---- replica pick -------------------------------------------------------

    def get_handle(
        self,
        app_id: str,
        deployment: Optional[str] = None,
        options: Optional[RequestOptions] = None,
    ) -> DeploymentHandle:
        app = self.apps.get(app_id)
        if app is None:
            raise KeyError(f"app '{app_id}' not deployed")
        if deployment is None:
            deployment = next(iter(app.specs))
        if deployment not in app.specs:
            raise KeyError(f"app '{app_id}' has no deployment '{deployment}'")
        self._queue_depth.setdefault((app_id, deployment), 0)
        return DeploymentHandle(self, app_id, deployment, options)

    def _pick_replica(
        self, app_id: str, deployment: str, avoid: Optional[set] = None
    ) -> Replica:
        """Least-loaded routable replica, round-robin tie-break.
        ``avoid`` holds replica_ids that already failed THIS request —
        preferred against, but used as a last resort (the replica may
        have recovered and being wrong just costs one more retry).

        PROBATION replicas (latency outliers, serving/outlier.py) are
        soft-ejected: skipped by the pick except for the trickle probe
        (every Nth pick routes one real request there so recovery is
        observed) — and as the last resort when nothing else is
        routable, because slow beats unavailable."""
        app = self.apps.get(app_id)
        if app is None:
            raise KeyError(f"app '{app_id}' not deployed")
        healthy = [
            r
            for r in app.replicas.get(deployment, [])
            if r.state in ROUTABLE_STATES
        ]
        if avoid:
            preferred = [r for r in healthy if r.replica_id not in avoid]
            healthy = preferred or healthy
        if not healthy:
            raise NoHealthyReplicasError(
                f"no healthy replicas for {app_id}/{deployment}"
            )
        probation = [
            r for r in healthy if r.state == ReplicaState.PROBATION
        ]
        normal = [
            r for r in healthy if r.state != ReplicaState.PROBATION
        ]
        if probation and normal:
            tracker = self._outlier_tracker(app_id, deployment)
            if tracker.take_probe_ticket():
                # the probe trickle: route ONE real request to a
                # probation replica so its latency keeps being measured
                # — recovery is self-correcting, not operator-driven
                healthy = probation
            else:
                healthy = normal
        min_load = min(r.load for r in healthy)
        candidates = [r for r in healthy if r.load == min_load]
        rr = self._rr_counters.setdefault(
            (app_id, deployment), itertools.count()
        )
        return candidates[next(rr) % len(candidates)]

    async def _pick_replica_wait(
        self,
        app_id: str,
        deployment: str,
        avoid: Optional[set] = None,
        deadline: Optional[float] = None,
    ) -> Replica:
        """Like ``_pick_replica`` but WAITS through a restart window
        (bounded by the request deadline, or a default grace period)
        instead of raising instantly — a replica being re-placed after
        a host death is invisible to callers that can afford to wait."""
        wait_until = (
            deadline
            if deadline is not None
            else time.monotonic() + self.pick_replica_grace_s
        )
        while True:
            try:
                return self._pick_replica(app_id, deployment, avoid=avoid)
            except NoHealthyReplicasError:
                gate = self._router_gate
                if gate is not None and gate.closed:
                    # a closed router will never (re-)place a replica —
                    # waiting out the deadline here only burns the
                    # caller's retry budget; refuse typed NOW so the
                    # client fails over to a sibling or a healed plane
                    raise RouterClosedError(
                        f"router {gate.router_id} is closed to new "
                        "requests"
                    ) from None
                remaining = wait_until - time.monotonic()
                if remaining <= 0:
                    raise
                # a waiter with nothing routable is the same signal a
                # breaker trip is: capacity may be back (a rejoined
                # host) with placement still sitting out the health
                # period — ring the health loop so the top-up runs NOW,
                # not up to health_check_period later
                self._wake_health.set()
                self._replicas_changed.clear()
                try:
                    # woken early when a replica is (re-)placed
                    await asyncio.wait_for(
                        self._replicas_changed.wait(), min(remaining, 0.25)
                    )
                except asyncio.TimeoutError:
                    pass

    # ---- circuit breaker ----------------------------------------------------

    def _breaker_failure(self, replica, exc: Exception) -> None:
        """Record one transport failure. At ``breaker_threshold``
        consecutive failures the replica is ejected NOW (marked
        UNHEALTHY + health loop woken) instead of waiting out the
        health period."""
        rid = replica.replica_id
        n = self._breaker_counts.get(rid, 0) + 1
        self._breaker_counts[rid] = n
        if n >= self.breaker_threshold and replica.state in ROUTABLE_STATES:
            replica.state = ReplicaState.UNHEALTHY
            replica.last_error = (
                f"circuit breaker opened after {n} consecutive transport "
                f"failures (last: {exc})"
            )
            self._breaker_tripped[rid] = time.monotonic()
            self.logger.warning(
                f"breaker ejected replica {rid} after {n} transport failures"
            )
            if metrics.metrics_enabled():
                BREAKER_TRIPS.labels(
                    replica.app_id, replica.deployment_name
                ).inc()
            flight.record(
                "breaker.trip",
                severity="error",
                replica=rid,
                app=replica.app_id,
                deployment=replica.deployment_name,
                host=getattr(replica, "host_id", None),
                failures=n,
                error=str(exc)[:500],
            )
            # the postmortem moment: snapshot the ring while the events
            # leading up to the trip are still in it
            flight.dump("breaker_trip", replica=rid, app=replica.app_id)
            self._wake_health.set()

    def _breaker_success(self, replica) -> None:
        if self._breaker_counts.pop(replica.replica_id, None):
            self._breaker_tripped.pop(replica.replica_id, None)
            flight.record(
                "breaker.reset",
                replica=replica.replica_id,
                app=replica.app_id,
                deployment=replica.deployment_name,
            )

    # ---- gray-failure defense (latency outliers → probation) ----------------

    def _outlier_tracker(
        self, app_id: str, deployment: str
    ) -> DeploymentLatencyTracker:
        key = (app_id, deployment)
        tracker = self._outliers.get(key)
        if tracker is None:
            tracker = self._outliers[key] = DeploymentLatencyTracker(
                app_id, deployment, self.outlier_config
            )
        return tracker

    def _note_attempt_latency(self, replica, seconds: float) -> None:
        """Feed one SUCCESSFUL attempt's service time into the
        deployment's outlier tracker and apply the probation verdicts
        it returns (possibly for OTHER replicas of the deployment — a
        hedged-around gray replica stops producing samples of its own,
        so its excursion matures on its siblings' notes). Called by the
        router path, the scheduler's fast path, and group dispatch —
        never for failed attempts (their wall time measures the
        transport) and never for cancelled hedge losers (their wall
        time measures the winner)."""
        tracker = self._outlier_tracker(
            replica.app_id, replica.deployment_name
        )
        transitions = tracker.note(replica.replica_id, seconds)
        self._apply_probation_transitions(tracker, replica, transitions)

    def _note_hedge_loss(self, replica) -> None:
        """A hedge fired against ``replica`` and won. Not a breaker
        strike, not an EWMA sample — but the tracker counts the streak
        (see ``note_hedge_loss``) and may return probation verdicts."""
        tracker = self._outlier_tracker(
            replica.app_id, replica.deployment_name
        )
        transitions = tracker.note_hedge_loss(replica.replica_id)
        self._apply_probation_transitions(tracker, replica, transitions)

    def _apply_probation_transitions(
        self, tracker, replica, transitions
    ) -> None:
        if not transitions:
            return
        app_id = replica.app_id
        deployment = replica.deployment_name
        app = self.apps.get(app_id)
        by_id = {
            r.replica_id: r
            for r in (app.replicas.get(deployment, []) if app else [])
        }
        by_id.setdefault(replica.replica_id, replica)
        median = tracker._median()
        for rid, transition in transitions:
            target = by_id.get(rid)
            if target is None:
                tracker.forget(rid)  # retired mid-flight — stale entry
                continue
            ewma = tracker.ewma(rid)
            # a streak-entered replica may have NO measured EWMA at all
            # (every completion was a cancelled hedge loser) — the
            # evidence attrs must tolerate that, not crash the hedged
            # request that triggered the verdict
            ewma_s = None if ewma is None else round(ewma, 6)
            median_s = None if median is None else round(median, 6)
            if transition == "enter":
                if target.state != ReplicaState.HEALTHY:
                    # TESTING replicas are still warming (compile spikes
                    # are not gray failure) and DRAINING/UNHEALTHY ones
                    # are already out of the pick — roll the verdict back
                    tracker.replicas[rid].in_probation = False
                    continue
                target.state = ReplicaState.PROBATION
                self.logger.warning(
                    f"replica {rid} entered probation: latency EWMA "
                    f"{ewma_s}s vs deployment median {median_s}s "
                    f"(gray failure — health checks still pass)"
                )
                if metrics.metrics_enabled():
                    REPLICA_PROBATIONS.labels(app_id, deployment).inc()
                record_probation_event(
                    app_id, deployment, rid, "enter",
                    ewma_s=ewma_s, median_s=median_s,
                    host=getattr(target, "host_id", None),
                )
            elif transition == "exit":
                if target.state == ReplicaState.PROBATION:
                    target.state = ReplicaState.HEALTHY
                    self._replicas_changed.set()
                self.logger.info(
                    f"replica {rid} recovered from probation "
                    f"(EWMA {ewma_s}s, median {median_s}s)"
                )
                record_probation_event(
                    app_id, deployment, rid, "exit",
                    ewma_s=ewma_s, median_s=median_s,
                    host=getattr(target, "host_id", None),
                )

    def _forget_replica_latency(self, replica_id: str) -> None:
        self._breaker_tripped.pop(replica_id, None)
        for tracker in self._outliers.values():
            tracker.forget(replica_id)

    def hedge_delay_s(
        self, app_id: str, deployment: str, options: "RequestOptions"
    ) -> float:
        if options.hedge_delay_s is not None:
            return options.hedge_delay_s
        return self._outlier_tracker(app_id, deployment).hedge_delay_s()


# ---------------------------------------------------------------------------
# Routing table — publication (controller side)
# ---------------------------------------------------------------------------


class RoutingTablePublisher:
    """Controller-side versioned view of everything a router needs to
    route: the replica set with states and host bindings, per-deployment
    scheduler configs, mesh/host membership, and breaker/probation
    hints. Content-addressed per deployment: ``refresh()`` re-signs each
    deployment's entry list and bumps the monotonic ``version`` only on
    real change, so the diff a router pulls (``since_version``) is
    usually empty. Every table is stamped with the controller's journal
    epoch — the same PR 15 fence hosts use — so a stale controller's
    push can never regress a router (``StaleTableError``).

    Advisory fields (per-entry ``load`` / ``breaker_failures``) are
    deliberately EXCLUDED from the change signature: they churn every
    request, and versioning them would turn every diff into a full
    table. Routers treat them as hints, not truth."""

    def __init__(self, controller):
        self._c = controller
        self.version = 0
        self._dep_version: dict[tuple[str, str], int] = {}
        self._dep_sig: dict[tuple[str, str], Any] = {}
        self._removed_version: dict[tuple[str, str], int] = {}
        self._hosts_sig: Any = None
        self._hosts_version = 0
        # router_id -> last sync report (acked version, staleness, when)
        self.routers: dict[str, dict] = {}

    @staticmethod
    def _entry_sig(r) -> tuple:
        return (
            r.replica_id,
            r.state.value,
            getattr(r, "host_id", None),
            getattr(r, "host_service_id", None),
        )

    def refresh(self) -> int:
        """Re-sign the live placement state; bump ``version`` for each
        deployment whose routable membership changed. O(replicas), no
        allocation on the unchanged path beyond the signatures."""
        c = self._c
        seen: set[tuple[str, str]] = set()
        for app in list(c.apps.values()):
            for dep, replicas in list(app.replicas.items()):
                key = (app.app_id, dep)
                seen.add(key)
                spec = app.specs.get(dep)
                sig = (
                    tuple(self._entry_sig(r) for r in replicas),
                    None if spec is None else (
                        getattr(spec, "max_ongoing_requests", 10),
                        spec.scheduling is not None,
                    ),
                )
                if self._dep_sig.get(key) != sig:
                    self.version += 1
                    self._dep_sig[key] = sig
                    self._dep_version[key] = self.version
                    self._removed_version.pop(key, None)
        for key in [k for k in self._dep_sig if k not in seen]:
            self.version += 1
            del self._dep_sig[key]
            self._dep_version.pop(key, None)
            self._removed_version[key] = self.version
        hosts_sig = tuple(
            sorted(
                (h.host_id, h.service_id, h.alive)
                for h in c.cluster_state.hosts.values()
            )
        )
        if hosts_sig != self._hosts_sig:
            self.version += 1
            self._hosts_sig = hosts_sig
            self._hosts_version = self.version
        return self.version

    def _dep_payload(self, app_id: str, dep: str) -> dict:
        c = self._c
        app = c.apps[app_id]
        spec = app.specs.get(dep)
        entries = []
        for r in app.replicas.get(dep, []):
            entries.append(
                {
                    "replica_id": r.replica_id,
                    "state": r.state.value,
                    "host_id": getattr(r, "host_id", None),
                    "host_service_id": getattr(r, "host_service_id", None),
                    "device_ids": list(getattr(r, "device_ids", []) or []),
                    # advisory hints (NOT versioned — see class docstring)
                    "load": getattr(r, "load", 0),
                    "breaker_failures": c._breaker_counts.get(
                        r.replica_id, 0
                    ),
                }
            )
        sched = spec.scheduling if spec is not None else None
        return {
            "version": self._dep_version[(app_id, dep)],
            "max_ongoing": (
                getattr(spec, "max_ongoing_requests", 10)
                if spec is not None
                else 10
            ),
            "max_replicas": getattr(spec, "max_replicas", 1),
            "target_load": getattr(spec, "target_load", 0.7),
            "scheduling": (
                None
                if sched is None
                else {
                    f: getattr(sched, f)
                    for f in (
                        "enabled", "max_batch", "max_wait_ms",
                        "max_queue_depth", "default_class",
                        "tenant_quota", "target_wait_s",
                        "scale_down_ticks", "ewma_alpha",
                    )
                }
            ),
            "entries": entries,
        }

    def table(
        self,
        since_version: int = 0,
        router_id: Optional[str] = None,
        staleness_s: Optional[float] = None,
    ) -> dict:
        """A full table (``since_version <= 0``) or the diff since a
        version the router already holds. Also books the caller's sync
        report so ``get_app_status`` can surface per-router staleness."""
        self.refresh()
        full = since_version <= 0
        deployments: dict[str, dict] = {}
        for (app_id, dep), ver in self._dep_version.items():
            if full or ver > since_version:
                deployments.setdefault(app_id, {})[dep] = self._dep_payload(
                    app_id, dep
                )
        removed = [
            list(key)
            for key, ver in self._removed_version.items()
            if not full and ver > since_version
        ]
        out = {
            "schema": TABLE_SCHEMA,
            "epoch": self._c.epoch,
            "version": self.version,
            "full": full,
            "generated_at": time.time(),
            "deployments": deployments,
            "removed": removed,
        }
        if full or self._hosts_version > since_version:
            out["hosts"] = {
                h.host_id: {
                    "service_id": h.service_id,
                    "alive": h.alive,
                    "n_chips": h.n_chips,
                }
                for h in self._c.cluster_state.hosts.values()
            }
        if router_id is not None:
            self.note_router(
                router_id,
                acked_version=self.version,
                staleness_s=staleness_s,
            )
        return out

    def note_router(
        self,
        router_id: str,
        acked_version: Optional[int] = None,
        staleness_s: Optional[float] = None,
    ) -> None:
        self.routers[router_id] = {
            "router_id": router_id,
            "acked_version": acked_version,
            "table_epoch": self._c.epoch,
            "staleness_s": (
                None if staleness_s is None else round(staleness_s, 3)
            ),
            "last_sync_at": time.time(),
        }

    def describe(self) -> dict:
        """The ``router_tier`` block of ``get_app_status``."""
        self.refresh()
        return {
            "table_version": self.version,
            "table_epoch": self._c.epoch,
            "routers": [
                self.routers[rid] for rid in sorted(self.routers)
            ],
        }


# ---------------------------------------------------------------------------
# Routing table — consumption (standalone router side)
# ---------------------------------------------------------------------------


@dataclass
class _TableSpec:
    """The slice of ``DeploymentSpec`` a router actually reads,
    reconstructed from a table payload (the full spec carries an
    ``instance_factory`` that cannot cross a process boundary)."""

    name: str
    max_ongoing_requests: int = 10
    max_replicas: int = 1
    target_load: float = 0.7
    scheduling: Optional[SchedulingConfig] = None


@dataclass
class _RouterApp:
    """``AppDeployment``-shaped view a router rebuilds from its table —
    just the fields ``RouterCore`` and the scheduler read."""

    app_id: str
    specs: dict[str, _TableSpec] = field(default_factory=dict)
    replicas: dict[str, list] = field(default_factory=dict)
    status: str = "RUNNING"
    acl: Any = None


def shared_object_resolver(controller) -> Callable:
    """Resolver for routers colocated with the serving plane (the
    scenario engine, in-process scale-out tests): table entries resolve
    to the LIVE replica objects the controller placed, so semaphore
    occupancy, chip accounting, and lifecycle state stay single-source.
    The router therefore never writes replica state from the table
    (``owns_replicas = False``) — the objects already carry it."""

    get = controller if callable(controller) else (lambda: controller)

    def resolve(app_id: str, deployment: str, entries: list) -> list:
        c = get()
        app = c.apps.get(app_id) if c is not None else None
        if app is None:
            return [None] * len(entries)
        by_id = {
            r.replica_id: r for r in app.replicas.get(deployment, [])
        }
        return [by_id.get(e["replica_id"]) for e in entries]

    resolve.owns_replicas = False
    return resolve


def remote_replica_resolver(
    call_host,
    payload: Optional[dict] = None,
    stream_host=None,
) -> Callable:
    """Resolver for a router in its OWN process: each table entry
    becomes a cached :class:`RemoteReplica` dialing the worker host the
    controller placed it on (``call_host`` is the same transport hook
    the controller's remote path uses). The router owns these objects
    (``owns_replicas = True``): lifecycle state is applied FROM the
    table, modulated by the router's local breaker verdicts."""

    cache: dict[tuple[str, str], dict[str, RemoteReplica]] = {}

    def resolve(app_id: str, deployment: str, entries: list) -> list:
        pool = cache.setdefault((app_id, deployment), {})
        out = []
        keep = set()
        for e in entries:
            svc = e.get("host_service_id")
            if not svc:
                # a local (controller-process) replica is unreachable
                # from a remote router — only host-bound entries route
                out.append(None)
                continue
            rid = e["replica_id"]
            keep.add(rid)
            replica = pool.get(rid)
            if replica is None:
                replica = RemoteReplica(
                    app_id,
                    deployment,
                    e.get("host_id"),
                    svc,
                    call_host,
                    dict(payload or {}),
                    device_ids=list(e.get("device_ids") or []),
                    max_ongoing_requests=int(e.get("max_ongoing", 10)),
                    stream_host=stream_host,
                )
                replica.replica_id = rid
                pool[rid] = replica
            out.append(replica)
        for rid in [r for r in pool if r not in keep]:
            del pool[rid]
        return out

    resolve.owns_replicas = True
    return resolve


class StandaloneRouter(RouterCore):
    """A scale-out router: the full ``RouterCore`` request path over a
    locally cached routing table instead of live placement state. N of
    these serve concurrently against one controller; each keeps serving
    its last-good table through a controller crash/restart and reports
    the table's staleness age.

    ``resolver`` turns table entries into callable replica objects —
    :func:`shared_object_resolver` for a colocated router (scenario
    engine), :func:`remote_replica_resolver` for a router process
    dialing worker hosts over RPC.

    Table application is epoch-fenced (:meth:`apply_table`); syncing is
    the caller's loop — :meth:`sync_from` against an in-process
    controller, :meth:`sync_once` over the RPC plane, or
    :meth:`sync_loop` to run either on a period
    (``BIOENGINE_ROUTER_SYNC_S``)."""

    def __init__(
        self,
        router_id: Optional[str] = None,
        resolver: Optional[Callable] = None,
        *,
        breaker_threshold: Optional[int] = None,
        outlier_config: Optional[OutlierConfig] = None,
        max_inflight: Optional[int] = None,
        table_stale_s: Optional[float] = None,
        log_file: Optional[str] = None,
    ):
        self.router_id = router_id or f"router-{os.getpid()}-{id(self):x}"
        self.apps: dict[str, _RouterApp] = {}
        self.logger = create_logger(
            f"router.{self.router_id}", log_file=log_file
        )
        self._init_router_core(
            breaker_threshold=breaker_threshold,
            outlier_config=outlier_config,
        )
        if max_inflight is None:
            raw = os.environ.get("BIOENGINE_ROUTER_MAX_INFLIGHT", "")
            max_inflight = int(raw) if raw else None
        self._router_gate = _RouterGate(self.router_id, max_inflight)
        # staleness past this bound flags the router DEGRADED in
        # describe() — it still serves (last-good beats nothing), the
        # flag is the operator signal
        self.table_stale_s = (
            table_stale_s
            if table_stale_s is not None
            else float(os.environ.get("BIOENGINE_ROUTER_TABLE_STALE_S", "30"))
        )
        # how long a local breaker verdict outranks a table that still
        # says HEALTHY (the router saw the failures first-hand; the
        # controller's view lags a health tick)
        self.breaker_hold_s = float(
            os.environ.get("BIOENGINE_ROUTER_BREAKER_HOLD_S", "30")
        )
        self._resolver = resolver or (
            lambda app_id, dep, entries: [None] * len(entries)
        )
        self.table_epoch = 0
        self.table_version = 0
        # staleness baseline: construction counts as "last applied", so
        # a router that never synced reports its age, not infinity
        self._table_applied_mono = time.monotonic()
        self._table_generated_at: Optional[float] = None
        self.hosts: dict[str, dict] = {}
        _ROUTERS.add(self)

    # ---- table lifecycle ----------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._router_gate.closed

    @property
    def table_staleness_s(self) -> float:
        """Seconds since a routing table was last applied."""
        return max(0.0, time.monotonic() - self._table_applied_mono)

    def apply_table(self, table: dict) -> dict:
        """Apply a published table (full or diff). Fencing, in order:

        - LOWER epoch than held → the publisher is a revived old
          controller; rejected typed (``StaleTableError``), view kept.
        - Same epoch, LOWER version → reordered/duplicate push;
          rejected typed, view kept (a stale push never regresses).
        - HIGHER epoch → new controller generation; only a FULL table
          is acceptable (the old generation's version stream means
          nothing), and it resets the view.
        """
        epoch = int(table.get("epoch", 0))
        version = int(table.get("version", 0))
        full = bool(table.get("full", False))
        if epoch < self.table_epoch or (
            epoch == self.table_epoch and version < self.table_version
        ):
            reason = (
                "stale_epoch" if epoch < self.table_epoch else "stale_version"
            )
            flight.record(
                "router.table_reject",
                severity="warning",
                router=self.router_id,
                reason=reason,
                held_epoch=self.table_epoch,
                held_version=self.table_version,
                got_epoch=epoch,
                got_version=version,
            )
            raise StaleTableError(
                f"router {self.router_id} holds table "
                f"epoch={self.table_epoch} version={self.table_version}; "
                f"rejecting {reason} push "
                f"(epoch={epoch} version={version})",
                seen_epoch=self.table_epoch,
                got_epoch=epoch,
            )
        if epoch > self.table_epoch and self.table_epoch > 0 and not full:
            flight.record(
                "router.table_reject",
                severity="warning",
                router=self.router_id,
                reason="diff_across_epochs",
                held_epoch=self.table_epoch,
                got_epoch=epoch,
            )
            raise ValueError(
                f"router {self.router_id}: a diff cannot cross a controller "
                f"generation (held epoch {self.table_epoch}, got {epoch}) — "
                f"resync with since_version=0"
            )
        if epoch == self.table_epoch and version == self.table_version:
            # no-op push, but a live publisher just CONFIRMED the held
            # view is current — that resets the staleness clock (else a
            # quiet fleet would read as ever-more-stale between changes)
            self._table_applied_mono = time.monotonic()
            return {"applied": False, "reason": "duplicate",
                    "epoch": epoch, "version": version}

        deployments = table.get("deployments") or {}
        applied = 0
        for app_id, deps in deployments.items():
            for dep, payload in deps.items():
                self._apply_deployment(app_id, dep, payload)
                applied += 1
        removed = [tuple(k) for k in (table.get("removed") or [])]
        for app_id, dep in removed:
            self._remove_deployment(app_id, dep)
        if full:
            # a full table is authoritative: prune deployments it no
            # longer lists (covers removals that predate this router)
            listed = {
                (app_id, dep)
                for app_id, deps in deployments.items()
                for dep in deps
            }
            for app in list(self.apps.values()):
                for dep in list(app.specs):
                    if (app.app_id, dep) not in listed:
                        self._remove_deployment(app.app_id, dep)
        if "hosts" in table:
            self.hosts = dict(table["hosts"] or {})
        self.table_epoch = epoch
        self.table_version = version
        self._table_applied_mono = time.monotonic()
        self._table_generated_at = table.get("generated_at")
        self._replicas_changed.set()
        flight.record(
            "router.table_apply",
            router=self.router_id,
            epoch=epoch,
            version=version,
            full=full,
            deployments=applied,
            removed=len(removed),
        )
        return {"applied": True, "epoch": epoch, "version": version,
                "deployments": applied, "removed": len(removed)}

    def _apply_deployment(
        self, app_id: str, dep: str, payload: dict
    ) -> None:
        app = self.apps.get(app_id)
        if app is None:
            app = self.apps[app_id] = _RouterApp(app_id=app_id)
        entries = payload.get("entries") or []
        resolved = self._resolver(app_id, dep, entries)
        owned = getattr(self._resolver, "owns_replicas", False)
        live = []
        for entry, replica in zip(entries, resolved):
            if replica is None:
                continue
            if owned:
                desired = ReplicaState(entry["state"])
                rid = entry["replica_id"]
                # the table says routable but the LOCAL breaker tripped
                # recently: the router saw those failures first-hand and
                # holds its verdict for breaker_hold_s (the controller's
                # view lags a health tick)
                veto = (
                    replica.state is ReplicaState.UNHEALTHY
                    and desired in ROUTABLE_STATES
                    and self._breaker_counts.get(rid, 0)
                    >= self.breaker_threshold
                    and (
                        time.monotonic()
                        - self._breaker_tripped.get(rid, 0.0)
                    )
                    < self.breaker_hold_s
                )
                if not veto:
                    replica.state = desired
            live.append(replica)
        app.replicas[dep] = live
        sched_cfg = payload.get("scheduling")
        spec = _TableSpec(
            name=dep,
            max_ongoing_requests=int(payload.get("max_ongoing", 10)),
            max_replicas=int(payload.get("max_replicas", 1)),
            target_load=float(payload.get("target_load", 0.7)),
        )
        app.specs[dep] = spec
        self._queue_depth.setdefault((app_id, dep), 0)
        key = (app_id, dep)
        if sched_cfg:
            cfg = SchedulingConfig.from_config(dict(sched_cfg))
            spec.scheduling = cfg
            if key not in self._schedulers:
                self._schedulers[key] = DeploymentScheduler(
                    self, app_id, dep, spec, cfg,
                    scorer=self.scorer_factory(),
                )
        elif key in self._schedulers:
            self._schedulers.pop(key).kill()

    def _remove_deployment(self, app_id: str, dep: str) -> None:
        key = (app_id, dep)
        sched = self._schedulers.pop(key, None)
        if sched is not None:
            sched.kill()
        self._rr_counters.pop(key, None)
        self._outliers.pop(key, None)
        self._queue_depth.pop(key, None)
        app = self.apps.get(app_id)
        if app is not None:
            app.replicas.pop(dep, None)
            app.specs.pop(dep, None)
            if not app.specs:
                self.apps.pop(app_id, None)

    # ---- sync ---------------------------------------------------------------

    def _since_version(self, publisher_epoch: int) -> int:
        # a diff is only meaningful within one controller generation
        return self.table_version if publisher_epoch == self.table_epoch else 0

    def sync_from(self, controller) -> dict:
        """One in-process sync against a live controller's publisher
        (colocated deployments, the scenario engine)."""
        table = controller.router_publisher.table(
            since_version=self._since_version(controller.epoch),
            router_id=self.router_id,
            staleness_s=self.table_staleness_s,
        )
        return self.apply_table(table)

    async def sync_once(self, controller_service) -> dict:
        """One sync over the RPC plane: ``controller_service`` is a
        connected client for the controller's ``serve-router`` service
        (the same wrapper worker hosts hold)."""
        table = await controller_service.call_service_method(
            "serve-router",
            "get_routing_table",
            self.router_id,
            self._since_version(self.table_epoch),
            self.table_staleness_s,
        )
        return self.apply_table(table)

    async def sync_loop(
        self, source, period_s: Optional[float] = None
    ) -> None:
        """Periodic sync until the router is killed. ``source`` is a
        live controller (in-process) or an RPC service client. Sync
        failures degrade staleness, never the router — it keeps serving
        the last-good table (that is the whole point of the cache)."""
        if period_s is None:
            period_s = float(os.environ.get("BIOENGINE_ROUTER_SYNC_S", "2"))
        is_local = hasattr(source, "router_publisher")
        while not self.closed:
            try:
                if is_local:
                    self.sync_from(source)
                else:
                    await self.sync_once(source)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — staleness IS the signal
                self.logger.warning(
                    f"router {self.router_id} table sync failed "
                    f"(serving last-good, "
                    f"staleness={self.table_staleness_s:.1f}s): {e}"
                )
            await asyncio.sleep(period_s)

    # ---- lifecycle ----------------------------------------------------------

    def kill(self) -> None:
        """Stop admitting requests (in-flight ones finish). New calls
        get ``RouterClosedError`` — retryable, so clients fail over to
        a sibling router."""
        if self._router_gate.closed:
            return
        self._router_gate.closed = True
        for sched in list(self._schedulers.values()):
            sched.kill()
        self._schedulers.clear()
        flight.record(
            "router.closed",
            router=self.router_id,
            table_epoch=self.table_epoch,
            table_version=self.table_version,
            inflight=self._router_gate.inflight,
        )

    def describe(self) -> dict:
        staleness = self.table_staleness_s
        return {
            "router_id": self.router_id,
            "closed": self.closed,
            "table_epoch": self.table_epoch,
            "table_version": self.table_version,
            "table_staleness_s": round(staleness, 3),
            "stale": staleness > self.table_stale_s,
            "inflight": self._router_gate.inflight,
            "max_inflight": self._router_gate.max_inflight,
            "deployments": sorted(
                f"{app.app_id}/{dep}"
                for app in self.apps.values()
                for dep in app.specs
            ),
            "hosts": len(self.hosts),
        }


def _collect_routers(instances: list) -> list:
    """Scrape-time gauges from live standalone routers: the table
    epoch/staleness pair is the split-brain + liveness signal the
    fleet dashboard alerts on (a router serving a stale table keeps
    serving — the alert is the operator's cue, not a failure)."""
    out = []
    for r in instances:
        labels = {"router": r.router_id}
        out.append(
            metrics.Sample(
                "router_table_epoch",
                r.table_epoch,
                labels,
                help="journal epoch of the router's applied routing table",
            )
        )
        out.append(
            metrics.Sample(
                "router_table_staleness_seconds",
                round(r.table_staleness_s, 3),
                labels,
                help="seconds since the router last applied a routing table",
            )
        )
        out.append(
            metrics.Sample(
                "router_inflight_requests",
                r._router_gate.inflight,
                labels,
                help="requests currently admitted by the router's gate",
            )
        )
    return out


_ROUTERS = metrics.InstanceSet("standalone_router", _collect_routers)
