"""Global request scheduler — cross-replica continuous batching,
admission control with priority classes, predictive autoscaling.

The per-request router (``ServeController._pick_replica``) answers
"which replica takes THIS call"; at scale the controller must answer a
different question — "what should the fleet execute next" — and that is
a scheduling problem. This module adds, per deployment:

- **Cross-replica continuous batching.** Compatible requests (same
  batch signature — method + non-payload argument values + payload
  shape bucket, the controller-side analog of the replica batcher's
  model+bucket+mesh key) coalesce into one :class:`_Group` dispatched
  to a single replica as ONE ``call_batch`` round trip. On the replica
  the K members execute in the same event-loop window, so a deployment
  with its own ``ContinuousBatcher`` merges them into one dp-sharded
  forward instead of K separate forwards spread thin over the fleet.
- **Admission control.** Priority classes (``interactive`` > ``bulk``
  > ``background``) scheduled by deficit-weighted round robin; a
  per-deployment queue-depth budget and optional per-tenant quota shed
  load with a typed :class:`AdmissionRejectedError` instead of letting
  queues grow unbounded; requests are ordered earliest-deadline-first
  within a class and are failed fast (``DeadlineExceeded``) the moment
  they could no longer finish in time — a request never waits past the
  point where waiting can help.
- **A pluggable cost model.** Replica choice is a scored decision over
  load/breaker/affinity features (:class:`HeuristicCostModel` by
  default). GDP/Placeto (PAPERS.md) show learned placement beating
  fixed heuristics — a learned policy drops in by assigning
  ``ServeController.scorer_factory`` (the feature dict is the contract,
  not this scorer's arithmetic).
- **Predictive autoscaling.** :class:`LoadPredictor` keeps EWMAs of
  arrival rate and per-request service time; the controller's autoscale
  pass (and a cheap submit-time early trigger that wakes the health
  loop) scales up when utilization or projected queue wait crosses the
  threshold — BEFORE queues saturate, not after — and scales down only
  after ``scale_down_ticks`` consecutive idle verdicts (hysteresis), so
  a traffic dip never thrashes replicas that are expensive to rebuild.

Scheduling is opt-in per deployment (``DeploymentSpec.scheduling`` /
the manifest's ``deployment_config.<dep>.scheduling``); deployments
without it keep the per-request router path byte-for-byte.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, Optional, Protocol

from bioengine_tpu_torch.rpc.protocol import RemoteError
from bioengine_tpu_torch.serving.errors import (
    AdmissionRejectedError,
    DeadlineExceeded,
    NoHealthyReplicasError,
    ReplicaUnavailableError,
    is_caller_timeout,
    is_retryable,
)
from bioengine_tpu_torch.serving.replica import (
    DEFAULT_DRAIN_TIMEOUT_S,
    ROUTABLE_STATES,
    ReplicaState,
)
from bioengine_tpu_torch.utils import flight, metrics, tracing
from bioengine_tpu_torch.utils.tasks import spawn_supervised

# Every Nth consecutive deadline_infeasible verdict is admitted as a
# PROBE instead of shed: a poisoned or stale service estimate (e.g. one
# 120 s cold-compile outlier seeding the EWMA) would otherwise shed ALL
# deadlined traffic forever — rejected requests never complete, so
# nothing could ever correct the estimate. A completed probe re-grounds
# it; probes skip the predictive shed but still fail on true expiry.
INFEASIBLE_PROBE_EVERY = 8

# fixed class order IS the tie-break: when several classes hold credit,
# the most latency-sensitive one goes first
DEFAULT_CLASS_WEIGHTS: dict[str, float] = {
    "interactive": 8.0,   # user-facing inference
    "bulk": 2.0,          # bulk embedding / batch jobs
    "background": 1.0,    # fine-tune / maintenance traffic
}

SCHED_ADMITTED = metrics.counter(
    "scheduler_admitted_total",
    "requests admitted into a deployment scheduler queue",
    ("app", "deployment", "priority"),
)
SCHED_REJECTED = metrics.counter(
    "scheduler_rejected_total",
    "requests shed by admission control",
    ("app", "deployment", "reason"),
)
SCHED_QUEUE_WAIT = metrics.histogram(
    "scheduler_queue_wait_seconds",
    "time a request waited in the scheduler before dispatch",
    ("app", "deployment", "priority"),
)
SCHED_BATCH_SIZE = metrics.histogram(
    "scheduler_batch_size",
    "requests per dispatched cross-replica group",
    ("app", "deployment"),
    buckets=metrics.BATCH_SIZE_BUCKETS,
)
SCHED_DISPATCHES = metrics.counter(
    "scheduler_dispatches_total",
    "groups dispatched to a replica (one call_batch round trip each)",
    ("app", "deployment"),
)


def _collect_schedulers(instances: list) -> list:
    """Scrape-time scheduler gauges: per-class queue depth and the
    predictor's projection — the live inputs of admission and the
    predictive autoscaler, visible on the same /metrics plane that
    shows their consequences."""
    out: list[metrics.Sample] = []
    for s in instances:
        if s._closed:
            continue
        labels = {"app": s.app_id, "deployment": s.deployment}
        for cls, q in s._queues.items():
            out.append(
                metrics.Sample(
                    "scheduler_queue_depth",
                    len(q),
                    {**labels, "priority": cls},
                    help="requests waiting in a scheduler class queue",
                )
            )
        proj = s.predictor.projection(
            time.monotonic(), s.waiting, max(1, s._n_routable())
        )
        out.append(
            metrics.Sample(
                "scheduler_projected_wait_seconds",
                round(proj["projected_wait_s"], 6),
                labels,
                help="predicted queue wait at current arrival/service rates",
            )
        )
        out.append(
            metrics.Sample(
                "scheduler_inflight_groups",
                len(s._inflight),
                labels,
                help="dispatched groups currently executing",
            )
        )
    return out


_SCHEDULERS = metrics.InstanceSet("deployment_scheduler", _collect_schedulers)


# ---------------------------------------------------------------------------
# batch-compatibility signature
# ---------------------------------------------------------------------------


def _sig_value(v: Any) -> Hashable:
    """One argument's contribution to the compatibility key. Scalars
    and strings contribute their VALUE (model ids, format flags — a
    different model must never co-batch); array-likes contribute their
    per-item shape + dtype (the bucket — the batch dim is exactly what
    coalescing merges, so it is excluded); everything else contributes
    only its type (opaque payloads are conservatively incompatible only
    when their types differ — matching the replica-side batcher, which
    re-checks its own model+bucket+mesh signature anyway)."""
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    shape = getattr(v, "shape", None)
    if shape is not None:
        item_shape = tuple(shape[1:]) if len(shape) > 1 else tuple(shape)
        return ("nd", item_shape, str(getattr(v, "dtype", "")))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, len(v))
    if isinstance(v, dict):
        return ("dict", tuple(sorted(str(k) for k in v)))
    return type(v).__name__


# sorted-kwargs-key memo: the signature is rebuilt on EVERY submit, and
# re-sorting the same handful of kwarg-key tuples re-serializes scalar
# kwargs for no reason (the --hot-path-report offender PR 16 mapped).
# Keyed by the kwargs keys IN INSERTION ORDER — handles call with a
# stable shape, so this hits ~always. Bounded; eviction is arbitrary.
_SORTED_KEYS_CACHE: dict[tuple, tuple] = {}
_SORTED_KEYS_CACHE_MAX = 512


def batch_signature(method: str, args: tuple, kwargs: dict) -> Hashable:
    """Controller-side compatibility key: requests sharing a signature
    may ride one dispatched group (the same replica, one round trip)."""
    if kwargs:
        keys = tuple(kwargs)
        skeys = _SORTED_KEYS_CACHE.get(keys)
        if skeys is None:
            if len(_SORTED_KEYS_CACHE) >= _SORTED_KEYS_CACHE_MAX:
                _SORTED_KEYS_CACHE.pop(next(iter(_SORTED_KEYS_CACHE)))
            skeys = _SORTED_KEYS_CACHE[keys] = tuple(sorted(keys))
        kw_sig = tuple((k, _sig_value(kwargs[k])) for k in skeys)
    else:
        kw_sig = ()
    return (method, tuple(_sig_value(a) for a in args), kw_sig)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclass
class SchedulingConfig:
    """Per-deployment scheduler knobs (manifest:
    ``deployment_config.<dep>.scheduling``)."""

    enabled: bool = True
    max_batch: int = 8                 # group size cap per dispatch
    max_wait_ms: float = 5.0           # group coalescing window
    max_queue_depth: int = 256         # admission budget (all classes)
    class_weights: dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_CLASS_WEIGHTS)
    )
    default_class: str = "interactive"
    tenant_quota: Optional[int] = None  # max waiting requests per tenant
    target_wait_s: float = 1.0          # predictive scale-up threshold
    scale_down_ticks: int = 3           # hysteresis before scale-down
    ewma_alpha: float = 0.2
    # consume the SLO engine's error-budget burn as an autoscale
    # up-pressure signal (needs a manifest slo: block; off by default —
    # the loop only closes where an operator asked it to)
    slo_pressure: bool = False

    @classmethod
    def from_config(cls, cfg: dict) -> "SchedulingConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(cfg) - known)
        if unknown:
            raise ValueError(
                f"unknown scheduling config keys: {unknown} "
                f"(accepted: {sorted(known)})"
            )
        out = cls()
        if "enabled" in cfg:
            out.enabled = bool(cfg["enabled"])
        if "max_batch" in cfg:
            out.max_batch = max(1, int(cfg["max_batch"]))
        if "max_wait_ms" in cfg:
            out.max_wait_ms = float(cfg["max_wait_ms"])
        if "max_queue_depth" in cfg:
            out.max_queue_depth = max(1, int(cfg["max_queue_depth"]))
        if "class_weights" in cfg:
            weights = {
                str(k): float(v) for k, v in dict(cfg["class_weights"]).items()
            }
            if not weights or min(weights.values()) <= 0:
                raise ValueError("class_weights must be positive")
            out.class_weights = weights
        if "default_class" in cfg:
            out.default_class = str(cfg["default_class"])
        if out.default_class not in out.class_weights:
            raise ValueError(
                f"default_class '{out.default_class}' not in class_weights "
                f"{sorted(out.class_weights)}"
            )
        if "tenant_quota" in cfg and cfg["tenant_quota"] is not None:
            out.tenant_quota = max(1, int(cfg["tenant_quota"]))
        if "target_wait_s" in cfg:
            out.target_wait_s = float(cfg["target_wait_s"])
        if "scale_down_ticks" in cfg:
            out.scale_down_ticks = max(1, int(cfg["scale_down_ticks"]))
        if "ewma_alpha" in cfg:
            out.ewma_alpha = min(1.0, max(0.01, float(cfg["ewma_alpha"])))
        if "slo_pressure" in cfg:
            out.slo_pressure = bool(cfg["slo_pressure"])
        return out


# ---------------------------------------------------------------------------
# cost-model scorer (pluggable — the learnable policy surface)
# ---------------------------------------------------------------------------


class ReplicaScorer(Protocol):
    """Placement policy contract: lower score wins. ``features`` is the
    stable interface a learned policy consumes — keys: ``load``,
    ``queued``, ``max_ongoing``, ``breaker_failures``,
    ``signature_affinity``, ``avoided``, ``probation``, ``group_size``.

    The dict is a REUSED template mutated between ``score`` calls (one
    allocation per scheduler, not per candidate): read synchronously,
    copy (``dict(features)``) before retaining for training datasets or
    deferred scoring."""

    def score(self, features: dict) -> float: ...


class HeuristicCostModel:
    """Default scorer: occupancy plus a breaker-risk penalty, minus a
    warm-program affinity bonus (the replica that last served this
    signature holds the compiled program and batcher group hot).
    Replicas the request already failed on score worst — preferred
    against, but still usable as a last resort, matching the router."""

    def __init__(
        self,
        queued_weight: float = 0.1,
        breaker_penalty: float = 0.5,
        affinity_bonus: float = 0.15,
        avoid_penalty: float = 10.0,
        probation_penalty: float = 20.0,
    ):
        self.queued_weight = queued_weight
        self.breaker_penalty = breaker_penalty
        self.affinity_bonus = affinity_bonus
        self.avoid_penalty = avoid_penalty
        self.probation_penalty = probation_penalty

    def score(self, features: dict) -> float:
        s = float(features.get("load", 0.0))
        s += self.queued_weight * float(features.get("queued", 0) or 0)
        s += self.breaker_penalty * float(
            features.get("breaker_failures", 0) or 0
        )
        if features.get("signature_affinity"):
            s -= self.affinity_bonus
        if features.get("avoided"):
            s += self.avoid_penalty
        if features.get("probation"):
            # latency outlier (gray failure): soft ejection — scored
            # far behind every healthy sibling, above only nothing at
            # all (the trickle probe bypasses scoring entirely)
            s += self.probation_penalty
        return s


# ---------------------------------------------------------------------------
# load prediction (EWMA arrival rate + service time)
# ---------------------------------------------------------------------------


class LoadPredictor:
    """EWMA of arrival rate and per-request service time; the scaling
    signal is computed from MEASURED flow, not from already-saturated
    queues — projected wait crosses the threshold while the queue is
    still shallow, which is the whole point of scaling predictively."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.arrival_rate = 0.0        # requests/s (EWMA)
        self.service_s = 0.0           # seconds/request (EWMA)
        self._last_arrival: Optional[float] = None
        self._below_ticks = 0

    def note_arrival(self, now: float) -> None:
        if self._last_arrival is not None:
            dt = max(now - self._last_arrival, 1e-4)
            inst = 1.0 / dt
            self.arrival_rate += self.alpha * (inst - self.arrival_rate)
        self._last_arrival = now

    def note_service(
        self, n_requests: int, wall_s: float, reground: bool = False
    ) -> None:
        per = wall_s / max(1, n_requests)
        if self.service_s == 0.0 or reground:
            # reground: the sample comes from an infeasibility PROBE —
            # it exists precisely because the current estimate is
            # suspect (poisoned by an outlier, or stale), so it
            # replaces the estimate instead of nudging an EWMA that
            # would take dozens of samples to climb down from a 120 s
            # cold-compile spike
            self.service_s = per
        else:
            self.service_s += self.alpha * (per - self.service_s)

    def service_estimate_s(self) -> float:
        return self.service_s

    def current_rate(self, now: float) -> float:
        """The EWMA, capped by the observed idle gap — an EWMA only
        updates on arrival, so without the cap a traffic stop would
        freeze a high rate forever and block scale-down."""
        if self._last_arrival is None:
            return 0.0
        gap = max(now - self._last_arrival, 1e-4)
        return min(self.arrival_rate, 1.0 / gap)

    def projection(self, now: float, queue_depth: int, n_replicas: int) -> dict:
        """Replicas modeled as serial servers (honest for accelerator
        work — concurrent calls time-share the same chips): capacity is
        n/s requests/s, utilization is (arrival rate)/(capacity), and
        the projected wait of a NEW arrival is the backlog divided by
        drain rate."""
        n = max(1, n_replicas)
        s = self.service_s
        rate = self.current_rate(now)
        utilization = rate * s / n
        projected_wait = (queue_depth * s / n) if s > 0 else 0.0
        return {
            "arrival_rate": round(rate, 3),
            "service_s": round(s, 6),
            "utilization": round(utilization, 4),
            "projected_wait_s": projected_wait,
            "queue_depth": queue_depth,
        }

    def decide(
        self,
        now: float,
        queue_depth: int,
        n_replicas: int,
        target_wait_s: float,
        target_load: float,
        scale_down_ticks: int,
    ) -> tuple[str, dict]:
        proj = self.projection(now, queue_depth, n_replicas)
        if (
            proj["utilization"] > target_load
            or proj["projected_wait_s"] > target_wait_s
        ):
            self._below_ticks = 0
            return "up", proj
        if proj["utilization"] < target_load / 2 and queue_depth == 0:
            # scale-down needs HYSTERESIS: one idle tick is noise, K
            # consecutive ones are a trend worth paying a drain for
            self._below_ticks += 1
            if self._below_ticks >= scale_down_ticks:
                self._below_ticks = 0
                return "down", proj
        else:
            self._below_ticks = 0
        return "hold", proj


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------


@dataclass
class _Request:
    method: str
    args: tuple
    kwargs: dict
    signature: Hashable
    priority: str
    tenant: Optional[str]
    deadline: Optional[float]          # monotonic; None = unbounded
    timeout_s: Optional[float]         # per-attempt budget from the handle
    avoid: frozenset
    future: asyncio.Future
    # admitted despite an infeasible-looking deadline to re-ground the
    # service estimate — exempt from the predictive shed (absolute
    # expiry still applies)
    probe: bool = False
    # waiting-bookkeeping consumed exactly once (dispatch, shed, close,
    # or caller abandonment) — see _finish_waiting
    finished_waiting: bool = False
    enqueued_at: float = field(default_factory=time.monotonic)
    # sampled-trace identity captured at submit (None when unsampled):
    # queue wait is only measurable at dispatch, so the span is recorded
    # retroactively against the submitter's trace
    trace_ctx: Any = None
    parent_span: Optional[str] = None

    def sort_key(self) -> tuple:
        # EDF within a class; deadline-free requests keep arrival order
        # behind every deadlined one
        return (
            self.deadline if self.deadline is not None else float("inf"),
            self.enqueued_at,
        )

    def slack(self, now: float) -> float:
        return (
            float("inf") if self.deadline is None else self.deadline - now
        )


class DeploymentScheduler:
    """One per scheduled deployment, owned by the controller. The
    handle's retry envelope stays in charge of failover/backoff —
    ``submit`` is one attempt: admission, fair queueing, group
    coalescing, scored dispatch, result delivery."""

    def __init__(
        self,
        controller,
        app_id: str,
        deployment: str,
        spec,
        config: SchedulingConfig,
        scorer: Optional[ReplicaScorer] = None,
    ):
        self.controller = controller
        self.app_id = app_id
        self.deployment = deployment
        self.spec = spec
        self.cfg = config
        self.scorer: ReplicaScorer = scorer or HeuristicCostModel()
        self._queues: dict[str, list[_Request]] = {
            c: [] for c in config.class_weights
        }
        self._deficit: dict[str, float] = {c: 0.0 for c in config.class_weights}
        self._open: dict[Hashable, list[_Request]] = {}
        self._timers: dict[Hashable, asyncio.Task] = {}
        self._timer_fire_at: dict[Hashable, float] = {}
        self._inflight: set[asyncio.Task] = set()
        self._waiting_by_tenant: dict[str, int] = {}
        self.waiting = 0               # class queues + open groups
        self._fast_inflight = 0        # uncontended inline dispatches
        self._closed = False
        self._last_scale_signal = 0.0
        self.predictor = LoadPredictor(alpha=config.ewma_alpha)
        self._last_signature: dict[str, Hashable] = {}  # replica -> sig
        # cheap in-process counters for tests/describe (metric children
        # are the exported truth; this dict avoids label lookups there)
        self.stats = {
            "admitted": 0,
            "rejected": 0,
            "dispatched_groups": 0,
            "dispatched_requests": 0,
            "shed_deadline": 0,
            "fast_path": 0,
            "infeasible_probes": 0,
            "unknown_priority": 0,
        }
        self._infeasible_streak = 0
        self._warned_priorities: set = set()
        # SLO burn-rate pressure hook (the pluggable half of "close the
        # loop"): a zero-arg callable returning the deployment's current
        # burn normalized to the page threshold. None (the default)
        # keeps scaling purely queue-projection driven; the controller
        # wires it only when scheduling.slo_pressure is on AND the
        # deployment carries a manifest slo: block.
        self.pressure_fn: Optional[Callable[[], float]] = None
        self._m_admitted: dict[str, Any] = {}
        self._m_wait: dict[str, Any] = {}
        self._m_rejected: dict[str, Any] = {}  # reason -> counter child
        self._m_batch = SCHED_BATCH_SIZE.labels(app_id, deployment)
        self._m_dispatch = SCHED_DISPATCHES.labels(app_id, deployment)
        # reusable scorer feature dict — see _best_replica
        self._feat_template: dict[str, Any] = {
            "load": 0,
            "queued": 0,
            "max_ongoing": 0,
            "breaker_failures": 0,
            "signature_affinity": False,
            "avoided": False,
            "probation": False,
            "group_size": 1,
        }
        _SCHEDULERS.add(self)

    # ---- admission ----------------------------------------------------------

    async def submit(
        self,
        method: str,
        args: tuple,
        kwargs: dict,
        options,
        timeout_s: Optional[float] = None,
        deadline: Optional[float] = None,
        avoid: Optional[frozenset] = None,
    ) -> Any:
        if self._closed:
            raise ReplicaUnavailableError(
                f"scheduler for {self.app_id}/{self.deployment} is closed"
            )
        now = time.monotonic()
        priority = getattr(options, "priority", None) or self.cfg.default_class
        if priority not in self._queues:
            self._note_unknown_priority(priority)
            priority = self.cfg.default_class
        tenant = getattr(options, "tenant", None)
        if self.waiting >= self.cfg.max_queue_depth:
            self._reject("queue_full", priority, tenant, method)
        if (
            tenant is not None
            and self.cfg.tenant_quota is not None
            and self._waiting_by_tenant.get(tenant, 0) >= self.cfg.tenant_quota
        ):
            self._reject("tenant_quota", priority, tenant, method)
        est = self.predictor.service_estimate_s()
        probe = False
        if deadline is not None:
            if deadline - now < est:
                # admitting would only burn queue space: even an empty
                # fleet could not finish this before its deadline —
                # except every Nth in a row, which probes through so a
                # wrong estimate can never shed deadlined traffic
                # forever (see INFEASIBLE_PROBE_EVERY)
                self._infeasible_streak += 1
                if self._infeasible_streak % INFEASIBLE_PROBE_EVERY != 0:
                    self._reject(
                        "deadline_infeasible", priority, tenant, method
                    )
                probe = True
                self.stats["infeasible_probes"] += 1
            else:
                self._infeasible_streak = 0
        signature = batch_signature(method, tuple(args), kwargs)
        if (
            self.waiting == 0
            and not self._inflight
            and self._fast_inflight == 0
            and not self._open
        ):
            # UNCONTENDED fast path: a lone request on an idle
            # deployment gains nothing from queueing — no companion
            # exists to coalesce with, and charging it the batching
            # window would be pure latency. Dispatch inline through the
            # scored pick; the moment a second request overlaps, the
            # fair-queue path takes over and coalescing resumes.
            replica = self._pick_now(signature, avoid or frozenset())
            if replica is not None:
                return await self._fast_dispatch(
                    replica, signature, method, args, kwargs,
                    timeout_s, priority, now, probe,
                )
        self.predictor.note_arrival(now)
        ctx, span_id = tracing.current_trace_and_span()
        sampled = ctx is not None and ctx.sampled
        req = _Request(
            method=method,
            args=tuple(args),
            kwargs=dict(kwargs),
            signature=signature,
            priority=priority,
            tenant=tenant,
            deadline=deadline,
            timeout_s=timeout_s,
            avoid=avoid or frozenset(),
            probe=probe,
            future=asyncio.get_running_loop().create_future(),
            trace_ctx=ctx if sampled else None,
            parent_span=span_id if sampled else None,
        )
        queue = self._queues[priority]
        # EDF insertion: linear from the back (deadline-free traffic —
        # the common case — appends in O(1))
        idx = len(queue)
        key = req.sort_key()
        while idx > 0 and queue[idx - 1].sort_key() > key:
            idx -= 1
        queue.insert(idx, req)
        self.waiting += 1
        if tenant is not None:
            self._waiting_by_tenant[tenant] = (
                self._waiting_by_tenant.get(tenant, 0) + 1
            )
        self._note_admitted(priority)
        self._maybe_signal_scale(now)
        self._pump()
        try:
            if timeout_s is None:
                return await req.future
            # the member's OWN budget bounds its wait, whatever group
            # it lands in — co-batching with a no-timeout companion
            # must not let a tight-budget caller inherit the loosest
            # member's budget (the group's host-side abort still uses
            # the group max; this is the caller-side cut, exactly like
            # the router's call_bounded wrapper). wait_for cancels the
            # future, and _run_group skips done futures at delivery.
            return await asyncio.wait_for(req.future, timeout_s)
        except (asyncio.TimeoutError, asyncio.CancelledError):
            # the caller is GONE: the zombie stays in its queue/group
            # (delivery skips done futures) but must release its
            # admission depth now — live traffic must never be shed on
            # queue space held by futures nobody is waiting on
            self._finish_waiting(req)
            raise

    def _note_unknown_priority(self, priority: str) -> None:
        """A mistagged request silently riding the default class would
        degrade real interactive traffic at the default weight with no
        operator signal — warn ONCE per unknown tag (a busy mistagged
        client must not spam the log) and keep a counter + flight
        event. Manifest-side typos already fail the build; request-side
        ones can only be flagged at runtime."""
        self.stats["unknown_priority"] += 1
        if priority in self._warned_priorities:
            return
        self._warned_priorities.add(priority)
        self.controller.logger.warning(
            f"unknown request priority '{priority}' on "
            f"{self.app_id}/{self.deployment}; using "
            f"'{self.cfg.default_class}' (classes: {sorted(self._queues)})"
        )
        flight.record(
            "admission.unknown_priority",
            severity="warning",
            app=self.app_id,
            deployment=self.deployment,
            priority=str(priority)[:64],
            default=self.cfg.default_class,
        )

    def _note_admitted(self, priority: str) -> None:
        self.stats["admitted"] += 1
        if metrics.metrics_enabled():
            child = self._m_admitted.get(priority)
            if child is None:
                child = self._m_admitted[priority] = SCHED_ADMITTED.labels(
                    self.app_id, self.deployment, priority
                )
            child.inc()

    def _reject(
        self, reason: str, priority: str, tenant: Optional[str], method: str
    ) -> None:
        self.stats["rejected"] += 1
        child = self._m_rejected.get(reason)
        if child is None:
            child = self._m_rejected[reason] = SCHED_REJECTED.labels(
                self.app_id, self.deployment, reason
            )
        child.inc()
        flight.record(
            "admission.reject",
            severity="warning",
            app=self.app_id,
            deployment=self.deployment,
            method=method,
            reason=reason,
            priority=priority,
            tenant=tenant,
            queue_depth=self.waiting,
        )
        raise AdmissionRejectedError(
            f"{self.app_id}/{self.deployment}.{method} shed by admission "
            f"control ({reason}; depth={self.waiting}/"
            f"{self.cfg.max_queue_depth})",
            reason=reason,
        )

    def _best_replica(
        self, signature: Hashable, avoid: frozenset, group_size: int
    ):
        """ONE scored argmin over the routable replicas — the single
        place the scorer's feature contract is built, shared by the
        fast path and the group-dispatch pick so the two can never
        drift. None when no routable replica exists right now.

        PROBATION replicas (latency outliers) ride the same contract:
        the ``probation`` feature lets any scorer — heuristic or
        learned — price the soft ejection, and the trickle probe
        (every Nth pick, serving/outlier.py) bypasses scoring entirely
        so recovery keeps being measured with real traffic."""
        app = self.controller.apps.get(self.app_id)
        if app is None:
            return None
        candidates = [
            r
            for r in app.replicas.get(self.deployment, [])
            if r.state in ROUTABLE_STATES
        ]
        probation = [
            r for r in candidates if r.state == ReplicaState.PROBATION
        ]
        if probation and len(probation) < len(candidates):
            tracker = self.controller._outlier_tracker(
                self.app_id, self.deployment
            )
            if tracker.take_probe_ticket():
                pool = [
                    r for r in probation if r.replica_id not in avoid
                ] or probation
                return pool[tracker._probe_tick % len(pool)]
        best = None
        best_score = None
        # one reusable feature dict, mutated per candidate: the scorer
        # contract is read-synchronously-then-forget (HeuristicCostModel
        # and any FittedCostModel must copy if they retain — documented
        # on ReplicaScorer). Building an 8-key dict literal per
        # candidate per pick was a measurable slice of the uncontended
        # submit budget.
        feats = self._feat_template
        feats["group_size"] = group_size
        breaker_counts = self.controller._breaker_counts
        last_sig = self._last_signature
        score = self.scorer.score
        for r in candidates:
            rid = r.replica_id
            feats["load"] = r.load
            feats["queued"] = getattr(r, "_queued", 0)
            feats["max_ongoing"] = r.max_ongoing_requests
            feats["breaker_failures"] = breaker_counts.get(rid, 0)
            feats["signature_affinity"] = last_sig.get(rid) == signature
            feats["avoided"] = rid in avoid
            feats["probation"] = r.state == ReplicaState.PROBATION
            s = score(feats)
            if best_score is None or s < best_score:
                best, best_score = r, s
        return best

    def _pick_now(self, signature: Hashable, avoid: frozenset):
        """Synchronous scored pick for the fast path; None when no
        routable replica exists right now (the queued path then parks
        through the restart window like the router does)."""
        return self._best_replica(signature, avoid, 1)

    async def _fast_dispatch(
        self,
        replica,
        signature: Hashable,
        method: str,
        args: tuple,
        kwargs: dict,
        timeout_s: Optional[float],
        priority: str,
        now: float,
        probe: bool = False,
    ):
        self.predictor.note_arrival(now)
        self._note_admitted(priority)
        self.stats["fast_path"] += 1
        self._fast_inflight += 1
        t0 = time.monotonic()
        try:
            result = await replica.call_bounded(
                method, args, kwargs, timeout_s=timeout_s
            )
        except Exception as e:
            # same breaker discipline as the router and group paths:
            # only transport-classified failures are replica-health
            # evidence — an app error (bad client input) or the
            # caller's own budget expiring must never eject a replica
            if not is_caller_timeout(e) and is_retryable(e):
                self.controller._breaker_failure(replica, e)
            self._attach_replica(e, replica)
            raise
        else:
            self.controller._breaker_success(replica)
            # successful service time feeds the gray-failure outlier
            # EWMA — same evidence stream as the router path
            self.controller._note_attempt_latency(
                replica, time.monotonic() - t0
            )
            self._last_signature[replica.replica_id] = signature
            self._prune_affinity()
            self.predictor.note_service(
                1, time.monotonic() - t0, reground=probe
            )
            return result
        finally:
            self._fast_inflight -= 1
            self._pump()  # work may have queued behind this dispatch

    # ---- fair dequeue + group formation -------------------------------------

    def _n_routable(self) -> int:
        app = self.controller.apps.get(self.app_id)
        if app is None:
            return 0
        return sum(
            1
            for r in app.replicas.get(self.deployment, [])
            if r.state in ROUTABLE_STATES
        )

    def _dispatch_capacity(self) -> int:
        # enough in-flight groups to keep every replica busy plus one
        # forming behind it; the backlog beyond that stays in the FAIR
        # queues, where priority weights decide who goes next
        return max(1, 2 * self._n_routable())

    def _next_request(self) -> Optional[_Request]:
        """Deficit-weighted round robin across class queues: every pass
        grants each backlogged class its weight in credit; one request
        costs one credit. Served shares converge to the weight ratio
        under saturation, and any positive weight guarantees progress —
        the bulk class can be slowed, never starved."""
        nonempty = [c for c in self._queues if self._queues[c]]
        if not nonempty:
            return None
        for c in self._queues:
            if not self._queues[c]:
                # empty classes don't bank credit (no burst after idle)
                self._deficit[c] = 0.0
        while True:
            for c in nonempty:
                if self._queues[c] and self._deficit[c] >= 1.0:
                    self._deficit[c] -= 1.0
                    return self._queues[c].pop(0)
            for c in nonempty:
                self._deficit[c] += self.cfg.class_weights.get(c, 1.0)

    def _pump(self) -> None:
        """Drain class queues into signature groups while dispatch
        capacity remains. Full groups dispatch immediately; partial
        groups wait out the coalescing window (bounded by the tightest
        member's slack) for companions.

        Capacity gates the OPENING of new groups (open + in-flight
        stays within bound): forming a group commits its members past
        the fair queues, and a signature-diverse backlog would
        otherwise drain entirely into open groups in one pass — every
        timer-fired dispatch then runs regardless of load, and
        late-arriving interactive traffic would queue at replica
        semaphores instead of overtaking via class weights. JOINING an
        already-open group is always allowed — that's coalescing, the
        whole point — so a same-signature flood still fills groups to
        max_batch while the excess backlog stays in the fair queues,
        where DRR/EDF decide who goes next."""
        if self._closed:
            return
        while True:
            req = self._next_request()
            if req is None:
                return
            if (
                req.signature not in self._open
                and len(self._inflight) + len(self._open)
                >= self._dispatch_capacity()
            ):
                # no capacity for a NEW group: hand the request back to
                # the head of its class queue (it was the head — EDF
                # order is preserved) with its DRR credit refunded, and
                # stop pumping until a dispatch slot frees
                self._queues[req.priority].insert(0, req)
                self._deficit[req.priority] += 1.0
                return
            now = time.monotonic()
            if req.deadline is not None:
                # a probe exists to correct the estimate, so the
                # estimate must not be allowed to shed it — only true
                # expiry can
                est = (
                    0.0 if req.probe
                    else self.predictor.service_estimate_s()
                )
                if req.deadline - now <= est:
                    # the request can no longer finish — fail NOW, not
                    # after burning a replica slot on a doomed call
                    self._finish_waiting(req)
                    self.stats["shed_deadline"] += 1
                    if not req.future.done():
                        req.future.set_exception(
                            DeadlineExceeded(
                                f"{self.app_id}/{self.deployment}."
                                f"{req.method} shed before dispatch: "
                                f"deadline unreachable (est {est:.3f}s)"
                            )
                        )
                    continue
            group = self._open.setdefault(req.signature, [])
            group.append(req)
            if len(group) >= self.cfg.max_batch:
                self._cancel_timer(req.signature)
                self._dispatch_group(req.signature)
                continue
            wait_budget = self.cfg.max_wait_ms / 1000.0
            if req.deadline is not None:
                est = self.predictor.service_estimate_s()
                wait_budget = min(
                    wait_budget, max(0.0, req.slack(now) - 2.0 * est)
                )
            if wait_budget <= 0.0005:
                # no slack to coalesce — this member's deadline beats
                # batching efficiency
                self._cancel_timer(req.signature)
                self._dispatch_group(req.signature)
                continue
            fire_at = now + wait_budget
            current = self._timer_fire_at.get(req.signature)
            if current is None or fire_at < current - 0.0005:
                # (re-)arm: a deadline-pressed member JOINING an open
                # group pulls its dispatch forward — the coalescing
                # window really is bounded by the tightest member's
                # slack, not just the opener's
                self._cancel_timer(req.signature)
                self._timer_fire_at[req.signature] = fire_at
                self._timers[req.signature] = asyncio.create_task(
                    self._timed_dispatch(req.signature, wait_budget)
                )

    async def _timed_dispatch(self, signature: Hashable, delay: float) -> None:
        try:
            await asyncio.sleep(delay)
            self._timers.pop(signature, None)
            self._timer_fire_at.pop(signature, None)
            self._dispatch_group(signature)
        except asyncio.CancelledError:
            self._timers.pop(signature, None)
            raise

    def _cancel_timer(self, signature: Hashable) -> None:
        task = self._timers.pop(signature, None)
        self._timer_fire_at.pop(signature, None)
        if task:
            task.cancel()

    def _finish_waiting(self, req: _Request) -> None:
        if req.finished_waiting:
            return  # abandonment and dispatch may both reach here
        req.finished_waiting = True
        self.waiting -= 1
        if req.tenant is not None:
            n = self._waiting_by_tenant.get(req.tenant, 1) - 1
            if n <= 0:
                self._waiting_by_tenant.pop(req.tenant, None)
            else:
                self._waiting_by_tenant[req.tenant] = n

    # ---- dispatch -----------------------------------------------------------

    def _dispatch_group(self, signature: Hashable) -> None:
        group = self._open.pop(signature, None)
        if not group:
            return
        now = time.monotonic()
        m_on = metrics.metrics_enabled()
        for r in group:
            self._finish_waiting(r)
            if m_on:
                child = self._m_wait.get(r.priority)
                if child is None:
                    child = self._m_wait[r.priority] = SCHED_QUEUE_WAIT.labels(
                        self.app_id, self.deployment, r.priority
                    )
                child.observe(now - r.enqueued_at)
        self.stats["dispatched_groups"] += 1
        self.stats["dispatched_requests"] += len(group)
        if m_on:
            self._m_dispatch.inc()
            self._m_batch.observe(len(group))
        task = spawn_supervised(
            self._run_group(signature, group),
            name=f"sched-dispatch-{self.app_id}-{self.deployment}",
        )
        self._inflight.add(task)
        task.add_done_callback(self._group_done)

    def _group_done(self, task: asyncio.Task) -> None:
        self._inflight.discard(task)
        self._pump()  # a freed slot may unblock queued work

    async def _run_group(
        self, signature: Hashable, group: list[_Request]
    ) -> None:
        now = time.monotonic()
        now_wall = time.time()
        live: list[_Request] = []
        for r in group:
            if r.trace_ctx is not None:
                wait = now - r.enqueued_at
                tracing.record_span(
                    "sched.queue",
                    wait,
                    started_at=now_wall - wait,
                    parent_id=r.parent_span,
                    ctx=r.trace_ctx,
                    batch_size=len(group),
                    priority=r.priority,
                )
            if r.future.done():
                continue  # caller gave up while queued
            if r.deadline is not None and r.deadline <= now:
                r.future.set_exception(
                    DeadlineExceeded(
                        f"{self.app_id}/{self.deployment}.{r.method} "
                        f"deadline passed while queued"
                    )
                )
                continue
            live.append(r)
        if not live:
            return
        avoid = frozenset().union(*(r.avoid for r in live))
        deadline = None
        if all(r.deadline is not None for r in live):
            deadline = max(r.deadline for r in live)
        try:
            replica = await self._pick_replica_wait(
                signature, avoid, len(live), deadline
            )
        except Exception as e:  # noqa: BLE001 — typed routing errors fan out
            for r in live:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        timeouts = [r.timeout_s for r in live]
        timeout_s = (
            None if any(t is None for t in timeouts) else max(timeouts)
        )
        payload = [{"args": list(r.args), "kwargs": r.kwargs} for r in live]
        t0 = time.monotonic()
        t0_wall = time.time()  # AFTER the pick: spans must not absorb the park
        try:
            items = await replica.call_batch(
                live[0].method, payload, timeout_s=timeout_s
            )
            if len(items) != len(live):
                raise RuntimeError(
                    f"call_batch returned {len(items)} results for "
                    f"{len(live)} requests"
                )
        except Exception as e:  # noqa: BLE001 — classified by the handle's envelope
            # whole-group failure (transport / host gone / budget cut):
            # mirror the direct path's breaker discipline — only a
            # transport-classified failure is replica-health evidence;
            # a caller's expired budget or a client-caused error that
            # died before/inside the frame (APPLICATION kind) is not
            if not is_caller_timeout(e) and is_retryable(e):
                self.controller._breaker_failure(replica, e)
            self._attach_replica(e, replica)
            for r in live:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        wall = time.monotonic() - t0
        self._last_signature[replica.replica_id] = signature
        self._prune_affinity()
        # one outlier-EWMA sample per dispatched group: the group wall
        # is the service time every member experienced on this replica
        self.controller._note_attempt_latency(replica, wall)
        self.predictor.note_service(
            len(live), wall, reground=any(r.probe for r in live)
        )
        breaker_exc = None
        for r, item in zip(live, items):
            if item.get("ok"):
                if not r.future.done():
                    self._record_dispatch_span(r, replica, wall, t0_wall)
                    r.future.set_result(item.get("result"))
                continue
            exc = item.get("exception")
            if exc is None:
                # remote member failure: rebuild on the existing
                # RemoteError wire contract so the handle's
                # classify-by-type-name taxonomy applies unchanged
                exc = RemoteError(
                    item.get("type", "Exception"),
                    item.get("error", "remote batch member failed"),
                )
            # a transport-classified member failure is replica-health
            # evidence even though the frame round-tripped (e.g. the
            # instance's transport raised, or the replica flipped
            # non-routable mid-batch) — but a member's own budget
            # expiring is not
            if not is_caller_timeout(exc) and is_retryable(exc):
                breaker_exc = exc
            self._attach_replica(exc, replica)
            if not r.future.done():
                r.future.set_exception(exc)
        if breaker_exc is not None:
            # ONE failure per dispatch, like one per attempt on the
            # router path — a 16-member batch rejected by a draining
            # replica is one event, not sixteen breaker strikes
            self.controller._breaker_failure(replica, breaker_exc)
        else:
            self.controller._breaker_success(replica)

    @staticmethod
    def _attach_replica(exc: BaseException, replica) -> None:
        """Stamp the serving replica on a member failure so the
        handle's failover loop can avoid it next attempt (the scheduler
        picked the replica, so the handle never saw it)."""
        try:
            exc.replica_id = replica.replica_id
        except (AttributeError, TypeError):
            pass  # slotted/frozen exception types opt out of the hint

    def _record_dispatch_span(
        self, r: _Request, replica, wall: float, started_wall: float
    ) -> None:
        if r.trace_ctx is None:
            return
        tracing.record_span(
            "sched.dispatch",
            wall,
            started_at=started_wall,
            parent_id=r.parent_span,
            ctx=r.trace_ctx,
            replica=replica.replica_id,
        )

    def _prune_affinity(self) -> None:
        """Bound the warm-signature map: replica restarts mint new ids,
        and the map must not grow without bound under churn (swept on a
        size trigger so it runs on every code path, autoscale or not)."""
        if len(self._last_signature) <= 8 + 2 * len(self._all_replicas()):
            return
        live = {r.replica_id for r in self._all_replicas()}
        for rid in [r for r in self._last_signature if r not in live]:
            del self._last_signature[rid]

    async def _pick_replica_wait(
        self,
        signature: Hashable,
        avoid: frozenset,
        group_size: int,
        deadline: Optional[float],
    ):
        """Scored replica choice, waiting through restart windows like
        the router does (same grace/deadline bound, same wakeup)."""
        controller = self.controller
        wait_until = (
            deadline
            if deadline is not None
            else time.monotonic() + controller.pick_replica_grace_s
        )
        while True:
            if controller.apps.get(self.app_id) is None:
                raise NoHealthyReplicasError(
                    f"app '{self.app_id}' is gone"
                )
            best = self._best_replica(signature, avoid, group_size)
            if best is not None:
                return best
            remaining = wait_until - time.monotonic()
            if remaining <= 0:
                raise NoHealthyReplicasError(
                    f"no healthy replicas for "
                    f"{self.app_id}/{self.deployment}"
                )
            controller._replicas_changed.clear()
            try:
                await asyncio.wait_for(
                    controller._replicas_changed.wait(), min(remaining, 0.25)
                )
            except asyncio.TimeoutError:
                pass

    # ---- autoscaling signal -------------------------------------------------

    def _maybe_signal_scale(self, now: float) -> None:
        """Submit-time early trigger (rate-limited): when the projected
        wait crosses the threshold, ring the health loop NOW — the next
        periodic tick may be most of a health period away, which is
        exactly the reactive lag predictive scaling exists to remove."""
        if now - self._last_scale_signal < 1.0:
            return
        n = self._n_routable()
        if n == 0:
            return
        proj = self.predictor.projection(now, self.waiting, n)
        if (
            proj["projected_wait_s"] > self.cfg.target_wait_s
            and len(self._all_replicas()) < self.spec.max_replicas
        ):
            self._last_scale_signal = now
            flight.record(
                "scale.predict",
                app=self.app_id,
                deployment=self.deployment,
                direction="up",
                trigger="submit",
                **{
                    k: proj[k]
                    for k in ("projected_wait_s", "arrival_rate", "service_s")
                },
            )
            self.controller._wake_health.set()

    def _all_replicas(self) -> list:
        app = self.controller.apps.get(self.app_id)
        if app is None:
            return []
        return app.replicas.get(self.deployment, [])

    def scale_decision(self, n_routable: int) -> tuple[str, dict]:
        """The controller's autoscale pass calls this each tick; the
        non-hold verdicts land in the flight ring with the projection
        that justified them."""
        now = time.monotonic()
        decision, proj = self.predictor.decide(
            now,
            self.waiting,
            n_routable,
            self.cfg.target_wait_s,
            self.spec.target_load,
            self.cfg.scale_down_ticks,
        )
        trigger = "tick"
        if self.pressure_fn is not None:
            try:
                pressure = float(self.pressure_fn())
            except Exception:  # noqa: BLE001 — a hook bug must not stop scaling
                pressure = 0.0
            proj["slo_pressure"] = round(pressure, 3)
            if pressure >= 1.0 and decision != "up":
                # the deployment is burning its error budget at page
                # rate: capacity is the one lever the controller holds,
                # whatever the queue projection says (latency burn with
                # shallow queues = slow replicas, not idle ones). ONE
                # event, attributed to the burn — the projection below
                # is the one that said hold.
                decision = "up"
                trigger = "slo_burn"
        if decision != "hold":
            flight.record(
                "scale.predict",
                app=self.app_id,
                deployment=self.deployment,
                direction=decision,
                trigger=trigger,
                **{
                    k: proj[k]
                    for k in (
                        "projected_wait_s",
                        "arrival_rate",
                        "service_s",
                        "utilization",
                        "queue_depth",
                        *(("slo_pressure",) if "slo_pressure" in proj else ()),
                    )
                },
            )
        return decision, proj

    # ---- status / lifecycle -------------------------------------------------

    def describe(self) -> dict:
        now = time.monotonic()
        return {
            "enabled": True,
            "queue_depth": {c: len(q) for c, q in self._queues.items()},
            "open_groups": len(self._open),
            "inflight_groups": len(self._inflight),
            "waiting": self.waiting,
            "stats": dict(self.stats),
            "prediction": self.predictor.projection(
                now, self.waiting, max(1, self._n_routable())
            ),
        }

    def _fail_pending(self, reason: str) -> None:
        """Shared teardown flush: stop the timers, empty every class
        queue and open group, and fail each stranded request typed (so
        idempotent callers fail over / surface cleanly)."""
        self._closed = True
        for signature in list(self._timers):
            self._cancel_timer(signature)
        pending: list[_Request] = []
        for q in self._queues.values():
            pending.extend(q)
            q.clear()
        for group in self._open.values():
            pending.extend(group)
        self._open.clear()
        for r in pending:
            self._finish_waiting(r)
            if not r.future.done():
                r.future.set_exception(
                    ReplicaUnavailableError(
                        f"{self.app_id}/{self.deployment} {reason}"
                    )
                )

    def kill(self) -> None:
        """Crash-path teardown (the scenario engine's SIGKILL
        emulation): the process owning this scheduler is "gone" — every
        queued / open-group request fails typed IMMEDIATELY (exactly
        what a severed client connection would surface) and in-flight
        groups are left to die with their transport. Unlike
        :meth:`close`, nothing is drained: a dead process drains
        nothing."""
        self._fail_pending("control plane died with this request queued")

    async def close(self) -> None:
        """Undeploy path: fail everything still waiting (typed, so
        idempotent callers fail over / surface cleanly) and drain
        in-flight groups — dispatched work finishes against replicas
        the controller is about to drain anyway."""
        self._fail_pending("scheduler closed (undeploy)")
        # bounded, like every other drain in the shutdown path: a group
        # wedged inside a stuck instance must not wedge undeploy — the
        # replica drain/stop that follows owns stranded calls
        deadline = time.monotonic() + DEFAULT_DRAIN_TIMEOUT_S
        while self._inflight:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            done, _ = await asyncio.wait(
                list(self._inflight), timeout=remaining
            )
            if not done:
                break
