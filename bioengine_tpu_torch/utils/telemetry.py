"""Telemetry history — the fixed-memory multi-resolution series store.

The metrics plane (PR 6) answers "what is this worker doing *right
now*"; nothing in the system remembers what it was doing five minutes
ago, so questions like "is this deployment meeting its latency target
this hour" (the SLO engine, serving/slo.py) or "what did load look
like before the page" (the GDP-style learned-placement feature stream,
PAPERS.md) had no substrate. This module is that substrate:

- **Snapshots, not scrapes.** A :class:`RegistrySampler` diffs two
  successive ``metrics.collect()`` snapshots into per-deployment
  DELTAS — counters become per-interval counts, histogram buckets
  become per-interval bucket counts, gauges are point-sampled. Worker
  hosts run one and push the result to the controller over the
  existing RPC plane (capability ``telem1``, worker_host.py); the
  controller runs its own over the local registry. Either way the
  store never touches the hot path — it consumes what the registry
  already accumulates.
- **Fixed memory.** :class:`TelemetryStore` keeps, per deployment and
  per resolution, a ring of time-aligned buckets
  (default ``10s x 360 / 1m x 180 / 5m x 288`` — one hour of fine
  grain, three of medium, a day of coarse). Rings are bounded deques;
  the deployment-key set is bounded too (LRU eviction at
  ``BIOENGINE_TELEM_MAX_SERIES``), so a deploy/undeploy churn loop or
  a hostile push stream cannot grow the store.
- **Reconstructable series.** :meth:`TelemetryStore.series` turns the
  stored deltas back into the series operators ask for — request/error
  rates, latency quantiles re-estimated from merged histogram buckets
  (same upper-edge estimator as the live registry, so the two agree
  within quantile-bucket error), queue depth, chip-seconds, shed
  counts — and :meth:`window_aggregate` folds a wall-clock window into
  the totals the SLO burn-rate math consumes.

Env knobs: ``BIOENGINE_TELEM_RES`` overrides the resolution ladder
(``"10x360,60x180,300x288"`` — step seconds x slots),
``BIOENGINE_TELEM_MAX_SERIES`` bounds distinct deployment keys
(default 256), ``BIOENGINE_TELEM_PUSH_S`` is the sampler cadence
(read by worker_host/controller, default 10).
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Any, Iterable, Optional

# step seconds x slots, finest first (series/window selection walks in
# order and picks the finest ring that covers the request)
DEFAULT_RESOLUTIONS: tuple[tuple[float, int], ...] = (
    (10.0, 360),   # 1 h of 10 s grain
    (60.0, 180),   # 3 h of 1 m grain
    (300.0, 288),  # 24 h of 5 m grain
)

DEFAULT_MAX_SERIES = 256

# the numeric per-interval delta fields a snapshot may carry for one
# deployment (summed on ingest; anything else is ignored — the wire
# format is forward-compatible by construction)
_SUM_FIELDS = (
    "requests",
    "errors",
    "shed",
    "chip_seconds",
    "latency_sum",
    "replica_requests",
    # token streaming (DeploymentHandle.call_stream): generated-token
    # count and the inter-token gap histogram's count — the SLO
    # engine's inter_token_ms objective burns against these
    "tokens",
    "inter_token_count",
)
# gauges: point-sampled, last-write-wins within a bucket
_GAUGE_FIELDS = ("queue_depth",)
# bucket-delta dicts {upper_edge_str: count}
_BUCKET_FIELDS = (
    "latency_buckets",
    "replica_latency_buckets",
    "inter_token_buckets",
)

SERIES_NAMES = (
    "request_rate",
    "error_rate",
    "error_ratio",
    "shed_rate",
    "chip_seconds",
    "queue_depth",
    "latency_p50",
    "latency_p95",
    "latency_p99",
    "replica_latency_p99",
    "tokens_per_second",
    "inter_token_p99",
)


def resolutions_from_env() -> tuple[tuple[float, int], ...]:
    raw = os.environ.get("BIOENGINE_TELEM_RES")
    if not raw:
        return DEFAULT_RESOLUTIONS
    out = []
    for part in raw.split(","):
        step, _, slots = part.strip().partition("x")
        out.append((float(step), max(2, int(slots))))
    return tuple(sorted(out)) or DEFAULT_RESOLUTIONS


def _merge_buckets(dst: dict, src: dict) -> None:
    for edge, n in (src or {}).items():
        dst[edge] = dst.get(edge, 0) + n


def quantile_from_buckets(
    buckets: dict, total: Optional[float], q: float
) -> Optional[float]:
    """Upper-edge quantile estimate over per-interval (cumulative-form)
    bucket counts — the same estimator HistogramChild uses, so stored
    history and the live registry agree within bucket error. ``total``
    falls back to the largest cumulative count when absent."""
    if not buckets:
        return None
    edges = sorted(
        ((float(e) if e != "+Inf" else math.inf), c)
        for e, c in buckets.items()
    )
    n = total if total is not None else (edges[-1][1] if edges else 0)
    if not n:
        return None
    target = math.ceil(q * n)
    for edge, cum in edges:
        if cum >= target:
            return edge
    return math.inf


class _Bucket:
    """One time-aligned slot of one ring."""

    __slots__ = ("t", "span_s", "sums", "gauges", "buckets", "samples")

    def __init__(self, t: float, span_s: float):
        self.t = t                    # bucket start (wall clock, aligned)
        self.span_s = span_s
        self.sums: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.buckets: dict[str, dict] = {}
        self.samples = 0

    def add(self, snap: dict) -> None:
        self.samples += 1
        for f in _SUM_FIELDS:
            v = snap.get(f)
            if v:
                self.sums[f] = self.sums.get(f, 0.0) + float(v)
        for f in _GAUGE_FIELDS:
            v = snap.get(f)
            if v is not None:
                self.gauges[f] = float(v)
        for f in _BUCKET_FIELDS:
            v = snap.get(f)
            if v:
                _merge_buckets(self.buckets.setdefault(f, {}), v)

    def merged_into(self, acc: dict) -> None:
        for f, v in self.sums.items():
            acc[f] = acc.get(f, 0.0) + v
        for f, v in self.buckets.items():
            _merge_buckets(acc.setdefault(f, {}), v)


class _DeploymentSeries:
    """All resolutions for one (app, deployment)."""

    def __init__(self, resolutions: tuple[tuple[float, int], ...]):
        self.rings: list[tuple[float, deque]] = [
            (step, deque(maxlen=slots)) for step, slots in resolutions
        ]
        self.updated_at = 0.0

    def add(self, captured_at: float, snap: dict) -> None:
        self.updated_at = captured_at
        for step, ring in self.rings:
            start = math.floor(captured_at / step) * step
            if ring and ring[-1].t == start:
                ring[-1].add(snap)
            elif ring and ring[-1].t > start:
                # late sample from a skewed pusher: fold into the
                # newest bucket rather than corrupting ring order
                ring[-1].add(snap)
            else:
                b = _Bucket(start, step)
                b.add(snap)
                ring.append(b)

    def ring_for(
        self, since: Optional[float], resolution: Optional[float], now: float
    ) -> tuple[float, deque]:
        if resolution is not None:
            # exact or next-coarser match
            for step, ring in self.rings:
                if step >= resolution - 1e-9:
                    return step, ring
            return self.rings[-1]
        if since is None:
            return self.rings[0]
        span = now - since
        for step, ring in self.rings:
            if step * ring.maxlen >= span:
                return step, ring
        return self.rings[-1]


class TelemetryStore:
    """Controller-side store of per-deployment telemetry history.

    Thread-safe (pushes arrive on the RPC plane while scrapes read).
    Every public reader returns JSON-able data — series cross the RPC
    plane via ``get_telemetry`` and land in incident bundles."""

    def __init__(
        self,
        resolutions: Optional[Iterable[tuple[float, int]]] = None,
        max_series: Optional[int] = None,
    ):
        self.resolutions = tuple(
            sorted(resolutions) if resolutions else resolutions_from_env()
        )
        self.max_series = max_series or int(
            os.environ.get("BIOENGINE_TELEM_MAX_SERIES", str(DEFAULT_MAX_SERIES))
        )
        self._series: dict[tuple[str, str], _DeploymentSeries] = {}
        self._hosts: dict[str, float] = {}  # host_id -> last push wall time
        self._lock = threading.Lock()

    # ---- ingest -------------------------------------------------------------

    def ingest(self, snapshot: dict, host_id: Optional[str] = None) -> int:
        """Fold one sampler snapshot in. Returns the number of
        deployment entries accepted (0 for a malformed push — a bad
        peer must never throw into the RPC plane)."""
        if not isinstance(snapshot, dict):
            return 0
        captured_at = float(snapshot.get("captured_at") or time.time())
        deployments = snapshot.get("deployments")
        if not isinstance(deployments, dict):
            return 0
        accepted = 0
        with self._lock:
            if host_id is not None:
                self._hosts[host_id] = captured_at
                if len(self._hosts) > 4 * self.max_series:
                    oldest = min(self._hosts, key=self._hosts.get)
                    self._hosts.pop(oldest, None)
            for key_str, snap in deployments.items():
                if not isinstance(snap, dict):
                    continue
                app, _, dep = str(key_str).partition("/")
                key = (app, dep)
                series = self._series.get(key)
                if series is None:
                    if len(self._series) >= self.max_series:
                        victim = min(
                            self._series, key=lambda k: self._series[k].updated_at
                        )
                        self._series.pop(victim, None)
                    series = self._series[key] = _DeploymentSeries(
                        self.resolutions
                    )
                series.add(captured_at, snap)
                accepted += 1
        return accepted

    def sweep(self, app: str, deployment: Optional[str] = None) -> None:
        """Drop a swept deployment's (or whole app's) series — called by
        undeploy so ``get_telemetry`` never reports a dead deployment
        as live history."""
        with self._lock:
            for key in [
                k
                for k in self._series
                if k[0] == app and (deployment is None or k[1] == deployment)
            ]:
                del self._series[key]

    # ---- read ---------------------------------------------------------------

    def keys(self) -> list[tuple[str, str]]:
        with self._lock:
            return sorted(self._series)

    def hosts(self) -> dict[str, float]:
        with self._lock:
            return dict(self._hosts)

    def series(
        self,
        app: str,
        deployment: str,
        name: str,
        since: Optional[float] = None,
        resolution: Optional[float] = None,
        now: Optional[float] = None,
    ) -> list[dict]:
        """One reconstructed series, oldest first:
        ``[{"t": bucket_start, "value": ...}, ...]`` (None values mean
        the bucket held no relevant samples)."""
        now = now if now is not None else time.time()
        with self._lock:
            s = self._series.get((app, deployment))
            if s is None:
                return []
            step, ring = s.ring_for(since, resolution, now)
            buckets = [b for b in ring if since is None or b.t + step > since]
            out = []
            for b in buckets:
                out.append({"t": b.t, "value": self._value(b, name, step)})
            return out

    @staticmethod
    def _value(b: _Bucket, name: str, step: float) -> Optional[float]:
        if name == "request_rate":
            return round(b.sums.get("requests", 0.0) / step, 6)
        if name == "error_rate":
            return round(b.sums.get("errors", 0.0) / step, 6)
        if name == "shed_rate":
            return round(b.sums.get("shed", 0.0) / step, 6)
        if name == "error_ratio":
            req = b.sums.get("requests", 0.0)
            return round(b.sums.get("errors", 0.0) / req, 6) if req else None
        if name == "chip_seconds":
            return round(b.sums.get("chip_seconds", 0.0), 6)
        if name == "queue_depth":
            return b.gauges.get("queue_depth")
        if name.startswith("latency_p"):
            q = float(name[len("latency_p"):]) / 100.0
            return quantile_from_buckets(
                b.buckets.get("latency_buckets", {}),
                b.sums.get("requests") or None,
                q,
            )
        if name.startswith("replica_latency_p"):
            q = float(name[len("replica_latency_p"):]) / 100.0
            return quantile_from_buckets(
                b.buckets.get("replica_latency_buckets", {}),
                b.sums.get("replica_requests") or None,
                q,
            )
        if name == "tokens_per_second":
            return round(b.sums.get("tokens", 0.0) / step, 6)
        if name.startswith("inter_token_p"):
            q = float(name[len("inter_token_p"):]) / 100.0
            return quantile_from_buckets(
                b.buckets.get("inter_token_buckets", {}),
                b.sums.get("inter_token_count") or None,
                q,
            )
        return None

    def window_aggregate(
        self,
        app: str,
        deployment: str,
        window_s: float,
        now: Optional[float] = None,
    ) -> dict:
        """Totals over ``[now - window_s, now]`` from the finest ring
        that covers the window — the SLO burn-rate input. Keys:
        every _SUM_FIELDS member plus merged ``latency_buckets``."""
        now = now if now is not None else time.time()
        acc: dict[str, Any] = {}
        with self._lock:
            s = self._series.get((app, deployment))
            if s is None:
                return acc
            step, ring = s.ring_for(now - window_s, None, now)
            cut = now - window_s
            for b in ring:
                if b.t + step <= cut:
                    continue
                b.merged_into(acc)
        return acc

    def coverage_s(self) -> float:
        """The longest window this store can actually answer (coarsest
        ring's span) — SLO status reports budget math over
        ``min(slo_window, coverage)`` and flags the truncation."""
        return max(step * slots for step, slots in self.resolutions)

    def describe(self) -> dict:
        """Store sizing facts for status surfaces (and the docs'
        capacity math): resolutions, live keys, pushing hosts."""
        with self._lock:
            return {
                "resolutions": [
                    {"step_s": step, "slots": slots, "span_s": step * slots}
                    for step, slots in self.resolutions
                ],
                "series": len(self._series),
                "max_series": self.max_series,
                "hosts": dict(self._hosts),
            }


# ---------------------------------------------------------------------------
# registry delta sampler
# ---------------------------------------------------------------------------

# family -> (kind of contribution). The controller process carries the
# handle-side families (requests_total / request_e2e_seconds /
# scheduler_rejected_total / serve_queue_depth) plus any local
# replicas' families; a worker-host process carries only the
# replica-side ones. Each process samples what it has — the store sums
# the contributions, and no family appears on both sides of one
# request (chip_seconds accrues exactly where the replica runs).
_OK_OUTCOMES = ("ok",)


class RegistrySampler:
    """Diffs successive ``metrics.collect()`` snapshots into the
    per-deployment delta dict the store ingests. The first call
    establishes the baseline and returns None."""

    def __init__(self, registry=None):
        from bioengine_tpu_torch.utils import flight as _flight
        from bioengine_tpu_torch.utils import metrics as _metrics

        self._registry = registry or _metrics.REGISTRY
        self._last: Optional[dict] = None
        self._last_at: Optional[float] = None
        # process identity (the flight recorder's) stamped on every
        # snapshot: the controller drops pushes that originate from its
        # OWN process (an in-process multi-host harness shares one
        # registry — its own sampler already covers it), the same
        # dedup-by-recorder-identity rule merge_records applies
        self.source_id = _flight.recorder_id()

    def sample(self, now: Optional[float] = None) -> Optional[dict]:
        now = now if now is not None else time.time()
        snap = self._registry.collect()
        prev, self._last = self._last, snap
        prev_at, self._last_at = self._last_at, now
        if prev is None:
            return None
        deployments: dict[str, dict] = {}

        def entry(labels: dict) -> Optional[dict]:
            app = labels.get("app")
            dep = labels.get("deployment")
            if not app or not dep:
                return None
            return deployments.setdefault(f"{app}/{dep}", {})

        # one O(n) index per family instead of a linear _match scan per
        # series — a family near the 1000-child cardinality cap would
        # otherwise make every sample tick quadratic
        prev_index: dict[str, dict] = {}

        def old_series(family: str, labels: dict) -> dict:
            idx = prev_index.get(family)
            if idx is None:
                idx = prev_index[family] = {
                    _label_key(s["labels"]): s
                    for s in (prev or {}).get(family, {}).get("series", [])
                }
            return idx.get(_label_key(labels), {})

        def counter_delta(family: str, into: str, predicate=None) -> None:
            for cur in snap.get(family, {}).get("series", []):
                if predicate is not None and not predicate(cur["labels"]):
                    continue
                e = entry(cur["labels"])
                if e is None:
                    continue
                d = cur.get("value", 0.0) - old_series(
                    family, cur["labels"]
                ).get("value", 0.0)
                if d > 0:
                    e[into] = e.get(into, 0.0) + d

        def histogram_delta(family: str, buckets_into: str, count_into: str, sum_into: Optional[str]) -> None:
            for cur in snap.get(family, {}).get("series", []):
                e = entry(cur["labels"])
                if e is None:
                    continue
                old = old_series(family, cur["labels"])
                dcount = cur.get("count", 0) - old.get("count", 0)
                if dcount <= 0:
                    continue
                e[count_into] = e.get(count_into, 0.0) + dcount
                if sum_into is not None:
                    e[sum_into] = e.get(sum_into, 0.0) + (
                        cur.get("sum", 0.0) - old.get("sum", 0.0)
                    )
                old_b = old.get("buckets", {})
                dst = e.setdefault(buckets_into, {})
                for edge, cum in cur.get("buckets", {}).items():
                    d = cum - old_b.get(edge, 0)
                    if d > 0:
                        dst[edge] = dst.get(edge, 0) + d

        # handle-side (controller process)
        counter_delta("requests_total", "requests")
        counter_delta(
            "requests_total",
            "errors",
            predicate=lambda l: l.get("outcome") not in _OK_OUTCOMES,
        )
        counter_delta("scheduler_rejected_total", "shed")
        histogram_delta(
            "request_e2e_seconds", "latency_buckets", "requests_e2e",
            "latency_sum",
        )
        # the e2e histogram's count IS the request count when the
        # outcome counter is absent in this process; when both exist
        # requests_total wins (it classifies outcomes)
        for e in deployments.values():
            if "requests" not in e and "requests_e2e" in e:
                e["requests"] = e["requests_e2e"]
            e.pop("requests_e2e", None)
        # token streaming (handle-side): generated-token throughput and
        # the inter-token gap histogram the inter_token_ms SLO reads
        counter_delta("tokens_generated_total", "tokens")
        histogram_delta(
            "inter_token_seconds", "inter_token_buckets",
            "inter_token_count", None,
        )
        # replica-side (worker-host process, or local placement)
        counter_delta("chip_seconds_total", "chip_seconds")
        histogram_delta(
            "replica_request_seconds", "replica_latency_buckets",
            "replica_requests", None,
        )
        # queue depth is a scrape-time collector gauge
        for cur in snap.get("serve_queue_depth", {}).get("series", []):
            e = entry(cur["labels"])
            if e is not None:
                e["queue_depth"] = cur.get("value", 0.0)

        # drop entries that saw no movement this interval — a snapshot
        # full of empty dicts is noise on the wire and in the rings
        deployments = {k: v for k, v in deployments.items() if v}
        if not deployments:
            return None
        interval = now - prev_at if prev_at is not None else None
        return {
            "captured_at": now,
            "interval_s": round(interval, 3) if interval else None,
            "source_id": self.source_id,
            "deployments": deployments,
        }


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))
