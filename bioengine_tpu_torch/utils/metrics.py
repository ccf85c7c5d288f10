"""Process-wide metrics registry: counters, gauges, histograms.

Own copy of ``bioengine_tpu/utils/metrics.py``, with the same names and
behaviour; it is a registry of its own, apart from the JAX package's.

- **First-class metrics**: ``counter`` / ``gauge`` / ``histogram``
  return process-wide metric families; ``.labels(...)`` hands back a
  child whose hot path is one dict lookup + one small lock. Histograms
  use explicit buckets (Prometheus convention: cumulative ``le``).
- **Collectors**: stats objects stay the single source of truth for
  their ``describe()`` schemas; they register a callback
  (:class:`InstanceSet`, :func:`register_collector`) that turns their
  counters into samples at *scrape* time.

Rendered two ways: :func:`collect` (a JSON-able snapshot) and
:func:`render_prometheus` (text exposition format v0.0.4).

Label discipline: keep cardinality bounded by things an operator can
enumerate (app, deployment, replica, method family), never user ids or
request ids.
"""

from __future__ import annotations

import bisect
import logging
import math
import threading
import time
import weakref
from typing import Any, Callable, Iterable, Optional, Sequence

_collector_logger = logging.getLogger("bioengine.metrics")

# Prometheus-convention latency buckets (seconds). Explicit, not
# exponential-by-config: the serve path spans ~1 ms (cache-hit CPU
# calls) to minutes (cold compiles), and fixed edges keep dashboards
# comparable across workers.
LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

# Batch-occupancy buckets (requests per dispatched group) for the
# scheduler_* family: powers of two up to the largest group any ladder
# bucket realistically pads to — occupancy is the lever cross-replica
# coalescing exists to move, so it gets first-class edges.
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class _Child:
    """One labeled series. Base for Counter/Gauge children."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount


class GaugeChild(_Child):
    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount


class HistogramChild:
    __slots__ = ("_lock", "_edges", "_counts", "_sum", "_count")

    def __init__(self, edges: Sequence[float]):
        self._lock = threading.Lock()
        self._edges = list(edges)
        self._counts = [0] * (len(self._edges) + 1)  # + overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self._edges, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> dict:
        """Cumulative bucket counts keyed by upper edge (rendered as
        strings — the snapshot crosses the RPC plane, and msgpack's
        strict_map_key rejects float keys), plus sum/count and the
        quantile estimates operators actually read."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
            s = self._sum
        cum = 0
        buckets = {}
        for edge, n in zip(self._edges, counts):
            cum += n
            buckets[_fmt(edge)] = cum
        return {
            "buckets": buckets,
            "count": total,
            "sum": round(s, 6),
            "p50": self._quantile(counts, total, 0.50),
            "p95": self._quantile(counts, total, 0.95),
            "p99": self._quantile(counts, total, 0.99),
        }

    def _quantile(self, counts: list, total: int, q: float) -> Optional[float]:
        """Upper-edge estimate of quantile ``q`` (None when empty,
        inf when it lands in the overflow bucket)."""
        if total == 0:
            return None
        target = math.ceil(q * total)
        cum = 0
        for edge, n in zip(self._edges, counts):
            cum += n
            if cum >= target:
                return edge
        return math.inf


OVERFLOW_LABEL = "__overflow__"

_MAX_CHILDREN: Optional[int] = None


def _max_children() -> int:
    """Per-family child cap (``BIOENGINE_METRICS_MAX_LABELS``, default
    1000). Read once — labels() can sit on warm request paths."""
    global _MAX_CHILDREN
    if _MAX_CHILDREN is None:
        import os

        _MAX_CHILDREN = int(
            os.environ.get("BIOENGINE_METRICS_MAX_LABELS", "1000")
        )
    return _MAX_CHILDREN


class _Family:
    """A named metric family with a fixed label schema.

    Cardinality guard: a hostile or buggy caller feeding unbounded
    label values (e.g. arbitrary ``method`` strings) would otherwise
    grow the child map — and the process — without bound. At
    ``BIOENGINE_METRICS_MAX_LABELS`` distinct children the family
    folds every NEW label set into one ``__overflow__`` child, warns
    once, and counts the drops in ``metrics_dropped_labels_total`` so
    the truncation is visible on the same scrape it protects."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, Any] = {}
        self._lock = threading.Lock()
        self._overflow_warned = False

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *values: Any) -> Any:
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got {values}"
            )
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if (
                        self.labelnames
                        and len(self._children) >= _max_children()
                    ):
                        return self._overflow_child_locked()
                    child = self._children[key] = self._make_child()
        return child

    def _overflow_child_locked(self):
        """Called under self._lock: the shared sink child for label
        sets past the cap."""
        okey = (OVERFLOW_LABEL,) * len(self.labelnames)
        child = self._children.get(okey)
        if child is None:
            child = self._children[okey] = self._make_child()
        if not self._overflow_warned:
            self._overflow_warned = True
            _collector_logger.warning(
                f"metric family '{self.name}' hit the label-cardinality "
                f"cap ({_max_children()}); folding new label sets into "
                f"'{OVERFLOW_LABEL}' (raise BIOENGINE_METRICS_MAX_LABELS "
                f"if this cardinality is intentional)"
            )
        # DROPPED_LABELS is a plain family whose own cardinality is
        # bounded by the number of registered families; never recurse
        # into ourselves if the guard family itself ever hits the cap
        if self.name != "metrics_dropped_labels_total":
            DROPPED_LABELS.labels(self.name).inc()
        return child

    def items(self) -> list[tuple[tuple, Any]]:
        with self._lock:
            return list(self._children.items())


class Counter(_Family):
    kind = "counter"

    def _make_child(self):
        return CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)  # unlabeled convenience


class Gauge(_Family):
    kind = "gauge"

    def _make_child(self):
        return GaugeChild()

    def set(self, value: float) -> None:
        self.labels().set(value)


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help, labelnames, buckets=LATENCY_BUCKETS_S):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))

    def _make_child(self):
        return HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self.labels().observe(value)


class Sample:
    """One collector-produced series: collectors turn a live stats
    object (RpcStats, PipelineStats, batcher stats) into samples at
    scrape time instead of double-writing on the hot path."""

    __slots__ = ("name", "labels", "value", "kind", "help")

    def __init__(
        self,
        name: str,
        value: float,
        labels: Optional[dict] = None,
        kind: str = "gauge",
        help: str = "",
    ):
        self.name = name
        self.value = value
        self.labels = labels or {}
        self.kind = kind
        self.help = help


CollectorFn = Callable[[], Iterable[Sample]]


class MetricsRegistry:
    def __init__(self, namespace: str = "bioengine"):
        self.namespace = namespace
        self._metrics: dict[str, _Family] = {}
        self._collectors: dict[str, CollectorFn] = {}
        self._lock = threading.Lock()

    # ---- first-class metrics ------------------------------------------------

    def _register(self, metric: _Family) -> _Family:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric) or (
                    existing.labelnames != metric.labelnames
                ):
                    raise ValueError(
                        f"metric '{metric.name}' re-registered with a "
                        f"different type or label schema"
                    )
                return existing
            # process-lifetime family registry: families are module-
            # level singletons, never torn down while the process lives
            # bioengine: ignore[BE-LIFE-401]
            self._metrics[metric.name] = metric
            return metric

    def counter(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> Counter:
        return self._register(Counter(name, help, labelnames))  # type: ignore[return-value]

    def gauge(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> Gauge:
        return self._register(Gauge(name, help, labelnames))  # type: ignore[return-value]

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = LATENCY_BUCKETS_S,
    ) -> Histogram:
        return self._register(Histogram(name, help, labelnames, buckets))  # type: ignore[return-value]

    # ---- collectors ---------------------------------------------------------

    def register_collector(self, name: str, fn: CollectorFn) -> None:
        """Scrape-time sample source (idempotent by name — re-import
        of a module that registers at import time must not stack)."""
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    def _collector_samples(self) -> list[Sample]:
        with self._lock:
            collectors = list(self._collectors.items())
        out: list[Sample] = []
        for cname, fn in collectors:
            try:
                out.extend(fn())
            except Exception as e:  # noqa: BLE001 — one bad collector
                # never breaks the whole scrape; it does leave a trace
                _collector_logger.debug(f"collector '{cname}' failed: {e}")
        return out

    # ---- export -------------------------------------------------------------

    def collect(self) -> dict:
        """JSON-able snapshot (the ``get_metrics`` verb)."""
        out: dict[str, Any] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            series = []
            for key, child in m.items():
                labels = dict(zip(m.labelnames, key))
                if isinstance(child, HistogramChild):
                    series.append({"labels": labels, **child.snapshot()})
                else:
                    series.append({"labels": labels, "value": child.value})
            out[m.name] = {"type": m.kind, "help": m.help, "series": series}
        for s in self._collector_samples():
            entry = out.setdefault(
                s.name, {"type": s.kind, "help": s.help, "series": []}
            )
            entry["series"].append({"labels": s.labels, "value": s.value})
        return out

    def render_prometheus(self) -> str:
        """Text exposition format 0.0.4."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            full = f"{self.namespace}_{m.name}"
            if m.help:
                lines.append(f"# HELP {full} {_escape_help(m.help)}")
            lines.append(f"# TYPE {full} {m.kind}")
            for key, child in m.items():
                labels = dict(zip(m.labelnames, key))
                if isinstance(child, HistogramChild):
                    snap = child.snapshot()
                    for edge, cum in snap["buckets"].items():
                        lines.append(
                            _line(
                                f"{full}_bucket",
                                {**labels, "le": edge},
                                cum,
                            )
                        )
                    lines.append(
                        _line(
                            f"{full}_bucket",
                            {**labels, "le": "+Inf"},
                            snap["count"],
                        )
                    )
                    lines.append(_line(f"{full}_sum", labels, snap["sum"]))
                    lines.append(_line(f"{full}_count", labels, snap["count"]))
                else:
                    lines.append(_line(full, labels, child.value))
        # collector samples, grouped so TYPE headers appear once
        grouped: dict[str, list[Sample]] = {}
        for s in self._collector_samples():
            grouped.setdefault(s.name, []).append(s)
        for name, samples in grouped.items():
            full = f"{self.namespace}_{name}"
            if samples[0].help:
                lines.append(f"# HELP {full} {_escape_help(samples[0].help)}")
            lines.append(f"# TYPE {full} {samples[0].kind}")
            for s in samples:
                lines.append(_line(full, s.labels, s.value))
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Prometheus float formatting: integral values without the dot."""
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _line(name: str, labels: dict, value: float) -> str:
    if labels:
        inner = ",".join(
            f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())
        )
        return f"{name}{{{inner}}} {_fmt(float(value))}"
    return f"{name} {_fmt(float(value))}"


# ---------------------------------------------------------------------------
# The process-wide default registry + module-level conveniences
# ---------------------------------------------------------------------------

REGISTRY = MetricsRegistry()

# the cardinality guard's visible half: how many label sets each family
# folded into its __overflow__ child (labelled by family, so its own
# cardinality is bounded by the number of registered families)
DROPPED_LABELS = REGISTRY.counter(
    "metrics_dropped_labels_total",
    "label sets folded into __overflow__ by the cardinality guard",
    ("family",),
)

_ENABLED: Optional[bool] = None


def metrics_enabled() -> bool:
    """Hot-path kill-switch (``BIOENGINE_METRICS=0``): gates the
    *optional* request-path observations (latency histograms, park
    times). Counters that back existing ``describe()`` schemas always
    run — they replaced the plain ints those schemas already paid for.
    Read once; tests flip it via :func:`reset_env_cache`."""
    global _ENABLED
    if _ENABLED is None:
        import os

        _ENABLED = os.environ.get("BIOENGINE_METRICS", "1") != "0"
    return _ENABLED


def reset_env_cache() -> None:
    global _ENABLED, _MAX_CHILDREN
    _ENABLED = None
    _MAX_CHILDREN = None


def counter(name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(
    name: str,
    help: str = "",
    labelnames: Sequence[str] = (),
    buckets: Sequence[float] = LATENCY_BUCKETS_S,
) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets)


def register_collector(name: str, fn: CollectorFn) -> None:
    REGISTRY.register_collector(name, fn)


def collect() -> dict:
    return REGISTRY.collect()


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


# ---------------------------------------------------------------------------
# Instance-set collectors — the pattern the stats islands plug in with
# ---------------------------------------------------------------------------


class InstanceSet:
    """Weak set of live stats objects plus a collector that folds them
    into samples at scrape time. ``RpcStats``/``PipelineStats``/batcher
    instances register at construction; a dead replica's stats object
    drops out with the garbage collector, no unregister bookkeeping."""

    def __init__(self, name: str, fold: Callable[[list], Iterable[Sample]]):
        self._instances: "weakref.WeakSet" = weakref.WeakSet()
        self._fold = fold
        register_collector(name, self._collect)

    def add(self, obj: Any) -> None:
        self._instances.add(obj)

    def _collect(self) -> Iterable[Sample]:
        return self._fold(list(self._instances))


# ---------------------------------------------------------------------------
# Process self-metrics: event-loop lag, RSS, open fds, GC pauses
# ---------------------------------------------------------------------------
#
# The serving plane measures requests; these measure the PROCESS the
# requests run in — the numbers that explain a latency regression no
# request-level metric can (a blocked event loop, a leak marching RSS
# toward the OOM killer, fd exhaustion, GC pressure). All are
# scrape-time reads except the loop-lag gauge, which a supervised
# ticker samples (a scrape can't observe the loop from inside a
# blocked loop), and GC pauses, which gc callbacks accumulate.

_proc_lock = threading.Lock()
_loop_lag = {"last_s": 0.0, "max_s": 0.0, "samples": 0}
# gc stats are LOCK-FREE by design: gc.callbacks run synchronously on
# whatever thread's allocation crossed the collection threshold — if
# that thread already holds a lock the callback needs (e.g. a scrape
# holding _proc_lock allocating its snapshot), a locking callback
# self-deadlocks and wedges the process. Plain GIL-protected updates
# suffice; readers may see a value one collection stale. Generations
# are pre-seeded so the dict never changes size under an iterating
# reader.
_gc_stats: dict[str, Any] = {
    "pause_seconds": 0.0,
    "collections": {0: 0, 1: 0, 2: 0},   # generation -> count
    "collected": 0,
    "start_mono": None,
    "installed": False,
}
_loop_monitor_running = False


def _gc_callback(phase: str, info: dict) -> None:
    # module-global time, no lazy import: this callback outlives the
    # import machinery (gc runs during interpreter shutdown). NO locks
    # here — see the note on _gc_stats.
    if phase == "start":
        _gc_stats["start_mono"] = time.monotonic()
        return
    start = _gc_stats["start_mono"]
    if start is not None:
        _gc_stats["pause_seconds"] += time.monotonic() - start
        _gc_stats["start_mono"] = None
    gen = info.get("generation", 0)
    counts = _gc_stats["collections"]
    counts[gen] = counts.get(gen, 0) + 1
    _gc_stats["collected"] += info.get("collected", 0)


def _read_rss_bytes() -> Optional[float]:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        import os as _os

        return float(pages * _os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        try:
            import resource

            # ru_maxrss is PEAK rss in KiB on linux — a coarser truth
            # than live rss, still the right alarm signal
            return float(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
            )
        except Exception:  # noqa: BLE001 — no rss source on this platform
            return None


def _count_open_fds() -> Optional[float]:
    try:
        import os as _os

        return float(len(_os.listdir("/proc/self/fd")))
    except OSError:
        return None


def _collect_process() -> Iterable[Sample]:
    out: list[Sample] = []
    rss = _read_rss_bytes()
    if rss is not None:
        out.append(
            Sample(
                "process_rss_bytes", rss,
                help="resident set size of this process",
            )
        )
    fds = _count_open_fds()
    if fds is not None:
        out.append(
            Sample(
                "process_open_fds", fds,
                help="open file descriptors (sockets, shm maps, logs)",
            )
        )
    with _proc_lock:
        lag_last, lag_max, lag_n = (
            _loop_lag["last_s"], _loop_lag["max_s"], _loop_lag["samples"],
        )
    # gc stats read OUTSIDE the lock (the gc callback is lock-free and
    # the collections dict never changes size — generations pre-seeded)
    gc_pause = _gc_stats["pause_seconds"]
    gc_colls = dict(_gc_stats["collections"])
    gc_collected = _gc_stats["collected"]
    if lag_n:
        out.append(
            Sample(
                "event_loop_lag_seconds", round(lag_last, 6),
                help="latest sampled event-loop scheduling lag",
            )
        )
        out.append(
            Sample(
                "event_loop_lag_max_seconds", round(lag_max, 6),
                help="worst event-loop lag since process start",
            )
        )
    out.append(
        Sample(
            "gc_pause_seconds_total", round(gc_pause, 6), kind="counter",
            help="cumulative stop-the-world gc pause time",
        )
    )
    for gen, n in sorted(gc_colls.items()):
        out.append(
            Sample(
                "gc_collections_total", n, {"generation": str(gen)},
                kind="counter", help="gc runs by generation",
            )
        )
    out.append(
        Sample(
            "gc_collected_objects_total", gc_collected, kind="counter",
            help="objects reclaimed by the cyclic gc",
        )
    )
    return out


def install_process_metrics() -> None:
    """Register the process collector + gc callbacks (idempotent —
    worker and worker_host both call this at startup; an in-process
    test harness hosting several of them installs once)."""
    register_collector("process", _collect_process)
    if not _gc_stats["installed"]:
        import gc

        gc.callbacks.append(_gc_callback)
        _gc_stats["installed"] = True


async def monitor_event_loop(interval_s: float = 0.5) -> None:
    """Supervised ticker: sleep ``interval_s``, measure the overshoot —
    that overshoot IS the event-loop scheduling lag every coroutine in
    this process experiences. Runs forever; spawn it supervised and
    cancel at shutdown. A second ticker in the same process returns
    immediately (one sampler is the truth)."""
    import asyncio

    global _loop_monitor_running
    if _loop_monitor_running:
        return
    _loop_monitor_running = True
    try:
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(interval_s)
            lag = max(0.0, (time.monotonic() - t0) - interval_s)
            with _proc_lock:
                _loop_lag["last_s"] = lag
                _loop_lag["max_s"] = max(_loop_lag["max_s"], lag)
                _loop_lag["samples"] += 1
    finally:
        _loop_monitor_running = False
