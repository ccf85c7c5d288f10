"""Structured spans + request-scoped distributed tracing.

Complements the jax.profiler surface (worker start/stop_profiling —
device-side traces) with host-side spans. Two usage tiers share one
ring buffer and one ``get_traces`` surface:

**Control-plane spans** (PR 1 era, unchanged call sites)::

    with span("deploy_app", app_id=app_id):
        ...

always record — deploys and replica placements are rare and precious.

**Request-scoped traces**: ``DeploymentHandle.call`` mints a
:class:`TraceContext` (trace_id + head-sampling decision, default
~1% via ``BIOENGINE_TRACE_SAMPLE``); the context rides a contextvar
through the routing path, crosses process boundaries in the RPC CALL
envelope (capability-negotiated ``proto=trace1`` — legacy peers never
see the fields), and request-path call sites use::

    with trace_span("replica.execute", replica_id=rid):
        ...

which is a shared no-op object when the request is unsampled — the
unsampled hot path pays one contextvar read. Spans recorded on a
remote peer while handling a sampled call are piggybacked onto the
RPC RESULT frame and absorbed into the caller's buffer, so
``get_traces(trace_id=...)`` reconstructs ONE cross-process span tree
with a per-stage latency breakdown.

Timing discipline: durations come from ``time.monotonic()`` (wall
``time.time()`` deltas jump under NTP slew); ``started_at`` stays wall
time for display. Spans are appended to the buffer when they OPEN, so
``get_spans(include_open=True)`` shows in-flight work (a wedged
request is visible while it hangs, not after).
"""

from __future__ import annotations

import contextvars
import os
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Optional

MAX_SPANS = 4096

_spans: deque[dict] = deque(maxlen=MAX_SPANS)
_lock = threading.Lock()

# The whole per-request tracing state rides ONE contextvar holding an
# immutable (trace_context, current_span_id, chip_accumulator) triple.
# Contextvar reads are the per-request tax tracing charges even when
# disabled; fusing the triple means carry()/activate()/to_wire() and
# the scheduler's submit path pay one read where they used to pay two
# or three. Every mutation allocates a fresh 3-tuple — cheap, and only
# sampled requests / chip-accounted executions mutate at all.
_EMPTY_STATE: tuple = (None, None, None)
_state: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "bioengine_trace_state", default=_EMPTY_STATE
)


def new_id() -> str:
    """Mint a 64-bit hex id for call/span correlation.

    random.getrandbits, not uuid4: ids need uniqueness, not crypto
    randomness, and uuid4's os.urandom syscall costs ~40 us on
    sandboxed kernels — minted per request on the serve hot path.
    The rpc layer uses this for call ids too (BE-PERF-302)."""
    return f"{random.getrandbits(64):016x}"


# internal callers predate the public name
_new_id = new_id


def _new_trace_id() -> str:
    return f"{random.getrandbits(128):032x}"


@dataclass
class TraceContext:
    """One request's tracing identity.

    ``span_id`` is the parent span on the MINTING side when the context
    crosses a process boundary; ``collector`` accumulates spans closed
    under this context so an RPC handler can ship them back on the
    RESULT frame (None when unsampled — zero collection cost)."""

    trace_id: str
    span_id: Optional[str] = None
    sampled: bool = False
    collector: Optional[list] = None

    def to_wire(self) -> dict:
        """The trace fields carried on a CALL message (only when the
        peer negotiated ``trace1`` and the request is sampled)."""
        return {
            "tid": self.trace_id,
            "sid": _state.get()[1] or self.span_id,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "TraceContext":
        return cls(
            trace_id=str(d.get("tid", "")),
            span_id=d.get("sid"),
            sampled=True,
            collector=[],
        )


# ---------------------------------------------------------------------------
# env knobs (read once — these sit on the request hot path)
# ---------------------------------------------------------------------------

_ENV_CACHE: dict[str, float] = {}


def _cached_env(key: str, default: str) -> float:
    v = _ENV_CACHE.get(key)
    if v is None:
        v = float(os.environ.get(key, default))
        _ENV_CACHE[key] = v
    return v


def tracing_enabled() -> bool:
    """Global kill-switch (``BIOENGINE_TRACING=0``) — the bench's
    baseline leg. Off means no context is minted at all."""
    return _cached_env("BIOENGINE_TRACING", "1") != 0.0


def trace_sample_rate() -> float:
    """Head-sampling probability, ``BIOENGINE_TRACE_SAMPLE`` (default
    0.01 — tracing must be affordable at production request rates)."""
    return _cached_env("BIOENGINE_TRACE_SAMPLE", "0.01")


def slow_request_threshold_ms() -> float:
    """``BIOENGINE_SLOW_REQUEST_MS`` (default 1000); <= 0 disables
    slow-request logging."""
    return _cached_env("BIOENGINE_SLOW_REQUEST_MS", "1000")


def reset_env_cache() -> None:
    """Tests flip the env knobs; production reads them once."""
    _ENV_CACHE.clear()


# ---------------------------------------------------------------------------
# context management
# ---------------------------------------------------------------------------


def maybe_start_trace(sample: Optional[bool] = None) -> Optional[TraceContext]:
    """Mint a request trace context (head-sampled). Returns None when
    tracing is globally disabled. The trace_id exists even unsampled so
    slow-request logs are correlatable; only sampled requests record
    spans or put fields on the wire."""
    if not tracing_enabled():
        return None
    if sample is None:
        sample = random.random() < trace_sample_rate()
    return TraceContext(
        trace_id=_new_trace_id(),
        sampled=bool(sample),
        collector=[] if sample else None,
    )


def activate(ctx: TraceContext):
    """Install ``ctx`` as the current trace (and its ``span_id`` as the
    current parent, so local spans chain to the remote caller's span).
    Returns an opaque token for :func:`deactivate`."""
    chip = _state.get()[2]
    return _state.set((ctx, ctx.span_id, chip))


def deactivate(token) -> None:
    _state.reset(token)


def current_trace() -> Optional[TraceContext]:
    return _state.get()[0]


def current_span_id() -> Optional[str]:
    """The enclosing span's id — for call sites that record a span
    *later* (e.g. the batcher measures queue wait at flush time) and
    must capture the parent while the request is still in scope."""
    return _state.get()[1]


def current_trace_and_span() -> tuple:
    """The (trace_context, span_id) pair in ONE contextvar read — for
    hot call sites (scheduler submit) that need both."""
    st = _state.get()
    return st[0], st[1]


def sampled() -> bool:
    """True when the current request's trace is sampled — the cheap
    gate hot call sites use before building span attr dicts."""
    ctx = _state.get()[0]
    return ctx is not None and ctx.sampled


def carry(ctx: Optional[TraceContext], fn):
    """Wrap ``fn`` so it runs with ``ctx`` (and the chip-seconds
    accumulator, when one is active) installed — the bridge into worker
    threads (engine dispatch thread, pipeline stages) where asyncio's
    automatic contextvar propagation does not reach. Chip accounting
    crosses even for unsampled requests: cost is accounting, not
    sampled telemetry."""
    st = _state.get()
    acc = st[2]
    is_sampled = ctx is not None and ctx.sampled
    if not is_sampled and acc is None:
        return fn

    parent = st[1]

    def wrapped(*args, **kwargs):
        here = _state.get()
        token = _state.set(
            (
                ctx if is_sampled else here[0],
                parent if is_sampled else here[1],
                acc if acc is not None else here[2],
            )
        )
        try:
            return fn(*args, **kwargs)
        finally:
            _state.reset(token)

    return wrapped


# ---------------------------------------------------------------------------
# chip-seconds accounting (request-scoped device-cost accumulator)
# ---------------------------------------------------------------------------


class ChipSecondsAccumulator:
    """Mutable per-request device-cost sink. The replica installs one
    around instance execution; every engine ``predict`` underneath
    (including on the dispatch thread, via :func:`carry`) adds its
    wall seconds x mesh width. Unlike spans this is NOT sampled —
    chip-seconds are the billing/scheduling signal and must be exact."""

    __slots__ = ("seconds",)

    def __init__(self):
        self.seconds = 0.0


def start_chip_accounting() -> tuple[ChipSecondsAccumulator, Any]:
    """Install a fresh accumulator; returns ``(accumulator, token)``
    for :func:`stop_chip_accounting`."""
    acc = ChipSecondsAccumulator()
    st = _state.get()
    return acc, _state.set((st[0], st[1], acc))


def stop_chip_accounting(token) -> None:
    _state.reset(token)


def add_chip_seconds(seconds: float) -> None:
    """Engines call this once per prediction: one contextvar read when
    no request accounting is active (engine used outside the serve
    path), one float add when it is."""
    acc = _state.get()[2]
    if acc is not None and seconds > 0.0:
        acc.seconds += seconds


# ---------------------------------------------------------------------------
# span recording
# ---------------------------------------------------------------------------


@contextmanager
def span(name: str, **attrs: Any):
    """Record one span; exceptions mark it failed and re-raise.
    Appended to the buffer at OPEN (visible in-flight), completed in
    place at close. When a sampled trace context is active the span
    carries its trace_id and feeds the context's collector."""
    span_id = _new_id()
    st = _state.get()
    ctx, parent = st[0], st[1]
    token = _state.set((ctx, span_id, st[2]))
    record = {
        "span_id": span_id,
        "parent_id": parent,
        "name": name,
        "attrs": attrs,
        "started_at": time.time(),
    }
    if ctx is not None and ctx.sampled:
        record["trace_id"] = ctx.trace_id
    t0 = time.monotonic()
    with _lock:
        _spans.append(record)
    try:
        yield record
    except BaseException as e:
        record["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        _state.reset(token)
        record["duration_s"] = round(time.monotonic() - t0, 6)
        if ctx is not None and ctx.collector is not None:
            ctx.collector.append(record)


class _NoopSpan:
    """Shared do-nothing context manager — what ``trace_span`` hands
    the unsampled hot path (no allocation, no lock, no record)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


NOOP_SPAN = _NOOP


def trace_span(name: str, **attrs: Any):
    """``span`` gated on the current request being sampled — the
    request-path variant. Control-plane call sites keep ``span``."""
    ctx = _state.get()[0]
    if ctx is None or not ctx.sampled:
        return _NOOP
    return span(name, **attrs)


def trace_span_t(name: str, attrs_template: dict):
    """``trace_span`` taking a PREBUILT attr dict — hot call sites keep
    one template per handle/replica instead of allocating a kwargs dict
    on every unsampled request. The template is copied when (and only
    when) the request is sampled, so callers may reuse it freely."""
    ctx = _state.get()[0]
    if ctx is None or not ctx.sampled:
        return _NOOP
    return span(name, **attrs_template)


def record_span(
    name: str,
    duration_s: float,
    started_at: Optional[float] = None,
    parent_id: Optional[str] = None,
    ctx: Optional[TraceContext] = None,
    **attrs: Any,
) -> Optional[dict]:
    """After-the-fact span for durations measured elsewhere (e.g. the
    batcher knows a request's queue wait only at flush time). Recorded
    only when ``ctx`` (default: current) is sampled."""
    ctx = ctx if ctx is not None else _state.get()[0]
    if ctx is None or not ctx.sampled:
        return None
    record = {
        "span_id": _new_id(),
        "parent_id": parent_id if parent_id is not None else ctx.span_id,
        "name": name,
        "attrs": attrs,
        "started_at": started_at if started_at is not None else time.time(),
        "duration_s": round(duration_s, 6),
        "trace_id": ctx.trace_id,
    }
    with _lock:
        _spans.append(record)
    if ctx.collector is not None:
        ctx.collector.append(record)
    return record


def absorb_spans(spans: list) -> int:
    """Fold spans shipped from a remote peer (RESULT piggyback) into
    the local buffer so one process can reconstruct the whole tree."""
    added = 0
    if not spans:
        return added
    with _lock:
        known = {s["span_id"] for s in _spans if "trace_id" in s}
        for s in spans:
            if not isinstance(s, dict) or "span_id" not in s:
                continue
            if s["span_id"] in known:
                continue
            _spans.append(dict(s))
            added += 1
    return added


# ---------------------------------------------------------------------------
# querying
# ---------------------------------------------------------------------------


def get_spans(
    name: Optional[str] = None,
    max_spans: int = 200,
    include_open: bool = False,
    trace_id: Optional[str] = None,
    since: Optional[float] = None,
) -> list[dict]:
    """Most recent spans in OPEN order; filtered by name / trace_id /
    wall-clock ``since`` (``started_at >= since`` — the pagination
    cursor for repeated ``get_traces`` pulls). Open (in-flight) spans
    are excluded unless ``include_open``."""
    with _lock:
        items = list(_spans)
    if not include_open:
        items = [s for s in items if "duration_s" in s]
    if name is not None:
        items = [s for s in items if s["name"] == name]
    if trace_id is not None:
        items = [s for s in items if s.get("trace_id") == trace_id]
    if since is not None:
        items = [s for s in items if s.get("started_at", 0.0) >= since]
    return items[-max_spans:]


def trace_attr_sum(trace_id: str, name: str, attr: str) -> float:
    """Sum a numeric span attr across one trace in a single pass under
    the lock — no ring copy, no intermediate lists. The per-sampled-
    request path (trace-root chip_seconds) calls this; at 100% sampling
    a copying scan of the 4096-span ring per request would be the
    dominant tracing cost."""
    total = 0.0
    with _lock:
        for s in _spans:
            if s.get("trace_id") == trace_id and s["name"] == name:
                total += s["attrs"].get(attr, 0.0) or 0.0
    return total


def build_trace_tree(trace_id: str) -> dict:
    """One request's cross-process span tree: spans nested under their
    parents, children in start order, plus the stage rollup the SLO
    dashboards read (name -> summed duration)."""
    spans = get_spans(
        trace_id=trace_id, max_spans=MAX_SPANS, include_open=True
    )
    by_id: dict[str, dict] = {}
    for s in spans:
        node = dict(s)
        node["children"] = []
        by_id[s["span_id"]] = node
    roots = []
    for node in by_id.values():
        parent = by_id.get(node.get("parent_id"))
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in by_id.values():
        node["children"].sort(key=lambda n: n.get("started_at", 0.0))
    roots.sort(key=lambda n: n.get("started_at", 0.0))
    stages: dict[str, float] = {}
    for s in spans:
        if "duration_s" in s:
            stages[s["name"]] = round(
                stages.get(s["name"], 0.0) + s["duration_s"], 6
            )
    return {
        "trace_id": trace_id,
        "spans": len(spans),
        "stage_seconds": stages,
        "tree": roots,
    }


def clear_spans() -> int:
    with _lock:
        n = len(_spans)
        _spans.clear()
    return n
