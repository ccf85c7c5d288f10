"""Structured spans, request-scoped traces and chip-seconds accounting.

Own copy of the parts of ``bioengine_tpu/utils/tracing.py`` that the
engine and the model-runner call, with the same span names and
attributes. Spans land in one ring buffer read by :func:`get_spans`.
``span`` always records; ``trace_span`` records only under a sampled
:class:`TraceContext`. Durations come from ``time.monotonic()``;
``started_at`` is wall time for display.

The whole per-request state rides ONE contextvar holding an immutable
(trace_context, current_span_id, chip_accumulator) triple.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Optional

MAX_SPANS = 4096

_spans: deque[dict] = deque(maxlen=MAX_SPANS)
_lock = threading.Lock()

_EMPTY_STATE: tuple = (None, None, None)
_state: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "bioengine_torch_trace_state", default=_EMPTY_STATE
)


def new_id() -> str:
    """A 64-bit hex id for span correlation."""
    return f"{random.getrandbits(64):016x}"


@dataclass
class TraceContext:
    """One request's tracing identity. ``collector`` gathers the spans
    closed under this context (None when unsampled)."""

    trace_id: str
    span_id: Optional[str] = None
    sampled: bool = False
    collector: Optional[list] = None


def activate(ctx: TraceContext):
    """Install ``ctx`` as the current trace (its ``span_id`` as the
    current parent). Returns a token for :func:`deactivate`."""
    chip = _state.get()[2]
    return _state.set((ctx, ctx.span_id, chip))


def deactivate(token) -> None:
    _state.reset(token)


def current_trace() -> Optional[TraceContext]:
    return _state.get()[0]


def carry(ctx: Optional[TraceContext], fn):
    """Wrap ``fn`` so it runs with ``ctx`` (and the chip-seconds
    accumulator, when one is active) installed: the bridge into worker
    threads (the engine's dispatch thread), where contextvars do not
    follow on their own. Chip accounting crosses even for unsampled
    requests."""
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


# ---- chip-seconds accounting (request-scoped device-cost accumulator) ------


class ChipSecondsAccumulator:
    """Mutable per-request device-cost sink: every engine ``predict``
    underneath adds its wall seconds x device count. Not sampled."""

    __slots__ = ("seconds",)

    def __init__(self):
        self.seconds = 0.0


def start_chip_accounting() -> tuple[ChipSecondsAccumulator, Any]:
    """Install a fresh accumulator; returns ``(accumulator, token)`` for
    :func:`stop_chip_accounting`."""
    acc = ChipSecondsAccumulator()
    st = _state.get()
    return acc, _state.set((st[0], st[1], acc))


def stop_chip_accounting(token) -> None:
    _state.reset(token)


def add_chip_seconds(seconds: float) -> None:
    acc = _state.get()[2]
    if acc is not None and seconds > 0.0:
        acc.seconds += seconds


# ---- span recording ---------------------------------------------------------


@contextmanager
def span(name: str, **attrs: Any):
    """Record one span; an exception marks it failed and re-raises. The
    record is in the buffer from the moment it opens."""
    span_id = new_id()
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
    """Shared do-nothing context manager for the unsampled path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def trace_span(name: str, **attrs: Any):
    """``span`` gated on the current request being sampled."""
    ctx = _state.get()[0]
    if ctx is None or not ctx.sampled:
        return _NOOP
    return span(name, **attrs)


def get_spans(
    name: Optional[str] = None,
    max_spans: int = 200,
    include_open: bool = False,
    trace_id: Optional[str] = None,
) -> list[dict]:
    """Most recent spans in open order, filtered by name and trace id;
    open spans are left out unless ``include_open``."""
    with _lock:
        items = list(_spans)
    if not include_open:
        items = [s for s in items if "duration_s" in s]
    if name is not None:
        items = [s for s in items if s["name"] == name]
    if trace_id is not None:
        items = [s for s in items if s.get("trace_id") == trace_id]
    return items[-max_spans:]
