"""Deterministic fault injection for the request path.

Named fault points are compiled into the hot paths of the RPC client,
the RPC server, and the worker host. Each call site is guarded by the
module-level ``ACTIVE`` flag, so a production process with no faults
configured pays one global read per pass — no dict lookups, no
coroutine scheduling.

A fault is addressed by its point name and triggers on a deterministic
hit window: the ``nth`` hit (1-based) through ``nth + count - 1``.
That makes chaos tests reproducible — "drop the connection on the 3rd
replica_call" behaves identically on every run, unlike SIGKILL-based
chaos whose timing races the event loop.

Call sites that serve a NAMED party (a worker host serving replicas)
pass ``scope=`` — their own host id — so a fault can target ONE host
in the in-process multi-host harness, where every host shares this
module's state. A spec armed with a scope only triggers when the call
site's scope matches; scopeless specs trigger everywhere (the legacy
behavior). Hit counters are per-point-per-armed-spec, so a scoped
window counts only the targeted host's passes.

Configuration is programmatic (:func:`configure`, same-process tests)
or via the ``BIOENGINE_FAULTS`` environment variable for subprocesses
(worker hosts spawned by tests)::

    BIOENGINE_FAULTS="host.replica_call=drop:3;rpc.client.send=raise:1:2"
    BIOENGINE_FAULTS="host.replica_call@h1=slow_ramp:1:1000:0.2:42:20"

i.e. ``;``-separated ``point[@scope]=action[:nth[:count[:delay_s
[:seed[:ramp_hits]]]]]`` entries.

Actions:

- ``raise`` — raise :class:`FaultInjected` (a ``ConnectionError``
  subclass, so the serving layer classifies it as transport).
- ``delay`` — ``await asyncio.sleep(delay_s)`` then proceed.
- ``drop`` — invoke the call site's ``drop`` callback (each site knows
  how to sever its own connection), then raise :class:`FaultInjected`.
- ``slow_ramp`` — gray failure: ``await asyncio.sleep(d)`` where ``d``
  ramps linearly from ~0 up to ``delay_s`` over the first
  ``ramp_hits`` triggering hits, each sample scaled by a jitter factor
  drawn from the spec's OWN seeded RNG (uniform 0.5–1.5). The replica
  keeps answering — degraded, not dead — and the whole delay sequence
  replays EXACTLY for a given ``seed`` (per-point ``random.Random``,
  consumed only on triggering hits). This is what the fixed nth-hit
  ``delay`` window cannot express: a slow-but-alive replica whose
  latency excursion grows over time.

Registered fault points:

==========================  ================================================
``rpc.client.send``         every outbound client frame (ServerConnection)
``rpc.server.send``         every outbound server frame (per websocket)
``host.replica_call``       worker host serving a routed replica call
                            (scope = the serving host's id)
``host.start_replica``      worker host building a shipped replica payload
                            (scope = the building host's id)
==========================  ================================================
"""

from __future__ import annotations

import asyncio
import copy
import os
import random
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional

ACTIVE = False

_specs: dict[str, "FaultSpec"] = {}
_hits: dict[str, int] = {}

_ACTIONS = ("raise", "delay", "drop", "slow_ramp")


class FaultInjected(ConnectionError):
    """Raised by a triggered fault point. Subclasses ConnectionError so
    the request path treats it as a transport failure."""


class FaultSpecError(ValueError):
    """A malformed fault spec (``BIOENGINE_FAULTS`` entry or
    :func:`configure` arguments). Raised at parse/arm time so a typo'd
    chaos configuration fails the run loudly instead of silently arming
    nothing."""


@dataclass
class FaultSpec:
    point: str
    action: str                  # "raise" | "delay" | "drop" | "slow_ramp"
    nth: int = 1                 # first triggering hit (1-based)
    count: int = 1 << 30         # hits that trigger, starting at nth
    delay_s: float = 0.05
    scope: Optional[str] = None  # only trigger when the site's scope matches
    seed: int = 0                # slow_ramp: RNG seed (deterministic replay)
    ramp_hits: int = 16          # slow_ramp: hits to reach full delay_s
    _rng: Optional[random.Random] = field(default=None, repr=False)

    def rng(self) -> random.Random:
        if self._rng is None:
            # seeded per armed spec, consumed only on triggering hits —
            # the delay sequence is a pure function of (seed, hit index)
            self._rng = random.Random(self.seed)
        return self._rng

    def ramp_delay(self, trigger_index: int) -> float:
        """Delay for the ``trigger_index``-th (1-based) TRIGGERING hit:
        linear ramp to ``delay_s`` over ``ramp_hits`` hits, jittered by
        the spec's own RNG so the shape is noisy but replayable."""
        ramp = min(1.0, trigger_index / max(1, self.ramp_hits))
        return self.delay_s * ramp * self.rng().uniform(0.5, 1.5)


def _key(point: str, scope: Optional[str]) -> str:
    return point if scope is None else f"{point}@{scope}"


def configure(
    point: str,
    action: str,
    nth: int = 1,
    count: int = 1 << 30,
    delay_s: float = 0.05,
    scope: Optional[str] = None,
    seed: int = 0,
    ramp_hits: int = 16,
) -> None:
    """Arm a fault point. Resets the point's hit counter. ``point`` may
    carry an inline ``@scope`` suffix (the env-var syntax)."""
    global ACTIVE
    if action not in _ACTIONS:
        raise FaultSpecError(
            f"unknown fault action '{action}' "
            f"(known: {', '.join(_ACTIONS)})"
        )
    if scope is None and "@" in point:
        point, _, scope = point.partition("@")
    if not point:
        raise FaultSpecError("fault spec has an empty point name")
    if nth < 1 or count < 1:
        raise FaultSpecError(
            f"fault '{point}': nth and count are 1-based positives "
            f"(got nth={nth}, count={count})"
        )
    key = _key(point, scope)
    _specs[key] = FaultSpec(
        point, action, nth, count, delay_s,
        scope=scope, seed=seed, ramp_hits=ramp_hits,
    )
    _hits[key] = 0
    ACTIVE = True


def clear(point: Optional[str] = None) -> None:
    """Disarm faults (also zeroes hit counters). ``None`` clears
    everything; a scoped name (``p@h1``) clears exactly that scope's
    spec; a bare name clears the point across every scope — so a
    scenario can heal ONE host while another's fault stays armed."""
    global ACTIVE
    if point is None:
        _specs.clear()
        _hits.clear()
    elif "@" in point:
        _specs.pop(point, None)
        _hits.pop(point, None)
    else:
        for key in [
            k for k in _specs if k.partition("@")[0] == point
        ]:
            _specs.pop(key, None)
            _hits.pop(key, None)
    ACTIVE = bool(_specs)


def clear_all() -> int:
    """Disarm EVERY fault point and zero every hit counter; returns how
    many specs were armed. The fuzz loop calls this between iterations
    so one schedule's leftover armed points (or half-consumed hit
    windows) can never bleed into the next run."""
    global ACTIVE
    n = len(_specs)
    _specs.clear()
    _hits.clear()
    ACTIVE = False
    return n


def snapshot() -> dict:
    """Capture the whole fault-layer state — armed specs (including
    each slow_ramp spec's consumed RNG state), hit counters, and the
    ACTIVE flag — so a nested harness (the fuzzer, a test) can run with
    its own faults and :func:`restore` the ambient state afterwards."""
    return {
        "specs": copy.deepcopy(_specs),
        "hits": dict(_hits),
        "active": ACTIVE,
    }


def restore(snap: dict) -> None:
    """Restore a :func:`snapshot` exactly. The module dicts are mutated
    in place (never rebound) so call sites holding references keep
    seeing the live state."""
    global ACTIVE
    _specs.clear()
    _specs.update(copy.deepcopy(snap["specs"]))
    _hits.clear()
    _hits.update(snap["hits"])
    ACTIVE = bool(snap["active"])


def hits(point: str, scope: Optional[str] = None) -> int:
    """How many times a point (optionally one scope's armed window) has
    been passed since it was armed. A bare point name sums the
    scopeless spec plus every scoped one."""
    if scope is not None or "@" in point:
        return _hits.get(_key(point, scope), 0)
    return sum(
        n for k, n in _hits.items() if k.partition("@")[0] == point
    )


def _matching_specs(point: str, scope: Optional[str]) -> list[FaultSpec]:
    out = []
    spec = _specs.get(point)
    if spec is not None:
        out.append(spec)
    if scope is not None:
        scoped = _specs.get(f"{point}@{scope}")
        if scoped is not None:
            out.append(scoped)
    return out


async def hit(
    point: str,
    drop: Optional[Callable[[], Awaitable[None]]] = None,
    scope: Optional[str] = None,
) -> None:
    """Pass a fault point. Call sites guard with ``if faults.ACTIVE``
    so this coroutine is never even created in a clean process.
    ``scope`` identifies WHOSE pass this is (e.g. the serving host's
    id) so scoped specs can target one party."""
    # EVERY matching spec counts this pass BEFORE any action fires: a
    # scopeless raise must not skip the scoped spec's counter for the
    # same pass, or the scoped window would shift depending on what
    # else happens to be armed (replay alignment breaks)
    triggered = []
    for spec in _matching_specs(point, scope):
        key = _key(spec.point, spec.scope)
        _hits[key] = n = _hits[key] + 1
        if spec.nth <= n < spec.nth + spec.count:
            triggered.append((spec, n))
    for spec, n in triggered:
        # a TRIGGERED fault is incident evidence: chaos tests assert the
        # flight timeline shows injected failures where they were
        # injected (guarded by ACTIVE at call sites — zero cost in
        # clean processes)
        from bioengine_tpu_torch.utils import flight

        extra = {}
        if spec.action == "slow_ramp":
            extra["delay_s"] = round(spec.ramp_delay(n - spec.nth + 1), 6)
        flight.record(
            "fault.hit", severity="warning",
            point=spec.point, action=spec.action, hit=n,
            **({"scope": spec.scope} if spec.scope else {}),
            **extra,
        )
        if spec.action == "delay":
            await asyncio.sleep(spec.delay_s)
            continue
        if spec.action == "slow_ramp":
            await asyncio.sleep(extra["delay_s"])
            continue
        if spec.action == "drop" and drop is not None:
            try:
                await drop()
            finally:
                raise FaultInjected(
                    f"fault '{spec.point}' dropped the connection (hit #{n})"
                )
        raise FaultInjected(f"fault '{spec.point}' triggered (hit #{n})")


def load_env(env_value: Optional[str] = None) -> None:
    """Parse ``BIOENGINE_FAULTS`` (subprocess configuration path).
    Malformed entries raise :class:`FaultSpecError` naming the entry —
    a chaos run with a typo'd spec must fail at parse time, not run
    clean with nothing armed."""
    raw = (
        env_value
        if env_value is not None
        else os.environ.get("BIOENGINE_FAULTS", "")
    )
    for entry in filter(None, (e.strip() for e in raw.split(";"))):
        point, eq, rest = entry.partition("=")
        if not eq or not point.strip():
            raise FaultSpecError(
                f"malformed fault spec '{entry}': expected "
                "'point[@scope]=action[:nth[:count[:delay_s"
                "[:seed[:ramp_hits]]]]]'"
            )
        parts = rest.split(":")
        if len(parts) > 6:
            raise FaultSpecError(
                f"malformed fault spec '{entry}': too many ':' fields "
                f"({len(parts)}, max 6)"
            )
        action = parts[0]
        try:
            nth = int(parts[1]) if len(parts) > 1 else 1
            count = int(parts[2]) if len(parts) > 2 else 1 << 30
            delay_s = float(parts[3]) if len(parts) > 3 else 0.05
            seed = int(parts[4]) if len(parts) > 4 else 0
            ramp_hits = int(parts[5]) if len(parts) > 5 else 16
        except ValueError as e:
            raise FaultSpecError(
                f"malformed fault spec '{entry}': {e}"
            ) from None
        configure(
            point.strip(), action, nth=nth, count=count, delay_s=delay_s,
            seed=seed, ramp_hits=ramp_hits,
        )


load_env()
