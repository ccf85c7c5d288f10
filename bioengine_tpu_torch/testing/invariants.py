"""Universal invariant library — checked on EVERY scenario/fuzz run.

The scenario engine's per-scenario invariants answer "did this incident
hold the promises this scenario makes"; this module holds the promises
the stack makes *unconditionally*, regardless of which faults a
schedule composed. The chaos fuzzer searches the fault-schedule space
and scores every run against exactly this library, so anything added
here is automatically hunted for by ``bioengine fuzz`` — and every
hand-written scenario must keep it green (zero false positives is the
admission bar for a new universal invariant).

The library:

==========================  ================================================
``lease_conservation``      no chip lease leaks (dead hosts, dead
                            replicas) and no double-release (a live
                            replica whose lease table disagrees with
                            the host's — a freed-then-reused chip)
``no_idempotent_loss``      strict idempotent traffic never fails —
                            whatever died, failover/retry carried it
``typed_errors_only``       clients only ever see the typed error
                            taxonomy (serving/errors.py), never a raw
                            internal exception
``epoch_monotonic``         every controller restart mints a strictly
                            greater fencing epoch (journal-epoch
                            monotonicity — split-brain fencing depends
                            on it)
``table_staleness_bounded`` a router tier, if present, served from a
                            routing table younger than the bound
``settle_liveness``         post-settle: no parked futures, no open
                            scheduler groups, no in-flight batches, no
                            lingering supervised tasks
``watchdog_timeout``        the run finished inside its wall-clock
                            watchdog (a livelocked schedule fails
                            typed with a flight dump instead of
                            hanging the suite)
==========================  ================================================

Checks take a :class:`RunContext` duck-typing the scenario engine's
run state (the ``plane``, the request plan + outcomes, flight window)
and return ``(ok, detail)``; :func:`evaluate_universal` runs the whole
library. Every check must be cheap, side-effect free, and — above all
— free of false positives: a red universal invariant is treated as a
real bug by CI and by the fuzzer's shrinker.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from bioengine_tpu_torch.utils import flight

# Exception type names a client may legitimately observe. Everything in
# serving/errors.py plus the builtin timeout it subclasses, plus the
# engine's own watchdog marker (the watchdog invariant owns that
# failure mode; typed_errors_only must not double-report it as a leak).
TYPED_CLIENT_ERRORS = frozenset(
    {
        "RetryableTransportError",
        "ReplicaUnavailableError",
        "NoHealthyReplicasError",
        "ApplicationError",
        "AdmissionRejectedError",
        "RouterSaturatedError",
        "RouterClosedError",
        "StaleEpochError",
        "StaleTableError",
        "DeadlineExceeded",
        "TimeoutError",
        "WatchdogTimeout",
    }
)


@dataclass
class RunContext:
    """Everything a universal check may look at. ``plane`` duck-types
    the scenario engine's ``_Plane`` (controller / hosts / routers /
    server / staleness_samples / epoch_history)."""

    scenario: Any
    plane: Any
    plan: list
    outcomes: list
    flight_t0: float
    scale: float = 1.0
    watchdog_fired: bool = False
    watchdog_budget_s: Optional[float] = None


# ---------------------------------------------------------------------------
# shared problem-finders (also backing the per-scenario invariant names)
# ---------------------------------------------------------------------------


def lease_problems(controller) -> list[str]:
    """Every way chip accounting can be wrong: a dead host still holding
    leases, a chip leased to a replica nobody routes, a live replica
    whose device_ids disagree with the host's lease table (the
    double-release / double-lease signature), and a controller-local
    chip leased to a dead replica."""
    state = controller.cluster_state
    problems: list[str] = []
    live_replicas = {
        r.replica_id: r
        for app in controller.apps.values()
        for reps in app.replicas.values()
        for r in reps
    }
    for host in state.hosts.values():
        if not host.alive and host.chips_in_use:
            problems.append(f"dead host {host.host_id} leaks leases")
        for chip, rid in host.chips_in_use.items():
            if rid not in live_replicas:
                problems.append(
                    f"chip {chip} on {host.host_id} leased by dead {rid}"
                )
    for chip, rid in getattr(state, "_chips_in_use", {}).items():
        if rid not in live_replicas:
            problems.append(f"local chip {chip} leased by dead {rid}")
    for rid, r in live_replicas.items():
        host_id = getattr(r, "host_id", None)
        if host_id is None or not r.device_ids:
            continue
        host = state.hosts.get(host_id)
        held = (
            [c for c, owner in host.chips_in_use.items() if owner == rid]
            if host
            else []
        )
        if host is None or sorted(held) != sorted(r.device_ids):
            problems.append(
                f"{rid} lease mismatch on {host_id}: "
                f"{held} vs {r.device_ids}"
            )
    return problems


def liveness_problems(plane) -> list[str]:
    """Post-settle leak sweep: parked RPC futures, open coalescing
    groups, in-flight scheduler batches, lingering supervised tasks."""
    from bioengine_tpu_torch.utils import tasks as task_registry

    problems: list[str] = []
    if plane.server is not None and plane.server._pending:
        problems.append(f"server pending: {len(plane.server._pending)}")
    for host_id, host in plane.hosts.items():
        conn = host.connection
        if conn is not None and conn._pending:
            problems.append(f"{host_id} pending: {len(conn._pending)}")
    sched_owners = [("controller", plane.controller)] + [
        (r.router_id, r) for r in plane.routers
    ]
    for owner, core in sched_owners:
        for key, sched in core._schedulers.items():
            if sched.waiting or sched._open or sched._inflight:
                problems.append(
                    f"{owner} scheduler {key}: waiting={sched.waiting} "
                    f"open={len(sched._open)} inflight={len(sched._inflight)}"
                )
    lingering = [
        t for t in task_registry._BACKGROUND_TASKS if not t.done()
    ]
    if len(lingering) > 16:
        problems.append(f"{len(lingering)} lingering supervised tasks")
    return problems


# ---------------------------------------------------------------------------
# the universal checks
# ---------------------------------------------------------------------------


def check_lease_conservation(ctx: RunContext) -> tuple[bool, str]:
    problems = lease_problems(ctx.plane.controller)
    return not problems, "; ".join(problems[:6]) or "conserved"


def check_no_idempotent_loss(ctx: RunContext) -> tuple[bool, str]:
    bad = [
        (req["idx"], out)
        for req, out in zip(ctx.plan, ctx.outcomes)
        if req["stream"].strict
        and req["stream"].idempotent
        and out != "ok"
    ]
    return not bad, (
        f"{len(bad)} lost idempotent request(s): {bad[:5]}"
        if bad
        else "zero loss"
    )


def check_typed_errors_only(ctx: RunContext) -> tuple[bool, str]:
    leaks: list[tuple[int, str]] = []
    for req, out in zip(ctx.plan, ctx.outcomes):
        if not req["stream"].strict or out is None:
            continue
        if out in ("ok", "shed", "deadline", "absorbed"):
            continue
        if out == "wrong_result":
            leaks.append((req["idx"], out))
            continue
        name = out.partition(":")[2] if out.startswith("failed:") else out
        if name not in TYPED_CLIENT_ERRORS:
            leaks.append((req["idx"], out))
    return not leaks, (
        f"{len(leaks)} raw/unknown client error(s): {leaks[:5]}"
        if leaks
        else "typed taxonomy only"
    )


def check_epoch_monotonic(ctx: RunContext) -> tuple[bool, str]:
    history = [
        e for e in getattr(ctx.plane, "epoch_history", []) if e is not None
    ]
    if len(history) < 2:
        return True, f"epochs {history or '[]'} (no restart)"
    violations = [
        (a, b) for a, b in zip(history, history[1:]) if b <= a
    ]
    return not violations, (
        f"non-monotonic epoch transition(s) {violations} in {history}"
        if violations
        else f"strictly increasing: {history}"
    )


def check_table_staleness(ctx: RunContext) -> tuple[bool, str]:
    samples = getattr(ctx.plane, "staleness_samples", [])
    if not ctx.plane.routers or not samples:
        return True, "no router tier"
    bound = (
        ctx.scenario.router_staleness_bound_s or 5.0
    ) * ctx.scale
    worst = max(samples)
    return worst <= bound, (
        f"max table age {1000 * worst:.0f}ms vs bound "
        f"{1000 * bound:.0f}ms over {len(samples)} samples"
    )


def check_settle_liveness(ctx: RunContext) -> tuple[bool, str]:
    problems = liveness_problems(ctx.plane)
    return not problems, "; ".join(problems[:6]) or "drained"


def check_watchdog(ctx: RunContext) -> tuple[bool, str]:
    if ctx.watchdog_fired:
        return False, (
            f"run exceeded its {ctx.watchdog_budget_s:.1f}s wall-clock "
            "watchdog (livelock?) — flight dump 'watchdog_timeout' "
            "holds the timeline"
        )
    return True, (
        f"finished inside the {ctx.watchdog_budget_s:.1f}s watchdog"
        if ctx.watchdog_budget_s
        else "finished"
    )


UNIVERSAL_INVARIANTS: dict[str, Callable[[RunContext], tuple[bool, str]]] = {
    "lease_conservation": check_lease_conservation,
    "no_idempotent_loss": check_no_idempotent_loss,
    "typed_errors_only": check_typed_errors_only,
    "epoch_monotonic": check_epoch_monotonic,
    "table_staleness_bounded": check_table_staleness,
    "settle_liveness": check_settle_liveness,
    "watchdog_timeout": check_watchdog,
}


def evaluate_universal(ctx: RunContext) -> dict[str, tuple[bool, str]]:
    """Run the whole library; a check that itself crashes is reported
    red with the exception (an invariant that cannot evaluate is not
    silently green). Records a flight event per red verdict so merged
    incident timelines show *which* promise broke, when."""
    out: dict[str, tuple[bool, str]] = {}
    for name, check in UNIVERSAL_INVARIANTS.items():
        try:
            ok, detail = check(ctx)
        except Exception as e:  # noqa: BLE001 — a crashing check is a red check
            ok, detail = False, f"invariant check crashed: {e!r}"
        if not ok:
            flight.record(
                "invariant.red", severity="error",
                invariant=name, detail=detail[:300],
            )
        out[name] = (bool(ok), detail)
    return out


__all__ = [
    "RunContext",
    "TYPED_CLIENT_ERRORS",
    "UNIVERSAL_INVARIANTS",
    "evaluate_universal",
    "lease_problems",
    "liveness_problems",
]
