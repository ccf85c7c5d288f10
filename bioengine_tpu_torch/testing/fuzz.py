"""Coverage-guided chaos fuzzer — search the fault-schedule space.

Every incident the stack has survived so far was a *hand-written*
fault schedule: someone imagined the failure mode, scripted it, and
pinned it as a scenario. This module automates the imagination. A
seeded generator composes schedules from the full fault vocabulary
(host kill/rejoin, router kill, controller SIGKILL/restart, gray-
failure slow ramps, connection blips, clock skew, traffic bursts,
named fault points) onto the scenario engine's deterministic
substrate; every run is checked against the universal invariant
library (testing/invariants.py); runs that reach *novel* coverage —
a new combination of flight-event types, invariant verdicts, and
outcome classes — are kept and mutated AFL-style (drop, add, retime,
retarget, splice), boring ones are discarded.

When a schedule breaks a universal invariant, a delta-debugging
shrinker (ddmin + a local-minimality sweep) reduces it to a schedule
where removing ANY single remaining event makes the failure disappear,
then serializes it as a replayable JSON artifact. ``bioengine fuzz
--replay <file>`` re-executes an artifact bit-deterministically (the
scenario engine's one-seed contract); failing artifacts are promoted
into ``tests/fuzz_corpus/`` and replayed by tier-1 forever after.

Determinism boundaries, stated honestly: a single *schedule* replays
exactly (request plan, fault windows, and slow-ramp jitter are pure
functions of the seed — the engine's existing double-run gate), and
the generator/mutator/shrinker are pure functions of the fuzz seed.
The *search* as a whole is wall-clock-budgeted, so how MANY schedules
a budget explores varies by machine; what the fuzzer finds is always
handed back as a deterministic artifact.

The end-to-end drill: ``BIOENGINE_FUZZ_DRILL=1`` arms a deliberate
lease-accounting defect (cluster/state.py — dead-host lease
reclamation skipped). CI runs the fuzzer against it and requires the
searcher to find the bug and shrink it to a minimal repro, proving
the whole loop on a KNOWN bug, not just accidental ones.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import random
import time
import zlib
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Awaitable, Callable, Optional

from bioengine_tpu_torch.runtime.devices import DeviceLike
from bioengine_tpu_torch.testing import faults
from bioengine_tpu_torch.testing.scenarios import (
    FaultEvent,
    Scenario,
    Stream,
    outcome_signature,
    run_scenario_async,
)
from bioengine_tpu_torch.utils.logger import create_logger

logger = create_logger("fuzz", log_file="off")

ARTIFACT_KIND = "bioengine-fuzz-repro"
ARTIFACT_VERSION = 1
# the only env keys an artifact may carry into a replay (an artifact is
# checked-in data — it must not be able to smuggle arbitrary env)
ARTIFACT_ENV_ALLOWLIST = ("BIOENGINE_FUZZ_DRILL",)

# ticks near the end of a run are reserved for healing + settling so a
# late fault can't turn expected-drain time into a bogus red invariant
SETTLE_MARGIN_TICKS = 10


class FuzzError(RuntimeError):
    """Fuzzer-level failure (unknown topology, malformed artifact,
    broken baseline)."""


# ---------------------------------------------------------------------------
# fuzz topologies — the substrates schedules are composed onto
# ---------------------------------------------------------------------------

# Small and short on purpose: a fuzz iteration is a full plane
# start/drive/settle/teardown, so topology cost IS search throughput.
# Per-scenario invariants are left empty — the universal library is
# the contract every schedule is held to.
TOPOLOGIES: dict[str, Scenario] = {
    "small_multihost": Scenario(
        name="fuzz_small_multihost",
        description=(
            "2 worker hosts over real websockets, durable controller — "
            "the full fault vocabulary (host/controller chaos)"
        ),
        ticks=36,
        tick_s=0.012,
        health_every=3,
        n_hosts=2,
        n_replicas=2,
        chips_per_replica=2,
        max_ongoing=16,
        service_s=0.006,
        streams=(Stream(base=2, deadline_s=8.0),),
        hedge=True,
        deadline_s=8.0,
        max_attempts=8,
        durable=True,
        client_retry=True,
        slo_ms=1e9,
        invariants=(),
        watchdog_s=60.0,
    ),
    "routed_local": Scenario(
        name="fuzz_routed_local",
        description=(
            "local replicas behind a 2-router tier — router-loss and "
            "admission chaos without host-spawn cost"
        ),
        ticks=30,
        tick_s=0.01,
        health_every=4,
        n_hosts=0,
        n_replicas=4,
        max_ongoing=16,
        service_s=0.006,
        n_routers=2,
        router_sync_every=2,
        router_staleness_bound_s=2.0,
        streams=(Stream(base=3, deadline_s=6.0),),
        hedge=False,
        deadline_s=6.0,
        slo_ms=1e9,
        invariants=(),
        watchdog_s=45.0,
    ),
}

# weighted action vocabulary per topology class (host actions need
# hosts, router actions need routers, controller SIGKILL needs the
# real RPC plane a multi-host topology brings up)
_HOST_VOCAB: tuple[tuple[str, int], ...] = (
    ("kill_host", 4),
    ("respawn_host", 2),
    ("blip", 3),
    ("slow_ramp", 3),
    ("clear_faults", 1),
    ("kill_controller", 2),
    ("stale_verb", 1),
    ("traffic_burst", 2),
    ("clock_skew", 1),
)
_ROUTER_VOCAB: tuple[tuple[str, int], ...] = (
    ("kill_router", 4),
    ("traffic_burst", 3),
)


def _vocabulary(topo: Scenario) -> list[tuple[str, int]]:
    vocab: list[tuple[str, int]] = []
    if topo.n_hosts > 0:
        vocab.extend(_HOST_VOCAB)
    if topo.n_routers > 0:
        vocab.extend(_ROUTER_VOCAB)
    if not vocab:
        raise FuzzError(
            f"topology '{topo.name}' offers no fault vocabulary"
        )
    return vocab


def _hosts_of(topo: Scenario) -> list[str]:
    return [f"h{i + 1}" for i in range(topo.n_hosts)]


def _routers_of(topo: Scenario) -> list[str]:
    return [f"r{i}" for i in range(topo.n_routers)]


# ---------------------------------------------------------------------------
# schedule generation, repair, mutation
# ---------------------------------------------------------------------------


def _random_event(
    topo: Scenario, action: str, rng: random.Random
) -> FaultEvent:
    last = topo.ticks - SETTLE_MARGIN_TICKS
    tick = rng.randint(1, max(1, last))
    host: Optional[str] = None
    kwargs: dict[str, Any] = {}
    if action in ("kill_host", "respawn_host", "blip", "slow_ramp"):
        host = rng.choice(_hosts_of(topo))
    elif action == "kill_router":
        host = rng.choice(_routers_of(topo))
    if action == "slow_ramp":
        kwargs["delay_s"] = rng.choice((0.05, 0.1, 0.2))
        kwargs["ramp_hits"] = rng.randint(6, 12)
    elif action == "traffic_burst":
        kwargs["burst"] = rng.randint(4, 20)
    elif action == "clock_skew":
        kwargs["skew_s"] = round(rng.uniform(-5.0, 5.0), 3)
    return FaultEvent(at_tick=tick, action=action, host=host, **kwargs)


def repair(topology: str, events: list[FaultEvent],
           rng: random.Random) -> list[FaultEvent]:
    """Make a candidate schedule *fair*: drop events that target the
    impossible (killing a host that is already dead, the last live
    host, or every router) and pair every controller SIGKILL with a
    restart, so a red invariant always means a broken promise — never
    "the schedule removed the whole serving plane and traffic failed,
    as designed". The generator and mutator funnel through here; the
    shrinker deliberately does NOT (its red-set-superset predicate is
    the fairness guard there)."""
    topo = TOPOLOGIES[topology]
    last = topo.ticks - SETTLE_MARGIN_TICKS
    hosts = set(_hosts_of(topo))
    routers = _routers_of(topo)

    clamped = [
        replace(
            ev,
            at_tick=min(max(1, ev.at_tick), last),
            burst=min(max(0, ev.burst), 24),
            skew_s=min(max(ev.skew_s, -10.0), 10.0),
        )
        for ev in events
    ]
    clamped.sort(key=lambda ev: (ev.at_tick, ev.action, ev.host or ""))

    out: list[FaultEvent] = []
    dead_hosts: set[str] = set()
    router_kills = 0
    controller_alive = True
    kill_tick: Optional[int] = None
    fenced_cycle = False  # a kill->restart cycle completed before tick
    for ev in clamped:
        if ev.action == "kill_host":
            if ev.host not in hosts or ev.host in dead_hosts:
                continue
            if len(hosts - dead_hosts) <= 1:
                continue  # never take the last live host
            dead_hosts.add(ev.host)
        elif ev.action == "respawn_host":
            if ev.host not in dead_hosts:
                continue  # respawning a live host would mint extras
            if not controller_alive:
                continue  # nothing to rejoin while the plane is down
            dead_hosts.discard(ev.host)
        elif ev.action in ("blip", "slow_ramp"):
            if ev.host not in hosts:
                continue
        elif ev.action == "kill_controller":
            if not controller_alive or ev.at_tick > last - 4:
                continue
            controller_alive = False
            kill_tick = ev.at_tick
        elif ev.action == "restart_controller":
            if controller_alive:
                continue
            controller_alive = True
            fenced_cycle = True
        elif ev.action == "stale_verb":
            if not fenced_cycle:
                continue  # nothing stale to replay yet
        elif ev.action == "kill_router":
            if ev.host not in routers or router_kills >= len(routers) - 1:
                continue  # keep at least one router serving
            router_kills += 1
        elif ev.action == "traffic_burst":
            if ev.burst <= 0:
                continue
        elif ev.action in ("clear_faults", "clock_skew"):
            pass
        else:
            continue  # unknown action: not in this fuzzer's vocabulary
        out.append(ev)
    if not controller_alive and kill_tick is not None:
        # pair the SIGKILL with a restart a few ticks later —
        # idempotent traffic rides client_retry across the gap.
        # Appended only when the schedule lacks one, so repairing an
        # already-fair schedule is the identity (is_fair depends on it)
        out.append(
            FaultEvent(
                at_tick=min(kill_tick + rng.randint(2, 6), last),
                action="restart_controller",
            )
        )
    out.sort(key=lambda ev: (ev.at_tick, ev.action, ev.host or ""))
    return out


def is_fair(topology: str, events: list[FaultEvent]) -> bool:
    """A schedule is *fair* iff :func:`repair` would hand it back
    unchanged — no event targets the impossible and every controller
    SIGKILL has its restart. The shrinker only explores fair
    candidates: dropping the restart from a kill/restart pair trivially
    loses all remaining traffic and would mask the interesting bug
    behind "you deleted the control plane, as designed"."""
    # the RNG only feeds the append-a-restart path, and needing an
    # append already means the schedule differs from its repair
    return repair(topology, list(events), random.Random(0)) == list(events)


def generate(topology: str, rng: random.Random,
             max_events: int = 5) -> list[FaultEvent]:
    """A fresh schedule: 1..max_events weighted-random events, repaired."""
    topo = TOPOLOGIES[topology]
    vocab = _vocabulary(topo)
    actions = [a for a, _ in vocab]
    weights = [w for _, w in vocab]
    events = [
        _random_event(topo, rng.choices(actions, weights)[0], rng)
        for _ in range(rng.randint(1, max_events))
    ]
    return repair(topology, events, rng)


def mutate(
    topology: str,
    parent: list[FaultEvent],
    rng: random.Random,
    pool: Optional[list[list[FaultEvent]]] = None,
) -> list[FaultEvent]:
    """AFL-style mutation: drop / add / retime / re-target / splice a
    slice from another interesting schedule. 1-2 ops, then repair."""
    topo = TOPOLOGIES[topology]
    events = list(parent)
    for _ in range(rng.randint(1, 2)):
        op = rng.choice(("drop", "add", "retime", "retarget", "splice"))
        if op == "drop" and events:
            events.pop(rng.randrange(len(events)))
        elif op == "add" or not events:
            vocab = _vocabulary(topo)
            action = rng.choices(
                [a for a, _ in vocab], [w for _, w in vocab]
            )[0]
            events.append(_random_event(topo, action, rng))
        elif op == "retime":
            i = rng.randrange(len(events))
            shift = rng.randint(-8, 8)
            events[i] = replace(
                events[i], at_tick=events[i].at_tick + shift
            )
        elif op == "retarget":
            i = rng.randrange(len(events))
            ev = events[i]
            if ev.action == "kill_router" and topo.n_routers:
                events[i] = replace(ev, host=rng.choice(_routers_of(topo)))
            elif ev.host is not None and topo.n_hosts:
                events[i] = replace(ev, host=rng.choice(_hosts_of(topo)))
        elif op == "splice" and pool:
            donor = rng.choice(pool)
            if donor:
                lo = rng.randrange(len(donor))
                hi = rng.randint(lo, len(donor))
                events.extend(donor[lo:hi + 1])
    return repair(topology, events, rng)


# ---------------------------------------------------------------------------
# running one schedule
# ---------------------------------------------------------------------------


async def run_schedule(
    topology: str,
    events: list[FaultEvent],
    seed: int,
    device: DeviceLike = "cuda",
    n_devices: Optional[int] = None,
) -> dict:
    """Execute one schedule on its topology and return the scenario
    result artifact. The ambient fault-layer state is snapshotted and
    restored so back-to-back iterations can never leak armed fault
    points or half-consumed hit windows into each other. Worker hosts
    hold ``n_devices`` chips of ``device`` each."""
    topo = TOPOLOGIES.get(topology)
    if topo is None:
        raise FuzzError(
            f"unknown fuzz topology '{topology}' "
            f"(known: {', '.join(sorted(TOPOLOGIES))})"
        )
    snap = faults.snapshot()
    faults.clear_all()
    try:
        scenario = replace(topo, fault_script=tuple(events))
        return await run_scenario_async(
            scenario, seed=seed, defenses=True, device=device,
            n_devices=n_devices,
        )
    finally:
        faults.clear_all()
        faults.restore(snap)


def red_set(result: dict) -> set[str]:
    """The required invariants a run broke."""
    return {
        k
        for k, v in result["invariants"].items()
        if v["required"] and not v["ok"]
    }


def coverage_key(result: dict) -> tuple:
    """The novelty fingerprint: which flight-event types fired, how
    every invariant came out, and which outcome classes appeared.
    Latencies are deliberately excluded — wall time is the one thing a
    replay may legitimately change."""
    return (
        tuple(result.get("flight_event_types", ())),
        tuple(
            sorted((k, v["ok"]) for k, v in result["invariants"].items())
        ),
        tuple(sorted(result["counts"])),
    )


# ---------------------------------------------------------------------------
# delta-debugging shrinker
# ---------------------------------------------------------------------------


async def shrink(
    events: list[FaultEvent],
    still_fails: Callable[[list[FaultEvent]], Awaitable[bool]],
    max_runs: int = 48,
) -> tuple[list[FaultEvent], int]:
    """ddmin to a locally-minimal failing schedule: chunked removal
    passes first, then a single-event sweep until removing ANY one
    remaining event makes the failure disappear (or the candidate
    unfair — see :func:`is_fair`). ``still_fails`` is the oracle (for
    real runs: fair AND the original red set still reproduces).
    Returns (minimal schedule, oracle invocations)."""
    runs = 0
    cur = list(events)

    async def check(cand: list[FaultEvent]) -> bool:
        nonlocal runs
        runs += 1
        return await still_fails(cand)

    # chunk phase (classic ddmin over complements)
    n = 2
    while len(cur) >= 2 and runs < max_runs:
        chunk = max(1, len(cur) // n)
        reduced = False
        for i in range(0, len(cur), chunk):
            if runs >= max_runs:
                break
            cand = cur[:i] + cur[i + chunk:]
            if await check(cand):
                cur = cand
                n = max(2, n - 1)
                reduced = True
                break
        if not reduced:
            if chunk == 1:
                break
            n = min(len(cur), n * 2)

    # local-minimality sweep: every single-event removal must pass
    i = 0
    while i < len(cur) and runs < max_runs:
        cand = cur[:i] + cur[i + 1:]
        if await check(cand):
            cur = cand
            i = 0
        else:
            i += 1
    return cur, runs


# ---------------------------------------------------------------------------
# repro artifacts
# ---------------------------------------------------------------------------


def schedule_to_json(events: list[FaultEvent]) -> list[dict]:
    return [dataclasses.asdict(ev) for ev in events]


def schedule_from_json(rows: list[dict]) -> list[FaultEvent]:
    try:
        return [FaultEvent(**row) for row in rows]
    except TypeError as e:
        raise FuzzError(f"malformed schedule row: {e}") from None


def schedule_digest(topology: str, events: list[FaultEvent],
                    seed: int) -> str:
    payload = json.dumps(
        {"topology": topology, "seed": seed,
         "events": schedule_to_json(events)},
        sort_keys=True,
    )
    return f"{zlib.crc32(payload.encode()):08x}"


def make_artifact(
    topology: str,
    seed: int,
    events: list[FaultEvent],
    result: dict,
    env: Optional[dict] = None,
    note: str = "",
) -> dict:
    return {
        "kind": ARTIFACT_KIND,
        "version": ARTIFACT_VERSION,
        "topology": topology,
        "seed": seed,
        "events": schedule_to_json(events),
        "env": {
            k: v
            for k, v in (env or {}).items()
            if k in ARTIFACT_ENV_ALLOWLIST
        },
        "expect": {
            "passed": bool(result["passed"]),
            "red": sorted(red_set(result)),
        },
        # informational: the signature when the artifact was minted.
        # The corpus gate compares replay-vs-replay (determinism), not
        # replay-vs-history — the invariant set is allowed to grow.
        "outcome_signature": outcome_signature(result),
        "note": note,
    }


def save_artifact(path: Path | str, artifact: dict) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(artifact, indent=2) + "\n")
    return path


def load_artifact(path: Path | str) -> dict:
    path = Path(path)
    try:
        art = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise FuzzError(f"unreadable artifact {path}: {e}") from None
    if art.get("kind") != ARTIFACT_KIND:
        raise FuzzError(f"{path} is not a {ARTIFACT_KIND} artifact")
    if art.get("version") != ARTIFACT_VERSION:
        raise FuzzError(
            f"{path}: unsupported artifact version {art.get('version')}"
        )
    if art.get("topology") not in TOPOLOGIES:
        raise FuzzError(
            f"{path}: unknown topology '{art.get('topology')}'"
        )
    return art


class _env_overlay:
    """Apply allowlisted env keys for the duration of a replay/run and
    restore the previous values exactly."""

    def __init__(self, env: dict):
        self.env = {
            k: v for k, v in env.items() if k in ARTIFACT_ENV_ALLOWLIST
        }
        self._saved: dict[str, Optional[str]] = {}

    def __enter__(self):
        for k, v in self.env.items():
            self._saved[k] = os.environ.get(k)
            os.environ[k] = str(v)
        return self

    def __exit__(self, *exc):
        for k, old in self._saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        self._saved.clear()
        return False


async def replay_artifact(
    artifact: dict | Path | str,
    check_determinism: bool = True,
    device: DeviceLike = "cuda",
    n_devices: Optional[int] = None,
) -> dict:
    """Re-execute a repro artifact. Returns the verdict: the replay's
    red set, whether it matches the artifact's expectation, and (when
    ``check_determinism``) whether two replays produced identical
    outcome signatures."""
    art = (
        artifact
        if isinstance(artifact, dict)
        else await asyncio.to_thread(load_artifact, artifact)
    )
    events = schedule_from_json(art["events"])
    with _env_overlay(art.get("env", {})):
        r1 = await run_schedule(
            art["topology"], events, art["seed"], device, n_devices
        )
        r2 = (
            await run_schedule(
                art["topology"], events, art["seed"], device, n_devices
            )
            if check_determinism
            else None
        )
    sig1 = outcome_signature(r1)
    red = sorted(red_set(r1))
    expect = art.get("expect", {})
    return {
        "result": r1,
        "red": red,
        "signature": sig1,
        "matches_expect": (
            red == list(expect.get("red", []))
            and bool(r1["passed"]) == bool(expect.get("passed"))
        ),
        "deterministic": (
            None if r2 is None else sig1 == outcome_signature(r2)
        ),
    }


# ---------------------------------------------------------------------------
# the search loop
# ---------------------------------------------------------------------------


@dataclass
class FuzzStats:
    runs: int = 0
    novel: int = 0
    failures: int = 0
    shrink_runs: int = 0
    elapsed_s: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


async def fuzz(
    topology: str = "small_multihost",
    seed: int = 0,
    budget_s: float = 120.0,
    max_runs: Optional[int] = None,
    out_dir: Optional[Path | str] = None,
    drill: bool = False,
    keep_going: bool = False,
    shrink_max_runs: int = 48,
    on_progress: Optional[Callable[[str], None]] = None,
    device: DeviceLike = "cuda",
    n_devices: Optional[int] = None,
) -> dict:
    """The coverage-guided search: generate/mutate schedules, keep the
    novel ones, shrink any failure to a minimal replayable artifact.
    Returns ``{"stats", "artifacts", "artifact_paths", "pool"}``;
    callers decide what a failure means (the drill EXPECTS one)."""
    if topology not in TOPOLOGIES:
        raise FuzzError(
            f"unknown fuzz topology '{topology}' "
            f"(known: {', '.join(sorted(TOPOLOGIES))})"
        )
    say = on_progress or (lambda msg: logger.info(msg))
    rng = random.Random(seed)
    env = {"BIOENGINE_FUZZ_DRILL": "1"} if drill else {}
    stats = FuzzStats()
    artifacts: list[dict] = []
    artifact_paths: list[str] = []
    pool: list[list[FaultEvent]] = []
    seen: set = set()
    t0 = time.monotonic()
    deadline = t0 + budget_s

    with _env_overlay(env):
        # the empty schedule is the baseline: it must be green, or the
        # substrate itself is broken and every search result is noise
        base = await run_schedule(topology, [], seed, device, n_devices)
        stats.runs += 1
        base_red = red_set(base)
        if base_red:
            raise FuzzError(
                f"baseline (empty schedule) is red on '{topology}': "
                f"{sorted(base_red)} — fix the substrate before fuzzing"
            )
        seen.add(coverage_key(base))
        pool.append([])

        while time.monotonic() < deadline and (
            max_runs is None or stats.runs < max_runs
        ):
            if pool and rng.random() < 0.7:
                parent = pool[rng.randrange(len(pool))]
                events = mutate(topology, parent, rng, pool)
            else:
                events = generate(topology, rng)
            if not events:
                continue
            result = await run_schedule(
                topology, events, seed, device, n_devices
            )
            stats.runs += 1
            red = red_set(result)
            if red:
                stats.failures += 1
                say(
                    f"run {stats.runs}: RED {sorted(red)} with "
                    f"{len(events)} event(s) — shrinking"
                )

                async def still_fails(cand: list[FaultEvent]) -> bool:
                    if not is_fair(topology, cand):
                        return False  # rejected without burning a run
                    r = await run_schedule(
                        topology, cand, seed, device, n_devices
                    )
                    return red <= red_set(r)

                minimal, used = await shrink(
                    events, still_fails, max_runs=shrink_max_runs
                )
                stats.shrink_runs += used
                final = await run_schedule(
                    topology, minimal, seed, device, n_devices
                )
                art = make_artifact(
                    topology,
                    seed,
                    minimal,
                    final,
                    env=env,
                    note=(
                        f"found by fuzz seed={seed} after "
                        f"{stats.runs} run(s); shrunk from "
                        f"{len(events)} to {len(minimal)} event(s) "
                        f"in {used} run(s)"
                    ),
                )
                artifacts.append(art)
                say(
                    f"  minimal repro: {len(minimal)} event(s) "
                    f"{[(e.at_tick, e.action, e.host) for e in minimal]}"
                )
                if out_dir is not None:
                    digest = schedule_digest(topology, minimal, seed)
                    path = await asyncio.to_thread(
                        save_artifact,
                        Path(out_dir) / f"fuzz-{topology}-{digest}.json",
                        art,
                    )
                    artifact_paths.append(str(path))
                    say(f"  artifact: {path}")
                if not keep_going:
                    break
                continue
            key = coverage_key(result)
            if key not in seen:
                seen.add(key)
                pool.append(events)
                stats.novel += 1
                say(
                    f"run {stats.runs}: novel coverage "
                    f"(pool={len(pool)}, "
                    f"events={[(e.at_tick, e.action) for e in events]})"
                )

    stats.elapsed_s = round(time.monotonic() - t0, 3)
    return {
        "stats": stats.as_dict(),
        "artifacts": artifacts,
        "artifact_paths": artifact_paths,
        "pool": [schedule_to_json(ev) for ev in pool],
    }


__all__ = [
    "ARTIFACT_KIND",
    "ARTIFACT_VERSION",
    "FuzzError",
    "TOPOLOGIES",
    "coverage_key",
    "fuzz",
    "generate",
    "is_fair",
    "load_artifact",
    "make_artifact",
    "mutate",
    "red_set",
    "repair",
    "replay_artifact",
    "run_schedule",
    "save_artifact",
    "schedule_digest",
    "schedule_from_json",
    "schedule_to_json",
    "shrink",
]
