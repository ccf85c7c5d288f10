"""The port's chaos fuzzer (``bioengine_tpu_torch.testing.fuzz``) against the
JAX package's: the topologies, the generator, ``repair`` and ``mutate`` give
the JAX package's schedules for the same fuzz seed; every artifact of
``tests/fuzz_corpus`` replays through the port to the signature and red set
the JAX package pinned, twice alike; the drill finds the armed defect in the
port's copy of ``cluster/state.py`` and shrinks to the single ``kill_host``;
and ``tests/test_fuzz.py``'s shrinker, watchdog and artifact cases hold for
the port's module.

Port hosts hold 8 CPU chips each (``device="cpu", n_devices=8``), as many as
the JAX conftest gives a JAX host. The port's fault registry is its own: the
fixture below clears it and the JAX one.
"""

import dataclasses
import inspect
import json
import os
import random
from pathlib import Path

import pytest

from _torch_parity import few_torch_threads  # noqa: F401
from bioengine_tpu.testing import faults as jax_faults
from bioengine_tpu.testing import fuzz as jax_fuzz
from bioengine_tpu.testing.scenarios import FaultEvent as JaxFaultEvent
from bioengine_tpu_torch.cluster.state import ClusterState
from bioengine_tpu_torch.testing import faults
from bioengine_tpu_torch.testing import fuzz as fuzzer
from bioengine_tpu_torch.testing.invariants import UNIVERSAL_INVARIANTS
from bioengine_tpu_torch.testing.scenarios import FaultEvent, outcome_signature, run_scenario_async

pytestmark = [pytest.mark.integration, pytest.mark.anyio]

CORPUS_DIR = Path(__file__).parent / "fuzz_corpus"
CPU = {"device": "cpu", "n_devices": 8}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def _json(events) -> list:
    return fuzzer.schedule_to_json(events)


# ---- the search's pure functions, beside the JAX package's ---------------------


def test_topologies_and_artifact_format_equal_the_jax_ones():
    assert {k: dataclasses.asdict(v) for k, v in fuzzer.TOPOLOGIES.items()} == {
        k: dataclasses.asdict(v) for k, v in jax_fuzz.TOPOLOGIES.items()
    }
    assert fuzzer.TOPOLOGIES["small_multihost"].chips_per_replica == 2
    assert (fuzzer.ARTIFACT_KIND, fuzzer.ARTIFACT_VERSION, fuzzer.ARTIFACT_ENV_ALLOWLIST) == (
        jax_fuzz.ARTIFACT_KIND, jax_fuzz.ARTIFACT_VERSION, jax_fuzz.ARTIFACT_ENV_ALLOWLIST)
    assert "BIOENGINE_FUZZ_DRILL" in fuzzer.ARTIFACT_ENV_ALLOWLIST
    for fn in (fuzzer.run_schedule, fuzzer.replay_artifact, fuzzer.fuzz):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda" and params["n_devices"].default is None


@pytest.mark.parametrize("topology", ["small_multihost", "routed_local"])
@pytest.mark.parametrize("seed", [0, 1, 7, 11, 42])
def test_generate_repair_mutate_equal_the_jax_ones(topology, seed):
    ours, theirs = random.Random(seed), random.Random(seed)
    a, b = fuzzer.generate(topology, ours), jax_fuzz.generate(topology, theirs)
    assert _json(a) == jax_fuzz.schedule_to_json(b)
    assert fuzzer.is_fair(topology, a)
    pool_a, pool_b = [a], [b]
    for _ in range(12):
        a = fuzzer.mutate(topology, a, ours, pool_a) or a
        b = jax_fuzz.mutate(topology, b, theirs, pool_b) or b
        assert _json(a) == jax_fuzz.schedule_to_json(b)
        assert fuzzer.is_fair(topology, a)
        pool_a.append(a)
        pool_b.append(b)
    # repair of an unfair schedule: the last host, a respawn of a live
    # host, an unpaired controller kill, a burst of nothing
    unfair = [("kill_host", "h1", 5), ("kill_host", "h2", 8), ("respawn_host", "h1", 3),
              ("kill_controller", None, 9), ("traffic_burst", None, 4), ("kill_router", "r1", 6)]
    ours_r = fuzzer.repair(topology, [FaultEvent(at_tick=t, action=act, host=h) for act, h, t in unfair],
                           random.Random(seed))
    theirs_r = jax_fuzz.repair(topology, [JaxFaultEvent(at_tick=t, action=act, host=h) for act, h, t in unfair],
                               random.Random(seed))
    assert _json(ours_r) == jax_fuzz.schedule_to_json(theirs_r)


def test_repair_pairs_controller_kill_with_restart():
    repaired = fuzzer.repair("small_multihost", [FaultEvent(at_tick=10, action="kill_controller")],
                             random.Random(0))
    assert [e.action for e in repaired] == ["kill_controller", "restart_controller"]
    assert repaired[1].at_tick > repaired[0].at_tick


def _ev(tick: int, action: str = "blip", host: str = "h1") -> FaultEvent:
    return FaultEvent(at_tick=tick, action=action, host=host)


async def test_shrinks_to_the_single_culprit():
    culprit = _ev(9, "kill_host", "h2")
    events = [_ev(t) for t in range(1, 8)] + [culprit]

    async def still_fails(cand):
        return culprit in cand

    minimal, runs = await fuzzer.shrink(events, still_fails)
    assert minimal == [culprit] and runs < len(events) * 4


async def test_minimal_schedule_is_locally_minimal():
    needed = {_ev(3, "kill_host", "h1"), _ev(11, "kill_host", "h2")}
    noise = [_ev(t) for t in (2, 5, 7, 13, 17)]

    async def still_fails(cand):
        return needed <= set(cand)

    minimal, _ = await fuzzer.shrink(list(needed) + noise, still_fails)
    assert await still_fails(minimal)
    for i in range(len(minimal)):
        assert not await still_fails(minimal[:i] + minimal[i + 1:])


async def test_shrink_respects_its_run_budget():
    calls = 0

    async def still_fails(cand):
        nonlocal calls
        calls += 1
        return True

    await fuzzer.shrink([_ev(t) for t in range(1, 20)], still_fails, max_runs=10)
    assert calls <= 10


# ---- runs on the port's plane ----------------------------------------------------


async def test_every_run_carries_the_whole_library():
    result = await fuzzer.run_schedule("routed_local", [], seed=3)  # no hosts: the default cuda is never touched
    for name in UNIVERSAL_INVARIANTS:
        v = result["invariants"][name]
        assert v["required"] and v.get("universal"), name
    assert result["passed"], result["invariants"]
    assert result["flight_event_types"]


async def test_watchdog_fails_typed_instead_of_hanging():
    scenario = dataclasses.replace(fuzzer.TOPOLOGIES["routed_local"], name="fuzz_watchdog_probe",
                                   ticks=4, service_s=30.0, watchdog_s=0.8, deadline_s=0.9)
    result = await run_scenario_async(scenario, seed=0)
    assert not result["passed"]
    assert not result["invariants"]["watchdog_timeout"]["ok"]
    assert any(out and "WatchdogTimeout" in out for out in result["outcomes"])


async def test_coverage_key_separates_outcome_shapes():
    clean = await fuzzer.run_schedule("routed_local", [], seed=3)
    killed = await fuzzer.run_schedule("routed_local", [FaultEvent(at_tick=5, action="kill_router", host="r0")],
                                       seed=3)
    assert fuzzer.coverage_key(clean) != fuzzer.coverage_key(killed)
    with pytest.raises(fuzzer.FuzzError):
        await fuzzer.run_schedule("no_such_topology", [], 0)
    with pytest.raises(fuzzer.FuzzError):
        await fuzzer.fuzz(topology="no_such_topology", budget_s=1)


CORPUS = sorted(CORPUS_DIR.glob("*.json"))


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.stem)
async def test_corpus_artifact_replays_to_the_pinned_signature(path):
    """The JAX package pinned each artifact's signature and red set; the
    port's replay gives both, twice alike."""
    art = fuzzer.load_artifact(path)
    assert art == jax_fuzz.load_artifact(path)
    verdict = await fuzzer.replay_artifact(path, check_determinism=True, **CPU)
    assert verdict["signature"] == art["outcome_signature"]
    assert verdict["red"] == art["expect"]["red"]
    assert verdict["matches_expect"] and verdict["deterministic"] is True
    digest = fuzzer.schedule_digest(art["topology"], fuzzer.schedule_from_json(art["events"]), art["seed"])
    assert digest == jax_fuzz.schedule_digest(
        art["topology"], jax_fuzz.schedule_from_json(art["events"]), art["seed"])


async def test_drill_artifact_is_red_on_lease_conservation_only():
    verdict = await fuzzer.replay_artifact(CORPUS_DIR / "drill_lease_leak.json", check_determinism=False, **CPU)
    assert verdict["red"] == ["lease_conservation"] and not verdict["result"]["passed"]


async def test_drill_bug_found_in_the_ports_state_and_shrunk(monkeypatch):
    """The noisy schedule of ``tests/test_fuzz.py``'s drill over the armed
    defect of the port's ``cluster/state.py``: red on lease_conservation,
    shrunk to the single kill_host; without the flag it is green."""
    deaths = []
    mark_host_dead = ClusterState.mark_host_dead

    def spy(self, host_id):
        deaths.append(host_id)
        return mark_host_dead(self, host_id)

    monkeypatch.setattr(ClusterState, "mark_host_dead", spy)
    noisy = [
        FaultEvent(at_tick=3, action="clock_skew", skew_s=2.0),
        FaultEvent(at_tick=7, action="kill_host", host="h2"),
        FaultEvent(at_tick=9, action="traffic_burst", burst=6),
    ]
    with fuzzer._env_overlay({"BIOENGINE_FUZZ_DRILL": "1"}):
        first = await fuzzer.run_schedule("small_multihost", noisy, seed=5, **CPU)
        red = fuzzer.red_set(first)
        assert red == {"lease_conservation"}, first["invariants"]
        assert "h2" in deaths  # the port's ClusterState took the death

        async def still_fails(cand):
            if not fuzzer.is_fair("small_multihost", cand):
                return False
            r = await fuzzer.run_schedule("small_multihost", cand, seed=5, **CPU)
            return red <= fuzzer.red_set(r)

        minimal, _ = await fuzzer.shrink(noisy, still_fails)
    assert _json(minimal) == _json([noisy[1]])
    clean = await fuzzer.run_schedule("small_multihost", minimal, seed=5, **CPU)
    assert clean["passed"], clean["invariants"]
    assert outcome_signature(clean) != outcome_signature(first)


async def test_env_overlay_is_scoped_and_allowlisted(monkeypatch):
    monkeypatch.delenv("BIOENGINE_FUZZ_DRILL", raising=False)
    before = os.environ.get("PATH")
    with fuzzer._env_overlay({"BIOENGINE_FUZZ_DRILL": "1", "PATH": "/evil"}):
        assert os.environ.get("BIOENGINE_FUZZ_DRILL") == "1"
        assert os.environ.get("PATH") == before
    assert os.environ.get("BIOENGINE_FUZZ_DRILL") is None


def test_artifact_roundtrip_and_foreign_json(tmp_path):
    events = [FaultEvent(at_tick=4, action="kill_host", host="h1")]
    art = {"kind": fuzzer.ARTIFACT_KIND, "version": fuzzer.ARTIFACT_VERSION, "topology": "small_multihost",
           "seed": 9, "events": _json(events), "env": {}, "expect": {"passed": True, "red": []},
           "outcome_signature": "x", "note": ""}
    path = fuzzer.save_artifact(tmp_path / "a.json", art)
    assert fuzzer.schedule_from_json(fuzzer.load_artifact(path)["events"]) == events
    assert jax_fuzz.load_artifact(path) == fuzzer.load_artifact(path)  # one format
    foreign = tmp_path / "x.json"
    foreign.write_text(json.dumps({"kind": "something-else"}))
    with pytest.raises(fuzzer.FuzzError):
        fuzzer.load_artifact(foreign)
