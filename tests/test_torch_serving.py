"""The serving plane's scenarios of ``tests/test_serving.py`` through both
packages: the JAX ``bioengine_tpu.serving`` and the port's
``bioengine_tpu_torch.serving``, each over the same explicit CPU topology
(8 chips; the fixture classes ignore their lease).

Each scenario is one ``async`` function of a package namespace. It makes
the JAX test's assertions and returns what it observed: replica states,
error types and messages (replica ids masked), lease maps, pending
workloads and batch statistics. ``test_scenario`` runs it on each
package; ``test_same_outcomes`` runs it on both and requires equal
observations. Waits are bounded polls on state, never fixed sleeps, and
groups flush by ``max_batch`` (with a 60 s timer) wherever their
composition is observed.
"""

import asyncio
import re
from types import SimpleNamespace

import pytest

from _torch_parity import few_torch_threads  # noqa: F401
from bioengine_tpu import serving as jax_serving
from bioengine_tpu.cluster import state as jax_state
from bioengine_tpu.cluster import topology as jax_topology
from bioengine_tpu_torch import serving as torch_serving
from bioengine_tpu_torch.cluster import state as torch_state
from bioengine_tpu_torch.cluster import topology as torch_topology

pytestmark = [pytest.mark.integration, pytest.mark.anyio]

N_CHIPS = 8
NEVER_MS = 60_000  # a timer that never fires within a test


def _jax_cpu_topology(n: int):
    chips = tuple(
        jax_topology.ChipInfo(device_id=i, platform="cpu", kind="cpu", process_index=0)
        for i in range(n)
    )
    return jax_topology.TpuTopology(chips=chips, n_hosts=1, platform="cpu")


def _package(name, state_mod, serving, topology):
    return SimpleNamespace(
        name=name,
        cluster_state=lambda n=N_CHIPS: state_mod.ClusterState(topology(n)),
        ServeController=serving.ServeController,
        DeploymentSpec=serving.DeploymentSpec,
        ReplicaState=serving.ReplicaState,
        ContinuousBatcher=serving.ContinuousBatcher,
    )


PACKAGES = {
    "jax": _package("jax", jax_state, jax_serving, _jax_cpu_topology),
    "torch": _package(
        "torch", torch_state, torch_serving,
        lambda n: torch_topology.detect_topology(device="cpu", n_devices=n),
    ),
}


# ---- fixture classes (those of tests/test_serving.py) ------------------------


class GoodApp:
    def __init__(self):
        self.initialized = False
        self.tested = False
        self.health_checks = 0

    async def async_init(self):
        self.initialized = True

    async def test_deployment(self):
        self.tested = True

    async def check_health(self):
        self.health_checks += 1

    async def echo(self, value):
        return {"echo": value}

    def sync_add(self, a, b):
        return a + b


class FailingTestApp(GoodApp):
    async def test_deployment(self):
        raise RuntimeError("self-test exploded")


class CrashingInitApp:
    def __init__(self):
        raise RuntimeError("init boom")


class FlakyApp(GoodApp):
    """Healthy until told otherwise."""

    broken = False

    async def check_health(self):
        if FlakyApp.broken:
            raise RuntimeError("went bad")


# ---- helpers ----------------------------------------------------------------


def _masked(text: str) -> str:
    """Replica and trace ids are random: mask them before comparing."""
    return re.sub(r"-[0-9a-f]{8}\b", "-<id>", text)


def _error(exc: BaseException) -> tuple:
    return type(exc).__name__, _masked(str(exc))


def _states(app) -> dict:
    return {
        name: [str(getattr(r.state, "value", r.state)) for r in reps]
        for name, reps in app.replicas.items()
    }


def _leases(app) -> dict:
    return {name: [list(r.device_ids) for r in reps] for name, reps in app.replicas.items()}


def _stats(batcher) -> dict:
    """The batcher's stats without its wall-clock queue-wait quantiles."""
    s = batcher.stats
    return {**s, "queue_wait_ms": {"samples": s["queue_wait_ms"]["samples"]}}


async def _settled(pkg, app, timeout=10.0) -> None:
    """Poll until no replica is still initialising or running its
    background self-test."""
    busy = (pkg.ReplicaState.INITIALIZING, pkg.ReplicaState.TESTING)

    async def wait():
        while any(r.state in busy for reps in app.replicas.values() for r in reps):
            await asyncio.sleep(0.005)

    await asyncio.wait_for(wait(), timeout)


async def _until(predicate, timeout=10.0) -> None:
    async def wait():
        while not predicate():
            await asyncio.sleep(0.005)

    await asyncio.wait_for(wait(), timeout)


class _Controller:
    """``ServeController(ClusterState(topology), health_check_period=3600)``
    for the length of a scenario, stopped at its end."""

    def __init__(self, pkg):
        self.c = pkg.ServeController(pkg.cluster_state(), health_check_period=3600)

    async def __aenter__(self):
        return self.c

    async def __aexit__(self, *exc):
        await self.c.stop()


# ---- deploy lifecycle -------------------------------------------------------


async def deploy_and_call(pkg):
    async with _Controller(pkg) as controller:
        app = await controller.deploy(
            "app-1", [pkg.DeploymentSpec(name="entry", instance_factory=GoodApp)]
        )
        await _settled(pkg, app)
        handle = controller.get_handle("app-1")
        echoed = await handle.echo(value=5)
        added = await handle.call("sync_add", 2, 3)
        assert echoed == {"echo": 5} and added == 5
        status = controller.get_app_status("app-1")
        assert status["status"] == "RUNNING"
        rep = status["deployments"]["entry"]["replicas"][0]
        assert rep["state"] == "HEALTHY"
        assert rep["total_requests"] == 2
        return {"echo": echoed, "add": added, "status": status["status"],
                "replica": (rep["state"], rep["total_requests"], rep["device_ids"])}


async def lifecycle_chain_ran(pkg):
    async with _Controller(pkg) as controller:
        app = await controller.deploy(
            "app-2", [pkg.DeploymentSpec(name="entry", instance_factory=GoodApp)]
        )
        await _settled(pkg, app)
        inst = app.replicas["entry"][0].instance
        assert inst.initialized and inst.tested
        await controller.health_tick()
        assert inst.health_checks == 1
        return {"chain": (inst.initialized, inst.tested, inst.health_checks), "states": _states(app)}


async def failed_self_test_marks_unhealthy(pkg):
    async with _Controller(pkg) as controller:
        app = await controller.deploy(
            "app-3",
            [pkg.DeploymentSpec(name="entry", instance_factory=FailingTestApp, autoscale=False)],
        )
        await _settled(pkg, app)
        r = app.replicas["entry"][0]
        assert r.state == pkg.ReplicaState.UNHEALTHY
        with pytest.raises(RuntimeError, match="not healthy") as err:
            await r.call("echo", value=1)
        return {"states": _states(app), "error": _error(err.value)}


async def crashing_init_fails_deploy(pkg):
    async with _Controller(pkg) as controller:
        with pytest.raises(RuntimeError, match="init boom") as err:
            await controller.deploy(
                "app-4", [pkg.DeploymentSpec(name="entry", instance_factory=CrashingInitApp)]
            )
        assert controller.apps["app-4"].status == "DEPLOY_FAILED"
        return {"error": _error(err.value), "status": controller.apps["app-4"].status,
                "free": controller.cluster_state.free_chips()}


async def undeploy_releases(pkg):
    async with _Controller(pkg) as controller:
        await controller.deploy(
            "app-5", [pkg.DeploymentSpec(name="entry", instance_factory=GoodApp)]
        )
        await controller.undeploy("app-5")
        assert "app-5" not in controller.list_apps()
        with pytest.raises(KeyError) as err:
            controller.get_handle("app-5")
        return {"apps": controller.list_apps(), "error": _error(err.value)}


async def unhealthy_replica_restarted(pkg):
    FlakyApp.broken = False
    async with _Controller(pkg) as controller:
        app = await controller.deploy(
            "app-6", [pkg.DeploymentSpec(name="entry", instance_factory=FlakyApp)]
        )
        await _settled(pkg, app)
        old_id = app.replicas["entry"][0].replica_id
        FlakyApp.broken = True
        try:
            await controller.health_tick()  # detects + restarts
        finally:
            FlakyApp.broken = False
        await _settled(pkg, app)
        await controller.health_tick()
        new = app.replicas["entry"][0]
        assert new.replica_id != old_id
        assert new.state == pkg.ReplicaState.HEALTHY
        logs = controller.cluster_state.get_replica_logs("app-6")
        assert any("(dead)" in k for k in logs)
        return {"states": _states(app), "restarted": new.replica_id != old_id,
                "dead_logs": sorted(_masked(k) for k in logs)}


# ---- chip accounting ----------------------------------------------------------


async def chips_leased_and_released(pkg):
    async with _Controller(pkg) as controller:
        state = controller.cluster_state
        app = await controller.deploy(
            "app-7",
            [pkg.DeploymentSpec(name="rt", instance_factory=GoodApp,
                                chips_per_replica=4, autoscale=False)],
        )
        leased, free_during = _leases(app), state.free_chips()
        assert free_during == 4
        await controller.undeploy("app-7")
        assert state.free_chips() == N_CHIPS
        return {"leases": leased, "free_during": free_during, "free_after": state.free_chips()}


async def no_capacity_enqueues_pending(pkg):
    async with _Controller(pkg) as controller:
        state = controller.cluster_state
        with pytest.raises(RuntimeError, match="chips") as err:
            await controller.deploy(
                "app-8",
                [pkg.DeploymentSpec(name="rt", instance_factory=GoodApp,
                                    chips_per_replica=16)],  # more than the 8 available
            )
        pending = [(p.workload_id, p.resources) for p in state.pending()]
        assert [p[0] for p in pending] == ["app-8/rt"]
        return {"error": _error(err.value), "pending": pending, "free": state.free_chips()}


async def failed_deploy_releases_chips_and_allows_retry(pkg):
    calls = {"n": 0}

    class SecondFails:
        def __init__(self):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("second replica boom")

        async def ping(self):
            return "ok"

    specs = [pkg.DeploymentSpec(name="rt", instance_factory=SecondFails, num_replicas=2,
                                chips_per_replica=2, autoscale=False)]
    async with _Controller(pkg) as controller:
        with pytest.raises(RuntimeError, match="boom") as err:
            await controller.deploy("app-fail", specs)
        free_after_fail = controller.cluster_state.free_chips()
        assert free_after_fail == N_CHIPS
        app = await controller.deploy("app-fail", specs)  # third ctor call OK
        assert app.status == "RUNNING"
        return {"error": _error(err.value), "free_after_fail": free_after_fail,
                "status": app.status, "leases": _leases(app), "constructions": calls["n"]}


# ---- autoscaling ----------------------------------------------------------------


async def scale_up_under_load(pkg):
    gate = asyncio.Event()

    class SlowApp(GoodApp):
        async def slow(self):
            await gate.wait()
            return "done"

    async with _Controller(pkg) as controller:
        app = await controller.deploy(
            "app-9",
            [pkg.DeploymentSpec(name="entry", instance_factory=SlowApp,
                                max_ongoing_requests=2, max_replicas=3, target_load=0.4)],
        )
        await _settled(pkg, app)
        handle = controller.get_handle("app-9")
        tasks = [asyncio.create_task(handle.slow()) for _ in range(4)]
        first = app.replicas["entry"][0]
        await _until(lambda: first.load >= 1.0)  # requests in flight -> load 1.0
        await controller.health_tick()
        n_replicas = len(app.replicas["entry"])
        assert n_replicas == 2
        gate.set()
        results = await asyncio.gather(*tasks)
        return {"replicas": n_replicas, "results": results, "leases": _leases(app)}


async def scale_down_when_idle(pkg):
    async with _Controller(pkg) as controller:
        app = await controller.deploy(
            "app-10",
            [pkg.DeploymentSpec(name="entry", instance_factory=GoodApp,
                                num_replicas=2, min_replicas=1)],
        )
        await _settled(pkg, app)
        await controller.health_tick()
        assert len(app.replicas["entry"]) == 1
        return {"states": _states(app)}


# ---- the continuous batcher ---------------------------------------------------------


async def batches_by_signature(pkg):
    seen = []

    async def batch_fn(sig, payloads):
        seen.append((sig, list(payloads)))
        return [p * 2 for p in payloads]

    b = pkg.ContinuousBatcher(batch_fn, max_batch=4, max_wait_ms=NEVER_MS)
    results = await asyncio.gather(*(b.submit("bucket-a", i) for i in range(4)))
    assert results == [0, 2, 4, 6]
    assert len(seen) == 1 and len(seen[0][1]) == 4  # one full batch
    return {"results": results, "seen": seen, "stats": _stats(b)}


async def timeout_flush_partial(pkg):
    async def batch_fn(sig, payloads):
        return payloads

    b = pkg.ContinuousBatcher(batch_fn, max_batch=100, max_wait_ms=10)
    out = await b.submit("s", "only-one")
    assert out == "only-one"
    assert b.stats["batches"] == 1
    return {"out": out, "stats": _stats(b)}


async def different_signatures_not_mixed(pkg):
    calls = []

    async def batch_fn(sig, payloads):
        calls.append((sig, list(payloads)))
        return payloads

    b = pkg.ContinuousBatcher(batch_fn, max_batch=2, max_wait_ms=NEVER_MS)
    results = await asyncio.gather(b.submit("a", 1), b.submit("b", 2), b.submit("a", 3), b.submit("b", 4))
    assert sorted(sig for sig, _ in calls) == ["a", "b"]
    return {"results": results, "calls": calls, "stats": _stats(b)}


async def batch_error_propagates_to_all(pkg):
    async def batch_fn(sig, payloads):
        raise ValueError("bad batch")

    b = pkg.ContinuousBatcher(batch_fn, max_batch=2, max_wait_ms=NEVER_MS)
    outs = await asyncio.gather(b.submit("s", 1), b.submit("s", 2), return_exceptions=True)
    assert all(isinstance(o, ValueError) and "bad batch" in str(o) for o in outs)
    return {"errors": [_error(o) for o in outs], "stats": _stats(b)}


async def result_count_mismatch_detected(pkg):
    async def batch_fn(sig, payloads):
        return payloads[:-1]

    b = pkg.ContinuousBatcher(batch_fn, max_batch=2, max_wait_ms=NEVER_MS)
    outs = await asyncio.gather(b.submit("s", 1), b.submit("s", 2), return_exceptions=True)
    assert all(isinstance(o, RuntimeError) and "results" in str(o) for o in outs)
    return {"errors": [_error(o) for o in outs], "stats": _stats(b)}


async def queue_wait_stats_empty(pkg):
    async def batch_fn(sig, payloads):
        return payloads

    b = pkg.ContinuousBatcher(batch_fn)
    assert b.stats["queue_wait_ms"] == {"p50": 0.0, "p95": 0.0, "samples": 0}
    return {"stats": b.stats}


async def close_flushes(pkg):
    async def batch_fn(sig, payloads):
        return payloads

    b = pkg.ContinuousBatcher(batch_fn, max_batch=100, max_wait_ms=NEVER_MS)
    task = asyncio.create_task(b.submit("s", 7))
    await _until(lambda: b.stats["requests"] == 1)
    await b.close()
    out = await task
    assert out == 7
    return {"out": out, "stats": _stats(b)}


async def burst_never_exceeds_max_batch(pkg):
    sizes = []

    async def batch_fn(sig, payloads):
        sizes.append(len(payloads))
        return payloads

    b = pkg.ContinuousBatcher(batch_fn, max_batch=8, max_wait_ms=NEVER_MS)
    results = await asyncio.gather(*[b.submit("s", i) for i in range(16)])
    assert results == list(range(16))
    assert sizes == [8, 8]
    await b.close()
    return {"sizes": sizes, "stats": _stats(b)}


async def cancelled_submitter_does_not_strand_group(pkg):
    started = asyncio.Event()
    release = asyncio.Event()

    async def batch_fn(sig, payloads):
        started.set()
        await release.wait()
        return [p * 10 for p in payloads]

    b = pkg.ContinuousBatcher(batch_fn, max_batch=2, max_wait_ms=NEVER_MS)
    first = asyncio.create_task(b.submit("s", 1))
    await asyncio.sleep(0)  # first request enqueued
    trigger = asyncio.create_task(b.submit("s", 2))  # fills the group
    await asyncio.wait_for(started.wait(), 10)  # batch_fn mid-flight
    trigger.cancel()  # the triggering submitter dies
    await asyncio.sleep(0)
    release.set()
    survivor = await asyncio.wait_for(first, 10)
    assert survivor == 10
    with pytest.raises(asyncio.CancelledError):
        await trigger
    await b.close()
    return {"survivor": survivor, "stats": _stats(b)}


async def submit_during_inflight_flush_gets_timer(pkg):
    """A request arriving while batch_fn for its signature is mid-flight
    must not wait forever (timer registration)."""
    first_in = asyncio.Event()
    release = asyncio.Event()

    async def batch_fn(sig, payloads):
        if not first_in.is_set():
            first_in.set()
            await release.wait()  # hold the first flush open
        return payloads

    b = pkg.ContinuousBatcher(batch_fn, max_batch=100, max_wait_ms=5)
    t1 = asyncio.create_task(b.submit("s", 1))
    await asyncio.wait_for(first_in.wait(), 10)  # first flush is in batch_fn
    t2 = asyncio.create_task(b.submit("s", 2))
    await _until(lambda: b.stats["requests"] == 2)
    release.set()
    outs = [await asyncio.wait_for(t1, 10), await asyncio.wait_for(t2, 10)]
    assert outs == [1, 2]
    return {"outs": outs, "stats": _stats(b)}


SCENARIOS = [
    deploy_and_call,
    lifecycle_chain_ran,
    failed_self_test_marks_unhealthy,
    crashing_init_fails_deploy,
    undeploy_releases,
    unhealthy_replica_restarted,
    chips_leased_and_released,
    no_capacity_enqueues_pending,
    failed_deploy_releases_chips_and_allows_retry,
    scale_up_under_load,
    scale_down_when_idle,
    batches_by_signature,
    timeout_flush_partial,
    different_signatures_not_mixed,
    batch_error_propagates_to_all,
    result_count_mismatch_detected,
    queue_wait_stats_empty,
    close_flushes,
    burst_never_exceeds_max_batch,
    cancelled_submitter_does_not_strand_group,
    submit_during_inflight_flush_gets_timer,
]


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
async def test_scenario(scenario, package):
    await scenario(PACKAGES[package])


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
async def test_same_outcomes(scenario):
    assert await scenario(PACKAGES["torch"]) == await scenario(PACKAGES["jax"])


def test_same_exports():
    assert sorted(torch_serving.__all__) == sorted(jax_serving.__all__)


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_protocol_frames_cross_packages(direction):
    """The port's ``rpc/protocol.py`` writes the JAX protocol's bytes and
    reads its frames, arrays and remote errors included."""
    import numpy as np

    from bioengine_tpu.rpc import protocol as jax_protocol
    from bioengine_tpu_torch.rpc import protocol as torch_protocol

    msg = {"type": "call", "id": 7, "args": [np.arange(6, dtype=np.float32).reshape(2, 3)],
           "kwargs": {"error": ValueError("bad input")}}
    src, dst = ((torch_protocol, jax_protocol) if direction == "torch_to_jax"
                else (jax_protocol, torch_protocol))
    frame = src.encode(msg)
    assert frame == dst.encode(msg)
    out = dst.decode(frame)
    assert out["type"] == "call" and out["id"] == 7
    np.testing.assert_array_equal(out["args"][0], msg["args"][0])
    assert isinstance(out["kwargs"]["error"], dst.RemoteError)
    assert "bad input" in str(out["kwargs"]["error"])
