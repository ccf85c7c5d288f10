"""Deterministic scenario engine — replayable synthetic incidents.

The chaos tests (tests/test_chaos.py) prove single failure modes with
hand-written choreography. This module generalizes them into a
**seeded, deterministic workload driver** over the same in-process
multi-host harness: a scenario composes a *load shape* (constant,
diurnal wave, bursts, tenant flood, hot-key signature skew) with a
*fault script* built on :mod:`bioengine_tpu_torch.testing.faults` (gray
failure = seeded ``slow_ramp`` at ``host.replica_call``, preemption
storm = repeated host kills + respawns, blip storm = connection drops),
runs it time-compressed (ticks of ~10-20 ms), and checks a set of
declarative **invariants** when the run settles — zero failed
idempotent requests, exact chip accounting, no stuck pending futures,
bounded queue depths, an SLO-attainment floor, tail-latency recovery.

Everything the workload does derives from ONE seed: arrivals per tick
are a pure function of the load shape, request arguments come from a
``random.Random(seed)``, fault windows live in tick space, and the
slow-ramp delay sequence replays exactly under its derived seed. The
**request outcome sequence** — the per-request outcome class, ordered
by request index — is therefore identical across runs with the same
seed, and so are the invariant verdicts; ``outcome_signature`` distills
both into one comparable string (the CI determinism gate diffs it
across a double run).

One normalization keeps that guarantee honest: a stream marked
``strict=False`` (the flood tenant in ``tenant_flood``) records
``absorbed`` for both *served* and *shed* — best-effort flood traffic's
contract is "must not break protected traffic", and whether one flood
request squeaked through before the queue filled is timing the
scenario deliberately does not pin. Strict streams record their real
outcome class, always.

Scenarios run with defenses ON (probation + hedging, the default) or
OFF (``defenses=False``) — the ``slow_replica`` scenario run both ways
is the acceptance proof for the gray-failure machinery: same seed, same
injected degradation; with defenses the tail recovers and nothing
fails, without them the ``p99_recovery`` invariant goes red.

Entry points: :func:`run_scenario` (sync, used by the CLI / bench /
CI) and :func:`run_scenario_async` (tests already inside a loop).
``BIOENGINE_SCENARIO_SCALE`` stretches every time constant for slow
machines (2.0 = twice as slow, twice as patient).
"""

from __future__ import annotations

import asyncio
import math
import os
import random
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional

from bioengine_tpu_torch.runtime.devices import DeviceLike
from bioengine_tpu_torch.testing import faults
from bioengine_tpu_torch.utils import flight
from bioengine_tpu_torch.utils.logger import create_logger

logger = create_logger("scenarios", log_file="off")

# ---------------------------------------------------------------------------
# scenario vocabulary
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Stream:
    """One deterministic arrival process. ``arrivals(tick)`` is a pure
    function — no RNG — so the request plan replays exactly."""

    name: str = "main"
    tenant: Optional[str] = None
    priority: Optional[str] = None
    strict: bool = True          # False → ok and shed both record "absorbed"
    idempotent: bool = True
    kind: str = "constant"       # constant | diurnal | burst
    base: int = 2                # arrivals per tick
    amplitude: int = 0           # diurnal peak above base
    period: int = 40             # diurnal period in ticks
    burst_every: int = 0
    burst_size: int = 0
    start_tick: int = 0
    end_tick: Optional[int] = None
    skew_keys: int = 0           # >0 → hot-key argument skew (signature skew)
    deadline_s: Optional[float] = None
    # token streaming: drive ``gen_stream`` through
    # DeploymentHandle.call_stream instead of the unary ``work`` call.
    # Generation length is gen_tokens + (a % (gen_spread + 1)) — a pure
    # function of the seeded request args, so variable-length
    # co-batching replays exactly
    streaming: bool = False
    gen_tokens: int = 16
    gen_spread: int = 0

    def arrivals(self, tick: int) -> int:
        if tick < self.start_tick:
            return 0
        if self.end_tick is not None and tick >= self.end_tick:
            return 0
        n = self.base
        if self.kind == "diurnal":
            n = round(
                self.base
                + self.amplitude
                * 0.5
                * (1.0 + math.sin(2.0 * math.pi * tick / self.period))
            )
        elif (
            self.kind == "burst"
            and self.burst_every
            and tick % self.burst_every == 0
        ):
            n += self.burst_size
        return max(0, n)


@dataclass(frozen=True)
class FaultEvent:
    """One scripted incident step, pinned to a tick. This is also the
    chaos fuzzer's schedule-event vocabulary — every field must stay
    JSON-serializable (fuzz repro artifacts are ``asdict`` of these)."""

    at_tick: int
    # kill_host | respawn_host | slow_ramp | blip | clear_faults |
    # kill_controller | restart_controller | stale_verb | kill_router |
    # traffic_burst (extra seeded arrivals at this tick) |
    # clock_skew (shift every host's reported clock by skew_s)
    action: str
    host: Optional[str] = None
    delay_s: float = 0.2         # slow_ramp target delay
    ramp_hits: int = 12          # slow_ramp hits to reach full delay
    point: str = "host.replica_call"
    burst: int = 0               # traffic_burst: extra arrivals
    skew_s: float = 0.0          # clock_skew: seconds of host-clock shift


@dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    ticks: int = 80
    tick_s: float = 0.015
    health_every: int = 3        # controller.health_tick cadence, in ticks
    # topology: n_hosts > 0 → remote replicas over real websockets
    # (chips_per_replica forces remote placement); 0 → local replicas
    n_hosts: int = 0
    n_replicas: int = 2
    chips_per_replica: int = 2
    max_ongoing: int = 16
    service_s: float = 0.008     # synthetic deployment's forward time
    scheduling: Optional[dict] = None   # SchedulingConfig kwargs → scheduler path
    streams: tuple = (Stream(),)
    fault_script: tuple = ()
    hedge: bool = True           # defenses leg hedges idempotent traffic
    deadline_s: float = 15.0
    max_attempts: int = 8
    slo_ms: float = 250.0
    slo_floor: float = 0.9
    # invariants: always required / required only when defenses are on
    invariants: tuple = (
        "zero_failed_idempotent",
        "chip_accounting_exact",
        "no_stuck_futures",
        "bounded_queues",
    )
    defended_invariants: tuple = ()
    # p99_recovery phases: requests issued before first fault tick are
    # the healthy baseline; the last `recovery_tail` requests the tail
    recovery_tail: int = 60
    recovery_factor: float = 2.0
    # outlier-detector overrides for the defenses leg (time-compressed)
    outlier: dict = field(default_factory=dict)
    # durable control plane: give the controller a journal directory
    # under the scenario workdir so kill_controller/restart_controller
    # can exercise crash recovery (serving/journal.py)
    durable: bool = False
    # driver-level retry for idempotent strict traffic: a client whose
    # CONTROLLER died retries through the restarted one while its
    # deadline budget lasts — the honest model of "zero failed
    # idempotent requests" across a control-plane restart (in-replica
    # failover can't help when the router itself is gone)
    client_retry: bool = False
    # scale-out router tier: n_routers > 0 → requests route through
    # StandaloneRouters fed by the controller's routing-table publisher
    # (clients spread round-robin by request index and fail over to a
    # sibling router on RouterClosedError — the typed-retry contract)
    n_routers: int = 0
    # per-router inflight admission cap (None → unbounded); the knob
    # that makes the fleet-scale goodput capacity-bound per router
    router_max_inflight: Optional[int] = None
    router_sync_every: int = 2   # table sync cadence, in ticks
    # bounded-staleness assertion input: max observed table age (seconds,
    # sampled just BEFORE each sync — the worst age a live router served
    # from), scaled by BIOENGINE_SCENARIO_SCALE
    router_staleness_bound_s: Optional[float] = None
    # fleet dressing: register N synthetic mesh hosts in ClusterState so
    # the published routing table carries a fleet-scale host membership
    # block (replicas stay local — the routing work is what's under test)
    sim_hosts: int = 0
    # step-level decode batch cap for streaming scenarios (the
    # deployment's DecodeLoop max_active; one slot is always the
    # interactive reserve)
    decode_max_active: int = 4
    # wall-clock watchdog: a livelocked run fails typed (the
    # watchdog_timeout universal invariant goes red with a flight dump)
    # instead of hanging the suite. None derives a generous budget from
    # ticks/deadline; the fuzzer relies on this to survive pathological
    # schedules. Scaled by BIOENGINE_SCENARIO_SCALE like everything else.
    watchdog_s: Optional[float] = None


# ---------------------------------------------------------------------------
# the synthetic deployment
# ---------------------------------------------------------------------------

_MANIFEST = """\
name: Scenario App
id: scenario-app
id_emoji: "\\U0001F9EA"
description: deterministic idempotent arithmetic for scenario traffic
type: tpu-serve
version: 1.0.0
deployments:
  - scenario_dep:ScenarioDep
authorized_users: ["*"]
deployment_config:
  scenario_dep:
    num_replicas: {n_replicas}
    min_replicas: {n_replicas}
    max_replicas: {n_replicas}
    chips: {chips}
    autoscale: false
"""

_SOURCE = """\
import asyncio
import time

from bioengine_tpu_torch.rpc import schema_method


class _ToyDecodeBackend:
    \"\"\"Deterministic pure-python decode backend for the step-level
    continuous batcher: token i of a sequence is a pure function of its
    prompt (token_i = (sum(prompt) + i) % 251), so a resumed stream
    regenerates exactly and the scenario client can verify the full
    sequence. MUST agree with scenarios._expected_tokens.\"\"\"

    step_s = {service_s}

    def __init__(self):
        self._state = {{}}

    def prefill(self, seq_id, tokens):
        base = sum(int(t) for t in tokens) % 251
        self._state[seq_id] = [base, 1]
        time.sleep(self.step_s)
        return base

    def step(self, seq_ids, tokens):
        time.sleep(self.step_s)
        out = []
        for sid in seq_ids:
            base, n = self._state[sid]
            out.append((base + n) % 251)
            self._state[sid][1] = n + 1
        return out

    def finish(self, seq_id):
        self._state.pop(seq_id, None)


class ScenarioDep:
    service_s = {service_s}
    decode_max_active = {decode_max_active}

    def __init__(self):
        self.calls = 0
        self._decode_loop = None

    @schema_method
    async def work(self, a: int, b: int, context=None):
        \"\"\"Idempotent arithmetic with a fixed service time.\"\"\"
        self.calls += 1
        await asyncio.sleep(self.service_s)
        return {{"sum": a + b}}

    async def gen_stream(
        self,
        prompt,
        max_new_tokens: int = 16,
        klass: str = "interactive",
        resume_from: int = 0,
        context=None,
    ):
        \"\"\"Streaming generation over the step-level continuous
        batcher (serving/decode.py) — one item per token.\"\"\"
        from bioengine_tpu_torch.serving.decode import DecodeLoop

        if self._decode_loop is None:
            self._decode_loop = DecodeLoop(
                _ToyDecodeBackend(),
                name="scenario",
                max_active=self.decode_max_active,
                interactive_reserve=1,
            )
        stream = self._decode_loop.submit(
            [int(t) for t in prompt],
            int(max_new_tokens),
            klass=klass,
            resume_from=int(resume_from or 0),
        )
        async for tok in stream.tokens():
            yield {{"token": int(tok)}}

    async def close(self):
        if self._decode_loop is not None:
            await self._decode_loop.close()
"""


def _expected_tokens(prompt: list, n: int) -> list:
    """Client-side mirror of ``_ToyDecodeBackend`` in ``_SOURCE``:
    token i = (sum(prompt) + i) % 251. The streaming driver verifies
    the WHOLE sequence against this — a resumed stream that dropped,
    duplicated or reordered a token records ``wrong_result``."""
    base = sum(prompt) % 251
    return [(base + i) % 251 for i in range(n)]


class _LocalDep:
    """Local-replica variant for host-less (scheduler-path) scenarios."""

    service_s = 0.008

    async def work(self, a: int = 0, b: int = 0):
        await asyncio.sleep(type(self).service_s)
        return {"sum": a + b}


def _build_app_dir(root: Path, scenario: Scenario) -> Path:
    """Sync helper (driven via ``asyncio.to_thread``): writes the
    scenario app's manifest + source for the AppBuilder."""
    app_dir = root / "scenario-src"
    app_dir.mkdir(parents=True, exist_ok=True)
    manifest = _MANIFEST.format(
        n_replicas=scenario.n_replicas, chips=scenario.chips_per_replica
    )
    if scenario.scheduling:
        # remote scenarios opt into the global scheduler through the
        # same manifest vocabulary operators use
        lines = ["    scheduling:"]
        for k, v in scenario.scheduling.items():
            lines.append(f"      {k}: {v}")
        manifest += "\n".join(lines) + "\n"
    (app_dir / "manifest.yaml").write_text(manifest)
    (app_dir / "scenario_dep.py").write_text(
        _SOURCE.format(
            service_s=scenario.service_s,
            decode_max_active=scenario.decode_max_active,
        )
    )
    return app_dir


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _scale() -> float:
    try:
        return max(0.1, float(os.environ.get("BIOENGINE_SCENARIO_SCALE", "1")))
    except ValueError:
        return 1.0


def _quantile(vals: list, q: float) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    return s[min(int(len(s) * q), len(s) - 1)]


async def _kill_host(host) -> None:
    """In-process SIGKILL: sever the websocket with rejoin suppressed."""
    host.rejoin = False
    if host.connection is not None:
        host.connection.auto_reconnect = False
        host.connection._closing = True
        await host.connection._abort_connection()


class _Plane:
    """The in-process serving plane a scenario drives: controller (+
    optional RpcServer and WorkerHosts), the deployed scenario app, and
    fault-script application."""

    def __init__(self, scenario: Scenario, seed: int, defenses: bool,
                 scale: float, workdir: Path, device: DeviceLike = "cuda",
                 n_devices: Optional[int] = None):
        self.scenario = scenario
        self.device = device
        self.n_devices = n_devices
        self.seed = seed
        self.defenses = defenses
        self.scale = scale
        self.workdir = workdir
        self.server = None
        self.controller = None
        self.hosts: dict[str, Any] = {}
        self.dead_hosts: dict[str, Any] = {}
        self._token = None
        self._port: Optional[int] = None
        self._outlier = None
        # SIGKILL'd controllers, kept so stale_verb can replay a
        # lower-epoch verb from them (the split-brain probe)
        self.old_controllers: list[Any] = []
        # every controller incarnation's fencing epoch, in order — the
        # epoch_monotonic universal invariant reads this
        self.epoch_history: list[Any] = []
        # scale-out router tier (scenario.n_routers > 0)
        self.routers: list[Any] = []
        self.killed_routers: list[str] = []
        self.router_failovers = 0          # client hops to a sibling
        self.staleness_samples: list[float] = []
        self.app_id = "scenario-app"
        self.deployment = "scenario_dep"

    async def start(self) -> None:
        from bioengine_tpu_torch.cluster.state import ClusterState
        from bioengine_tpu_torch.cluster.topology import TpuTopology
        from bioengine_tpu_torch.serving import (
            DeploymentSpec,
            OutlierConfig,
            SchedulingConfig,
            ServeController,
        )

        s = self.scenario
        outlier_kwargs = {
            # time-compressed defaults sized to the tick scale; a
            # scenario may override any of them
            "ratio": 2.5,
            "recovery_ratio": 1.6,
            "excursion_s": 0.25 * self.scale,
            "min_samples": 6,
            "probe_every": 6,
            "ewma_alpha": 0.35,
            **s.outlier,
        }
        outlier = OutlierConfig(enabled=self.defenses, **outlier_kwargs)
        self._outlier = outlier
        if s.n_hosts > 0:
            from bioengine_tpu_torch.rpc.server import RpcServer

            self.server = RpcServer(host="127.0.0.1", admin_users=["admin"])
            await self.server.start()
            self._port = self.server.port
            self._token = self.server.issue_token("admin", is_admin=True)
            self.controller = self._make_controller()
            self.controller.attach_rpc(self.server, admin_users=["admin"])
            for i in range(s.n_hosts):
                await self.spawn_host(f"h{i + 1}")
            await self._deploy_remote()
        else:
            self.controller = ServeController(
                ClusterState(), health_check_period=3600,
                outlier_config=outlier,
            )
            _LocalDep.service_s = s.service_s
            scheduling = (
                SchedulingConfig(**s.scheduling)
                if s.scheduling is not None
                else None
            )
            await self.controller.deploy(
                self.app_id,
                [
                    DeploymentSpec(
                        name=self.deployment,
                        instance_factory=_LocalDep,
                        num_replicas=s.n_replicas,
                        min_replicas=s.n_replicas,
                        max_replicas=s.n_replicas,
                        max_ongoing_requests=s.max_ongoing,
                        autoscale=False,
                        scheduling=scheduling,
                    )
                ],
            )
        if s.sim_hosts > 0:
            self._register_sim_hosts()
        if s.n_routers > 0:
            self._start_routers()
        self.epoch_history.append(getattr(self.controller, "epoch", None))

    def _register_sim_hosts(self) -> None:
        """Fleet dressing: N synthetic mesh hosts in ClusterState so the
        published routing table carries a fleet-scale membership block.
        Safe because the local plane has no RPC server — the dead-host
        prune is a no-op — and the hosts lease no chips."""
        from bioengine_tpu_torch.cluster.state import HostRecord

        now = time.time()
        for i in range(self.scenario.sim_hosts):
            hid = f"sim{i}"
            self.controller.cluster_state.hosts[hid] = HostRecord(
                host_id=hid,
                service_id=f"svc-{hid}",
                topology={"n_chips": 4, "chips": []},
                registered_at=now,
            )

    def _start_routers(self) -> None:
        """Bring up the standalone router tier against the controller's
        routing-table publisher. The resolver re-reads ``self.controller``
        per lookup so a controller restart transparently re-resolves."""
        from bioengine_tpu_torch.serving import (
            StandaloneRouter,
            shared_object_resolver,
        )

        s = self.scenario
        resolver = shared_object_resolver(lambda: self.controller)
        for i in range(s.n_routers):
            router = StandaloneRouter(
                f"r{i}",
                resolver,
                outlier_config=self._outlier,
                max_inflight=s.router_max_inflight,
            )
            router.sync_from(self.controller)
            self.routers.append(router)

    def sync_routers(self) -> None:
        """One table-sync round. Staleness is sampled BEFORE syncing —
        the worst age each live router actually served from — feeding
        the bounded-staleness invariant. A failed sync (controller
        mid-restart) keeps the last-good table: staleness grows, routing
        continues."""
        for router in self.routers:
            if router.closed:
                continue
            self.staleness_samples.append(router.table_staleness_s)
            try:
                router.sync_from(self.controller)
            except Exception as e:  # noqa: BLE001 — stale table keeps serving
                logger.debug(
                    f"router {router.router_id} sync failed: {e}"
                )

    def kill_router(self, router_id: Optional[str]) -> None:
        for router in self.routers:
            if router.router_id == router_id:
                router.kill()
                self.killed_routers.append(router.router_id)
                logger.info(f"scenario: router {router_id} killed")
                return
        raise ValueError(f"kill_router: unknown router '{router_id}'")

    def _make_controller(self):
        from bioengine_tpu_torch.cluster.state import ClusterState
        from bioengine_tpu_torch.cluster.topology import TpuTopology
        from bioengine_tpu_torch.serving import ServeController

        kwargs: dict = {}
        if self.scenario.durable:
            kwargs["control_dir"] = str(self.workdir / "control")
        return ServeController(
            ClusterState(TpuTopology(chips=(), n_hosts=1, platform="cpu")),
            health_check_period=3600,
            outlier_config=self._outlier,
            **kwargs,
        )

    async def kill_controller(self) -> None:
        """SIGKILL-equivalent control-plane teardown: the RPC server
        vanishes (every host's websocket closes — they go ORPHANED and
        start rejoin backoff) and the controller object is abandoned
        mid-state: no drains, no undeploys, no journal goodbye. The
        journal directory is all that survives."""
        if self.server is None:
            # already dead — killing a corpse is a no-op. The fuzzer's
            # shrinker runs arbitrary subsets of a schedule, so the
            # substrate must accept unpaired lifecycle verbs.
            return
        # self.controller keeps pointing at the dead object until the
        # restart lands — exactly what a client with a stale reference
        # sees; its calls fail fast (provider gone) and client_retry
        # carries them across
        self.old_controllers.append(self.controller)
        server, self.server = self.server, None
        if server is not None:
            await server.stop()
        # callers queued inside the dead controller's schedulers would
        # otherwise wait out their full deadline — in a real SIGKILL
        # their connection to the controller process dies, so emulate
        # that: fail queued work typed NOW, drain nothing
        for sched in self.controller._schedulers.values():
            sched.kill()
        # a SIGKILL'd process refuses new connections instantly — model
        # that on the abandoned object too: calls through a stale
        # reference get a typed fast refusal (RouterClosedError) instead
        # of burning their whole deadline in _pick_replica_wait on
        # replicas a dead control plane can never re-place (the chaos
        # fuzzer found exactly that: paired kill/restart still lost
        # idempotent traffic because one slow failure ate the budget)
        from bioengine_tpu_torch.serving.router import _RouterGate

        gate = _RouterGate(router_id="controller-sigkilled")
        gate.closed = True
        self.controller._router_gate = gate
        logger.info("scenario: controller killed (SIGKILL-equivalent)")

    async def restart_controller(self) -> None:
        """A fresh controller process-equivalent on the SAME port and
        admin token: replays snapshot+journal into RECOVERING, attaches
        the router, and lets the hosts' reconnect loops bring their
        warm-replica inventory back for reconcile."""
        if self.server is not None:
            # control plane is up — nothing to restart. An unpaired
            # restart (a shrinker candidate that dropped the kill)
            # must not try to double-bind the port.
            return
        from bioengine_tpu_torch.rpc.server import RpcServer

        server = RpcServer(
            host="127.0.0.1", port=self._port, admin_users=["admin"]
        )
        await server.start()
        # hosts reconnect with the token the OLD control plane issued —
        # the restarted one must honor it (prod: pre-shared admin token)
        server.issue_token("admin", is_admin=True, token_value=self._token)
        controller = self._make_controller()
        await controller.recover()
        controller.attach_rpc(server, admin_users=["admin"])
        self.server = server
        self.controller = controller
        self.epoch_history.append(getattr(controller, "epoch", None))
        logger.info(
            f"scenario: controller restarted (epoch {controller.epoch}, "
            f"phase {controller.phase})"
        )

    async def stale_verb(self) -> None:
        """The split-brain probe: the SIGKILL'd controller 'revives'
        and issues a lifecycle verb with its stale epoch straight at a
        host. The host must reject it typed (StaleEpochError) and
        record ``host.fenced`` — the epoch_fencing_observed invariant
        reads that evidence."""
        old = self.old_controllers[-1] if self.old_controllers else None
        host = next(iter(self.hosts.values()), None)
        if old is None or host is None or not host.replicas:
            return
        rid = next(iter(host.replicas))
        try:
            await host.drain_replica(rid, timeout_s=0.1, epoch=old.epoch)
            logger.warning(
                "scenario: stale-epoch verb was NOT fenced "
                "(epoch_fencing_observed will fail)"
            )
        except Exception as e:  # noqa: BLE001 — the rejection IS the datum
            logger.info(f"scenario: stale verb fenced: {e}")

    async def spawn_host(self, host_id: str):
        from bioengine_tpu_torch.worker_host import WorkerHost

        host = WorkerHost(
            server_url=self.server.url,
            token=self._token,
            host_id=host_id,
            workspace_dir=self.workdir / f"ws-{host_id}",
            rejoin=True,
            device=self.device,
            n_devices=self.n_devices,
        )
        await host.start()
        if host.connection is not None:
            host.connection.reconnect_max_backoff_s = 0.5
        self.hosts[host_id] = host
        self.dead_hosts.pop(host_id, None)
        return host

    async def _deploy_remote(self) -> None:
        from bioengine_tpu_torch.apps.builder import AppBuilder

        app_dir = await asyncio.to_thread(
            _build_app_dir, self.workdir, self.scenario
        )

        def _build():
            builder = AppBuilder(workdir_root=self.workdir / "apps")
            return builder.build(app_id=self.app_id, local_path=app_dir)

        built = await asyncio.to_thread(_build)
        await self.controller.deploy(self.app_id, built.specs)

    async def apply(self, ev: FaultEvent, seed: int) -> None:
        if ev.action == "kill_host":
            host = self.hosts.pop(ev.host, None)
            if host is not None:
                self.dead_hosts[ev.host] = host
                await _kill_host(host)
        elif ev.action == "respawn_host":
            if self.server is None:
                # the control plane is down — a real preempted host
                # would retry its join until a controller answers; the
                # harness just skips the rejoin (fuzz schedules may
                # land a respawn inside a controller-dead window)
                logger.info(
                    f"scenario: respawn of {ev.host} skipped "
                    "(controller down)"
                )
                return
            old = self.dead_hosts.pop(ev.host, None)
            if old is not None:
                try:
                    await old.stop()
                except Exception as e:  # noqa: BLE001 — already-severed host
                    logger.debug(f"stop of killed host {ev.host}: {e}")
            await self.spawn_host(ev.host)
        elif ev.action == "slow_ramp":
            import zlib

            faults.configure(
                ev.point,
                "slow_ramp",
                scope=ev.host,
                delay_s=ev.delay_s * self.scale,
                # derived, not shared: the ramp's jitter stream must not
                # depend on how many other points the scenario armed.
                # crc32, NOT hash() — str hashing is randomized per
                # interpreter (PYTHONHASHSEED), which would break the
                # replay-exactly contract ACROSS invocations while the
                # in-process double run still passed
                seed=seed
                ^ (zlib.crc32((ev.host or "").encode()) & 0xFFFF)
                ^ ev.at_tick,
                ramp_hits=ev.ramp_hits,
            )
        elif ev.action == "blip":
            host = self.hosts.get(ev.host)
            if host is not None and host.connection is not None:
                await host.connection._abort_connection()
        elif ev.action == "clear_faults":
            faults.clear(ev.point)
        elif ev.action == "kill_controller":
            await self.kill_controller()
        elif ev.action == "restart_controller":
            await self.restart_controller()
        elif ev.action == "stale_verb":
            await self.stale_verb()
        elif ev.action == "kill_router":
            self.kill_router(ev.host)
        elif ev.action == "traffic_burst":
            # the burst itself lives in the request PLAN (built from the
            # fault script before the run, keeping the plan a pure
            # function of the seed) — nothing to do at apply time
            pass
        elif ev.action == "clock_skew":
            # every host's clock drifts by skew_s relative to the
            # controller: shift the recorded skew estimate and the
            # registration timestamps the way a real skewed rejoin
            # would report them (timeline merge / telemetry attribution
            # must de-skew; nothing placement-critical keys off these)
            for host in self.controller.cluster_state.hosts.values():
                host.clock_skew_s += ev.skew_s
                host.registered_at -= ev.skew_s
        else:
            raise ValueError(f"unknown fault action '{ev.action}'")

    async def stop(self) -> None:
        for router in self.routers:
            if not router.closed:
                router.kill()
        for host in list(self.hosts.values()) + list(self.dead_hosts.values()):
            try:
                await host.stop()
            except Exception as e:  # noqa: BLE001 — teardown best effort
                logger.debug(f"host {host.host_id} teardown: {e}")
        if self.controller is not None:
            await self.controller.stop()
        if self.server is not None:
            await self.server.stop()
        # stopped hosts are useless references — drop them so a plane
        # held past stop() (scenario asserts) doesn't pin every host
        self.hosts.clear()
        self.dead_hosts.clear()


async def run_scenario_async(
    scenario: Scenario,
    seed: int = 0,
    defenses: bool = True,
    workdir: Optional[Path] = None,
    device: DeviceLike = "cuda",
    n_devices: Optional[int] = None,
) -> dict:
    """Run one scenario to completion and evaluate its invariants.
    Returns the result artifact (see module docstring); raises nothing
    on invariant failure — ``result["passed"]`` is the verdict. Worker
    hosts run on ``device`` with ``n_devices`` chips each (a ``cuda``
    host raises at its start without CUDA); a scenario without hosts
    touches no device and ignores both."""
    import tempfile

    from bioengine_tpu_torch.serving import RequestOptions
    from bioengine_tpu_torch.serving.errors import (
        AdmissionRejectedError,
        DeadlineExceeded,
        RouterClosedError,
    )

    scale = _scale()
    s = scenario
    rng = random.Random(seed)
    owns_workdir = workdir is None
    if owns_workdir:
        workdir = Path(
            await asyncio.to_thread(tempfile.mkdtemp, prefix="bioengine-scn-")
        )
    flight_t0 = time.time()
    faults.clear()
    plane = _Plane(s, seed, defenses, scale, workdir, device, n_devices)

    # ---- deterministic request plan (pure function of seed) ----------------
    # traffic_burst events inject extra arrivals; they are folded in
    # HERE, while the plan is built, so the request plan stays a pure
    # function of (seed, scenario+fault script) and replays exactly
    burst_by_tick: dict[int, int] = {}
    for ev in s.fault_script:
        if ev.action == "traffic_burst":
            burst_by_tick[ev.at_tick] = (
                burst_by_tick.get(ev.at_tick, 0) + max(0, ev.burst)
            )
    plan: list[dict] = []
    for tick in range(s.ticks):
        for stream in s.streams:
            for _ in range(stream.arrivals(tick)):
                if stream.skew_keys:
                    # hot-key skew: 80% of traffic shares one argument
                    # tuple (one batch signature — signatures hash the
                    # scalar VALUES), the rest spreads over cold keys
                    a = (
                        0
                        if rng.random() < 0.8
                        else 1 + rng.randrange(stream.skew_keys)
                    )
                    b = 1
                else:
                    a = rng.randrange(1000)
                    b = rng.randrange(1000)
                plan.append(
                    {
                        "idx": len(plan),
                        "tick": tick,
                        "stream": stream,
                        "a": a,
                        "b": b,
                    }
                )
        for _ in range(burst_by_tick.get(tick, 0)):
            plan.append(
                {
                    "idx": len(plan),
                    "tick": tick,
                    "stream": s.streams[0],
                    "a": rng.randrange(1000),
                    "b": rng.randrange(1000),
                }
            )

    outcomes: list[Optional[str]] = [None] * len(plan)
    latencies: list[Optional[float]] = [None] * len(plan)
    queue_samples: list[int] = []

    try:
        await plane.start()
        fault_by_tick: dict[int, list[FaultEvent]] = {}
        for ev in s.fault_script:
            fault_by_tick.setdefault(ev.at_tick, []).append(ev)

        def opts_for(req: dict) -> RequestOptions:
            stream = req["stream"]
            return RequestOptions(
                idempotent=stream.idempotent,
                deadline_s=(stream.deadline_s or s.deadline_s) * scale,
                max_attempts=s.max_attempts,
                backoff_base_s=0.02,
                backoff_cap_s=0.25,
                priority=stream.priority,
                tenant=stream.tenant,
                hedge=defenses and s.hedge and stream.idempotent,
            )

        async def one(req: dict) -> None:
            idx = req["idx"]
            opts = opts_for(req)
            t0 = time.monotonic()
            # client_retry scenarios re-resolve the handle per attempt:
            # after a controller restart the surviving object is the
            # PLANE, not any one controller instance — exactly a real
            # client reconnecting to the healed control-plane URL
            budget_until = t0 + (opts.deadline_s or s.deadline_s * scale)
            # router tier: clients spread round-robin by request index;
            # a RouterClosedError (typed-retryable) hops to the next
            # sibling — each request tries at most every router once
            n_routers = len(plane.routers)
            router_offset = 0
            while True:
                try:
                    if n_routers:
                        target = plane.routers[
                            (idx + router_offset) % n_routers
                        ]
                    else:
                        target = plane.controller
                    handle = target.get_handle(
                        plane.app_id, plane.deployment
                    )
                    stream = req["stream"]
                    if stream.streaming:
                        # token streaming: drain the whole generation
                        # through call_stream (mid-stream failover
                        # resumes idempotently with resume_from) and
                        # verify every token against the deterministic
                        # backend mirror
                        prompt = [req["a"] % 251, req["b"] % 251]
                        n_tokens = stream.gen_tokens + (
                            req["a"] % (stream.gen_spread + 1)
                            if stream.gen_spread
                            else 0
                        )
                        toks: list = []
                        async for item in handle.call_stream(
                            "gen_stream",
                            prompt=prompt,
                            max_new_tokens=n_tokens,
                            klass=stream.priority or "interactive",
                            options=opts,
                        ):
                            toks.append(item["token"])
                        outcomes[idx] = (
                            "ok"
                            if toks == _expected_tokens(prompt, n_tokens)
                            else "wrong_result"
                        )
                    else:
                        r = await handle.call(
                            "work", req["a"], req["b"], options=opts
                        )
                        got = r["sum"] if isinstance(r, dict) else None
                        outcomes[idx] = (
                            "ok"
                            if got == req["a"] + req["b"]
                            else "wrong_result"
                        )
                except RouterClosedError:
                    router_offset += 1
                    plane.router_failovers += 1
                    if router_offset < n_routers:
                        continue
                    if (
                        s.client_retry
                        and req["stream"].idempotent
                        and time.monotonic() < budget_until - 0.5 * scale
                    ):
                        # no sibling absorbed it (or no router tier):
                        # the refusal came from a SIGKILL'd control
                        # plane — re-resolve through whatever controller
                        # answers next, like any transport failure
                        await asyncio.sleep(0.05 * scale)
                        continue
                    outcomes[idx] = "failed:RouterClosedError"
                except AdmissionRejectedError:
                    outcomes[idx] = "shed"
                except DeadlineExceeded:
                    outcomes[idx] = "deadline"
                except Exception as e:  # noqa: BLE001 — the outcome IS the datum
                    if (
                        s.client_retry
                        and req["stream"].idempotent
                        and time.monotonic() < budget_until - 0.5 * scale
                    ):
                        # the control plane itself may be mid-restart —
                        # an idempotent request is safe to re-issue
                        # through whatever controller answers next
                        await asyncio.sleep(0.05 * scale)
                        continue
                    outcomes[idx] = f"failed:{type(e).__name__}"
                break
            latencies[idx] = time.monotonic() - t0

        by_tick: dict[int, list[dict]] = {}
        for req in plan:
            by_tick.setdefault(req["tick"], []).append(req)

        t_run = time.monotonic()
        tasks: list[asyncio.Task] = []

        async def _drive() -> None:
            for tick in range(s.ticks):
                for ev in fault_by_tick.get(tick, ()):
                    await plane.apply(ev, seed)
                for req in by_tick.get(tick, ()):
                    tasks.append(asyncio.create_task(one(req)))
                await asyncio.sleep(s.tick_s * scale)
                queue_samples.append(
                    sum(plane.controller._queue_depth.values())
                    + sum(
                        sum(r._queue_depth.values()) for r in plane.routers
                    )
                )
                if plane.routers and tick % s.router_sync_every == 0:
                    plane.sync_routers()
                if tick % s.health_every == 0:
                    await plane.controller.health_tick()
            # drain: every request finishes (deadlines bound this), then
            # the plane settles so leak checks see steady state, not
            # shutdown. The health cadence keeps running while requests
            # drain — production's background health loop doesn't stop
            # when the traffic generator does, and a request waiting in
            # _pick_replica_wait for a re-placed replica would otherwise
            # starve out its whole deadline against a rejoined host
            # nobody tops up (found by the chaos fuzzer: kill one host,
            # blip the other near the last tick)
            drained = asyncio.Event()

            async def _drain_health() -> None:
                period = s.health_every * s.tick_s * scale
                while True:
                    try:
                        await asyncio.wait_for(drained.wait(), period)
                        return
                    except asyncio.TimeoutError:
                        await plane.controller.health_tick()

            drain_health = asyncio.create_task(_drain_health())
            try:
                await asyncio.gather(*tasks)
            finally:
                drained.set()
                await drain_health
            for _ in range(3):
                await plane.controller.health_tick()
                await asyncio.sleep(0.05 * scale)
            # detached hedge probes (a probation replica is slow by
            # definition) may still be settling — give the RPC plane a
            # bounded window to drain before the leak invariants look
            settle_until = time.monotonic() + 3.0 * scale
            while time.monotonic() < settle_until:
                pending = len(plane.server._pending) if plane.server else 0
                if not pending:
                    break
                await asyncio.sleep(0.02)

        # wall-clock watchdog: a pathological schedule (livelock, a
        # drain that never drains) fails TYPED — watchdog_timeout goes
        # red with a flight dump attached — instead of hanging the
        # suite. The fuzzer depends on this to survive schedules nobody
        # would write by hand.
        watchdog_budget = (
            s.watchdog_s
            if s.watchdog_s is not None
            else s.ticks * s.tick_s + s.deadline_s + 30.0
        ) * scale
        watchdog_fired = False
        try:
            await asyncio.wait_for(_drive(), timeout=watchdog_budget)
        except asyncio.TimeoutError:
            watchdog_fired = True
            flight.dump(
                "watchdog_timeout",
                scenario=s.name,
                budget_s=round(watchdog_budget, 3),
            )
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            for i, out in enumerate(outcomes):
                if out is None:
                    outcomes[i] = "failed:WatchdogTimeout"
        wall = time.monotonic() - t_run

        result = _evaluate(
            s, seed, defenses, plane, plan, outcomes, latencies,
            queue_samples, flight_t0, wall,
            watchdog_fired=watchdog_fired,
            watchdog_budget=watchdog_budget,
        )
        return result
    finally:
        faults.clear()
        await plane.stop()
        if owns_workdir:
            import shutil

            await asyncio.to_thread(shutil.rmtree, workdir, True)


def run_scenario(
    scenario: Scenario,
    seed: int = 0,
    defenses: bool = True,
    device: DeviceLike = "cuda",
    n_devices: Optional[int] = None,
) -> dict:
    return asyncio.run(
        run_scenario_async(
            scenario, seed, defenses, device=device, n_devices=n_devices
        )
    )


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------


def _evaluate(
    s: Scenario,
    seed: int,
    defenses: bool,
    plane: _Plane,
    plan: list,
    outcomes: list,
    latencies: list,
    queue_samples: list,
    flight_t0: float,
    wall: float,
    watchdog_fired: bool = False,
    watchdog_budget: Optional[float] = None,
) -> dict:
    from bioengine_tpu_torch.testing import invariants as universal
    # normalized outcome sequence: strict streams record the real
    # class; best-effort streams (flood) collapse served/shed into
    # "absorbed" (the contract they are held to — see module docstring)
    seq = []
    for req, out in zip(plan, outcomes):
        if not req["stream"].strict and out in ("ok", "shed", "deadline"):
            seq.append("absorbed")
        else:
            seq.append(out)

    probation_events = flight.get_events(
        types=("replica.probation",), since=flight_t0
    )
    hedge_events = flight.get_events(
        types=("request.hedge",), since=flight_t0
    )

    strict_lat = [
        1000.0 * lat
        for req, lat, out in zip(plan, latencies, outcomes)
        if req["stream"].strict and out == "ok" and lat is not None
    ]
    first_fault_tick = min(
        (ev.at_tick for ev in s.fault_script), default=None
    )
    base_lat = [
        1000.0 * lat
        for req, lat, out in zip(plan, latencies, outcomes)
        if first_fault_tick is not None
        and req["tick"] < first_fault_tick
        and req["stream"].strict
        and out == "ok"
        and lat is not None
    ]
    tail_lat = [
        1000.0 * lat
        for req, lat, out in list(zip(plan, latencies, outcomes))[
            -s.recovery_tail:
        ]
        if req["stream"].strict and out == "ok" and lat is not None
    ]

    checks: dict[str, Callable[[], tuple[bool, str]]] = {
        "zero_failed_idempotent": lambda: _inv_zero_failed(plan, outcomes),
        "chip_accounting_exact": lambda: _inv_chips(plane),
        "no_stuck_futures": lambda: _inv_no_stuck(plane),
        "bounded_queues": lambda: _inv_bounded_queues(
            s, plane, queue_samples
        ),
        "slo_attainment": lambda: _inv_slo(s, strict_lat),
        "p99_recovery": lambda: _inv_recovery(s, base_lat, tail_lat),
        "probation_entered": lambda: (
            any(e["attrs"].get("phase") == "enter" for e in probation_events),
            f"{len(probation_events)} probation event(s)",
        ),
        "coalescing_observed": lambda: _inv_coalescing(plane),
        "flood_shed_observed": lambda: _inv_flood_shed(plane),
        "no_duplicate_placements": lambda: _inv_no_duplicates(plane),
        "epoch_fencing_observed": lambda: _inv_fencing(flight_t0),
        "replicas_adopted": lambda: _inv_adopted(flight_t0),
        "router_failover_observed": lambda: (
            plane.router_failovers > 0,
            f"{plane.router_failovers} client hop(s) to a sibling router",
        ),
        "router_staleness_bounded": lambda: _inv_router_staleness(s, plane),
        "decode_cobatch_observed": lambda: _inv_cobatch(flight_t0),
        "stream_resume_observed": lambda: _inv_stream_resume(flight_t0),
    }

    invariants: dict[str, dict] = {}
    for name in dict.fromkeys(
        (*s.invariants, *s.defended_invariants)
    ):
        ok, detail = checks[name]()
        invariants[name] = {
            "ok": bool(ok),
            "required": name in s.invariants
            or (defenses and name in s.defended_invariants),
            "detail": detail,
        }

    # the universal library runs on EVERY scenario, always required —
    # these are the promises the stack makes regardless of which faults
    # a schedule composed (and what `bioengine fuzz` hunts violations of)
    ctx = universal.RunContext(
        scenario=s,
        plane=plane,
        plan=plan,
        outcomes=outcomes,
        flight_t0=flight_t0,
        scale=_scale(),
        watchdog_fired=watchdog_fired,
        watchdog_budget_s=watchdog_budget,
    )
    for name, (ok, detail) in universal.evaluate_universal(ctx).items():
        invariants[name] = {
            "ok": bool(ok),
            "required": True,
            "universal": True,
            "detail": detail,
        }

    counts: dict[str, int] = {}
    for out in seq:
        counts[out] = counts.get(out, 0) + 1
    routers_section = None
    if plane.routers:
        routers_section = {
            "count": len(plane.routers),
            "killed": list(plane.killed_routers),
            "client_failovers": plane.router_failovers,
            # raw (un-normalized) served count — the goodput numerator
            # the router_scaling bench reads; best-effort capacity legs
            # normalize seq to "absorbed" but goodput wants the truth
            "raw_ok": sum(1 for out in outcomes if out == "ok"),
            "staleness_max_s": (
                round(max(plane.staleness_samples), 4)
                if plane.staleness_samples
                else None
            ),
            "staleness_samples": len(plane.staleness_samples),
            "table_epoch": plane.routers[0].table_epoch,
            "per_router": [r.describe() for r in plane.routers],
        }
    return {
        "scenario": s.name,
        "seed": seed,
        "defenses": defenses,
        "requests": len(plan),
        "wall_s": round(wall, 3),
        "counts": counts,
        "outcomes": seq,
        "invariants": invariants,
        "passed": all(
            v["ok"] for v in invariants.values() if v["required"]
        ),
        "latency_ms": {
            "p50": round(_quantile(strict_lat, 0.5) or 0.0, 2),
            "p95": round(_quantile(strict_lat, 0.95) or 0.0, 2),
            "p99": round(_quantile(strict_lat, 0.99) or 0.0, 2),
        },
        "phases": {
            "baseline_p99_ms": round(_quantile(base_lat, 0.99) or 0.0, 2),
            "tail_p99_ms": round(_quantile(tail_lat, 0.99) or 0.0, 2),
        },
        "probations": sum(
            1
            for e in probation_events
            if e["attrs"].get("phase") == "enter"
        ),
        "hedges": len(hedge_events),
        "routers": routers_section,
        # the distinct flight-event types this run produced — one third
        # of the fuzzer's coverage signature (which code paths fired,
        # not just how requests ended)
        "flight_event_types": sorted(
            {e["type"] for e in flight.get_events(since=flight_t0)}
        ),
    }


def outcome_signature(result: dict) -> str:
    """The determinism fingerprint: outcome sequence + invariant
    verdicts (NOT latencies — wall time is the one thing a replay may
    legitimately change)."""
    verdicts = ",".join(
        f"{k}={int(v['ok'])}" for k, v in sorted(result["invariants"].items())
    )
    return "|".join(result["outcomes"]) + "#" + verdicts


def _inv_zero_failed(plan, outcomes) -> tuple[bool, str]:
    bad = [
        (req["idx"], out)
        for req, out in zip(plan, outcomes)
        if req["stream"].strict
        and req["stream"].idempotent
        and out != "ok"
    ]
    return not bad, f"{len(bad)} failed idempotent request(s): {bad[:5]}"


def _inv_chips(plane: _Plane) -> tuple[bool, str]:
    # delegated to the universal library (testing/invariants.py) — the
    # per-scenario name stays for scenario definitions and old artifacts
    from bioengine_tpu_torch.testing.invariants import lease_problems

    problems = lease_problems(plane.controller)
    return not problems, "; ".join(problems) or "exact"


def _inv_no_stuck(plane: _Plane) -> tuple[bool, str]:
    from bioengine_tpu_torch.testing.invariants import liveness_problems

    problems = liveness_problems(plane)
    return not problems, "; ".join(problems) or "drained"


def _inv_bounded_queues(
    s: Scenario, plane: _Plane, queue_samples: list
) -> tuple[bool, str]:
    bound = s.n_replicas * s.max_ongoing * 4
    peak = max(queue_samples, default=0)
    final = sum(plane.controller._queue_depth.values()) + sum(
        sum(r._queue_depth.values()) for r in plane.routers
    )
    ok = peak <= bound and final == 0
    return ok, f"peak={peak} bound={bound} final={final}"


def _inv_router_staleness(s: Scenario, plane: _Plane) -> tuple[bool, str]:
    """Every live router's table age, sampled just before each sync
    round, stays under the scenario's bound — the 'routers serve a
    bounded-staleness view' contract."""
    if not plane.staleness_samples:
        return False, "no staleness samples (router tier absent?)"
    bound = (s.router_staleness_bound_s or 1.0) * _scale()
    worst = max(plane.staleness_samples)
    return worst <= bound, (
        f"max table age {1000 * worst:.0f}ms <= bound "
        f"{1000 * bound:.0f}ms over {len(plane.staleness_samples)} samples"
    )


def _inv_slo(s: Scenario, strict_lat: list) -> tuple[bool, str]:
    if not strict_lat:
        return False, "no successful strict requests"
    met = sum(1 for v in strict_lat if v <= s.slo_ms * _scale())
    frac = met / len(strict_lat)
    return (
        frac >= s.slo_floor,
        f"{100 * frac:.1f}% <= {s.slo_ms}ms (floor {100 * s.slo_floor:.0f}%)",
    )


def _inv_recovery(
    s: Scenario, base_lat: list, tail_lat: list
) -> tuple[bool, str]:
    if not base_lat or not tail_lat:
        return False, "missing baseline or tail window"
    base = _quantile(base_lat, 0.99)
    tail = _quantile(tail_lat, 0.99)
    # floor the baseline at one service time: an empty-queue baseline
    # p99 can sit below the service sleep on a quiet run
    floor = max(base, 1000.0 * s.service_s * _scale())
    ok = tail <= s.recovery_factor * floor
    return ok, (
        f"tail_p99={tail:.1f}ms vs {s.recovery_factor}x "
        f"baseline_p99={base:.1f}ms"
    )


def _inv_no_duplicates(plane: _Plane) -> tuple[bool, str]:
    """After a controller restart + reconcile there must be exactly one
    placement per intent: no duplicate replica ids in any routing set,
    no routing set over its journaled replica target, and no host-side
    replica the (current) controller does not route — a leftover copy
    the reconcile should have dropped or adopted."""
    problems: list[str] = []
    routed: set[str] = set()
    for app in plane.controller.apps.values():
        for name, reps in app.replicas.items():
            ids = [r.replica_id for r in reps]
            routed.update(ids)
            if len(ids) != len(set(ids)):
                problems.append(f"{app.app_id}/{name}: duplicate ids {ids}")
            spec = app.specs.get(name)
            if spec is not None and len(reps) > spec.num_replicas:
                problems.append(
                    f"{app.app_id}/{name}: {len(reps)} replicas over "
                    f"intent {spec.num_replicas}"
                )
    for host_id, host in plane.hosts.items():
        for rid, r in host.replicas.items():
            base = rid
            if getattr(r, "mesh_shard", None):
                base = (r.mesh_shard or {}).get(
                    "mesh_replica_id"
                ) or rid.rsplit("-s", 1)[0]
            if base not in routed:
                problems.append(
                    f"host {host_id} still serves unrouted replica {rid}"
                )
    return not problems, "; ".join(problems) or "exactly one placement per intent"


def _inv_fencing(flight_t0: float) -> tuple[bool, str]:
    fenced = flight.get_events(types=("host.fenced",), since=flight_t0)
    return bool(fenced), f"{len(fenced)} host.fenced event(s)"


def _inv_adopted(flight_t0: float) -> tuple[bool, str]:
    recovered = flight.get_events(
        types=("controller.recovered",), since=flight_t0
    )
    adopted = max(
        (e["attrs"].get("adopted", 0) for e in recovered), default=0
    )
    return adopted > 0, (
        f"{len(recovered)} controller.recovered event(s), "
        f"max adopted={adopted}"
    )


def _inv_cobatch(flight_t0: float) -> tuple[bool, str]:
    """Step-level continuous batching actually engaged: sequences were
    admitted INTO running batches (``decode.join`` with mid_batch=True)
    instead of waiting for a batch to drain — the no-head-of-line-
    blocking evidence."""
    joins = flight.get_events(types=("decode.join",), since=flight_t0)
    mid = sum(1 for e in joins if e["attrs"].get("mid_batch"))
    return mid > 0, f"{mid}/{len(joins)} join(s) entered a running batch"


def _inv_stream_resume(flight_t0: float) -> tuple[bool, str]:
    """A mid-generation failure was healed by idempotent stream resume
    (``decode.stream_resume`` marks the seam) — the fault script's kill
    really interrupted live generations, and nothing was lost."""
    evs = flight.get_events(
        types=("decode.stream_resume",), since=flight_t0
    )
    return bool(evs), f"{len(evs)} mid-stream resume(s)"


def _inv_coalescing(plane: _Plane) -> tuple[bool, str]:
    stats = {
        k: dict(sched.stats)
        for k, sched in plane.controller._schedulers.items()
    }
    grouped = sum(
        st["dispatched_requests"] - st["dispatched_groups"]
        for st in stats.values()
    )
    return grouped > 0, f"requests coalesced beyond groups: {grouped}"


def _inv_flood_shed(plane: _Plane) -> tuple[bool, str]:
    shed = sum(
        sched.stats["rejected"]
        for sched in plane.controller._schedulers.values()
    )
    return shed > 0, f"admission rejections: {shed}"


# ---------------------------------------------------------------------------
# named scenarios
# ---------------------------------------------------------------------------

NAMED_SCENARIOS: dict[str, Scenario] = {}


def _register(s: Scenario) -> Scenario:
    NAMED_SCENARIOS[s.name] = s
    return s


# THE acceptance scenario: one host's replica gray-fails (seeded
# slow-ramp — still passing health checks) a third of the way in and
# never heals; with defenses the outlier detector puts it in probation,
# hedges rescue the in-window tail, and deployment p99 returns to
# within 2x the healthy baseline with zero failed idempotent requests.
# With defenses OFF the same seed shows the degradation (p99_recovery
# goes red) — proving the scenario detects what the machinery fixes.
SLOW_REPLICA = _register(
    Scenario(
        name="slow_replica",
        description=(
            "gray failure: seeded slow-ramp on one host's replica path; "
            "probation + hedging steer around it"
        ),
        ticks=110,
        tick_s=0.015,
        n_hosts=3,
        n_replicas=3,
        chips_per_replica=2,
        service_s=0.008,
        streams=(Stream(base=3),),
        fault_script=(
            FaultEvent(at_tick=30, action="slow_ramp", host="h1",
                       delay_s=0.25, ramp_hits=10),
        ),
        slo_ms=400.0,
        slo_floor=0.85,
        recovery_tail=80,
        defended_invariants=("probation_entered", "p99_recovery"),
    )
)

_register(
    Scenario(
        name="preemption_storm",
        description=(
            "repeated host kills + respawns under idempotent traffic "
            "(spot/preempted TPUs)"
        ),
        ticks=100,
        tick_s=0.02,
        health_every=2,
        n_hosts=2,
        n_replicas=2,
        chips_per_replica=2,
        streams=(Stream(base=2),),
        fault_script=(
            FaultEvent(at_tick=20, action="kill_host", host="h1"),
            FaultEvent(at_tick=50, action="respawn_host", host="h1"),
            FaultEvent(at_tick=75, action="kill_host", host="h2"),
        ),
        deadline_s=20.0,
        slo_ms=2000.0,
    )
)

_register(
    Scenario(
        name="diurnal_wave",
        description=(
            "sinusoidal load wave over remote replicas — capacity and "
            "queue bounds under a compressed day"
        ),
        ticks=90,
        tick_s=0.015,
        n_hosts=2,
        n_replicas=2,
        chips_per_replica=2,
        streams=(
            Stream(kind="diurnal", base=1, amplitude=6, period=30),
        ),
        slo_ms=300.0,
        slo_floor=0.9,
        invariants=(
            "zero_failed_idempotent",
            "chip_accounting_exact",
            "no_stuck_futures",
            "bounded_queues",
            "slo_attainment",
        ),
    )
)

_register(
    Scenario(
        name="blip_storm",
        description=(
            "repeated connection drops with warm rejoin — the control "
            "plane flaps, traffic never notices"
        ),
        ticks=90,
        tick_s=0.02,
        health_every=3,
        n_hosts=2,
        n_replicas=2,
        chips_per_replica=2,
        streams=(Stream(base=2),),
        fault_script=(
            FaultEvent(at_tick=20, action="blip", host="h1"),
            FaultEvent(at_tick=45, action="blip", host="h2"),
            FaultEvent(at_tick=70, action="blip", host="h1"),
        ),
        deadline_s=20.0,
        slo_ms=2000.0,
    )
)

_register(
    Scenario(
        name="hot_signature",
        description=(
            "hot-key signature skew through the global scheduler — "
            "coalescing keeps the hot signature batched"
        ),
        ticks=70,
        tick_s=0.01,
        n_hosts=0,
        n_replicas=2,
        max_ongoing=32,
        service_s=0.006,
        scheduling={"max_batch": 16, "max_wait_ms": 4.0},
        streams=(
            Stream(kind="burst", base=2, burst_every=5, burst_size=8,
                   skew_keys=4),
        ),
        hedge=False,  # scheduler path owns placement; probation steers it
        slo_ms=500.0,
        invariants=(
            "zero_failed_idempotent",
            "no_stuck_futures",
            "bounded_queues",
            "coalescing_observed",
        ),
    )
)

_register(
    Scenario(
        name="tenant_flood",
        description=(
            "one tenant floods a scheduled deployment; quotas shed the "
            "flood, the protected tenant never fails"
        ),
        ticks=80,
        tick_s=0.01,
        n_hosts=0,
        n_replicas=2,
        max_ongoing=8,
        service_s=0.01,
        scheduling={
            # queue depth stays far above what the flood can pile up
            # (tenant_quota is the shedding mechanism under test; a
            # full queue would shed the PROTECTED tenant too)
            "max_batch": 8,
            "max_wait_ms": 2.0,
            "max_queue_depth": 512,
            "tenant_quota": 6,
        },
        streams=(
            Stream(name="protected", tenant="alice", priority="interactive",
                   base=2),
            Stream(name="flood", tenant="mallory", priority="bulk",
                   strict=False, base=0, kind="burst", burst_every=2,
                   burst_size=24, start_tick=20, end_tick=60),
        ),
        hedge=False,
        slo_ms=800.0,
        invariants=(
            "zero_failed_idempotent",
            "no_stuck_futures",
            "flood_shed_observed",
        ),
    )
)


# The durable-control-plane acceptance scenario: the CONTROLLER itself
# is SIGKILL'd mid-mixed-priority traffic (the hosts go orphaned but
# keep serving warm replicas), restarted against the same journal
# directory, and must reconcile — re-adopting every surviving replica
# in place, placing nothing twice, and fencing a lower-epoch verb from
# the "revived" old controller. Client-side retry models what a real
# client does when the control-plane URL heals: idempotent requests
# re-issue, so "zero failed idempotent" spans the restart.
CONTROLLER_CRASH = _register(
    Scenario(
        name="controller_crash",
        description=(
            "SIGKILL the controller mid-traffic; journal replay + host "
            "inventory reconcile recovers with zero loss and epoch "
            "fencing rejects the old controller"
        ),
        ticks=130,
        tick_s=0.02,
        health_every=3,
        n_hosts=2,
        n_replicas=2,
        chips_per_replica=2,
        max_ongoing=16,
        service_s=0.008,
        scheduling={
            "max_batch": 8,
            "max_wait_ms": 2.0,
            "max_queue_depth": 1024,
        },
        streams=(
            Stream(name="interactive", priority="interactive", base=2),
            Stream(name="bulk", priority="bulk", base=1),
        ),
        fault_script=(
            FaultEvent(at_tick=35, action="kill_controller"),
            FaultEvent(at_tick=45, action="restart_controller"),
            FaultEvent(at_tick=95, action="stale_verb"),
        ),
        hedge=False,            # scheduled deployment — scorer owns placement
        durable=True,
        client_retry=True,
        deadline_s=30.0,
        max_attempts=8,
        slo_ms=5000.0,
        invariants=(
            "zero_failed_idempotent",
            "chip_accounting_exact",
            "no_stuck_futures",
            "bounded_queues",
            "no_duplicate_placements",
            "replicas_adopted",
            "epoch_fencing_observed",
        ),
        recovery_tail=60,
        recovery_factor=6.0,
    )
)


# The scale-out routing-tier capacity scenario (and the workload under
# the router_scaling bench): hundreds of simulated mesh hosts in the
# published table, a large local replica pool, and offered load far
# over what ONE router's inflight cap can admit. Goodput is therefore
# capacity-bound per router — adding routers adds admitted goodput
# near-linearly until the offered load is fully served. The stream is
# best-effort (strict=False): shed-at-the-router is the designed
# behavior for the over-subscribed legs, so ok/shed normalize to
# "absorbed" and the raw served count rides in result["routers"].
FLEET_SCALE = _register(
    Scenario(
        name="fleet_scale",
        description=(
            "fleet-scale routing-table fan-out: offered load beyond one "
            "router's admission capacity; goodput scales with routers"
        ),
        ticks=40,
        tick_s=0.015,
        health_every=1000,       # one pass at tick 0 — no churn to heal
        n_hosts=0,
        n_replicas=160,
        sim_hosts=320,
        max_ongoing=16,
        service_s=0.05,
        n_routers=4,
        router_max_inflight=8,
        router_sync_every=2,
        router_staleness_bound_s=1.0,
        streams=(Stream(name="fleet", strict=False, base=24,
                        deadline_s=5.0),),
        hedge=False,             # capacity probe — no duplicate attempts
        deadline_s=5.0,
        slo_ms=5000.0,
        invariants=(
            "no_stuck_futures",
            "bounded_queues",
            "router_staleness_bounded",
        ),
    )
)


# The router-loss acceptance scenario: three routers, one SIGKILL'd
# mid-traffic. In-flight requests on the dead router finish (kill only
# closes admission); new arrivals that land on it get the typed
# RouterClosedError and hop to a sibling — zero idempotent loss, and
# the surviving routers' table staleness stays bounded throughout.
ROUTER_LOSS = _register(
    Scenario(
        name="router_loss",
        description=(
            "SIGKILL one of three routers mid-traffic; clients fail "
            "over to siblings typed, zero idempotent loss"
        ),
        ticks=80,
        tick_s=0.015,
        health_every=4,
        n_hosts=0,
        n_replicas=6,
        max_ongoing=16,
        service_s=0.01,
        n_routers=3,
        router_sync_every=2,
        router_staleness_bound_s=1.0,
        streams=(Stream(base=3),),
        hedge=False,
        fault_script=(
            FaultEvent(at_tick=30, action="kill_router", host="r1"),
        ),
        slo_ms=1000.0,
        invariants=(
            "zero_failed_idempotent",
            "no_stuck_futures",
            "bounded_queues",
            "router_failover_observed",
            "router_staleness_bounded",
        ),
    )
)


# The token-streaming acceptance scenario: interactive generations
# arrive every tick while bursts of long bulk generations co-batch with
# them in the replicas' step-level decode loops — the interactive
# reserve keeps the bulk burst from occupying the whole batch, so
# variable-length co-batching never starves short streams. Mid-run one
# host is SIGKILL-equivalently severed while generations are in flight:
# idempotent streams resume on the surviving replica with
# ``resume_from`` (greedy regeneration skips the already-delivered
# prefix), the client verifies EVERY token against the deterministic
# backend mirror, and the lease/liveness universals prove nothing
# leaked. hedge=False: a generation is a stateful stream — duplicate
# attempts would double-decode, resume is the failover mechanism.
TOKEN_STREAMING = _register(
    Scenario(
        name="token_streaming",
        description=(
            "token streaming under a long-generation burst + host kill "
            "mid-generation: step-level co-batching, interactive never "
            "starved, killed streams resume idempotently"
        ),
        ticks=90,
        tick_s=0.02,
        health_every=3,
        n_hosts=2,
        n_replicas=2,
        chips_per_replica=2,
        max_ongoing=32,
        service_s=0.004,          # decode step time (see _SOURCE)
        decode_max_active=6,
        streams=(
            Stream(name="interactive", priority="interactive",
                   streaming=True, gen_tokens=6, gen_spread=4, base=1,
                   deadline_s=15.0),
            Stream(name="bulk", priority="bulk", streaming=True,
                   gen_tokens=80, base=0, kind="burst", burst_every=20,
                   burst_size=3, start_tick=20, end_tick=70,
                   deadline_s=25.0),
        ),
        fault_script=(
            FaultEvent(at_tick=45, action="kill_host", host="h1"),
        ),
        hedge=False,
        deadline_s=25.0,
        max_attempts=8,
        slo_ms=4000.0,
        slo_floor=0.85,
        invariants=(
            "zero_failed_idempotent",
            "chip_accounting_exact",
            "no_stuck_futures",
            "bounded_queues",
            "slo_attainment",
            "decode_cobatch_observed",
            "stream_resume_observed",
        ),
    )
)


def get_scenario(name: str) -> Scenario:
    try:
        return NAMED_SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario '{name}' "
            f"(known: {', '.join(sorted(NAMED_SCENARIOS))})"
        ) from None


def list_scenarios() -> list[dict]:
    return [
        {
            "name": s.name,
            "description": s.description,
            "ticks": s.ticks,
            "hosts": s.n_hosts,
            "replicas": s.n_replicas,
            "routers": s.n_routers,
            "scheduled": s.scheduling is not None,
            "faults": [
                {"tick": ev.at_tick, "action": ev.action, "host": ev.host}
                for ev in s.fault_script
            ],
            "invariants": list(s.invariants),
            "defended_invariants": list(s.defended_invariants),
        }
        for s in NAMED_SCENARIOS.values()
    ]


__all__ = [
    "FaultEvent",
    "NAMED_SCENARIOS",
    "Scenario",
    "Stream",
    "get_scenario",
    "list_scenarios",
    "outcome_signature",
    "run_scenario",
    "run_scenario_async",
]
