"""ServeController — deployment orchestration, health loop, autoscaling.

Replaces Ray Serve as used by the reference (serve.run per app with
autoscaling 1-10 replicas and health-check-driven restarts, ref
bioengine/apps/proxy_deployment.py:25-47, bioengine/apps/manager.py:
355-455). Differences by design:

- Load is measured at the controller (per-replica semaphore occupancy +
  queue depth), so the reference's "mimic request" workaround for the
  Serve autoscaler (proxy_deployment.py:405-442) has no equivalent —
  the signal is native.
- Replicas scale in whole units, each owning a fixed chip set leased
  from ClusterState; unplaceable replicas enqueue a pending workload,
  which is exactly what drives the provisioner's scale-up
  (cluster/provisioner.py check_scaling).
"""

from __future__ import annotations

import asyncio
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from bioengine_tpu_torch.cluster.state import ClusterState
from bioengine_tpu_torch.rpc.protocol import PROTO_EPOCH1, PROTO_MESH1
from bioengine_tpu_torch.serving.mesh_plan import (
    MeshConfig,
    MeshPlanError,
    plan_mesh,
)
from bioengine_tpu_torch.serving.outlier import OutlierConfig
from bioengine_tpu_torch.serving.mesh_replica import MeshReplica
from bioengine_tpu_torch.serving.remote import RemoteReplica
from bioengine_tpu_torch.serving.scheduler import (
    DeploymentScheduler,
    SchedulingConfig,
)
from bioengine_tpu_torch.serving.replica import (
    CHIP_SECONDS,
    ROUTABLE_STATES,
    Replica,
    ReplicaState,
)
from bioengine_tpu_torch.serving.router import (
    BREAKER_TRIPS,
    REQUEST_E2E,
    REQUEST_FAILOVERS,
    REQUEST_HEDGES,
    REQUEST_OUTCOMES,
    ROUTE_WAIT,
    DeploymentHandle,
    RequestOptions,
    RouterCore,
    RoutingTablePublisher,
    _min_defined,
)
from bioengine_tpu_torch.serving.slo import SLOConfig, SLOEngine
from bioengine_tpu_torch.serving.compile_tier import CompileCacheTier
from bioengine_tpu_torch.serving.journal import (
    ControlJournal,
    spec_from_dict,
    spec_to_dict,
)
from bioengine_tpu_torch.serving.warm_pool import WarmPool, WarmPoolConfig
from bioengine_tpu_torch.utils import flight, metrics, tracing
from bioengine_tpu_torch.utils.tasks import spawn_supervised
from bioengine_tpu_torch.utils.telemetry import (
    SERIES_NAMES,
    RegistrySampler,
    TelemetryStore,
)
from bioengine_tpu_torch.utils.logger import create_logger

# The request-path metric families (REQUEST_E2E, REQUEST_OUTCOMES,
# REQUEST_FAILOVERS, ROUTE_WAIT, BREAKER_TRIPS, REQUEST_HEDGES) moved to
# serving/router.py with the request path itself; they are re-imported
# above so existing `controller.REQUEST_*` references keep resolving.

# durable control plane (serving/journal.py): the fencing epoch this
# process serves under, and what the recovery reconcile did
CONTROLLER_EPOCH = metrics.gauge(
    "controller_epoch",
    "monotonic fencing epoch minted at controller start (journaled)",
)
RECONCILE_ADOPTED = metrics.counter(
    "reconcile_adopted_total",
    "replicas re-adopted in place from host inventory at recovery",
)
RECONCILE_REPLACED = metrics.counter(
    "reconcile_replaced_total",
    "replicas re-placed from journaled intent at recovery settle",
)
RECONCILE_DROPPED = metrics.counter(
    "reconcile_dropped_total",
    "host-reported replicas dropped at recovery (no matching intent)",
)

# host verbs that carry the controller epoch so hosts can fence a
# wedged-then-revived old controller (register_host carries it in its
# RESULT instead — the host learns the epoch there)
_EPOCH_STAMPED_VERBS = frozenset(
    {"start_replica", "drain_replica", "stop_replica"}
)


def _collect_controllers(instances: list) -> list:
    """Scrape-time gauges from live controllers: router queue depth,
    replica states, and chip-lease occupancy — the load features the
    autoscaler/scheduler consumes, now exported instead of thrown
    away after each health tick. Values aggregate across controllers
    (tests build several per process; one Prometheus series per label
    set must stay unique)."""
    depth_by_key: dict[tuple, int] = {}
    replicas_by_key: dict[tuple, int] = {}
    breaker_open = 0
    chips_total = 0
    chips_free = 0
    for c in instances:
        for (app_id, dep), depth in list(c._queue_depth.items()):
            key = (app_id, dep)
            depth_by_key[key] = depth_by_key.get(key, 0) + depth
        for app in list(c.apps.values()):
            for dep_name, replicas in list(app.replicas.items()):
                for r in list(replicas):
                    key = (app.app_id, dep_name, r.state.value)
                    replicas_by_key[key] = replicas_by_key.get(key, 0) + 1
        breaker_open += len(c._breaker_counts)
        chips_total += c.cluster_state.topology.n_chips
        chips_free += c.cluster_state.free_chips()
    out = [
        metrics.Sample(
            "serve_queue_depth",
            depth,
            {"app": app_id, "deployment": dep},
            help="requests currently inside DeploymentHandle.call",
        )
        for (app_id, dep), depth in depth_by_key.items()
    ]
    out.extend(
        metrics.Sample(
            "serve_replicas",
            n,
            {"app": app_id, "deployment": dep, "state": state},
            help="replicas by lifecycle state",
        )
        for (app_id, dep, state), n in replicas_by_key.items()
    )
    out.append(
        metrics.Sample(
            "breaker_open_replicas",
            breaker_open,
            help="replicas with a non-zero consecutive transport-failure count",
        )
    )
    out.append(
        metrics.Sample("chips_total", chips_total, help="chips on local hosts")
    )
    out.append(
        metrics.Sample(
            "chips_free", chips_free, help="unleased chips on local hosts"
        )
    )
    return out


_CONTROLLERS = metrics.InstanceSet("serve_controller", _collect_controllers)


@dataclass
class DeploymentSpec:
    name: str
    instance_factory: Callable[[], Any]
    num_replicas: int = 1
    min_replicas: int = 1
    max_replicas: int = 3
    chips_per_replica: int = 0
    max_ongoing_requests: int = 10
    autoscale: bool = True
    target_load: float = 0.7          # scale up above, down below half
    # artifact payload (manifest + sources + kwargs) for building this
    # deployment on a REMOTE worker host — set by AppBuilder; None means
    # the deployment can only be placed locally
    remote_payload: Optional[dict] = None
    # replica-side ContinuousBatcher knobs, surfaced from the manifest
    # (deployment_config.<dep>.batching) and injected into the instance
    # as ``bioengine_batch_config`` before async_init; None keeps the
    # instance's own defaults
    max_batch: Optional[int] = None
    max_wait_ms: Optional[float] = None
    # opt-in global scheduler (cross-replica batching + admission
    # control + predictive autoscaling); None keeps the per-request
    # router path
    scheduling: Optional[SchedulingConfig] = None
    # per-deployment service objectives (manifest slo: block) — the
    # controller's SLO engine evaluates burn rates against these; None
    # means untracked (no alerting, no budget accounting)
    slo: Optional[SLOConfig] = None
    # controller-managed standby replicas (manifest warm_pool: block):
    # pre-started out-of-rotation replicas that absorb scale-up and
    # preemption by PROMOTION instead of a cold start; None = no pool
    warm_pool: Optional[WarmPoolConfig] = None
    # multi-host mesh placement (manifest mesh: block): one logical
    # replica whose pipeline/dp/tp shards span several hosts' chip
    # leases (serving/mesh_plan.py) — the path for checkpoints bigger
    # than any single host's lease; None = single-host replicas
    mesh: Optional[MeshConfig] = None

    def batch_config(self) -> Optional[dict]:
        if self.max_batch is None and self.max_wait_ms is None:
            return None
        out: dict = {}
        if self.max_batch is not None:
            out["max_batch"] = int(self.max_batch)
        if self.max_wait_ms is not None:
            out["max_wait_ms"] = float(self.max_wait_ms)
        return out


@dataclass
class AppDeployment:
    app_id: str
    specs: dict[str, DeploymentSpec]
    replicas: dict[str, list[Replica]] = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)
    status: str = "DEPLOYING"         # DEPLOYING | RUNNING | UNHEALTHY | DEPLOY_FAILED | STOPPED
    # per-method ACL for cross-host route_call — same shape as the app
    # proxy's authorized_users (list = all methods, dict = per-method).
    # None means "no ACL recorded": route_call then admits admins only.
    acl: Any = None


class ServeController(RouterCore):
    def __init__(
        self,
        cluster_state: Optional[ClusterState] = None,
        health_check_period: float = 10.0,
        log_file: Optional[str] = None,
        breaker_threshold: Optional[int] = None,
        health_check_concurrency: int = 8,
        outlier_config: Optional[OutlierConfig] = None,
        control_dir: Optional[str] = None,
    ):
        self.cluster_state = cluster_state or ClusterState()
        self.health_check_period = health_check_period
        self.health_check_concurrency = health_check_concurrency
        self.apps: dict[str, AppDeployment] = {}
        self.logger = create_logger("serving", log_file=log_file)
        self._health_task: Optional[asyncio.Task] = None
        # the whole request path — breaker, outlier probation, replica
        # pick/wait, rr counters, queue depth, scheduler registry —
        # comes from RouterCore (serving/router.py), shared verbatim
        # with the standalone router tier
        self._init_router_core(
            breaker_threshold=breaker_threshold,
            outlier_config=outlier_config,
        )
        # versioned routing-table publication for the scale-out router
        # tier (served over serve-router.get_routing_table)
        self.router_publisher = RoutingTablePublisher(self)
        # warm pools, one per deployment that opted in via
        # DeploymentSpec.warm_pool; standbys live here, OUT of the
        # routing set, until a scale-up/preemption promotes them
        self._warm_pools: dict[tuple[str, str], WarmPool] = {}
        # controller-side shared compile-cache tier (served to worker
        # hosts over the compile_cache_* verbs once attach_rpc runs)
        self.compile_tier = CompileCacheTier()
        self._rpc_server = None            # set by attach_rpc (multi-host)
        self._router_admins: list[str] = []
        # telemetry history + SLO engine (the proactive half of the
        # observability plane): the store aggregates this process's
        # registry deltas plus telem1 pushes from worker hosts; the
        # engine evaluates burn rates on the same tick. Page-severity
        # firings auto-capture an incident bundle (rate-limited).
        self.telemetry = TelemetryStore()
        self._telem_sampler = RegistrySampler()
        self.slo = SLOEngine(
            self.telemetry, on_page=self._slo_page_hook, logger=self.logger
        )
        self.telemetry_interval_s = float(
            os.environ.get("BIOENGINE_TELEM_PUSH_S", "10")
        )
        self._telemetry_task: Optional[asyncio.Task] = None
        self.slo_bundles: deque = deque(maxlen=4)   # auto-captured artifacts
        self._slo_bundle_last: dict[tuple[str, str], float] = {}
        # ---- durable control plane (serving/journal.py) -----------------
        # intent journal + snapshot under control_dir /
        # BIOENGINE_CONTROL_DIR; None = memory-only (exactly the old
        # behavior). Every start MINTS a persisted monotonic epoch —
        # the fence hosts use to reject verbs from a revived old
        # controller — whether or not recover() is ever called.
        self.journal = (
            ControlJournal(control_dir)
            if control_dir
            else ControlJournal.from_env()
        )
        self._journal_state = None
        self.phase = "ACTIVE"              # ACTIVE | RECOVERING
        self.reconcile_report: Optional[dict] = None
        self._recover_deadline: Optional[float] = None
        # mesh shards reported by rejoining hosts, keyed by the mesh
        # replica id they belong to — a MeshReplica is rebuilt once
        # every stage has reported (serving/journal.py module docstring)
        self._pending_mesh_shards: dict[str, dict[int, dict]] = {}
        # complete-but-surplus meshes (intent already satisfied when
        # the last stage reported): their earlier stages were answered
        # "kept" before the surplus was knowable, so the settle sweep
        # must stop them host-side
        self._surplus_mesh_shards: dict[str, dict[int, dict]] = {}
        self.reconcile_grace_s = float(
            os.environ.get("BIOENGINE_RECONCILE_GRACE_S", "20")
        )
        if self.journal is not None:
            self._journal_state = self.journal.load()
            self.journal.snapshot_provider = self._journal_snapshot_state
            self.epoch = self.journal.mint_epoch()
        else:
            self.epoch = 1
        CONTROLLER_EPOCH.set(self.epoch)
        flight.record(
            "controller.epoch",
            epoch=self.epoch,
            journaled=self.journal is not None,
        )
        _CONTROLLERS.add(self)             # scrape-time serving gauges

    # ---- multi-host control plane -------------------------------------------

    def attach_rpc(self, server, admin_users: Optional[list[str]] = None) -> None:
        """Enable multi-host placement: registers the ``serve-router``
        service that (a) worker hosts join through (``register_host``)
        and (b) remote deployments route composition calls back through
        (``route_call`` — the cross-host analog of a Serve
        DeploymentHandle call, ref apps/builder.py:1474-1508)."""
        from bioengine_tpu_torch.utils.permissions import (
            check_method_permission,
            check_permissions,
            is_authorized,
        )

        self._rpc_server = server
        self._router_admins = list(admin_users or [])
        if not self._router_admins and self._journal_state is not None:
            # a restarted controller attached without explicit admins
            # restores the journaled bindings (worker restarts normally
            # pass their own list, which then re-journals below)
            self._router_admins = list(self._journal_state.admins)
        # the welcome handshake advertises the fencing epoch so a host
        # can spot a stale controller before exchanging any verbs
        server.epoch = self.epoch
        if self.journal is not None and self._router_admins:
            # via _journal_append: a full/readonly disk degrades
            # durability, never controller attach, and the folded
            # snapshot view keeps the RECOVERING flag accurate
            self._journal_append(
                "admins", {"admins": list(self._router_admins)}
            )

        async def route_call(
            app_id, deployment, method, args=None, kwargs=None, context=None
        ):
            # Same per-method ACL the front-door proxy enforces
            # (apps/proxy.py) — route_call must not be a side door.
            # Admins (incl. worker hosts holding the admin token, whose
            # composition handles route through here) always pass.
            if not is_authorized(context, self._router_admins):
                app = self.apps.get(app_id)
                acl = app.acl if app is not None else None
                check_method_permission(acl or [], method, context)
            handle = self.get_handle(app_id, deployment)
            return await handle.call(method, *(args or []), **(kwargs or {}))

        def register_host(
            host_id,
            service_id,
            topology,
            worker_tag=None,
            replicas=None,
            clock_skew_s=0.0,
            context=None,
        ):
            check_permissions(context, self._router_admins, "register_host")
            self.cluster_state.register_host(
                host_id, service_id, topology, worker_tag,
                clock_skew_s=clock_skew_s,
            )
            # reconcile a REJOINING host's still-warm replicas: each one
            # the controller still routes to this host is re-adopted
            # (service id + chip lease restored); anything already
            # re-placed elsewhere is returned for the host to discard
            drop_replicas = []
            for info in replicas or []:
                # two reconciliation paths: a warm replica the routing
                # set still knows (blip rejoin) is re-adopted in place;
                # during RECOVERY the routing set is empty, so a replica
                # matching journaled intent is adopted from the report
                # instead. Anything matching neither is dropped — the
                # journal is the intent of record.
                if self._readopt_replica(host_id, service_id, info):
                    continue
                if self._adopt_reported_replica(host_id, service_id, info):
                    continue
                if self.phase == "RECOVERING":
                    RECONCILE_DROPPED.inc()
                    if self.reconcile_report is not None:
                        self.reconcile_report["dropped"] += 1
                drop_replicas.append(info.get("replica_id"))
            self.logger.info(
                f"host '{host_id}' joined with "
                f"{topology.get('n_chips', 0)} chips ({service_id})"
                + (
                    f"; re-adopted {len(replicas or []) - len(drop_replicas)}"
                    f"/{len(replicas)} warm replicas"
                    if replicas
                    else ""
                )
            )
            if replicas:
                self._replicas_changed.set()
            flight.record(
                "host.join",
                host=host_id,
                service_id=service_id,
                chips=topology.get("n_chips", 0),
                warm_replicas=len(replicas or []),
                dropped=len(drop_replicas),
            )
            return {
                "host_id": host_id,
                "registered": True,
                "drop_replicas": drop_replicas,
                # the fencing epoch: the host records it and rejects
                # replica verbs stamped with anything lower
                "epoch": self.epoch,
            }

        def deregister_host(host_id, context=None):
            check_permissions(context, self._router_admins, "deregister_host")
            orphans = self.cluster_state.mark_host_dead(host_id)
            return {"host_id": host_id, "orphaned_replicas": orphans}

        def push_telemetry(host_id, snapshot, context=None):
            # capability telem1: worker hosts push periodic registry
            # deltas here. A push from THIS process (the in-process
            # multi-host harness shares one registry, which the local
            # sampler already covers) is dropped by source identity —
            # the same dedup rule flight.merge_records applies.
            check_permissions(context, self._router_admins, "push_telemetry")
            if (
                isinstance(snapshot, dict)
                and snapshot.get("source_id") == self._telem_sampler.source_id
            ):
                return {"host_id": host_id, "accepted": 0, "deduped": True}
            # de-skew: captured_at is the PUSHER's wall clock — shift it
            # onto the controller's timeline with the offset the host
            # measured at its handshake, or a fast host's future-dated
            # buckets would swallow every on-time sample behind them
            record = self.cluster_state.hosts.get(host_id)
            if (
                record is not None
                and record.clock_skew_s
                and isinstance(snapshot, dict)
                and snapshot.get("captured_at") is not None
            ):
                snapshot = {
                    **snapshot,
                    "captured_at": float(snapshot["captured_at"])
                    - record.clock_skew_s,
                }
            accepted = self.telemetry.ingest(snapshot, host_id=host_id)
            return {"host_id": host_id, "accepted": accepted}

        def compile_cache_list(context=None):
            check_permissions(context, self._router_admins, "compile_cache_list")
            return self.compile_tier.list()

        def compile_cache_fetch(name, context=None):
            # bulk bytes ride the zero-copy OOB transport frame on the
            # way back; None = tier miss (the host compiles as usual)
            check_permissions(
                context, self._router_admins, "compile_cache_fetch"
            )
            return self.compile_tier.fetch(name)

        def compile_cache_publish(name, blob, context=None):
            check_permissions(
                context, self._router_admins, "compile_cache_publish"
            )
            return {"name": name, "stored": self.compile_tier.publish(name, blob)}

        def get_routing_table(
            router_id=None, since_version=0, staleness_s=None, context=None
        ):
            # the scale-out router tier syncs its epoch-stamped table
            # here (serving/router.py StandaloneRouter.sync_once);
            # admin-gated like the other control verbs — a router holds
            # the same token a worker host does
            check_permissions(
                context, self._router_admins, "get_routing_table"
            )
            return self.router_publisher.table(
                since_version=int(since_version or 0),
                router_id=router_id,
                staleness_s=staleness_s,
            )

        server.register_local_service(
            {
                "id": "serve-router",
                "name": "Serving controller router",
                "type": "bioengine-serve-router",
                # public visibility: every method self-enforces
                # (register/deregister_host require admin; route_call
                # enforces the target app's per-method ACL above)
                "config": {"require_context": True, "visibility": "public"},
                "route_call": route_call,
                "register_host": register_host,
                "deregister_host": deregister_host,
                "push_telemetry": push_telemetry,
                "compile_cache_list": compile_cache_list,
                "compile_cache_fetch": compile_cache_fetch,
                "compile_cache_publish": compile_cache_publish,
                "get_routing_table": get_routing_table,
            }
        )

    async def _call_host(
        self,
        service_id: str,
        method: str,
        *args,
        rpc_timeout: Optional[float] = None,
        **kwargs,
    ):
        if self._rpc_server is None:
            raise RuntimeError("controller has no RPC server attached")
        if method in _EPOCH_STAMPED_VERBS and self._rpc_server.service_peer_supports(
            service_id, PROTO_EPOCH1
        ):
            # every placement/lifecycle verb carries this controller's
            # epoch; a host that has seen a newer one rejects it typed
            # (StaleEpochError) — the split-brain fence. A pre-epoch1
            # host never declared the capability, so it gets the legacy
            # signature (and no fence) instead of an unexpected-kwarg
            # TypeError on every placement
            kwargs.setdefault("epoch", self.epoch)
        return await self._rpc_server.call_service_method(
            service_id, method, args, kwargs,
            **({"timeout": rpc_timeout} if rpc_timeout else {}),
        )

    async def _stream_host(self, service_id: str, method: str, *args, **kwargs):
        """Streaming twin of :meth:`_call_host`: bridges a host's
        async-generator verb (``replica_stream``) through the RPC
        server's stream1 plane, yielding items as their frames land."""
        if self._rpc_server is None:
            raise RuntimeError("controller has no RPC server attached")
        async for item in self._rpc_server.call_service_stream(
            service_id, method, args, kwargs
        ):
            yield item

    # ---- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        if self._health_task is None:
            self._health_task = asyncio.create_task(self._health_loop())
        if self._telemetry_task is None:
            self._telemetry_task = asyncio.create_task(self._telemetry_loop())

    async def stop(self) -> None:
        if self._health_task:
            self._health_task.cancel()
            self._health_task = None
        if self._telemetry_task:
            self._telemetry_task.cancel()
            self._telemetry_task = None
        for app_id in list(self.apps):
            await self.undeploy(app_id)

    async def _telemetry_loop(self) -> None:
        while True:
            try:
                await asyncio.sleep(self.telemetry_interval_s)
                self.telemetry_tick()
            except asyncio.CancelledError:
                return
            except Exception as e:  # noqa: BLE001 — the loop must survive
                self.logger.error(f"telemetry tick error: {e}")

    def telemetry_tick(self) -> None:
        """One observation pass: fold this process's registry deltas
        into the telemetry store, then run the SLO/anomaly evaluation.
        The periodic loop calls this; tests and the CI dryrun drive it
        directly for determinism."""
        snapshot = self._telem_sampler.sample()
        if snapshot:
            self.telemetry.ingest(snapshot, host_id="controller")
        # SLO verdicts are deferred while RECOVERING: burn rates
        # computed over a half-seen cluster would fire (and feed scale
        # pressure) on recovery noise, not service behavior
        if self.slo.deployments() and self.phase != "RECOVERING":
            self.slo.evaluate()

    # ---- deploy / undeploy --------------------------------------------------

    async def deploy(
        self, app_id: str, specs: list[DeploymentSpec], acl: Any = None
    ) -> AppDeployment:
        existing = self.apps.get(app_id)
        if existing is not None:
            if existing.status in ("DEPLOY_FAILED", "STOPPED"):
                del self.apps[app_id]  # failed attempt may be retried
            else:
                raise ValueError(f"app '{app_id}' already deployed")
        app = AppDeployment(
            app_id=app_id, specs={s.name: s for s in specs}, acl=acl
        )
        self.apps[app_id] = app
        # intent commit: the deploy is ACCEPTED (validated specs, app
        # registered) — journal it now so a crash mid-placement recovers
        # to "place this app", never to silence. Placement failures roll
        # the record back below.
        self._journal_append(
            "deploy",
            {
                "app_id": app_id,
                "specs": [spec_to_dict(s) for s in specs],
                "acl": acl,
            },
        )
        try:
            for spec in specs:
                app.replicas[spec.name] = []
                self._init_deployment_plumbing(app_id, spec)
                for _ in range(spec.num_replicas):
                    await self._add_replica(app, spec)
            # pools fill AFTER every serving replica is placed — a tight
            # cluster spends its chips on the routing set first
            for spec in specs:
                if (app_id, spec.name) in self._warm_pools:
                    await self._top_up_warm_pool(app, spec)
            app.status = "RUNNING"
            self.logger.info(f"app '{app_id}' deployed")
        except Exception:
            # Roll back partial state: stop started replicas and release
            # their chip leases so a failed deploy leaks nothing.
            app.status = "DEPLOY_FAILED"
            # the intent did not commit — a recovering controller must
            # not resurrect a deploy that never finished
            self._journal_append("undeploy", {"app_id": app_id})
            self.slo.unregister(app_id)
            for spec in specs:
                sched = self._schedulers.pop((app_id, spec.name), None)
                if sched is not None:
                    await sched.close()
                pool = self._warm_pools.pop((app_id, spec.name), None)
                if pool is not None:
                    for r in pool.drain_all():
                        try:
                            await r.stop()
                        finally:
                            self.cluster_state.mark_replica_dead(r.replica_id)
            for replicas in app.replicas.values():
                for r in replicas:
                    try:
                        await r.stop()
                    finally:
                        self.cluster_state.mark_replica_dead(r.replica_id)
            raise
        return app

    def _init_deployment_plumbing(self, app_id: str, spec: DeploymentSpec) -> None:
        """Per-deployment controller plumbing shared by ``deploy`` and
        journal recovery: the opt-in global scheduler, SLO tracking,
        and the warm pool shell (pools FILL later — after serving
        replicas, or after reconcile settles)."""
        if spec.scheduling is not None and spec.scheduling.enabled:
            scheduler = DeploymentScheduler(
                self,
                app_id,
                spec.name,
                spec,
                spec.scheduling,
                scorer=self.scorer_factory(),
            )
            self._schedulers[(app_id, spec.name)] = scheduler
            if spec.scheduling.slo_pressure and spec.slo is not None:
                # close the loop: the predictive autoscaler may
                # consume budget burn as an up-pressure signal
                # (opt-in — scheduling.slo_pressure)
                scheduler.pressure_fn = (
                    lambda a=app_id, d=spec.name: self.slo.burn_pressure(a, d)
                )
        if spec.slo is not None:
            self.slo.register(app_id, spec.name, spec.slo)
        if spec.warm_pool is not None and spec.warm_pool.size > 0:
            self._warm_pools[(app_id, spec.name)] = WarmPool(
                app_id, spec.name, spec.warm_pool
            )

    # ---- durable control plane: journal + crash recovery --------------------

    def _journal_snapshot_state(self) -> tuple:
        """Lazy snapshot provider: the journal pulls the folded intent
        only when a compaction actually fires (1-in-snapshot_every
        appends, plus the explicit recover/settle snapshots) — a plain
        append never pays the full-fleet spec serialization."""
        apps = {
            app_id: {
                "specs": [spec_to_dict(s) for s in app.specs.values()],
                "acl": app.acl,
            }
            for app_id, app in self.apps.items()
            if app.status not in ("STOPPED", "DEPLOY_FAILED")
        }
        return apps, self._router_admins, self.phase == "RECOVERING"

    def _journal_append(self, op: str, data: dict) -> None:
        if self.journal is None:
            return
        try:
            self.journal.append(op, data)
        except OSError as e:
            # a full/readonly disk must degrade durability, not serving
            self.logger.error(f"journal append failed ({op}): {e}")

    async def recover(self) -> dict:
        """Rebuild declarative intent from snapshot + journal into a
        ``RECOVERING`` phase: apps exist with their full specs (so
        routing, handles and new deploys work) but with EMPTY replica
        sets. Live hosts rejoin with their warm-replica inventory and
        :meth:`_adopt_reported_replica` re-adopts matching replicas in
        place; after ``BIOENGINE_RECONCILE_GRACE_S`` (or once every
        intent is satisfied) the health loop settles the diff —
        re-placing only what no host still serves — and flips the
        phase to ``ACTIVE``. Until then autoscale and SLO verdicts are
        DEFERRED: a half-seen cluster must not be "scaled down"."""
        if self.journal is None:
            raise RuntimeError(
                "recovery needs a control journal "
                "(control_dir= or BIOENGINE_CONTROL_DIR)"
            )
        state = self._journal_state or self.journal.load()
        report = {
            "epoch": self.epoch,
            "apps": 0,
            "adopted": 0,
            "replaced": 0,
            "dropped": 0,
            "mesh_rebuilt": 0,
            "torn_tail": state.torn_tail,
            "started_at": time.time(),
            "settled_at": None,
        }
        self.reconcile_report = report
        self._recover_started_mono = time.monotonic()
        if state.admins and not self._router_admins:
            self._router_admins = list(state.admins)
        for app_id, entry in state.apps.items():
            if app_id in self.apps:
                continue  # double recover() is a no-op per app
            specs = [
                spec_from_dict(
                    sd,
                    app_id,
                    make_handle=lambda name, a=app_id: self.get_handle(
                        a, name
                    ),
                )
                for sd in entry.get("specs", [])
            ]
            app = AppDeployment(
                app_id=app_id,
                specs={s.name: s for s in specs},
                acl=entry.get("acl"),
            )
            app.status = "RECOVERING"
            self.apps[app_id] = app
            for spec in specs:
                app.replicas[spec.name] = []
                self._init_deployment_plumbing(app_id, spec)
            report["apps"] += 1
        if report["apps"]:
            self.phase = "RECOVERING"
            self._recover_deadline = (
                time.monotonic() + self.reconcile_grace_s
            )
            self._wake_health.set()
        flight.record(
            "controller.recovering",
            severity="warning",
            epoch=self.epoch,
            apps=report["apps"],
            records_replayed=state.records_replayed,
            torn_tail=state.torn_tail,
            snapshot=state.snapshot_loaded,
        )
        self.logger.info(
            f"recovered intent for {report['apps']} app(s) from "
            f"{self.journal.directory} (epoch {self.epoch}, "
            f"{state.records_replayed} journal records"
            + (", TORN TAIL discarded" if state.torn_tail else "")
            + "); reconciling against host inventory"
        )
        # compact NOW, flagged recovering=True via the snapshot
        # provider (phase is RECOVERING here): a double-crash recovers
        # from this snapshot (the "snapshot written by a recovering
        # controller" edge case the tests pin)
        try:
            self.journal.write_snapshot()
        except OSError as e:
            self.logger.error(f"recovery snapshot failed: {e}")
        return report

    def adopt_recovered_specs(
        self, app_id: str, specs: list, acl: Any = None
    ) -> bool:
        """Re-attach a freshly BUILT app to its journal-recovered
        intent instead of re-deploying it. The apps manager's own
        record recovery redeploys every recorded app at worker start;
        when the control journal already resurrected the controller
        half (status ``RECOVERING``), a second ``deploy`` would be
        rejected as a duplicate — instead the recovered specs take the
        build's LIVE instance factories (so local placements stop
        paying the payload rebuild) and reconcile proceeds untouched.
        Returns False when the app is not in journal recovery (caller
        should deploy normally)."""
        app = self.apps.get(app_id)
        if app is None or app.status != "RECOVERING":
            return False
        for spec in specs:
            current = app.specs.get(spec.name)
            if current is None:
                # deployment added since the journal record: place it
                # like a deploy would, but through the reconcile path
                app.specs[spec.name] = spec
                app.replicas.setdefault(spec.name, [])
                self._init_deployment_plumbing(app_id, spec)
            else:
                # keep the recovered spec OBJECT (schedulers and warm
                # pools hold references to it) — swap in the live build
                current.instance_factory = spec.instance_factory
                current.remote_payload = spec.remote_payload
        if acl is not None:
            app.acl = acl
        self.logger.info(
            f"app '{app_id}' re-attached to journal-recovered intent "
            f"({len(specs)} spec(s))"
        )
        return True

    def _adopt_reported_replica(
        self, host_id: str, service_id: str, info: dict
    ) -> bool:
        """RECOVERY adoption: a rejoining host reports a warm replica
        the (restarted) controller's routing set does not know. If
        journaled intent covers it — app recovered, deployment spec
        present, replica count under the intent — adopt it IN PLACE:
        same replica_id, chips re-leased via ``host_adopt_chips``, no
        restart. Mesh shards buffer until every stage reports, then a
        MeshReplica is rebuilt around them. Anything else returns
        False and the host is told to drop its copy."""
        app = self.apps.get(info.get("app_id", ""))
        if app is None or app.status != "RECOVERING":
            return False
        dep = info.get("deployment", "")
        spec = app.specs.get(dep)
        if spec is None:
            return False
        rid = info.get("replica_id") or ""
        if info.get("mesh_shard"):
            return self._adopt_mesh_shard(
                app, spec, host_id, service_id, info
            )
        existing = app.replicas.setdefault(dep, [])
        for r in existing:
            if r.replica_id != rid:
                continue
            # idempotent re-report (host re-registered twice). This
            # branch is only reached when _readopt_replica declined —
            # wrong host, non-routable state, or a lease conflict —
            # so "keep" must re-establish the lease on the freshly
            # reset HostRecord, not just wave the copy through.
            if getattr(r, "host_id", None) != host_id:
                return False  # duplicate id reported by the wrong host
            try:
                self.cluster_state.host_adopt_chips(
                    host_id, rid, list(info.get("device_ids") or [])
                )
            except Exception as e:  # noqa: BLE001 — lease conflict = drop
                self.logger.warning(
                    f"cannot re-lease re-reported {rid} on "
                    f"'{host_id}': {e}"
                )
                return False
            return True
        if len(existing) >= spec.num_replicas:
            return False  # intent already satisfied — surplus copy
        try:
            reported = ReplicaState(info.get("state", ""))
        except ValueError:
            return False
        if reported not in ROUTABLE_STATES + (ReplicaState.INITIALIZING,):
            return False
        device_ids = list(info.get("device_ids") or [])
        try:
            self.cluster_state.host_adopt_chips(host_id, rid, device_ids)
        except Exception as e:  # noqa: BLE001 — lease conflict = don't adopt
            self.logger.warning(
                f"recovery cannot adopt {rid} on '{host_id}': {e}"
            )
            return False
        replica = RemoteReplica(
            app_id=app.app_id,
            deployment_name=dep,
            host_id=host_id,
            host_service_id=service_id,
            call_host=self._call_host,
            stream_host=self._stream_host,
            payload=spec.remote_payload or {},
            device_ids=device_ids,
            max_ongoing_requests=spec.max_ongoing_requests,
            log_sink=self.cluster_state.append_replica_log,
        )
        replica.replica_id = rid  # the host's copy IS the identity
        replica.state = reported
        self.cluster_state.register_replica(
            app.app_id, dep, rid, device_ids, host_id=host_id
        )
        existing.append(replica)
        self._replicas_changed.set()
        RECONCILE_ADOPTED.inc()
        if self.reconcile_report is not None:
            self.reconcile_report["adopted"] += 1
        self.logger.info(
            f"recovery adopted {rid} on '{host_id}' "
            f"({app.app_id}/{dep}, state={reported.value})"
        )
        flight.record(
            "replica.readopt",
            replica=rid,
            app=app.app_id,
            host=host_id,
            state=reported.value,
            recovery=True,
        )
        return True

    def _adopt_mesh_shard(
        self, app: AppDeployment, spec: DeploymentSpec,
        host_id: str, service_id: str, info: dict,
    ) -> bool:
        """Buffer one reported mesh shard; once all ``spec.mesh.stages``
        stages have reported, rebuild the MeshReplica around them (same
        mesh replica id, shard chips re-leased under it, no shard
        restarts). Incomplete meshes left at settle are swept — the
        orphan shards stopped and the mesh re-placed from spec."""
        if spec.mesh is None:
            return False
        from bioengine_tpu_torch.serving.mesh_plan import MeshPlan, ShardAssignment

        shard_info = info.get("mesh_shard") or {}
        rid = info.get("replica_id") or ""
        mesh_rid = shard_info.get("mesh_replica_id") or (
            rid.rsplit("-s", 1)[0] if "-s" in rid else ""
        )
        try:
            stage = int(shard_info.get("stage", -1))
        except (TypeError, ValueError):
            return False
        if not mesh_rid or stage < 0 or stage >= spec.mesh.stages:
            return False
        dep = spec.name
        existing = app.replicas.setdefault(dep, [])
        if any(r.replica_id == mesh_rid for r in existing):
            # mesh already rebuilt; this shard belongs to it — but the
            # re-register reset this host's lease table, so the chips
            # must be re-leased under the mesh id or the ledger shows
            # them free and a later placement double-leases the devices
            try:
                self.cluster_state.host_adopt_chips(
                    host_id, mesh_rid, list(info.get("device_ids") or [])
                )
            except Exception as e:  # noqa: BLE001 — lease conflict = drop
                self.logger.warning(
                    f"cannot re-lease shard {rid} of rebuilt mesh "
                    f"{mesh_rid} on '{host_id}': {e}"
                )
                return False
            return True
        pending = self._pending_mesh_shards.setdefault(mesh_rid, {})
        pending[stage] = {
            "host_id": host_id,
            "service_id": service_id,
            "device_ids": list(info.get("device_ids") or []),
            "state": info.get("state"),
            "app_id": app.app_id,
            "deployment": dep,
        }
        if len(pending) < spec.mesh.stages:
            return True  # keep the shard; siblings may still report
        if len(existing) >= spec.num_replicas:
            # surplus mesh: THIS reporter is told to drop its shard,
            # but the sibling stages were already answered "kept" —
            # park them for the settle sweep to stop host-side, else
            # they'd serve unrouted and hold chip leases forever
            self._pending_mesh_shards.pop(mesh_rid, None)
            pending.pop(stage, None)
            if pending:
                # handoff, not a leak: _reconcile_settle stops these
                # shards host-side and clear()s the whole map when the
                # recovery grace window closes
                # bioengine: ignore[BE-LIFE-401]
                self._surplus_mesh_shards[mesh_rid] = pending
            return False
        shards = [
            ShardAssignment(
                stage=s,
                host_id=sh["host_id"],
                service_id=sh["service_id"],
                n_chips=len(sh["device_ids"]),
                device_ids=list(sh["device_ids"]),
            )
            for s, sh in sorted(pending.items())
        ]
        try:
            for sh in shards:
                self.cluster_state.host_adopt_chips(
                    sh.host_id, mesh_rid, sh.device_ids
                )
        except Exception as e:  # noqa: BLE001 — lease conflict = don't adopt
            self.logger.warning(
                f"recovery cannot adopt mesh {mesh_rid}: {e}"
            )
            self.cluster_state.release_chips(mesh_rid)
            return False
        replica = MeshReplica(
            app_id=app.app_id,
            deployment_name=dep,
            plan=MeshPlan(config=spec.mesh, shards=shards),
            call_host=self._call_host,
            payload=spec.remote_payload or {},
            max_ongoing_requests=spec.max_ongoing_requests,
            log_sink=self.cluster_state.append_replica_log,
            stream_host=self._stream_host,
        )
        replica.replica_id = mesh_rid
        replica.state = ReplicaState.HEALTHY
        self.cluster_state.register_replica(
            app.app_id, dep, mesh_rid, replica.device_ids,
            host_id=replica.host_id,
        )
        existing.append(replica)
        self._pending_mesh_shards.pop(mesh_rid, None)
        self._replicas_changed.set()
        RECONCILE_ADOPTED.inc()
        if self.reconcile_report is not None:
            self.reconcile_report["adopted"] += 1
            self.reconcile_report["mesh_rebuilt"] += 1
        self.logger.info(
            f"recovery rebuilt mesh {mesh_rid} over "
            f"{[s.host_id for s in shards]} ({app.app_id}/{dep})"
        )
        flight.record(
            "replica.readopt",
            replica=mesh_rid,
            app=app.app_id,
            host=replica.host_id,
            state=replica.state.value,
            recovery=True,
            mesh=True,
        )
        return True

    def _reconcile_satisfied(self) -> bool:
        for app in self.apps.values():
            if app.status != "RECOVERING":
                continue
            for name, spec in app.specs.items():
                if len(app.replicas.get(name, [])) < spec.num_replicas:
                    return False
        return not self._pending_mesh_shards

    async def _reconcile_tick(self) -> None:
        """RECOVERING-phase health tick: wait for hosts to rejoin and
        report; settle once every intent is satisfied or the grace
        window closes."""
        if not self._reconcile_satisfied():
            if (
                self._recover_deadline is None
                or time.monotonic() < self._recover_deadline
            ):
                return
        await self._reconcile_settle()

    async def _reconcile_settle(self) -> None:
        report = self.reconcile_report or {}
        # sweep incomplete mesh rebuilds (a sibling stage's host never
        # came back) AND complete-but-surplus meshes (intent already
        # satisfied; their early stages were answered "kept" before the
        # surplus was knowable): stop the shards host-side and let the
        # normal placement path re-place whatever the diff still needs
        orphan_meshes = {
            **self._pending_mesh_shards,
            **self._surplus_mesh_shards,
        }
        for mesh_rid, pending in orphan_meshes.items():
            for stage, sh in pending.items():
                try:
                    await self._call_host(
                        sh["service_id"], "stop_replica",
                        f"{mesh_rid}-s{stage}",
                    )
                except Exception as e:  # noqa: BLE001 — host may be gone
                    self.logger.debug(
                        f"orphan shard stop failed (tolerated): {e}"
                    )
            report["dropped"] = report.get("dropped", 0) + 1
            RECONCILE_DROPPED.inc()
        self._pending_mesh_shards.clear()
        self._surplus_mesh_shards.clear()
        # re-place only the DIFF: what no surviving host still serves
        for app in list(self.apps.values()):
            if app.status != "RECOVERING":
                continue
            for name, spec in app.specs.items():
                while (
                    len(app.replicas.get(name, [])) < spec.num_replicas
                ):
                    try:
                        await self._add_replica(app, spec)
                    except Exception as e:  # noqa: BLE001 — capacity may come later
                        self.logger.warning(
                            f"recovery re-place blocked for "
                            f"{app.app_id}/{name}: {e}"
                        )
                        break
                    report["replaced"] = report.get("replaced", 0) + 1
                    RECONCILE_REPLACED.inc()
            app.status = "RUNNING"
            for name, spec in app.specs.items():
                if (app.app_id, name) in self._warm_pools:
                    spawn_supervised(
                        self._top_up_warm_pool(app, spec),
                        name=f"recover-warmpool-{app.app_id}-{name}",
                        logger=self.logger,
                    )
        self.phase = "ACTIVE"
        self._recover_deadline = None
        report["settled_at"] = time.time()
        self._replicas_changed.set()
        # the settled state is the new baseline snapshot (the provider
        # reports recovering=False now that the phase is ACTIVE)
        if self.journal is not None:
            try:
                self.journal.write_snapshot()
            except OSError as e:
                self.logger.error(f"settle snapshot failed: {e}")
        flight.record(
            "controller.recovered",
            epoch=self.epoch,
            adopted=report.get("adopted", 0),
            replaced=report.get("replaced", 0),
            dropped=report.get("dropped", 0),
            mesh_rebuilt=report.get("mesh_rebuilt", 0),
            duration_s=round(
                time.monotonic()
                - getattr(self, "_recover_started_mono", time.monotonic()),
                3,
            ),
        )
        self.logger.info(
            f"reconcile settled: adopted={report.get('adopted', 0)} "
            f"replaced={report.get('replaced', 0)} "
            f"dropped={report.get('dropped', 0)} "
            f"mesh_rebuilt={report.get('mesh_rebuilt', 0)} "
            f"(epoch {self.epoch})"
        )

    async def _add_replica(
        self,
        app: AppDeployment,
        spec: DeploymentSpec,
        avoid_hosts: Any = (),
    ):
        """Place one replica: locally when this host has the chips, else
        on a joined worker host with capacity (RPC-backed RemoteReplica),
        else enqueue a pending workload for the provisioner.
        ``avoid_hosts`` steers a mesh re-plan around hosts the replaced
        replica degraded on (dead hosts are excluded anyway; this
        covers alive-but-faulty ones)."""
        from bioengine_tpu_torch.utils.tracing import span

        with span(
            "add_replica", app_id=app.app_id, deployment=spec.name,
            chips=spec.chips_per_replica,
        ):
            return await self._add_replica_inner(
                app, spec, avoid_hosts=avoid_hosts
            )

    async def _add_replica_inner(
        self,
        app: AppDeployment,
        spec: DeploymentSpec,
        avoid_hosts: Any = (),
    ):
        # warm-pool fast path: a scale-up or preemption restart PROMOTES
        # a pre-started standby (instance built, weights resident,
        # programs warm) instead of paying the cold start — the pool
        # refills itself in the background
        pool = self._warm_pools.get((app.app_id, spec.name))
        if pool is not None:
            dead_hosts = {
                h.host_id
                for h in self.cluster_state.hosts.values()
                if not h.alive
            }
            promoted = pool.pop_routable(skip_hosts=dead_hosts)
            if promoted is not None:
                app.replicas[spec.name].append(promoted)
                self.cluster_state.remove_pending(f"{app.app_id}/{spec.name}")
                self._replicas_changed.set()
                self.logger.info(
                    f"promoted warm standby {promoted.replica_id} for "
                    f"{app.app_id}/{spec.name} "
                    f"(pool occupancy {len(pool.standbys)})"
                )
                flight.record(
                    "replica.place",
                    replica=promoted.replica_id,
                    app=app.app_id,
                    deployment=spec.name,
                    host=getattr(promoted, "host_id", None),
                    device_ids=list(promoted.device_ids),
                    warm_pool=True,
                )
                if pool.config.refill:
                    spawn_supervised(
                        self._top_up_warm_pool(app, spec),
                        name=f"warmpool-refill-{app.app_id}-{spec.name}",
                        logger=self.logger,
                    )
                return promoted
        replica = await self._place_new_replica(
            app, spec, avoid_hosts=avoid_hosts
        )
        app.replicas[spec.name].append(replica)
        self.cluster_state.remove_pending(f"{app.app_id}/{spec.name}")
        self._replicas_changed.set()  # wake requests parked in _pick_replica_wait
        flight.record(
            "replica.place",
            replica=replica.replica_id,
            app=app.app_id,
            deployment=spec.name,
            host=getattr(replica, "host_id", None),
            device_ids=list(replica.device_ids),
        )
        return replica

    async def _place_new_replica(
        self,
        app: AppDeployment,
        spec: DeploymentSpec,
        pending_on_fail: bool = True,
        record_failed: bool = True,
        avoid_hosts: Any = (),
    ):
        """Place and START one replica (local chips → joined host →
        pending workload) WITHOUT adding it to the routing set — shared
        by the serving path (_add_replica) and the warm-pool fill.
        ``record_failed`` keeps the legacy behavior of surfacing a
        start-failed replica in app.replicas (the health loop retires
        it); pool fills opt out — a failed standby just isn't a standby."""
        if spec.mesh is not None:
            return await self._place_mesh_replica(
                app, spec, pending_on_fail=pending_on_fail,
                record_failed=record_failed, avoid_hosts=avoid_hosts,
            )
        replica = None
        host_id = None
        if spec.chips_per_replica > 0 and (
            self.cluster_state.free_chips() < spec.chips_per_replica
        ):
            replica = self._make_remote_replica(app, spec)
            if replica is None:
                # No capacity anywhere: surface as pending workload so
                # the provisioner can scale out (ref manager.py:239-353's
                # SLURM headroom allowance).
                if pending_on_fail:
                    self.cluster_state.add_pending(
                        f"{app.app_id}/{spec.name}",
                        {"chips": spec.chips_per_replica},
                    )
                raise RuntimeError(
                    f"need {spec.chips_per_replica} chips for "
                    f"{app.app_id}/{spec.name}: none free locally or on "
                    f"any joined host"
                )
            host_id = replica.host_id
        if replica is None:
            replica = Replica(
                app_id=app.app_id,
                deployment_name=spec.name,
                instance_factory=spec.instance_factory,
                max_ongoing_requests=spec.max_ongoing_requests,
                log_sink=self.cluster_state.append_replica_log,
                batch_config=spec.batch_config(),
            )
            if spec.chips_per_replica > 0:
                replica.device_ids = self.cluster_state.acquire_chips(
                    replica.replica_id, spec.chips_per_replica
                )
        self.cluster_state.register_replica(
            app.app_id,
            spec.name,
            replica.replica_id,
            replica.device_ids,
            host_id=host_id,
        )
        try:
            await replica.start()
        except Exception:
            self.cluster_state.mark_replica_dead(replica.replica_id)
            if record_failed:
                app.replicas[spec.name].append(replica)
            raise
        return replica

    # ---- multi-host mesh placement ------------------------------------------

    def _mesh_capable_hosts(self) -> list:
        """Alive hosts whose connection declared the ``mesh1``
        capability at its handshake — a legacy host that cannot honor a
        ``mesh_shard`` start is never planned onto."""
        if self._rpc_server is None:
            return []
        return [
            h
            for h in self.cluster_state.hosts.values()
            if h.alive
            and self._rpc_server.service_peer_supports(
                h.service_id, PROTO_MESH1
            )
        ]

    async def _place_mesh_replica(
        self,
        app: AppDeployment,
        spec: DeploymentSpec,
        pending_on_fail: bool = True,
        record_failed: bool = True,
        avoid_hosts: Any = (),
    ):
        """Place one LOGICAL replica across several hosts' leases:
        plan (policy — serving/mesh_plan.py, scored through the same
        ``scorer_factory`` contract as scheduler placement), lease
        every shard's chips under the mesh replica's own id (so
        ``mark_replica_dead`` releases the whole mesh), then start the
        shards (execution — serving/mesh_replica.py). A restart after a
        host death lands here again and re-plans over the survivors —
        collapsing to a single-host fallback mesh when the config
        allows it."""
        if spec.remote_payload is None:
            raise MeshPlanError(
                f"{app.app_id}/{spec.name}: mesh placement needs a "
                f"remote payload (shards are built on worker hosts)"
            )
        try:
            plan = plan_mesh(
                spec.mesh,
                self._mesh_capable_hosts(),
                self.scorer_factory(),
                avoid_hosts=avoid_hosts,
            )
        except MeshPlanError as e:
            if pending_on_fail:
                # the provisioner's scale-up signal carries the chip
                # bill the PLANNER computed (the whole mesh, not one
                # host's slice — and a future partial-plan raise can
                # bill only the remainder)
                self.cluster_state.add_pending(
                    f"{app.app_id}/{spec.name}",
                    {"chips": e.chips_needed or spec.mesh.total_chips},
                )
            raise
        replica = MeshReplica(
            app_id=app.app_id,
            deployment_name=spec.name,
            plan=plan,
            call_host=self._call_host,
            payload=spec.remote_payload,
            max_ongoing_requests=spec.max_ongoing_requests,
            log_sink=self.cluster_state.append_replica_log,
            stream_host=self._stream_host,
        )
        for shard in plan.shards:
            shard.device_ids = self.cluster_state.host_acquire_chips(
                shard.host_id, replica.replica_id, shard.n_chips
            )
        replica.device_ids = [
            d for s in plan.shards for d in s.device_ids
        ]
        self.cluster_state.register_replica(
            app.app_id,
            spec.name,
            replica.replica_id,
            replica.device_ids,
            host_id=replica.host_id,
        )
        self.logger.info(
            f"placing {app.app_id}/{spec.name} as a "
            f"{spec.mesh.kind} x{spec.mesh.stages} mesh over "
            f"{plan.hosts} (chips {replica.device_ids})"
        )
        try:
            await replica.start()
        except Exception:
            # every shard lease rides the mesh replica id — one release
            self.cluster_state.mark_replica_dead(replica.replica_id)
            if record_failed:
                app.replicas[spec.name].append(replica)
            raise
        return replica

    # ---- warm pool ----------------------------------------------------------

    async def _top_up_warm_pool(
        self, app: AppDeployment, spec: DeploymentSpec
    ) -> None:
        """Fill the deployment's pool to its target size (config, or
        telemetry-grown toward max_size). Capacity shortfalls log and
        stop — a pool never queues pending workloads against the
        provisioner; serving replicas take that priority."""
        pool = self._warm_pools.get((app.app_id, spec.name))
        if pool is None:
            return
        target = pool.target_size(self.telemetry)
        # filling counts in-flight placements: a promotion-triggered
        # refill and a concurrent health tick must not both fill the
        # same slot (a cold start takes seconds — plenty of overlap)
        while len(pool.standbys) + pool.filling < target:
            if app.app_id not in self.apps or app.status == "STOPPED":
                return
            pool.filling += 1
            try:
                replica = await self._place_new_replica(
                    app, spec, pending_on_fail=False, record_failed=False
                )
            except Exception as e:  # noqa: BLE001 — capacity may come later
                pool.fill_failures += 1
                self.logger.warning(
                    f"warm-pool fill blocked for "
                    f"{app.app_id}/{spec.name}: {e}"
                )
                return
            finally:
                pool.filling -= 1
            if self._warm_pools.get((app.app_id, spec.name)) is not pool:
                # undeployed while the standby was starting
                await self._retire_replica(replica)
                return
            pool.add(replica)

    async def _warm_pool_tick(
        self, app: AppDeployment, spec: DeploymentSpec
    ) -> None:
        """Health-loop pool maintenance: standbys are health-checked
        (a preempted host's standby must not be promoted into a black
        hole), dead ones released, and the pool refilled to target."""
        pool = self._warm_pools.get((app.app_id, spec.name))
        if pool is None:
            return
        # bounded-concurrent checks, exactly like the serving replicas'
        # path — a dead host's standbys each cost a 30 s health timeout
        # and must not serialize the whole health loop behind it
        sem = asyncio.Semaphore(self.health_check_concurrency)

        async def checked(r) -> None:
            async with sem:
                try:
                    await r.check_health()
                except Exception:  # noqa: BLE001 — a throwing check is unhealthy
                    r.state = ReplicaState.UNHEALTHY

        await asyncio.gather(*(checked(r) for r in list(pool.standbys)))
        for dead in pool.remove_dead():
            self.logger.warning(
                f"warm standby {dead.replica_id} unhealthy; releasing"
            )
            try:
                await dead.stop()
            finally:
                self.cluster_state.mark_replica_dead(dead.replica_id)
        target = pool.target_size(self.telemetry)
        # shrink an over-target pool (telemetry sizing receded, or a
        # refill raced a promotion before the filling counter existed):
        # retire the youngest standby — idle chips go back to the fleet
        while len(pool.standbys) > target:
            victim = pool.standbys.pop()
            self.logger.info(
                f"warm pool over target for {app.app_id}/{spec.name}; "
                f"retiring standby {victim.replica_id}"
            )
            try:
                await victim.stop()
            finally:
                self.cluster_state.mark_replica_dead(victim.replica_id)
        if pool.config.refill and (
            len(pool.standbys) + pool.filling < target
        ):
            # a refill is a full cold start — run it off the health
            # loop (the filling counter keeps concurrent runs from
            # overfilling the same slot)
            spawn_supervised(
                self._top_up_warm_pool(app, spec),
                name=f"warmpool-tick-refill-{app.app_id}-{spec.name}",
                logger=self.logger,
            )

    def _readopt_replica(
        self, host_id: str, service_id: str, info: dict
    ) -> bool:
        """Reconcile one still-warm replica reported by a REJOINING
        host: if the controller still routes that replica_id to this
        host, restore its service binding + chip lease and (when the
        host reports it routable) clear the UNHEALTHY verdict the
        disconnect earned it. Returns False when the replica was
        already re-placed elsewhere — the host must discard its copy."""
        app = self.apps.get(info.get("app_id", ""))
        if app is None or app.status == "STOPPED":
            return False
        for r in app.replicas.get(info.get("deployment", ""), []):
            if r.replica_id != info.get("replica_id"):
                continue
            if not getattr(r, "is_remote", False) or r.host_id != host_id:
                return False
            if getattr(r, "is_mesh", False):
                # a mesh's identity spans hosts (and its inventory rows
                # carry shard ids, not the mesh id — this branch is a
                # belt under that suspender): one rejoining host can
                # never re-adopt it; the re-plan owns recovery
                return False
            try:
                reported = ReplicaState(info.get("state", ""))
            except ValueError:
                reported = ReplicaState.UNHEALTHY
            if reported not in ROUTABLE_STATES + (ReplicaState.INITIALIZING,):
                return False
            try:
                self.cluster_state.host_adopt_chips(
                    host_id, r.replica_id, list(r.device_ids)
                )
            except Exception as e:  # noqa: BLE001 — lease conflict = don't adopt
                self.logger.warning(
                    f"cannot re-adopt {r.replica_id} on '{host_id}': {e}"
                )
                return False
            r.host_service_id = service_id
            r.state = reported
            r.last_error = None
            self._breaker_counts.pop(r.replica_id, None)
            self.logger.info(
                f"re-adopted warm replica {r.replica_id} on rejoined "
                f"host '{host_id}' (state={reported})"
            )
            flight.record(
                "replica.readopt",
                replica=r.replica_id,
                app=app.app_id,
                host=host_id,
                state=reported.value,
            )
            return True
        return False

    def _make_remote_replica(
        self, app: AppDeployment, spec: DeploymentSpec
    ) -> Optional["RemoteReplica"]:
        if self._rpc_server is None or spec.remote_payload is None:
            return None
        self._prune_dead_hosts()  # never place on a host whose ws is gone
        host = self.cluster_state.find_host_for_chips(spec.chips_per_replica)
        if host is None:
            return None
        replica = RemoteReplica(
            app_id=app.app_id,
            deployment_name=spec.name,
            host_id=host.host_id,
            host_service_id=host.service_id,
            call_host=self._call_host,
            stream_host=self._stream_host,
            payload=spec.remote_payload,
            max_ongoing_requests=spec.max_ongoing_requests,
            log_sink=self.cluster_state.append_replica_log,
        )
        replica.device_ids = self.cluster_state.host_acquire_chips(
            host.host_id, replica.replica_id, spec.chips_per_replica
        )
        self.logger.info(
            f"placing {app.app_id}/{spec.name} on host '{host.host_id}' "
            f"(chips {replica.device_ids})"
        )
        return replica

    async def undeploy(
        self, app_id: str, drain_timeout_s: Optional[float] = None
    ) -> None:
        app = self.apps.pop(app_id, None)
        if app is None:
            return
        # intent commit: the undeploy is accepted the moment the app
        # leaves the routing map — a crash mid-teardown must not
        # resurrect the app at recovery
        self._journal_append("undeploy", {"app_id": app_id})
        # schedulers close FIRST: queued requests fail fast (typed) and
        # already-dispatched groups drain against replicas that are
        # still routable for a moment longer
        for name in app.specs:
            sched = self._schedulers.pop((app_id, name), None)
            if sched is not None:
                await sched.close()
        # warm standbys carry no traffic — retired alongside the
        # serving replicas so their chip leases release with the app
        standbys: list = []
        for name in app.specs:
            pool = self._warm_pools.pop((app_id, name), None)
            if pool is not None:
                standbys.extend(pool.drain_all())
        # drain-then-stop every replica concurrently: new calls are
        # rejected the moment states flip to DRAINING, in-flight
        # requests get up to drain_timeout_s to finish
        await asyncio.gather(
            *(
                self._retire_replica(r, drain_timeout_s)
                for replicas in app.replicas.values()
                for r in replicas
            ),
            *(self._retire_replica(r, drain_timeout_s) for r in standbys),
        )
        # router-state leak fix: get_handle/_pick_replica seeded
        # per-deployment entries that previously outlived the app —
        # unbounded growth under deploy/undeploy churn
        for name in app.specs:
            self._queue_depth.pop((app_id, name), None)
            self._rr_counters.pop((app_id, name), None)
            self._outliers.pop((app_id, name), None)
            # the SLO-page rate limiter seeds per-deployment stamps; a
            # redeploy under the same name must page immediately, not
            # inherit the dead app's cooldown (BE-LIFE-401)
            self._slo_bundle_last.pop((app_id, name), None)
        # observability-state sweep: a dead deployment must not keep
        # alerting or report history as live (get_telemetry races with
        # undeploy by design — see tests/test_slo.py churn test)
        self.slo.unregister(app_id)
        self.telemetry.sweep(app_id)
        app.status = "STOPPED"
        self.logger.info(f"app '{app_id}' undeployed")

    async def _retire_replica(
        self, replica, drain_timeout_s: Optional[float] = None
    ) -> None:
        try:
            await replica.stop(drain_timeout_s)
        finally:
            self.cluster_state.mark_replica_dead(replica.replica_id)
            self._breaker_counts.pop(replica.replica_id, None)
            self._forget_replica_latency(replica.replica_id)

    # ---- health + autoscaling loop ------------------------------------------

    async def _health_loop(self) -> None:
        while True:
            try:
                try:
                    # a breaker trip wakes the loop immediately
                    await asyncio.wait_for(
                        self._wake_health.wait(), self.health_check_period
                    )
                except asyncio.TimeoutError:
                    pass
                self._wake_health.clear()
                await self.health_tick()
            except asyncio.CancelledError:
                return
            except Exception as e:
                self.logger.error(f"health loop error: {e}")

    async def health_tick(self) -> None:
        """One pass: health-check replicas, restart dead ones, autoscale.
        Apps are checked concurrently, and replicas within an app are
        checked concurrently under a per-app bound — one host hitting
        the 30 s ``replica_health`` timeout must not stall every other
        app's restart."""
        self._prune_dead_hosts()
        if self.phase == "RECOVERING":
            # reconcile owns this window: hosts are still rejoining and
            # reporting inventory, so restarts/autoscale/top-ups here
            # would double-place replicas a host is about to re-offer —
            # the verdicts are DEFERRED until the diff is settled
            await self._reconcile_tick()
            return
        # DEPLOYING apps are excluded: deploy() is still placing their
        # replicas, and a concurrent restart/top-up here would race it
        # into double-placed replicas and double-leased chips
        apps = [
            a
            for a in self.apps.values()
            if a.status not in ("DEPLOYING", "DEPLOY_FAILED", "STOPPED")
        ]
        await asyncio.gather(*(self._health_tick_app(a) for a in apps))

    async def _health_tick_app(self, app: AppDeployment) -> None:
        any_unhealthy = False
        sem = asyncio.Semaphore(self.health_check_concurrency)

        async def checked(r):
            async with sem:
                try:
                    return await r.check_health()
                except Exception as e:  # noqa: BLE001 — a throwing check is unhealthy
                    self.logger.error(
                        f"check_health raised for {r.replica_id}: {e}"
                    )
                    return ReplicaState.UNHEALTHY

        for spec_name, spec in app.specs.items():
            replicas = app.replicas.get(spec_name, [])
            snapshot = list(replicas)
            states = await asyncio.gather(*(checked(r) for r in snapshot))
            for r, state in zip(snapshot, states):
                if state != ReplicaState.UNHEALTHY:
                    continue
                any_unhealthy = True
                self.logger.warning(
                    f"restarting unhealthy replica {r.replica_id}"
                )
                await r.stop()
                self.cluster_state.mark_replica_dead(r.replica_id)
                self._breaker_counts.pop(r.replica_id, None)
                self._forget_replica_latency(r.replica_id)
                if r in replicas:
                    replicas.remove(r)
                try:
                    # a mesh replica remembers WHICH hosts its shards
                    # failed on — steer the re-plan around them (a dead
                    # host is excluded anyway; this covers the
                    # alive-but-faulty one, scored last-resort)
                    await self._add_replica(
                        app,
                        spec,
                        avoid_hosts=frozenset(
                            getattr(r, "degraded_hosts", ()) or ()
                        ),
                    )
                    self._replicas_changed.set()
                except Exception as e:
                    self.logger.error(
                        f"replica restart failed for "
                        f"{app.app_id}/{spec_name}: {e}"
                    )
            # top up a deployment that fell below its floor (e.g. a
            # restart failed for lack of capacity on an earlier tick, a
            # rejoining host was told to drop an already-re-placed
            # replica, or a recovery re-place was blocked at settle) —
            # without this the app would stay degraded even after
            # capacity returns. With autoscale the floor is
            # min_replicas (num_replicas tracks actual); with a PINNED
            # replica count, num_replicas IS the declared intent and
            # must be restored in full.
            floor = (
                spec.min_replicas
                if spec.autoscale
                else max(spec.min_replicas, spec.num_replicas)
            )
            while (
                len(
                    [
                        r
                        for r in app.replicas.get(spec_name, [])
                        if r.state
                        in ROUTABLE_STATES + (ReplicaState.INITIALIZING,)
                    ]
                )
                < floor
            ):
                try:
                    await self._add_replica(app, spec)
                    self._replicas_changed.set()
                except Exception as e:
                    self.logger.warning(
                        f"top-up blocked for {app.app_id}/{spec_name}: {e}"
                    )
                    break
            await self._autoscale(app, spec)
            await self._warm_pool_tick(app, spec)
            alive = [
                r
                for r in app.replicas.get(spec_name, [])
                if r.state in (ReplicaState.HEALTHY, ReplicaState.TESTING,
                               ReplicaState.INITIALIZING)
            ]
            if not alive:
                any_unhealthy = True
        app.status = "UNHEALTHY" if any_unhealthy else "RUNNING"

    def _prune_dead_hosts(self) -> None:
        """A host whose RPC service vanished (websocket closed) is dead:
        release its chip accounting so restarts can re-place its
        replicas. The replicas themselves go UNHEALTHY on their next
        check (transport error) and ride the normal restart path."""
        if self._rpc_server is None:
            return
        live_services = {
            s["id"] for s in self._rpc_server.list_services()
        }
        for host in list(self.cluster_state.hosts.values()):
            if host.alive and host.service_id not in live_services:
                orphans = self.cluster_state.mark_host_dead(host.host_id)
                self.logger.warning(
                    f"host '{host.host_id}' lost "
                    f"(orphaned replicas: {orphans})"
                )
                flight.record(
                    "host.dead",
                    severity="error",
                    host=host.host_id,
                    orphaned_replicas=list(orphans),
                )

    async def _autoscale(self, app: AppDeployment, spec: DeploymentSpec) -> None:
        if not spec.autoscale:
            return
        replicas = app.replicas.get(spec.name, [])
        # TESTING replicas carry real traffic (they are routable), so
        # they must count toward the load/scaling signal
        healthy = [
            r
            for r in replicas
            if r.state in (ReplicaState.HEALTHY, ReplicaState.TESTING)
        ]
        if not healthy:
            return
        scheduler = self._schedulers.get((app.app_id, spec.name))
        if scheduler is not None:
            await self._autoscale_predictive(
                app, spec, scheduler, healthy, replicas
            )
            return
        avg_load = sum(r.load for r in healthy) / len(healthy)
        depth = self._queue_depth.get((app.app_id, spec.name), 0)
        if (
            avg_load > spec.target_load or depth > len(healthy) * spec.max_ongoing_requests
        ) and len(replicas) < spec.max_replicas:
            self.logger.info(
                f"autoscale UP {app.app_id}/{spec.name} "
                f"(load={avg_load:.2f}, depth={depth})"
            )
            try:
                await self._add_replica(app, spec)
                self._journal_scale(app, spec)
            except Exception as e:
                self.logger.warning(f"autoscale up blocked: {e}")
        elif (
            avg_load < spec.target_load / 2
            and depth == 0
            and len(healthy) > spec.min_replicas
        ):
            # only a fully idle replica may be stopped (in-flight
            # requests must never be cut); prefer the youngest so
            # long-warm replicas with populated caches survive
            idle = [r for r in healthy if r.load == 0.0]
            if idle:
                victim = idle[-1]
                self.logger.info(
                    f"autoscale DOWN {app.app_id}/{spec.name} "
                    f"({victim.replica_id})"
                )
                app.replicas[spec.name].remove(victim)
                await self._retire_replica(victim)
                self._journal_scale(app, spec)

    def _journal_scale(self, app: AppDeployment, spec: DeploymentSpec) -> None:
        """Autoscale verdicts are intent changes: the journaled replica
        target moves with them so a crash after a scale-up recovers to
        the SCALED size, not the deploy-time one. Journaled at intent
        commit (the scale happened) — never per request."""
        spec.num_replicas = len(app.replicas.get(spec.name, []))
        self._journal_append(
            "scale",
            {
                "app_id": app.app_id,
                "deployment": spec.name,
                "num_replicas": spec.num_replicas,
            },
        )

    async def _autoscale_predictive(
        self,
        app: AppDeployment,
        spec: DeploymentSpec,
        scheduler: DeploymentScheduler,
        healthy: list,
        replicas: list,
    ) -> None:
        """Scheduler-backed deployments scale on the predictor's
        verdict: up when measured arrival rate x service time projects
        a wait over the threshold (BEFORE queues saturate — occupancy
        alone reacts after), down only after the configured hysteresis
        of consecutive idle verdicts, riding the same drain machinery
        as undeploy so in-flight work is never cut."""
        decision, proj = scheduler.scale_decision(len(healthy))
        if decision == "up" and len(replicas) < spec.max_replicas:
            self.logger.info(
                f"predictive autoscale UP {app.app_id}/{spec.name} "
                f"(projected_wait={proj['projected_wait_s']:.3f}s, "
                f"utilization={proj['utilization']:.2f}, "
                f"rate={proj['arrival_rate']:.1f}/s)"
            )
            try:
                await self._add_replica(app, spec)
                self._replicas_changed.set()
                self._journal_scale(app, spec)
            except Exception as e:  # noqa: BLE001 — capacity may come later
                self.logger.warning(f"predictive autoscale up blocked: {e}")
        elif decision == "down" and len(healthy) > spec.min_replicas:
            # only a fully idle replica may be retired; prefer the
            # youngest so long-warm program caches survive
            idle = [r for r in healthy if r.load == 0.0]
            if idle:
                victim = idle[-1]
                self.logger.info(
                    f"predictive autoscale DOWN {app.app_id}/{spec.name} "
                    f"({victim.replica_id})"
                )
                app.replicas[spec.name].remove(victim)
                await self._retire_replica(victim)
                self._journal_scale(app, spec)

    # ---- status -------------------------------------------------------------

    def get_app_status(self, app_id: str) -> dict:
        app = self.apps.get(app_id)
        if app is None:
            raise KeyError(f"app '{app_id}' not deployed")
        return {
            "app_id": app_id,
            "status": app.status,
            "created_at": app.created_at,
            # the fencing epoch + phase: `bioengine apps status` shows
            # these so an operator can watch a reconcile converge
            "controller": {
                "epoch": self.epoch,
                "phase": self.phase,
                "reconcile": self.reconcile_report,
            },
            # the scale-out router tier: table version/epoch plus each
            # router's last-reported sync (acked version, staleness age)
            "router_tier": self.router_publisher.describe(),
            "cost": self._cost_rollup(app_id),
            "deployments": {
                name: self._describe_deployment(app_id, name, replicas)
                for name, replicas in app.replicas.items()
            },
        }

    def _cost_rollup(self, app_id: str) -> dict:
        """Per-app chip-seconds from the process registry — the feature
        vector the future scheduler consumes (ROADMAP item 1). Replicas
        in THIS process (local placement, or the in-process multi-host
        harness) account here; separate worker-host processes surface
        their slice via their own ``get_metrics``/``get_flight_record``
        and the incident bundle."""
        total = 0.0
        by_dep: dict[str, dict] = {}
        for key, child in CHIP_SECONDS.items():
            a, dep, method = key
            if a != app_id:
                continue
            v = child.value
            total += v
            d = by_dep.setdefault(
                dep, {"chip_seconds_total": 0.0, "by_method": {}}
            )
            d["chip_seconds_total"] = round(d["chip_seconds_total"] + v, 6)
            d["by_method"][method] = round(v, 6)
        return {
            "chip_seconds_total": round(total, 6),
            "by_deployment": by_dep,
        }

    def _describe_deployment(self, app_id, name, replicas) -> dict:
        """Per-deployment status: replica describes plus the load
        rollup least-loaded routing acts on — router queue depth,
        outstanding + parked calls, and each replica's mesh shape, so
        a sharded replica that hogs traffic (or idles its chips) is
        visible from one status call."""
        described = [r.describe() for r in replicas]
        # RemoteReplica.describe deliberately omits queued_requests
        # (the semaphore queue lives host-side): a missing key means
        # UNKNOWN, so the rollup reports None rather than coercing to
        # 0 and faking an idle queue to least-loaded routing decisions
        queued = [d.get("queued_requests") for d in described]
        scheduler = self._schedulers.get((app_id, name))
        pool = self._warm_pools.get((app_id, name))
        # per-deployment compile rollup from the replicas' engine
        # describes (joined on the same RuntimeDeployment._status_key
        # the pipeline/mesh views use): how many "compiles" were
        # persistent/tier cache hits vs real XLA work
        tier_hits = real_compiles = 0
        for d in described:
            for eng in ((d.get("mesh") or {}).get("engines") or {}).values():
                progs = eng.get("programs") or {}
                tier_hits += int(progs.get("persistent_hits") or 0)
                real_compiles += int(progs.get("real_compiles") or 0)
        # the newest replica's TTFR breakdown — the number the warm
        # path is accountable for, fresh from the latest scale-up
        last_ttfr = None
        for d in reversed(described):
            cold = d.get("cold_start") or {}
            if cold.get("ttfr_seconds") is not None:
                last_ttfr = cold
                break
        tracker = self._outliers.get((app_id, name))
        return {
            "num_replicas": len(replicas),
            "scheduler": scheduler.describe() if scheduler else None,
            # latency-outlier view (serving/outlier.py): per-replica
            # EWMAs vs the deployment median, probation flags, and the
            # p95-derived hedge delay — the evidence the gray-failure
            # runbook reads next to `bioengine slo status`
            "gray_failure": tracker.describe() if tracker else None,
            "cold_start": {
                "warm_pool": pool.stats() if pool else None,
                "last_replica_ttfr": last_ttfr,
                "compile": {
                    "persistent_cache_hits": tier_hits,
                    "real_compiles": real_compiles,
                    "hit_rate": round(
                        tier_hits / (tier_hits + real_compiles), 4
                    )
                    if (tier_hits + real_compiles)
                    else None,
                },
            },
            "replicas": described,
            "queue_depth": self._queue_depth.get((app_id, name), 0),
            "outstanding_calls": sum(
                d.get("ongoing_requests", 0) for d in described
            ),
            "queued_calls": (
                sum(queued) if all(q is not None for q in queued) else None
            ),
            "avg_load": round(
                sum(d.get("load", 0.0) for d in described) / len(described),
                4,
            ) if described else 0.0,
            "mesh_shapes": {
                d["replica_id"]: (d.get("mesh") or {}).get("mesh_shape")
                for d in described
                if d.get("mesh")
            },
            # one-logical-deployment-over-many-hosts view: per-replica
            # shard placement + the cross-shard transfer rate (the
            # number that says whether the pipeline split is
            # transfer-bound); None when no replica is a mesh
            "cross_host_mesh": {
                d["replica_id"]: {
                    "kind": (d["mesh"] or {}).get("kind"),
                    "mesh_shape": (d["mesh"] or {}).get("mesh_shape"),
                    "cross_host": (d["mesh"] or {}).get("cross_host"),
                    "hosts": (d["mesh"] or {}).get("hosts"),
                    "shards": (d["mesh"] or {}).get("shards"),
                    "transfer": (d["mesh"] or {}).get("transfer"),
                }
                for d in described
                if (d.get("mesh") or {}).get("shards") is not None
            }
            or None,
        }

    # ---- telemetry / SLO surfaces -------------------------------------------

    def get_telemetry(
        self,
        series: Any = None,
        app: Optional[str] = None,
        deployment: Optional[str] = None,
        since: Optional[float] = None,
        resolution: Optional[float] = None,
    ) -> dict:
        """Reconstructed per-deployment series from the telemetry
        store (rates, latency quantiles from merged buckets, queue
        depth, chip-seconds, shed counts). ``series`` is one name, a
        list, or None for all; ``resolution`` picks a ring (seconds,
        next-coarser match), ``since`` a wall-clock cursor. Only LIVE
        history is reported — undeploy sweeps a deployment's series."""
        if isinstance(series, str):
            names = [series]
        else:
            names = list(series) if series else list(SERIES_NAMES)
        unknown = sorted(set(names) - set(SERIES_NAMES))
        if unknown:
            raise ValueError(
                f"unknown telemetry series {unknown} "
                f"(available: {list(SERIES_NAMES)})"
            )
        store = self.telemetry
        out: dict[str, Any] = {
            "generated_at": time.time(),
            "store": store.describe(),
            "deployments": {},
        }
        for a, d in store.keys():
            if app is not None and a != app:
                continue
            if deployment is not None and d != deployment:
                continue
            out["deployments"][f"{a}/{d}"] = {
                name: store.series(
                    a, d, name, since=since, resolution=resolution
                )
                for name in names
            }
        return out

    def get_slo_status(self) -> dict:
        """Burn rates, budget remaining, and alert state per tracked
        deployment, plus metadata of auto-captured incident bundles —
        JSON-able (this is the ``get_slo_status`` verb body and the
        ``bioengine slo status`` CLI feed)."""
        status = self.slo.status()
        status["auto_bundles"] = [
            {
                "generated_at": b.get("generated_at"),
                "alert": b.get("slo_alert"),
                "events": len(b.get("events", [])),
            }
            for b in self.slo_bundles
        ]
        return status

    def _slo_page_hook(self, alert: dict) -> None:
        """A page-severity SLO firing: snapshot the flight ring NOW
        (evidence survives even if the bundle task is starved), then
        capture a full cross-host incident bundle in the background —
        rate-limited per deployment so a flapping alert cannot DoS the
        hosts with bundle gathering."""
        key = (alert.get("app", ""), alert.get("deployment", ""))
        interval = float(
            os.environ.get("BIOENGINE_SLO_BUNDLE_INTERVAL_S", "300")
        )
        now = time.monotonic()
        last = self._slo_bundle_last.get(key)
        if last is not None and now - last < interval:
            return
        self._slo_bundle_last[key] = now
        flight.dump(
            "slo_page",
            app=alert.get("app"),
            deployment=alert.get("deployment"),
            objective=alert.get("objective"),
        )
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (sync unit test) — the dump above is the artifact
        from bioengine_tpu_torch.utils.tasks import spawn_supervised

        spawn_supervised(
            self._capture_slo_bundle(alert),
            name="slo-auto-bundle",
            logger=self.logger,
        )

    async def _capture_slo_bundle(self, alert: dict) -> None:
        try:
            bundle = await self.debug_bundle()
        except Exception as e:  # noqa: BLE001 — bundling never breaks serving
            self.logger.error(f"slo auto-bundle failed: {e}")
            return
        bundle["slo_alert"] = alert
        self.slo_bundles.append(bundle)
        flight.record(
            "slo.bundle",
            app=alert.get("app"),
            deployment=alert.get("deployment"),
            objective=alert.get("objective"),
            events=len(bundle.get("events", [])),
        )
        target_dir = os.environ.get("BIOENGINE_FLIGHT_DIR")
        if target_dir:
            import json as _json
            from pathlib import Path as _Path

            def _write() -> None:
                try:
                    path = _Path(target_dir).expanduser()
                    path.mkdir(parents=True, exist_ok=True)
                    stamp = time.strftime("%Y%m%d-%H%M%S")
                    name = (
                        f"slo-bundle-{stamp}-{alert.get('app')}"
                        f"-{alert.get('deployment')}.json"
                    )
                    (path / name).write_text(
                        _json.dumps(bundle, indent=2, default=str)
                    )
                except OSError as e:
                    self.logger.warning(f"slo bundle not persisted: {e}")

            await asyncio.get_running_loop().run_in_executor(None, _write)

    async def debug_bundle(
        self,
        event_limit: int = 2000,
        max_spans: int = 1000,
        host_timeout_s: float = 10.0,
    ) -> dict:
        """One time-merged incident artifact: this process's flight
        record, recent traces, and metrics snapshot, plus the flight
        record + metrics + describe (topology, replica/mesh state) of
        every REACHABLE worker host, with all flight events folded into
        a single wall-clock-ordered timeline (deduped by recorder
        identity, so an in-process harness where hosts share this
        process's ring never double-reports). Unreachable hosts are
        reported as such instead of failing the bundle — the hosts you
        can't reach are usually the ones the incident is about."""
        local_rec = flight.get_record(limit=event_limit)
        records = [local_rec]
        hosts_out: dict[str, Any] = {}

        async def gather_host(host) -> None:
            # the three verbs (and the hosts) are independent — run
            # them concurrently so a cluster with several wedged hosts
            # costs ONE timeout, not hosts x verbs of them; the bundle
            # is the tool an operator reaches for mid-incident
            try:
                rec, met, desc = await asyncio.gather(
                    self._call_host(
                        host.service_id,
                        "get_flight_record",
                        limit=event_limit,
                        rpc_timeout=host_timeout_s,
                    ),
                    self._call_host(
                        host.service_id, "get_metrics",
                        rpc_timeout=host_timeout_s,
                    ),
                    self._call_host(
                        host.service_id, "describe",
                        rpc_timeout=host_timeout_s,
                    ),
                )
                # skew: prefer the host's own latest handshake estimate
                # (stamped on its record), fall back to what it reported
                # at registration — either way the merged timeline below
                # is corrected onto the controller's clock
                if "clock_skew_s" not in rec:
                    rec["clock_skew_s"] = host.clock_skew_s
                records.append(rec)
                hosts_out[host.host_id] = {
                    "reachable": True,
                    "recorder": rec.get("recorder"),
                    "flight_events": len(rec.get("events", []) or []),
                    "dumps": rec.get("dumps", []),
                    "clock_skew_s": rec.get("clock_skew_s", 0.0),
                    "metrics": met,
                    "describe": desc,
                }
            except Exception as e:  # noqa: BLE001 — partial bundle beats none
                hosts_out[host.host_id] = {
                    "reachable": False,
                    "reason": f"{type(e).__name__}: {e}",
                }

        live_hosts = []
        for host in list(self.cluster_state.hosts.values()):
            if host.alive:
                live_hosts.append(host)
            else:
                hosts_out[host.host_id] = {
                    "reachable": False,
                    "reason": "marked dead",
                }
        await asyncio.gather(*(gather_host(h) for h in live_hosts))
        return {
            "generated_at": time.time(),
            "recorder": local_rec["recorder"],
            "events": flight.merge_records(records),
            "dumps": local_rec["dumps"],
            "traces": tracing.get_spans(
                max_spans=max_spans, include_open=True
            ),
            "metrics": metrics.collect(),
            "slo": self.slo.status(),
            "controller": {
                "epoch": self.epoch,
                "phase": self.phase,
                "reconcile": self.reconcile_report,
            },
            "journal": (
                self.journal.describe() if self.journal is not None else None
            ),
            "compile_tier": self.compile_tier.stats(),
            "telemetry": self.telemetry.describe(),
            "cluster": self.cluster_state.snapshot(),
            "apps": {
                app_id: self.get_app_status(app_id)
                for app_id in list(self.apps)
            },
            "hosts": hosts_out,
        }

    def list_apps(self) -> list[str]:
        return sorted(self.apps)

    def get_load(self, app_id: str) -> float:
        app = self.apps.get(app_id)
        if not app:
            return 0.0
        loads = [
            r.load
            for replicas in app.replicas.values()
            for r in replicas
            if r.state in (ReplicaState.HEALTHY, ReplicaState.TESTING)
        ]
        return sum(loads) / len(loads) if loads else 0.0
