"""BioEngineWorker — the central lifecycle orchestrator.

Capability parity with ref bioengine/worker/worker.py:142-1217: init the
component managers, bring up the control plane, register the worker
service surface, deploy startup applications, run the monitoring loop
(connection checks, scaling, app auto-redeploy, data-server rediscovery,
consecutive-error trip wire), aggregate status, tail component logs, and
shut everything down gracefully in reverse order.

Topology differences by design: the reference connects OUT to an external
Hypha server and babysits an external Ray cluster; here the control plane
(RpcServer) and the serving substrate (ServeController over the CUDA
topology) are part of the framework, so "standalone" mode is fully
self-contained, and ``server_url`` optionally federates this worker's
service surface onto a remote control plane as well.

Own copy of ``bioengine_tpu/worker/worker.py``. It takes ``device``
(default ``cuda``; ``"cpu"`` for tests): the topology is detected on it
at ``start()``, which raises there without CUDA. Profiling goes through
``torch.profiler``; the persistent compile cache it enables at ``start()``
holds the kernel libraries (``utils/compile_cache.py``).
"""

from __future__ import annotations

import asyncio
import os
import time
from pathlib import Path
from typing import Any, Optional

from bioengine_tpu_torch.apps.artifacts import LocalArtifactStore
from bioengine_tpu_torch.apps.builder import AppBuilder
from bioengine_tpu_torch.apps.manager import AppsManager
from bioengine_tpu_torch.cluster.cluster import TpuCluster
from bioengine_tpu_torch.cluster.topology import detect_topology
from bioengine_tpu_torch.datasets.datasets import BioEngineDatasets
from bioengine_tpu_torch.datasets.proxy_server import DatasetsServer, rpc_token_validator
from bioengine_tpu_torch.rpc.client import ServerConnection, connect_to_server
from bioengine_tpu_torch.rpc.server import RpcServer
from bioengine_tpu_torch.serving.controller import ServeController
from bioengine_tpu_torch.utils.logger import LOG_FILE_REGISTRY, create_logger, read_log_tail
from bioengine_tpu_torch.utils.permissions import check_permissions, create_context
from bioengine_tpu_torch.utils.tasks import spawn_supervised
from bioengine_tpu_torch.runtime.devices import DeviceLike
from bioengine_tpu_torch.worker.code_executor import CodeExecutor

MAX_CONSECUTIVE_MONITOR_ERRORS = 5


class BioEngineWorker:
    def __init__(
        self,
        mode: str = "single-machine",
        workspace_dir: str | Path = "~/.bioengine",
        admin_users: Optional[list[str]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        server_url: Optional[str] = None,
        server_token: Optional[str] = None,
        datasets_dir: Optional[str | Path] = None,
        startup_applications: Optional[list[dict]] = None,
        monitoring_interval_seconds: float = 10.0,
        provisioner_config: Optional[dict] = None,
        log_file: Optional[str] = "off",
        cluster: Optional[TpuCluster] = None,
        device: DeviceLike = "cuda",
    ):
        self.device = device
        self.workspace_dir = Path(workspace_dir).expanduser()
        self.admin_users = list(admin_users or ["admin"])
        self.monitoring_interval_seconds = monitoring_interval_seconds
        self.startup_applications = list(startup_applications or [])
        self.server_url = server_url
        self.server_token = server_token
        self.datasets_dir = Path(datasets_dir).expanduser() if datasets_dir else None
        self.log_file = log_file
        if log_file is None:
            log_file = str(self.workspace_dir / "logs" / "worker.log")
            self.log_file = log_file
        self.logger = create_logger("worker", log_file=self.log_file)

        # component managers (ref worker.py:142-357)
        self.cluster = cluster or TpuCluster(
            mode=mode,
            workspace_dir=self.workspace_dir,
            provisioner_config=provisioner_config,
            log_file=self.log_file,
        )
        self.server = RpcServer(host=host, port=port, admin_users=self.admin_users)
        self.controller: Optional[ServeController] = None
        self.apps_manager: Optional[AppsManager] = None
        self.code_executor = CodeExecutor(
            admin_users=self.admin_users,
            log_file=self.log_file,
            on_submit=self._nudge_scaling,
        )
        self.datasets_server: Optional[DatasetsServer] = None
        self.datasets_client: Optional[BioEngineDatasets] = None
        self.remote_connection: Optional[ServerConnection] = None

        self.is_ready = False
        self.start_time: Optional[float] = None
        self._start_mono: Optional[float] = None
        self._monitor_task: Optional[asyncio.Task] = None
        self._monitor_errors = 0
        self._geo_location: Optional[dict] = None
        self._geo_task: Optional[asyncio.Task] = None
        self._tripped = False
        self._stop_event = asyncio.Event()
        self._service_id: Optional[str] = None

    # ---- lifecycle ----------------------------------------------------------

    async def start(self, blocking: bool = False) -> dict:
        """Bring the worker up (ref worker.py:925-1001). Returns the
        service endpoints."""
        from bioengine_tpu_torch.utils.compile_cache import (
            enable_persistent_compilation_cache,
        )

        enable_persistent_compilation_cache()
        if self.cluster.state is None and self.cluster._topology is None:
            # the worker's device decides the topology; without CUDA a
            # cuda worker raises here, before it takes the workspace lock
            self.cluster._topology = detect_topology(device=self.device)
        self.start_time = time.time()          # wall, for display
        self._start_mono = time.monotonic()    # durations (NTP-safe)
        self.cluster.start()
        await self.server.start()

        self.controller = ServeController(
            cluster_state=self.cluster.state, log_file=self.log_file
        )
        if self.controller.journal is not None:
            # durable control plane (BIOENGINE_CONTROL_DIR): replay the
            # previous life's journaled intent into the RECOVERING
            # phase BEFORE the router verbs exist — rejoining hosts'
            # warm-replica inventory then reconciles against it instead
            # of being told to drop everything. A fresh/empty journal
            # recovers nothing and the phase stays ACTIVE.
            await self.controller.recover()
        # multi-host: register the serve-router service so worker_host
        # processes can join and receive replica placements
        self.controller.attach_rpc(self.server, admin_users=self.admin_users)
        await self.controller.start()
        # chip-aware code execution: lease from the live cluster state,
        # dispatch to joined hosts through the controller's RPC plumbing
        self.code_executor.cluster_state = self.cluster.state
        self.code_executor.call_host = self.controller._call_host

        artifact_store = LocalArtifactStore(self.workspace_dir / "artifacts")
        # artifact manager HTTP surface: presigned uploads + static site
        # (the reference's Hypha artifact manager, served by the
        # framework itself — apps/artifact_http.py)
        from bioengine_tpu_torch.apps.artifact_http import ArtifactHttpService

        self.server.attach_artifact_service(
            ArtifactHttpService(artifact_store, self.server, log_file=self.log_file)
        )
        builder = AppBuilder(
            store=artifact_store,
            workdir_root=self.workspace_dir / "apps",
            data_client_factory=self._make_datasets_client,
            admin_users=self.admin_users,
        )
        self.apps_manager = AppsManager(
            controller=self.controller,
            server=self.server,
            store=artifact_store,
            builder=builder,
            admin_users=self.admin_users,
            can_scale_out=self.cluster.mode in ("slurm", "gke"),
            state_file=self.workspace_dir / "apps" / "deployed.json",
            log_file=self.log_file,
        )

        # datasets plane: serve locally when a data dir is configured,
        # otherwise discover an already-running server (ref :451-498)
        if self.datasets_dir is not None:
            self.datasets_server = DatasetsServer(
                self.datasets_dir,
                token_validator=rpc_token_validator(self.server),
                log_file=self.log_file,
            )
            await self.datasets_server.start()
        self.datasets_client = self._make_datasets_client()

        # built-in operator dashboard at /apps/_dashboard/ (the
        # reference leans on an external dashboard site reading its
        # Hypha service; ours is self-served)
        dashboard = Path(__file__).resolve().parent / "dashboard"
        if dashboard.is_dir():
            self.server.register_static_dir("_dashboard", dashboard)

        await asyncio.to_thread(self._write_admin_token)
        # provisioned worker_host processes join THIS control plane
        self.cluster.provisioner.set_join_info(self.server.url, self.admin_token)
        self._register_worker_service()
        if self.server_url:
            await self._connect_remote()

        # re-adopt apps recorded by a previous worker life (ref
        # bioengine/apps/manager.py:841-935), then the configured
        # startup apps (already-recovered ids are skipped by record)
        recovered = await self.apps_manager.recover_deployed_applications()
        if recovered:
            self.logger.info(
                f"recovered {len(recovered)} app(s) from previous run"
            )
        if self.startup_applications:
            await self.apps_manager.deploy_startup_applications(
                self.startup_applications
            )

        # process self-metrics: rss / fds / gc collectors + the
        # event-loop lag ticker (a scrape can't measure a blocked loop
        # from inside it — the supervised ticker can)
        from bioengine_tpu_torch.utils import metrics as _metrics

        _metrics.install_process_metrics()
        self._loop_lag_task = spawn_supervised(
            _metrics.monitor_event_loop(),
            name="event-loop-lag-monitor",
            logger=self.logger,
        )
        self._monitor_task = asyncio.create_task(self._monitor_loop())
        self._geo_task = asyncio.create_task(self._fetch_geo_location())
        self.is_ready = True
        self.logger.info(
            f"worker ready: rpc={self.server.url} "
            f"datasets={self.datasets_server.url if self.datasets_server else 'external'}"
        )
        if blocking:
            await self._stop_event.wait()
        return {
            "rpc_url": self.server.url,
            "datasets_url": self.datasets_server.url if self.datasets_server else None,
            "service_id": self._service_id,
        }

    async def stop(self, context: Optional[dict] = None) -> None:
        """Graceful shutdown in reverse order (ref worker.py:697-778)."""
        if context is not None:
            check_permissions(context, self.admin_users, "stop_worker")
        self.is_ready = False
        try:
            if self._monitor_task:
                self._monitor_task.cancel()
                self._monitor_task = None
            if self._geo_task:
                self._geo_task.cancel()
                self._geo_task = None
            if getattr(self, "_loop_lag_task", None):
                self._loop_lag_task.cancel()
                self._loop_lag_task = None
            if self.apps_manager:
                try:
                    admin_ctx = create_context(
                        self.admin_users[0], workspace="bioengine"
                    )
                    # forget=False: a graceful shutdown keeps the
                    # persisted records so restart re-adopts the apps
                    await self.apps_manager.stop_all_apps(
                        context=admin_ctx, forget=False
                    )
                except Exception as e:
                    self.logger.warning(f"stopping apps failed: {e}")
            if self.controller:
                await self.controller.stop()
            if self.remote_connection:
                await self.remote_connection.disconnect()
                self.remote_connection = None
            if self.datasets_client:
                await self.datasets_client.aclose()
            if self.datasets_server:
                await self.datasets_server.stop()
            await self.server.stop()
            self.cluster.stop()
        finally:
            # always release a blocking start() — a failed teardown must
            # not leave the process unkillable
            self._stop_event.set()
        self.logger.info("worker stopped")

    async def _stop_worker_service(self, context: Optional[dict] = None) -> dict:
        """RPC-exposed stop: respond first, then shut down — tearing the
        server down inline would close the caller's socket before the
        result frame is sent and hang the client forever."""
        check_permissions(context, self.admin_users, "stop_worker")

        async def _deferred():
            await asyncio.sleep(0.2)  # let the RESULT frame flush
            await self.stop()

        spawn_supervised(
            _deferred(), name="deferred-stop", logger=self.logger
        )
        return {"status": "stopping"}

    def _write_admin_token(self) -> None:
        """Bootstrap operator auth: issue a long-lived admin token and
        drop it (0600) into the workspace so the CLI on this machine can
        authenticate — the analog of the reference's admin-token
        validation via Hypha login (ref worker.py:522-612). A pre-shared
        token can be forced via env BIOENGINE_ADMIN_TOKEN."""
        token = self.server.issue_token(
            self.admin_users[0],
            ttl_seconds=30 * 86400,
            is_admin=True,
            token_value=os.environ.get("BIOENGINE_ADMIN_TOKEN"),
        )
        self.admin_token = token
        path = self.workspace_dir / "admin_token"
        path.write_text(token)
        path.chmod(0o600)

    def _make_datasets_client(self) -> BioEngineDatasets:
        url = self.datasets_server.url if self.datasets_server else None
        return BioEngineDatasets(server_url=url, log_file="off")

    def _nudge_scaling(self) -> None:
        """Prod the provisioner right after a code submit, mirroring the
        reference's SLURM autoscale nudge (ref code_executor.py:490-494)."""
        try:
            if self.cluster.is_ready:
                self.cluster.monitor_cluster()
        except Exception as e:  # noqa: BLE001 — a nudge must never fail a submit
            self.logger.debug(f"scaling nudge failed (tolerated): {e}")

    # ---- service surface (ref worker.py:614-664) ----------------------------

    def _service_definition(self) -> dict[str, Any]:
        definition: dict[str, Any] = {
            "id": "bioengine-worker",
            "name": "BioEngine worker",
            "type": "bioengine-worker",
            "description": "BioEngine worker on NVIDIA GPUs (PyTorch/CUDA)",
            "config": {"require_context": True, "visibility": "public"},
            "get_status": self.get_status,
            "get_logs": self.get_logs,
            "stop_worker": self._stop_worker_service,
            "start_profiling": self.start_profiling,
            "stop_profiling": self.stop_profiling,
            "profile_replica": self.profile_replica,
            "memory_profile": self.memory_profile,
            "get_traces": self.get_traces,
            "get_metrics": self.get_metrics,
            "get_telemetry": self.get_telemetry,
            "get_slo_status": self.get_slo_status,
            "get_flight_record": self.get_flight_record,
            "debug_bundle": self.debug_bundle,
            **self.code_executor.service_methods(),
        }
        assert self.apps_manager is not None
        definition.update(self.apps_manager.service_methods())
        return definition

    def _register_worker_service(self) -> None:
        entry = self.server.register_local_service(self._service_definition())
        self._service_id = entry.full_id

    async def _connect_remote(self) -> None:
        """Federate this worker's service surface onto a remote control
        plane (the reference's Hypha registration, ref worker.py:522-664)."""
        self.remote_connection = await connect_to_server(
            {"server_url": self.server_url, "token": self.server_token}
        )
        await self.remote_connection.register_service(self._service_definition())
        self.logger.info(f"registered on remote control plane {self.server_url}")

    # ---- monitoring loop (ref worker.py:780-883) ----------------------------

    async def _monitor_loop(self) -> None:
        while True:
            try:
                await asyncio.sleep(self.monitoring_interval_seconds)
                await self._monitor_once()
                self._monitor_errors = 0
                if self._tripped:
                    # recovery after the trip wire: monitoring is clean
                    # again, so readiness is restored
                    self._tripped = False
                    self.is_ready = True
                    self.logger.info("monitoring recovered; worker ready again")
            except asyncio.CancelledError:
                return
            except Exception as e:
                self._monitor_errors += 1
                self.logger.error(
                    f"monitor error ({self._monitor_errors}/"
                    f"{MAX_CONSECUTIVE_MONITOR_ERRORS}): {e}"
                )
                if self._monitor_errors >= MAX_CONSECUTIVE_MONITOR_ERRORS:
                    self.is_ready = False
                    self._tripped = True
                    self.logger.critical(
                        "worker tripped not-ready after repeated monitor errors"
                    )

    async def _fetch_geo_location(self) -> None:
        # geolocation for the dashboard map: one background fetch, never
        # fatal (ref worker.py:780-883; zero-egress workers keep all-None
        # coordinates and the monitor loop is never blocked by it)
        from bioengine_tpu_torch.utils.geo_location import fetch_geolocation

        try:
            self._geo_location = await fetch_geolocation(self.logger)
        except Exception:
            self._geo_location = {}

    async def _monitor_once(self) -> None:
        # cluster: liveness + scaling tick
        if not self.cluster.check_connection():
            raise RuntimeError("cluster connection lost")
        self.cluster.monitor_cluster()
        # remote control plane: ping, reconnect + re-register on failure
        if self.server_url:
            healthy = False
            if self.remote_connection and self.remote_connection.connected:
                try:
                    await self.remote_connection.ping()
                    healthy = True
                except Exception:
                    healthy = False
            if not healthy:
                self.logger.warning("remote control plane lost; reconnecting")
                if self.remote_connection:
                    await self.remote_connection.disconnect()
                await self._connect_remote()
        # datasets: ping, rediscover on failure (ref worker.py:428-498)
        if self.datasets_client and self.datasets_client.available:
            if not await self.datasets_client.ping():
                self.logger.warning("data server unreachable; rediscovering")
                await self.datasets_client.aclose()
                self.datasets_client = self._make_datasets_client()
        # apps: health-driven registration + auto-redeploy
        if self.apps_manager:
            await self.apps_manager.monitor_applications()

    # ---- profiling (SURVEY §5.1: jax.profiler surface) ----------------------

    def start_profiling(
        self, trace_dir: Optional[str] = None, context: Optional[dict] = None
    ) -> dict:
        """Start a torch.profiler trace (CPU and CUDA activity)
        covering everything the worker's process executes (serving
        replicas included — they run in-process). ``stop_profiling``
        writes it as ``trace.json`` (Chrome trace format: chrome://tracing
        or Perfetto). Admin-only."""
        check_permissions(context, self.admin_users, "start_profiling")
        from bioengine_tpu_torch.utils import profiling

        self._profile_dir = profiling.start_trace(
            self.workspace_dir, trace_dir, getattr(self, "_profile_dir", None)
        )
        self.logger.info(f"profiling started -> {self._profile_dir}")
        return {"trace_dir": self._profile_dir, "profiling": True}

    def stop_profiling(self, context: Optional[dict] = None) -> dict:
        check_permissions(context, self.admin_users, "stop_profiling")
        from bioengine_tpu_torch.utils import profiling

        trace_dir = profiling.stop_trace(getattr(self, "_profile_dir", None))
        self._profile_dir = None
        self.logger.info(f"profiling stopped -> {trace_dir}")
        return {"trace_dir": trace_dir, "profiling": False}

    async def profile_replica(
        self,
        app_id: str,
        deployment: Optional[str] = None,
        replica_id: Optional[str] = None,
        action: str = "start",
        trace_dir: Optional[str] = None,
        context: Optional[dict] = None,
    ) -> dict:
        """Profile ONE replica of a live deployment: resolves the
        replica (by id, or the first routable one) and routes
        ``start``/``stop``/``memory`` to the process that actually
        runs it — this worker for local placement, the owning worker
        host over RPC for remote placement. jax.profiler is
        process-global, so on a multi-replica host the trace covers
        that host process; the point is picking WHICH host of a live
        deployment pays the profiling overhead. Admin-only."""
        check_permissions(context, self.admin_users, "profile_replica")
        if action not in ("start", "stop", "memory"):
            raise ValueError(
                f"action must be start|stop|memory, got '{action}'"
            )
        assert self.controller is not None
        app = self.controller.apps.get(app_id)
        if app is None:
            raise KeyError(f"app '{app_id}' not deployed")
        if deployment is None:
            deployment = next(iter(app.specs))
        replicas = app.replicas.get(deployment, [])
        if replica_id is not None:
            matches = [r for r in replicas if r.replica_id == replica_id]
            if not matches:
                raise KeyError(
                    f"no replica '{replica_id}' in {app_id}/{deployment}"
                )
            replica = matches[0]
        else:
            from bioengine_tpu_torch.serving.replica import ROUTABLE_STATES

            routable = [r for r in replicas if r.state in ROUTABLE_STATES]
            if not routable:
                raise RuntimeError(
                    f"no routable replica in {app_id}/{deployment}"
                )
            replica = routable[0]
        target = {
            "replica_id": replica.replica_id,
            "app_id": app_id,
            "deployment": deployment,
        }
        if getattr(replica, "is_remote", False):
            verb = {
                "start": "start_profiling",
                "stop": "stop_profiling",
                "memory": "memory_profile",
            }[action]
            kwargs = (
                {"trace_dir": trace_dir}
                if action == "start" and trace_dir
                else {}
            )
            if getattr(replica, "is_mesh", False):
                # a mesh replica spans hosts; jax.profiler is
                # process-global per host, so profile every shard host
                # (deduped — a single-host fallback mesh has one) and
                # return the per-host results keyed by host_id
                shard_hosts = {
                    s.host_id: s.service_id for s in replica.plan.shards
                }

                async def one_host(service_id: str) -> dict:
                    # bounded + isolated: a wedged shard host (the
                    # degraded one, usually) costs its own 30 s, never
                    # the default 300 s RPC timeout, and never the
                    # live hosts' profiling data mid-incident
                    try:
                        return await self.controller._call_host(
                            service_id, verb, rpc_timeout=30.0, **kwargs
                        )
                    except Exception as e:  # noqa: BLE001 — partial profile beats none
                        return {"error": f"{type(e).__name__}: {e}"}

                gathered = await asyncio.gather(
                    *(one_host(sid) for sid in shard_hosts.values())
                )
                return {
                    **target,
                    "hosts": dict(zip(shard_hosts, gathered)),
                }
            result = await self.controller._call_host(
                replica.host_service_id, verb, **kwargs
            )
            return {**target, "host_id": replica.host_id, **result}
        # local replica: it runs in THIS process
        if action == "start":
            result = self.start_profiling(trace_dir=trace_dir, context=context)
        elif action == "stop":
            result = self.stop_profiling(context=context)
        else:
            result = self.memory_profile(context=context)
        return {**target, "host_id": "local", **result}

    def get_traces(
        self,
        name: Optional[str] = None,
        max_spans: int = 200,
        trace_id: Optional[str] = None,
        include_open: bool = False,
        limit: Optional[int] = None,
        since: Optional[float] = None,
        context: Optional[dict] = None,
    ) -> Any:
        """Recent spans (control-plane events + sampled request
        traces), newest last. With ``trace_id`` returns that request's
        reconstructed cross-process span tree (remote spans arrive
        piggybacked on RPC results) with a per-stage latency rollup.
        Paginate with ``limit`` (caps the returned spans; alias of
        ``max_spans``) and ``since`` (wall-clock ``started_at`` cursor:
        pass the newest span's ``started_at`` from the previous pull) —
        repeated polling never re-ships the whole buffer. Admin-only."""
        check_permissions(context, self.admin_users, "get_traces")
        from bioengine_tpu_torch.utils.tracing import build_trace_tree, get_spans

        if trace_id is not None:
            return build_trace_tree(trace_id)
        return get_spans(
            name=name,
            max_spans=limit if limit is not None else max_spans,
            include_open=include_open,
            since=since,
        )

    def get_flight_record(
        self,
        limit: Optional[int] = 500,
        since: Optional[float] = None,
        context: Optional[dict] = None,
    ) -> dict:
        """This process's flight-recorder ring: the structured event
        timeline (replica transitions, breaker trips, drains,
        reconnects, compiles, fault hits, slow requests) plus dump
        metadata. ``limit``/``since`` paginate like ``get_traces``.
        Admin-only."""
        check_permissions(context, self.admin_users, "get_flight_record")
        from bioengine_tpu_torch.utils import flight

        return flight.get_record(limit=limit, since=since)

    async def debug_bundle(
        self,
        event_limit: int = 2000,
        max_spans: int = 1000,
        context: Optional[dict] = None,
    ) -> dict:
        """One incident artifact (the ``bioengine debug bundle`` CLI):
        flight records + recent traces + metrics snapshot + mesh/lease
        state from this worker AND every reachable worker host, with
        all flight events time-merged into a single timeline.
        Admin-only."""
        check_permissions(context, self.admin_users, "debug_bundle")
        assert self.controller is not None
        bundle = await self.controller.debug_bundle(
            event_limit=event_limit, max_spans=max_spans
        )
        bundle["worker"] = {
            "rpc_url": self.server.url,
            "service_id": self._service_id,
            "ready": self.is_ready,
            "uptime_seconds": (
                time.monotonic() - self._start_mono if self._start_mono else 0.0
            ),
        }
        return bundle

    def get_metrics(
        self,
        prometheus: bool = False,
        context: Optional[dict] = None,
    ) -> Any:
        """The process-wide metrics registry (utils/metrics.py):
        request latency histograms, transport counters, serving
        gauges. ``prometheus=True`` returns the text exposition format
        (the same body ``GET /metrics`` serves, unauthenticated, for
        scrapers). Admin-only over RPC."""
        check_permissions(context, self.admin_users, "get_metrics")
        from bioengine_tpu_torch.utils import metrics

        if prometheus:
            return metrics.render_prometheus()
        return metrics.collect()

    def get_telemetry(
        self,
        series: Any = None,
        app: Optional[str] = None,
        deployment: Optional[str] = None,
        since: Optional[float] = None,
        resolution: Optional[float] = None,
        context: Optional[dict] = None,
    ) -> dict:
        """Per-deployment telemetry HISTORY from the controller's
        multi-resolution store (request/error rates, latency quantiles
        reconstructed from merged histogram buckets, queue depth,
        chip-seconds, shed counts) — what the live registry forgets,
        `bioengine top` renders, and the SLO engine evaluates.
        Admin-only."""
        check_permissions(context, self.admin_users, "get_telemetry")
        assert self.controller is not None
        return self.controller.get_telemetry(
            series=series,
            app=app,
            deployment=deployment,
            since=since,
            resolution=resolution,
        )

    def get_slo_status(self, context: Optional[dict] = None) -> dict:
        """Burn rates, error-budget remaining, and alert state for
        every deployment carrying a manifest ``slo:`` block, plus
        auto-captured incident-bundle metadata (the ``bioengine slo
        status`` CLI feed). Admin-only."""
        check_permissions(context, self.admin_users, "get_slo_status")
        assert self.controller is not None
        return self.controller.get_slo_status()

    def memory_profile(self, context: Optional[dict] = None) -> dict:
        """Device-memory snapshot (the CUDA caching allocator's
        snapshot, pickled and base64) plus each device's
        ``memory_stats`` — the on-demand analog of the reference
        scraping GPU memory off the Ray dashboard (ref
        cluster/proxy_actor.py:230-287)."""
        check_permissions(context, self.admin_users, "memory_profile")
        from bioengine_tpu_torch.utils import profiling

        return profiling.device_memory_snapshot()

    # ---- status / logs (ref worker.py:1034-1159) ----------------------------

    def get_status(self, context: Optional[dict] = None) -> dict:
        uptime = (
            time.monotonic() - self._start_mono if self._start_mono else 0.0
        )
        apps = {}
        if self.apps_manager:
            try:
                apps = self.apps_manager.get_app_status()
            except Exception as e:
                apps = {"error": str(e)}
        try:
            # control-plane data-plane counters (bytes/frames/chunked
            # sends, encode/decode seconds, shm hit-rate) — the
            # transport half of "is the worker healthy"
            rpc = self.server.describe()
        except Exception as e:
            rpc = {"error": str(e)}
        return {
            "worker": {
                "ready": self.is_ready,
                "start_time": self.start_time,
                "uptime_seconds": uptime,
                "rpc_url": self.server.url,
                "service_id": self._service_id,
                "admin_users": self.admin_users,
                "monitor_errors": self._monitor_errors,
                "geo_location": self._geo_location or {},
            },
            "rpc": rpc,
            "cluster": self.cluster.status,
            # durable control plane: the fencing epoch this controller
            # serves under, its phase (RECOVERING while a restarted
            # controller reconciles), and journal stats when enabled
            "serving": (
                {
                    "epoch": self.controller.epoch,
                    "phase": self.controller.phase,
                    "reconcile": self.controller.reconcile_report,
                    "journal": (
                        self.controller.journal.describe()
                        if self.controller.journal is not None
                        else None
                    ),
                }
                if self.controller is not None
                else None
            ),
            "applications": apps,
            "datasets": {
                "server_url": (
                    self.datasets_server.url
                    if self.datasets_server
                    else (self.datasets_client.server_url or None)
                    if self.datasets_client
                    else None
                ),
                "served_locally": self.datasets_server is not None,
            },
        }

    def get_logs(
        self,
        component: Optional[str] = None,
        max_lines: int = 200,
        context: Optional[dict] = None,
    ) -> dict:
        check_permissions(context, self.admin_users, "get_logs")
        if component is not None:
            return {component: read_log_tail(component, max_lines)}
        return {
            name: read_log_tail(name, max_lines) for name in LOG_FILE_REGISTRY
        }
