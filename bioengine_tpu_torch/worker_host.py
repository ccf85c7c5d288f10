"""Worker host — the process a provisioned node runs to JOIN the cluster.

The reference's analog: a SLURM job starts ``ray start --block`` so the
node joins the head's Ray cluster and Serve can schedule replica actors
onto its GPUs (ref bioengine/cluster/slurm_workers.py:153-296). Here the
join protocol is the framework's own RPC plane:

1. connect to the controller's RPC server (url + admin token — the
   provisioner embeds both in the launch command),
2. register a ``bioengine-host-<id>`` service exposing the replica verbs
   (start_replica / replica_call / replica_health / stop_replica),
3. announce the local chip topology via ``serve-router.register_host``
   so the controller can lease chips and place replicas here.

Replicas are BUILT on this host from the artifact payload the controller
ships (manifest + sources + kwargs — no pickled closures), using the
same AppBuilder + Replica lifecycle as local placement; composition
handles route back through the controller's ``serve-router.route_call``.

Liveness is structural: when this process dies its websocket closes, the
RPC server drops the host service, and the controller's health loop
marks the host dead and re-places its replicas elsewhere.

A CONNECTION drop is not a process death: the client auto-reconnects
with backoff and this host REJOINS the controller — re-registering its
service and announcing its still-warm replicas so the controller can
reconcile (re-adopt whatever it has not yet re-placed). Downloaded
weights and compiled programs survive a control-plane blip instead of
being discarded with the process.

Run: ``python -m bioengine_tpu_torch.worker_host --server-url ws://head:PORT/ws
--token <admin-token>`` (this is exactly what the provisioner's sbatch
script execs, cluster/provisioner.py).

Own copy of ``bioengine_tpu/worker_host.py``. The host takes ``device``
(default ``cuda``; ``"cpu"`` with ``n_devices`` CPU chips for tests): the
topology is detected on it at ``start()``, which raises there without
CUDA. Profiling goes through ``torch.profiler`` and the CUDA allocator.
The compile-cache tier carries the port's kernel libraries
(``utils/compile_cache.py``): a host fetches the fleet's libraries at join
and before each replica build, so a fresh host loads the flash kernel
without running nvcc, and publishes the libraries it built.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import shutil
import socket
import sys
import tempfile
import time
import uuid
from pathlib import Path
from typing import Any, Optional

from bioengine_tpu_torch.rpc import protocol
from bioengine_tpu_torch.rpc.client import ServerConnection, connect_to_server
from bioengine_tpu_torch.testing import faults
from bioengine_tpu_torch.runtime.devices import DeviceLike
from bioengine_tpu_torch.utils import compile_cache, flight
from bioengine_tpu_torch.utils.logger import create_logger


class RouterHandle:
    """Cross-host DeploymentHandle: composition calls from a deployment
    hosted HERE route back through the controller's serve-router (the
    controller then load-balances over that deployment's replicas,
    wherever they live)."""

    def __init__(self, connection: ServerConnection, app_id: str, deployment: str):
        self._connection = connection
        self.app_id = app_id
        self.deployment = deployment

    async def call(self, method: str, *args, **kwargs) -> Any:
        return await self._connection.call(
            "serve-router",
            "route_call",
            self.app_id,
            self.deployment,
            method,
            list(args),
            kwargs,
        )

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)

        async def invoke(*args, **kwargs):
            return await self.call(name, *args, **kwargs)

        invoke.__name__ = name
        return invoke


class WorkerHost:
    def __init__(
        self,
        server_url: str,
        token: Optional[str] = None,
        host_id: Optional[str] = None,
        workspace_dir: str | Path | None = None,
        worker_tag: Optional[str] = None,
        log_file: Optional[str] = "off",
        rejoin: bool = True,
        compile_cache_dir: str | Path | None = None,
        orphan_grace_s: Optional[float] = None,
        device: DeviceLike = "cuda",
        n_devices: Optional[int] = None,
    ):
        self.server_url = server_url
        self.device = device
        self.n_devices = n_devices
        self.token = token
        self.host_id = host_id or f"{socket.gethostname()}-{uuid.uuid4().hex[:6]}"
        self.worker_tag = worker_tag
        self.workspace_dir = Path(
            workspace_dir or tempfile.mkdtemp(prefix="bioengine-host-")
        ).expanduser()
        self._owns_workspace = workspace_dir is None
        self.logger = create_logger(f"host.{self.host_id}", log_file=log_file)
        self.connection: Optional[ServerConnection] = None
        self.replicas: dict[str, Any] = {}
        self.service_id: Optional[str] = None
        self.rejoin = rejoin
        self._stop_event = asyncio.Event()
        self._conn_lost = asyncio.Event()
        # ---- orphan mode + epoch fencing --------------------------------
        # a host that loses its controller keeps serving in-flight and
        # queued work and rejoins with backoff; if the controller stays
        # gone past the grace window the host SELF-DRAINS its replicas
        # (stops burning chips against intent nobody owns). The epoch
        # is the controller's journaled fence: verbs stamped with a
        # LOWER epoch than this host has seen are rejected typed
        # (StaleEpochError) so a revived old controller cannot issue
        # conflicting placements.
        self.orphan_grace_s = (
            orphan_grace_s
            if orphan_grace_s is not None
            else float(os.environ.get("BIOENGINE_ORPHAN_GRACE_S", "600"))
        )
        self.controller_epoch = 0
        self._orphaned_since: Optional[float] = None
        self._orphan_task: Optional[asyncio.Task] = None
        self.orphan_drained = False
        # wall-clock skew to the controller (this host minus the
        # controller), RTT-midpoint estimate refreshed on every
        # join/rejoin — rides register_host and every flight record so
        # merged incident timelines order correctly
        self.clock_skew_s = 0.0
        self._telemetry_task: Optional[asyncio.Task] = None
        # shared compile-cache tier: entries sync between this host's
        # kernel-library cache directory and the controller's tier
        # (fetch at join + before each replica build, publish after
        # builds land). Default = the process-enabled cache dir; tests
        # override to exercise per-host directories in-process.
        self._compile_cache_dir = (
            str(compile_cache_dir) if compile_cache_dir else None
        )
        self._tier_published: set[str] = set()
        self._tier_publish_task: Optional[asyncio.Task] = None
        self.tier_fetched = 0
        self.tier_published_count = 0

    # ---- lifecycle ----------------------------------------------------------

    async def start(self) -> dict:
        from bioengine_tpu_torch.cluster.topology import detect_topology

        # raises here without CUDA on a cuda host, before it connects
        self.topology = detect_topology(self.device, self.n_devices)
        self.connection = await connect_to_server(
            {
                "server_url": self.server_url,
                "token": self.token,
                "reconnect": self.rejoin,
            }
        )
        # connection-lost callback wakes serve_forever IMMEDIATELY (no
        # polling); after the client re-establishes and re-registers the
        # host service, _rejoin_cluster reconciles warm replicas
        self.connection.on_disconnect.append(self._on_connection_lost)
        self.connection.on_reconnect.append(self._rejoin_cluster)
        result = await self.connection.register_service(
            {
                "id": f"bioengine-host-{self.host_id}",
                "name": f"BioEngine worker host {self.host_id}",
                "type": "bioengine-worker-host",
                "config": {"require_context": False, "visibility": "protected"},
                "describe": self.describe,
                "get_metrics": self.get_metrics,
                "get_flight_record": self.get_flight_record,
                "start_profiling": self.start_profiling,
                "stop_profiling": self.stop_profiling,
                "memory_profile": self.memory_profile,
                "start_replica": self.start_replica,
                "replica_call": self.replica_call,
                "replica_stream": self.replica_stream,
                "replica_health": self.replica_health,
                "drain_replica": self.drain_replica,
                "stop_replica": self.stop_replica,
                "run_code": self.run_code,
                "shutdown": self.shutdown,
            }
        )
        self.service_id = result["id"]
        # process self-metrics for THIS host process (its /metrics ride
        # the controller's get_metrics pull + incident bundles)
        from bioengine_tpu_torch.utils import metrics as _metrics
        from bioengine_tpu_torch.utils.tasks import spawn_supervised

        _metrics.install_process_metrics()
        self._loop_lag_task = spawn_supervised(
            _metrics.monitor_event_loop(),
            name="event-loop-lag-monitor",
            logger=self.logger,
        )
        joined = await self._register_host()
        # pull the fleet's compiled programs BEFORE any replica lands
        # here — a fresh autoscaled host starts with the tier's entries
        # in its local persistent cache, so its first compile is a disk
        # read; publish whatever this host already has in return, and
        # keep publishing periodically (compiles land AFTER start_replica
        # returns: background test_deployment, lazily-compiled hot-path
        # shapes — a start-time-only publish would miss all of them)
        await self._sync_compile_cache()
        await self._publish_compile_cache()
        self._tier_publish_task = spawn_supervised(
            self._tier_publish_loop(),
            name="compile-tier-publish",
            logger=self.logger,
        )
        # push-telemetry (capability telem1, same negotiation pattern as
        # oob1/trace1): periodic registry-delta snapshots to the
        # controller's store. A legacy control plane that never
        # advertised telem1 keeps working scrape-only.
        if self.connection.peer_supports(protocol.PROTO_TELEM1):
            self._telemetry_task = spawn_supervised(
                self._telemetry_loop(),
                name="telemetry-push",
                logger=self.logger,
            )
        self.logger.info(
            f"joined cluster as '{self.host_id}' "
            f"({self.topology.n_chips} chips): {joined}"
        )
        return joined

    async def _measure_clock_skew(self) -> None:
        """RTT-midpoint wall-clock offset to the controller; failure
        keeps the previous estimate (never blocks a join)."""
        try:
            probe = await self.connection.measure_clock_offset()
            # offset = controller minus us; skew = us minus controller
            self.clock_skew_s = -probe["offset_s"]
        except Exception as e:  # noqa: BLE001 — a join must not die on a probe
            self.logger.debug(f"clock-skew probe failed (tolerated): {e}")

    async def _register_host(self) -> dict:
        # NB: positional — kwargs named service_id/method would collide
        # with ServerConnection.call's own parameters
        await self._measure_clock_skew()
        # early fence: the welcome handshake advertises the controller
        # epoch — refuse to register with a REVIVED OLD controller
        # (lower epoch than this host has already served under) before
        # any verbs flow
        peer_epoch = getattr(self.connection, "peer_epoch", None)
        if peer_epoch is not None:
            self._check_epoch(int(peer_epoch), "register_host")
        result = await self.connection.call(
            "serve-router",
            "register_host",
            self.host_id,
            self.service_id,
            self.topology.as_dict(),
            self.worker_tag,
            self._replica_inventory(),
            self.clock_skew_s,
        )
        epoch = result.get("epoch") if isinstance(result, dict) else None
        if epoch is not None:
            self._check_epoch(int(epoch), "register_host")
        return result

    def _check_epoch(self, epoch: Optional[int], verb: str) -> None:
        """Epoch fencing: reject verbs from a controller epoch LOWER
        than the highest this host has seen; ratchet forward on higher.
        ``None`` means a legacy (pre-fencing) controller — accepted, so
        mixed-version fleets keep working."""
        if epoch is None:
            return
        epoch = int(epoch)
        if epoch < self.controller_epoch:
            from bioengine_tpu_torch.serving.errors import StaleEpochError

            flight.record(
                "host.fenced",
                severity="warning",
                host=self.host_id,
                verb=verb,
                got_epoch=epoch,
                seen_epoch=self.controller_epoch,
            )
            raise StaleEpochError(
                f"host '{self.host_id}' rejects {verb} from stale "
                f"controller epoch {epoch} (already serving epoch "
                f"{self.controller_epoch})",
                seen_epoch=self.controller_epoch,
                got_epoch=epoch,
            )
        if epoch > self.controller_epoch:
            self.controller_epoch = epoch

    async def _telemetry_loop(self) -> None:
        """Push periodic metric-delta snapshots (utils/telemetry.py
        RegistrySampler over THIS process's registry: replica latency
        histograms, chip-seconds) to the controller's telemetry store.
        A push failure is tolerated — the next interval retries, and a
        reconnect resumes pushing against the healed session."""
        from bioengine_tpu_torch.utils.telemetry import RegistrySampler

        interval = float(os.environ.get("BIOENGINE_TELEM_PUSH_S", "10"))
        sampler = RegistrySampler()
        sampler.sample()  # establish the delta baseline
        while not self._stop_event.is_set():
            await asyncio.sleep(interval)
            if self.connection is None or not self.connection.connected:
                continue
            try:
                snapshot = sampler.sample()
                if snapshot:
                    await self.connection.call(
                        "serve-router",
                        "push_telemetry",
                        self.host_id,
                        snapshot,
                    )
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — telemetry is best-effort
                self.logger.debug(f"telemetry push failed (tolerated): {e}")

    # ---- shared compile-cache tier ------------------------------------------

    def _cache_dir(self) -> Optional[str]:
        return self._compile_cache_dir or compile_cache.enabled_dir()

    async def _sync_compile_cache(self) -> None:
        """Fetch tier entries this host's local persistent cache lacks.
        Entry names are jax's own on-disk keys, so an installed file IS
        a local cache hit. A legacy controller without the verbs (or a
        disabled local cache) degrades to a no-op, never an error."""
        directory = self._cache_dir()
        if directory is None or self.connection is None:
            return
        try:
            listing = await self.connection.call(
                "serve-router", "compile_cache_list"
            )
        except Exception as e:  # noqa: BLE001 — tier is best-effort
            self.logger.debug(f"compile tier list failed (tolerated): {e}")
            return
        local = compile_cache.list_entries(directory)
        fetched = 0
        for name in listing or {}:
            if name in local:
                continue
            try:
                blob = await self.connection.call(
                    "serve-router", "compile_cache_fetch", name
                )
            except Exception as e:  # noqa: BLE001 — tier is best-effort
                self.logger.debug(
                    f"compile tier fetch failed (tolerated): {e}"
                )
                return
            if not blob:
                continue
            if compile_cache.write_entry(name, bytes(blob), directory):
                fetched += 1
                self.tier_fetched += 1
                self._tier_published.add(name)  # never re-publish a fetch
                compile_cache.TIER_FETCHES.inc()
                compile_cache.TIER_FETCH_BYTES.inc(len(blob))
                flight.record(
                    "program.cache_fetch",
                    host=self.host_id,
                    entry=name[:120],
                    bytes=len(blob),
                )
        if fetched:
            self.logger.info(
                f"compile tier: fetched {fetched} compiled-program "
                f"entries into {directory}"
            )

    async def _publish_compile_cache(self) -> None:
        """Publish locally-compiled entries the tier lacks (idempotent:
        a name is offered at most once per host lifetime; the tier
        keeps its first copy)."""
        directory = self._cache_dir()
        if directory is None or self.connection is None:
            return
        try:
            have = set(
                await self.connection.call(
                    "serve-router", "compile_cache_list"
                )
                or {}
            )
        except Exception as e:  # noqa: BLE001 — tier is best-effort
            self.logger.debug(f"compile tier list failed (tolerated): {e}")
            return
        for name in compile_cache.list_entries(directory):
            if name in have or name in self._tier_published:
                continue
            # compiled-program blobs run to tens of MB — read off-loop
            blob = await asyncio.to_thread(
                compile_cache.read_entry, name, directory
            )
            if blob is None:
                continue
            try:
                result = await self.connection.call(
                    "serve-router", "compile_cache_publish", name, blob
                )
            except Exception as e:  # noqa: BLE001 — tier is best-effort
                self.logger.debug(
                    f"compile tier publish failed (tolerated): {e}"
                )
                return
            self._tier_published.add(name)
            if isinstance(result, dict) and result.get("stored"):
                self.tier_published_count += 1
                compile_cache.TIER_PUBLISHES.inc()
                compile_cache.TIER_PUBLISH_BYTES.inc(len(blob))

    async def _tier_publish_loop(self) -> None:
        """Periodic publish of NEW local cache entries
        (``BIOENGINE_COMPILE_TIER_PUBLISH_S``, default 30 s). The cheap
        local listing gates the RPC: no new entries, no round trip."""
        interval = float(
            os.environ.get("BIOENGINE_COMPILE_TIER_PUBLISH_S", "30")
        )
        while not self._stop_event.is_set():
            await asyncio.sleep(interval)
            if self.connection is None or not self.connection.connected:
                continue
            directory = self._cache_dir()
            if directory is None:
                continue
            if all(
                name in self._tier_published
                for name in compile_cache.list_entries(directory)
            ):
                continue
            try:
                await self._publish_compile_cache()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — tier is best-effort
                self.logger.debug(
                    f"periodic tier publish failed (tolerated): {e}"
                )

    def _replica_inventory(self) -> list[dict]:
        return [
            {
                "replica_id": rid,
                "app_id": r.app_id,
                "deployment": r.deployment_name,
                "state": r.state.value,
                "device_ids": list(r.device_ids),
                # mesh shards carry their stage identity (incl. the
                # parent mesh replica id) so a RECOVERING controller
                # can rebuild the MeshReplica around surviving shards
                "mesh_shard": (
                    dict(r.mesh_shard)
                    if getattr(r, "mesh_shard", None)
                    else None
                ),
            }
            for rid, r in self.replicas.items()
        ]

    def _on_connection_lost(self) -> None:
        self._conn_lost.set()
        if self._stop_event.is_set() or not self.rejoin:
            return
        if self._orphaned_since is None:
            # ORPHAN MODE: keep serving in-flight + queued work against
            # warm replicas; the reconnect loop rejoins with backoff.
            # The grace window bounds how long leased chips serve
            # intent nobody owns before the host self-drains.
            self._orphaned_since = time.monotonic()
            self.logger.warning(
                f"controller connection lost; serving orphaned "
                f"({len(self.replicas)} warm replicas, self-drain in "
                f"{self.orphan_grace_s:.0f}s unless rejoined)"
            )
            flight.record(
                "host.orphaned",
                severity="warning",
                host=self.host_id,
                replicas=len(self.replicas),
                grace_s=self.orphan_grace_s,
            )
            if self.orphan_grace_s > 0:
                from bioengine_tpu_torch.utils.tasks import spawn_supervised

                self._orphan_task = spawn_supervised(
                    self._orphan_watch(),
                    name=f"orphan-watch-{self.host_id}",
                    logger=self.logger,
                )

    async def _orphan_watch(self) -> None:
        """Self-protection: if the controller stays gone past the grace
        window, drain and stop every replica — in-flight work finishes,
        then the chips stop serving orphaned intent. The process keeps
        running (and rejoining); a later controller re-places fresh."""
        while True:
            since = self._orphaned_since
            if since is None or self._stop_event.is_set():
                return  # rejoined (or shutting down) before the window closed
            remaining = self.orphan_grace_s - (time.monotonic() - since)
            if remaining <= 0:
                break
            await asyncio.sleep(min(remaining, 1.0))
        if self._orphaned_since is None:
            return
        self.logger.warning(
            f"orphan grace ({self.orphan_grace_s:.0f}s) expired; "
            f"self-draining {len(self.replicas)} replicas"
        )
        flight.record(
            "host.orphan_drain",
            severity="warning",
            host=self.host_id,
            replicas=len(self.replicas),
            grace_s=self.orphan_grace_s,
        )
        for rid in list(self.replicas):
            replica = self.replicas.get(rid)
            if replica is None:
                continue
            try:
                await replica.drain()
            except Exception as e:  # noqa: BLE001 — drain is best effort here
                self.logger.debug(f"orphan drain of {rid}: {e}")
            await self.stop_replica(rid)
        self.orphan_drained = True

    def _orphan_recovered(self) -> float:
        """Back under a controller: cancel the self-drain watchdog.
        Returns how long the orphan gap lasted (0.0 if none)."""
        gap = (
            time.monotonic() - self._orphaned_since
            if self._orphaned_since is not None
            else 0.0
        )
        self._orphaned_since = None
        if self._orphan_task is not None:
            self._orphan_task.cancel()
            self._orphan_task = None
        return gap

    async def _rejoin_cluster(self) -> None:
        """After the RPC client re-established + re-registered our
        service: announce ourselves to the controller again, with the
        still-warm replica inventory. The controller re-adopts what it
        has not yet re-placed and tells us to drop the rest."""
        prev_epoch = self.controller_epoch
        joined = await self._register_host()
        gap_s = self._orphan_recovered()
        dropped = joined.get("drop_replicas") or []
        for rid in dropped:
            self.logger.info(
                f"controller re-placed replica {rid} while we were away; "
                f"discarding the local copy"
            )
            await self.stop_replica(rid)
        self.logger.info(
            f"rejoined cluster as '{self.host_id}' "
            f"(kept {len(self.replicas)} warm replicas, "
            f"dropped {len(dropped)}, epoch {self.controller_epoch})"
        )
        flight.record(
            "host.rejoin",
            host=self.host_id,
            kept=len(self.replicas),
            dropped=len(dropped),
        )
        # the incident-timeline pair of host.orphaned: which controller
        # EPOCH the host came back under (a restart bumps it; a blip of
        # the same controller keeps it), and how long the gap was
        flight.record(
            "host.rejoined_epoch",
            host=self.host_id,
            prev_epoch=prev_epoch,
            epoch=self.controller_epoch,
            orphan_gap_s=round(gap_s, 3),
            kept=len(self.replicas),
        )

    async def serve_forever(self) -> None:
        """Block until shutdown. A dropped control-plane connection
        wakes this loop immediately (connection-lost callback, not a
        poll): with ``rejoin`` enabled the RPC client heals the session
        in the background and we keep serving warm replicas; without it
        we exit so a supervisor/provisioner can restart us."""
        while not self._stop_event.is_set():
            stop_w = asyncio.ensure_future(self._stop_event.wait())
            lost_w = asyncio.ensure_future(self._conn_lost.wait())
            try:
                await asyncio.wait(
                    {stop_w, lost_w}, return_when=asyncio.FIRST_COMPLETED
                )
            finally:
                for w in (stop_w, lost_w):
                    if not w.done():
                        w.cancel()
            if self._stop_event.is_set():
                return
            if self._conn_lost.is_set():
                self._conn_lost.clear()
                if not self.rejoin:
                    self.logger.warning(
                        "control-plane connection lost; exiting"
                    )
                    return
                self.logger.warning(
                    "control-plane connection lost; auto-rejoin in progress"
                )

    async def stop(self) -> None:
        self._stop_event.set()
        if self._orphan_task is not None:
            self._orphan_task.cancel()
            self._orphan_task = None
        if self._telemetry_task is not None:
            self._telemetry_task.cancel()
            self._telemetry_task = None
        if self._tier_publish_task is not None:
            self._tier_publish_task.cancel()
            self._tier_publish_task = None
        if getattr(self, "_loop_lag_task", None):
            self._loop_lag_task.cancel()
            self._loop_lag_task = None
        for replica_id in list(self.replicas):
            await self.stop_replica(replica_id)
        if self.connection is not None:
            try:
                await self.connection.call(
                    "serve-router", "deregister_host", self.host_id
                )
            except Exception as e:  # noqa: BLE001 — controller may be gone
                self.logger.debug(f"deregister_host failed (tolerated): {e}")
            await self.connection.disconnect()
            self.connection = None
        if self._owns_workspace:
            await asyncio.to_thread(
                shutil.rmtree, self.workspace_dir, ignore_errors=True
            )
        self._stop_event.set()

    def shutdown(self) -> dict:
        asyncio.get_running_loop().call_soon(self._stop_event.set)
        return {"host_id": self.host_id, "stopping": True}

    # ---- replica verbs (called by the controller over RPC) ------------------

    async def start_replica(
        self,
        replica_id: str,
        payload: dict,
        device_ids: Optional[list[int]] = None,
        max_ongoing_requests: int = 10,
        mesh_shard: Optional[dict] = None,
        epoch: Optional[int] = None,
    ) -> dict:
        """Build the deployment instance from the shipped artifact
        payload and run the standard replica lifecycle chain."""
        from bioengine_tpu_torch.apps.builder import AppBuilder
        from bioengine_tpu_torch.serving.replica import Replica

        self._check_epoch(epoch, "start_replica")
        if faults.ACTIVE:
            await faults.hit("host.start_replica", scope=self.host_id)

        if mesh_shard is not None and not (
            self.connection is not None
            and self.connection.peer_supports(protocol.PROTO_MESH1)
        ):
            # a mesh shard only makes sense under a controller that
            # speaks the mesh1 contract (it drives our stage calls and
            # owns the cross-shard composition) — refuse loudly rather
            # than serve a partial model as if it were whole
            raise RuntimeError(
                f"host '{self.host_id}' was handed a mesh_shard but the "
                f"control plane never negotiated '{protocol.PROTO_MESH1}'"
            )

        # tier entries published since our join (another host's compile
        # of the same model) turn this replica's compiles into disk
        # reads — worth one cheap list round trip before a 20-40 s build
        await self._sync_compile_cache()

        app_id = payload["app_id"]
        deployment = payload["deployment"]
        app_src = self.workspace_dir / "artifacts" / f"{app_id}-{replica_id}"
        app_src.mkdir(parents=True, exist_ok=True)
        for rel, text in payload["files"].items():
            target = app_src / rel
            if not target.resolve().is_relative_to(app_src.resolve()):
                raise ValueError(f"payload path escapes app dir: {rel}")
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_text(text)

        builder = AppBuilder(workdir_root=self.workspace_dir / "apps")
        conn = self.connection
        built = builder.build(
            app_id=app_id,
            local_path=app_src,
            deployment_kwargs=payload.get("deployment_kwargs"),
            env_vars=payload.get("env_vars"),
            make_handle=lambda name, a=app_id: RouterHandle(conn, a, name),
        )
        spec = next(s for s in built.specs if s.name == deployment)
        replica = Replica(
            app_id=app_id,
            deployment_name=deployment,
            instance_factory=spec.instance_factory,
            device_ids=list(device_ids or []),
            max_ongoing_requests=max_ongoing_requests,
            # the shipped manifest carries the operator's batching knobs
            # (deployment_config.<dep>.batching) — the host-side build
            # re-derives the same spec, so remote replicas honor them
            # identically to local ones
            batch_config=spec.batch_config(),
            mesh_shard=mesh_shard,
        )
        replica.replica_id = replica_id  # controller's id IS the identity
        try:
            await replica.start()
        except Exception:
            self.replicas.pop(replica_id, None)
            raise
        self.replicas[replica_id] = replica
        self.logger.info(
            f"replica {replica_id} ({app_id}/{deployment}) started "
            f"(state={replica.state})"
        )
        # whatever this replica's build just compiled belongs to the
        # fleet — publish in the background, off the start critical path
        from bioengine_tpu_torch.utils.tasks import spawn_supervised as _spawn

        _spawn(
            self._publish_compile_cache(),
            name=f"compile-tier-publish-{replica_id}",
            logger=self.logger,
        )
        return {"replica_id": replica_id, "state": replica.state.value}

    def _get(self, replica_id: str):
        replica = self.replicas.get(replica_id)
        if replica is None:
            raise KeyError(f"no replica '{replica_id}' on host {self.host_id}")
        return replica

    async def replica_call(
        self,
        replica_id: str,
        method: str,
        args: list,
        kwargs: dict,
        timeout_s: Optional[float] = None,
    ) -> Any:
        """Serve one routed call. ``timeout_s`` is the caller's
        propagated remaining budget: the work is aborted HERE when it
        expires, not just abandoned by the controller."""
        if faults.ACTIVE:
            await faults.hit(
                "host.replica_call", drop=self._abort_connection,
                scope=self.host_id,
            )
        replica = self._get(replica_id)
        if method == "__batch__":
            # a controller-coalesced group: args = [real_method,
            # [member payloads]]; the host fans members out through the
            # replica's normal per-call path and returns wire-safe
            # per-member envelopes in the same RESULT frame — K
            # requests, one round trip
            real_method, requests = args[0], args[1]
            return await replica.call_batch(
                real_method, requests, timeout_s=timeout_s, wire=True
            )
        coro = replica.call(method, *(args or []), **(kwargs or {}))
        if timeout_s is None:
            return await coro
        return await asyncio.wait_for(coro, timeout_s)

    async def replica_stream(
        self,
        replica_id: str,
        method: str,
        args: list,
        kwargs: dict,
        item_timeout_s: Optional[float] = None,
    ):
        """Streaming twin of :meth:`replica_call`: an async-generator
        service verb — the RPC plane's stream1 machinery sends each
        yielded item as its own frame (token-sized payloads ride the
        fast-frame path). ``item_timeout_s`` bounds the gap BETWEEN
        items, not the whole generation: a 10k-token stream is healthy
        as long as tokens keep flowing."""
        if faults.ACTIVE:
            await faults.hit(
                "host.replica_stream", drop=self._abort_connection,
                scope=self.host_id,
            )
        replica = self._get(replica_id)
        agen = replica.call_stream(method, *(args or []), **(kwargs or {}))
        try:
            while True:
                nxt = agen.__anext__()
                if item_timeout_s is not None:
                    nxt = asyncio.wait_for(nxt, item_timeout_s)
                try:
                    item = await nxt
                except StopAsyncIteration:
                    break
                yield item
        finally:
            await agen.aclose()

    async def _abort_connection(self) -> None:
        """Fault-injection hook: sever our control-plane websocket as a
        network partition would (reconnect/rejoin machinery takes over)."""
        if self.connection is not None:
            await self.connection._abort_connection()

    async def replica_health(self, replica_id: str) -> dict:
        replica = self._get(replica_id)
        state = await replica.check_health()
        return {
            "replica_id": replica_id,
            "state": state.value,
            "last_error": replica.last_error,
        }

    async def drain_replica(
        self,
        replica_id: str,
        timeout_s: Optional[float] = None,
        epoch: Optional[int] = None,
    ) -> dict:
        """Reject new calls on the replica, wait (bounded) for its
        in-flight requests to finish."""
        self._check_epoch(epoch, "drain_replica")
        replica = self.replicas.get(replica_id)
        if replica is None:
            return {"replica_id": replica_id, "drained": True, "known": False}
        drained = await replica.drain(timeout_s)
        return {"replica_id": replica_id, "drained": drained, "known": True}

    async def run_code(
        self,
        payload: bytes,
        device_ids: Optional[list[int]] = None,
        env_vars: Optional[dict] = None,
        cwd: Optional[str] = None,
        timeout: float = 180.0,
    ) -> dict:
        """Execute a controller-dispatched run_code payload on THIS
        host's leased chips (the TPU analog of a Ray task landing on a
        cluster node with per-call resources, ref
        bioengine/worker/code_executor.py:469-487). The service is
        ``visibility: protected`` so only admin callers reach it."""
        from bioengine_tpu_torch.worker.code_executor import (
            chip_env,
            run_payload_subprocess,
        )

        env = {
            **os.environ,
            "BIOENGINE_HOST_ID": self.host_id,
            **chip_env(list(device_ids or [])),
            **(env_vars or {}),
        }
        return await run_payload_subprocess(
            bytes(payload), env, cwd, timeout
        )

    async def stop_replica(
        self, replica_id: str, epoch: Optional[int] = None
    ) -> dict:
        self._check_epoch(epoch, "stop_replica")
        replica = self.replicas.pop(replica_id, None)
        if replica is not None:
            await replica.stop()
        return {"replica_id": replica_id, "stopped": replica is not None}

    def get_metrics(self, prometheus: bool = False) -> Any:
        """This host process's metrics registry (replica latency
        histograms, transport counters) — the controller can pull every
        host's snapshot next to its own. Service is visibility:
        protected, so only admin callers reach it."""
        from bioengine_tpu_torch.utils import metrics

        if prometheus:
            return metrics.render_prometheus()
        return metrics.collect()

    def get_flight_record(
        self, limit: Optional[int] = 500, since: Optional[float] = None
    ) -> dict:
        """This host process's flight-recorder events + dump metadata,
        stamped with its host_id so the controller's time-merged
        incident bundle can attribute every event. Protected service —
        admin callers only."""
        record = flight.get_record(limit=limit, since=since)
        record["host_id"] = self.host_id
        # measured at the last join/rejoin handshake: merge_records
        # shifts these events onto the controller's timeline with it
        record["clock_skew_s"] = round(self.clock_skew_s, 6)
        return record

    # ---- on-demand device profiling (routed here by the controller so
    # an operator can profile ONE replica of a live deployment) ----------

    def start_profiling(self, trace_dir: Optional[str] = None) -> dict:
        """Start a torch.profiler trace (CPU and CUDA activity) covering
        everything this host process executes (its replicas included);
        ``stop_profiling`` writes it as ``trace.json`` in the Chrome
        trace format, every kernel launch an event of category
        ``kernel``. One trace at a time per process — the profiler is
        process-global."""
        from bioengine_tpu_torch.utils import profiling

        self._profile_dir = profiling.start_trace(
            self.workspace_dir, trace_dir, getattr(self, "_profile_dir", None)
        )
        self.logger.info(f"profiling started -> {self._profile_dir}")
        return {
            "host_id": self.host_id,
            "trace_dir": self._profile_dir,
            "profiling": True,
        }

    def stop_profiling(self) -> dict:
        """Stop the trace and write ``<trace_dir>/trace.json``."""
        from bioengine_tpu_torch.utils import profiling

        trace_dir = profiling.stop_trace(getattr(self, "_profile_dir", None))
        self._profile_dir = None
        self.logger.info(f"profiling stopped -> {trace_dir}")
        return {
            "host_id": self.host_id,
            "trace_dir": trace_dir,
            "profiling": False,
        }

    def memory_profile(self) -> dict:
        """Device-memory snapshot: the CUDA caching allocator's snapshot
        (pickled, base64) and each card's name and ``memory_stats`` —
        the device memory the replicas this host serves hold."""
        from bioengine_tpu_torch.utils import profiling

        return {
            "host_id": self.host_id,
            **profiling.device_memory_snapshot(),
        }

    def describe(self) -> dict:
        d = {
            "host_id": self.host_id,
            "worker_tag": self.worker_tag,
            "controller_epoch": self.controller_epoch,
            "orphaned": self._orphaned_since is not None,
            "orphan_drained": self.orphan_drained,
            "topology": self.topology.as_dict(),
            "replicas": {
                rid: r.describe() for rid, r in self.replicas.items()
            },
            "compile_tier": {
                "cache_dir": self._cache_dir(),
                "fetched": self.tier_fetched,
                "published": self.tier_published_count,
            },
        }
        if self.connection is not None:
            # transport counters for the host<->controller link: on a
            # shared machine the shm hit-rate here is the signal that
            # replica payloads are riding the fast path
            d["transport"] = self.connection.describe()
        return d


def main(argv: Optional[list[str]] = None) -> int:
    import signal

    parser = argparse.ArgumentParser(
        description="Join a BioEngine cluster as a worker host on NVIDIA GPUs"
    )
    parser.add_argument(
        "--server-url",
        default=os.environ.get("BIOENGINE_SERVER_URL"),
        help="controller RPC url (ws://host:port/ws); "
        "env BIOENGINE_SERVER_URL",
    )
    parser.add_argument(
        "--token",
        default=os.environ.get("BIOENGINE_ADMIN_TOKEN"),
        help="admin token for the control plane; env BIOENGINE_ADMIN_TOKEN",
    )
    parser.add_argument("--host-id", default=None)
    parser.add_argument("--worker-tag", default=None,
                        help="provisioner job tag (for targeted scale-down)")
    parser.add_argument("--workspace-dir", default=None)
    parser.add_argument(
        "--device",
        default="cuda",
        help="device the host serves from: 'cuda' (default; raises "
        "without CUDA) or 'cpu' for hermetic tests",
    )
    parser.add_argument(
        "--n-devices",
        type=int,
        default=None,
        help="chips to announce (default: every CUDA device; 1 on cpu)",
    )
    args = parser.parse_args(argv)
    if not args.server_url:
        parser.error("--server-url (or BIOENGINE_SERVER_URL) is required")
    from bioengine_tpu_torch.utils.compile_cache import (
        enable_persistent_compilation_cache,
    )

    enable_persistent_compilation_cache()

    async def run() -> int:
        host = WorkerHost(
            server_url=args.server_url,
            token=args.token,
            host_id=args.host_id,
            workspace_dir=args.workspace_dir,
            worker_tag=args.worker_tag,
            rejoin=os.environ.get("BIOENGINE_HOST_REJOIN", "1") != "0",
            device=args.device,
            n_devices=args.n_devices,
        )
        # SIGTERM/SIGINT stop the host gracefully (replicas stopped, the
        # host deregistered, exit 0), as the worker's CLI does
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, host._stop_event.set)
        await host.start()
        try:
            await host.serve_forever()
        finally:
            await host.stop()
        return 0

    return asyncio.run(run())


if __name__ == "__main__":
    sys.exit(main())
