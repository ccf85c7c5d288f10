"""RemoteReplica — an RPC-backed replica living on a joined worker host.

Duck-types :class:`bioengine_tpu_torch.serving.replica.Replica` so the
controller's deploy / health / routing paths treat local and remote
replicas identically — the analog of Ray Serve scheduling replica actors
onto SLURM-joined worker nodes (ref bioengine/apps/manager.py:355-455,
bioengine/cluster/slurm_workers.py:153-296). The instance is built ON
the host from a shipped artifact payload (manifest + sources + kwargs —
never pickled closures), so hosts need no shared filesystem.

Host death is detected three ways: the RPC server drops a host's
service the moment its websocket closes (so in-flight calls raise
``ConnectionError`` instead of timing out), ``check_health`` maps any
transport error to UNHEALTHY, and the controller's per-replica circuit
breaker ejects a replica after K consecutive transport failures
without waiting for the next health tick. A host that RECONNECTS
before its replicas are re-placed re-adopts them via
``serve-router.register_host`` reconciliation (warm weights and
compiled programs survive the blip).
"""

from __future__ import annotations

import asyncio
import time
import uuid
from typing import Any, Callable, Optional

from bioengine_tpu_torch.serving.errors import ReplicaUnavailableError
from bioengine_tpu_torch.serving.replica import (
    DEFAULT_DRAIN_TIMEOUT_S,
    ROUTABLE_STATES,
    ReplicaState,
    ReplicaStateMixin,
)
from bioengine_tpu_torch.utils import flight, tracing


class RemoteReplica(ReplicaStateMixin):
    is_remote = True

    def __init__(
        self,
        app_id: str,
        deployment_name: str,
        host_id: str,
        host_service_id: str,
        call_host: Callable[..., Any],     # async (service_id, method, *args, **kw)
        payload: dict,
        device_ids: Optional[list[int]] = None,
        max_ongoing_requests: int = 10,
        log_sink: Optional[Callable[[str, str], None]] = None,
        drain_timeout_s: float = DEFAULT_DRAIN_TIMEOUT_S,
        stream_host: Optional[Callable[..., Any]] = None,  # async-gen (service_id, method, *args, **kw)
    ):
        self.app_id = app_id
        self.deployment_name = deployment_name
        self.replica_id = f"{deployment_name}-{uuid.uuid4().hex[:8]}"
        self.host_id = host_id
        self.host_service_id = host_service_id
        self.device_ids = device_ids or []
        self.max_ongoing_requests = max_ongoing_requests
        self.drain_timeout_s = drain_timeout_s
        self.state = ReplicaState.STARTING
        self.started_at = time.time()
        self._started_mono = time.monotonic()
        self.last_error: Optional[str] = None
        self._payload = payload
        self._call_host = call_host
        self._stream_host = stream_host
        self._ongoing = 0
        self._total_requests = 0
        self._idle_event = asyncio.Event()
        self._idle_event.set()
        self._log_sink = log_sink
        # controller-side TTFR view of a remote replica: coarse by
        # design (the host-side Replica owns the fine breakdown via its
        # own describe) — what promotion re-anchors is the span the
        # warm pool is accountable for
        self.ttfr: dict[str, Any] = {}
        self.promoted_from_warm_pool = False
        self._first_request_done = False

    def _log(self, line: str) -> None:
        if self._log_sink:
            self._log_sink(self.replica_id, line)

    # ---- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        self._log(f"placing replica on host {self.host_id}")
        try:
            result = await self._call_host(
                self.host_service_id,
                "start_replica",
                replica_id=self.replica_id,
                device_ids=self.device_ids,
                max_ongoing_requests=self.max_ongoing_requests,
                payload=self._payload,
            )
            self.state = ReplicaState(result["state"])
            self.ttfr["init_seconds"] = round(
                time.monotonic() - self._started_mono, 4
            )
            self._log(f"remote replica started (state={self.state})")
        except Exception as e:
            self.last_error = str(e)[-2000:]
            self.state = ReplicaState.UNHEALTHY
            self._log(f"remote start failed: {e}")
            raise

    async def check_health(self) -> ReplicaState:
        if self.state in (
            ReplicaState.STOPPED,
            ReplicaState.UNHEALTHY,
            ReplicaState.DRAINING,
        ):
            return self.state
        try:
            result = await asyncio.wait_for(
                self._call_host(
                    self.host_service_id, "replica_health", self.replica_id
                ),
                timeout=30.0,
            )
            reported = ReplicaState(result["state"])
            # PROBATION is a CONTROLLER verdict the host-side replica
            # never hears about — a host reporting "healthy" is exactly
            # what gray failure looks like, so it must not clear the
            # soft ejection (latency evidence from probe traffic does);
            # any non-routable host-side state still wins
            if not (
                self.state == ReplicaState.PROBATION
                and reported in (ReplicaState.HEALTHY, ReplicaState.TESTING)
            ):
                self.state = reported
            if result.get("last_error"):
                self.last_error = result["last_error"]
        except Exception as e:
            # transport failure == host gone; the controller restarts us
            # elsewhere exactly like a crashed local replica
            self.last_error = f"host '{self.host_id}' unreachable: {e}"
            self.state = ReplicaState.UNHEALTHY
            self._log(self.last_error)
        return self.state

    async def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Stop routing new calls here; ask the host to finish what's
        in flight (bounded). Host-side drain failures are tolerated —
        a dead host has trivially drained."""
        if self.state in ROUTABLE_STATES + (ReplicaState.INITIALIZING,):
            self.state = ReplicaState.DRAINING
            self._log(f"draining ({self._ongoing} in-flight)")
            flight.record(
                "replica.drain",
                replica=self.replica_id,
                app=self.app_id,
                deployment=self.deployment_name,
                host=self.host_id,
                in_flight=self._ongoing,
            )
        timeout = self.drain_timeout_s if timeout_s is None else timeout_s
        started = time.monotonic()
        try:
            await asyncio.wait_for(
                self._call_host(
                    self.host_service_id,
                    "drain_replica",
                    self.replica_id,
                    timeout,
                ),
                timeout=timeout + 5.0,
            )
        except Exception as e:  # noqa: BLE001 — a dead host has trivially drained
            self._log(f"host-side drain failed (tolerated): {e}")
        # calls routed through THIS object (the only routing path) must
        # also settle before the replica is torn down — on whatever is
        # LEFT of the one drain budget, not a second full helping
        if self._ongoing == 0:
            return True
        remaining = max(0.0, timeout - (time.monotonic() - started))
        try:
            await asyncio.wait_for(self._idle_event.wait(), remaining)
            return True
        except asyncio.TimeoutError:
            self._log(f"drain timed out ({self._ongoing} stranded)")
            return False

    async def stop(self, drain_timeout_s: Optional[float] = None) -> None:
        if self.state in (
            ReplicaState.HEALTHY,
            ReplicaState.TESTING,
            ReplicaState.PROBATION,
            ReplicaState.DRAINING,
        ):
            await self.drain(drain_timeout_s)
        self.state = ReplicaState.STOPPED
        try:
            await asyncio.wait_for(
                self._call_host(
                    self.host_service_id, "stop_replica", self.replica_id
                ),
                timeout=15.0,
            )
        except Exception as e:  # noqa: BLE001 — host already gone is stopped
            self._log(f"host-side stop failed (tolerated): {e}")
        self._log("remote replica stopped")

    # ---- request path -------------------------------------------------------

    async def call(self, method: str, *args, **kwargs) -> Any:
        return await self.call_bounded(method, args, kwargs)

    async def call_bounded(
        self,
        method: str,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        timeout_s: Optional[float] = None,
    ) -> Any:
        """Route one call to the host, propagating the remaining time
        budget so the HOST aborts the work too (not just the caller's
        await) when the deadline passes."""
        if self.state not in ROUTABLE_STATES:
            raise ReplicaUnavailableError(
                f"replica {self.replica_id} not healthy ({self.state})"
            )
        self._ongoing += 1
        self._idle_event.clear()
        self._total_requests += 1
        try:
            extra: dict = {}
            if timeout_s is not None:
                # host enforces timeout_s around the instance call; the
                # transport timeout gets slack so the host's (typed)
                # TimeoutError wins the race over a bare client timeout
                extra = {"timeout_s": timeout_s, "rpc_timeout": timeout_s + 5.0}
            # the sampled trace context crosses to the host inside the
            # RPC envelope (server.call_service_method reads the
            # contextvar); this span is the controller-side view of the
            # whole remote hop (encode + wire + host-side work)
            with tracing.trace_span(
                "remote.call",
                replica=self.replica_id,
                host=self.host_id,
                method=method,
            ):
                result = await self._call_host(
                    self.host_service_id,
                    "replica_call",
                    self.replica_id,
                    method,
                    list(args),
                    kwargs or {},
                    **extra,
                )
            if not self._first_request_done:
                self._first_request_done = True
                self.ttfr["ttfr_seconds"] = round(
                    time.monotonic() - self._started_mono, 4
                )
                flight.record(
                    "replica.first_request",
                    replica=self.replica_id,
                    app=self.app_id,
                    deployment=self.deployment_name,
                    host=self.host_id,
                    method=method,
                    ttfr_seconds=self.ttfr["ttfr_seconds"],
                    warm_pool=self.promoted_from_warm_pool,
                )
            return result
        except KeyError as e:
            # a raw KeyError here is the ROUTER's (host service gone
            # from the registry, i.e. the websocket dropped) — app
            # exceptions always arrive wrapped as RemoteError
            raise ReplicaUnavailableError(
                f"host '{self.host_id}' service vanished: {e}"
            ) from e
        finally:
            self._ongoing -= 1
            if self._ongoing == 0:
                self._idle_event.set()

    async def call_stream(self, method: str, *args, **kwargs):
        """Streaming twin of :meth:`call`: routes to the host's
        ``replica_stream`` verb through the controller's
        ``call_service_stream`` bridge (``stream_host``), yielding each
        token frame as it lands. Transport failures mid-stream surface
        as ``ConnectionError`` — the handle's resume machinery turns
        them into an idempotent re-pick, never a silent truncation."""
        if self.state not in ROUTABLE_STATES:
            raise ReplicaUnavailableError(
                f"replica {self.replica_id} not healthy ({self.state})"
            )
        if self._stream_host is None:
            raise ReplicaUnavailableError(
                f"replica {self.replica_id}: control plane has no "
                f"streaming bridge (stream_host not wired)"
            )
        self._ongoing += 1
        self._idle_event.clear()
        self._total_requests += 1
        try:
            with tracing.trace_span(
                "remote.stream",
                replica=self.replica_id,
                host=self.host_id,
                method=method,
            ):
                agen = self._stream_host(
                    self.host_service_id,
                    "replica_stream",
                    self.replica_id,
                    method,
                    list(args),
                    kwargs or {},
                )
                first_seen = False
                async for item in agen:
                    if not first_seen:
                        first_seen = True
                        if not self._first_request_done:
                            self._first_request_done = True
                            self.ttfr["ttfr_seconds"] = round(
                                time.monotonic() - self._started_mono, 4
                            )
                    yield item
        except KeyError as e:
            raise ReplicaUnavailableError(
                f"host '{self.host_id}' service vanished: {e}"
            ) from e
        finally:
            self._ongoing -= 1
            if self._ongoing == 0:
                self._idle_event.set()

    async def call_batch(
        self,
        method: str,
        requests: list,
        timeout_s: Optional[float] = None,
    ) -> list:
        """A controller-coalesced group as ONE wire round trip: the
        ``__batch__`` verb carries all K member payloads in a single
        ``replica_call`` frame, the host fans them out through the
        replica's normal per-call path (where the instance's own
        batcher merges them into one forward), and K result envelopes
        ride back in one frame — K requests, one round trip."""
        if self.state not in ROUTABLE_STATES:
            raise ReplicaUnavailableError(
                f"replica {self.replica_id} not healthy ({self.state})"
            )
        n = len(requests)
        self._ongoing += n
        self._idle_event.clear()
        self._total_requests += n
        try:
            extra: dict = {}
            if timeout_s is not None:
                extra = {"timeout_s": timeout_s, "rpc_timeout": timeout_s + 5.0}
            with tracing.trace_span(
                "remote.call",
                replica=self.replica_id,
                host=self.host_id,
                method=method,
                batch=n,
            ):
                return await self._call_host(
                    self.host_service_id,
                    "replica_call",
                    self.replica_id,
                    "__batch__",
                    [method, requests],
                    {},
                    **extra,
                )
        except KeyError as e:
            raise ReplicaUnavailableError(
                f"host '{self.host_id}' service vanished: {e}"
            ) from e
        finally:
            self._ongoing -= n
            if self._ongoing == 0:
                self._idle_event.set()

    def mark_promoted(self) -> None:
        """Warm-pool standby → serving replica (see Replica.mark_promoted)."""
        self.promoted_from_warm_pool = True
        self.ttfr["standby_seconds"] = round(
            time.monotonic() - self._started_mono, 4
        )
        self._started_mono = time.monotonic()
        self._first_request_done = False

    @property
    def load(self) -> float:
        return self._ongoing / max(1, self.max_ongoing_requests)

    def describe(self) -> dict:
        cold = dict(self.ttfr)
        cold["promoted_from_warm_pool"] = self.promoted_from_warm_pool
        return {
            "replica_id": self.replica_id,
            "deployment": self.deployment_name,
            "state": self.state.value,
            "device_ids": self.device_ids,
            "host_id": self.host_id,
            "ongoing_requests": self._ongoing,
            # no queued_requests key: the semaphore queue lives in the
            # host-side Replica (visible via the host's get_status /
            # describe) — reporting 0 here would fake an idle queue and
            # the controller rollup treats a missing key as unknown
            "total_requests": self._total_requests,
            "load": self.load,
            "cold_start": cold,
            "uptime_seconds": time.monotonic() - self._started_mono,
            "last_error": self.last_error,
        }
