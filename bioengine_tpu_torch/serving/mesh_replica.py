"""Cross-host mesh execution — one logical replica over several hosts.

:class:`MeshReplica` duck-types :class:`~bioengine_tpu_torch.serving.replica.
Replica` exactly like ``RemoteReplica`` does, so the WHOLE serving plane
applies to a multi-host deployment unchanged: the router and global
scheduler route to it (``call_bounded`` / ``call_batch``), the health
loop restarts it, drain/undeploy tear it down, the circuit breaker
ejects it, chip accounting releases every shard's lease under ONE
replica id, and tracing/flight events flow from the same
instrumentation points.

Under it, :class:`CrossHostEngine` drives the per-host shards — each a
normal host-side ``Replica`` whose instance holds only its slice of the
model in a PR 5 ``InferenceEngine`` over that host's lease. Activations
cross hosts inside ordinary ``replica_call`` frames, where the PR 3
codec already moves any >=1KiB ndarray as a zero-copy OOB payload (shm
fast path on a shared machine) — collectives bootstrap on the existing
transport, no second data plane. The whole exchange is gated on the
capability-negotiated ``mesh1`` proto: the controller only plans shards
onto hosts that declared it, and a host refuses a ``mesh_shard`` start
from a controller that never advertised it.

Degradation: any shard failure marks the mesh UNHEALTHY (one
``mesh.degrade`` flight event names the shard); the controller's normal
restart path then re-plans — onto the surviving hosts, collapsing to a
single-host fallback mesh when only one remains (unless the config
forbids it). A host REJOIN does not re-adopt mesh shards (the mesh's
identity spans hosts); the rejoining host is told to drop its copies
and the re-plan takes over.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from typing import Any, Callable, Optional

import numpy as np

from bioengine_tpu_torch.rpc import protocol
from bioengine_tpu_torch.serving.errors import (
    DeadlineExceeded,
    ReplicaUnavailableError,
    is_caller_timeout,
    is_retryable,
)
from bioengine_tpu_torch.serving.mesh_plan import MeshConfig, MeshPlan
from bioengine_tpu_torch.serving.replica import (
    DEFAULT_DRAIN_TIMEOUT_S,
    ROUTABLE_STATES,
    ReplicaState,
    ReplicaStateMixin,
)
from bioengine_tpu_torch.utils import flight, metrics, tracing

# cross-host data-plane accounting: how many activation bytes hop
# between shards and what the hops cost — the number that says whether
# a pipeline split is transfer-bound (surfaces in get_app_status and
# the multihost_mesh bench stage)
MESH_TRANSFER_BYTES = metrics.counter(
    "mesh_transfer_bytes_total",
    "activation bytes exchanged between mesh shards (both directions)",
    ("app", "deployment"),
)
MESH_TRANSFER_SECONDS = metrics.counter(
    "mesh_transfer_seconds_total",
    "wall seconds spent in cross-shard stage calls (transfer + compute)",
    ("app", "deployment"),
)
MESH_STAGE_CALLS = metrics.counter(
    "mesh_stage_calls_total",
    "stage invocations dispatched to mesh shards",
    ("app", "deployment"),
)


class CrossHostEngine:
    """Drives one logical forward across per-host engine shards.

    ``call_stage(shard, method, args, timeout_s)`` is the transport —
    injected by :class:`MeshReplica` (controller → host ``replica_call``
    over the RPC plane) or by tests/the dryrun (in-process stubs), so
    the composition math is checkable without a cluster.

    Composition by ``kind``:

    - ``pipeline``: sequential hops, stage k's output array is stage
      k+1's input. Throughput comes from co-batched requests (the PR 8
      scheduler coalesces; each hop carries the whole group's batch).
    - ``dp``: the batch splits across shards (``np.array_split`` on
      axis 0), shards run concurrently, outputs concatenate in order.
    - ``tp``: every shard sees the full input and returns a PARTIAL
      output; the driver sums — the host-mediated all-reduce of a
      Megatron block (shard halves exchange activations through the
      driver rather than ICI until real DCN collectives exist).
    """

    def __init__(
        self,
        config: MeshConfig,
        n_shards: int,
        call_stage: Callable[..., Any],
        app_id: str = "?",
        deployment: str = "?",
    ):
        self.config = config
        self.n_shards = n_shards
        self._call_stage = call_stage
        self.transfer_bytes = 0
        self.transfer_seconds = 0.0
        self.stage_calls = 0
        self._m_bytes = MESH_TRANSFER_BYTES.labels(app_id, deployment)
        self._m_seconds = MESH_TRANSFER_SECONDS.labels(app_id, deployment)
        self._m_calls = MESH_STAGE_CALLS.labels(app_id, deployment)

    async def _stage(
        self, shard: int, inputs: Any, timeout_s: Optional[float]
    ) -> Any:
        t0 = time.monotonic()
        out = await self._call_stage(
            shard, self.config.stage_method, [shard, inputs], timeout_s
        )
        dt = time.monotonic() - t0
        # the codec's own payload walk (depth-guarded) — activation
        # accounting agrees with what the wire actually moves
        moved = protocol.payload_nbytes(inputs) + protocol.payload_nbytes(
            out
        )
        self.stage_calls += 1
        self.transfer_bytes += moved
        self.transfer_seconds += dt
        self._m_calls.inc()
        self._m_bytes.inc(moved)
        self._m_seconds.inc(dt)
        return out

    def _remaining(self, deadline: Optional[float]) -> Optional[float]:
        per_hop = self.config.resolved_stage_timeout_s()
        if deadline is None:
            return per_hop
        left = deadline - time.monotonic()
        if left <= 0:
            # an earlier hop ate the whole composition budget — fail
            # fast HERE instead of serializing a multi-MB activation
            # onto the wire with a dead (negative) timeout
            raise DeadlineExceeded(
                f"mesh {self.config.kind} composition budget exhausted "
                f"mid-run ({self.n_shards} shards)"
            )
        return min(per_hop, left) if per_hop is not None else left

    async def run(
        self, inputs: Any, timeout_s: Optional[float] = None
    ) -> Any:
        """One logical forward. ``timeout_s`` bounds the WHOLE
        composition; each hop additionally respects the per-stage
        budget (``mesh.stage_timeout_s`` /
        ``BIOENGINE_MESH_STAGE_TIMEOUT_S``)."""
        deadline = (
            time.monotonic() + timeout_s if timeout_s is not None else None
        )
        kind = self.config.kind
        with tracing.trace_span(
            "mesh.run", kind=kind, shards=self.n_shards
        ):
            if kind == "pipeline":
                act = inputs
                for k in range(self.n_shards):
                    act = await self._stage(k, act, self._remaining(deadline))
                return act
            if kind == "dp":
                # a batch smaller than the shard count would split into
                # EMPTY tails — skip them (every dp shard holds the full
                # model, so any prefix of shards serves the request)
                # rather than paying a cross-host round trip per surplus
                # shard and skewing the transfer accounting with
                # phantom hops
                parts = [
                    p
                    for p in np.array_split(
                        np.asarray(inputs), self.n_shards
                    )
                    if len(p)
                ]
                outs = await asyncio.gather(
                    *(
                        self._stage(k, part, self._remaining(deadline))
                        for k, part in enumerate(parts)
                    )
                )
                return np.concatenate(
                    [np.asarray(o) for o in outs], axis=0
                )
            if kind == "tp":
                outs = await asyncio.gather(
                    *(
                        self._stage(k, inputs, self._remaining(deadline))
                        for k in range(self.n_shards)
                    )
                )
                total = np.asarray(outs[0])
                for o in outs[1:]:
                    total = total + np.asarray(o)
                return total
            raise ValueError(f"unknown mesh kind '{kind}'")

    def stats(self) -> dict:
        return {
            "stage_calls": self.stage_calls,
            "transfer_bytes": self.transfer_bytes,
            "transfer_seconds": round(self.transfer_seconds, 6),
            "transfer_bytes_per_sec": round(
                self.transfer_bytes / self.transfer_seconds, 1
            )
            if self.transfer_seconds > 0
            else None,
        }


class MeshReplica(ReplicaStateMixin):
    """One logical deployment over the shards of a :class:`MeshPlan`.

    Chip accounting: every shard's chips are leased (by the controller)
    under THIS replica's id, so ``ClusterState.mark_replica_dead(
    replica_id)`` releases the whole mesh — host deaths, restarts, and
    undeploy leak nothing without any mesh-specific bookkeeping."""

    is_remote = True
    is_mesh = True

    def __init__(
        self,
        app_id: str,
        deployment_name: str,
        plan: MeshPlan,
        call_host: Callable[..., Any],   # async (service_id, method, *a, **kw)
        payload: dict,
        max_ongoing_requests: int = 10,
        log_sink: Optional[Callable[[str, str], None]] = None,
        drain_timeout_s: float = DEFAULT_DRAIN_TIMEOUT_S,
        stream_host: Optional[Callable[..., Any]] = None,
    ):
        self.app_id = app_id
        self.deployment_name = deployment_name
        self.replica_id = f"{deployment_name}-mesh-{uuid.uuid4().hex[:8]}"
        self.plan = plan
        self.config: MeshConfig = plan.config
        # flattened view for flight/status; per-shard detail lives in
        # describe()["mesh"]["shards"]. host_id is the joined shard-host
        # set — display/logging only. NB it CAN equal a single host's id
        # (a 1-host plan or the fallback mesh), so rejoin re-adoption is
        # guarded explicitly by is_mesh in the controller's
        # _readopt_replica, not by this string's shape.
        self.device_ids = [d for s in plan.shards for d in s.device_ids]
        self.host_id = "+".join(plan.hosts)
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
        self._degraded = False
        # hosts whose shard failed during this mesh's life — the
        # restart path steers the re-plan around them (scored as
        # last-resort by plan_mesh's `avoided` feature, so a sole
        # survivor is still usable)
        self.degraded_hosts: set[str] = set()
        self.ttfr: dict[str, Any] = {}
        self.promoted_from_warm_pool = False
        self._first_request_done = False
        self.engine = CrossHostEngine(
            self.config,
            len(plan.shards),
            self._call_shard_stage,
            app_id=app_id,
            deployment=deployment_name,
        )

    def _log(self, line: str) -> None:
        if self._log_sink:
            self._log_sink(self.replica_id, line)

    def shard_replica_id(self, stage: int) -> str:
        return f"{self.replica_id}-s{stage}"

    # ---- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        started: list[int] = []
        shard_states: list[ReplicaState] = []
        try:
            for shard in self.plan.shards:
                rid = self.shard_replica_id(shard.stage)
                self._log(
                    f"starting shard {rid} (stage {shard.stage}) on "
                    f"host {shard.host_id} chips {shard.device_ids}"
                )
                result = await self._call_host(
                    shard.service_id,
                    "start_replica",
                    replica_id=rid,
                    device_ids=list(shard.device_ids),
                    max_ongoing_requests=self.max_ongoing_requests,
                    payload=self._payload,
                    mesh_shard={
                        "stage": shard.stage,
                        "n_stages": self.config.stages,
                        "kind": self.config.kind,
                        "axes": dict(self.config.axes),
                        # the parent identity a RECOVERING controller
                        # groups surviving shards by when it rebuilds
                        # the MeshReplica from host inventory
                        "mesh_replica_id": self.replica_id,
                    },
                )
                shard_states.append(ReplicaState(result["state"]))
                started.append(shard.stage)
            self.state = (
                ReplicaState.TESTING
                if any(s == ReplicaState.TESTING for s in shard_states)
                else ReplicaState.HEALTHY
            )
            self.ttfr["init_seconds"] = round(
                time.monotonic() - self._started_mono, 4
            )
            flight.record(
                "mesh.establish",
                replica=self.replica_id,
                app=self.app_id,
                deployment=self.deployment_name,
                kind=self.config.kind,
                mesh_shape=self.config.mesh_shape(),
                hosts=self.plan.hosts,
                cross_host=self.plan.cross_host,
                stages=self.config.stages,
            )
            self._log(
                f"mesh established: {self.config.kind} x{self.config.stages} "
                f"over {self.plan.hosts} (state={self.state})"
            )
        except Exception as e:
            self.last_error = str(e)[-2000:]
            self.state = ReplicaState.UNHEALTHY
            self._log(f"mesh start failed: {e}")
            # release whatever shards DID start; leases release when the
            # controller marks this replica dead
            for stage in started:
                shard = self.plan.shards[stage]
                try:
                    await self._call_host(
                        shard.service_id,
                        "stop_replica",
                        self.shard_replica_id(stage),
                    )
                except Exception as rollback_err:  # noqa: BLE001 — rollback is best-effort
                    self._log(
                        f"shard {stage} rollback stop failed "
                        f"(tolerated): {rollback_err}"
                    )
            raise

    async def check_health(self) -> ReplicaState:
        if self.state in (
            ReplicaState.STOPPED,
            ReplicaState.UNHEALTHY,
            ReplicaState.DRAINING,
        ):
            return self.state

        async def one(shard) -> tuple:
            try:
                result = await asyncio.wait_for(
                    self._call_host(
                        shard.service_id,
                        "replica_health",
                        self.shard_replica_id(shard.stage),
                    ),
                    timeout=30.0,
                )
                return shard, ReplicaState(result["state"]), result.get(
                    "last_error"
                )
            except Exception as e:  # noqa: BLE001 — transport error = shard gone
                return shard, ReplicaState.UNHEALTHY, (
                    f"host '{shard.host_id}' unreachable: {e}"
                )

        results = await asyncio.gather(
            *(one(s) for s in self.plan.shards)
        )
        # ANY shard that cannot take stage calls fails the whole mesh —
        # a shard parked in DRAINING/STOPPED (host-side drain, admin
        # action) serves nothing, and a mesh left HEALTHY around it
        # would route every request into ReplicaUnavailableError
        # forever instead of being re-planned
        bad = [
            (s, err or f"shard state {state.value}")
            for s, state, err in results
            if state not in (ReplicaState.HEALTHY, ReplicaState.TESTING)
        ]
        if bad:
            shard, err = bad[0]
            self.last_error = err
            self.state = ReplicaState.UNHEALTHY
            # EVERY failed shard's host feeds the re-plan avoid set (a
            # shared rack fault can take two shards down in one tick);
            # the one-shot degrade event still names the first
            for other, _ in bad[1:]:
                self.degraded_hosts.add(other.host_id)
            self._note_degraded(shard, err)
        elif any(state == ReplicaState.TESTING for _, state, _ in results):
            self.state = ReplicaState.TESTING
        elif self.state != ReplicaState.PROBATION:
            # gray failure is invisible to health checks by definition:
            # a controller-assigned PROBATION (latency outlier,
            # serving/outlier.py) survives an all-shards-healthy check
            # — only latency evidence from probe traffic clears it
            # (same guard as Replica/RemoteReplica.check_health)
            self.state = ReplicaState.HEALTHY
        return self.state

    async def drain(self, timeout_s: Optional[float] = None) -> bool:
        if self.state in ROUTABLE_STATES + (ReplicaState.INITIALIZING,):
            self.state = ReplicaState.DRAINING
            self._log(f"draining mesh ({self._ongoing} in-flight)")
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
        # host-side drains run concurrently on ONE shared budget
        await asyncio.gather(
            *(
                self._drain_shard(s, timeout)
                for s in self.plan.shards
            ),
            return_exceptions=True,
        )
        if self._ongoing == 0:
            return True
        remaining = max(0.0, timeout - (time.monotonic() - started))
        try:
            await asyncio.wait_for(self._idle_event.wait(), remaining)
            return True
        except asyncio.TimeoutError:
            self._log(f"mesh drain timed out ({self._ongoing} stranded)")
            return False

    async def _drain_shard(self, shard, timeout: float) -> None:
        try:
            await asyncio.wait_for(
                self._call_host(
                    shard.service_id,
                    "drain_replica",
                    self.shard_replica_id(shard.stage),
                    timeout,
                ),
                timeout=timeout + 5.0,
            )
        except Exception as e:  # noqa: BLE001 — a dead host has trivially drained
            self._log(
                f"shard {shard.stage} drain failed (tolerated): {e}"
            )

    async def stop(self, drain_timeout_s: Optional[float] = None) -> None:
        if self.state in (
            ReplicaState.HEALTHY,
            ReplicaState.TESTING,
            ReplicaState.DRAINING,
        ):
            await self.drain(drain_timeout_s)
        self.state = ReplicaState.STOPPED

        async def stop_shard(shard) -> None:
            try:
                await asyncio.wait_for(
                    self._call_host(
                        shard.service_id,
                        "stop_replica",
                        self.shard_replica_id(shard.stage),
                    ),
                    timeout=15.0,
                )
            except Exception as e:  # noqa: BLE001 — host already gone is stopped
                self._log(
                    f"shard {shard.stage} stop failed (tolerated): {e}"
                )

        await asyncio.gather(*(stop_shard(s) for s in self.plan.shards))
        flight.record(
            "mesh.teardown",
            replica=self.replica_id,
            app=self.app_id,
            deployment=self.deployment_name,
            hosts=self.plan.hosts,
            **self.engine.stats(),
        )
        self._log("mesh stopped")

    def _note_degraded(self, shard, err) -> None:
        """Record the ONE ``mesh.degrade`` event for this mesh's life —
        fired wherever the shard failure is first observed (a stage
        call's transport error usually beats the health loop; the
        breaker may flip the state before check_health ever runs)."""
        self.degraded_hosts.add(shard.host_id)
        if self._degraded:
            return
        self._degraded = True
        flight.record(
            "mesh.degrade",
            severity="warning",
            replica=self.replica_id,
            app=self.app_id,
            deployment=self.deployment_name,
            stage=shard.stage,
            host=shard.host_id,
            error=str(err)[:300],
        )
        self._log(
            f"mesh degraded: stage {shard.stage} on {shard.host_id}: {err}"
        )

    # ---- request path -------------------------------------------------------

    async def _call_shard_stage(
        self,
        shard_index: int,
        method: str,
        args: list,
        timeout_s: Optional[float],
        kwargs: Optional[dict] = None,
    ) -> Any:
        """The CrossHostEngine's transport (and the route for non-entry
        control/status methods, which carry ``kwargs``): one hop
        through the existing replica RPC plane. Activation ndarrays in
        ``args`` and the result ride the PR 3 OOB frames (shm on a
        shared machine) — no mesh-specific wire format."""
        shard = self.plan.shards[shard_index]
        extra: dict = {}
        if timeout_s is not None:
            extra = {"timeout_s": timeout_s, "rpc_timeout": timeout_s + 5.0}
        try:
            with tracing.trace_span(
                "mesh.stage",
                replica=self.replica_id,
                stage=shard.stage,
                host=shard.host_id,
            ):
                return await self._call_host(
                    shard.service_id,
                    "replica_call",
                    self.shard_replica_id(shard.stage),
                    method,
                    args,
                    kwargs or {},
                    **extra,
                )
        except KeyError as e:
            # the host's service vanished from the router registry —
            # typed so the handle fails over / parks for the re-plan
            self._note_degraded(shard, e)
            raise ReplicaUnavailableError(
                f"mesh shard {shard.stage} host '{shard.host_id}' "
                f"service vanished: {e}"
            ) from e
        except Exception as e:
            # a transport-classified stage failure is the data-plane
            # sighting of a degraded mesh (it usually precedes the
            # health loop's verdict); a member's own expired budget says
            # nothing about shard health
            if is_retryable(e) and not is_caller_timeout(e):
                self._note_degraded(shard, e)
            raise

    async def call(self, method: str, *args, **kwargs) -> Any:
        return await self.call_bounded(method, args, kwargs)

    async def call_bounded(
        self,
        method: str,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        timeout_s: Optional[float] = None,
    ) -> Any:
        if self.state not in ROUTABLE_STATES:
            raise ReplicaUnavailableError(
                f"mesh replica {self.replica_id} not healthy ({self.state})"
            )
        kwargs = kwargs or {}
        self._ongoing += 1
        self._idle_event.clear()
        self._total_requests += 1
        try:
            if method in self.config.entry_methods:
                # the mesh driver owns entry methods: the single
                # positional payload is the model input, composed across
                # shards per the config's kind
                if kwargs or len(args) != 1:
                    raise TypeError(
                        f"mesh entry method '{method}' takes exactly one "
                        f"positional input (got args={len(args)}, "
                        f"kwargs={sorted(kwargs)}) — per-request options "
                        f"don't fan across shards"
                    )
                result = await self.engine.run(args[0], timeout_s=timeout_s)
            else:
                # control-plane / status methods route to stage 0
                result = await self._call_shard_stage(
                    0, method, list(args), timeout_s, kwargs=kwargs
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
                    warm_pool=False,
                )
            return result
        finally:
            self._ongoing -= 1
            if self._ongoing == 0:
                self._idle_event.set()

    async def call_stream(self, method: str, *args, **kwargs):
        """Token stream through the mesh: the stream is driven by stage
        0's replica (whose DecodeLoop holds the KV cache for the
        sequence); other stages serve it via the instance's own
        cross-shard calls, exactly like non-entry unary methods route.
        Duck-types ``Replica.call_stream`` so DeploymentHandle's
        streaming failover applies to mesh deployments unchanged."""
        if self.state not in ROUTABLE_STATES:
            raise ReplicaUnavailableError(
                f"mesh replica {self.replica_id} not healthy ({self.state})"
            )
        if self._stream_host is None:
            raise ReplicaUnavailableError(
                f"mesh replica {self.replica_id}: control plane has no "
                "streaming bridge"
            )
        shard = self.plan.shards[0]
        self._ongoing += 1
        self._idle_event.clear()
        self._total_requests += 1
        try:
            with tracing.trace_span(
                "mesh.stream",
                replica=self.replica_id,
                stage=shard.stage,
                host=shard.host_id,
            ):
                agen = self._stream_host(
                    shard.service_id,
                    "replica_stream",
                    self.shard_replica_id(shard.stage),
                    method,
                    list(args),
                    kwargs or {},
                )
                async for item in agen:
                    if not self._first_request_done:
                        self._first_request_done = True
                        self.ttfr["ttfr_seconds"] = round(
                            time.monotonic() - self._started_mono, 4
                        )
                    yield item
        except KeyError as e:
            self._note_degraded(shard, e)
            raise ReplicaUnavailableError(
                f"mesh shard {shard.stage} host '{shard.host_id}' "
                f"service vanished: {e}"
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
        """A scheduler-coalesced group against the mesh: members run
        concurrently through the normal per-call path (pipeline hops
        already carry each member's batch; per-member failures stay
        isolated, local-envelope style like ``Replica.call_batch``)."""

        async def one(r: dict) -> dict:
            try:
                result = await self.call_bounded(
                    method,
                    tuple(r.get("args") or ()),
                    dict(r.get("kwargs") or {}),
                    timeout_s=timeout_s,
                )
                return {"ok": True, "result": result}
            except Exception as e:  # noqa: BLE001 — per-member isolation
                return {"ok": False, "exception": e}

        return await asyncio.gather(*(one(r) for r in requests))

    def mark_promoted(self) -> None:
        """Mesh replicas don't sit in warm pools (their chips span
        hosts); promotion re-anchoring is a no-op kept for duck-type
        completeness."""
        self.promoted_from_warm_pool = True

    @property
    def load(self) -> float:
        return self._ongoing / max(1, self.max_ongoing_requests)

    def describe(self) -> dict:
        mesh = self.plan.describe()
        mesh["transfer"] = self.engine.stats()
        mesh["shard_replica_ids"] = [
            self.shard_replica_id(s.stage) for s in self.plan.shards
        ]
        return {
            "replica_id": self.replica_id,
            "deployment": self.deployment_name,
            "state": self.state.value,
            "device_ids": self.device_ids,
            "host_id": self.host_id,
            "ongoing_requests": self._ongoing,
            # like RemoteReplica: no queued_requests key — the shard
            # semaphores live host-side; a missing key reads as unknown
            "total_requests": self._total_requests,
            "load": self.load,
            "mesh": mesh,
            "cold_start": dict(self.ttfr),
            "uptime_seconds": time.monotonic() - self._started_mono,
            "last_error": self.last_error,
        }
