"""RPC client: connect to a control-plane server, register services,
call remote services.

API shape mirrors what the reference gets from hypha-rpc's
``connect_to_server`` (a server object with register_service /
get_service / generate_token, ref bioengine/worker/worker.py:522-612),
so worker/app code reads the same against our in-repo control plane.
"""

from __future__ import annotations

import asyncio
import contextlib
from typing import Any, Callable, Optional

import aiohttp

from bioengine_tpu_torch.rpc import protocol
from bioengine_tpu_torch.rpc.schema import extract_schema
from bioengine_tpu_torch.rpc.transport import (
    Codec,
    TransportConfig,
    attach_store_by_name,
)
from bioengine_tpu_torch.testing import faults
from bioengine_tpu_torch.utils import flight, tracing
from bioengine_tpu_torch.utils.backoff import full_jitter_delay
from bioengine_tpu_torch.utils.logger import create_logger
from bioengine_tpu_torch.utils.tasks import spawn_supervised


class ConnectionLost(ConnectionError):
    """The websocket dropped with this call in flight. The outcome on
    the server is unknown — the serving layer retries only idempotent
    calls."""


def _expire_request(fut: asyncio.Future) -> None:
    # timer callback for _request: fires only if the RESULT never came
    if not fut.done():
        fut.set_exception(asyncio.TimeoutError())


class ServiceProxy:
    """Callable facade over a remote service: ``await svc.method(...)``."""

    def __init__(self, connection: "ServerConnection", service_info: dict):
        self._connection = connection
        self._info = service_info
        self.id = service_info["id"]

    def __getattr__(self, name: str) -> Callable:
        if name.startswith("_"):
            raise AttributeError(name)

        async def call(*args, **kwargs):
            return await self._connection.call(self.id, name, *args, **kwargs)

        call.__name__ = name
        return call

    def __repr__(self) -> str:
        return f"<ServiceProxy {self.id} methods={self._info.get('methods')}>"


class ServerConnection:
    """A live WebSocket session with the RPC server."""

    def __init__(
        self,
        url: str,
        token: Optional[str] = None,
        timeout: float = 300.0,
        shm_store: Any = "auto",
        transport_config: Optional[TransportConfig] = None,
        protocols: Optional[list[str]] = None,
        auto_reconnect: bool = False,
        reconnect_max_backoff_s: float = 5.0,
        compat_pre_fast1: bool = False,
    ):
        self.url = url
        # same-host deployments skip the TCP stack entirely:
        # ``unix:///path/to.sock`` dials the server's unix-domain
        # listener — ~40% lower per-message syscall cost on the
        # small-request hot path (docs/performance.md)
        self._uds_path: Optional[str] = (
            url[len("unix://"):] if url.startswith("unix://") else None
        )
        self.token = token
        self.timeout = timeout
        # capabilities declared at handshake; [] forces pure-legacy
        # framing in BOTH directions (bench baseline, interop tests)
        self.protocols = (
            [
                protocol.PROTO_OOB1,
                protocol.PROTO_TRACE1,
                protocol.PROTO_TELEM1,
                protocol.PROTO_MESH1,
                protocol.PROTO_EPOCH1,
                protocol.PROTO_FAST1,
                protocol.PROTO_STREAM1,
            ]
            if protocols is None
            else list(protocols)
        )
        # what the SERVER advertised at the last welcome (telem1 and
        # future server-side capabilities gate on this, see
        # peer_supports) and the last measured wall-clock offset to it
        self.peer_protocols: list[str] = []
        # the controller fencing epoch the server's welcome advertised
        # (None on legacy / non-controller servers) — worker hosts use
        # it to refuse rejoining a stale revived controller
        self.peer_epoch: Optional[int] = None
        self.clock_offset_s: Optional[float] = None
        self.clock_offset_rtt_s: Optional[float] = None
        self.auto_reconnect = auto_reconnect
        self.reconnect_max_backoff_s = reconnect_max_backoff_s
        # connection-lifecycle hooks (sync or async callables): fired on
        # an UNEXPECTED drop, and after a successful re-establish +
        # service re-registration respectively
        self.on_disconnect: list[Callable[[], Any]] = []
        self.on_reconnect: list[Callable[[], Any]] = []
        self.client_id: Optional[str] = None
        self.workspace: Optional[str] = None
        self.user_id: Optional[str] = None
        self.logger = create_logger("rpc.client", log_file="off")
        self._session: Optional[aiohttp.ClientSession] = None
        self._ws: Optional[aiohttp.ClientWebSocketResponse] = None
        self._pending: dict[str, asyncio.Future] = {}
        # open streaming calls: call_id -> queue of ("item", seq, value)
        # / ("end", count, spans) / ("err", 0, exc) — fed by the read
        # loop, drained by call_stream
        self._streams: dict[str, asyncio.Queue] = {}
        # call ids need per-connection uniqueness, not global entropy:
        # one random prefix at construction, then a counter — minting
        # 64 random bits per request shows up on the microsecond path
        self._call_prefix = f"{tracing.new_id()[:8]}-"
        self._call_seq = 0
        # measurement compat: reproduce the pre-fast1 per-request
        # bookkeeping (a fresh uuid call id + an asyncio.wait_for
        # timeout chain per call) so the request_overhead bench's
        # baseline leg measures the pre-optimization stack in the SAME
        # interpreter as the fast leg. Never set on production paths.
        self._compat_request = compat_pre_fast1
        self._local_services: dict[str, dict[str, Callable]] = {}
        self._service_definitions: dict[str, dict[str, Any]] = {}
        self._reader_task: Optional[asyncio.Task] = None
        self._closing = False
        self._reconnect_task: Optional[asyncio.Task] = None
        self.codec = Codec(config=transport_config or TransportConfig.from_env())
        self._shm_store_cfg = shm_store
        self._owns_shm = False

    async def connect(self) -> "ServerConnection":
        await self._establish()
        return self

    async def _establish(self) -> None:
        """One transport bring-up: websocket + welcome + reader + shm
        negotiation. Shared by ``connect`` and the reconnect loop."""
        await self._teardown_transport()
        if self._uds_path is not None:
            self._session = aiohttp.ClientSession(
                connector=aiohttp.UnixConnector(path=self._uds_path)
            )
            # the connector owns routing; the authority is synthetic
            url = "ws://localhost/ws"
        else:
            self._session = aiohttp.ClientSession()
            url = self.url
        # declare codec support at handshake; a pre-oob server ignores
        # unknown query params and its welcome carries no "protocols",
        # so both sides settle on legacy frames automatically
        if self.protocols:
            sep = "&" if "?" in url else "?"
            url = f"{url}{sep}proto={','.join(self.protocols)}"
        if self.token:
            sep = "&" if "?" in url else "?"
            url = f"{url}{sep}token={self.token}"
        self._ws = await self._session.ws_connect(
            url, max_msg_size=self.codec.config.max_msg_size
        )
        welcome = self.codec.decode((await self._ws.receive()).data)
        self.client_id = welcome["client_id"]
        self.workspace = welcome["workspace"]
        self.user_id = welcome["user_id"]
        self.peer_protocols = list(welcome.get("protocols", []))
        self.peer_epoch = welcome.get("epoch")
        self.codec.oob = protocol.PROTO_OOB1 in self.protocols and (
            protocol.PROTO_OOB1 in welcome.get("protocols", [])
        )
        # trace fields ride the CALL envelope only when BOTH sides
        # advertise trace1 — a legacy peer never sees them on the wire
        self.codec.trace = protocol.PROTO_TRACE1 in self.protocols and (
            protocol.PROTO_TRACE1 in welcome.get("protocols", [])
        )
        # BEFS small-request frames, same both-sides rule as oob1 —
        # a legacy peer keeps seeing byte-identical legacy frames
        self.codec.fast = protocol.PROTO_FAST1 in self.protocols and (
            protocol.PROTO_FAST1 in welcome.get("protocols", [])
        )
        self._reader_task = asyncio.create_task(self._read_loop())
        if self.codec.oob and isinstance(welcome.get("shm"), dict):
            await self._negotiate_shm(welcome["shm"])

    async def _teardown_transport(self) -> None:
        """Close ws/session remnants without touching pending futures
        or service state (reconnect keeps both)."""
        if self._reader_task and self._reader_task is not asyncio.current_task():
            self._reader_task.cancel()
            self._reader_task = None
        if self._ws is not None and not self._ws.closed:
            try:
                await self._ws.close()
            except Exception as e:  # noqa: BLE001 — remnant of a dead transport
                self.logger.debug(f"stale ws close raised: {e}")
        if self._session is not None:
            try:
                await self._session.close()
            except Exception as e:  # noqa: BLE001 — remnant of a dead transport
                self.logger.debug(f"stale session close raised: {e}")
        self._ws = None
        self._session = None

    async def _negotiate_shm(self, offer: dict) -> None:
        """Same-host handshake: map the server's segment, read the
        probe nonce out of it, echo it back. Any failure leaves the
        connection on wire frames — never fatal."""
        store = self._shm_store_cfg
        if store == "auto":
            # first probe may build the native lib (subprocess cc) —
            # keep the handshake off the loop's critical path
            store = await asyncio.to_thread(
                attach_store_by_name, offer.get("name", "")
            )
            self._owns_shm = store is not None
        if store is None:
            return
        try:
            nonce = store.get_bytes(offer["probe_key"])
        except Exception:  # noqa: BLE001 — foreign/mismatched segment
            nonce = None
        if nonce is None:
            if self._owns_shm:
                store.close()
                self._owns_shm = False
            return
        verified = await self._request(
            {"t": protocol.SHM_ACK, "nonce": nonce}
        )
        if verified:
            self.codec.enable_shm(store)
            self.logger.info("shm fast path negotiated")
        elif self._owns_shm:
            store.close()
            self._owns_shm = False

    async def disconnect(self) -> None:
        self._closing = True
        if self._reconnect_task is not None:
            self._reconnect_task.cancel()
            self._reconnect_task = None
        if self._reader_task:
            self._reader_task.cancel()
        if self._ws:
            await self._ws.close()
        if self._session:
            await self._session.close()
        self._fail_inflight(ConnectionLost("client disconnected"))
        shm = self.codec.shm_store
        self.codec.close()
        if shm is not None and self._owns_shm:
            shm.close()

    def describe(self) -> dict:
        """Data-plane counters for this connection (mirrors
        RpcServer.describe)."""
        return {
            "url": self.url,
            "connected": self.connected,
            "oob": self.codec.oob,
            "fast": self.codec.fast,
            "shm": self.codec.shm_store.name
            if self.codec.shm_store is not None
            else None,
            "transport": self.codec.stats.as_dict(),
        }

    @property
    def connected(self) -> bool:
        return self._ws is not None and not self._ws.closed

    # ---- request/response ---------------------------------------------------

    async def _read_loop(self) -> None:
        assert self._ws is not None
        try:
            async for msg in self._ws:
                if msg.type != aiohttp.WSMsgType.BINARY:
                    continue
                raw = msg.data
                try:
                    if protocol.is_fast_frame(raw):
                        # BEFS: sync decode, no pins to drain. A
                        # RESULT resolves its future straight from the
                        # (call_id, value) parse — fast frames can
                        # never carry spans or errors, so the generic
                        # handling below has nothing to add
                        parsed = self.codec.decode_fast_result_frame(raw)
                        if parsed is not None:
                            fut = self._pending.pop(parsed[0], None)
                            if fut is not None and not fut.done():
                                fut.set_result(parsed[1])
                            elif parsed[0] in self._streams:
                                # closing RESULT of a streaming call:
                                # fast result frames carry no spans
                                self._streams[parsed[0]].put_nowait(
                                    ("end", parsed[1], None)
                                )
                            continue
                        sparsed = self.codec.decode_fast_stream_frame(raw)
                        if sparsed is not None:
                            q = self._streams.get(sparsed[0])
                            if q is not None:
                                q.put_nowait(("item", sparsed[1], sparsed[2]))
                            continue
                        data = self.codec.decode_fast_frame(raw)
                    else:
                        try:
                            data = await self.codec.decode_async(raw)
                        finally:
                            # retry releasing pins of earlier shm
                            # payloads whose consumers have since
                            # dropped their views (results are handed
                            # to caller futures, so the release point
                            # is only observable opportunistically)
                            self.codec.drain_pins()
                except Exception as e:  # noqa: BLE001
                    # a poisoned message (e.g. its shm object was
                    # evicted before we consumed it) must cost only
                    # that message — the affected call times out, the
                    # connection and every other in-flight call live
                    self.logger.error(f"dropping undecodable message: {e}")
                    continue
                if data is None:
                    continue  # mid-reassembly chunk
                t = data.get("t")
                if t in (protocol.RESULT, protocol.ERROR):
                    if data.get("spans"):
                        # sampled-trace spans recorded by the peer while
                        # serving our call — fold into the local buffer
                        # so one process holds the whole tree
                        tracing.absorb_spans(data["spans"])
                    call_id = data.get("call_id", "")
                    fut = self._pending.pop(call_id, None)
                    if fut and not fut.done():
                        if t == protocol.RESULT:
                            fut.set_result(data.get("result"))
                        else:
                            err = data.get("error")
                            if not isinstance(err, Exception):
                                err = RuntimeError(str(err))
                            fut.set_exception(err)
                    elif call_id in self._streams:
                        q = self._streams[call_id]
                        if t == protocol.RESULT:
                            q.put_nowait(("end", data.get("result"), None))
                        else:
                            err = data.get("error")
                            if not isinstance(err, Exception):
                                err = RuntimeError(str(err))
                            q.put_nowait(("err", 0, err))
                elif t == protocol.STREAM:
                    q = self._streams.get(data.get("call_id", ""))
                    if q is not None:
                        q.put_nowait(
                            ("item", data.get("seq", 0), data.get("item"))
                        )
                elif t == protocol.CALL:
                    spawn_supervised(
                        self._handle_incoming_call(data),
                        name="rpc-incoming-call",
                        logger=self.logger,
                    )
                elif t == protocol.PONG:
                    fut = self._pending.pop("__ping__", None)
                    if fut and not fut.done():
                        fut.set_result(data.get("ts"))
        except asyncio.CancelledError:
            return
        except Exception as e:  # noqa: BLE001 — transport died under us
            self.logger.error(f"read loop failed: {e}")
        # the websocket closed without disconnect(): classify every
        # in-flight future NOW (a caller must see a typed transport
        # error immediately, not a timeout), then heal if configured
        self._on_connection_lost()

    def _on_connection_lost(self) -> None:
        if self._closing:
            return
        self.logger.warning("connection to server lost")
        flight.record(
            "client.disconnect",
            severity="warning",
            url=self.url,
            client_id=self.client_id,
            in_flight=len(self._pending),
        )
        self._fail_inflight(
            ConnectionLost(f"connection to {self.url} lost mid-call")
        )
        for cb in self.on_disconnect:
            try:
                result = cb()
                if asyncio.iscoroutine(result):
                    spawn_supervised(
                        result, name="rpc-on-disconnect", logger=self.logger
                    )
            except Exception as e:  # noqa: BLE001 — hooks never kill the client
                self.logger.error(f"on_disconnect callback failed: {e}")
        if self.auto_reconnect and (
            self._reconnect_task is None or self._reconnect_task.done()
        ):
            # exactly one reconnect loop at a time: a re-drop while a
            # loop is mid-retry must not spawn a second one (each
            # _establish tears down the transport — two racing loops
            # would keep closing each other's fresh connection)
            self._reconnect_task = spawn_supervised(
                self._reconnect_loop(),
                name="rpc-reconnect",
                logger=self.logger,
            )

    def _fail_inflight(self, exc: Exception) -> None:
        pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(exc)
                # a caller that already bailed (e.g. its send raised
                # first) never awaits this future — mark the exception
                # retrieved so the loop doesn't report it at GC time
                fut.exception()
        # open streams see the SAME typed transport error as unary
        # calls — the serving layer's idempotent-failover rules key on
        # ConnectionLost, streams included
        streams, self._streams = self._streams, {}
        for q in streams.values():
            q.put_nowait(("err", 0, exc))

    async def _reconnect_loop(self) -> None:
        """Re-establish with exponential backoff + full jitter, then
        re-register every local service and fire ``on_reconnect``."""
        attempt = 0
        while not self._closing:
            await asyncio.sleep(
                full_jitter_delay(attempt, 0.2, self.reconnect_max_backoff_s)
            )
            attempt += 1
            try:
                await self._establish()
                await self._reregister_services()
                for cb in self.on_reconnect:
                    result = cb()
                    if asyncio.iscoroutine(result):
                        await result
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — keep trying
                self.logger.warning(
                    f"reconnect attempt {attempt} failed: {e}"
                )
                continue
            self.logger.info(f"reconnected after {attempt} attempt(s)")
            flight.record(
                "client.reconnect",
                url=self.url,
                client_id=self.client_id,
                attempts=attempt,
            )
            return

    async def _reregister_services(self) -> None:
        # one registration implementation: register_service rebuilds the
        # wire definition and refreshes both local maps
        for definition in list(self._service_definitions.values()):
            await self.register_service(definition)

    async def _send_msg(self, msg: dict) -> None:
        if faults.ACTIVE:
            await faults.hit("rpc.client.send", drop=self._abort_connection)
        ws = self._ws
        if ws is None or ws.closed:
            raise ConnectionLost("rpc connection is down")
        codec = self.codec
        if codec.fast:
            # small-request hot path: one sync encode attempt, one
            # send — skips the encode_frames_async coroutine and the
            # payload-size walk entirely when it hits
            frame = codec.encode_fast_frame(msg)
            if frame is not None:
                await ws.send_bytes(frame)
                return
        for frame in await codec.encode_frames_async(msg):
            await ws.send_bytes(frame)

    async def _send_stream_item(self, call_id: str, seq: int, item: Any) -> None:
        """One stream item to the server. Per-token sends are THE hot
        path of a generation — try the BEFS stream frame first and only
        build the STREAM envelope dict on fallback (mirrors
        ``_request_fast``'s inlined send)."""
        if faults.ACTIVE:
            await faults.hit("rpc.client.send", drop=self._abort_connection)
        ws = self._ws
        if ws is None or ws.closed:
            raise ConnectionLost("rpc connection is down")
        codec = self.codec
        if codec.fast:
            frame = codec.encode_fast_stream_frame(call_id, seq, item)
            if frame is not None:
                await ws.send_bytes(frame)
                return
        for frame in await codec.encode_frames_async(
            {"t": protocol.STREAM, "call_id": call_id, "seq": seq, "item": item}
        ):
            await ws.send_bytes(frame)

    async def _abort_connection(self) -> None:
        """Sever the transport WITHOUT the closing handshake semantics
        of disconnect() — the fault-injection analog of a network
        partition; the read loop notices and runs the lost-connection
        path (in-flight failure + reconnect)."""
        if self._ws is not None and not self._ws.closed:
            await self._ws.close()

    async def _request(self, msg: dict) -> Any:
        if self._compat_request:
            # pre-fast1 request path, kept verbatim for the bench's
            # baseline leg (see compat_pre_fast1 in __init__)
            msg["call_id"] = call_id = tracing.new_id()
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._pending[call_id] = fut
            try:
                await self._send_msg(msg)
                return await asyncio.wait_for(fut, self.timeout)
            finally:
                self._pending.pop(call_id, None)
        self._call_seq = seq = self._call_seq + 1
        msg["call_id"] = call_id = f"{self._call_prefix}{seq:x}"
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending[call_id] = fut
        try:
            await self._send_msg(msg)
            # a bare timer handle, not asyncio.wait_for: wait_for
            # allocates an extra future + callback chain per call —
            # measurable on the small-request path. Semantics match:
            # TimeoutError after self.timeout, cancelled on exit.
            timer = loop.call_later(self.timeout, _expire_request, fut)
            try:
                return await fut
            finally:
                timer.cancel()
        finally:
            # RESULT/ERROR pop on arrival; this covers timeout/cancel so
            # abandoned futures don't accumulate across reconnects
            self._pending.pop(call_id, None)

    async def _handle_incoming_call(self, msg: dict) -> None:
        """The server is routing another client's call to one of OUR
        registered services. A sampled trace context on the CALL is
        activated around the handler (local spans chain under the
        caller's span) and the spans it closes ship back on the
        RESULT/ERROR frame."""
        assert self._ws is not None
        ctx = token = None
        if self.codec.trace and isinstance(msg.get("trace"), dict):
            ctx = tracing.TraceContext.from_wire(msg["trace"])
            token = tracing.activate(ctx)

        def _spans() -> dict:
            if ctx is not None and ctx.collector:
                return {"spans": ctx.collector}
            return {}

        try:
            service = self._local_services[msg["service_id"]]
            fn = service[msg["method"]]
            with (
                tracing.span(
                    "rpc.handle",
                    service=msg["service_id"],
                    method=msg["method"],
                )
                if tracing.sampled()
                else tracing.NOOP_SPAN
            ):
                result = fn(*msg.get("args", []), **msg.get("kwargs", {}))
                if asyncio.iscoroutine(result):
                    result = await result
            if hasattr(result, "__aiter__"):
                if msg.get("stream"):
                    # streaming handler for a streaming caller: one
                    # STREAM frame per item (fast-encoded when small),
                    # closed by a RESULT carrying the item count so the
                    # caller can detect truncation
                    seq = 0
                    try:
                        async for item in result:
                            await self._send_stream_item(
                                msg.get("call_id"), seq, item
                            )
                            seq += 1
                    except BaseException:
                        # a failed send mid-stream must not leave the
                        # provider's generator suspended until GC — its
                        # finally blocks release decode slots / ongoing
                        # counts, so close it deterministically
                        with contextlib.suppress(Exception):
                            await result.aclose()
                        raise
                    result = {"n": seq}
                else:
                    # legacy caller on a streaming method: drain to a
                    # list so the method stays callable without stream1
                    result = [item async for item in result]
            await self._send_msg(
                {
                    "t": protocol.RESULT,
                    "call_id": msg.get("call_id"),
                    "result": result,
                    **_spans(),
                }
            )
        except Exception as e:
            await self._send_msg(
                {
                    "t": protocol.ERROR,
                    "call_id": msg.get("call_id"),
                    "error": e,
                    **_spans(),
                }
            )
        finally:
            if token is not None:
                tracing.deactivate(token)
            # args decoded from shm refs die with the handler — let the
            # store reclaim their blocks
            self.codec.drain_pins()

    # ---- public API (hypha-shaped) ------------------------------------------

    async def register_service(self, definition: dict[str, Any]) -> dict:
        methods = {k: v for k, v in definition.items() if callable(v)}
        schemas = {
            k: getattr(v, "__schema__", extract_schema(v))
            for k, v in methods.items()
        }
        wire_def = {k: v for k, v in definition.items() if not callable(v)}
        wire_def["methods"] = schemas
        result = await self._request(
            {"t": protocol.REGISTER, "definition": wire_def}
        )
        full_id = result["id"]
        self._local_services[full_id] = methods
        # remember the ORIGINAL definition (with callables) so a
        # reconnect can re-register this service transparently
        self._service_definitions[full_id] = dict(definition)
        return {"id": full_id}

    async def unregister_service(self, service_id: str) -> None:
        await self._request(
            {"t": protocol.UNREGISTER, "service_id": service_id}
        )
        self._local_services.pop(service_id, None)
        self._service_definitions.pop(service_id, None)

    async def list_services(self, workspace: Optional[str] = None) -> list[dict]:
        return await self._request(
            {"t": protocol.LIST, "workspace": workspace}
        )

    async def get_service(self, service_id: str) -> ServiceProxy:
        services = await self.list_services()
        for info in services:
            if info["id"] == service_id or info["id"].endswith(f"/{service_id}"):
                return ServiceProxy(self, info)
        raise KeyError(f"Service '{service_id}' not found")

    async def call(self, service_id: str, method: str, *args, **kwargs) -> Any:
        codec = self.codec
        ctx = tracing.current_trace()
        traced = codec.trace and ctx is not None and ctx.sampled
        if codec.fast and not traced and not self._compat_request:
            # small-request hot path: encode straight from the call
            # site — the envelope dict is only built if the fast
            # encode bails (oversize / non-scalar payload)
            return await self._request_fast(service_id, method, args, kwargs)
        msg = {
            "t": protocol.CALL,
            "service_id": service_id,
            "method": method,
            "args": list(args),
            "kwargs": kwargs,
        }
        if traced:
            msg["trace"] = ctx.to_wire()
        return await self._request(msg)

    async def call_stream(
        self,
        service_id: str,
        method: str,
        *args,
        item_timeout: Optional[float] = None,
        **kwargs,
    ):
        """Call a streaming service method; async-iterates its items.

        The CALL carries ``stream: True``; the provider sends one
        STREAM frame per item and closes with a counting RESULT. A
        per-item inactivity timeout (default: the connection timeout)
        replaces the unary whole-call timer — a healthy generation may
        run far longer than any single gap between tokens. Out-of-order
        or missing items raise :class:`ConnectionLost` (the transport
        guarantees ordering, so a gap means frames were lost to a drop
        mid-stream)."""
        if self.peer_protocols and not self.peer_supports(protocol.PROTO_STREAM1):
            raise RuntimeError(
                "server does not support streaming calls (stream1)"
            )
        self._call_seq = seq = self._call_seq + 1
        call_id = f"{self._call_prefix}{seq:x}"
        q: asyncio.Queue = asyncio.Queue()
        self._streams[call_id] = q
        msg: dict[str, Any] = {
            "t": protocol.CALL,
            "call_id": call_id,
            "service_id": service_id,
            "method": method,
            "args": list(args),
            "kwargs": kwargs,
            "stream": True,
        }
        ctx = tracing.current_trace()
        if self.codec.trace and ctx is not None and ctx.sampled:
            msg["trace"] = ctx.to_wire()
        gap = item_timeout if item_timeout is not None else self.timeout
        expected = 0
        try:
            await self._send_msg(msg)
            while True:
                kind, a, b = await asyncio.wait_for(q.get(), gap)
                if kind == "item":
                    if a != expected:
                        raise ConnectionLost(
                            f"stream {call_id} gap: expected item "
                            f"{expected}, got {a}"
                        )
                    expected += 1
                    yield b
                elif kind == "end":
                    n = a.get("n") if isinstance(a, dict) else None
                    if n is not None and n != expected:
                        raise ConnectionLost(
                            f"stream {call_id} truncated: provider sent "
                            f"{n} items, received {expected}"
                        )
                    return
                else:
                    raise b
        finally:
            self._streams.pop(call_id, None)

    async def _request_fast(
        self, service_id: str, method: str, args: tuple, kwargs: dict
    ) -> Any:
        self._call_seq = seq = self._call_seq + 1
        call_id = f"{self._call_prefix}{seq:x}"
        frame = self.codec.encode_fast_call_frame(
            call_id, service_id, method, args, kwargs
        )
        if frame is None:
            return await self._request(
                {
                    "t": protocol.CALL,
                    "service_id": service_id,
                    "method": method,
                    "args": list(args),
                    "kwargs": kwargs,
                }
            )
        # inlined _send_msg minus the encode (already done): one fault
        # gate, one liveness check, one send
        if faults.ACTIVE:
            await faults.hit("rpc.client.send", drop=self._abort_connection)
        ws = self._ws
        if ws is None or ws.closed:
            raise ConnectionLost("rpc connection is down")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending[call_id] = fut
        try:
            await ws.send_bytes(frame)
            timer = loop.call_later(self.timeout, _expire_request, fut)
            try:
                return await fut
            finally:
                timer.cancel()
        finally:
            self._pending.pop(call_id, None)

    async def generate_token(self, config: Optional[dict] = None) -> str:
        config = config or {}
        return await self._request(
            {
                "t": protocol.TOKEN,
                "user_id": config.get("user_id"),
                "workspace": config.get("workspace"),
                "ttl_seconds": config.get("expires_in"),
                "is_admin": config.get("is_admin", False),
            }
        )

    async def ping(self) -> float:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending["__ping__"] = fut
        await self._send_msg({"t": protocol.PING})
        return await asyncio.wait_for(fut, 10.0)

    def peer_supports(self, capability: str) -> bool:
        """Did the server advertise ``capability`` at the welcome?
        (Client-declared capabilities gate what WE put on the wire;
        this gates what we may ASK of the server — e.g. ``telem1``'s
        push_telemetry verb.)"""
        return capability in self.peer_protocols

    async def measure_clock_offset(self, samples: int = 3) -> dict:
        """Estimate this process's wall-clock offset to the server via
        RTT-midpoint pings (NTP's core idea): the server's PONG
        timestamp is assumed taken halfway through the round trip, so
        ``offset = server_ts - (t_send + t_recv)/2``. The sample with
        the smallest RTT wins — queueing delay only ever inflates RTT,
        and the least-delayed exchange is closest to the symmetric
        ideal. Stored on the connection (``clock_offset_s``, positive =
        the server's clock is ahead of ours) and refreshed by callers
        on reconnect; merged incident timelines use it to de-skew
        multi-host event ordering (utils/flight.merge_records)."""
        import time as _time

        best: Optional[tuple[float, float]] = None  # (rtt, offset)
        for _ in range(max(1, samples)):
            t0 = _time.time()
            server_ts = await self.ping()
            t1 = _time.time()
            rtt = t1 - t0
            offset = float(server_ts) - (t0 + t1) / 2.0
            if best is None or rtt < best[0]:
                best = (rtt, offset)
        self.clock_offset_rtt_s, self.clock_offset_s = best
        return {
            "offset_s": round(best[1], 6),
            "rtt_s": round(best[0], 6),
            "samples": samples,
        }


async def connect_to_server(config: dict[str, Any]) -> ServerConnection:
    """hypha-style entry point: ``{"server_url": ..., "token": ...}``.

    Optional transport keys: ``shm_store`` (a store instance for the
    same-host fast path, ``"auto"`` to attach the advertised native
    segment, None to disable), ``transport_config``, and ``reconnect``
    (auto-reconnect with backoff on an unexpected drop; registered
    services are re-registered transparently)."""
    url = config["server_url"]
    if url.startswith("unix://"):
        pass  # a socket path, not an authority — used verbatim
    else:
        if url.startswith("http"):
            url = "ws" + url[4:]
        if not url.endswith("/ws"):
            url = url.rstrip("/") + "/ws"
    conn = ServerConnection(
        url,
        token=config.get("token"),
        timeout=config.get("method_timeout", 300.0),
        shm_store=config.get("shm_store", "auto"),
        transport_config=config.get("transport_config"),
        protocols=config.get("protocols"),
        auto_reconnect=bool(config.get("reconnect", False)),
        compat_pre_fast1=bool(config.get("compat_pre_fast1", False)),
    )
    return await conn.connect()
