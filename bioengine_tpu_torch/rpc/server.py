"""The control-plane RPC server.

Replaces the external Hypha server the reference depends on (the worker
connects OUT to hypha.aicell.io and registers its service dict, ref
bioengine/worker/worker.py:522-664). Here the control plane is part of
the framework: an aiohttp WebSocket server hosting a service registry
with token auth and caller-context injection. A worker can either run
this server itself (standalone mode) or connect to a remote instance —
the same two topologies the reference supports with Hypha.

Capabilities:
- token issue/validate (``generate_token`` with expiry; admin users)
- service registration from any connected client or in-process object
- method calls routed caller -> provider with ``context`` injection
  (``config.require_context``, same convention as the reference's
  services, ref bioengine/utils/permissions.py create_context)
- service listing/metadata incl. method schemas
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import secrets
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from aiohttp import WSMsgType, web

from bioengine_tpu_torch.rpc import protocol
from bioengine_tpu_torch.rpc.schema import extract_schema
from bioengine_tpu_torch.rpc.transport import Codec, RpcStats, TransportConfig
from bioengine_tpu_torch.testing import faults
from bioengine_tpu_torch.utils import metrics, tracing
from bioengine_tpu_torch.utils.logger import create_logger
from bioengine_tpu_torch.utils.tasks import spawn_supervised


def _to_jsonable(obj: Any) -> Any:
    """Numpy-aware conversion for the JSON HTTP bridge (service results
    may carry arrays, e.g. segmentation masks). Non-finite floats
    become null: Python's json emits bare NaN/Infinity literals, which
    browsers' JSON.parse rejects — a diverged training loss must not
    break the frontend."""
    import math

    import numpy as np

    if isinstance(obj, np.ndarray):
        if np.issubdtype(obj.dtype, np.floating) and not np.isfinite(obj).all():
            # vectorized: one NaN in a megapixel map must not trigger
            # per-element Python recursion
            masked = obj.astype(object)
            masked[~np.isfinite(obj)] = None
            return masked.tolist()
        return obj.tolist()
    if isinstance(obj, np.generic):
        obj = obj.item()
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


@dataclass
class TokenInfo:
    user_id: str
    workspace: str
    expires_at: float
    is_admin: bool = False


@dataclass
class ServiceEntry:
    service_id: str
    workspace: str
    owner_client: Optional[str]      # ws connection id; None = in-process
    definition: dict[str, Any]
    methods: dict[str, Callable] = field(default_factory=dict)  # in-process only
    schemas: dict[str, dict] = field(default_factory=dict)

    @property
    def full_id(self) -> str:
        return f"{self.workspace}/{self.service_id}"


class RpcServer:
    """In-process + WebSocket service registry and call router."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        admin_users: Optional[list[str]] = None,
        default_workspace: str = "bioengine",
        token_ttl_seconds: float = 3600 * 24,
        shm_store: Any = "auto",
        transport_config: Optional[TransportConfig] = None,
        inline_dispatch: Optional[bool] = None,
        uds_path: Optional[str] = None,
    ):
        self.host = host
        self.port = port
        # optional same-host listener: serving the same /ws endpoint on
        # a unix-domain socket skips the TCP stack — the cheap wire for
        # co-located workers (clients dial ``unix://<path>``)
        self.uds_path = uds_path
        self._uds_site: Optional[web.UnixSite] = None
        self.default_workspace = default_workspace
        self.admin_users = list(admin_users or [])
        self.token_ttl_seconds = token_ttl_seconds
        self.logger = create_logger("rpc.server", log_file="off")

        self._tokens: dict[str, TokenInfo] = {}
        self._services: dict[str, ServiceEntry] = {}
        self._clients: dict[str, web.WebSocketResponse] = {}
        self._client_users: dict[str, TokenInfo] = {}
        self._pending: dict[str, asyncio.Future] = {}
        self._pending_owner: dict[str, str] = {}  # call_id -> provider client
        # open streaming calls forwarded to remote providers: call_id ->
        # queue of ("item", seq, value) / ("end", result, None) /
        # ("err", 0, exc), drained by call_service_stream
        self._stream_sinks: dict[str, asyncio.Queue] = {}
        self._runner: Optional[web.AppRunner] = None
        self._site: Optional[web.TCPSite] = None
        self._static_dirs: dict[str, Any] = {}  # name -> Path
        self.artifact_service = None            # attach_artifact_service
        self._mcp_apps: dict[str, Any] = {}     # app_id -> AppServiceProxy
        # zero-copy data plane: one Codec per websocket client, all
        # feeding one server-wide RpcStats (surfaced by describe())
        self.transport_config = transport_config or TransportConfig.from_env()
        self.stats = RpcStats()
        self._client_codecs: dict[str, Codec] = {}
        # capability sets each ws client declared at its handshake
        # (oob/trace live on the codec; the rest are looked up here)
        self._client_protos: dict[str, frozenset[str]] = {}
        self._shm_store_cfg = shm_store
        self._shm_store: Any = None
        # microsecond hot path: an untraced CALL whose target is a
        # LOCAL sync method is executed inline from the read loop —
        # no asyncio task per request (~10-20us saved per call).
        # (service_id, method) -> eligible; cleared on (un)register.
        self._inline_sync: dict[tuple, bool] = {}
        self._inline_dispatch = (
            inline_dispatch
            if inline_dispatch is not None
            else os.environ.get("BIOENGINE_RPC_INLINE_DISPATCH", "1") != "0"
        )
        self._shm_nonces: dict[str, tuple[str, bytes]] = {}  # client -> (key, nonce)
        # controller fencing epoch (set by ServeController.attach_rpc):
        # advertised in the welcome so a connecting host can spot a
        # stale (wedged-then-revived) controller before any verbs flow
        self.epoch: Optional[int] = None

    # ---- lifecycle ----------------------------------------------------------

    def _resolve_shm_store(self) -> Any:
        """The same-host fast-path segment. ``"auto"`` attaches (or
        creates) the shared native segment when the toolchain allows;
        an explicit store instance is used as-is (how tests wire a
        LocalObjectStore through both ends in-process); None disables.
        Auto failures are silent by design — the wire path is always
        sufficient."""
        cfg = self._shm_store_cfg
        if cfg is None:
            return None
        if cfg != "auto":
            return cfg
        import os as _os

        if _os.environ.get("BIOENGINE_RPC_SHM", "1") == "0":
            return None
        from bioengine_tpu_torch.native import store as native_store

        if not native_store.native_available():
            return None
        try:
            name = _os.environ.get("BIOENGINE_RPC_STORE_NAME", "bioengine-rpc")
            cap_mb = float(_os.environ.get("BIOENGINE_RPC_STORE_MB", "256"))
            return native_store.SharedObjectStore(
                name, capacity=int(cap_mb * 1024 * 1024), create="attach"
            )
        except Exception as e:  # noqa: BLE001 — degrade to wire frames
            self.logger.warning(f"shm store unavailable ({e}); wire-only")
            return None

    async def start(self) -> str:
        # the first native-store probe may BUILD the ctypes lib
        # (subprocess cc) — seconds of work that must not sit on the loop
        self._shm_store = await asyncio.to_thread(self._resolve_shm_store)
        app = web.Application(client_max_size=256 * 1024 * 1024)
        app.router.add_get("/ws", self._handle_ws)
        app.router.add_get("/health/liveness", self._handle_health)
        app.router.add_get("/services", self._handle_list_http)
        # Prometheus scrape surface: the process-wide metrics registry
        # (request latency histograms, transport counters, serving
        # gauges) in text exposition format — docs/observability.md
        app.router.add_get("/metrics", self._handle_metrics)
        # JSON-over-HTTP bridge: what browser frontends use (the
        # reference's frontends call Hypha services from JS, ref
        # apps/cellpose-finetuning/frontend/index.html; here the bridge
        # is part of the framework's own server)
        app.router.add_post("/call/{service_id}/{method}", self._handle_call_http)
        # dynamically registered app frontends (register_static_dir)
        app.router.add_get("/apps/{name}", self._handle_static)
        app.router.add_get("/apps/{name}/{rest:.*}", self._handle_static)
        # artifact manager HTTP surface (attach_artifact_service)
        app.router.add_route(
            "*", "/artifacts{tail:.*}", self._handle_artifacts
        )
        # per-app MCP endpoints (register_mcp_app)
        app.router.add_post("/mcp/{name}", self._handle_mcp)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        self._site = web.TCPSite(self._runner, self.host, self.port)
        await self._site.start()
        self.port = self._site._server.sockets[0].getsockname()[1]
        if self.uds_path:
            try:
                os.unlink(self.uds_path)  # stale socket from a crash
            except OSError:
                pass
            self._uds_site = web.UnixSite(self._runner, self.uds_path)
            await self._uds_site.start()
            self.logger.info(f"RPC server also on unix://{self.uds_path}")
        self.logger.info(f"RPC server listening on ws://{self.host}:{self.port}/ws")
        return self.url

    async def stop(self) -> None:
        for ws in list(self._clients.values()):
            await ws.close()
        if self._runner:
            await self._runner.cleanup()
        if self.uds_path:
            try:
                os.unlink(self.uds_path)
            except OSError:
                pass
        for codec in self._client_codecs.values():
            codec.close()
        self._client_codecs.clear()
        if self._shm_store is not None:
            self._shm_store.close()  # segment stays for other processes
            self._shm_store = None

    def describe(self) -> dict:
        """Control-plane + data-plane observability: who's connected,
        what's registered, and the transport counters (bytes, frames,
        chunked sends, encode/decode seconds, shm hit-rate)."""
        d = {
            "url": self.url,
            "uds_path": self.uds_path,
            "services": len(self._services),
            "clients": len(self._clients),
            "transport": self.stats.as_dict(),
            "shm": None,
        }
        if self._shm_store is not None:
            shm_clients = sum(
                1 for c in self._client_codecs.values() if c.shm_store is not None
            )
            try:
                store_stats = self._shm_store.stats()
            except Exception as e:  # noqa: BLE001 — stats never break status
                store_stats = {"error": str(e)}
            d["shm"] = {
                "store": self._shm_store.name,
                "negotiated_clients": shm_clients,
                **store_stats,
            }
        return d

    @property
    def url(self) -> str:
        return f"ws://{self.host}:{self.port}/ws"

    @property
    def http_url(self) -> str:
        """Advertisable base URL: a wildcard bind resolves to this
        machine's routable address, never 'http://0.0.0.0:...'."""
        host = self.host
        if host in ("0.0.0.0", "::"):
            from bioengine_tpu_torch.utils.network import get_internal_ip

            host = get_internal_ip()
        return f"http://{host}:{self.port}"

    # ---- tokens -------------------------------------------------------------

    def issue_token(
        self,
        user_id: str,
        workspace: Optional[str] = None,
        ttl_seconds: Optional[float] = None,
        is_admin: Optional[bool] = None,
        token_value: Optional[str] = None,
    ) -> str:
        # token_value lets the worker honor a pre-shared admin token
        # (env BIOENGINE_ADMIN_TOKEN) instead of a generated one.
        # Auth tokens MUST be crypto-random (issuance is login-rate,
        # not request-rate, so the urandom cost is fine here).
        # bioengine: ignore[BE-PERF-302]
        token = token_value or secrets.token_urlsafe(32)
        # opportunistic expiry sweep: lazy deletion in validate_token
        # only reaps tokens that are presented again — without this,
        # a token minted and never revalidated lives forever
        now = time.time()
        for stale in [
            t for t, info in self._tokens.items() if info.expires_at <= now
        ]:
            self._tokens.pop(stale, None)
        self._tokens[token] = TokenInfo(
            user_id=user_id,
            workspace=workspace or self.default_workspace,
            expires_at=time.time() + (ttl_seconds or self.token_ttl_seconds),
            is_admin=user_id in self.admin_users if is_admin is None else is_admin,
        )
        return token

    def validate_token(self, token: str) -> TokenInfo:
        info = self._tokens.get(token)
        if info is None:
            raise PermissionError("Unknown token")
        if time.time() > info.expires_at:
            del self._tokens[token]
            raise PermissionError("Token expired")
        return info

    def _context_for(self, info: TokenInfo) -> dict:
        return {
            "user": {
                "id": info.user_id,
                "email": f"{info.user_id}@bioengine",
                "is_anonymous": info.user_id == "anonymous",
                "roles": ["admin"] if info.is_admin else [],
            },
            "ws": info.workspace,
        }

    # ---- in-process services ------------------------------------------------

    def register_local_service(self, definition: dict[str, Any]) -> ServiceEntry:
        """Register a service whose methods are local callables (the path
        the worker itself uses in standalone mode)."""
        service_id = definition["id"]
        workspace = definition.get("workspace", self.default_workspace)
        methods = {
            k: v for k, v in definition.items() if callable(v)
        }
        entry = ServiceEntry(
            service_id=service_id,
            workspace=workspace,
            owner_client=None,
            definition={
                k: v for k, v in definition.items() if not callable(v)
            },
            methods=methods,
            schemas={
                k: getattr(v, "__schema__", None) or extract_schema(v)
                for k, v in methods.items()
            },
        )
        self._services[entry.full_id] = entry
        self._inline_sync.clear()
        self.logger.info(f"Registered local service {entry.full_id}")
        return entry

    def unregister_service(self, full_id: str) -> None:
        self._services.pop(full_id, None)
        self._inline_sync.clear()

    def service_peer_supports(self, full_id: str, capability: str) -> bool:
        """Did the ws client that OWNS ``full_id`` declare ``capability``
        at its handshake? In-process services (owner_client None) share
        this process's code and support everything we do. The mesh
        planner gates cross-host shard placement on this — a legacy
        worker host that never declared ``mesh1`` must not be handed a
        ``mesh_shard`` start it cannot honor."""
        entry = self._services.get(full_id)
        if entry is None:
            return False
        if entry.owner_client is None:
            return True
        return capability in self._client_protos.get(
            entry.owner_client, frozenset()
        )

    def list_services(self, workspace: Optional[str] = None) -> list[dict]:
        out = []
        for entry in self._services.values():
            if workspace and entry.workspace != workspace:
                continue
            out.append(
                {
                    "id": entry.full_id,
                    "name": entry.definition.get("name", entry.service_id),
                    "type": entry.definition.get("type", "generic"),
                    "description": entry.definition.get("description", ""),
                    "config": entry.definition.get("config", {}),
                    "methods": sorted(entry.schemas),
                }
            )
        return out

    async def call_service_method(
        self,
        full_id: str,
        method: str,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        caller: Optional[TokenInfo] = None,
        timeout: float = 300.0,
    ) -> Any:
        """Route a call to an in-process or remote-client service.

        ``visibility: "protected"`` services (worker-host replica verbs,
        internal control surfaces) accept only admin callers; the
        in-process path (``caller=None`` — the controller itself) is
        trusted. Public services do their own per-method enforcement."""
        kwargs = dict(kwargs or {})
        entry = self._find_service(full_id)
        visibility = entry.definition.get("config", {}).get(
            "visibility", "public"
        )
        if visibility == "protected" and caller is not None and not caller.is_admin:
            raise PermissionError(
                f"service '{full_id}' is protected (admin required)"
            )
        require_context = entry.definition.get("config", {}).get(
            "require_context", False
        )
        if require_context:
            kwargs["context"] = self._context_for(
                caller
                or TokenInfo("anonymous", self.default_workspace, time.time() + 60)
            )
        if entry.owner_client is None:
            fn = entry.methods.get(method)
            if fn is None:
                raise AttributeError(f"{full_id} has no method '{method}'")
            # gate the attr-dict build on the sampled check — this
            # runs once per local dispatch on the unsampled hot path
            with (
                tracing.span("rpc.dispatch", service=full_id, method=method)
                if tracing.sampled()
                else tracing.NOOP_SPAN
            ):
                result = fn(*args, **kwargs)
                if asyncio.iscoroutine(result):
                    result = await result
            return result
        # remote provider: forward over its websocket
        ws = self._clients.get(entry.owner_client)
        if ws is None or ws.closed:
            raise ConnectionError(f"Provider for {full_id} is gone")
        call_id = tracing.new_id()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[call_id] = fut
        self._pending_owner[call_id] = entry.owner_client
        msg = {
            "t": protocol.CALL,
            "call_id": call_id,
            "service_id": full_id,
            "method": method,
            "args": list(args),
            "kwargs": kwargs,
        }
        # carry the caller's sampled trace context to the provider —
        # only when that provider declared trace1 at its handshake
        # (legacy peers see a byte-identical CALL)
        codec = self._client_codecs.get(entry.owner_client)
        ctx = tracing.current_trace()
        if codec is not None and codec.trace and ctx is not None and ctx.sampled:
            msg["trace"] = ctx.to_wire()
        try:
            with (
                tracing.span("rpc.call", service=full_id, method=method)
                if tracing.sampled()
                else tracing.NOOP_SPAN
            ):
                await self._send(ws, codec, msg)
                return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(call_id, None)
            self._pending_owner.pop(call_id, None)

    async def call_service_stream(
        self,
        full_id: str,
        method: str,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        caller: Optional[TokenInfo] = None,
        timeout: float = 300.0,
    ):
        """Streaming counterpart of ``call_service_method``: async-
        iterates the items of an async-generator service method.

        Same permission/context rules. Local providers run in-process;
        remote providers must have declared ``stream1`` at their
        handshake (their items arrive as STREAM frames routed into a
        per-call queue and re-yielded here, so in-process and remote
        callers share one ordering/truncation contract). ``timeout`` is
        a per-item inactivity bound, not a whole-stream one — a healthy
        generation outlives any unary deadline."""
        kwargs = dict(kwargs or {})
        entry = self._find_service(full_id)
        visibility = entry.definition.get("config", {}).get(
            "visibility", "public"
        )
        if visibility == "protected" and caller is not None and not caller.is_admin:
            raise PermissionError(
                f"service '{full_id}' is protected (admin required)"
            )
        if entry.definition.get("config", {}).get("require_context", False):
            kwargs["context"] = self._context_for(
                caller
                or TokenInfo("anonymous", self.default_workspace, time.time() + 60)
            )
        if entry.owner_client is None:
            fn = entry.methods.get(method)
            if fn is None:
                raise AttributeError(f"{full_id} has no method '{method}'")
            result = fn(*args, **kwargs)
            if asyncio.iscoroutine(result):
                result = await result
            if not hasattr(result, "__aiter__"):
                # unary method under a streaming call: one-item stream
                yield result
                return
            try:
                async for item in result:
                    yield item
            finally:
                # closing THIS generator must deterministically close
                # the provider's, so its finally blocks run now rather
                # than at GC
                with contextlib.suppress(Exception):
                    await result.aclose()
            return
        # remote provider: forward as a streaming CALL, drain the sink
        if not self.service_peer_supports(entry.full_id, protocol.PROTO_STREAM1):
            raise RuntimeError(
                f"provider of '{full_id}' does not support streaming "
                "calls (stream1)"
            )
        ws = self._clients.get(entry.owner_client)
        if ws is None or ws.closed:
            raise ConnectionError(f"Provider for {full_id} is gone")
        call_id = tracing.new_id()
        q: asyncio.Queue = asyncio.Queue()
        self._stream_sinks[call_id] = q
        self._pending_owner[call_id] = entry.owner_client
        msg = {
            "t": protocol.CALL,
            "call_id": call_id,
            "service_id": entry.full_id,
            "method": method,
            "args": list(args),
            "kwargs": kwargs,
            "stream": True,
        }
        codec = self._client_codecs.get(entry.owner_client)
        ctx = tracing.current_trace()
        if codec is not None and codec.trace and ctx is not None and ctx.sampled:
            msg["trace"] = ctx.to_wire()
        expected = 0
        try:
            await self._send(ws, codec, msg)
            while True:
                kind, a, b = await asyncio.wait_for(q.get(), timeout)
                if kind == "item":
                    if a != expected:
                        raise ConnectionError(
                            f"stream {call_id} gap: expected item "
                            f"{expected}, got {a}"
                        )
                    expected += 1
                    yield b
                elif kind == "end":
                    n = a.get("n") if isinstance(a, dict) else None
                    if n is not None and n != expected:
                        raise ConnectionError(
                            f"stream {call_id} truncated: provider sent "
                            f"{n} items, received {expected}"
                        )
                    return
                else:
                    raise b
        finally:
            self._stream_sinks.pop(call_id, None)
            self._pending_owner.pop(call_id, None)

    def _find_service(self, full_id: str) -> ServiceEntry:
        if full_id in self._services:
            return self._services[full_id]
        # allow bare ids (unique across workspaces) like the reference's
        # service lookup convenience
        matches = [
            e for e in self._services.values() if e.service_id == full_id
        ]
        if len(matches) == 1:
            return matches[0]
        raise KeyError(f"Service '{full_id}' not found")

    # ---- websocket handling -------------------------------------------------

    async def _handle_health(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "ok", "services": len(self._services)})

    async def _handle_metrics(self, request: web.Request) -> web.Response:
        return web.Response(
            body=metrics.render_prometheus().encode(),
            headers={
                "Content-Type": "text/plain; version=0.0.4; charset=utf-8"
            },
        )

    async def _handle_list_http(self, request: web.Request) -> web.Response:
        return web.json_response(self.list_services())

    # ---- HTTP bridge + app frontends -----------------------------------------

    def register_static_dir(self, name: str, directory) -> str:
        """Serve ``directory`` at ``/apps/{name}/`` (an app's browser
        frontend). Returns the URL path prefix."""
        from pathlib import Path

        self._static_dirs[name] = Path(directory).resolve()
        return f"/apps/{name}/"

    def unregister_static_dir(self, name: str) -> None:
        self._static_dirs.pop(name, None)

    async def _handle_static(self, request: web.Request) -> web.Response:
        name = request.match_info["name"]
        root = self._static_dirs.get(name)
        if root is None:
            raise web.HTTPNotFound(reason=f"no frontend '{name}'")
        if "rest" not in request.match_info:
            # /apps/foo -> /apps/foo/ so the page's relative asset URLs
            # resolve inside the frontend dir
            raise web.HTTPFound(f"/apps/{name}/")
        rest = request.match_info.get("rest", "") or "index.html"
        target = (root / rest).resolve()
        if not target.is_relative_to(root):
            raise web.HTTPForbidden(reason="path escapes frontend dir")
        if target.is_dir():
            target = target / "index.html"
        if not target.is_file():
            raise web.HTTPNotFound()
        return web.FileResponse(target)

    def register_mcp_app(self, app_id: str, proxy) -> str:
        """Expose a deployed app as an MCP server at ``/mcp/{app_id}``
        (streamable HTTP, apps/mcp.py). Returns the URL path."""
        self._mcp_apps[app_id] = proxy
        return f"/mcp/{app_id}"

    def unregister_mcp_app(self, app_id: str) -> None:
        self._mcp_apps.pop(app_id, None)

    async def _handle_mcp(self, request: web.Request) -> web.Response:
        from bioengine_tpu_torch.apps.mcp import handle_message

        proxy = self._mcp_apps.get(request.match_info["name"])
        if proxy is None:
            raise web.HTTPNotFound(
                reason=f"no MCP app '{request.match_info['name']}'"
            )
        try:
            caller = self._http_caller(request)
        except PermissionError as e:
            return web.json_response({"error": str(e)}, status=401)
        try:
            body = await request.json()
        except ValueError:
            body = None
        if not isinstance(body, dict):
            return web.json_response(
                {
                    "jsonrpc": "2.0",
                    "id": None,
                    "error": {"code": -32700, "message": "parse error"},
                },
                status=400,
            )
        response = await handle_message(
            proxy, body, self._context_for(caller)
        )
        if response is None:  # notification
            return web.Response(status=202)
        return web.json_response(response)

    def attach_artifact_service(self, service) -> None:
        """Serve an ArtifactHttpService at ``/artifacts`` (presigned
        uploads, versioned fetch, static site — apps/artifact_http.py)."""
        self.artifact_service = service

    async def _handle_artifacts(self, request: web.Request) -> web.Response:
        if self.artifact_service is None:
            raise web.HTTPNotFound(reason="no artifact service attached")
        return await self.artifact_service.handle(request)

    def _http_caller(self, request: web.Request) -> TokenInfo:
        token = request.query.get("token", "")
        auth = request.headers.get("Authorization", "")
        if auth.startswith("Bearer "):
            token = auth[len("Bearer "):]
        if token:
            return self.validate_token(token)  # PermissionError -> 401
        return TokenInfo("anonymous", self.default_workspace, time.time() + 60)

    async def _handle_call_http(self, request: web.Request) -> web.Response:
        """POST /call/{service_id}/{method} with JSON body
        ``{"args": [...], "kwargs": {...}}`` — the browser-facing call
        path. Same auth + context injection as the websocket plane."""
        try:
            caller = self._http_caller(request)
        except PermissionError as e:
            return web.json_response({"error": str(e)}, status=401)
        try:
            body = await request.json() if request.can_read_body else {}
        except ValueError:
            body = None
        if not isinstance(body, dict):
            return web.json_response({"error": "invalid JSON body"}, status=400)
        service_id = request.match_info["service_id"]
        method = request.match_info["method"]
        # resolve first so only a wrong service/method is a 404 — an app
        # bug raising KeyError inside the call must surface as a 500
        try:
            entry = self._find_service(service_id)
        except KeyError as e:
            return web.json_response({"error": str(e)}, status=404)
        if entry.owner_client is None and method not in entry.methods:
            return web.json_response(
                {"error": f"{service_id} has no method '{method}'"}, status=404
            )
        try:
            result = await self.call_service_method(
                entry.full_id,
                method,
                tuple(body.get("args", ())),
                body.get("kwargs", {}),
                caller=caller,
            )
            return web.json_response({"result": _to_jsonable(result)})
        except PermissionError as e:
            return web.json_response({"error": str(e)}, status=403)
        except Exception as e:
            return web.json_response(
                {"error": f"{type(e).__name__}: {e}"}, status=500
            )

    async def _send(
        self, ws: web.WebSocketResponse, codec: Optional[Codec], msg: dict
    ) -> None:
        """Encode per the client's negotiated capabilities and send —
        one websocket message per frame (oversized frames go out as a
        chunk sequence). Large payloads encode off-loop."""
        if faults.ACTIVE:
            await faults.hit("rpc.server.send", drop=ws.close)
        if codec is None:
            codec = Codec(config=self.transport_config, stats=self.stats)
        if codec.fast:
            # small-response hot path: one sync encode attempt, one
            # send — skips the coroutine + payload walk when it hits
            frame = codec.encode_fast_frame(msg)
            if frame is not None:
                await ws.send_bytes(frame)
                return
        for frame in await codec.encode_frames_async(msg):
            await ws.send_bytes(frame)

    async def _handle_ws(self, request: web.Request) -> web.WebSocketResponse:
        token = request.query.get("token", "")
        try:
            if token:
                info = self.validate_token(token)
            else:
                info = TokenInfo(
                    "anonymous", self.default_workspace, time.time() + 86400
                )
        except PermissionError as e:
            raise web.HTTPUnauthorized(reason=str(e))

        ws = web.WebSocketResponse(max_msg_size=self.transport_config.max_msg_size)
        await ws.prepare(request)
        client_id = uuid.uuid4().hex
        codec = Codec(config=self.transport_config, stats=self.stats)
        # the client declares codec support at handshake time; anything
        # it doesn't declare gets legacy single-blob frames forever
        declared = request.query.get("proto", "").split(",")
        codec.oob = protocol.PROTO_OOB1 in declared
        codec.trace = protocol.PROTO_TRACE1 in declared
        codec.fast = protocol.PROTO_FAST1 in declared
        self._clients[client_id] = ws
        # the full declared set outlives the codec flags: server-side
        # capability gates (e.g. the controller refusing to plan a
        # cross-host mesh onto a pre-mesh1 host) ask via
        # service_peer_supports
        self._client_protos[client_id] = frozenset(p for p in declared if p)
        self._client_users[client_id] = info
        self._client_codecs[client_id] = codec
        welcome = {
            "t": "welcome",
            "client_id": client_id,
            "workspace": info.workspace,
            "user_id": info.user_id,
            "protocols": [
                protocol.PROTO_OOB1,
                protocol.PROTO_TRACE1,
                protocol.PROTO_TELEM1,
                protocol.PROTO_MESH1,
                protocol.PROTO_EPOCH1,
                protocol.PROTO_FAST1,
                protocol.PROTO_STREAM1,
            ],
        }
        if self.epoch is not None:
            welcome["epoch"] = self.epoch
        if codec.oob and self._shm_store is not None:
            # same-host probe: the client must read this nonce OUT OF
            # the segment and echo it back — proof the two processes
            # map the same shm, not just claim the same store name
            probe_key = f"rpc/probe/{client_id}"
            nonce = secrets.token_bytes(16)
            try:
                if self._shm_store.try_put(probe_key, nonce):
                    self._shm_nonces[client_id] = (probe_key, nonce)
                    welcome["shm"] = {
                        "name": self._shm_store.name,
                        "probe_key": probe_key,
                    }
            except Exception as e:  # noqa: BLE001 — probe failure = wire-only
                self.logger.warning(f"shm probe put failed: {e}")
        await self._send(ws, codec, welcome)
        try:
            async for msg in ws:
                if msg.type != WSMsgType.BINARY:
                    continue
                raw = msg.data
                try:
                    if protocol.is_fast_frame(raw):
                        # BEFS: sync decode, nothing pinned to drain.
                        # A fast frame is only ever CALL or RESULT and
                        # a fast CALL can never carry a trace
                        # attachment (the encoder rejects it), so the
                        # inline gate here is just the memoized plan —
                        # and the hot path runs handler-from-tuple
                        # without ever materializing the envelope dict
                        parsed = (
                            codec.decode_fast_call_frame(raw)
                            if self._inline_dispatch
                            else None
                        )
                        if parsed is not None:
                            call_id, sid, mth, c_args, c_kwargs = parsed
                            plan = self._inline_call_plan(sid, mth)
                            if plan:
                                await self._handle_call_inline(
                                    ws, codec, info,
                                    call_id, sid, c_args, c_kwargs,
                                    plan,
                                )
                                continue
                            await self._dispatch(client_id, ws, {
                                "t": protocol.CALL,
                                "call_id": call_id,
                                "service_id": sid,
                                "method": mth,
                                "args": c_args,
                                "kwargs": c_kwargs,
                            })
                            continue
                        # per-token stream frames from a provider ride
                        # straight into the caller's sink — no envelope
                        # dict on the per-item hot path
                        sparsed = codec.decode_fast_stream_frame(raw)
                        if sparsed is not None:
                            sink = self._stream_sinks.get(sparsed[0])
                            if sink is not None:
                                sink.put_nowait(
                                    ("item", sparsed[1], sparsed[2])
                                )
                            continue
                        await self._dispatch(
                            client_id, ws, codec.decode_fast_frame(raw)
                        )
                        continue
                    try:
                        decoded = await codec.decode_async(raw)
                        if decoded is None:
                            continue  # mid-reassembly chunk
                        await self._dispatch(client_id, ws, decoded)
                    finally:
                        # one-shot shm payloads whose consumers
                        # finished leave the arena as soon as possible
                        codec.drain_pins()
                except Exception as e:  # keep the connection alive
                    self.logger.error(f"dispatch error: {e}")
        finally:
            self._drop_client(client_id)
        return ws

    def _drop_client(self, client_id: str) -> None:
        self._clients.pop(client_id, None)
        self._client_users.pop(client_id, None)
        self._client_protos.pop(client_id, None)
        codec = self._client_codecs.pop(client_id, None)
        if codec is not None:
            codec.close()
        probe = self._shm_nonces.pop(client_id, None)
        if probe is not None and self._shm_store is not None:
            try:
                self._shm_store.delete(probe[0])
            except Exception as e:  # noqa: BLE001 — client may have deleted it
                self.logger.debug(f"probe cleanup raced: {e}")
        for full_id in [
            fid
            for fid, e in self._services.items()
            if e.owner_client == client_id
        ]:
            del self._services[full_id]
            self._inline_sync.clear()
            self.logger.info(f"Dropped service {full_id} (client disconnect)")
        # fail every in-flight call routed to this client NOW — without
        # this, callers hang for the full RPC timeout after a provider
        # crash (a worker-host SIGKILL must fail fast so the serving
        # controller can restart the replica elsewhere)
        for call_id, owner in list(self._pending_owner.items()):
            if owner != client_id:
                continue
            fut = self._pending.get(call_id)
            if fut and not fut.done():
                fut.set_exception(
                    ConnectionError(
                        f"provider client {client_id} disconnected mid-call"
                    )
                )
            # streams in flight from this provider fail with the same
            # typed error, immediately — a caller mid-generation must
            # see the drop now, not an inter-token timeout later
            sink = self._stream_sinks.get(call_id)
            if sink is not None:
                sink.put_nowait(
                    ("err", 0, ConnectionError(
                        f"provider client {client_id} disconnected mid-stream"
                    ))
                )

    async def _dispatch(
        self, client_id: str, ws: web.WebSocketResponse, msg: dict
    ) -> None:
        t = msg.get("t")
        info = self._client_users[client_id]
        codec = self._client_codecs.get(client_id)
        if t == protocol.CALL:
            # checked first — CALL dominates the message mix.
            # Uncontended small-request path: a sync local handler runs
            # for ~microseconds either way — spawning a supervised task
            # just to host it costs more than the call itself. Inline
            # keeps ordering per connection (the read loop is already
            # sequential); async handlers and remote providers still
            # take the task path so pipelined calls interleave.
            plan = (
                self._inline_dispatch
                and "trace" not in msg
                and self._inline_call_plan(
                    msg.get("service_id"), msg.get("method")
                )
            )
            if plan:
                await self._handle_call_inline(
                    ws, codec, info,
                    msg.get("call_id"), msg.get("service_id"),
                    msg.get("args", ()), msg.get("kwargs") or {},
                    plan,
                )
            else:
                spawn_supervised(
                    self._handle_call(ws, codec, info, msg),
                    name="rpc-handle-call",
                    logger=self.logger,
                )
        elif t == protocol.PING:
            await self._send(ws, codec, {"t": protocol.PONG, "ts": time.time()})
        elif t == protocol.SHM_ACK:
            # the client read the probe nonce out of the segment and
            # echoed it: both processes provably map the same shm, so
            # large payloads to this client may ride the store
            probe = self._shm_nonces.pop(client_id, None)
            verified = (
                probe is not None
                and codec is not None
                and self._shm_store is not None
                and bytes(msg.get("nonce") or b"") == probe[1]
            )
            if verified:
                codec.enable_shm(self._shm_store)
                self.logger.info(
                    f"shm fast path negotiated with client {client_id}"
                )
            if probe is not None and self._shm_store is not None:
                try:
                    self._shm_store.delete(probe[0])
                except Exception as e:  # noqa: BLE001 — client may have deleted it
                    self.logger.debug("probe cleanup raced: %s", e)
            await self._send(
                ws,
                codec,
                {
                    "t": protocol.RESULT,
                    "call_id": msg.get("call_id"),
                    "result": bool(verified),
                },
            )
        elif t == protocol.REGISTER:
            definition = msg["definition"]
            entry = ServiceEntry(
                service_id=definition["id"],
                workspace=info.workspace,
                owner_client=client_id,
                definition={
                    k: v for k, v in definition.items() if k != "methods"
                },
                schemas=definition.get("methods", {}),
            )
            self._services[entry.full_id] = entry
            self._inline_sync.clear()
            await self._send(
                ws,
                codec,
                {
                    "t": protocol.RESULT,
                    "call_id": msg.get("call_id"),
                    "result": {"id": entry.full_id},
                },
            )
        elif t == protocol.UNREGISTER:
            entry = self._services.get(msg["service_id"])
            if entry and entry.owner_client == client_id:
                del self._services[msg["service_id"]]
                self._inline_sync.clear()
            await self._send(
                ws,
                codec,
                {
                    "t": protocol.RESULT,
                    "call_id": msg.get("call_id"),
                    "result": True,
                },
            )
        elif t == protocol.TOKEN:
            if not info.is_admin:
                await self._send_error(
                    ws, codec, msg.get("call_id"), PermissionError("admin required")
                )
                return
            # clients send explicit None for unset fields — `or` fallback,
            # not a .get default, so None resolves to the caller's identity
            token = self.issue_token(
                user_id=msg.get("user_id") or info.user_id,
                workspace=msg.get("workspace") or info.workspace,
                ttl_seconds=msg.get("ttl_seconds"),
                is_admin=bool(msg.get("is_admin")),
            )
            await self._send(
                ws,
                codec,
                {
                    "t": protocol.RESULT,
                    "call_id": msg.get("call_id"),
                    "result": token,
                },
            )
        elif t == protocol.LIST:
            await self._send(
                ws,
                codec,
                {
                    "t": protocol.RESULT,
                    "call_id": msg.get("call_id"),
                    "result": self.list_services(msg.get("workspace")),
                },
            )
        elif t == protocol.STREAM:
            sink = self._stream_sinks.get(msg.get("call_id", ""))
            if sink is not None:
                sink.put_nowait(("item", msg.get("seq", 0), msg.get("item")))
        elif t == protocol.RESULT:
            if msg.get("spans"):
                # spans a provider recorded while serving a sampled
                # call — absorbed here so the control-plane process
                # can hand back one cross-process tree via get_traces
                tracing.absorb_spans(msg["spans"])
            call_id = msg.get("call_id", "")
            fut = self._pending.get(call_id)
            if fut and not fut.done():
                fut.set_result(msg.get("result"))
            else:
                sink = self._stream_sinks.get(call_id)
                if sink is not None:
                    sink.put_nowait(("end", msg.get("result"), None))
        elif t == protocol.ERROR:
            if msg.get("spans"):
                tracing.absorb_spans(msg["spans"])
            call_id = msg.get("call_id", "")
            err = msg.get("error")
            if not isinstance(err, Exception):
                err = RuntimeError(str(err))
            fut = self._pending.get(call_id)
            if fut and not fut.done():
                fut.set_exception(err)
            else:
                sink = self._stream_sinks.get(call_id)
                if sink is not None:
                    sink.put_nowait(("err", 0, err))

    def _inline_call_plan(self, service_id, method):
        """Resolve a CALL target to a (fn, require_context, protected)
        plan when it is a local (in-process) plain-function method,
        else False. Memoized per (service_id, method) — the lookup
        runs on every request, so it must cost two dict hits, not an
        ``iscoroutinefunction`` + config walk. Any registry mutation
        clears the memo."""
        key = (service_id, method)
        plan = self._inline_sync.get(key)
        if plan is None:
            entry = self._services.get(service_id)
            fn = (
                entry.methods.get(method)
                if entry is not None and entry.owner_client is None
                else None
            )
            if fn is None or asyncio.iscoroutinefunction(fn):
                plan = False
            else:
                cfg = entry.definition.get("config", {})
                plan = (
                    fn,
                    bool(cfg.get("require_context", False)),
                    cfg.get("visibility", "public") == "protected",
                )
            self._inline_sync[key] = plan
        return plan

    async def _handle_call_inline(
        self,
        ws: web.WebSocketResponse,
        codec: Optional[Codec],
        info: TokenInfo,
        call_id,
        service_id,
        args,
        kwargs: dict,
        plan: tuple,
    ) -> None:
        """The microsecond dispatch path for an untraced CALL whose
        target resolved to a local sync method: the permission and
        context rules of ``call_service_method`` applied from the
        memoized plan, no span machinery (nothing is sampled here —
        the inline branch requires an untraced CALL), no pin drain
        (small frames carry no shm refs). Takes the envelope fields
        unpacked so the BEFS read-loop path never builds the dict."""
        fn, require_context, protected = plan
        try:
            if protected and not info.is_admin:
                raise PermissionError(
                    f"service '{service_id}' is protected "
                    "(admin required)"
                )
            if require_context:
                kwargs = dict(kwargs)
                kwargs["context"] = self._context_for(info)
            result = fn(*args, **kwargs)
            if asyncio.iscoroutine(result):
                result = await result
            if codec is not None and codec.fast:
                # straight from return value to wire: no RESULT dict
                # unless the fast encode bails (oversize payload)
                if faults.ACTIVE:
                    await faults.hit("rpc.server.send", drop=ws.close)
                frame = codec.encode_fast_result_frame(call_id, result)
                if frame is not None:
                    await ws.send_bytes(frame)
                    return
            await self._send(
                ws,
                codec,
                {
                    "t": protocol.RESULT,
                    "call_id": call_id,
                    "result": result,
                },
            )
        except Exception as e:
            await self._send_error(ws, codec, call_id, e)

    async def _handle_call(
        self,
        ws: web.WebSocketResponse,
        codec: Optional[Codec],
        info: TokenInfo,
        msg: dict,
    ) -> None:
        # a sampled caller's trace context wraps the whole dispatch:
        # spans recorded here (and piggybacked by a downstream
        # provider) ship back to the caller on the response frame
        ctx = token = None
        if codec is not None and codec.trace and isinstance(
            msg.get("trace"), dict
        ):
            ctx = tracing.TraceContext.from_wire(msg["trace"])
            token = tracing.activate(ctx)
        try:
            if msg.get("stream"):
                # streaming call: re-send each item to the caller as it
                # arrives (provider-side ordering is preserved by the
                # sequential per-websocket read loop), then close with
                # the counting RESULT
                seq = 0
                agen = self.call_service_stream(
                    msg["service_id"],
                    msg["method"],
                    tuple(msg.get("args", ())),
                    msg.get("kwargs", {}),
                    caller=info,
                )
                try:
                    async for item in agen:
                        await self._send_stream_item(
                            ws, codec, msg.get("call_id"), seq, item
                        )
                        seq += 1
                except BaseException:
                    # a failed send mid-stream must not leave the
                    # provider's generator suspended until GC — its
                    # finally blocks release decode slots / ongoing
                    # counts, so close it deterministically
                    with contextlib.suppress(Exception):
                        await agen.aclose()
                    raise
                result = {"n": seq}
            else:
                result = await self.call_service_method(
                    msg["service_id"],
                    msg["method"],
                    tuple(msg.get("args", ())),
                    msg.get("kwargs", {}),
                    caller=info,
                )
            response = {
                "t": protocol.RESULT,
                "call_id": msg.get("call_id"),
                "result": result,
            }
            if ctx is not None and ctx.collector:
                response["spans"] = ctx.collector
            await self._send(ws, codec, response)
        except Exception as e:
            await self._send_error(
                ws,
                codec,
                msg.get("call_id"),
                e,
                spans=ctx.collector if ctx is not None else None,
            )
        finally:
            if token is not None:
                tracing.deactivate(token)
            if codec is not None:
                # call args decoded from shm refs are dead once the
                # handler returns — release their pins promptly
                codec.drain_pins()

    async def _send_stream_item(
        self,
        ws: web.WebSocketResponse,
        codec: Optional[Codec],
        call_id,
        seq: int,
        item,
    ) -> None:
        """One stream item to a caller — fast frame first (per-token
        sends are the stream plane's hot path), STREAM envelope on
        fallback."""
        if codec is not None and codec.fast:
            if faults.ACTIVE:
                await faults.hit("rpc.server.send", drop=ws.close)
            frame = codec.encode_fast_stream_frame(call_id, seq, item)
            if frame is not None:
                await ws.send_bytes(frame)
                return
        await self._send(
            ws,
            codec,
            {"t": protocol.STREAM, "call_id": call_id, "seq": seq, "item": item},
        )

    async def _send_error(
        self,
        ws: web.WebSocketResponse,
        codec: Optional[Codec],
        call_id: Optional[str],
        error: Exception,
        spans: Optional[list] = None,
    ) -> None:
        msg = {"t": protocol.ERROR, "call_id": call_id, "error": error}
        if spans:
            msg["spans"] = spans
        await self._send(ws, codec, msg)
