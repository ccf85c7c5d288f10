"""HTTP dataset server: serves zarr datasets in place with auth + Range.

Capability parity with ref bioengine/datasets/proxy_server.py:106-652
(manifest-scan registry with hot reload, token->user cache, per-dataset
``authorized_users`` ACL, Range-capable file serving, public/private save
API with traversal protection, port scan + discovery-file write) — built
on aiohttp (no FastAPI in this image) and pluggable token validation so
it can authenticate against the framework's own RPC control plane
(:class:`bioengine_tpu_torch.rpc.server.RpcServer`) instead of an external
Hypha server.
"""

from __future__ import annotations

import asyncio
import json
import time
from collections import OrderedDict
from pathlib import Path
from typing import Awaitable, Callable, Optional

import yaml
from aiohttp import web

from bioengine_tpu_torch.utils.logger import create_logger
from bioengine_tpu_torch.utils.network import get_internal_ip
from bioengine_tpu_torch.utils.permissions import check_permissions, is_authorized

DEFAULT_START_PORT = 39527
DISCOVERY_FILE = Path.home() / ".bioengine_tpu" / "datasets" / "current_server"
MANIFEST_RELOAD_SECONDS = 30.0
TOKEN_CACHE_SIZE = 1000
TOKEN_CACHE_TTL_SECONDS = 60.0

# token -> context resolver; returns the permission context for a token.
# May be sync or async; a rejection must raise PermissionError (-> 401).
TokenValidator = Callable[[str], Awaitable[dict]]


async def _anonymous_validator(token: str) -> dict:
    return {"user": {"id": "anonymous", "email": "anonymous@local"}, "ws": "public"}


def rpc_token_validator(rpc_server) -> TokenValidator:
    """Adapt an in-process :class:`bioengine_tpu_torch.rpc.server.RpcServer`
    (sync ``validate_token`` returning TokenInfo) into a TokenValidator."""

    async def _validate(token: str) -> dict:
        info = rpc_server.validate_token(token)  # raises PermissionError
        return rpc_server._context_for(info)

    return _validate


class DatasetRegistry:
    """Scans ``data_dir`` for dataset directories containing manifest.yaml."""

    def __init__(self, data_dir: Path):
        self.data_dir = Path(data_dir)
        self.datasets: dict[str, dict] = {}
        self.last_scan = float("-inf")  # monotonic clock

    def scan(self) -> None:
        found = {}
        if self.data_dir.is_dir():
            for entry in sorted(self.data_dir.iterdir()):
                manifest_path = entry / "manifest.yaml"
                if not entry.is_dir() or not manifest_path.is_file():
                    continue
                try:
                    manifest = yaml.safe_load(manifest_path.read_text()) or {}
                except yaml.YAMLError:
                    continue
                found[entry.name] = {
                    "path": entry,
                    "description": manifest.get("description", ""),
                    "authorized_users": manifest.get("authorized_users", []),
                }
        self.datasets = found
        self.last_scan = time.monotonic()

    def maybe_rescan(self) -> None:
        if time.monotonic() - self.last_scan > MANIFEST_RELOAD_SECONDS:
            self.scan()


class DatasetsServer:
    """aiohttp application serving datasets + user-file save API."""

    def __init__(
        self,
        data_dir: Path | str,
        host: str = "0.0.0.0",
        port: int = 0,
        token_validator: Optional[TokenValidator] = None,
        log_file: Optional[str] = "off",
        write_discovery_file: bool = True,
    ):
        self.data_dir = Path(data_dir)
        self.host = host
        self.port = port
        self.token_validator = token_validator or _anonymous_validator
        self.write_discovery_file = write_discovery_file
        self.logger = create_logger("datasets.server", log_file=log_file)
        self.registry = DatasetRegistry(self.data_dir)
        self.saved_dir = self.data_dir / ".saved"
        self._token_cache: OrderedDict[str, tuple[dict, float]] = OrderedDict()
        self._runner: Optional[web.AppRunner] = None

    # -- auth -----------------------------------------------------------------

    async def _context_from_request(self, request: web.Request) -> dict:
        token = ""
        auth = request.headers.get("Authorization", "")
        if auth.startswith("Bearer "):
            token = auth[len("Bearer "):]
        token = token or request.query.get("token", "")
        if not token:
            return await _anonymous_validator("")
        cached = self._token_cache.get(token)
        if cached is not None and time.monotonic() - cached[1] < TOKEN_CACHE_TTL_SECONDS:
            self._token_cache.move_to_end(token)
            return cached[0]
        try:
            result = self.token_validator(token)
            context = await result if asyncio.iscoroutine(result) else result
        except PermissionError as e:
            self._token_cache.pop(token, None)
            raise web.HTTPUnauthorized(reason=str(e))
        self._token_cache[token] = (context, time.monotonic())
        while len(self._token_cache) > TOKEN_CACHE_SIZE:
            self._token_cache.popitem(last=False)
        return context

    def _check_dataset_access(self, name: str, context: dict) -> dict:
        self.registry.maybe_rescan()
        info = self.registry.datasets.get(name)
        if info is None:
            raise web.HTTPNotFound(reason=f"Unknown dataset '{name}'")
        try:
            check_permissions(context, info["authorized_users"], name)
        except PermissionError as e:
            raise web.HTTPForbidden(reason=str(e))
        return info

    @staticmethod
    def _safe_join(root: Path, rel: str) -> Path:
        """Join with traversal protection (ref proxy_server.py:390-553)."""
        target = (root / rel).resolve()
        if not str(target).startswith(str(root.resolve()) + "/") and target != root.resolve():
            raise web.HTTPBadRequest(reason="Path traversal rejected")
        return target

    # -- handlers -------------------------------------------------------------

    async def _handle_liveness(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "ok"})

    async def _handle_ping(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "ok", "pong": time.time()})

    async def _handle_list_datasets(self, request: web.Request) -> web.Response:
        context = await self._context_from_request(request)
        self.registry.maybe_rescan()
        out = []
        for name, info in self.registry.datasets.items():
            if is_authorized(context, info["authorized_users"]):
                out.append({"name": name, "description": info["description"]})
        return web.json_response(out)

    async def _handle_list_files(self, request: web.Request) -> web.Response:
        context = await self._context_from_request(request)
        name = request.match_info["dataset"]
        info = self._check_dataset_access(name, context)
        sub = request.query.get("path", "")
        root: Path = info["path"]
        target = self._safe_join(root, sub) if sub else root
        if not target.is_dir():
            raise web.HTTPNotFound(reason=f"No directory '{sub}' in '{name}'")
        files = []
        for p in sorted(target.iterdir()):
            if p.name == "manifest.yaml" and target == root:
                continue
            files.append(
                {
                    "name": p.name,
                    "type": "directory" if p.is_dir() else "file",
                    "size": p.stat().st_size if p.is_file() else None,
                }
            )
        return web.json_response(files)

    async def _handle_get_data(self, request: web.Request) -> web.StreamResponse:
        context = await self._context_from_request(request)
        name = request.match_info["dataset"]
        info = self._check_dataset_access(name, context)
        rel = request.match_info["path"]
        target = self._safe_join(info["path"], rel)
        if not target.is_file():
            raise web.HTTPNotFound(reason=f"No file '{rel}' in '{name}'")
        return await self._serve_file(request, target)

    async def _serve_file(
        self, request: web.Request, path: Path
    ) -> web.StreamResponse:
        """Range-capable file response (ref proxy_server.py:247-277)."""
        size = path.stat().st_size
        range_header = request.headers.get("Range")
        start, end = 0, size - 1
        status = 200
        if range_header and range_header.startswith("bytes="):
            spec = range_header[len("bytes="):].split(",")[0].strip()
            lo, _, hi = spec.partition("-")
            try:
                if lo:
                    start = int(lo)
                    end = int(hi) if hi else size - 1
                elif hi:  # suffix range: last N bytes
                    start = max(0, size - int(hi))
                else:
                    raise ValueError(spec)
                status = 206
            except ValueError:
                # RFC 7233: unparsable Range is ignored, full file served
                start, end, status = 0, size - 1, 200
            if status == 206:
                end = min(end, size - 1)
                if start > end or start >= size:
                    raise web.HTTPRequestRangeNotSatisfiable(
                        headers={"Content-Range": f"bytes */{size}"}
                    )
        length = end - start + 1
        headers = {
            "Accept-Ranges": "bytes",
            "Content-Length": str(length),
        }
        if status == 206:
            headers["Content-Range"] = f"bytes {start}-{end}/{size}"
        resp = web.StreamResponse(status=status, headers=headers)
        await resp.prepare(request)
        with path.open("rb") as f:
            f.seek(start)
            remaining = length
            while remaining > 0:
                # disk reads off the event loop so one slow-disk download
                # doesn't stall concurrent chunk fetches
                data = await asyncio.to_thread(
                    f.read, min(1024 * 1024, remaining)
                )
                if not data:
                    break
                await resp.write(data)
                remaining -= len(data)
        await resp.write_eof()
        return resp

    # -- save API (user files) -----------------------------------------------

    def _saved_root(self, scope: str, context: dict) -> Path:
        if scope == "public":
            return self.saved_dir / "public"
        user_id = (context.get("user") or {}).get("id", "anonymous")
        return self.saved_dir / "private" / user_id

    async def _handle_save(self, request: web.Request) -> web.Response:
        context = await self._context_from_request(request)
        scope = request.match_info["scope"]
        if scope not in ("public", "private"):
            raise web.HTTPBadRequest(reason="scope must be public|private")
        if scope == "private" and (context.get("user") or {}).get(
            "id", "anonymous"
        ) == "anonymous":
            raise web.HTTPForbidden(reason="Private save requires a token")
        rel = request.match_info["path"]
        root = self._saved_root(scope, context)
        target = self._safe_join(root, rel)
        target.parent.mkdir(parents=True, exist_ok=True)
        body = await request.read()
        await asyncio.to_thread(target.write_bytes, body)
        return web.json_response({"saved": rel, "size": len(body)})

    async def _handle_list_saved(self, request: web.Request) -> web.Response:
        context = await self._context_from_request(request)
        scope = request.match_info["scope"]
        root = self._saved_root(scope, context)
        if not root.is_dir():
            return web.json_response([])
        out = [
            {"name": str(p.relative_to(root)), "size": p.stat().st_size}
            for p in sorted(root.rglob("*"))
            if p.is_file()
        ]
        return web.json_response(out)

    async def _handle_get_saved(self, request: web.Request) -> web.StreamResponse:
        context = await self._context_from_request(request)
        scope = request.match_info["scope"]
        rel = request.match_info["path"]
        root = self._saved_root(scope, context)
        target = self._safe_join(root, rel)
        if not target.is_file():
            raise web.HTTPNotFound(reason=f"No saved file '{rel}'")
        return await self._serve_file(request, target)

    # -- lifecycle ------------------------------------------------------------

    def _build_app(self) -> web.Application:
        app = web.Application(client_max_size=1024 * 1024 * 1024)
        app.router.add_get("/health/liveness", self._handle_liveness)
        app.router.add_get("/ping", self._handle_ping)
        app.router.add_get("/datasets", self._handle_list_datasets)
        app.router.add_get("/datasets/{dataset}/files", self._handle_list_files)
        app.router.add_get("/data/{dataset}/{path:.+}", self._handle_get_data)
        app.router.add_put("/saved/{scope}/{path:.+}", self._handle_save)
        app.router.add_get("/saved/{scope}", self._handle_list_saved)
        app.router.add_get("/saved/{scope}/{path:.+}", self._handle_get_saved)
        return app

    async def start(self) -> str:
        self.registry.scan()
        self._runner = web.AppRunner(self._build_app())
        await self._runner.setup()
        if self.port != 0:
            candidates = [self.port]
        else:
            # scan upward from the conventional start port so multiple
            # servers on one host don't collide (ref proxy_server.py:636-652);
            # bind directly instead of probe-then-bind to avoid TOCTOU races
            candidates = list(
                range(DEFAULT_START_PORT, DEFAULT_START_PORT + 100)
            )
        last_error: Optional[OSError] = None
        for port in candidates:
            site = web.TCPSite(self._runner, self.host, port)
            try:
                await site.start()
                self.port = port
                break
            except OSError as e:
                last_error = e
        else:
            await self._runner.cleanup()
            raise RuntimeError(f"No free port for datasets server: {last_error}")
        url = self.url
        if self.write_discovery_file:
            DISCOVERY_FILE.parent.mkdir(parents=True, exist_ok=True)
            DISCOVERY_FILE.write_text(url)
        self.logger.info(
            f"Datasets server on {url} ({len(self.registry.datasets)} datasets)"
        )
        return url

    async def stop(self) -> None:
        if self._runner:
            await self._runner.cleanup()
        if self.write_discovery_file and DISCOVERY_FILE.exists():
            try:
                if DISCOVERY_FILE.read_text() == self.url:
                    DISCOVERY_FILE.unlink()
            except OSError:
                pass

    @property
    def url(self) -> str:
        host = get_internal_ip() if self.host == "0.0.0.0" else self.host
        return f"http://{host}:{self.port}"


async def start_proxy_server(
    data_dir: Path | str, **kwargs
) -> DatasetsServer:
    server = DatasetsServer(data_dir, **kwargs)
    await server.start()
    return server
