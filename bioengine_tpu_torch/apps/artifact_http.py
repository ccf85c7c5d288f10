"""HTTP artifact service + remote client.

The reference keeps app packages in Hypha's remote artifact manager:
clients request a presigned PUT URL per file, upload over plain HTTP,
then ``commit`` finalizes the staged version; artifacts get a public
static-site URL (ref bioengine/utils/artifact_utils.py:481-548,
600-628). This framework ships its own control plane, so the artifact
manager is part of it: ``ArtifactHttpService`` mounts the same
capability surface on the RPC server's HTTP app, backed by a
``LocalArtifactStore``; ``RemoteArtifactStore`` is the client side,
interface-compatible with ``LocalArtifactStore`` so AppBuilder /
AppsManager work against either transparently.

Routes (mounted under ``/artifacts``):

- ``GET    /artifacts``                          list artifact ids
- ``GET    /artifacts/{id}``                     {versions, latest}
- ``GET    /artifacts/{id}/manifest?version=``   manifest (yaml text)
- ``GET    /artifacts/{id}/files?version=``      file listing
- ``GET    /artifacts/{id}/files/{path}?version=``  file bytes
- ``GET    /artifacts/{id}/view/{path}``         static site (latest)
- ``POST   /artifacts/{id}/put_url``   admin: presign one file upload
- ``PUT    /artifacts/{id}/upload/{path}?sig=``  upload to the stage
- ``POST   /artifacts/{id}/commit``    admin: finalize staged version
- ``DELETE /artifacts/{id}?version=``  admin: delete
"""

from __future__ import annotations

import mimetypes
import secrets
import time
from typing import TYPE_CHECKING, Optional

from aiohttp import web

from bioengine_tpu_torch.apps.artifacts import ArtifactVersionError, LocalArtifactStore
from bioengine_tpu_torch.utils.logger import create_logger

if TYPE_CHECKING:  # pragma: no cover
    from bioengine_tpu_torch.rpc.server import RpcServer

UPLOAD_GRANT_TTL = 600.0
STAGE_TTL = 3600.0                      # abandoned uploads are dropped
STAGE_MAX_BYTES = 1 << 30               # total in-RAM staging budget


def _check_rel_path(path: str) -> str:
    """Reject traversal in a client-supplied artifact-relative path —
    aiohttp delivers dot segments verbatim when the client sends them
    raw, so every read AND write route must check."""
    if not path or path.startswith("/") or ".." in path.split("/"):
        raise ValueError(f"bad artifact path '{path}'")
    return path


class ArtifactHttpService:
    def __init__(
        self,
        store: LocalArtifactStore,
        rpc_server: "RpcServer",
        log_file: Optional[str] = None,
    ):
        self.store = store
        self.rpc = rpc_server
        self.logger = create_logger("artifacts.http", log_file=log_file)
        # sig -> (artifact_id, path, expires_at)
        self._grants: dict[str, tuple[str, str, float]] = {}
        # artifact_id -> {path: bytes} staged since the last commit
        self._staged: dict[str, dict[str, bytes]] = {}
        self._stage_touched: dict[str, float] = {}

    def _gc(self) -> None:
        """Drop expired grants and abandoned stages — a client that
        presigns or uploads and never commits must not pin worker RAM
        forever."""
        now = time.time()
        for sig in [s for s, g in self._grants.items() if now > g[2]]:
            del self._grants[sig]
        for aid in [
            a
            for a, t in self._stage_touched.items()
            if now - t > STAGE_TTL
        ]:
            self._staged.pop(aid, None)
            del self._stage_touched[aid]

    def _staged_bytes(self) -> int:
        return sum(
            len(b) for files in self._staged.values() for b in files.values()
        )

    # ---- auth ---------------------------------------------------------------

    def _require_admin(self, request: web.Request) -> None:
        auth = request.headers.get("Authorization", "")
        token = auth[len("Bearer "):] if auth.startswith("Bearer ") else (
            request.query.get("token", "")
        )
        info = self.rpc.validate_token(token)  # raises PermissionError
        if not info.is_admin:
            raise PermissionError("artifact writes require an admin token")

    # ---- dispatch -----------------------------------------------------------

    async def handle(self, request: web.Request) -> web.Response:
        """Route ``/artifacts...`` requests (mounted as a catch-all on
        the RPC server's HTTP app)."""
        parts = [p for p in request.path.split("/") if p][1:]  # drop 'artifacts'
        try:
            return await self._route(request, parts)
        except PermissionError as e:
            return web.json_response({"error": str(e)}, status=401)
        except ArtifactVersionError as e:
            return web.json_response({"error": str(e)}, status=409)
        except (KeyError, FileNotFoundError) as e:
            return web.json_response({"error": str(e)}, status=404)
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)

    async def _route(
        self, request: web.Request, parts: list[str]
    ) -> web.Response:
        method = request.method
        if not parts:
            return web.json_response(self.store.list_artifacts())
        aid = parts[0]
        rest = parts[1:]
        version = request.query.get("version") or None

        if method == "GET":
            if not rest:
                return web.json_response(
                    {
                        "artifact_id": aid,
                        "versions": self.store.versions(aid),
                        "latest": self.store.latest_version(aid),
                    }
                )
            if rest == ["manifest"]:
                data = self.store.get_file(aid, "manifest.yaml", version)
                return web.Response(body=data, content_type="text/yaml")
            if rest == ["files"]:
                return web.json_response(self.store.list_files(aid, version))
            if rest[0] == "files":
                path = _check_rel_path("/".join(rest[1:]))
                return self._file_response(aid, path, version)
            if rest[0] == "view":
                path = _check_rel_path("/".join(rest[1:]) or "index.html")
                return self._file_response(aid, path, None, inline=True)
        elif method == "POST" and rest == ["put_url"]:
            self._require_admin(request)
            self._gc()
            body = await request.json()
            path = _check_rel_path(body.get("path", ""))
            sig = secrets.token_urlsafe(24)
            self._grants[sig] = (aid, path, time.time() + UPLOAD_GRANT_TTL)
            return web.json_response(
                {"url": f"/artifacts/{aid}/upload/{path}?sig={sig}"}
            )
        elif method == "PUT" and rest and rest[0] == "upload":
            path = "/".join(rest[1:])
            sig = request.query.get("sig", "")
            grant = self._grants.get(sig)
            if (
                grant is None
                or grant[0] != aid
                or grant[1] != path
                or time.time() > grant[2]
            ):
                raise PermissionError("invalid or expired upload signature")
            del self._grants[sig]
            data = await request.read()
            if self._staged_bytes() + len(data) > STAGE_MAX_BYTES:
                raise ValueError(
                    "staging area full — commit or abandon pending uploads"
                )
            self._staged.setdefault(aid, {})[path] = data
            self._stage_touched[aid] = time.time()
            return web.json_response({"staged": path})
        elif method == "POST" and rest == ["commit"]:
            self._require_admin(request)
            body = await request.json() if request.can_read_body else {}
            staged = self._staged.pop(aid, None)
            self._stage_touched.pop(aid, None)
            if not staged:
                raise ValueError(f"nothing staged for '{aid}'")
            try:
                artifact_id, committed = self.store.put_files(
                    staged, artifact_id=aid, version=body.get("version")
                )
            except Exception:
                # commit failed: keep the stage for a retry
                self._staged[aid] = staged
                self._stage_touched[aid] = time.time()
                raise
            self.logger.info(
                f"committed {artifact_id}@{committed} ({len(staged)} files)"
            )
            return web.json_response(
                {"artifact_id": artifact_id, "version": committed}
            )
        elif method == "DELETE" and not rest:
            self._require_admin(request)
            self.store.delete(aid, version)
            return web.json_response({"deleted": aid, "version": version})
        raise KeyError(f"no artifact route {method} {request.path}")

    def _file_response(
        self,
        aid: str,
        path: str,
        version: Optional[str],
        inline: bool = False,
    ) -> web.Response:
        data = self.store.get_file(aid, path, version)
        ctype = None
        if inline:
            ctype = mimetypes.guess_type(path)[0] or "application/octet-stream"
        return web.Response(
            body=data, content_type=ctype or "application/octet-stream"
        )

    @staticmethod
    def view_url(base_url: str, artifact_id: str) -> str:
        """Public static-site URL for an artifact (the analog of ref
        utils/artifact_utils.py:612-628)."""
        return f"{base_url}/artifacts/{artifact_id}/view/"


class RemoteArtifactStore:
    """Client for an ArtifactHttpService — same interface as
    LocalArtifactStore, so AppBuilder/AppsManager can stage and deploy
    from a remote controller's artifact manager."""

    def __init__(self, base_url: str, token: Optional[str] = None):
        import httpx

        self.base_url = base_url.rstrip("/")
        self.token = token
        self._http = httpx.Client(base_url=self.base_url, timeout=30.0)

    def _headers(self) -> dict:
        return {"Authorization": f"Bearer {self.token}"} if self.token else {}

    def _get(self, path: str, **params):
        r = self._http.get(path, params={k: v for k, v in params.items() if v})
        if r.status_code == 404:
            raise KeyError(r.json().get("error", path))
        r.raise_for_status()
        return r

    # ---- read (LocalArtifactStore interface) --------------------------------

    def list_artifacts(self) -> list[str]:
        return self._get("/artifacts").json()

    def versions(self, artifact_id: str) -> list[str]:
        return self._get(f"/artifacts/{artifact_id}").json()["versions"]

    def latest_version(self, artifact_id: str) -> str:
        return self._get(f"/artifacts/{artifact_id}").json()["latest"]

    def get_manifest(self, artifact_id: str, version: Optional[str] = None):
        import yaml

        from bioengine_tpu_torch.apps.manifest import validate_manifest

        text = self._get(
            f"/artifacts/{artifact_id}/manifest", version=version
        ).text
        return validate_manifest(yaml.safe_load(text))

    def get_file(
        self, artifact_id: str, path: str, version: Optional[str] = None
    ) -> bytes:
        return self._get(
            f"/artifacts/{artifact_id}/files/{path}", version=version
        ).content

    def list_files(
        self, artifact_id: str, version: Optional[str] = None
    ) -> list[str]:
        return self._get(
            f"/artifacts/{artifact_id}/files", version=version
        ).json()

    # ---- write: presigned-PUT flow ------------------------------------------

    def put_files(
        self,
        files: dict[str, bytes | str],
        artifact_id: Optional[str] = None,
        version: Optional[str] = None,
    ) -> tuple[str, str]:
        """Presign + upload each file, then commit (the reference's
        put_file -> httpx PUT -> commit flow, ref
        utils/artifact_utils.py:481-548, 600-608)."""
        import yaml

        if artifact_id is None:
            manifest_src = files.get("manifest.yaml")
            if manifest_src is None:
                raise ValueError("upload needs manifest.yaml or artifact_id")
            if isinstance(manifest_src, bytes):
                manifest_src = manifest_src.decode()
            artifact_id = yaml.safe_load(manifest_src)["id"]
        for rel, content in files.items():
            r = self._http.post(
                f"/artifacts/{artifact_id}/put_url",
                json={"path": rel},
                headers=self._headers(),
            )
            r.raise_for_status()
            url = r.json()["url"]
            if isinstance(content, str):
                content = content.encode()
            up = self._http.put(url, content=content)
            up.raise_for_status()
        r = self._http.post(
            f"/artifacts/{artifact_id}/commit",
            json={"version": version},
            headers=self._headers(),
        )
        if r.status_code == 409:
            raise ArtifactVersionError(r.json().get("error", "version conflict"))
        r.raise_for_status()
        data = r.json()
        return data["artifact_id"], data["version"]

    def put(
        self,
        src_dir,
        artifact_id: Optional[str] = None,
        version: Optional[str] = None,
    ) -> tuple[str, str]:
        from pathlib import Path

        src = Path(src_dir)
        files = {
            str(p.relative_to(src)): p.read_bytes()
            for p in src.rglob("*")
            if p.is_file()
        }
        return self.put_files(files, artifact_id, version)

    def delete(self, artifact_id: str, version: Optional[str] = None) -> None:
        r = self._http.delete(
            f"/artifacts/{artifact_id}",
            params={"version": version} if version else {},
            headers=self._headers(),
        )
        if r.status_code == 404:
            raise KeyError(artifact_id)
        r.raise_for_status()

    def view_url(self, artifact_id: str) -> str:
        return ArtifactHttpService.view_url(self.base_url, artifact_id)

    def close(self) -> None:
        self._http.close()
