"""Model-runner entry: model discovery, the package cache and inference dispatch.

Counterpart of ``apps/model-runner/entry_deployment.py``:

- ``LocalCollectionSource``: models laid out as ``root/<model_id>/rdf.yaml``
  plus files, with ``bioengine_inference`` check results in an optional
  ``root/collection.yaml``; ``EntryDeployment`` reads the root from
  ``BIOENGINE_LOCAL_MODEL_PATH``.
- ``HttpCollectionSource``: the bioimage.io artifact endpoints under
  ``collection_url`` (the default source without a local root): the
  artifact manager's ``list`` and ``read`` (the ``bioengine_inference``
  checks, cached for ``CHECKS_TTL_SECONDS``) and
  ``{server}/bioimage-io/artifacts/{id}/files/{path}``, each GET tried up
  to 4 times with a doubling back-off on a transport error, a 5xx or a 429.
- ``ModelPackage`` / ``ModelCache``: the cross-replica download protocol
  (an exclusive-create ``.downloading`` marker that goes stale after
  ``STALE_DOWNLOAD_SECONDS``, a temp dir renamed into place),
  ``.last_access`` files driving LRU eviction under a byte budget, and
  in-use refcounts mirrored to ``.inuse-*`` markers that block eviction.
  A URL is refused as a model id.
- ``EntryDeployment``: ``search_models``, ``get_model_rdf``,
  ``get_model_documentation``, ``validate``, ``test``, ``infer``,
  ``get_upload_url``, ``upload_image`` and ``list_cached_models``, each a
  ``@schema_method``. Under the app builder ``runtime_deployment`` is the
  sibling deployment's ``DeploymentHandle`` (its methods are routed
  calls); built alone, the entry builds its own ``RuntimeDeployment``.

RDFs and ``collection.yaml`` are read with ``runtime.rdf.parse_rdf_text``
(PyYAML where it imports, else JSON). An ``http(s)://`` input to ``infer``
is fetched with httpx. Entry points run on ``cuda`` unless given
``device="cpu"``.
"""

from __future__ import annotations

import asyncio
import io
import json
import os
import shutil
import time
import uuid
from pathlib import Path
from typing import Optional

import numpy as np

from bioengine_tpu_torch.apps.model_runner.runtime import RuntimeDeployment
from bioengine_tpu_torch.rpc import schema_method
from bioengine_tpu_torch.runtime.devices import DeviceLike
from bioengine_tpu_torch.runtime.rdf import parse_rdf_text

STALE_DOWNLOAD_SECONDS = 600
SUPPORTED_FILE_TYPES = (".npy", ".png", ".tiff", ".tif", ".jpeg", ".jpg")


def _read_yaml(path: Path) -> dict:
    return parse_rdf_text(path.read_text(), str(path)) or {}


# ---- model sources ----------------------------------------------------------


class LocalCollectionSource:
    """Models laid out as ``root/<model_id>/rdf.yaml`` + files; an optional
    ``root/collection.yaml`` carries ``bioengine_inference`` check results."""

    def __init__(self, root: str | Path):
        self.root = Path(root)

    async def list_models(self) -> list[dict]:
        models = []
        for d in sorted(self.root.iterdir()):
            if (d / "rdf.yaml").exists():
                rdf = _read_yaml(d / "rdf.yaml")
                models.append(
                    {
                        "model_id": d.name,
                        "description": rdf.get("description", ""),
                        "tags": rdf.get("tags", []),
                        "name": rdf.get("name", d.name),
                    }
                )
        return models

    async def inference_checks(self) -> dict:
        cpath = self.root / "collection.yaml"
        if cpath.exists():
            return _read_yaml(cpath).get("bioengine_inference", {})
        return {}

    async def fetch_file_list(self, model_id: str, stage: bool) -> list[dict]:
        d = self.root / model_id
        if not (d / "rdf.yaml").exists():
            raise FileNotFoundError(f"model '{model_id}' not in collection")
        return [
            {"name": str(p.relative_to(d)), "size": p.stat().st_size}
            for p in sorted(d.rglob("*"))
            if p.is_file() and not p.name.startswith(".")
        ]

    async def fetch_file(self, model_id: str, name: str, stage: bool) -> bytes:
        return await asyncio.to_thread((self.root / model_id / name).read_bytes)

    async def is_published(self, model_id: str) -> bool:
        checks = await self.inference_checks()
        if model_id in checks:
            return checks[model_id].get("status") == "passed"
        return (self.root / model_id / "rdf.yaml").exists()


class HttpCollectionSource:
    """bioimage.io artifact endpoints: list via the artifact manager,
    files via ``{server}/bioimage-io/artifacts/{id}/files/{path}``."""

    CHECKS_TTL_SECONDS = 60

    def __init__(self, server_url: str = "https://hypha.aicell.io"):
        self.server_url = server_url.rstrip("/")
        import httpx

        self._client = httpx.AsyncClient(timeout=60, follow_redirects=True)
        self._checks_cache: tuple[float, dict] | None = None

    async def _get(self, url: str, **kw):
        last = None
        for attempt in range(4):
            try:
                r = await self._client.get(url, **kw)
                if r.status_code < 400 or (400 <= r.status_code < 500 and r.status_code != 429):
                    return r
                last = RuntimeError(f"HTTP {r.status_code} for {url}")
            except Exception as e:
                last = e
            await asyncio.sleep(0.2 * 2**attempt)
        raise last

    async def list_models(self) -> list[dict]:
        url = f"{self.server_url}/public/services/artifact-manager/list"
        r = await self._get(
            url,
            params={
                "parent_id": "bioimage-io/bioimage.io",
                "filters": json.dumps({"type": "model"}),
                "limit": 1000,
            },
        )
        r.raise_for_status()
        return [
            {
                "model_id": a["alias"],
                "description": a.get("manifest", {}).get("description", ""),
                "tags": a.get("manifest", {}).get("tags", []),
                "name": a.get("manifest", {}).get("name", a["alias"]),
            }
            for a in r.json()
        ]

    async def inference_checks(self) -> dict:
        # TTL-cached: is_published runs on every infer() and must not add a
        # collection round-trip to the inference hot path
        if self._checks_cache and time.time() - self._checks_cache[0] < self.CHECKS_TTL_SECONDS:
            return self._checks_cache[1]
        url = f"{self.server_url}/public/services/artifact-manager/read"
        r = await self._get(url, params={"artifact_id": "bioimage-io/bioimage.io"})
        r.raise_for_status()
        checks = r.json().get("manifest", {}).get("bioengine_inference", {})
        self._checks_cache = (time.time(), checks)
        return checks

    async def fetch_file_list(self, model_id: str, stage: bool) -> list[dict]:
        url = f"{self.server_url}/bioimage-io/artifacts/{model_id}/files/"
        r = await self._get(url, params={"stage": str(stage).lower()})
        r.raise_for_status()
        return [
            {"name": f["name"], "size": f.get("size", 0)}
            for f in r.json()
            if f.get("type") != "directory"
        ]

    async def fetch_file(self, model_id: str, name: str, stage: bool) -> bytes:
        url = f"{self.server_url}/bioimage-io/artifacts/{model_id}/files/{name}"
        r = await self._get(url, params={"stage": str(stage).lower()})
        r.raise_for_status()
        return r.content

    async def is_published(self, model_id: str) -> bool:
        checks = await self.inference_checks()
        return checks.get(model_id, {}).get("status") == "passed"

    async def close(self) -> None:
        await self._client.aclose()


# ---- model cache ------------------------------------------------------------


class ModelPackage:
    """In-use guard: holding it blocks LRU eviction during inference. The
    refcount is mirrored to an on-disk ``.inuse-*`` marker so eviction is
    safe across replicas sharing one cache dir."""

    def __init__(self, cache: "ModelCache", model_id: str, path: Path):
        self.cache = cache
        self.model_id = model_id
        self.path = path
        self._marker = cache.cache_dir / f".inuse-{model_id}-{os.getpid()}-{id(self):x}"

    async def __aenter__(self):
        self.cache._in_use[self.model_id] = self.cache._in_use.get(self.model_id, 0) + 1
        self._marker.write_text(self.model_id)
        return self

    async def __aexit__(self, *exc):
        self.cache._in_use[self.model_id] -= 1
        if self.cache._in_use[self.model_id] <= 0:
            del self.cache._in_use[self.model_id]
        self._marker.unlink(missing_ok=True)


class ModelCache:
    def __init__(self, cache_dir: str | Path, source, max_size_bytes: int = 20 * 1024**3):
        self.cache_dir = Path(cache_dir).expanduser()
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.source = source
        self.max_size_bytes = max_size_bytes
        self._in_use: dict[str, int] = {}

    def _package_dir(self, model_id: str, stage: bool) -> Path:
        return self.cache_dir / (f"{model_id}-staged" if stage else model_id)

    def _marker(self, model_id: str, stage: bool) -> Path:
        return self.cache_dir / f".downloading-{model_id}{'-staged' if stage else ''}"

    @staticmethod
    def _touch_access(package: Path) -> None:
        (package / ".last_access").write_text(str(time.time()))

    async def get_model_package(
        self,
        model_id: str,
        stage: bool = False,
        allow_unpublished: bool = False,
        skip_cache: bool = False,
    ) -> ModelPackage:
        if "/" in model_id or model_id.startswith("http"):
            raise ValueError(f"'{model_id}' is not a model id (URLs are not accepted)")
        if not allow_unpublished and not await self.source.is_published(model_id):
            raise ValueError(
                f"model '{model_id}' has not passed the bioengine inference "
                f"check; pass allow_unpublished=True to force"
            )
        package = self._package_dir(model_id, stage)
        if skip_cache and package.exists():
            if self._in_use.get(model_id):
                raise RuntimeError(f"cannot re-download '{model_id}' while it is in use")
            # rename first (sync, atomic) so no coroutine can adopt a
            # half-deleted package; the dot keeps it out of listings
            doomed = package.with_name(f".purge-{package.name}-{os.getpid()}")
            package.rename(doomed)
            await asyncio.to_thread(shutil.rmtree, doomed)
        if not package.exists():
            await self._download(model_id, stage, package)
        self._touch_access(package)
        return ModelPackage(self, model_id, package)

    async def _download(self, model_id: str, stage: bool, package: Path):
        """The first claimant creates the marker with O_EXCL and downloads
        into a temp dir renamed into place; others poll for completion. A
        marker older than ``STALE_DOWNLOAD_SECONDS`` is a dead claimant's
        and is taken over."""
        marker = self._marker(model_id, stage)
        while True:
            try:
                fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                break  # we own the download
            except FileExistsError:
                try:
                    age = time.time() - marker.stat().st_mtime
                except FileNotFoundError:
                    continue  # the owner just finished; contend again
                if age > STALE_DOWNLOAD_SECONDS:
                    marker.unlink(missing_ok=True)
                    continue
                await asyncio.sleep(0.25)
                if package.exists():
                    return  # a sibling finished it
        if package.exists():
            marker.unlink(missing_ok=True)
            return
        tmp = self.cache_dir / f".tmp-{model_id}-{os.getpid()}"
        try:
            files = await self.source.fetch_file_list(model_id, stage)
            await self._ensure_space(sum(f.get("size", 0) for f in files))
            if tmp.exists():
                await asyncio.to_thread(shutil.rmtree, tmp)
            tmp.mkdir(parents=True)
            for f in files:
                data = await self.source.fetch_file(model_id, f["name"], stage)
                dest = tmp / f["name"]
                dest.parent.mkdir(parents=True, exist_ok=True)
                await asyncio.to_thread(dest.write_bytes, data)
            tmp.rename(package)
        except BaseException:
            # cleanup must stay synchronous: awaiting inside a handler
            # that may hold a CancelledError would get re-cancelled and
            # leak the temp dir
            # bioengine: ignore[BE-ASYNC-001]
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        finally:
            marker.unlink(missing_ok=True)

    async def _ensure_space(self, incoming_bytes: int):
        """Evict least-recently-accessed packages not in use until the
        incoming model fits the budget. If every remaining package is in
        use the cache overflows for now rather than failing the download."""
        packages = [p for p in self.cache_dir.iterdir() if p.is_dir() and not p.name.startswith(".")]

        def size(p: Path) -> int:
            return sum(f.stat().st_size for f in p.rglob("*") if f.is_file())

        def last_access(p: Path) -> float:
            try:
                return float((p / ".last_access").read_text())
            except (OSError, ValueError):
                return 0.0

        used = {p: size(p) for p in packages}
        budget = self.max_size_bytes - incoming_bytes
        current = sum(used.values())
        # other replicas' in-use markers; a crashed replica's go stale
        disk_in_use = set()
        for m in self.cache_dir.glob(".inuse-*"):
            try:
                if time.time() - m.stat().st_mtime < STALE_DOWNLOAD_SECONDS:
                    disk_in_use.add(m.read_text().strip())
            except OSError:
                continue
        for p in sorted(packages, key=last_access):
            if current <= budget:
                break
            model_id = p.name.removesuffix("-staged")
            if self._in_use.get(model_id) or model_id in disk_in_use:
                continue
            # sync rename, threaded delete: nothing adopts a half-deleted
            # package during the await
            doomed = p.with_name(f".evict-{p.name}-{os.getpid()}")
            p.rename(doomed)
            await asyncio.to_thread(shutil.rmtree, doomed)
            current -= used[p]

    async def cached_models(self) -> list[dict]:
        out = []
        for p in sorted(self.cache_dir.iterdir()):
            if p.is_dir() and not p.name.startswith("."):
                la = p / ".last_access"
                out.append(
                    {
                        "model_id": p.name,
                        "size_bytes": sum(f.stat().st_size for f in p.rglob("*") if f.is_file()),
                        "last_access": float(la.read_text()) if la.exists() else 0.0,
                        "in_use": bool(self._in_use.get(p.name.removesuffix("-staged"))),
                    }
                )
        return out


# ---- entry deployment -------------------------------------------------------


class EntryDeployment:
    """The model-runner's front: discovery, cache, test and infer, over a
    ``RuntimeDeployment`` or its deployment handle (a runtime is built on
    ``device`` unless one is given)."""

    def __init__(
        self,
        runtime_deployment: Optional[RuntimeDeployment] = None,
        collection_url: str = "https://hypha.aicell.io",
        cache_dir: str = "~/.bioengine/model-cache",
        max_cache_size_gb: float = 20.0,
        device: DeviceLike = None,
    ):
        # a runtime this entry built is its own to close; a given one (the
        # builder's handle to the runtime deployment) belongs to its owner
        self._owns_runtime = runtime_deployment is None
        self.runtime_deployment = (
            RuntimeDeployment(device=device) if self._owns_runtime else runtime_deployment
        )
        local_root = os.environ.get("BIOENGINE_LOCAL_MODEL_PATH")
        if local_root:
            source = LocalCollectionSource(local_root)
        else:
            source = HttpCollectionSource(collection_url)
        self.model_cache = ModelCache(
            cache_dir=cache_dir, source=source, max_size_bytes=int(max_cache_size_gb * 1024**3),
        )
        # dot-prefixed so the cache's LRU eviction never touches uploads
        self._uploads_dir = Path(cache_dir).expanduser() / ".uploads"
        self._uploads_dir.mkdir(parents=True, exist_ok=True)

    async def async_init(self):
        await self._check_runtime_available()

    async def test_deployment(self):
        models = await self.model_cache.source.list_models()
        assert isinstance(models, list)

    async def check_health(self):
        await self._check_runtime_available()

    async def _check_runtime_available(self):
        status = await asyncio.wait_for(self.runtime_deployment.get_status(), timeout=10)
        if not status.get("device_count"):
            raise RuntimeError("runtime replica reports no devices")

    async def close(self) -> None:
        if isinstance(self.model_cache.source, HttpCollectionSource):
            await self.model_cache.source.close()
        if self._owns_runtime:
            await self.runtime_deployment.close()

    # ---- discovery ----------------------------------------------------------

    @schema_method
    async def search_models(
        self, keywords: list | None = None, limit: int = 10, ignore_checks: bool = False, context=None
    ):
        """Search the model collection; by default only models that passed
        the bioengine inference check are returned."""
        models = await self.model_cache.source.list_models()
        if not ignore_checks:
            checks = await self.model_cache.source.inference_checks()
            if checks:
                passed = {mid for mid, r in checks.items() if r.get("status") == "passed"}
                models = [m for m in models if m["model_id"] in passed]
        if keywords:
            kws = [k.lower() for k in keywords]
            models = [
                m
                for m in models
                if any(
                    k in m["model_id"].lower()
                    or k in m["description"].lower()
                    or k in m["name"].lower()
                    or any(k in str(t).lower() for t in m.get("tags", []))
                    for k in kws
                )
            ]
        return [
            {"model_id": m["model_id"], "description": m["description"]}
            for m in models[: limit or 10]
        ]

    @schema_method
    async def get_model_rdf(self, model_id: str, stage: bool = False, context=None):
        """Fetch and parse a model's rdf.yaml."""
        data = await self.model_cache.source.fetch_file(model_id, "rdf.yaml", stage)
        return parse_rdf_text(data.decode(), f"{model_id}/rdf.yaml")

    @schema_method
    async def get_model_documentation(self, model_id: str, stage: bool = False, context=None):
        """The file the RDF's 'documentation' field names, or None when it
        is absent or missing."""
        rdf = await self.get_model_rdf(model_id=model_id, stage=stage)
        doc_path = rdf.get("documentation")
        if not doc_path:
            return None
        try:
            data = await self.model_cache.source.fetch_file(model_id, doc_path, stage)
        except Exception:
            return None
        return data.decode(errors="replace")

    @schema_method
    async def validate(self, rdf_dict: dict, context=None):
        """Format-validate a model RDF (no IO checks): the subset of
        bioimageio.spec's format validation the runtime relies on."""
        problems = []
        for field in ("name", "inputs", "outputs", "weights"):
            if not rdf_dict.get(field):
                problems.append(f"missing required field '{field}'")
        if rdf_dict.get("type") not in (None, "model"):
            problems.append(f"type must be 'model', got '{rdf_dict.get('type')}'")
        for section in ("inputs", "outputs"):
            for i, entry in enumerate(rdf_dict.get(section) or []):
                if not isinstance(entry, dict) or "axes" not in entry:
                    problems.append(f"{section}[{i}] missing 'axes'")
        weights = rdf_dict.get("weights") or {}
        if isinstance(weights, dict):
            for fmt, entry in weights.items():
                if not isinstance(entry, dict) or not entry.get("source"):
                    problems.append(f"weights['{fmt}'] missing 'source'")
        else:
            problems.append("'weights' must be a mapping")
        return {
            "success": not problems,
            "details": "; ".join(problems) if problems else "valid-format",
        }

    # ---- test + infer -------------------------------------------------------

    @schema_method
    async def test(self, model_id: str, stage: bool = False, skip_cache: bool = False, context=None):
        """Fetch (or reuse) the model package and run the runtime's self-test
        on it; reports are cached keyed on weight mtimes."""
        package = await self.model_cache.get_model_package(
            model_id, stage=stage, allow_unpublished=True, skip_cache=skip_cache
        )
        async with package:
            return await self.runtime_deployment.test(rdf_path=str(package.path), skip_cache=skip_cache)

    @schema_method
    async def infer(
        self,
        model_id: str,
        inputs,
        weights_format: str | None = None,
        default_blocksize_parameter: int | None = None,
        sample_id: str = "sample",
        skip_cache: bool = False,
        return_download_url: bool = False,
        context=None,
    ):
        """Run inference on a published model. ``inputs``: an array, a dict
        of arrays, or a file path from ``get_upload_url``."""
        if isinstance(inputs, str):
            inputs = await self._load_image_from_source(inputs)
        elif isinstance(inputs, dict):
            inputs = {
                k: (await self._load_image_from_source(v) if isinstance(v, str) else v)
                for k, v in inputs.items()
            }
        package = await self.model_cache.get_model_package(
            model_id, allow_unpublished=False, skip_cache=skip_cache
        )
        async with package:
            result = await self.runtime_deployment.predict(
                rdf_path=str(package.path),
                inputs=inputs,
                weights_format=weights_format,
                default_blocksize_parameter=default_blocksize_parameter,
                sample_id=sample_id,
            )
        if return_download_url:
            result = {
                k: (await asyncio.to_thread(self._save_temp_array, v) if isinstance(v, np.ndarray) else v)
                for k, v in result.items()
            }
        return result

    # ---- image upload/download ----------------------------------------------

    @schema_method
    async def get_upload_url(self, file_type: str, context=None):
        """Reserve a temporary upload slot: ``upload_path`` on disk and the
        ``file_path`` to pass to ``upload_image`` and ``infer``."""
        if file_type not in SUPPORTED_FILE_TYPES:
            raise ValueError(f"file_type must be one of {SUPPORTED_FILE_TYPES}")
        file_path = f"temp/{uuid.uuid4()}{file_type}"
        dest = self._uploads_dir / file_path
        dest.parent.mkdir(parents=True, exist_ok=True)
        return {"upload_path": str(dest), "file_path": file_path}

    @schema_method
    async def upload_image(self, file_path: str, data: bytes, context=None):
        """Store encoded image bytes under a reserved ``file_path``."""
        dest = (self._uploads_dir / file_path).resolve()
        if not dest.is_relative_to(self._uploads_dir.resolve()):
            raise ValueError("file_path escapes the upload area")
        dest.parent.mkdir(parents=True, exist_ok=True)
        await asyncio.to_thread(dest.write_bytes, bytes(data))
        return {"file_path": file_path, "size": len(data)}

    async def _load_image_from_source(self, source: str) -> np.ndarray:
        """URL / uploaded-file-path -> numpy array."""
        if source.startswith(("http://", "https://")):
            import httpx

            async with httpx.AsyncClient(timeout=60, follow_redirects=True) as client:
                r = await client.get(source)
                r.raise_for_status()
                raw, name = r.content, source
        else:
            path = (self._uploads_dir / source).resolve()
            if not path.is_relative_to(self._uploads_dir.resolve()):
                raise ValueError("file path escapes the upload area")
            if not path.exists():
                raise FileNotFoundError(f"uploaded file '{source}' not found or expired")
            raw, name = await asyncio.to_thread(path.read_bytes), str(path)
        # decoding is CPU and allocation heavy: off the event loop
        return await asyncio.to_thread(self._decode_array, raw, name)

    @staticmethod
    def _decode_array(raw: bytes, name: str) -> np.ndarray:
        lower = name.lower()
        if lower.endswith(".npy"):
            return np.load(io.BytesIO(raw), allow_pickle=False)
        if lower.endswith((".tif", ".tiff")):
            try:
                import tifffile
            except ImportError as e:
                raise RuntimeError("tifffile not available") from e
            return tifffile.imread(io.BytesIO(raw))
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(f"no decoder available for '{name}'") from e
        return np.asarray(Image.open(io.BytesIO(raw)))

    def _save_temp_array(self, array: np.ndarray) -> str:
        file_path = f"temp/{uuid.uuid4()}.npy"
        dest = self._uploads_dir / file_path
        dest.parent.mkdir(parents=True, exist_ok=True)
        np.save(dest, array)
        return file_path

    # ---- cache inspection ---------------------------------------------------

    @schema_method
    async def list_cached_models(self, context=None):
        """Cached packages with size, last access and in-use flags."""
        return await self.model_cache.cached_models()
