"""Client for the datasets server, injected into app deployments.

Capability parity with ref bioengine/datasets/datasets.py:11-462
(auto-discovery via a well-known file, ping/list_datasets/list_files/
get_file where ``.zarr`` paths yield lazy zarr handles and other files
yield bytes, plus save/list/get of user files).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

import httpx

from bioengine_tpu_torch.datasets.http_zarr_store import (
    HttpZarrStore,
    RemoteZarrArray,
    RemoteZarrGroup,
)
from bioengine_tpu_torch.datasets.net import get_url_with_retry
from bioengine_tpu_torch.datasets.proxy_server import DISCOVERY_FILE
from bioengine_tpu_torch.utils.logger import create_logger


class BioEngineDatasets:
    """Async client bound to one datasets server."""

    def __init__(
        self,
        server_url: Optional[str] = None,
        token: Optional[str] = None,
        log_file: Optional[str] = "off",
    ):
        self.server_url = (server_url or self._discover() or "").rstrip("/")
        self.token = token or os.environ.get("BIOENGINE_TPU_DATA_TOKEN")
        self.logger = create_logger("datasets.client", log_file=log_file)
        self._client: Optional[httpx.AsyncClient] = None

    @staticmethod
    def _discover() -> Optional[str]:
        """Server discovery: env var, then the well-known discovery file
        (ref datasets/datasets.py:85-97)."""
        env = os.environ.get("BIOENGINE_TPU_DATA_SERVER")
        if env:
            return env
        if DISCOVERY_FILE.is_file():
            try:
                return DISCOVERY_FILE.read_text().strip() or None
            except OSError:
                return None
        return None

    @property
    def available(self) -> bool:
        return bool(self.server_url)

    def _headers(self) -> dict:
        return {"Authorization": f"Bearer {self.token}"} if self.token else {}

    def _get_client(self) -> httpx.AsyncClient:
        if self._client is None or self._client.is_closed:
            self._client = httpx.AsyncClient(
                timeout=httpx.Timeout(60.0), headers=self._headers()
            )
        return self._client

    async def aclose(self) -> None:
        if self._client is not None:
            await self._client.aclose()

    # -- API ------------------------------------------------------------------

    async def ping(self) -> bool:
        if not self.available:
            return False
        try:
            resp = await self._get_client().get(f"{self.server_url}/ping")
            return resp.status_code == 200
        except httpx.HTTPError:
            return False

    async def list_datasets(self) -> list[dict]:
        resp = await get_url_with_retry(
            f"{self.server_url}/datasets", client=self._get_client()
        )
        return resp.json()

    async def list_files(self, dataset: str, path: str = "") -> list[dict]:
        resp = await get_url_with_retry(
            f"{self.server_url}/datasets/{dataset}/files",
            params={"path": path} if path else None,
            client=self._get_client(),
        )
        return resp.json()

    async def get_file(
        self, dataset: str, file_path: str
    ) -> Union[RemoteZarrArray, RemoteZarrGroup, bytes]:
        """``.zarr`` paths -> lazy zarr handle; other paths -> raw bytes
        (ref datasets/datasets.py:240-335)."""
        names = {f["name"] for f in await self.list_files(dataset)}
        head = file_path.split("/", 1)[0]
        if head not in names:
            raise FileNotFoundError(
                f"'{file_path}' not found in dataset '{dataset}' "
                f"(available: {sorted(names)})"
            )
        if file_path.endswith(".zarr") or ".zarr/" in file_path:
            store = HttpZarrStore(
                f"{self.server_url}/data/{dataset}/{file_path.rstrip('/')}",
                token=self.token,
            )
            # array at the root? otherwise hand back a group
            try:
                return await RemoteZarrArray.open(store)
            except FileNotFoundError:
                members = [
                    f["name"]
                    for f in await self.list_files(dataset, path=file_path)
                    if f["type"] == "directory"
                ]
                return RemoteZarrGroup(store, member_paths=members)
        resp = await get_url_with_retry(
            f"{self.server_url}/data/{dataset}/{file_path}",
            client=self._get_client(),
        )
        return resp.content

    # -- user files (ref datasets/datasets.py:337-462) ------------------------

    async def save_file(
        self, path: str, data: bytes, scope: str = "private"
    ) -> dict:
        resp = await self._get_client().put(
            f"{self.server_url}/saved/{scope}/{path}", content=data
        )
        resp.raise_for_status()
        return resp.json()

    async def list_saved(self, scope: str = "private") -> list[dict]:
        resp = await get_url_with_retry(
            f"{self.server_url}/saved/{scope}", client=self._get_client()
        )
        return resp.json()

    async def get_saved(self, path: str, scope: str = "private") -> bytes:
        resp = await get_url_with_retry(
            f"{self.server_url}/saved/{scope}/{path}",
            client=self._get_client(),
        )
        return resp.content
