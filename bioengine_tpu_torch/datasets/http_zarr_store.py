"""Read-only zarr store over HTTP with shared LRU cache + Range requests.

Capability parity with ref bioengine/datasets/http_zarr_store.py:32-245:
check-cache-then-fetch, byte-range mapping, bounded request concurrency,
pooled async HTTP client, parallel partial reads. Instead of plugging
into the external ``zarr`` package (absent from this image), the store
feeds :class:`RemoteZarrArray` / :class:`RemoteZarrGroup`, our own lazy
readers built on :mod:`bioengine_tpu_torch.datasets.zarr_codec`.
"""

from __future__ import annotations

import asyncio
import os
import weakref
from typing import Any, Optional

import httpx
import numpy as np

from bioengine_tpu_torch.datasets import zarr_codec
from bioengine_tpu_torch.datasets.chunk_cache import ChunkCache, default_cache
from bioengine_tpu_torch.datasets.net import get_url_with_retry
from bioengine_tpu_torch.datasets.zarr_codec import ArrayMeta

MAX_CONCURRENT_REQUESTS = int(
    os.environ.get("BIOENGINE_DATASETS_ZARR_STORE_CONCURRENT_REQUESTS", "50")
)
MAX_CONNECTIONS = int(
    os.environ.get("BIOENGINE_DATASETS_ZARR_STORE_CONNECTIONS", "20")
)


class HttpZarrStore:
    """Fetch zarr keys from ``{base_url}/{key}`` with caching.

    ``base_url`` points at the dataset root served by the proxy server,
    e.g. ``http://host:port/data/my-dataset/images.zarr``.

    A store that makes its own client keeps one client, and one request
    semaphore, per event loop: an array opened on one loop may be read on
    another (``ZarrBatchLoader`` reads on its own thread's), and a pooled
    connection is bound to the loop that opened it. ``aclose`` closes the
    calling loop's client. A client passed in is used as it is.
    """

    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        cache: Optional[ChunkCache] = None,
        client: Optional[httpx.AsyncClient] = None,
        max_concurrent: int = MAX_CONCURRENT_REQUESTS,
    ):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.cache = cache if cache is not None else default_cache
        self._max_concurrent = max_concurrent
        self._client = client
        self._owns_client = client is None
        # per event loop: the store's own clients and the request semaphores
        self._clients: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        self._semaphores: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    @property
    def _semaphore(self) -> asyncio.Semaphore:
        loop = asyncio.get_running_loop()
        sem = self._semaphores.get(loop)
        if sem is None:
            sem = self._semaphores[loop] = asyncio.Semaphore(self._max_concurrent)
        return sem

    def _get_client(self) -> httpx.AsyncClient:
        if not self._owns_client:
            return self._client
        loop = asyncio.get_running_loop()
        client = self._clients.get(loop)
        if client is None or client.is_closed:
            client = self._clients[loop] = httpx.AsyncClient(
                timeout=httpx.Timeout(60.0),
                limits=httpx.Limits(
                    max_connections=MAX_CONNECTIONS,
                    max_keepalive_connections=MAX_CONNECTIONS,
                ),
                headers=(
                    {"Authorization": f"Bearer {self.token}"}
                    if self.token
                    else {}
                ),
            )
        return client

    async def aclose(self) -> None:
        if self._owns_client:
            client = self._clients.pop(asyncio.get_running_loop(), None)
            if client is not None:
                await client.aclose()

    def _url(self, key: str) -> str:
        return f"{self.base_url}/{key.lstrip('/')}"

    def _cache_key(self, key: str, byte_range: Optional[tuple[int, int]]) -> str:
        if byte_range is None:
            return self._url(key)
        return f"{self._url(key)}#{byte_range[0]}-{byte_range[1]}"

    async def get(
        self, key: str, byte_range: Optional[tuple[int, int]] = None
    ) -> Optional[bytes]:
        """Fetch a key; ``byte_range=(start, end_exclusive)``. None on 404."""
        ck = self._cache_key(key, byte_range)
        cached = await self.cache.get(ck)
        if cached is not None:
            return cached
        headers = {}
        if byte_range is not None:
            headers["Range"] = f"bytes={byte_range[0]}-{byte_range[1] - 1}"
        async with self._semaphore:
            # retry transient failures — one 503 among a 50-way chunk
            # gather must not fail a whole array read
            try:
                resp = await get_url_with_retry(
                    self._url(key), headers=headers, client=self._get_client()
                )
            except httpx.HTTPStatusError as e:
                if e.response.status_code == 404:
                    return None
                raise
        data = resp.content
        await self.cache.put(ck, data)
        return data

    async def get_partial_values(
        self, requests: list[tuple[str, Optional[tuple[int, int]]]]
    ) -> list[Optional[bytes]]:
        return list(
            await asyncio.gather(*(self.get(k, r) for k, r in requests))
        )

    async def exists(self, key: str) -> bool:
        ck = self._cache_key(key, None)
        if await self.cache.get(ck) is not None:
            return True
        async with self._semaphore:
            resp = await self._get_client().head(self._url(key))
        return resp.status_code == 200


class RemoteZarrArray:
    """Lazy ndarray view over one zarr array behind an HttpZarrStore."""

    def __init__(self, store: HttpZarrStore, path: str, meta: ArrayMeta):
        self.store = store
        self.path = path.strip("/")
        self.meta = meta

    # -- construction ---------------------------------------------------------

    @classmethod
    async def open(cls, store: HttpZarrStore, path: str = "") -> "RemoteZarrArray":
        path = path.strip("/")
        prefix = f"{path}/" if path else ""
        doc = await store.get(f"{prefix}{zarr_codec.V3_DOC}")
        if doc is None:
            doc = await store.get(f"{prefix}{zarr_codec.V2_ARRAY_DOC}")
        if doc is None:
            raise FileNotFoundError(
                f"No zarr array metadata under '{store.base_url}/{path}'"
            )
        meta = zarr_codec.parse_array_meta(doc, name_hint=path)
        return cls(store, path, meta)

    # -- metadata -------------------------------------------------------------

    @property
    def shape(self) -> tuple[int, ...]:
        return self.meta.shape

    @property
    def chunks(self) -> tuple[int, ...]:
        return self.meta.chunks

    @property
    def dtype(self) -> np.dtype:
        return self.meta.dtype

    @property
    def ndim(self) -> int:
        return len(self.meta.shape)

    def __repr__(self) -> str:
        return (
            f"RemoteZarrArray(path='{self.path}', shape={self.shape}, "
            f"chunks={self.chunks}, dtype={self.dtype})"
        )

    # -- reads ----------------------------------------------------------------

    def _full_key(self, idx: tuple[int, ...]) -> str:
        rel = self.meta.chunk_key(idx)
        return f"{self.path}/{rel}" if self.path else rel

    async def read(
        self, selection: Optional[tuple[slice, ...]] = None
    ) -> np.ndarray:
        """Read a slice selection (whole array by default) into numpy."""
        sel = selection or tuple(slice(0, s) for s in self.shape)
        if len(sel) != self.ndim:
            sel = tuple(sel) + tuple(
                slice(0, s) for s in self.shape[len(sel):]
            )
        indices = zarr_codec.chunks_for_selection(self.meta, sel)
        raws = await asyncio.gather(
            *(self.store.get(self._full_key(idx)) for idx in indices)
        )
        # decode off the loop: blosc/gzip decompression is CPU-bound
        # (and the first crc32c call may build the native lib) — on the
        # loop it would stall every concurrent chunk fetch
        chunks = dict(
            zip(
                indices,
                await asyncio.gather(
                    *(
                        asyncio.to_thread(
                            zarr_codec.decode_chunk, self.meta, raw
                        )
                        for raw in raws
                    )
                ),
            )
        )
        return zarr_codec.assemble(self.meta, chunks, sel)

    async def read_chunk(self, idx: tuple[int, ...]) -> np.ndarray:
        raw = await self.store.get(self._full_key(idx))
        return await asyncio.to_thread(
            zarr_codec.decode_chunk, self.meta, raw
        )


class RemoteZarrGroup:
    """Lazy group: discovers member arrays via the server's file listing
    or by probing conventional member names."""

    def __init__(
        self,
        store: HttpZarrStore,
        member_paths: Optional[list[str]] = None,
        attributes: Optional[dict] = None,
    ):
        self.store = store
        self._member_paths = member_paths
        self.attributes = dict(attributes or {})
        self._arrays: dict[str, RemoteZarrArray] = {}

    async def array(self, name: str) -> RemoteZarrArray:
        if name not in self._arrays:
            self._arrays[name] = await RemoteZarrArray.open(self.store, name)
        return self._arrays[name]

    async def members(self) -> list[str]:
        if self._member_paths is not None:
            return self._member_paths
        raise RuntimeError(
            "Member listing requires the proxy server's file API; "
            "open arrays directly with .array(name)"
        )


def zarr_array_like(obj: Any) -> bool:
    return isinstance(obj, (RemoteZarrArray, RemoteZarrGroup))
