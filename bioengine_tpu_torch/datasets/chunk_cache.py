"""Byte-bounded LRU cache for dataset chunks.

Capability parity with ref bioengine/datasets/chunk_cache.py:18-103
(1 GB default via env var, asyncio-lock guarded, runtime resize,
module-level shared instance) — plus a host-shared variant backed by
the native C++ shm object store so every replica process on a TPU host
shares one chunk cache (set BIOENGINE_DATASETS_SHARED_CACHE=1).
"""

from __future__ import annotations

import asyncio
import os
from collections import OrderedDict
from typing import Optional

DEFAULT_CACHE_SIZE = int(
    os.environ.get(
        "BIOENGINE_DATASETS_ZARR_STORE_CACHE_SIZE", str(1024 * 1024 * 1024)
    )
)


class ChunkCache:
    """Byte-bounded LRU mapping cache-key -> bytes."""

    def __init__(self, max_bytes: int = DEFAULT_CACHE_SIZE):
        self.max_bytes = max_bytes
        self._data: OrderedDict[str, bytes] = OrderedDict()
        self._size = 0
        self._lock = asyncio.Lock()
        self.hits = 0
        self.misses = 0

    @property
    def size_bytes(self) -> int:
        return self._size

    def __len__(self) -> int:
        return len(self._data)

    async def get(self, key: str) -> Optional[bytes]:
        async with self._lock:
            value = self._data.get(key)
            if value is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return value

    async def put(self, key: str, value: bytes) -> None:
        if len(value) > self.max_bytes:
            return  # never cache an item bigger than the whole budget
        async with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._size -= len(old)
            self._data[key] = value
            self._size += len(value)
            while self._size > self.max_bytes and self._data:
                _, evicted = self._data.popitem(last=False)
                self._size -= len(evicted)

    async def resize(self, max_bytes: int) -> None:
        async with self._lock:
            self.max_bytes = max_bytes
            while self._size > self.max_bytes and self._data:
                _, evicted = self._data.popitem(last=False)
                self._size -= len(evicted)

    async def clear(self) -> None:
        async with self._lock:
            self._data.clear()
            self._size = 0


class SharedChunkCache:
    """ChunkCache API over the native shared-memory object store —
    one cache per HOST instead of per process, so N replicas streaming
    the same zarr dataset fetch each chunk over HTTP once.

    The native store's mutex is process-shared and calls are short
    (memcpy), so the async API simply calls through.
    """

    def __init__(
        self,
        max_bytes: int = DEFAULT_CACHE_SIZE,
        name: str = "bioengine-chunks",
    ):
        from bioengine_tpu_torch.native import open_store

        self.max_bytes = max_bytes
        self._name = name
        # attach-or-create: a late-starting replica joins the existing
        # segment — it must NEVER wipe what its siblings already cached
        self._store = open_store(name, capacity=max_bytes, create="attach")

    @property
    def size_bytes(self) -> int:
        return int(self._store.stats()["used_bytes"])

    def __len__(self) -> int:
        return int(self._store.stats()["n_objects"])

    @property
    def hits(self) -> int:
        return int(self._store.stats()["hits"])

    @property
    def misses(self) -> int:
        return int(self._store.stats()["misses"])

    async def get(self, key: str) -> Optional[bytes]:
        return self._store.get_bytes(key)

    async def put(self, key: str, value: bytes) -> None:
        if len(value) > self.max_bytes:
            return
        try:
            self._store.put(key, value)
        except FileExistsError:
            pass  # another replica cached it first — fine
        except OSError:
            pass  # cache full of pinned entries: serve without caching

    async def resize(self, max_bytes: int) -> None:
        """The shm segment's capacity is fixed at creation. Shrinking
        gates future puts; growing past the segment is impossible and
        logged instead of silently ignored."""
        capacity = int(self._store.stats()["capacity"])
        if max_bytes > capacity:
            import logging

            logging.getLogger(__name__).warning(
                "SharedChunkCache cannot grow past its shm capacity "
                "(%d > %d); recreate the segment to grow",
                max_bytes, capacity,
            )
        self.max_bytes = min(max_bytes, capacity)

    async def clear(self) -> None:
        # in place: every attached replica observes the cleared state
        self._store.clear()


def make_default_cache():
    if os.environ.get("BIOENGINE_DATASETS_SHARED_CACHE"):
        try:
            return SharedChunkCache()
        except Exception as e:
            import logging

            logging.getLogger(__name__).warning(
                "BIOENGINE_DATASETS_SHARED_CACHE requested but the "
                "shared cache is unavailable (%s); falling back to a "
                "per-process cache", e,
            )
    return ChunkCache()


class _LazyDefaultCache:
    """Defers construction to first use so importing the datasets
    package never triggers a native build or shm creation."""

    _inner = None

    def _cache(self):
        if self._inner is None:
            self._inner = make_default_cache()
        return self._inner

    def __getattr__(self, name):
        return getattr(self._cache(), name)

    def __len__(self):
        return len(self._cache())


# shared across every store in the process (ref chunk_cache.py:103)
default_cache = _LazyDefaultCache()
