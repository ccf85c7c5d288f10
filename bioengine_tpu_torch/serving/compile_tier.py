"""Shared compile-cache tier — the controller-side store.

A worker host's persistent XLA cache (utils/compile_cache.py) only
helps the machine that already paid the compile. At production churn
(autoscale-up onto a fresh node, a preempted TPU replaced by a new
lease) the new host's directory is empty and the replica pays the full
20-40 s compile before its first request — exactly the cold-start the
autoscaler was trying to get ahead of.

This store promotes the cache to a controller-coordinated tier: worker
hosts publish their locally-compiled entries here (``register_host``
join + after every replica start) and fetch what the fleet already
compiled before their first compile would happen. Entries are keyed
exactly as jax keys them on disk (``jit_<fn>-<hash>-cache``), so a
fetch-installed file IS a local persistent-cache hit — no re-keying,
no format translation. Bulk bytes ride the existing RPC data plane
(the PR 3 zero-copy transport moves them as out-of-band payloads).

Directory-backed and size-bounded: eviction is LRU on access time, so
the programs the fleet keeps re-fetching stay resident.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Optional

from bioengine_tpu_torch.utils import flight, metrics
from bioengine_tpu_torch.utils.compile_cache import _safe_entry_name

# not the JAX package's xla-tier: a port host would fetch the JAX hosts'
# XLA programs into its kernel-library cache, and publish them back
DEFAULT_TIER_DIR = "~/.cache/bioengine-tpu/kernel-tier"

TIER_SERVED = metrics.counter(
    "compile_tier_served_total",
    "tier fetch requests served with an entry (tier hits)",
)
TIER_MISSES = metrics.counter(
    "compile_tier_miss_total",
    "tier fetch requests for entries the tier does not hold",
)
TIER_STORED = metrics.counter(
    "compile_tier_stored_total",
    "entries accepted into the tier from publishing hosts",
)
TIER_EVICTIONS = metrics.counter(
    "compile_tier_evictions_total",
    "entries evicted to keep the tier under its size bound",
)


class CompileCacheTier:
    """Bounded, directory-backed store of compiled-program cache
    entries, served over the serve-router verbs ``compile_cache_list``
    / ``compile_cache_fetch`` / ``compile_cache_publish``."""

    def __init__(
        self,
        directory: str | Path | None = None,
        max_bytes: Optional[int] = None,
    ):
        self.directory = Path(
            directory
            or os.environ.get("BIOENGINE_COMPILE_TIER_DIR")
            or DEFAULT_TIER_DIR
        ).expanduser()
        self.max_bytes = (
            int(max_bytes)
            if max_bytes is not None
            else int(
                float(os.environ.get("BIOENGINE_COMPILE_TIER_MAX_MB", "2048"))
                * 1024
                * 1024
            )
        )
        self._available: Optional[bool] = None
        # lifetime counters (the metrics above are process-global; an
        # operator asking THIS tier's hit rate reads stats())
        self.served = 0
        self.missed = 0
        self.stored = 0
        self.evicted = 0

    def _ensure_dir(self) -> bool:
        if self._available is None:
            try:
                self.directory.mkdir(parents=True, exist_ok=True)
                self._available = True
            except OSError:
                # verdict cached — a read-only controller FS degrades
                # the tier to "empty", it never breaks register_host
                self._available = False
        return self._available

    # ---- verbs --------------------------------------------------------------

    def list(self) -> dict[str, int]:
        """{entry_name: size_bytes} of everything the tier holds."""
        if not self._ensure_dir():
            return {}
        out: dict[str, int] = {}
        try:
            for p in self.directory.iterdir():
                if _safe_entry_name(p.name) and p.is_file():
                    out[p.name] = p.stat().st_size
        except OSError:
            return {}
        return out

    def fetch(self, name: str) -> Optional[bytes]:
        """One entry's bytes (touches its atime for LRU), or None."""
        if not self._ensure_dir() or not _safe_entry_name(name):
            self.missed += 1
            TIER_MISSES.inc()
            return None
        p = self.directory / name
        try:
            blob = p.read_bytes()
        except OSError:
            self.missed += 1
            TIER_MISSES.inc()
            return None
        try:
            now = time.time()
            os.utime(p, (now, now))
        except OSError:
            pass
        self.served += 1
        TIER_SERVED.inc()
        return blob

    def publish(self, name: str, blob: bytes) -> bool:
        """Accept one entry from a host. Idempotent (an existing entry
        is kept — every host compiling the same program publishes the
        same bytes); oversized single entries are refused outright."""
        if (
            not self._ensure_dir()
            or not _safe_entry_name(name)
            or not isinstance(blob, (bytes, bytearray, memoryview))
        ):
            return False
        blob = bytes(blob)
        if len(blob) > self.max_bytes:
            return False
        p = self.directory / name
        if p.exists():
            return False
        try:
            tmp = p.with_name(f".pub-{os.getpid()}-{name[:64]}")
            tmp.write_bytes(blob)
            os.replace(tmp, p)
        except OSError:
            return False
        self.stored += 1
        TIER_STORED.inc()
        flight.record(
            "program.cache_publish", entry=name[:120], bytes=len(blob)
        )
        self._evict_over_budget()
        return True

    def _evict_over_budget(self) -> None:
        entries = []
        total = 0
        try:
            for p in self.directory.iterdir():
                if _safe_entry_name(p.name) and p.is_file():
                    st = p.stat()
                    entries.append((st.st_atime, st.st_size, p))
                    total += st.st_size
        except OSError:
            return
        if total <= self.max_bytes:
            return
        for _, size, p in sorted(entries):  # oldest access first
            try:
                p.unlink()
            except OSError:
                continue
            self.evicted += 1
            TIER_EVICTIONS.inc()
            flight.record("program.cache_evict_tier", entry=p.name[:120])
            total -= size
            if total <= self.max_bytes:
                break

    # ---- status -------------------------------------------------------------

    def stats(self) -> dict:
        listing = self.list()
        requests = self.served + self.missed
        return {
            "directory": str(self.directory),
            "available": bool(self._ensure_dir()),
            "entries": len(listing),
            "bytes": sum(listing.values()),
            "max_bytes": self.max_bytes,
            "served": self.served,
            "missed": self.missed,
            "stored": self.stored,
            "evicted": self.evicted,
            "hit_rate": round(self.served / requests, 4) if requests else 0.0,
        }
