"""Program cache: a bounded LRU of built per-bucket programs.

Counterpart of ``bioengine_tpu/runtime/program_cache.py``. There the
cached object is an XLA executable; in the port's engine it is a CUDA
graph captured for one (model, bucket shape, dtype, placement) key, or on
the CPU the module's forward. Keys are explicit so eviction, stats and
warm-up stay controllable.

Builds and evictions leave ``program.compile`` / ``program.evict``
flight events, and live caches fold into the ``program_cache_*`` metrics
at scrape time, as in the JAX package. Left out of the copy: the XLA
persistent compile cache (so ``cache_hit`` is always False and
``persistent_hits`` stays 0).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable

from bioengine_tpu_torch.utils import flight, metrics


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    # always 0 in the port: there is no persistent cache to hit
    persistent_hits: int = 0
    # per-key build time for LIVE entries only (evicted keys are dropped)
    compile_seconds: dict = field(default_factory=dict)
    # per-key cache_hit verdict, same lifecycle as compile_seconds
    cache_hit: dict = field(default_factory=dict)
    # lifetime total, survives evictions
    cumulative_compile_seconds: float = 0.0

    def as_dict(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "persistent_hits": self.persistent_hits,
            "hit_rate": self.hits / total if total else 0.0,
            "total_compile_seconds": self.cumulative_compile_seconds,
            "live_compile_seconds": sum(self.compile_seconds.values()),
        }


def _collect_program_caches(instances: list) -> list:
    """Scrape-time fold of live program caches into process metrics:
    build time is the cold-start cost, and the reason a request's p99
    suddenly grows a tail."""
    hits = misses = evictions = persistent = 0
    compile_s = 0.0
    live = 0
    for c in instances:
        s = c.stats
        hits += s.hits
        misses += s.misses
        evictions += s.evictions
        persistent += s.persistent_hits
        compile_s += s.cumulative_compile_seconds
        live += len(c)
    return [
        metrics.Sample(
            "program_cache_hits_total", hits, kind="counter",
            help="compiled-program cache hits",
        ),
        metrics.Sample(
            "program_cache_misses_total", misses, kind="counter",
            help="compiled-program cache misses (each cost a compile)",
        ),
        metrics.Sample(
            "program_cache_evictions_total", evictions, kind="counter",
            help="compiled programs evicted (a re-request recompiles)",
        ),
        metrics.Sample(
            "program_cache_compile_seconds_total", round(compile_s, 6),
            kind="counter",
            help="lifetime program build seconds across caches",
        ),
        metrics.Sample(
            "program_cache_persistent_hits_total", persistent,
            kind="counter",
            help="misses satisfied by a persistent cache (always 0 here)",
        ),
        metrics.Sample(
            "program_cache_live_programs", live,
            help="compiled programs currently cached",
        ),
    ]


_PROGRAM_CACHES = metrics.InstanceSet("program_cache", _collect_program_caches)


class CompiledProgramCache:
    """Bounded LRU of built programs.

    ``get_or_compile(key, build)``: ``build()`` returns the object to
    cache. Thread-safe: concurrent misses on one key build once; the
    other callers wait for that build.
    """

    def __init__(self, max_programs: int = 32):
        self.max_programs = max_programs
        self._programs: OrderedDict[Hashable, Any] = OrderedDict()
        self._building: dict[Hashable, threading.Event] = {}
        self._lock = threading.Lock()
        self.stats = CacheStats()
        _PROGRAM_CACHES.add(self)

    def get_or_compile(self, key: Hashable, build: Callable[[], Any]) -> Any:
        while True:
            with self._lock:
                if key in self._programs:
                    self._programs.move_to_end(key)
                    self.stats.hits += 1
                    return self._programs[key]
                ev = self._building.get(key)
                if ev is None:
                    self._building[key] = threading.Event()
                    break
            ev.wait()
        try:
            t0 = time.perf_counter()
            program = build()
            dt = time.perf_counter() - t0
            evicted = []
            with self._lock:
                self.stats.misses += 1
                self.stats.compile_seconds[str(key)] = dt
                self.stats.cache_hit[str(key)] = False
                self.stats.cumulative_compile_seconds += dt
                self._programs[key] = program
                self._programs.move_to_end(key)
                while len(self._programs) > self.max_programs:
                    victim, _ = self._programs.popitem(last=False)
                    self.stats.compile_seconds.pop(str(victim), None)
                    self.stats.cache_hit.pop(str(victim), None)
                    self.stats.evictions += 1
                    evicted.append(victim)
            flight.record(
                "program.compile", key=str(key), seconds=round(dt, 3),
                cache_hit=False,
            )
            for victim in evicted:
                flight.record("program.evict", key=str(victim))
            return program
        finally:
            with self._lock:
                self._building.pop(key).set()

    def compile_info_snapshot(self) -> dict:
        """Per-key ``{"seconds": s, "cache_hit": bool}`` under the lock."""
        with self._lock:
            return {
                k: {
                    "seconds": v,
                    "cache_hit": bool(self.stats.cache_hit.get(k, False)),
                }
                for k, v in self.stats.compile_seconds.items()
            }

    def stats_dict(self) -> dict:
        """``stats.as_dict()`` under the cache lock."""
        with self._lock:
            return self.stats.as_dict()

    def evict(self, predicate: Callable[[Hashable], bool]) -> int:
        """Evict all entries whose key matches (e.g. one model's programs)."""
        with self._lock:
            victims = [k for k in self._programs if predicate(k)]
            for k in victims:
                del self._programs[k]
                self.stats.compile_seconds.pop(str(k), None)
                self.stats.cache_hit.pop(str(k), None)
            self.stats.evictions += len(victims)
        for k in victims:
            flight.record("program.evict", key=str(k))
        return len(victims)

    def keys(self) -> list[Hashable]:
        with self._lock:
            return list(self._programs)

    def __len__(self) -> int:
        with self._lock:
            return len(self._programs)


# Process-wide default, shared by the inference engines of one process.
default_program_cache = CompiledProgramCache()
