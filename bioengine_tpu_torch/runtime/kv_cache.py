"""Paged KV cache for autoregressive decoding, with the pool on the device.

Counterpart of ``bioengine_tpu/runtime/kv_cache.py``, with the same API,
block-table semantics, free-list order, LRU eviction of unpinned
sequences (a ``decode.kv_evict`` flight event) and ``stats``. KV lives
in fixed-size **blocks** drawn from a shared pool (the vLLM
paged-attention layout): a sequence owns an ordered block table,
allocation is a free-list pop, and freeing a finished sequence returns
whole blocks.

The difference: the pools ``k_pool``/``v_pool``
``[n_layers, num_blocks, block_size, n_heads, head_dim]`` are torch
tensors on the cache's ``device`` (the JAX cache keeps host numpy), so
prefill and append write on the device and ``gather`` indexes the pool
there, one gather per call. The bookkeeping (block tables, lengths, the
free list, the LRU order) stays on the host under one lock, because
scrape-time collectors read ``stats`` from other threads.

Capacity knobs ride ``BIOENGINE_DECODE_KV_BLOCKS`` /
``BIOENGINE_DECODE_BLOCK_SIZE`` (defaults 512 and 16, read once).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device
from bioengine_tpu_torch.utils import flight, metrics


class KVCacheFull(RuntimeError):
    """The block pool is exhausted and no idle sequence can be evicted.

    Typed so admission control can shed (retryable) instead of the
    engine dying mid-batch."""


_ENV_DEFAULTS: Optional[tuple[int, int]] = None


def env_capacity() -> tuple[int, int]:
    """(num_blocks, block_size) from ``BIOENGINE_DECODE_KV_BLOCKS`` /
    ``BIOENGINE_DECODE_BLOCK_SIZE``, read once per process."""
    global _ENV_DEFAULTS
    if _ENV_DEFAULTS is None:
        _ENV_DEFAULTS = (
            int(os.environ.get("BIOENGINE_DECODE_KV_BLOCKS", "512")),
            int(os.environ.get("BIOENGINE_DECODE_BLOCK_SIZE", "16")),
        )
    return _ENV_DEFAULTS


@dataclass
class _Sequence:
    """One live sequence: its block table and fill level."""

    block_ids: list = field(default_factory=list)
    length: int = 0          # tokens currently stored
    pinned: bool = False     # active in a running batch — never evicted


def _collect_kv_caches(instances: list) -> list:
    """Scrape-time fold of live KV caches: pool pressure decides whether
    the next sequence admits, and an operator reads it next to batch
    occupancy."""
    total = in_use = seqs = evictions = appends = 0
    for c in instances:
        s = c.stats
        total += s["blocks_total"]
        in_use += s["blocks_in_use"]
        seqs += s["sequences"]
        evictions += s["evictions"]
        appends += s["appends"]
    return [
        metrics.Sample(
            "kv_cache_blocks_total", total,
            help="KV block pool capacity across caches",
        ),
        metrics.Sample(
            "kv_cache_blocks_in_use", in_use,
            help="KV blocks currently owned by live sequences",
        ),
        metrics.Sample(
            "kv_cache_sequences", seqs,
            help="sequences with resident KV state",
        ),
        metrics.Sample(
            "kv_cache_evictions_total", evictions, kind="counter",
            help="idle sequences evicted to reclaim KV blocks",
        ),
        metrics.Sample(
            "kv_cache_appends_total", appends, kind="counter",
            help="KV entries appended (one per decoded token per sequence)",
        ),
    ]


_KV_CACHES = metrics.InstanceSet("kv_cache", _collect_kv_caches)


def gather_blocks(
    pool: torch.Tensor, table: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Dense padded KV from a pool ``[..., num_blocks, block_size,
    n_heads, head_dim]`` (all layers, or one) through a block table
    ``[B, n]`` (int64, on the pool's device): ``[..., B, n * block_size,
    n_heads, head_dim]``, zero past each row's ``lengths[b]``. One indexed
    read, no loop over blocks; the decode step's CUDA graph calls it with
    the table in a fixed buffer."""
    B, n = table.shape
    bs, heads, dim = pool.shape[-3:]
    dense = pool.index_select(-4, table.reshape(-1))
    dense = dense.reshape(*pool.shape[:-4], B, n * bs, heads, dim)
    keep = torch.arange(n * bs, device=pool.device)[None, :] < lengths[:, None]
    return torch.where(keep[:, :, None, None], dense, 0.0)


class PagedKVCache:
    """Block-pooled KV storage for one decoder's sequences, on ``device``.

    Layout: ``k_pool``/``v_pool`` are
    ``[n_layers, num_blocks, block_size, n_heads, head_dim]`` tensors on
    the device; a sequence's logical KV ``[n_layers, T, n_heads,
    head_dim]`` lives scattered across its block table. ``gather``
    materializes the padded dense batch; ``append`` writes one step's KV
    into the tail block, ``append_batch`` a whole co-batch's in one
    indexed write.

    Thread-safe: the decode loop drives it from a worker thread while
    scrape-time collectors read stats.
    """

    def __init__(
        self,
        n_layers: int,
        n_heads: int,
        head_dim: int,
        num_blocks: Optional[int] = None,
        block_size: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        device: DeviceLike = None,
    ):
        env_blocks, env_bs = env_capacity()
        self.device = resolve_device(device)
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.num_blocks = int(num_blocks if num_blocks is not None else env_blocks)
        self.block_size = int(block_size if block_size is not None else env_bs)
        shape = (
            self.n_layers, self.num_blocks, self.block_size,
            self.n_heads, self.head_dim,
        )
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free: list[int] = list(range(self.num_blocks - 1, -1, -1))
        # LRU order: oldest-touched first — eviction victims pop from
        # the front, every touch moves a sequence to the end
        self._seqs: "OrderedDict[str, _Sequence]" = OrderedDict()
        self._lock = threading.Lock()
        self._evictions = 0
        self._appends = 0
        _KV_CACHES.add(self)

    # ---- allocation ---------------------------------------------------------

    def _alloc_block_locked(self, for_seq: str) -> int:
        if self._free:
            return self._free.pop()
        # pool exhausted: evict the least-recently-touched IDLE
        # sequence (pinned = in the running batch, never a victim)
        victim_id = next(
            (sid for sid, s in self._seqs.items() if not s.pinned and sid != for_seq),
            None,
        )
        if victim_id is None:
            raise KVCacheFull(
                f"kv pool exhausted ({self.num_blocks} blocks) with no "
                f"evictable sequence — shed or raise "
                f"BIOENGINE_DECODE_KV_BLOCKS"
            )
        victim = self._seqs.pop(victim_id)
        self._free.extend(reversed(victim.block_ids))
        self._evictions += 1
        flight.record(
            "decode.kv_evict",
            seq=victim_id,
            blocks=len(victim.block_ids),
            tokens=victim.length,
        )
        return self._free.pop()

    def has_sequence(self, seq_id: str) -> bool:
        with self._lock:
            return seq_id in self._seqs

    def sequence_length(self, seq_id: str) -> int:
        with self._lock:
            s = self._seqs.get(seq_id)
            return s.length if s is not None else 0

    def pin(self, seq_id: str) -> None:
        """Mark a sequence as batch-active (exempt from eviction)."""
        with self._lock:
            s = self._seqs.get(seq_id)
            if s is not None:
                s.pinned = True
                self._seqs.move_to_end(seq_id)

    def unpin(self, seq_id: str) -> None:
        with self._lock:
            s = self._seqs.get(seq_id)
            if s is not None:
                s.pinned = False

    # ---- writes -------------------------------------------------------------

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.k_pool.dtype, device=self.device)

    def _write(self, blocks: list[int], slots: list[int], k, v) -> None:
        """One indexed write per pool: entry i of ``k``/``v`` (their
        axis 1, after the layer axis) lands at (blocks[i], slots[i])."""
        if not blocks:
            return
        index = torch.tensor([blocks, slots], dtype=torch.int64).to(
            self.device, non_blocking=True
        )
        self.k_pool[:, index[0], index[1]] = self._on_device(k)
        self.v_pool[:, index[0], index[1]] = self._on_device(v)

    def write_prefill(self, seq_id: str, k, v) -> None:
        """Store a prefilled prefix. ``k``/``v``:
        ``[n_layers, T, n_heads, head_dim]`` (un-padded length), numpy or
        torch."""
        T = k.shape[1]
        bs = self.block_size
        with self._lock:
            if seq_id in self._seqs:
                old = self._seqs.pop(seq_id)
                self._free.extend(reversed(old.block_ids))
            seq = _Sequence()
            n_blocks = max(1, -(-T // bs))
            for _ in range(n_blocks):
                seq.block_ids.append(self._alloc_block_locked(seq_id))
            self._write(
                [seq.block_ids[t // bs] for t in range(T)],
                [t % bs for t in range(T)],
                k, v,
            )
            seq.length = T
            seq.pinned = True
            self._seqs[seq_id] = seq

    def _append_slot_locked(self, seq_id: str) -> tuple[int, int]:
        """Bookkeeping of one append: the (block, slot) the entry goes to."""
        bs = self.block_size
        seq = self._seqs.get(seq_id)
        if seq is None:
            raise KeyError(f"no KV state for sequence '{seq_id}'")
        slot = seq.length % bs
        if slot == 0 and seq.length > 0 or not seq.block_ids:
            seq.block_ids.append(self._alloc_block_locked(seq_id))
        seq.length += 1
        self._appends += 1
        self._seqs.move_to_end(seq_id)
        return seq.block_ids[-1], slot

    def append(self, seq_id: str, k_step, v_step) -> None:
        """Append one decoded step's KV. ``k_step``/``v_step``:
        ``[n_layers, n_heads, head_dim]``."""
        with self._lock:
            bid, slot = self._append_slot_locked(seq_id)
            self._write([bid], [slot], k_step[:, None], v_step[:, None])

    def append_batch(self, seq_ids: Sequence[str], k_new, v_new) -> None:
        """``append(seq_ids[i], k_new[:, i], v_new[:, i])`` for every i, in
        order (the same bookkeeping), with one indexed write per pool.
        ``k_new``/``v_new``: ``[n_layers, len(seq_ids), n_heads,
        head_dim]``. If an append fails (``KeyError``, ``KVCacheFull``),
        the entries before it are written, as sequential appends leave
        them, and the error propagates."""
        blocks: list[int] = []
        slots: list[int] = []
        with self._lock:
            try:
                for sid in seq_ids:
                    bid, slot = self._append_slot_locked(sid)
                    blocks.append(bid)
                    slots.append(slot)
            finally:
                n = len(blocks)
                self._write(blocks, slots, k_new[:, :n], v_new[:, :n])

    # ---- reads --------------------------------------------------------------

    def _block_table_locked(self, seq_ids, pad_len, pad_batch):
        B = pad_batch if pad_batch is not None else len(seq_ids)
        table = np.zeros((B, pad_len // self.block_size), np.int64)
        lengths = np.zeros((B,), np.int64)
        for b, sid in enumerate(seq_ids):
            seq = self._seqs.get(sid)
            if seq is None:
                raise KeyError(f"no KV state for sequence '{sid}'")
            used = -(-seq.length // self.block_size)
            table[b, :used] = seq.block_ids[:used]
            lengths[b] = seq.length
            self._seqs.move_to_end(sid)
        return table, lengths

    def block_table(
        self, seq_ids: Sequence[str], pad_len: int, pad_batch: Optional[int] = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Host ``(table, lengths)`` for a padded batch: ``table`` int64
        ``[B_pad, pad_len // block_size]`` (block ids; 0 past a sequence's
        blocks and in pad rows, which ``lengths`` masks), ``lengths``
        int64 ``[B_pad]`` (0 for pad rows). Touches each sequence's LRU
        position, as ``gather`` does. ``pad_len`` must be a multiple of
        ``block_size`` (the caller buckets it so)."""
        with self._lock:
            return self._block_table_locked(seq_ids, pad_len, pad_batch)

    def gather(
        self, seq_ids: list[str], pad_len: int, pad_batch: Optional[int] = None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Dense padded batch view: ``(K, V, lengths)`` on the device, with
        K/V ``[n_layers, B_pad, pad_len, n_heads, head_dim]`` (zero past
        each sequence's length and in pad rows) and lengths int32
        ``[B_pad]`` (0 for pad rows). ``pad_len`` must be a multiple of
        ``block_size``."""
        with self._lock:
            table, lengths = self._block_table_locked(seq_ids, pad_len, pad_batch)
            t = torch.from_numpy(table).to(self.device)
            n = torch.from_numpy(lengths).to(self.device)
            K = gather_blocks(self.k_pool, t, n)
            V = gather_blocks(self.v_pool, t, n)
        return K, V, n.to(torch.int32)

    # ---- lifecycle ----------------------------------------------------------

    def free(self, seq_id: str) -> int:
        """Release a sequence's blocks back to the pool; returns the
        number of blocks reclaimed (0 when unknown — idempotent)."""
        with self._lock:
            seq = self._seqs.pop(seq_id, None)
            if seq is None:
                return 0
            self._free.extend(reversed(seq.block_ids))
            return len(seq.block_ids)

    def __len__(self) -> int:
        with self._lock:
            return len(self._seqs)

    @property
    def stats(self) -> dict:
        with self._lock:
            in_use = self.num_blocks - len(self._free)
            return {
                "blocks_total": self.num_blocks,
                "blocks_in_use": in_use,
                "block_utilization": in_use / max(1, self.num_blocks),
                "block_size": self.block_size,
                "sequences": len(self._seqs),
                "evictions": self._evictions,
                "appends": self._appends,
            }
