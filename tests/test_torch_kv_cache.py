"""The port's paged KV cache (pool on the device) against the JAX cache.

Mirrors ``tests/test_decode.py``'s ``TestPagedKVCache`` cases on the
port's ``PagedKVCache(device="cpu")``, each beside the JAX cache fed the
same seeded numpy KV; then a seeded random sequence of operations on
both caches, with ``gather`` equal bit for bit and ``stats``, the
block tables and the flight events equal after every operation.
"""

import time

import numpy as np
import pytest
import torch

from bioengine_tpu.runtime.kv_cache import KVCacheFull as JaxKVCacheFull
from bioengine_tpu.runtime.kv_cache import PagedKVCache as JaxPagedKVCache
from bioengine_tpu.utils import flight as jax_flight
from _torch_parity import few_torch_threads  # noqa: F401
from bioengine_tpu_torch.runtime.kv_cache import (
    KVCacheFull,
    PagedKVCache,
    env_capacity,
    gather_blocks,
)
from bioengine_tpu_torch.utils import flight


def _rand_kv(rng, n_layers, T, n_heads, head_dim):
    return (
        rng.normal(size=(n_layers, T, n_heads, head_dim)).astype(np.float32),
        rng.normal(size=(n_layers, T, n_heads, head_dim)).astype(np.float32),
    )


def _pair(*args, **kwargs):
    return PagedKVCache(*args, device="cpu", **kwargs), JaxPagedKVCache(*args, **kwargs)


def _assert_gather_equal(port, ref, seq_ids, pad_len, pad_batch=None):
    K, V, lengths = port.gather(seq_ids, pad_len, pad_batch=pad_batch)
    K2, V2, lengths2 = ref.gather(seq_ids, pad_len, pad_batch=pad_batch)
    assert K.device.type == "cpu" and K.dtype == torch.float32
    np.testing.assert_array_equal(K.numpy(), K2)
    np.testing.assert_array_equal(V.numpy(), V2)
    assert lengths.dtype == torch.int32
    np.testing.assert_array_equal(lengths.numpy(), lengths2)
    return K, V, lengths


def test_prefill_gather_roundtrip():
    """KV written as a prefix comes back exactly through the block table,
    zero-padded to the bucket, as the JAX cache gives it."""
    rng = np.random.default_rng(0)
    port, ref = _pair(2, 4, 16, num_blocks=8, block_size=4)
    k, v = _rand_kv(rng, 2, 6, 4, 16)  # 6 tokens -> 2 blocks
    port.write_prefill("s", k, v)
    ref.write_prefill("s", k, v)
    assert port.sequence_length("s") == 6
    assert tuple(port.k_pool.shape) == (2, 8, 4, 4, 16)
    K, V, lengths = _assert_gather_equal(port, ref, ["s"], 8)
    assert K.shape == (2, 1, 8, 4, 16)
    np.testing.assert_array_equal(K[:, 0, :6].numpy(), k)
    assert not K[:, 0, 6:].any()
    assert lengths.tolist() == [6]
    # a torch input on the device and a padded batch
    port.write_prefill("t", torch.from_numpy(k[:, :5]), torch.from_numpy(v[:, :5]))
    ref.write_prefill("t", k[:, :5], v[:, :5])
    _assert_gather_equal(port, ref, ["t", "s"], 8, pad_batch=4)
    assert port.stats == ref.stats


def test_append_crosses_block_boundary():
    rng = np.random.default_rng(1)
    port, ref = _pair(1, 2, 8, num_blocks=8, block_size=4)
    k, v = _rand_kv(rng, 1, 3, 2, 8)
    port.write_prefill("s", k, v)
    ref.write_prefill("s", k, v)
    steps = []
    for _ in range(4):  # 3 -> 7 tokens: crosses the 4-token block edge
        ks = rng.normal(size=(1, 2, 8)).astype(np.float32)
        vs = rng.normal(size=(1, 2, 8)).astype(np.float32)
        port.append("s", ks, vs)
        ref.append("s", ks, vs)
        steps.append((ks, vs))
    assert port.sequence_length("s") == 7
    K, V, _ = _assert_gather_equal(port, ref, ["s"], 8)
    for i, (ks, vs) in enumerate(steps):
        np.testing.assert_array_equal(K[:, 0, 3 + i].numpy(), ks)
        np.testing.assert_array_equal(V[:, 0, 3 + i].numpy(), vs)
    assert port.stats == ref.stats


def test_append_batch_equals_sequential_appends():
    """One indexed write per pool for a co-batch: the same pool, block
    tables and stats as appending each sequence in turn."""
    rng = np.random.default_rng(5)
    batched = PagedKVCache(2, 2, 4, num_blocks=16, block_size=4, device="cpu")
    seq = PagedKVCache(2, 2, 4, num_blocks=16, block_size=4, device="cpu")
    for T, sid in ((3, "a"), (4, "b"), (1, "c")):
        k, v = _rand_kv(rng, 2, T, 2, 4)
        batched.write_prefill(sid, k, v)
        seq.write_prefill(sid, k, v)
    for _ in range(6):
        kn = rng.normal(size=(2, 3, 2, 4)).astype(np.float32)
        vn = rng.normal(size=(2, 3, 2, 4)).astype(np.float32)
        batched.append_batch(["b", "a", "c"], torch.from_numpy(kn), torch.from_numpy(vn))
        for i, sid in enumerate(["b", "a", "c"]):
            seq.append(sid, kn[:, i], vn[:, i])
    assert torch.equal(batched.k_pool, seq.k_pool)
    assert torch.equal(batched.v_pool, seq.v_pool)
    for pad in (None, 4):
        t1, l1 = batched.block_table(["a", "b", "c"], 16, pad_batch=pad)
        t2, l2 = seq.block_table(["a", "b", "c"], 16, pad_batch=pad)
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(l1, l2)
    assert batched.stats == seq.stats
    # a failing append keeps the entries before it, as sequential appends do
    kn = rng.normal(size=(2, 2, 2, 4)).astype(np.float32)
    with pytest.raises(KeyError, match="nope"):
        batched.append_batch(["a", "nope"], kn, kn)
    seq.append("a", kn[:, 0], kn[:, 0])
    assert torch.equal(batched.k_pool, seq.k_pool)
    assert batched.stats == seq.stats


def test_gather_blocks_single_layer_matches_gather():
    rng = np.random.default_rng(6)
    cache = PagedKVCache(3, 2, 4, num_blocks=12, block_size=4, device="cpu")
    for sid, T in (("x", 9), ("y", 2)):
        k, v = _rand_kv(rng, 3, T, 2, 4)
        cache.write_prefill(sid, k, v)
    K, _, lengths = cache.gather(["y", "x"], 12, pad_batch=4)
    table, _ = cache.block_table(["y", "x"], 12, pad_batch=4)
    t = torch.from_numpy(table)
    for li in range(3):
        layer = gather_blocks(cache.k_pool[li], t, lengths.long())
        assert torch.equal(layer, K[li])


def test_free_returns_blocks_and_is_idempotent():
    rng = np.random.default_rng(2)
    port, ref = _pair(1, 2, 8, num_blocks=4, block_size=4)
    k, v = _rand_kv(rng, 1, 8, 2, 8)
    for cache in (port, ref):
        cache.write_prefill("s", k, v)
        assert cache.stats["blocks_in_use"] == 2
        assert cache.free("s") == 2
        assert cache.free("s") == 0
        assert cache.stats["blocks_in_use"] == 0
        assert len(cache) == 0
    assert port.stats == ref.stats


def test_eviction_reclaims_idle_lru_victim():
    """Pool exhaustion evicts the least-recently-touched UNPINNED sequence
    (a ``decode.kv_evict`` event in the port's recorder); an all-pinned
    pool sheds typed, in both caches."""
    rng = np.random.default_rng(3)
    port, ref = _pair(1, 2, 8, num_blocks=2, block_size=4)
    k, v = _rand_kv(rng, 1, 4, 2, 8)
    t0 = time.time()
    for cache in (port, ref):
        cache.write_prefill("a", k, v)
        cache.unpin("a")  # idle: eviction candidate
        cache.write_prefill("b", k, v)
        cache.write_prefill("c", k, v)  # must evict 'a'
        assert not cache.has_sequence("a")
        assert cache.has_sequence("b") and cache.has_sequence("c")
    for fmod in (flight, jax_flight):
        evs = fmod.get_events(types=("decode.kv_evict",), since=t0)
        assert evs and evs[-1]["attrs"] == {"seq": "a", "blocks": 1, "tokens": 4}
    with pytest.raises(KVCacheFull):
        port.write_prefill("d", k, v)
    with pytest.raises(JaxKVCacheFull):
        ref.write_prefill("d", k, v)
    assert port.stats == ref.stats
    _assert_gather_equal(port, ref, ["c", "b"], 4)


def test_env_capacity_reads_the_jax_variables(monkeypatch):
    from bioengine_tpu.runtime import kv_cache as jax_kv_cache
    from bioengine_tpu_torch.runtime import kv_cache

    for mod in (kv_cache, jax_kv_cache):
        monkeypatch.setattr(mod, "_ENV_DEFAULTS", None)
    monkeypatch.delenv("BIOENGINE_DECODE_KV_BLOCKS", raising=False)
    monkeypatch.delenv("BIOENGINE_DECODE_BLOCK_SIZE", raising=False)
    assert env_capacity() == jax_kv_cache.env_capacity() == (512, 16)
    for mod in (kv_cache, jax_kv_cache):
        monkeypatch.setattr(mod, "_ENV_DEFAULTS", None)
    monkeypatch.setenv("BIOENGINE_DECODE_KV_BLOCKS", "7")
    monkeypatch.setenv("BIOENGINE_DECODE_BLOCK_SIZE", "2")
    assert env_capacity() == jax_kv_cache.env_capacity() == (7, 2)
    cache = PagedKVCache(1, 1, 2, device="cpu")
    assert (cache.num_blocks, cache.block_size) == (7, 2)
    assert tuple(cache.k_pool.shape) == (1, 7, 2, 1, 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_operations_match_the_jax_cache(seed):
    """Prefill, append, append_batch, pin/unpin, free and gather in a
    seeded random order over a small pool (evictions and KVCacheFull
    included): after every operation, the same outcome, ``stats`` and
    block tables, and ``gather`` equal bit for bit."""
    rng = np.random.default_rng(100 + seed)
    L, H, D, bs = 2, 2, 4, 4
    port, ref = _pair(L, H, D, num_blocks=10, block_size=bs)
    names = [f"s{i}" for i in range(6)]
    t0 = time.time()
    for _ in range(120):
        op = rng.choice(["prefill", "append", "append_batch", "unpin", "pin", "free", "gather"],
                        p=[0.18, 0.3, 0.17, 0.1, 0.05, 0.08, 0.12])
        sid = str(rng.choice(names))
        outcome = []
        for cache in (port, ref):
            try:
                if op == "prefill":
                    T = int(rng.integers(1, 10)) if cache is port else T
                    kv = _rand_kv(rng, L, T, H, D) if cache is port else kv
                    cache.write_prefill(sid, *kv)
                elif op == "append":
                    ks = rng.normal(size=(L, H, D)).astype(np.float32) if cache is port else ks
                    cache.append(sid, ks, -ks)
                elif op == "append_batch":
                    if cache is port:
                        ids = [str(s) for s in rng.choice(names, size=3, replace=False)]
                        kn = rng.normal(size=(L, 3, H, D)).astype(np.float32)
                        cache.append_batch(ids, kn, kn * 2)
                    else:
                        for i, s in enumerate(ids):
                            cache.append(s, kn[:, i], kn[:, i] * 2)
                elif op == "unpin":
                    cache.unpin(sid)
                elif op == "pin":
                    cache.pin(sid)
                elif op == "free":
                    outcome.append(cache.free(sid))
                    continue
                else:
                    live = [s for s in names if cache.has_sequence(s)]
                    if live:
                        longest = max(cache.sequence_length(s) for s in live)
                        pad = -(-longest // bs) * bs
                        if cache is port:
                            _assert_gather_equal(port, ref, live, pad, pad_batch=len(live) + 1)
                outcome.append("ok")
            except (KVCacheFull, JaxKVCacheFull):
                outcome.append("full")
            except KeyError:
                outcome.append("missing")
        assert outcome[0] == outcome[1], (op, sid, outcome)
        assert port.stats == ref.stats
        live = [s for s in names if ref.has_sequence(s)]
        assert live == [s for s in names if port.has_sequence(s)]
        for s in live:
            assert port.sequence_length(s) == ref.sequence_length(s)
    assert [e["attrs"] for e in flight.get_events(types=("decode.kv_evict",), since=t0)] == [
        e["attrs"] for e in jax_flight.get_events(types=("decode.kv_evict",), since=t0)
    ]
    live = [s for s in names if ref.has_sequence(s)]
    if live:
        longest = max(ref.sequence_length(s) for s in live)
        _assert_gather_equal(port, ref, live, -(-longest // bs) * bs)


def test_pool_lives_on_the_cache_device():
    cache = PagedKVCache(1, 1, 2, num_blocks=2, block_size=2, device="cpu")
    assert cache.device.type == "cpu" and cache.k_pool.device.type == "cpu"
