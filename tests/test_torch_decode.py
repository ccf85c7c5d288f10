"""The port's decoder and DecodeEngine against the JAX ones.

- ``init_decoder_params`` draws what the JAX init draws, bit for bit;
- ``decoder_prefill`` / ``decoder_step`` on the bridged params agree with
  the JAX functions within 1e-5 (f32, same seeded inputs, pad rows and
  padded prompts included), and with the independent numpy fixture
  ``tests/fixtures_golden_decoder.npz`` within 2e-4;
- ``DecodeEngine(device="cpu")`` reproduces the fixture's 32 greedy
  tokens exactly, and a mixed co-batch that joins, leaves and grows
  across KV-length buckets gives the JAX engine's tokens, with the same
  program keys per bucket and no new program on repeated traffic;
- the JAX engine's ``ValueError`` for a ``tp`` axis and for a prompt
  length out of range;
- dp (``tests/test_decode.py``'s mesh cases): the golden tokens on dp
  meshes of 2, 4 and 8 CPU entries bit for bit, ``mesh_shape``,
  ``chip_width`` and a lease of several ids; a mixed-length co-batch with
  eviction across the per-entry pools gives the one-device engine's
  tokens, each sequence pinned to the entry with the most free blocks.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioengine_tpu.runtime import decode_engine as jax_de
from bioengine_tpu.runtime.program_cache import CompiledProgramCache as JaxCache
from _torch_parity import few_torch_threads  # noqa: F401
from bioengine_tpu_torch.runtime import decode_engine as de
from bioengine_tpu_torch.runtime.program_cache import CompiledProgramCache
from bioengine_tpu_torch.utils import tracing

FIXTURE = Path(__file__).parent / "fixtures_golden_decoder.npz"
TOL = dict(rtol=1e-5, atol=1e-5)
GOLDEN_TOL = dict(rtol=2e-4, atol=2e-4)
# a non-default width: heads of 16, three layers, a shorter context
NARROW = de.DecoderConfig(d_model=48, n_heads=3, n_layers=3, d_ff=96, max_len=128)


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


def _model(config=de.DecoderConfig(), seed=0):
    params = jax_de.init_decoder_params(seed, jax_de.DecoderConfig(**vars(config)))
    model = de.Decoder(config)
    model.load_state_dict(de.decoder_state_dict(params))
    return params, model.eval().requires_grad_(False)


@pytest.mark.parametrize("config", [de.DecoderConfig(), NARROW], ids=["default", "narrow"])
def test_init_and_bridge_match_the_jax_params(config):
    ref = jax_de.init_decoder_params(3, jax_de.DecoderConfig(**vars(config)))
    mine = de.init_decoder_params(3, config)
    assert mine.keys() == ref.keys() and len(mine["layers"]) == config.n_layers
    for name in ("tok_emb", "pos_emb", "ln_f_g", "ln_f_b"):
        np.testing.assert_array_equal(mine[name], ref[name])
    for a, b in zip(mine["layers"], ref["layers"]):
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])
    sd = de.decoder_state_dict(ref)
    assert set(sd) == set(de.Decoder(config).state_dict())
    np.testing.assert_array_equal(sd["layers.0.wq.weight"].numpy(), ref["layers"][0]["wq"].T)
    np.testing.assert_array_equal(sd["layers.0.b1"].numpy(), ref["layers"][0]["b1"])


@pytest.mark.parametrize("config", [de.DecoderConfig(), NARROW], ids=["default", "narrow"])
@pytest.mark.parametrize("length,t_pad", [(16, 16), (5, 16), (23, 32)])
def test_prefill_matches_jax(config, length, t_pad):
    params, model = _model(config, seed=1)
    rng = np.random.default_rng(length)
    tokens = np.zeros((t_pad,), np.int32)
    tokens[:length] = rng.integers(0, config.vocab, size=length)
    jcfg = jax_de.DecoderConfig(**vars(config))
    logits, K, V = jax_de.decoder_prefill(params, jcfg, jnp.asarray(tokens), np.int32(length))
    with torch.no_grad():
        logits2, K2, V2 = de.decoder_prefill(
            model, torch.from_numpy(tokens).long(), torch.tensor(length)
        )
    np.testing.assert_allclose(logits2.numpy(), np.asarray(logits), **TOL)
    assert K2.shape == (config.n_layers, t_pad, config.n_heads, config.head_dim)
    # entries past length are garbage in both; the caller crops them
    np.testing.assert_allclose(K2[:, :length].numpy(), np.asarray(K)[:, :length], **TOL)
    np.testing.assert_allclose(V2[:, :length].numpy(), np.asarray(V)[:, :length], **TOL)


@pytest.mark.parametrize("config", [de.DecoderConfig(), NARROW], ids=["default", "narrow"])
def test_step_matches_jax_with_a_pad_row(config):
    """A padded batch of four: lengths 7, 16 and 1, and a pad row
    (length 0) that attends only to its own key."""
    params, model = _model(config, seed=2)
    rng = np.random.default_rng(7)
    lengths = np.array([7, 16, 1, 0], np.int32)
    B, T = len(lengths), 16
    shape = (config.n_layers, B, T, config.n_heads, config.head_dim)
    K = rng.normal(size=shape).astype(np.float32)
    V = rng.normal(size=shape).astype(np.float32)
    keep = (np.arange(T)[None, :] < lengths[:, None])[None, :, :, None, None]
    K, V = K * keep, V * keep
    tokens = rng.integers(0, config.vocab, size=B).astype(np.int32)
    jcfg = jax_de.DecoderConfig(**vars(config))
    logits, k_new, v_new = jax_de.decoder_step(params, jcfg, tokens, lengths, K, V, lengths)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    with torch.no_grad():
        logits2, k2, v2 = de.decoder_step(
            model, t(tokens).long(), t(lengths).long(), t(K), t(V), t(lengths).long()
        )
    assert torch.isfinite(logits2).all()
    np.testing.assert_allclose(logits2.numpy(), np.asarray(logits), **TOL)
    np.testing.assert_allclose(k2.numpy(), np.asarray(k_new), **TOL)
    np.testing.assert_allclose(v2.numpy(), np.asarray(v_new), **TOL)


def test_prefill_and_step_logits_match_the_golden_fixture(fx):
    _, model = _model()
    prompt = torch.from_numpy(fx["prompt"].astype(np.int64))
    T = len(prompt)
    with torch.no_grad():
        logits0, K, V = de.decoder_prefill(model, prompt, torch.tensor(T))
        np.testing.assert_allclose(logits0.numpy(), fx["prefill_logits"], **GOLDEN_TOL)
        tok0 = int(np.argmax(logits0.numpy()))
        assert tok0 == int(fx["greedy_tokens"][0])
        step_logits, _, _ = de.decoder_step(
            model, torch.tensor([tok0]), torch.tensor([T]),
            K[:, None], V[:, None], torch.tensor([T]),
        )
    np.testing.assert_allclose(step_logits[0].numpy(), fx["step_logits"], **GOLDEN_TOL)


def _engine_greedy(engine, prompt, n, seq_id="golden"):
    toks = [engine.prefill(seq_id, list(prompt))]
    while len(toks) < n:
        toks.extend(engine.step([seq_id], [toks[-1]]))
    engine.finish(seq_id)
    return toks


def test_engine_greedy_tokens_bit_exact(fx):
    """Bucketed prefill, the paged pool, batched steps across KV-bucket
    growth: the fixture's 32 greedy tokens exactly; finish releases KV."""
    engine = de.DecodeEngine(model_id="golden-cpu", device="cpu", cache=CompiledProgramCache())
    assert engine.kv.k_pool.device.type == "cpu"
    toks = _engine_greedy(engine, fx["prompt"], 32)
    assert toks == fx["greedy_tokens"].tolist()
    assert engine.kv.stats["sequences"] == 0
    d = engine.describe()
    assert d["mesh"] is None and d["n_devices"] == 1 and d["device"] == "cpu"
    assert d["config"] == vars(de.DecoderConfig())
    assert engine.chip_width == 1 and engine.mesh_shape is None


def _co_batch(engine, prompts, steps, join_at, leave_at):
    """A co-batch driven as the decode loop drives it: sequence i joins
    at step ``join_at[i]`` and leaves after ``leave_at[i]`` steps."""
    last, out = {}, {}
    for step in range(steps):
        for i, p in enumerate(prompts):
            if join_at[i] == step:
                sid = f"s{i}"
                last[sid] = engine.prefill(sid, p)
                out[sid] = [last[sid]]
        ids = [s for s in last if len(out[s]) < leave_at[int(s[1:])]]
        for s in [s for s in last if s not in ids]:
            engine.finish(s)
            del last[s]
        if ids:
            nxt = engine.step(ids, [last[s] for s in ids])
            for s, t in zip(ids, nxt):
                last[s] = t
                out[s].append(t)
    for s in list(last):
        engine.finish(s)
    return out


CO_PROMPTS = [[7, 3, 99], list(range(40, 49)), [ord(c) for c in "the cell divides"][:14]]
CO_ARGS = dict(steps=34, join_at=[0, 2, 5], leave_at=[30, 12, 40])


def _program_keys(cache):
    return sorted(k[1:-1] for k in cache.keys())


def test_mixed_co_batch_across_kv_buckets_matches_the_jax_engine():
    """Three prompts of different lengths, one joining mid-batch and one
    leaving early, with block size 8: the batch bucket moves through 4, 2
    and 1 rows and the KV bucket through 8, 16, 32 and 64 entries. Tokens
    equal the JAX engine's; both engines build the same program keys, one
    per (batch bucket, KV bucket) and per prompt bucket; repeating the
    traffic builds nothing."""
    jax_cache, cache = JaxCache(), CompiledProgramCache()
    ref = jax_de.DecodeEngine(model_id="co", cache=jax_cache, kv_block_size=8, kv_blocks=64)
    engine = de.DecodeEngine(
        model_id="co", device="cpu", cache=cache, kv_block_size=8, kv_blocks=64
    )
    want = _co_batch(ref, CO_PROMPTS, **CO_ARGS)
    got = _co_batch(engine, CO_PROMPTS, **CO_ARGS)
    assert got == want
    assert [len(got[s]) for s in ("s0", "s1", "s2")] == [30, 12, 30]
    keys = _program_keys(cache)
    assert keys == _program_keys(jax_cache)
    steps = {k[1:] for k in keys if k[0] == "decode_step"}
    assert {t for _, t in steps} == {8, 16, 32, 64}
    assert {b for b, _ in steps} == {1, 2, 4}
    assert {k[1] for k in keys if k[0] == "decode_prefill"} == {8, 16}
    assert len(keys) == len(set(keys))
    misses = cache.stats.misses
    assert misses == len(keys)
    assert _co_batch(engine, CO_PROMPTS, **CO_ARGS) == want
    assert cache.stats.misses == misses
    assert engine.kv.stats["sequences"] == 0
    assert engine.describe()["programs"] == len(keys)
    engine.close()
    assert len(cache) == 0


def test_warmup_builds_the_jax_engines_first_programs():
    jax_cache, cache = JaxCache(), CompiledProgramCache()
    jax_de.DecodeEngine(model_id="w", cache=jax_cache).warmup(prompt_lens=(16, 40), batches=(1, 3))
    de.DecodeEngine(model_id="w", device="cpu", cache=cache).warmup(
        prompt_lens=(16, 40), batches=(1, 3)
    )
    assert _program_keys(cache) == _program_keys(jax_cache)


def test_engine_records_spans_and_chip_seconds():
    engine = de.DecodeEngine(model_id="traced", device="cpu", cache=CompiledProgramCache())
    ctx = tracing.TraceContext(trace_id=tracing.new_id(), sampled=True, collector=[])
    token = tracing.activate(ctx)
    acc, acc_token = tracing.start_chip_accounting()
    try:
        tok = engine.prefill("t", [1, 2, 3])
        engine.step(["t"], [tok])
    finally:
        tracing.stop_chip_accounting(acc_token)
        tracing.deactivate(token)
    engine.finish("t")
    names = [s["name"] for s in ctx.collector]
    assert names == ["decode.prefill", "decode.step"]
    assert ctx.collector[0]["attrs"]["bucket"] == 16
    assert ctx.collector[1]["attrs"]["batch_bucket"] == 1
    assert acc.seconds > 0


def test_mesh_rejects_unsupported_axes():
    with pytest.raises(ValueError, match="dp"):
        de.DecodeEngine(device="cpu", mesh_axes={"tp": -1})
    with pytest.raises(ValueError, match="dp"):
        de.DecodeEngine(devices=["cpu"] * 2, mesh_axes={"tp": -1})
    with pytest.raises(ValueError, match="not divisible"):
        de.DecodeEngine(device="cpu", mesh_axes={"dp": 2})
    assert de.DecodeEngine(device="cpu", mesh_axes={"dp": -1}).mesh_shape is None
    # a lease of several ids is a dp mesh, as in the JAX engine
    engine = de.DecodeEngine(device="cpu", device_ids=[0, 1], mesh_axes={"dp": -1})
    assert engine.mesh_shape == {"dp": 2} and engine.chip_width == 2 and len(engine.pools) == 2
    assert engine._mesh_key == "dp2" and engine.describe()["device_ids"] == [0, 0]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_golden_tokens_on_dp_meshes(fx, n):
    """``tests/test_decode.py``'s mesh parity: the same model over a dp
    mesh gives the fixture's greedy tokens bit for bit."""
    engine = de.DecodeEngine(model_id=f"golden-dp{n}", devices=["cpu"] * n, mesh_axes={"dp": -1},
                             cache=CompiledProgramCache())
    assert engine.mesh_shape == {"dp": n} and engine.chip_width == n
    assert _engine_greedy(engine, fx["prompt"], 32) == fx["greedy_tokens"].tolist()
    assert engine.kv.stats["sequences"] == 0


def test_dp_co_batch_with_eviction_across_pools_matches_one_device():
    """Eight sequences of mixed prompt lengths over dp = 2 with pools of 6
    blocks of 8: each is pinned to the entry with the most free blocks, the
    steps group rows by entry, idle sequences are evicted inside their
    entry's pool, and every sequence's tokens equal its greedy tokens on
    one device."""
    prompts = [list(range(10 + i, 10 + i + n)) for i, n in enumerate((3, 9, 14, 5, 17, 2, 11, 7))]
    engine = de.DecodeEngine(model_id="co2", devices=["cpu"] * 2, cache=CompiledProgramCache(),
                             kv_block_size=8, kv_blocks=6)
    toks = {f"s{i}": [engine.prefill(f"s{i}", p)] for i, p in enumerate(prompts[:4])}
    assert engine._entry == {"s0": 0, "s1": 1, "s2": 0, "s3": 1}
    for _ in range(6):
        ids = list(toks)
        for sid, t in zip(ids, engine.step(ids, [toks[s][-1] for s in ids])):
            toks[sid].append(t)
    for sid in ids:
        for pool in engine.pools:
            pool.unpin(sid)
    # four more admissions evict idle sequences to make room
    for i, p in enumerate(prompts[4:], start=4):
        toks[f"s{i}"] = [engine.prefill(f"s{i}", p)]
    live = [s for s in toks if engine.kv.has_sequence(s)]
    assert live == ["s0", "s2", "s4", "s5", "s6", "s7"]
    for sid, t in zip(live, engine.step(live, [toks[s][-1] for s in live])):
        toks[sid].append(t)
    stats = engine.kv.stats
    assert stats["evictions"] > 0 and stats["blocks_total"] == 12
    assert engine.describe()["kv"] == stats and len(engine.pools) == 2
    for sid in toks:
        engine.finish(sid)
    assert engine.kv.stats["sequences"] == 0 and engine.kv.stats["blocks_in_use"] == 0
    one = de.DecodeEngine(model_id="co1", device="cpu", cache=CompiledProgramCache(), kv_block_size=8)
    for i, p in enumerate(prompts):
        sid = f"s{i}"
        if sid in live or i >= 4:
            assert toks[sid] == _engine_greedy(one, p, len(toks[sid]), sid), sid


def test_prompt_length_and_tokens_validated():
    engine = de.DecodeEngine(model_id="val", device="cpu", cache=CompiledProgramCache())
    with pytest.raises(ValueError, match="prompt length"):
        engine.prefill("bad", [])
    with pytest.raises(ValueError, match="prompt length"):
        engine.prefill("bad", [1] * 1000)
    with pytest.raises(ValueError, match="prompt tokens"):
        engine.prefill("bad", [1, 256])
    assert len(engine.cache) == 0 and not engine.kv.has_sequence("bad")


def test_generation_past_max_len_clamps_positions_as_jax_does():
    """Past ``max_len`` the JAX gather clamps the position row; the port's
    step clamps too (a device gather would assert)."""
    cfg = de.DecoderConfig(max_len=32)
    ref = jax_de.DecodeEngine(
        config=jax_de.DecoderConfig(max_len=32), cache=JaxCache(), kv_block_size=8
    )
    engine = de.DecodeEngine(config=cfg, device="cpu", cache=CompiledProgramCache(),
                             kv_block_size=8)
    prompt = list(range(60, 90))
    assert _engine_greedy(engine, prompt, 6) == _engine_greedy(ref, prompt, 6)
