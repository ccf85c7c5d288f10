"""The port's DecodeLoop: the ``TestDecodeLoop`` behaviours of
``tests/test_decode.py`` over the same pure-Python backend, and the same
traffic through the JAX loop and the port's with equal tokens, stats,
metrics and flight events.

Steps take a millisecond at most and no test sleeps long: these run
beside the JAX package's timing-bound tests.
"""

import asyncio
import time

import pytest

from bioengine_tpu.serving.decode import DecodeLoop as JaxDecodeLoop
from bioengine_tpu.serving.scheduler import DEFAULT_CLASS_WEIGHTS as JAX_WEIGHTS
from bioengine_tpu.utils import flight as jax_flight
from bioengine_tpu.utils import metrics as jax_metrics
from _torch_parity import few_torch_threads  # noqa: F401
from bioengine_tpu_torch.serving import decode as decode_mod
from bioengine_tpu_torch.serving.decode import DecodeLoop
from bioengine_tpu_torch.serving.scheduler import DEFAULT_CLASS_WEIGHTS
from bioengine_tpu_torch.utils import flight, metrics


class _FakeBackend:
    """Deterministic toy decoder: token i of a sequence is
    ``(sum(prompt) + i) % 97``. Tracks finish() calls so tests can
    assert resource release."""

    chip_width = 2  # exercised by fair-share accounting

    def __init__(self, step_s: float = 0.0):
        self.step_s = step_s
        self.state: dict[str, list[int]] = {}
        self.finished: list[str] = []

    def prefill(self, seq_id, tokens):
        if self.step_s:
            time.sleep(self.step_s)
        base = sum(tokens) % 97
        self.state[seq_id] = [base, 1]
        return base

    def step(self, seq_ids, tokens):
        if self.step_s:
            time.sleep(self.step_s)
        out = []
        for sid in seq_ids:
            base, n = self.state[sid]
            out.append((base + n) % 97)
            self.state[sid][1] += 1
        return out

    def finish(self, seq_id):
        self.state.pop(seq_id, None)
        self.finished.append(seq_id)


def _expected(prompt, n):
    base = sum(prompt) % 97
    return [(base + i) % 97 for i in range(n)]


async def _drain(stream):
    return [t async for t in stream.tokens()]


def test_class_weights_and_env_defaults_match_jax():
    assert DEFAULT_CLASS_WEIGHTS == JAX_WEIGHTS
    assert decode_mod._CLASS_ORDER == ("interactive", "bulk", "background")


@pytest.mark.anyio
class TestDecodeLoop:
    async def test_tokens_are_deterministic_and_complete(self):
        loop = DecodeLoop(_FakeBackend(), name="pt-det", max_active=4)
        try:
            toks = await _drain(loop.submit([1, 2, 3], 8))
            assert toks == _expected([1, 2, 3], 8)
        finally:
            await loop.close()

    async def test_cobatching_occupancy(self):
        """N concurrent streams drain in ~L steps, not N*L, and the
        occupancy window shows the co-batch."""
        be = _FakeBackend()
        loop = DecodeLoop(be, name="pt-occ", max_active=4, interactive_reserve=0)
        try:
            streams = [loop.submit([i], 12, klass="bulk") for i in range(4)]
            results = await asyncio.gather(*(_drain(s) for s in streams))
            for i, toks in enumerate(results):
                assert toks == _expected([i], 12)
            s = loop.stats
            assert s["occupancy"]["max"] == 4
            assert s["steps"] <= 2 * 11
            assert be.finished and len(be.finished) == 4
        finally:
            await loop.close()

    async def test_short_generation_not_blocked_by_long(self):
        """A short sequence submitted while a long one generates joins the
        running batch, finishes and leaves while the long one goes on."""
        be = _FakeBackend(step_s=0.001)
        loop = DecodeLoop(be, name="pt-hol", max_active=4)
        try:
            long_stream = loop.submit([5], 200, klass="bulk")
            long_task = asyncio.ensure_future(_drain(long_stream))
            while loop.stats["tokens"] < 5:
                await asyncio.sleep(0.001)
            short = loop.submit([9], 4, klass="interactive")
            toks = await _drain(short)
            assert toks == _expected([9], 4)
            assert short.joined_mid_batch
            assert not long_task.done()
            assert await long_task == _expected([5], 200)
            assert short.chip_seconds > 0
        finally:
            await loop.close()

    async def test_interactive_reserve_blocks_bulk_admits_interactive(self):
        be = _FakeBackend(step_s=0.001)
        loop = DecodeLoop(be, name="pt-res", max_active=2, interactive_reserve=1)
        try:
            b1 = asyncio.ensure_future(_drain(loop.submit([1], 100, klass="bulk")))
            while loop.stats["tokens"] < 3:
                await asyncio.sleep(0.001)
            b2 = asyncio.ensure_future(_drain(loop.submit([2], 100, klass="bulk")))
            await asyncio.sleep(0.02)
            s = loop.stats
            assert s["active"] == 1 and s["waiting"] == 1  # reserve held
            toks = await _drain(loop.submit([3], 4, klass="interactive"))
            assert toks == _expected([3], 4)
            assert await b1 == _expected([1], 100)
            assert await b2 == _expected([2], 100)
        finally:
            await loop.close()

    async def test_resume_from_emits_exact_suffix(self):
        loop = DecodeLoop(_FakeBackend(), name="pt-res2", max_active=2)
        try:
            full = await _drain(loop.submit([7, 7], 10))
            resumed = await _drain(loop.submit([7, 7], 10, resume_from=6))
            assert resumed == full[6:]
        finally:
            await loop.close()

    async def test_consumer_break_releases_slot_and_backend(self):
        be = _FakeBackend(step_s=0.001)
        loop = DecodeLoop(be, name="pt-cancel", max_active=4)
        try:
            t0 = time.time()
            stream = loop.submit([4], 500, klass="bulk")
            got = 0
            async for _ in stream.tokens():
                got += 1
                if got == 3:
                    break  # generator aclose -> loop.cancel
            for _ in range(200):
                if stream.seq_id in be.finished:
                    break
                await asyncio.sleep(0.005)
            assert stream.seq_id in be.finished
            assert loop.stats["active"] == 0
            leaves = flight.get_events(types=("decode.leave",), since=t0)
            assert any(e["attrs"]["reason"] == "cancelled" for e in leaves)
            assert await _drain(loop.submit([1], 3)) == _expected([1], 3)
        finally:
            await loop.close()

    async def test_backend_failure_fails_the_sequence_not_the_loop(self):
        class Failing(_FakeBackend):
            def prefill(self, seq_id, tokens):
                if tokens == [0]:
                    raise ValueError("bad prompt")
                return super().prefill(seq_id, tokens)

        loop = DecodeLoop(Failing(), name="pt-fail", max_active=2)
        try:
            with pytest.raises(ValueError, match="bad prompt"):
                await _drain(loop.submit([0], 4))
            assert await _drain(loop.submit([2], 4)) == _expected([2], 4)
        finally:
            await loop.close()
        with pytest.raises(RuntimeError, match="closed"):
            loop.submit([1], 1)


async def _traffic(loop_cls, name):
    """One fixed mix: four bulk streams, an interactive one, a resumed
    one and a background one, on a loop of three slots."""
    loop = loop_cls(_FakeBackend(), name=name, max_active=3, interactive_reserve=1)
    try:
        streams = [loop.submit([i, 1], 9, klass="bulk") for i in range(4)]
        streams.append(loop.submit([50], 5, klass="interactive"))
        streams.append(loop.submit([50], 5, klass="interactive", resume_from=2))
        streams.append(loop.submit([8], 6, klass="background"))
        tokens = await asyncio.gather(*(_drain(s) for s in streams))
        return tokens, loop.stats
    finally:
        await loop.close()


@pytest.mark.anyio
async def test_same_traffic_same_tokens_stats_metrics_and_events_as_jax():
    got = {}
    for loop_cls, fmod, mmod, name in (
        (JaxDecodeLoop, jax_flight, jax_metrics, "pt-parity-jax"),
        (DecodeLoop, flight, metrics, "pt-parity-port"),
    ):
        t0 = time.time()
        tokens, stats = await _traffic(loop_cls, name)
        snap = mmod.collect()
        counts = {
            fam: [s["value"] for s in snap[fam]["series"] if s["labels"] == {"loop": name}]
            for fam in ("decode_tokens_total", "decode_steps_total")
        }
        events = [
            (e["type"], {k: v for k, v in e["attrs"].items() if k not in ("waited_ms", "seq")})
            for e in fmod.get_events(types=("decode.join", "decode.leave"), since=t0)
            if e["attrs"]["seq"].startswith(name)
        ]
        got[loop_cls] = (tokens, stats, counts, events)
        assert {"decode_active_sequences", "decode_waiting_sequences",
                "decode_batch_occupancy"} <= set(snap)
    assert got[DecodeLoop] == got[JaxDecodeLoop]
    tokens, stats, counts, events = got[DecodeLoop]
    assert tokens[5] == tokens[4][2:]
    assert counts["decode_tokens_total"] == [stats["tokens"]]
    assert counts["decode_steps_total"] == [stats["steps"]]
    assert sum(1 for t, _ in events if t == "decode.join") == 7


def test_env_knobs_are_read_once(monkeypatch):
    monkeypatch.setattr(decode_mod, "_ENV", None)
    monkeypatch.setenv("BIOENGINE_DECODE_MAX_ACTIVE", "3")
    monkeypatch.setenv("BIOENGINE_DECODE_STEP_IDLE_MS", "2")
    assert decode_mod._env() == (3, 0.002)
    loop = DecodeLoop(_FakeBackend(), name="pt-env")
    assert loop.max_active == 3 and loop.idle_wait_s == 0.002
    assert loop.interactive_reserve == 1
