"""Step-level continuous batching for token generation.

Own copy of ``bioengine_tpu/serving/decode.py``. The running batch is
re-formed between every decode step: a finished sequence leaves at once
and a waiting one joins the next step without waiting for the batch to
drain, so a short generation is never chained to a long one. Admission
uses weighted classes (``scheduler.DEFAULT_CLASS_WEIGHTS``), EDF within
a class and deterministic tie-breaks, with ``interactive_reserve`` slots
kept for the interactive class.

The loop drives a pluggable backend (``prefill(seq_id, tokens)`` /
``step(seq_ids, tokens)`` / ``finish(seq_id)``) through
``asyncio.to_thread``: the ``generate`` app plugs a
:class:`~bioengine_tpu_torch.runtime.decode_engine.DecodeEngine`, which
makes its CUDA device current on whichever worker thread calls it; tests
plug a pure-python deterministic decoder.

Chip-seconds are attributed fair-share: a step's ``wall x width`` cost
splits evenly over the sequences in that step, accumulated per sequence;
the consumer books the total into the request's accounting.

Env knobs: ``BIOENGINE_DECODE_MAX_ACTIVE`` caps the running batch
(default 8), ``BIOENGINE_DECODE_STEP_IDLE_MS`` is the idle wait when
no sequence is active (default 5).
"""

from __future__ import annotations

import asyncio
import heapq
import os
import time
from collections import deque
from typing import Any, Optional, Sequence

from bioengine_tpu_torch.serving.scheduler import DEFAULT_CLASS_WEIGHTS
from bioengine_tpu_torch.utils import flight, metrics
from bioengine_tpu_torch.utils.logger import create_logger

_ENV: Optional[tuple[int, float]] = None


def _env() -> tuple[int, float]:
    global _ENV
    if _ENV is None:
        _ENV = (
            int(os.environ.get("BIOENGINE_DECODE_MAX_ACTIVE", "8")),
            float(os.environ.get("BIOENGINE_DECODE_STEP_IDLE_MS", "5")) / 1000.0,
        )
    return _ENV


DECODE_TOKENS = metrics.counter(
    "decode_tokens_total",
    "tokens generated by decode loops (provider side)",
    ("loop",),
)
DECODE_STEPS = metrics.counter(
    "decode_steps_total",
    "decode steps executed (one batched forward each)",
    ("loop",),
)


def _collect_decode_loops(instances: list) -> list:
    """Occupancy is THE efficiency number of continuous batching: mean
    sequences per step over the recent window. 1.0 on a busy loop means
    co-batching is broken; max_active means the admission cap binds."""
    out: list[metrics.Sample] = []
    active = waiting = 0
    occ_sum = 0.0
    occ_n = 0
    for lp in instances:
        s = lp.stats
        active += s["active"]
        waiting += s["waiting"]
        occ_sum += s["occupancy"]["sum"]
        occ_n += s["occupancy"]["count"]
    out.append(
        metrics.Sample(
            "decode_active_sequences", active,
            help="sequences currently in running decode batches",
        )
    )
    out.append(
        metrics.Sample(
            "decode_waiting_sequences", waiting,
            help="sequences queued for admission into a decode batch",
        )
    )
    out.append(
        metrics.Sample(
            "decode_batch_occupancy", occ_sum / occ_n if occ_n else 0.0,
            help="mean sequences per decode step (recent window)",
        )
    )
    return out


_DECODE_LOOPS = metrics.InstanceSet("decode_loop", _collect_decode_loops)

# fixed class order is the credit tie-break, most latency-sensitive
# first — identical contract to the request-level scheduler
_CLASS_ORDER = ("interactive", "bulk", "background")


class _Seq:
    """One generating sequence's loop-side state."""

    __slots__ = (
        "seq_id", "prompt", "max_new", "klass", "deadline", "enqueued",
        "queue", "last_token", "emitted", "generated", "resume_from",
        "chip_seconds", "cancelled", "joined_mid_batch",
    )

    def __init__(self, seq_id, prompt, max_new, klass, deadline, resume_from):
        self.seq_id = seq_id
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.klass = klass
        self.deadline = deadline
        self.enqueued = time.monotonic()
        self.queue: asyncio.Queue = asyncio.Queue()
        self.last_token: Optional[int] = None
        self.emitted = 0          # tokens delivered to the consumer
        self.generated = 0        # tokens produced (>= emitted on resume)
        self.resume_from = int(resume_from)
        self.chip_seconds = 0.0
        self.cancelled = False
        self.joined_mid_batch = False


class DecodeStream:
    """Consumer handle for one submitted sequence: async-iterate
    ``tokens()``; ``chip_seconds`` holds the fair-share device cost
    once the stream closes (the app books it into request accounting)."""

    def __init__(self, loop: "DecodeLoop", seq: _Seq):
        self._loop = loop
        self._seq = seq
        self.seq_id = seq.seq_id

    @property
    def chip_seconds(self) -> float:
        return self._seq.chip_seconds

    @property
    def joined_mid_batch(self) -> bool:
        return self._seq.joined_mid_batch

    async def tokens(self):
        try:
            while True:
                item = await self._seq.queue.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # consumer went away (disconnect, break, error): release
            # the sequence's batch slot and KV blocks promptly
            self._loop.cancel(self.seq_id)


class DecodeLoop:
    """Token-level continuous batcher over a decode backend.

    One asyncio task re-forms the running batch every step: admit
    waiting sequences into free slots (weighted class credits + EDF
    within the class), run one batched ``backend.step``, emit a token
    per sequence, retire finished ones. ``interactive_reserve`` slots
    are admission-restricted to the interactive class so a burst of
    long bulk generations can never occupy the whole batch.
    """

    def __init__(
        self,
        backend: Any,
        name: str = "decode",
        max_active: Optional[int] = None,
        interactive_reserve: int = 1,
        class_weights: Optional[dict[str, float]] = None,
    ):
        env_active, env_idle = _env()
        self.backend = backend
        self.name = name
        self.max_active = int(max_active if max_active is not None else env_active)
        self.interactive_reserve = min(int(interactive_reserve), self.max_active - 1)
        self.idle_wait_s = env_idle
        self.weights = dict(class_weights or DEFAULT_CLASS_WEIGHTS)
        self._credit: dict[str, float] = {c: 0.0 for c in _CLASS_ORDER}
        self._waiting: dict[str, list] = {c: [] for c in _CLASS_ORDER}
        self._active: dict[str, _Seq] = {}
        self._seq_no = 0
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._closing = False
        self._occupancy: deque = deque(maxlen=1024)
        self._steps = 0
        self._tokens = 0
        self._joins = 0
        self._leaves = 0
        self._m_tokens = DECODE_TOKENS.labels(name)
        self._m_steps = DECODE_STEPS.labels(name)
        self._logger = create_logger(f"decode.{name}", log_file="off")
        self._width = float(getattr(backend, "chip_width", 1) or 1)
        _DECODE_LOOPS.add(self)

    # ---- submission ---------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        klass: str = "interactive",
        deadline_s: Optional[float] = None,
        seq_id: Optional[str] = None,
        resume_from: int = 0,
    ) -> DecodeStream:
        """Queue a sequence for admission; returns its stream handle.

        ``resume_from`` replays a resumed idempotent stream: the first
        N tokens regenerate (greedy decoding is deterministic) but are
        not re-emitted, so a failed-over consumer sees exactly the
        suffix it is missing."""
        if self._closing:
            raise RuntimeError(f"decode loop '{self.name}' is closed")
        if klass not in self._waiting:
            klass = "background"
        self._seq_no += 1
        seq = _Seq(
            seq_id or f"{self.name}-{self._seq_no}",
            prompt,
            max_new_tokens,
            klass,
            time.monotonic() + deadline_s if deadline_s else float("inf"),
            resume_from,
        )
        heapq.heappush(self._waiting[klass], (seq.deadline, self._seq_no, seq))
        self._wake.set()
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name=f"decode-loop-{self.name}"
            )
        return DecodeStream(self, seq)

    def cancel(self, seq_id: str) -> None:
        """Drop a sequence (consumer gone). Active sequences leave at
        the next step boundary; waiting ones are lazily skipped at
        admission."""
        seq = self._active.get(seq_id)
        if seq is not None:
            seq.cancelled = True
            return
        for q in self._waiting.values():
            for _, _, s in q:
                if s.seq_id == seq_id:
                    s.cancelled = True

    async def close(self) -> None:
        self._closing = True
        self._wake.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            except Exception as e:
                self._logger.warning(
                    "decode loop %s exited with %s during close: %s",
                    self.name,
                    type(e).__name__,
                    e,
                )
        for sid, seq in list(self._active.items()):
            self.backend.finish(sid)
            seq.queue.put_nowait(None)
        self._active.clear()
        for q in self._waiting.values():
            for _, _, s in q:
                s.queue.put_nowait(None)
            q.clear()

    # ---- admission ----------------------------------------------------------

    def _waiting_count(self) -> int:
        return sum(len(q) for q in self._waiting.values())

    def _pick_class(self, reserved_only: bool) -> Optional[str]:
        """Weighted-credit pick with the fixed class order as
        tie-break; ``reserved_only`` restricts to interactive (the
        reserve slots exist so bulk bursts can't starve it)."""
        ready = [
            c for c in (_CLASS_ORDER[:1] if reserved_only else _CLASS_ORDER)
            if self._waiting[c]
        ]
        if not ready:
            return None
        for c in ready:
            self._credit[c] += self.weights.get(c, 1.0)
        best = max(ready, key=lambda c: (self._credit[c], -_CLASS_ORDER.index(c)))
        self._credit[best] = 0.0
        return best

    def _pop_waiting(self, klass: str) -> Optional[_Seq]:
        q = self._waiting[klass]
        while q:
            _, _, seq = heapq.heappop(q)
            if not seq.cancelled:
                return seq
        return None

    async def _admit_one(self) -> bool:
        free = self.max_active - len(self._active)
        if free <= 0:
            return False
        non_interactive = sum(
            1 for s in self._active.values() if s.klass != "interactive"
        )
        # only interactive may take the last `reserve` slots while
        # non-interactive work holds the rest
        reserved_only = (
            free <= self.interactive_reserve
            and non_interactive > 0
        )
        klass = self._pick_class(reserved_only)
        if klass is None:
            return False
        seq = self._pop_waiting(klass)
        if seq is None:
            return False
        # "mid-batch" = others were already generating when this one was
        # admitted; computed at admission time because prefill awaits can
        # interleave with new submissions.
        batch_running = any(
            s.generated > 0 for s in self._active.values()
        )
        t0 = time.monotonic()
        try:
            first = await asyncio.to_thread(
                self.backend.prefill, seq.seq_id, seq.prompt
            )
        except Exception as e:  # noqa: BLE001 — admission failure is per-seq
            seq.queue.put_nowait(e)
            return True
        seq.chip_seconds += (time.monotonic() - t0) * self._width
        seq.joined_mid_batch = batch_running
        self._active[seq.seq_id] = seq
        self._joins += 1
        flight.record(
            "decode.join",
            seq=seq.seq_id,
            klass=seq.klass,
            batch=len(self._active),
            mid_batch=batch_running,
            waited_ms=round((t0 - seq.enqueued) * 1000.0, 3),
        )
        self._emit(seq, first)
        return True

    def _emit(self, seq: _Seq, token: int) -> None:
        seq.last_token = token
        seq.generated += 1
        self._tokens += 1
        self._m_tokens.inc()
        if seq.generated > seq.resume_from:
            seq.emitted += 1
            seq.queue.put_nowait(token)

    def _retire(self, seq: _Seq, reason: str) -> None:
        self._active.pop(seq.seq_id, None)
        self.backend.finish(seq.seq_id)
        self._leaves += 1
        flight.record(
            "decode.leave",
            seq=seq.seq_id,
            klass=seq.klass,
            reason=reason,
            generated=seq.generated,
            batch=len(self._active),
        )
        seq.queue.put_nowait(None)

    # ---- the loop -----------------------------------------------------------

    async def _run(self) -> None:
        while not self._closing:
            while await self._admit_one():
                pass
            if not self._active:
                # idle: block until a submission wakes us
                self._wake.clear()
                if self._waiting_count() == 0:
                    try:
                        await asyncio.wait_for(self._wake.wait(), 30.0)
                    except asyncio.TimeoutError:
                        continue
                else:
                    await asyncio.sleep(self.idle_wait_s)
                continue
            seqs = [
                s for s in self._active.values() if not s.cancelled
            ]
            for s in list(self._active.values()):
                if s.cancelled:
                    self._retire(s, "cancelled")
            if not seqs:
                continue
            ids = [s.seq_id for s in seqs]
            toks = [s.last_token for s in seqs]
            t0 = time.monotonic()
            try:
                nxt = await asyncio.to_thread(self.backend.step, ids, toks)
            except Exception as e:  # noqa: BLE001 — one bad step fails the batch members, not the loop
                for s in seqs:
                    self._active.pop(s.seq_id, None)
                    self.backend.finish(s.seq_id)
                    s.queue.put_nowait(e)
                continue
            share = (time.monotonic() - t0) * self._width / len(seqs)
            self._steps += 1
            self._m_steps.inc()
            self._occupancy.append(len(seqs))
            for s, tok in zip(seqs, nxt):
                s.chip_seconds += share
                self._emit(s, tok)
                if s.generated >= s.max_new:
                    self._retire(s, "complete")
            # yield so consumers drain queues between steps (to_thread
            # already yields, but a fast pure-python backend can starve
            # emission otherwise)
            await asyncio.sleep(0)

    # ---- observability ------------------------------------------------------

    @property
    def stats(self) -> dict:
        occ = list(self._occupancy)
        return {
            "active": len(self._active),
            "waiting": self._waiting_count(),
            "max_active": self.max_active,
            "steps": self._steps,
            "tokens": self._tokens,
            "joins": self._joins,
            "leaves": self._leaves,
            "occupancy": {
                "count": len(occ),
                "sum": float(sum(occ)),
                "mean": (sum(occ) / len(occ)) if occ else 0.0,
                "max": max(occ) if occ else 0,
            },
        }
