"""Streaming generation over the decode engine.

Counterpart of ``apps/generate/generate_deployment.py``:
``generate_stream`` is an async generator over a
:class:`~bioengine_tpu_torch.serving.decode.DecodeLoop` (step-level
continuous batching) driving a
:class:`~bioengine_tpu_torch.runtime.decode_engine.DecodeEngine`, one
``{"token", "text", "index"}`` item per generated token. Greedy decoding
keeps it deterministic, which mid-stream resume (``resume_from``) relies
on.

As in the JAX app, ``generate`` and ``describe_engine`` are
``@schema_method``s, which the worker publishes on the app's service
(WebSocket, HTTP bridge, MCP); ``generate_stream`` is not one: callers
reach the stream through the deployment's handle
(``DeploymentHandle.call_stream``). Differences from the JAX app (ROADMAP,
slices 7 and 15): the deployment takes ``device`` (``cuda`` unless
``device="cpu"``); a multi-device lease builds a dp engine whose entries
each hold a replica and a KV pool, a sequence pinned to one of them.
"""

import asyncio
import os

from bioengine_tpu_torch.rpc import schema_method
from bioengine_tpu_torch.utils import tracing


def encode(text: str) -> list:
    """Char-level tokenization into the toy decoder's 256-way vocab."""
    return [ord(c) % 256 for c in text]


def decode(tokens) -> str:
    return "".join(chr(int(t) % 256) for t in tokens)


class GenerateDeployment:
    def __init__(self, max_active: int = None, interactive_reserve: int = 1, device=None):
        self.max_active = max_active
        self.interactive_reserve = interactive_reserve
        self.device = device
        self.engine = None
        self.loop = None
        self.ready = False

    async def async_init(self):
        from bioengine_tpu_torch.runtime.decode_engine import DecodeEngine
        from bioengine_tpu_torch.serving.decode import DecodeLoop

        lease = list(getattr(self, "bioengine_device_ids", None) or [])
        shard = getattr(self, "bioengine_mesh_shard", None)
        axes = None
        if shard and shard.get("axes"):
            axes = dict(shard["axes"])
        elif len(lease) > 1:
            # multi-device lease without an explicit mesh block still
            # shards the step batch — dp is the only decoder axis
            axes = {"dp": -1}

        def build():
            eng = DecodeEngine(
                device=self.device,
                device_ids=lease or None,
                mesh_axes=axes,
                seed=int(os.environ.get("BIOENGINE_GENERATE_SEED", "0")),
            )
            eng.warmup(prompt_lens=(16,), batches=(1,))
            return eng

        self.engine = await asyncio.to_thread(build)
        self.loop = DecodeLoop(
            self.engine,
            name="generate",
            max_active=self.max_active,
            interactive_reserve=self.interactive_reserve,
        )
        self.ready = True

    async def test_deployment(self):
        out = await self.generate(prompt="hello", max_new_tokens=4)
        if len(out["tokens"]) != 4:
            raise RuntimeError(f"expected 4 tokens, got {out}")

    async def check_health(self):
        if not self.ready:
            raise RuntimeError("decode engine not initialized")

    async def close(self):
        if self.loop is not None:
            await self.loop.close()
        if self.engine is not None:
            self.engine.close()

    # ---- streaming entry ----------------------------------------------------

    async def generate_stream(
        self,
        prompt: str,
        max_new_tokens: int = 64,
        klass: str = "interactive",
        deadline_s=None,
        resume_from: int = 0,
        seq_id=None,
        context=None,
    ):
        """Async generator: one ``{"token", "text", "index"}`` item per
        generated token. ``resume_from`` makes a resumed stream emit
        exactly the missing suffix (greedy decoding regenerates the
        prefix deterministically without re-sending it)."""
        stream = self.loop.submit(
            encode(prompt),
            max_new_tokens,
            klass=klass,
            deadline_s=deadline_s,
            seq_id=seq_id,
            resume_from=int(resume_from or 0),
        )
        booked = 0.0
        index = int(resume_from or 0)
        try:
            async for tok in stream.tokens():
                # book the fair-share device cost as it accrues, so a
                # mid-stream disconnect is accounted too
                delta = stream.chip_seconds - booked
                if delta > 0:
                    tracing.add_chip_seconds(delta)
                    booked += delta
                yield {
                    "token": int(tok),
                    "text": chr(int(tok) % 256),
                    "index": index,
                }
                index += 1
        finally:
            delta = stream.chip_seconds - booked
            if delta > 0:
                tracing.add_chip_seconds(delta)

    # ---- unary surface -------------------------------------------------------

    @schema_method
    async def generate(
        self,
        prompt: str,
        max_new_tokens: int = 64,
        klass: str = "interactive",
        context=None,
    ):
        """Drain a full generation and return it in one response."""
        tokens = []
        async for item in self.generate_stream(
            prompt, max_new_tokens=max_new_tokens, klass=klass
        ):
            tokens.append(item["token"])
        return {"prompt": prompt, "tokens": tokens, "text": decode(tokens)}

    @schema_method
    async def describe_engine(self, context=None):
        """Engine placement + KV cache + decode-loop occupancy stats."""
        return {
            "engine": self.engine.describe() if self.engine else None,
            "loop": self.loop.stats if self.loop else None,
        }
