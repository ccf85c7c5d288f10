"""Decode-capable engine: bucketed prefill + single-token decode steps.

Counterpart of ``bioengine_tpu/runtime/decode_engine.py``. A *prefill*
over the prompt builds per-layer KV state, then a loop of batched
single-token *steps* extends it:

- **Programs build once per bucket.** Prompt lengths bucket on a
  block-size ladder, decode-step programs key on ``(batch bucket,
  KV-length bucket)``, and both live in the shared
  ``CompiledProgramCache`` under the JAX engine's keys. On the card a
  program is a CUDA graph over fixed buffers: its inputs (tokens,
  lengths and, for a step, the block table) are packed into one int64
  buffer, filled by one host-to-device copy per call, and a repeated
  shape builds nothing new. On the CPU a program runs the same functions
  eagerly.
- **KV state is paged, on the device.** Per-sequence KV lives in a
  :class:`~bioengine_tpu_torch.runtime.kv_cache.PagedKVCache` pool on the
  engine's device. A step's graph reads the pool through the block table
  (no host gather, no K/V upload), and the co-batch's new entries go
  back in one indexed write per pool.
- **Precision.** The forward runs in f32 with TF32 off
  (``torch_runner.full_f32``); a graph keeps the kernels chosen at
  capture, so it stays full f32 whatever the process sets later.
- **Greedy on the host.** Logits come back to the host and the argmax is
  numpy's (first index on ties), as in the JAX engine.

The bundled model is the deterministic seeded character-level
transformer (vocab = 256 bytes) of the JAX package: pre-LN attention +
MLP with tanh GELU, LayerNorm eps 1e-5, weight-tied logits. One device:
a lease of several ids raises ``NotImplementedError`` (ROADMAP A10).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bioengine_tpu_torch.runtime.buckets import bucket_batch, bucket_dim
from bioengine_tpu_torch.runtime.devices import (
    DeviceLike,
    mesh_cache_tag,
    resolve_devices,
)
from bioengine_tpu_torch.runtime.engine import GRAPH_WARMUP_ITERS
from bioengine_tpu_torch.runtime.kv_cache import PagedKVCache, gather_blocks
from bioengine_tpu_torch.runtime.program_cache import (
    CompiledProgramCache,
    default_program_cache,
)
from bioengine_tpu_torch.runtime.torch_runner import full_f32
from bioengine_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Char-level decoder hyperparameters (the JAX package's defaults)."""

    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 128
    max_len: int = 512

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_decoder_params(seed: int = 0, config: DecoderConfig = DecoderConfig()) -> dict:
    """Deterministic seeded init in the JAX package's layout (numpy,
    ``h @ W``): the same draws in the same order as the JAX engine and
    the golden fixture's generator, so all three agree bit for bit."""
    rng = np.random.default_rng(seed)
    c = config

    def w(*shape, scale):
        return rng.normal(0.0, scale, size=shape).astype(np.float32)

    params: dict[str, Any] = {
        "tok_emb": w(c.vocab, c.d_model, scale=0.02),
        "pos_emb": w(c.max_len, c.d_model, scale=0.02),
        "ln_f_g": np.ones((c.d_model,), np.float32),
        "ln_f_b": np.zeros((c.d_model,), np.float32),
        "layers": [],
    }
    for _ in range(c.n_layers):
        params["layers"].append(
            {
                "ln1_g": np.ones((c.d_model,), np.float32),
                "ln1_b": np.zeros((c.d_model,), np.float32),
                "wq": w(c.d_model, c.d_model, scale=c.d_model**-0.5),
                "wk": w(c.d_model, c.d_model, scale=c.d_model**-0.5),
                "wv": w(c.d_model, c.d_model, scale=c.d_model**-0.5),
                "wo": w(c.d_model, c.d_model, scale=c.d_model**-0.5),
                "ln2_g": np.ones((c.d_model,), np.float32),
                "ln2_b": np.zeros((c.d_model,), np.float32),
                "w1": w(c.d_model, c.d_ff, scale=c.d_model**-0.5),
                "b1": np.zeros((c.d_ff,), np.float32),
                "w2": w(c.d_ff, c.d_model, scale=c.d_ff**-0.5),
                "b2": np.zeros((c.d_model,), np.float32),
            }
        )
    return params


class DecoderLayer(nn.Module):
    """Pre-LN attention + MLP block. Projections are bias-free
    ``nn.Linear``; the MLP biases are their own parameters, added after
    the product as the JAX block adds them."""

    def __init__(self, c: DecoderConfig):
        super().__init__()
        d = c.d_model
        self.ln1_g = nn.Parameter(torch.ones(d))
        self.ln1_b = nn.Parameter(torch.zeros(d))
        self.wq = nn.Linear(d, d, bias=False)
        self.wk = nn.Linear(d, d, bias=False)
        self.wv = nn.Linear(d, d, bias=False)
        self.wo = nn.Linear(d, d, bias=False)
        self.ln2_g = nn.Parameter(torch.ones(d))
        self.ln2_b = nn.Parameter(torch.zeros(d))
        self.w1 = nn.Linear(d, c.d_ff, bias=False)
        self.b1 = nn.Parameter(torch.zeros(c.d_ff))
        self.w2 = nn.Linear(c.d_ff, d, bias=False)
        self.b2 = nn.Parameter(torch.zeros(d))


class Decoder(nn.Module):
    """The char-level decoder's weights; the forward is
    :func:`decoder_prefill` and :func:`decoder_step`."""

    def __init__(self, config: DecoderConfig = DecoderConfig()):
        super().__init__()
        self.config = config
        self.tok_emb = nn.Parameter(torch.zeros(config.vocab, config.d_model))
        self.pos_emb = nn.Parameter(torch.zeros(config.max_len, config.d_model))
        self.ln_f_g = nn.Parameter(torch.ones(config.d_model))
        self.ln_f_b = nn.Parameter(torch.zeros(config.d_model))
        self.layers = nn.ModuleList(DecoderLayer(config) for _ in range(config.n_layers))


_TRANSPOSED = ("wq", "wk", "wv", "wo", "w1", "w2")


def decoder_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX params dict (numpy, ``init_decoder_params``'s layout) as a
    :class:`Decoder` state dict. The JAX forward computes ``h @ W`` with
    ``W`` ``[in, out]``; ``nn.Linear`` holds ``[out, in]``, so the six
    projections are transposed and everything else is copied as is."""
    out = {
        name: torch.from_numpy(np.asarray(params[name], np.float32).copy())
        for name in ("tok_emb", "pos_emb", "ln_f_g", "ln_f_b")
    }
    for i, layer in enumerate(params["layers"]):
        for name, arr in layer.items():
            arr = np.asarray(arr, np.float32)
            if name in _TRANSPOSED:
                out[f"layers.{i}.{name}.weight"] = torch.from_numpy(arr.T.copy())
            else:
                out[f"layers.{i}.{name}"] = torch.from_numpy(arr.copy())
    return out


def _ln(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * g + b


def _mlp(x, layer: DecoderLayer):
    h = _ln(x, layer.ln2_g, layer.ln2_b)
    return x + layer.w2(F.gelu(layer.w1(h) + layer.b1, approximate="tanh")) + layer.b2


def decoder_prefill(model: Decoder, tokens: torch.Tensor, length: torch.Tensor):
    """Full-prefix forward for ONE sequence, padded to a length bucket.

    ``tokens``: int ``[T_pad]``; ``length``: 0-d int tensor (true prompt
    length). Returns ``(logits, K, V)``: logits ``[vocab]`` at the last
    real position, K/V ``[n_layers, T_pad, n_heads, head_dim]`` (entries
    past ``length`` are garbage; the caller crops). No host sync, so a
    CUDA graph can capture it."""
    c = model.config
    T = tokens.shape[0]
    pos = torch.arange(T, device=tokens.device)
    x = model.tok_emb[tokens] + model.pos_emb[:T]
    # causal AND padding mask: query q attends key k iff k <= q < length.
    # Additive -1e30, not -inf: rows past length stay finite garbage
    causal = pos[None, :] <= pos[:, None]
    valid = pos[None, :] < length
    mask = torch.where(causal & valid, 0.0, -1e30)
    ks, vs = [], []
    for layer in model.layers:
        h = _ln(x, layer.ln1_g, layer.ln1_b)
        q = layer.wq(h).reshape(T, c.n_heads, c.head_dim)
        k = layer.wk(h).reshape(T, c.n_heads, c.head_dim)
        v = layer.wv(h).reshape(T, c.n_heads, c.head_dim)
        scores = torch.einsum("qhd,khd->hqk", q, k) * (c.head_dim**-0.5)
        attn = torch.softmax(scores + mask[None], dim=-1)
        out = torch.einsum("hqk,khd->qhd", attn, v).reshape(T, c.d_model)
        x = x + layer.wo(out)
        x = _mlp(x, layer)
        ks.append(k)
        vs.append(v)
    x = _ln(x, model.ln_f_g, model.ln_f_b)
    last = x.index_select(0, (length - 1).reshape(1))[0]
    logits = last @ model.tok_emb.T
    return logits, torch.stack(ks), torch.stack(vs)


def decoder_step(model: Decoder, tokens, positions, K, V, lengths):
    """One decode step for a padded batch of sequences.

    ``tokens``/``positions``/``lengths``: int ``[B]`` (position == tokens
    already cached == where this token sits); ``K``/``V``: ``[n_layers,
    B, T_pad, n_heads, head_dim]`` cached state, or anything whose
    ``[li]`` gives layer ``li``'s ``[B, T_pad, n_heads, head_dim]`` and
    whose ``shape`` is that (the engine reads the paged pool so). Rows
    past ``lengths[b]`` are masked out. Returns ``(logits, k_new,
    v_new)``: logits ``[B, vocab]``, k_new/v_new ``[n_layers, B,
    n_heads, head_dim]``, the KV of THIS token, which the caller
    appends."""
    c = model.config
    B, T = tokens.shape[0], K.shape[2]
    x = model.tok_emb[tokens] + model.pos_emb[positions]
    key_pos = torch.arange(T, device=tokens.device)
    mask = torch.where(key_pos[None, :] < lengths[:, None], 0.0, -1e30)
    scale = c.head_dim**-0.5
    k_news, v_news = [], []
    for li, layer in enumerate(model.layers):
        h = _ln(x, layer.ln1_g, layer.ln1_b)
        q = layer.wq(h).reshape(B, c.n_heads, c.head_dim)
        k_new = layer.wk(h).reshape(B, c.n_heads, c.head_dim)
        v_new = layer.wv(h).reshape(B, c.n_heads, c.head_dim)
        # cached keys, then this token's own key (it sits at position
        # lengths[b], past the cache): a pad row (length 0) attends to
        # itself only
        scores = torch.einsum("bhd,bthd->bht", q, K[li]) * scale + mask[:, None, :]
        self_score = (q * k_new).sum(-1, keepdim=True) * scale
        attn = torch.softmax(torch.cat([scores, self_score], dim=-1), dim=-1)
        out = (
            torch.einsum("bht,bthd->bhd", attn[:, :, :T], V[li])
            + attn[:, :, T:] * v_new
        ).reshape(B, c.d_model)
        x = x + layer.wo(out)
        x = _mlp(x, layer)
        k_news.append(k_new)
        v_news.append(v_new)
    x = _ln(x, model.ln_f_g, model.ln_f_b)
    logits = x @ model.tok_emb.T
    return logits, torch.stack(k_news), torch.stack(v_news)


class _PagedLayers:
    """A co-batch's K or V read from the pool through a block table, one
    layer at a time: ``[li]`` -> ``[B, T_pad, n_heads, head_dim]``, zero
    past each row's length (``kv_cache.gather_blocks``)."""

    def __init__(self, pool: torch.Tensor, table: torch.Tensor, lengths: torch.Tensor):
        self.pool, self.table, self.lengths = pool, table, lengths
        L, _, bs, heads, dim = pool.shape
        self.shape = (L, table.shape[0], table.shape[1] * bs, heads, dim)

    def __getitem__(self, li: int) -> torch.Tensor:
        return gather_blocks(self.pool[li], self.table, self.lengths)


class _Program:
    """One bucket's program over fixed inputs.

    ``layout`` names the int64 inputs and their shapes; they are views of
    one device buffer, filled from one (pinned, on the card) host buffer
    by a single copy per call, and hold ``init`` (else zeros) while the
    program is built. ``fn(**inputs)`` returns the outputs. On
    the card the program is a CUDA graph captured over those views (after
    warm-up on a side stream), and a call replays it and returns its
    static outputs, valid until the next call; on the CPU a call runs
    ``fn`` eagerly."""

    def __init__(
        self,
        device: torch.device,
        layout: dict[str, tuple],
        fn: Callable,
        init: Optional[Mapping[str, int]] = None,
    ):
        sizes = {name: math.prod(shape) for name, shape in layout.items()}
        total = sum(sizes.values())
        self.fn = fn
        self.device = device
        on_card = device.type == "cuda"
        self._host = torch.zeros(total, dtype=torch.int64, pin_memory=on_card)
        self._dev = torch.zeros(total, dtype=torch.int64, device=device)
        host_np = self._host.numpy()
        self.host_inputs: dict[str, np.ndarray] = {}
        self.inputs: dict[str, torch.Tensor] = {}
        at = 0
        for name, shape in layout.items():
            n = sizes[name]
            self.host_inputs[name] = host_np[at : at + n].reshape(shape)
            self.inputs[name] = self._dev[at : at + n].view(shape)
            at += n
        for name, value in (init or {}).items():
            self.host_inputs[name][...] = value
        self._dev.copy_(self._host)
        self.graph = None
        self.outputs = None
        if on_card:
            self._capture()

    def _capture(self) -> None:
        dev = self.device
        with torch.cuda.device(dev), torch.no_grad(), full_f32():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUP_ITERS):
                    self.fn(**self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # thread_local: other threads may use CUDA while this one
            # captures (the loop's worker threads, another engine)
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.outputs = self.fn(**self.inputs)
            torch.cuda.synchronize(dev)
        self.graph = graph

    def __call__(self, **arrays: np.ndarray):
        for name, arr in arrays.items():
            self.host_inputs[name][...] = arr
        self._dev.copy_(self._host, non_blocking=True)
        if self.graph is not None:
            self.graph.replay()
            return self.outputs
        with torch.no_grad(), full_f32():
            return self.fn(**self.inputs)


def _mesh_sizes(axes: Mapping[str, int], n_devices: int) -> dict[str, int]:
    """Axis sizes of a mesh spec over ``n_devices`` (``-1`` = fill), with
    the JAX ``MeshSpec.resolve`` errors."""
    sizes = dict(axes)
    fill = [k for k, v in sizes.items() if v == -1]
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if n_devices % fixed:
        raise ValueError(f"{n_devices} devices not divisible by fixed axes {sizes}")
    if not fill:
        if fixed != n_devices:
            raise ValueError(f"Mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes
    if len(fill) > 1:
        raise ValueError("At most one axis may be -1")
    sizes[fill[0]] = n_devices // fixed
    return sizes


class DecodeEngine:
    """Prefill + step execution on one device.

    Serving glue (``serving/decode.py`` DecodeLoop) drives three calls:
    ``prefill(seq_id, tokens)`` admits a sequence and returns its first
    generated token, ``step(seq_ids, tokens)`` advances a co-batch one
    token, ``finish(seq_id)`` releases KV blocks. All greedy (argmax):
    determinism is what makes mid-stream resume exact and the golden
    fixture bit-exact. Entry point: runs on ``cuda`` unless given
    ``device="cpu"``.
    """

    def __init__(
        self,
        model_id: str = "toy-chargen",
        params: Optional[dict] = None,
        config: DecoderConfig = DecoderConfig(),
        seed: int = 0,
        cache: Optional[CompiledProgramCache] = None,
        device: DeviceLike = None,
        device_ids: Optional[Sequence[int]] = None,
        mesh_axes: Optional[Mapping[str, int]] = None,
        kv_blocks: Optional[int] = None,
        kv_block_size: Optional[int] = None,
    ):
        self.model_id = model_id
        self.config = config
        self.cache = cache if cache is not None else default_program_cache
        self.devices = resolve_devices(device_ids, device)
        if mesh_axes is not None:
            unknown = sorted(set(_mesh_sizes(mesh_axes, len(self.devices))) - {"dp"})
            if unknown:
                # the decoder carries no tp sharding rules; a silent
                # replicate would claim a tp axis it doesn't have
                raise ValueError(
                    f"mesh_axes names unsupported decoder axes {unknown} "
                    "(DecodeEngine shards the step batch over 'dp' only)"
                )
        self.dp = len(self.devices)
        self.device = self.devices[0]
        host_params = params if params is not None else init_decoder_params(seed, config)
        model = Decoder(config)
        model.load_state_dict(decoder_state_dict(host_params))
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.kv = PagedKVCache(
            config.n_layers,
            config.n_heads,
            config.head_dim,
            num_blocks=kv_blocks,
            block_size=kv_block_size,
            device=self.device,
        )
        bs = self.kv.block_size
        # KV-length ladder: block-size multiples doubling up to max_len
        # — bounded program count, and every bucket is whole blocks
        ladder = []
        b = bs
        while b < config.max_len:
            ladder.append(b)
            b *= 2
        ladder.append(max(b, config.max_len))
        self._len_ladder = tuple(ladder)
        # one caller at a time: a program's fixed buffers and the pool's
        # block tables are shared state
        self._lock = threading.Lock()

    # ---- device group and program identity ---------------------------------

    @property
    def chip_width(self) -> int:
        """Leased-device multiplier for fair-share accounting: DecodeLoop
        bills each step's wall time x this across batch members."""
        return len(self.devices)

    @property
    def mesh_shape(self) -> Optional[dict[str, int]]:
        """None: the port's engine runs on one device."""
        return None

    @property
    def _mesh_key(self) -> str:
        return mesh_cache_tag(self.dp, 1)

    @property
    def _placement_key(self) -> str:
        """The group's shape, its devices and this engine's model: a
        captured graph reads the model's parameters and this engine's KV
        pool by address, so engines never share a program."""
        devices = ",".join(str(d) for d in self.devices)
        return f"{self._mesh_key}@{devices}#{id(self.model):x}"

    def _device_scope(self):
        """The engine's CUDA device as the calling thread's current one
        (the loop calls from ``asyncio.to_thread`` workers)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # ---- programs -----------------------------------------------------------

    def _prefill_program(self, t_pad: int) -> _Program:
        key = (self.model_id, "decode_prefill", t_pad, self._placement_key)

        def fn(tokens, length):
            return decoder_prefill(self.model, tokens, length[0])

        def build():
            with self._device_scope():
                # a real length while building: the logits row is length - 1
                return _Program(
                    self.device, {"tokens": (t_pad,), "length": (1,)}, fn, init={"length": 1}
                )

        return self.cache.get_or_compile(key, build)

    def _step_program(self, b_pad: int, t_pad: int) -> _Program:
        key = (self.model_id, "decode_step", b_pad, t_pad, self._placement_key)
        last_pos = self.config.max_len - 1

        def fn(tokens, lengths, table):
            K = _PagedLayers(self.kv.k_pool, table, lengths)
            V = _PagedLayers(self.kv.v_pool, table, lengths)
            # positions == lengths; past max_len the JAX gather clamps
            # the row, and so does this one (no device-side assert)
            positions = lengths.clamp(max=last_pos)
            return decoder_step(self.model, tokens, positions, K, V, lengths)

        def build():
            layout = {
                "tokens": (b_pad,),
                "lengths": (b_pad,),
                "table": (b_pad, t_pad // self.kv.block_size),
            }
            with self._device_scope():
                return _Program(self.device, layout, fn)

        return self.cache.get_or_compile(key, build)

    def warmup(self, prompt_lens: Sequence[int] = (16,), batches: Sequence[int] = (1,)) -> None:
        bs = self.kv.block_size
        with self._lock:
            for t in prompt_lens:
                self._prefill_program(bucket_dim(t, self._len_ladder, divisor=bs))
            for b in batches:
                self._step_program(
                    bucket_batch(b, multiple_of=self.dp),
                    bucket_dim(max(bs, 1), self._len_ladder, divisor=bs),
                )

    # ---- decode API ---------------------------------------------------------

    def prefill(self, seq_id: str, tokens: Sequence[int]) -> int:
        """Admit a sequence: run the prompt, cache its KV, return the
        first greedy token."""
        width = len(self.devices)
        t0 = time.monotonic()
        try:
            toks = np.asarray(tokens, np.int64)
            T = toks.shape[0]
            if T == 0 or T > self.config.max_len:
                raise ValueError(
                    f"prompt length {T} outside (0, {self.config.max_len}]"
                )
            if toks.min() < 0 or toks.max() >= self.config.vocab:
                # the JAX gather would clamp; a device gather would assert
                raise ValueError(f"prompt tokens outside [0, {self.config.vocab})")
            bs = self.kv.block_size
            t_pad = bucket_dim(T, self._len_ladder, divisor=bs)
            padded = np.zeros((t_pad,), np.int64)
            padded[:T] = toks
            with self._lock, self._device_scope():
                program = self._prefill_program(t_pad)
                logits, K, V = program(tokens=padded, length=T)
                logits = logits.cpu().numpy()
                # [L, T, H, Dh] cropped to real length -> paged blocks
                self.kv.write_prefill(seq_id, K[:, :T], V[:, :T])
            tok = int(np.argmax(logits))
            ctx = tracing.current_trace()
            if ctx is not None and ctx.sampled:
                with tracing.span(
                    "decode.prefill",
                    model=self.model_id,
                    prompt_len=T,
                    bucket=t_pad,
                    mesh=self._mesh_key,
                ) as record:
                    record["attrs"]["chip_seconds"] = round(
                        (time.monotonic() - t0) * width, 6
                    )
            return tok
        finally:
            tracing.add_chip_seconds((time.monotonic() - t0) * width)

    def step(self, seq_ids: Sequence[str], tokens: Sequence[int]) -> list[int]:
        """Advance a co-batch one token. ``tokens[i]`` is the last
        generated token of ``seq_ids[i]`` (not yet in the cache); its KV
        is computed here and appended. Returns the next greedy token per
        sequence. The decode hot path: one host-to-device copy (tokens,
        lengths, block table), one graph replay, the logits back, and one
        indexed KV write per pool."""
        width = len(self.devices)
        t0 = time.monotonic()
        try:
            B = len(seq_ids)
            if B == 0:
                return []
            bs = self.kv.block_size
            lengths_now = [self.kv.sequence_length(s) for s in seq_ids]
            t_pad = bucket_dim(max(lengths_now), self._len_ladder, divisor=bs)
            b_pad = bucket_batch(B, multiple_of=self.dp)
            toks = np.zeros((b_pad,), np.int64)
            toks[:B] = np.asarray(tokens, np.int64)
            with self._lock, self._device_scope():
                program = self._step_program(b_pad, t_pad)
                table, lengths = self.kv.block_table(list(seq_ids), t_pad, pad_batch=b_pad)
                logits, k_new, v_new = program(tokens=toks, lengths=lengths, table=table)
                logits = logits[:B].cpu().numpy()
                self.kv.append_batch(seq_ids, k_new[:, :B], v_new[:, :B])
            out = [int(t) for t in np.argmax(logits, axis=-1)]
            ctx = tracing.current_trace()
            if ctx is not None and ctx.sampled:
                with tracing.span(
                    "decode.step",
                    model=self.model_id,
                    batch=B,
                    batch_bucket=b_pad,
                    kv_bucket=t_pad,
                    mesh=self._mesh_key,
                ) as record:
                    record["attrs"]["chip_seconds"] = round(
                        (time.monotonic() - t0) * width, 6
                    )
            return out
        finally:
            tracing.add_chip_seconds((time.monotonic() - t0) * width)

    def finish(self, seq_id: str) -> None:
        """Release a sequence's KV blocks (idempotent)."""
        self.kv.unpin(seq_id)
        self.kv.free(seq_id)

    def describe(self) -> dict:
        placement = self._placement_key
        return {
            "model_id": self.model_id,
            "device_ids": [d.index or 0 for d in self.devices],
            "n_devices": len(self.devices),
            "mesh": self.mesh_shape,
            "kv": self.kv.stats,
            "config": dataclasses.asdict(self.config),
            "device": str(self.device),
            "precision": "float32, TF32 off",
            "programs": sum(1 for k in self.cache.keys() if k[-1] == placement),
        }

    def close(self) -> None:
        """Drop this engine's programs (their graphs hold device memory)."""
        placement = self._placement_key
        self.cache.evict(lambda key: key[-1] == placement)
