"""Transport plumbing for the zero-copy RPC data plane.

``protocol.py`` owns the byte format; this module owns everything a
live connection needs around it:

- ``TransportConfig`` — env-tunable thresholds (chunk size, shm
  threshold, off-loop offload threshold).
- ``RpcStats`` — bytes/frames/chunks in+out, encode/decode seconds,
  shm hit/fallback counters; surfaced by ``RpcServer.describe`` /
  ``ServerConnection.describe`` and the worker status dict.
- ``chunk_frames``/``FrameAssembler`` — oversized frames split into
  ``BEC1`` chunks at ``frame_limit`` and reassembled on the receive
  side, replacing the old hard 256 MB ``max_msg_size`` ceiling with a
  bounded per-websocket-message size (chunk streams from concurrent
  sends may interleave; reassembly is keyed by message id).
- ``ShmPinTracker`` — store pins taken while decoding shm refs, held
  until the consumer drops its array views, then released+deleted.
- ``Codec`` — one per connection: negotiated capabilities (oob,
  shm store), encode-to-frames / decode-from-frames, and off-loop
  execution of both above ``offload_threshold`` so a 64 MB payload
  never serializes on the asyncio event loop (the exact blocking
  pattern BE-ASYNC-001 exists to catch).
"""

from __future__ import annotations

import asyncio
import os
import secrets
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import msgpack

from bioengine_tpu_torch.rpc import protocol
from bioengine_tpu_torch.utils import metrics

# module-level bind: a global-name load beats two attribute hops on a
# function called four times per small-request round trip
_perf_counter = time.perf_counter


def _env_mb(name: str, default_mb: float) -> int:
    return int(float(os.environ.get(name, default_mb)) * 1024 * 1024)


@dataclass
class TransportConfig:
    # one websocket message never exceeds this; larger frames chunk.
    # 128 MB keeps every realistic tensor message single-frame (no
    # chunk-join copy) while chunking still removes the old 256 MB
    # ceiling for the giants
    frame_limit: int = 128 * 1024 * 1024
    # buffers at least this large go through the shared store when a
    # same-host segment is negotiated
    shm_threshold: int = 1024 * 1024
    # encode/decode with more payload than this run off-loop
    offload_threshold: int = 4 * 1024 * 1024
    # receive-side ceiling for ONE websocket message — covers our own
    # chunks (frame_limit + header) and unchunked legacy-peer sends
    # (their encoder caps out where the old wire cap sat)
    max_msg_size: int = 256 * 1024 * 1024
    # ceiling for ONE reassembled logical message: chunking removes
    # the per-websocket-message cap, so this is the replacement bound
    # on what a peer's chunk headers can make the receiver allocate
    max_assembled: int = 2 * 1024 * 1024 * 1024
    # whole-frame byte ceiling for BEFS small-request fast frames; a
    # message that packs larger falls back to the full codec
    fast_threshold: int = protocol.FAST_THRESHOLD_DEFAULT

    def __post_init__(self) -> None:
        # a chunk (frame_limit payload + ~64-byte header) must fit the
        # receiver's per-websocket-message cap, or every chunked send
        # would kill the connection — clamp rather than trusting two
        # independently-tunable env vars to agree
        self.frame_limit = max(
            min(self.frame_limit, self.max_msg_size - 65536), 65536
        )

    @classmethod
    def from_env(cls) -> "TransportConfig":
        return cls(
            frame_limit=_env_mb("BIOENGINE_RPC_FRAME_LIMIT_MB", 128),
            shm_threshold=_env_mb("BIOENGINE_RPC_SHM_THRESHOLD_MB", 1),
            offload_threshold=_env_mb("BIOENGINE_RPC_OFFLOAD_MB", 4),
            max_msg_size=_env_mb("BIOENGINE_RPC_MAX_MSG_MB", 256),
            max_assembled=_env_mb("BIOENGINE_RPC_MAX_ASSEMBLED_MB", 2048),
            fast_threshold=int(
                float(
                    os.environ.get(
                        "BIOENGINE_RPC_FAST_THRESHOLD",
                        protocol.FAST_THRESHOLD_DEFAULT,
                    )
                )
            ),
        )


@dataclass(eq=False)  # identity semantics — instances live in a WeakSet
class RpcStats:
    """Data-plane counters for one server or one client connection.

    Mutations hold ``lock``: encode/decode above the offload threshold
    run in ``asyncio.to_thread`` workers, concurrently across clients
    — unlocked ``+=`` would silently drop increments exactly under the
    high-throughput conditions the counters exist to observe."""

    lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )
    bytes_out: int = 0
    bytes_in: int = 0
    msgs_out: int = 0
    msgs_in: int = 0
    frames_out: int = 0
    frames_in: int = 0
    chunked_msgs_out: int = 0
    chunked_msgs_in: int = 0
    encode_seconds: float = 0.0
    decode_seconds: float = 0.0
    shm_puts: int = 0
    shm_put_bytes: int = 0
    shm_gets: int = 0
    shm_get_bytes: int = 0
    shm_fallbacks: int = 0       # store absent/full -> wire frame
    legacy_msgs_out: int = 0     # peers without oob1
    # payloads extracted into BEF1 scatter-gather tables on encode (the
    # wire half of the zero-copy path; shm_puts is the same-host half).
    # What the cross-host mesh tests PIN: activation arrays between
    # shards must land here, never as legacy inline double-packs.
    oob_payloads_out: int = 0
    oob_payload_bytes_out: int = 0
    # BEFS small-request fast frames. fast_fallbacks counts CALL/RESULT
    # envelopes on a fast1 connection that still needed the full codec
    # (trace attached, spans piggybacked, oversize or non-scalar args)
    # — the hit-rate denominator next to shm_hit_rate.
    small_frames_out: int = 0
    small_frames_in: int = 0
    fast_fallbacks: int = 0

    def __post_init__(self) -> None:
        # every live stats object feeds the process-wide metrics plane
        # at scrape time (utils/metrics.py collector) — describe() and
        # GET /metrics read the SAME counters, no double bookkeeping
        _STATS_INSTANCES.add(self)

    def as_dict(self) -> dict:
        with self.lock:
            d = dict(self.__dict__)
        d.pop("lock", None)
        d["encode_seconds"] = round(d["encode_seconds"], 4)
        d["decode_seconds"] = round(d["decode_seconds"], 4)
        shm_total = d["shm_puts"] + d["shm_fallbacks"]
        d["shm_hit_rate"] = (
            round(d["shm_puts"] / shm_total, 4) if shm_total else None
        )
        fast_total = d["small_frames_out"] + d["fast_fallbacks"]
        d["fast_frame_hit_rate"] = (
            round(d["small_frames_out"] / fast_total, 4)
            if fast_total
            else None
        )
        return d


_RPC_METRIC_FIELDS = (
    "bytes_out", "bytes_in", "msgs_out", "msgs_in", "frames_out",
    "frames_in", "chunked_msgs_out", "chunked_msgs_in", "encode_seconds",
    "decode_seconds", "shm_puts", "shm_put_bytes", "shm_gets",
    "shm_get_bytes", "shm_fallbacks", "legacy_msgs_out",
    "oob_payloads_out", "oob_payload_bytes_out",
    "small_frames_out", "small_frames_in", "fast_fallbacks",
)


def _collect_rpc_stats(instances: list) -> list:
    """Fold every live RpcStats (server + each client connection in
    this process) into process totals. Per-connection breakdowns stay
    on describe(); the metrics plane wants the aggregate an autoscaler
    or dashboard keys on."""
    totals = dict.fromkeys(_RPC_METRIC_FIELDS, 0.0)
    for st in instances:
        with st.lock:
            for f in _RPC_METRIC_FIELDS:
                totals[f] += getattr(st, f)
    samples = [
        metrics.Sample(
            f"rpc_{name}",
            round(value, 4),
            kind="counter",
            help=f"RPC transport {name.replace('_', ' ')} (process total)",
        )
        for name, value in totals.items()
    ]
    samples.append(
        metrics.Sample(
            "rpc_stats_instances",
            len(instances),
            kind="gauge",
            help="live RpcStats objects (server + client connections)",
        )
    )
    small_total = totals["small_frames_out"] + totals["small_frames_in"]
    samples.append(
        metrics.Sample(
            "rpc_small_frames_total",
            round(small_total, 4),
            kind="counter",
            help="BEFS fast frames on the wire, both directions "
            "(process total)",
        )
    )
    fast_attempts = totals["small_frames_out"] + totals["fast_fallbacks"]
    samples.append(
        metrics.Sample(
            "rpc_fast_frame_hit_rate",
            round(totals["small_frames_out"] / fast_attempts, 4)
            if fast_attempts
            else 0.0,
            kind="gauge",
            help="fraction of fast1 CALL/RESULT envelopes that rode a "
            "BEFS frame instead of the full codec",
        )
    )
    return samples


_STATS_INSTANCES = metrics.InstanceSet("rpc_transport", _collect_rpc_stats)


def chunk_frames(frame, frame_limit: int) -> list:
    """Split ``frame`` into self-describing BEC1 chunks of at most
    ``frame_limit`` payload bytes. A frame that fits returns as-is
    (zero overhead for the common case)."""
    total = len(frame)
    if total <= frame_limit:
        return [frame]
    mv = memoryview(frame)
    msg_id = secrets.token_bytes(8)
    n = (total + frame_limit - 1) // frame_limit
    out = []
    for seq in range(n):
        off = seq * frame_limit
        # "c" (the fixed chunk stride) lets the receiver VALIDATE that
        # offset, seq, and count are mutually consistent — a chunk
        # stream cannot claim coverage it doesn't deliver
        hdr = msgpack.packb(
            {"id": msg_id, "q": seq, "n": n, "z": total, "o": off,
             "c": frame_limit}
        )
        out.append(
            b"".join(
                [
                    protocol.CHUNK_MAGIC,
                    len(hdr).to_bytes(4, "little"),
                    hdr,
                    mv[off : off + frame_limit],
                ]
            )
        )
    return out


class FrameAssembler:
    """Reassembles BEC1 chunk streams into complete frames.

    ``feed`` returns the complete frame (the original bytes for
    unchunked messages) or None while a chunked message is still in
    flight. Interleaved chunk streams are fine — state is per
    message id.

    Chunk headers are peer-controlled, so they are validated before a
    single byte is allocated: the claimed total is capped by
    ``max_assembled`` (the replacement for the per-websocket-message
    bound that chunking removed, which also bounds the SUM of all
    in-flight partial buffers), the fixed chunk stride ``c`` must tie
    offset, seq, and count together (a stream cannot claim coverage it
    doesn't deliver — completion means every byte position was
    written), and a changed header mid-stream is an error. Partial
    streams whose sender went silent expire after ``stale_after``
    seconds so an abandoned transfer cannot pin its buffer forever.

    Completed frames are returned as READ-ONLY memoryviews so decoded
    arrays carry the same immutable contract as unchunked messages
    (aiohttp delivers those as ``bytes``)."""

    def __init__(
        self, max_assembled: int = 2 * 1024 * 1024 * 1024,
        stale_after: float = 300.0,
    ) -> None:
        self.max_assembled = max_assembled
        self.stale_after = stale_after
        # id -> (buffer, received-seqs, last-activity monotonic time)
        self._partial: dict[bytes, tuple[bytearray, set, float]] = {}
        self._pending_bytes = 0

    def feed(self, data) -> Optional[Any]:
        if not protocol.is_chunk_frame(data):
            return data
        mv = memoryview(data)
        hdr_len = int.from_bytes(mv[4:8], "little")
        hdr = msgpack.unpackb(mv[8 : 8 + hdr_len], raw=False)
        chunk = mv[8 + hdr_len :]
        total, off, n, seq = hdr["z"], hdr["o"], hdr["n"], hdr["q"]
        stride = hdr.get("c", 0)
        if not (0 < total <= self.max_assembled):
            raise ValueError(
                f"chunk claims {total} assembled bytes (cap "
                f"{self.max_assembled}; BIOENGINE_RPC_MAX_ASSEMBLED_MB)"
            )
        if (
            stride < 1
            or not 0 <= seq < n
            or n != (total + stride - 1) // stride
            or off != seq * stride
            or len(chunk) != min(stride, total - off)
        ):
            raise ValueError(
                "inconsistent chunk header (offset/seq/count/stride)"
            )
        self._expire_stale()
        if hdr["id"] not in self._partial and (
            self._pending_bytes + total > self.max_assembled
        ):
            raise ValueError(
                "in-flight partial frames exceed the assembly budget "
                "(BIOENGINE_RPC_MAX_ASSEMBLED_MB)"
            )
        now = time.monotonic()
        if hdr["id"] not in self._partial:
            self._partial[hdr["id"]] = (bytearray(total), set(), now)
            self._pending_bytes += total
        buf, seen, _ = self._partial[hdr["id"]]
        if len(buf) != total:
            raise ValueError("chunk stream changed its claimed total")
        buf[off : off + len(chunk)] = chunk
        seen.add(seq)
        self._partial[hdr["id"]] = (buf, seen, now)
        if len(seen) < n:
            return None
        # every seq 0..n-1 present with validated stride offsets —
        # the buffer is fully covered, no zero-filled holes possible
        del self._partial[hdr["id"]]
        self._pending_bytes -= total
        return memoryview(buf).toreadonly()

    def _expire_stale(self) -> None:
        cutoff = time.monotonic() - self.stale_after
        for mid in [
            mid for mid, (_, _, ts) in self._partial.items() if ts < cutoff
        ]:
            buf, _, _ = self._partial.pop(mid)
            self._pending_bytes -= len(buf)

    @property
    def pending(self) -> int:
        return len(self._partial)


class ShmPinTracker:
    """Pins taken while decoding shm refs on the receive side.

    Each decoded array is a view over the store's mapping; the pin must
    outlive every such view or LRU eviction could recycle the bytes
    underneath it. Liveness is detected with ``weakref.finalize`` on
    the root ``np.frombuffer`` array: any numpy view derived from it
    keeps it alive through the ``.base`` chain (and ``memoryview(arr)``
    holds it via the exported Py_buffer), so the finalizer fires
    exactly when no consumer can reach the bytes anymore.
    (``memoryview.release()`` is NOT a usable signal — numpy exports
    from the underlying buffer owner, so release never raises.)

    The finalizer may run from GC in any thread mid-anything, so it
    only enqueues the key; ``drain`` — called from safe points after
    each dispatched message — performs the store release+delete (RPC
    payloads are one-shot: the receiver owns disposal)."""

    def __init__(self, store) -> None:
        self.store = store
        self._finalizers: dict[str, Any] = {}
        self._releasable: deque[str] = deque()

    def materialize(self, desc: dict) -> Any:
        """Descriptor {"k", "n", "d", "s"} / {"k", "n", "y"} -> value."""
        key, nbytes = desc["k"], desc["n"]
        view = self.store.get(key)
        if view is None:
            raise KeyError(
                f"shm object {key!r} missing — evicted before consume; "
                "size the store above the in-flight payload volume "
                "(docs/OPERATIONS.md)"
            )
        if desc.get("y"):
            data = bytes(view[:nbytes])  # bytes consumers get a copy
            view.release()
            self.store.release(key)
            self._try_delete(key)
            return data
        import numpy as np

        arr = np.frombuffer(view[:nbytes], dtype=np.dtype(desc["d"])).reshape(
            desc["s"]
        )
        self._finalizers[key] = weakref.finalize(
            arr, self._releasable.append, key
        )
        return arr

    def _try_delete(self, key: str) -> None:
        try:
            self.store.delete(key)
        except Exception:  # noqa: BLE001 — another peer may have raced
            pass

    def drain(self) -> int:
        """Release+delete objects whose consumers are gone; returns how
        many stay pinned."""
        while True:
            try:
                key = self._releasable.popleft()
            except IndexError:
                break
            self._finalizers.pop(key, None)
            self.store.release(key)
            self._try_delete(key)
        return len(self._finalizers)

    def close(self) -> None:
        # keys whose consumers are still alive KEEP their pins — a
        # closing connection must not let eviction recycle bytes under
        # live arrays; those pins persist until process exit
        self.drain()


# a scratch bytearray that ballooned past this is dropped instead of
# returned to the pool — one aborted pack of a 64 KB string must not
# pin that much capacity on the connection forever
_FAST_SCRATCH_RETAIN = 2 * protocol.FAST_THRESHOLD_DEFAULT + 65536


class Codec:
    """Per-connection encoder/decoder with negotiated capabilities."""

    def __init__(
        self,
        *,
        config: Optional[TransportConfig] = None,
        stats: Optional[RpcStats] = None,
    ):
        self.config = config or TransportConfig.from_env()
        self.stats = stats or RpcStats()
        self.oob = False                 # peer speaks PROTO_OOB1
        self.trace = False               # peer speaks PROTO_TRACE1
        self.fast = False                # peer speaks PROTO_FAST1
        self.shm_store = None            # negotiated same-host store
        self._tracker: Optional[ShmPinTracker] = None
        self._assembler = FrameAssembler(
            max_assembled=self.config.max_assembled
        )
        # reusable BEFS scratch buffers. A tiny pool (list.pop/append
        # are atomic under the GIL) instead of one shared bytearray:
        # encode can run concurrently on the event loop and in an
        # offload thread, and a scratch must never be shared mid-pack
        self._fast_pool: list[bytearray] = [bytearray()]
        # hoisted out of the per-frame wrappers: two attribute hops per
        # call add up at 4 codec invocations per round trip
        self._fast_threshold = self.config.fast_threshold

    # ---- negotiation --------------------------------------------------------

    def enable_shm(self, store) -> None:
        self.shm_store = store
        self._tracker = ShmPinTracker(store)

    # ---- encode -------------------------------------------------------------

    def _shm_put(self, buf: memoryview) -> Optional[str]:
        if self.shm_store is None or buf.nbytes < self.config.shm_threshold:
            return None
        key = f"rpc/{secrets.token_hex(12)}"
        try:
            ok = self.shm_store.try_put(key, buf)
        except Exception:  # noqa: BLE001 — store trouble must not kill the call
            ok = False
        if not ok:
            with self.stats.lock:
                self.stats.shm_fallbacks += 1
            return None
        with self.stats.lock:
            self.stats.shm_puts += 1
            self.stats.shm_put_bytes += buf.nbytes
        return key

    def encode_fast_frame(self, msg: dict) -> Optional[bytes]:
        """One BEFS frame for a fast-eligible message, else None (and
        the fallback counter ticks for the hot envelopes).

        Stats are updated WITHOUT the lock: fast frames are by
        construction small, so this path only ever runs on the event
        loop thread (the ``to_thread`` offload is for big payloads,
        which can never qualify). The counters are advisory — a lost
        increment against a concurrent locked full-path update is
        tolerable; a per-request lock acquire on the microsecond hot
        path is not (BE-PERF-301)."""
        t0 = _perf_counter()
        pool = self._fast_pool
        scratch = pool.pop() if pool else bytearray()
        frame = protocol.encode_fast(msg, self._fast_threshold, scratch)
        if len(scratch) <= _FAST_SCRATCH_RETAIN:
            pool.append(scratch)
        st = self.stats
        if frame is None:
            t = msg.get("t")
            if t == protocol.CALL or t == protocol.RESULT:
                st.fast_fallbacks += 1
            return None
        st.small_frames_out += 1
        st.encode_seconds += _perf_counter() - t0
        st.msgs_out += 1
        st.frames_out += 1
        st.bytes_out += len(frame)
        return frame

    def encode_fast_call_frame(
        self, call_id: str, service_id: str, method: str, args, kwargs: dict
    ) -> Optional[bytes]:
        """``encode_fast_frame`` from call-site arguments — the client
        request path never materializes the CALL dict when this hits
        (same unlocked-stats argument, BE-PERF-301)."""
        t0 = _perf_counter()
        pool = self._fast_pool
        scratch = pool.pop() if pool else bytearray()
        frame = protocol.encode_fast_call(
            call_id, service_id, method, args, kwargs,
            self._fast_threshold, scratch,
        )
        if len(scratch) <= _FAST_SCRATCH_RETAIN:
            pool.append(scratch)
        st = self.stats
        if frame is None:
            st.fast_fallbacks += 1
            return None
        st.small_frames_out += 1
        st.encode_seconds += _perf_counter() - t0
        st.msgs_out += 1
        st.frames_out += 1
        st.bytes_out += len(frame)
        return frame

    def encode_fast_result_frame(
        self, call_id: str, result: Any
    ) -> Optional[bytes]:
        """``encode_fast_frame`` from the handler's return value — the
        server inline-dispatch path never materializes the RESULT
        dict when this hits."""
        t0 = _perf_counter()
        pool = self._fast_pool
        scratch = pool.pop() if pool else bytearray()
        frame = protocol.encode_fast_result(
            call_id, result, self._fast_threshold, scratch
        )
        if len(scratch) <= _FAST_SCRATCH_RETAIN:
            pool.append(scratch)
        st = self.stats
        if frame is None:
            st.fast_fallbacks += 1
            return None
        st.small_frames_out += 1
        st.encode_seconds += _perf_counter() - t0
        st.msgs_out += 1
        st.frames_out += 1
        st.bytes_out += len(frame)
        return frame

    def encode_fast_stream_frame(
        self, call_id: str, seq: int, item: Any
    ) -> Optional[bytes]:
        """One BEFS stream-item frame — the per-token send path of a
        streaming call never materializes the STREAM dict when this
        hits (same unlocked-stats argument as the other fast encoders:
        a generation is hundreds of tiny frames)."""
        t0 = _perf_counter()
        pool = self._fast_pool
        scratch = pool.pop() if pool else bytearray()
        frame = protocol.encode_fast_stream(
            call_id, seq, item, self._fast_threshold, scratch
        )
        if len(scratch) <= _FAST_SCRATCH_RETAIN:
            pool.append(scratch)
        st = self.stats
        if frame is None:
            st.fast_fallbacks += 1
            return None
        st.small_frames_out += 1
        st.encode_seconds += _perf_counter() - t0
        st.msgs_out += 1
        st.frames_out += 1
        st.bytes_out += len(frame)
        return frame

    def decode_fast_stream_frame(self, data: bytes) -> Optional[tuple]:
        """``(call_id, seq, item)`` for a BEFS STREAM frame, else None
        — read loops feed the stream queue straight from the tuple."""
        t0 = _perf_counter()
        parsed = protocol.decode_fast_stream(data)
        if parsed is None:
            return None
        st = self.stats
        st.frames_in += 1
        st.bytes_in += len(data)
        st.small_frames_in += 1
        st.msgs_in += 1
        st.decode_seconds += _perf_counter() - t0
        return parsed

    def encode_frames(self, msg: dict) -> list:
        """Encode ``msg`` into the list of websocket messages to send."""
        if self.fast:
            frame = self.encode_fast_frame(msg)
            if frame is not None:
                return [frame]
        return self._encode_full(msg)

    def _encode_full(self, msg: dict) -> list:
        t0 = time.perf_counter()
        payload_info: dict = {}
        if not self.oob:
            frames = [protocol.encode(msg)]
        else:
            frame = protocol.encode_oob(
                msg, shm_put=self._shm_put, payload_info=payload_info
            )
            frames = chunk_frames(frame, self.config.frame_limit)
        with self.stats.lock:
            if not self.oob:
                self.stats.legacy_msgs_out += 1
            elif len(frames) > 1:
                self.stats.chunked_msgs_out += 1
            self.stats.oob_payloads_out += payload_info.get("n", 0)
            self.stats.oob_payload_bytes_out += payload_info.get("bytes", 0)
            self.stats.encode_seconds += time.perf_counter() - t0
            self.stats.msgs_out += 1
            self.stats.frames_out += len(frames)
            self.stats.bytes_out += sum(len(f) for f in frames)
        return frames

    async def encode_frames_async(self, msg: dict) -> list:
        """``encode_frames``, off-loop when the payload is large enough
        that serializing it inline would stall the event loop."""
        if self.fast:
            # the fast attempt is bounded (bails on the first oversize
            # or non-scalar value) so it runs inline and, when it hits,
            # skips the payload_nbytes walk entirely
            frame = self.encode_fast_frame(msg)
            if frame is not None:
                return [frame]
        if protocol.payload_nbytes(msg) >= self.config.offload_threshold:
            return await asyncio.to_thread(self._encode_full, msg)
        return self._encode_full(msg)

    # ---- decode -------------------------------------------------------------

    def _shm_materialize(self, desc: dict) -> Any:
        assert self._tracker is not None
        value = self._tracker.materialize(desc)
        with self.stats.lock:
            self.stats.shm_gets += 1
            self.stats.shm_get_bytes += desc.get("n", 0)
        return value

    def decode(self, data) -> Optional[dict]:
        """One received websocket message -> a complete message dict,
        or None while a chunked frame is still assembling."""
        t0 = time.perf_counter()
        whole = self._assembler.feed(data)
        if whole is None:
            with self.stats.lock:
                self.stats.frames_in += 1
                self.stats.bytes_in += len(data)
                self.stats.decode_seconds += time.perf_counter() - t0
            return None
        fast_in = False
        if protocol.is_fast_frame(whole):
            # dispatch by magic, not by the negotiated flag: only a
            # fast1 peer ever sends BEFS, but decode stays symmetric
            msg = protocol.decode_fast(whole)
            fast_in = True
        elif protocol.is_oob_frame(whole):
            msg = protocol.decode_oob(
                whole,
                shm_get=self._shm_materialize
                if self._tracker is not None
                else None,
            )
        else:
            msg = protocol.decode(whole)
        with self.stats.lock:
            self.stats.frames_in += 1
            self.stats.bytes_in += len(data)
            if whole is not data:
                self.stats.chunked_msgs_in += 1
            if fast_in:
                self.stats.small_frames_in += 1
            self.stats.msgs_in += 1
            self.stats.decode_seconds += time.perf_counter() - t0
        return msg

    def decode_fast_frame(self, data: bytes) -> dict:
        """Decode one BEFS frame (caller checked ``is_fast_frame``).
        BEFS frames are never chunked and never big enough to offload,
        so the read loops take this branch-free sync path — no
        assembler feed, no coroutine, and (same argument as
        ``encode_fast_frame``) no stats lock."""
        t0 = _perf_counter()
        msg = protocol.decode_fast(data)
        st = self.stats
        st.frames_in += 1
        st.bytes_in += len(data)
        st.small_frames_in += 1
        st.msgs_in += 1
        st.decode_seconds += _perf_counter() - t0
        return msg

    def decode_fast_call_frame(self, data: bytes) -> Optional[tuple]:
        """``(call_id, service_id, method, args, kwargs)`` for a BEFS
        CALL frame, else None — the server's inline dispatch runs off
        the tuple without building the envelope dict. A None return
        records no stats; the ``decode_fast_frame`` fallback does."""
        t0 = _perf_counter()
        parsed = protocol.decode_fast_call(data)
        if parsed is None:
            return None
        st = self.stats
        st.frames_in += 1
        st.bytes_in += len(data)
        st.small_frames_in += 1
        st.msgs_in += 1
        st.decode_seconds += _perf_counter() - t0
        return parsed

    def decode_fast_result_frame(self, data: bytes) -> Optional[tuple]:
        """``(call_id, value)`` for a BEFS RESULT frame, else None —
        the client read loop resolves the waiting future from the
        tuple without building the envelope dict. A None return
        records no stats; the ``decode_fast_frame`` fallback does."""
        t0 = _perf_counter()
        parsed = protocol.decode_fast_result(data)
        if parsed is None:
            return None
        st = self.stats
        st.frames_in += 1
        st.bytes_in += len(data)
        st.small_frames_in += 1
        st.msgs_in += 1
        st.decode_seconds += _perf_counter() - t0
        return parsed

    async def decode_async(self, data) -> Optional[dict]:
        if len(data) >= self.config.offload_threshold:
            return await asyncio.to_thread(self.decode, data)
        return self.decode(data)

    # ---- shm lifecycle ------------------------------------------------------

    def drain_pins(self) -> None:
        """Retry releasing store pins whose consumer views are gone —
        called after each dispatched message so one-shot RPC payloads
        leave the arena as soon as the handler drops them."""
        if self._tracker is not None:
            self._tracker.drain()

    def close(self) -> None:
        if self._tracker is not None:
            self._tracker.close()


def attach_store_by_name(name: str):
    """Best-effort attach to an existing named shm segment (the client
    side of negotiation). None when the native store is unavailable or
    the segment doesn't exist — the caller falls back to wire frames."""
    from bioengine_tpu_torch.native import store as native_store

    if not native_store.native_available():
        return None
    try:
        return native_store.SharedObjectStore(name, create=False)
    except Exception:  # noqa: BLE001 — absent segment is a normal outcome
        return None
