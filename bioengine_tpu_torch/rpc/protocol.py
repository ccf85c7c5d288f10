"""Wire protocol for the BioEngine-TPU control plane.

The reference speaks hypha-rpc (an external WebSocket RPC service,
ref bioengine/worker/worker.py:522-612 connects out to it). This
framework ships its own control plane with the same *shape* —
service registration, method calls with injected caller context,
token auth — so deployments need no external RPC broker.

Two codecs share this module:

**Legacy** (``encode``/``decode``): one msgpack map; ndarrays ride as
ExtType(1) carrying ``dtype/shape/data`` packed *again* inside the
outer message. Every array crossing the plane is copied at least three
times per direction (``tobytes`` -> inner pack -> outer pack, then the
mirror on decode). Kept verbatim for interop with peers that predate
out-of-band framing.

**Out-of-band** (``encode_oob``/``decode_oob``): one scatter-gather
frame. A pre-walk extracts every large ndarray/bytes payload into a
buffer table and replaces it with a tiny ExtType(3) ref
(``{"i": idx, "d": dtype, "s": shape}``); the remaining small header
packs once, and raw buffers are appended 64-byte-aligned after it —
each payload is memcpy'd exactly once into the frame. ``decode_oob``
rebuilds arrays with ``np.frombuffer`` directly over the received
frame's memoryview: **zero** payload copies on receive. ExtType(4)
refs point into the host-shared shm object store instead (key, not
bytes): the receive side maps those zero-copy too, so a same-host hop
costs one copy total (the store put). Transport-level concerns —
chunked multi-frame sends, shm negotiation, stats — live in
``rpc/transport.py``.

Frame layout (all integers little-endian)::

    b"BEF1" | u32 meta_len | meta | pad to 64 | buf0 | pad | buf1 | ...
    meta = msgpack {"h": <packed message with ExtType refs>,
                    "b": [[rel_offset, length], ...]}

``rel_offset`` is relative to ``payload_start =
align64(8 + meta_len)`` so every buffer lands 64-byte-aligned in the
assembled frame (aligned ``np.frombuffer`` views are vectorization-
friendly). The magic byte 0x42 can never open a legacy message (a
msgpack map starts 0x80-0x8f or 0xde/0xdf), so ``is_oob_frame``
dispatch is unambiguous.
"""

from __future__ import annotations

import struct
import traceback
from typing import Any, Callable, Optional

import msgpack
import numpy as np

# message types
REGISTER = "register"          # client -> server: register a service
UNREGISTER = "unregister"
CALL = "call"                  # caller -> server -> provider
RESULT = "result"              # provider -> server -> caller
ERROR = "error"
TOKEN = "token"                # generate_token request
LIST = "list_services"
PING = "ping"
PONG = "pong"
SHM_ACK = "shm_ack"            # client proves it mapped the shared store
STREAM = "stream"              # provider -> server -> caller: one item of
                               # a streaming call (ordered by seq; the
                               # closing RESULT carries the final count)

# wire identifiers
OOB_MAGIC = b"BEF1"            # out-of-band scatter-gather frame
CHUNK_MAGIC = b"BEC1"          # one chunk of an oversized frame
FAST_MAGIC = b"BEFS"           # fixed-layout small-request fast frame
PROTO_OOB1 = "oob1"            # negotiated capability name
PROTO_FAST1 = "fast1"          # small-request fast frames (BEFS)
PROTO_TRACE1 = "trace1"        # request-trace fields on CALL/RESULT
PROTO_TELEM1 = "telem1"        # push-telemetry verbs on the serve-router
PROTO_MESH1 = "mesh1"          # cross-host mesh shards (mesh_shard on
                               # start_replica, stage activations over OOB)
PROTO_EPOCH1 = "epoch1"        # controller-epoch fencing: epoch kwarg on
                               # placement/lifecycle verbs, rejected typed
                               # when stale (StaleEpochError)
PROTO_STREAM1 = "stream1"      # streaming calls: async-generator service
                               # methods emit per-item STREAM frames
                               # (fast-frame kind 3 when eligible) closed
                               # by a counting RESULT

EXT_NDARRAY = 1                # legacy inline array (double-packed)
EXT_EXCEPTION = 2
EXT_OOB_REF = 3                # ref into this frame's buffer table
EXT_SHM_REF = 4                # ref into the host-shared object store

# payloads below this stay inline as legacy ExtType(1) — the envelope
# overhead of a table entry isn't worth it for scalars and tiny arrays
INLINE_LIMIT = 1024


def _pack_exception(obj: Exception) -> msgpack.ExtType:
    return msgpack.ExtType(
        EXT_EXCEPTION,
        msgpack.packb(
            {
                "type": type(obj).__name__,
                "message": str(obj),
                "traceback": "".join(
                    traceback.format_exception(obj)
                )[-4000:],
            }
        ),
    )


def _pack_inline_ndarray(obj: np.ndarray) -> msgpack.ExtType:
    return msgpack.ExtType(
        EXT_NDARRAY,
        msgpack.packb(
            {
                "dtype": obj.dtype.str,
                "shape": list(obj.shape),
                "data": obj.tobytes(),
            }
        ),
    )


def _default(obj: Any) -> Any:
    if isinstance(obj, np.ndarray):
        return _pack_inline_ndarray(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, Exception):
        return _pack_exception(obj)
    raise TypeError(f"Cannot serialize {type(obj)}")


class RemoteError(RuntimeError):
    """An exception raised on the provider side of an RPC call."""

    def __init__(self, type_name: str, message: str, remote_traceback: str = ""):
        super().__init__(f"{type_name}: {message}")
        self.type_name = type_name
        self.remote_traceback = remote_traceback


def _ext_hook(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        d = msgpack.unpackb(data)
        return np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])).reshape(
            d["shape"]
        )
    if code == EXT_EXCEPTION:
        d = msgpack.unpackb(data)
        return RemoteError(d["type"], d["message"], d.get("traceback", ""))
    return msgpack.ExtType(code, data)


def encode(msg: dict) -> bytes:
    """Legacy single-blob encoding (interop baseline)."""
    return msgpack.packb(msg, default=_default, use_bin_type=True)


def decode(data) -> dict:
    """Legacy single-blob decoding. Shm refs cannot appear here (they
    require a negotiated store); an ExtType(4) raises loudly rather
    than returning a silent placeholder."""
    return msgpack.unpackb(bytes(data), ext_hook=_ext_hook, raw=False)


# ---------------------------------------------------------------------------
# Out-of-band codec
# ---------------------------------------------------------------------------


def is_oob_frame(data) -> bool:
    return bytes(data[:4]) == OOB_MAGIC


def is_chunk_frame(data) -> bool:
    return bytes(data[:4]) == CHUNK_MAGIC


def _align64(n: int) -> int:
    return (n + 63) & ~63


def payload_nbytes(obj: Any, _depth: int = 0) -> int:
    """Recursive estimate of the raw tensor/bytes payload a message
    carries — what decides off-loop encode and chunking, computed
    without serializing anything."""
    if _depth > 8:
        return 0
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return len(obj)
    if isinstance(obj, dict):
        return sum(payload_nbytes(v, _depth + 1) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(payload_nbytes(v, _depth + 1) for v in obj)
    return 0


def _extract(obj: Any, buffers: list, shm_put: Optional[Callable]) -> Any:
    """Pre-walk replacing large payloads with ExtType refs.

    ``buffers`` collects flat C-order memoryviews (the scatter list);
    ``shm_put(buf) -> key | None`` diverts a buffer into the shared
    store instead (None = store full/absent, fall back to the wire)."""
    if isinstance(obj, np.ndarray):
        if obj.nbytes < INLINE_LIMIT:
            return _pack_inline_ndarray(obj)
        arr = np.ascontiguousarray(obj)  # copies only if non-contiguous
        desc = {"d": arr.dtype.str, "s": list(arr.shape)}
        return _ref_for(memoryview(arr).cast("B"), desc, buffers, shm_put)
    if isinstance(obj, (bytes, bytearray, memoryview)):
        buf = memoryview(obj).cast("B") if not isinstance(obj, bytes) else obj
        if len(buf) < INLINE_LIMIT:
            return bytes(buf) if not isinstance(obj, bytes) else obj
        return _ref_for(
            buf if isinstance(buf, memoryview) else memoryview(buf),
            {"y": 1},
            buffers,
            shm_put,
        )
    if isinstance(obj, dict):
        return {k: _extract(v, buffers, shm_put) for k, v in obj.items()}
    if isinstance(obj, msgpack.ExtType):
        # ExtType is a namedtuple — the tuple branch below would
        # flatten it into [code, data]; pass it through to msgpack
        return obj
    if isinstance(obj, (list, tuple)):
        return [_extract(v, buffers, shm_put) for v in obj]
    return obj


def _ref_for(
    buf: memoryview, desc: dict, buffers: list, shm_put: Optional[Callable]
) -> msgpack.ExtType:
    if shm_put is not None:
        key = shm_put(buf)
        if key is not None:
            return msgpack.ExtType(
                EXT_SHM_REF,
                msgpack.packb({**desc, "k": key, "n": buf.nbytes}),
            )
    idx = len(buffers)
    buffers.append(buf)
    return msgpack.ExtType(EXT_OOB_REF, msgpack.packb({**desc, "i": idx}))


def encode_oob(
    msg: dict,
    shm_put: Optional[Callable] = None,
    payload_info: Optional[dict] = None,
) -> bytearray:
    """Encode ``msg`` as one scatter-gather frame.

    Each extracted payload buffer is written into the frame exactly
    once (or diverted to the shared store via ``shm_put``); everything
    else packs into the small header. Returns the assembled frame —
    ``bytearray`` so callers can send slices without another copy.
    ``payload_info`` (when given) receives ``{"n", "bytes"}`` of the
    wire-extracted buffers — the codec's RpcStats feed."""
    buffers: list[memoryview] = []
    header = msgpack.packb(
        _extract(msg, buffers, shm_put), default=_default, use_bin_type=True
    )
    if payload_info is not None:
        payload_info["n"] = len(buffers)
        payload_info["bytes"] = sum(b.nbytes for b in buffers)
    table = []
    rel = 0
    for buf in buffers:
        rel = _align64(rel)
        table.append([rel, buf.nbytes])
        rel += buf.nbytes
    meta = msgpack.packb({"h": header, "b": table})
    payload_start = _align64(8 + len(meta))
    frame = bytearray(payload_start + rel)
    frame[0:4] = OOB_MAGIC
    frame[4:8] = len(meta).to_bytes(4, "little")
    frame[8 : 8 + len(meta)] = meta
    for (off, length), buf in zip(table, buffers):
        frame[payload_start + off : payload_start + off + length] = buf
    return frame


def decode_oob(data, shm_get: Optional[Callable] = None) -> dict:
    """Decode a scatter-gather frame.

    Arrays referenced through the buffer table come back as
    ``np.frombuffer`` views **over the received frame** — zero copies,
    read-only (mutate via ``.copy()`` when needed, same contract the
    legacy decoder already had). ``shm_get(descriptor) -> value``
    materializes store-resident payloads (array view over the shm
    segment, or bytes) and owns their pin lifetime
    (rpc.transport.ShmPinTracker)."""
    mv = memoryview(data)
    if bytes(mv[:4]) != OOB_MAGIC:
        raise ValueError("not an out-of-band frame")
    meta_len = int.from_bytes(mv[4:8], "little")
    meta = msgpack.unpackb(mv[8 : 8 + meta_len], raw=False)
    table = meta["b"]
    payload = mv[_align64(8 + meta_len) :]

    def hook(code: int, ext_data: bytes) -> Any:
        if code == EXT_OOB_REF:
            d = msgpack.unpackb(ext_data)
            off, length = table[d["i"]]
            raw = payload[off : off + length]
            if d.get("y"):
                return bytes(raw)
            return np.frombuffer(raw, dtype=np.dtype(d["d"])).reshape(d["s"])
        if code == EXT_SHM_REF:
            d = msgpack.unpackb(ext_data)
            if shm_get is None:
                raise RuntimeError(
                    "message references the shared object store but this "
                    "peer has none attached (negotiation bug)"
                )
            # shm_get materializes the value itself (array view over
            # the segment, or bytes) because pin lifetime must be tied
            # to the object it hands out — see transport.ShmPinTracker
            return shm_get(d)
        return _ext_hook(code, ext_data)

    return msgpack.unpackb(meta["h"], ext_hook=hook, raw=False)


# ---------------------------------------------------------------------------
# Small-request fast frames (BEFS)
# ---------------------------------------------------------------------------
#
# The microsecond budget of a 1 KB call is dominated by envelope work:
# the oob pre-walk, a double msgpack pack, and ExtType dispatch. A fast
# frame is a fixed-layout struct-packed encoding for the two hot
# envelopes only — an untraced CALL and a span-free RESULT — whose
# values are scalars/strings/small bytes (shallow lists/dicts of the
# same allowed, so batched ``replica_call`` envelopes qualify). One
# single-pass pack into a caller-supplied scratch buffer, no msgpack,
# no pre-walk. Anything else — traces, spans, ndarrays, exceptions,
# oversize values — makes ``encode_fast`` return None and the caller
# falls back to the full codec, so the fast path can never change what
# a message can carry. Negotiated as ``fast1``; like the oob magic,
# 0x42 cannot open a legacy msgpack map, so dispatch stays unambiguous.
#
# Frame layout (little-endian)::
#
#     b"BEFS" | u8 kind | body
#     kind 1 (CALL):   str16 call_id | str16 service_id | str16 method
#                      | u8 n_args | value*  | u8 n_kwargs
#                      | (str16 key, value)*
#     kind 2 (RESULT): str16 call_id | value
#     str16 = u16 len | utf-8 bytes
#     value = u8 tag | payload    (tags below)

FAST_KIND_CALL = 1
FAST_KIND_RESULT = 2
FAST_KIND_STREAM = 3           # str16 call_id | u32 seq | value item

_FT_NONE = 0
_FT_TRUE = 1
_FT_FALSE = 2
_FT_INT = 3       # s64
_FT_FLOAT = 4     # f64
_FT_STR = 5       # u32 len | utf-8
_FT_BYTES = 6     # u32 len | raw
_FT_LIST = 7      # u8 count | value*
_FT_DICT = 8      # u8 count | (str16 key, value)*

# Per-value size guard: a single str/bytes longer than this can never
# fit a fast frame regardless of the negotiated limit, so bail before
# copying it into the scratch buffer.
_FAST_VALUE_LIMIT = 65536
# Default whole-frame threshold; transport exposes it as a config knob
# (BIOENGINE_RPC_FAST_THRESHOLD).
FAST_THRESHOLD_DEFAULT = 4096

_PACK_Q = struct.Struct("<q").pack
_PACK_D = struct.Struct("<d").pack
_UNPACK_Q = struct.Struct("<q").unpack_from
_UNPACK_D = struct.Struct("<d").unpack_from
_UNPACK_H = struct.Struct("<H").unpack_from
_UNPACK_I = struct.Struct("<I").unpack_from

_FAST_CALL_PREFIX = FAST_MAGIC + bytes([FAST_KIND_CALL])
_FAST_RESULT_PREFIX = FAST_MAGIC + bytes([FAST_KIND_RESULT])
_FAST_STREAM_PREFIX = FAST_MAGIC + bytes([FAST_KIND_STREAM])


class _FastUnsupported(Exception):
    """Internal: value not expressible in a fast frame (fall back)."""


def is_fast_frame(data) -> bool:
    return bytes(data[:4]) == FAST_MAGIC


def _fast_str16(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    if len(b) > 65535:
        raise _FastUnsupported
    out += len(b).to_bytes(2, "little")
    out += b


def _fast_pack_value(out: bytearray, v: Any, depth: int) -> None:
    t = type(v)
    if v is None:
        out.append(_FT_NONE)
    elif t is bool:
        out.append(_FT_TRUE if v else _FT_FALSE)
    elif t is int:
        out.append(_FT_INT)
        out += _PACK_Q(v)  # struct.error on >64-bit -> fallback
    elif t is float:
        out.append(_FT_FLOAT)
        out += _PACK_D(v)
    elif t is str:
        b = v.encode("utf-8")
        if len(b) > _FAST_VALUE_LIMIT:
            raise _FastUnsupported
        out.append(_FT_STR)
        out += len(b).to_bytes(4, "little")
        out += b
    elif t is bytes:
        if len(v) > _FAST_VALUE_LIMIT:
            raise _FastUnsupported
        out.append(_FT_BYTES)
        out += len(v).to_bytes(4, "little")
        out += v
    elif t is list or t is tuple:
        if depth >= 6 or len(v) > 255:
            raise _FastUnsupported
        out.append(_FT_LIST)
        out.append(len(v))
        for item in v:
            _fast_pack_value(out, item, depth + 1)
    elif t is dict:
        if depth >= 6 or len(v) > 255:
            raise _FastUnsupported
        out.append(_FT_DICT)
        out.append(len(v))
        for k, item in v.items():
            if type(k) is not str:
                raise _FastUnsupported
            _fast_str16(out, k)
            _fast_pack_value(out, item, depth + 1)
    else:
        # exact-type dispatch on purpose: np scalars, Exceptions,
        # ndarrays, ExtType, user subclasses all land here -> full codec
        raise _FastUnsupported


def encode_fast(
    msg: dict,
    limit: int = FAST_THRESHOLD_DEFAULT,
    scratch: Optional[bytearray] = None,
) -> Optional[bytes]:
    """Encode ``msg`` as one BEFS frame, or return None when it is not
    fast-eligible (caller falls back to the full codec).

    Only the two hot envelopes qualify — a CALL without a trace
    attachment and a RESULT without piggybacked spans — and only when
    every value packs into the tag scheme above and the whole frame
    stays within ``limit`` bytes. ``scratch`` is a reusable per-
    connection buffer; the returned value is an immutable copy so the
    scratch can be reused immediately (websocket sends may be queued).
    """
    try:
        t = msg.get("t")
        if t == CALL:
            if len(msg) != 6:
                return None
            return encode_fast_call(
                msg["call_id"],
                msg["service_id"],
                msg["method"],
                msg["args"],
                msg["kwargs"],
                limit,
                scratch,
            )
        if t == RESULT:
            if len(msg) != 3:
                return None
            return encode_fast_result(
                msg["call_id"], msg["result"], limit, scratch
            )
        return None
    except KeyError:
        return None


def encode_fast_call(
    call_id: str,
    service_id: str,
    method: str,
    args,
    kwargs: dict,
    limit: int = FAST_THRESHOLD_DEFAULT,
    scratch: Optional[bytearray] = None,
) -> Optional[bytes]:
    """``encode_fast`` for a CALL, taken directly from the call-site
    arguments — the request hot path skips building (and immediately
    re-walking) the envelope dict entirely. Byte-identical to encoding
    the equivalent dict through ``encode_fast``."""
    try:
        if (
            type(call_id) is not str
            or type(service_id) is not str
            or type(method) is not str
            or (type(args) is not list and type(args) is not tuple)
            or type(kwargs) is not dict
            or len(args) > 255
            or len(kwargs) > 255
        ):
            return None
        out = scratch if scratch is not None else bytearray()
        del out[:]
        out += _FAST_CALL_PREFIX
        _fast_str16(out, call_id)
        _fast_str16(out, service_id)
        _fast_str16(out, method)
        out.append(len(args))
        for v in args:
            _fast_pack_value(out, v, 0)
        out.append(len(kwargs))
        for k, v in kwargs.items():
            if type(k) is not str:
                return None
            _fast_str16(out, k)
            _fast_pack_value(out, v, 0)
        if len(out) > limit:
            return None
        return bytes(out)
    except (_FastUnsupported, struct.error, OverflowError):
        return None


def encode_fast_result(
    call_id: str,
    result: Any,
    limit: int = FAST_THRESHOLD_DEFAULT,
    scratch: Optional[bytearray] = None,
) -> Optional[bytes]:
    """``encode_fast`` for a RESULT, taken directly from the handler's
    return value — same direct-argument shortcut as
    ``encode_fast_call``."""
    try:
        if type(call_id) is not str:
            return None
        out = scratch if scratch is not None else bytearray()
        del out[:]
        out += _FAST_RESULT_PREFIX
        _fast_str16(out, call_id)
        _fast_pack_value(out, result, 0)
        if len(out) > limit:
            return None
        return bytes(out)
    except (_FastUnsupported, struct.error, OverflowError):
        return None


def encode_fast_stream(
    call_id: str,
    seq: int,
    item: Any,
    limit: int = FAST_THRESHOLD_DEFAULT,
    scratch: Optional[bytearray] = None,
) -> Optional[bytes]:
    """One stream item as a BEFS frame. Per-token sends are the entire
    point of the stream plane — a generation emits hundreds of tiny
    frames per request, so each rides the same single-pass fixed-layout
    encoding as a fast RESULT. None when the item isn't fast-eligible
    (caller falls back to the full-codec STREAM envelope)."""
    try:
        if type(call_id) is not str or seq < 0 or seq > 0xFFFFFFFF:
            return None
        out = scratch if scratch is not None else bytearray()
        del out[:]
        out += _FAST_STREAM_PREFIX
        _fast_str16(out, call_id)
        out += seq.to_bytes(4, "little")
        _fast_pack_value(out, item, 0)
        if len(out) > limit:
            return None
        return bytes(out)
    except (_FastUnsupported, struct.error, OverflowError):
        return None


def decode_fast_stream(data) -> Optional[tuple]:
    """``(call_id, seq, item)`` for a BEFS STREAM frame, None for any
    other kind — mirrors ``decode_fast_result``."""
    buf = bytes(data)
    if buf[4] != FAST_KIND_STREAM:  # caller already checked the magic
        return None
    call_id, pos = _fast_read_str16(buf, 5)
    seq = _UNPACK_I(buf, pos)[0]
    item, _ = _fast_read_value(buf, pos + 4)
    return call_id, seq, item


def _fast_read_str16(buf: bytes, pos: int):
    n = _UNPACK_H(buf, pos)[0]  # no slice allocation on the hot path
    pos += 2
    end = pos + n
    return str(buf[pos:end], "utf-8"), end


def _fast_read_value(buf: bytes, pos: int):
    tag = buf[pos]
    pos += 1
    if tag == _FT_NONE:
        return None, pos
    if tag == _FT_TRUE:
        return True, pos
    if tag == _FT_FALSE:
        return False, pos
    if tag == _FT_INT:
        return _UNPACK_Q(buf, pos)[0], pos + 8
    if tag == _FT_FLOAT:
        return _UNPACK_D(buf, pos)[0], pos + 8
    if tag == _FT_STR:
        n = _UNPACK_I(buf, pos)[0]
        pos += 4
        end = pos + n
        return str(buf[pos:end], "utf-8"), end
    if tag == _FT_BYTES:
        n = _UNPACK_I(buf, pos)[0]
        pos += 4
        end = pos + n
        return buf[pos:end], end
    if tag == _FT_LIST:
        n = buf[pos]
        pos += 1
        out = []
        for _ in range(n):
            v, pos = _fast_read_value(buf, pos)
            out.append(v)
        return out, pos
    if tag == _FT_DICT:
        n = buf[pos]
        pos += 1
        d = {}
        for _ in range(n):
            k, pos = _fast_read_str16(buf, pos)
            v, pos = _fast_read_value(buf, pos)
            d[k] = v
        return d, pos
    raise ValueError(f"bad fast-frame value tag {tag}")


def decode_fast(data) -> dict:
    """Decode a BEFS frame back into the canonical message dict —
    identical in shape and value to what ``decode`` would return for
    the same message through the legacy codec (tuples become lists in
    both, matching msgpack)."""
    buf = bytes(data)
    if buf[:4] != FAST_MAGIC:
        raise ValueError("not a fast frame")
    kind = buf[4]
    pos = 5
    if kind == FAST_KIND_CALL:
        call_id, service_id, method, args, kwargs = decode_fast_call(buf)
        return {
            "t": CALL,
            "call_id": call_id,
            "service_id": service_id,
            "method": method,
            "args": args,
            "kwargs": kwargs,
        }
    if kind == FAST_KIND_RESULT:
        call_id, pos = _fast_read_str16(buf, pos)
        v, pos = _fast_read_value(buf, pos)
        return {"t": RESULT, "call_id": call_id, "result": v}
    if kind == FAST_KIND_STREAM:
        call_id, pos = _fast_read_str16(buf, pos)
        seq = _UNPACK_I(buf, pos)[0]
        v, _ = _fast_read_value(buf, pos + 4)
        return {"t": STREAM, "call_id": call_id, "seq": seq, "item": v}
    raise ValueError(f"bad fast-frame kind {kind}")


def decode_fast_call(data) -> Optional[tuple]:
    """``(call_id, service_id, method, args, kwargs)`` for a BEFS CALL
    frame, None for any other kind — the server's inline dispatch runs
    the handler straight off the tuple without materializing the
    envelope dict."""
    buf = bytes(data)
    if buf[4] != FAST_KIND_CALL:  # caller already checked the magic
        return None
    call_id, pos = _fast_read_str16(buf, 5)
    service_id, pos = _fast_read_str16(buf, pos)
    method, pos = _fast_read_str16(buf, pos)
    n = buf[pos]
    pos += 1
    args = []
    for _ in range(n):
        v, pos = _fast_read_value(buf, pos)
        args.append(v)
    n = buf[pos]
    pos += 1
    kwargs = {}
    for _ in range(n):
        k, pos = _fast_read_str16(buf, pos)
        v, pos = _fast_read_value(buf, pos)
        kwargs[k] = v
    return call_id, service_id, method, args, kwargs


def decode_fast_result(data) -> Optional[tuple]:
    """``(call_id, value)`` for a BEFS RESULT frame, None for any
    other kind (the caller falls back to ``decode_fast``). The waiting
    future gets the value directly — no envelope dict is materialized
    on the response hot path."""
    buf = bytes(data)
    if buf[4] != FAST_KIND_RESULT:  # caller already checked the magic
        return None
    call_id, pos = _fast_read_str16(buf, 5)
    v, _ = _fast_read_value(buf, pos)
    return call_id, v
