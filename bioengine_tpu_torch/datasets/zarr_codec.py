"""Self-contained Zarr v2/v3 metadata + chunk codec layer.

The execution image ships no ``zarr`` package, and the TPU data path
doesn't need one: reading a chunked array over HTTP only requires JSON
metadata parsing, chunk-key arithmetic, and byte (de)compression — all
stdlib + numpy. This module provides exactly that, for both Zarr formats:

- v2: ``.zarray`` / ``.zgroup`` documents, ``.``- or ``/``-separated
  chunk keys, ``compressor: {id: gzip|zlib|blosc|zstd|lz4|null}``.
- v3: ``zarr.json`` documents, ``c/``-prefixed chunk keys, codec chains
  ``[bytes, gzip|zlib|zstd|blosc?, crc32c?]`` and ``sharding_indexed``
  (inner-chunked shards with a trailing/leading binary index).

blosc/zstd/lz4 ride the same C libraries numcodecs wraps, bound via
ctypes in :mod:`bioengine_tpu_torch.datasets.codecs` — wire formats are
bit-identical to what the zarr/numcodecs ecosystem produces, so
real-world OME-Zarr (blosc is its default compressor) reads end-to-end.

Capability parity target: the read path of ref
bioengine/datasets/http_zarr_store.py:32-245 (which delegates decoding to
the external ``zarr>=3.0.8``); the write path exists so tests and apps can
produce stores hermetically.
"""

from __future__ import annotations

import gzip
import json
import math
import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterator, Optional

import numpy as np

from bioengine_tpu_torch.datasets import codecs as _native

V2_ARRAY_DOC = ".zarray"
V2_GROUP_DOC = ".zgroup"
V2_ATTRS_DOC = ".zattrs"
V3_DOC = "zarr.json"


@dataclass
class ShardingSpec:
    """zarr v3 ``sharding_indexed``: a stored chunk (shard) contains a
    regular grid of inner chunks plus a binary index of uint64
    (offset, nbytes) pairs, the index itself run through
    ``index_codecs`` (typically ``[bytes, crc32c]``)."""

    inner_chunks: tuple[int, ...]
    codecs: list  # inner codec chain (normalized v3 codec dicts)
    index_codecs: list
    index_location: str = "end"  # "end" | "start"


@dataclass
class ArrayMeta:
    """Normalized view of a zarr array's metadata (either format)."""

    shape: tuple[int, ...]
    chunks: tuple[int, ...]
    dtype: np.dtype
    zarr_format: int = 2
    compressor: Optional[str] = None  # None | gzip | zlib | zstd | blosc | lz4
    compressor_level: int = 5
    compressor_config: dict = field(default_factory=dict)  # blosc cname/shuffle…
    fill_value: Any = 0
    separator: str = "."  # v2 chunk-key separator; v3 always "/" with "c/" prefix
    attributes: dict = field(default_factory=dict)
    checksum: bool = False  # v3 crc32c codec after compression
    sharding: Optional[ShardingSpec] = None  # chunks == shard shape if set

    @property
    def chunk_grid(self) -> tuple[int, ...]:
        return tuple(
            -(-s // c) for s, c in zip(self.shape, self.chunks)
        )

    @property
    def nchunks(self) -> int:
        n = 1
        for g in self.chunk_grid:
            n *= g
        return n

    def chunk_key(self, idx: tuple[int, ...]) -> str:
        """Relative key of a chunk within the array directory."""
        if self.zarr_format == 3:
            return "c/" + "/".join(str(i) for i in idx) if idx else "c"
        return self.separator.join(str(i) for i in idx) if idx else "0"

    def chunk_indices(self) -> Iterator[tuple[int, ...]]:
        grid = self.chunk_grid
        idx = [0] * len(grid)
        if not grid:
            yield ()
            return
        while True:
            yield tuple(idx)
            for dim in reversed(range(len(grid))):
                idx[dim] += 1
                if idx[dim] < grid[dim]:
                    break
                idx[dim] = 0
            else:
                return

    def doc_name(self) -> str:
        return V3_DOC if self.zarr_format == 3 else V2_ARRAY_DOC


def parse_array_meta(doc: bytes | str | dict, name_hint: str = "") -> ArrayMeta:
    """Parse a ``.zarray`` (v2) or ``zarr.json`` (v3) document."""
    if isinstance(doc, (bytes, str)):
        doc = json.loads(doc)
    fmt = doc.get("zarr_format", 2)
    if fmt == 3:
        if doc.get("node_type") != "array":
            raise ValueError(f"zarr.json node '{name_hint}' is not an array")
        shape = tuple(doc["shape"])
        chunks = tuple(doc["chunk_grid"]["configuration"]["chunk_shape"])
        dtype = np.dtype(_v3_dtype_to_numpy(doc["data_type"]))
        parsed = _parse_v3_codec_chain(doc.get("codecs", []), name_hint)
        if parsed["endian"] == "big":
            dtype = dtype.newbyteorder(">")
        return ArrayMeta(
            shape=shape,
            chunks=chunks,
            dtype=dtype,
            zarr_format=3,
            compressor=parsed["compressor"],
            compressor_level=parsed["level"],
            compressor_config=parsed["config"],
            fill_value=_parse_fill(doc.get("fill_value", 0)),
            separator="/",
            attributes=doc.get("attributes", {}) or {},
            checksum=parsed["checksum"],
            sharding=parsed["sharding"],
        )
    # v2
    shape = tuple(doc["shape"])
    chunks = tuple(doc["chunks"])
    dtype = np.dtype(doc["dtype"])
    comp = doc.get("compressor")
    compressor = None
    level = 5
    config: dict = {}
    if comp:
        cid = comp.get("id")
        if cid in ("gzip", "zlib"):
            compressor = cid
            level = comp.get("level", 5)
        elif cid == "zstd":
            compressor = "zstd"
            level = comp.get("level", 3)
        elif cid == "lz4":
            compressor = "lz4"
        elif cid == "blosc":
            compressor = "blosc"
            level = comp.get("clevel", 5)
            config = {
                "cname": comp.get("cname", "lz4"),
                "shuffle": comp.get("shuffle", _native.SHUFFLE_BYTE),
                "blocksize": comp.get("blocksize", 0),
            }
        else:
            raise ValueError(
                f"Unsupported zarr v2 compressor '{cid}' for '{name_hint}' "
                "(supported: gzip, zlib, zstd, lz4, blosc, none)"
            )
    if doc.get("filters"):
        raise ValueError(f"zarr v2 filters not supported for '{name_hint}'")
    if doc.get("order", "C") != "C":
        raise ValueError("Only C-order zarr arrays are supported")
    return ArrayMeta(
        shape=shape,
        chunks=chunks,
        dtype=dtype,
        zarr_format=2,
        compressor=compressor,
        compressor_level=level,
        compressor_config=config,
        fill_value=_parse_fill(doc.get("fill_value", 0)),
        separator=doc.get("dimension_separator", "."),
    )


def _parse_fill(value: Any) -> Any:
    """v3 encodes non-finite floats as JSON strings."""
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}.get(
            value, value
        )
    return value


_V3_SHUFFLE = {"noshuffle": 0, "shuffle": 1, "bitshuffle": 2}


def _parse_v3_codec_chain(chain: list, name_hint: str) -> dict:
    """Normalize a zarr v3 ``codecs`` list into decode parameters."""
    out: dict = {
        "endian": "little",
        "compressor": None,
        "level": 5,
        "config": {},
        "checksum": False,
        "sharding": None,
    }
    for codec in chain:
        cname = codec.get("name")
        cfg = codec.get("configuration", {}) or {}
        if cname == "bytes":
            out["endian"] = cfg.get("endian", "little")
        elif cname in ("gzip", "zlib"):
            out["compressor"] = cname
            out["level"] = cfg.get("level", 5)
        elif cname == "zstd":
            out["compressor"] = "zstd"
            out["level"] = cfg.get("level", 3)
        elif cname == "blosc":
            out["compressor"] = "blosc"
            shuffle = cfg.get("shuffle", "shuffle")
            if isinstance(shuffle, str):
                shuffle = _V3_SHUFFLE.get(shuffle, 1)
            out["level"] = cfg.get("clevel", 5)
            out["config"] = {
                "cname": cfg.get("cname", "lz4"),
                "shuffle": shuffle,
                "blocksize": cfg.get("blocksize", 0),
            }
        elif cname == "crc32c":
            out["checksum"] = True
        elif cname == "sharding_indexed":
            inner = _parse_v3_codec_chain(cfg.get("codecs", []), name_hint)
            if inner["sharding"] is not None:
                raise ValueError(
                    f"Nested sharding_indexed not supported for '{name_hint}'"
                )
            out["sharding"] = ShardingSpec(
                inner_chunks=tuple(cfg["chunk_shape"]),
                codecs=list(cfg.get("codecs", [])),
                index_codecs=list(
                    cfg.get(
                        "index_codecs",
                        [{"name": "bytes", "configuration": {"endian": "little"}},
                         {"name": "crc32c"}],
                    )
                ),
                index_location=cfg.get("index_location", "end"),
            )
        else:
            raise ValueError(
                f"Unsupported zarr v3 codec '{cname}' for '{name_hint}' "
                "(supported: bytes, gzip, zlib, zstd, blosc, crc32c, "
                "sharding_indexed)"
            )
    return out


def _v3_dtype_to_numpy(data_type: str) -> str:
    table = {
        "bool": "bool",
        "int8": "i1", "int16": "i2", "int32": "i4", "int64": "i8",
        "uint8": "u1", "uint16": "u2", "uint32": "u4", "uint64": "u8",
        "float16": "f2", "float32": "f4", "float64": "f8",
        "bfloat16": "V2",  # stored raw; caller reinterprets
        "complex64": "c8", "complex128": "c16",
    }
    if data_type not in table:
        raise ValueError(f"Unsupported zarr v3 data_type '{data_type}'")
    return table[data_type]


def _numpy_to_v3_dtype(dtype: np.dtype) -> str:
    table = {
        "bool": "bool",
        "int8": "int8", "int16": "int16", "int32": "int32", "int64": "int64",
        "uint8": "uint8", "uint16": "uint16", "uint32": "uint32",
        "uint64": "uint64",
        "float16": "float16", "float32": "float32", "float64": "float64",
        "complex64": "complex64", "complex128": "complex128",
    }
    name = np.dtype(dtype).name
    if name not in table:
        raise ValueError(f"Cannot express dtype {name} as zarr v3 data_type")
    return table[name]


def _decompress_bytes(
    raw: bytes,
    compressor: Optional[str],
    checksum: bool,
) -> bytes:
    if checksum:
        if len(raw) < 4:
            raise ValueError("crc32c-suffixed chunk shorter than 4 bytes")
        body, stored = raw[:-4], struct.unpack("<I", raw[-4:])[0]
        if _native.crc32c(body) != stored:
            raise ValueError("crc32c checksum mismatch")
        raw = body
    if compressor == "gzip":
        return gzip.decompress(raw)
    if compressor == "zlib":
        return zlib.decompress(raw)
    if compressor == "zstd":
        return _native.zstd_decompress(raw)
    if compressor == "lz4":
        return _native.lz4_decompress(raw)
    if compressor == "blosc":
        return _native.blosc_decompress(raw)
    return raw


def _compress_bytes(
    raw: bytes,
    compressor: Optional[str],
    level: int,
    config: dict,
    checksum: bool,
    typesize: int = 1,
) -> bytes:
    if compressor == "gzip":
        out = gzip.compress(raw, compresslevel=level)
    elif compressor == "zlib":
        out = zlib.compress(raw, level)
    elif compressor == "zstd":
        out = _native.zstd_compress(raw, level)
    elif compressor == "lz4":
        out = _native.lz4_compress(raw)
    elif compressor == "blosc":
        out = _native.blosc_compress(
            raw,
            typesize=typesize,
            cname=config.get("cname", "lz4"),
            clevel=level,
            shuffle=config.get("shuffle", _native.SHUFFLE_BYTE),
            blocksize=config.get("blocksize", 0),
        )
    else:
        out = raw
    if checksum:
        out = out + struct.pack("<I", _native.crc32c(out))
    return out


def decode_chunk(meta: ArrayMeta, raw: Optional[bytes]) -> np.ndarray:
    """Decode one chunk's (or shard's) bytes into a full-size ndarray."""
    if raw is None:
        fill = meta.fill_value if meta.fill_value is not None else 0
        return np.full(meta.chunks, fill, dtype=meta.dtype)
    if meta.sharding is not None:
        return _decode_shard(meta, raw)
    raw = _decompress_bytes(raw, meta.compressor, meta.checksum)
    arr = np.frombuffer(raw, dtype=meta.dtype)
    return arr.reshape(meta.chunks)


def encode_chunk(meta: ArrayMeta, chunk: np.ndarray) -> bytes:
    if meta.sharding is not None:
        return _encode_shard(meta, chunk)
    raw = np.ascontiguousarray(chunk, dtype=meta.dtype).tobytes()
    return _compress_bytes(
        raw,
        meta.compressor,
        meta.compressor_level,
        meta.compressor_config,
        meta.checksum,
        typesize=meta.dtype.itemsize,
    )


# ---- zarr v3 sharding_indexed ------------------------------------------------

_MISSING_CHUNK = 2**64 - 1  # sharding spec: all-ones offset/nbytes = absent


def _shard_grid(meta: ArrayMeta) -> tuple[int, ...]:
    spec = meta.sharding
    assert spec is not None
    for c, i in zip(meta.chunks, spec.inner_chunks):
        if c % i != 0:
            raise ValueError(
                f"shard shape {meta.chunks} not a multiple of inner chunk "
                f"shape {spec.inner_chunks}"
            )
    return tuple(c // i for c, i in zip(meta.chunks, spec.inner_chunks))


def _inner_meta(meta: ArrayMeta) -> ArrayMeta:
    spec = meta.sharding
    assert spec is not None
    parsed = _parse_v3_codec_chain(spec.codecs, "shard-inner")
    dtype = meta.dtype
    if parsed["endian"] == "big" and dtype.byteorder != ">":
        dtype = dtype.newbyteorder(">")
    return ArrayMeta(
        shape=meta.chunks,
        chunks=spec.inner_chunks,
        dtype=dtype,
        zarr_format=3,
        compressor=parsed["compressor"],
        compressor_level=parsed["level"],
        compressor_config=parsed["config"],
        fill_value=meta.fill_value,
        separator="/",
        checksum=parsed["checksum"],
    )


def _index_has_crc(spec: ShardingSpec) -> bool:
    return any(c.get("name") == "crc32c" for c in spec.index_codecs)


def _decode_shard(meta: ArrayMeta, raw: bytes) -> np.ndarray:
    spec = meta.sharding
    assert spec is not None
    grid = _shard_grid(meta)
    n = math.prod(grid)
    index_len = 16 * n + (4 if _index_has_crc(spec) else 0)
    if len(raw) < index_len:
        raise ValueError(
            f"shard of {len(raw)} bytes shorter than its {index_len}-byte index"
        )
    if spec.index_location == "start":
        index_raw = raw[:index_len]
    else:
        index_raw = raw[-index_len:]
    if _index_has_crc(spec):
        body, stored = index_raw[:-4], struct.unpack("<I", index_raw[-4:])[0]
        if _native.crc32c(body) != stored:
            raise ValueError("shard index crc32c mismatch")
        index_raw = body
    offsets = np.frombuffer(index_raw, dtype="<u8").reshape(n, 2)
    inner = _inner_meta(meta)
    out = np.full(
        meta.chunks,
        meta.fill_value if meta.fill_value is not None else 0,
        dtype=meta.dtype,
    )
    for flat, idx in enumerate(np.ndindex(*grid)):
        offset, nbytes = int(offsets[flat, 0]), int(offsets[flat, 1])
        if offset == _MISSING_CHUNK:
            continue
        chunk = decode_chunk(inner, raw[offset : offset + nbytes])
        sl = tuple(
            slice(i * c, (i + 1) * c) for i, c in zip(idx, spec.inner_chunks)
        )
        out[sl] = chunk
    return out


def _encode_shard(meta: ArrayMeta, chunk: np.ndarray) -> bytes:
    spec = meta.sharding
    assert spec is not None
    grid = _shard_grid(meta)
    n = math.prod(grid)
    inner = _inner_meta(meta)
    index = np.empty((n, 2), dtype="<u8")
    blobs: list[bytes] = []
    index_len = 16 * n + (4 if _index_has_crc(spec) else 0)
    pos = index_len if spec.index_location == "start" else 0
    for flat, idx in enumerate(np.ndindex(*grid)):
        sl = tuple(
            slice(i * c, (i + 1) * c) for i, c in zip(idx, spec.inner_chunks)
        )
        blob = encode_chunk(inner, np.ascontiguousarray(chunk[sl]))
        index[flat] = (pos, len(blob))
        blobs.append(blob)
        pos += len(blob)
    index_raw = index.tobytes()
    if _index_has_crc(spec):
        index_raw += struct.pack("<I", _native.crc32c(index_raw))
    body = b"".join(blobs)
    if spec.index_location == "start":
        return index_raw + body
    return body + index_raw


def _normalize_selection(
    meta: ArrayMeta, selection: tuple[slice, ...]
) -> tuple[slice, ...]:
    out = []
    for s, dim in zip(selection, meta.shape):
        start, stop, step = s.indices(dim)
        if step != 1:
            raise ValueError(
                "Strided zarr selections are not supported; read a "
                "contiguous slab and stride in numpy"
            )
        out.append(slice(start, stop))
    return tuple(out)


def assemble(
    meta: ArrayMeta,
    chunks: dict[tuple[int, ...], np.ndarray],
    selection: Optional[tuple[slice, ...]] = None,
) -> np.ndarray:
    """Assemble decoded chunks into (a selection of) the full array.

    Selections must be contiguous (step 1); strided slices raise."""
    sel = selection or tuple(slice(0, s) for s in meta.shape)
    sel = _normalize_selection(meta, sel)
    out_shape = tuple(max(0, s.stop - s.start) for s in sel)
    out = np.empty(out_shape, dtype=meta.dtype)
    for idx, chunk in chunks.items():
        src_slices, dst_slices = [], []
        skip = False
        for d, (ci, csize, s) in enumerate(zip(idx, meta.chunks, sel)):
            c0 = ci * csize
            lo = max(s.start, c0)
            hi = min(s.stop, c0 + csize)
            if lo >= hi:
                skip = True
                break
            src_slices.append(slice(lo - c0, hi - c0))
            dst_slices.append(slice(lo - s.start, hi - s.start))
        if not skip:
            out[tuple(dst_slices)] = chunk[tuple(src_slices)]
    return out


def chunks_for_selection(
    meta: ArrayMeta, selection: tuple[slice, ...]
) -> list[tuple[int, ...]]:
    """Chunk indices intersecting a slice selection."""
    sel = _normalize_selection(meta, selection)
    ranges = []
    for s, csize in zip(sel, meta.chunks):
        if s.stop <= s.start:
            return []
        ranges.append(range(s.start // csize, (s.stop - 1) // csize + 1))
    out: list[tuple[int, ...]] = []

    def rec(dim: int, prefix: tuple[int, ...]) -> None:
        if dim == len(ranges):
            out.append(prefix)
            return
        for i in ranges[dim]:
            rec(dim + 1, prefix + (i,))

    rec(0, ())
    return out


# ---- local write path (hermetic test/app stores) ----------------------------


def _v3_codec_doc(
    compressor: Optional[str], level: int, config: dict
) -> list[dict]:
    codecs: list[dict] = [
        {"name": "bytes", "configuration": {"endian": "little"}}
    ]
    if compressor == "blosc":
        shuffle = config.get("shuffle", 1)
        codecs.append(
            {
                "name": "blosc",
                "configuration": {
                    "cname": config.get("cname", "lz4"),
                    "clevel": level,
                    "shuffle": {0: "noshuffle", 1: "shuffle", 2: "bitshuffle"}[
                        shuffle
                    ],
                    "typesize": config.get("typesize", 1),
                    "blocksize": config.get("blocksize", 0),
                },
            }
        )
    elif compressor == "zstd":
        codecs.append(
            {"name": "zstd", "configuration": {"level": level, "checksum": False}}
        )
    elif compressor:
        codecs.append({"name": compressor, "configuration": {"level": level}})
    return codecs


def write_array(
    root: Path | str,
    name: str,
    data: np.ndarray,
    chunks: Optional[tuple[int, ...]] = None,
    compressor: Optional[str] = None,
    zarr_format: int = 2,
    attributes: Optional[dict] = None,
    compressor_config: Optional[dict] = None,
    inner_chunks: Optional[tuple[int, ...]] = None,
) -> ArrayMeta:
    """Write a numpy array as a zarr array directory under ``root``.

    ``inner_chunks`` (v3 only) wraps the codec chain in
    ``sharding_indexed``: ``chunks`` becomes the shard shape and
    ``inner_chunks`` the read-granularity chunk shape inside it.
    """
    root = Path(root)
    adir = root / name if name else root
    adir.mkdir(parents=True, exist_ok=True)
    chunks = tuple(chunks or data.shape)
    config = dict(compressor_config or {})
    if compressor == "blosc":
        config.setdefault("typesize", data.dtype.itemsize)
    sharding = None
    if inner_chunks is not None:
        if zarr_format != 3:
            raise ValueError("sharding_indexed requires zarr v3")
        sharding = ShardingSpec(
            inner_chunks=tuple(inner_chunks),
            codecs=_v3_codec_doc(compressor, 5, config),
            index_codecs=[
                {"name": "bytes", "configuration": {"endian": "little"}},
                {"name": "crc32c"},
            ],
            index_location="end",
        )
    meta = ArrayMeta(
        shape=tuple(data.shape),
        chunks=chunks,
        dtype=data.dtype,
        zarr_format=zarr_format,
        compressor=None if sharding else compressor,
        compressor_config=config,
        separator="/" if zarr_format == 3 else ".",
        attributes=dict(attributes or {}),
        sharding=sharding,
    )
    if zarr_format == 3:
        if sharding is not None:
            codecs = [
                {
                    "name": "sharding_indexed",
                    "configuration": {
                        "chunk_shape": list(sharding.inner_chunks),
                        "codecs": sharding.codecs,
                        "index_codecs": sharding.index_codecs,
                        "index_location": "end",
                    },
                }
            ]
        else:
            codecs = _v3_codec_doc(compressor, 5, config)
        doc = {
            "zarr_format": 3,
            "node_type": "array",
            "shape": list(data.shape),
            "data_type": _numpy_to_v3_dtype(data.dtype),
            "chunk_grid": {
                "name": "regular",
                "configuration": {"chunk_shape": list(chunks)},
            },
            "chunk_key_encoding": {
                "name": "default",
                "configuration": {"separator": "/"},
            },
            "codecs": codecs,
            "fill_value": 0,
            "attributes": meta.attributes,
        }
        (adir / V3_DOC).write_text(json.dumps(doc))
    else:
        if compressor == "blosc":
            comp_doc: Optional[dict] = {
                "id": "blosc",
                "cname": config.get("cname", "lz4"),
                "clevel": 5,
                "shuffle": config.get("shuffle", 1),
                "blocksize": config.get("blocksize", 0),
            }
        elif compressor == "zstd":
            comp_doc = {"id": "zstd", "level": 3}
        elif compressor == "lz4":
            comp_doc = {"id": "lz4", "acceleration": 1}
        elif compressor:
            comp_doc = {"id": compressor, "level": 5}
        else:
            comp_doc = None
        doc = {
            "zarr_format": 2,
            "shape": list(data.shape),
            "chunks": list(chunks),
            "dtype": data.dtype.str,
            "compressor": comp_doc,
            "fill_value": 0,
            "order": "C",
            "filters": None,
        }
        (adir / V2_ARRAY_DOC).write_text(json.dumps(doc))
        if meta.attributes:
            (adir / V2_ATTRS_DOC).write_text(json.dumps(meta.attributes))
    for idx in meta.chunk_indices():
        sl = tuple(
            slice(i * c, min((i + 1) * c, s))
            for i, c, s in zip(idx, chunks, data.shape)
        )
        chunk = data[sl]
        if chunk.shape != chunks:  # pad edge chunks to full size
            full = np.zeros(chunks, dtype=data.dtype)
            full[tuple(slice(0, e) for e in chunk.shape)] = chunk
            chunk = full
        key_path = adir / meta.chunk_key(idx)
        key_path.parent.mkdir(parents=True, exist_ok=True)
        key_path.write_bytes(encode_chunk(meta, chunk))
    return meta


def write_group(
    root: Path | str, zarr_format: int = 2, attributes: Optional[dict] = None
) -> None:
    """Write group metadata so the directory is a valid zarr hierarchy."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    if zarr_format == 3:
        (root / V3_DOC).write_text(
            json.dumps(
                {
                    "zarr_format": 3,
                    "node_type": "group",
                    "attributes": dict(attributes or {}),
                }
            )
        )
    else:
        (root / V2_GROUP_DOC).write_text(json.dumps({"zarr_format": 2}))
        if attributes:
            (root / V2_ATTRS_DOC).write_text(json.dumps(attributes))
