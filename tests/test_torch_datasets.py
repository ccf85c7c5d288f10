"""The port's datasets plane beside the JAX one, on the CPU.

- ``datasets/codecs.py`` and ``zarr_codec.py``: the committed golden
  frames (``tests/fixtures_codec_golden.json``) decode to the expected
  array through the port as through the JAX package; both compress to the
  same bytes; arrays one package writes, the other reads, and the files
  are byte for byte the same. Both packages agree on which codec libraries
  load. Codecs still work after a ``torch.profiler`` trace in the same
  process (the JAX package's ``RTLD_DEEPBIND`` load, kept in the copy).
- The port's ``DatasetsServer`` read by the JAX ``BioEngineDatasets`` and
  the JAX server read by the port's client: the same dataset and file
  lists, the same bytes and arrays, the same refusals (ACL, expired and
  missing tokens, missing files).
- ``ChunkCache``: one sequence of puts, gets and resizes gives the same
  hits, misses, sizes and surviving keys in both packages.
"""

import base64
import functools
import gzip
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import httpx
import numpy as np
import pytest

from _torch_parity import few_torch_threads  # noqa: F401
from bioengine_tpu.datasets import chunk_cache as jax_chunk_cache
from bioengine_tpu.datasets import codecs as jax_codecs
from bioengine_tpu.datasets import datasets as jax_datasets
from bioengine_tpu.datasets import proxy_server as jax_proxy
from bioengine_tpu.datasets import zarr_codec as jax_zarr
from bioengine_tpu.rpc.server import RpcServer as JaxRpcServer
from bioengine_tpu_torch.datasets import chunk_cache as torch_chunk_cache
from bioengine_tpu_torch.datasets import codecs as torch_codecs
from bioengine_tpu_torch.datasets import datasets as torch_datasets
from bioengine_tpu_torch.datasets import proxy_server as torch_proxy
from bioengine_tpu_torch.datasets import zarr_codec as torch_zarr
from bioengine_tpu_torch.rpc.server import RpcServer as TorchRpcServer

pytestmark = [pytest.mark.integration, pytest.mark.anyio]

REPO = Path(__file__).resolve().parent.parent
GOLDEN = json.loads((Path(__file__).parent / "fixtures_codec_golden.json").read_text())
PACKAGES = {
    "jax": SimpleNamespace(
        codecs=jax_codecs, zarr=jax_zarr, Datasets=jax_datasets.BioEngineDatasets,
        DatasetsServer=jax_proxy.DatasetsServer, token_validator=jax_proxy.rpc_token_validator,
        RpcServer=JaxRpcServer, ChunkCache=jax_chunk_cache.ChunkCache,
    ),
    "torch": SimpleNamespace(
        codecs=torch_codecs, zarr=torch_zarr, Datasets=torch_datasets.BioEngineDatasets,
        DatasetsServer=torch_proxy.DatasetsServer, token_validator=torch_proxy.rpc_token_validator,
        RpcServer=TorchRpcServer, ChunkCache=torch_chunk_cache.ChunkCache,
    ),
}
CROSS = [("torch", "jax"), ("jax", "torch")]  # (server package, client package)


# ---- codecs -----------------------------------------------------------------


def _golden_decoders(codecs):
    decoders = {"zstd_frame": codecs.zstd_decompress, "lz4_numcodecs": codecs.lz4_decompress}
    if codecs.blosc_available():
        for key in ("blosc_lz4_shuffle", "blosc_zstd_bitshuffle", "blosc_blosclz_noshuffle"):
            decoders[key] = codecs.blosc_decompress
    return decoders


def test_codec_libraries_load_alike():
    assert torch_codecs.blosc_available() == jax_codecs.blosc_available()
    assert sorted(_golden_decoders(torch_codecs)) == sorted(_golden_decoders(jax_codecs))


@pytest.mark.parametrize("key", ["zstd_frame", "lz4_numcodecs", "blosc"])
def test_golden_frames_decode(key):
    expected = np.arange(96, dtype=GOLDEN["expected_dtype"]).reshape(GOLDEN["expected_shape"])
    decoders = _golden_decoders(torch_codecs)
    ref = _golden_decoders(jax_codecs)
    keys = [k for k in decoders if k.startswith(key)]
    assert keys or (key == "blosc" and not jax_codecs.blosc_available())
    for k in keys:
        frame = base64.b64decode(GOLDEN[k])
        assert decoders[k](frame) == ref[k](frame) == expected.tobytes(), k


def test_compressors_write_the_same_bytes():
    data = np.random.default_rng(0).integers(0, 500, size=4096, dtype=np.uint16).tobytes()
    assert torch_codecs.zstd_compress(data, 5) == jax_codecs.zstd_compress(data, 5)
    assert torch_codecs.lz4_compress(data) == jax_codecs.lz4_compress(data)
    assert torch_codecs.crc32c(data) == jax_codecs.crc32c(data)
    if jax_codecs.blosc_available():
        assert torch_codecs.blosc_compress(data) == jax_codecs.blosc_compress(data)


def _read(zarr, root: Path):
    meta = zarr.parse_array_meta(
        next(p for p in root.iterdir() if p.name in (".zarray", "zarr.json")).read_bytes())
    chunks = {}
    for idx in meta.chunk_indices():
        p = root / meta.chunk_key(idx)
        chunks[idx] = zarr.decode_chunk(meta, p.read_bytes() if p.exists() else None)
    return zarr.assemble(meta, chunks)


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("zarr_format, compressor", [
    (2, None), (2, "gzip"), (2, "zlib"), (2, "zstd"), (2, "lz4"),
    (3, None), (3, "gzip"), (3, "zstd"),
])
def test_zarr_arrays_cross_packages(tmp_path, monkeypatch, zarr_format, compressor):
    # a gzip member's header holds the wall-clock second it was written:
    # both packages write at one pinned second, else the two trees differ
    # whenever their writes straddle a second boundary
    monkeypatch.setattr(gzip, "compress", functools.partial(gzip.compress, mtime=1_700_000_000))
    data = np.random.default_rng(zarr_format).normal(size=(20, 30)).astype(np.float32)
    written = {}
    for writer in ("jax", "torch"):
        root = tmp_path / writer
        PACKAGES[writer].zarr.write_array(root, "arr", data, chunks=(8, 16),
                                          compressor=compressor, zarr_format=zarr_format)
        written[writer] = _tree(root)
        for reader in ("jax", "torch"):
            np.testing.assert_array_equal(_read(PACKAGES[reader].zarr, root / "arr"), data)
    assert written["torch"] == written["jax"]


def test_codecs_after_a_torch_profiler_trace():
    """A torch.profiler trace, then zstd/lz4 (and blosc where it loads) in
    the same process, in a subprocess of its own."""
    code = """
import os, torch
from bioengine_tpu_torch.datasets import codecs
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    torch.ones(64, 64).sum()
prof.export_chrome_trace(os.path.join(os.environ["TRACE_DIR"], "trace.json"))
data = os.urandom(1 << 16)
assert codecs.zstd_decompress(codecs.zstd_compress(data, 5)) == data
assert codecs.lz4_decompress(codecs.lz4_compress(data)) == data
if codecs.blosc_available():
    assert codecs.blosc_decompress(codecs.blosc_compress(data)) == data
print("codecs-after-profiler OK")
"""
    with tempfile.TemporaryDirectory() as d:
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=120, cwd=REPO, env={**os.environ, "TRACE_DIR": d})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "codecs-after-profiler OK" in proc.stdout


# ---- server and client across packages --------------------------------------


def _write_data_dir(zarr, data_dir: Path) -> np.ndarray:
    demo = data_dir / "demo"
    demo.mkdir(parents=True)
    (demo / "manifest.yaml").write_text("description: demo dataset\nauthorized_users: ['*']\n")
    images = (np.random.default_rng(1).normal(size=(16, 8, 8)) * 100).astype(np.int16)
    zarr.write_group(demo / "images.zarr")
    zarr.write_array(demo / "images.zarr", "raw", images, chunks=(4, 8, 8), compressor="zstd")
    (demo / "notes.txt").write_bytes(b"hello bioengine")
    private = data_dir / "secret"
    private.mkdir()
    (private / "manifest.yaml").write_text("description: private\nauthorized_users: ['alice']\n")
    (private / "blob.bin").write_bytes(b"secret bytes")
    return images


async def _observe(server_pkg, client_pkg, tmp_path) -> dict:
    images = _write_data_dir(server_pkg.zarr, tmp_path / "data")
    rpc = server_pkg.RpcServer(admin_users=["alice"])
    alice = rpc.issue_token("alice")
    expired = rpc.issue_token("alice", ttl_seconds=-1)
    server = server_pkg.DatasetsServer(tmp_path / "data", host="127.0.0.1",
                                       token_validator=server_pkg.token_validator(rpc),
                                       write_discovery_file=False)
    await server.start()
    seen = {}
    try:
        anon = client_pkg.Datasets(server_url=server.url, log_file="off")
        authed = client_pkg.Datasets(server_url=server.url, token=alice, log_file="off")
        try:
            seen["ping"] = await anon.ping()
            seen["anon_datasets"] = [d["name"] for d in await anon.list_datasets()]
            seen["alice_datasets"] = [d["name"] for d in await authed.list_datasets()]
            seen["files"] = sorted((f["name"], f.get("size")) for f in await anon.list_files("demo"))
            seen["notes"] = await anon.get_file("demo", "notes.txt")
            group = await anon.get_file("demo", "images.zarr")
            arr = await group.array("raw")
            seen["shape"] = tuple(arr.shape)
            whole = await arr.read()
            np.testing.assert_array_equal(whole, images)
            seen["whole"] = whole.tobytes()
            seen["part"] = (await arr.read((slice(2, 9), slice(1, 5), slice(0, 8)))).tobytes()
            seen["secret_alice"] = await authed.get_file("secret", "blob.bin")
            for name, call in (
                ("secret_anon", lambda: anon.get_file("secret", "blob.bin")),
                ("missing_file", lambda: anon.get_file("demo", "missing.bin")),
            ):
                with pytest.raises(Exception) as exc:
                    await call()
                seen[name] = type(exc.value).__name__
            async with httpx.AsyncClient() as http:
                url = f"{server.url}/data/secret/blob.bin"
                for name, headers in (("anon", {}), ("alice", {"Authorization": f"Bearer {alice}"}),
                                      ("expired", {"Authorization": f"Bearer {expired}"}),
                                      ("unknown", {"Authorization": "Bearer not-a-token"})):
                    r = await http.get(url, headers=headers)
                    seen[f"http_{name}"] = r.status_code
        finally:
            await anon.aclose()
            await authed.aclose()
    finally:
        await server.stop()
    return seen


@pytest.mark.parametrize("server, client", CROSS, ids=lambda p: p)
async def test_server_and_client_across_packages(server, client, tmp_path):
    seen = await _observe(PACKAGES[server], PACKAGES[client], tmp_path / "cross")
    assert seen == await _observe(PACKAGES["jax"], PACKAGES["jax"], tmp_path / "ref")
    assert seen["anon_datasets"] == ["demo"]
    assert seen["notes"] == b"hello bioengine"
    assert seen["secret_alice"] == b"secret bytes"
    assert (seen["http_anon"], seen["http_alice"], seen["http_expired"]) == (403, 200, 401)
    assert seen["missing_file"] == "FileNotFoundError"


# ---- chunk cache ------------------------------------------------------------


async def _cache_trace(ChunkCache) -> list:
    cache = ChunkCache(max_bytes=100)
    trace = []
    ops = [("put", "a", 40), ("put", "b", 40), ("get", "a"), ("put", "c", 40), ("get", "b"),
           ("get", "a"), ("get", "c"), ("put", "big", 101), ("get", "big"), ("put", "a", 30),
           ("resize", 70), ("get", "c"), ("get", "a"), ("put", "d", 10), ("clear",), ("get", "d")]
    for op in ops:
        if op[0] == "put":
            await cache.put(op[1], op[1].encode() * op[2])
        elif op[0] == "get":
            value = await cache.get(op[1])
            trace.append(None if value is None else len(value))
        elif op[0] == "resize":
            await cache.resize(op[1])
        else:
            await cache.clear()
        trace.append((op[0], cache.size_bytes, len(cache), cache.hits, cache.misses))
    return trace


async def test_chunk_cache_lru_alike():
    trace = await _cache_trace(torch_chunk_cache.ChunkCache)
    assert trace == await _cache_trace(jax_chunk_cache.ChunkCache)
    assert trace[1] == ("put", 80, 2, 0, 0) and trace[5] is None  # "b" was evicted
