"""The port's device prefetch (``datasets/prefetch.py``) beside the JAX
package's, on the CPU: ``test_datasets.py``'s ``test_prefetch_to_device_order``
and ``test_zarr_batch_loader`` with ``device="cpu"``, the pytrees that
``jax.tree_util`` walks, how many host batches each keeps in flight, and
the entry points' device rules. The pinned copies on a copy stream run only
on the card, where ``chip_smoke.py`` checks them.
"""

import asyncio
import collections

import jax
import numpy as np
import pytest
import torch

from bioengine_tpu.datasets import prefetch as jax_prefetch
from bioengine_tpu.parallel.mesh import make_mesh as jax_make_mesh
from jax.sharding import NamedSharding, PartitionSpec as JP
from bioengine_tpu.datasets.http_zarr_store import HttpZarrStore as JaxStore
from bioengine_tpu.datasets.http_zarr_store import RemoteZarrArray as JaxArray
from bioengine_tpu_torch.parallel.data_parallel import Replicated, Shards
from bioengine_tpu_torch.parallel.mesh import make_mesh, replicated, sharding
from bioengine_tpu_torch.datasets import (
    ChunkCache,
    DatasetsServer,
    HttpZarrStore,
    RemoteZarrArray,
    ZarrBatchLoader,
    prefetch_to_device,
    zarr_codec,
)

from _torch_parity import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.anyio

Pair = collections.namedtuple("Pair", "image mask")


def _leaves(tree):
    if isinstance(tree, dict):
        return {k: _leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_leaves(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return np.asarray(tree)


def _same(a, b) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("size", [1, 2, 3, 7])
def test_prefetch_to_device_order(size):
    batches = [np.full((2, 2), i, np.float32) for i in range(5)]
    ours = list(prefetch_to_device(iter(batches), size=size, device="cpu"))
    ref = list(jax_prefetch.prefetch_to_device(iter(batches), size=size))
    assert len(ours) == len(ref) == 5
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), batches[i])
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pytrees_of_batches_keep_structure_and_values():
    rng = np.random.default_rng(0)
    batches = [
        {"image": rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
         "labels": [rng.integers(0, 9, size=4).astype(np.int32), (rng.random(4) > 0.5)],
         "pair": Pair(rng.normal(size=(2,)).astype(np.float64), np.arange(3, dtype=np.uint16))}
        for _ in range(3)
    ]
    ours = [_leaves(b) for b in prefetch_to_device(iter(batches), size=2, device="cpu")]
    ref = [_leaves(b) for b in jax_prefetch.prefetch_to_device(iter(batches), size=2)]
    for a, b, src in zip(ours, ref, batches):
        assert _same(a, _leaves(src))
        assert type(b["pair"]) is Pair and type(a["pair"]) is Pair
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["image"], b["image"])


def test_batches_in_flight_match_the_jax_prefetch():
    """How many host batches each prefetch has drawn after each batch it
    yields: ``size`` ahead, as the JAX generator keeps them."""

    def drawn_after_each(fn):
        count = [0]

        def source():
            for i in range(6):
                count[0] += 1
                yield np.full((1,), i, np.int64)

        seen = []
        for _ in fn(source()):
            seen.append(count[0])
        return seen

    for size in (1, 2, 4):
        ours = drawn_after_each(lambda it: prefetch_to_device(it, size=size, device="cpu"))
        ref = drawn_after_each(lambda it: jax_prefetch.prefetch_to_device(it, size=size))
        assert ours == ref, size


def test_device_rules(monkeypatch):
    # a placement over a CPU mesh places every leaf over it, whatever
    # ``device`` says; a spec may split any one dimension over one axis of
    # a mesh of several, or two dimensions over two axes, placed as JAX's
    # ``addressable_shards``; a spec naming one axis twice raises a
    # ``ValueError`` (``DuplicateSpecError``, as JAX names it)
    mesh = make_mesh({"dp": 2}, ["cpu", "cpu"])
    (batch,) = prefetch_to_device(iter([np.arange(4)]), device="cuda", sharding=sharding(mesh, "dp"))
    assert isinstance(batch, Shards) and [t.tolist() for t in batch] == [[0, 1], [2, 3]]
    x = np.arange(16).reshape(2, 8)
    mesh4 = make_mesh({"dp": 2, "sp": 2}, ["cpu"] * 4)
    (ours,) = prefetch_to_device(iter([x]), sharding=sharding(mesh4, None, "sp"))
    jmesh = jax_make_mesh({"dp": 2, "sp": 2}, jax.devices()[:4])
    (theirs,) = jax_prefetch.prefetch_to_device(iter([x]), sharding=NamedSharding(jmesh, JP(None, "sp")))
    jshards = sorted(theirs.addressable_shards, key=lambda s: s.device.id)
    assert [t.tolist() for t in ours] == [np.asarray(s.data).tolist() for s in jshards]
    assert ours.gather().tolist() == x.tolist()
    (ours,) = prefetch_to_device(iter([x]), sharding=sharding(mesh4, "dp", "sp"))
    (theirs,) = jax_prefetch.prefetch_to_device(iter([x]), sharding=NamedSharding(jmesh, JP("dp", "sp")))
    jshards = sorted(theirs.addressable_shards, key=lambda s: s.device.id)
    assert [t.tolist() for t in ours] == [np.asarray(s.data).tolist() for s in jshards]
    assert ours.gather().tolist() == x.tolist()
    with pytest.raises(ValueError, match="names the mesh axis 'sp' twice"):
        list(prefetch_to_device(iter([np.zeros((2, 2))]), sharding=sharding(mesh4, "sp", "sp")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            prefetch_to_device(iter([np.zeros(2)]), device=device)
    assert list(prefetch_to_device(iter([]), device="cpu")) == []


@pytest.mark.parametrize("spec", [(("dp", "sp"),), (("sp", "dp"), None), (None, ("dp", "sp")), ("dp", ("sp", "tp"))],
                         ids=["dp_sp", "sp_dp", "columns_dp_sp", "dp_then_sp_tp"])
def test_tuple_axis_placement_matches_jax(spec):
    """A dimension split over a tuple of axes (their product, row-major):
    each entry's part equals JAX's ``addressable_shards`` through both
    packages' ``prefetch_to_device``."""
    axes = {"dp": 2, "sp": 2, "tp": 2}
    x = np.arange(8 * 8 * 3).reshape(8, 8, 3)
    mesh = make_mesh(axes, ["cpu"] * 8)
    (ours,) = prefetch_to_device(iter([x]), sharding=sharding(mesh, *spec))
    jmesh = jax_make_mesh(axes, jax.devices()[:8])
    (theirs,) = jax_prefetch.prefetch_to_device(iter([x]), sharding=NamedSharding(jmesh, JP(*spec)))
    jshards = sorted(theirs.addressable_shards, key=lambda s: s.device.id)
    assert [t.tolist() for t in ours] == [np.asarray(s.data).tolist() for s in jshards]
    assert ours.gather().tolist() == x.tolist()


@pytest.fixture()
async def data_server(tmp_path):
    """``test_datasets.py``'s dataset, served by the port's datasets plane."""
    ds_dir = tmp_path / "data" / "demo"
    ds_dir.mkdir(parents=True)
    (ds_dir / "manifest.yaml").write_text("description: demo dataset\nauthorized_users: ['*']\n")
    rng = np.random.default_rng(1)
    images = (rng.normal(size=(16, 8, 8)) * 100).astype(np.int16)
    zarr_codec.write_group(ds_dir / "images.zarr")
    zarr_codec.write_array(ds_dir / "images.zarr", "raw", images, chunks=(4, 8, 8), compressor="gzip")
    server = DatasetsServer(tmp_path / "data", host="127.0.0.1", write_discovery_file=False)
    await server.start()
    try:
        yield server, images
    finally:
        await server.stop()


async def _open(store_cls, array_cls, url: str):
    """Open the array here. The JAX store's client is closed after: its
    loader reads on its own thread's event loop, where a connection pooled
    on this loop cannot be used (a fresh client is made there on first
    read; ROADMAP C4). The port's store keeps a client per loop (C5)."""
    store = store_cls(url)
    arr = await array_cls.open(store, "raw")
    if store_cls is JaxStore:
        await store.aclose()
    return arr


async def test_zarr_batch_loader(data_server):
    server, images = data_server
    url = f"{server.url}/data/demo/images.zarr"
    arr = await _open(HttpZarrStore, RemoteZarrArray, url)
    jax_arr = await _open(JaxStore, JaxArray, url)
    loader = ZarrBatchLoader(arr, batch_size=4, prefetch_batches=2, device="cpu")
    jax_loader = jax_prefetch.ZarrBatchLoader(jax_arr, batch_size=4, prefetch_batches=2)
    assert len(loader) == len(jax_loader) == 4

    def consume(it):
        return [np.asarray(b) for b in it]

    got = await asyncio.to_thread(consume, loader)
    ref = await asyncio.to_thread(consume, jax_loader)
    assert len(got) == 4 and all(g.dtype == np.int16 for g in got)
    np.testing.assert_array_equal(np.concatenate(got, axis=0), images)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


async def test_zarr_batch_loader_remainder_and_indices(data_server):
    server, images = data_server
    arr = await _open(HttpZarrStore, RemoteZarrArray, f"{server.url}/data/demo/images.zarr")
    order = [15, 0, 7, 3, 9, 12, 1]
    loader = ZarrBatchLoader(arr, batch_size=3, indices=order, prefetch_batches=1,
                             drop_remainder=False, device="cpu")
    assert len(loader) == 3
    got = await asyncio.to_thread(lambda: [b.numpy() for b in loader])
    assert [len(b) for b in got] == [3, 3, 1]
    np.testing.assert_array_equal(np.concatenate(got), images[order])


def test_zarr_batch_loader_defaults_to_cuda(monkeypatch):
    import inspect

    assert inspect.signature(ZarrBatchLoader).parameters["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class _Array:
        shape = (4, 2)

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ZarrBatchLoader(_Array(), batch_size=2)
    assert ZarrBatchLoader(_Array(), batch_size=2, device="cpu").device == torch.device("cpu")


async def test_streamed_crops_embed_as_the_app_embeds_them(tmp_path):
    """The prefetch route of ``chip_smoke.py`` on the CPU at a narrow ViT:
    224^2 RGB uint8 crops served by the datasets plane, streamed by
    ``ZarrBatchLoader(device="cpu")``, scaled by ``model_input`` and
    embedded by ``ViTEmbedder.embed_tensor``, equal bit for bit to
    ``embed_batch`` of the raw crops (the app's host route). The dataset
    holds each crop as ``to_rgb_uint8`` makes it, and ``model_input`` is
    the rest of ``to_model_input``."""
    from bioengine_tpu_torch.apps.cell_image_search.embedder import ViTEmbedder, model_input
    from bioengine_tpu_torch.apps.cell_image_search.normalizer import to_model_input, to_rgb_uint8

    rng = np.random.default_rng(4)
    raw = rng.gamma(2.0, 300.0, size=(10, 224, 224, 3)).astype(np.uint16)
    crops = np.stack([to_rgb_uint8(c) for c in raw])
    assert np.array_equal(model_input(torch.from_numpy(crops)).numpy(), np.stack([to_model_input(c) for c in raw]))
    ds = tmp_path / "data" / "crops"
    ds.mkdir(parents=True)
    (ds / "manifest.yaml").write_text("description: crops\nauthorized_users: ['*']\n")
    zarr_codec.write_group(ds / "crops.zarr")
    zarr_codec.write_array(ds / "crops.zarr", "rgb", crops, chunks=(1, 224, 224, 3))
    server = DatasetsServer(tmp_path / "data", host="127.0.0.1", write_discovery_file=False)
    await server.start()
    try:
        store = HttpZarrStore(f"{server.url}/data/crops/crops.zarr")
        arr = await RemoteZarrArray.open(store, "rgb")
        emb = ViTEmbedder(device="cpu", batch_bucket=4, seed=2,
                          model_overrides={"dim": 32, "depth": 2, "num_heads": 2, "patch_size": 28})
        loader = ZarrBatchLoader(arr, batch_size=4, prefetch_batches=2, drop_remainder=False, device="cpu")
        streamed = await asyncio.to_thread(
            lambda: torch.cat([emb.embed_tensor(model_input(b)) for b in loader]).numpy())
        await store.aclose()
    finally:
        await server.stop()
    whole = emb.embed_batch(list(raw))
    assert streamed.shape == whole.shape == (10, 32)
    assert np.array_equal(streamed, whole)
    assert emb.forward_count == 6  # 3 streamed batches, 3 buckets of the whole


async def test_zarr_batch_loader_over_an_array_opened_on_this_loop(data_server):
    """The loader reads on its own thread's event loop. An array opened
    here, its store's client left open, over a cold chunk cache: every row
    is fetched over HTTP on the loader's loop, through a client of that
    loop's own (ROADMAP C5)."""
    server, images = data_server
    store = HttpZarrStore(f"{server.url}/data/demo/images.zarr", cache=ChunkCache())
    arr = await RemoteZarrArray.open(store, "raw")
    try:
        loader = ZarrBatchLoader(arr, batch_size=4, prefetch_batches=2, device="cpu")
        got = await asyncio.to_thread(lambda: [b.numpy() for b in loader])
        np.testing.assert_array_equal(np.concatenate(got), images)
        # and the store still reads on this loop afterwards
        np.testing.assert_array_equal(await arr.read(), images)
    finally:
        await store.aclose()


async def test_jax_loader_over_an_array_opened_on_this_loop_fails(data_server):
    """The JAX behaviour beside the port's fix (ROADMAP C4, C5): the JAX
    store keeps one client across loops, so its loader over an array opened
    here, over a cold chunk cache, fails on the loader's loop."""
    from bioengine_tpu.datasets.chunk_cache import ChunkCache as JaxChunkCache

    server, _ = data_server
    store = JaxStore(f"{server.url}/data/demo/images.zarr", cache=JaxChunkCache())
    arr = await JaxArray.open(store, "raw")
    loader = jax_prefetch.ZarrBatchLoader(arr, batch_size=4, prefetch_batches=2)
    with pytest.raises(RuntimeError, match="different event loop"):
        await asyncio.to_thread(lambda: [np.asarray(b) for b in loader])
    # the client's pool now holds a connection of the loader's closed loop,
    # so it is not closed here


@pytest.mark.parametrize("width", [2, 4])
async def test_zarr_batch_loader_with_a_placement(data_server, width):
    """``ZarrBatchLoader(sharding=)`` over a CPU mesh: each batch arrives
    as ``shard_batch`` lays it out, ``width`` equal shards in order; under
    ``replicated`` every entry holds the whole batch."""
    server, images = data_server
    arr = await _open(HttpZarrStore, RemoteZarrArray, f"{server.url}/data/demo/images.zarr")
    mesh = make_mesh({"dp": width}, ["cpu"] * width)
    loader = ZarrBatchLoader(arr, batch_size=4, prefetch_batches=2, sharding=sharding(mesh, "dp"))
    assert loader.device == torch.device("cpu")
    got = await asyncio.to_thread(lambda: list(loader))
    assert all(isinstance(b, Shards) and len(b) == width for b in got)
    assert all(s.shape[0] == 4 // width for b in got for s in b)
    np.testing.assert_array_equal(np.concatenate([b.gather().numpy() for b in got]), images)
    rep = ZarrBatchLoader(arr, batch_size=4, prefetch_batches=1, sharding=replicated(mesh))
    got = await asyncio.to_thread(lambda: list(rep))
    assert all(isinstance(b, Replicated) and len(b) == width for b in got)
    for i, b in enumerate(got):
        for copy in b:
            np.testing.assert_array_equal(copy.numpy(), images[4 * i : 4 * i + 4])
    await arr.store.aclose()


def test_prefetch_with_a_placement_keeps_the_tree():
    """A pytree of host batches placed over a CPU mesh of 4: each leaf as
    ``shard_batch`` places it, the tree's structure kept; a leaf whose
    leading dimension does not divide raises as JAX's sharded put does."""
    from bioengine_tpu_torch.parallel.data_parallel import shard_batch

    rng = np.random.default_rng(3)
    mesh = make_mesh({"dp": 4}, ["cpu"] * 4)
    batches = [{"image": rng.normal(size=(8, 4, 4, 2)).astype(np.float32),
                "pair": Pair(rng.integers(0, 9, size=8), np.arange(8.0))} for _ in range(3)]
    got = list(prefetch_to_device(iter(batches), size=2, sharding=sharding(mesh, "dp")))
    for g, b in zip(got, batches):
        ref = shard_batch(mesh, {"image": torch.from_numpy(b["image"]),
                                 "pair": Pair(*(torch.from_numpy(x) for x in b["pair"]))})
        assert type(g["pair"]) is Pair and isinstance(g["image"], Shards)
        for leaf, want in ((g["image"], ref["image"]), (g["pair"].image, ref["pair"].image),
                           (g["pair"].mask, ref["pair"].mask)):
            assert len(leaf) == 4 and all(torch.equal(a, w) for a, w in zip(leaf, want))
    with pytest.raises(ValueError, match="does not divide"):
        list(prefetch_to_device(iter([np.zeros((6, 2))]), sharding=sharding(mesh, "dp")))
