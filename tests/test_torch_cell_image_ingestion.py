"""The PyTorch port's cell-image-search ingestion and app against the JAX
app's, on the CPU.

- Status files, stop files and the dataset registry written by the same
  call sequence through both modules: equal, ``updated_at`` aside.
- ``iter_local_images`` over a directory of npy/npz/png, and
  ``iter_dataset_images`` over one fake datasets client used by both apps:
  the same names and arrays.
- ``run_ingestion`` of one synthetic dataset through both modules, the JAX
  app's with its CPU embedder's arithmetic (a tiny flax ViT, XLA attention)
  and the port's with the same weights bridged: the same metadata rows and
  session status, embeddings within the slice's 1e-3.
- The flow of ``TestCellImageSearchApp`` (``tests/test_cell_image_search.py``:
  full flow, stop, unknown dataset) on ``CellImageSearch(device="cpu")``,
  plus ``image_bytes`` and the datasets source.
"""

import asyncio
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu.models.vit import ViT as JaxViT
from bioengine_tpu.runtime.convert import save_params_npz
from bioengine_tpu_torch.apps.cell_image_search import index as port_index
from bioengine_tpu_torch.apps.cell_image_search import ingestion as port_ingestion
from bioengine_tpu_torch.apps.cell_image_search.embedder import ViTEmbedder
from bioengine_tpu_torch.apps.cell_image_search.service import CellImageSearch

APP_DIR = Path(__file__).resolve().parent.parent / "apps" / "cell-image-search"
# 224² crops through a 28-pixel patch: 65 tokens, dim 64
TINY = dict(patch_size=28, dim=64, depth=2, num_heads=2)
EMB_TOL = 1e-3
# status fields that carry the wall clock
CLOCK_FIELDS = {"updated_at", "elapsed_seconds", "throughput_per_sec", "eta_seconds"}


def _load(stem):
    """Import an app module by its bare stem name, as the app loader does."""
    if stem in sys.modules:
        return sys.modules[stem]
    spec = importlib.util.spec_from_file_location(stem, APP_DIR / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[stem] = mod
    spec.loader.exec_module(mod)
    return mod


jax_normalizer = _load("normalizer")
jax_ingestion = _load("ingestion")
jax_index = _load("index")


def _status_file(ws, sid):
    data = json.loads((ws / "sessions" / sid / "status.json").read_text())
    return {k: v for k, v in data.items() if k not in CLOCK_FIELDS}


def test_status_stop_and_registry_files_match_jax(tmp_path):
    ws = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    for name, mod in (("jax", jax_ingestion), ("port", port_ingestion)):
        w = ws[name]
        assert mod.read_status(w, "s") == {"status": "waiting", "message": "Not started"}
        mod.write_status(w, "s", mod.IngestionStatus.PREPARING, "prep", dataset_name="d")
        mod.write_status(w, "s", mod.IngestionStatus.RUNNING, "run", n_embedded=5,
                         n_total=20, throughput_per_sec=2.5, elapsed_seconds=2.0,
                         log_lines=["a", "b"])
        # a terminal write keeps the counters and the log
        mod.write_status(w, "s", mod.IngestionStatus.FAILED, "boom", log_lines=["c"], extra=1)
        assert not mod.is_stop_requested(w, "s")
        mod.request_stop(w, "s")
        assert mod.is_stop_requested(w, "s")
        (w / "sessions" / "bad").mkdir(parents=True)
        (w / "sessions" / "bad" / "status.json").write_text("{not json")
        mod.upsert_registry(w, {"name": "a", "source": "synthetic"})
        mod.upsert_registry(w, {"name": "b", "source": "local", "path": "/x"})
        mod.upsert_registry(w, {"name": "a", "source": "datasets"})
        mod.save_registry(w, mod.load_registry(w)[:1] + [{"name": "c"}])
    assert _status_file(ws["port"], "s") == _status_file(ws["jax"], "s")
    got = port_ingestion.read_status(ws["port"], "s")
    assert got["status"] == "failed" and got["n_embedded"] == 5 and got["log_tail"] == ["a", "b", "c"]
    assert port_ingestion.read_status(ws["port"], "bad") == jax_ingestion.read_status(ws["jax"], "bad")
    assert (ws["port"] / "sessions" / "s" / "stop_requested").read_text() == "1"
    assert port_ingestion.load_registry(ws["port"]) == jax_ingestion.load_registry(ws["jax"])
    assert (ws["port"] / "dataset_registry.json").read_text() == (
        ws["jax"] / "dataset_registry.json").read_text()
    assert not list(ws["port"].rglob("*.tmp"))


def _png_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_iter_local_images_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "sub").mkdir()
    np.save(tmp_path / "a.npy", rng.normal(size=(40, 30)).astype(np.float32))
    np.savez(tmp_path / "sub" / "b.npz", x=rng.integers(0, 9, (8, 8)), y=np.ones((3, 4, 5)))
    (tmp_path / "c.png").write_bytes(_png_bytes(rng.integers(0, 255, (16, 12, 3)).astype(np.uint8)))
    (tmp_path / "notes.txt").write_text("skip me")
    got = list(port_ingestion.iter_local_images(tmp_path))
    ref = list(jax_ingestion.iter_local_images(tmp_path))
    assert [n for n, _ in got] == [n for n, _ in ref] == ["a.npy", "c.png", "b.npz:x", "b.npz:y"]
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)


class FakeArray:
    def __init__(self, data):
        self.data = data
        self.ndim, self.shape = data.ndim, data.shape

    async def read(self, sel=None):
        return self.data if sel is None else self.data[sel]


class FakeGroup:
    def __init__(self, arrays):
        self.arrays = arrays

    async def members(self):
        return list(self.arrays)

    async def array(self, name):
        return self.arrays[name]


class FakeDatasetsClient:
    """What the ingestion asks of the datasets plane: list_files/get_file,
    and for the app list_datasets/available."""

    available = True

    def __init__(self):
        rng = np.random.default_rng(1)
        self.files = {
            "plane.zarr": FakeArray(rng.normal(size=(128, 128)).astype(np.float32)),
            "group.zarr": FakeGroup({
                "channels": FakeArray(rng.normal(size=(3, 72, 72)).astype(np.float32)),
                "stack": FakeArray(rng.normal(size=(7, 80, 80)).astype(np.float32)),
            }),
            "field.png": _png_bytes(rng.integers(0, 255, (96, 96)).astype(np.uint8)),
            "readme.md": b"skip",
        }

    async def list_datasets(self):
        return [{"name": "plates"}]

    async def list_files(self, dataset_name):
        return [{"name": n} for n in self.files]

    async def get_file(self, dataset_name, fname):
        return self.files[fname]


def test_iter_dataset_images_matches_jax():
    client = FakeDatasetsClient()

    async def collect(mod):
        return [item async for item in mod.iter_dataset_images(client, "plates")]

    got = asyncio.run(collect(port_ingestion))
    ref = asyncio.run(collect(jax_ingestion))
    assert [n for n, _ in got] == [n for n, _ in ref]
    assert len(got) == 1 + 1 + 7 + 1
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)


class JaxCpuEmbedder:
    """The JAX app's embedder arithmetic on the CPU backend (XLA attention,
    as ``ViTEmbedder`` picks off a TPU), on a tiny seeded f32 ViT whose
    weights it writes for the port to load."""

    batch_bucket = 4

    def __init__(self, weights_path):
        model = JaxViT(**TINY, dtype=jnp.float32)
        self.params = seeded_flax_params(model, (1, 224, 224, 3), seed=5)
        save_params_npz(weights_path, self.params)
        self.apply = jax.jit(model.apply)

    def embed_batch(self, images, batch_size=None):
        prepped = np.stack([jax_normalizer.to_model_input(c) for c in images])
        emb = np.asarray(self.apply({"params": self.params}, jnp.asarray(prepped)))
        return emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-9)


def test_run_ingestion_matches_jax(tmp_path):
    import pandas as pd

    weights = str(tmp_path / "vit_tiny.npz")
    jax_embedder = JaxCpuEmbedder(weights)
    port_embedder = ViTEmbedder(weights_path=weights, batch_bucket=4, device="cpu",
                                model_overrides={**TINY, "dtype": torch.float32})
    dataset = {"name": "demo", "source": "synthetic", "n_images": 2, "image_size": 448}
    kw = dict(session_id="s1", dataset=dataset, crop_size=224, n_crops_per_image=6,
              batch_bucket=4)
    ws_jax, ws_port = tmp_path / "jax", tmp_path / "port"
    ref = asyncio.run(jax_ingestion.run_ingestion(
        workspace_dir=ws_jax, embedder=jax_embedder, **kw))
    got = asyncio.run(port_ingestion.run_ingestion(
        workspace_dir=ws_port, embedder=port_embedder, device="cpu", **kw))
    assert got["status"] == ref["status"] == "completed"
    assert got["n_embedded"] == ref["n_embedded"] >= 8
    assert got["index_type"] == ref["index_type"] == "FlatIP"

    rows = json.loads((ws_port / "index" / "metadata.json").read_text())
    ref_rows = pd.read_parquet(ws_jax / "index" / "metadata.parquet").to_dict("records")
    assert rows == [{k: (v.item() if hasattr(v, "item") else v) for k, v in r.items()}
                    for r in ref_rows]
    assert rows[0] == {"dataset": "demo", "image": "synthetic_0000", "crop": 0}
    with np.load(ws_port / "index" / "cell_search_index.npz") as a, \
            np.load(ws_jax / "index" / "cell_search_index.npz") as b:
        assert str(a["kind"]) == str(b["kind"])
        np.testing.assert_allclose(a["embeddings"], b["embeddings"], atol=EMB_TOL, rtol=0)
    status, ref_status = _status_file(ws_port, "s1"), _status_file(ws_jax, "s1")
    for d in (status, ref_status):
        d.pop("message")  # carries the elapsed seconds
        d.pop("index")    # build times and file size
    assert status == ref_status
    assert status["status"] == "completed" and status["progress_pct"] == 100.0


@pytest.mark.parametrize("dataset", [
    {"name": "d", "source": "datasets"},
    {"name": "d", "source": "ftp"},
])
def test_run_ingestion_refuses_what_jax_refuses(dataset, tmp_path):
    messages = []
    for mod in (jax_ingestion, port_ingestion):
        with pytest.raises(ValueError) as err:
            asyncio.run(mod.run_ingestion(
                workspace_dir=tmp_path, session_id="s", dataset=dataset, embedder=None))
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# ---- the app flow (tests/test_cell_image_search.py::TestCellImageSearchApp) ----


def _app(tmp_path, **kw):
    return CellImageSearch(
        workspace_dir=str(tmp_path / "ws"), batch_bucket=8, crop_size=64,
        n_crops_per_image=8, device="cpu", model_overrides=TINY, **kw,
    )


async def _wait(svc, sid, done=("completed", "failed", "stopped"), timeout=600):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        status = await svc.get_ingestion_status(session_id=sid)
        if status["status"] in done:
            return status
        await asyncio.sleep(0.05)
    raise AssertionError(f"session {sid} did not finish: {status}")


def test_app_full_flow(tmp_path):
    svc = _app(tmp_path)

    async def flow():
        await svc.async_init()
        assert (await svc.ping())["status"] == "ok"
        assert (await svc.get_index_stats())["loaded"] is False
        added = await svc.add_dataset(name="demo", source="synthetic", n_images=2, image_size=256)
        assert added["added"]
        datasets = await svc.list_datasets()
        assert any(d["name"] == "demo" for d in datasets["registered"])
        assert datasets["data_server"] == []
        started = await svc.start_ingestion(dataset_name="demo", session_id="s1")
        assert started["status"] == "started"
        status = await _wait(svc, "s1")
        assert status["status"] == "completed", status
        assert status["n_embedded"] > 0

        stats = await svc.get_index_stats()
        assert stats["loaded"] and stats["n_cells"] == status["n_embedded"]
        assert stats["index_type"] == "FlatIP"

        query = np.random.default_rng(0).normal(100, 20, (64, 64))
        found = await svc.search(image=query, top_k=5)
        assert found["n_results"] == 5
        assert found["results"][0]["rank"] == 1
        assert found["results"][0]["dataset"] == "demo"
        assert found["query_projection"] is None  # no map yet
        with pytest.raises(RuntimeError, match="get_umap_preview"):
            await svc.project_query_onto_umap(image=query)

        preview = await svc.get_umap_preview(n_samples=10)
        assert len(preview["x"]) == min(10, status["n_embedded"])
        pos = await svc.project_query_onto_umap(image=query)
        assert set(pos) == {"x", "y"}
        found = await svc.search(image=query, top_k=5)
        assert found["query_projection"] == pos

        # a PNG of the same pixels finds the same cells
        png = np.clip(query, 0, 255).astype(np.uint8)
        by_bytes = await svc.search(image_bytes=_png_bytes(png), top_k=5)
        by_array = await svc.search(image=png, top_k=5)
        assert [r["index_id"] for r in by_bytes["results"]] == [
            r["index_id"] for r in by_array["results"]]
        with pytest.raises(ValueError, match="image_bytes"):
            await svc.search()

        sessions = await svc.get_active_sessions()
        assert "s1" in sessions and sessions["s1"]["status"] == "completed"
        # a rerun of the same session id starts from a fresh session dir
        await svc.stop_ingestion(session_id="s1")
        await svc.start_ingestion(dataset_name="demo", session_id="s1")
        assert (await _wait(svc, "s1"))["status"] == "completed"
        assert (await svc.remove_dataset(name="demo")) == {"removed": True}
        assert (await svc.remove_dataset(name="demo")) == {"removed": False}
        assert (await svc.list_datasets())["registered"] == []

    asyncio.run(flow())


def test_app_stop_ingestion(tmp_path):
    svc = _app(tmp_path)

    async def flow():
        await svc.add_dataset(name="big", source="synthetic", n_images=50, image_size=256)
        await svc.start_ingestion(dataset_name="big", session_id="s2")
        await svc.stop_ingestion(session_id="s2")
        status = await _wait(svc, "s2")
        assert status["status"] == "stopped", status
        assert (await svc.get_index_stats())["loaded"] is False

    asyncio.run(flow())


def test_app_unknown_dataset_rejected(tmp_path):
    svc = _app(tmp_path)
    with pytest.raises(ValueError, match="not registered"):
        asyncio.run(svc.start_ingestion(dataset_name="nope"))
    with pytest.raises(ValueError, match="unknown source"):
        asyncio.run(svc.add_dataset(name="x", source="ftp"))
    with pytest.raises(ValueError, match="requires path"):
        asyncio.run(svc.add_dataset(name="x", source="local"))


def test_app_datasets_and_local_sources(tmp_path):
    client = FakeDatasetsClient()
    svc = _app(tmp_path, datasets_client=client)
    local = tmp_path / "images"
    local.mkdir()
    for i, (_, img) in enumerate(port_ingestion.make_synthetic_images(n_images=2, size=128)):
        np.save(local / f"f{i}.npy", img)

    async def flow():
        assert (await svc.list_datasets())["data_server"] == [{"name": "plates"}]
        await svc.add_dataset(name="plates", source="datasets")
        await svc.start_ingestion(dataset_name="plates", session_id="remote")
        status = await _wait(svc, "remote")
        assert status["status"] == "completed", status
        rows = json.loads((tmp_path / "ws" / "index" / "metadata.json").read_text())
        assert {r["image"] for r in rows} >= {"plane.zarr", "field.png"}
        await svc.add_dataset(name="lab", source="local", path=str(local))
        await svc.start_ingestion(dataset_name="lab", session_id="local")
        status = await _wait(svc, "local")
        assert status["status"] == "completed", status
        index, meta, _ = port_index.load_index(tmp_path / "ws", device="cpu")
        assert index.ntotal == status["n_embedded"]
        assert {r["image"] for r in meta} == {"f0.npy", "f1.npy"}
        # without a client the datasets source fails the session, as in the JAX app
        svc.bioengine_datasets = None
        await svc.start_ingestion(dataset_name="plates", session_id="none")
        status = await _wait(svc, "none")
        assert status["status"] == "failed" and "datasets client" in status["message"]

    asyncio.run(flow())
