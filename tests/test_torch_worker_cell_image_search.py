"""Slice 9 as a whole on the CPU: cell-image-search deployed by the port's
worker from ``bioengine_tpu_torch/apps/bundles/cell-image-search`` and
searched over the wire, beside the JAX worker serving ``apps/cell-image-search``.

- The port's ``BioEngineWorker(device="cpu")`` serves a small Zarr
  dataset from its own datasets plane; the bundle, deployed through the
  apps manager over a ``connect_to_server`` WebSocket client with a narrow
  f32 ViT (patch 28, dim 64, depth 1) and seeded weights, ingests it from
  the ``datasets`` source (the client the worker's builder attaches).
- Searches over the WebSocket, the HTTP ``/call`` bridge and MCP
  ``tools/call`` equal, bit for bit, the port's in-process
  ``CellImageSearch(device="cpu")`` over the index the worker wrote.
- The JAX worker serves the JAX app on the same dataset and weights (its
  embedder's flax ViT narrowed to the same shape, XLA attention, as the
  JAX app runs off a TPU); its ingestion gives the same metadata rows, and
  its searches the same top-k ids (ties within the score tolerance aside)
  with scores within 1e-3, the f32 tolerance of
  ``tests/test_torch_cell_image_search.py``.
- The app computes on the card its replica leased (``bioengine_device_ids``),
  on a two-card ``torch.cuda`` stood in for on the CPU.

Temporary workspaces and ``HOME``; geolocation and the JAX compile cache
off; waits are bounded polls.
"""

import asyncio
import json
import time
from pathlib import Path

import aiohttp
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import few_torch_threads, private_rpc_store, seeded_flax_params  # noqa: F401
from bioengine_tpu.datasets import datasets as jax_datasets_mod
from bioengine_tpu.datasets import proxy_server as jax_proxy
from bioengine_tpu.models import vit as jax_vit
from bioengine_tpu.rpc.client import connect_to_server as jax_connect
from bioengine_tpu.runtime.convert import save_params_npz
from bioengine_tpu.worker.worker import BioEngineWorker as JaxWorker
from bioengine_tpu_torch.apps.cell_image_search.ingestion import make_synthetic_images
from bioengine_tpu_torch.apps.cell_image_search.service import CellImageSearch
from bioengine_tpu_torch.datasets import datasets as torch_datasets_mod
from bioengine_tpu_torch.datasets import proxy_server as torch_proxy
from bioengine_tpu_torch.datasets import zarr_codec
from bioengine_tpu_torch.rpc import connect_to_server
from bioengine_tpu_torch.worker import BioEngineWorker

pytestmark = [pytest.mark.end_to_end, pytest.mark.anyio]

REPO = Path(__file__).resolve().parent.parent
PORT_BUNDLE = REPO / "bioengine_tpu_torch" / "apps" / "bundles" / "cell-image-search"
JAX_APP = REPO / "apps" / "cell-image-search"
TINY = {"patch_size": 28, "dim": 64, "depth": 1, "num_heads": 2}
SCORE_TOL = 1e-3  # f32, tests/test_torch_cell_image_search.py
N_FIELDS, FIELD = 6, 448  # more than 5 planes: the zarr array is read plane by plane
TOP_K = 5
APP_KWARGS = {"batch_bucket": 8, "crop_size": 224, "n_crops_per_image": 4}


@pytest.fixture(autouse=True)
def hermetic(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("BIOENGINE_DISABLE_GEOLOCATION", "1")
    monkeypatch.setenv("BIOENGINE_COMPILE_CACHE", "off")
    monkeypatch.delenv("BIOENGINE_TPU_DATA_SERVER", raising=False)
    for module in (jax_proxy, jax_datasets_mod, torch_proxy, torch_datasets_mod):
        monkeypatch.setattr(module, "DISCOVERY_FILE", tmp_path / module.__name__ / "current_server")
    with private_rpc_store():  # the RPC servers' shared memory is the test's own
        yield


@pytest.fixture
def dataset(tmp_path):
    """``<datasets>/cells/fields.zarr/raw``: (6, 448, 448) float32 fields."""
    fields = np.stack([img for _, img in make_synthetic_images(n_images=N_FIELDS, size=FIELD, seed=4)])
    root = tmp_path / "datasets" / "cells"
    root.mkdir(parents=True)
    (root / "manifest.yaml").write_text("description: synthetic fields\nauthorized_users: ['*']\n")
    zarr_codec.write_group(root / "fields.zarr")
    zarr_codec.write_array(root / "fields.zarr", "raw", fields, chunks=(1, FIELD, FIELD),
                           compressor="zstd")
    return tmp_path / "datasets", fields


@pytest.fixture
def weights(tmp_path):
    path = str(tmp_path / "vit_tiny.npz")
    params = seeded_flax_params(jax_vit.ViT(**TINY, dtype=jnp.float32), (1, 224, 224, 3), seed=5)
    save_params_npz(path, params)
    return path


def _queries(fields) -> list:
    rng = np.random.default_rng(7)
    out = []
    for y, x in ((40, 40), (200, 120)):
        out.append(fields[0, y : y + 224, x : x + 224].astype(np.float64))
    out.append(rng.normal(100, 20, (224, 224)))
    return out


def _results(found: dict) -> list:
    return [dict(r) for r in found["results"]]


async def _ingest(app) -> dict:
    await app.add_dataset(name="cells", source="datasets")
    await app.start_ingestion(dataset_name="cells", session_id="s1")
    deadline = time.monotonic() + 120
    while True:
        status = await app.get_ingestion_status(session_id="s1")
        if status["status"] in ("completed", "failed", "stopped"):
            return status
        assert time.monotonic() < deadline, status
        await asyncio.sleep(0.05)


async def _serve_port(datasets_dir, weights, tmp_path, queries) -> dict:
    worker = BioEngineWorker(device="cpu", workspace_dir=tmp_path / "port-ws",
                             datasets_dir=datasets_dir, log_file="off", admin_users=["admin"])
    await worker.start()
    seen = {}
    try:
        conn = await connect_to_server({"server_url": worker.server.url,
                                        "token": worker.server.issue_token("admin")})
        try:
            svc = await conn.get_service("bioengine-worker")
            workspace = str(tmp_path / "port-app")
            deployed = await svc.deploy_app(
                local_path=str(PORT_BUNDLE), app_id="cell-image-search",
                deployment_kwargs={"main": {
                    "workspace_dir": workspace, "device": "cpu", "weights_path": weights,
                    "model_overrides": {**TINY, "dtype": "float32"}, **APP_KWARGS}})
            assert "search" in deployed["methods"] and "start_ingestion" in deployed["methods"]
            app = await conn.get_service("cell-image-search")
            listed = await app.list_datasets()
            assert [d["name"] for d in listed["data_server"]] == ["cells"]
            seen["status"] = await _ingest(app)
            assert seen["status"]["status"] == "completed", seen["status"]
            seen["stats"] = await app.get_index_stats()
            seen["ws"] = [await app.search(image=q, top_k=TOP_K) for q in queries]
            base, user = worker.server.http_url, worker.server.issue_token("someone")
            async with aiohttp.ClientSession() as http:
                seen["bridge"] = []
                for q in queries:
                    async with http.post(f"{base}/call/cell-image-search/search",
                                         json={"kwargs": {"image": q.tolist(), "top_k": TOP_K}},
                                         headers={"Authorization": f"Bearer {user}"}) as r:
                        assert r.status == 200
                        seen["bridge"].append((await r.json())["result"])
                async with http.post(f"{base}/mcp/cell-image-search", json={
                        "jsonrpc": "2.0", "id": 1, "method": "tools/call",
                        "params": {"name": "search",
                                   "arguments": {"image": queries[0].tolist(), "top_k": TOP_K}}}) as r:
                    out = (await r.json())["result"]
                    assert out["isError"] is False, out
                    seen["mcp"] = json.loads(out["content"][0]["text"])
            seen["preview"] = await app.get_umap_preview(n_samples=1000)
            seen["position"] = await app.project_query_onto_umap(image=queries[0])
            await svc.stop_app(app_id="cell-image-search")
        finally:
            await conn.disconnect()
    finally:
        await worker.stop()
    seen["workspace"] = workspace
    return seen


async def _serve_jax(datasets_dir, weights, tmp_path, queries) -> dict:
    worker = JaxWorker(workspace_dir=tmp_path / "jax-ws", datasets_dir=datasets_dir,
                       log_file="off", admin_users=["admin"])
    await worker.start()
    seen = {}
    try:
        conn = await jax_connect({"server_url": worker.server.url,
                                  "token": worker.server.issue_token("admin")})
        try:
            svc = await conn.get_service("bioengine-worker")
            await svc.deploy_app(
                local_path=str(JAX_APP), app_id="cell-image-search",
                deployment_kwargs={"main": {"workspace_dir": str(tmp_path / "jax-app"),
                                            "weights_path": weights, **APP_KWARGS}})
            app = await conn.get_service("cell-image-search")
            seen["status"] = await _ingest(app)
            assert seen["status"]["status"] == "completed", seen["status"]
            seen["stats"] = await app.get_index_stats()
            seen["ws"] = [await app.search(image=q, top_k=TOP_K) for q in queries]
            await svc.stop_app(app_id="cell-image-search")
        finally:
            await conn.disconnect()
    finally:
        await worker.stop()
    return seen


async def test_worker_serves_cell_image_search_over_the_wire(dataset, weights, tmp_path, monkeypatch):
    datasets_dir, fields = dataset
    queries = _queries(fields)
    port = await _serve_port(datasets_dir, weights, tmp_path, queries)
    assert port["stats"]["loaded"] and port["stats"]["index_type"] == "FlatIP"
    assert port["stats"]["n_cells"] == port["status"]["n_embedded"] >= 10

    # the same searches in process, over the index the worker wrote
    local = CellImageSearch(workspace_dir=port["workspace"], device="cpu", weights_path=weights,
                            model_overrides={**TINY, "dtype": "float32"}, **APP_KWARGS)
    await local.async_init()
    mine = [await local.search(image=q, top_k=TOP_K) for q in queries]
    for ws, bridged, ref in zip(port["ws"], port["bridge"], mine):
        assert _results(ws) == _results(bridged) == _results(ref)
        assert len(ref["results"]) == TOP_K
    assert _results(port["mcp"]) == _results(mine[0])
    # the map the worker's app cached, read in process: the same points and position
    assert len(port["preview"]["x"]) == port["stats"]["n_cells"]
    assert await local.get_umap_preview(n_samples=1000) == port["preview"]
    assert await local.project_query_onto_umap(queries[0]) == port["position"]

    # the JAX worker serving the JAX app on the same images and weights,
    # its ViT narrowed to the same shape
    wide = jax_vit.ViT
    monkeypatch.setattr(jax_vit, "ViT", lambda **kw: wide(**{**kw, **TINY, "dtype": jnp.float32}))
    ref = await _serve_jax(datasets_dir, weights, tmp_path, queries)
    assert ref["stats"]["n_cells"] == port["stats"]["n_cells"]
    assert ref["status"]["n_embedded"] == port["status"]["n_embedded"]
    for got, want in zip(port["ws"], ref["ws"]):
        ids = np.array([r["index_id"] for r in got["results"]])
        scores = np.array([r["score"] for r in got["results"]])
        ref_ids = np.array([r["index_id"] for r in want["results"]])
        ref_scores = np.array([r["score"] for r in want["results"]])
        for rank in range(TOP_K):
            tied = ref_ids[np.abs(ref_scores - ref_scores[rank]) <= SCORE_TOL]
            assert ids[rank] in tied, (rank, ids, ref_ids)
            assert abs(scores[rank] - ref_scores[rank]) <= SCORE_TOL
        # the metadata rows of the same ids agree
        rows = {r["index_id"]: {k: r[k] for k in ("dataset", "image", "crop")} for r in want["results"]}
        for r in got["results"]:
            if r["index_id"] in rows:
                assert {k: r[k] for k in ("dataset", "image", "crop")} == rows[r["index_id"]]


@pytest.mark.parametrize("lease, card", [(None, 0), ([0], 0), ([1], 1), ([2], None)])
async def test_the_app_computes_on_its_leased_card(lease, card, tmp_path, monkeypatch):
    """A replica that leased card 1 of two embeds, indexes and ingests on
    card 1; no lease means the constructor's device; a lease naming no
    card is refused. Two cards are stood in for: nothing touches them
    before the model's first use."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    app = CellImageSearch(workspace_dir=str(tmp_path / "cis"), device="cuda")
    if lease is not None:
        app.bioengine_device_ids = lease
    if card is None:
        with pytest.raises(ValueError, match="refusing to remap"):
            await app.async_init()
        return
    await app.async_init()
    assert app.device == app.embedder.device == torch.device("cuda", card)
    assert not app.embedder.loaded
