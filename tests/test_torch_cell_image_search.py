"""The PyTorch port of cell-image-search against the JAX app, on the CPU.

The slice as a whole: synthetic fields → crops → a tiny ViT embedding →
FlatIP search, once through the JAX app's modules (JAX ViT with its Pallas
kernel in interpreter mode, ``topk_inner_product``) and once through the
port's ``CellImageSearch(device="cpu")`` on the same crops and bridged
weights. Same top-k ids (ties within the score tolerance aside), scores
within 1e-3.
"""

import asyncio
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu.models.vit import ViT as JaxViT
from bioengine_tpu.ops.knn import topk_inner_product as jax_topk_inner_product
from bioengine_tpu.ops.pallas.attention import make_attn_fn as jax_make_attn_fn
from bioengine_tpu.runtime.convert import save_params_npz
from bioengine_tpu_torch.apps.cell_image_search import index as port_index
from bioengine_tpu_torch.apps.cell_image_search import ingestion as port_ingestion
from bioengine_tpu_torch.apps.cell_image_search import normalizer as port_normalizer
from bioengine_tpu_torch.apps.cell_image_search.service import CellImageSearch
from bioengine_tpu_torch.ops import attention
from bioengine_tpu_torch.ops.knn import topk_inner_product

APP_DIR = Path(__file__).resolve().parent.parent / "apps" / "cell-image-search"
# 224² crops through a 28-pixel patch: 65 tokens, dim 64
TINY = dict(patch_size=28, dim=64, depth=2, num_heads=2)
SCORE_TOL = 1e-3


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


def _crops():
    crops = []
    for _, img in jax_ingestion.make_synthetic_images(n_images=2, size=448, seed=3):
        crops += jax_ingestion.extract_cell_crops(img, crop_size=224, n_crops=12)
    return crops


def _jax_slice(crops, dtype, weights_path):
    """The JAX app's path: normaliser → JAX ViT with its kernel → L2
    norm. Writes the weights both sides load; returns the embeddings."""
    model = JaxViT(**TINY, dtype=dtype, attn_fn=jax_make_attn_fn())
    params = seeded_flax_params(model, (1, 224, 224, 3), seed=5)
    save_params_npz(weights_path, params)
    prepped = np.stack([jax_normalizer.to_model_input(c) for c in crops])
    emb = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(prepped)))
    return emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-9)


def _assert_same_topk(port_ids, port_scores, ref_ids, ref_scores, k, tol=SCORE_TOL):
    """Rank by rank: the port's id is one the reference ranks at a score
    within ``tol`` of the reference's score at that rank."""
    for r in range(k):
        tied = ref_ids[np.abs(ref_scores - ref_scores[r]) <= tol]
        assert port_ids[r] in tied, (r, port_ids[:k], ref_ids[:k])
        assert abs(port_scores[r] - ref_scores[r]) <= tol


# bf16 embeddings agree to cosine 0.9999, but each side rounds its own
# 64-wide unit vectors to bf16 for the corpus product: ~2^-8 * sqrt(3/64)
# ~ 8.5e-4 spread per score, so bf16 scores are held to 4e-3
@pytest.mark.parametrize("dtype, tol", [("f32", SCORE_TOL), ("bf16", 4e-3)])
def test_slice_matches_jax(dtype, tol, tmp_path):
    crops = _crops()
    assert len(crops) >= 8
    weights = str(tmp_path / "vit_tiny.npz")
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref_emb = _jax_slice(crops, jdt, weights)
    svc = CellImageSearch(
        workspace_dir=str(tmp_path), weights_path=weights, batch_bucket=8,
        device="cpu", model_overrides={**TINY, "dtype": tdt},
    )
    emb = svc.embedder.embed_batch(crops)
    assert emb.shape == ref_emb.shape
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-3)
    assert np.sum(emb * ref_emb, 1).min() >= 0.9999

    rows = [{"dataset": "synthetic", "crop": j} for j in range(len(crops))]
    port_index.build_index(emb, rows, tmp_path)
    corpus = jnp.asarray(ref_emb, jnp.bfloat16)
    k = 5
    for qi in (0, 3, len(crops) - 1):
        found = asyncio.run(svc.search(crops[qi], top_k=k))
        assert found["n_results"] == k
        ids = np.array([r["index_id"] for r in found["results"]])
        scores = np.array([r["score"] for r in found["results"]])
        assert found["results"][0]["rank"] == 1
        assert found["results"][0]["crop"] == ids[0]
        ref_s, ref_i = jax_topk_inner_product(
            corpus, jnp.asarray(ref_emb[qi : qi + 1]), len(crops)
        )
        _assert_same_topk(
            ids, scores, np.asarray(ref_i)[0], np.asarray(ref_s)[0], k, tol
        )


def test_topk_inner_product_matches_jax():
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(300, 32)).astype(np.float32)
    queries = rng.normal(size=(4, 32)).astype(np.float32)
    ref_s, ref_i = jax_topk_inner_product(
        jnp.asarray(corpus, jnp.bfloat16), jnp.asarray(queries), 300
    )
    s, i = topk_inner_product(
        torch.from_numpy(corpus).to(torch.bfloat16), torch.from_numpy(queries), 7
    )
    assert s.dtype == torch.float32
    for row in range(4):
        _assert_same_topk(
            i[row].numpy(), s[row].numpy(),
            np.asarray(ref_i)[row], np.asarray(ref_s)[row], 7,
        )


@pytest.mark.parametrize("channels", [0, 1, 2, 3, 4, 5])
def test_normalizer_matches_jax(channels):
    rng = np.random.default_rng(channels)
    shape = (224, 224) if channels == 0 else (224, 224, channels)
    img = rng.integers(0, 65535, shape).astype(np.uint16)
    np.testing.assert_array_equal(
        port_normalizer.to_model_input(img), jax_normalizer.to_model_input(img)
    )


def test_resize_without_pillow_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        port_normalizer.resize_rgb(np.zeros((64, 64, 3), np.uint8))
    same = np.zeros((224, 224, 3), np.uint8)
    assert port_normalizer.resize_rgb(same) is same


@pytest.mark.parametrize("size, n_crops", [(512, 20), (256, 100), (300, 9)])
def test_crop_extraction_matches_jax(size, n_crops):
    _, img = next(iter(port_ingestion.make_synthetic_images(n_images=1, size=size)))
    _, ref_img = next(iter(jax_ingestion.make_synthetic_images(n_images=1, size=size)))
    np.testing.assert_array_equal(img, ref_img)
    u8 = port_normalizer.percentile_stretch(img)
    assert port_ingestion._otsu_threshold(u8) == jax_ingestion._otsu_threshold(u8)
    crop = 96 if size == 512 else 224 if size == 256 else 64
    crops = port_ingestion.extract_cell_crops(img, crop_size=crop, n_crops=n_crops)
    ref = jax_ingestion.extract_cell_crops(img, crop_size=crop, n_crops=n_crops)
    assert len(crops) == len(ref) >= 1
    for a, b in zip(crops, ref):
        np.testing.assert_array_equal(a, b)


def test_topk_pad_matches_jax():
    rng = np.random.default_rng(1)
    parts_s = [rng.normal(size=7).astype(np.float32), rng.normal(size=3).astype(np.float32)]
    parts_i = [np.arange(7), np.arange(100, 103)]
    for top_k in (4, 15):
        for got, ref in zip(
            port_index._topk_pad(parts_s, parts_i, top_k),
            jax_index._topk_pad(parts_s, parts_i, top_k),
        ):
            np.testing.assert_array_equal(got, ref)
    s, i = port_index._topk_pad([], [], 3)
    assert np.all(np.isneginf(s)) and np.all(i == -1)


def test_index_persistence(tmp_path):
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(50, 768)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    rows = [{"compound": f"c{i % 7}"} for i in range(50)]
    stats = port_index.build_index(emb, rows, tmp_path)
    assert stats["index_type"] == "FlatIP" and stats["n_cells"] == 50
    assert json.loads((tmp_path / "index" / "metadata.json").read_text()) == rows
    idx, meta, info = port_index.load_index(tmp_path, device="cpu")
    assert meta == rows and info["n_cells"] == 50
    results = port_index.search_index(idx, meta, emb[42], top_k=5)
    assert results[0]["index_id"] == 42 and results[0]["score"] > 0.99
    assert results[0]["compound"] == "c0"
    assert len(port_index.search_index(idx, meta, emb[0], top_k=80)) == 50
    # 200K cells select IVFFlat, nlist capped at the 50 rows there are
    stats = port_index.build_index(emb, rows, tmp_path, n_cells_total=200_000, device="cpu")
    assert stats["index_type"] == "IVFFlat"
    idx, meta, _ = port_index.load_index(tmp_path, device="cpu")
    assert len(idx.centroids) == 50 and meta == rows
    assert port_index.search_index(idx, meta, emb[42], top_k=5)[0]["index_id"] == 42
    with pytest.raises(ValueError):
        port_index.build_index(emb, rows[:-1], tmp_path)
    with pytest.raises(FileNotFoundError):
        port_index.load_index(tmp_path / "nowhere", device="cpu")


def test_service_lifecycle(tmp_path):
    svc = CellImageSearch(
        workspace_dir=str(tmp_path), batch_bucket=2, device="cpu",
        model_overrides=TINY,
    )

    async def drive():
        with pytest.raises(RuntimeError):
            await svc.check_health()
        assert (await svc.get_index_stats()) == {"loaded": False, "n_cells": 0}
        with pytest.raises(RuntimeError, match="no index"):
            await svc.search(np.zeros((224, 224)))
        launches = attention.launch_count
        await svc.test_deployment()
        assert attention.launch_count == launches  # CPU: no kernel launch
        await svc.check_health()
        pong = await svc.ping()
        assert pong["backend"] == "cpu" and pong["embedder_loaded"]
        assert not pong["pretrained"] and not pong["index_loaded"]
        crops = _crops()[:3]
        emb = svc.embedder.embed_batch(crops)
        assert svc.embedder.forward_count == 1 + 2  # test_deployment + 2 buckets
        port_index.build_index(emb, [{"crop": j} for j in range(3)], tmp_path)
        stats = await svc.get_index_stats()
        assert stats["loaded"] and stats["n_cells"] == 3
        found = await svc.search(crops[1], top_k=2)
        assert found["results"][0]["index_id"] == 1
        assert (await svc.ping())["index_loaded"]

    asyncio.run(drive())
