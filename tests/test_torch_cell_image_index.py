"""The PyTorch port's cell-image-search indexes against the JAX app's, on
the CPU.

- Each of the four kinds built by one app, saved, and loaded by the other:
  same top-k ids (ties within the score tolerance aside) and scores within
  1e-5, single and batched queries, and the same ``reconstruct``.
- The port's k-means (``ops/kmeans.py``) against scikit-learn, which the
  JAX app calls: nearest-centroid encoding equals ``MiniBatchKMeans.predict``
  on the same centres outside distance ties; inertia within 1% of
  ``MiniBatchKMeans``'s on the same data.
- The port's builds meet the JAX app's own recall thresholds
  (``tests/test_cell_image_search.py``) on the same corpora.
- ``build_index``'s choice of kind and ``nlist`` at each threshold.
- The 2-D map against the JAX app's on clustered rows, each app reading
  the other's cache.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import few_torch_threads  # noqa: F401
from threadpoolctl import threadpool_limits
from bioengine_tpu_torch.apps.cell_image_search import index as port_index
from bioengine_tpu_torch.ops import kmeans
from bioengine_tpu_torch.ops.knn import pq_scan_topk

APP_DIR = Path(__file__).resolve().parent.parent / "apps" / "cell-image-search"
SCORE_TOL = 1e-5
# the two nearest squared distances closer than this are a tie
TIE_TOL = 1e-6


def _load(stem):
    """Import an app module by its bare stem name, as the app loader does."""
    if stem in sys.modules:
        return sys.modules[stem]
    spec = importlib.util.spec_from_file_location(stem, APP_DIR / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[stem] = mod
    spec.loader.exec_module(mod)
    return mod


jax_index = _load("index")


@pytest.fixture(scope="module", autouse=True)
def few_native_threads():
    """Hold scikit-learn's OpenMP and numpy's BLAS to 2 threads while the
    module runs, as ``few_torch_threads`` holds PyTorch: timing-bound tests
    in other files share the cores."""
    with threadpool_limits(limits=2):
        yield


def _nearest(x, centres):
    """The port's encoding: ``ops.kmeans.nearest_centroids`` on the CPU."""
    labels, _ = kmeans.nearest_centroids(
        torch.from_numpy(np.asarray(x, np.float32))[None],
        torch.from_numpy(np.asarray(centres, np.float32))[None],
    )
    return labels[0].numpy()


def _random_unit(n, d=768, seed=0):
    """The JAX app tests' corpora (tests/test_cell_image_search.py)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered_unit(n, n_clusters=5, spread=0.15, d=768, seed=0):
    """Unit rows around ``n_clusters`` unit centres: a spectrum with a gap,
    so the top two principal axes are well defined."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(n_clusters, d))
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    which = rng.integers(n_clusters, size=n)
    x = centres[which] + spread * rng.normal(size=(n, d)) / np.sqrt(d)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32), which


def _assert_same_topk(ids, scores, ref_ids, ref_scores, tol=SCORE_TOL):
    """Row by row, rank by rank: the same id, or one the reference ranks at
    a score within ``tol`` of its score at that rank (a tie)."""
    for row in range(len(ids)):
        for r in range(ids.shape[1]):
            tied = ref_ids[row][np.abs(ref_scores[row] - ref_scores[row][r]) <= tol]
            assert ids[row][r] in tied, (row, r, ids[row], ref_ids[row])
        np.testing.assert_allclose(scores[row], ref_scores[row], atol=tol, rtol=0)


# ---- the four kinds, cross-loaded ---------------------------------------------

CORPUS = _random_unit(1200, seed=3)


def _jax_build(kind):
    if kind == "FlatIP":
        return jax_index.FlatIPIndex(CORPUS)
    if kind == "IVFFlat":
        return jax_index.IVFFlatIndex.build(CORPUS, nlist=8)
    if kind == "IVFPQ":
        return jax_index.IVFPQIndex.build(CORPUS, nlist=4)
    return jax_index.PQFlatIndex.build(CORPUS)


def _port_build(kind):
    if kind == "FlatIP":
        return port_index.FlatIPIndex(CORPUS, device="cpu")
    if kind == "IVFFlat":
        return port_index.IVFFlatIndex.build(CORPUS, nlist=8, device="cpu")
    if kind == "IVFPQ":
        return port_index.IVFPQIndex.build(CORPUS, nlist=4, device="cpu")
    return port_index.PQFlatIndex.build(CORPUS, device="cpu")


def _load_both(path):
    with np.load(path) as data:
        kind = str(data["kind"])
        return (
            jax_index._KINDS[kind].load(data),
            port_index._KINDS[kind].load(data, device="cpu"),
        )


# FlatIP scores are bf16 x bf16 products summed in f32 in another order on
# each side; the rest are the same numpy (IVF) or the same subspace order (PQ)
@pytest.mark.parametrize("built_by", ["jax", "port"])
@pytest.mark.parametrize("kind", ["FlatIP", "IVFFlat", "IVFPQ", "PQFlatTPU"])
def test_cross_load_search_and_reconstruct(kind, built_by, tmp_path):
    built = (_jax_build if built_by == "jax" else _port_build)(kind)
    assert built.kind == kind
    path = tmp_path / f"{kind}.npz"
    built.save(path)
    jax_loaded, port_loaded = _load_both(path)
    assert port_loaded.ntotal == jax_loaded.ntotal == len(CORPUS)
    for query, k in ((CORPUS[7], 5), (CORPUS[:6], 10), (CORPUS[100:102], 1300)):
        s_ref, i_ref = jax_loaded.search(query, k)
        s, i = port_loaded.search(query, k)
        assert s.shape == i.shape == np.shape(s_ref)
        assert s.dtype == np.float32 and i.dtype == np.int64
        live = np.isfinite(np.asarray(s_ref))
        np.testing.assert_array_equal(np.isfinite(s), live)
        _assert_same_topk(
            np.where(live, i, -1), np.where(live, s, 0),
            np.where(live, np.asarray(i_ref), -1), np.where(live, np.asarray(s_ref), 0),
        )
    ids = np.array([0, 7, 1199, 42])
    np.testing.assert_array_equal(port_loaded.reconstruct(ids), jax_loaded.reconstruct(ids))


# ---- k-means against scikit-learn ---------------------------------------------


@pytest.mark.parametrize(
    "n, dims, n_clusters, seed",
    [(3000, slice(0, 8), 256, 2), (3000, slice(560, 568), 256, 4), (2000, slice(None), 32, 1)],
    ids=["pq_subspace_0", "pq_subspace_70", "coarse_768"],
)
def test_nearest_centroids_match_sklearn_predict(n, dims, n_clusters, seed):
    from sklearn.cluster import MiniBatchKMeans

    x = np.ascontiguousarray(_random_unit(n, seed=seed)[:, dims])
    fitted = MiniBatchKMeans(
        n_clusters=n_clusters, batch_size=8192, n_init=1, random_state=0
    ).fit(x)
    centres = fitted.cluster_centers_
    got = _nearest(x, centres)
    want = fitted.predict(x)
    d2 = ((x.astype(np.float64)[:, None] - centres[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    clear = two[:, 1] - two[:, 0] > TIE_TOL
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], want[clear])


@pytest.mark.parametrize(
    "n, n_clusters, seed", [(3000, 32, 1), (4000, 16, 2)],
    ids=["ivfflat_corpus", "ivfpq_corpus"],
)
def test_kmeans_inertia_within_one_percent_of_sklearn(n, n_clusters, seed):
    from sklearn.cluster import MiniBatchKMeans

    x = _random_unit(n, seed=seed)
    centres, labels = kmeans.kmeans(x, n_clusters, n_init=3, device="cpu")
    inertia = float(((x - centres[labels]) ** 2).sum())
    ref = MiniBatchKMeans(
        n_clusters=n_clusters, batch_size=4096, n_init=3, random_state=0
    ).fit(x)
    assert inertia <= 1.01 * ref.inertia_, (inertia, ref.inertia_)
    # the labels are those of the returned centres
    np.testing.assert_array_equal(labels, _nearest(x, centres))


def test_kmeans_edge_cases():
    x = _random_unit(40, d=16, seed=9)
    # one cluster per row: every row its own centre
    centres, labels = kmeans.kmeans(x, 40, device="cpu")
    assert sorted(labels.tolist()) == list(range(40))
    np.testing.assert_allclose(centres[labels], x, atol=1e-6)
    # a cluster emptied by the first update is reseeded from a far row
    dup = np.concatenate([np.repeat(x[:1], 30, axis=0), x[1:11]])
    centres, labels = kmeans.kmeans(dup, 8, device="cpu")
    assert np.bincount(labels, minlength=8).min() >= 1
    # the same seed gives the same centres; the batched form runs each
    # problem as the unbatched one does
    again, _ = kmeans.kmeans(dup, 8, device="cpu")
    np.testing.assert_array_equal(centres, again)
    batch = torch.from_numpy(np.stack([dup[:, :8], dup[:, 8:]]))
    bc = kmeans.fit(batch, 8, [3, 5])
    bl, _ = kmeans.nearest_centroids(batch, bc)
    for s, state in enumerate((3, 5)):
        c1, l1 = kmeans.kmeans(dup[:, 8 * s : 8 * s + 8], 8, random_state=state, device="cpu")
        np.testing.assert_allclose(bc[s].numpy(), c1, atol=1e-6)
        np.testing.assert_array_equal(bl[s].numpy(), l1)
    with pytest.raises(ValueError):
        kmeans.kmeans(x, 41, device="cpu")


def _clear_of_ties(x, centres):
    """Rows whose two nearest centres (float64 squared distances) differ by
    more than TIE_TOL."""
    d2 = ((x.astype(np.float64)[:, None] - centres.astype(np.float64)[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    return two[:, 1] - two[:, 0] > TIE_TOL


@pytest.mark.parametrize("encode_rows", [37, 500, 5000])
@pytest.mark.parametrize("residual", [False, True], ids=["pq", "ivfpq"])
def test_streamed_pq_encoding_matches_one_pass(encode_rows, residual, monkeypatch):
    """``_train_pq`` trains on the first ``train_len`` rows and encodes in
    chunks of ``ENCODE_ROWS``: the codebooks do not depend on the chunk, and
    the codes (and coarse assignments) are those of one pass over every row,
    ties aside."""
    emb = _random_unit(1500, seed=8)
    M, dsub = 96, 8
    coarse = torch.from_numpy(emb[:: 150].copy()) if residual else None
    monkeypatch.setattr(port_index, "ENCODE_ROWS", encode_rows)
    books, codes, assign = port_index._train_pq(
        emb, M, 64, train_n=600, device="cpu", coarse=coarse)
    x = torch.from_numpy(emb)
    want_assign = None
    if residual:
        x, want_assign = port_index._residuals(x, coarse)
        clear = _clear_of_ties(emb, coarse.numpy())
        assert clear.mean() > 0.99
        np.testing.assert_array_equal(assign[clear], want_assign.numpy()[clear])
    else:
        assert assign is None
    # the codebooks are k-means of the first 600 rows' subspaces alone
    train = port_index._subspaces(x[:600], M)
    np.testing.assert_array_equal(books, kmeans.fit(train, 64, list(range(M))).numpy())
    assert books.shape == (M, 64, dsub) and codes.shape == (1500, M) and codes.dtype == np.uint8
    sub = x.numpy().reshape(1500, M, dsub)
    for m in (0, 41, 95):
        want = _nearest(sub[:, m], books[m])
        clear = _clear_of_ties(sub[:, m], books[m])
        if residual:
            clear &= _clear_of_ties(emb, coarse.numpy())
        assert clear.mean() > 0.99
        np.testing.assert_array_equal(codes[clear, m], want[clear])


# ---- the JAX app's recall thresholds, on the port's builds --------------------


def test_ivfflat_recall():
    emb = _random_unit(3000, seed=1)
    idx = port_index.IVFFlatIndex.build(emb, nlist=32, nprobe=8, device="cpu")
    _, ids = idx.search(emb[:50], 1)
    assert int((ids[:, 0] == np.arange(50)).sum()) >= 45  # self-recall@1, 8/32 probes


def test_ivfpq_recall():
    emb = _random_unit(4000, seed=2)
    idx = port_index.IVFPQIndex.build(emb, nlist=16, nprobe=8, device="cpu")
    assert idx.codes.dtype == np.uint8 and idx.codes.shape == (4000, 96)
    _, ids = idx.search(emb[:30], 10)
    assert sum(int(q in ids[q]) for q in range(30)) >= 24  # self-recall@10


def test_pqflat_exact_scan_recall_and_batch():
    emb = _random_unit(600, seed=5)
    idx = port_index.PQFlatIndex.build(emb, device="cpu")
    assert idx.ntotal == 600 and idx.codebooks.shape == (96, 256, 8)
    _, ids = idx.search(emb[:30], 10)
    assert sum(int(q in ids[q]) for q in range(30)) >= 26, ids
    s, i = idx.search(emb[:8], 5)
    assert s.shape == (8, 5) and i.shape == (8, 5)
    s1, i1 = idx.search(emb[3], 5)
    np.testing.assert_array_equal(i[3], i1[0])
    rec = idx.reconstruct(np.array([0, 7]))
    assert rec.shape == (2, emb.shape[1])
    assert (rec[0] / np.linalg.norm(rec[0])) @ emb[0] > 0.8


@pytest.mark.parametrize("q_chunk_queries", [1, 3, 8])
def test_pq_scan_matches_numpy_adc(q_chunk_queries, monkeypatch):
    """The scan's scores are the numpy ADC sums (lut[codes + offs]), added
    subspace by subspace; queries chunk by the score budget."""
    rng = np.random.default_rng(11)
    n, M = 700, 96
    # codewords and queries at the scale of unit embeddings: scores ~1
    codebooks = (rng.normal(size=(M, 256, 8)) / np.sqrt(768)).astype(np.float32)
    codes = rng.integers(0, 256, size=(n, M), dtype=np.uint8)
    idx = port_index.PQFlatIndex(codebooks, codes, device="cpu")
    monkeypatch.setattr(idx, "SCORE_BUDGET_BYTES", n * 4 * q_chunk_queries)
    q = _random_unit(8, seed=12)
    s, i = idx.search(q, 12)
    luts = np.einsum("mkd,qmd->qmk", codebooks, q.reshape(8, M, 8))
    offs = np.arange(M) * 256
    ref = np.stack([lut.ravel()[codes.astype(np.int64) + offs].sum(axis=1) for lut in luts])
    for row in range(8):
        np.testing.assert_allclose(s[row], ref[row][i[row]], atol=SCORE_TOL, rtol=0)
        np.testing.assert_allclose(s[row], -np.sort(-ref[row])[:12], atol=SCORE_TOL, rtol=0)
    # the ops function alone, widened codes against the uint8 plane
    scores, pos = pq_scan_topk(
        torch.from_numpy(luts), torch.from_numpy(np.ascontiguousarray(codes.T)), 3
    )
    np.testing.assert_array_equal(scores.numpy(), s[:, :3])


# ---- size thresholds ----------------------------------------------------------


@pytest.mark.parametrize("n_target", [99_999, 100_000, 4_999_999, 5_000_000, 80_000_000])
def test_select_index_matches_jax_build_index(n_target, tmp_path, monkeypatch):
    """The JAX app's build_index on its CPU backend, with its trained kinds
    recording (kind, nlist) instead of training."""
    import pandas as pd

    chosen = {}

    def recorder(kind):
        def build(cls, embeddings, nlist=None, **kwargs):
            chosen.update(kind=kind, nlist=nlist)
            return jax_index.FlatIPIndex(embeddings)
        return classmethod(build)

    monkeypatch.setattr(jax_index.IVFFlatIndex, "build", recorder("IVFFlat"))
    monkeypatch.setattr(jax_index.IVFPQIndex, "build", recorder("IVFPQ"))
    emb = _random_unit(300, d=8, seed=1)
    stats = jax_index.build_index(emb, pd.DataFrame({"c": range(300)}), tmp_path, n_target)
    want = (chosen.get("kind", stats["index_type"]), chosen.get("nlist"))
    assert port_index.select_index(n_target, 300, "cpu") == want
    assert want[0] == ("IVFPQ" if n_target >= 5_000_000 else want[0])
    # on a card, 5M and more keep the codes resident
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    on_card = port_index.select_index(n_target, 300, "cuda")
    assert on_card == (("PQFlatTPU", None) if n_target >= 5_000_000 else want)


def test_build_index_trains_the_selected_kind(tmp_path):
    emb = _random_unit(300, seed=6)
    rows = [{"crop": j} for j in range(300)]
    stats = port_index.build_index(emb, rows, tmp_path, n_cells_total=6_000_000, device="cpu")
    assert stats["index_type"] == "IVFPQ" and stats["n_cells"] == 300
    assert set(stats["build_split_seconds"]) == {
        "coarse_seconds", "pq_seconds", "sort_seconds", "save_seconds"}
    index, meta, info = port_index.load_index(tmp_path, device="cpu")
    assert index.kind == "IVFPQ" and len(index.centroids) == 300  # nlist == n
    assert meta == rows and info["index_type"] == "IVFPQ"
    results = port_index.search_index(index, meta, emb[17], top_k=5)
    assert results[0]["index_id"] == 17 and results[0]["crop"] == 17
    # the JAX app reads the port's npz
    with np.load(port_index.index_dir(tmp_path) / "cell_search_index.npz") as data:
        assert jax_index._KINDS[str(data["kind"])].load(data).ntotal == 300


# ---- the 2-D map ----------------------------------------------------------------


def test_projection_matches_jax_and_caches_cross_read(tmp_path):
    import pandas as pd

    emb, which = _clustered_unit(800, seed=4)
    rows = [{"compound": f"c{w}", "crop": j} for j, w in enumerate(which)]
    ws_jax, ws_port = tmp_path / "jax", tmp_path / "port"
    jax_index.build_index(emb, pd.DataFrame(rows), ws_jax)
    port_index.build_index(emb, rows, ws_port)
    ref = jax_index.compute_projection(ws_jax, n_samples=200)
    got = port_index.compute_projection(ws_port, n_samples=200, device="cpu")
    assert got["n_total"] == ref["n_total"] == 800
    assert got["labels"] == ref["labels"] and got["colors"] == ref["colors"]
    for axis in ("x", "y"):
        a, b = np.asarray(got[axis]), np.asarray(ref[axis])
        assert np.abs(a - b).max() <= 1e-4 * (b.max() - b.min()), axis
    q = emb[5]
    pos, ref_pos = port_index.project_query(ws_port, q), jax_index.project_query(ws_jax, q)
    span = np.ptp(ref["x"]) + np.ptp(ref["y"])
    assert abs(pos["x"] - ref_pos["x"]) + abs(pos["y"] - ref_pos["y"]) <= 1e-4 * span

    # each app reads the other's cache as its own
    cache = "index/projection_cache.npz"
    (ws_jax / cache).replace(tmp_path / "jax_cache.npz")
    (ws_port / cache).replace(ws_jax / cache)
    (tmp_path / "jax_cache.npz").replace(ws_port / cache)
    assert jax_index.compute_projection(ws_jax, n_samples=200) == got
    assert port_index.compute_projection(ws_port, n_samples=200) == ref
    assert jax_index.project_query(ws_jax, q) == pos
    assert port_index.project_query(ws_port, q) == ref_pos


def test_projection_labels_and_empty_workspace(tmp_path):
    assert port_index.compute_projection(tmp_path / "none") == {
        "x": [], "y": [], "labels": [], "colors": [], "n_total": 0}
    assert port_index.project_query(tmp_path / "none", np.zeros(768)) is None
    emb = _random_unit(30, seed=8)
    # the label column is the first of moa_class, compound, label that any
    # row has; a row without it reads "nan", as pandas writes a missing value
    rows = [{"label": "x"} if j % 3 else {"moa_class": f"m{j % 2}"} for j in range(30)]
    port_index.build_index(emb, rows, tmp_path)
    proj = port_index.compute_projection(tmp_path, n_samples=30, device="cpu")
    assert proj["labels"] == [f"m{j % 2}" if j % 3 == 0 else "nan" for j in range(30)]
    palette = port_index._generate_palette(3)
    assert palette == jax_index._generate_palette(3)
    assert set(proj["colors"]) == set(palette)
