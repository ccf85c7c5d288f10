#!/usr/bin/env python3
"""Whether the port's IVFPQ and PQFlat builds repeat on one NVIDIA GPU.

Run from the root of a checkout on a machine with CUDA:
``python3 scripts/repeat_torch_index_builds.py``. Draws ``chip_smoke.py``'s
seeded 1M x 768 mixture and its 64 perturbed queries, takes exact f32
top-10 on the card as the truth, then builds ``IVFPQIndex`` (nlist 4096)
and ``PQFlatIndex`` twice each from the same rows and prints, per build,
recall@10, seconds and a digest of the trained centres, codebooks and
codes: equal digests mean the build repeated bit for bit. To compare two
commits, run it from a ``git archive`` of each. The last line is one JSON
object of those numbers with the card's name and power limit.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as smoke  # noqa: E402
from bioengine_tpu_torch.apps.cell_image_search.index import (  # noqa: E402
    IVFPQIndex,
    PQFlatIndex,
)
from bioengine_tpu_torch.ops.knn import topk_inner_product  # noqa: E402

REPEATS = 2


def digest(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()[:12]


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emb_dev = smoke.mixture_corpus(smoke.INDEX_N, smoke.INDEX_DIM, smoke.INDEX_CLUSTERS,
                                   smoke.SEED, "cuda")
    emb = emb_dev.cpu().numpy()
    rng = np.random.default_rng(smoke.SEED)
    qids = rng.choice(smoke.INDEX_N, size=smoke.INDEX_QUERIES, replace=False)
    q = emb[qids] + smoke.QUERY_SPREAD * rng.standard_normal(
        (smoke.INDEX_QUERIES, smoke.INDEX_DIM)).astype(np.float32) / smoke.INDEX_DIM ** 0.5
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    _, truth = topk_inner_product(emb_dev, torch.from_numpy(q).cuda(), smoke.RECALL_K)
    truth = truth.cpu().numpy()
    del emb_dev

    builds = {
        "ivfpq": lambda: IVFPQIndex.build(emb, smoke.IVFPQ_NLIST, device="cuda"),
        "pqflat": lambda: PQFlatIndex.build(emb, device="cuda"),
    }
    out: dict = {"card": card}
    for kind, build in builds.items():
        runs = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            index = build()
            seconds = time.perf_counter() - t0
            _, ids = index.search(q, smoke.RECALL_K)
            trained = [getattr(index, "centroids", np.zeros(0)), index.codebooks, index.codes]
            runs.append({"recall_at_10": smoke.recall_at_k(ids, truth), "seconds": seconds,
                         "digest": "-".join(digest(a) for a in trained)})
            print(f"[{card}] {kind}: {json.dumps(runs[-1])}", flush=True)
        out[kind] = {"runs": runs, "repeats": len({r["digest"] for r in runs}) == 1}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
