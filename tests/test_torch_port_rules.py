"""Rules of the PyTorch port: it imports no JAX and nothing of the JAX
package, and its entry points run on the card unless asked for the CPU."""

import ast
import asyncio
from pathlib import Path

import numpy as np
import pytest
import torch

from bioengine_tpu_torch.apps.cell_image_search import index
from bioengine_tpu_torch.apps.cell_image_search.embedder import ViTEmbedder
from bioengine_tpu_torch.apps.cell_image_search.service import CellImageSearch
from bioengine_tpu_torch.apps.cellpose_finetuning.service import CellposeFinetune
from bioengine_tpu_torch.apps.generate.service import GenerateDeployment
from bioengine_tpu_torch.apps.model_runner.entry import EntryDeployment
from bioengine_tpu_torch.apps.model_runner.runtime import Pipeline, RuntimeDeployment
from bioengine_tpu_torch.models.cellpose import CellposeConfig, create_model_and_state
from bioengine_tpu_torch.models.registry import list_models
from bioengine_tpu_torch.models.unet import UNet2D
from bioengine_tpu_torch.ops import kmeans
from bioengine_tpu_torch.ops.flows import masks_from_flows
from bioengine_tpu_torch.runtime.decode_engine import DecodeEngine
from bioengine_tpu_torch.runtime.devices import resolve_device, resolve_devices
from bioengine_tpu_torch.runtime.engine import InferenceEngine
from bioengine_tpu_torch.runtime.kv_cache import PagedKVCache
from bioengine_tpu_torch.runtime.torch_runner import TorchRunner

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "flax", "optax", "bioengine_tpu", "sklearn", "pandas"}
PORT_FILES = sorted((REPO / "bioengine_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]


def _imported_top_levels(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_files_exist():
    names = {p.name for p in PORT_FILES}
    assert {"attention.py", "vit.py", "service.py", "chip_smoke.py"} <= names
    # slice 2: model-runner serving
    assert {
        "buckets.py", "tracing.py", "program_cache.py", "pipeline.py",
        "unet.py", "unet3d.py", "registry.py", "convert.py", "devices.py",
        "engine.py", "rdf.py", "weight_stream.py", "runtime.py",
    } <= names
    # slice 3: cellpose fine-tuning
    assert {"flows.py", "cellpose.py"} <= names
    # slice 4: the transformer backbones
    assert {"sam.py", "cellpose_sam.py"} <= names
    # slice 5: StarDist, the zoo's torch formats, the entry deployment
    assert {"stardist.py", "torch_runner.py", "entry.py"} <= names
    assert (REPO / "bioengine_tpu_torch" / "ops" / "stardist.py").is_file()
    assert (REPO / "bioengine_tpu_torch" / "models" / "stardist.py").is_file()
    assert (REPO / "bioengine_tpu_torch" / "apps" / "cellpose_finetuning" / "service.py").is_file()
    assert (REPO / "bioengine_tpu_torch" / "csrc" / "flash_attn_fwd.cu").is_file()
    # slice 6: cell-image-search at corpus scale
    assert {"kmeans.py", "knn.py", "index.py", "ingestion.py", "normalizer.py"} <= names
    assert (REPO / "bioengine_tpu_torch" / "ops" / "kmeans.py").is_file()
    # slice 7: token generation, the metrics and flight registries
    for rel in (
        "utils/metrics.py", "utils/flight.py", "utils/logger.py",
        "runtime/kv_cache.py", "runtime/decode_engine.py",
        "serving/scheduler.py", "serving/decode.py", "apps/generate/service.py",
    ):
        assert (REPO / "bioengine_tpu_torch" / rel).is_file(), rel


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_imports_no_jax_and_nothing_of_the_jax_package(path):
    # top-level names only: "bioengine_tpu_torch" is not "bioengine_tpu"
    assert not _imported_top_levels(path) & FORBIDDEN


def test_import_walk_sees_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import jax.numpy as jnp\nfrom flax import linen\nimport optax\n"
        "from bioengine_tpu.ops import knn\nimport bioengine_tpu_torch\n"
        "from sklearn.cluster import MiniBatchKMeans\nimport pandas as pd\n"
    )
    assert _imported_top_levels(probe) & FORBIDDEN == FORBIDDEN


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(no_cuda):
    for device in (None, "cuda", "cuda:0", torch.device("cuda", 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(device)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_entry_points_without_device_raise_without_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ViTEmbedder()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CellImageSearch(workspace_dir=str(tmp_path))
    assert ViTEmbedder(device="cpu").device.type == "cpu"


def test_index_entry_points_raise_without_cuda(no_cuda, tmp_path):
    """Every path that trains or searches on the device: k-means, the IVF
    and PQ builds, build_index above the FlatIP size, the PQ scan's first
    search, and through them the service's ingestion."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(64, 768)).astype(np.float32)
    rows = [{"crop": j} for j in range(64)]
    for device in (None, "cuda"):
        calls = [
            lambda: kmeans.kmeans(emb, 4, device=device),
            lambda: index.IVFFlatIndex.build(emb, 4, device=device),
            lambda: index.IVFPQIndex.build(emb, 4, device=device),
            lambda: index.PQFlatIndex.build(emb, device=device),
            lambda: index.build_index(emb, rows, tmp_path, 200_000, device=device),
            lambda: index.build_index(emb, rows, tmp_path, 5_000_000, device=device),
            lambda: index.select_index(5_000_000, 64, device),
            lambda: index.PQFlatIndex(np.zeros((96, 256, 8), np.float32),
                                      np.zeros((4, 96), np.uint8), device=device).search(emb[0], 1),
            lambda: index.FlatIPIndex(emb, device=device).search(emb[0], 1),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    assert index.build_index(emb, rows, tmp_path)["index_type"] == "FlatIP"  # trains nothing
    # the service's methods run on its device, which only "cpu" gives here
    svc = CellImageSearch(workspace_dir=str(tmp_path / "ws"), device="cpu",
                          model_overrides={"dim": 32, "depth": 1, "num_heads": 2})
    assert svc.device.type == "cpu" and svc.embedder.device.type == "cpu"
    # every method of the JAX app's CellImageSearch
    tree = ast.parse((REPO / "apps" / "cell-image-search" / "main.py").read_text())
    (jax_cls,) = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "CellImageSearch"]
    methods = {f.name for f in jax_cls.body if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))}
    assert {"start_ingestion", "get_umap_preview", "project_query_onto_umap"} <= methods
    for method in methods:
        assert callable(getattr(svc, method)), method


def test_serving_entry_points_raise_without_cuda(no_cuda, tmp_path):
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InferenceEngine("m", UNet2D(features=(4, 8)), device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            RuntimeDeployment(device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Pipeline(tmp_path, device=device)  # before reading the package
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_devices([0], device)
    assert InferenceEngine("m", UNet2D(features=(4, 8)), device="cpu").device.type == "cpu"
    assert RuntimeDeployment(device="cpu").backend == "cpu"


def test_finetuning_entry_points_raise_without_cuda(no_cuda, tmp_path):
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CellposeFinetune(sessions_root=str(tmp_path / "sessions"), device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_model_and_state(CellposeConfig(features=(4, 8)), device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            masks_from_flows(np.zeros((2, 8, 8), np.float32), np.ones((8, 8), np.float32), device=device)
    assert CellposeFinetune(sessions_root=str(tmp_path / "sessions"), device="cpu").device.type == "cpu"
    assert "cellpose" in list_models()


def test_zoo_entry_points_raise_without_cuda(no_cuda, tmp_path, monkeypatch):
    monkeypatch.setenv("BIOENGINE_LOCAL_MODEL_PATH", str(tmp_path))
    module = torch.nn.Identity()
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchRunner(module=module, device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            EntryDeployment(cache_dir=str(tmp_path / "cache"), device=device)
    runner = TorchRunner(module=module, device="cpu")
    assert runner.device.type == "cpu"
    runner.close()
    entry = EntryDeployment(cache_dir=str(tmp_path / "cache"), device="cpu")
    assert entry.runtime_deployment.backend == "cpu"
    assert "stardist2d" in list_models()


def test_decode_entry_points_raise_without_cuda(no_cuda):
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DecodeEngine(device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PagedKVCache(2, 4, 16, num_blocks=4, block_size=4, device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            asyncio.run(GenerateDeployment(device=device).async_init())
    assert DecodeEngine(device="cpu").kv.k_pool.device.type == "cpu"
    app = GenerateDeployment(device="cpu")
    asyncio.run(app.async_init())
    assert app.engine.device.type == "cpu"
    asyncio.run(app.close())
