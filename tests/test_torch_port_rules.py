"""Rules of the PyTorch port: it imports no JAX and nothing of the JAX
package, and its entry points run on the card unless asked for the CPU."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from bioengine_tpu_torch.apps.cell_image_search.embedder import ViTEmbedder
from bioengine_tpu_torch.apps.cell_image_search.service import CellImageSearch
from bioengine_tpu_torch.apps.cellpose_finetuning.service import CellposeFinetune
from bioengine_tpu_torch.apps.model_runner.entry import EntryDeployment
from bioengine_tpu_torch.apps.model_runner.runtime import Pipeline, RuntimeDeployment
from bioengine_tpu_torch.models.cellpose import CellposeConfig, create_model_and_state
from bioengine_tpu_torch.models.registry import list_models
from bioengine_tpu_torch.models.unet import UNet2D
from bioengine_tpu_torch.ops.flows import masks_from_flows
from bioengine_tpu_torch.runtime.devices import resolve_device, resolve_devices
from bioengine_tpu_torch.runtime.engine import InferenceEngine
from bioengine_tpu_torch.runtime.torch_runner import TorchRunner

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "flax", "optax", "bioengine_tpu"}
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


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_imports_no_jax_and_nothing_of_the_jax_package(path):
    # top-level names only: "bioengine_tpu_torch" is not "bioengine_tpu"
    assert not _imported_top_levels(path) & FORBIDDEN


def test_import_walk_sees_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import jax.numpy as jnp\nfrom flax import linen\nimport optax\n"
        "from bioengine_tpu.ops import knn\nimport bioengine_tpu_torch\n"
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
