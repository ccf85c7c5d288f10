"""Rules of the PyTorch port: it imports no JAX and nothing of the JAX
package, and its entry points run on the card unless asked for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

from bioengine_tpu_torch.apps.cell_image_search.embedder import ViTEmbedder
from bioengine_tpu_torch.apps.cell_image_search.service import CellImageSearch
from bioengine_tpu_torch.runtime.devices import resolve_device

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "flax", "bioengine_tpu"}
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
    assert (REPO / "bioengine_tpu_torch" / "csrc" / "flash_attn_fwd.cu").is_file()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_imports_no_jax_and_nothing_of_the_jax_package(path):
    # top-level names only: "bioengine_tpu_torch" is not "bioengine_tpu"
    assert not _imported_top_levels(path) & FORBIDDEN


def test_import_walk_sees_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import jax.numpy as jnp\nfrom flax import linen\n"
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
