"""Rules of the PyTorch port: it imports no JAX and nothing of the JAX
package, and its entry points run on the card unless asked for the CPU."""

import ast
import asyncio
import subprocess
import sys
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
from bioengine_tpu_torch.cluster.state import ClusterState
from bioengine_tpu_torch.cluster.topology import detect_topology
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
FORBIDDEN = {"jax", "flax", "optax", "orbax", "bioengine_tpu", "sklearn", "pandas"}
PORT_FILES = sorted((REPO / "bioengine_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]
# the modules of slice 8, each imported below in a fresh interpreter
SLICE8_MODULES = [
    "utils/tasks.py", "utils/backoff.py", "utils/permissions.py", "utils/telemetry.py",
    "utils/tracing.py", "utils/compile_cache.py",
    "rpc/__init__.py", "rpc/schema.py", "rpc/protocol.py",
    "cluster/__init__.py", "cluster/topology.py", "cluster/state.py",
    "serving/__init__.py", "serving/errors.py", "serving/replica.py", "serving/batching.py",
    "serving/outlier.py", "serving/remote.py", "serving/scheduler.py", "serving/router.py",
    "serving/slo.py", "serving/journal.py", "serving/warm_pool.py", "serving/mesh_replica.py",
    "serving/mesh_plan.py", "serving/compile_tier.py", "serving/controller.py",
    "apps/manifest.py", "apps/builder.py", "apps/artifacts.py",
    "apps/model_runner/runtime.py", "apps/model_runner/entry.py",
]
# the modules of slice 9: the wire, the apps manager, the datasets plane, the worker
SLICE9_MODULES = [
    "utils/network.py", "utils/geo_location.py", "utils/profiling.py",
    "testing/__init__.py", "testing/faults.py", "native/__init__.py", "native/store.py",
    "rpc/transport.py", "rpc/server.py", "rpc/client.py",
    "apps/mcp.py", "apps/webrtc.py", "apps/proxy.py", "apps/artifact_http.py", "apps/manager.py",
    "cluster/provisioner.py", "cluster/cluster.py",
    "datasets/__init__.py", "datasets/net.py", "datasets/chunk_cache.py", "datasets/codecs.py",
    "datasets/zarr_codec.py", "datasets/http_zarr_store.py", "datasets/datasets.py",
    "datasets/proxy_server.py", "datasets/__main__.py",
    "worker/__init__.py", "worker/code_executor.py", "worker/worker.py", "worker/__main__.py",
]
# the modules of slice 11: the worker host and the CLI
SLICE11_MODULES = [
    "worker_host.py", "cli/__init__.py", "cli/utils.py", "cli/call.py", "cli/cluster.py",
    "cli/apps.py", "cli/debug.py", "cli/slo.py", "cli/models.py", "cli/cli.py",
]
# the modules of slice 12: the scenario engine, the fuzzer, the controller process
SLICE12_MODULES = [
    "testing/invariants.py", "testing/scenarios.py", "testing/fuzz.py", "testing/controller_proc.py",
    "cli/scenarios.py", "cli/fuzz.py",
]
# the modules of slice 13: the compile cache, device prefetch, checkpoints
SLICE13_MODULES = [
    "utils/compile_cache.py", "ops/_build.py", "runtime/program_cache.py", "datasets/prefetch.py",
    "datasets/__init__.py", "runtime/checkpoints.py", "worker_host.py", "worker/worker.py",
]
# the modules of slice 14: the parallel layer's data parallelism
SLICE14_MODULES = ["parallel/__init__.py", "parallel/mesh.py", "parallel/data_parallel.py"]
# the modules of slice 15: the rest of the parallel layer
SLICE15_MODULES = [
    "parallel/tensor_parallel.py", "parallel/spatial.py", "parallel/ring.py", "ops/knn.py",
    "runtime/engine.py", "runtime/decode_engine.py", "apps/generate/service.py",
]
# the modules of slice 16: the exact dp x sp train step and the dry run
SLICE16_MODULES = [
    "graft_entry.py", "parallel/spatial.py", "parallel/data_parallel.py", "parallel/lockstep.py",
    "datasets/prefetch.py", "models/unet.py", "models/cellpose.py",
]
# the modules of slice 17: the static analyzer, its command, the requirement pins
SLICE17_MODULES = [
    "analysis/__init__.py", "analysis/__main__.py", "analysis/core.py", "analysis/baseline.py",
    "analysis/sarif.py", "analysis/project.py", "analysis/async_rules.py", "analysis/interproc.py",
    "analysis/obs_rules.py", "analysis/dist_rules.py", "analysis/lifecycle_rules.py",
    "analysis/hotpath_rules.py", "analysis/capture_rules.py", "cli/analyze.py", "utils/requirements.py",
]
BUNDLE_FILES = [
    "apps/bundles/cell-image-search/main.py", "apps/bundles/demo-app/demo_deployment.py",
    "apps/bundles/model-runner/entry_deployment.py", "apps/bundles/model-runner/runtime_deployment.py",
    # slice 10: every other app of the JAX repo
    "apps/bundles/cellpose-finetuning/main.py", "apps/bundles/generate/generate_deployment.py",
    "apps/bundles/fibsem-mito-analysis/analysis_deployment.py",
    "apps/bundles/composition-demo/entry_deployment.py", "apps/bundles/composition-demo/runtime_a.py",
    "apps/bundles/composition-demo/runtime_b.py", "apps/bundles/gpu-test/gpu_test_deployment.py",
]
BUNDLES = REPO / "bioengine_tpu_torch" / "apps" / "bundles"


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
    # slice 8: the serving plane, the topology over CUDA, the app builder
    for rel in SLICE8_MODULES:
        assert (REPO / "bioengine_tpu_torch" / rel).is_file(), rel
    for name in ("manifest.yaml", "entry_deployment.py", "runtime_deployment.py"):
        assert (REPO / "bioengine_tpu_torch" / "apps" / "bundles" / "model-runner" / name).is_file()
    # slice 9: the worker, the wire, the datasets plane, two more bundles
    for rel in SLICE9_MODULES + BUNDLE_FILES + [
        "worker/dashboard/index.html", "apps/bundles/cell-image-search/manifest.yaml",
        "apps/bundles/demo-app/manifest.yaml",
    ]:
        assert (REPO / "bioengine_tpu_torch" / rel).is_file(), rel
    # slice 13: the compile cache whole, device prefetch, checkpoints
    for rel in SLICE13_MODULES:
        assert (REPO / "bioengine_tpu_torch" / rel).is_file(), rel
    # slice 14: the parallel layer; slice 15: the rest of it
    for rel in SLICE14_MODULES + SLICE15_MODULES + SLICE16_MODULES:
        assert (REPO / "bioengine_tpu_torch" / rel).is_file(), rel
    # slice 10: a bundle for every app of the JAX repo (tpu-test's twin is gpu-test)
    jax_apps = {p.name for p in (REPO / "apps").iterdir() if (p / "manifest.yaml").is_file()}
    bundles = {p.name for p in BUNDLES.iterdir() if (p / "manifest.yaml").is_file()}
    assert bundles == (jax_apps - {"tpu-test"}) | {"gpu-test"}
    for app in ("cellpose-finetuning", "cell-image-search", "fibsem-mito-analysis", "composition-demo"):
        assert (BUNDLES / app / "frontend" / "index.html").is_file(), app
    # slice 11: the worker host and the CLI; slice 12: the scenario engine,
    # the fuzzer and their commands; slice 17: the analyzer and its command
    for rel in SLICE11_MODULES + SLICE12_MODULES + SLICE17_MODULES + ["cli/__main__.py"]:
        assert (REPO / "bioengine_tpu_torch" / rel).is_file(), rel
    assert len([m for m in SLICE17_MODULES if m.startswith("analysis/")]) == 13
    assert {p.name for p in (REPO / "bioengine_tpu_torch" / "analysis").glob("*.py")} == {
        m.removeprefix("analysis/") for m in SLICE17_MODULES if m.startswith("analysis/")
    }
    from click.testing import CliRunner

    from bioengine_tpu_torch.cli.cli import main as cli_main

    out = CliRunner().invoke(cli_main, ["--help"])
    assert out.exit_code == 0 and "  analyze " in out.output, out.output


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
        "import orbax.checkpoint as ocp\n"
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


def test_slice8_imports_load_nothing_forbidden():
    """In a fresh interpreter, every module of slice 8, the bundle's
    deployment files and chip_smoke.py import, a manifest and a cluster
    snapshot load, and no module of jax, flax, ``bioengine_tpu`` or the
    other forbidden packages has been imported along the way."""
    modules = [
        "bioengine_tpu_torch." + rel.removesuffix(".py").removesuffix("/__init__").replace("/", ".")
        for rel in SLICE8_MODULES
    ]
    bundle = REPO / "bioengine_tpu_torch" / "apps" / "bundles" / "model-runner"
    script = f"""
import importlib, runpy, sys
for module in {modules!r}:
    importlib.import_module(module)
for path in ({str(bundle / "entry_deployment.py")!r}, {str(bundle / "runtime_deployment.py")!r}):
    runpy.run_path(path)
import chip_smoke
from bioengine_tpu_torch.apps.manifest import load_manifest
from bioengine_tpu_torch.cluster.state import ClusterState
from bioengine_tpu_torch.cluster.topology import detect_topology
assert load_manifest({str(bundle)!r}).raw["id"] == "model-runner"
assert ClusterState(detect_topology(device="cpu")).snapshot()["memory"]["total_bytes"] > 0
bad = [m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r}]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_serving_defaults_are_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RuntimeDeployment()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detect_topology()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterState().free_chips()
    assert detect_topology(device="cpu").platform == "cpu"


def test_slice9_imports_load_nothing_forbidden():
    """In a fresh interpreter, every module of slice 9 and every bundle's
    deployment file import, and no module of jax, flax, ``bioengine_tpu``
    or the other forbidden packages has been imported along the way."""
    modules = [
        "bioengine_tpu_torch." + rel.removesuffix(".py").removesuffix("/__init__").replace("/", ".")
        for rel in SLICE9_MODULES
    ]
    paths = [str(REPO / "bioengine_tpu_torch" / rel) for rel in BUNDLE_FILES]
    script = f"""
import importlib, runpy, sys
for module in {modules!r}:
    importlib.import_module(module)
for path in {paths!r}:
    runpy.run_path(path)
bad = [m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r}]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_worker_entry_points_default_to_cuda(no_cuda, tmp_path, monkeypatch):
    """``BioEngineWorker`` and the CLI's parsed kwargs default to ``cuda``;
    without CUDA the worker raises at ``start()``, before the workspace lock."""
    import inspect

    # ``start()`` enables the kernel-library cache for the whole process
    # before it raises; off, so no later test in this worker inherits it
    monkeypatch.setenv("BIOENGINE_COMPILE_CACHE", "off")

    from bioengine_tpu_torch.worker import __main__ as cli
    from bioengine_tpu_torch.worker.worker import BioEngineWorker

    assert inspect.signature(BioEngineWorker).parameters["device"].default == "cuda"
    kwargs = cli.worker_kwargs_from_args(cli.create_parser().parse_args([]))
    assert kwargs["device"] == "cuda"
    worker = BioEngineWorker(**{**kwargs, "workspace_dir": tmp_path / "ws", "log_file": "off"})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        asyncio.run(worker.start())
    assert not (tmp_path / "ws" / "cluster.lock").exists()
    assert cli.worker_kwargs_from_args(cli.create_parser().parse_args(["--device", "cpu"]))["device"] == "cpu"


def test_app_entry_points_of_slice10_default_to_cuda(no_cuda, tmp_path, monkeypatch):
    """``GpuTest`` defaults to ``cuda`` and raises without it, as does the
    fine-tuning app's ``async_init`` once CUDA is gone; ``device="cpu"``
    runs the probe's matmul on the CPU."""
    import inspect
    import runpy

    GpuTest = runpy.run_path(str(BUNDLES / "gpu-test" / "gpu_test_deployment.py"))["GpuTest"]
    assert inspect.signature(GpuTest).parameters["device"].default is None
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GpuTest(device=device)
    probe = GpuTest(device="cpu")
    asyncio.run(probe.async_init())
    info = asyncio.run(probe.gpu_info())
    assert (info["backend"], info["matmul_norm"], info["error"]) == ("cpu", 16384.0, "")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)  # a card stood in for
    app = CellposeFinetune(sessions_root=str(tmp_path / "sessions"))
    assert app.device == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        asyncio.run(app.async_init())
    cpu = CellposeFinetune(sessions_root=str(tmp_path / "cpu-sessions"), device="cpu")
    cpu.bioengine_device_ids = [0]
    asyncio.run(cpu.async_init())
    assert cpu.device == torch.device("cpu")


def test_slice11_imports_load_nothing_forbidden():
    """In a fresh interpreter, the worker host and every module of the
    CLI import, the CLI's command tree loads, and no module of jax, flax,
    ``bioengine_tpu`` or the other forbidden packages has been imported."""
    modules = [
        "bioengine_tpu_torch." + rel.removesuffix(".py").removesuffix("/__init__").replace("/", ".")
        for rel in SLICE11_MODULES
    ]
    script = f"""
import importlib, sys
for module in {modules!r}:
    importlib.import_module(module)
from bioengine_tpu_torch.cli.cli import main
assert {{"analyze", "call", "apps", "cluster", "debug", "fuzz", "models", "scenarios", "slo", "top",
         "status", "worker"}} == set(main.commands)
bad = [m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r}]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_worker_host_entry_points_default_to_cuda(no_cuda, tmp_path):
    """``WorkerHost`` and ``python -m bioengine_tpu_torch.worker_host``
    default to ``cuda``: without CUDA ``WorkerHost.start`` and ``main``
    raise before they connect; ``--device cpu`` detects a CPU topology."""
    import inspect

    from bioengine_tpu_torch import worker_host

    assert inspect.signature(worker_host.WorkerHost).parameters["device"].default == "cuda"
    host = worker_host.WorkerHost("ws://127.0.0.1:9/ws", workspace_dir=tmp_path / "ws", log_file="off")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        asyncio.run(host.start())
    assert host.connection is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        worker_host.main(["--server-url", "ws://127.0.0.1:9/ws", "--workspace-dir", str(tmp_path / "ws")])
    cpu = worker_host.WorkerHost("ws://127.0.0.1:9/ws", workspace_dir=tmp_path / "ws", device="cpu",
                                 n_devices=4, log_file="off")
    with pytest.raises(OSError):  # the topology is detected, then the connect fails
        asyncio.run(cpu.start())
    assert cpu.topology.platform == "cpu" and cpu.topology.n_chips == 4


def test_slice12_imports_load_nothing_forbidden():
    """In a fresh interpreter, every module of slice 12 imports, the catalog
    and the fuzz topologies load, ``python -m
    bioengine_tpu_torch.testing.controller_proc --help`` parses, and no
    module of jax, flax, ``bioengine_tpu`` or the other forbidden packages
    has been imported along the way."""
    modules = [
        "bioengine_tpu_torch." + rel.removesuffix(".py").replace("/", ".") for rel in SLICE12_MODULES
    ]
    script = f"""
import contextlib, importlib, io, sys
for module in {modules!r}:
    importlib.import_module(module)
from bioengine_tpu_torch.testing import controller_proc, fuzz, scenarios
assert len(scenarios.list_scenarios()) >= 8 and "small_multihost" in fuzz.TOPOLOGIES
with contextlib.redirect_stdout(io.StringIO()) as out:
    try:
        controller_proc.main(["--help"])
    except SystemExit as e:
        assert e.code == 0
assert "--control-dir" in out.getvalue()
bad = [m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r}]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_slice13_imports_load_nothing_forbidden():
    """In a fresh interpreter, every module of slice 13 imports, the
    kernel's cache entry is named, and no module of jax, flax, orbax,
    ``bioengine_tpu`` or the other forbidden packages has been imported."""
    modules = [
        "bioengine_tpu_torch." + rel.removesuffix(".py").removesuffix("/__init__").replace("/", ".")
        for rel in SLICE13_MODULES
    ]
    script = f"""
import importlib, sys
for module in {modules!r}:
    importlib.import_module(module)
from bioengine_tpu_torch.ops import _build
assert _build.entry_name("flash_attn_fwd").endswith("-cache")
bad = [m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r}]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_slice13_entry_points_default_to_cuda(no_cuda, tmp_path):
    """``prefetch_to_device`` and ``ZarrBatchLoader`` default to ``cuda:0``
    and raise without it; a checkpoint restores onto its template's device,
    so ``CheckpointService`` takes none."""
    import inspect

    from bioengine_tpu_torch.datasets import ZarrBatchLoader, prefetch_to_device
    from bioengine_tpu_torch.runtime.checkpoints import CheckpointService

    assert inspect.signature(prefetch_to_device).parameters["device"].default is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prefetch_to_device(iter([np.zeros(2)]))
    assert list(prefetch_to_device(iter([np.zeros(2)]), device="cpu"))[0].device.type == "cpu"
    assert inspect.signature(ZarrBatchLoader).parameters["device"].default is None
    assert "device" not in inspect.signature(CheckpointService).parameters


def test_slice14_imports_load_nothing_forbidden():
    """In a fresh interpreter, every module of slice 14 imports and no
    module of jax, flax, ``bioengine_tpu`` or the other forbidden packages
    has been imported."""
    modules = [
        "bioengine_tpu_torch." + rel.removesuffix(".py").removesuffix("/__init__").replace("/", ".")
        for rel in SLICE14_MODULES
    ]
    script = f"""
import importlib, sys
for module in {modules!r}:
    importlib.import_module(module)
bad = [m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r}]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_slice14_meshes_default_to_cuda(no_cuda):
    """``make_mesh()`` and ``local_device_mesh()`` take the CUDA devices
    and raise without CUDA rather than build a CPU mesh; an engine,
    embedder or prefetch over a lease of several ids raises the same way
    unless asked for the CPU."""
    from bioengine_tpu_torch.parallel.mesh import local_device_mesh, make_mesh

    for build in (lambda: make_mesh({"dp": -1}), lambda: local_device_mesh(2),
                  lambda: resolve_devices([0, 1]),
                  lambda: InferenceEngine("m", UNet2D(features=(4, 8)), device_ids=[0, 1]),
                  lambda: ViTEmbedder(devices=["cuda:0", "cuda:1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert make_mesh({"dp": 2}, ["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2


def test_slice15_imports_load_nothing_forbidden():
    """In a fresh interpreter, every module of slice 15 imports and no
    module of jax, flax, ``bioengine_tpu`` or the other forbidden packages
    has been imported."""
    modules = [
        "bioengine_tpu_torch." + rel.removesuffix(".py").replace("/", ".") for rel in SLICE15_MODULES
    ]
    script = f"""
import importlib, sys
for module in {modules!r}:
    importlib.import_module(module)
bad = [m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r}]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_slice15_entry_points_default_to_cuda(no_cuda):
    """A dp decode engine over a lease, a tp engine, the sharded index
    without a mesh and ``make_mesh()`` for the spatial and ring layers take
    the CUDA devices and raise without CUDA, unless asked for the CPU."""
    from bioengine_tpu_torch.models.vit import ViT
    from bioengine_tpu_torch.ops.knn import ShardedKnnIndex
    from bioengine_tpu_torch.parallel.mesh import make_mesh
    from bioengine_tpu_torch.parallel.tensor_parallel import VIT_TP_RULES
    from bioengine_tpu_torch.runtime.decode_engine import DecodeEngine

    vit = ViT(dim=32, depth=1, num_heads=2, patch_size=8, img_size=16)
    for build in (lambda: DecodeEngine(device_ids=[0, 1]),
                  lambda: InferenceEngine("m", vit, device_ids=[0, 1], tp=2, tp_rules=VIT_TP_RULES),
                  lambda: ShardedKnnIndex(np.zeros((4, 8), np.float32)),
                  lambda: make_mesh({"sp": -1})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    engine = DecodeEngine(device="cpu", device_ids=[0, 1])
    assert engine.devices == [torch.device("cpu")] * 2
    assert ShardedKnnIndex(np.zeros((4, 8), np.float32), device="cpu").corpus.device.type == "cpu"


def test_slice16_imports_load_nothing_forbidden():
    """In a fresh interpreter, every module of slice 16 imports and no
    module of jax, flax, ``bioengine_tpu`` or the other forbidden packages
    has been imported."""
    modules = ["bioengine_tpu_torch." + rel.removesuffix(".py").replace("/", ".") for rel in SLICE16_MODULES]
    script = f"""
import importlib, sys
for module in {modules!r}:
    importlib.import_module(module)
bad = [m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r}]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_slice16_entry_points_default_to_cuda(no_cuda):
    """``entry`` and ``dryrun_multichip`` default to ``cuda`` and raise
    without it, as does the command without ``--device cpu``."""
    import inspect

    from bioengine_tpu_torch import graft_entry

    for fn in (graft_entry.entry, graft_entry.dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for call in (graft_entry.entry, lambda: graft_entry.dryrun_multichip(2), lambda: graft_entry.main(["2"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    fn, (params, images) = graft_entry.entry(device="cpu")
    assert fn(params, images).shape == (1, 256, 256, 3)


def test_slice17_imports_load_nothing_forbidden():
    """In a fresh interpreter, every module of slice 17 imports and no
    module of jax, flax, ``bioengine_tpu`` or the other forbidden packages
    has been imported; the analyzer is host-only and loads no torch."""
    modules = ["bioengine_tpu_torch." + rel.removesuffix(".py").replace("/", ".") for rel in SLICE17_MODULES]
    script = f"""
import importlib, sys
for module in {modules!r}:
    if module != "bioengine_tpu_torch.cli.analyze":
        importlib.import_module(module)
assert "torch" not in sys.modules, "the analyzer imported torch"
importlib.import_module("bioengine_tpu_torch.cli.analyze")
bad = [m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r}]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
