"""Copy fidelity of the serving plane's and the worker's modules: each
module the port keeps as a copy of a JAX-package module (host-only Python
that imports no JAX) must equal it statement for statement after the
import prefix ``bioengine_tpu.`` is renamed ``bioengine_tpu_torch.``; so
must each app bundle file copied from a JAX app (``BUNDLE_COPIES``).

The comparison is ``ast.dump`` of each top-level statement, keyed by what
it defines: a function or class by name, an import by its text, an
assignment by its targets, a ``try`` by its first statement, an ``if`` by
its test, any other expression statement by its text, the module
docstring as ``__doc__``. A class whose methods are allow-listed is
compared method by method. Every allow-listed key is a deliberate
difference of the port and must be listed, with its module, in
ROADMAP.md's slice-8, slice-9, slice-11, slice-12, slice-13, slice-14,
slice-15, slice-17 or slice-18 differences.
"""

import ast
from pathlib import Path

import pytest

from _torch_parity import few_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

# module -> {key: reason}; a module mapped to {} is an unchanged copy
COPIES = {
    "utils/tasks.py": {},
    "utils/backoff.py": {},
    "utils/permissions.py": {},
    "utils/telemetry.py": {},
    "utils/tracing.py": {},
    "rpc/schema.py": {},
    "rpc/protocol.py": {},
    "rpc/__init__.py": {},
    "cluster/topology.py": {
        "__doc__": "CUDA in place of jax.devices()",
        "import torch": "CUDA in place of jax.devices()",
        "from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device":
            "CUDA in place of jax.devices()",
        "detect_topology": "CUDA in place of jax.devices()",
    },
    "cluster/state.py": {
        "ClusterState.register_host": "a live host's rejoin keeps the leases held on it (slice 12)",
    },
    "serving/errors.py": {},
    "serving/replica.py": {},
    "serving/batching.py": {},
    "serving/outlier.py": {},
    "serving/remote.py": {},
    "serving/scheduler.py": {},
    "serving/router.py": {},
    "serving/slo.py": {},
    "serving/journal.py": {},
    "serving/warm_pool.py": {},
    "serving/mesh_replica.py": {},
    "serving/mesh_plan.py": {},
    "serving/compile_tier.py": {
        "DEFAULT_TIER_DIR": "the port's tier holds kernel libraries, apart from the JAX tier (slice 13)",
    },
    "serving/controller.py": {},
    "serving/__init__.py": {},
    "apps/manifest.py": {},
    "apps/builder.py": {},
    "apps/artifacts.py": {},
    # slice 9: the wire, the apps manager, the datasets plane, the worker
    "utils/network.py": {},
    "utils/geo_location.py": {},
    "testing/__init__.py": {},
    "testing/faults.py": {},
    "native/__init__.py": {},
    "native/store.py": {
        "import fcntl": "the library built under a lock and renamed into place whole (ROADMAP C7)",
        "import tempfile": "the library built under a lock and renamed into place whole (ROADMAP C7)",
        "_ensure_lib": "the library built under a lock and renamed into place whole (ROADMAP C7)",
        "_load": "the library built under a lock and renamed into place whole (ROADMAP C7)",
    },
    "rpc/transport.py": {},
    "rpc/server.py": {},
    "rpc/client.py": {},
    "apps/mcp.py": {},
    "apps/webrtc.py": {},
    "apps/proxy.py": {},
    "apps/artifact_http.py": {},
    "apps/manager.py": {},
    "cluster/provisioner.py": {},
    "cluster/cluster.py": {},
    "cluster/__init__.py": {},
    "datasets/net.py": {},
    "datasets/chunk_cache.py": {},
    "datasets/codecs.py": {},
    "datasets/zarr_codec.py": {},
    "datasets/http_zarr_store.py": {
        "import weakref": "a client and a request semaphore per event loop (ROADMAP C5)",
        "HttpZarrStore": "a client and a request semaphore per event loop (ROADMAP C5)",
    },
    "datasets/datasets.py": {},
    "datasets/proxy_server.py": {},
    "datasets/__main__.py": {},
    "datasets/__init__.py": {
        "__doc__": "CUDA prefetch in place of TPU prefetch",
    },
    "utils/profiling.py": {
        "__doc__": "torch.profiler in place of jax.profiler",
        "TRACE_FILE": "torch.profiler in place of jax.profiler",
        "_ACTIVE": "torch.profiler in place of jax.profiler",
        "start_trace": "torch.profiler in place of jax.profiler",
        "stop_trace": "torch.profiler in place of jax.profiler",
        "device_memory_snapshot": "torch.cuda memory stats and allocator snapshot",
    },
    "worker/code_executor.py": {
        "chip_env": "CUDA_VISIBLE_DEVICES in place of TPU_VISIBLE_CHIPS/DEVICES",
    },
    "worker/worker.py": {
        "__doc__": "device argument, torch.profiler, the cache holds kernel libraries",
        "from bioengine_tpu_torch.cluster.topology import detect_topology": "device argument",
        "from bioengine_tpu_torch.runtime.devices import DeviceLike": "device argument",
        "BioEngineWorker.__init__": "device argument",
        "BioEngineWorker.start": "topology on the device",
        "BioEngineWorker._service_definition": "the description names the GPU",
        "BioEngineWorker.start_profiling": "torch.profiler in place of jax.profiler",
        "BioEngineWorker.memory_profile": "torch.cuda memory stats and allocator snapshot",
    },
    "worker/__main__.py": {
        "__doc__": "--device",
        "create_parser": "--device",
        "worker_kwargs_from_args": "--device",
    },
    "worker/__init__.py": {},
    # slice 11: the worker host and the CLI
    "worker_host.py": {
        "__doc__": "device argument, torch.profiler, the tier carries kernel libraries",
        "from bioengine_tpu_torch.runtime.devices import DeviceLike": "device argument",
        "WorkerHost.__init__": "device and n_devices beside compile_cache_dir",
        "WorkerHost.start": "topology on the device",
        "WorkerHost.start_profiling": "torch.profiler in place of jax.profiler",
        "WorkerHost.stop_profiling": "torch.profiler in place of jax.profiler",
        "WorkerHost.memory_profile": "torch.cuda memory stats and allocator snapshot",
        "main": "--device/--n-devices in place of --platform",
    },
    "cli/__init__.py": {},
    "cli/__main__.py": {},
    "cli/utils.py": {},
    "cli/call.py": {},
    "cli/cluster.py": {
        "profile_command": "the allocator snapshot's size in place of pprof_bytes",
    },
    "cli/apps.py": {},
    "cli/debug.py": {
        "profile_command": "the allocator snapshot left out of the human output in place of pprof_b64",
    },
    "cli/slo.py": {},
    "cli/models.py": {},
    "cli/cli.py": {
        "main": "prog name bioengine-torch; the docstring names the CUDA worker",
    },
    # slice 12: the scenario engine, the fuzzer, the controller process, their commands
    "testing/invariants.py": {},
    "testing/scenarios.py": {
        "from bioengine_tpu_torch.runtime.devices import DeviceLike": "device argument",
        "_Plane.__init__": "device and n_devices kept for the hosts",
        "_Plane.spawn_host": "WorkerHost(device=, n_devices=)",
        "run_scenario_async": "device and n_devices",
        "run_scenario": "device and n_devices",
    },
    "testing/fuzz.py": {
        "from bioengine_tpu_torch.runtime.devices import DeviceLike": "device argument",
        "run_schedule": "device and n_devices passed through",
        "replay_artifact": "device and n_devices passed through",
        "fuzz": "device and n_devices passed through",
    },
    "testing/controller_proc.py": {
        "main": "no jax platform to pin: the controller holds no chips",
    },
    "cli/scenarios.py": {
        "__doc__": "--device/--n-devices in place of forced XLA CPU devices",
        "import os": "--device/--n-devices in place of forced XLA CPU devices",
        "import sys": "--device/--n-devices in place of forced XLA CPU devices",
        "from typing import Optional": "--device/--n-devices",
        "_prepare_cpu_devices": "--device/--n-devices in place of forced XLA CPU devices",
        "CPU_CHIPS_PER_HOST": "--device/--n-devices",
        "device_option": "--device/--n-devices",
        "n_devices_option": "--device/--n-devices",
        "_host_chips": "the placement error on too few chips",
        "scenarios_run_command": "--device/--n-devices",
    },
    "cli/fuzz.py": {
        "__doc__": "--device/--n-devices",
        "from bioengine_tpu_torch.cli.scenarios import _prepare_cpu_devices":
            "--device/--n-devices in place of forced XLA CPU devices",
        "from bioengine_tpu_torch.cli.scenarios import _host_chips, device_option, n_devices_option":
            "--device/--n-devices",
        "fuzz_command": "--device/--n-devices",
    },
    # slice 13: host-side device glue
    "utils/compile_cache.py": {
        "__doc__": "the cache holds the CUDA kernel libraries in place of XLA programs",
        "_DEFAULT": "the checkout's build/torch_kernels in place of ~/.cache/bioengine-tpu/xla",
        "enable_persistent_compilation_cache": "no jax config: the directory is the kernel libraries'",
    },
    "datasets/prefetch.py": {
        "__doc__": "pinned staging and a copy stream in place of jax.device_put",
        "import jax": "pinned staging and a copy stream in place of jax.device_put",
        "import torch": "pinned staging and a copy stream in place of jax.device_put",
        "from typing import Any, Iterable, Iterator, Optional, Sequence": "a Callable annotation",
        "from typing import Any, Callable, Iterable, Iterator, Optional, Sequence": "a Callable annotation",
        "from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device": "device argument",
        "prefetch_to_device": "pinned staging and a copy stream; a placement's mesh (slice 14)",
        "from bioengine_tpu_torch.parallel.data_parallel import host_parts, place, tree_map":
            "a placement's mesh; the pytree walk of jax.tree_util (slice 14)",
        "from bioengine_tpu_torch.parallel.mesh import Placement": "a placement's mesh (slice 14)",
        "_ShardedCopy": "a copy stream per device of a placement's mesh (slice 14)",
        "_prefetch": "the JAX generator, with the consumer's wait on each batch's copy",
        "_CopyStream": "pinned staging and a copy stream in place of jax.device_put",
        "ZarrBatchLoader.__doc__": "device and sharding arguments",
        "ZarrBatchLoader.__init__": "device and sharding arguments",
        "ZarrBatchLoader.__iter__": "device and sharding arguments",
    },
    "runtime/checkpoints.py": {
        "__doc__": "the service itself in place of orbax; torch.save format",
        "import concurrent.futures": "the service itself in place of orbax",
        "import os": "the service itself in place of orbax",
        "import shutil": "the service itself in place of orbax",
        "import threading": "the service itself in place of orbax",
        "import torch": "the service itself in place of orbax",
        "from bioengine_tpu_torch.models.cellpose import TrainState": "the port's TrainState",
        "from bioengine_tpu_torch.parallel.data_parallel import DataParallelTrainState, Replicated":
            "restore onto replicas (slice 14)",
        "_restore": "restore onto replicas (slice 14)",
        "STATE_FILE": "torch.save format",
        "_to_host": "the host snapshot before save returns",
        "_fill": "restore onto the template's devices and dtypes",
        "_snapshot": "TrainState, module or tree",
        "CheckpointService": "the service itself in place of orbax; torch.save format",
    },
    # slice 14: the parallel layer's data parallelism, one process driving the group
    "parallel/mesh.py": {
        "__doc__": "a port Mesh of torch devices in place of jax.sharding",
        "import jax": "a port Mesh of torch devices in place of jax.sharding",
        "import numpy as np": "a port Mesh of torch devices in place of jax.sharding",
        "from jax.sharding import Mesh, NamedSharding, PartitionSpec as P":
            "a port Mesh of torch devices in place of jax.sharding",
        "import torch": "a port Mesh of torch devices in place of jax.sharding",
        "from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device":
            "make_mesh defaults to every CUDA device and raises without CUDA",
        "Mesh": "a port Mesh of torch devices in place of jax.sharding",
        "Placement": "the port's placement in place of NamedSharding",
        "PartitionSpec": "the port's partition spec in place of jax.sharding's (slice 15)",
        "make_mesh": "make_mesh defaults to every CUDA device and raises without CUDA",
        "sharding": "the port's placement in place of NamedSharding",
        "replicated": "the port's placement in place of NamedSharding",
        "local_device_mesh": "a device argument: n entries of cpu on the CPU",
        "get_shard_map": "a JAX version shim with no counterpart",
        "named_axis_size": "a JAX version shim with no counterpart",
    },
    "parallel/data_parallel.py": {
        "__doc__": "explicit device-to-device copies in place of XLA's all-reduce",
        "import copy": "replicas are copies of the module",
        "import dataclasses": "the data-parallel train state",
        "from typing import Any, Callable": "the port's annotations",
        "from typing import Any, Callable, Optional": "the port's annotations",
        "import jax": "explicit device-to-device copies in place of XLA's all-reduce",
        "from jax.sharding import Mesh, NamedSharding, PartitionSpec as P":
            "explicit device-to-device copies in place of XLA's all-reduce",
        "import numpy as np": "host leaves become tensors",
        "import torch": "explicit device-to-device copies in place of XLA's all-reduce",
        "from torch import nn": "replicas of a module",
        "from bioengine_tpu_torch.models.cellpose import CellposeNet, LossTrainStep, TrainState":
            "the port's train step and state; the dp x sp forward is CellposeNet's",
        "from bioengine_tpu_torch.parallel import lockstep": "the dp x sp forward over each sp ring",
        "from bioengine_tpu_torch.parallel.mesh import Mesh, Placement": "the port's Mesh and placement",
        "_PerEntry": "a value per mesh entry",
        "Shards": "a leaf split over the mesh in place of a sharded jax.Array",
        "Blocks": "a leaf split on two dimensions over two mesh axes in place of a sharded jax.Array",
        "Replicated": "a value copied to each mesh entry in place of a replicated jax.Array",
        "DataParallelTrainState": "one replica per mesh entry, the first one updated",
        "tree_map": "the pytree walk of jax.tree_util",
        "_as_tensor": "host leaves become tensors",
        "shard_batch": "the host splits each leaf into equal shards",
        "host_parts": "a placement's parts on the host, for the prefetch",
        "place": "a placement's parts on their devices",
        "replicate": "one independent replica per mesh entry",
        "_sum_gradients": "gradients summed onto the first replica in shard order",
        "data_parallel_step": "the step of the global batch in place of jit_data_parallel_step",
        "jit_data_parallel_step": "the step of the global batch in place of jit_data_parallel_step",
        "DuplicateSpecError": "a spec naming one axis twice refuses, as NamedSharding does (slice 18)",
        "_split_dims": "a placement's split dimensions checked as NamedSharding checks them (slice 18)",
        "_whole": "images placed otherwise re-placed over the batch axis (slice 18)",
    },
    "parallel/__init__.py": {},
    # slice 17: the static analyzer, its command, the requirement pins
    "analysis/__init__.py": {
        "__doc__": "the BE-GRAPH capture rules in place of the BE-JAX tracer rules",
        "from bioengine_tpu_torch.analysis import jax_rules as _jax_rules":
            "the BE-GRAPH capture rules in place of the BE-JAX tracer rules",
        "from bioengine_tpu_torch.analysis import capture_rules as _capture_rules":
            "the BE-GRAPH capture rules in place of the BE-JAX tracer rules",
    },
    "analysis/__main__.py": {
        "__doc__": "the command is bioengine-torch analyze",
        "build_parser": "prog python -m bioengine_tpu_torch.analysis; default paths bioengine_tpu_torch",
    },
    "analysis/core.py": {
        "__doc__": "captured functions in place of jitted ones",
    },
    "analysis/baseline.py": {
        "DEFAULT_BASELINE": "the port's baseline .analyze-torch-baseline.json",
    },
    "analysis/sarif.py": {
        "__doc__": "the SARIF tool name bioengine-torch-analyze",
        "render_sarif": "the SARIF tool name bioengine-torch-analyze",
    },
    "analysis/project.py": {
        "__doc__": "the port's cache .analyze-torch-cache.json",
        "DEFAULT_CACHE": "the port's cache .analyze-torch-cache.json",
    },
    "analysis/async_rules.py": {},
    "analysis/interproc.py": {},
    "analysis/obs_rules.py": {},
    "analysis/dist_rules.py": {
        "__doc__": "the history is told without the JAX repository's PR count",
    },
    "analysis/lifecycle_rules.py": {
        "__doc__": "the history is told without the JAX repository's PR numbers",
    },
    "analysis/hotpath_rules.py": {},
    "cli/analyze.py": {
        "__doc__": "the command is bioengine-torch analyze",
        "analyze_command": "the help names the capture rules and bioengine-torch",
    },
    "utils/requirements.py": {
        "__doc__": "the image stack is torch and triton",
        "SKIP_PACKAGES": "the image stack is torch and triton",
    },
}

def _key(i: int, node: ast.stmt) -> str:
    if (
        i == 0
        and isinstance(node, ast.Expr)
        and isinstance(node.value, ast.Constant)
        and isinstance(node.value.value, str)
    ):
        return "__doc__"
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return node.name
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        return ast.unparse(node)
    if isinstance(node, ast.Assign):
        return ", ".join(ast.unparse(t) for t in node.targets)
    if isinstance(node, ast.AnnAssign):
        return ast.unparse(node.target)
    if isinstance(node, ast.Try):
        return "try: " + ast.unparse(node.body[0])
    if isinstance(node, ast.If):
        return "if " + ast.unparse(node.test)
    if isinstance(node, ast.Expr):
        return ast.unparse(node)
    return f"{type(node).__name__}@{i}"


def _items(body: list, prefix: str, split: set) -> dict:
    out = {}
    for i, node in enumerate(body):
        key = prefix + _key(i, node)
        if isinstance(node, ast.ClassDef) and key in split:
            out.update(_items(node.body, key + ".", split))
        else:
            out[key] = ast.dump(node)
    return out


def _pair(rel: str, skips: dict) -> tuple[dict, dict]:
    split = {k.rsplit(".", 1)[0] for k in skips if "." in k and not k.startswith(("import", "from"))}
    jax_src = (REPO / "bioengine_tpu" / rel).read_text().replace("bioengine_tpu.", "bioengine_tpu_torch.")
    port_src = (REPO / "bioengine_tpu_torch" / rel).read_text()
    return (
        _items(ast.parse(jax_src).body, "", split),
        _items(ast.parse(port_src).body, "", split),
    )


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copy_equals_the_jax_module(rel):
    skips = COPIES[rel]
    ref, ours = _pair(rel, skips)
    for key in skips:
        assert key in ref or key in ours, f"{rel}: allow-listed {key!r} is on neither side"
    differ = sorted(
        k for k in set(ref) | set(ours)
        if k not in skips and ref.get(k) != ours.get(k)
    )
    assert not differ, f"{rel}: differs from the JAX module at {differ}"


# the port's app bundles that are copies of a JAX app's files, prefix renamed
BUNDLE_COPIES = [
    "demo-app/demo_deployment.py",
    "fibsem-mito-analysis/analysis_deployment.py",
    "composition-demo/entry_deployment.py",
    "composition-demo/runtime_a.py",
    "composition-demo/runtime_b.py",
]


@pytest.mark.parametrize("rel", BUNDLE_COPIES)
def test_bundle_file_equals_the_jax_app(rel):
    jax_src = (REPO / "apps" / rel).read_text().replace("bioengine_tpu.", "bioengine_tpu_torch.")
    port_src = (REPO / "bioengine_tpu_torch" / "apps" / "bundles" / rel).read_text()
    ref, ours = _items(ast.parse(jax_src).body, "", set()), _items(ast.parse(port_src).body, "", set())
    assert ref.keys() == ours.keys()
    assert [k for k in ref if ref[k] != ours[k]] == []


def _listed_differences() -> str:
    """ROADMAP's "Slice 8 (", "Slice 9 (", "Slice 11 (", "Slice 12 (",
    "Slice 13 (", "Slice 14 (", "Slice 15 (", "Slice 17 (" and "Slice 18 ("
    differences sections."""
    text = (REPO / "ROADMAP.md").read_text()
    sections = []
    for heading in ("Slice 8 (", "Slice 9 (", "Slice 11 (", "Slice 12 (", "Slice 13 (", "Slice 14 (",
                    "Slice 15 (", "Slice 17 (", "Slice 18 ("):
        start = text.index(heading)
        end = text.find("\n\n\n", start)
        sections.append(text[start : end if end != -1 else len(text)])
    return "\n".join(sections)


@pytest.mark.parametrize("rel", sorted(k for k, v in COPIES.items() if v))
def test_every_skip_is_a_listed_difference(rel):
    section = _listed_differences()
    assert f"`{rel}`" in section, rel
    for key in COPIES[rel]:
        assert f"`{key}`" in section, f"{rel}: {key}"


@pytest.mark.parametrize("rel, name", [
    ("parallel/mesh.py", "MeshSpec"),
    ("parallel/mesh.py", "VirtualMeshSpec"),
    ("parallel/data_parallel.py", "per_device_batch"),
])
def test_parallel_copies_statement_for_statement(rel, name):
    """The parallel layer's specs and ``per_device_batch`` are never a
    listed difference: each equals the JAX statement."""
    assert name not in COPIES[rel]
    ref, ours = _pair(rel, COPIES[rel])
    assert name in ref and ours.get(name) == ref[name]
