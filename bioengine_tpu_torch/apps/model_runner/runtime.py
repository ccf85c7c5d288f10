"""Model-runner runtime: serves BioImage Model Zoo packages on a device group.

Counterpart of ``apps/model-runner/runtime_deployment.py``:

- a ``Pipeline`` wraps the RDF's axes and pre-/post-processing around an
  execution backend;
- ``jax_params`` packages (a flat npz in flax names + a registry
  architecture) load through the registry and the weight bridge into the
  port's ``InferenceEngine`` (buckets, per-bucket CUDA graphs, overlap-
  tiled stitching of large images); with a ``<weights>.manifest.json``
  beside the npz the weights stream in while the engine builds;
- ``pytorch_state_dict`` packages (the RDF's architecture source executed
  in its own namespace, the state loaded with ``weights_only=True``) and
  ``torchscript`` packages run through ``runtime.torch_runner.TorchRunner``
  on the same device, whole arrays at a time in f32 with TF32 off (the
  reference runs them on the host CPU); their backend is ``"torch"``;
- ``RuntimeDeployment`` keeps the pipeline LRU and the test-report cache
  keyed on weight mtimes, reports CUDA out-of-memory the way the
  reference does, and serves as a replica of the port's serving plane:
  ``async_init`` takes the replica's chip lease (``bioengine_device_ids``;
  a lease of several chips builds data-parallel engines over them, the
  torch formats run on the first) and batching knobs
  (``bioengine_batch_config``), and concurrent ``predict`` calls on one
  pipeline and per-item shape ride one engine call through a
  ``ContinuousBatcher``.

Entry points run on ``cuda`` unless given ``device="cpu"``.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import re
import time
from collections import OrderedDict
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from bioengine_tpu_torch.models.registry import get_model
from bioengine_tpu_torch.rpc import schema_method
from bioengine_tpu_torch.runtime.convert import load_params_npz, state_dict_from_flax
from bioengine_tpu_torch.runtime.devices import (
    DeviceLike,
    mesh_cache_tag,
    resolve_device,
    resolve_devices,
)
from bioengine_tpu_torch.runtime.engine import EngineConfig, InferenceEngine
from bioengine_tpu_torch.runtime.rdf import (
    apply_processing,
    from_nhwc,
    load_model_rdf,
    to_nhwc,
)
from bioengine_tpu_torch.runtime.torch_runner import PRECISION, TorchRunner
from bioengine_tpu_torch.runtime.weight_stream import (
    StreamedWeightLoader,
    load_manifest,
    skeleton_from_manifest,
)
from bioengine_tpu_torch.utils import tracing

_FIRST_CONV = re.compile(r"\w+_0\.Conv_0\.weight|(encoder\.)?patch_embed\.weight")


def _normalize_oom(e: Exception) -> Exception:
    """CUDA out-of-memory as the plain RuntimeError the reference reports."""
    msg = str(e)
    if isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in msg.lower():
        return RuntimeError(
            f"CUDA out of memory while executing the model: {msg[:500]}. "
            f"Try a smaller input or enable tiled prediction "
            f"(default_blocksize_parameter)."
        )
    return e


def _input_channels(state: Mapping[str, torch.Tensor]) -> Optional[int]:
    """Input channels of a conv net from its first convolution's weight
    (``ConvBlock_0.Conv_0``, ``ConvBlock3D_0.Conv_0``, ``ResBlock_0.Conv_0``,
    a transformer's ``patch_embed`` or ``encoder.patch_embed``): flax infers them
    from the input at ``init``, the port's modules take them at
    construction. None for a model without one."""
    for key, value in state.items():
        if _FIRST_CONV.fullmatch(key):
            return int(value.shape[1])
    return None


class Pipeline:
    """One loaded model: RDF bookkeeping + an execution backend, the
    inference engine or (zoo torch formats) a ``TorchRunner``."""

    def __init__(
        self,
        package_path: Path,
        weights_format: Optional[str] = None,
        default_blocksize_parameter: Optional[int] = None,
        device: DeviceLike = None,
        devices: Optional[list] = None,
    ):
        # the replica's device group: the engine's dp mesh; None = [device]
        self.devices = list(devices) if devices else [resolve_device(device)]
        self.device = self.devices[0]
        self.package_path = Path(package_path)
        # how this pipeline's weights landed (eager vs streamed, seconds)
        self.load_info: dict = {}
        self._weight_loader: Optional[StreamedWeightLoader] = None
        self.rdf = load_model_rdf(self.package_path / "rdf.yaml")
        self.weights_format, self.weights_entry = self._select_weights(weights_format)
        config = EngineConfig()
        if default_blocksize_parameter:
            config.tile = int(default_blocksize_parameter)
            config.max_tile = int(default_blocksize_parameter)
            # an overlap at or above a small blocksize would clamp to
            # tile-1, stride-1 tiling; only that degenerate case rescales
            if config.tile_overlap >= config.tile:
                config.tile_overlap = max(config.tile // 8, 1)
        self.backend, self.engine = self._build_backend(config)

    # ---- weights selection --------------------------------------------------

    def _select_weights(self, requested: Optional[str]):
        weights = self.rdf.weights
        if requested:
            if requested not in weights:
                raise ValueError(
                    f"weights format '{requested}' not in model "
                    f"(has: {sorted(weights)})"
                )
            return requested, weights[requested]
        for fmt in ("jax_params", "pytorch_state_dict", "torchscript"):
            if fmt in weights:
                return fmt, weights[fmt]
        return self.rdf.preferred_weights

    def _resolve(self, source: str) -> Path:
        p = self.package_path / source
        if not p.exists():
            raise FileNotFoundError(f"weight source '{source}' not in package")
        return p

    # ---- engine construction ------------------------------------------------

    def _build_backend(self, config: EngineConfig):
        """(backend name, engine): (the device type, ``InferenceEngine``)
        for ``jax_params``, ("torch", ``TorchRunner``) for the zoo's torch
        formats."""
        if self.weights_format in ("pytorch_state_dict", "torchscript"):
            t_load = time.perf_counter()
            if self.weights_format == "torchscript":
                runner = TorchRunner(
                    torchscript_path=str(self._resolve(self.weights_entry["source"])),
                    device=self.device,
                )
            else:
                runner = TorchRunner(module=self._torch_module_from_rdf(), device=self.device)
            self.load_info = {
                "streamed": False,
                "weights_seconds": round(time.perf_counter() - t_load, 4),
            }
            return "torch", runner
        if self.weights_format != "jax_params":
            raise NotImplementedError(
                f"weights format '{self.weights_format}' is not supported "
                f"(supported: jax_params, pytorch_state_dict, torchscript)"
            )
        return self.device.type, self._build_engine(config)

    def _torch_module_from_rdf(self) -> torch.nn.Module:
        """RDF 0.4 (``"file.py:Callable"``) or 0.5 (``{source, callable,
        kwargs}``) pytorch architecture: execute the package's source in
        a namespace of its own, build the named callable and load the
        state dict into it."""
        entry = self.weights_entry
        arch = entry.get("architecture")
        if isinstance(arch, str):
            src, _, callable_name = arch.partition(":")
            arch_kwargs = entry.get("kwargs", {}) or {}
        elif isinstance(arch, dict):
            callable_name = arch.get("callable", "")
            src = (arch.get("source") or "").partition(":")[0]
            arch_kwargs = arch.get("kwargs", {}) or {}
        else:
            raise ValueError("pytorch_state_dict weights without architecture")
        src_path = self._resolve(src)
        namespace: dict = {"__name__": f"bioengine_model_{src_path.stem}"}
        exec(compile(src_path.read_text(), str(src_path), "exec"), namespace)
        factory = namespace.get(callable_name)
        if factory is None:
            raise ValueError(f"architecture callable '{callable_name}' not found in {src}")
        module = factory(**arch_kwargs)
        state = torch.load(self._resolve(entry["source"]), map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
        module.load_state_dict(state)
        return module

    def _build_engine(self, config: EngineConfig) -> InferenceEngine:
        entry = self.weights_entry
        arch = entry.get("architecture") or {}
        source = self._resolve(entry["source"])
        # streamed path: a key->shape manifest beside the npz lets the
        # engine build and capture against a zero skeleton while the real
        # bytes stream in; prediction gates on residency
        manifest = (
            load_manifest(source)
            if os.environ.get("BIOENGINE_WEIGHT_STREAMING", "1") != "0"
            else None
        )
        t_load = time.perf_counter()
        params = (
            skeleton_from_manifest(manifest)
            if manifest is not None
            else load_params_npz(str(source))
        )
        state = state_dict_from_flax(params)
        kwargs = dict(arch.get("kwargs") or {})
        in_channels = _input_channels(state)
        if in_channels is not None:
            kwargs.setdefault("in_channels", in_channels)
        model = get_model(arch.get("name", ""), **kwargs)
        # strict: a skeleton or checkpoint that does not fit the
        # architecture fails here, naming the keys
        model.load_state_dict(state)
        engine = InferenceEngine(
            model_id=self._model_key(),
            module=model,
            divisor=getattr(model, "divisor", 1),
            z_divisor=getattr(model, "z_divisor", 1),
            config=config,
            devices=self.devices,
        )
        if manifest is not None:
            engine.begin_param_streaming()
            self._weight_loader = StreamedWeightLoader(
                source,
                manifest,
                on_complete=lambda p: engine.complete_param_streaming(
                    state_dict_from_flax(p)
                ),
                on_error=engine.fail_param_streaming,
                model_id=self._model_key(),
            ).start()
            self.load_info = {"streamed": True, "manifest_keys": len(manifest)}
        else:
            self.load_info = {
                "streamed": False,
                "weights_seconds": round(time.perf_counter() - t_load, 4),
            }
        return engine

    def _model_key(self) -> str:
        return f"{self.rdf.rdf_id or self.rdf.name}@{self.package_path.name}"

    # ---- prediction ---------------------------------------------------------

    @property
    def input_spec(self):
        return self.rdf.inputs[0]

    @property
    def output_spec(self):
        return self.rdf.outputs[0]

    @staticmethod
    def extract_array(inputs) -> np.ndarray:
        """array | single-entry {input_name: array} -> f32 array."""
        if isinstance(inputs, dict):
            if len(inputs) != 1:
                raise ValueError(
                    "the runtime executes single-input models; got "
                    f"{sorted(inputs)}"
                )
            inputs = next(iter(inputs.values()))
        return np.asarray(inputs, np.float32)

    def predict(self, inputs) -> dict[str, np.ndarray]:
        """inputs: array | {input_name: array} -> {output_name: array}, in
        the RDF's declared axes on both sides."""
        spec = self.input_spec
        x = to_nhwc(self.extract_array(inputs), spec.axes)
        x = apply_processing(x, spec.preprocessing)
        y = self.engine.predict(x)
        out_spec = self.output_spec
        y = apply_processing(y, out_spec.postprocessing)
        y = from_nhwc(y, out_spec.axes)
        return {out_spec.name: y}

    async def predict_async(self, inputs) -> dict[str, np.ndarray]:
        """The whole prediction (processing + inference) on the engine's
        one dispatch thread: concurrent callers never race for the device
        and the event loop never blocks."""
        fn = tracing.carry(tracing.current_trace(), self.predict)
        return await asyncio.wrap_future(self.engine.submit(fn, inputs))

    def pipeline_stats(self) -> dict:
        if isinstance(self.engine, TorchRunner):
            return {}
        return self.engine.pipeline_stats.as_dict()

    def cold_start_info(self) -> dict:
        """How the weights landed and what the program builds cost."""
        info = dict(self.load_info)
        if isinstance(self.engine, TorchRunner):
            return info
        if self._weight_loader is not None:
            st = self._weight_loader.stats()
            info["weights_seconds"] = st["seconds"]
            info["bytes_loaded"] = st["bytes_loaded"]
            info["stream_done"] = st["done"]
            if st["error"]:
                info["stream_error"] = st["error"]
        progs = self.engine.describe()["programs"]
        info["compile_seconds"] = progs["real_compile_seconds"]
        info["persistent_cache_hits"] = progs["persistent_hits"]
        info["real_compiles"] = progs["real_compiles"]
        return info

    def close(self) -> None:
        self.engine.close()

    # ---- self test ----------------------------------------------------------

    def run_test(self) -> dict:
        """Run the packaged test tensors through the pipeline and compare
        with the expected outputs."""
        t0 = time.monotonic()
        test_in = self._load_test_arrays("inputs", "test_inputs")
        if test_in is None:
            spec = self.input_spec
            # z kept thin: 16 planes exercise the same code path as 64
            shape = [
                1 if a in "bc" else (16 if a == "z" else 64)
                for a in spec.axes.lower()
            ]
            test_in = np.random.default_rng(0).normal(size=shape).astype(np.float32)
            synthesized = True
        else:
            synthesized = False
        result = self.predict(test_in)
        output = next(iter(result.values()))
        report = {
            "status": "passed",
            "backend": self.backend,
            "weights_format": self.weights_format,
            "synthesized_input": synthesized,
            "input_shape": list(np.asarray(test_in).shape),
            "output_shape": list(output.shape),
            "duration_seconds": round(time.monotonic() - t0, 3),
        }
        expected = self._load_test_arrays("outputs", "test_outputs")
        if expected is not None and not synthesized:
            # bf16 compute against f32 reference outputs: ~3 decimal digits
            close = np.allclose(output, expected, rtol=1e-2, atol=1e-2)
            report["output_matches_expected"] = bool(close)
            if not close:
                report["status"] = "failed"
                report["max_abs_error"] = float(np.max(np.abs(output - expected)))
        return report

    def _load_test_arrays(self, field_05: str, field_04: str):
        """Test tensors: 0.5 inputs[i].test_tensor.source / 0.4 test_inputs."""
        raw = self.rdf.raw
        entries = raw.get(field_05) or []
        if entries and isinstance(entries[0], dict):
            tt = entries[0].get("test_tensor")
            if isinstance(tt, dict) and tt.get("source"):
                p = self.package_path / tt["source"]
                if p.exists():
                    return np.load(p)
        sources = raw.get(field_04) or []
        if sources:
            p = self.package_path / sources[0]
            if p.exists():
                return np.load(p)
        return None


class RuntimeDeployment:
    """Inference replica on one device: pipeline LRU + test-report cache +
    continuous batching (concurrent predicts against the same pipeline and
    per-item shape run as ONE engine call, ``serving/batching.py``)."""

    def __init__(
        self,
        max_pipelines: int = 4,
        batch_max: int = 8,
        batch_wait_ms: float = 5.0,
        device: DeviceLike = None,
        device_ids=None,
    ):
        self.max_pipelines = max_pipelines
        self.batch_max = batch_max
        self.batch_wait_ms = batch_wait_ms
        self._device = resolve_device(device)
        self._set_devices(resolve_devices(device_ids, self._device))
        self._pipelines: OrderedDict[str, Pipeline] = OrderedDict()
        self._lock = asyncio.Lock()
        self._batcher = None

    def _set_devices(self, devices: list) -> None:
        self._devices = devices
        self.device = devices[0]
        self.backend = self.device.type
        self.device_count = (
            torch.cuda.device_count() if self.backend == "cuda" else 1
        )

    async def async_init(self):
        """The replica lifecycle injects the leased chip group and the
        batching knobs (``deployment_config.<dep>.batching``) before this
        runs; they override the constructor's. A lease resolves on this
        deployment's device type (``resolve_devices``: refused, never
        remapped, when it names no such device)."""
        lease = getattr(self, "bioengine_device_ids", None)
        self._set_devices(resolve_devices(list(lease) if lease else None, self._device))
        batch_cfg = getattr(self, "bioengine_batch_config", None) or {}
        if batch_cfg.get("max_batch") is not None:
            self.batch_max = int(batch_cfg["max_batch"])
        if batch_cfg.get("max_wait_ms") is not None:
            self.batch_wait_ms = float(batch_cfg["max_wait_ms"])
        if self.batch_max > 1:
            from bioengine_tpu_torch.serving import ContinuousBatcher

            self._batcher = ContinuousBatcher(
                self._run_batch,
                max_batch=self.batch_max,
                max_wait_ms=self.batch_wait_ms,
            )

    async def _run_batch(self, signature, payloads):
        """One flushed group: same pipeline + same per-item shape, so the
        arrays concatenate along the batch axis into a single engine call,
        then split back per request."""
        pipeline = payloads[0][0]
        arrays = [a for _, a in payloads]
        sizes = [len(a) for a in arrays]
        with tracing.trace_span("batch.assemble", requests=len(arrays)):
            merged = np.concatenate(arrays, axis=0)
        result = await pipeline.predict_async(merged)
        out_name, y = next(iter(result.items()))
        outs = []
        start = 0
        for n in sizes:
            outs.append({out_name: y[start : start + n]})
            start += n
        return outs

    async def check_health(self):
        return  # nothing loaded, or engines that answer: healthy

    @staticmethod
    def _status_key(key: str, p: Pipeline) -> str:
        """Model key plus the cache-key prefix: one model under two
        weights formats or blocksizes is two pipelines."""
        return f"{p._model_key()}#{key[:8]}"

    def _engine_pipelines(self):
        """(key, pipeline) of the pipelines on the inference engine."""
        return [(k, p) for k, p in self._pipelines.items() if p.backend != "torch"]

    def pipeline_stats(self) -> dict:
        return {self._status_key(k, p): p.pipeline_stats() for k, p in self._engine_pipelines()}

    def cold_start_info(self) -> dict:
        return {self._status_key(k, p): p.cold_start_info() for k, p in self._engine_pipelines()}

    def mesh_info(self) -> dict:
        """The device group and each loaded engine's describe()."""
        lease = getattr(self, "bioengine_device_ids", None)
        info: dict = {
            "lease": list(lease) if lease else [d.index or 0 for d in self._devices],
            "engines": {
                self._status_key(k, p): p.engine.describe()
                for k, p in self._pipelines.items()
            },
        }
        # the engines' mesh, or the shape the lease implies before the
        # first pipeline loads; None on one device
        shapes = [e.get("mesh") for e in info["engines"].values()]
        if shapes:
            info["mesh_shape"] = shapes[0]
        elif len(self._devices) > 1:
            info["mesh_shape"] = {"dp": len(self._devices)}
        else:
            info["mesh_shape"] = None
        return info

    async def close(self) -> None:
        """Replica.stop's hook: flush the batcher and release every cached
        pipeline's engine (its dispatch thread and its graphs)."""
        if self._batcher is not None:
            await self._batcher.close()
        async with self._lock:
            pipelines = list(self._pipelines.values())
            self._pipelines.clear()
        for p in pipelines:
            p.close()

    # ---- pipeline cache -----------------------------------------------------

    @staticmethod
    def _cache_key(rdf_path: str, **kwargs) -> str:
        blob = json.dumps({"rdf_path": rdf_path, **kwargs}, sort_keys=True)
        return hashlib.md5(blob.encode()).hexdigest()

    def _mesh_tag(self) -> str:
        return mesh_cache_tag(len(self._devices))

    async def _get_pipeline(
        self,
        rdf_path: str,
        weights_format: Optional[str],
        default_blocksize_parameter: Optional[int],
    ) -> Pipeline:
        key = self._cache_key(
            rdf_path,
            weights_format=weights_format,
            blocksize=default_blocksize_parameter,
            mesh=self._mesh_tag(),
        )
        async with self._lock:
            if key in self._pipelines:
                self._pipelines.move_to_end(key)
                return self._pipelines[key]
        # build outside the lock (loading and the first captures take time)
        pipeline = await asyncio.to_thread(
            Pipeline,
            Path(rdf_path).parent if rdf_path.endswith(".yaml") else Path(rdf_path),
            weights_format,
            default_blocksize_parameter,
            self.device,
            self._devices,
        )
        async with self._lock:
            existing = self._pipelines.get(key)
            if existing is not None:
                # lost a concurrent-build race: keep the first one
                self._pipelines.move_to_end(key)
                pipeline.close()
                return existing
            self._pipelines[key] = pipeline
            while len(self._pipelines) > self.max_pipelines:
                _, evicted = self._pipelines.popitem(last=False)
                evicted.close()
        return pipeline

    # ---- handle API ---------------------------------------------------------

    @schema_method
    async def predict(
        self,
        rdf_path: str,
        inputs,
        weights_format: Optional[str] = None,
        default_blocksize_parameter: Optional[int] = None,
        sample_id: str = "sample",
        context=None,
    ):
        """Run one inference; returns {output_name: np.ndarray, "_meta": ...}.

        Concurrent calls against the same pipeline whose declared axes are
        batch-first and whose per-item shapes match ride one batched engine
        call (continuous batching); anything else takes the direct path."""
        t0 = time.monotonic()
        try:
            pipeline = await self._get_pipeline(
                rdf_path, weights_format, default_blocksize_parameter
            )
            array = pipeline.extract_array(inputs)
            if self._batchable(pipeline, array):
                # the full pipeline-cache key, not just the model key: one
                # model under another weights format or blocksize is
                # another pipeline and never co-batches
                signature = (
                    self._cache_key(
                        rdf_path,
                        weights_format=weights_format,
                        blocksize=default_blocksize_parameter,
                        mesh=self._mesh_tag(),
                    ),
                    tuple(array.shape[1:]),
                )
                result = await self._batcher.submit(signature, (pipeline, array))
            else:
                result = await pipeline.predict_async(array)
        except Exception as e:
            raise _normalize_oom(e) from e
        ms = (time.monotonic() - t0) * 1000
        return {
            **result,
            "_meta": {
                "sample_id": sample_id,
                "backend": pipeline.backend,
                "weights_format": pipeline.weights_format,
                "duration_ms": round(ms, 1),
            },
        }

    # processing ops that treat each sample independently (or use fixed
    # constants), so co-batched requests can't contaminate each other's
    # statistics: batch-global zero_mean/scale_range must NOT co-batch
    _PER_SAMPLE_SAFE_OPS = frozenset({"scale_linear", "sigmoid", "binarize", "clip"})

    @classmethod
    def _processing_per_sample_safe(cls, ops) -> bool:
        for op in ops or []:
            name = op.get("name", op.get("id"))
            kw = op.get("kwargs", {}) or {}
            if name in cls._PER_SAMPLE_SAFE_OPS:
                continue
            if (
                name in ("zero_mean_unit_variance", "fixed_zero_mean_unit_variance")
                and (kw.get("mean") is not None or kw.get("mode") == "per_sample")
            ):
                continue  # fixed constants or per-sample stats
            return False
        return True

    def _batchable(self, pipeline: Pipeline, array: np.ndarray) -> bool:
        return (
            self._batcher is not None
            and pipeline.input_spec.axes.startswith("b")
            and pipeline.output_spec.axes.startswith("b")
            and array.ndim == len(pipeline.input_spec.axes)
            and self._processing_per_sample_safe(pipeline.input_spec.preprocessing)
            and self._processing_per_sample_safe(pipeline.output_spec.postprocessing)
        )

    @schema_method
    async def test(
        self,
        rdf_path: str,
        weights_format: Optional[str] = None,
        skip_cache: bool = False,
        context=None,
    ):
        """Test a model package; the report is cached beside it, keyed on
        the weight files' mtimes."""
        package = Path(rdf_path).parent if rdf_path.endswith(".yaml") else Path(rdf_path)
        cache_file = package / ".test_cache.json"
        stamp = self._weights_stamp(package)
        if not skip_cache and cache_file.exists():
            try:
                cached = json.loads(cache_file.read_text())
                if cached.get("stamp") == stamp:
                    return cached["report"]
            except (json.JSONDecodeError, KeyError):
                pass
        try:
            pipeline = await self._get_pipeline(str(package), weights_format, None)
            # on the engine's dispatch thread, like every other prediction
            report = await asyncio.wrap_future(pipeline.engine.submit(pipeline.run_test))
        except Exception as e:
            report = {"status": "failed", "error": str(_normalize_oom(e))}
        try:
            cache_file.write_text(json.dumps({"stamp": stamp, "report": report}))
        except OSError:
            pass  # read-only package dirs still get a fresh report
        return report

    @staticmethod
    def _weights_stamp(package: Path) -> str:
        parts = []
        for p in sorted(package.glob("*")):
            if p.suffix in (".npz", ".pt", ".pth", ".onnx") or "weight" in p.name:
                parts.append(f"{p.name}:{p.stat().st_mtime_ns}")
        return ";".join(parts)

    @schema_method
    async def get_status(self, context=None):
        """Loaded pipelines + backend info."""
        return {
            "backend": self.backend,
            "device": str(self.device),
            "device_count": self.device_count,
            "loaded_pipelines": [
                {
                    "model": p._model_key(),
                    "backend": p.backend,
                    "weights_format": p.weights_format,
                    **({"precision": PRECISION} if p.backend == "torch" else {}),
                }
                for p in self._pipelines.values()
            ],
        }
