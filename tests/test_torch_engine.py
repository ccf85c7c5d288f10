"""The port's inference engine on ``device="cpu"``: the cases of
``tests/test_runtime.py`` (buckets, program cache, engine, pipelined
engine, global-output guard) re-run against it, and the port's engine
held against the JAX engine on the same bridged U-Net weights, direct and
tiled, 2D and volumetric, f32 to 1e-4 max-abs (the two sides differ only
in summation order inside the model; the padding, tiling and stitching
are the same numpy)."""

import asyncio
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from bioengine_tpu.models import get_model as jax_get_model
from bioengine_tpu.runtime.engine import EngineConfig as JaxEngineConfig
from bioengine_tpu.runtime.engine import InferenceEngine as JaxEngine
from bioengine_tpu.runtime.program_cache import CompiledProgramCache as JaxCache
from _torch_parity import few_torch_threads, seeded_flax_params  # noqa: F401
from bioengine_tpu_torch.models import registry
from bioengine_tpu_torch.runtime import convert
from bioengine_tpu_torch.runtime.buckets import (
    bucket_batch,
    bucket_dim,
    bucket_shape,
    crop_to,
    fill_bucketed,
    pad_to,
)
from bioengine_tpu_torch.runtime.devices import mesh_cache_tag, resolve_devices
from bioengine_tpu_torch.runtime.engine import EngineConfig, InferenceEngine
from bioengine_tpu_torch.runtime.pipeline import StagingPool
from bioengine_tpu_torch.runtime.program_cache import CompiledProgramCache
from bioengine_tpu_torch.utils import tracing


class Fn(nn.Module):
    """A module around a plain function of the input."""

    def __init__(self, fn, scale=None):
        super().__init__()
        self.fn = fn
        if scale is not None:
            self.scale = nn.Parameter(torch.tensor(float(scale)))

    def forward(self, x):
        return self.fn(self, x)


def engine(model_id, fn, scale=None, **kw):
    kw.setdefault("cache", CompiledProgramCache())
    return InferenceEngine(model_id, Fn(fn, scale), device="cpu", **kw)


class TestBuckets:
    def test_bucket_dim_ladder(self):
        assert bucket_dim(200) == 256
        assert bucket_dim(256) == 256
        assert bucket_dim(257) == 384

    def test_bucket_dim_divisor(self):
        assert bucket_dim(100, divisor=8) % 8 == 0

    def test_bucket_fallback_respects_odd_divisor(self):
        assert bucket_dim(8, (8, 16, 24, 32), 5) == 10
        assert bucket_dim(101, (8, 16), 5) == 160  # 5 * 2^5
        assert bucket_dim(106, (8, 16), 5) == 160
        assert bucket_dim(3000, (64, 128), 2) == 3072

    def test_bucket_above_ladder(self):
        assert bucket_dim(5000) >= 5000

    def test_bucket_batch(self):
        assert bucket_batch(3) == 4
        assert bucket_batch(64) == 64
        assert bucket_batch(130, multiple_of=4) == 192
        assert bucket_batch(1, multiple_of=3) == 3

    def test_pad_crop_roundtrip(self):
        x = np.random.rand(1, 50, 70, 3).astype(np.float32)
        bh, bw = bucket_shape((50, 70))
        padded = pad_to(x, (bh, bw))
        assert padded.shape == (1, bh, bw, 3)
        np.testing.assert_array_equal(crop_to(padded, (50, 70)), x)

    def test_pad_rejects_oversize(self):
        with pytest.raises(ValueError):
            pad_to(np.zeros((1, 300, 300, 1)), (256, 256))

    def test_fill_bucketed_zeroes_the_rest(self):
        dst = np.full((2, 4, 4, 1), 7.0, np.float32)
        fill_bucketed(dst, np.ones((1, 3, 2, 1), np.float32))
        assert dst.sum() == 6 and dst[0, :3, :2].min() == 1
        with pytest.raises(ValueError):
            fill_bucketed(dst, np.ones((3, 4, 4, 1), np.float32))


class TestProgramCache:
    def test_hit_miss_eviction(self):
        cache = CompiledProgramCache(max_programs=2)
        calls = []
        for key in ["a", "b", "a", "c"]:
            cache.get_or_compile(key, lambda k=key: calls.append(k) or k)
        assert calls == ["a", "b", "c"]  # "a" second time was a hit
        assert cache.stats.hits == 1
        assert cache.stats.evictions == 1  # "b", the least recently used
        assert len(cache) == 2 and cache.keys() == ["a", "c"]

    def test_concurrent_build_single_compile(self):
        cache = CompiledProgramCache()
        n_builds = []
        barrier = threading.Barrier(4)

        def build():
            n_builds.append(1)
            return "prog"

        def worker():
            barrier.wait()
            assert cache.get_or_compile("k", build) == "prog"

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
        assert len(n_builds) == 1

    def test_evict_predicate(self):
        cache = CompiledProgramCache()
        cache.get_or_compile(("m1", 256), lambda: 1)
        cache.get_or_compile(("m2", 256), lambda: 2)
        assert cache.evict(lambda k: k[0] == "m1") == 1
        assert cache.keys() == [("m2", 256)]

    def test_eviction_drops_compile_seconds(self):
        cache = CompiledProgramCache(max_programs=2)
        for key in ["a", "b", "c"]:  # "a" evicted by LRU pressure
            cache.get_or_compile(key, lambda k=key: k)
        assert set(cache.stats.compile_seconds) == {"b", "c"}
        cache.evict(lambda k: k == "b")
        assert set(cache.stats.compile_seconds) == {"c"}
        d = cache.stats.as_dict()
        assert d["total_compile_seconds"] >= d["live_compile_seconds"]
        assert d["persistent_hits"] == 0
        info = cache.compile_info_snapshot()
        assert info == {"c": {"seconds": info["c"]["seconds"], "cache_hit": False}}


class TestEngine:
    @pytest.fixture(scope="class")
    def eng(self):
        return engine("ident", lambda m, x: x * m.scale, scale=2.0)

    def test_predict_exact_bucket(self, eng):
        x = np.ones((1, 64, 64, 1), np.float32)
        np.testing.assert_allclose(eng.predict(x), 2.0 * x)

    def test_predict_odd_shape_cropped_back(self, eng):
        x = np.random.rand(2, 50, 77, 3).astype(np.float32)
        out = eng.predict(x)
        assert out.shape == (2, 50, 77, 3)
        np.testing.assert_allclose(out, 2 * x, rtol=1e-5)

    def test_same_bucket_reuses_program(self, eng):
        eng.predict(np.ones((1, 60, 60, 1), np.float32))
        misses_before = eng.cache.stats.misses
        eng.predict(np.ones((1, 64, 64, 1), np.float32))  # same bucket
        assert eng.cache.stats.misses == misses_before
        key = eng.program_key((1, 64, 64, 1), np.float32)
        assert key == ("ident", 1, 64, 64, 1, "float32", True, eng._placement_key)
        assert eng._placement_key.startswith("1dev@cpu#")
        assert key in eng.cache.keys()

    def test_tiled_prediction_matches_direct(self):
        cfg = EngineConfig(max_tile=64, tile=48, tile_overlap=16)
        eng = engine("plus1", lambda m, x: x + 1.0, config=cfg)
        x = np.random.rand(1, 100, 90, 2).astype(np.float32)
        out = eng.predict(x)
        assert out.shape == x.shape
        np.testing.assert_allclose(out, x + 1.0, rtol=1e-4, atol=1e-5)

    def test_volume_bucketed_predict(self, eng):
        x = np.random.rand(1, 5, 50, 70, 2).astype(np.float32)
        out = eng.predict(x)
        assert out.shape == x.shape
        np.testing.assert_allclose(out, 2 * x, rtol=1e-5)

    def test_volume_tiled_matches_direct(self):
        cfg = EngineConfig(
            max_tile=32, tile=24, tile_overlap=8,
            max_tile_z=8, tile_z=6, tile_overlap_z=2, ladder_z=(2, 4, 6, 8),
        )
        eng = engine("times3-3d", lambda m, x: x * 3.0, config=cfg)
        x = np.random.rand(1, 13, 40, 50, 1).astype(np.float32)
        out = eng.predict(x)
        assert out.shape == x.shape
        np.testing.assert_allclose(out, 3 * x, rtol=1e-4, atol=1e-5)

    def test_thin_wide_stack_clamps_z_overlap(self):
        cfg = EngineConfig(
            max_tile=32, tile=24, tile_overlap=8,
            max_tile_z=16, tile_z=12, tile_overlap_z=8,
        )
        eng = engine("plus2-thin", lambda m, x: x + 2.0, config=cfg)
        x = np.random.rand(1, 4, 60, 40, 1).astype(np.float32)
        out = eng.predict(x)
        assert out.shape == x.shape
        np.testing.assert_allclose(out, x + 2.0, rtol=1e-4, atol=1e-5)

    def test_tiled_chunks_bound_device_batch(self):
        cfg = EngineConfig(max_tile=16, tile=16, tile_overlap=4, tile_batch=2, ladder=(16,))
        cache = CompiledProgramCache()
        eng = engine("times2-chunk", lambda m, x: x * 2.0, config=cfg, cache=cache)
        x = np.random.rand(1, 50, 50, 1).astype(np.float32)
        np.testing.assert_allclose(eng.predict(x), x * 2.0, rtol=1e-4, atol=1e-5)
        batches = {key[1] for key in cache.keys()}  # (model, B, ...)
        assert max(batches) <= 2, batches

    def test_volume_respects_z_divisor(self):
        """A real 3D conv model: padding must land on the pooling divisor
        in every axis or the forward would fail on shapes."""
        model = registry.get_model("unet3d", features=(2, 4), out_channels=1)
        model.reset_parameters(0)
        eng = InferenceEngine(
            "unet3d-test", model, divisor=model.divisor, z_divisor=model.z_divisor,
            cache=CompiledProgramCache(), device="cpu",
        )
        out = eng.predict(np.random.rand(1, 6, 20, 24, 1).astype(np.float32))
        assert out.shape == (1, 6, 20, 24, 1)

    def test_identity_output_never_aliases_the_staging_buffer(self):
        eng = engine("same", lambda m, x: x)
        a = np.random.rand(1, 64, 64, 1).astype(np.float32)
        out_a = eng.predict(a)
        eng.predict(np.zeros((1, 64, 64, 1), np.float32))  # reuses the buffer
        np.testing.assert_array_equal(out_a, a)

    def test_describe_and_warmup(self):
        eng = engine("desc", lambda m, x: x * 2.0)
        eng.warmup([(3, 64, 64, 1)])
        assert eng.program_key((4, 64, 64, 1), np.float32) in eng.cache.keys()
        d = eng.describe()
        assert d["device_ids"] == [0] and d["n_devices"] == 1 and d["mesh"] is None
        assert d["per_chip"] == {"cpu": {"platform": "cpu"}}
        assert d["params_resident"] and d["programs"]["live"] == 1
        assert d["programs"]["persistent_hits"] == 0

    def test_engines_never_share_a_program(self):
        """Two engines under one model_id on one shared cache: each runs
        its own module, and close() drops only its own programs."""
        cache = CompiledProgramCache()
        a = engine("same-id", lambda m, x: x * m.scale, scale=2.0, cache=cache)
        b = engine("same-id", lambda m, x: x * m.scale, scale=3.0, cache=cache)
        x = np.ones((1, 64, 64, 1), np.float32)
        np.testing.assert_allclose(a.predict(x), 2.0)
        np.testing.assert_allclose(b.predict(x), 3.0)
        assert len(cache) == 2 and b.describe()["programs"]["live"] == 1
        a.close()
        assert cache.keys() == [b.program_key((1, 64, 64, 1), np.float32)]


class TestPipelinedEngine:
    """The overlapped tiled pipeline against the serial baseline."""

    def _engine(self, fn=None, **cfg_overrides):
        cfg_kw = dict(max_tile=64, tile=48, tile_overlap=16, tile_batch=3, pipeline_depth=2)
        cfg_kw.update(cfg_overrides)
        return engine(
            "pipe", fn or (lambda m, x: x * m.scale + 0.25), scale=1.7,
            config=EngineConfig(**cfg_kw),
        )

    def test_planar_identical_to_serial(self):
        eng = self._engine()
        x = np.random.rand(3, 100, 90, 2).astype(np.float32)
        serial = eng.predict_serial(x)
        piped = eng.predict(x)
        np.testing.assert_array_equal(piped, serial)
        np.testing.assert_allclose(piped, x * 1.7 + 0.25, rtol=1e-4, atol=1e-5)

    def test_volumetric_identical_to_serial(self):
        eng = engine(
            "pipe3d", lambda m, x: x * 3.0,
            config=EngineConfig(
                max_tile=32, tile=24, tile_overlap=8,
                max_tile_z=8, tile_z=6, tile_overlap_z=2,
                ladder_z=(2, 4, 6, 8), tile_batch=2, pipeline_depth=3,
            ),
        )
        x = np.random.rand(2, 13, 40, 50, 1).astype(np.float32)
        serial = eng.predict_serial(x)
        piped = eng.predict(x)
        np.testing.assert_array_equal(piped, serial)
        assert piped.shape == x.shape

    def test_staging_reuse_after_direct_path_poisoning(self):
        eng = self._engine()
        x = np.random.rand(2, 100, 90, 2).astype(np.float32)
        serial = eng.predict_serial(x)
        eng.predict(np.random.rand(3, 60, 60, 2).astype(np.float32) + 5.0)
        np.testing.assert_array_equal(eng.predict(x), serial)

    def test_in_flight_window_bounded(self):
        for depth in (1, 2, 3):
            eng = self._engine(pipeline_depth=depth, tile_batch=1)
            x = np.random.rand(1, 120, 120, 1).astype(np.float32)
            out = eng.predict(x)
            stats = eng.pipeline_stats
            assert stats.chunks >= 4
            assert stats.max_in_flight <= depth, (depth, stats.as_dict())
            np.testing.assert_allclose(out, x * 1.7 + 0.25, rtol=1e-4, atol=1e-5)

    def test_depth_zero_disables_pipeline(self):
        eng = self._engine(pipeline_depth=0)
        x = np.random.rand(2, 100, 90, 1).astype(np.float32)
        np.testing.assert_array_equal(eng.predict(x), eng.predict_serial(x))
        assert eng.pipeline_stats.runs == 0

    def test_staging_buffers_are_recycled(self):
        eng = self._engine()
        x = np.random.rand(4, 150, 150, 1).astype(np.float32)
        for _ in range(3):
            eng.predict(x)
        assert eng.pipeline_stats.chunks >= 12
        cfg = eng.config
        per_shape_bound = cfg.pipeline_depth + cfg.pipeline_prefetch + 2
        assert eng._staging_pool.allocated <= 2 * per_shape_bound

    def test_stats_accounting(self):
        eng = self._engine()
        eng.predict(np.random.rand(2, 100, 100, 1).astype(np.float32))
        d = eng.pipeline_stats.as_dict()
        assert d["runs"] == 1 and d["items"] == 2 and d["chunks"] > 0
        for stage in ("cut", "put", "dispatch", "readback", "stitch"):
            assert d[f"{stage}_seconds"] >= 0.0
        assert d["wall_seconds"] > 0
        assert 0.0 <= d["overlap_efficiency"] <= 1.5  # clock-skew slack

    def test_error_in_model_propagates_and_pipeline_unwinds(self):
        def bad_fn(m, x):
            raise RuntimeError("forward boom")

        eng = self._engine(fn=bad_fn)
        with pytest.raises(RuntimeError, match="boom"):
            eng.predict(np.random.rand(1, 100, 100, 1).astype(np.float32))
        self._engine().predict(np.random.rand(1, 100, 100, 1).astype(np.float32))

    def test_global_output_raises_in_pipeline(self):
        eng = self._engine(fn=lambda m, x: x.mean(dim=(1, 2)))
        with pytest.raises(ValueError, match="dense spatial"):
            eng.predict(np.ones((1, 100, 100, 2), np.float32))

    def test_predict_async_front_door(self):
        eng = self._engine()

        async def run(x):
            return await asyncio.gather(*(eng.predict_async(x) for _ in range(3)))

        try:
            x = np.random.rand(2, 100, 90, 1).astype(np.float32)
            serial = eng.predict_serial(x)
            for out in asyncio.run(run(x)):
                np.testing.assert_array_equal(out, serial)
        finally:
            eng.close()
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit(lambda: None)


class TestGlobalOutputGuard:
    def test_padded_global_output_raises(self):
        eng = engine("emb", lambda m, x: x.mean(dim=(1, 2)))
        assert eng.predict(np.ones((1, 64, 64, 3), np.float32)).shape == (1, 3)
        with pytest.raises(ValueError, match="global output"):
            eng.predict(np.ones((1, 60, 60, 3), np.float32))


class TestTracingAndStreaming:
    def test_engine_predict_span_and_chip_seconds(self):
        eng = engine("traced", lambda m, x: x * 2.0)
        ctx = tracing.TraceContext(trace_id="t-engine", sampled=True, collector=[])
        acc, acc_token = tracing.start_chip_accounting()
        token = tracing.activate(ctx)
        try:
            eng.predict(np.ones((2, 64, 64, 1), np.float32))
        finally:
            tracing.deactivate(token)
            tracing.stop_chip_accounting(acc_token)
        (span,) = tracing.get_spans("engine.predict", trace_id="t-engine")
        attrs = span["attrs"]
        assert attrs["model"] == "traced" and attrs["batch"] == 2
        assert attrs["mesh"] == "1dev" and attrs["devices"] == 1
        assert set(attrs["stage_seconds"]) == {
            "cut", "put", "dispatch", "compute", "readback", "stitch",
        }
        assert attrs["chip_seconds"] >= 0.0 and acc.seconds > 0.0
        assert ctx.collector == [span]
        # unsampled: no span, chip-seconds still counted
        acc2, acc_token = tracing.start_chip_accounting()
        try:
            eng.predict(np.ones((1, 64, 64, 1), np.float32))
        finally:
            tracing.stop_chip_accounting(acc_token)
        assert acc2.seconds > 0.0
        assert len(tracing.get_spans("engine.predict", trace_id="t-engine")) == 1

    def test_param_streaming_gate(self):
        model = Fn(lambda m, x: x * m.scale, scale=0.0)  # the skeleton
        eng = InferenceEngine("gate", model, cache=CompiledProgramCache(), device="cpu")
        eng.begin_param_streaming()
        assert not eng.params_resident
        eng.warmup([(1, 64, 64, 1)])  # builds while the weights are away
        result = {}
        t = threading.Thread(
            target=lambda: result.setdefault("out", eng.predict(np.ones((1, 64, 64, 1), np.float32))),
            daemon=True,
        )
        t.start()
        t.join(timeout=0.2)
        assert t.is_alive()  # gated
        scale = model.scale
        eng.complete_param_streaming({"scale": torch.tensor(3.0)})
        t.join(timeout=10)
        assert not t.is_alive()
        assert model.scale is scale  # copied in place, never rebound
        np.testing.assert_allclose(result["out"], 3.0)
        eng.begin_param_streaming()
        eng.fail_param_streaming(OSError("disk gone"))
        with pytest.raises(RuntimeError, match="disk gone"):
            eng.predict(np.ones((1, 64, 64, 1), np.float32))

    def test_staging_pool_reuses_per_shape(self):
        pool = StagingPool()
        a = pool.acquire((2, 3), np.float32)
        pool.release(a)
        assert pool.acquire((2, 3), np.float32) is a
        assert pool.acquire((2, 3), np.float32) is not a
        assert pool.allocated == 2


class TestDevices:
    def test_resolve_devices_one_device(self):
        assert resolve_devices(None, "cpu") == [torch.device("cpu")]
        assert resolve_devices([0], "cpu") == [torch.device("cpu")]
        # JAX's rule on its 8 forced host devices: id 3 exists there, so a
        # lease of it is one device; a lease of two ids is a group of two
        assert resolve_devices([3], "cpu") == [torch.device("cpu")]
        assert resolve_devices([0, 1], "cpu") == [torch.device("cpu")] * 2

    def test_mesh_cache_tag(self):
        assert mesh_cache_tag(1) == "1dev"
        assert mesh_cache_tag(4) == "dp4"
        assert mesh_cache_tag(2, 2) == "dp2xtp2"


# ---- the port's engine against the JAX engine, same bridged weights ----------

PARITY = {
    # name: (registry name, kwargs, input shape, engine config)
    "unet2d_direct": ("unet2d", dict(features=(4, 8)), (2, 50, 40, 1), {}),
    "unet2d_tiled": (
        "unet2d", dict(features=(4, 8)), (1, 90, 70, 2),
        dict(max_tile=64, tile=48, tile_overlap=16, tile_batch=3),
    ),
    "unet3d_direct": ("unet3d", dict(features=(2, 4)), (1, 7, 60, 56, 1), {}),
    "unet3d_tiled": (
        "unet3d", dict(features=(2, 4), z_strides=(1,)), (1, 13, 40, 36, 1),
        dict(max_tile=32, tile=24, tile_overlap=8, max_tile_z=8, tile_z=6,
             tile_overlap_z=2, ladder_z=(2, 4, 6, 8), tile_batch=2),
    ),
}


@pytest.mark.parametrize("case", list(PARITY))
def test_engine_matches_jax_engine(case):
    name, kw, shape, cfg = PARITY[case]
    jax_model = jax_get_model(name, **kw, dtype=jnp.float32)
    # the params' shapes do not depend on the spatial size
    init_shape = (1, *([16] * (len(shape) - 2)), shape[-1])
    params = seeded_flax_params(jax_model, init_shape, seed=4)
    jax_params = jax.tree.map(jnp.asarray, params)
    jax_engine = JaxEngine(
        case, lambda p, a: jax_model.apply({"params": p}, a), jax_params,
        divisor=jax_model.divisor, z_divisor=getattr(jax_model, "z_divisor", 1),
        config=JaxEngineConfig(**cfg), cache=JaxCache(),
    )
    model = registry.get_model(name, **kw, in_channels=shape[-1], dtype=torch.float32)
    model.load_state_dict(convert.state_dict_from_flax(params))
    port_engine = InferenceEngine(
        case, model, divisor=model.divisor, z_divisor=getattr(model, "z_divisor", 1),
        config=EngineConfig(**cfg), cache=CompiledProgramCache(), device="cpu",
    )
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    ref = jax_engine.predict(x)
    out = port_engine.predict(x)
    assert out.shape == ref.shape == (*shape[:-1], 1)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    if cfg:  # tiled: the pipelined path equals the serial one bit for bit
        assert port_engine.pipeline_stats.runs == 1
        np.testing.assert_array_equal(port_engine.predict_serial(x), out)
