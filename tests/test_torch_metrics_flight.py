"""The port's metrics and flight registries against the JAX package's.

Both packages load in one process and each keeps its own registry, so a
test compares only the families (and event types) it made itself. The
same counter, gauge, histogram and collector operations must give equal
``collect()`` entries and equal ``render_prometheus()`` lines; the same
``record``/``dump``/``get_events``/``merge_records`` calls must give the
same events (all but the recorder id, the sequence number and the
clock). Then the port's program cache, pipeline stats and streamed
weight loader record into the port's registries what the JAX modules
record into theirs.
"""

import time

import numpy as np
import pytest

from bioengine_tpu.runtime import pipeline as jax_pipeline
from bioengine_tpu.runtime import weight_stream as jax_weight_stream
from bioengine_tpu.runtime.program_cache import CompiledProgramCache as JaxCache
from bioengine_tpu.utils import flight as jax_flight
from bioengine_tpu.utils import logger as jax_logger
from bioengine_tpu.utils import metrics as jax_metrics
from _torch_parity import few_torch_threads  # noqa: F401
from bioengine_tpu_torch.runtime import pipeline, weight_stream
from bioengine_tpu_torch.runtime.program_cache import CompiledProgramCache
from bioengine_tpu_torch.utils import flight, logger, metrics

BOTH = [(jax_metrics, "jax"), (metrics, "torch")]


def _families(mod, names):
    snap = mod.collect()
    return {n: snap[n] for n in names}


def _prom_lines(mod, names):
    full = tuple(f"{mod.REGISTRY.namespace}_{n}" for n in names)
    return [
        line for line in mod.render_prometheus().splitlines()
        if line.lstrip("# HELPTYE").startswith(full)
    ]


def _drive(mod, tag):
    """The same operations on one registry; returns the family names."""
    c = mod.counter(f"parity_{tag}_requests_total", "requests", ("app", "method"))
    c.labels("a", "predict").inc()
    c.labels("a", "predict").inc(2.5)
    c.labels("b", 'quo"te\n').inc()
    g = mod.gauge(f"parity_{tag}_inflight", "in flight")
    g.set(7)
    g.labels().inc(3)
    g.labels().dec(1.5)
    h = mod.histogram(
        f"parity_{tag}_latency_seconds", "latency", ("app",),
        buckets=(0.01, 0.1, 1.0),
    )
    for v in (0.005, 0.05, 0.05, 0.5, 5.0):
        h.labels("a").observe(v)

    class Stats:
        def __init__(self, n):
            self.n = n

    live = [Stats(2), Stats(5)]
    inst = mod.InstanceSet(
        f"parity_{tag}_set",
        lambda objs: [
            mod.Sample(
                f"parity_{tag}_objects", sum(o.n for o in objs), kind="counter",
                help="objects",
            )
        ],
    )
    for obj in live:
        inst.add(obj)
    mod.register_collector(
        f"parity_{tag}_labelled",
        lambda: [
            mod.Sample(f"parity_{tag}_by_kind", 1.0, {"kind": "x"}, help="kinds"),
            mod.Sample(f"parity_{tag}_by_kind", 4.0, {"kind": "y"}, help="kinds"),
        ],
    )
    names = [f"parity_{tag}_{n}" for n in (
        "requests_total", "inflight", "latency_seconds", "objects", "by_kind",
    )]
    return names, live


def _rename(obj, tag):
    """A snapshot or lines with the registry's tag swapped for a common one."""
    if isinstance(obj, str):
        return obj.replace(f"parity_{tag}_", "parity_x_")
    if isinstance(obj, dict):
        return {_rename(k, tag): _rename(v, tag) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_rename(v, tag) for v in obj]
    return obj


def test_counter_gauge_histogram_collectors_collect_and_render_equal():
    got = {}
    for mod, tag in BOTH:
        names, live = _drive(mod, tag)
        got[tag] = (
            _rename(_families(mod, names), tag),
            _rename(_prom_lines(mod, names), tag),
        )
        del live
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1]
    fam = got["torch"][0]
    assert fam["parity_x_latency_seconds"]["series"][0]["p50"] == 0.1
    assert fam["parity_x_objects"]["series"][0]["value"] == 7
    assert any('method="quo\\"te\\n"' in line for line in got["torch"][1])


def test_registries_are_separate_and_reject_a_changed_schema():
    metrics.counter("parity_only_port_total", "port only")
    assert "parity_only_port_total" in metrics.collect()
    assert "parity_only_port_total" not in jax_metrics.collect()
    for mod, _ in BOTH:
        mod.counter("parity_schema_total", "x", ("a",))
        with pytest.raises(ValueError, match="re-registered"):
            mod.gauge("parity_schema_total", "x", ("a",))
        with pytest.raises(ValueError, match="counters only go up"):
            mod.counter("parity_schema_total", "x", ("a",)).labels("1").inc(-1)


def test_cardinality_guard_folds_new_label_sets_into_overflow(monkeypatch):
    monkeypatch.setenv("BIOENGINE_METRICS_MAX_LABELS", "3")
    got = {}
    for mod, tag in BOTH:
        mod.reset_env_cache()
        try:
            c = mod.counter(f"parity_{tag}_capped_total", "capped", ("user",))
            for i in range(6):
                c.labels(f"u{i}").inc()
            got[tag] = _rename(_families(mod, [f"parity_{tag}_capped_total"]), tag)
        finally:
            mod.reset_env_cache()
    assert got["torch"] == got["jax"]
    series = got["torch"]["parity_x_capped_total"]["series"]
    assert {"labels": {"user": metrics.OVERFLOW_LABEL}, "value": 3.0} in series


def test_process_metrics_install_the_same_families():
    for mod, _ in BOTH:
        mod.install_process_metrics()
    names = {"process_rss_bytes", "gc_pause_seconds_total", "gc_collections_total",
             "gc_collected_objects_total"}
    assert names <= set(metrics.collect())
    assert names <= set(jax_metrics.collect())
    assert {k: v["type"] for k, v in metrics.collect().items() if k in names} == {
        k: v["type"] for k, v in jax_metrics.collect().items() if k in names
    }


def _strip(events):
    """Events without their recorder id, sequence number and clock; a
    dump's event count is left out too, since the JAX ring also holds
    what earlier tests in this process recorded."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in ("recorder", "seq", "ts")}
        if e["type"] == "flight.dump":
            e["attrs"] = {k: v for k, v in e["attrs"].items() if k != "events"}
        out.append(e)
    return out


def test_flight_record_get_events_dump_and_merge_equal(monkeypatch, tmp_path):
    monkeypatch.setenv("BIOENGINE_FLIGHT_DUMP_INTERVAL_S", "30")
    since = time.time()
    got = {}
    for mod in (jax_flight, flight):
        mod.record("parity.a", seq_id="s1", n=1)
        mod.record("parity.b", severity="warning", reason="slow")
        mod.record("parity.a", seq_id="s2", n=2)
        events = mod.get_events(types=("parity.a", "parity.b"), since=since)
        last = mod.get_events(types=("parity.a",), since=since, limit=1)
        snap = mod.dump("parity-dump", why="test")
        again = mod.dump("parity-dump")  # rate-limited
        rec = mod.get_record(limit=None, since=since)
        other = {"clock_skew_s": 2.0, "events": [
            {"type": "parity.c", "ts": since + 5.0, "recorder": "r2", "seq": 1, "attrs": {}},
        ]}
        merged = mod.merge_records([rec, rec, other])
        got[mod] = {
            "events": _strip(events),
            "last": _strip(last),
            "dump_events": _strip(
                [e for e in snap["events"] if e["type"].startswith("parity.")]
            )[-3:],
            "again": again,
            "dumps": [d["reason"] for d in rec["dumps"]][-1:],
            "merged": _strip(
                [e for e in merged if e["type"].startswith(("parity.", "flight."))]
            )[-5:],
            "merged_skew": [
                (e["ts"] - since, e.get("ts_raw", 0) - since)
                for e in merged if e["type"] == "parity.c"
            ],
            "unique": len(merged) == len({(e["recorder"], e["seq"]) for e in merged}),
        }
    assert got[flight] == got[jax_flight]
    assert got[flight]["again"] is None
    assert got[flight]["merged_skew"] == [(3.0, 5.0)]
    assert got[flight]["unique"]
    assert flight.recorder_id() != jax_flight.recorder_id()


def test_flight_disabled_records_nothing(monkeypatch):
    for mod in (jax_flight, flight):
        monkeypatch.setenv("BIOENGINE_FLIGHT", "0")
        mod.reset_env_cache()
        try:
            assert mod.record("parity.off") is None
            assert mod.dump("parity-off") is None
        finally:
            monkeypatch.delenv("BIOENGINE_FLIGHT")
            mod.reset_env_cache()
    assert flight.enabled() and jax_flight.enabled()


def test_logger_same_handlers_and_tail(tmp_path):
    for mod in (jax_logger, logger):
        path = tmp_path / f"{mod.__name__.split('.')[0]}.log"
        lg = mod.create_logger(f"parity.{mod.__name__.split('.')[0]}", log_file=path)
        for i in range(5):
            lg.info("line %d", i)
        for h in lg.handlers:
            h.flush()
        tail = mod.read_log_tail(f"parity.{mod.__name__.split('.')[0]}", max_lines=2)
        assert tail.endswith("line 4") and "line 3" in tail and "line 2" not in tail
        assert [type(h).__name__ for h in lg.handlers] == ["StreamHandler", "FileHandler"]
        assert "T" in mod.timestamp()
        quiet = mod.create_logger(f"parity.quiet.{mod.__name__}", log_file="off")
        assert len(quiet.handlers) == 1


def test_program_cache_records_compile_evict_and_metrics(monkeypatch):
    """The JAX cache's flight events and ``program_cache_*`` samples, from
    the same sequence of builds and evictions. Each package tags a build
    as a persistent hit off its own persistent compile cache (XLA's, the
    port's kernel libraries), which an earlier test in the process may
    have turned on: both are held off here, so no build is a hit
    (``tests/test_torch_compile_cache.py`` holds the tagging itself)."""
    from bioengine_tpu.utils import compile_cache as jax_compile_cache
    from bioengine_tpu_torch.utils import compile_cache

    for mod in (jax_compile_cache, compile_cache):
        monkeypatch.setattr(mod, "_enabled_dir", None)
    since = time.time()
    got = {}
    for cache_cls, fmod, mmod in (
        (JaxCache, jax_flight, jax_metrics), (CompiledProgramCache, flight, metrics)
    ):
        before = {
            k: v["series"][0]["value"] for k, v in mmod.collect().items()
            if k.startswith("program_cache_")
        }
        cache = cache_cls(max_programs=2)
        for key in ("p1", "p2", "p1", "p3"):
            cache.get_or_compile(("parity", key), lambda: object())
        cache.evict(lambda k: k == ("parity", "p3"))
        events = fmod.get_events(types=("program.compile", "program.evict"), since=since)
        after = {
            k: v["series"][0]["value"] for k, v in mmod.collect().items()
            if k.startswith("program_cache_")
        }
        got[cache_cls] = (
            [(e["type"], e["attrs"]["key"]) for e in events],
            {k: after[k] - before.get(k, 0) for k in after
             if k not in ("program_cache_compile_seconds_total",
                          "program_cache_persistent_hits_total")},
            sorted(after),
        )
        hits = [e["attrs"]["cache_hit"] for e in events if e["type"] == "program.compile"]
        del cache
    assert got[CompiledProgramCache] == got[JaxCache]
    assert hits == [False, False, False]  # the port's, read last
    events, deltas, _ = got[CompiledProgramCache]
    assert [t for t, _ in events] == [
        "program.compile", "program.compile", "program.compile",
        "program.evict", "program.evict",
    ]
    assert deltas["program_cache_hits_total"] == 1
    assert deltas["program_cache_misses_total"] == 3


def test_pipeline_stats_fold_into_pipeline_metrics():
    got = {}
    for pmod, mmod in ((jax_pipeline, jax_metrics), (pipeline, metrics)):
        before = mmod.collect()
        stats = pmod.PipelineStats(depth=2)
        stats.add(runs=1, chunks=3, items=2, put_seconds=0.25, wall_seconds=1.5)
        after = mmod.collect()
        # the collector folds every live PipelineStats of the process and
        # rounds each total to 4 decimals, so the difference of two such
        # totals is a multiple of 1e-4 up to the float subtraction's error,
        # which other live engines in the process make nonzero
        got[pmod] = {
            k: (after[k]["type"],
                round(after[k]["series"][0]["value"] - before[k]["series"][0]["value"], 4))
            for k in after if k.startswith("pipeline_")
        }
        del stats
    assert got[pipeline] == got[jax_pipeline]
    assert got[pipeline]["pipeline_chunks"] == ("counter", 3)


def test_weight_stream_records_streamed_and_error_events(tmp_path):
    rng = np.random.default_rng(0)
    flat = {"a/kernel": rng.normal(size=(3, 4)).astype(np.float32),
            "b/bias": rng.normal(size=(4,)).astype(np.float32)}
    npz = tmp_path / "w.npz"
    np.savez(npz, **flat)
    since = time.time()
    got = {}
    for wmod, fmod in ((jax_weight_stream, jax_flight), (weight_stream, flight)):
        manifest_path = wmod.write_manifest(npz, flat)
        manifest = wmod.load_manifest(npz)
        done = wmod.StreamedWeightLoader(
            npz, manifest, on_complete=lambda p: None, model_id="parity-ok"
        ).start()
        assert done.done.wait(30)
        bad = dict(manifest, **{"c/missing": {"shape": [1], "dtype": "float32"}})
        failed = wmod.StreamedWeightLoader(
            npz, bad, on_complete=lambda p: None, model_id="parity-bad"
        ).start()
        assert failed.done.wait(30) and failed.error is not None
        manifest_path.unlink()
        events = fmod.get_events(
            types=("weights.streamed", "weights.stream_error"), since=since
        )
        got[wmod] = [
            (e["type"], e["severity"], e["attrs"]["model"],
             {k: v for k, v in e["attrs"].items() if k in ("groups", "bytes")})
            for e in events if e["attrs"]["model"].startswith("parity-")
        ]
    assert got[weight_stream] == got[jax_weight_stream]
    assert [t for t, *_ in got[weight_stream]] == ["weights.streamed", "weights.stream_error"]
