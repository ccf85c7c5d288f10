"""The port's persistent compile cache of its kernel libraries and the
shared compile-cache tier, against the JAX package's own cases
(``test_cold_start.py`` ``TestCompileCache``, ``TestCacheHitTagging``,
``TestCompileTierSync``).

The file-level cases run the JAX module and the port's on the same
inputs and compare what each returns; the tier cases run the JAX tests'
scenarios on the port's control plane with ``WorkerHost(device="cpu")``
over fake ``*-cache`` entries, with the JAX tests' assertions. Then
``ops/_build.py`` on a machine without nvcc: an entry already in the
cache directory is loaded without nvcc (a copy of a system library stands
in for a kernel library), entry names carry no local path, a damaged
entry raises naming itself, and ``off`` builds into a private directory.
"""

import asyncio
import ctypes.util
import logging
import re
import shutil
import time
from pathlib import Path

import pytest

from bioengine_tpu.utils import compile_cache as jax_compile_cache
from bioengine_tpu_torch.ops import _build
from bioengine_tpu_torch.runtime.program_cache import CompiledProgramCache
from bioengine_tpu_torch.utils import compile_cache, flight

from _torch_parity import few_torch_threads, private_rpc_store  # noqa: F401
from test_cold_start import CHAOS_SOURCE, WARM_CHAOS_MANIFEST

pytestmark = [pytest.mark.integration, pytest.mark.anyio]

KERNEL = "flash_attn_fwd"


@pytest.fixture
def fresh_cache(monkeypatch):
    """Both packages' cached verdicts dropped, and restored after."""
    for mod in (compile_cache, jax_compile_cache):
        monkeypatch.setattr(mod, "_enabled_dir", None)
        monkeypatch.setattr(mod, "_failed", False)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_private", None)
    yield


# ---------------------------------------------------------------------------
# compile_cache: failure-verdict caching + tier entry file protocol
# ---------------------------------------------------------------------------


class TestCompileCache:
    def test_failure_verdict_cached_and_logged_once(self, tmp_path, monkeypatch, caplog, fresh_cache):
        blocker = tmp_path / "a-file"
        blocker.write_text("not a directory")
        monkeypatch.setenv("BIOENGINE_COMPILE_CACHE", str(blocker / "sub" / "dir"))
        with caplog.at_level(logging.WARNING, logger="bioengine_tpu_torch.utils.compile_cache"):
            for _ in range(3):
                assert compile_cache.enable_persistent_compilation_cache() is None
        warnings = [r for r in caplog.records if "unavailable" in r.getMessage()]
        assert len(warnings) == 1
        assert compile_cache._failed is True
        # an explicit path is a different target and gets its own attempt
        assert compile_cache.enable_persistent_compilation_cache(str(tmp_path / "ok")) == str(tmp_path / "ok")

    def test_off_switch(self, monkeypatch, fresh_cache):
        monkeypatch.setenv("BIOENGINE_COMPILE_CACHE", "off")
        for mod in (jax_compile_cache, compile_cache):
            assert mod.enable_persistent_compilation_cache() is None
            assert mod._failed is False  # off is not a failure
            assert mod.enabled_dir() is None

    def test_enable_is_idempotent_and_defaults(self, tmp_path, monkeypatch, fresh_cache):
        monkeypatch.delenv("BIOENGINE_COMPILE_CACHE", raising=False)
        assert compile_cache._DEFAULT == str(_build.BUILD_DIR)
        assert Path(compile_cache._DEFAULT).parts[-2:] == ("build", "torch_kernels")
        monkeypatch.setenv("BIOENGINE_COMPILE_CACHE", str(tmp_path / "env"))
        first = compile_cache.enable_persistent_compilation_cache()
        assert first == str(tmp_path / "env") and (tmp_path / "env").is_dir()
        assert compile_cache.enable_persistent_compilation_cache(str(tmp_path / "other")) == first
        assert compile_cache.enabled_dir() == first
        compile_cache.reset_for_tests()
        assert compile_cache.enabled_dir() is None

    @pytest.mark.parametrize("name", ["jit_fn-abc123-cache", "flash_attn_fwd-0123456789abcdef-cache"])
    def test_entry_io_roundtrip_and_safety(self, tmp_path, name):
        seen = {}
        for label, mod in (("jax", jax_compile_cache), ("torch", compile_cache)):
            d = tmp_path / label
            d.mkdir()
            got = [mod.write_entry(name, b"program-bytes", d), mod.write_entry(name, b"other", d),
                   mod.read_entry(name, d), mod.list_entries(d)]
            stem = name.removesuffix("-cache")
            (d / f"{stem}-atime").write_bytes(b"x")
            (d / f"{stem}.log").write_text("ptxas info")
            (d / f".{name}.123.tmp").write_bytes(b"half")
            (d / "random.txt").write_bytes(b"x")
            got.append(list(mod.list_entries(d)))
            for bad in ("../evil-cache", "a/b-cache", ".hidden-cache", "x", name.removesuffix("-cache") + ".log"):
                got.append((mod.write_entry(bad, b"x", d), mod.read_entry(bad, d)))
            seen[label] = got
        assert seen["torch"] == seen["jax"]
        assert seen["torch"][:5] == [True, False, b"program-bytes", {name: 13}, [name]]


# ---------------------------------------------------------------------------
# program cache: persistent-hit tagging
# ---------------------------------------------------------------------------


class TestCacheHitTagging:
    def test_fast_build_with_persistent_cache_tags_hit(self, tmp_path, monkeypatch):
        monkeypatch.setattr(compile_cache, "_enabled_dir", str(tmp_path))
        monkeypatch.setenv("BIOENGINE_COMPILE_HIT_THRESHOLD_S", "10")
        flight.clear()
        cache = CompiledProgramCache()
        cache.get_or_compile(("m", 1), lambda: (lambda *a: None))
        assert cache.stats.persistent_hits == 1
        assert cache.compile_info_snapshot()[str(("m", 1))]["cache_hit"] is True
        events = [e for e in flight.get_record()["events"] if e["type"] == "program.compile"]
        assert events and events[-1]["attrs"]["cache_hit"] is True

    def test_no_persistent_cache_means_no_hit_tag(self, monkeypatch):
        monkeypatch.setattr(compile_cache, "_enabled_dir", None)
        monkeypatch.setenv("BIOENGINE_COMPILE_HIT_THRESHOLD_S", "10")
        cache = CompiledProgramCache()
        cache.get_or_compile(("m", 1), lambda: (lambda *a: None))
        assert cache.stats.persistent_hits == 0
        assert cache.compile_info_snapshot()[str(("m", 1))]["cache_hit"] is False

    def test_slow_build_is_a_real_compile(self, tmp_path, monkeypatch):
        monkeypatch.setattr(compile_cache, "_enabled_dir", str(tmp_path))
        monkeypatch.setenv("BIOENGINE_COMPILE_HIT_THRESHOLD_S", "0.01")

        def build():
            time.sleep(0.05)
            return lambda *a: None

        cache = CompiledProgramCache()
        cache.get_or_compile(("m", 2), build)
        assert cache.stats.persistent_hits == 0

    def test_a_build_that_writes_an_entry_is_a_real_compile(self, tmp_path, monkeypatch):
        """The port's build that had to run nvcc leaves a new library in
        the cache directory: a miss however fast; a later build that finds
        the library there writes nothing and is a hit."""
        monkeypatch.setattr(compile_cache, "_enabled_dir", str(tmp_path))
        monkeypatch.setenv("BIOENGINE_COMPILE_HIT_THRESHOLD_S", "10")
        cache = CompiledProgramCache()

        def nvcc_build():
            compile_cache.write_entry(f"{KERNEL}-0123456789abcdef-cache", b"lib", tmp_path)
            return object()

        cache.get_or_compile(("m", "cold"), nvcc_build)
        cache.get_or_compile(("m", "warm"), nvcc_build)  # the entry is there: nothing new written
        info = cache.compile_info_snapshot()
        assert [info[str(("m", k))]["cache_hit"] for k in ("cold", "warm")] == [False, True]
        assert (cache.stats.misses, cache.stats.persistent_hits) == (2, 1)

    def test_the_embedders_build_is_a_tagged_program(self, tmp_path, monkeypatch):
        from bioengine_tpu_torch.apps.cell_image_search.embedder import ViTEmbedder

        monkeypatch.setattr(compile_cache, "_enabled_dir", str(tmp_path))
        monkeypatch.setenv("BIOENGINE_COMPILE_HIT_THRESHOLD_S", "10")
        emb = ViTEmbedder(device="cpu", model_overrides={"dim": 32, "depth": 1, "num_heads": 2})
        emb.load()
        emb.load()
        assert (emb.programs.stats.misses, emb.programs.stats.hits) == (1, 0)
        ((key, info),) = emb.programs.compile_info_snapshot().items()
        assert "vit-embedder" in key and info["cache_hit"] is True
        assert emb.programs.stats.persistent_hits == 1


# ---------------------------------------------------------------------------
# ops/_build.py: the kernel libraries in the cache, on a machine without nvcc
# ---------------------------------------------------------------------------


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    """nvcc out of reach: a PATH without it and CUDA_HOME at an empty
    directory; every call of ``_nvcc`` is recorded."""
    empty = tmp_path / "no-cuda"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setenv("CUDA_HOME", str(empty))
    calls = []
    real = _build._nvcc

    def spy():
        calls.append(1)
        return real()

    monkeypatch.setattr(_build, "_nvcc", spy)
    return calls


def _stub_library() -> bytes:
    """The bytes of a shared library that loads anywhere (libm)."""
    path = ctypes.util.find_library("m")
    if path and not Path(path).is_absolute():
        path = ctypes.CDLL(path)._name
        if not Path(path).is_absolute():
            found = [p for d in ("/lib", "/usr/lib", "/lib64", "/usr/lib64")
                     for p in Path(d).rglob(Path(path).name)]
            path = str(found[0]) if found else None
    if not path or not Path(path).is_file():
        pytest.skip("no shared library to stand in for a kernel library")
    return Path(path).read_bytes()


class TestBuildFromCache:
    def test_entry_in_the_cache_loads_without_nvcc(self, tmp_path, monkeypatch, fresh_cache, no_nvcc):
        monkeypatch.setenv("BIOENGINE_COMPILE_CACHE", str(tmp_path / "cache"))
        name = _build.entry_name(KERNEL)
        assert compile_cache.write_entry(name, _stub_library(), compile_cache.enable_persistent_compilation_cache())
        lib = _build.load(KERNEL)
        assert Path(lib._name) == tmp_path / "cache" / name == _build.library_path(KERNEL)
        assert _build.load(KERNEL) is lib and no_nvcc == []
        assert compile_cache.list_entries() == {name: (tmp_path / "cache" / name).stat().st_size}

    def test_missing_entry_starts_nvcc(self, tmp_path, monkeypatch, fresh_cache, no_nvcc):
        monkeypatch.setenv("BIOENGINE_COMPILE_CACHE", str(tmp_path / "cache"))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load(KERNEL)
        assert no_nvcc == [1]
        assert compile_cache.list_entries() == {}

    def test_damaged_entry_raises_naming_it(self, tmp_path, monkeypatch, fresh_cache, no_nvcc):
        monkeypatch.setenv("BIOENGINE_COMPILE_CACHE", str(tmp_path / "cache"))
        name = _build.entry_name(KERNEL)
        compile_cache.write_entry(name, b"not a library", compile_cache.enable_persistent_compilation_cache())
        with pytest.raises(RuntimeError, match=re.escape(name)):
            _build.load(KERNEL)
        assert no_nvcc == []  # not rebuilt behind the caller's back

    def test_entry_names_carry_no_local_path(self, tmp_path, monkeypatch, fresh_cache):
        name = _build.entry_name(KERNEL)
        assert re.fullmatch(rf"{KERNEL}-[0-9a-f]{{16}}-cache", name)
        assert compile_cache._safe_entry_name(name)
        # the same sources elsewhere, another cache directory: the same name
        moved = tmp_path / "elsewhere" / "csrc"
        shutil.copytree(_build.CSRC_DIR, moved)
        monkeypatch.setattr(_build, "CSRC_DIR", moved)
        monkeypatch.setenv("BIOENGINE_COMPILE_CACHE", str(tmp_path / "cache"))
        assert _build.entry_name(KERNEL) == name
        assert _build.library_path(KERNEL) == tmp_path / "cache" / name
        # an edited source is another entry
        (moved / f"{KERNEL}.cu").write_text((moved / f"{KERNEL}.cu").read_text() + "\n// edited\n")
        assert _build.entry_name(KERNEL) != name
        # nvcc's log sits beside the entry under a name the tier never lists
        log = _build.log_path(KERNEL)
        assert log.parent == tmp_path / "cache" and log.suffix == ".log"
        assert not compile_cache._safe_entry_name(log.name)

    def test_off_builds_into_a_private_directory(self, monkeypatch, fresh_cache):
        monkeypatch.setenv("BIOENGINE_COMPILE_CACHE", "off")
        d = _build.build_dir()
        assert d.is_dir() and d != _build.BUILD_DIR and d.name.startswith("bioengine-kernels-")
        assert _build.build_dir() == d == _build.library_path(KERNEL).parent
        assert compile_cache.enabled_dir() is None and compile_cache.list_entries() == {}

    def test_build_seconds_from_the_log(self):
        log = "ptxas info    : Used 168 registers\n" + _build.SECONDS_PREFIX + "6.125\n"
        assert _build.build_seconds(log) == 6.125
        assert _build.build_seconds("no such line") is None


# ---------------------------------------------------------------------------
# the shared compile-cache tier over the in-process multi-host control plane
# ---------------------------------------------------------------------------


@pytest.fixture()
async def control_plane(tmp_path):
    from bioengine_tpu_torch.cluster.state import ClusterState
    from bioengine_tpu_torch.cluster.topology import TpuTopology
    from bioengine_tpu_torch.rpc.server import RpcServer
    from bioengine_tpu_torch.serving import ServeController
    from bioengine_tpu_torch.serving.compile_tier import CompileCacheTier
    from bioengine_tpu_torch.worker_host import WorkerHost

    with private_rpc_store():
        server = RpcServer(host="127.0.0.1", admin_users=["admin"])
        await server.start()
        token = server.issue_token("admin", is_admin=True)
        controller = ServeController(
            ClusterState(TpuTopology(chips=(), n_hosts=1, platform="cpu")), health_check_period=3600
        )
        controller.compile_tier = CompileCacheTier(tmp_path / "tier")
        controller.attach_rpc(server, admin_users=["admin"])
        hosts = []

        async def spawn_host(host_id: str, **kwargs) -> WorkerHost:
            host = WorkerHost(server_url=server.url, token=token, host_id=host_id,
                              workspace_dir=tmp_path / f"ws-{host_id}", device="cpu", n_devices=8, **kwargs)
            await host.start()
            hosts.append(host)
            return host

        try:
            yield server, controller, spawn_host, tmp_path
        finally:
            for host in hosts:
                try:
                    await host.stop()
                except Exception:
                    pass
            await controller.stop()
            await server.stop()


class TestCompileTierSync:
    async def test_join_publishes_and_later_host_fetches(self, control_plane):
        server, controller, spawn_host, tmp_path = control_plane
        flight.clear()
        k1, k2 = f"{KERNEL}-k1-cache", f"{KERNEL}-k2-cache"
        dir_a = tmp_path / "kernels-a"
        dir_a.mkdir()
        (dir_a / k1).write_bytes(b"P1" * 600)
        (dir_a / k2).write_bytes(b"P2" * 600)
        (dir_a / f"{KERNEL}-k1.log").write_text("nvcc log")  # local-only
        (dir_a / f".{k1}.77.tmp").write_bytes(b"half")  # a build in flight
        dir_b = tmp_path / "kernels-b"
        dir_b.mkdir()

        h1 = await spawn_host("h1", compile_cache_dir=dir_a)
        assert h1.tier_published_count == 2
        assert set(controller.compile_tier.list()) == {k1, k2}

        h2 = await spawn_host("h2", compile_cache_dir=dir_b)
        assert h2.tier_fetched == 2
        assert compile_cache.list_entries(dir_b) == {k1: 1200, k2: 1200}
        assert (dir_b / k1).read_bytes() == b"P1" * 600
        assert sorted(p.name for p in dir_b.iterdir()) == [k1, k2]
        fetches = [e for e in flight.get_record()["events"] if e["type"] == "program.cache_fetch"]
        assert len(fetches) == 2
        assert all(e["attrs"]["host"] == "h2" for e in fetches)
        stats = controller.compile_tier.stats()
        assert stats["served"] == 2 and stats["stored"] == 2
        assert stats["hit_rate"] == 1.0
        assert h2.describe()["compile_tier"] == {"cache_dir": str(dir_b), "fetched": 2, "published": 0}
        assert h1.describe()["compile_tier"] == {"cache_dir": str(dir_a), "fetched": 0, "published": 2}

    async def test_fetched_library_loads_without_nvcc(self, control_plane, monkeypatch, fresh_cache, no_nvcc):
        """h1 publishes the kernel's entry under the name ``_build`` gives
        it; h2, whose cache directory is the enabled one and empty, fetches
        it at join, and ``_build.load`` then loads it without nvcc."""
        server, controller, spawn_host, tmp_path = control_plane
        name = _build.entry_name(KERNEL)
        dir_a = tmp_path / "kernels-a"
        dir_a.mkdir()
        (dir_a / name).write_bytes(_stub_library())
        await spawn_host("h1", compile_cache_dir=dir_a)
        assert name in controller.compile_tier.list()
        monkeypatch.setenv("BIOENGINE_COMPILE_CACHE", str(tmp_path / "kernels-b"))
        assert compile_cache.enable_persistent_compilation_cache() == str(tmp_path / "kernels-b")
        h2 = await spawn_host("h2")
        assert h2.describe()["compile_tier"]["cache_dir"] == str(tmp_path / "kernels-b")
        assert h2.tier_fetched == 1
        lib = _build.load(KERNEL)
        assert Path(lib._name) == tmp_path / "kernels-b" / name and no_nvcc == []
        assert (tmp_path / "kernels-b" / name).read_bytes() == (dir_a / name).read_bytes()

    async def test_replica_start_resyncs_and_publishes(self, control_plane):
        from bioengine_tpu_torch.apps.builder import AppBuilder
        from bioengine_tpu_torch.serving import RequestOptions

        server, controller, spawn_host, tmp_path = control_plane
        dir_a = tmp_path / "kernels-h1"
        dir_a.mkdir()
        h1 = await spawn_host("h1", compile_cache_dir=dir_a)
        controller.compile_tier.publish(f"{KERNEL}-late-cache", b"LATE" * 300)

        app_dir = tmp_path / "app-src"
        app_dir.mkdir()
        (app_dir / "manifest.yaml").write_text(WARM_CHAOS_MANIFEST.replace(
            "num_replicas: 2", "num_replicas: 1"
        ).replace("min_replicas: 2", "min_replicas: 1").replace(
            "    warm_pool:\n      size: 1\n      refill: false\n", ""
        ))
        (app_dir / "chaos_dep.py").write_text(CHAOS_SOURCE.replace("bioengine_tpu.", "bioengine_tpu_torch."))
        built = AppBuilder(workdir_root=tmp_path / "apps").build(app_id="warm-chaos-app", local_path=app_dir)
        await controller.deploy("warm-chaos-app", built.specs)
        assert f"{KERNEL}-late-cache" in compile_cache.list_entries(dir_a)
        (dir_a / f"{KERNEL}-fresh-cache").write_bytes(b"F" * 100)
        await h1._publish_compile_cache()
        assert f"{KERNEL}-fresh-cache" in controller.compile_tier.list()
        handle = controller.get_handle("warm-chaos-app")
        r = await handle.call("add", 1, 2, options=RequestOptions(idempotent=True))
        assert r["sum"] == 3

    async def test_publish_loop_offers_new_builds(self, control_plane, monkeypatch):
        """An entry built after the join (a replica's first nvcc run) reaches
        the tier through the periodic publish loop."""
        monkeypatch.setenv("BIOENGINE_COMPILE_TIER_PUBLISH_S", "0.05")
        server, controller, spawn_host, tmp_path = control_plane
        dir_a = tmp_path / "kernels-h1"
        dir_a.mkdir()
        h1 = await spawn_host("h1", compile_cache_dir=dir_a)
        assert controller.compile_tier.list() == {}
        assert compile_cache.write_entry(f"{KERNEL}-built-cache", b"B" * 64, dir_a)
        deadline = time.monotonic() + 10
        while f"{KERNEL}-built-cache" not in controller.compile_tier.list():
            assert time.monotonic() < deadline, "the publish loop never offered the new entry"
            await asyncio.sleep(0.05)
        assert h1.tier_published_count == 1
