"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/<name>.cu`` compiles on its own into a library named
``<name>-<hash16>-cache`` (a plain C interface, no PyTorch headers, so a
build takes seconds) in the persistent compile cache's directory
(``utils/compile_cache.py``: ``$BIOENGINE_COMPILE_CACHE``, else the
checkout's ``build/torch_kernels``). The hash covers the sources and
nvcc's flags, which name the target (``sm_90a``), and nothing of the host:
no path, no toolkit location. So an edited source rebuilds, an unchanged
one is loaded as it is, and two hosts compute the same entry name for the
same library: an entry fetched from the controller's compile-cache tier
(``worker_host.py``) is a local cache hit, loaded without nvcc.
With ``BIOENGINE_COMPILE_CACHE=off`` a process builds into a private
temporary directory, removed at exit.

Nothing builds at import time: the first call that needs a kernel loads
its entry, and starts nvcc only when the entry is missing. nvcc's log, with
ptxas's registers, shared memory and spills for each kernel (``-Xptxas
-v``) and the build's wall seconds, is kept beside the entry as
``<name>-<hash16>.log`` (``build_log``), a name the tier never lists.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

from bioengine_tpu_torch.utils import compile_cache

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
# the default directory of the persistent compile cache
BUILD_DIR = Path(compile_cache._DEFAULT)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the last line of an entry's log
SECONDS_PREFIX = "nvcc wall seconds: "

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_private: Optional[Path] = None


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): the CUDA "
        "kernels of bioengine_tpu_torch are built from source on first use"
    )


def build_dir() -> Path:
    """The directory the libraries are built into and loaded from: the
    persistent compile cache's, enabled here on first use; with the cache
    off (or its directory unavailable) a private temporary directory,
    removed at exit."""
    global _private
    enabled = compile_cache.enable_persistent_compilation_cache()
    if enabled is not None:
        return Path(enabled)
    if _private is None:
        _private = Path(tempfile.mkdtemp(prefix="bioengine-kernels-"))
        atexit.register(shutil.rmtree, _private, True)
    return _private


def entry_name(name: str) -> str:
    """``<name>-<hash16>-cache``: the hash covers the sources and the
    flags, never a path, so every host computes the same name."""
    source = CSRC_DIR / f"{name}.cu"
    if not source.is_file():
        raise FileNotFoundError(f"no kernel source {source}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return f"{name}-{digest.hexdigest()[:16]}{compile_cache.CACHE_SUFFIX}"


def library_path(name: str) -> Path:
    return build_dir() / entry_name(name)


def log_path(name: str, directory: str | Path | None = None) -> Path:
    """nvcc's log beside the entry, in ``directory`` (default: this
    process's build directory)."""
    base = Path(directory) if directory is not None else build_dir()
    return base / (entry_name(name).removesuffix(compile_cache.CACHE_SUFFIX) + ".log")


def build_log(name: str, directory: str | Path | None = None) -> str:
    """nvcc's output from the build of ``csrc/<name>.cu`` ("" if none)."""
    path = log_path(name, directory)
    return path.read_text() if path.is_file() else ""


def build_seconds(log: str) -> Optional[float]:
    """The wall seconds nvcc took, from an entry's log (None if absent)."""
    for line in reversed(log.splitlines()):
        if line.startswith(SECONDS_PREFIX):
            return float(line[len(SECONDS_PREFIX):])
    return None


def _start(name: str) -> tuple[subprocess.Popen, Path, Path, float] | None:
    """Start nvcc for ``name`` unless its entry is in the cache; the
    output goes to a temporary name and is renamed into place once
    complete, so two processes building one entry leave one whole file."""
    out = library_path(name)
    if out.is_file():
        return None
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path, t0: float) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    seconds = time.perf_counter() - t0
    log_path(name).write_text(f"{log}{SECONDS_PREFIX}{seconds:.3f}\n")
    os.replace(tmp, out)


def build_all() -> list[Path]:
    """Build every kernel whose entry is not in the cache yet, one nvcc
    per source, all started together. Returns the entries' paths."""
    with _lock:
        started = {name: _start(name) for name in kernel_names()}
        errors = []
        for name, job in started.items():
            if job is None:
                continue
            try:
                _finish(name, *job)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))
    return [library_path(name) for name in kernel_names()]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``: its cache entry, built
    first only if the entry is missing. An entry that does not load (a
    damaged fetch, a ``noexec`` mount) raises, naming it; it is not
    rebuilt behind the caller's back."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, *job)
            path = library_path(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise RuntimeError(
                    f"kernel library {path.name} in {path.parent} does not load: {exc}"
                ) from exc
            _loaded[name] = lib
    return lib
