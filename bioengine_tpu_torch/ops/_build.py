"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/<name>.cu`` compiles on its own into
``build/torch_kernels/<name>-<hash>.so`` (a plain C interface, no PyTorch
headers, so a build takes seconds). The hash covers the sources and the
flags, so an edited source rebuilds and an unchanged one is loaded as it is.
Nothing builds at import time: the first call that needs a kernel builds it.
nvcc's log, with ptxas's registers, shared memory and spills for each kernel
(``-Xptxas -v``), is kept beside the library (``build_log``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


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


def library_path(name: str) -> Path:
    source = CSRC_DIR / f"{name}.cu"
    if not source.is_file():
        raise FileNotFoundError(f"no kernel source {source}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    return library_path(name).with_suffix(".log")


def build_log(name: str) -> str:
    """nvcc's output from the build of ``csrc/<name>.cu`` ("" if none)."""
    path = log_path(name)
    return path.read_text() if path.is_file() else ""


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for ``name`` unless its library is built; the output goes
    to a temporary name and is renamed into place once complete."""
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    log_path(name).write_text(log)
    os.replace(tmp, out)


def build_all() -> list[Path]:
    """Build every kernel that is not built yet, one nvcc per source, all
    started together. Returns the libraries' paths."""
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
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, *job)
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
    return lib
