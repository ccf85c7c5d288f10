"""Persistent compile cache of the CUDA kernel libraries + the shared
compile-cache tier.

Own copy of ``bioengine_tpu/utils/compile_cache.py``. What the port
compiles ahead of a request is not an XLA program but a kernel library:
nvcc builds each ``csrc/<name>.cu`` into a shared library
(``ops/_build.py``), which is loaded with ctypes. The port's CUDA graphs
live one process and cannot be persisted, so the library is the artefact
this cache keeps: with it enabled, a repeat build -- a replica restart, a
second run on the same machine -- becomes a disk read instead of an nvcc
run.

The cache directory is per-machine (``$BIOENGINE_COMPILE_CACHE``, else
the ``build/torch_kernels`` directory of the checkout, which ``.gitignore``
lists). A FRESH host has an empty directory and pays the full build
anyway -- so this module also speaks the **shared tier** protocol: entry
files (named by ``ops/_build.py`` as ``<kernel>-<hash16>-cache``, the
hash over the sources and nvcc's flags only, never a local path, so
every host computes the same name for the same library) are enumerated,
read, and written atomically so a worker host can fetch the fleet's
already-built libraries from the controller's tier at join time and
publish its own builds back (worker_host.py drives the RPC side;
serving/compile_tier.py holds the controller-side store). Only
``*-cache`` payload files ride the tier -- nvcc's ``*.log`` beside each
entry and the ``.tmp`` files of a build in flight are local-only.

With ``BIOENGINE_COMPILE_CACHE=off`` nothing is enabled: a process then
builds its libraries into a private temporary directory removed at exit
(``ops/_build.py``), and lists and publishes nothing.

One call, safe anywhere: failures (read-only FS) degrade to a warning,
never an error -- and the VERDICT is cached either way, so a host with a
read-only filesystem logs once instead of retrying the mkdir on every
call.
"""

from __future__ import annotations

import logging
import os
import tempfile
from pathlib import Path
from typing import Optional

from bioengine_tpu_torch.utils import metrics

logger = logging.getLogger(__name__)

_DEFAULT = str(Path(__file__).resolve().parents[2] / "build" / "torch_kernels")
_enabled_dir: str | None = None
# failure verdict cache: once an attempt fails, every later call
# returns None immediately instead of re-trying the mkdir/config (a
# read-only FS would otherwise pay — and log — the attempt per call)
_failed = False

# the suffix jax gives entry payload files; its sibling "-atime" files
# are local LRU bookkeeping and never ride the tier
CACHE_SUFFIX = "-cache"

TIER_FETCHES = metrics.counter(
    "compile_tier_fetches_total",
    "compile-cache entries fetched from the shared tier",
)
TIER_PUBLISHES = metrics.counter(
    "compile_tier_publishes_total",
    "compile-cache entries published to the shared tier",
)
TIER_FETCH_BYTES = metrics.counter(
    "compile_tier_fetch_bytes_total",
    "bytes of compiled programs fetched from the shared tier",
)
TIER_PUBLISH_BYTES = metrics.counter(
    "compile_tier_publish_bytes_total",
    "bytes of compiled programs published to the shared tier",
)


def enable_persistent_compilation_cache(path: str | None = None) -> str | None:
    """Point the persistent cache of the CUDA kernel libraries (the
    directory ``ops/_build.py`` builds into and loads from) at ``path``
    (default ``$BIOENGINE_COMPILE_CACHE`` or the checkout's
    ``build/torch_kernels``). Idempotent; returns the cache dir, or None
    when disabled/failed. Both verdicts are cached: a failed first
    attempt (read-only FS) is logged ONCE and never retried.

    Set ``BIOENGINE_COMPILE_CACHE=off`` to opt out entirely.
    """
    global _enabled_dir, _failed
    env = os.environ.get("BIOENGINE_COMPILE_CACHE")
    if env and env.lower() in ("off", "0", "false", "none"):
        return None
    if _enabled_dir is not None:
        return _enabled_dir
    if _failed and path is None:
        # the cached verdict covers the default/env directory; an
        # EXPLICIT path is a different target and deserves its own
        # attempt (e.g. a bench worker pointing at a writable tmpdir
        # after the default failed read-only)
        return None
    target = Path(path or env or _DEFAULT).expanduser()
    try:
        target.mkdir(parents=True, exist_ok=True)
        _enabled_dir = str(target)
        logger.info("persistent kernel-library cache at %s", target)
        return _enabled_dir
    except Exception as exc:  # noqa: BLE001 — never fail the caller
        _failed = True
        logger.warning(
            "compilation cache unavailable (will not retry): %s", exc
        )
        return None


def enabled_dir() -> Optional[str]:
    """The active cache dir, or None when disabled/failed/not enabled."""
    return _enabled_dir


def reset_for_tests() -> None:
    """Drop the cached verdict so a test can exercise both paths."""
    global _enabled_dir, _failed
    _enabled_dir = None
    _failed = False


# ---- tier entry I/O (file-level; the RPC side lives in worker_host /
# serving/compile_tier.py) -------------------------------------------------


def list_entries(directory: str | Path | None = None) -> dict[str, int]:
    """``{entry_name: size_bytes}`` of the cache payload files under
    ``directory`` (default: the enabled cache dir). Entry names are
    exactly jax's on-disk keys, so two hosts agree on identity without
    any re-hashing."""
    d = Path(directory) if directory else (
        Path(_enabled_dir) if _enabled_dir else None
    )
    if d is None or not d.is_dir():
        return {}
    out: dict[str, int] = {}
    try:
        for p in d.iterdir():
            if p.name.endswith(CACHE_SUFFIX) and p.is_file():
                out[p.name] = p.stat().st_size
    except OSError:
        return {}
    return out


def read_entry(name: str, directory: str | Path | None = None) -> Optional[bytes]:
    """Read one cache entry's bytes, or None when absent/unreadable.
    ``name`` must be a bare entry filename (path components rejected —
    these names cross the RPC plane)."""
    d = Path(directory) if directory else (
        Path(_enabled_dir) if _enabled_dir else None
    )
    if d is None or not _safe_entry_name(name):
        return None
    p = d / name
    try:
        return p.read_bytes()
    except OSError:
        return None


def write_entry(
    name: str, blob: bytes, directory: str | Path | None = None
) -> bool:
    """Atomically install one fetched cache entry (temp file + rename,
    so jax never reads a half-written program). Returns False when the
    entry already exists, the name is unsafe, or the FS refuses."""
    d = Path(directory) if directory else (
        Path(_enabled_dir) if _enabled_dir else None
    )
    if d is None or not _safe_entry_name(name):
        return False
    target = d / name
    if target.exists():
        return False
    try:
        d.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(d), prefix=".tier-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, target)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return True
    except OSError as exc:
        logger.debug("tier entry %s not installed: %s", name, exc)
        return False


def _safe_entry_name(name: str) -> bool:
    """Entry names cross the RPC plane: refuse anything that is not a
    bare jax cache filename (no separators, no dotfiles, right suffix)."""
    return (
        bool(name)
        and "/" not in name
        and "\\" not in name
        and not name.startswith(".")
        and name.endswith(CACHE_SUFFIX)
        and len(name) < 512
    )
