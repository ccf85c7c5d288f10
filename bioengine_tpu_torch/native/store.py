"""ctypes binding for the C++ shared-memory object store.

The native library (native/object_store.cpp) owns all mutation under a
process-shared mutex; this binding maps the same POSIX-shm segment with
``mmap`` so ``get`` returns a **zero-copy memoryview** over the shared
bytes. Pins (refcounts) taken at get-time keep the object from being
LRU-evicted while a view is live — release views promptly or use the
``pinned`` context manager.

The library auto-builds from source with ``make`` on first use (the
worker image ships g++); a pure-Python in-process fallback with the
same API keeps environments without a toolchain working (no sharing
across processes there).
"""

from __future__ import annotations

import ctypes
import fcntl
import mmap
import os
import subprocess
import tempfile
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libbioengine_store.so"
_build_lock = threading.Lock()


class BesStats(ctypes.Structure):
    _fields_ = [
        ("capacity", ctypes.c_uint64),
        ("used_bytes", ctypes.c_uint64),
        ("n_objects", ctypes.c_uint64),
        ("hits", ctypes.c_uint64),
        ("misses", ctypes.c_uint64),
        ("evictions", ctypes.c_uint64),
        ("put_count", ctypes.c_uint64),
    ]


def _ensure_lib() -> Optional[ctypes.CDLL]:
    """Build (once) and load the native library; None if unavailable.

    ``BIOENGINE_STORE_LIB`` overrides the library path without
    triggering a build — how the CI sanitizer job (and the slow test in
    tests/test_native_store.py) points the same binding at the
    ASan/TSan-instrumented build from ``make -C native sanitizers``.

    Several processes may reach a fresh checkout's first build at once
    (test workers, a worker and its hosts), and ``make`` writes the
    library in place: a process that loads it mid-write fails. So the
    build runs under an exclusive lock, in a private directory, and the
    result is renamed into place whole; a library that does not load (one
    another writer has not finished) is built privately and loaded from
    there.
    """
    override = os.environ.get("BIOENGINE_STORE_LIB")
    with _build_lock:
        if override:
            # an explicit override must fail LOUDLY: silently falling
            # back to the pure-Python store would let a sanitizer CI
            # run go green while exercising zero native code
            lib = ctypes.CDLL(override)
            return _bind_abi(lib)
        if not (_NATIVE_DIR / "Makefile").exists():
            return None if not _LIB_PATH.exists() else _load(_LIB_PATH)
        try:
            _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
            with open(_LIB_PATH.parent / ".build.lock", "a") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if _LIB_PATH.exists():
                    lib = _load(_LIB_PATH)
                    if lib is not None:
                        return lib
                with tempfile.TemporaryDirectory(dir=_LIB_PATH.parent) as tmp:
                    subprocess.run(
                        ["make", f"BUILD_DIR={tmp}"], cwd=_NATIVE_DIR, check=True,
                        capture_output=True, timeout=120,
                    )
                    built = Path(tmp) / _LIB_PATH.name
                    lib = _load(built)  # loaded before the rename: the mapping stays
                    os.replace(built, _LIB_PATH)
                    return lib
        except Exception:
            return None


def _load(path: Path) -> Optional[ctypes.CDLL]:
    try:
        return _bind_abi(ctypes.CDLL(str(path)))
    except OSError:
        return None


def _bind_abi(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.bes_create.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
    ]
    lib.bes_create.restype = ctypes.c_int
    lib.bes_create_excl.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
    ]
    lib.bes_create_excl.restype = ctypes.c_int
    lib.bes_clear.argtypes = [ctypes.c_void_p]
    lib.bes_clear.restype = ctypes.c_int
    lib.bes_destroy.argtypes = [ctypes.c_char_p]
    lib.bes_destroy.restype = ctypes.c_int
    lib.bes_open.argtypes = [ctypes.c_char_p]
    lib.bes_open.restype = ctypes.c_void_p
    lib.bes_close.argtypes = [ctypes.c_void_p]
    lib.bes_close.restype = None
    lib.bes_put.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.bes_put.restype = ctypes.c_int
    lib.bes_get_pin.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.bes_get_pin.restype = ctypes.c_int
    lib.bes_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bes_release.restype = ctypes.c_int
    lib.bes_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bes_contains.restype = ctypes.c_int
    lib.bes_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bes_delete.restype = ctypes.c_int
    lib.bes_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(BesStats)]
    lib.bes_stats.restype = ctypes.c_int
    return lib


_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if not _lib_tried:
        _lib = _ensure_lib()
        _lib_tried = True
    return _lib


def native_available() -> bool:
    return get_lib() is not None


class StoreError(OSError):
    pass


def _check(rc: int, op: str) -> None:
    if rc < 0:
        raise StoreError(-rc, f"{op}: {os.strerror(-rc)}")


class SharedObjectStore:
    """One named shm segment shared by every process on the host.

    ``create``:
      - ``"attach"`` (default): join the existing segment, creating it
        exclusively if absent — the right mode for a host-shared cache
        (a late-starting replica must never wipe the segment; the
        create race resolves to one winner).
      - ``True``: force-(re)initialize, unlinking any existing segment.
      - ``False``: attach only; FileNotFoundError if absent.
    """

    def __init__(
        self,
        name: str = "bioengine-store",
        capacity: int = 256 * 1024 * 1024,
        n_slots: int = 16384,
        create: "bool | str" = "attach",
    ):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(
                "native object store unavailable (no toolchain?) — "
                "use LocalObjectStore"
            )
        self._lib = lib
        self.name = name
        self._bname = name.encode()
        if create is True:
            _check(lib.bes_create(self._bname, capacity, n_slots), "create")
        elif create == "attach":
            rc = lib.bes_create_excl(self._bname, capacity, n_slots)
            if rc not in (0, -17):  # -EEXIST = someone else has it: fine
                _check(rc, "create")
        self._handle = lib.bes_open(self._bname)
        if not self._handle:
            raise FileNotFoundError(f"shm store '{name}' not found")
        # map the segment read-only in Python for zero-copy views
        fd = os.open(f"/dev/shm/{name}", os.O_RDONLY)
        try:
            size = os.fstat(fd).st_size
            self._map = mmap.mmap(fd, size, prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        self._closed = False
        # (key, view) pairs whose release raised BufferError because an
        # export (np.frombuffer) was still alive; retried on later calls.
        self._deferred_releases: list = []

    # ---- core API -----------------------------------------------------------

    def put(self, key: str, data) -> None:
        """Copy ``data`` into the arena (LRU-evicting as needed) —
        exactly ONE copy, the memcpy inside ``bes_put``: bytes,
        memoryviews, and C-contiguous ndarrays all hand the native
        layer a raw pointer instead of round-tripping through
        ``bytes()`` first (the RPC shm fast path's one-copy promise
        rests on this). Raises FileExistsError if the key is present."""
        rc = self._put_rc(key, data)
        if rc == -17:  # EEXIST
            raise FileExistsError(key)
        _check(rc, f"put {key!r}")

    def try_put(self, key: str, data) -> bool:
        """``put`` that reports capacity/key pressure instead of
        raising: False when the key exists or the store cannot fit the
        object (full of pinned blocks, or larger than the arena) — the
        transport's cue to fall back to wire frames."""
        rc = self._put_rc(key, data)
        if rc in (-17, -28, -12):  # EEXIST / ENOSPC / ENOMEM
            return False
        _check(rc, f"put {key!r}")
        return True

    def _put_rc(self, key: str, data) -> int:
        import numpy as np

        # np.frombuffer is the one stdlib-adjacent way to borrow a raw
        # pointer from read-only bytes/memoryview without copying
        # (ctypes.from_buffer demands writable memory)
        flat = np.frombuffer(data, dtype=np.uint8)
        ptr = ctypes.c_void_p(flat.ctypes.data if flat.size else None)
        return self._lib.bes_put(
            self._handle, key.encode(), ptr, flat.size
        )

    def get(self, key: str) -> Optional[memoryview]:
        """Zero-copy view of the stored bytes, or None. The view holds a
        pin — call release(key) (or use ``pinned``) when done."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.bes_get_pin(
            self._handle, key.encode(), ctypes.byref(off), ctypes.byref(size)
        )
        if rc == -2:  # ENOENT
            return None
        _check(rc, f"get {key!r}")
        return memoryview(self._map)[off.value : off.value + size.value]

    def release(self, key: str) -> None:
        self._lib.bes_release(self._handle, key.encode())

    @contextmanager
    def pinned(self, key: str):
        """``with store.pinned(k) as view:`` — auto-release.

        If the caller kept an export of the view alive (np.frombuffer),
        ``view.release()`` raises BufferError; the store pin is then
        KEPT (the block must stay unevictable while any export points
        into the mapping) and retried on later calls / close()."""
        self._drain_deferred_releases()
        view = self.get(key)
        try:
            yield view
        finally:
            if view is not None:
                try:
                    view.release()
                except BufferError:
                    # exports alive: keep the pin so eviction can't
                    # recycle bytes under them; retry later
                    self._deferred_releases.append((key, view))
                else:
                    self.release(key)

    def _drain_deferred_releases(self) -> None:
        still_held = []
        for key, view in self._deferred_releases:
            try:
                view.release()
            except BufferError:
                still_held.append((key, view))
            else:
                self.release(key)
        self._deferred_releases = still_held

    def get_bytes(self, key: str) -> Optional[bytes]:
        """Copying read — no pin left behind."""
        with self.pinned(key) as view:
            return None if view is None else bytes(view)

    def contains(self, key: str) -> bool:
        return bool(self._lib.bes_contains(self._handle, key.encode()))

    def delete(self, key: str) -> bool:
        rc = self._lib.bes_delete(self._handle, key.encode())
        if rc == -2:
            return False
        _check(rc, f"delete {key!r}")
        return True

    def clear(self) -> int:
        """Remove every unpinned entry in place — all attached
        processes observe the cleared state. Returns entries removed."""
        rc = self._lib.bes_clear(self._handle)
        _check(rc, "clear")
        return rc

    def stats(self) -> dict:
        st = BesStats()
        _check(self._lib.bes_stats(self._handle, ctypes.byref(st)), "stats")
        return {f: getattr(st, f) for f, _ in BesStats._fields_}

    # ---- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._map.close()
            except BufferError:
                # numpy arrays / memoryviews over the mapping are still
                # alive; the map stays until they're collected. Unpinning
                # already happened, so this only delays address release.
                pass
            self._lib.bes_close(self._handle)
            self._handle = None

    def destroy(self) -> None:
        """Close and unlink the shm segment (unlinks even if live views
        keep the mapping itself alive)."""
        self.close()
        self._lib.bes_destroy(self._bname)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class LocalObjectStore:
    """Same API, plain-Python, single-process — the fallback when no
    native toolchain exists. LRU with byte budget, like ChunkCache."""

    def __init__(
        self,
        name: str = "local",
        capacity: int = 256 * 1024 * 1024,
        n_slots: int = 0,
        create: "bool | str" = "attach",
    ):
        self.name = name
        self.capacity = capacity
        self._data: dict[str, bytes] = {}
        self._order: list[str] = []
        self._used = 0
        self._lock = threading.Lock()
        self._stats = {"hits": 0, "misses": 0, "evictions": 0, "put_count": 0}
        self._deferred_releases: list = []

    def put(self, key: str, data) -> None:
        buf = bytes(data)
        if len(buf) > self.capacity:
            raise StoreError(28, "object larger than store capacity")
        with self._lock:
            if key in self._data:
                raise FileExistsError(key)
            while self._used + len(buf) > self.capacity and self._order:
                old = self._order.pop(0)
                self._used -= len(self._data.pop(old))
                self._stats["evictions"] += 1
            self._data[key] = buf
            self._order.append(key)
            self._used += len(buf)
            self._stats["put_count"] += 1

    def try_put(self, key: str, data) -> bool:
        try:
            self.put(key, data)
        except (FileExistsError, StoreError):
            return False
        return True

    def get(self, key: str) -> Optional[memoryview]:
        with self._lock:
            if key not in self._data:
                self._stats["misses"] += 1
                return None
            self._stats["hits"] += 1
            self._order.remove(key)
            self._order.append(key)
            return memoryview(self._data[key])

    def release(self, key: str) -> None:
        pass

    @contextmanager
    def pinned(self, key: str):
        yield self.get(key)

    def get_bytes(self, key: str) -> Optional[bytes]:
        view = self.get(key)
        return None if view is None else bytes(view)

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def delete(self, key: str) -> bool:
        with self._lock:
            if key not in self._data:
                return False
            self._used -= len(self._data.pop(key))
            self._order.remove(key)
            return True

    def clear(self) -> int:
        with self._lock:
            n = len(self._data)
            self._data.clear()
            self._order.clear()
            self._used = 0
            return n

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "used_bytes": self._used,
                "n_objects": len(self._data),
                **self._stats,
            }

    def close(self) -> None:
        pass

    def destroy(self) -> None:
        with self._lock:
            self._data.clear()
            self._order.clear()
            self._used = 0


def open_store(
    name: str = "bioengine-store",
    capacity: int = 256 * 1024 * 1024,
    n_slots: int = 16384,
    create: "bool | str" = "attach",
):
    """SharedObjectStore when the native lib is available, else the
    in-process fallback."""
    if native_available():
        return SharedObjectStore(name, capacity, n_slots, create=create)
    return LocalObjectStore(name, capacity, n_slots, create=create)
