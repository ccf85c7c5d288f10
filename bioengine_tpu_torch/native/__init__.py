"""Native (C++) runtime components and their ctypes bindings.

The reference delegates its node-local runtime to Ray's C++ core
(GCS / raylet / plasma, SURVEY.md §2.1 #4); the pieces the TPU
framework needs natively live here, built from ``native/`` at the repo
root with plain ``make``.
"""

from bioengine_tpu_torch.native.store import (
    LocalObjectStore,
    SharedObjectStore,
    StoreError,
    native_available,
    open_store,
)

__all__ = [
    "LocalObjectStore",
    "SharedObjectStore",
    "StoreError",
    "native_available",
    "open_store",
]
