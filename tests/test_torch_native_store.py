"""The port's native-store binding builds its library once when several
processes reach a fresh checkout's first build together (test workers, a
worker and its hosts): every process loads the store, none caches a
failure from a library another one is still writing."""

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
STORE_PY = REPO / "bioengine_tpu_torch" / "native" / "store.py"
PROCESSES = 6

# loads the port's store.py on its own (no package import), points it at a
# copy of native/, waits for the start file and builds or loads the library
LOADER = """
import importlib.util, os, sys, time
from pathlib import Path
spec = importlib.util.spec_from_file_location("port_store", sys.argv[1])
store = importlib.util.module_from_spec(spec)
spec.loader.exec_module(store)
store._NATIVE_DIR = Path(sys.argv[2])
store._LIB_PATH = store._NATIVE_DIR / "build" / "libbioengine_store.so"
go = Path(sys.argv[3])
while not go.exists():
    time.sleep(0.001)
print("loaded" if store._ensure_lib() is not None else "unavailable")
"""


@pytest.mark.skipif(shutil.which("make") is None or shutil.which("g++") is None,
                    reason="the native shared-memory store does not build here (no make or g++)")
@pytest.mark.parametrize("trial", range(3))
def test_concurrent_first_builds_all_load(tmp_path, trial):
    native = tmp_path / "native"
    native.mkdir()
    for name in ("Makefile", "object_store.cpp"):
        shutil.copy(REPO / "native" / name, native / name)
    go = tmp_path / "go"
    env = {k: v for k, v in os.environ.items() if k != "BIOENGINE_STORE_LIB"}
    procs = [
        subprocess.Popen([sys.executable, "-c", LOADER, str(STORE_PY), str(native), str(go)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for _ in range(PROCESSES)
    ]
    time.sleep(0.5)  # every process waiting on the start file
    go.touch()
    outs = [p.communicate(timeout=180) for p in procs]
    assert [p.returncode for p in procs] == [0] * PROCESSES, [err for _, err in outs]
    assert [out.strip() for out, _ in outs] == ["loaded"] * PROCESSES
    # the library in place, no private build directory left beside it
    assert (native / "build" / "libbioengine_store.so").is_file()
    assert [p.name for p in (native / "build").iterdir() if p.is_dir()] == []
