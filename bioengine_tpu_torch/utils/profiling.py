"""torch.profiler wrappers shared by the worker's verbs.

Counterpart of ``bioengine_tpu/utils/profiling.py``, with the same three
functions and the same errors: ``start_trace`` / ``stop_trace`` run one
``torch.profiler.profile`` (CPU activity, and CUDA activity where CUDA is
present) and write a Chrome trace into the trace dir;
``device_memory_snapshot`` returns each CUDA device's ``memory_stats``
and the caching allocator's snapshot. The profiler is process-global:
one trace at a time per process.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

TRACE_FILE = "trace.json"

# the running profiler, keyed by its trace dir (one per process)
_ACTIVE: dict[str, object] = {}


def start_trace(
    workspace_dir, trace_dir: Optional[str], active: Optional[str]
) -> str:
    """Start a torch.profiler trace; returns the trace dir. ``active``
    is the caller's currently-active dir (None when idle) — a second
    start raises instead of silently nesting."""
    import torch

    if active:
        raise RuntimeError(f"profiling already active -> {active}")
    trace_dir = trace_dir or str(
        Path(workspace_dir) / "profiles" / time.strftime("%Y%m%d-%H%M%S")
    )
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _ACTIVE[trace_dir] = prof
    return trace_dir


def stop_trace(active: Optional[str]) -> str:
    """Stop the active trace and write ``trace.json`` (Chrome trace
    format) into its dir; returns the dir (raises when idle)."""
    if not active:
        raise RuntimeError("profiling is not active")
    prof = _ACTIVE.pop(active)
    prof.stop()
    prof.export_chrome_trace(str(Path(active) / TRACE_FILE))
    return active


def device_memory_snapshot() -> dict:
    """Device-memory snapshot: the caching allocator's snapshot (a
    pickle, base64; ``torch.cuda.memory._snapshot``, which
    ``torch.cuda._memory_viz`` reads) plus each local CUDA device's id,
    name and ``memory_stats``. Without CUDA both are empty."""
    import base64
    import pickle

    import torch

    if not torch.cuda.is_available():
        return {"allocator_snapshot_pickle_b64": "", "devices": []}
    snapshot = pickle.dumps(torch.cuda.memory._snapshot())
    return {
        "allocator_snapshot_pickle_b64": base64.b64encode(snapshot).decode(),
        "devices": [
            {
                "id": i,
                "kind": torch.cuda.get_device_name(i),
                "memory_stats": dict(torch.cuda.memory_stats(i)),
            }
            for i in range(torch.cuda.device_count())
        ],
    }
