"""Seeded violations for BE-GRAPH-104 (closed-over or global state
mutated under capture: it runs once, at capture, and never on replay).

``capture_cases`` makes the ``pos_*`` and ``neg_*`` functions captured
regions; a ``block_pos_*`` function holds a capture block of its own.
chip_smoke.py's ``phase_analysis`` runs every case on the card, reading
``effects()`` around the capture and the replays."""

import torch

CAPTURE_LOG = []
_STATE = {}
_calls = 0


def pos_append(x):
    CAPTURE_LOG.append("captured")  # <- BE-GRAPH-104
    return x * 2


def pos_dict_write(x):
    _STATE["writes"] = _STATE.get("writes", 0) + 1  # <- BE-GRAPH-104
    return x + 1


def pos_global(x):
    global _calls  # <- BE-GRAPH-104
    _calls += 1
    return x - 1


def block_pos_append_in_block(x, stream=None):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        y = x * 3
        CAPTURE_LOG.append("block")  # <- BE-GRAPH-104
    return graph, y


# --- negatives -------------------------------------------------------------


def neg_local_containers(x):
    parts = []
    parts.append(x * 2)  # a local list: self-contained
    acc = {}
    acc["y"] = x + 1
    return torch.cat(parts + [acc["y"]])


def host_log_never_captured(x):
    CAPTURE_LOG.append("eager")  # eager host code, never captured
    return x


def effects() -> int:
    """Every side effect the positives above have made since ``reset``."""
    return len(CAPTURE_LOG) + _STATE.get("writes", 0) + _calls


def reset() -> None:
    global _calls
    CAPTURE_LOG.clear()
    _STATE.clear()
    _calls = 0


def capture_cases(graph, x):
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        pos_append(x)
        pos_dict_write(x)
        pos_global(x)
        neg_local_containers(x)
