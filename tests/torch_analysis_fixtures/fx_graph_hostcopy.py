"""Seeded violations for BE-GRAPH-102 (host copies of captured tensors).

``capture_cases`` makes the ``pos_*`` and ``neg_*`` functions captured
regions; a ``block_pos_*`` function holds a capture block of its own.
chip_smoke.py's ``phase_analysis`` runs every case on the card."""

import numpy as np
import torch


def pos_numpy_call(x):
    return np.asarray(x.cpu())  # <- BE-GRAPH-102


def pos_cpu_copy(x):
    host = x.cpu()  # <- BE-GRAPH-102
    return host + 1


def pos_tolist(x):
    return x.sum(dim=0).tolist()  # <- BE-GRAPH-102


def pos_numpy_method(x):
    y = x * 2
    return y.numpy(force=True)  # <- BE-GRAPH-102


def block_pos_cpu_in_block(x, stream=None):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        y = x * 2
        peek = y.cpu()  # <- BE-GRAPH-102
    return graph, peek


# --- negatives -------------------------------------------------------------


def neg_numpy_on_shape(x):
    n = int(np.prod(x.shape))  # static metadata on the host
    return x.reshape(n) * 2


def neg_stays_on_card(x):
    return (x * 2).to(x.dtype)


def neg_host_constant(x):
    scale = np.float32(2.0)  # host numpy on a constant
    return x * float(scale)


def host_copy_never_captured(x):
    return np.asarray(x.cpu())  # eager host code, never captured


def capture_cases(graph, x):
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        pos_numpy_call(x)
        pos_cpu_copy(x)
        pos_tolist(x)
        pos_numpy_method(x)
        neg_numpy_on_shape(x)
        neg_stays_on_card(x)
        neg_host_constant(x)
