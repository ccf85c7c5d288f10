"""Seeded violations for BE-GRAPH-105 (captured tensors used as shapes).

``capture_cases`` makes the ``pos_*`` and ``neg_*`` functions captured
regions; a ``block_pos_*`` function holds a capture block of its own.
chip_smoke.py's ``phase_analysis`` runs every case on the card."""

import torch


def pos_zeros_from_count(x):
    n = (x > 0).sum()
    return torch.zeros(n, device=x.device)  # <- BE-GRAPH-105


def pos_reshape_rows(x):
    cols = (x == x).sum(dim=1)[0]
    return x.reshape(-1, cols)  # <- BE-GRAPH-105


def pos_expand(x):
    reps = (x[:, :1] == x[:, :1]).sum()
    return x[:1].expand(reps, -1)  # <- BE-GRAPH-105


def pos_arange(x):
    return torch.arange(x.abs().argmax(), device=x.device)  # <- BE-GRAPH-105


def block_pos_view_in_block(x, stream=None):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        cols = (x[0] == x[0]).sum()
        y = x.view(-1, cols)  # <- BE-GRAPH-105
    return graph, y


# --- negatives -------------------------------------------------------------


def neg_reshape_static(x):
    return x.reshape(x.shape[0], -1) * 2  # static metadata


def neg_zeros_of_shape(x):
    return torch.zeros(x.shape, device=x.device, dtype=x.dtype) + x


def neg_view_flat(x):
    return x.view(-1) + 1


def neg_expand_starred(x):
    return x[:1].expand(2, *x.shape[1:]) * 1


def neg_static_size(x, n: int = 3):
    return torch.ones(n, device=x.device, dtype=x.dtype) * x.sum()


def host_shape_never_captured(x):
    return x.reshape(-1, (x == x).sum(dim=1)[0])  # eager host code


def capture_cases(graph, x):
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        pos_zeros_from_count(x)
        pos_reshape_rows(x)
        pos_expand(x)
        pos_arange(x)
        neg_reshape_static(x)
        neg_zeros_of_shape(x)
        neg_view_flat(x)
        neg_expand_starred(x)
        neg_static_size(x)
