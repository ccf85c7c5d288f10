"""Seeded violations for BE-GRAPH-103 (coercions of captured tensors).

``capture_cases`` and ``graphed_cases`` make the ``pos_*`` and ``neg_*``
functions captured regions; a ``block_pos_*`` function holds a capture
block of its own. chip_smoke.py's ``phase_analysis`` runs every case on
the card."""

import torch
from torch.cuda import make_graphed_callables as graphed


def pos_item(x):
    peak = x.max().item()  # <- BE-GRAPH-103
    return x / peak


def pos_float(x):
    return x * float(x.mean())  # <- BE-GRAPH-103


def pos_int(x):
    return x + int(x.sum())  # <- BE-GRAPH-103


def pos_bool(x):
    flag = bool(x.any())  # <- BE-GRAPH-103
    return x if flag else -x


def block_pos_float_in_block(x, stream=None):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        total = x.sum()
        y = x / float(total)  # <- BE-GRAPH-103
    return graph, y


# --- negatives -------------------------------------------------------------


def neg_float_of_shape(x):
    return x / float(x.shape[-1])  # static metadata


def neg_int_of_static(x, k: int = 2):
    return x * int(k)  # annotated int: static


def neg_tensor_casts(x):
    return x.float() + x.int().float()  # stays a tensor


def neg_bool_mask(x):
    return x * (x > 0).to(x.dtype)


def host_item_never_captured(x):
    return x.max().item()  # eager host code, never captured


def capture_cases(graph, x):
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        pos_item(x)
        pos_float(x)
        neg_float_of_shape(x)
        neg_int_of_static(x)


def graphed_cases(x):
    return graphed((pos_int, pos_bool, neg_tensor_casts, neg_bool_mask), ((x,),) * 4)
