"""Seeded violations for BE-GRAPH-101 (Python control flow on captured
tensors).

``capture_cases`` and ``graphed_cases`` make the ``pos_*`` and ``neg_*``
functions captured regions; a ``block_pos_*`` function holds a capture
block of its own. On the card, chip_smoke.py's ``phase_analysis``
captures every ``pos_*`` (the capture must raise) and every ``neg_*``
(replays must equal eager bit for bit)."""

import torch


def pos_if_on_value(x):
    if x.sum() > 0:  # <- BE-GRAPH-101
        return x * 2
    return -x


def pos_while_on_derived(x):
    y = x.abs().max()
    while y > 1:  # <- BE-GRAPH-101
        y = y / 2
    return x * y


def block_pos_if_in_block(x, stream=None):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        y = x + 1
        if y.mean() > 0:  # <- BE-GRAPH-101
            y = y * 2
    return graph, y


# --- negatives -------------------------------------------------------------


def neg_shape_branch(x):
    if x.shape[0] > 2:  # static metadata, known at capture
        return x[:2] * 2
    return x


def neg_none_check(x, mask=None):
    if mask is None:  # identity check on a Python-level default
        return x + 1
    return x * mask


def neg_static_arg_branch(x, mode: str = "train"):
    if mode == "train":  # annotated str: static
        return x * 3
    return x


def neg_where(x):
    return torch.where(x.sum(dim=-1, keepdim=True) > 0, x, -x)


def host_branch_never_captured(x):
    if x.sum() > 0:  # eager host code, never captured
        return x
    return -x


def capture_cases(graph, x):
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        pos_if_on_value(x)
        neg_shape_branch(x)
        neg_none_check(x)
        neg_static_arg_branch(x)


def graphed_cases(x):
    return torch.cuda.make_graphed_callables(
        (pos_while_on_derived, neg_where), ((x,), (x,))
    )
