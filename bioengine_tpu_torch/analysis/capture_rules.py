"""CUDA-graph capture-safety pass (BE-GRAPH-*): silent hazards inside
captured code.

The port compiles its hot programs by capturing them into CUDA graphs
(``runtime/engine.py`` and ``runtime/decode_engine.py`` capture the engine
and decode programs with ``torch.cuda.graph``), and a captured region is
to the port what a jitted function is to JAX.  Inside one, reading a
tensor's value on the host (a Python ``if``, ``.item()``, ``.cpu()``, a
tensor used as a shape) synchronizes the stream, which raises "operation
not permitted when stream is capturing" — or, where it slips through,
bakes one value into every replay — and mutation of closed-over state
runs once, at capture, and never again when the graph is replayed.

Captured regions are found two ways:

1. block style — the body of ``with torch.cuda.graph(...)``, plus the
   same-module functions called from it (by name, or as ``self.f`` /
   ``cls.f``);
2. call style — a same-module function passed to
   ``torch.cuda.make_graphed_callables`` (alone or in a tuple).

``from torch.cuda import graph`` and ``make_graphed_callables`` imports,
aliased or not, are followed.

Captured values are a region's parameters other than ``self``/``cls``
and the static ones, plus every name its function binds from an
expression that reads a captured value.  Torch has no
``static_argnums``: a parameter is static when it is annotated ``int``,
``float``, ``bool`` or ``str``, ``torch.Size``, ``torch.dtype`` or
``torch.device``, or a tuple, ``Optional`` or ``| None`` of these.  In a
block, the names bound inside the block from a call (the captured
work's outputs) and the names the enclosing function binds from a torch
tensor factory (``torch.zeros(...)``, the static inputs) are captured
too.  As under jit, static reads never count: ``.shape``, ``.ndim``,
``.dtype``, ``.device``, ``.size()``, ``.dim()``, ``.numel()``,
``len()``, ``isinstance()`` and identity comparisons.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterator, Optional, Union

from bioengine_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    dotted_name,
    register_pass,
    register_rule,
)

CAPTURED_BRANCH = register_rule(
    Rule(
        "BE-GRAPH-101",
        "captured-python-branch",
        "Python if/while on a captured tensor's value inside a CUDA-graph "
        "capture",
        "graph",
    )
)
HOST_COPY_OF_CAPTURED = register_rule(
    Rule(
        "BE-GRAPH-102",
        "host-copy-of-captured",
        "Host numpy call or .numpy()/.cpu()/.tolist() on a captured tensor "
        "inside a CUDA-graph capture",
        "graph",
    )
)
CAPTURED_COERCION = register_rule(
    Rule(
        "BE-GRAPH-103",
        "captured-coercion",
        ".item()/float()/int()/bool() on a captured tensor inside a "
        "CUDA-graph capture",
        "graph",
    )
)
CLOSURE_MUTATION = register_rule(
    Rule(
        "BE-GRAPH-104",
        "closure-mutation-under-capture",
        "Mutation of closed-over/global state inside a CUDA-graph capture",
        "graph",
    )
)
CAPTURED_SHAPE = register_rule(
    Rule(
        "BE-GRAPH-105",
        "captured-shape-arg",
        "Captured tensor used as a shape argument inside a CUDA-graph "
        "capture",
        "graph",
    )
)

_GRAPH_NAMES = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
_GRAPHED_NAMES = {
    "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.make_graphed_callables",
}

# Dotted callables whose positional arguments are sizes: None means every
# positional argument (``torch.zeros(2, 3)``), an int the one at that index.
_SHAPE_ARG_FNS: dict[str, Optional[int]] = {
    "torch.zeros": None,
    "torch.ones": None,
    "torch.empty": None,
    "torch.full": 0,
    "torch.eye": None,
    "torch.arange": None,
    "torch.linspace": 2,  # steps
    "torch.reshape": 1,
    "torch.broadcast_to": 1,
}
_SHAPE_KWARGS = {"size", "shape", "steps", "start", "end", "step"}
# Tensor methods whose arguments are sizes.
_SHAPE_METHODS = {"reshape", "view", "expand", "new_zeros", "new_ones", "new_empty"}
# Torch calls that make a fresh tensor: names bound from them in a block's
# enclosing function are the capture's static inputs.
_TENSOR_FACTORIES = {
    "torch.zeros", "torch.ones", "torch.empty", "torch.full", "torch.eye",
    "torch.arange", "torch.linspace", "torch.rand", "torch.randn",
    "torch.randint", "torch.tensor", "torch.as_tensor", "torch.from_numpy",
    "torch.zeros_like", "torch.ones_like", "torch.empty_like",
    "torch.full_like", "torch.rand_like", "torch.randn_like", "torch.stack",
    "torch.cat",
}
_HOST_COPY_METHODS = {"numpy", "cpu", "tolist"}

_MUTATOR_METHODS = {
    "append",
    "extend",
    "insert",
    "add",
    "update",
    "setdefault",
    "remove",
    "discard",
    "clear",
    "popitem",
}

# Builtins that are static/identity-level even on captured tensors.
_STATIC_BUILTINS = {
    "len",
    "isinstance",
    "type",
    "getattr",
    "hasattr",
    "callable",
    "id",
}
# Tensor metadata: attributes, or methods whose result is metadata.
_STATIC_ATTRS = {
    "shape", "ndim", "dtype", "device", "is_cuda", "layout", "requires_grad",
    "size", "dim", "numel", "nelement", "stride", "element_size",
    "is_contiguous",
}
_STATIC_ANNOTATIONS = {
    "int", "float", "bool", "str", "torch.Size", "torch.dtype", "torch.device",
}
_WRAPPER_ANNOTATIONS = {"tuple", "Tuple", "typing.Tuple", "Optional", "typing.Optional"}

_FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef]


@dataclass
class CapturedRegion:
    """One captured region: a function (``how`` "call" or "graphed") or
    the body of a ``with torch.cuda.graph`` block (``how`` "block")."""

    node: ast.AST  # the function, or the ``with`` statement
    body: list[ast.stmt]
    where: str  # how messages name the region
    how: str
    captured: set[str] = field(default_factory=set)
    locals_: set[str] = field(default_factory=set)

    @property
    def line(self) -> int:
        return self.node.lineno


# ---------------------------------------------------------------------------
# Discovery
# ---------------------------------------------------------------------------


def _is_static_annotation(ann: Optional[ast.expr]) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    if isinstance(ann, ast.Constant) and ann.value is None:
        return True
    if dotted_name(ann) in _STATIC_ANNOTATIONS:
        return True
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _is_static_annotation(ann.left) and _is_static_annotation(
            ann.right
        )
    if (
        isinstance(ann, ast.Subscript)
        and dotted_name(ann.value) in _WRAPPER_ANNOTATIONS
    ):
        elts = (
            ann.slice.elts if isinstance(ann.slice, ast.Tuple) else [ann.slice]
        )
        return all(
            (isinstance(e, ast.Constant) and e.value is Ellipsis)
            or _is_static_annotation(e)
            for e in elts
        )
    return False


def _captured_params(fn: _FunctionNode) -> set[str]:
    args = fn.args
    return {
        a.arg
        for a in args.posonlyargs + args.args + args.kwonlyargs
        if a.arg not in {"self", "cls"} and not _is_static_annotation(a.annotation)
    }


def _aliases(tree: ast.Module) -> tuple[set[str], set[str]]:
    """The names ``torch.cuda.graph`` and ``make_graphed_callables`` go
    by in this module."""
    graph, graphed = set(_GRAPH_NAMES), set(_GRAPHED_NAMES)
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom) or node.module not in {
            "torch.cuda",
            "torch.cuda.graphs",
        }:
            continue
        for alias in node.names:
            if alias.name == "graph":
                graph.add(alias.asname or alias.name)
            elif alias.name == "make_graphed_callables":
                graphed.add(alias.asname or alias.name)
    return graph, graphed


def _walk_scope(nodes: list[ast.stmt]) -> Iterator[ast.AST]:
    """Every node under ``nodes`` outside nested function and class
    bodies (their code is not run where it is defined)."""
    stack: list[ast.AST] = list(reversed(nodes))
    while stack:
        node = stack.pop()
        yield node
        for child in reversed(list(ast.iter_child_nodes(node))):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda),
            ):
                continue
            stack.append(child)


def _enclosing_functions(tree: ast.Module) -> dict[int, Optional[_FunctionNode]]:
    """id(node) -> the innermost function that holds it (None: module)."""
    out: dict[int, Optional[_FunctionNode]] = {}

    def visit(node: ast.AST, fn: Optional[_FunctionNode]) -> None:
        for child in ast.iter_child_nodes(node):
            out[id(child)] = fn
            inner = (
                child
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                else fn
            )
            visit(child, inner)

    visit(tree, None)
    return out


def discover_captured(tree: ast.Module) -> list[CapturedRegion]:
    """Every captured region of a module, blocks first, then the
    functions they call and the functions passed to
    ``make_graphed_callables``; each function once."""
    graph_names, graphed_names = _aliases(tree)
    fns = {
        n.name: n
        for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    owner = _enclosing_functions(tree)
    out: list[CapturedRegion] = []
    seen: set[str] = set()

    def add_function(fn: _FunctionNode, how: str) -> None:
        if fn.name in seen:
            return
        seen.add(fn.name)
        region = CapturedRegion(fn, fn.body, f"captured `{fn.name}`", how)
        region.captured = _propagate(fn.body, _captured_params(fn))
        region.locals_ = _collect_locals(fn)
        out.append(region)

    callees: list[_FunctionNode] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        if not any(
            isinstance(item.context_expr, ast.Call)
            and dotted_name(item.context_expr.func) in graph_names
            for item in node.items
        ):
            continue
        enclosing = owner.get(id(node))
        scope = enclosing.body if enclosing is not None else tree.body
        seed = _captured_params(enclosing) if enclosing is not None else set()
        seed |= _factory_bound(scope) | _call_bound(node.body)
        name = enclosing.name if enclosing is not None else "<module>"
        region = CapturedRegion(
            node, node.body, f"the `torch.cuda.graph` block in `{name}`", "block"
        )
        region.captured = _propagate(scope, seed)
        region.locals_ = (
            _collect_locals(enclosing) if enclosing is not None else set()
        )
        out.append(region)
        for sub in _walk_scope(node.body):
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            if isinstance(func, ast.Name) and func.id in fns:
                callees.append(fns[func.id])
            elif (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id in {"self", "cls"}
                and func.attr in fns
            ):
                callees.append(fns[func.attr])
    for fn in callees:
        add_function(fn, "call")

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        if dotted_name(node.func) not in graphed_names:
            continue
        target = node.args[0]
        targets = target.elts if isinstance(target, (ast.Tuple, ast.List)) else [target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id in fns:
                add_function(fns[t.id], "graphed")
    return out


def _assignments(nodes: list[ast.stmt]) -> Iterator[tuple[list[ast.expr], ast.expr]]:
    """(targets, value) of each binding under ``nodes`` in their scope."""
    for node in _walk_scope(nodes):
        if isinstance(node, ast.Assign):
            yield node.targets, node.value
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and node.value is not None:
            yield [node.target], node.value
        elif isinstance(node, ast.NamedExpr):
            yield [node.target], node.value
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            yield [node.target], node.iter
        elif isinstance(node, ast.comprehension):
            yield [node.target], node.iter


def _factory_bound(scope: list[ast.stmt]) -> set[str]:
    names: set[str] = set()
    for targets, value in _assignments(scope):
        if isinstance(value, ast.Call) and dotted_name(value.func) in _TENSOR_FACTORIES:
            for t in targets:
                _bind_target(t, names)
    return names


def _call_bound(body: list[ast.stmt]) -> set[str]:
    names: set[str] = set()
    for node in _walk_scope(body):
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and isinstance(
            node.value, ast.Call
        ):
            if dotted_name(node.value.func) in _STATIC_BUILTINS | {"range"}:
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                _bind_target(t, names)
    return names


def _propagate(scope: list[ast.stmt], seed: set[str]) -> set[str]:
    """``seed`` plus every name bound in ``scope`` from an expression that
    reads a captured value, to a fixed point."""
    captured = set(seed)
    bindings = list(_assignments(scope))
    changed = True
    while changed:
        changed = False
        for targets, value in bindings:
            if not _naked_captured_refs(value, captured):
                continue
            bound: set[str] = set()
            for t in targets:
                _bind_target(t, bound)
            if not bound <= captured:
                captured |= bound
                changed = True
    return captured


def _collect_locals(fn: _FunctionNode) -> set[str]:
    """Names assigned anywhere in the function (params included)."""
    args = fn.args
    names = {
        a.arg
        for a in args.posonlyargs
        + args.args
        + args.kwonlyargs
        + ([args.vararg] if args.vararg else [])
        + ([args.kwarg] if args.kwarg else [])
    }
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node is not fn:
                names.add(node.name)
            continue
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            targets = [node.target]
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            targets = [
                item.optional_vars
                for item in node.items
                if item.optional_vars is not None
            ]
        elif isinstance(node, ast.comprehension):
            targets = [node.target]
        for t in targets:
            _bind_target(t, names)
    return names


def _bind_target(t: ast.expr, names: set[str]) -> None:
    """Add names a target *binds*.  ``x[k] = v`` / ``x.a = v`` mutate an
    existing object — they bind nothing, so they must not make ``x``
    local (that would hide closure mutations from BE-GRAPH-104)."""
    if isinstance(t, ast.Name):
        names.add(t.id)
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            _bind_target(e, names)
    elif isinstance(t, ast.Starred):
        _bind_target(t.value, names)


# ---------------------------------------------------------------------------
# Captured-value reference analysis
# ---------------------------------------------------------------------------


def _naked_captured_refs(expr: ast.AST, captured: set[str]) -> set[str]:
    """Captured names referenced *as values* (not via static metadata).

    ``x.shape[0] > 4`` is static; ``x.sum() > 4`` reads the tensor.
    Identity comparisons (``x is None``) and static builtins (``len(x)``,
    ``isinstance(x, ...)``) are excluded.
    """
    refs: set[str] = set()

    def visit(node: ast.AST) -> None:
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return
            visit(node.value)
            return
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            if fname in _STATIC_BUILTINS:
                return
            visit(node.func)
            for a in node.args:
                visit(a)
            for kw in node.keywords:
                visit(kw.value)
            return
        if isinstance(node, ast.Compare):
            ops_static = all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
            )
            if ops_static:
                return
        if isinstance(node, ast.Name):
            if node.id in captured:
                refs.add(node.id)
            return
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(expr)
    return refs


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------


def run_capture_pass(ctx: ModuleContext) -> Iterator[Finding]:
    if "graph" not in ctx.source:
        return
    seen: set[tuple] = set()
    for region in discover_captured(ctx.tree):
        for f in _check_region(ctx, region):
            key = (f.rule, f.line, f.col, f.message)
            if key not in seen:
                seen.add(key)
                yield f


def _check_region(ctx: ModuleContext, region: CapturedRegion) -> Iterator[Finding]:
    captured, where = region.captured, region.where
    for node in (n for stmt in region.body for n in ast.walk(stmt)):
        # --- Python control flow on captured values -------------------
        if isinstance(node, (ast.If, ast.While)):
            refs = _naked_captured_refs(node.test, captured)
            if refs:
                kind = "if" if isinstance(node, ast.If) else "while"
                yield ctx.finding(
                    CAPTURED_BRANCH.id,
                    node,
                    f"Python `{kind}` on captured tensor(s) {sorted(refs)} "
                    f"in {where} — reading the value syncs the stream, "
                    f"which raises under capture (or bakes one branch into "
                    f"every replay); use `torch.where` (or make the "
                    f"argument static)",
                )

        if isinstance(node, ast.Call):
            fname = dotted_name(node.func) or ""

            # --- host copies of captured values -----------------------
            if fname.startswith(("np.", "numpy.")):
                hit: set[str] = set()
                for a in list(node.args) + [kw.value for kw in node.keywords]:
                    hit |= _naked_captured_refs(a, captured)
                if hit:
                    yield ctx.finding(
                        HOST_COPY_OF_CAPTURED.id,
                        node,
                        f"host `{fname}()` applied to captured tensor(s) "
                        f"{sorted(hit)} in {where} — a device-to-host copy "
                        f"syncs the stream and raises under capture; use "
                        f"the `torch.` equivalent",
                    )
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOST_COPY_METHODS
            ):
                hit = _naked_captured_refs(node.func.value, captured)
                if hit:
                    yield ctx.finding(
                        HOST_COPY_OF_CAPTURED.id,
                        node,
                        f"`.{node.func.attr}()` on captured tensor(s) "
                        f"{sorted(hit)} in {where} — a device-to-host copy "
                        f"syncs the stream and raises under capture",
                    )

            # --- concretizing coercions -------------------------------
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in {"float", "int", "bool"}
                and node.args
            ):
                hit = _naked_captured_refs(node.args[0], captured)
                if hit:
                    yield ctx.finding(
                        CAPTURED_COERCION.id,
                        node,
                        f"`{node.func.id}()` concretizes captured tensor(s) "
                        f"{sorted(hit)} in {where} — syncs the stream and "
                        f"raises under capture; keep it a tensor (`.to`) or "
                        f"return it instead",
                    )
            if isinstance(node.func, ast.Attribute) and node.func.attr == "item":
                hit = _naked_captured_refs(node.func.value, captured)
                if hit:
                    yield ctx.finding(
                        CAPTURED_COERCION.id,
                        node,
                        f"`.item()` on captured tensor(s) {sorted(hit)} in "
                        f"{where} — syncs the stream and raises under "
                        f"capture",
                    )

            # --- mutating a closed-over container ---------------------
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATOR_METHODS
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id not in region.locals_
            ):
                yield ctx.finding(
                    CLOSURE_MUTATION.id,
                    node,
                    f"`{node.func.value.id}.{node.func.attr}(...)` mutates "
                    f"closed-over state in {where} — runs once at capture, "
                    f"then never again on replay",
                )

            # --- captured shape arguments -----------------------------
            yield from _check_shape_call(ctx, region, node, fname)

        # --- global/nonlocal rebinding under capture ------------------
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            kw = "global" if isinstance(node, ast.Global) else "nonlocal"
            yield ctx.finding(
                CLOSURE_MUTATION.id,
                node,
                f"`{kw} {', '.join(node.names)}` in {where} — rebinding "
                f"outer state under capture happens once, at capture; "
                f"return the value instead",
            )

        # --- subscript-assign into closed-over container --------------
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id not in region.locals_
                ):
                    yield ctx.finding(
                        CLOSURE_MUTATION.id,
                        node,
                        f"`{t.value.id}[...] = ...` writes into closed-over "
                        f"state in {where} — a capture-time side effect, "
                        f"silently stale on replay",
                    )


def _check_shape_call(
    ctx: ModuleContext, region: CapturedRegion, node: ast.Call, fname: str
) -> Iterator[Finding]:
    shape_args: list[ast.expr] = []
    if fname in _SHAPE_ARG_FNS:
        idx = _SHAPE_ARG_FNS[fname]
        if idx is None:
            shape_args.extend(node.args)
        elif len(node.args) > idx:
            shape_args.append(node.args[idx])
        for kw in node.keywords:
            if kw.arg in _SHAPE_KWARGS:
                shape_args.append(kw.value)
        label = fname
    elif (
        isinstance(node.func, ast.Attribute)
        and node.func.attr in _SHAPE_METHODS
    ):
        shape_args.extend(node.args)
        shape_args.extend(
            kw.value for kw in node.keywords if kw.arg in _SHAPE_KWARGS
        )
        label = f".{node.func.attr}"
    else:
        return

    for arg in shape_args:
        hit = _naked_captured_refs(arg, region.captured)
        if hit:
            yield ctx.finding(
                CAPTURED_SHAPE.id,
                node,
                f"shape argument of `{label}(...)` derives from captured "
                f"tensor(s) {sorted(hit)} in {region.where} — reading it "
                f"syncs the stream and raises under capture; shapes must "
                f"be Python ints (annotate the parameter `int`)",
            )
            return


register_pass("graph", run_capture_pass)
