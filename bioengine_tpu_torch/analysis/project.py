"""Whole-program project index — phase 1 of the two-phase analyzer.

Per-module AST walks (phase 1) produce a :class:`ModuleIndex` of
*facts*: defined functions/classes, an approximate call graph (edges
keyed on qualified names, ``self.``-method references, and imported
module attributes), and the stringly-typed cross-module contracts the
distributed serving stack is held together by —

- RPC **verbs** registered in service-definition dicts vs. verbs sent
  over the wire (``conn.call("serve-router", "register_host", ...)``),
- **capability tokens** (``PROTO_* = "oob1"``) offered in handshake
  lists vs. gated by membership tests / ``peer_supports``,
- **flight events** emitted via ``flight.record("breaker.trip", ...)``,
- **metric families** registered via ``metrics.counter/gauge/histogram``
  or emitted as scrape-time ``Sample``\\ s,
- **env knobs** read via ``os.environ.get("BIOENGINE_*")``.

Phase 2 (``dist_rules`` / ``interproc``) evaluates cross-module rule
families over the union of every module's facts plus the documentation
catalogs (:func:`parse_docs`).

Module indexes are cached (``.analyze-torch-cache.json``, keyed by content
hash) and built incrementally: ``analyze --changed`` re-indexes only
edited modules but still evaluates cross-module rules against the full
fact base.  Indexing is embarrassingly parallel and runs across a
process pool (``--jobs``).
"""

from __future__ import annotations

import ast
import hashlib
import json
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional

from bioengine_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    _parse_suppressions,
    dotted_name,
    iter_python_files,
    run_module_passes,
)

CACHE_VERSION = 5
DEFAULT_CACHE = Path(".analyze-torch-cache.json")

# `# analyze: hot-path-root` on a def line (or the line directly above
# it) declares the function a request-path root for the BE-PERF-3xx
# hot-path cost pass, extending the checked-in catalog in
# hotpath_rules.HOT_PATH_ROOT_CATALOG.
_HOT_PATH_ROOT_RE = re.compile(r"#\s*analyze:\s*hot-path-root\b")

# ---------------------------------------------------------------------------
# Blocking-call model shared with the interprocedural async pass
# ---------------------------------------------------------------------------

# Superset of the module-local BE-ASYNC-001 model — imported, not
# copied, so the two passes can never drift — plus heavyweight numpy
# disk I/O that is fine in a sync helper but not on the loop.
from bioengine_tpu_torch.analysis.async_rules import (
    _BLOCKING_CALLS as _MODULE_BLOCKING_CALLS,
    _BLOCKING_PREFIXES as BLOCKING_PREFIXES,
    _FILE_IO_METHODS as FILE_IO_METHODS,
)

BLOCKING_CALLS = _MODULE_BLOCKING_CALLS | {
    "np.load",
    "np.save",
    "np.savez",
    "numpy.load",
    "numpy.save",
    "numpy.savez",
}

_THREADING_LOCKS = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
}
_ASYNC_LOCKS = {
    "asyncio.Lock",
    "asyncio.Semaphore",
    "asyncio.BoundedSemaphore",
    "asyncio.Condition",
}

_CONSTRUCTOR_NAMES = {"__init__", "__post_init__", "__new__"}

# verbs ride these call shapes (see rpc/client.py, serving/controller.py):
#   <conn>.call("service-id", "verb", ...)          both strings constant
#   <x>._call_host(service_var, "verb", ...)        verb constant
#   <x>.call_service_method(service_var, "verb", ...)
#   <x>._stream_host(service_var, "verb", ...)      streaming twin
_VERB_CALL_ATTRS = {"_call_host", "call_service_method", "_stream_host"}

# dict literals in these functions register verbs even when the dict is
# returned rather than passed straight to register_service (the
# worker's `_service_definition` / `service_methods` convention)
_VERB_DEF_FUNCTIONS = {"_service_definition", "service_methods"}
_VERB_REGISTER_FUNCS = {"register_service", "register_local_service"}

# A dict key whose value is a literal (str/num/dict/list) is service
# *metadata*, not a verb; callables arrive as Name/Attribute/Lambda.
_VERB_META_KEYS = {"id", "name", "type", "description", "config", "docs"}


def _sha1(text: str) -> str:
    return hashlib.sha1(text.encode("utf-8", "replace")).hexdigest()


_TOOL_FINGERPRINT: Optional[str] = None


def tool_fingerprint() -> str:
    """Hash of the analyzer's own sources.  Folded into the cache key
    so editing any rule/pass invalidates every cached module result —
    a manual CACHE_VERSION bump alone is too easy to forget, and a
    stale cache would silently replay pre-edit findings."""
    global _TOOL_FINGERPRINT
    if _TOOL_FINGERPRINT is None:
        h = hashlib.sha1(str(CACHE_VERSION).encode())
        for src in sorted(Path(__file__).parent.glob("*.py")):
            try:
                h.update(src.name.encode())
                h.update(src.read_bytes())
            except OSError:
                pass
        _TOOL_FINGERPRINT = h.hexdigest()[:16]
    return _TOOL_FINGERPRINT


# ---------------------------------------------------------------------------
# Per-module indexer
# ---------------------------------------------------------------------------


class _FunctionFacts:
    """Facts for one function (or the module-level pseudo-function)."""

    __slots__ = (
        "qualname", "lineno", "is_async", "is_generator", "cls",
        "calls", "blocking", "writes", "withs", "acquires",
        "perf", "map_inserts", "map_sweeps", "task_spawns",
        "task_cancels", "sem_acquires", "sem_releases",
    )

    def __init__(self, qualname: str, lineno: int, is_async: bool,
                 cls: Optional[str]):
        self.qualname = qualname
        self.lineno = lineno
        self.is_async = is_async
        # calling a generator function does NOT run its body — the
        # interprocedural blocking walk must not follow such edges
        self.is_generator = False
        self.cls = cls
        self.calls: list[list] = []      # [ref, line, col, kind]
        self.blocking: list[list] = []   # [name, line, col]
        self.writes: list[list] = []     # [attr, line, col, locked]
        self.withs: list[list] = []      # [ref, line, col, is_async, has_await]
        self.acquires: list[list] = []   # [ref, line, col]
        # per-request cost sites for the BE-PERF-3xx hot-path pass
        self.perf: list[list] = []       # [kind, detail, line, col]
        # keyed-map lifecycle sites for BE-LIFE-401
        self.map_inserts: list[list] = []  # [attr, line, col]
        self.map_sweeps: list[list] = []   # [attr, line, col]
        # supervised-task handle sites for BE-LIFE-402
        self.task_spawns: list[list] = []  # [attr, line, col]
        self.task_cancels: list[list] = []  # [attr, line, col]
        # semaphore/lock pairing sites for BE-LIFE-403
        self.sem_acquires: list[list] = []  # [base, line, col, protected]
        self.sem_releases: list[list] = []  # [base, line, col, in_finally]

    def to_dict(self) -> dict:
        return {
            "qualname": self.qualname,
            "lineno": self.lineno,
            "is_async": self.is_async,
            "is_generator": self.is_generator,
            "cls": self.cls,
            "calls": self.calls,
            "blocking": self.blocking,
            "writes": self.writes,
            "withs": self.withs,
            "acquires": self.acquires,
            "perf": self.perf,
            "map_inserts": self.map_inserts,
            "map_sweeps": self.map_sweeps,
            "task_spawns": self.task_spawns,
            "task_cancels": self.task_cancels,
            "sem_acquires": self.sem_acquires,
            "sem_releases": self.sem_releases,
        }


def _collect_lock_names(tree: ast.Module) -> tuple[set[str], set[str]]:
    """Names (``x``, ``self._lock``) bound to threading / asyncio lock
    constructors anywhere in the module."""
    threading_names: set[str] = set()
    async_names: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not isinstance(node.value, ast.Call):
            continue
        ctor = dotted_name(node.value.func)
        if ctor is None:
            continue
        for target in node.targets:
            name = dotted_name(target)
            if not name:
                continue
            if ctor in _THREADING_LOCKS:
                threading_names.add(name)
            elif ctor in _ASYNC_LOCKS:
                async_names.add(name)
    return threading_names, async_names


class _Indexer(ast.NodeVisitor):
    def __init__(self, module_name: str, lock_names: set[str],
                 async_lock_names: set[str]):
        self.module_name = module_name
        self.lock_names = lock_names
        self.async_lock_names = async_lock_names
        self.functions: dict[str, _FunctionFacts] = {}
        self.imports: dict[str, str] = {}
        self.verbs_registered: list[list] = []   # [verb, line, col]
        self.verb_calls: list[list] = []         # [service, verb, line, col]
        self.attr_calls: set[str] = set()
        self.flight_events: list[list] = []      # [name, line, col]
        self.metric_names: list[list] = []       # [name|prefix*, line, col]
        self.env_reads: list[list] = []          # [knob, line, col]
        self.caps_defined: list[list] = []       # [symbol, value, line, col]
        self.caps_offered: list[list] = []       # [symbol|value, line, col]
        self.caps_gated: list[list] = []         # [symbol|value, line, col]

        # `self.X = {}` / dict() / defaultdict(...) sites per class —
        # BE-LIFE-401 only considers attrs declared mapping-shaped, so
        # list/array index assignment never reads as a keyed insert
        self.dict_attrs: list[list] = []         # [cls, attr, line, col]

        self._class_stack: list[str] = []
        self._fn_stack: list[_FunctionFacts] = []
        self._lock_depth = 0
        # depth > 0: inside the miss branch of an `if x is None:`
        # memoization guard — an env read there is a cached read, not a
        # per-request cost (metrics_enabled, tracing._cached_env, ...)
        self._memo_depth = 0
        # depth > 0: inside `if log.isEnabledFor(...)`-guarded code —
        # eager formatting there is level-gated, not a per-request cost
        self._log_guard_depth = 0
        # stack of lock/semaphore bases released in the finally block of
        # each enclosing `try:` — an acquire under one of these is
        # exception-safe (BE-LIFE-403)
        self._finally_release_stack: list[set[str]] = []
        self._in_finally = 0
        # local-name -> self-attr aliases per function frame, so
        # `task = self._t` / `if task: task.cancel()` still counts as a
        # cancel of `self._t` (the common guarded-cancel idiom)
        self._alias_stack: list[dict[str, str]] = [{}]
        self._module_fn = _FunctionFacts("<module>", 1, False, None)
        self.functions["<module>"] = self._module_fn

    # ---- helpers ----------------------------------------------------

    @property
    def _fn(self) -> _FunctionFacts:
        return self._fn_stack[-1] if self._fn_stack else self._module_fn

    @staticmethod
    def _const_str(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        return None

    def _pos(self, node: ast.AST) -> tuple[int, int]:
        return getattr(node, "lineno", 1), getattr(node, "col_offset", 0)

    # ---- imports ----------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            # _Indexer is a per-parse throwaway (and visit_Delete is an
            # AST hook, not a close path)
            # bioengine: ignore[BE-LIFE-401]
            self.imports[alias.asname or alias.name.split(".")[0]] = (
                alias.name
            )

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and node.level == 0:
            for alias in node.names:
                self.imports[alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}"
                )

    # ---- definitions ------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_function(self, node, is_async: bool) -> None:
        cls = self._class_stack[-1] if self._class_stack else None
        qual = f"{cls}.{node.name}" if cls else node.name
        if self._fn_stack:
            # nested function: facts attributed to a distinct node so a
            # nested sync def's blocking calls don't taint the parent
            qual = f"{self._fn.qualname}.<locals>.{node.name}"
        facts = _FunctionFacts(qual, node.lineno, is_async, cls)
        # first definition wins (overloads / branches are rare);
        # per-parse throwaway registry # bioengine: ignore[BE-LIFE-401]
        self.functions.setdefault(qual, facts)
        self._fn_stack.append(facts)
        self._alias_stack.append({})
        saved_lock = self._lock_depth
        saved_memo = self._memo_depth
        saved_guard = self._log_guard_depth
        saved_finally = self._finally_release_stack
        self._lock_depth = 0
        self._memo_depth = 0
        self._log_guard_depth = 0
        # an enclosing try's finally does not run around a nested def's
        # body — the nested function executes later, elsewhere
        self._finally_release_stack = []
        self.generic_visit(node)
        self._lock_depth = saved_lock
        self._memo_depth = saved_memo
        self._log_guard_depth = saved_guard
        self._finally_release_stack = saved_finally
        self._alias_stack.pop()
        self._fn_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_function(node, False)

    def visit_Yield(self, node: ast.Yield) -> None:
        self._fn.is_generator = True
        self.generic_visit(node)

    def visit_YieldFrom(self, node: ast.YieldFrom) -> None:
        self._fn.is_generator = True
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_function(node, True)

    # ---- with / locks ----------------------------------------------

    def _visit_with(self, node, is_async: bool) -> None:
        locked = False
        for item in node.items:
            expr = item.context_expr
            # `with self._lock:` and `with lock.acquire_timeout(..)` both
            # count the lock name as covering the block
            ref = dotted_name(expr)
            if ref is None and isinstance(expr, ast.Call):
                ref = dotted_name(expr.func)
            if ref is None:
                continue
            base = ref
            if ref.rsplit(".", 1)[-1] in {"acquire_timeout", "acquire"}:
                base = ref.rsplit(".", 1)[0]
            if base in self.lock_names or base in self.async_lock_names:
                locked = True
                has_await = any(
                    isinstance(n, (ast.Await, ast.AsyncFor, ast.AsyncWith))
                    for n in ast.walk(node)
                )
                line, col = self._pos(node)
                self._fn.withs.append(
                    [base, line, col, is_async, has_await]
                )
        if locked:
            self._lock_depth += 1
            self.generic_visit(node)
            self._lock_depth -= 1
        else:
            self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        self._visit_with(node, False)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._visit_with(node, True)

    # ---- guard-sensitive blocks (memoization / log level) -----------

    @staticmethod
    def _is_memo_test(test: ast.AST) -> bool:
        """``if x is None:`` (incl. walrus) — the miss branch of the
        read-once memoization idiom."""
        return (
            isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Is)
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None
        )

    @staticmethod
    def _is_log_guard_test(test: ast.AST) -> bool:
        for sub in ast.walk(test):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "isEnabledFor"
            ):
                return True
        return False

    def visit_If(self, node: ast.If) -> None:
        memo = self._is_memo_test(node.test)
        guard = self._is_log_guard_test(node.test)
        self.visit(node.test)
        self._memo_depth += memo
        self._log_guard_depth += guard
        for stmt in node.body:
            self.visit(stmt)
        self._memo_depth -= memo
        self._log_guard_depth -= guard
        # the else branch is the memo HIT path / the unguarded path
        for stmt in node.orelse:
            self.visit(stmt)

    # ---- try/finally: release pairing (BE-LIFE-403) -----------------

    def visit_Try(self, node: ast.Try) -> None:
        released: set[str] = set()
        for stmt in node.finalbody:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call):
                    ref = dotted_name(sub.func)
                    if ref is not None and ref.endswith(".release"):
                        released.add(ref.rsplit(".", 1)[0])
        self._finally_release_stack.append(released)
        for stmt in node.body:
            self.visit(stmt)
        for handler in node.handlers:
            self.visit(handler)
        for stmt in node.orelse:
            self.visit(stmt)
        self._finally_release_stack.pop()
        self._in_finally += 1
        for stmt in node.finalbody:
            self.visit(stmt)
        self._in_finally -= 1

    # ---- attribute writes -------------------------------------------

    def _record_write(self, target: ast.AST, node: ast.AST) -> None:
        if (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            line, col = self._pos(node)
            self._fn.writes.append(
                [target.attr, line, col, self._lock_depth > 0]
            )

    _DICT_CTORS = {"dict", "defaultdict", "OrderedDict", "WeakValueDictionary"}
    _SPAWN_FUNCS = {"spawn_supervised", "create_task", "ensure_future"}

    def _self_attr(self, node: ast.AST) -> Optional[str]:
        """``self.X`` -> ``"X"``, else None."""
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr
        return None

    def _is_dict_value(self, value: ast.AST) -> bool:
        if isinstance(value, ast.Dict):
            return True
        if isinstance(value, ast.Call):
            ctor = dotted_name(value.func)
            if ctor is not None and ctor.rsplit(".", 1)[-1] in self._DICT_CTORS:
                return True
        return False

    def _record_lifecycle_assign(self, target: ast.AST,
                                 node: ast.AST) -> None:
        line, col = self._pos(node)
        # `self.X[key] = v` with a non-constant key: a keyed-map insert.
        # `self._m[k] = FAMILY.labels(...)` is the memoized metric-child
        # idiom — bounded by label cardinality, not lifecycle state
        if isinstance(target, ast.Subscript):
            attr = self._self_attr(target.value)
            is_labels_memo = (
                isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute)
                and node.value.func.attr == "labels"
            )
            if (
                attr is not None
                and not isinstance(target.slice, ast.Constant)
                and not is_labels_memo
            ):
                self._fn.map_inserts.append([attr, line, col])
            return
        attr = self._self_attr(target)
        if attr is None:
            # `task = self._t` local alias (guarded-cancel idiom)
            if isinstance(target, ast.Name):
                src = self._self_attr(node.value)
                if src is not None:
                    self._alias_stack[-1][target.id] = src
            return
        cls = self._class_stack[-1] if self._class_stack else self._fn.cls
        if self._is_dict_value(node.value):
            if cls is not None:
                self.dict_attrs.append([cls, attr, line, col])
            leaf = self._fn.qualname.rsplit(".", 1)[-1]
            if leaf not in _CONSTRUCTOR_NAMES:
                # `self.X = {}` outside __init__ resets the whole map —
                # that is a sweep of every entry
                self._fn.map_sweeps.append([attr, line, col])
        if isinstance(node.value, ast.Call):
            fn_ref = dotted_name(node.value.func)
            if fn_ref is not None and (
                fn_ref.rsplit(".", 1)[-1] in self._SPAWN_FUNCS
            ):
                self._fn.task_spawns.append([attr, line, col])

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._record_write(target, node)
            self._record_lifecycle_assign(target, node)
            # PROTO_* string constants are capability definitions
            name = dotted_name(target)
            value = self._const_str(node.value)
            if (
                name
                and value is not None
                and name.rsplit(".", 1)[-1].startswith("PROTO_")
            ):
                line, col = self._pos(node)
                self.caps_defined.append(
                    [name.rsplit(".", 1)[-1], value, line, col]
                )
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_write(node.target, node)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for target in node.targets:
            if isinstance(target, ast.Subscript):
                attr = self._self_attr(target.value)
                if attr is not None:
                    line, col = self._pos(node)
                    self._fn.map_sweeps.append([attr, line, col])
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_write(node.target, node)
            self._record_lifecycle_assign(node.target, node)
        self.generic_visit(node)

    # ---- capability offer / gate sites ------------------------------

    _CAP_VALUE_RE = re.compile(r"^[a-z][a-z0-9_]{2,15}\d$")

    def _cap_token(self, node: ast.AST) -> Optional[str]:
        """A capability reference: ``protocol.PROTO_X`` / ``PROTO_X`` /
        a version-suffixed string constant ("oob1") — consts are
        resolved against defined capability values at rule time."""
        ref = dotted_name(node)
        if ref is not None:
            leaf = ref.rsplit(".", 1)[-1]
            return leaf if leaf.startswith("PROTO_") else None
        value = self._const_str(node)
        if value is not None and self._CAP_VALUE_RE.match(value):
            return value
        return None

    def visit_List(self, node: ast.List) -> None:
        self._collect_offered(node.elts, node)
        self.generic_visit(node)

    def visit_Tuple(self, node: ast.Tuple) -> None:
        self._collect_offered(node.elts, node)
        self.generic_visit(node)

    def visit_Set(self, node: ast.Set) -> None:
        self._collect_offered(node.elts, node)
        self.generic_visit(node)

    def _collect_offered(self, elts: list, node: ast.AST) -> None:
        for elt in elts:
            token = self._cap_token(elt)
            if token is not None:
                line, col = self._pos(elt)
                self.caps_offered.append([token, line, col])

    def visit_Compare(self, node: ast.Compare) -> None:
        # `PROTO_X in declared` / `"oob1" in protocols` — string-const
        # tokens are resolved against defined capability VALUES at rule
        # time, so `"x" in some_dict` noise never becomes a gate fact
        if any(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops):
            token = self._cap_token(node.left)
            if token is not None:
                line, col = self._pos(node)
                self.caps_gated.append([token, line, col])
        self.generic_visit(node)

    # ---- subscript env reads ----------------------------------------

    def visit_Subscript(self, node: ast.Subscript) -> None:
        base = dotted_name(node.value)
        if base == "os.environ":
            key = self._const_str(node.slice)
            if key and key.startswith("BIOENGINE_"):
                line, col = self._pos(node)
                self.env_reads.append([key, line, col])
        self.generic_visit(node)

    # ---- calls: the fact goldmine -----------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        ref = dotted_name(node.func)
        leaf = None
        if isinstance(node.func, ast.Attribute):
            leaf = node.func.attr
            self.attr_calls.add(leaf)
        elif isinstance(node.func, ast.Name):
            leaf = node.func.id
        line, col = self._pos(node)

        if ref is not None:
            self._fn.calls.append([ref, line, col, "call"])

        # thread entry points: the callable handed over runs OFF the
        # event loop — an edge of kind "thread", not "call"
        self._collect_thread_edges(node, leaf)

        # blocking facts (shared model with the interprocedural pass)
        if ref is not None and (
            ref in BLOCKING_CALLS or ref.startswith(BLOCKING_PREFIXES)
        ):
            self._fn.blocking.append([ref, line, col])
        elif isinstance(node.func, ast.Name) and node.func.id == "open":
            self._fn.blocking.append(["open", line, col])
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in FILE_IO_METHODS
        ):
            self._fn.blocking.append([f".{node.func.attr}", line, col])

        # `self._lock.acquire()` on a threading lock
        if leaf == "acquire" and ref is not None:
            base = ref.rsplit(".", 1)[0]
            if base in self.lock_names:
                self._fn.acquires.append([base, line, col])

        # per-request cost + lifecycle facts (BE-PERF-3xx / BE-LIFE-4xx)
        if self._fn_stack:
            self._collect_perf(node, ref, leaf, line, col)
        self._collect_lifecycle_call(node, ref, leaf, line, col)

        # RPC verb calls
        self._collect_verb_call(node, leaf)

        # verb registration dicts passed straight to register_service
        if leaf in _VERB_REGISTER_FUNCS and node.args and isinstance(
            node.args[0], ast.Dict
        ):
            self._collect_verb_dict(node.args[0])

        # flight events: `flight.record("x", ...)` from anywhere, plus
        # the flight module's own internal `record("flight.dump", ...)`
        full = ref or ""
        if "." not in full and full:
            full = self.imports.get(full, full)
        is_flight_record = (
            full == "flight.record"
            or full.endswith(".flight.record")
            or (
                ref == "record"
                and (
                    self.module_name == "flight"
                    or self.module_name.endswith(".flight")
                )
            )
        )
        if is_flight_record and node.args:
            first = node.args[0]
            name = self._const_str(first)
            if name is None and isinstance(
                first, ast.JoinedStr
            ) and first.values:
                # `flight.record(f"slo.{state}", ...)` — a dynamic
                # event family, recorded as a prefix wildcard
                prefix = self._const_str(first.values[0])
                if prefix:
                    name = f"{prefix}*"
            if name:
                self.flight_events.append([name, line, col])

        # metric families
        self._collect_metric(node, ref, leaf, line, col)

        # env knob reads
        if ref in {"os.getenv"} or (
            ref is not None and ref.endswith("environ.get")
        ):
            key = self._const_str(node.args[0]) if node.args else None
            if key and key.startswith("BIOENGINE_"):
                self.env_reads.append([key, line, col])

        # capability gates through the negotiation helpers: the
        # client-side ``peer_supports(TOKEN)`` and the server-side
        # ``service_peer_supports(service_id, TOKEN)`` (the controller
        # gating a verb on what a ws host declared at its handshake)
        token = None
        if leaf == "peer_supports" and node.args:
            token = self._cap_token(node.args[0])
        elif leaf == "service_peer_supports" and len(node.args) >= 2:
            token = self._cap_token(node.args[1])
        if token:
            self.caps_gated.append([token, line, col])

        self.generic_visit(node)

    def _collect_thread_edges(self, node: ast.Call, leaf) -> None:
        target: Optional[ast.AST] = None
        if leaf == "to_thread" and node.args:
            target = node.args[0]
        elif leaf == "run_in_executor" and len(node.args) >= 2:
            target = node.args[1]
        elif leaf == "submit" and node.args:
            target = node.args[0]
        elif leaf in {"Thread", "start_new_thread"}:
            for kw in node.keywords:
                if kw.arg == "target":
                    target = kw.value
            if target is None and leaf == "start_new_thread" and node.args:
                target = node.args[0]
        if target is None:
            return
        ref = dotted_name(target)
        if ref is not None:
            line, col = self._pos(node)
            self._fn.calls.append([ref, line, col, "thread"])

    def _collect_verb_call(self, node: ast.Call, leaf) -> None:
        if not isinstance(node.func, ast.Attribute):
            return
        args = node.args
        if leaf == "call" and len(args) >= 2:
            service = self._const_str(args[0])
            verb = self._const_str(args[1])
            if service is not None and verb is not None:
                line, col = self._pos(args[1])
                self.verb_calls.append([service, verb, line, col])
        elif leaf in _VERB_CALL_ATTRS and len(args) >= 2:
            verb = self._const_str(args[1])
            if verb is not None:
                line, col = self._pos(args[1])
                self.verb_calls.append([None, verb, line, col])

    def _collect_verb_dict(self, d: ast.Dict) -> None:
        for key, value in zip(d.keys, d.values):
            verb = self._const_str(key) if key is not None else None
            if verb is None or verb in _VERB_META_KEYS:
                continue
            if isinstance(
                value, (ast.Name, ast.Attribute, ast.Lambda, ast.Call)
            ):
                line, col = self._pos(key)
                self.verbs_registered.append([verb, line, col])

    def _collect_metric(self, node, ref, leaf, line, col) -> None:
        is_family = leaf in {"counter", "gauge", "histogram"} and (
            (
                isinstance(node.func, ast.Attribute)
                and (dotted_name(node.func.value) or "").split(".")[-1]
                in {"metrics", "_metrics", "registry", "_registry"}
            )
            or (
                isinstance(node.func, ast.Name)
                and self.imports.get(leaf, "").endswith(f"metrics.{leaf}")
            )
        )
        is_sample = leaf == "Sample"
        if not (is_family or is_sample):
            return
        if not node.args:
            return
        first = node.args[0]
        name = self._const_str(first)
        if name is None and isinstance(first, ast.JoinedStr) and first.values:
            head = first.values[0]
            prefix = self._const_str(head)
            if prefix:
                name = f"{prefix}*"
        if name:
            self.metric_names.append([name, line, col])

    # ---- per-request cost sites (BE-PERF-3xx) -----------------------

    _ENTROPY_CALLS = {"uuid.uuid4", "uuid.uuid1", "os.urandom"}
    _EAGER_LOG_BASES = {"log", "logger"}

    def _resolve_ref(self, ref: Optional[str]) -> Optional[str]:
        if ref is None:
            return None
        return self.imports.get(ref, ref) if "." not in ref else ref

    @staticmethod
    def _is_eager_format(arg: ast.AST) -> bool:
        """f-string / `%`-interpolation / `.format()` — formatting that
        runs whether or not the level is enabled, unlike the lazy
        ``log.debug("x %s", v)`` idiom."""
        if isinstance(arg, ast.JoinedStr):
            # a constant-only f-string has nothing to format
            return any(
                isinstance(v, ast.FormattedValue) for v in arg.values
            )
        if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Mod):
            return True
        return (
            isinstance(arg, ast.Call)
            and isinstance(arg.func, ast.Attribute)
            and arg.func.attr == "format"
        )

    def _collect_perf(self, node: ast.Call, ref, leaf, line, col) -> None:
        # 301 — env read (any key; module-level reads are import-time
        # and never collected here; memo-guarded reads are cached)
        if (
            ref is not None
            and (ref == "os.getenv" or ref.endswith("environ.get"))
            and self._memo_depth == 0
        ):
            key = self._const_str(node.args[0]) if node.args else None
            self._fn.perf.append(["env", key or "<dynamic>", line, col])

        # 302 — entropy syscall per call
        full = self._resolve_ref(ref)
        if full is not None and (
            full in self._ENTROPY_CALLS or full.startswith("secrets.")
        ):
            self._fn.perf.append(["entropy", full, line, col])

        # 303 — chained `.labels(...).inc()`: a labeled-child lookup per
        # call.  The cached idioms (`self._m = F.labels(...)` at
        # construction, `child = self._m[k] = F.labels(...)` on a memo
        # miss) are assignments, never this chain.
        if (
            isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Call)
            and isinstance(node.func.value.func, ast.Attribute)
            and node.func.value.func.attr == "labels"
        ):
            inner = node.func.value
            family = dotted_name(inner.func.value) or "<family>"
            iline, icol = self._pos(inner)
            self._fn.perf.append(["relabel", family, iline, icol])

        # 304 — regex construction per call
        if self._resolve_ref(ref) == "re.compile":
            self._fn.perf.append(["recompile", "", line, col])

        # 305 — eagerly-formatted debug log without a level guard
        if (
            leaf == "debug"
            and isinstance(node.func, ast.Attribute)
            and self._log_guard_depth == 0
            and node.args
            and self._is_eager_format(node.args[0])
        ):
            base = dotted_name(node.func.value) or ""
            tail = base.rsplit(".", 1)[-1].lstrip("_")
            if tail in self._EAGER_LOG_BASES or "logger" in tail:
                self._fn.perf.append(["logdebug", base, line, col])

    # ---- lifecycle call sites (BE-LIFE-4xx) -------------------------

    _SWEEP_METHODS = {"pop", "clear", "popitem"}

    def _collect_lifecycle_call(self, node: ast.Call, ref, leaf,
                                line, col) -> None:
        if ref is None:
            return
        parts = ref.split(".")
        # `self.X.pop(key)` / `.clear()` sweeps; `.setdefault(k, v)`
        # inserts — both only on direct self attributes
        if len(parts) == 3 and parts[0] == "self":
            attr = parts[1]
            if leaf in self._SWEEP_METHODS:
                self._fn.map_sweeps.append([attr, line, col])
            elif leaf == "setdefault" and node.args and not isinstance(
                node.args[0], ast.Constant
            ):
                self._fn.map_inserts.append([attr, line, col])
            elif leaf == "cancel":
                self._fn.task_cancels.append([attr, line, col])
        elif len(parts) == 2 and leaf == "cancel":
            # `task.cancel()` through a local alias of a self attr
            attr = self._alias_stack[-1].get(parts[0])
            if attr is not None:
                self._fn.task_cancels.append([attr, line, col])

        # semaphore / lock acquire-release pairing (threading AND
        # asyncio families — `await sem.acquire()` parses as this Call)
        if leaf in {"acquire", "release"} and len(parts) >= 2:
            base = ref.rsplit(".", 1)[0]
            if base in self.lock_names or base in self.async_lock_names:
                if leaf == "acquire":
                    protected = any(
                        base in s for s in self._finally_release_stack
                    )
                    self._fn.sem_acquires.append(
                        [base, line, col, protected]
                    )
                else:
                    self._fn.sem_releases.append(
                        [base, line, col, self._in_finally > 0]
                    )


def index_module(path: str, source: str, module_name: str,
                 tree: Optional[ast.Module] = None) -> dict:
    """Build one module's fact index (phase 1).  Pure function of the
    source — safe to run in a process-pool worker."""
    if tree is None:
        tree = ast.parse(source)
    lock_names, async_lock_names = _collect_lock_names(tree)
    idx = _Indexer(module_name, lock_names, async_lock_names)
    idx.visit(tree)

    # service-definition convention: dict literals in functions named
    # _service_definition / service_methods register their verb keys
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
            node.name in _VERB_DEF_FUNCTIONS
        ):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Dict):
                    idx._collect_verb_dict(sub)

    lines = source.splitlines()
    per_line, file_wide = _parse_suppressions(lines)

    # `# analyze: hot-path-root` on the def line or the line above it
    marker_lines = {
        i for i, raw in enumerate(lines, start=1)
        if _HOT_PATH_ROOT_RE.search(raw)
    }
    hot_path_roots = sorted(
        f.qualname
        for f in idx.functions.values()
        if f.qualname != "<module>"
        and (f.lineno in marker_lines or f.lineno - 1 in marker_lines)
    )

    return {
        "path": path,
        "module": module_name,
        "sha1": _sha1(source),
        "functions": {q: f.to_dict() for q, f in idx.functions.items()},
        "hot_path_roots": hot_path_roots,
        "dict_attrs": idx.dict_attrs,
        "imports": idx.imports,
        "lock_names": sorted(lock_names),
        "async_lock_names": sorted(async_lock_names),
        "verbs_registered": idx.verbs_registered,
        "verb_calls": idx.verb_calls,
        "attr_calls": sorted(idx.attr_calls),
        "flight_events": idx.flight_events,
        "metric_names": idx.metric_names,
        "env_reads": idx.env_reads,
        "caps_defined": idx.caps_defined,
        "caps_offered": idx.caps_offered,
        "caps_gated": idx.caps_gated,
        "suppress_lines": {
            str(k): (sorted(v) if v is not None else None)
            for k, v in per_line.items()
        },
        "suppress_file": sorted(file_wide),
    }


# ---------------------------------------------------------------------------
# Documentation facts
# ---------------------------------------------------------------------------

_KNOB_RE = re.compile(r"BIOENGINE_[A-Z0-9_]+")
_BACKTICK_RE = re.compile(r"`([^`]+)`")
_EVENT_NAME_RE = re.compile(r"^[a-z0-9_*]+(\.[a-z0-9_*]+)+$")
_METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_*]*_[a-z0-9_*]+$")


def _expand_braces(token: str) -> list[str]:
    m = re.search(r"\{([^{}]*)\}", token)
    if not m:
        return [token]
    head, tail = token[: m.start()], token[m.end():]
    parts = m.group(1).split(",")
    if len(parts) == 1:
        # `metric_total{label}` documents a label set, not a name
        # alternation — the braces (and label) are not part of the name
        return _expand_braces(head + tail)
    out: list[str] = []
    for part in parts:
        out.extend(_expand_braces(head + part.strip() + tail))
    return out


@dataclass
class DocFacts:
    """Contract catalogs extracted from the docs tree.

    ``events`` / ``metrics`` map documented names (possibly with ``*``
    wildcards) to (file, line); ``knobs`` maps every ``BIOENGINE_*``
    token mentioned anywhere under docs/.  ``has_docs`` /
    ``has_catalogs`` gate the doc-dependent rules so a docs-less
    project (unit-test fixtures, other repos) never misfires."""

    events: dict[str, tuple[str, int]] = field(default_factory=dict)
    metrics: dict[str, tuple[str, int]] = field(default_factory=dict)
    knobs: dict[str, tuple[str, int]] = field(default_factory=dict)
    has_docs: bool = False
    has_event_catalog: bool = False
    has_metric_catalog: bool = False


def _first_cell_tokens(line: str) -> list[str]:
    """Backticked names from the first cell of a markdown table row."""
    if not line.lstrip().startswith("|"):
        return []
    cells = line.split("|")
    if len(cells) < 2:
        return []
    out: list[str] = []
    for token in _BACKTICK_RE.findall(cells[1]):
        for part in token.split("/"):
            out.extend(_expand_braces(part.strip()))
    return out


def parse_docs(root: Path) -> DocFacts:
    """Extract the event/metric catalogs (docs/observability.md) and
    the documented env-knob set (every ``BIOENGINE_*`` mention in any
    markdown file under docs/)."""
    facts = DocFacts()
    docs_dir = root / "docs"
    if not docs_dir.is_dir():
        return facts
    md_files = sorted(docs_dir.glob("*.md"))
    if not md_files:
        return facts
    facts.has_docs = True

    for md in md_files:
        try:
            text = md.read_text(encoding="utf-8")
        except (OSError, UnicodeDecodeError):
            continue
        rel = str(md.relative_to(root)) if md.is_relative_to(root) else str(md)
        section = ""
        for lineno, line in enumerate(text.splitlines(), start=1):
            if line.startswith("#"):
                section = line.lstrip("#").strip().lower()
                continue
            for m in _KNOB_RE.finditer(line):
                facts.knobs.setdefault(m.group(0), (rel, lineno))
            if md.name != "observability.md":
                continue
            if "event catalog" in section:
                facts.has_event_catalog = True
                for token in _first_cell_tokens(line):
                    if _EVENT_NAME_RE.match(token):
                        facts.events.setdefault(token, (rel, lineno))
            elif "metric catalog" in section or (
                "process self-metrics" in section
            ):
                facts.has_metric_catalog = True
                for token in _first_cell_tokens(line):
                    if _METRIC_NAME_RE.match(token) and "." not in token:
                        facts.metrics.setdefault(token, (rel, lineno))
    return facts


# ---------------------------------------------------------------------------
# Project index: build, cache, incremental re-index
# ---------------------------------------------------------------------------


@dataclass
class IndexStats:
    files_total: int = 0
    files_indexed: int = 0      # (re)parsed this run
    files_cached: int = 0       # served from the cache
    jobs: int = 1
    wall_s: float = 0.0
    # phase-2 wall time per registered project pass (--stats-json)
    pass_s: dict = field(default_factory=dict)


def _index_one(abs_path: str, rel_path: str, module_name: str) -> dict:
    """Process-pool worker: parse + index + module passes for one file.
    Returns the cache record {sha1, index, findings}."""
    try:
        source = Path(abs_path).read_text(encoding="utf-8")
    except (OSError, UnicodeDecodeError) as e:
        return {
            "sha1": "",
            "index": None,
            "findings": [
                finding_to_dict(
                    Finding("BE-IO-000", rel_path, 1, 0, f"unreadable: {e}")
                )
            ],
        }
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return {
            "sha1": _sha1(source),
            "index": None,
            "findings": [
                finding_to_dict(
                    Finding(
                        "BE-PARSE-000",
                        rel_path,
                        e.lineno or 1,
                        e.offset or 0,
                        f"syntax error: {e.msg}",
                    )
                )
            ],
        }
    index = index_module(rel_path, source, module_name, tree=tree)
    lines = source.splitlines()
    ctx = ModuleContext(path=rel_path, source=source, tree=tree, lines=lines)
    findings = run_module_passes(ctx)
    return {
        "sha1": index["sha1"],
        "index": index,
        "findings": [finding_to_dict(f) for f in findings],
    }


def finding_to_dict(f: Finding) -> dict:
    return {
        "rule": f.rule,
        "path": f.path,
        "line": f.line,
        "col": f.col,
        "message": f.message,
        "source_line": f.source_line,
    }


def finding_from_dict(d: dict) -> Finding:
    return Finding(
        d["rule"], d["path"], d["line"], d["col"], d["message"],
        d.get("source_line", ""),
    )


def _module_name_for(rel_path: str) -> str:
    parts = Path(rel_path).with_suffix("").parts
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def load_cache(cache_path: Optional[Path]) -> dict:
    if cache_path is None or not cache_path.exists():
        return {}
    try:
        data = json.loads(cache_path.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return {}
    if data.get("tool") != tool_fingerprint():
        return {}
    return data.get("modules", {})


def save_cache(cache_path: Optional[Path], modules: dict) -> None:
    if cache_path is None:
        return
    try:
        cache_path.write_text(
            json.dumps({"tool": tool_fingerprint(), "modules": modules}),
            encoding="utf-8",
        )
    except OSError:
        pass  # a read-only checkout still analyzes, just never caches


def build_project_index(
    paths: Iterable[Path],
    root: Optional[Path] = None,
    jobs: Optional[int] = None,
    cache_path: Optional[Path] = DEFAULT_CACHE,
) -> tuple[dict[str, dict], IndexStats]:
    """Phase 1 over every python file under ``paths``.

    Returns ``(records, stats)`` where records maps repo-relative path
    -> {sha1, index, findings}.  Unchanged files (by content hash) are
    served from ``cache_path``; the rest are (re)indexed, across a
    process pool when ``jobs`` > 1.
    """
    import os

    root = (root or Path.cwd()).resolve()
    t0 = time.monotonic()
    files: list[tuple[str, str, str]] = []  # (abs, rel, module)
    seen: set[str] = set()
    for f in iter_python_files(paths):
        ap = f.resolve()
        try:
            rel = str(ap.relative_to(root))
        except ValueError:
            rel = str(ap)
        if rel in seen:
            continue
        seen.add(rel)
        files.append((str(ap), rel, _module_name_for(rel)))

    cached = load_cache(cache_path)
    stats = IndexStats(files_total=len(files))

    work: list[tuple[str, str, str]] = []
    records: dict[str, dict] = {}
    for abs_path, rel, module_name in files:
        entry = cached.get(rel)
        if entry is not None:
            try:
                source = Path(abs_path).read_text(encoding="utf-8")
            except (OSError, UnicodeDecodeError):
                source = None
            if source is not None and entry.get("sha1") == _sha1(source):
                records[rel] = entry
                stats.files_cached += 1
                continue
        work.append((abs_path, rel, module_name))

    jobs = jobs or os.cpu_count() or 1
    stats.jobs = jobs
    if jobs > 1 and len(work) > 8:
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=jobs) as pool:
            for (abs_path, rel, _), rec in zip(
                work, pool.map(
                    _index_one,
                    [w[0] for w in work],
                    [w[1] for w in work],
                    [w[2] for w in work],
                    chunksize=8,
                )
            ):
                records[rel] = rec
                stats.files_indexed += 1
    else:
        stats.jobs = 1
        for abs_path, rel, module_name in work:
            records[rel] = _index_one(abs_path, rel, module_name)
            stats.files_indexed += 1

    # merge-save: runs over different scopes (full scan, --changed
    # subsets, fixture dirs) share one cache file without evicting
    # each other's entries
    save_cache(cache_path, {**cached, **records})
    stats.wall_s = time.monotonic() - t0
    return records, stats


def index_line_suppressed(idx: dict, line: int, rule: str) -> bool:
    """One place for the serialized suppress_lines/suppress_file
    semantics (ProjectContext filtering AND the interprocedural walk's
    edge pruning share it — the grammar must never diverge)."""
    if rule in idx["suppress_file"]:
        return True
    ids = idx["suppress_lines"].get(str(line), "absent")
    if ids == "absent":
        return False
    return ids is None or rule in ids


# ---------------------------------------------------------------------------
# ProjectContext — what phase-2 passes see
# ---------------------------------------------------------------------------


class ProjectContext:
    """The whole program, resolved: every module's fact index plus the
    documentation catalogs.  Phase-2 passes receive one of these."""

    def __init__(self, records: dict[str, dict], docs: DocFacts,
                 root: Path):
        self.root = root
        self.docs = docs
        self.modules: dict[str, dict] = {
            rel: rec["index"]
            for rel, rec in records.items()
            if rec.get("index") is not None
        }
        # dotted module name -> index (for import resolution)
        self.by_module_name: dict[str, dict] = {
            idx["module"]: idx for idx in self.modules.values()
        }
        self._lines: dict[str, list[str]] = {}

    # ---- findings ---------------------------------------------------

    def _source_line(self, path: str, line: int) -> str:
        lines = self._lines.get(path)
        if lines is None:
            try:
                lines = (self.root / path).read_text(
                    encoding="utf-8"
                ).splitlines()
            except (OSError, UnicodeDecodeError):
                lines = []
            self._lines[path] = lines
        if 0 < line <= len(lines):
            return lines[line - 1].strip()
        return ""

    def finding(self, rule: str, path: str, line: int, col: int,
                message: str) -> Finding:
        return Finding(
            rule, path, line, col, message,
            self._source_line(path, line),
        )

    # ---- call-graph resolution --------------------------------------

    def resolve(self, idx: dict, cls: Optional[str],
                ref: str) -> Optional[tuple[dict, dict]]:
        """Resolve a call reference from module ``idx`` (inside class
        ``cls``) to ``(module_index, function_facts)`` — or None when
        the target is outside the project / not statically nameable."""
        functions = idx["functions"]
        if ref.startswith("self."):
            rest = ref[len("self."):]
            if "." in rest or cls is None:
                return None
            fn = functions.get(f"{cls}.{rest}")
            return (idx, fn) if fn else None
        if "." not in ref:
            fn = functions.get(ref)
            if fn:
                return (idx, fn)
            # `from x import helper` — resolve through the import map
            target = idx["imports"].get(ref)
            if target and "." in target:
                mod, leaf = target.rsplit(".", 1)
                other = self.by_module_name.get(mod)
                if other:
                    fn = other["functions"].get(leaf)
                    return (other, fn) if fn else None
            return None
        head, leaf = ref.rsplit(".", 1)
        # `mod.helper()` via `import pkg.mod` / `from pkg import mod`
        target_mod = idx["imports"].get(head, head)
        other = self.by_module_name.get(target_mod)
        if other:
            fn = other["functions"].get(leaf)
            return (other, fn) if fn else None
        # `Class.method()` in the same module
        fn = functions.get(ref)
        if fn:
            return (idx, fn)
        return None

    # ---- suppression filtering --------------------------------------

    def suppressed(self, f: Finding) -> bool:
        idx = self.modules.get(f.path)
        if idx is None:
            return False
        return index_line_suppressed(idx, f.line, f.rule)


# ---------------------------------------------------------------------------
# Two-phase entry point
# ---------------------------------------------------------------------------


def analyze_project(
    paths: Iterable[Path],
    root: Optional[Path] = None,
    report_paths: Optional[Iterable[Path]] = None,
    rules: Optional[set[str]] = None,
    jobs: Optional[int] = None,
    cache_path: Optional[Path] = DEFAULT_CACHE,
    return_context: bool = False,
):
    """Run both phases: index every module under ``paths`` (phase 1,
    cached + incremental + parallel), then evaluate module findings and
    every registered project pass over the full fact base (phase 2).

    ``report_paths`` restricts *module-local* findings to a subset of
    files (the ``--changed`` gate) while cross-module rules still see —
    and report against — the whole project.

    Returns ``(findings, stats)``, or ``(findings, stats, ctx)`` with
    ``return_context=True`` so callers (``--hot-path-report``) can
    derive artifacts from the same fact base without re-indexing.
    """
    from bioengine_tpu_torch.analysis.core import project_passes

    root = (root or Path.cwd()).resolve()
    records, stats = build_project_index(
        paths, root=root, jobs=jobs, cache_path=cache_path
    )

    report_rel: Optional[set[str]] = None
    if report_paths is not None:
        report_rel = set()
        for f in iter_python_files(report_paths):
            ap = f.resolve()
            try:
                report_rel.add(str(ap.relative_to(root)))
            except ValueError:
                report_rel.add(str(ap))

    out: list[Finding] = []
    for rel, rec in records.items():
        if report_rel is not None and rel not in report_rel:
            continue
        for d in rec.get("findings", ()):
            f = finding_from_dict(d)
            if rules is not None and f.rule not in rules:
                continue
            out.append(f)

    docs = parse_docs(root)
    ctx = ProjectContext(records, docs, root)
    for name, fn in project_passes().items():
        t_pass = time.monotonic()
        for f in fn(ctx):
            if rules is not None and f.rule not in rules:
                continue
            if ctx.suppressed(f):
                continue
            out.append(f)
        stats.pass_s[name] = round(time.monotonic() - t_pass, 4)

    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    if return_context:
        return out, stats, ctx
    return out, stats
