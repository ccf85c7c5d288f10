"""Async-safety pass (BE-ASYNC-*): event-loop hazards in ``async def``.

The orchestration layer (rpc/, apps/proxy.py, datasets/proxy_server.py,
serving/, worker/) is single-event-loop asyncio; one blocking call
stalls every RPC, batch flush, and health probe at once, and a
swallowed task exception silently kills a background loop.  These
rules flag the hazards that reviews keep re-finding by hand.

All rules only inspect code *directly* inside an ``async def`` —
nested sync ``def``/``lambda`` bodies are skipped, because they run
wherever they're called (often an executor), not in the coroutine.
"""

from __future__ import annotations

import ast
from typing import Iterator

from bioengine_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    dotted_name,
    register_pass,
    register_rule,
)

BLOCKING_IN_ASYNC = register_rule(
    Rule(
        "BE-ASYNC-001",
        "blocking-call-in-async",
        "Blocking call (sleep/subprocess/socket/sync HTTP) inside async def",
        "async",
    )
)
LOCK_ACROSS_AWAIT = register_rule(
    Rule(
        "BE-ASYNC-002",
        "threading-lock-across-await",
        "threading.Lock held across an await point",
        "async",
    )
)
FIRE_AND_FORGET = register_rule(
    Rule(
        "BE-ASYNC-003",
        "fire-and-forget-task",
        "create_task result discarded: exceptions vanish, task may be GC'd",
        "async",
    )
)
UNAWAITED_CORO = register_rule(
    Rule(
        "BE-ASYNC-004",
        "unawaited-coroutine",
        "Coroutine called but never awaited",
        "async",
    )
)
BLOCKING_FILE_IO = register_rule(
    Rule(
        "BE-ASYNC-005",
        "blocking-file-io-in-async",
        "Synchronous file I/O inside async def",
        "async",
    )
)

# Exact dotted names that block the calling thread.  Deliberately a
# closed list: precision beats recall for a CI-blocking gate.
_BLOCKING_CALLS = {
    "time.sleep",
    "os.system",
    "os.popen",
    "os.wait",
    "os.waitpid",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "subprocess.getoutput",
    "socket.create_connection",
    "socket.getaddrinfo",
    "socket.gethostbyname",
    "urllib.request.urlopen",
    "shutil.rmtree",
    "shutil.copytree",
    "shutil.move",
    "shutil.copyfile",
    "httpx.get",
    "httpx.post",
    "httpx.put",
    "httpx.delete",
    "httpx.head",
    "httpx.request",
    "httpx.stream",
}
_BLOCKING_PREFIXES = ("requests.",)

_FILE_IO_METHODS = {"read_text", "read_bytes", "write_text", "write_bytes"}

_TASK_SPAWNERS = {"create_task", "ensure_future"}

_THREADING_LOCKS = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
}

_MUTATING_FN_BOUNDARY = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _shallow_walk(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body without entering nested def/lambda bodies."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _MUTATING_FN_BOUNDARY):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _contains_await(node: ast.AST) -> bool:
    return any(
        isinstance(n, (ast.Await, ast.AsyncFor, ast.AsyncWith))
        for n in _shallow_walk(node)
    )


def _collect_threading_locks(tree: ast.Module) -> set[str]:
    """Names (``x``, ``self._lock``) bound to ``threading.Lock()`` etc."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not isinstance(node.value, ast.Call):
            continue
        ctor = dotted_name(node.value.func)
        if ctor not in _THREADING_LOCKS:
            continue
        for target in node.targets:
            name = dotted_name(target)
            if name:
                names.add(name)
    return names


def _collect_async_names(tree: ast.Module) -> set[str]:
    """Names of every ``async def`` in the module (functions + methods)."""
    return {
        n.name for n in ast.walk(tree) if isinstance(n, ast.AsyncFunctionDef)
    }


def run_async_pass(ctx: ModuleContext) -> Iterator[Finding]:
    lock_names = _collect_threading_locks(ctx.tree)
    async_names = _collect_async_names(ctx.tree)

    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        yield from _check_async_fn(ctx, fn, lock_names, async_names)


def _check_async_fn(
    ctx: ModuleContext,
    fn: ast.AsyncFunctionDef,
    lock_names: set[str],
    async_names: set[str],
) -> Iterator[Finding]:
    for node in _shallow_walk(fn):
        # --- blocking calls / file I/O -------------------------------
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name and (
                name in _BLOCKING_CALLS
                or name.startswith(_BLOCKING_PREFIXES)
            ):
                yield ctx.finding(
                    BLOCKING_IN_ASYNC.id,
                    node,
                    f"`{name}()` blocks the event loop inside "
                    f"`async def {fn.name}` — use the asyncio equivalent "
                    f"or `await asyncio.to_thread(...)`",
                )
            elif isinstance(node.func, ast.Name) and node.func.id == "open":
                yield ctx.finding(
                    BLOCKING_FILE_IO.id,
                    node,
                    f"`open()` inside `async def {fn.name}` blocks the "
                    f"event loop — wrap in `asyncio.to_thread` (or accept "
                    f"and suppress for tiny local files)",
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _FILE_IO_METHODS
            ):
                yield ctx.finding(
                    BLOCKING_FILE_IO.id,
                    node,
                    f"`.{node.func.attr}()` inside `async def {fn.name}` "
                    f"is synchronous disk I/O on the event loop",
                )

        # --- threading lock held across await ------------------------
        if isinstance(node, ast.With):
            for item in node.items:
                name = dotted_name(item.context_expr)
                if name in lock_names and _contains_await(node):
                    yield ctx.finding(
                        LOCK_ACROSS_AWAIT.id,
                        node,
                        f"`with {name}:` is a threading lock held across "
                        f"`await` in `async def {fn.name}` — every other "
                        f"coroutine *and* thread blocks until resume; use "
                        f"`asyncio.Lock` or drop the lock before awaiting",
                    )

        # --- statement-level call checks ------------------------------
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            call = node.value
            name = dotted_name(call.func) or ""
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _TASK_SPAWNERS:
                yield ctx.finding(
                    FIRE_AND_FORGET.id,
                    node,
                    f"`{name}(...)` result discarded in "
                    f"`async def {fn.name}` — the task can be garbage-"
                    f"collected mid-flight and its exception is never "
                    f"observed; keep a reference and add a done-callback",
                )
            elif _is_local_coroutine_call(call, async_names):
                yield ctx.finding(
                    UNAWAITED_CORO.id,
                    node,
                    f"`{name}(...)` creates a coroutine that is never "
                    f"awaited in `async def {fn.name}` — the body never "
                    f"runs; add `await` (or wrap in `create_task` and "
                    f"keep the handle)",
                )


def _is_local_coroutine_call(call: ast.Call, async_names: set[str]) -> bool:
    func = call.func
    if isinstance(func, ast.Name):
        return func.id in async_names
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        # self.method() / cls.method() against an async def in this module
        if func.value.id in {"self", "cls"}:
            return func.attr in async_names
    return False


register_pass("async", run_async_pass)
