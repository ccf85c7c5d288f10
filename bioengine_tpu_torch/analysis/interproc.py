"""Interprocedural async-safety pass (BE-ASYNC-006..008).

The module-local BE-ASYNC-001/005 rules stop at the coroutine's own
body: `await` a sync helper away and the blocking call disappears from
view.  This pass walks the phase-1 call graph (qualified names,
``self.``-method resolution, imported-module functions) so the hazards
that actually ship — a blocking call three sync frames below an
``async def``, a ``self.`` attribute racing between the event loop and
a worker thread — surface statically:

- BE-ASYNC-006 — a blocking call (file I/O, ``time.sleep``,
  ``subprocess``, bulk ``np.load``) reachable from an ``async def``
  *transitively* through sync callees, without ``to_thread`` or an
  executor hop anywhere on the path.  (Depth-limited DFS; edges created
  by handing a function reference to ``to_thread`` / ``run_in_executor``
  / ``Thread(target=...)`` / ``.submit`` are thread-context, not
  loop-context, and are not followed.)
- BE-ASYNC-007 — a ``self.`` attribute written both from event-loop
  context (an ``async def`` or a sync method it calls) and from a
  thread entry point (``to_thread`` callees, ``Thread`` targets,
  ``DispatchExecutor``/executor ``.submit`` functions), with neither
  write under a lock.  ``__init__``-time writes are construction
  (happens-before the loop and every thread) and don't count.
- BE-ASYNC-008 — a lock misused inside an ``async def``: a sync
  ``with`` on an ``asyncio.Lock``-family object (must be ``async
  with``), or a blocking ``.acquire()`` on a ``threading`` lock (parks
  the whole event loop behind a thread).
"""

from __future__ import annotations

from typing import Iterator, Optional

from bioengine_tpu_torch.analysis.core import (
    Finding,
    Rule,
    register_project_pass,
    register_rule,
)
from bioengine_tpu_torch.analysis.project import (
    ProjectContext,
    index_line_suppressed,
)

BLOCKING_REACHABLE = register_rule(
    Rule(
        "BE-ASYNC-006",
        "blocking-reachable-from-async",
        "Blocking call reachable from async def through sync callees",
        "async",
        project=True,
    )
)
UNLOCKED_SHARED_MUTATION = register_rule(
    Rule(
        "BE-ASYNC-007",
        "unlocked-loop-thread-mutation",
        "self attribute written from both event loop and thread entry "
        "point without a lock",
        "async",
        project=True,
    )
)
SYNC_LOCK_IN_ASYNC = register_rule(
    Rule(
        "BE-ASYNC-008",
        "sync-lock-acquire-in-async",
        "Lock acquired in async def via blocking `with`/.acquire() "
        "instead of `async with`",
        "async",
        project=True,
    )
)

_MAX_DEPTH = 12
_CONSTRUCTORS = {"__init__", "__post_init__", "__new__"}

# A `# bioengine: ignore[RULE]` on an *intermediate* call line (or the
# blocking line itself) prunes that edge from the reachability walk —
# the one place a path-insensitive analyzer can be taught "this branch
# only runs off-loop" (see flight._write_dump).
_line_suppressed = index_line_suppressed


def run_interproc_pass(ctx: ProjectContext) -> Iterator[Finding]:
    yield from _check_blocking_reachability(ctx)
    yield from _check_shared_mutation(ctx)
    yield from _check_lock_misuse(ctx)


# ---------------------------------------------------------------------------
# BE-ASYNC-006
# ---------------------------------------------------------------------------


def _first_blocking_chain(
    ctx: ProjectContext,
    idx: dict,
    fn: dict,
    depth: int,
    visiting: set[tuple[str, str]],
) -> Optional[list[str]]:
    """DFS through *sync* callees of ``fn`` for the first blocking
    call; returns the human-readable chain (names then the blocking
    callee) or None."""
    key = (idx["path"], fn["qualname"])
    if key in visiting or depth > _MAX_DEPTH:
        return None
    visiting.add(key)
    try:
        for name, line, _col in fn["blocking"]:
            if not _line_suppressed(idx, line, BLOCKING_REACHABLE.id):
                return [fn["qualname"], f"{name}()"]
        for ref, line, _col, kind in fn["calls"]:
            if kind != "call":
                continue
            if _line_suppressed(idx, line, BLOCKING_REACHABLE.id):
                continue
            resolved = _resolve_sync(ctx, idx, fn, ref)
            if resolved is None:
                continue
            callee_idx, callee = resolved
            chain = _first_blocking_chain(
                ctx, callee_idx, callee, depth + 1, visiting
            )
            if chain is not None:
                return [fn["qualname"]] + chain
        return None
    finally:
        visiting.discard(key)


def _resolve_sync(ctx, idx, fn, ref):
    resolved = ctx.resolve(idx, fn.get("cls"), ref)
    if resolved is None:
        return None
    callee_idx, callee = resolved
    if callee["is_async"] or callee["qualname"] == "<module>":
        return None
    if callee.get("is_generator"):
        # calling a generator function only builds the generator
        # object — its body (and any blocking call in it) runs at
        # iteration time, wherever that happens
        return None
    return callee_idx, callee


def _check_blocking_reachability(ctx: ProjectContext) -> Iterator[Finding]:
    for path, idx in sorted(ctx.modules.items()):
        for fn in idx["functions"].values():
            if not fn["is_async"]:
                continue
            reported: set[int] = set()
            for ref, line, col, kind in fn["calls"]:
                if kind != "call" or line in reported:
                    continue
                resolved = _resolve_sync(ctx, idx, fn, ref)
                if resolved is None:
                    continue
                callee_idx, callee = resolved
                chain = _first_blocking_chain(
                    ctx, callee_idx, callee, 1, {(path, fn["qualname"])}
                )
                if chain is None:
                    continue
                reported.add(line)
                pretty = " -> ".join(chain)
                yield ctx.finding(
                    BLOCKING_REACHABLE.id, path, line, col,
                    f"`{ref}()` called from `async def "
                    f"{fn['qualname']}` reaches a blocking call "
                    f"({pretty}) — the event loop stalls for its whole "
                    f"duration; hop off the loop with `await "
                    f"asyncio.to_thread(...)` or make the helper async",
                )


# ---------------------------------------------------------------------------
# BE-ASYNC-007
# ---------------------------------------------------------------------------


def _reachable(
    ctx: ProjectContext,
    roots: list[tuple[dict, dict]],
    *,
    follow_async: bool,
) -> set[tuple[str, str]]:
    """Transitive closure over ``call`` edges from ``roots``; returns
    {(path, qualname)}."""
    seen: set[tuple[str, str]] = set()
    stack = list(roots)
    while stack:
        idx, fn = stack.pop()
        key = (idx["path"], fn["qualname"])
        if key in seen:
            continue
        seen.add(key)
        for ref, _line, _col, kind in fn["calls"]:
            if kind != "call":
                continue
            resolved = ctx.resolve(idx, fn.get("cls"), ref)
            if resolved is None:
                continue
            callee_idx, callee = resolved
            if callee["is_async"] and not follow_async:
                continue
            stack.append((callee_idx, callee))
    return seen


def _check_shared_mutation(ctx: ProjectContext) -> Iterator[Finding]:
    # loop side: every async def plus the sync functions they call;
    # thread side: every function handed to a thread entry point plus
    # its sync callees
    loop_roots: list[tuple[dict, dict]] = []
    thread_roots: list[tuple[dict, dict]] = []
    for idx in ctx.modules.values():
        for fn in idx["functions"].values():
            if fn["is_async"]:
                loop_roots.append((idx, fn))
            for ref, _line, _col, kind in fn["calls"]:
                if kind != "thread":
                    continue
                resolved = ctx.resolve(idx, fn.get("cls"), ref)
                if resolved is not None:
                    thread_roots.append(resolved)

    if not thread_roots:
        return

    loop_side = _reachable(ctx, loop_roots, follow_async=True)
    thread_side = _reachable(ctx, thread_roots, follow_async=False)

    # collect per-(module, class, attr) write sites on each side
    for path, idx in sorted(ctx.modules.items()):
        by_attr: dict[tuple[str, str], dict[str, list]] = {}
        for fn in idx["functions"].values():
            cls = fn.get("cls")
            if cls is None:
                continue
            name = fn["qualname"].rsplit(".", 1)[-1]
            if name in _CONSTRUCTORS:
                continue
            key = (path, fn["qualname"])
            on_loop = key in loop_side
            on_thread = key in thread_side
            if not (on_loop or on_thread):
                continue
            for attr, line, col, locked in fn["writes"]:
                # a locked write is itself safe, but it must not
                # amnesty an unlocked loop/thread pair elsewhere in
                # the class — only UNLOCKED writes count as race sites
                if locked:
                    continue
                rec = by_attr.setdefault(
                    (cls, attr), {"loop": [], "thread": []}
                )
                if on_loop:
                    rec["loop"].append((fn["qualname"], line, col))
                if on_thread:
                    rec["thread"].append((fn["qualname"], line, col))
        for (cls, attr), rec in sorted(by_attr.items()):
            if not rec["loop"] or not rec["thread"]:
                continue
            t_fn, t_line, t_col = rec["thread"][0]
            l_fn, l_line, _ = rec["loop"][0]
            yield ctx.finding(
                UNLOCKED_SHARED_MUTATION.id, path, t_line, t_col,
                f"`self.{attr}` is written here in thread context "
                f"(`{t_fn}`, reachable from a thread entry point) AND "
                f"on the event loop (`{l_fn}` at line {l_line}) with no "
                f"lock around either write — guard both sides with a "
                f"lock or confine the attribute to one context",
            )


# ---------------------------------------------------------------------------
# BE-ASYNC-008
# ---------------------------------------------------------------------------


def _check_lock_misuse(ctx: ProjectContext) -> Iterator[Finding]:
    for path, idx in sorted(ctx.modules.items()):
        async_locks = set(idx["async_lock_names"])
        for fn in idx["functions"].values():
            if not fn["is_async"]:
                continue
            for ref, line, col, is_async_with, _has_await in fn["withs"]:
                if not is_async_with and ref in async_locks:
                    yield ctx.finding(
                        SYNC_LOCK_IN_ASYNC.id, path, line, col,
                        f"`with {ref}:` in `async def {fn['qualname']}` "
                        f"uses a blocking context manager on an asyncio "
                        f"lock — it raises (or deadlocks) at runtime; "
                        f"use `async with {ref}:`",
                    )
            for ref, line, col in fn["acquires"]:
                yield ctx.finding(
                    SYNC_LOCK_IN_ASYNC.id, path, line, col,
                    f"`{ref}.acquire()` in `async def {fn['qualname']}` "
                    f"blocks the event loop until the threading lock "
                    f"frees — every coroutine stalls behind it; use "
                    f"`asyncio.Lock` (`async with`) or hop the critical "
                    f"section off the loop",
                )


register_project_pass("interproc", run_interproc_pass)
