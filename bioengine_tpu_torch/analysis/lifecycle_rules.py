"""Resource-lifecycle contract pass (BE-LIFE-4xx): leak-free undeploy,
machine-checked.

The same bug was fixed four separate times by hand: a
controller/scheduler/handle-level dict keyed by app/deployment/replica
gains an insert site, and the ``undeploy``/``close`` sweep misses it —
the entry (and whatever it pins: handles, breakers, metrics children,
inflight maps) outlives the deployment.  This pass turns that review
knowledge into rules over the phase-1 fact base:

- BE-LIFE-401 — a ``self.X`` attribute declared mapping-shaped
  (``self.X = {}`` / ``dict()`` / ``defaultdict(...)``) with a keyed
  insert site (``self.X[key] = ...`` / ``setdefault``) in a class that
  HAS a close-path method, but no sweep (``pop``/``del``/``clear``/
  whole-map reset) reachable from any close-path method or from the
  inserting function itself (self-bounding caches pass).
- BE-LIFE-402 — a ``spawn_supervised``/``create_task`` handle stored
  on ``self`` with no ``.cancel()`` reachable from any close-path
  method (or no close-path method at all).
- BE-LIFE-403 — a ``threading``/asyncio lock or semaphore
  ``.acquire()`` that is not exception-safe: no ``release()`` in a
  ``finally`` on any path through the function.  A function that never
  releases but hands the permit to another function in the module
  (release elsewhere) is treated as a deliberate handoff and skipped —
  ``with lock:`` is always clean.

Close-path methods are matched by name: any underscore-separated part
of the method name equal to one of ``close``/``stop``/``shutdown``/
``undeploy``/``terminate``/``drain``/``disconnect``/``teardown``/
``cleanup``/``aclose``/``exit``/``aexit``/``finalize``/``destroy``/
``unregister``/``deregister``/``delete`` (so ``stop_accepting``,
``__aexit__``, ``unregister_service``, ``delete_session`` all count —
a per-entry deregistration API is a close path for its entries).

Reachability runs over the same interprocedural call graph as the
BE-ASYNC and BE-PERF passes (``ProjectContext.resolve``), so a sweep
delegated through a helper still counts.
"""

from __future__ import annotations

from typing import Iterator, Optional

from bioengine_tpu_torch.analysis.core import (
    Finding,
    Rule,
    register_project_pass,
    register_rule,
)
from bioengine_tpu_torch.analysis.project import ProjectContext

UNSWEPT_REGISTRY = register_rule(
    Rule(
        "BE-LIFE-401",
        "unswept-keyed-registry",
        "Keyed mapping on self has insert sites but no sweep reachable "
        "from any close-path method",
        "lifecycle",
        project=True,
    )
)
UNCANCELLED_TASK = register_rule(
    Rule(
        "BE-LIFE-402",
        "uncancelled-supervised-task",
        "Supervised task handle on self is never cancelled on any "
        "close path",
        "lifecycle",
        project=True,
    )
)
UNBALANCED_ACQUIRE = register_rule(
    Rule(
        "BE-LIFE-403",
        "unbalanced-semaphore-acquire",
        "Lock/semaphore acquire without an exception-safe release on "
        "all paths through the function",
        "lifecycle",
        project=True,
    )
)

_CLOSE_BASES = {
    "close", "aclose", "stop", "shutdown", "undeploy", "terminate",
    "drain", "disconnect", "teardown", "cleanup", "exit", "aexit",
    "finalize", "destroy", "unregister", "deregister", "delete",
}

_CONSTRUCTORS = {"__init__", "__post_init__", "__new__"}


def _leaf(fn: dict) -> str:
    return fn["qualname"].rsplit(".", 1)[-1]


def is_close_path_name(name: str) -> bool:
    norm = name.strip("_").lower()
    if norm in _CLOSE_BASES:
        return True
    return any(part in _CLOSE_BASES for part in norm.split("_"))


def _closure(
    ctx: ProjectContext, idx: dict, fn: dict,
    cache: dict[tuple[str, str], dict],
) -> dict[tuple[str, str], tuple[dict, dict]]:
    """Everything reachable from ``fn`` over call/thread edges,
    including ``fn`` itself.  -> {(path, qualname): (idx, fn)}"""
    root_key = (idx["path"], fn["qualname"])
    hit = cache.get(root_key)
    if hit is not None:
        return hit
    out: dict[tuple[str, str], tuple[dict, dict]] = {}
    stack = [(idx, fn)]
    while stack:
        i, f = stack.pop()
        key = (i["path"], f["qualname"])
        if key in out:
            continue
        out[key] = (i, f)
        for ref, _line, _col, kind in f["calls"]:
            if kind not in {"call", "thread"}:
                continue
            resolved = ctx.resolve(i, f.get("cls"), ref)
            if resolved is None:
                continue
            ci, cf = resolved
            if cf["qualname"] == "<module>":
                continue
            if (ci["path"], cf["qualname"]) not in out:
                stack.append((ci, cf))
    cache[root_key] = out
    return out


def _class_facts(idx: dict) -> dict[str, list[dict]]:
    by_cls: dict[str, list[dict]] = {}
    for fn in idx["functions"].values():
        cls = fn.get("cls")
        if cls:
            by_cls.setdefault(cls, []).append(fn)
    return by_cls


def run_lifecycle_pass(ctx: ProjectContext) -> Iterator[Finding]:
    closure_cache: dict[tuple[str, str], dict] = {}
    for path, idx in sorted(ctx.modules.items()):
        dict_attrs: dict[str, set[str]] = {}
        for cls, attr, _line, _col in idx.get("dict_attrs", ()):
            dict_attrs.setdefault(cls, set()).add(attr)

        for cls, fns in sorted(_class_facts(idx).items()):
            fns = sorted(fns, key=lambda f: f["lineno"])
            close_fns = [f for f in fns if is_close_path_name(_leaf(f))]
            close_names = sorted({_leaf(f) for f in close_fns})

            close_reach: dict[tuple[str, str], tuple[dict, dict]] = {}
            for cf in close_fns:
                close_reach.update(_closure(ctx, idx, cf, closure_cache))

            def _sweeps(reach: dict, attr: str) -> bool:
                return any(
                    i["path"] == path
                    and f.get("cls") == cls
                    and any(a == attr for a, _l, _c in f["map_sweeps"])
                    for i, f in reach.values()
                )

            # ---- 401: keyed insert with no reachable sweep ----------
            if close_fns:
                reported: set[str] = set()
                for fn in fns:
                    if _leaf(fn) in _CONSTRUCTORS:
                        continue
                    for attr, line, col in fn["map_inserts"]:
                        if attr in reported:
                            continue
                        if attr not in dict_attrs.get(cls, ()):
                            continue
                        if _sweeps(close_reach, attr):
                            reported.add(attr)
                            continue
                        # self-bounding caches: the inserting function
                        # (or anything it calls) evicts its own entries
                        if _sweeps(
                            _closure(ctx, idx, fn, closure_cache), attr
                        ):
                            reported.add(attr)
                            continue
                        reported.add(attr)
                        yield ctx.finding(
                            UNSWEPT_REGISTRY.id, path, line, col,
                            f"`self.{attr}` is a keyed registry on "
                            f"`{cls}` with an insert here in "
                            f"`{fn['qualname']}` but no sweep "
                            f"(pop/del/clear/reset) reachable from any "
                            f"close-path method "
                            f"({', '.join(close_names)}) — entries "
                            f"outlive undeploy (the PR 8/14 leak "
                            f"class); add the sweep to the close path",
                        )

            # ---- 402: supervised task handle never cancelled --------
            spawn_sites: dict[str, tuple[dict, int, int]] = {}
            for fn in fns:
                for attr, line, col in fn["task_spawns"]:
                    spawn_sites.setdefault(attr, (fn, line, col))
            if spawn_sites:
                cancelled: set[str] = {
                    a
                    for i, f in close_reach.values()
                    if i["path"] == path and f.get("cls") == cls
                    for a, _l, _c in f["task_cancels"]
                }
                for attr, (fn, line, col) in sorted(spawn_sites.items()):
                    if attr in cancelled:
                        continue
                    if close_fns:
                        detail = (
                            f"no `.cancel()` of `self.{attr}` is "
                            f"reachable from any close-path method "
                            f"({', '.join(close_names)})"
                        )
                    else:
                        detail = (
                            f"`{cls}` has no close-path method at all "
                            f"(close/stop/shutdown/...)"
                        )
                    yield ctx.finding(
                        UNCANCELLED_TASK.id, path, line, col,
                        f"supervised task handle `self.{attr}` spawned "
                        f"in `{fn['qualname']}` is never cancelled: "
                        f"{detail} — the task outlives its owner and "
                        f"keeps running against torn-down state",
                    )

        # ---- 403: acquire without exception-safe release ------------
        module_released: set[str] = set()
        for fn in idx["functions"].values():
            for base, _line, _col, _fin in fn["sem_releases"]:
                module_released.add(base)
        for fn in sorted(
            idx["functions"].values(), key=lambda f: f["lineno"]
        ):
            for base, line, col, protected in fn["sem_acquires"]:
                if protected:
                    continue
                releases = [
                    r for r in fn["sem_releases"] if r[0] == base
                ]
                if any(r[3] for r in releases):
                    # released in a finally somewhere in this function
                    continue
                if releases:
                    why = (
                        f"`{base}.release()` exists in "
                        f"`{fn['qualname']}` but not in a `finally` — "
                        f"an exception between acquire and release "
                        f"leaks the permit"
                    )
                elif base in module_released:
                    # deliberate handoff: another function in this
                    # module releases the permit (dispatch/on-done
                    # pairs) — pairing across functions is the
                    # interprocedural rules' job, not a leak here
                    continue
                else:
                    why = (
                        f"nothing in this module ever releases "
                        f"`{base}` — the permit can never be returned"
                    )
                yield ctx.finding(
                    UNBALANCED_ACQUIRE.id, path, line, col,
                    f"`{base}.acquire()` without an exception-safe "
                    f"release: {why}; use `with {base}:` or a "
                    f"try/finally release",
                )


register_project_pass("lifecycle", run_lifecycle_pass)
