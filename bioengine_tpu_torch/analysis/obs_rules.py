"""Observability pass (BE-OBS-*): telemetry-correctness hazards.

The tracing/metrics plane promises that every recorded duration is a
*monotonic* delta — wall-clock ``time.time()`` deltas jump when NTP
slews or steps the clock, which turns latency histograms and span
durations into lies precisely during the incidents operators read
them for.  BE-OBS-001 flags wall-clock subtraction used as a duration.

Wall time is still correct for *absolute* timestamps (``started_at``
fields, token expiry deadlines, display ages cross-referenced against
logged wall times); those sites suppress with
``# bioengine: ignore[BE-OBS-001]`` and a justification, like any
other rule.

BE-OBS-002 flags the other way telemetry lies: a broad exception
handler (bare ``except:``, ``except Exception:``,
``except BaseException:``) whose entire body is ``pass`` — the failure
happened, left no log line, no flight-recorder event, no re-raise, and
the postmortem reads "everything was fine". Narrow handlers
(``except OSError: pass``) stay legal: catching a *specific* expected
condition and ignoring it is a decision the type spells out. Broad
silent swallows that are genuinely deliberate (close-paths racing a
peer's teardown) get a baseline entry with a justification.
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

WALL_CLOCK_DURATION = register_rule(
    Rule(
        "BE-OBS-001",
        "wall-clock-duration",
        "time.time() subtraction used as a duration — use time.monotonic()",
        "obs",
    )
)

SILENT_SWALLOW = register_rule(
    Rule(
        "BE-OBS-002",
        "silent-swallow",
        "broad except whose body is only `pass` — swallows without "
        "logging or re-raising",
        "obs",
    )
)

_WALL_CALLS = {"time.time"}

# handler types broad enough that silently discarding them hides bugs;
# a narrow type (OSError, StopIteration, asyncio.TimeoutError) names
# the expected condition and may be ignored deliberately
_BROAD_EXC = {"Exception", "BaseException", "builtins.Exception",
              "builtins.BaseException"}


def _body_is_only_pass(body: list[ast.stmt]) -> bool:
    """True when the handler does literally nothing: ``pass`` and/or
    bare ``...`` statements only (a docstring or log call disqualifies)."""
    for stmt in body:
        if isinstance(stmt, ast.Pass):
            continue
        if (
            isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Constant)
            and stmt.value.value is Ellipsis
        ):
            continue
        return False
    return True


def _iter_silent_swallows(tree: ast.Module) -> Iterator[ast.ExceptHandler]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _body_is_only_pass(node.body):
            continue
        if node.type is None:  # bare `except:` — broader than broad
            yield node
            continue
        types = (
            node.type.elts
            if isinstance(node.type, ast.Tuple)
            else [node.type]
        )
        if any(dotted_name(t) in _BROAD_EXC for t in types):
            yield node


def _is_wall_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and dotted_name(node.func) in _WALL_CALLS


def _collect_wall_names(tree: ast.Module) -> set[str]:
    """Names (``t0``, ``self.started_at``) bound to ``time.time()``."""
    names: set[str] = set()
    for node in ast.walk(tree):
        targets: list[ast.AST] = []
        if isinstance(node, ast.Assign) and _is_wall_call(node.value):
            targets = list(node.targets)
        elif (
            isinstance(node, ast.AnnAssign)
            and node.value is not None
            and _is_wall_call(node.value)
        ):
            targets = [node.target]
        for target in targets:
            name = dotted_name(target)
            if name:
                names.add(name)
    return names


def run_obs_pass(ctx: ModuleContext) -> Iterator[Finding]:
    wall_names = _collect_wall_names(ctx.tree)

    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)):
            continue
        left, right = node.left, node.right
        left_wall = _is_wall_call(left)
        right_wall = _is_wall_call(right)
        left_name = dotted_name(left) in wall_names
        right_name = dotted_name(right) in wall_names
        # ``time.time() - 3600`` computes a *timestamp* (an hour ago),
        # not a duration — a constant operand never flags.
        if isinstance(left, ast.Constant) or isinstance(right, ast.Constant):
            continue
        # A direct ``time.time()`` on either side of a subtraction is a
        # duration in practice (``time.time() - started``); for two
        # *names* both must be bound to time.time() in this module
        # (precision beats recall for a CI-blocking gate).
        if (left_wall or right_wall) or (left_name and right_name):
            yield ctx.finding(
                WALL_CLOCK_DURATION.id,
                node,
                "wall-clock duration: `time.time()` deltas jump under "
                "NTP slew — measure with `time.monotonic()` and keep "
                "wall time only for displayed timestamps",
            )

    for handler in _iter_silent_swallows(ctx.tree):
        yield ctx.finding(
            SILENT_SWALLOW.id,
            handler,
            "broad exception swallowed silently: log it (at least "
            "debug), record a flight event, re-raise, or narrow the "
            "type — a deliberate swallow needs a baseline justification",
        )


register_pass("obs", run_obs_pass)
