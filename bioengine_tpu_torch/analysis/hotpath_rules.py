"""Hot-path cost pass (BE-PERF-3xx): µs-budget discipline, machine-checked.

ROADMAP item 3 sets a per-request CPU budget (<100 µs router-side);
every PR so far has hand-fixed the same cost classes instead of
banning them — uuid4 call ids (~40 µs of ``os.urandom`` syscall per
mint), per-call ``os.environ`` reads, per-call labeled-metric child
lookups.  This pass makes the budget a rule: declare the request-path
**roots**, compute everything reachable from them through the phase-1
call graph, and flag per-request costs inside that set.

Roots come from two places:

- the checked-in catalog below (``DeploymentHandle.call``, scheduler
  submit/dispatch, ``Replica.call``/``call_batch``, rpc
  encode/decode/dispatch, ``engine.predict``), and
- a ``# analyze: hot-path-root`` comment on a ``def`` line (or the
  line directly above it) — how new request paths opt in without
  editing the analyzer.

Rules (all findings are sited at the cost, with the nearest root and
call-graph depth in the message):

- BE-PERF-301 — an uncached ``os.environ``/``os.getenv`` read.  Reads
  inside an ``if x is None:`` memoization miss-branch are cached reads
  and don't count (the ``metrics_enabled()`` idiom).
- BE-PERF-302 — ``uuid4``/``os.urandom``/``secrets.*`` entropy per
  call.  Request ids need uniqueness, not crypto randomness:
  ``random.getrandbits`` is ~40 µs cheaper per mint.
- BE-PERF-303 — a chained ``FAMILY.labels(...).inc()``: a labeled-
  child lookup (str()/tuple/lock) per call instead of a child cached
  at construction.
- BE-PERF-304 — ``re.compile`` per call instead of a module-level
  constant.
- BE-PERF-305 — an eagerly-formatted ``log.debug(f"...")`` (or ``%``/
  ``.format``) without an ``isEnabledFor`` guard: the formatting runs
  on every request even when DEBUG is off; use lazy ``%s`` args or
  guard the call.

``analyze --hot-path-report FILE`` emits a JSON artifact ranking every
reachable function by finding count × call-graph depth — the starting
map for the ``request_overhead`` bench (docs/performance.md).
"""

from __future__ import annotations

from typing import Iterator

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

UNCACHED_ENV_READ = register_rule(
    Rule(
        "BE-PERF-301",
        "hot-path-env-read",
        "os.environ read per request on the hot path (cache it once)",
        "perf",
        project=True,
    )
)
ENTROPY_PER_CALL = register_rule(
    Rule(
        "BE-PERF-302",
        "hot-path-entropy",
        "uuid4/os.urandom/secrets entropy syscall per request",
        "perf",
        project=True,
    )
)
LABELS_PER_CALL = register_rule(
    Rule(
        "BE-PERF-303",
        "hot-path-metric-child-lookup",
        "Labeled-metric child resolved per call instead of cached at "
        "construction",
        "perf",
        project=True,
    )
)
REGEX_PER_CALL = register_rule(
    Rule(
        "BE-PERF-304",
        "hot-path-regex-compile",
        "re.compile per request instead of a module-level pattern",
        "perf",
        project=True,
    )
)
EAGER_DEBUG_LOG = register_rule(
    Rule(
        "BE-PERF-305",
        "hot-path-eager-debug-log",
        "Eagerly-formatted log.debug without a level guard on the hot "
        "path",
        "perf",
        project=True,
    )
)

_KIND_TO_RULE = {
    "env": UNCACHED_ENV_READ.id,
    "entropy": ENTROPY_PER_CALL.id,
    "relabel": LABELS_PER_CALL.id,
    "recompile": REGEX_PER_CALL.id,
    "logdebug": EAGER_DEBUG_LOG.id,
}

# The checked-in request-path root catalog.  Matching is by dotted
# module name (exact, or suffix behind a dot, so scans rooted above the
# repo still resolve).  Extend at the code side with a
# `# analyze: hot-path-root` marker, not here, unless the root is a
# permanent architectural entry point.
HOT_PATH_ROOT_CATALOG: tuple[tuple[str, str], ...] = (
    ("bioengine_tpu_torch.serving.router", "DeploymentHandle.call"),
    ("bioengine_tpu_torch.serving.router", "StandaloneRouter.apply_table"),
    ("bioengine_tpu_torch.serving.scheduler", "DeploymentScheduler.submit"),
    ("bioengine_tpu_torch.serving.scheduler", "DeploymentScheduler._dispatch_group"),
    ("bioengine_tpu_torch.serving.replica", "Replica.call"),
    ("bioengine_tpu_torch.serving.replica", "Replica.call_batch"),
    ("bioengine_tpu_torch.serving.remote", "RemoteReplica.call"),
    ("bioengine_tpu_torch.serving.remote", "RemoteReplica.call_batch"),
    ("bioengine_tpu_torch.serving.batching", "ContinuousBatcher.submit"),
    ("bioengine_tpu_torch.rpc.protocol", "encode"),
    ("bioengine_tpu_torch.rpc.protocol", "decode"),
    ("bioengine_tpu_torch.rpc.protocol", "encode_oob"),
    ("bioengine_tpu_torch.rpc.protocol", "decode_oob"),
    ("bioengine_tpu_torch.rpc.client", "ServerConnection.call"),
    ("bioengine_tpu_torch.rpc.server", "RpcServer._dispatch"),
    ("bioengine_tpu_torch.rpc.server", "RpcServer.call_service_method"),
    ("bioengine_tpu_torch.runtime.engine", "InferenceEngine.predict"),
    # token streaming: the per-token send path and the per-step decode
    # loop run once per generated token / batched forward — the
    # tightest loops the serving tier owns
    ("bioengine_tpu_torch.serving.router", "DeploymentHandle.call_stream"),
    ("bioengine_tpu_torch.serving.decode", "DecodeLoop._run"),
    ("bioengine_tpu_torch.runtime.decode_engine", "DecodeEngine.step"),
    ("bioengine_tpu_torch.rpc.server", "RpcServer._send_stream_item"),
    ("bioengine_tpu_torch.rpc.client", "ServerConnection._send_stream_item"),
)

_ADVICE = {
    "env": (
        "read it once at import/construction time and cache the parsed "
        "value (the `_cached_env` / `metrics_enabled()` idiom)"
    ),
    "entropy": (
        "request/call ids need uniqueness, not crypto randomness — "
        "mint with `random.getrandbits` (~40 us cheaper per id; see "
        "utils/tracing._new_id)"
    ),
    "relabel": (
        "resolve the labeled child once at construction "
        "(`self._m_x = FAMILY.labels(...)`) or memoize per dynamic "
        "label (`child = self._m[k] = FAMILY.labels(...)` on miss)"
    ),
    "recompile": "hoist the pattern to a module-level constant",
    "logdebug": (
        "use lazy `%s` args (`log.debug(\"x %s\", v)`) or guard with "
        "`log.isEnabledFor(logging.DEBUG)` — the f-string renders on "
        "every request even with DEBUG off"
    ),
}


def _module_matches(module: str, catalog_module: str) -> bool:
    return module == catalog_module or module.endswith(
        "." + catalog_module
    )


def collect_roots(
    ctx: ProjectContext,
) -> list[tuple[dict, dict, str]]:
    """-> [(module_index, function_facts, origin)] where origin is
    ``"catalog"`` or ``"marker"``."""
    roots: list[tuple[dict, dict, str]] = []
    seen: set[tuple[str, str]] = set()
    for _path, idx in sorted(ctx.modules.items()):
        mod = idx["module"]
        for cat_mod, qual in HOT_PATH_ROOT_CATALOG:
            if _module_matches(mod, cat_mod):
                fn = idx["functions"].get(qual)
                key = (idx["path"], qual)
                if fn is not None and key not in seen:
                    seen.add(key)
                    roots.append((idx, fn, "catalog"))
        for qual in idx.get("hot_path_roots", ()):
            fn = idx["functions"].get(qual)
            key = (idx["path"], qual)
            if fn is not None and key not in seen:
                seen.add(key)
                roots.append((idx, fn, "marker"))
    return roots


def reachable_set(
    ctx: ProjectContext, roots: list[tuple[dict, dict, str]]
) -> dict[tuple[str, str], tuple[int, str, dict, dict]]:
    """BFS over call/thread edges.  Depth 1 at each root; ties keep the
    shallowest path.  -> {(path, qualname): (depth, root_qual, idx, fn)}
    """
    out: dict[tuple[str, str], tuple[int, str, dict, dict]] = {}
    frontier: list[tuple[dict, dict, int, str]] = [
        (idx, fn, 1, fn["qualname"]) for idx, fn, _origin in roots
    ]
    while frontier:
        nxt: list[tuple[dict, dict, int, str]] = []
        for idx, fn, depth, root in frontier:
            key = (idx["path"], fn["qualname"])
            if key in out:
                continue
            out[key] = (depth, root, idx, fn)
            for ref, _line, _col, kind in fn["calls"]:
                if kind not in {"call", "thread"}:
                    continue
                resolved = ctx.resolve(idx, fn.get("cls"), ref)
                if resolved is None:
                    continue
                callee_idx, callee = resolved
                if callee["qualname"] == "<module>":
                    continue
                ckey = (callee_idx["path"], callee["qualname"])
                if ckey not in out:
                    nxt.append((callee_idx, callee, depth + 1, root))
        frontier = nxt
    return out


def run_hotpath_pass(ctx: ProjectContext) -> Iterator[Finding]:
    roots = collect_roots(ctx)
    if not roots:
        return
    reach = reachable_set(ctx, roots)
    for (path, qual), (depth, root, idx, fn) in sorted(reach.items()):
        for kind, detail, line, col in fn["perf"]:
            rule = _KIND_TO_RULE.get(kind)
            if rule is None:
                continue
            what = {
                "env": f"`os.environ` read ({detail})",
                "entropy": f"`{detail}()` entropy syscall",
                "relabel": f"`{detail}.labels(...)` child lookup",
                "recompile": "`re.compile(...)`",
                "logdebug": f"eagerly-formatted `{detail}.debug(...)`",
            }[kind]
            yield ctx.finding(
                rule, path, line, col,
                f"{what} runs per request in `{qual}` — on the request "
                f"hot path (reachable from root `{root}`, depth "
                f"{depth}); {_ADVICE[kind]}",
            )


# ---------------------------------------------------------------------------
# --hot-path-report artifact
# ---------------------------------------------------------------------------

REPORT_SCHEMA = "bioengine.hot-path-report/v1"


def build_hot_path_report(ctx: ProjectContext) -> dict:
    """The overhead map: every function reachable from a request-path
    root, ranked by unsuppressed finding count × call-graph depth.
    Consumed by docs/performance.md as the starting point for the
    ROADMAP item 3 ``request_overhead`` bench."""
    roots = collect_roots(ctx)
    reach = reachable_set(ctx, roots)
    functions = []
    total_findings = 0
    for (path, qual), (depth, root, idx, fn) in reach.items():
        rules: dict[str, int] = {}
        for kind, _detail, line, _col in fn["perf"]:
            rule = _KIND_TO_RULE.get(kind)
            if rule is None or index_line_suppressed(idx, line, rule):
                continue
            rules[rule] = rules.get(rule, 0) + 1
        count = sum(rules.values())
        total_findings += count
        functions.append(
            {
                "qualname": qual,
                "path": path,
                "line": fn["lineno"],
                "depth": depth,
                "root": root,
                "findings": count,
                "rules": dict(sorted(rules.items())),
                "score": count * depth,
            }
        )
    functions.sort(
        key=lambda f: (-f["score"], -f["findings"], f["path"], f["qualname"])
    )
    return {
        "schema": REPORT_SCHEMA,
        "roots": [
            {
                "qualname": fn["qualname"],
                "path": idx["path"],
                "line": fn["lineno"],
                "origin": origin,
            }
            for idx, fn, origin in roots
        ],
        "functions": functions,
        "totals": {
            "roots": len(roots),
            "reachable_functions": len(reach),
            "findings": total_findings,
        },
    }


register_project_pass("hotpath", run_hotpath_pass)
