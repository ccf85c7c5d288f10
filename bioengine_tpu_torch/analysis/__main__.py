"""``python -m bioengine_tpu_torch.analysis`` — CLI for the static analyzer.

Exit codes: 0 clean (or all findings baselined/suppressed), 1 findings,
2 usage/internal error.  ``bioengine-torch analyze`` wraps this entry point.

The run is two-phase: phase 1 indexes every module in scope (process
pool via ``--jobs``, content-hash cache at ``--cache``), phase 2 runs
the cross-module rule families over the full fact base.  ``--changed``
narrows *module-local* reporting to edited files but still re-runs the
cross-module rules against the whole project — an unchanged module can
break a contract a changed one relied on.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from bioengine_tpu_torch.analysis import (
    Baseline,
    all_rules,
    analyze_project,
)
from bioengine_tpu_torch.analysis.baseline import (
    DEFAULT_BASELINE,
    TODO_JUSTIFICATION,
)
from bioengine_tpu_torch.analysis.project import DEFAULT_CACHE


def _git_changed_files(ref: str) -> list[Path] | None:
    """Tracked files changed vs ``ref`` plus untracked files, or None
    when git is unavailable (caller falls back to a full scan).

    git emits repo-root-relative names; anchor them at the toplevel so
    ``--changed`` works from any working directory, not just the root.
    """
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True,
            text=True,
            check=True,
            timeout=30,
        ).stdout.strip()
        diff = subprocess.run(
            ["git", "diff", "--name-only", "--diff-filter=ACMR", ref, "--"],
            capture_output=True,
            text=True,
            check=True,
            timeout=30,
            cwd=top,
        )
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            capture_output=True,
            text=True,
            check=True,
            timeout=30,
            cwd=top,  # --others is cwd-scoped: scope it to the whole repo
        )
    except (OSError, subprocess.SubprocessError):
        return None
    names = set(diff.stdout.splitlines()) | set(untracked.stdout.splitlines())
    return [Path(top) / n for n in sorted(names) if n.endswith(".py")]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m bioengine_tpu_torch.analysis",
        description=(
            "BioEngine whole-program linter: async-safety, CUDA-graph "
            "capture-safety, observability discipline, and "
            "distributed-contract drift"
        ),
    )
    p.add_argument(
        "paths",
        nargs="*",
        default=["bioengine_tpu_torch"],
        help="files/directories to scan (default: bioengine_tpu_torch)",
    )
    p.add_argument(
        "--baseline",
        type=Path,
        default=None,
        help=f"baseline file (default: {DEFAULT_BASELINE} when present)",
    )
    p.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore any baseline file",
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="record current findings into the baseline and exit 0",
    )
    p.add_argument(
        "--changed",
        nargs="?",
        const="HEAD",
        default=None,
        metavar="REF",
        help="report module-local findings only for files changed vs REF "
        "(default HEAD) + untracked, intersected with PATHS; "
        "cross-module rules still run over the full project "
        "(edited modules re-index, the rest come from the cache)",
    )
    p.add_argument(
        "--rule",
        action="append",
        default=None,
        metavar="RULE-ID",
        help="restrict to specific rule id(s); repeatable",
    )
    p.add_argument(
        "--format",
        choices=("text", "json", "sarif"),
        default="text",
    )
    p.add_argument(
        "--jobs",
        type=int,
        default=None,
        metavar="N",
        help="index worker processes (default: os.cpu_count())",
    )
    p.add_argument(
        "--cache",
        type=Path,
        default=DEFAULT_CACHE,
        metavar="FILE",
        help=f"module-index cache (default: {DEFAULT_CACHE}; "
        "content-hash keyed, safe to delete)",
    )
    p.add_argument(
        "--no-cache",
        action="store_true",
        help="ignore and don't write the index cache",
    )
    p.add_argument(
        "--stats",
        action="store_true",
        help="print indexing/evaluation wall time and cache hit counts "
        "to stderr",
    )
    p.add_argument(
        "--stats-json",
        type=Path,
        default=None,
        metavar="FILE",
        help="write machine-readable run stats (wall, cache hits, "
        "per-pass timings) as JSON — the CI perf-budget probe",
    )
    p.add_argument(
        "--hot-path-report",
        type=Path,
        default=None,
        metavar="FILE",
        help="write the BE-PERF-3xx hot-path overhead map (reachable "
        "functions ranked by finding count x call-graph depth) as JSON",
    )
    p.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule catalog and exit",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for r in all_rules():
            scope = "project" if r.project else "module"
            print(
                f"{r.id}  {r.slug:34s} [{r.pass_name}/{scope}] {r.summary}"
            )
        return 0

    if args.write_baseline and args.changed is not None:
        # --changed narrows the finding set; rebuilding the baseline
        # from it would silently drop (and lose the justifications of)
        # every entry for unchanged files
        print(
            "error: --write-baseline requires a full scan — "
            "drop --changed",
            file=sys.stderr,
        )
        return 2

    scan_paths = [Path(p) for p in args.paths]
    missing = [p for p in scan_paths if not p.exists()]
    if missing:
        print(
            f"error: no such path(s): {', '.join(map(str, missing))}",
            file=sys.stderr,
        )
        return 2

    report_paths: list[Path] | None = None
    if args.changed is not None:
        changed = _git_changed_files(args.changed)
        if changed is None:
            print(
                "warning: git unavailable, falling back to full scan",
                file=sys.stderr,
            )
        else:
            roots = [p.resolve() for p in scan_paths]
            report_paths = [
                f
                for f in changed
                if f.exists()
                and any(
                    f.resolve() == r or r in f.resolve().parents
                    for r in roots
                )
            ]

    rules = set(args.rule) if args.rule else None
    cache_path = None if args.no_cache else args.cache
    t0 = time.monotonic()
    findings, stats, ctx = analyze_project(
        scan_paths,
        root=Path.cwd(),
        report_paths=report_paths,
        rules=rules,
        jobs=args.jobs,
        cache_path=cache_path,
        return_context=True,
    )
    wall_s = time.monotonic() - t0

    if args.hot_path_report is not None:
        from bioengine_tpu_torch.analysis.hotpath_rules import (
            build_hot_path_report,
        )

        report = build_hot_path_report(ctx)
        args.hot_path_report.write_text(
            json.dumps(report, indent=2) + "\n", encoding="utf-8"
        )
        print(
            f"analyze: hot-path report -> {args.hot_path_report} "
            f"({report['totals']['roots']} roots, "
            f"{report['totals']['reachable_functions']} reachable, "
            f"{report['totals']['findings']} finding(s))",
            file=sys.stderr,
        )

    if args.stats:
        print(
            f"analyze: {stats.files_total} modules "
            f"({stats.files_indexed} indexed, {stats.files_cached} from "
            f"cache, jobs={stats.jobs}) — index {stats.wall_s:.2f}s, "
            f"total {wall_s:.2f}s",
            file=sys.stderr,
        )

    if args.stats_json is not None:
        args.stats_json.write_text(
            json.dumps(
                {
                    "schema": "bioengine.analyze-stats/v1",
                    "wall_s": round(wall_s, 4),
                    "index_wall_s": round(stats.wall_s, 4),
                    "files_total": stats.files_total,
                    "files_indexed": stats.files_indexed,
                    "files_cached": stats.files_cached,
                    "jobs": stats.jobs,
                    "passes": stats.pass_s,
                    "findings": len(findings),
                },
                indent=2,
            )
            + "\n",
            encoding="utf-8",
        )

    baseline_path = args.baseline or DEFAULT_BASELINE
    baseline = Baseline()
    if not args.no_baseline and baseline_path.exists():
        try:
            baseline = Baseline.load(baseline_path)
        except (OSError, json.JSONDecodeError) as e:
            print(f"error: bad baseline {baseline_path}: {e}", file=sys.stderr)
            return 2

    if args.write_baseline:
        baseline.update_from(findings)
        baseline.save(baseline_path)
        todo = sum(
            1
            for e in baseline.entries.values()
            if e["justification"] == TODO_JUSTIFICATION
        )
        print(
            f"wrote {len(baseline.entries)} finding(s) to {baseline_path}"
            + (f" — {todo} need a justification" if todo else "")
        )
        return 0

    new, stale = baseline.apply(findings)
    # --changed scans a subset of files, so absent baselined findings
    # are expected — only report staleness on a full scan.
    if stale and args.changed is None:
        print(
            f"warning: {len(stale)} stale baseline entr"
            f"{'y' if len(stale) == 1 else 'ies'} (fixed findings) — "
            f"prune with --write-baseline",
            file=sys.stderr,
        )

    if args.format == "json":
        print(
            json.dumps(
                [
                    {
                        "rule": f.rule,
                        "path": f.path,
                        "line": f.line,
                        "col": f.col,
                        "message": f.message,
                    }
                    for f in new
                ],
                indent=2,
            )
        )
    elif args.format == "sarif":
        from bioengine_tpu_torch.analysis.sarif import render_sarif

        print(json.dumps(render_sarif(new), indent=2))
    else:
        for f in new:
            print(f.render())
        suppressed = len(findings) - len(new)
        tail = f" ({suppressed} baselined)" if suppressed else ""
        print(
            f"analyze: {len(new)} finding(s){tail}"
            if new
            else f"analyze: clean{tail}"
        )
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
