"""AST-walker framework: rule registry, module context, suppressions.

A *pass* is a function ``(ModuleContext) -> Iterable[Finding]`` that
implements one family of rules in a single AST walk (collecting shared
facts like "which functions are captured" once, instead of once per
rule).  Rules are metadata records in a registry; passes tag each
finding with the id of the rule that produced it, and the framework
filters findings through suppression comments before reporting.

Suppression grammar (documented in docs/static-analysis.md):

- ``# bioengine: ignore[RULE-ID]`` on the flagged line — or on a
  comment-only line directly above it — suppresses that finding.
  ``# bioengine: ignore`` (no bracket) suppresses every rule on that
  line; multiple ids separate with commas.
- ``# bioengine: ignore-file[RULE-ID]`` on any comment-only line
  suppresses the rule for the whole file.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional, Sequence


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int  # 1-based
    col: int  # 0-based
    message: str
    source_line: str = ""  # stripped text of the flagged line

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


@dataclass(frozen=True)
class Rule:
    id: str
    slug: str
    summary: str
    pass_name: str  # "async" | "graph" | "obs" | "dist"
    # project rules run in phase 2 over the whole-program index
    # (project.ProjectContext), not per-module AST walks
    project: bool = False


@dataclass
class ModuleContext:
    path: str
    source: str
    tree: ast.Module
    lines: list[str] = field(default_factory=list)

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        text = self.lines[line - 1].strip() if 0 < line <= len(self.lines) else ""
        return Finding(rule, self.path, line, col, message, text)


PassFn = Callable[[ModuleContext], Iterable[Finding]]
# a project pass receives a project.ProjectContext (typed loosely here
# to avoid a circular import with the index module)
ProjectPassFn = Callable[[object], Iterable[Finding]]

_RULES: dict[str, Rule] = {}
_PASSES: dict[str, PassFn] = {}
_PROJECT_PASSES: dict[str, ProjectPassFn] = {}


def register_rule(rule: Rule) -> Rule:
    if rule.id in _RULES:
        raise ValueError(f"duplicate rule id {rule.id}")
    _RULES[rule.id] = rule
    return rule


def register_pass(name: str, fn: PassFn) -> None:
    _PASSES[name] = fn


def register_project_pass(name: str, fn: ProjectPassFn) -> None:
    _PROJECT_PASSES[name] = fn


def project_passes() -> dict[str, ProjectPassFn]:
    return dict(_PROJECT_PASSES)


def all_rules() -> list[Rule]:
    return sorted(_RULES.values(), key=lambda r: r.id)


def get_rule(rule_id: str) -> Rule:
    return _RULES[rule_id]


# ---------------------------------------------------------------------------
# Suppression comments
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*bioengine:\s*(ignore-file|ignore)\s*(?:\[([^\]]*)\])?"
)


def _parse_suppressions(lines: Sequence[str]):
    """-> (per-line {lineno: set(ids) | None}, file-wide set(ids)).

    ``None`` in the per-line map means "all rules".  A comment-only
    line's suppression also applies to the next line, so an ignore can
    sit above a long statement instead of pushing it past the line
    width.
    """
    per_line: dict[int, Optional[set[str]]] = {}
    file_wide: set[str] = set()

    def merge(lineno: int, ids: Optional[set[str]]) -> None:
        if lineno in per_line and per_line[lineno] is None:
            return
        if ids is None:
            per_line[lineno] = None
        else:
            per_line.setdefault(lineno, set()).update(ids)  # type: ignore[union-attr]

    for i, raw in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(raw)
        if not m:
            continue
        kind, id_list = m.group(1), m.group(2)
        ids: Optional[set[str]] = None
        if id_list is not None:
            ids = {s.strip() for s in id_list.split(",") if s.strip()}
        comment_only = raw.lstrip().startswith("#")
        if kind == "ignore-file":
            if comment_only:
                file_wide.update(ids or set())
            continue
        merge(i, ids)
        if comment_only:
            merge(i + 1, ids)
    return per_line, file_wide


def _suppressed(f: Finding, per_line, file_wide) -> bool:
    if f.rule in file_wide:
        return True
    if f.line in per_line:
        ids = per_line[f.line]
        return ids is None or f.rule in ids
    return False


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def analyze_source(
    source: str,
    path: str = "<string>",
    rules: Optional[set[str]] = None,
) -> list[Finding]:
    """Run every registered pass over one module's source.

    ``rules`` restricts reporting to the given rule ids (used by tests
    to exercise one rule at a time).  Returns findings sorted by
    position, with suppression comments already applied.
    """
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [
            Finding(
                "BE-PARSE-000",
                path,
                e.lineno or 1,
                e.offset or 0,
                f"syntax error: {e.msg}",
            )
        ]
    lines = source.splitlines()
    ctx = ModuleContext(path=path, source=source, tree=tree, lines=lines)
    out = run_module_passes(ctx, rules=rules)
    out.sort(key=lambda f: (f.line, f.col, f.rule))
    return out


def run_module_passes(
    ctx: ModuleContext, rules: Optional[set[str]] = None
) -> list[Finding]:
    """Every per-module pass over an already-parsed module, with
    suppression comments applied.  The project indexer reuses this so
    one parse serves both phase-1 indexing and the module rules."""
    per_line, file_wide = _parse_suppressions(ctx.lines)
    out: list[Finding] = []
    for fn in _PASSES.values():
        for f in fn(ctx):
            if rules is not None and f.rule not in rules:
                continue
            if _suppressed(f, per_line, file_wide):
                continue
            out.append(f)
    return out


def analyze_file(path: Path, rules: Optional[set[str]] = None) -> list[Finding]:
    try:
        source = path.read_text(encoding="utf-8")
    except (OSError, UnicodeDecodeError) as e:
        return [Finding("BE-IO-000", str(path), 1, 0, f"unreadable: {e}")]
    return analyze_source(source, str(path), rules=rules)


_SKIP_DIRS = {
    ".git",
    "__pycache__",
    "build",
    "node_modules",
    ".venv",
    "venv",
    ".eggs",
}


def iter_python_files(paths: Iterable[Path]) -> Iterator[Path]:
    for p in paths:
        if p.is_file():
            if p.suffix == ".py":
                yield p
            continue
        if not p.is_dir():
            continue
        for sub in sorted(p.rglob("*.py")):
            if any(part in _SKIP_DIRS for part in sub.parts):
                continue
            yield sub


def analyze_paths(
    paths: Iterable[Path], rules: Optional[set[str]] = None
) -> list[Finding]:
    out: list[Finding] = []
    for f in iter_python_files(paths):
        out.extend(analyze_file(f, rules=rules))
    return out


# ---------------------------------------------------------------------------
# Shared AST helpers (used by both rule passes)
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def names_in(node: ast.AST) -> set[str]:
    """All bare Name identifiers referenced anywhere under ``node``."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
