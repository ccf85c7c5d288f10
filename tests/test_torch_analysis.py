"""The port's static analyzer (``bioengine_tpu_torch.analysis``): the JAX
analyzer's tests run against the port's modules, and the port held to the
JAX analyzer's output on the same inputs.

Every rule family but one does not depend on the language (async, obs,
dist, perf, lifecycle): on the JAX fixtures, on ``proj_demo`` and on the
port's own tree both analyzers give the same findings, finding for
finding. The JAX family (BE-JAX-101..105) is swapped for the capture
rules (BE-GRAPH-101..105), seeded in ``tests/torch_analysis_fixtures/``;
the JAX fixture directory is read in place and never written."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from _torch_parity import few_torch_threads  # noqa: F401
from bioengine_tpu import analysis as jax_analysis
from bioengine_tpu.analysis import baseline as jax_baseline
from bioengine_tpu.analysis import hotpath_rules as jax_hotpath
from bioengine_tpu.analysis import sarif as jax_sarif
from bioengine_tpu_torch.analysis import (
    Baseline,
    all_rules,
    analyze_file,
    analyze_project,
    analyze_source,
    fingerprint,
)
from bioengine_tpu_torch.analysis import capture_rules
from bioengine_tpu_torch.analysis.__main__ import build_parser
from bioengine_tpu_torch.analysis.__main__ import main as analysis_main
from bioengine_tpu_torch.analysis.baseline import DEFAULT_BASELINE, TODO_JUSTIFICATION
from bioengine_tpu_torch.analysis.core import project_passes
from bioengine_tpu_torch.analysis.hotpath_rules import (
    HOT_PATH_ROOT_CATALOG,
    REPORT_SCHEMA,
    build_hot_path_report,
)
from bioengine_tpu_torch.analysis.project import (
    DEFAULT_CACHE,
    ProjectContext,
    build_project_index,
    parse_docs,
)
from bioengine_tpu_torch.analysis.sarif import render_sarif

pytestmark = pytest.mark.unit

REPO = Path(__file__).resolve().parent.parent
JAX_FIXTURES = REPO / "tests" / "analysis_fixtures"
FIXTURES = REPO / "tests" / "torch_analysis_fixtures"
PROJ = JAX_FIXTURES / "proj_demo"
PORT_BASELINE = REPO / ".analyze-torch-baseline.json"
_MARKER = re.compile(r"#\s*<-\s*(BE-[A-Z]+-\d+)")

# the JAX fixtures of the language-neutral module rules, read in place
SHARED_FIXTURES = sorted(p for p in JAX_FIXTURES.glob("fx_*.py") if not p.stem.startswith("fx_jax_"))
JAX_RULE_FIXTURES = sorted(JAX_FIXTURES.glob("fx_jax_*.py"))
GRAPH_FIXTURES = sorted(FIXTURES.glob("fx_graph_*.py"))
FIXTURE_FILES = SHARED_FIXTURES + GRAPH_FIXTURES
assert SHARED_FIXTURES and JAX_RULE_FIXTURES and len(GRAPH_FIXTURES) == 5

PROJECT_RULES = {r.id for r in all_rules() if r.project}
JAX_TO_GRAPH = {f"BE-JAX-10{i}": f"BE-GRAPH-10{i}" for i in range(1, 6)}
# JAX's own artifacts at the root, which nothing of the port may write
JAX_ARTIFACTS = [".analyze-baseline.json", "analyze.sarif", ".analyze-cache.json",
                 "analyze-stats.json", "hot-path-report.json"]


def expected_markers(path: Path) -> set[tuple[str, int]]:
    out = set()
    for lineno, line in enumerate(path.read_text().splitlines(), start=1):
        for m in _MARKER.finditer(line):
            out.add((m.group(1), lineno))
    return out


def _project_markers(root: Path) -> set[tuple[str, str, int]]:
    out = set()
    for path in sorted(root.rglob("*")):
        if path.suffix not in {".py", ".md"}:
            continue
        rel = str(path.relative_to(root))
        for lineno, line in enumerate(path.read_text().splitlines(), start=1):
            for m in _MARKER.finditer(line):
                out.add((m.group(1), rel, lineno))
    return out


def _rows(findings) -> list[tuple]:
    return [(f.rule, f.path, f.line, f.col, f.message) for f in findings]


def _digests() -> dict:
    return {name: hashlib.sha1((REPO / name).read_bytes()).hexdigest() if (REPO / name).exists() else None
            for name in JAX_ARTIFACTS}


# ---------------------------------------------------------------------------
# The registry: 28 rules, the JAX catalog with BE-GRAPH in place of BE-JAX
# ---------------------------------------------------------------------------


def test_rule_catalog_is_the_jax_catalog_with_the_capture_family():
    ours = {r.id: r for r in all_rules()}
    theirs = {r.id: r for r in jax_analysis.all_rules()}
    assert len(ours) == len(theirs) == 28
    assert set(ours) == {JAX_TO_GRAPH.get(i, i) for i in theirs}
    for rule_id, rule in theirs.items():
        if rule_id in JAX_TO_GRAPH:
            graph = ours[JAX_TO_GRAPH[rule_id]]
            assert (rule.pass_name, graph.pass_name) == ("jax", "graph")
            assert graph.project is rule.project is False
        else:
            # ids, slugs, summaries, passes as JAX has them
            mine = ours[rule_id]
            assert (mine.id, mine.slug, mine.summary, mine.pass_name, mine.project) == (
                rule.id, rule.slug, rule.summary, rule.pass_name, rule.project)
    # neither registry holds the other's rules, in one process
    assert not any(i.startswith("BE-JAX") for i in ours)
    assert not any(i.startswith("BE-GRAPH") for i in theirs)


def test_capture_rule_slugs():
    slugs = {r.id: r.slug for r in all_rules() if r.pass_name == "graph"}
    assert slugs == {
        "BE-GRAPH-101": "captured-python-branch",
        "BE-GRAPH-102": "host-copy-of-captured",
        "BE-GRAPH-103": "captured-coercion",
        "BE-GRAPH-104": "closure-mutation-under-capture",
        "BE-GRAPH-105": "captured-shape-arg",
    }


def test_cli_list_rules_prints_28(capsys):
    assert analysis_main(["--list-rules"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 28
    assert sum("[graph/module]" in line for line in lines) == 5
    assert not any("BE-JAX" in line for line in lines)


def test_defaults_write_nothing_of_the_jax_tool():
    assert str(DEFAULT_CACHE) == ".analyze-torch-cache.json"
    assert str(DEFAULT_BASELINE) == ".analyze-torch-baseline.json"
    parser = build_parser()
    assert parser.prog == "python -m bioengine_tpu_torch.analysis"
    assert parser.parse_args([]).paths == ["bioengine_tpu_torch"]


# ---------------------------------------------------------------------------
# Module rules: fixtures fire exactly their markers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixture", FIXTURE_FILES, ids=lambda p: f"{p.parent.name}/{p.stem}")
def test_fixture_findings_match_markers_exactly(fixture):
    """Every marked line fires its rule; nothing else fires (the unmarked
    negative cases in the same file double as the per-rule negatives)."""
    found = {(f.rule, f.line) for f in analyze_file(fixture)}
    assert found == expected_markers(fixture)


@pytest.mark.parametrize("fixture", SHARED_FIXTURES, ids=lambda p: p.stem)
def test_shared_fixture_findings_equal_the_jax_analyzer(fixture):
    """(rule, path, line, col, message) for (rule, path, line, col,
    message): the language-neutral families on the JAX fixtures."""
    assert _rows(analyze_file(fixture)) == _rows(jax_analysis.analyze_file(fixture))


@pytest.mark.parametrize("fixture", JAX_RULE_FIXTURES, ids=lambda p: p.stem)
def test_jax_rule_fixtures_give_the_port_only_the_shared_findings(fixture):
    """The BE-JAX fixtures hold jitted JAX code: the port's analyzer finds
    there what the JAX analyzer finds outside its JAX family, and no
    capture finding (nothing there is captured)."""
    theirs = [f for f in jax_analysis.analyze_file(fixture) if not f.rule.startswith("BE-JAX")]
    assert _rows(analyze_file(fixture)) == _rows(theirs)


def test_every_rule_has_a_seeded_fixture_violation():
    """Module rules in the flat fx_* fixtures (the JAX directory's shared
    ones and this directory's capture ones), project rules in proj_demo."""
    seeded = set()
    for f in FIXTURE_FILES:
        seeded |= {rule for rule, _ in expected_markers(f)}
    proj_seeded = {rule for rule, _, _ in _project_markers(PROJ)}
    by_pass: dict[str, set] = {}
    for r in all_rules():
        if r.project:
            assert r.id in proj_seeded, f"no proj_demo fixture seeds a violation for {r.id}"
        else:
            assert r.id in seeded, f"no fixture seeds a violation for {r.id}"
        by_pass.setdefault(r.pass_name, set()).add(r.id)
    assert len(by_pass["async"]) >= 8  # 5 module + 3 interprocedural
    assert len(by_pass["graph"]) == 5
    assert "jax" not in by_pass
    assert len(by_pass["obs"]) >= 1
    assert len(by_pass["dist"]) >= 5


def test_capture_fixture_cases_are_named_for_the_card():
    """chip_smoke.py's phase_analysis runs ``pos_*``/``block_pos_*`` as
    positives and ``neg_*`` as negatives: each marked line sits in a
    positive, no negative holds a marker."""
    import ast

    for path in GRAPH_FIXTURES:
        tree = ast.parse(path.read_text())
        marked = {line for _, line in expected_markers(path)}
        for fn in tree.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            lines = set(range(fn.lineno, fn.end_lineno + 1))
            if fn.name.startswith("neg_"):
                assert not lines & marked, (path.name, fn.name)
            elif fn.name.startswith(("pos_", "block_pos_")):
                assert lines & marked, (path.name, fn.name)
        positives = [f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name.startswith("pos_")]
        negatives = [f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name.startswith("neg_")]
        assert positives and negatives, path.name


@pytest.mark.parametrize("fixture", GRAPH_FIXTURES, ids=lambda p: p.stem)
def test_capture_fixture_cases_run_eagerly(fixture):
    """Every ``pos_*`` and ``neg_*`` case is valid code outside a capture:
    on the CPU each runs eagerly (the card shows what capture does)."""
    import importlib.util

    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location(f"torch_fx_{fixture.stem}", fixture)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32))
    names = [n for n in vars(module) if n.startswith(("pos_", "neg_"))]
    assert names
    for name in names:
        getattr(module, name)(x.clone())


def test_capture_pass_finds_the_ports_capture_sites():
    """The engine's and the decode engine's ``torch.cuda.graph`` blocks are
    captured regions, and neither has a finding."""
    import ast

    sites = {}
    for rel in ("runtime/engine.py", "runtime/decode_engine.py"):
        path = REPO / "bioengine_tpu_torch" / rel
        source = path.read_text()
        regions = capture_rules.discover_captured(ast.parse(source))
        blocks = [r for r in regions if r.how == "block"]
        assert len(blocks) == 1, rel
        line = source.splitlines()[blocks[0].line - 1]
        assert "torch.cuda.graph(graph, capture_error_mode=\"thread_local\")" in line
        sites[rel] = blocks[0]
        assert not [f for f in analyze_file(path) if f.rule.startswith("BE-GRAPH")]
    assert {"module", "static_in", "static_out"} <= sites["runtime/engine.py"].captured


@pytest.mark.parametrize("source, rules", [
    # a block's own body
    ("import torch\ndef f(x):\n    g = torch.cuda.CUDAGraph()\n    with torch.cuda.graph(g):\n"
     "        y = x * 2\n        if y.sum() > 0:\n            y = y + 1\n    return y\n", ["BE-GRAPH-101"]),
    # make_graphed_callables over a tuple; an aliased import
    ("from torch.cuda import make_graphed_callables as mg\nimport numpy as np\n"
     "def f(x):\n    return np.asarray(x.cpu())\n"
     "def g(x):\n    return mg((f,), ((x,),))\n", ["BE-GRAPH-102", "BE-GRAPH-102"]),
    # self.method called from a block; a static int parameter
    ("import torch\nclass P:\n    def step(self, x, n: int):\n        if n > 1:\n            return x.view(n, -1)\n"
     "        return x.view(int(x.sum()), -1)\n"
     "    def capture(self, g, x):\n        with torch.cuda.graph(g):\n            self.step(x, 2)\n",
     ["BE-GRAPH-105", "BE-GRAPH-103"]),
    # a static input made before the block is read inside it
    ("import torch\ndef f(g):\n    static_in = torch.zeros(4, device='cuda')\n"
     "    with torch.cuda.graph(g):\n        out = static_in * 2\n        peak = out.max().item()\n",
     ["BE-GRAPH-103"]),
    # nothing captured: no finding
    ("import torch\ndef f(x):\n    if x.sum() > 0:\n        return x.item()\n    return x.cpu()\n", []),
])
def test_capture_regions_and_values(source, rules):
    assert [f.rule for f in analyze_source(source)] == rules


def test_static_annotations():
    import ast

    src = ("def f(a: int, b: float, c: 'bool', d: str, e: tuple[int, ...], g: 'torch.Size', h: torch.dtype,"
           " i: int | None, j: Optional[int], k, m: torch.Tensor, self=None):\n    pass\n")
    fn = ast.parse(src).body[0]
    assert capture_rules._captured_params(fn) == {"k", "m"}


def test_clean_fixture_is_clean():
    assert analyze_file(JAX_FIXTURES / "fx_clean.py") == []


def test_suppression_fixture_is_clean():
    """Same-line, line-above, and ignore-file forms all suppress."""
    assert analyze_file(JAX_FIXTURES / "fx_suppressed.py") == []


def test_suppression_is_rule_specific():
    src = (
        "import time\n"
        "async def f():\n"
        "    time.sleep(1)  # bioengine: ignore[BE-ASYNC-999]\n"
    )
    assert [f.rule for f in analyze_source(src)] == ["BE-ASYNC-001"]


def test_suppression_grammar_covers_capture_rules():
    src = (
        "import torch\n"
        "def f(g, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        # bioengine: ignore[BE-GRAPH-103]\n"
        "        v = x.sum().item()\n"
        "        w = x.max().item()  # bioengine: ignore\n"
        "        u = x.min().item()\n"
    )
    assert [(f.rule, f.line) for f in analyze_source(src)] == [("BE-GRAPH-103", 7)]
    filewide = "# bioengine: ignore-file[BE-GRAPH-103]\n" + src
    assert analyze_source(filewide) == []


def test_blanket_ignore_suppresses_everything():
    src = (
        "import time\n"
        "async def f():\n"
        "    time.sleep(1)  # bioengine: ignore\n"
    )
    assert analyze_source(src) == []


def test_syntax_error_reported_as_finding():
    findings = analyze_source("def broken(:\n", path="x.py")
    assert [f.rule for f in findings] == ["BE-PARSE-000"]


# ---------------------------------------------------------------------------
# Baseline and fingerprints
# ---------------------------------------------------------------------------


def test_baseline_roundtrip_suppresses_then_goes_stale(tmp_path):
    findings = analyze_file(JAX_FIXTURES / "fx_async_blocking.py")
    assert findings
    bl = Baseline()
    bl.update_from(findings)
    assert all(e["justification"] == TODO_JUSTIFICATION for e in bl.entries.values())
    new, stale = bl.apply(findings)
    assert new == [] and stale == []
    new, stale = bl.apply(findings[1:])
    assert new == [] and len(stale) == 1
    p = tmp_path / "bl.json"
    bl.save(p)
    new, stale = Baseline.load(p).apply(findings)
    assert new == [] and stale == []


def test_baseline_fingerprint_tracks_line_content_not_number():
    src = "import time\nasync def f():\n    time.sleep(1)\n"
    moved = "import time\n# a new comment shifts lines\nasync def f():\n    time.sleep(1)\n"
    bl = Baseline()
    bl.update_from(analyze_source(src, path="m.py"))
    new, stale = bl.apply(analyze_source(moved, path="m.py"))
    assert new == [] and stale == []


def test_fingerprint_equals_the_jax_fingerprint():
    """rule | path | normalised line | occurrence, as JAX hashes it: on
    equal findings the two fingerprints are equal, and a baseline written
    by either package holds the same keys."""
    findings, _ = analyze_project([PROJ], root=PROJ, cache_path=None)
    findings += analyze_file(JAX_FIXTURES / "fx_async_blocking.py")
    assert findings
    for occurrence in (0, 1, 7):
        for f in findings:
            twin = jax_analysis.Finding(f.rule, f.path, f.line, f.col, f.message, f.source_line)
            assert fingerprint(f, occurrence) == jax_baseline.fingerprint(twin, occurrence)
    ours, theirs = Baseline(), jax_baseline.Baseline()
    ours.update_from(findings)
    theirs.update_from([jax_analysis.Finding(f.rule, f.path, f.line, f.col, f.message, f.source_line)
                        for f in findings])
    assert ours.entries == theirs.entries


def test_port_baseline_entries_are_all_justified():
    """Every remaining finding of the port carries a one-line
    justification; none is a leak (BE-LIFE-401) or docs drift
    (BE-DIST-204/205), which are fixed or justified inline."""
    data = json.loads(PORT_BASELINE.read_text())
    assert data["findings"]
    for fp, entry in data["findings"].items():
        assert entry["justification"] != TODO_JUSTIFICATION, (fp, entry["path"], entry["line"])
        assert "TODO" not in entry["justification"], fp
        assert "\n" not in entry["justification"], fp
        assert entry["rule"] not in {"BE-LIFE-401", "BE-DIST-204", "BE-DIST-205"}, (fp, entry)
        assert entry["path"].startswith("bioengine_tpu_torch/"), fp


# ---------------------------------------------------------------------------
# CLI: the exit-code contract
# ---------------------------------------------------------------------------


def test_cli_exits_nonzero_on_seeded_fixtures_without_baseline(capsys):
    rc = analysis_main([str(JAX_FIXTURES / "fx_async_blocking.py"), str(FIXTURES), "--no-baseline", "--no-cache"])
    assert rc == 1
    out = capsys.readouterr().out
    assert "BE-ASYNC-001" in out and "BE-GRAPH-101" in out


def test_cli_exits_zero_on_clean_file(capsys):
    rc = analysis_main([str(JAX_FIXTURES / "fx_clean.py"), "--no-baseline", "--no-cache"])
    assert rc == 0
    assert "clean" in capsys.readouterr().out


def test_cli_write_baseline_then_clean(tmp_path, capsys):
    bl = tmp_path / "bl.json"
    rc = analysis_main([str(FIXTURES), "--baseline", str(bl), "--write-baseline", "--no-cache"])
    assert rc == 0 and bl.exists()
    rc = analysis_main([str(FIXTURES), "--baseline", str(bl), "--no-cache"])
    assert rc == 0
    assert "baselined" in capsys.readouterr().out


def test_cli_json_format(capsys):
    rc = analysis_main([str(FIXTURES / "fx_graph_closure.py"), "--no-baseline", "--no-cache", "--format", "json"])
    assert rc == 1
    findings = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in findings} == {"BE-GRAPH-104"}


def test_cli_rule_filter(capsys):
    rc = analysis_main([str(FIXTURES), "--no-baseline", "--no-cache", "--rule", "BE-GRAPH-105"])
    assert rc == 1
    out = capsys.readouterr().out
    assert "BE-GRAPH-105" in out and "BE-GRAPH-101" not in out


def test_cli_bad_path_is_usage_error():
    assert analysis_main(["definitely/not/a/path"]) == 2


def test_cli_default_cache_is_the_ports(tmp_path, monkeypatch, capsys):
    """Run from another directory with the defaults: the port writes its
    own cache and reads its own baseline name, never a JAX file."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "ok.py").write_text("x = 1\n")
    assert analysis_main(["pkg"]) == 0
    assert (tmp_path / ".analyze-torch-cache.json").exists()
    assert not (tmp_path / ".analyze-cache.json").exists()


def test_bioengine_torch_analyze_command():
    from click.testing import CliRunner

    from bioengine_tpu_torch.cli.cli import main

    runner = CliRunner()
    out = runner.invoke(main, ["--help"])
    assert out.exit_code == 0 and "analyze" in out.output
    out = runner.invoke(main, ["analyze", "--list-rules"])
    assert out.exit_code == 0
    assert len(out.output.splitlines()) == 28 and "BE-GRAPH-105" in out.output
    out = runner.invoke(main, ["analyze", "definitely/not/a/path"])
    assert out.exit_code == 2
    out = runner.invoke(main, ["analyze", str(FIXTURES / "fx_graph_branch.py"), "--no-baseline", "--no-cache"])
    assert out.exit_code == 1 and "BE-GRAPH-101" in out.output


# ---------------------------------------------------------------------------
# --changed (diff-aware gate)
# ---------------------------------------------------------------------------


def _git(tmp, *args):
    subprocess.run(
        ["git", *args], cwd=tmp, check=True, capture_output=True,
        env={"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t", "GIT_COMMITTER_NAME": "t",
             "GIT_COMMITTER_EMAIL": "t@t", "PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(tmp)},
    )


def test_changed_mode_scans_only_touched_files(tmp_path, monkeypatch):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    dirty = pkg / "dirty.py"
    clean = pkg / "clean.py"
    dirty.write_text("import time\nasync def f():\n    time.sleep(1)\n")
    clean.write_text("import time\nasync def g():\n    time.sleep(1)\n")
    _git(tmp_path, "init", "-q")
    _git(tmp_path, "add", ".")
    _git(tmp_path, "commit", "-qm", "seed")
    monkeypatch.chdir(tmp_path)
    assert analysis_main(["pkg", "--changed", "--no-baseline"]) == 0
    dirty.write_text("import time\nasync def f():\n    time.sleep(2)\n")
    assert analysis_main(["pkg", "--changed", "--no-baseline"]) == 1
    assert analysis_main([str(pkg / "nonexistent_scope"), "--changed", "--no-baseline"]) == 2
    sub = tmp_path / "sub"
    sub.mkdir()
    monkeypatch.chdir(sub)
    assert analysis_main([str(pkg), "--changed", "--no-baseline"]) == 1


def test_cli_write_baseline_refuses_changed_subset(capsys):
    rc = analysis_main([str(PROJ), "--changed", "--write-baseline", "--no-cache"])
    assert rc == 2
    assert "full scan" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Whole program: proj_demo, cache, process pool, docs, SARIF, stats
# ---------------------------------------------------------------------------


def _copy_proj(tmp_path: Path) -> Path:
    dst = tmp_path / "proj"
    shutil.copytree(PROJ, dst)
    return dst


def test_project_fixture_findings_match_markers_exactly(tmp_path):
    findings, _ = analyze_project([PROJ], root=PROJ, cache_path=tmp_path / "cache.json")
    found = {(f.rule, f.path, f.line) for f in findings if f.rule in PROJECT_RULES}
    assert found == _project_markers(PROJ)


def test_project_findings_equal_the_jax_analyzer():
    """proj_demo through both: the same findings, the same hot-path
    report, and SARIF equal apart from the tool's name and the swapped
    family's five rows of the rule table."""
    ours, _, ctx = analyze_project([PROJ], root=PROJ, cache_path=None, return_context=True)
    theirs, _, jctx = jax_analysis.analyze_project([PROJ], root=PROJ, cache_path=None, return_context=True)
    assert ours and _rows(ours) == _rows(theirs)
    assert [f.source_line for f in ours] == [f.source_line for f in theirs]
    assert build_hot_path_report(ctx) == jax_hotpath.build_hot_path_report(jctx)
    doc, jdoc = render_sarif(ours), jax_sarif.render_sarif(theirs)
    driver, jdriver = doc["runs"][0]["tool"]["driver"], jdoc["runs"][0]["tool"]["driver"]
    assert (driver.pop("name"), jdriver.pop("name")) == ("bioengine-torch-analyze", "bioengine-analyze")
    rules, jrules = driver.pop("rules"), jdriver.pop("rules")
    assert [r["id"] for r in rules] == [JAX_TO_GRAPH.get(r["id"], r["id"]) for r in jrules]
    assert [r for r in rules if r["id"] not in JAX_TO_GRAPH.values()] == [
        r for r in jrules if r["id"] not in JAX_TO_GRAPH
    ]
    assert doc == jdoc


def test_every_project_rule_is_seeded():
    seeded = {rule for rule, _, _ in _project_markers(PROJ)}
    for rule_id in sorted(PROJECT_RULES):
        assert rule_id in seeded, f"no proj_demo marker for {rule_id}"


def test_project_findings_carry_source_lines_and_are_baselineable(tmp_path):
    findings, _ = analyze_project([PROJ], root=PROJ, cache_path=None)
    assert [f for f in findings if f.path.endswith(".md")]
    assert all(f.source_line for f in findings)
    bl = Baseline()
    bl.update_from(findings)
    assert bl.apply(findings) == ([], [])


def test_cache_round_trip_and_incremental_reindex(tmp_path):
    proj = _copy_proj(tmp_path)
    cache = tmp_path / "cache.json"
    _, stats1 = build_project_index([proj], root=proj, cache_path=cache)
    assert stats1.files_indexed == stats1.files_total > 0 and cache.exists()
    _, stats2 = build_project_index([proj], root=proj, cache_path=cache)
    assert stats2.files_indexed == 0 and stats2.files_cached == stats1.files_total
    client = proj / "client_mod.py"
    client.write_text(client.read_text() + "\n# trailing comment\n")
    _, stats3 = build_project_index([proj], root=proj, cache_path=cache)
    assert stats3.files_indexed == 1 and stats3.files_cached == stats1.files_total - 1


def test_cache_key_hashes_the_ports_own_sources(tmp_path, monkeypatch):
    """The cache key folds in a hash of the port's analyzer sources: not
    the JAX analyzer's, and an edit to a port rule invalidates it."""
    import bioengine_tpu.analysis.project as jax_project
    import bioengine_tpu_torch.analysis.project as project_mod

    assert project_mod.tool_fingerprint() != jax_project.tool_fingerprint()
    proj = _copy_proj(tmp_path)
    cache = tmp_path / "cache.json"
    build_project_index([proj], root=proj, cache_path=cache)
    monkeypatch.setattr(project_mod, "_TOOL_FINGERPRINT", "different-tool-version")
    _, stats = build_project_index([proj], root=proj, cache_path=cache)
    assert stats.files_cached == 0 and stats.files_indexed == stats.files_total


def test_cross_module_findings_survive_incremental_rebuild(tmp_path):
    proj = _copy_proj(tmp_path)
    cache = tmp_path / "cache.json"
    findings, _ = analyze_project([proj], root=proj, cache_path=cache)
    assert any(f.rule == "BE-DIST-201" for f in findings)
    client = proj / "client_mod.py"
    client.write_text(client.read_text().replace('"pingg"', '"ping"'))
    findings2, stats = analyze_project([proj], root=proj, cache_path=cache)
    assert stats.files_indexed == 1
    assert not any(f.rule == "BE-DIST-201" for f in findings2)
    assert any(f.rule == "BE-DIST-202" for f in findings2)


def test_report_paths_restricts_module_findings_not_project_rules(tmp_path):
    proj = _copy_proj(tmp_path)
    findings, _ = analyze_project([proj], root=proj, report_paths=[proj / "obs_mod.py"], cache_path=None)
    assert {f.path for f in findings if f.rule not in PROJECT_RULES} <= {"obs_mod.py"}
    assert any(f.rule in PROJECT_RULES and f.path != "obs_mod.py" for f in findings)


def test_parallel_indexing_matches_serial(tmp_path):
    proj = _copy_proj(tmp_path)
    for i in range(10):
        (proj / f"pad_{i}.py").write_text(f"PAD = {i}\n")
    shutil.copy(FIXTURES / "fx_graph_shape.py", proj / "graph_mod.py")
    par, stats = analyze_project([proj], root=proj, cache_path=None, jobs=2)
    ser, _ = analyze_project([proj], root=proj, cache_path=None, jobs=1)
    assert stats.jobs == 2
    assert [f.render() for f in par] == [f.render() for f in ser]
    assert any(f.rule == "BE-GRAPH-105" for f in par)


def test_parse_docs_extracts_catalogs():
    docs = parse_docs(PROJ)
    assert docs.has_docs and docs.has_event_catalog
    assert "demo.documented" in docs.events
    assert "demo_requests_total" in docs.metrics
    assert "BIOENGINE_DEMO_DOCUMENTED" in docs.knobs
    real, jreal = parse_docs(REPO), jax_analysis.parse_docs(REPO)
    assert (real.events, real.metrics, real.knobs) == (jreal.events, jreal.metrics, jreal.knobs)
    assert "program_cache_hits_total" in real.metrics and not any("{" in m for m in real.metrics)


def test_docless_project_skips_doc_rules(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text("import os\nKNOB = os.environ.get('BIOENGINE_NOT_DOCUMENTED')\n")
    findings, _ = analyze_project([pkg], root=pkg, cache_path=None)
    assert findings == []


def test_sarif_schema_shape(tmp_path):
    findings, _ = analyze_project([PROJ], root=PROJ, cache_path=None)
    doc = render_sarif(findings)
    assert doc["version"] == "2.1.0"
    assert doc["$schema"].endswith("sarif-schema-2.1.0.json")
    (run,) = doc["runs"]
    driver = run["tool"]["driver"]
    assert driver["name"] == "bioengine-torch-analyze"
    rule_ids = [r["id"] for r in driver["rules"]]
    assert {"BE-DIST-201", "BE-ASYNC-006", "BE-GRAPH-101"} <= set(rule_ids)
    assert all("text" in r["shortDescription"] for r in driver["rules"])
    assert len(run["results"]) == len(findings)
    for result in run["results"]:
        assert result["level"] in {"error", "warning", "note"} and result["message"]["text"]
        (loc,) = result["locations"]
        region = loc["physicalLocation"]["region"]
        assert region["startLine"] >= 1 and region["startColumn"] >= 1
        if "ruleIndex" in result:
            assert rule_ids[result["ruleIndex"]] == result["ruleId"]


def test_cli_sarif_format(capsys):
    rc = analysis_main([str(FIXTURES / "fx_graph_coercion.py"), "--no-baseline", "--no-cache", "--format", "sarif"])
    assert rc == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["runs"][0]["tool"]["driver"]["name"] == "bioengine-torch-analyze"
    assert {r["ruleId"] for r in doc["runs"][0]["results"]} == {"BE-GRAPH-103"}


def test_cli_stats_and_jobs_flags(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "ok.py").write_text("x = 1\n")
    assert analysis_main(["pkg", "--no-baseline", "--stats", "--jobs", "1", "--no-cache"]) == 0
    err = capsys.readouterr().err
    assert "1 modules" in err and "jobs=1" in err


def test_cli_cache_flag_writes_and_reuses(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "ok.py").write_text("x = 1\n")
    cache = tmp_path / "c.json"
    assert analysis_main(["pkg", "--no-baseline", "--cache", str(cache), "--stats"]) == 0
    assert cache.exists()
    capsys.readouterr()
    assert analysis_main(["pkg", "--no-baseline", "--cache", str(cache), "--stats"]) == 0
    assert "1 from cache" in capsys.readouterr().err


def test_hot_path_report_fixture_marker_root():
    _, _, ctx = analyze_project([PROJ], root=PROJ, cache_path=None, return_context=True)
    report = build_hot_path_report(ctx)
    assert report["schema"] == REPORT_SCHEMA == "bioengine.hot-path-report/v1"
    assert any(r["qualname"] == "handle_request" and r["path"] == "perf_mod.py"
               for r in report["roots"] if r["origin"] == "marker")
    by_qual = {f["qualname"]: f for f in report["functions"] if f["path"] == "perf_mod.py"}
    assert {"handle_request", "mint_request_id", "tokenize"} <= set(by_qual)
    assert "cold_path_rebuild" not in by_qual
    assert by_qual["suppressed_sites"]["findings"] == 0
    mint = by_qual["mint_request_id"]
    assert mint["rules"] == {"BE-PERF-302": 1} and mint["score"] == mint["findings"] * mint["depth"]


def test_hot_path_catalog_is_the_jax_catalog_renamed():
    assert HOT_PATH_ROOT_CATALOG == tuple(
        (module.replace("bioengine_tpu.", "bioengine_tpu_torch.", 1), qual)
        for module, qual in jax_hotpath.HOT_PATH_ROOT_CATALOG
    )
    assert len(HOT_PATH_ROOT_CATALOG) == 22


# ---------------------------------------------------------------------------
# The port's own tree, one scan per package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree_scans():
    """One scan of ``bioengine_tpu_torch`` by each analyzer, no baseline,
    each with its hot-path report; the JAX analyzer's root catalog renamed
    as the port's is."""
    ours = analyze_project([REPO / "bioengine_tpu_torch"], root=REPO, cache_path=None, return_context=True)
    ours = (*ours, build_hot_path_report(ours[2]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_hotpath, "HOT_PATH_ROOT_CATALOG", HOT_PATH_ROOT_CATALOG)
        theirs = jax_analysis.analyze_project(
            [REPO / "bioengine_tpu_torch"], root=REPO, cache_path=None, return_context=True
        )
        theirs = (*theirs, jax_hotpath.build_hot_path_report(theirs[2]))
    return ours, theirs


def test_tree_findings_equal_the_jax_analyzer(tree_scans):
    """async, obs, dist, lifecycle and perf (the last through the renamed
    catalog): finding for finding; no JAX finding and no capture finding
    on the port's tree."""
    (ours, *_), (theirs, *_) = tree_scans
    families = ("BE-ASYNC", "BE-OBS", "BE-DIST", "BE-LIFE", "BE-PERF")
    assert _rows(f for f in ours if f.rule.startswith(families)) == _rows(
        f for f in theirs if f.rule.startswith(families)
    )
    assert [f for f in ours if f.rule.startswith("BE-GRAPH")] == []
    assert [f for f in theirs if f.rule.startswith("BE-JAX")] == []
    assert len(ours) == len(theirs) > 0


def test_tree_hot_path_reports_equal(tree_scans):
    (*_, report), (*_, jreport) = tree_scans
    assert report == jreport
    resolved = {(r["path"], r["qualname"]) for r in report["roots"] if r["origin"] == "catalog"}
    for module, qual in HOT_PATH_ROOT_CATALOG:
        assert (module.replace(".", "/") + ".py", qual) in resolved, f"catalog root {module}:{qual}"
    assert report["totals"]["reachable_functions"] > len(HOT_PATH_ROOT_CATALOG)


def test_tree_has_no_leak_or_docs_drift_finding(tree_scans):
    """The gates that take no baseline: the port's tree is clean of
    BE-LIFE-401 and BE-DIST-204/205 (the three port-only findings are
    repaired in the code)."""
    (ours, *_), _ = tree_scans
    assert [f.render() for f in ours if f.rule in {"BE-LIFE-401", "BE-DIST-204", "BE-DIST-205"}] == []
    assert not [f for f in ours if f.rule == "BE-ASYNC-001"]


def test_tree_cross_module_facts_resolve(tree_scans):
    """The port's whole-program index sees its real contracts: verbs,
    capabilities, flight events, metric families and env knobs."""
    (_, stats, ctx, _), _ = tree_scans
    assert stats.files_total > 100
    assert isinstance(ctx, ProjectContext) and {"interproc", "dist", "hotpath", "lifecycle"} <= set(project_passes())
    verbs = {v for idx in ctx.modules.values() for v, _, _ in idx["verbs_registered"]}
    assert {"register_host", "push_telemetry", "start_replica"} <= verbs
    caps = {s for idx in ctx.modules.values() for s, _, _, _ in idx["caps_defined"]}
    assert {"PROTO_OOB1", "PROTO_TRACE1", "PROTO_TELEM1"} <= caps
    events = {e for idx in ctx.modules.values() for e, _, _ in idx["flight_events"]}
    assert {"breaker.trip", "host.rejoin", "slo.*"} <= events
    knobs = {k for idx in ctx.modules.values() for k, _, _ in idx["env_reads"]}
    assert "BIOENGINE_TELEM_PUSH_S" in knobs


def test_baseline_holds_exactly_the_tree_findings(tree_scans):
    """Nothing stale, nothing missing: the baseline's fingerprints are the
    tree's findings'."""
    (ours, *_), _ = tree_scans
    new, stale = Baseline.load(PORT_BASELINE).apply(ours)
    assert new == [] and stale == []


# ---------------------------------------------------------------------------
# The gate, cold, and the CI script
# ---------------------------------------------------------------------------


def test_gate_is_clean_cold_inside_the_wall_budget(tmp_path, monkeypatch):
    """A cold gate run over the port's default scope (fresh cache) exits
    0 against the checked-in baseline inside the 10 s budget, and emits
    the stats schema."""
    monkeypatch.chdir(REPO)
    stats_path = tmp_path / "stats.json"
    rc = analysis_main(["--cache", str(tmp_path / "cache.json"), "--stats-json", str(stats_path)])
    assert rc == 0
    stats = json.loads(stats_path.read_text())
    assert stats["schema"] == "bioengine.analyze-stats/v1"
    assert stats["files_indexed"] == stats["files_total"] > 100
    assert stats["files_cached"] == 0
    assert stats["wall_s"] < 10.0
    assert {"interproc", "dist", "hotpath", "lifecycle"} <= set(stats["passes"])
    assert stats["findings"] == len(json.loads(PORT_BASELINE.read_text())["findings"])


def test_analyzer_imports_no_torch_and_nothing_of_jax():
    """Host-only: the analyzer, the capture rules included, reads source
    and never imports torch, jax or the JAX package."""
    script = (
        "import sys\n"
        "from bioengine_tpu_torch.analysis import analyze_file\n"
        f"found = analyze_file(__import__('pathlib').Path({str(FIXTURES / 'fx_graph_branch.py')!r}))\n"
        "assert found, found\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in {'torch', 'jax', 'flax', 'bioengine_tpu'}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_ci_script_passes_and_writes_only_its_own_outputs(tmp_path):
    """``scripts/workflows/analyze_torch.sh`` passes on the tree; its
    SARIF, hot-path report and stats land where it is told, and no file of
    the JAX tool changes."""
    before = _digests()
    env = {**os.environ, "SARIF_OUT": str(tmp_path / "a.sarif"),
           "HOTPATH_OUT": str(tmp_path / "hp.json"), "STATS_OUT": str(tmp_path / "stats.json")}
    out = subprocess.run(["bash", str(REPO / "scripts" / "workflows" / "analyze_torch.sh")], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "analyze-torch: gate passed" in out.stdout
    sarif = json.loads((tmp_path / "a.sarif").read_text())
    assert sarif["runs"][0]["tool"]["driver"]["name"] == "bioengine-torch-analyze"
    assert json.loads((tmp_path / "hp.json").read_text())["totals"]["roots"] == 22
    assert json.loads((tmp_path / "stats.json").read_text())["schema"] == "bioengine.analyze-stats/v1"
    assert _digests() == before
    ignored = subprocess.run(["git", "check-ignore", ".analyze-torch-cache.json", "analyze-torch.sarif",
                              "hot-path-report-torch.json", "analyze-torch-stats.json"],
                             cwd=REPO, capture_output=True, text=True)
    assert len(ignored.stdout.split()) == 4, ignored.stdout
