#!/usr/bin/env bash
# CI job: the PyTorch port's static-analysis gate — whole-program, blocking.
#
# The port's analyzer (bioengine_tpu_torch.analysis) scans the port's
# package, bioengine_tpu_torch/ (its app bundles live inside it, under
# apps/bundles/). Phase 1 indexes every module (process pool,
# content-hash cache); phase 2 runs the cross-module rule families
# (BE-DIST-2xx contract drift, BE-ASYNC-006..008 interprocedural
# async-safety, BE-PERF-3xx hot-path cost, BE-LIFE-4xx lifecycle) over
# the full fact base; the BE-GRAPH-10x capture-safety rules check every
# region captured by torch.cuda.graph. Any finding not covered by
# .analyze-torch-baseline.json fails the job.
#
# On pull requests pass the base ref as $1 (e.g. origin/main): module-
# local findings then narrow to changed files while the cross-module
# rules still evaluate the whole project.
#
# Also emitted (each listed in .gitignore):
#   - analyze-torch.sarif         code-scanning annotations (SARIF
#     2.1.0, driver "bioengine-torch-analyze") — exported BEFORE the job
#     fails, so a red run still annotates
#   - hot-path-report-torch.json  the BE-PERF-3xx overhead map over the
#     port's request-path roots
#   - analyze-torch-stats.json    machine-readable run stats (wall,
#     cache hits, per-pass timings)
#   - a docs drift guard: BIOENGINE_* knobs and flight-event/metric
#     catalogs must match docs/ (BE-DIST-204/205) with NO baseline
#     escape hatch
#   - a leak drift guard: BE-LIFE-401 (unswept keyed registry) with NO
#     baseline escape hatch: a registry is swept or carries an inline
#     justification, never a baseline entry.
#
# Run locally from the repo root:  scripts/workflows/analyze_torch.sh
set -euo pipefail
cd "$(dirname "$0")/../.."

BASE_REF="${1:-}"
SARIF_OUT="${SARIF_OUT:-analyze-torch.sarif}"
HOTPATH_OUT="${HOTPATH_OUT:-hot-path-report-torch.json}"
STATS_OUT="${STATS_OUT:-analyze-torch-stats.json}"
ANALYZE=(python -m bioengine_tpu_torch.analysis bioengine_tpu_torch/)

gate_rc=0
if [[ -n "$BASE_REF" ]]; then
    echo "analyze-torch: whole-program scan (module findings vs $BASE_REF)"
    "${ANALYZE[@]}" --changed "$BASE_REF" --stats \
        --stats-json "$STATS_OUT" \
        --hot-path-report "$HOTPATH_OUT" || gate_rc=$?
else
    echo "analyze-torch: whole-program full scan"
    "${ANALYZE[@]}" --stats \
        --stats-json "$STATS_OUT" \
        --hot-path-report "$HOTPATH_OUT" || gate_rc=$?
fi
if [[ "$gate_rc" -ge 2 ]]; then
    echo "analyze-torch: analyzer error (rc=$gate_rc)" >&2
    exit "$gate_rc"
fi

echo "analyze-torch: exporting SARIF -> $SARIF_OUT"
sarif_rc=0
"${ANALYZE[@]}" --format sarif > "$SARIF_OUT" || sarif_rc=$?
if [[ "$sarif_rc" -ge 2 ]]; then
    echo "analyze-torch: SARIF export failed (rc=$sarif_rc)" >&2
    exit "$sarif_rc"
fi
python - "$SARIF_OUT" <<'PY'
import json, sys
doc = json.load(open(sys.argv[1]))
assert doc["version"] == "2.1.0", "SARIF export is not 2.1.0"
driver = doc["runs"][0]["tool"]["driver"]["name"]
assert driver == "bioengine-torch-analyze", driver
print(f"analyze-torch: SARIF ok ({len(doc['runs'][0]['results'])} result(s))")
PY

python - "$HOTPATH_OUT" <<'PY'
import json, sys
doc = json.load(open(sys.argv[1]))
assert doc["schema"] == "bioengine.hot-path-report/v1", doc.get("schema")
assert doc["totals"]["roots"] > 0, "no request-path roots resolved"
print(
    f"analyze-torch: hot-path report ok ({doc['totals']['roots']} roots, "
    f"{doc['totals']['reachable_functions']} reachable, "
    f"{doc['totals']['findings']} finding(s))"
)
PY

echo "analyze-torch: docs drift guard (env knobs + observability catalogs)"
"${ANALYZE[@]}" --rule BE-DIST-204 --rule BE-DIST-205 --no-baseline

echo "analyze-torch: leak drift guard (BE-LIFE-401, no baseline escape)"
"${ANALYZE[@]}" --rule BE-LIFE-401 --no-baseline

if [[ "$gate_rc" -ne 0 ]]; then
    echo "analyze-torch: gate FAILED (new findings above)" >&2
    exit "$gate_rc"
fi
echo "analyze-torch: gate passed"
