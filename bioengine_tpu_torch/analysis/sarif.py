"""SARIF 2.1.0 export — code-scanning annotations for CI.

One run, one driver ("bioengine-torch-analyze"), every registered rule in
the driver's rule table, one result per finding.  The shape is pinned
by ``tests/test_torch_analysis.py::test_sarif_schema_shape`` so a CI
consumer (GitHub code scanning, ``sarif-tools``) can rely on it.
"""

from __future__ import annotations

from typing import Iterable

from bioengine_tpu_torch.analysis.core import Finding, all_rules

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)

# every rule here gates CI, so findings map to SARIF "error" except the
# advisory parse/io internals
_LEVEL_OVERRIDES = {"BE-PARSE-000": "error", "BE-IO-000": "warning"}


def render_sarif(findings: Iterable[Finding]) -> dict:
    rules = [
        {
            "id": r.id,
            "name": r.slug,
            "shortDescription": {"text": r.summary},
            "helpUri": (
                "https://github.com/bioengine-tpu/bioengine-tpu/blob/"
                "main/docs/static-analysis.md"
            ),
        }
        for r in all_rules()
    ]
    rule_index = {r["id"]: i for i, r in enumerate(rules)}
    results = []
    for f in findings:
        result = {
            "ruleId": f.rule,
            "level": _LEVEL_OVERRIDES.get(f.rule, "error"),
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path.replace("\\", "/"),
                            "uriBaseId": "SRCROOT",
                        },
                        "region": {
                            "startLine": max(f.line, 1),
                            # SARIF columns are 1-based
                            "startColumn": f.col + 1,
                        },
                    }
                }
            ],
        }
        if f.rule in rule_index:
            result["ruleIndex"] = rule_index[f.rule]
        results.append(result)
    return {
        "version": SARIF_VERSION,
        "$schema": SARIF_SCHEMA,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "bioengine-torch-analyze",
                        "informationUri": (
                            "https://github.com/bioengine-tpu/"
                            "bioengine-tpu/blob/main/docs/"
                            "static-analysis.md"
                        ),
                        "rules": rules,
                    }
                },
                "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
                "results": results,
            }
        ],
    }
