"""Checked-in baseline: pre-existing findings that don't block CI.

Each baselined finding carries a one-line ``justification`` explaining
why it is acceptable (reviewed-and-safe, scheduled follow-up, …).  The
fingerprint hashes the rule id, the file path, and the *normalized
source text* of the flagged line (plus an occurrence index for
duplicate lines) — NOT the line number — so unrelated edits above a
baselined finding don't invalidate the baseline, while any edit to the
flagged line itself surfaces the finding again for re-review.

Regenerate with ``python -m bioengine_tpu_torch.analysis --write-baseline``:
existing justifications are preserved, new entries get a TODO marker
that a human must replace before commit.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

from bioengine_tpu_torch.analysis.core import Finding

DEFAULT_BASELINE = Path(".analyze-torch-baseline.json")
TODO_JUSTIFICATION = "TODO: justify or fix"


def _normalize(text: str) -> str:
    return " ".join(text.split())


def fingerprint(f: Finding, occurrence: int = 0) -> str:
    key = f"{f.rule}|{f.path}|{_normalize(f.source_line)}|{occurrence}"
    return hashlib.sha1(key.encode()).hexdigest()[:16]


def _fingerprints(findings: Iterable[Finding]) -> list[tuple[str, Finding]]:
    """Fingerprint each finding, disambiguating identical lines by
    occurrence order (stable because findings are position-sorted)."""
    counts: dict[tuple[str, str, str], int] = {}
    out = []
    for f in findings:
        key = (f.rule, f.path, _normalize(f.source_line))
        occ = counts.get(key, 0)
        counts[key] = occ + 1
        out.append((fingerprint(f, occ), f))
    return out


@dataclass
class Baseline:
    entries: dict[str, dict] = field(default_factory=dict)

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        data = json.loads(path.read_text(encoding="utf-8"))
        return cls(entries=data.get("findings", {}))

    def save(self, path: Path) -> None:
        payload = {
            "version": 1,
            "comment": (
                "bioengine analyze baseline — every entry needs a one-line "
                "justification; regenerate with --write-baseline"
            ),
            "findings": dict(sorted(self.entries.items())),
        }
        path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")

    def apply(
        self, findings: list[Finding]
    ) -> tuple[list[Finding], list[str]]:
        """-> (findings not in baseline, stale fingerprints).

        Stale entries (baselined finding no longer present) are
        reported so the baseline can be pruned, but never fail the
        run — a fixed finding shouldn't punish the fixer.
        """
        new: list[Finding] = []
        seen: set[str] = set()
        for fp, f in _fingerprints(findings):
            if fp in self.entries:
                seen.add(fp)
            else:
                new.append(f)
        stale = [fp for fp in self.entries if fp not in seen]
        return new, stale

    def update_from(self, findings: list[Finding]) -> None:
        """Rebuild entries from current findings, preserving existing
        justifications; new entries get a TODO marker."""
        fresh: dict[str, dict] = {}
        for fp, f in _fingerprints(findings):
            old = self.entries.get(fp, {})
            fresh[fp] = {
                "rule": f.rule,
                "path": f.path,
                "line": f.line,
                "source": _normalize(f.source_line),
                "justification": old.get("justification", TODO_JUSTIFICATION),
            }
        self.entries = fresh
