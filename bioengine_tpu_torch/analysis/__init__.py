"""Static analysis for the PyTorch port: a two-phase whole-program linter.

The orchestration layer (RPC server, proxies, worker monitor loop) is
asyncio end to end, the compute layer replays CUDA graphs, and the
distributed plane is held together by stringly-typed contracts (RPC
verbs, capability tokens, flight events, metric families, env knobs).
This package catches all three failure classes statically:

**Phase 1 (per module, parallel, cached)** parses each module once,
runs the module-local passes, and extracts a fact index — defs, an
approximate call graph, and every cross-module contract string.

**Phase 2 (whole program)** evaluates interprocedural and
cross-module rules over the union of all module indexes plus the
documentation catalogs.

- :mod:`bioengine_tpu_torch.analysis.core` — AST-walker framework, rule
  registry, ``# bioengine: ignore[RULE]`` suppressions.
- :mod:`bioengine_tpu_torch.analysis.project` — phase-1 index, cache,
  incremental/parallel build, doc-catalog extraction.
- :mod:`bioengine_tpu_torch.analysis.async_rules` — BE-ASYNC-001..005
  (module-local event-loop hazards).
- :mod:`bioengine_tpu_torch.analysis.interproc` — BE-ASYNC-006..008
  (call-graph async-safety).
- :mod:`bioengine_tpu_torch.analysis.capture_rules` — BE-GRAPH-* rules
  (CUDA-graph capture safety).
- :mod:`bioengine_tpu_torch.analysis.obs_rules` — BE-OBS-* rules.
- :mod:`bioengine_tpu_torch.analysis.dist_rules` — BE-DIST-2xx
  distributed-contract drift rules.
- :mod:`bioengine_tpu_torch.analysis.sarif` — SARIF 2.1.0 export for CI
  code-scanning annotations.
- :mod:`bioengine_tpu_torch.analysis.baseline` — checked-in baseline so
  pre-existing, justified findings don't block CI.

Run it as ``python -m bioengine_tpu_torch.analysis <paths>`` or
``bioengine-torch analyze``.  See docs/static-analysis.md for the rule
catalog and the two-phase architecture; the BE-GRAPH family is
described in :mod:`bioengine_tpu_torch.analysis.capture_rules`.
"""

from bioengine_tpu_torch.analysis.core import (
    Finding,
    Rule,
    all_rules,
    analyze_file,
    analyze_paths,
    analyze_source,
    get_rule,
)
from bioengine_tpu_torch.analysis.baseline import (
    Baseline,
    fingerprint,
)

# Importing the rule modules registers their rules with the registry.
from bioengine_tpu_torch.analysis import async_rules as _async_rules  # noqa: F401
from bioengine_tpu_torch.analysis import capture_rules as _capture_rules  # noqa: F401
from bioengine_tpu_torch.analysis import obs_rules as _obs_rules  # noqa: F401
from bioengine_tpu_torch.analysis import dist_rules as _dist_rules  # noqa: F401
from bioengine_tpu_torch.analysis import interproc as _interproc  # noqa: F401
from bioengine_tpu_torch.analysis import hotpath_rules as _hotpath_rules  # noqa: F401
from bioengine_tpu_torch.analysis import lifecycle_rules as _lifecycle_rules  # noqa: F401

from bioengine_tpu_torch.analysis.project import (
    analyze_project,
    build_project_index,
    parse_docs,
)

__all__ = [
    "Finding",
    "Rule",
    "Baseline",
    "all_rules",
    "analyze_file",
    "analyze_paths",
    "analyze_project",
    "analyze_source",
    "build_project_index",
    "fingerprint",
    "get_rule",
    "parse_docs",
]
