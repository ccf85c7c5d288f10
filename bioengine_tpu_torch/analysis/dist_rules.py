"""Distributed-contract pass (BE-DIST-2xx): cross-module drift checks.

Growth left the serving stack held together by
stringly-typed contracts no single-module lint can see: RPC verb names
registered in one process and sent from another, capability tokens
negotiated at handshake, flight-event types and metric families whose
catalog lives in docs/observability.md, and ``BIOENGINE_*`` env knobs
whose tables live in docs/OPERATIONS.md and friends.  These rules run
over the whole-program fact base (phase 2) and fail CI when the two
sides of a contract drift:

- BE-DIST-201 — a verb sent over RPC that no service registers
  (misspelled or removed verb: the call fails at runtime, on the
  unhappy path, usually during an incident).
- BE-DIST-202 — a registered verb nothing calls (by constant verb
  string or attribute-call name anywhere in the project): dead wire
  surface, or the *caller* got misspelled.
- BE-DIST-203 — a capability token offered in a handshake list but
  never gated (dead negotiation), or gated but never offered (the
  gate can never pass on a spec-following peer).
- BE-DIST-204 — a flight event emitted / metric family registered in
  code but missing from the docs/observability.md catalog, or a
  catalog row nothing emits (operators grep the catalog during
  incidents; a stale catalog lies to them).
- BE-DIST-205 — a ``BIOENGINE_*`` env knob read in code but not
  documented in any docs/*.md knob table.

Doc-dependent rules (204/205) disable themselves when the project has
no docs tree / no catalog sections, so fixture projects and other
repos never misfire.
"""

from __future__ import annotations

from fnmatch import fnmatchcase
from typing import Iterator

from bioengine_tpu_torch.analysis.core import (
    Finding,
    Rule,
    register_project_pass,
    register_rule,
)
from bioengine_tpu_torch.analysis.project import ProjectContext

UNREGISTERED_VERB = register_rule(
    Rule(
        "BE-DIST-201",
        "unregistered-verb-call",
        "RPC verb sent over the wire but registered by no service",
        "dist",
        project=True,
    )
)
DEAD_VERB = register_rule(
    Rule(
        "BE-DIST-202",
        "dead-registered-verb",
        "Registered RPC verb that nothing in the project calls",
        "dist",
        project=True,
    )
)
CAPABILITY_DRIFT = register_rule(
    Rule(
        "BE-DIST-203",
        "capability-offer-gate-drift",
        "Capability token offered but never gated, or gated but never "
        "offered",
        "dist",
        project=True,
    )
)
OBS_CATALOG_DRIFT = register_rule(
    Rule(
        "BE-DIST-204",
        "observability-catalog-drift",
        "Flight event / metric family undocumented, or documented but "
        "never emitted",
        "dist",
        project=True,
    )
)
UNDOCUMENTED_KNOB = register_rule(
    Rule(
        "BE-DIST-205",
        "undocumented-env-knob",
        "BIOENGINE_* env knob read in code but absent from the docs",
        "dist",
        project=True,
    )
)


def _names_match(name: str, pattern: str) -> bool:
    """Either side may carry a ``*`` wildcard (docs document families
    like ``rpc_msgs_*``; code emits f-string prefixes as ``rpc_*``)."""
    return fnmatchcase(name, pattern) or fnmatchcase(pattern, name)


def run_dist_pass(ctx: ProjectContext) -> Iterator[Finding]:
    yield from _check_verbs(ctx)
    yield from _check_capabilities(ctx)
    yield from _check_observability_catalog(ctx)
    yield from _check_env_knobs(ctx)


# ---------------------------------------------------------------------------
# BE-DIST-201 / 202 — verbs
# ---------------------------------------------------------------------------


def _check_verbs(ctx: ProjectContext) -> Iterator[Finding]:
    registered: dict[str, tuple[str, int, int]] = {}
    called: set[str] = set()
    attr_called: set[str] = set()
    calls: list[tuple[str, str, str, int, int]] = []

    for path, idx in sorted(ctx.modules.items()):
        for verb, line, col in idx["verbs_registered"]:
            registered.setdefault(verb, (path, line, col))
        for service, verb, line, col in idx["verb_calls"]:
            called.add(verb)
            calls.append((path, service or "<dynamic>", verb, line, col))
        attr_called.update(idx["attr_calls"])

    if not registered:
        # nothing registers services in scope (single-file scans,
        # other projects): no verb contract to check
        return

    for path, service, verb, line, col in calls:
        if verb not in registered:
            yield ctx.finding(
                UNREGISTERED_VERB.id, path, line, col,
                f"verb '{verb}' (service '{service}') is sent over RPC "
                f"but registered by no service in the project — "
                f"misspelled or removed? The call fails at runtime with "
                f"'unknown method'",
            )

    for verb, (path, line, col) in sorted(registered.items()):
        if verb in called or verb in attr_called:
            continue
        yield ctx.finding(
            DEAD_VERB.id, path, line, col,
            f"registered verb '{verb}' is never called anywhere in the "
            f"project (no constant verb string, no `.{verb}(...)` "
            f"attribute call) — dead wire surface, or the caller is "
            f"misspelled",
        )


# ---------------------------------------------------------------------------
# BE-DIST-203 — capabilities
# ---------------------------------------------------------------------------


def _check_capabilities(ctx: ProjectContext) -> Iterator[Finding]:
    defined: dict[str, tuple[str, str, int, int]] = {}  # symbol -> loc
    value_to_symbol: dict[str, str] = {}
    offered: set[str] = set()
    gated: set[str] = set()

    for path, idx in sorted(ctx.modules.items()):
        for symbol, value, line, col in idx["caps_defined"]:
            defined.setdefault(symbol, (path, value, line, col))
            value_to_symbol.setdefault(value, symbol)

    def canon(token: str) -> str:
        # facts carry either the PROTO_* symbol or the raw value
        return token if token.startswith("PROTO_") else (
            value_to_symbol.get(token, token)
        )

    for idx in ctx.modules.values():
        for token, _line, _col in idx["caps_offered"]:
            offered.add(canon(token))
        for token, _line, _col in idx["caps_gated"]:
            gated.add(canon(token))

    for symbol, (path, value, line, col) in sorted(defined.items()):
        is_offered = symbol in offered
        is_gated = symbol in gated
        if is_offered and not is_gated:
            yield ctx.finding(
                CAPABILITY_DRIFT.id, path, line, col,
                f"capability '{value}' ({symbol}) is offered in a "
                f"handshake list but no code path gates on it "
                f"(`peer_supports` / membership test) — dead "
                f"negotiation: peers advertise it, nothing changes "
                f"behavior",
            )
        elif is_gated and not is_offered:
            yield ctx.finding(
                CAPABILITY_DRIFT.id, path, line, col,
                f"capability '{value}' ({symbol}) is gated on but never "
                f"offered in any handshake list — the gate can never "
                f"pass against a spec-following peer",
            )


# ---------------------------------------------------------------------------
# BE-DIST-204 — flight events + metric families vs docs/observability.md
# ---------------------------------------------------------------------------


def _check_observability_catalog(ctx: ProjectContext) -> Iterator[Finding]:
    docs = ctx.docs

    if docs.has_event_catalog:
        emitted: dict[str, tuple[str, int, int]] = {}
        for path, idx in sorted(ctx.modules.items()):
            for name, line, col in idx["flight_events"]:
                emitted.setdefault(name, (path, line, col))
        for name, (path, line, col) in sorted(emitted.items()):
            if not any(_names_match(name, doc) for doc in docs.events):
                yield ctx.finding(
                    OBS_CATALOG_DRIFT.id, path, line, col,
                    f"flight event '{name}' is emitted here but missing "
                    f"from the docs/observability.md event catalog — "
                    f"operators grep that catalog during incidents",
                )
        # the documented-but-never-emitted direction only makes sense
        # when the scanned scope is the real emitting codebase — a
        # single-file scan emits nothing and would flag every row
        if emitted:
            for doc_name, (doc_path, doc_line) in sorted(
                docs.events.items()
            ):
                if not any(
                    _names_match(code, doc_name) for code in emitted
                ):
                    yield ctx.finding(
                        OBS_CATALOG_DRIFT.id, doc_path, doc_line, 0,
                        f"flight event '{doc_name}' is documented in "
                        f"the event catalog but no code path emits it — "
                        f"stale row, or the emitter was renamed",
                    )

    if docs.has_metric_catalog:
        metric_names: dict[str, tuple[str, int, int]] = {}
        for path, idx in sorted(ctx.modules.items()):
            for name, line, col in idx["metric_names"]:
                metric_names.setdefault(name, (path, line, col))
        for name, (path, line, col) in sorted(metric_names.items()):
            if "*" in name:
                continue  # dynamic f-string family: docs side checks it
            if not any(_names_match(name, doc) for doc in docs.metrics):
                yield ctx.finding(
                    OBS_CATALOG_DRIFT.id, path, line, col,
                    f"metric family '{name}' is registered here but "
                    f"missing from the docs/observability.md metric "
                    f"catalog",
                )
        if metric_names:
            for doc_name, (doc_path, doc_line) in sorted(
                docs.metrics.items()
            ):
                if not any(
                    _names_match(code, doc_name) for code in metric_names
                ):
                    yield ctx.finding(
                        OBS_CATALOG_DRIFT.id, doc_path, doc_line, 0,
                        f"metric family '{doc_name}' is documented in "
                        f"the metric catalog but never registered or "
                        f"sampled by any code path",
                    )


# ---------------------------------------------------------------------------
# BE-DIST-205 — env knobs vs the docs knob tables
# ---------------------------------------------------------------------------


def _check_env_knobs(ctx: ProjectContext) -> Iterator[Finding]:
    if not ctx.docs.has_docs:
        return
    seen: dict[str, tuple[str, int, int]] = {}
    for path, idx in sorted(ctx.modules.items()):
        for knob, line, col in idx["env_reads"]:
            seen.setdefault(knob, (path, line, col))
    for knob, (path, line, col) in sorted(seen.items()):
        if knob in ctx.docs.knobs:
            continue
        yield ctx.finding(
            UNDOCUMENTED_KNOB.id, path, line, col,
            f"env knob '{knob}' is read here but documented nowhere "
            f"under docs/ — add it to the knob tables in "
            f"docs/OPERATIONS.md (operational) or the subsystem guide "
            f"it belongs to",
        )


register_project_pass("dist", run_dist_pass)
