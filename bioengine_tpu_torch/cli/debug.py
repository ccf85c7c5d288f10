"""``bioengine debug`` — incident tooling over the worker's
observability verbs: the cross-host incident bundle, the flight
recorder, and on-demand device profiling of a live deployment.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import click

from bioengine_tpu_torch.cli.utils import emit, run_async, server_options, with_worker


@click.group("debug")
def debug_group() -> None:
    """Incident bundles, flight records, on-demand profiling."""


@debug_group.command("bundle")
@server_options
@click.option(
    "--output",
    "-o",
    default=None,
    help="Artifact path (default: bioengine-debug-<timestamp>.json)",
)
@click.option(
    "--event-limit", default=2000, show_default=True,
    help="Max flight events gathered per process",
)
def bundle_command(server_url, token, output, event_limit):
    """Gather ONE cross-host incident artifact: time-merged flight
    events, recent traces, metrics snapshots, and mesh/lease state
    from the controller and every reachable worker host."""
    result = run_async(
        with_worker(
            server_url,
            token,
            lambda w: w.debug_bundle(event_limit=event_limit),
        )
    )
    path = Path(
        output or f"bioengine-debug-{time.strftime('%Y%m%d-%H%M%S')}.json"
    )
    path.write_text(json.dumps(result, indent=2, default=str))
    hosts = result.get("hosts", {})
    reachable = sum(1 for h in hosts.values() if h.get("reachable"))
    summary = {
        "written": str(path),
        "events": len(result.get("events", [])),
        "traces": len(result.get("traces", [])),
        "hosts_reachable": reachable,
        "hosts_total": len(hosts),
        "dumps": len(result.get("dumps", [])),
    }
    emit(
        summary,
        human=(
            f"incident bundle -> {path}\n"
            f"  {summary['events']} flight events, "
            f"{summary['traces']} trace spans, "
            f"{summary['dumps']} dumps, "
            f"{reachable}/{len(hosts)} hosts reachable"
        ),
    )


@debug_group.command("journal")
@click.option(
    "--dir",
    "control_dir",
    default=None,
    help="Control-plane journal directory "
    "(default: $BIOENGINE_CONTROL_DIR)",
)
@click.option(
    "--tail", default=20, show_default=True,
    help="Journal records to show (newest last)",
)
def journal_command(control_dir, tail):
    """Inspect the controller's durable state OFFLINE: the compacted
    snapshot plus the journal tail (secrets redacted) — the first
    thing the 'Controller loss & upgrade' runbook reads after the
    epoch. Works against a dead controller's directory; no server
    needed."""
    import os

    from bioengine_tpu_torch.serving.journal import ControlJournal

    directory = control_dir or os.environ.get("BIOENGINE_CONTROL_DIR")
    if not directory:
        raise click.UsageError(
            "no journal directory: pass --dir or set BIOENGINE_CONTROL_DIR"
        )
    if not Path(directory).expanduser().exists():
        raise click.UsageError(f"journal directory not found: {directory}")
    info = ControlJournal(directory).inspect(tail=tail)
    snap = info.get("snapshot") or {}
    lines = [
        f"directory: {info['directory']}",
        f"snapshot: epoch={snap.get('epoch', '-')} "
        f"seq={snap.get('seq', '-')} apps={len(snap.get('apps') or {})} "
        f"recovering={snap.get('recovering', False)}"
        if snap
        else "snapshot: (none)",
        f"journal: {info['journal_records']} record(s)"
        + (" — TORN TAIL (truncated final record discarded)"
           if info["torn_tail"] else ""),
    ]
    for app_id, entry in (snap.get("apps") or {}).items():
        deps = ", ".join(
            f"{s.get('name')}x{s.get('num_replicas')}"
            for s in entry.get("specs", [])
        )
        lines.append(f"  app {app_id}: {deps}")
    if info["tail"]:
        lines.append(f"tail (last {len(info['tail'])}):")
        for r in info["tail"]:
            lines.append(
                f"  #{r.get('seq')} "
                f"{time.strftime('%H:%M:%S', time.localtime(r.get('ts', 0)))} "
                f"epoch={r.get('epoch')} {r.get('op')} "
                + json.dumps(r.get("data") or {}, default=str)[:160]
            )
    emit(info, human="\n".join(lines))


@debug_group.command("flight")
@server_options
@click.option("--limit", default=50, show_default=True)
@click.option(
    "--since", default=None, type=float,
    help="Wall-clock cursor: only events at/after this unix time",
)
def flight_command(server_url, token, limit, since):
    """Tail the worker's flight-recorder ring (newest last)."""
    record = run_async(
        with_worker(
            server_url,
            token,
            lambda w: w.get_flight_record(limit=limit, since=since),
        )
    )
    lines = [
        f"{time.strftime('%H:%M:%S', time.localtime(e['ts']))} "
        f"[{e['severity']:7s}] {e['type']:18s} "
        + " ".join(f"{k}={v}" for k, v in e.get("attrs", {}).items())
        for e in record.get("events", [])
    ]
    emit(record, human="\n".join(lines) or "(flight ring is empty)")


@debug_group.command("profile")
@server_options
@click.argument("app_id")
@click.option("--deployment", default=None)
@click.option("--replica", "replica_id", default=None)
@click.option(
    "--action",
    type=click.Choice(["start", "stop", "memory"]),
    default="start",
    show_default=True,
)
@click.option("--trace-dir", default=None)
def profile_command(
    server_url, token, app_id, deployment, replica_id, action, trace_dir
):
    """Profile one replica of a live deployment (torch.profiler on the
    process that runs it; the trace is Chrome trace JSON, for Perfetto or
    chrome://tracing)."""
    result = run_async(
        with_worker(
            server_url,
            token,
            lambda w: w.profile_replica(
                app_id,
                deployment=deployment,
                replica_id=replica_id,
                action=action,
                trace_dir=trace_dir,
            ),
        )
    )
    if action == "memory":
        # the allocator snapshot is bytes-heavy; print the per-device stats
        human = json.dumps(
            {
                k: v
                for k, v in result.items()
                if k != "allocator_snapshot_pickle_b64"
            },
            indent=2,
            default=str,
        )
    else:
        human = json.dumps(result, indent=2, default=str)
    emit(result, human=human)
