"""``bioengine cluster`` — cluster state from the shell.

Capability parity with ref bioengine/cli/cluster.py:48-131 (human/JSON
view of the worker's cluster status).
"""

from __future__ import annotations

import click

from bioengine_tpu_torch.cli.utils import emit, run_async, server_options, with_worker


@click.group("cluster")
def cluster_group() -> None:
    """Inspect the worker's compute substrate."""


@cluster_group.command("status")
@server_options
def status_command(server_url, token):
    """Topology, worker processes, and utilization snapshot."""

    async def action(worker):
        status = await worker.get_status()
        return status["cluster"]

    cluster = run_async(with_worker(server_url, token, action))
    topo = cluster.get("topology") or {}
    lines = [
        f"mode:   {cluster.get('mode')}",
        f"ready:  {cluster.get('ready')}",
        f"chips:  {topo.get('n_chips')} x {topo.get('platform')} "
        f"across {topo.get('n_hosts')} host(s)",
        f"workers: {len(cluster.get('workers', []))}",
    ]
    emit(cluster, human="\n".join(lines))


@cluster_group.command("traces")
@click.option("--name", default=None, help="filter by span name")
@click.option("--max-spans", default=30, type=int)
@server_options
def traces_command(name, max_spans, server_url, token):
    """Recent control-plane spans (deploys, replica placements)."""

    async def action(worker):
        return await worker.get_traces(name=name, max_spans=max_spans)

    spans = run_async(with_worker(server_url, token, action))
    lines = [
        f"{s['name']:<16} {s['duration_s']*1000:9.1f} ms  "
        f"{s.get('attrs') or ''}"
        + (f"  ERROR {s['error']}" if s.get("error") else "")
        for s in spans
    ]
    emit(spans, human="\n".join(lines) or "no spans recorded")


@cluster_group.command("profile")
@click.option("--start", "action_name", flag_value="start",
              help="start a torch.profiler trace on the worker")
@click.option("--stop", "action_name", flag_value="stop",
              help="stop the active trace")
@click.option("--memory", "action_name", flag_value="memory",
              help="device-memory snapshot (CUDA allocator snapshot + "
              "per-device stats)")
@click.option("--trace-dir", default=None)
@server_options
def profile_command(action_name, trace_dir, server_url, token):
    """Drive the worker's torch.profiler surface."""
    if action_name is None:
        raise click.UsageError("pass one of --start / --stop / --memory")

    async def action(worker):
        if action_name == "start":
            return await worker.start_profiling(trace_dir=trace_dir)
        if action_name == "stop":
            return await worker.stop_profiling()
        result = await worker.memory_profile()
        # the allocator snapshot is for files, not terminals
        return {
            "devices": result["devices"],
            "allocator_snapshot_bytes": len(
                result["allocator_snapshot_pickle_b64"]
            ) * 3 // 4,
        }

    result = run_async(with_worker(server_url, token, action))
    emit(result, human=str(result))
