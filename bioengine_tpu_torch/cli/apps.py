"""``bioengine apps`` — application lifecycle from the shell.

Capability parity with ref bioengine/cli/apps.py:91-679: upload, run
(deploy with kwargs/env/ACL), list, status, logs, stop, and the combined
deploy (upload + run). Uploads send FILE CONTENTS over RPC (the
reference's dir→file-list upload), so the worker never needs to see the
client's filesystem.
"""

from __future__ import annotations

import asyncio
import json

import click

from bioengine_tpu_torch.cli.utils import (
    emit,
    parse_env_args,
    parse_json_opt,
    read_dir_files,
    run_async,
    server_options,
    with_worker,
)


@click.group("apps")
def apps_group() -> None:
    """Manage BioEngine applications."""


async def _upload_dir(worker, src_dir, artifact_id=None, version=None) -> dict:
    # bulk file reads off the loop — the RPC connection heartbeats on it
    files = await asyncio.to_thread(read_dir_files, src_dir)
    return await worker.upload_app(
        files=files, artifact_id=artifact_id, version=version
    )


@apps_group.command("upload")
@click.argument("src_dir", type=click.Path(exists=True, file_okay=False))
@click.option("--artifact-id", default=None)
@click.option("--version", default=None)
@server_options
def upload_command(src_dir, artifact_id, version, server_url, token):
    """Upload an app directory to the worker's artifact store."""
    result = run_async(
        with_worker(
            server_url,
            token,
            lambda w: _upload_dir(w, src_dir, artifact_id, version),
        )
    )
    emit(result, human=f"uploaded {result['artifact_id']}@{result['version']}")


@apps_group.command("run")
@click.option("--artifact-id", default=None)
@click.option("--version", default=None)
@click.option(
    "--local-path",
    default=None,
    type=click.Path(exists=True, file_okay=False),
    help="App directory on THIS machine (uploaded, then deployed)",
)
@click.option("--app-id", default=None, help="Reuse an id (update in place)")
@click.option(
    "--deployment-kwargs", default=None, help="JSON {deployment: {kwarg: v}}"
)
@click.option("--env", "env_vars", multiple=True, help="k=v env var; repeatable")
@click.option(
    "--authorized-users", default=None, help="Comma-separated ACL override"
)
@click.option("--auto-redeploy", is_flag=True)
@server_options
def run_command(
    artifact_id,
    version,
    local_path,
    app_id,
    deployment_kwargs,
    env_vars,
    authorized_users,
    auto_redeploy,
    server_url,
    token,
):
    """Deploy an app from an uploaded artifact or a local directory."""
    if not artifact_id and not local_path:
        raise click.UsageError("need --artifact-id or --local-path")
    kwargs = dict(
        artifact_id=artifact_id,
        version=version,
        app_id=app_id,
        deployment_kwargs=parse_json_opt(deployment_kwargs, "--deployment-kwargs"),
        env_vars=parse_env_args(env_vars) or None,
        authorized_users=(
            [u.strip() for u in authorized_users.split(",")]
            if authorized_users
            else None
        ),
        auto_redeploy=auto_redeploy,
    )

    async def action(worker):
        if local_path:
            up = await _upload_dir(worker, local_path)
            kwargs["artifact_id"] = up["artifact_id"]
            kwargs["version"] = up["version"]
        return await worker.deploy_app(**kwargs)

    result = run_async(with_worker(server_url, token, action))
    emit(
        result,
        human=(
            f"deployed {result['app_id']} ({result['name']}) "
            f"methods: {', '.join(result['methods'])}"
        ),
    )


@apps_group.command("list")
@server_options
def list_command(server_url, token):
    """List uploaded app artifacts."""
    result = run_async(with_worker(server_url, token, lambda w: w.list_apps()))
    lines = [
        f"{a['artifact_id']:30s} latest={a['latest']} versions={len(a['versions'])}"
        for a in result
    ]
    emit(result, human="\n".join(lines) or "(no apps)")


def _cold_start_lines(status: dict) -> list[str]:
    """One line per deployment with a cold_start section: warm-pool
    occupancy/promotions, last-replica TTFR, and the compile-tier hit
    rate — the at-a-glance view of whether scale-ups are warm."""
    lines: list[str] = []
    apps = status if "deployments" not in status else {"": status}
    for app_id, st in apps.items():
        for name, dep in (st.get("deployments") or {}).items():
            cold = dep.get("cold_start") or {}
            pool = cold.get("warm_pool")
            ttfr = (cold.get("last_replica_ttfr") or {}).get("ttfr_seconds")
            compile_ = cold.get("compile") or {}
            parts = [f"{app_id + '/' if app_id else ''}{name}:"]
            parts.append(
                f"warm_pool {pool['occupancy']}/{pool['target']} "
                f"(promotions={pool['promotions']})"
                if pool
                else "warm_pool off"
            )
            parts.append(
                f"last_ttfr={ttfr:.3f}s" if ttfr is not None else "last_ttfr=-"
            )
            hr = compile_.get("hit_rate")
            parts.append(
                f"compile_hits={compile_.get('persistent_cache_hits', 0)}"
                f"/{(compile_.get('persistent_cache_hits', 0) or 0) + (compile_.get('real_compiles', 0) or 0)}"
                + (f" ({hr:.0%})" if hr is not None else "")
            )
            lines.append("  ".join(parts))
    return lines


def _mesh_lines(status: dict) -> list[str]:
    """One line per cross-host mesh replica: kind x stages, the hosts
    each shard landed on, and the cross-shard transfer rate — one
    logical deployment over several hosts, readable at a glance."""
    lines: list[str] = []
    apps = status if "deployments" not in status else {"": status}
    for app_id, st in apps.items():
        for name, dep in (st.get("deployments") or {}).items():
            for rid, mesh in (dep.get("cross_host_mesh") or {}).items():
                shards = mesh.get("shards") or []
                placed = ", ".join(
                    f"s{s['stage']}@{s['host_id']}"
                    f"({len(s.get('device_ids') or [])}ch)"
                    for s in shards
                )
                transfer = mesh.get("transfer") or {}
                rate = transfer.get("transfer_bytes_per_sec")
                lines.append(
                    f"{app_id + '/' if app_id else ''}{name} {rid}: "
                    f"{mesh.get('kind')} mesh {mesh.get('mesh_shape')} "
                    f"{'cross-host' if mesh.get('cross_host') else 'one host'}"
                    f" [{placed}]  transfer "
                    f"{transfer.get('transfer_bytes', 0)}B"
                    + (f" @ {rate / 1e6:.1f}MB/s" if rate else "")
                )
    return lines


def _controller_line(status: dict) -> str:
    """The durable-control-plane header: fencing epoch + phase, and —
    while a restarted controller reconciles — the adopt/replace/drop
    counters an operator watches converge."""
    apps = status if "deployments" not in status else {"": status}
    for st in apps.values():
        ctl = (st or {}).get("controller")
        if not ctl:
            continue
        line = f"controller: epoch={ctl.get('epoch')} phase={ctl.get('phase')}"
        rec = ctl.get("reconcile")
        if rec and ctl.get("phase") == "RECOVERING":
            line += (
                f" (reconciling: adopted={rec.get('adopted', 0)} "
                f"replaced={rec.get('replaced', 0)} "
                f"dropped={rec.get('dropped', 0)})"
            )
        return line
    return ""


@apps_group.command("status")
@click.argument("app_id", required=False)
@server_options
def status_command(app_id, server_url, token):
    """Deployment status for one app or all deployed apps."""
    result = run_async(
        with_worker(server_url, token, lambda w: w.get_app_status(app_id=app_id))
    )
    cold = _cold_start_lines(result if isinstance(result, dict) else {})
    mesh = _mesh_lines(result if isinstance(result, dict) else {})
    ctl = _controller_line(result if isinstance(result, dict) else {})
    human = json.dumps(result, indent=2, default=str)
    if mesh:
        human = "mesh:\n" + "\n".join(mesh) + "\n\n" + human
    if cold:
        human = "cold-start:\n" + "\n".join(cold) + "\n\n" + human
    if ctl:
        human = ctl + "\n\n" + human
    emit(result, human=human)


@apps_group.command("logs")
@click.argument("app_id")
@server_options
def logs_command(app_id, server_url, token):
    """Per-replica logs (incl. dead replicas) for an app."""

    async def action(worker):
        status = await worker.get_app_status(app_id=app_id)
        return status.get("replica_logs", {})

    result = run_async(with_worker(server_url, token, action))
    human = []
    for replica, lines in result.items():
        human.append(f"== {replica} ==")
        human.extend(lines if isinstance(lines, list) else [str(lines)])
    emit(result, human="\n".join(human) or "(no logs)")


@apps_group.command("stop")
@click.argument("app_id")
@server_options
def stop_command(app_id, server_url, token):
    """Undeploy an app."""
    result = run_async(
        with_worker(server_url, token, lambda w: w.stop_app(app_id=app_id))
    )
    emit(result, human=f"stopped {result['app_id']}")


@apps_group.command("deploy")
@click.argument("src_dir", type=click.Path(exists=True, file_okay=False))
@click.option("--version", default=None)
@click.option("--auto-redeploy", is_flag=True)
@server_options
def deploy_command(src_dir, version, auto_redeploy, server_url, token):
    """Upload SRC_DIR then deploy it (combined upload + run)."""

    async def action(worker):
        up = await _upload_dir(worker, src_dir, version=version)
        dep = await worker.deploy_app(
            artifact_id=up["artifact_id"],
            version=up["version"],
            auto_redeploy=auto_redeploy,
        )
        return {**up, **dep}

    result = run_async(with_worker(server_url, token, action))
    emit(
        result,
        human=(
            f"deployed {result['app_id']} from "
            f"{result['artifact_id']}@{result['version']}"
        ),
    )
