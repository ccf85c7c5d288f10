"""``bioengine slo`` / ``bioengine top`` — fleet questions answered
from the controller's telemetry history and SLO engine: is every
deployment meeting its objectives, how fast is each burning its error
budget, and what is the fleet doing right now.
"""

from __future__ import annotations

import time

import click

from bioengine_tpu_torch.cli.utils import emit, run_async, server_options, with_worker


def _fmt(value, unit: str = "", width: int = 9, digits: int = 1) -> str:
    if value is None:
        return "-".rjust(width)
    return f"{value:.{digits}f}{unit}".rjust(width)


def _alert_flag(alert) -> str:
    if not alert or alert.get("state") in (None, "inactive"):
        return "ok"
    state = alert["state"]
    if state == "resolved":
        return "resolved"
    return f"{state}({alert.get('severity')})"


@click.group("slo")
def slo_group() -> None:
    """Service objectives: burn rates, budgets, alert state."""


@slo_group.command("status")
@server_options
@click.option("--app", default=None, help="Filter to one app id")
def slo_status_command(server_url, token, app):
    """Per-deployment SLO status: burn rates over every rule window,
    error budget remaining, alert lifecycle state, and any
    auto-captured incident bundles."""
    result = run_async(
        with_worker(server_url, token, lambda w: w.get_slo_status())
    )
    lines = []
    deployments = result.get("deployments", {})
    for key, status in sorted(deployments.items()):
        if app is not None and not key.startswith(f"{app}/"):
            continue
        lines.append(f"{key}  (burn_pressure={status.get('burn_pressure')})")
        for objective, o in sorted(status.get("objectives", {}).items()):
            alert = o.get("alert") or {}
            target = o.get("target")
            head = (
                f"latency p{target} < {o.get('latency_objective_ms')}ms"
                if objective == "latency"
                else f"availability {target}%"
            )
            lines.append(
                f"  {objective:12s} {head:32s} "
                f"budget_remaining={o.get('budget_remaining')} "
                f"alert={_alert_flag(alert)} "
                f"burn_short={alert.get('burn_short', 0.0)} "
                f"burn_long={alert.get('burn_long', 0.0)}"
            )
    for b in result.get("auto_bundles", []):
        a = b.get("alert") or {}
        lines.append(
            f"  auto-bundle @{b.get('generated_at')}: "
            f"{a.get('app')}/{a.get('deployment')} {a.get('objective')} "
            f"({b.get('events')} events)"
        )
    if not lines:
        lines = ["(no deployments carry an slo: block)"]
    emit(result, human="\n".join(lines))


@click.command("top")
@server_options
@click.option(
    "--watch", default=0, show_default=True,
    help="Refresh every N seconds (0 = print once)",
)
@click.option(
    "--since-s", default=300.0, show_default=True,
    help="History window to summarize (seconds)",
)
def top_command(server_url, token, watch, since_s):
    """Fleet overview: per-deployment request/error rates, latency
    quantiles, queue depth, chip-seconds, and SLO alert state — the
    controller's telemetry store rendered as one table."""

    async def fetch(w):
        # wall-clock CURSOR (the store keys history by wall time), not
        # a duration  # bioengine: ignore[BE-OBS-001]
        since = time.time() - since_s
        telem = await w.get_telemetry(since=since)
        slo = await w.get_slo_status()
        return {"telemetry": telem, "slo": slo}

    def render(result) -> str:
        telem = result["telemetry"]
        slo_by_dep = result["slo"].get("deployments", {})
        header = (
            f"{'deployment':28s} {'req/s':>9s} {'err/s':>9s} "
            f"{'p50 ms':>9s} {'p99 ms':>9s} {'queue':>7s} "
            f"{'chip s':>9s} {'shed/s':>9s}  slo"
        )
        rows = [header, "-" * len(header)]

        def latest(points):
            for p in reversed(points or []):
                if p.get("value") is not None:
                    return p["value"]
            return None

        for key, series in sorted(telem.get("deployments", {}).items()):
            alerts = [
                _alert_flag(o.get("alert"))
                for o in slo_by_dep.get(key, {}).get("objectives", {}).values()
            ]
            # top's column answers "needs attention NOW" — a recently
            # recovered alert shows its resolved badge but a fleet scan
            # must not read it as unhealthy (slo status keeps the detail)
            firing = [a for a in alerts if a not in ("ok", "resolved")]
            p50 = latest(series.get("latency_p50"))
            p99 = latest(series.get("latency_p99"))
            rows.append(
                f"{key:28s} "
                f"{_fmt(latest(series.get('request_rate')))} "
                f"{_fmt(latest(series.get('error_rate')), digits=2)} "
                f"{_fmt(p50 * 1000.0 if p50 is not None else None)} "
                f"{_fmt(p99 * 1000.0 if p99 is not None else None)} "
                f"{_fmt(latest(series.get('queue_depth')), width=7, digits=0)} "
                f"{_fmt(latest(series.get('chip_seconds')), digits=2)} "
                f"{_fmt(latest(series.get('shed_rate')), digits=2)}  "
                + (",".join(firing) if firing else "ok")
            )
        if len(rows) == 2:
            rows.append("(no telemetry history yet)")
        store = telem.get("store", {})
        rows.append(
            f"\nstore: {store.get('series')} series, hosts pushing: "
            f"{sorted((store.get('hosts') or {}))}"
        )
        return "\n".join(rows)

    result = run_async(with_worker(server_url, token, fetch))
    if not watch:
        emit(result, human=render(result))
        return
    try:
        while True:
            click.clear()
            click.echo(render(result))
            time.sleep(watch)
            result = run_async(with_worker(server_url, token, fetch))
    except KeyboardInterrupt:
        pass
