"""``bioengine-torch scenarios`` — run replayable synthetic incidents.

The scenario engine (bioengine_tpu_torch/testing/scenarios.py) turns the
failure modes production will eventually throw — slow-but-alive
replicas, preemption storms, tenant floods, diurnal waves, connection
blip storms — into seeded, time-compressed, DETERMINISTIC runs against
the in-process multi-host harness, each checked against declarative
invariants. ``run`` executes one (optionally twice, diffing the
outcome sequences — the determinism gate), ``list`` shows the catalog.
The in-process worker hosts of a scenario run on ``--device`` (default
``cuda``, every visible card) with ``--n-devices`` chips each; on the CPU
a host holds 8 chips unless told otherwise.
"""

from __future__ import annotations

import json
from typing import Optional

import click

from bioengine_tpu_torch.cli.utils import emit


# chips per in-process host on the CPU: the JAX test suite's layout
CPU_CHIPS_PER_HOST = 8

device_option = click.option(
    "--device",
    default="cuda",
    show_default=True,
    help="Where the in-process worker hosts run (cuda or cpu)",
)
n_devices_option = click.option(
    "--n-devices",
    default=None,
    type=int,
    help="Chips per worker host [default: every card on cuda, "
    f"{CPU_CHIPS_PER_HOST} on cpu]",
)


def _host_chips(scenario, device: str, n_devices: Optional[int]):
    """The ``n_devices`` each worker host of ``scenario`` gets. A scenario
    with hosts whose replicas need more chips than one host holds fails
    here with a placement error: a lease is never shrunk, and the run
    never drops to the CPU on its own."""
    if n_devices is None and device == "cpu":
        n_devices = CPU_CHIPS_PER_HOST
    if scenario.n_hosts == 0 or scenario.chips_per_replica <= 0:
        return n_devices  # no host: the device is never touched
    from bioengine_tpu_torch.cluster.topology import detect_topology

    try:
        have = detect_topology(device, n_devices).n_chips
    except (RuntimeError, ValueError) as e:
        raise click.ClickException(
            f"scenario '{scenario.name}' needs worker hosts on {device}: "
            f"{e}; run it with --device cpu"
        ) from None
    need = scenario.chips_per_replica
    if have < need:
        fix = (
            f"--n-devices {need}"
            if device == "cpu"
            else f"--device cpu ({CPU_CHIPS_PER_HOST} CPU chips per host) "
            f"or on a machine with {need} cards"
        )
        raise click.ClickException(
            f"scenario '{scenario.name}' places replicas of {need} chips "
            f"on its worker hosts, and a host on {device} holds {have} "
            f"({need - have} chip(s) short); run it with {fix}"
        )
    return n_devices


@click.group("scenarios")
def scenarios_group() -> None:
    """Deterministic synthetic incidents (scenario engine)."""


@scenarios_group.command("list")
def scenarios_list_command() -> None:
    """The named-scenario catalog: what each one injects and checks."""
    from bioengine_tpu_torch.testing.scenarios import list_scenarios

    rows = list_scenarios()
    lines = []
    for s in rows:
        topo = (
            f"{s['hosts']}h/{s['replicas']}r"
            if s["hosts"]
            else f"local/{s['replicas']}r"
        )
        sched = " sched" if s["scheduled"] else ""
        lines.append(f"{s['name']:<18} {topo:>9}{sched:<6} {s['description']}")
        if s["faults"]:
            lines.append(
                "                   faults: "
                + ", ".join(
                    f"t{f['tick']}:{f['action']}"
                    + (f"@{f['host']}" if f["host"] else "")
                    for f in s["faults"]
                )
            )
    emit(rows, human="\n".join(lines))


@scenarios_group.command("run")
@click.argument("name")
@click.option("--seed", default=0, show_default=True, help="Workload seed")
@click.option(
    "--no-defenses",
    is_flag=True,
    help="Disable probation + hedging (show the undefended degradation)",
)
@click.option(
    "--check-determinism",
    is_flag=True,
    help="Run twice with the same seed and diff the outcome sequences",
)
@click.option(
    "--out", default=None, help="Write the full result artifact as JSON"
)
@device_option
@n_devices_option
def scenarios_run_command(
    name, seed, no_defenses, check_determinism, out, device, n_devices
):
    """Run one named scenario and enforce its invariants (non-zero exit
    on any required-invariant failure or a determinism mismatch)."""
    import logging

    # replica/controller lifecycle chatter would drown the verdict
    logging.disable(logging.WARNING)
    from bioengine_tpu_torch.testing.scenarios import (
        get_scenario,
        outcome_signature,
        run_scenario,
    )

    scenario = get_scenario(name)
    n_devices = _host_chips(scenario, device, n_devices)
    defenses = not no_defenses
    result = run_scenario(
        scenario, seed=seed, defenses=defenses, device=device,
        n_devices=n_devices,
    )
    runs = [result]
    deterministic = None
    if check_determinism:
        second = run_scenario(
            scenario, seed=seed, defenses=defenses, device=device,
            n_devices=n_devices,
        )
        runs.append(second)
        deterministic = outcome_signature(result) == outcome_signature(second)

    lines = [
        f"scenario {name} seed={seed} defenses={defenses}: "
        f"{'PASS' if result['passed'] else 'FAIL'} "
        f"({result['requests']} requests, {result['counts']})",
        f"  latency p50/p95/p99 ms: "
        f"{result['latency_ms']['p50']}/{result['latency_ms']['p95']}"
        f"/{result['latency_ms']['p99']}  "
        f"probations={result['probations']} hedges={result['hedges']}",
    ]
    for iname, v in result["invariants"].items():
        mark = "ok " if v["ok"] else "FAIL"
        req = "" if v["required"] else " (informational)"
        lines.append(f"  [{mark}] {iname}{req}: {v['detail']}")
    if deterministic is not None:
        lines.append(
            f"  determinism: {'identical' if deterministic else 'DIVERGED'}"
        )

    artifact = {
        "result": {k: v for k, v in result.items() if k != "outcomes"},
        "deterministic": deterministic,
    }
    if out:
        with open(out, "w") as f:
            json.dump({**artifact, "runs": runs}, f, indent=2, default=str)
        lines.append(f"  artifact: {out}")
    emit(artifact, human="\n".join(lines))
    if not result["passed"] or deterministic is False:
        raise SystemExit(1)
