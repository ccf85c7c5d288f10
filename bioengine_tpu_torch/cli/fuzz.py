"""``bioengine-torch fuzz`` — coverage-guided chaos fuzzing.

Search mode composes fault schedules onto a fuzz topology, scores
novelty, and shrinks any universal-invariant failure to a minimal
replayable JSON artifact (testing/fuzz.py). ``--replay FILE``
re-executes an artifact bit-deterministically and exits non-zero if
the recorded red set no longer reproduces or two replays diverge —
the mode tier-1 uses to hold the regression corpus green. The
substrate's worker hosts run on ``--device`` (default ``cuda``) with
``--n-devices`` chips each, 8 on the CPU unless told otherwise.
"""

from __future__ import annotations

import os

import click

from bioengine_tpu_torch.cli.scenarios import (
    _host_chips,
    device_option,
    n_devices_option,
)
from bioengine_tpu_torch.cli.utils import emit


def _quiet_logs() -> None:
    import logging

    # replica/controller lifecycle chatter would drown the verdict
    logging.disable(logging.WARNING)


@click.command("fuzz")
@click.option(
    "--replay",
    "replay_path",
    default=None,
    type=click.Path(exists=True, dir_okay=False),
    help="Re-execute a repro artifact (JSON) instead of searching",
)
@click.option(
    "--corpus",
    "corpus_dir",
    default=None,
    type=click.Path(exists=True, file_okay=False),
    help="Replay every *.json artifact in a directory (regression mode)",
)
@click.option(
    "--topology",
    default="small_multihost",
    show_default=True,
    help="Fuzz substrate (see testing/fuzz.py TOPOLOGIES)",
)
@click.option(
    "--seed",
    default=None,
    type=int,
    help="Search seed [env BIOENGINE_FUZZ_SEED, default 0]",
)
@click.option(
    "--budget-s",
    default=None,
    type=float,
    help="Wall-clock search budget [env BIOENGINE_FUZZ_BUDGET_S, "
    "default 120]",
)
@click.option(
    "--max-runs",
    default=None,
    type=int,
    help="Stop after N schedule executions (besides the time budget)",
)
@click.option(
    "--out",
    "out_dir",
    default=None,
    type=click.Path(file_okay=False),
    help="Directory for shrunk repro artifacts",
)
@click.option(
    "--drill",
    is_flag=True,
    help="Arm the flag-gated lease-accounting drill bug "
    "(BIOENGINE_FUZZ_DRILL=1) — the search MUST find it; exits "
    "non-zero if it does not",
)
@click.option(
    "--keep-going",
    is_flag=True,
    help="Keep searching after a failure instead of stopping at the "
    "first shrunk repro",
)
@click.option(
    "--no-check-determinism",
    is_flag=True,
    help="Replay mode: skip the second run (faster, no determinism gate)",
)
@device_option
@n_devices_option
def fuzz_command(
    replay_path,
    corpus_dir,
    topology,
    seed,
    budget_s,
    max_runs,
    out_dir,
    drill,
    keep_going,
    no_check_determinism,
    device,
    n_devices,
):
    """Coverage-guided fault-schedule search; shrink failures to
    minimal replayable repros (non-zero exit on unexpected failures)."""
    _quiet_logs()
    import asyncio

    from bioengine_tpu_torch.testing import fuzz as fuzzer

    if replay_path and corpus_dir:
        raise click.UsageError("--replay and --corpus are exclusive")

    if replay_path or corpus_dir:
        from pathlib import Path

        paths = (
            [Path(replay_path)]
            if replay_path
            else sorted(Path(corpus_dir).glob("*.json"))
        )
        if not paths:
            emit(
                {"replayed": 0},
                human=f"corpus {corpus_dir}: no artifacts — nothing to do",
            )
            return
        check = not no_check_determinism
        rows, lines, failed = [], [], False
        for path in paths:
            topo = fuzzer.TOPOLOGIES[fuzzer.load_artifact(path)["topology"]]
            verdict = asyncio.run(
                fuzzer.replay_artifact(
                    path,
                    check_determinism=check,
                    device=device,
                    n_devices=_host_chips(topo, device, n_devices),
                )
            )
            ok = verdict["matches_expect"] and verdict["deterministic"] in (
                None,
                True,
            )
            failed = failed or not ok
            rows.append(
                {
                    "artifact": str(path),
                    "red": verdict["red"],
                    "matches_expect": verdict["matches_expect"],
                    "deterministic": verdict["deterministic"],
                }
            )
            det = (
                ""
                if verdict["deterministic"] is None
                else (
                    " deterministic"
                    if verdict["deterministic"]
                    else " DIVERGED"
                )
            )
            lines.append(
                f"[{'ok ' if ok else 'FAIL'}] {path.name}: "
                f"red={verdict['red']}{det}"
            )
        emit({"replays": rows}, human="\n".join(lines))
        if failed:
            raise SystemExit(1)
        return

    # ---- search mode ----
    if seed is None:
        seed = int(os.environ.get("BIOENGINE_FUZZ_SEED", "0"))
    if budget_s is None:
        budget_s = float(os.environ.get("BIOENGINE_FUZZ_BUDGET_S", "120"))
    if topology in fuzzer.TOPOLOGIES:
        n_devices = _host_chips(fuzzer.TOPOLOGIES[topology], device, n_devices)

    result = asyncio.run(
        fuzzer.fuzz(
            topology=topology,
            seed=seed,
            budget_s=budget_s,
            max_runs=max_runs,
            out_dir=out_dir,
            drill=drill,
            keep_going=keep_going,
            on_progress=lambda msg: click.echo(msg, err=True),
            device=device,
            n_devices=n_devices,
        )
    )
    stats = result["stats"]
    lines = [
        f"fuzz {topology} seed={seed} budget={budget_s:.0f}s"
        f"{' DRILL' if drill else ''}: {stats['runs']} runs, "
        f"{stats['novel']} novel, {stats['failures']} failure(s), "
        f"{stats['shrink_runs']} shrink runs, {stats['elapsed_s']}s",
    ]
    for art, path in zip(
        result["artifacts"],
        result["artifact_paths"] or [None] * len(result["artifacts"]),
    ):
        events = ", ".join(
            f"t{e['at_tick']}:{e['action']}"
            + (f"@{e['host']}" if e.get("host") else "")
            for e in art["events"]
        )
        lines.append(
            f"  repro ({len(art['events'])} event(s)) "
            f"red={art['expect']['red']}: {events}"
        )
        if path:
            lines.append(f"    artifact: {path}")
    emit(
        {"stats": stats, "artifacts": result["artifacts"]},
        human="\n".join(lines),
    )
    if drill and not result["artifacts"]:
        click.echo(
            "DRILL FAILED: the armed lease-leak was not found within "
            "the budget",
            err=True,
        )
        raise SystemExit(1)
    if not drill and result["artifacts"]:
        raise SystemExit(1)
