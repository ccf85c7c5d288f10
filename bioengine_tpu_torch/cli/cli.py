"""``bioengine`` CLI root — wires call / apps / cluster / worker / status.

Capability parity with ref bioengine/cli/cli.py:1-62 (click group over
the same three subcommands, plus `worker` to launch a worker and
`status` as a top-level convenience).
"""

from __future__ import annotations

import json

import click

from bioengine_tpu_torch.cli.analyze import analyze_command
from bioengine_tpu_torch.cli.apps import apps_group
from bioengine_tpu_torch.cli.call import call_command
from bioengine_tpu_torch.cli.cluster import cluster_group
from bioengine_tpu_torch.cli.debug import debug_group
from bioengine_tpu_torch.cli.fuzz import fuzz_command
from bioengine_tpu_torch.cli.models import models_group
from bioengine_tpu_torch.cli.scenarios import scenarios_group
from bioengine_tpu_torch.cli.slo import slo_group, top_command


@click.group()
@click.version_option(package_name="bioengine-tpu", prog_name="bioengine-torch")
def main() -> None:
    """BioEngine command line interface for the PyTorch/CUDA worker."""


main.add_command(analyze_command)
main.add_command(call_command)
main.add_command(apps_group)
main.add_command(cluster_group)
main.add_command(debug_group)
main.add_command(fuzz_command)
main.add_command(models_group)
main.add_command(scenarios_group)
main.add_command(slo_group)
main.add_command(top_command)


@main.command("status")
@click.option("--server-url", default=None, help="Control-plane URL")
@click.option("--token", default=None, help="Auth token")
def status_command(server_url, token):
    """Full worker status (worker / cluster / applications / datasets)."""
    from bioengine_tpu_torch.cli.utils import emit, run_async, with_worker

    result = run_async(
        with_worker(server_url, token, lambda w: w.get_status())
    )
    emit(result, human=json.dumps(result, indent=2, default=str))


@main.command(
    "worker",
    context_settings={"ignore_unknown_options": True, "help_option_names": []},
)
@click.argument("worker_args", nargs=-1, type=click.UNPROCESSED)
def worker_command(worker_args):
    """Start a worker (forwards args to `python -m bioengine_tpu_torch.worker`)."""
    from bioengine_tpu_torch.worker.__main__ import main as worker_main

    worker_main(list(worker_args))


if __name__ == "__main__":
    main()
