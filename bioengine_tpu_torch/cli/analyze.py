"""``bioengine-torch analyze`` — CLI front-end for the static analyzer.

Thin pass-through to :mod:`bioengine_tpu_torch.analysis.__main__` so the
click command and ``python -m bioengine_tpu_torch.analysis`` share one
argument surface and exit-code contract (0 clean, 1 findings,
2 usage error).  Unknown options forward verbatim, so new analyzer
flags never need a second wiring here.
"""

from __future__ import annotations

import sys

import click


@click.command(
    "analyze",
    context_settings={"ignore_unknown_options": True, "help_option_names": []},
)
@click.argument("analyzer_args", nargs=-1, type=click.UNPROCESSED)
def analyze_command(analyzer_args: tuple[str, ...]) -> None:
    """Run the whole-program linter (async-safety, CUDA-graph
    capture-safety, distributed-contract drift).

    Examples:

      bioengine-torch analyze bioengine_tpu_torch/

      bioengine-torch analyze --changed origin/main

      bioengine-torch analyze --format sarif --stats --jobs 8

      bioengine-torch analyze --list-rules
    """
    from bioengine_tpu_torch.analysis.__main__ import main as analysis_main

    sys.exit(analysis_main(list(analyzer_args)))
