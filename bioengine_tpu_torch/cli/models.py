"""``bioengine models`` — builtin architectures + pretrained weight
conversion.

The reference obtains pretrained weights implicitly (cellpose downloads
cpsam, torch.hub downloads DINOv2 — ref
apps/cellpose-finetuning/main.py:2248, apps/cell-image-search/
embedder.py:23-101). The TPU framework makes the step explicit: convert
a torch checkpoint once into the flat-npz ``jax_params`` format every
app consumes (finetuning ``pretrained_path``, embedder
``weights_path``, model-runner ``jax_params`` weight entries).
"""

from __future__ import annotations

import json

import click


@click.group("models")
def models_group() -> None:
    """Builtin model registry and weight conversion."""


@models_group.command("list")
def list_command() -> None:
    """List builtin architecture names (model-runner / rdf registry)."""
    from bioengine_tpu_torch.models.registry import list_models

    click.echo(json.dumps(list_models(), indent=2))


@models_group.command("convert")
@click.argument("checkpoint", type=click.Path(exists=True, dir_okay=False))
@click.argument("output", type=click.Path(dir_okay=False))
@click.option(
    "--arch",
    required=True,
    type=click.Choice(["cpsam", "dinov2"]),
    help="Source checkpoint architecture (name-map family).",
)
@click.option(
    "--depth",
    type=int,
    default=None,
    help="Transformer depth; inferred from the checkpoint when omitted.",
)
@click.option(
    "--no-strict",
    is_flag=True,
    help="Skip (instead of error on) checkpoint keys with no mapping.",
)
def convert_command(checkpoint, output, arch, depth, no_strict) -> None:
    """Convert a torch CHECKPOINT into flat-npz jax_params at OUTPUT.

    Examples: a cpsam download -> `--arch cpsam`; a DINOv2 ViT-B/14
    torch-hub checkpoint -> `--arch dinov2`.
    """
    from bioengine_tpu_torch.runtime.convert import convert_checkpoint, count_params

    params = convert_checkpoint(
        arch, checkpoint, output, depth=depth, strict=not no_strict
    )
    click.echo(
        json.dumps(
            {
                "arch": arch,
                "output": output,
                "n_params": count_params(params),
                "top_level": sorted(params),
            }
        )
    )
