"""``bioengine call`` — invoke any method on any registered service.

Capability parity with ref bioengine/cli/call.py:48-184: ``--args`` JSON
payload, auto-typed ``--arg k=v`` pairs, image file inputs/outputs
(npy/npz/png), ``--list-methods``, JSON output when stdout is not a TTY.
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional

import click
import numpy as np

from bioengine_tpu_torch.cli.utils import (
    connect,
    emit,
    parse_json_opt,
    parse_kv_args,
    read_image,
    run_async,
    server_options,
    write_image,
)


@click.command("call")
@click.argument("service_id")
@click.argument("method", required=False)
@click.option("--args", "args_json", default=None, help="JSON kwargs payload")
@click.option(
    "--arg",
    "kv_args",
    multiple=True,
    help="k=v kwarg (JSON-typed value); repeatable",
)
@click.option(
    "--image-arg",
    "image_args",
    multiple=True,
    help="k=path kwarg loaded as an array (npy/npz/png); repeatable",
)
@click.option(
    "--output",
    "output_path",
    default=None,
    type=click.Path(dir_okay=False),
    help="Write an array result to this file instead of printing it",
)
@click.option(
    "--list-methods", is_flag=True, help="List the service's methods and exit"
)
@click.option("--timeout", type=float, default=300.0)
@server_options
def call_command(
    service_id: str,
    method: Optional[str],
    args_json: Optional[str],
    kv_args: tuple[str, ...],
    image_args: tuple[str, ...],
    output_path: Optional[str],
    list_methods: bool,
    timeout: float,
    server_url: Optional[str],
    token: Optional[str],
) -> None:
    """Call METHOD on SERVICE_ID (e.g. `bioengine call demo-app echo
    --arg message=hi`)."""

    async def _run():
        conn = await connect(server_url, token)
        conn.timeout = timeout
        try:
            if list_methods or method is None:
                services = await conn.list_services()
                for info in services:
                    if info["id"] == service_id or info["id"].endswith(
                        f"/{service_id}"
                    ):
                        return {"id": info["id"], "methods": info["methods"]}
                raise click.ClickException(f"Service '{service_id}' not found")
            kwargs = parse_json_opt(args_json, "--args") or {}
            kwargs.update(parse_kv_args(kv_args))
            for pair in image_args:
                if "=" not in pair:
                    raise click.UsageError(
                        f"--image-arg expects k=path, got '{pair}'"
                    )
                key, _, path = pair.partition("=")
                kwargs[key] = await asyncio.to_thread(read_image, path)
            svc = await conn.get_service(service_id)
            return await getattr(svc, method)(**kwargs)
        finally:
            await conn.disconnect()

    result = run_async(_run())
    if list_methods or method is None:
        emit(result, human="\n".join(result["methods"]))
        return
    if output_path is not None:
        array = result
        if isinstance(result, dict):
            arrays = {
                k: v for k, v in result.items() if isinstance(v, np.ndarray)
            }
            if len(arrays) != 1:
                raise click.ClickException(
                    "--output needs an array result (or a dict with exactly "
                    f"one array value; got keys {sorted(result)})"
                )
            array = next(iter(arrays.values()))
        if not isinstance(array, np.ndarray):
            raise click.ClickException("--output needs an array result")
        write_image(output_path, array)
        emit(
            {"saved": output_path, "shape": list(array.shape)},
            human=f"saved {output_path} {array.shape}",
        )
        return
    emit(result, human=json.dumps(result, indent=2, default=str))
