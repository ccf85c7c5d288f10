"""CLI helpers: worker connection, value coercion, image I/O, output.

Capability parity with ref bioengine/cli/utils.py:45-210 (service connect
with fallback, typed --arg parsing, npy/npz/png image I/O) minus the S3
helpers (the datasets save API covers that role here).
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
from pathlib import Path
from typing import Any, Optional

import click

from bioengine_tpu_torch.rpc.client import ServerConnection, ServiceProxy, connect_to_server

DEFAULT_SERVER_ENV = "BIOENGINE_SERVER_URL"
DEFAULT_TOKEN_ENV = "BIOENGINE_TOKEN"
DEFAULT_WORKSPACE_ENV = "BIOENGINE_WORKSPACE"
WORKER_SERVICE_ID = "bioengine-worker"


def resolve_server_url(server_url: Optional[str]) -> str:
    url = server_url or os.environ.get(DEFAULT_SERVER_ENV)
    if not url:
        raise click.UsageError(
            f"No server URL: pass --server-url or set {DEFAULT_SERVER_ENV}"
        )
    return url


def resolve_token(token: Optional[str]) -> Optional[str]:
    """Token chain: flag > env > the admin token file a colocated worker
    writes into its workspace on startup."""
    if token:
        return token
    env = os.environ.get(DEFAULT_TOKEN_ENV)
    if env:
        return env
    workspace = Path(
        os.environ.get(DEFAULT_WORKSPACE_ENV, "~/.bioengine")
    ).expanduser()
    token_file = workspace / "admin_token"
    if token_file.is_file():
        try:
            return token_file.read_text().strip() or None
        except OSError:
            return None
    return None


async def connect(
    server_url: Optional[str], token: Optional[str] = None
) -> ServerConnection:
    resolved_token = await asyncio.to_thread(resolve_token, token)
    return await connect_to_server(
        {
            "server_url": resolve_server_url(server_url),
            "token": resolved_token,
        }
    )


async def get_worker_service(conn: ServerConnection) -> ServiceProxy:
    return await conn.get_service(WORKER_SERVICE_ID)


def run_async(coro) -> Any:
    return asyncio.run(coro)


def coerce_value(raw: str) -> Any:
    """Auto-type an ``--arg k=v`` value: JSON first, then bare string
    (ref cli/call.py --arg convention)."""
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def parse_kv_args(pairs: tuple[str, ...]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise click.UsageError(f"--arg expects k=v, got '{pair}'")
        key, _, value = pair.partition("=")
        out[key] = coerce_value(value)
    return out


def parse_env_args(pairs: tuple[str, ...]) -> dict[str, str]:
    """k=v env vars, values kept as RAW strings — ``--env FLAG=true``
    must reach the app as the literal string "true", not Python True."""
    out: dict[str, str] = {}
    for pair in pairs:
        if "=" not in pair:
            raise click.UsageError(f"--env expects k=v, got '{pair}'")
        key, _, value = pair.partition("=")
        out[key] = value
    return out


def parse_json_opt(raw: Optional[str], opt_name: str) -> Optional[dict]:
    """Parse a JSON-object option; bad input is a usage error, not a
    traceback."""
    if raw is None:
        return None
    try:
        payload = json.loads(raw)
    except json.JSONDecodeError as e:
        raise click.UsageError(f"{opt_name} is not valid JSON: {e}")
    if not isinstance(payload, dict):
        raise click.UsageError(f"{opt_name} must be a JSON object")
    return payload


def read_dir_files(src_dir: str | Path) -> dict[str, bytes]:
    """Read an app directory into the {relative_path: bytes} wire form
    uploads use (the worker can't see the client's filesystem).

    Hidden files AND files under hidden directories are skipped —
    uploading an app dir that contains ``.git`` must not ship the
    repository object store."""
    src = Path(src_dir)
    return {
        str(p.relative_to(src)): p.read_bytes()
        for p in sorted(src.rglob("*"))
        if p.is_file()
        and not any(
            part.startswith(".") for part in p.relative_to(src).parts
        )
    }


# shared option pair + connection lifecycle for every worker-facing command

_server_opts = [
    click.option("--server-url", default=None, help="Control-plane URL"),
    click.option("--token", default=None, help="Auth token"),
]


def server_options(fn):
    for opt in reversed(_server_opts):
        fn = opt(fn)
    return fn


async def with_worker(server_url, token, action):
    """Connect, resolve the worker service, run ``action(worker)``,
    always disconnect."""
    conn = await connect(server_url, token)
    try:
        worker = await get_worker_service(conn)
        return await action(worker)
    finally:
        await conn.disconnect()


def emit(data: Any, human: Optional[str] = None) -> None:
    """Human text on a TTY, JSON when piped (ref cli/call.py non-TTY)."""
    if sys.stdout.isatty() and human is not None:
        click.echo(human)
    else:
        click.echo(json.dumps(data, indent=2, default=str))


# ---- image I/O (ref cli/utils.py:93-181; tifffile absent -> npy/npz/png) ----


def read_image(path: str | Path):
    import numpy as np

    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".npy":
        return np.load(path)
    if suffix == ".npz":
        data = np.load(path)
        return data[next(iter(data.files))]
    if suffix in (".png", ".jpg", ".jpeg", ".tif", ".tiff"):
        from PIL import Image

        return np.asarray(Image.open(path))
    raise click.UsageError(f"Unsupported image format '{suffix}'")


def write_image(path: str | Path, array) -> None:
    import numpy as np

    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".npy":
        np.save(path, array)
        return
    if suffix == ".npz":
        np.savez_compressed(path, array)
        return
    if suffix in (".png", ".jpg", ".jpeg"):
        from PIL import Image

        arr = np.asarray(array)
        if arr.dtype != np.uint8:
            lo, hi = float(arr.min()), float(arr.max())
            arr = ((arr - lo) / (hi - lo or 1.0) * 255).astype(np.uint8)
        Image.fromarray(arr).save(path)
        return
    raise click.UsageError(f"Unsupported image format '{suffix}'")
