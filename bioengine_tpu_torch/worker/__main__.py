"""Worker CLI entry point: ``python -m bioengine_tpu_torch.worker``.

Capability parity with ref bioengine/worker/__main__.py:58-600 — argparse
with option groups mapped to component configs, JSON startup-application
parsing, blocking run with signal-driven graceful shutdown.

Own copy of ``bioengine_tpu/worker/__main__.py`` with ``--device``
(default ``cuda``; ``--device cpu`` runs the plain PyTorch paths).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys
from typing import Any, Optional


def create_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m bioengine_tpu_torch.worker",
        description="Start a BioEngine worker on PyTorch/CUDA",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    worker = parser.add_argument_group("worker")
    worker.add_argument(
        "--mode",
        choices=["single-machine", "slurm", "gke", "external"],
        default="single-machine",
        help="Compute substrate mode",
    )
    worker.add_argument("--workspace-dir", default="~/.bioengine")
    worker.add_argument(
        "--device",
        default="cuda",
        help="Device the worker's topology is detected on (cuda or cpu)",
    )
    worker.add_argument(
        "--admin-users",
        nargs="*",
        default=["admin"],
        help="User ids/emails with admin permissions",
    )
    worker.add_argument(
        "--monitoring-interval-seconds", type=float, default=10.0
    )
    worker.add_argument(
        "--startup-applications",
        type=str,
        default=None,
        help=(
            "JSON list of deploy_app kwargs, e.g. "
            '\'[{"local_path": "apps/demo-app"}]\''
        ),
    )
    worker.add_argument(
        "--log-file",
        default=None,
        help="Component log file; 'off' disables file logging",
    )

    rpc = parser.add_argument_group("control plane")
    rpc.add_argument("--host", default="0.0.0.0")
    rpc.add_argument("--port", type=int, default=0)
    rpc.add_argument(
        "--server-url",
        default=None,
        help="Also register this worker on a remote control plane",
    )
    rpc.add_argument("--server-token", default=None)

    data = parser.add_argument_group("datasets")
    data.add_argument(
        "--datasets-dir",
        default=None,
        help="Serve datasets from this directory",
    )

    cluster = parser.add_argument_group("cluster provisioning")
    cluster.add_argument(
        "--provisioner-config",
        type=str,
        default=None,
        help="JSON config for the slurm/gke provisioner",
    )
    return parser


def parse_startup_applications(raw: Optional[str]) -> list[dict]:
    if not raw:
        return []
    parsed = json.loads(raw)
    if isinstance(parsed, dict):
        parsed = [parsed]
    if not isinstance(parsed, list) or not all(
        isinstance(x, dict) for x in parsed
    ):
        raise ValueError(
            "--startup-applications must be a JSON object or list of objects"
        )
    return parsed


def worker_kwargs_from_args(args: argparse.Namespace) -> dict[str, Any]:
    return {
        "mode": args.mode,
        "workspace_dir": args.workspace_dir,
        "admin_users": args.admin_users,
        "host": args.host,
        "port": args.port,
        "server_url": args.server_url,
        "server_token": args.server_token,
        "datasets_dir": args.datasets_dir,
        "startup_applications": parse_startup_applications(
            args.startup_applications
        ),
        "monitoring_interval_seconds": args.monitoring_interval_seconds,
        "provisioner_config": (
            json.loads(args.provisioner_config)
            if args.provisioner_config
            else None
        ),
        "log_file": args.log_file,
        "device": args.device,
    }


async def run(kwargs: dict[str, Any]) -> None:
    from bioengine_tpu_torch.worker.worker import BioEngineWorker

    worker = BioEngineWorker(**kwargs)
    loop = asyncio.get_running_loop()

    def _shutdown():
        asyncio.ensure_future(worker.stop())

    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, _shutdown)
    await worker.start(blocking=True)


def main(argv: Optional[list[str]] = None) -> None:
    args = create_parser().parse_args(argv)
    try:
        kwargs = worker_kwargs_from_args(args)
    except (ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)
    asyncio.run(run(kwargs))


if __name__ == "__main__":
    main()
