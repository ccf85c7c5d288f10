"""A standalone controller process for real-subprocess crash testing.

``python -m bioengine_tpu_torch.testing.controller_proc --port P
--control-dir DIR [--deploy-dir APP --app-id ID] [--recover]``

Runs an RpcServer + journaled ServeController exactly like a
production head process, printing line-oriented progress markers a
driving test (or operator) can wait on:

- ``READY epoch=<n> phase=<phase>`` — serving; hosts may join.
- ``DEPLOYED`` — the ``--deploy-dir`` app is placed (first life only;
  the process waits for at least one worker host before deploying).
- ``RECONCILED adopted=<n> replaced=<n> dropped=<n>`` — a
  ``--recover`` life finished its reconcile and is ACTIVE.

The process then serves until killed — the test SIGKILLs it
mid-traffic and starts a second life with ``--recover`` against the
same ``--control-dir`` and port. The pre-shared admin token rides
``BIOENGINE_ADMIN_TOKEN`` so hosts' stored credentials survive the
restart, exactly as a production pre-shared token would.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
from pathlib import Path


async def _run(args: argparse.Namespace) -> int:
    from bioengine_tpu_torch.cluster.state import ClusterState
    from bioengine_tpu_torch.cluster.topology import TpuTopology
    from bioengine_tpu_torch.rpc.server import RpcServer
    from bioengine_tpu_torch.serving import ServeController

    server = RpcServer(
        host="127.0.0.1", port=args.port, admin_users=["admin"]
    )
    await server.start()
    token = os.environ.get("BIOENGINE_ADMIN_TOKEN") or "controller-proc-token"
    server.issue_token("admin", is_admin=True, token_value=token)
    controller = ServeController(
        ClusterState(TpuTopology(chips=(), n_hosts=1, platform="cpu")),
        health_check_period=args.health_period,
        control_dir=args.control_dir,
    )
    if args.recover:
        await controller.recover()
    controller.attach_rpc(server, admin_users=["admin"])
    await controller.start()
    print(
        f"READY epoch={controller.epoch} phase={controller.phase}",
        flush=True,
    )
    if args.deploy_dir and not args.recover:
        from bioengine_tpu_torch.apps.builder import AppBuilder

        while not any(
            h.alive for h in controller.cluster_state.hosts.values()
        ):
            await asyncio.sleep(0.05)
        builder = AppBuilder(
            workdir_root=Path(args.control_dir) / "builder"
        )
        built = builder.build(
            app_id=args.app_id, local_path=Path(args.deploy_dir)
        )
        await controller.deploy(args.app_id, built.specs)
        print("DEPLOYED", flush=True)
    if args.recover:
        while controller.phase == "RECOVERING":
            await asyncio.sleep(0.05)
        report = controller.reconcile_report or {}
        print(
            f"RECONCILED adopted={report.get('adopted', 0)} "
            f"replaced={report.get('replaced', 0)} "
            f"dropped={report.get('dropped', 0)}",
            flush=True,
        )
    # serve until killed (the test's SIGKILL is the whole point)
    await asyncio.Event().wait()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="journaled ServeController in its own process"
    )
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--control-dir", required=True)
    parser.add_argument("--deploy-dir", default=None)
    parser.add_argument("--app-id", default="recovery-app")
    parser.add_argument("--recover", action="store_true")
    parser.add_argument("--health-period", type=float, default=0.25)
    args = parser.parse_args(argv)
    return asyncio.run(_run(args))


if __name__ == "__main__":
    sys.exit(main())
