"""Run the datasets server standalone: ``python -m bioengine_tpu_torch.datasets``.

Mirrors ref bioengine/datasets/__main__.py.
"""

from __future__ import annotations

import argparse
import asyncio
from pathlib import Path

from bioengine_tpu_torch.datasets.proxy_server import DatasetsServer


def main() -> None:
    parser = argparse.ArgumentParser(description="BioEngine-TPU datasets server")
    parser.add_argument("data_dir", type=Path, help="Directory of datasets")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--log-file", default="off")
    args = parser.parse_args()

    async def _run() -> None:
        server = DatasetsServer(
            args.data_dir, host=args.host, port=args.port, log_file=args.log_file
        )
        await server.start()
        try:
            await asyncio.Event().wait()
        finally:
            await server.stop()

    asyncio.run(_run())


if __name__ == "__main__":
    main()
