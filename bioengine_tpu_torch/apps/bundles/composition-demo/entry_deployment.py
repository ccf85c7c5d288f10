"""Multi-deployment composition: init params named after sibling file
stems receive DeploymentHandles (parity with ref apps/composition-demo/
entry_deployment.py + apps/builder.py:1474-1508 binding)."""

import asyncio

from bioengine_tpu_torch.rpc import schema_method


class EntryDeployment:
    def __init__(self, runtime_a, runtime_b):
        self.runtime_a = runtime_a
        self.runtime_b = runtime_b

    @schema_method
    async def fan_out(self, value: int, context=None):
        """Send the value to both runtimes concurrently; gather results."""
        a, b = await asyncio.gather(
            self.runtime_a.call("transform", value),
            self.runtime_b.call("transform", value),
        )
        return {"a": a, "b": b, "sum": a + b}
