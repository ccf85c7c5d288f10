"""Canonical lifecycle example app (parity with the reference's
demo-app, ref apps/demo-app/demo_deployment.py: async_init /
test_deployment / check_health hooks plus simple schema methods)."""

import asyncio
import os
import time

from bioengine_tpu_torch.rpc import schema_method


class DemoDeployment:
    def __init__(self, greeting: str = "Hello"):
        self.greeting = greeting
        self.started_at = time.time()
        self.ready = False
        self.ping_count = 0

    async def async_init(self):
        await asyncio.sleep(0)
        self.ready = True

    async def test_deployment(self):
        result = await self.echo(message="self-test")
        assert result["echo"] == "self-test", "echo self-test failed"

    async def check_health(self):
        if not self.ready:
            raise RuntimeError("not initialized")

    @schema_method
    async def ping(self, context=None):
        """Liveness check; returns 'pong' and a counter."""
        self.ping_count += 1
        return {"pong": True, "count": self.ping_count}

    @schema_method
    async def echo(self, message: str, context=None):
        """Echo a message back with uptime metadata."""
        return {
            "echo": message,
            "uptime_seconds": time.time() - self.started_at,
            "greeting": self.greeting,
        }

    @schema_method
    async def get_env(self, key: str, context=None):
        """Read an environment variable visible to the deployment."""
        return {"key": key, "value": os.environ.get(key)}
