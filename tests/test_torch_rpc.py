"""The RPC wire across the two packages, on loopback.

The port's ``rpc/server.py``, ``client.py`` and ``transport.py`` are
copies of the JAX modules; this holds them to the same wire. Each pairing
(client package, server package) runs one sequence: a provider client
registers a service, a second client calls it through the server, and
the server's HTTP ``/call`` bridge and ``/mcp`` endpoint answer. What each
pairing observes (values, array bytes, stream items, remote error types
and messages, refusals, the bridges' JSON) must equal what the JAX client
observes against the JAX server. Arrays are sent below and above the
transport's large-frame threshold (``BIOENGINE_RPC_FRAME_LIMIT_MB``, set
low so the large one goes out as chunks), with the shared-memory path off
and on.
"""

import asyncio
from types import SimpleNamespace

import aiohttp
import numpy as np
import pytest

from _torch_parity import few_torch_threads, private_rpc_store, retry_jax_store_load  # noqa: F401
from bioengine_tpu.apps import mcp as jax_mcp
from bioengine_tpu.native import store as jax_store
from bioengine_tpu.rpc import client as jax_client
from bioengine_tpu.rpc import protocol as jax_protocol
from bioengine_tpu.rpc import schema as jax_schema
from bioengine_tpu.rpc import server as jax_server
from bioengine_tpu_torch.apps import mcp as torch_mcp
from bioengine_tpu_torch.native import store as torch_store
from bioengine_tpu_torch.rpc import client as torch_client
from bioengine_tpu_torch.rpc import protocol as torch_protocol
from bioengine_tpu_torch.rpc import schema as torch_schema
from bioengine_tpu_torch.rpc import server as torch_server

pytestmark = [pytest.mark.integration, pytest.mark.anyio]

PACKAGES = {
    "jax": SimpleNamespace(
        connect=jax_client.connect_to_server, RpcServer=jax_server.RpcServer,
        RemoteError=jax_protocol.RemoteError, schema_method=jax_schema.schema_method,
        mcp=jax_mcp,
    ),
    "torch": SimpleNamespace(
        connect=torch_client.connect_to_server, RpcServer=torch_server.RpcServer,
        RemoteError=torch_protocol.RemoteError, schema_method=torch_schema.schema_method,
        mcp=torch_mcp,
    ),
}
PAIRINGS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]
FRAME_LIMIT_MB = 0.25  # the large-frame threshold for these tests
SMALL = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)  # 16 KiB
LARGE = np.random.default_rng(0).normal(size=(512, 1024)).astype(np.float32)  # 2 MiB


def _array(a) -> tuple:
    a = np.asarray(a)
    return str(a.dtype), a.shape, a.tobytes()


def _error(exc: BaseException) -> tuple:
    return type(exc).__name__, str(exc)


def _provider(pkg):
    schema_method = pkg.schema_method

    @schema_method
    async def echo(value, context=None):
        """Return the value as given."""
        return value

    @schema_method
    async def scale(arr, factor: float = 2.0, context=None):
        """Multiply an array by a factor."""
        return np.asarray(arr) * np.float32(factor)

    async def fail(context=None):
        raise ValueError("deliberate failure")

    async def countdown(n: int = 3, context=None):
        for i in range(n):
            await asyncio.sleep(0)
            yield {"i": i, "left": n - i - 1}

    return {"id": "calc", "name": "Calc", "config": {"require_context": True},
            "echo": echo, "scale": scale, "fail": fail, "countdown": countdown}


class _McpProxy:
    """The part of an app proxy that ``apps/mcp.py`` reads."""

    def __init__(self, pkg, service):
        self.built = SimpleNamespace(
            app_id="calc",
            manifest=SimpleNamespace(description="a calculator"),
            schema_methods={n: service[n].__schema__ for n in ("echo", "scale")},
        )
        self._service = service

    async def call_method(self, name, arguments, context):
        return await self._service[name](**arguments, context=context)


async def _post(session, url, body, token=None):
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    async with session.post(url, json=body, headers=headers) as r:
        return r.status, (await r.json() if r.status != 202 else None)


async def _drive(client_pkg, server_pkg) -> dict:
    server = server_pkg.RpcServer(admin_users=["admin"])
    await server.start()
    seen: dict = {}
    try:
        url = f"http://127.0.0.1:{server.port}"
        admin = server.issue_token("admin")
        provider = await client_pkg.connect({"server_url": url, "token": admin})
        caller = await client_pkg.connect({"server_url": url})
        try:
            service = _provider(client_pkg)
            registered = await provider.register_service(service)
            seen["registered"] = registered["id"]
            calc = await caller.get_service("calc")
            seen["scalar"] = await calc.echo(value=7)
            seen["dict"] = await calc.echo(value={"a": [1, 2.5, None], "b": "x", "c": True})
            for name, arr in (("small", SMALL), ("large", LARGE)):
                seen[f"{name}_echo"] = _array(await calc.echo(value=arr))
                seen[f"{name}_scale"] = _array(
                    await caller.call("bioengine/calc", "scale", arr, factor=0.5))
            seen["stream"] = [
                item async for item in caller.call_stream("calc", "countdown", n=4)]
            with pytest.raises(Exception) as exc:
                await calc.fail()
            seen["remote_error"] = _error(exc.value)
            assert isinstance(exc.value, client_pkg.RemoteError)
            with pytest.raises(Exception) as exc:
                await caller.generate_token()
            seen["unauthorised_call"] = _error(exc.value)
            with pytest.raises(Exception) as exc:
                await client_pkg.connect({"server_url": url, "token": "not-a-token"})
            seen["bad_token"] = type(exc.value).__name__

            # the HTTP bridge: a server-local service, and the remote one
            server.register_local_service({**_provider(server_pkg), "id": "local-calc"})
            server.register_mcp_app("calc", _McpProxy(server_pkg, _provider(server_pkg)))
            async with aiohttp.ClientSession() as http:
                for sid in ("local-calc", "calc"):
                    seen[f"bridge_{sid}"] = await _post(
                        http, f"{url}/call/{sid}/echo", {"kwargs": {"value": {"k": [1, 2]}}})
                    seen[f"bridge_{sid}_array"] = await _post(
                        http, f"{url}/call/{sid}/scale", {"args": [[1.0, 2.0]]})
                    seen[f"bridge_{sid}_error"] = await _post(http, f"{url}/call/{sid}/fail", {})
                seen["bridge_missing"] = await _post(http, f"{url}/call/local-calc/nope", {})
                seen["bridge_bad_token"] = await _post(
                    http, f"{url}/call/local-calc/echo", {"args": [1]}, token="not-a-token")
                for i, (method, params) in enumerate([
                    ("initialize", {}),
                    ("notifications/initialized", {}),
                    ("tools/list", {}),
                    ("tools/call", {"name": "echo", "arguments": {"value": [1, "a"]}}),
                    ("tools/call", {"name": "scale", "arguments": {"arr": [1.0, 3.0]}}),
                    ("tools/call", {"name": "nope"}),
                ]):
                    seen[f"mcp_{i}"] = await _post(
                        http, f"{url}/mcp/calc",
                        {"jsonrpc": "2.0", "id": i, "method": method, "params": params})
        finally:
            await caller.disconnect()
            await provider.disconnect()
        seen["frames_chunked"] = server.stats.chunked_msgs_in > 0
        seen["shm_carried"] = server.stats.shm_gets > 0 and server.stats.shm_puts > 0
    finally:
        await server.stop()
    return seen


@pytest.fixture(params=["wire", "shm"])
def transport(request, monkeypatch):
    if request.param == "shm" and not torch_store.native_available():
        pytest.skip("the native shared-memory store does not build here (no make or g++)")
    monkeypatch.setenv("BIOENGINE_RPC_FRAME_LIMIT_MB", str(FRAME_LIMIT_MB))
    monkeypatch.setenv("BIOENGINE_RPC_SHM", "0" if request.param == "wire" else "1")
    if request.param == "shm":
        # the pairings are held to the JAX pair's run, which needs its store
        retry_jax_store_load(jax_store)
    with private_rpc_store():  # a segment of the test's own, unlinked after
        yield request.param


@pytest.mark.parametrize("client, server", PAIRINGS, ids=lambda p: p)
async def test_wire_across_packages(client, server, transport):
    seen = await _drive(PACKAGES[client], PACKAGES[server])
    assert seen == await _drive(PACKAGES["jax"], PACKAGES["jax"])
    # and what was observed is what was sent
    assert seen["scalar"] == 7
    assert seen["large_echo"] == _array(LARGE)
    assert seen["small_scale"] == _array(SMALL * np.float32(0.5))
    assert [it["i"] for it in seen["stream"]] == [0, 1, 2, 3]
    assert seen["remote_error"][1].endswith("deliberate failure")
    assert "admin" in seen["unauthorised_call"][1]
    assert seen["bad_token"] in ("PermissionError", "RemoteError", "WSServerHandshakeError")
    assert seen["bridge_calc"] == (200, {"result": {"k": [1, 2]}})
    assert seen["bridge_bad_token"][0] == 401
    assert seen["mcp_1"] == (202, None)
    if transport == "wire":
        assert seen["frames_chunked"]  # the large array went out as chunks
    # the 2 MiB array crossed through shared memory exactly when it was on
    assert seen["shm_carried"] == (transport == "shm")
