"""MCP (Model Context Protocol) endpoint per deployed app.

The reference registers an MCP-type Hypha service alongside each app's
WebSocket service so agent frameworks can call the app's schema methods
as tools (ref bioengine/apps/proxy_deployment.py:834). This framework
serves the protocol itself: every deployed app gets a streamable-HTTP
MCP endpoint at ``POST /mcp/{app_id}`` on the RPC server, speaking
JSON-RPC 2.0:

- ``initialize``                capability/serverInfo handshake
- ``notifications/initialized`` accepted (202, no body)
- ``ping``                      liveness
- ``tools/list``                one tool per entry ``@schema_method``
                                (inputSchema = the method's parameter
                                schema, rpc/schema.py)
- ``tools/call``                routes through the app proxy, so the
                                SAME per-method ACL applies as on the
                                websocket plane (apps/proxy.py)

Auth mirrors the JSON HTTP bridge: Bearer/query token -> caller
context; anonymous otherwise (public apps with ``*`` ACLs work
unauthenticated, locked apps reject).
"""

from __future__ import annotations

import json
from typing import Any, Optional

PROTOCOL_VERSION = "2024-11-05"
SERVER_VERSION = "0.1.0"

# JSON-RPC error codes
METHOD_NOT_FOUND = -32601
INVALID_PARAMS = -32602
INTERNAL_ERROR = -32603


def tool_list(schema_methods: dict[str, dict]) -> list[dict]:
    """MCP tool descriptors from an app's schema methods."""
    tools = []
    for name, schema in sorted(schema_methods.items()):
        tools.append(
            {
                "name": name,
                "description": schema.get("description", ""),
                "inputSchema": schema.get(
                    "parameters", {"type": "object", "properties": {}}
                ),
            }
        )
    return tools


async def handle_message(
    proxy, body: dict, context: Optional[dict]
) -> Optional[dict]:
    """One JSON-RPC message against an app's proxy. Returns the response
    object, or None for notifications (HTTP 202)."""
    msg_id = body.get("id")
    method = body.get("method", "")
    params = body.get("params") or {}

    def result(payload: Any) -> dict:
        return {"jsonrpc": "2.0", "id": msg_id, "result": payload}

    def error(code: int, message: str) -> dict:
        return {
            "jsonrpc": "2.0",
            "id": msg_id,
            "error": {"code": code, "message": message},
        }

    if method.startswith("notifications/"):
        return None
    if method == "initialize":
        # echo a client-requested version (our JSON-RPC subset is wire-
        # identical across revisions); fall back to our baseline
        requested = params.get("protocolVersion")
        return result(
            {
                "protocolVersion": requested or PROTOCOL_VERSION,
                "capabilities": {"tools": {"listChanged": False}},
                "serverInfo": {
                    "name": f"bioengine-{proxy.built.app_id}",
                    "version": SERVER_VERSION,
                },
                "instructions": proxy.built.manifest.description,
            }
        )
    if method == "ping":
        return result({})
    if method == "tools/list":
        return result({"tools": tool_list(proxy.built.schema_methods)})
    if method == "tools/call":
        name = params.get("name", "")
        if name not in proxy.built.schema_methods:
            return error(INVALID_PARAMS, f"unknown tool '{name}'")
        arguments = params.get("arguments") or {}
        if not isinstance(arguments, dict):
            return error(INVALID_PARAMS, "arguments must be an object")
        # 'context' is reserved for server-injected caller identity on
        # every plane — never accept a caller-supplied one
        arguments.pop("context", None)
        try:
            value = await proxy.call_method(name, arguments, context)
        except PermissionError as e:
            return result(
                {
                    "content": [{"type": "text", "text": f"Permission denied: {e}"}],
                    "isError": True,
                }
            )
        except Exception as e:
            return result(
                {
                    "content": [
                        {"type": "text", "text": f"{type(e).__name__}: {e}"}
                    ],
                    "isError": True,
                }
            )
        return result(
            {
                "content": [
                    {"type": "text", "text": json.dumps(_jsonable(value))}
                ],
                "isError": False,
            }
        )
    return error(METHOD_NOT_FOUND, f"method '{method}' not supported")


def _jsonable(obj: Any) -> Any:
    # shares the bridge's conversion incl. non-finite-float -> null
    # (MCP clients parse with strict JSON too)
    from bioengine_tpu_torch.rpc.server import _to_jsonable

    return _to_jsonable(obj)
