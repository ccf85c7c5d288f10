"""WebRTC data-channel transport per app — gated on aiortc.

The reference registers a WebRTC service per app next to the WebSocket
one: clients fetch ICE servers, open a peer connection, and call app
methods over data channels; the deployment tracks open PCs for load
reporting (ref bioengine/apps/proxy_deployment.py:599-732, 950-992).

aiortc (C-backed) is an OPTIONAL dependency of this framework — TPU
worker images ship without it (SURVEY.md environment: stub or gate
anything not baked in). This module is the gate: when aiortc is
importable the proxy registers an ``{app_id}-rtc`` signaling service
whose ``offer`` verb answers SDP offers and serves ACL-checked app
calls over a ``rpc`` data channel (JSON ``{id, method, kwargs}`` ->
``{id, result | error}``); without aiortc, registration is skipped
with a log line and everything else works over WebSocket/HTTP/MCP.
"""

from __future__ import annotations

import json
from typing import Any, Optional


def webrtc_available() -> bool:
    try:
        import aiortc  # noqa: F401

        return True
    except ImportError:
        return False


def maybe_register_rtc(server, proxy) -> Optional[str]:
    """Register the app's WebRTC signaling service when aiortc exists.
    Returns the service id, or None when gated off."""
    if not webrtc_available():
        proxy.logger.info(
            "aiortc not installed — WebRTC transport gated off for "
            f"'{proxy.built.app_id}' (WebSocket/HTTP/MCP remain)"
        )
        return None
    return _register(server, proxy)


def close_rtc_pcs(proxy) -> int:
    """Close every peer connection an app's RTC service still holds
    (called from proxy.deregister — undeploy must not leak ICE/DTLS
    sockets). Returns how many closes were scheduled."""
    import asyncio

    pcs = getattr(proxy, "_rtc_pcs", None)
    if not pcs:
        return 0
    n = len(pcs)
    for pc in list(pcs):
        asyncio.ensure_future(pc.close())
    pcs.clear()
    return n


def _register(server, proxy) -> str:
    from aiortc import RTCPeerConnection, RTCSessionDescription

    pcs: set[Any] = set()
    proxy._rtc_pcs = pcs  # close_rtc_pcs reaches them on deregister

    async def offer(sdp: str, type: str = "offer", context=None) -> dict:
        """Answer an SDP offer; app methods ride the 'rpc' data channel
        with the caller context captured at signaling time (the ACL
        decision uses the SAME identity as the websocket plane).
        NB the wire field is named ``type`` (SDP convention)."""
        sdp_type = type
        pc = RTCPeerConnection()
        pcs.add(pc)

        @pc.on("connectionstatechange")
        async def _on_state():
            if pc.connectionState in ("failed", "closed"):
                pcs.discard(pc)

        @pc.on("datachannel")
        def _on_channel(channel):
            @channel.on("message")
            def _on_message(message):
                import asyncio

                async def respond():
                    req = None
                    try:
                        req = json.loads(message)
                        value = await proxy.call_method(
                            req["method"], req.get("kwargs") or {}, context
                        )
                        channel.send(
                            json.dumps({"id": req.get("id"), "result": value})
                        )
                    except Exception as e:
                        channel.send(
                            json.dumps(
                                {
                                    "id": (req.get("id")
                                           if isinstance(req, dict) else None),
                                    "error": f"{e.__class__.__name__}: {e}",
                                }
                            )
                        )

                asyncio.ensure_future(respond())

        await pc.setRemoteDescription(
            RTCSessionDescription(sdp=sdp, type=sdp_type)
        )
        answer = await pc.createAnswer()
        await pc.setLocalDescription(answer)
        return {
            "sdp": pc.localDescription.sdp,
            "type": pc.localDescription.type,
        }

    def get_num_pcs(context=None) -> int:
        return len(pcs)

    entry = server.register_local_service(
        {
            "id": f"{proxy.built.app_id}-rtc",
            "name": f"{proxy.built.manifest.name} (WebRTC)",
            "type": "bioengine-app-rtc",
            "config": {"require_context": True, "visibility": "public"},
            "offer": offer,
            "get_num_pcs": get_num_pcs,
        }
    )
    proxy.logger.info(f"registered WebRTC service {entry.full_id}")
    return entry.full_id
