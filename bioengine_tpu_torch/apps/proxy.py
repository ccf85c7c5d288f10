"""App service proxy — publish an app's entry methods on the RPC plane
with per-method access control.

The reference's ProxyDeployment registers one schema_function per entry
``@schema_method`` on Hypha, enforces per-method ACLs (method-specific >
wildcard > deny, ref bioengine/apps/proxy_deployment.py:345-403), counts
in-flight requests, and deregisters the service the moment the entry
goes unhealthy (:997-1088). Same responsibilities here, minus the
mimic-request autoscaling hack — the controller measures load natively.
"""

from __future__ import annotations

from typing import Any, Optional

from bioengine_tpu_torch.apps.builder import BuiltApp
from bioengine_tpu_torch.rpc.server import RpcServer
from bioengine_tpu_torch.serving.controller import DeploymentHandle, ServeController
from bioengine_tpu_torch.utils.logger import create_logger
from bioengine_tpu_torch.utils.permissions import check_method_permission


class AppServiceProxy:
    def __init__(
        self,
        server: RpcServer,
        controller: ServeController,
        built: BuiltApp,
        log_file: Optional[str] = None,
    ):
        self.server = server
        self.controller = controller
        self.built = built
        self.service_id: Optional[str] = None
        self.mcp_url: Optional[str] = None
        self.rtc_service_id: Optional[str] = None
        self.logger = create_logger(f"proxy.{built.app_id}", log_file=log_file)

    @property
    def handle(self) -> DeploymentHandle:
        return self.controller.get_handle(
            self.built.app_id, self.built.entry_name
        )

    def register(self) -> str:
        """Register one proxy function per entry schema method, plus the
        app's MCP endpoint (ref proxy_deployment.py:834 registers an
        MCP-type Hypha service; here the framework serves the protocol
        itself at /mcp/{app_id} — apps/mcp.py)."""
        built = self.built
        mcp_url = None
        register_mcp = getattr(self.server, "register_mcp_app", None)
        if register_mcp is not None:
            mcp_url = register_mcp(built.app_id, self)
        self.mcp_url = mcp_url
        # WebRTC transport: registers only when aiortc is installed
        # (apps/webrtc.py gate; ref proxy_deployment.py:599-732)
        from bioengine_tpu_torch.apps.webrtc import maybe_register_rtc

        self.rtc_service_id = maybe_register_rtc(self.server, self)
        definition: dict[str, Any] = {
            "id": built.app_id,
            "name": built.manifest.name,
            "type": "bioengine-app",
            "description": built.manifest.description,
            "config": {
                "require_context": True,
                "visibility": "public",
                "mcp_url": mcp_url,
            },
        }
        for method_name, schema in built.schema_methods.items():
            definition[method_name] = self._make_proxy_fn(method_name, schema)
        definition["get_load"] = (
            lambda context=None: self.controller.get_load(built.app_id)
        )
        entry = self.server.register_local_service(definition)
        self.service_id = entry.full_id
        self.logger.info(f"registered service {self.service_id}")
        return self.service_id

    async def call_method(
        self, method_name: str, kwargs: dict, context: Optional[dict]
    ) -> Any:
        """ACL-checked call — the single enforcement point shared by the
        websocket proxy functions and the MCP tools/call path."""
        check_method_permission(
            self.built.authorized_users, method_name, context
        )
        return await self.handle.call(method_name, **kwargs)

    def _make_proxy_fn(self, method_name: str, schema: dict):
        async def proxy_fn(*args, context=None, **kwargs):
            if not args:
                return await self.call_method(method_name, kwargs, context)
            # positional calls can't ride the kwargs-only shared path
            check_method_permission(
                self.built.authorized_users, method_name, context
            )
            return await self.handle.call(method_name, *args, **kwargs)

        proxy_fn.__name__ = method_name
        proxy_fn.__doc__ = schema.get("description", "")
        proxy_fn.__schema__ = schema
        proxy_fn.__is_schema_method__ = True
        return proxy_fn

    def deregister(self) -> None:
        if self.service_id:
            unregister_mcp = getattr(self.server, "unregister_mcp_app", None)
            if unregister_mcp is not None:
                unregister_mcp(self.built.app_id)
            self.mcp_url = None
            if self.rtc_service_id:
                from bioengine_tpu_torch.apps.webrtc import close_rtc_pcs

                close_rtc_pcs(self)
                self.server.unregister_service(self.rtc_service_id)
                self.rtc_service_id = None
            self.server.unregister_service(self.service_id)
            self.logger.info(f"deregistered service {self.service_id}")
            self.service_id = None

    @property
    def registered(self) -> bool:
        return self.service_id is not None
