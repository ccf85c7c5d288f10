from bioengine_tpu_torch.rpc.schema import schema_method
from bioengine_tpu_torch.rpc.client import connect_to_server
from bioengine_tpu_torch.rpc.server import RpcServer

__all__ = ["schema_method", "connect_to_server", "RpcServer"]
