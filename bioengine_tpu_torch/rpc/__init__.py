"""The RPC plane's in-process half: ``schema_method``.

The wire (``server.py``, ``transport.py``, ``client.py``) is not ported
yet (ROADMAP A12b); ``protocol.py`` is here for ``RemoteError`` and the
``PROTO_*`` names the serving plane reads.
"""

from bioengine_tpu_torch.rpc.schema import schema_method

__all__ = ["schema_method"]
