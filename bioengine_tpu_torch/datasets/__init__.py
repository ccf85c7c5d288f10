"""Dataset streaming plane: zarr-over-HTTP with LRU caching.

Own copy of ``bioengine_tpu/datasets/`` (client, HttpZarrStore,
ChunkCache, proxy server, and the zarr v2/v3 codec layer with no
external ``zarr`` dependency). The device-prefetch path
(``prefetch.py``) is not ported yet (ROADMAP A11).
"""

from bioengine_tpu_torch.datasets.chunk_cache import ChunkCache, default_cache
from bioengine_tpu_torch.datasets.datasets import BioEngineDatasets
from bioengine_tpu_torch.datasets.http_zarr_store import (
    HttpZarrStore,
    RemoteZarrArray,
    RemoteZarrGroup,
)
from bioengine_tpu_torch.datasets.proxy_server import DatasetsServer, start_proxy_server

__all__ = [
    "BioEngineDatasets",
    "ChunkCache",
    "DatasetsServer",
    "HttpZarrStore",
    "RemoteZarrArray",
    "RemoteZarrGroup",
    "default_cache",
    "start_proxy_server",
]
