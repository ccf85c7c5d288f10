"""Dataset streaming plane: zarr-over-HTTP with LRU caching + CUDA prefetch.

Own copy of ``bioengine_tpu/datasets/`` (client, HttpZarrStore,
ChunkCache, proxy server, and the zarr v2/v3 codec layer with no
external ``zarr`` dependency), with the device-prefetch path
(``prefetch.py``) feeding the card over pinned memory and a copy stream.
"""

from bioengine_tpu_torch.datasets.chunk_cache import ChunkCache, default_cache
from bioengine_tpu_torch.datasets.datasets import BioEngineDatasets
from bioengine_tpu_torch.datasets.http_zarr_store import (
    HttpZarrStore,
    RemoteZarrArray,
    RemoteZarrGroup,
)
from bioengine_tpu_torch.datasets.prefetch import ZarrBatchLoader, prefetch_to_device
from bioengine_tpu_torch.datasets.proxy_server import DatasetsServer, start_proxy_server

__all__ = [
    "BioEngineDatasets",
    "ChunkCache",
    "DatasetsServer",
    "HttpZarrStore",
    "RemoteZarrArray",
    "RemoteZarrGroup",
    "ZarrBatchLoader",
    "default_cache",
    "prefetch_to_device",
    "start_proxy_server",
]
