"""The cell-image-search deployment: ViT-B/14 embedding on the leased
device, ingestion sessions and similarity search."""

from bioengine_tpu_torch.apps.cell_image_search.service import CellImageSearch

__all__ = ["CellImageSearch"]
