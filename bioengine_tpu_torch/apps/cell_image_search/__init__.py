"""cell-image-search: ViT embedding of cell crops, ingestion sessions, the FlatIP/IVF/PQ indexes and the 2-D map."""
