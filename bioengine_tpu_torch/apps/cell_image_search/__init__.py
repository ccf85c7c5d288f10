"""cell-image-search: ViT embedding of cell crops and FlatIP search."""
