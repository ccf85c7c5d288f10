"""PyTorch model architectures."""
