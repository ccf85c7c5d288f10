"""Device resolution and weight formats."""
