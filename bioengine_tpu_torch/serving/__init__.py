"""Serving-plane pieces ported from ``bioengine_tpu/serving``."""
