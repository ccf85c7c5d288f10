"""Host-side utilities ported from ``bioengine_tpu/utils``."""
