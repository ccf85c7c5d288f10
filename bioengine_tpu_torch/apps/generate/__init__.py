"""Token generation, ported from ``apps/generate``."""
