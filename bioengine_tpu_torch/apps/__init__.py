"""Application compute ported from ``apps/``."""
