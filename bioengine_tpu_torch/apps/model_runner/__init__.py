"""Model-runner serving, ported from ``apps/model-runner``."""
