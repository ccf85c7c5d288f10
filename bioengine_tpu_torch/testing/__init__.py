"""Test-only runtime helpers (deterministic fault injection)."""
