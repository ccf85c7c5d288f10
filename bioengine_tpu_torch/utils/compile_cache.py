"""What ``serving/compile_tier.py`` imports of
``bioengine_tpu/utils/compile_cache.py``: the entry-name check.

The JAX persistent compile cache itself has no counterpart yet (ROADMAP
A11): the port's programs are CUDA graphs, built per process.
"""

CACHE_SUFFIX = "-cache"


def _safe_entry_name(name: str) -> bool:
    """Entry names cross the RPC plane: refuse anything that is not a
    bare jax cache filename (no separators, no dotfiles, right suffix)."""
    return (
        bool(name)
        and "/" not in name
        and "\\" not in name
        and not name.startswith(".")
        and name.endswith(CACHE_SUFFIX)
        and len(name) < 512
    )
