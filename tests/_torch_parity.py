"""Shared inputs for the PyTorch port's parity tests."""

import jax
import jax.numpy as jnp
import numpy as np

from bioengine_tpu.runtime import convert as jax_convert


def seeded_flax_params(model, image_shape, seed=0):
    """Params for a flax ``model`` drawn from ``np.random.default_rng(seed)``
    in the tree ``model.init`` would build (shaped by ``jax.eval_shape``, so
    nothing is compiled): kernels ~ N(0, 1/fan_in), every other leaf ~
    N(base, 0.02) with base 1 for norm scales and LayerScales, else 0."""
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros(image_shape, jnp.float32)
    )["params"]
    flat = jax_convert.flatten_params(
        jax.tree.map(lambda s: np.empty(s.shape, np.float32), shapes)
    )
    rng = np.random.default_rng(seed)
    out = {}
    for key, arr in sorted(flat.items()):
        if key.endswith("kernel"):
            std, base = 1.0 / np.sqrt(np.prod(arr.shape[:-1])), 0.0
        else:
            std = 0.02
            base = 1.0 if key.endswith(("scale", "ls1", "ls2")) else 0.0
        out[key] = (base + std * rng.normal(size=arr.shape)).astype(np.float32)
    return jax_convert.unflatten_params(out)
