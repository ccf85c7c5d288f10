"""BioEngine on PyTorch and CUDA: the port of ``bioengine_tpu`` to an
NVIDIA H100.

Imports torch, numpy and scipy, never jax, flax or ``bioengine_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
