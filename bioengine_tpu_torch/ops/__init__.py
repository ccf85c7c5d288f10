"""Hand-written CUDA kernels for the compute hot path, each beside its
plain PyTorch version (taken for CPU tensors)."""

from bioengine_tpu_torch.ops.attention import flash_attention, make_attn_fn

__all__ = ["flash_attention", "make_attn_fn"]
