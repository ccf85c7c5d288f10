"""The generate deployment: greedy token streaming over the decode engine
with step-level continuous batching on the leased device."""

from bioengine_tpu_torch.apps.generate.service import GenerateDeployment

__all__ = ["GenerateDeployment"]
