"""The model-runner's runtime deployment: one leased device, the pipeline
cache and continuous batching."""

from bioengine_tpu_torch.apps.model_runner.runtime import RuntimeDeployment

__all__ = ["RuntimeDeployment"]
