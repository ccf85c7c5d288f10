"""The model-runner's entry deployment: model discovery, the package cache,
``test`` and ``infer``, over a handle to the runtime deployment."""

from bioengine_tpu_torch.apps.model_runner.entry import EntryDeployment

__all__ = ["EntryDeployment"]
