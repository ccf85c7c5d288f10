"""The cellpose fine-tuning deployment: training sessions on the leased
device, live inference from per-epoch snapshots, export to model-runner
packages."""

from bioengine_tpu_torch.apps.cellpose_finetuning.service import CellposeFinetune

__all__ = ["CellposeFinetune"]
