"""Worker runtime: the BioEngineWorker orchestrator + admin code executor.

Replaces ref bioengine/worker/ (worker.py, code_executor.py, __main__.py).
"""

from bioengine_tpu_torch.worker.code_executor import CodeExecutor
from bioengine_tpu_torch.worker.worker import BioEngineWorker

__all__ = ["BioEngineWorker", "CodeExecutor"]
