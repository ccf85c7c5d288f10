"""Framework-level checkpoint service.

Own copy of ``bioengine_tpu/runtime/checkpoints.py``. The reference has
NO framework checkpointing — its only persistence is the cellpose app's
per-epoch model files (ref apps/cellpose-finetuning/main.py:1825-1835).
This closes it: any train loop gets durable, retention-managed,
atomically-committed checkpoints of its FULL train state — parameters,
optimizer moments, step.

The JAX service is a thin wrapper over orbax's CheckpointManager; orbax
is not a dependency of the port, so this one implements the same
behaviour itself, with the same constructor and methods:

- a step is committed by writing ``<step>/state.pt`` under a temporary
  directory name and renaming it into place, so a crash leaves either the
  whole step or none of it;
- ``save`` skips steps off ``save_interval_steps`` (the first save of an
  empty directory is always taken) and steps at or below the newest one,
  unless ``force`` is set — ``force`` never overwrites an existing step;
- retention keeps the newest ``max_to_keep`` steps;
- writes happen on a background thread. The train step updates its state
  in place (``models/cellpose.py`` ``make_loss_train_step``), so ``save``
  copies every tensor to host memory before it returns, as orbax's async
  save copies device arrays before its ``save`` returns: the next step
  cannot change a checkpoint still being written.

The state is the port's ``TrainState`` (module, AdamW, step), a module,
or a nested dict/list/tuple of tensors and numbers. The file format is
``torch.save``, read back with ``weights_only=True``; the port cannot
read orbax's format and the JAX package cannot read this one. A restore
puts every tensor onto the template's device and dtype (the optimizer's
moments too) and returns the template, filled in. A replicated template
(``parallel.data_parallel.replicate``'s: a data-parallel train state, or
replicas of a module or a tree) gets every replica filled, each on its own
device of the mesh; a data-parallel state's one optimizer keeps its
moments on the first. Such a state is saved as its first replica.
"""

from __future__ import annotations

import concurrent.futures
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import torch

from bioengine_tpu_torch.models.cellpose import TrainState
from bioengine_tpu_torch.parallel.data_parallel import DataParallelTrainState, Replicated

STATE_FILE = "state.pt"


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` whose tensors are detached host copies."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _fill(template: Any, saved: Any) -> Any:
    """``saved`` copied into ``template``'s tensors in place (their device
    and dtype); other leaves are taken from ``saved``."""
    if isinstance(template, torch.Tensor):
        if tuple(template.shape) != tuple(saved.shape):
            raise ValueError(f"checkpoint shape {tuple(saved.shape)} != template {tuple(template.shape)}")
        with torch.no_grad():
            template.copy_(saved)
        return template
    if isinstance(template, dict):
        if set(template) != set(saved):
            raise ValueError(f"checkpoint keys {sorted(saved)} != template keys {sorted(template)}")
        return type(template)((k, _fill(v, saved[k])) for k, v in template.items())
    if isinstance(template, (list, tuple)):
        if len(template) != len(saved):
            raise ValueError(f"checkpoint length {len(saved)} != template length {len(template)}")
        return type(template)(_fill(t, s) for t, s in zip(template, saved))
    return saved


def _snapshot(state: Any) -> dict:
    if isinstance(state, Replicated):
        return _snapshot(state[0])
    if isinstance(state, TrainState):
        return {
            "kind": "train_state",
            "module": _to_host(state.module.state_dict()),
            "optimizer": _to_host(state.optimizer.state_dict()),
            "step": int(state.step),
        }
    if isinstance(state, torch.nn.Module):
        return {"kind": "module", "module": _to_host(state.state_dict())}
    return {"kind": "tree", "tree": _to_host(state)}


class CheckpointService:
    """Retention-managed train-state checkpoints under one directory.

    Usage::

        ckpt = CheckpointService(workdir / "ckpt", max_to_keep=3)
        ckpt.save(step, state)            # async write-behind
        state = ckpt.restore_latest(state)  # template gives structure
    """

    def __init__(
        self,
        directory: str | Path,
        max_to_keep: int = 3,
        save_interval_steps: int = 1,
    ):
        self.directory = Path(directory).expanduser().resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        for p in self.directory.glob(".*.tmp-*"):  # an interrupted write
            shutil.rmtree(p, ignore_errors=True)
        self._steps = sorted(
            int(p.name) for p in self.directory.iterdir()
            if p.name.isdigit() and (p / STATE_FILE).is_file()
        )
        self._lock = threading.Lock()
        self._writer = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="checkpoint-writer"
        )
        self._pending: list[concurrent.futures.Future] = []

    # ---- write --------------------------------------------------------------

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Queue an async checkpoint of ``state`` at ``step``. Returns
        whether a save was started (save_interval/retention may skip).
        The state is copied to host memory before this returns."""
        step = int(step)
        with self._lock:
            if step in self._steps:
                if force:
                    raise ValueError(f"checkpoint step {step} already exists")
                return False
            if not force:
                latest = self._steps[-1] if self._steps else None
                if latest is not None and latest >= step:
                    return False
                if latest is not None and step % self.save_interval_steps:
                    return False
            snapshot = _snapshot(state)
            self._steps = sorted(self._steps + [step])
            drop = self._steps[: max(len(self._steps) - self.max_to_keep, 0)]
            self._steps = self._steps[len(drop):]
            self._pending.append(self._writer.submit(self._write, step, snapshot, drop))
        return True

    def _write(self, step: int, snapshot: dict, drop: list[int]) -> None:
        tmp = self.directory / f".{step}.tmp-{os.getpid()}"
        tmp.mkdir()
        try:
            with open(tmp / STATE_FILE, "wb") as f:
                torch.save(snapshot, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.directory / str(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in drop:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)

    def wait(self) -> None:
        """Block until queued saves are committed (call before reading
        the directory or tearing down)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    # ---- read ---------------------------------------------------------------

    def steps(self) -> list[int]:
        with self._lock:
            return list(self._steps)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any) -> Any:
        """Restore the checkpoint at ``step`` into ``template`` (a
        ``TrainState``, a module or a nested dict/list of tensors): each
        tensor lands on the template tensor's device and dtype."""
        self.wait()
        path = self.directory / str(int(step)) / STATE_FILE
        if not path.is_file():
            raise FileNotFoundError(f"no checkpoint at step {step} in {self.directory}")
        saved = torch.load(path, map_location="cpu", weights_only=True)
        return _restore(template, saved)

    def restore_latest(self, template: Any) -> Optional[Any]:
        """Restore the newest checkpoint, or None if the directory is
        empty (callers fall through to fresh initialization)."""
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, template)

    # ---- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        self.wait()
        self._writer.shutdown()

    def __enter__(self) -> "CheckpointService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _restore(template: Any, saved: dict) -> Any:
    """``saved`` into ``template``, replica by replica for a replicated one."""
    if isinstance(template, Replicated):
        return Replicated([_restore(replica, saved) for replica in template], template.mesh)
    if isinstance(template, TrainState):
        template.module.load_state_dict(saved["module"])
        template.optimizer.load_state_dict(saved["optimizer"])
        template.step = saved["step"]
        if isinstance(template, DataParallelTrainState):
            template.sync_replicas()
        return template
    if isinstance(template, torch.nn.Module):
        template.load_state_dict(saved["module"])
        return template
    return _fill(template, saved["tree"])
