"""Streamed checkpoint loading from key->shape manifests.

Own copy of ``bioengine_tpu/runtime/weight_stream.py``. A
``<weights>.manifest.json`` next to a package's npz makes the layout
known without reading a weight byte, so building the model and loading
its weights overlap:

1. :func:`skeleton_from_manifest` builds a zero-filled params tree of the
   checkpoint's exact shapes and dtypes; the engine is built from it at
   once and starts capturing its programs (the same shapes, so the same
   graphs; the real values are later copied into the same tensors).
2. :class:`StreamedWeightLoader` streams the real weight groups on
   background threads (the npz is a zip: each member reads on its own).
3. Prediction gates on the engine's ``complete_param_streaming``, so no
   request runs against the skeleton.

No manifest: the caller loads eagerly. A manifest/checkpoint mismatch
fails the load loudly. The end of a load leaves a ``weights.streamed``
or ``weights.stream_error`` flight event.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Mapping, Optional

import numpy as np

from bioengine_tpu_torch.runtime.convert import unflatten_params
from bioengine_tpu_torch.utils import flight

logger = logging.getLogger(__name__)

MANIFEST_SUFFIX = ".manifest.json"


def manifest_path_for(weights_path: str | Path) -> Path:
    """``weights.npz`` -> ``weights.npz.manifest.json`` beside it."""
    p = Path(weights_path)
    return p.with_name(p.name + MANIFEST_SUFFIX)


def load_manifest(weights_path: str | Path) -> Optional[dict[str, dict]]:
    """Read the key->{shape, dtype} manifest for ``weights_path``, or None
    when absent/unreadable (the caller then loads eagerly).

    Accepts ``{"a/b": [3, 3]}`` (shape only, float32) and
    ``{"a/b": {"shape": [3, 3], "dtype": "bfloat16"}}``; returns the dict
    form."""
    p = manifest_path_for(weights_path)
    if not p.is_file():
        return None
    try:
        data = json.loads(p.read_text())
    except (OSError, json.JSONDecodeError) as e:
        logger.warning("manifest %s unreadable (%s); eager load", p, e)
        return None
    if not isinstance(data, dict) or not data:
        return None
    try:
        out: dict[str, dict] = {}
        for k, v in data.items():
            if isinstance(v, dict):
                shape = [int(d) for d in v["shape"]]
                dtype = str(np.dtype(v.get("dtype", "float32")))
            else:
                shape = [int(d) for d in v]
                dtype = "float32"
            out[str(k)] = {"shape": shape, "dtype": dtype}
        return out
    except (TypeError, ValueError, KeyError):
        logger.warning("manifest %s malformed; eager load", p)
        return None


def write_manifest(
    weights_path: str | Path, params_flat: Mapping[str, np.ndarray]
) -> Path:
    """Write the key->{shape, dtype} manifest for a flat params mapping."""
    p = manifest_path_for(weights_path)
    p.write_text(
        json.dumps(
            {
                k: {
                    "shape": list(np.asarray(v).shape),
                    "dtype": str(np.asarray(v).dtype),
                }
                for k, v in params_flat.items()
            },
            indent=1,
            sort_keys=True,
        )
        + "\n"
    )
    return p


def skeleton_from_manifest(manifest: Mapping[str, dict]) -> dict[str, Any]:
    """Zero-filled params tree with the manifest's exact layout and
    dtypes."""
    return unflatten_params(
        {
            k: np.zeros(tuple(e["shape"]), np.dtype(e["dtype"]))
            for k, e in manifest.items()
        }
    )


def group_keys(manifest: Mapping[str, Any]) -> dict[str, list[str]]:
    """Manifest keys bucketed by top-level group (the ``a`` of ``a/b/c``),
    the unit of concurrent streaming."""
    groups: dict[str, list[str]] = {}
    for key in manifest:
        groups.setdefault(key.split("/", 1)[0], []).append(key)
    return groups


class StreamedWeightLoader:
    """Load an npz checkpoint group by group on background threads.

    ``on_complete(params)`` fires once with the full tree (checked against
    the manifest); ``on_error(exc)`` fires on the first failure."""

    def __init__(
        self,
        npz_path: str | Path,
        manifest: Mapping[str, dict],
        on_complete: Callable[[dict], None],
        on_error: Optional[Callable[[BaseException], None]] = None,
        max_workers: int = 4,
        model_id: str = "?",
    ):
        self.npz_path = str(npz_path)
        self.manifest = dict(manifest)
        self.on_complete = on_complete
        self.on_error = on_error
        self.max_workers = max(1, int(max_workers))
        self.model_id = model_id
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.groups_loaded = 0
        self.bytes_loaded = 0
        self.seconds: float = 0.0
        self._started_at: Optional[float] = None

    def start(self) -> "StreamedWeightLoader":
        self._started_at = time.perf_counter()
        t = threading.Thread(
            target=self._run, name=f"weight-stream-{self.model_id}", daemon=True
        )
        t.start()
        return self

    def _load_group(self, keys: list[str]) -> dict[str, np.ndarray]:
        # one npz handle per task: zipfile handles are not shared across
        # reader threads
        out: dict[str, np.ndarray] = {}
        with np.load(self.npz_path) as data:
            for key in keys:
                if key not in data.files:
                    raise KeyError(
                        f"manifest key '{key}' missing from {self.npz_path}"
                    )
                arr = data[key]
                entry = self.manifest[key]
                want = tuple(entry["shape"])
                if tuple(arr.shape) != want:
                    raise ValueError(
                        f"'{key}': checkpoint shape {tuple(arr.shape)} != "
                        f"manifest shape {want}"
                    )
                want_dtype = np.dtype(entry["dtype"])
                if arr.dtype != want_dtype:
                    raise ValueError(
                        f"'{key}': checkpoint dtype {arr.dtype} != "
                        f"manifest dtype {want_dtype}"
                    )
                out[key] = arr
        return out

    def _run(self) -> None:
        try:
            groups = group_keys(self.manifest)
            flat: dict[str, np.ndarray] = {}
            with ThreadPoolExecutor(
                max_workers=min(self.max_workers, max(1, len(groups))),
                thread_name_prefix=f"wstream-{self.model_id}",
            ) as pool:
                futures = {
                    pool.submit(self._load_group, keys): name
                    for name, keys in groups.items()
                }
                for fut in futures:
                    loaded = fut.result()
                    flat.update(loaded)
                    self.groups_loaded += 1
                    self.bytes_loaded += sum(a.nbytes for a in loaded.values())
            # checkpoint keys the manifest doesn't know would silently
            # vanish from the model: refuse
            with np.load(self.npz_path) as data:
                extra = sorted(set(data.files) - set(self.manifest))
            if extra:
                raise KeyError(
                    f"checkpoint carries {len(extra)} keys absent from the "
                    f"manifest, e.g. {extra[:3]}: regenerate the manifest "
                    f"or fall back to eager load"
                )
            self.seconds = time.perf_counter() - self._started_at
            flight.record(
                "weights.streamed",
                model=self.model_id,
                groups=self.groups_loaded,
                bytes=self.bytes_loaded,
                seconds=round(self.seconds, 3),
            )
            self.on_complete(unflatten_params(flat))
        except Exception as e:  # noqa: BLE001 — surfaced via on_error and the first request
            self.error = e
            self.seconds = time.perf_counter() - self._started_at
            flight.record(
                "weights.stream_error",
                severity="error",
                model=self.model_id,
                error=str(e)[:300],
            )
            logger.warning("streamed weight load failed for %s: %s", self.model_id, e)
            if self.on_error is not None:
                self.on_error(e)
        finally:
            self.done.set()

    def stats(self) -> dict:
        return {
            "npz_path": self.npz_path,
            "keys": len(self.manifest),
            "groups_loaded": self.groups_loaded,
            "bytes_loaded": self.bytes_loaded,
            "seconds": round(self.seconds, 4),
            "done": self.done.is_set(),
            "error": str(self.error) if self.error else None,
        }
