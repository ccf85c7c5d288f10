"""Minimal BioImage Model Zoo RDF (resource description file) support.

Own copy of ``bioengine_tpu/runtime/rdf.py``: axes bookkeeping,
pre-/post-processing ops and weight-source selection, for spec 0.4/0.5
model RDFs. One difference: the card's machine may lack PyYAML, so
``load_model_rdf`` parses with ``yaml`` where it imports and otherwise
parses the file as JSON (which is valid YAML), raising a clear error when
neither works.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class TensorSpec:
    name: str
    axes: str                      # canonical string like "bcyx" / "byxc"
    preprocessing: list[dict]
    postprocessing: list[dict]
    data_range: Optional[tuple] = None


@dataclasses.dataclass
class ModelRDF:
    name: str
    rdf_id: Optional[str]
    description: str
    inputs: list[TensorSpec]
    outputs: list[TensorSpec]
    weights: dict[str, dict]       # format -> {"source": ..., ...}
    raw: dict

    @property
    def preferred_weights(self) -> tuple[str, dict]:
        """Fallback preference when no ``jax_params`` entry exists."""
        for fmt in ("pytorch_state_dict", "torchscript", "onnx"):
            if fmt in self.weights:
                return fmt, self.weights[fmt]
        if self.weights:
            return next(iter(self.weights.items()))
        raise ValueError(f"Model '{self.name}' has no weight entries")


def _axes_string(axes: Any) -> str:
    """Normalize spec-0.5 axis dicts or 0.4 strings to a char string."""
    if isinstance(axes, str):
        return axes
    chars = []
    for ax in axes:
        if isinstance(ax, dict):
            t = ax.get("type", ax.get("id", "?"))
            chars.append(
                {"batch": "b", "channel": "c", "space": ax.get("id", "x")}.get(
                    t, str(ax.get("id", "?"))[0]
                )
            )
        else:
            chars.append(str(ax)[0])
    return "".join(chars)


def _tensor_spec(entry: dict) -> TensorSpec:
    return TensorSpec(
        name=str(entry.get("name", entry.get("id", "tensor"))),
        axes=_axes_string(entry.get("axes", "bcyx")),
        preprocessing=list(entry.get("preprocessing", []) or []),
        postprocessing=list(entry.get("postprocessing", []) or []),
    )


def _parse_rdf_text(text: str, where: str = "rdf") -> dict:
    """YAML through PyYAML where it imports; else the text as JSON."""
    try:
        import yaml
    except ImportError:
        yaml = None
    if yaml is not None:
        return yaml.safe_load(text)
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(
            f"{where}: PyYAML is not installed and the file is not JSON "
            f"({e}); install PyYAML or write the RDF as JSON text, which "
            "is valid YAML"
        ) from e


def load_model_rdf(source: str | Path | dict) -> ModelRDF:
    if isinstance(source, (str, Path)):
        raw = _parse_rdf_text(Path(source).read_text(), str(source))
    else:
        raw = dict(source)
    if raw.get("type") not in (None, "model"):
        raise ValueError(f"Not a model RDF (type={raw.get('type')})")
    return ModelRDF(
        name=raw.get("name", "unnamed-model"),
        rdf_id=raw.get("id"),
        description=raw.get("description", ""),
        inputs=[_tensor_spec(e) for e in raw.get("inputs", [])],
        outputs=[_tensor_spec(e) for e in raw.get("outputs", [])],
        weights={k: dict(v or {}) for k, v in (raw.get("weights") or {}).items()},
        raw=raw,
    )


# ---- axes conversion --------------------------------------------------------

def canonical_layout(axes: str) -> str:
    """The engine layout for an RDF axes string: volumetric tensors
    ('z' present) canonicalize to (B, Z, Y, X, C), planar to (B, Y, X, C)."""
    return "bzyxc" if "z" in axes.lower() else "byxc"


def _to_layout(x: np.ndarray, axes: str, layout: str) -> np.ndarray:
    """Rearrange an array described by ``axes`` into ``layout``, adding
    singleton dims for layout axes the source doesn't have."""
    unknown = sorted(set(axes) - set(layout))
    if unknown:
        raise ValueError(
            f"axes '{axes}' contain {unknown} which the runtime does "
            f"not support (supported layouts: byxc / bzyxc; time or index "
            f"axes are not implemented)"
        )
    x = np.asarray(x)
    if x.ndim != len(axes):
        if x.ndim == len(axes) - 1 and "b" in axes:
            x = x[None]
        else:
            raise ValueError(f"array ndim {x.ndim} != axes '{axes}'")
    order = [axes.index(a) for a in layout if a in axes]
    missing = [a for a in layout if a not in axes]
    x = np.transpose(x, order + [i for i in range(len(axes)) if i not in order])
    for a in missing:
        x = np.expand_dims(x, layout.index(a) if a != "c" else -1)
    return x


def _from_layout(x: np.ndarray, axes: str, layout: str) -> np.ndarray:
    """Inverse of _to_layout for the model-output round trip."""
    present = [a for a in layout if a in axes]
    # drop axes the target doesn't have (singleton only)
    for i, a in reversed(list(enumerate(layout))):
        if a not in axes:
            x = np.squeeze(x, axis=i if a != "c" else -1)
    inv = [present.index(a) for a in axes if a in present]
    return np.transpose(x, inv)


def to_nhwc(x: np.ndarray, axes: str) -> np.ndarray:
    """Rearrange an array described by an RDF axes string into the
    engine's canonical layout: (B,H,W,C), or (B,Z,H,W,C) when the axes
    include a z dimension."""
    axes = axes.lower()
    return _to_layout(x, axes, canonical_layout(axes))


def from_nhwc(x: np.ndarray, axes: str) -> np.ndarray:
    """Inverse of to_nhwc for the model-output round trip."""
    axes = axes.lower()
    return _from_layout(x, axes, canonical_layout(axes))


# ---- pre/post-processing ops ------------------------------------------------

def apply_processing(x: np.ndarray, ops: list[dict]) -> np.ndarray:
    """Apply RDF pre-/post-processing ops (numpy, channels-last layout)."""
    for op in ops:
        name = op.get("name", op.get("id"))
        kw = op.get("kwargs", {}) or {}
        if name in ("zero_mean_unit_variance", "fixed_zero_mean_unit_variance"):
            mean = kw.get("mean")
            std = kw.get("std")
            if mean is None:
                axes = tuple(range(x.ndim - 1)) if kw.get("mode") != "per_sample" else tuple(range(1, x.ndim))
                mean = x.mean(axis=axes, keepdims=True)
                std = x.std(axis=axes, keepdims=True)
            x = (x - np.asarray(mean)) / (np.asarray(std) + kw.get("eps", 1e-6))
        elif name == "scale_range":
            lo = np.percentile(x, kw.get("min_percentile", 0.0))
            hi = np.percentile(x, kw.get("max_percentile", 100.0))
            x = (x - lo) / max(hi - lo, kw.get("eps", 1e-6))
        elif name == "scale_linear":
            x = x * np.asarray(kw.get("gain", 1.0)) + np.asarray(kw.get("offset", 0.0))
        elif name == "sigmoid":
            x = 1.0 / (1.0 + np.exp(-x))
        elif name == "binarize":
            x = (x > kw.get("threshold", 0.5)).astype(np.float32)
        elif name == "clip":
            x = np.clip(x, kw.get("min"), kw.get("max"))
        else:
            raise NotImplementedError(f"processing op '{name}'")
    return x.astype(np.float32)
