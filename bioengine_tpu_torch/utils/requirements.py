"""Dependency pinning helpers for app runtime environments.

Capability parity with ref bioengine/utils/requirements.py: read this
package's own dependency metadata, normalize loose specifiers to exact
pins for reproducibility, and inject selected framework deps into app
runtime envs (skipping the heavyweight compute stack, which is provided
by the worker image itself — torch/triton here, where the reference
skips ``ray*``).
"""

from __future__ import annotations

import re
from importlib import metadata
from typing import Iterable

# Provided by the base image; never injected into app envs. Exact names
# — NOT prefixes, so torchmetrics-style packages still install.
SKIP_PACKAGES = frozenset({"torch", "triton"})

# Framework deps apps need to talk back to the worker.
INJECTED = ("numpy", "pyyaml", "httpx", "aiohttp", "cloudpickle", "pydantic")

_SPEC_RE = re.compile(r"^([A-Za-z0-9_.\-\[\]]+)\s*(==|>=|<=|~=|>|<)\s*([\w.]+)")


def normalize_requirement(req: str) -> str:
    """Pin loose specifiers: ``pkg>=1.2`` -> ``pkg==1.2``.

    Only the operator is rewritten; the version written in the spec is
    kept, so an app's declared bound is never silently replaced with
    whatever happens to be installed locally
    (ref bioengine/utils/requirements.py:10-36 semantics).
    """
    m = _SPEC_RE.match(req.strip())
    if not m:
        return req.strip()
    return f"{m.group(1)}=={m.group(3)}"


def get_pip_requirements(select: Iterable[str] = INJECTED) -> list[str]:
    """Exact pins of selected framework deps, from installed metadata."""
    out = []
    for name in select:
        if name.lower() in SKIP_PACKAGES:
            continue
        try:
            out.append(f"{name}=={metadata.version(name)}")
        except metadata.PackageNotFoundError:
            continue
    return out


def update_requirements(app_requirements: list[str]) -> list[str]:
    """Merge app requirements with framework pins; app pins win on clash."""
    merged: dict[str, str] = {}
    for req in get_pip_requirements():
        merged[_req_name(req)] = req
    for req in app_requirements:
        name = _req_name(req)
        if name in SKIP_PACKAGES:
            continue
        merged[name] = normalize_requirement(req)
    return sorted(merged.values())


def _req_name(req: str) -> str:
    return re.split(r"[=<>~!\[ ]", req.strip(), maxsplit=1)[0].lower()
