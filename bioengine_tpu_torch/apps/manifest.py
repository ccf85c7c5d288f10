"""App manifest schema + validation.

Same manifest contract as the reference so existing app directories port
unchanged (ref bioengine/apps/builder.py:29-67: required name/id/
id_emoji/description/type/deployments, optional frontend_entry;
``deployments`` entries are "file_stem:ClassName"). The TPU build adds
optional per-deployment resource hints (``deployment_config``) including
a mesh spec.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any, Optional

import yaml

REQUIRED_FIELDS = ("name", "id", "id_emoji", "description", "type", "deployments")
# accept the reference's type string so existing manifests work verbatim
ACCEPTED_TYPES = ("tpu-serve", "ray-serve")

_DEPLOYMENT_RE = re.compile(r"^([A-Za-z_][\w\-/]*):([A-Za-z_]\w*)$")

# operator-tunable per-deployment blocks with a fixed vocabulary —
# validated here so a typo fails the manifest, not a live deploy.
# ``batching`` feeds the replica's ContinuousBatcher (injected as
# bioengine_batch_config); ``scheduling`` opts the deployment into the
# controller's global scheduler (key set validated in depth by
# serving.scheduler.SchedulingConfig.from_config at build time);
# ``slo`` declares the deployment's service objectives (validated in
# depth by serving.slo.SLOConfig.from_config at build time — latency
# objective + percentile, availability target, window); ``warm_pool``
# keeps N pre-started standby replicas that absorb scale-up and
# preemption by promotion (validated in depth by
# serving.warm_pool.WarmPoolConfig.from_config at build time);
# ``mesh`` places one logical replica across several hosts' chip
# leases — pipeline/dp/tp shards for checkpoints bigger than one lease
# (validated in depth by serving.mesh_plan.MeshConfig.from_config).
_BATCHING_KEYS = {"max_batch", "max_wait_ms"}


class ManifestError(ValueError):
    pass


@dataclasses.dataclass
class DeploymentRef:
    file_stem: str
    class_name: str

    @property
    def python_file(self) -> str:
        return f"{self.file_stem}.py"


@dataclasses.dataclass
class AppManifest:
    name: str
    id: str
    id_emoji: str
    description: str
    type: str
    deployments: list[DeploymentRef]
    version: str = "1.0.0"
    frontend_entry: Optional[str] = None
    authorized_users: list[str] = dataclasses.field(default_factory=list)
    deployment_config: dict[str, dict] = dataclasses.field(default_factory=dict)
    raw: dict = dataclasses.field(default_factory=dict)

    @property
    def entry_deployment(self) -> DeploymentRef:
        """First listed deployment is the entry point (the service
        surface), matching the reference's convention."""
        return self.deployments[0]


def validate_manifest(data: dict[str, Any]) -> AppManifest:
    missing = [f for f in REQUIRED_FIELDS if not data.get(f)]
    if missing:
        raise ManifestError(f"manifest missing required fields: {missing}")
    if data["type"] not in ACCEPTED_TYPES:
        raise ManifestError(
            f"manifest type must be one of {ACCEPTED_TYPES}, "
            f"got '{data['type']}'"
        )
    deployments = []
    for entry in data["deployments"]:
        m = _DEPLOYMENT_RE.match(str(entry))
        if not m:
            raise ManifestError(
                f"deployment entry '{entry}' is not 'file_stem:ClassName'"
            )
        deployments.append(DeploymentRef(m.group(1), m.group(2)))
    if not deployments:
        raise ManifestError("manifest needs at least one deployment")
    for dep_name, cfg in (data.get("deployment_config") or {}).items():
        if not isinstance(cfg, dict):
            raise ManifestError(
                f"deployment_config.{dep_name} must be a mapping, got "
                f"{type(cfg).__name__}"
            )
        batching = cfg.get("batching")
        if batching is not None:
            if not isinstance(batching, dict):
                raise ManifestError(
                    f"deployment_config.{dep_name}.batching must be a "
                    f"mapping, got {type(batching).__name__}"
                )
            unknown = sorted(set(batching) - _BATCHING_KEYS)
            if unknown:
                raise ManifestError(
                    f"deployment_config.{dep_name}.batching has unknown "
                    f"keys {unknown} (accepted: {sorted(_BATCHING_KEYS)})"
                )
        scheduling = cfg.get("scheduling")
        if scheduling is not None and not isinstance(scheduling, dict):
            raise ManifestError(
                f"deployment_config.{dep_name}.scheduling must be a "
                f"mapping, got {type(scheduling).__name__}"
            )
        slo = cfg.get("slo")
        if slo is not None and not isinstance(slo, dict):
            raise ManifestError(
                f"deployment_config.{dep_name}.slo must be a "
                f"mapping, got {type(slo).__name__}"
            )
        warm_pool = cfg.get("warm_pool")
        if warm_pool is not None and not isinstance(warm_pool, dict):
            raise ManifestError(
                f"deployment_config.{dep_name}.warm_pool must be a "
                f"mapping, got {type(warm_pool).__name__}"
            )
        mesh = cfg.get("mesh")
        if mesh is not None and not isinstance(mesh, dict):
            raise ManifestError(
                f"deployment_config.{dep_name}.mesh must be a "
                f"mapping, got {type(mesh).__name__}"
            )
    return AppManifest(
        name=str(data["name"]),
        id=str(data["id"]),
        id_emoji=str(data["id_emoji"]),
        description=str(data["description"]),
        type=data["type"],
        deployments=deployments,
        version=str(data.get("version", "1.0.0")),
        frontend_entry=data.get("frontend_entry"),
        authorized_users=list(data.get("authorized_users", []) or []),
        deployment_config={
            k: dict(v) for k, v in (data.get("deployment_config") or {}).items()
        },
        raw=dict(data),
    )


def load_manifest(path: str | Path) -> AppManifest:
    path = Path(path)
    if path.is_dir():
        path = path / "manifest.yaml"
    if not path.exists():
        raise ManifestError(f"no manifest at {path}")
    return validate_manifest(yaml.safe_load(path.read_text()) or {})
