"""AppBuilder — turn an artifact (manifest + deployment .py files) into
deployable specs.

Functional parity with the reference's builder (ref bioengine/apps/
builder.py): download each deployment file, ``exec`` it in a controlled
namespace with env vars applied (:1089-1246), introspect and validate
``__init__`` kwargs (:892-1087), compose multi-deployment apps by
binding handles to parameters named after sibling file stems
(:1474-1508), attach the datasets client (:657-661), isolate a per-app
working directory (:532-667), and resolve authorized users
(override > manifest, + admins) (:1522-1569).

TPU-native differences: no Ray runtime_env/venv machinery — apps run in
the worker image's environment (deps are declared, validated present,
not installed per-deploy), and each deployment's resource request is a
chip count + optional mesh spec instead of ``num_gpus``.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import sys
from pathlib import Path
from typing import Any, Callable, Optional

from bioengine_tpu_torch.apps.artifacts import LocalArtifactStore
from bioengine_tpu_torch.apps.manifest import AppManifest, load_manifest
from bioengine_tpu_torch.rpc.schema import is_schema_method
from bioengine_tpu_torch.serving.controller import DeploymentSpec
from bioengine_tpu_torch.serving.mesh_plan import MeshConfig
from bioengine_tpu_torch.serving.scheduler import SchedulingConfig
from bioengine_tpu_torch.serving.slo import SLOConfig
from bioengine_tpu_torch.serving.warm_pool import WarmPoolConfig
from bioengine_tpu_torch.utils.logger import create_logger

# env var override mirroring the reference's local-artifact escape hatch
LOCAL_ARTIFACT_ENV = "BIOENGINE_LOCAL_ARTIFACT_PATH"


class AppBuildError(RuntimeError):
    pass


@dataclasses.dataclass
class BuiltApp:
    app_id: str
    manifest: AppManifest
    specs: list[DeploymentSpec]
    entry_name: str
    schema_methods: dict[str, dict]        # entry method name -> schema
    authorized_users: list[str]
    app_dir: Optional[Path] = None


class AppBuilder:
    def __init__(
        self,
        store: Optional[LocalArtifactStore] = None,
        workdir_root: str | Path = "~/.bioengine/apps",
        data_client_factory: Optional[Callable[[], Any]] = None,
        admin_users: Optional[list[str]] = None,
        log_file: Optional[str] = None,
    ):
        self.store = store
        self.workdir_root = Path(workdir_root).expanduser()
        self.data_client_factory = data_client_factory
        self.admin_users = list(admin_users or [])
        self.logger = create_logger("apps.builder", log_file=log_file)

    # ---- source loading -----------------------------------------------------

    def _stage_frontend(
        self,
        app_dir: Path,
        artifact_id: Optional[str],
        version: Optional[str],
        local_path: Optional[str | Path],
    ) -> None:
        """Copy the app's ``frontend/`` dir (if any) into the workdir so
        the manager can serve it as a static site (the reference hosts
        app frontends via Hypha's artifact static-site URL, ref
        bioengine/utils/artifact_utils.py:612-628; here the framework's
        own server does)."""
        import shutil

        # always drop the previous deploy's copy: app_dir is reused per
        # app_id, and a stale frontend must not survive an update that
        # removed or renamed files
        target = app_dir / "frontend"
        shutil.rmtree(target, ignore_errors=True)
        if local_path is not None:
            src = Path(local_path) / "frontend"
            if src.is_dir():
                shutil.copytree(src, target)
            return
        if self.store is None or artifact_id is None:
            return
        for rel in self.store.list_files(artifact_id, version):
            if not rel.startswith("frontend/"):
                continue
            out = target.parent / rel
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_bytes(self.store.get_file(artifact_id, rel, version))

    def _load_sources(
        self,
        artifact_id: Optional[str],
        version: Optional[str],
        local_path: Optional[str | Path],
    ) -> tuple[AppManifest, dict[str, str], dict[str, str]]:
        """Returns (manifest, {file_stem: source}, {sibling_stem: source}).

        Siblings are top-level ``*.py`` files of the artifact that are
        not deployment entries — apps import them as plain modules
        (``from normalizer import ...``), matching the reference where
        the whole app dir is the Ray runtime_env workdir."""
        local_override = os.environ.get(LOCAL_ARTIFACT_ENV)
        if local_path is None and local_override and artifact_id:
            candidate = Path(local_override) / artifact_id
            if candidate.exists():
                local_path = candidate
        if local_path is not None:
            base = Path(local_path)
            manifest = load_manifest(base)
            sources = {
                ref.file_stem: (base / ref.python_file).read_text()
                for ref in manifest.deployments
            }
            siblings = {
                p.stem: p.read_text()
                for p in sorted(base.glob("*.py"))
                if p.stem not in sources
            }
            return manifest, sources, siblings
        if self.store is None or artifact_id is None:
            raise AppBuildError(
                "need a local_path or an artifact store + artifact_id"
            )
        manifest = self.store.get_manifest(artifact_id, version)
        sources = {
            ref.file_stem: self.store.get_file(
                artifact_id, ref.python_file, version
            ).decode()
            for ref in manifest.deployments
        }
        siblings = {}
        for path in self.store.list_files(artifact_id, version):
            if "/" in path or not path.endswith(".py"):
                continue
            stem = path[: -len(".py")]
            if stem not in sources:
                siblings[stem] = self.store.get_file(
                    artifact_id, path, version
                ).decode()
        return manifest, sources, siblings

    def _install_sibling_modules(
        self, app_id: str, siblings: dict[str, str]
    ) -> None:
        """Exec sibling modules and register them in sys.modules under
        both a namespaced key and the bare stem, so deployment code can
        ``import normalizer`` at top level or lazily inside methods.

        Replicas share this process, so a bare stem already claimed by a
        DIFFERENT app is re-pointed at this app's module with a warning
        — the per-app namespaced key stays unambiguous either way."""
        import types

        # Pre-register every sibling before exec'ing any, so siblings can
        # import each other at top level regardless of file order (and
        # circular imports behave like normal partially-initialized
        # modules).
        modules: dict[str, types.ModuleType] = {}
        for stem in siblings:
            module = types.ModuleType(stem)
            module.__file__ = f"{stem}.py"
            module.__bioengine_app__ = app_id
            modules[stem] = module
            existing = sys.modules.get(stem)
            if existing is not None and existing is not module:
                owner = getattr(existing, "__bioengine_app__", None)
                if owner is None:
                    self.logger.warning(
                        "app '%s' module '%s' shadows an already-imported "
                        "module of the same name for this process",
                        app_id, stem,
                    )
                elif owner != app_id:
                    self.logger.warning(
                        "app module name '%s' already claimed by app "
                        "'%s'; re-pointing at app '%s'",
                        stem, owner, app_id,
                    )
            sys.modules[f"bioengine_app_{app_id}.{stem}"] = module
            sys.modules[stem] = module
        for stem, source in siblings.items():
            try:
                exec(
                    compile(source, f"{stem}.py", "exec"),
                    modules[stem].__dict__,
                )
            except Exception as e:
                raise AppBuildError(
                    f"executing app module '{stem}.py' failed: {e}"
                ) from e

    # ---- exec + class extraction --------------------------------------------

    def _load_class(
        self,
        stem: str,
        class_name: str,
        source: str,
        env_vars: dict[str, str],
        app_id: str,
    ) -> type:
        """Execute the deployment module and pull out the class.

        Env vars are applied to os.environ before exec (the reference
        passes them as exec globals AND runtime_env env_vars; one pinned
        process here, so os.environ is the single source). ``_``-prefixed
        keys are the secret convention — values masked in any status
        output (ref apps/manager.py:619-651)."""
        for k, v in env_vars.items():
            os.environ[k] = str(v)
        namespace: dict[str, Any] = {
            "__name__": f"bioengine_app_{app_id}_{stem}",
            "__file__": f"{stem}.py",
        }
        try:
            exec(compile(source, f"{stem}.py", "exec"), namespace)
        except Exception as e:
            raise AppBuildError(
                f"executing deployment '{stem}.py' failed: {e}"
            ) from e
        cls = namespace.get(class_name)
        if not inspect.isclass(cls):
            raise AppBuildError(
                f"'{stem}.py' does not define class '{class_name}'"
            )
        return cls

    # ---- kwargs validation --------------------------------------------------

    def _check_params(
        self,
        cls: type,
        kwargs: dict[str, Any],
        handle_params: set[str],
    ) -> None:
        """Validate provided kwargs against __init__'s signature —
        unexpected kwargs and missing required params fail the build,
        not the replica (ref builder.py:892-1087)."""
        sig = inspect.signature(cls.__init__)
        params = {n: p for n, p in sig.parameters.items() if n != "self"}
        accepts_var_kw = any(
            p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()
        )
        for name in kwargs:
            if name not in params and not accepts_var_kw:
                raise AppBuildError(
                    f"{cls.__name__}.__init__ got unexpected kwarg "
                    f"'{name}' (accepts: {sorted(params)})"
                )
        missing = [
            n
            for n, p in params.items()
            if p.default is inspect.Parameter.empty
            and p.kind
            in (
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
                inspect.Parameter.KEYWORD_ONLY,
            )
            and n not in kwargs
            and n not in handle_params
        ]
        if missing:
            raise AppBuildError(
                f"{cls.__name__}.__init__ missing required kwargs: {missing}"
            )

    # ---- build --------------------------------------------------------------

    def build(
        self,
        app_id: str,
        artifact_id: Optional[str] = None,
        version: Optional[str] = None,
        local_path: Optional[str | Path] = None,
        deployment_kwargs: Optional[dict[str, dict[str, Any]]] = None,
        env_vars: Optional[dict[str, str]] = None,
        authorized_users_override: Optional[list[str]] = None,
        make_handle: Optional[Callable[[str], Any]] = None,
        deployer: Optional[str] = None,
    ) -> BuiltApp:
        manifest, sources, siblings = self._load_sources(
            artifact_id, version, local_path
        )
        self._install_sibling_modules(app_id, siblings)
        deployment_kwargs = dict(deployment_kwargs or {})
        env_vars = dict(env_vars or {})

        app_dir = self.workdir_root / app_id
        app_dir.mkdir(parents=True, exist_ok=True)
        self._stage_frontend(app_dir, artifact_id, version, local_path)

        stems = [ref.file_stem for ref in manifest.deployments]
        classes: dict[str, type] = {}
        for ref in manifest.deployments:
            classes[ref.file_stem] = self._load_class(
                ref.file_stem,
                ref.class_name,
                sources[ref.file_stem],
                env_vars,
                app_id,
            )

        # artifact payload for remote placement: the complete app as
        # files + the original deploy kwargs, so a worker host rebuilds
        # the instance from source (never pickled closures) — the analog
        # of the reference's runtime_env workdir shipped to worker nodes
        import yaml as _yaml

        payload_files = {"manifest.yaml": _yaml.safe_dump(manifest.raw)}
        for ref in manifest.deployments:
            payload_files[ref.python_file] = sources[ref.file_stem]
        for stem, src in siblings.items():
            payload_files[f"{stem}.py"] = src
        base_payload = {
            "app_id": app_id,
            "files": payload_files,
            "deployment_kwargs": deployment_kwargs,
            "env_vars": env_vars,
        }

        specs: list[DeploymentSpec] = []
        entry_ref = manifest.entry_deployment
        for ref in manifest.deployments:
            cls = classes[ref.file_stem]
            kwargs = dict(deployment_kwargs.get(ref.file_stem, {}))
            sig_params = set(
                inspect.signature(cls.__init__).parameters
            ) - {"self"}
            # composition: parameters named after sibling stems get handles
            handle_params = {
                p for p in sig_params if p in stems and p != ref.file_stem
            }
            self._check_params(cls, kwargs, handle_params)
            cfg = manifest.deployment_config.get(ref.file_stem, {})
            factory = self._make_factory(
                cls, kwargs, handle_params, make_handle, app_dir
            )
            # operator-facing batching knobs (manifest
            # deployment_config.<dep>.batching) ride the spec so
            # replicas — local or rebuilt from the shipped payload on a
            # worker host — tune their ContinuousBatcher without code
            # changes; scheduling opts the deployment into the global
            # scheduler (cross-replica batching, admission control,
            # predictive autoscaling)
            batching = dict(cfg.get("batching") or {})
            scheduling_cfg = cfg.get("scheduling")
            slo_cfg = cfg.get("slo")
            warm_pool_cfg = cfg.get("warm_pool")
            mesh_cfg = cfg.get("mesh")
            try:
                spec_max_batch = (
                    int(batching["max_batch"])
                    if "max_batch" in batching
                    else None
                )
                spec_max_wait_ms = (
                    float(batching["max_wait_ms"])
                    if "max_wait_ms" in batching
                    else None
                )
                scheduling = (
                    SchedulingConfig.from_config(dict(scheduling_cfg))
                    if scheduling_cfg
                    else None
                )
                slo = (
                    SLOConfig.from_config(dict(slo_cfg)) if slo_cfg else None
                )
                warm_pool = (
                    WarmPoolConfig.from_config(dict(warm_pool_cfg))
                    if warm_pool_cfg
                    else None
                )
                mesh = (
                    MeshConfig.from_config(dict(mesh_cfg))
                    if mesh_cfg
                    else None
                )
                if mesh is not None and warm_pool is not None:
                    # a mesh standby's chips span hosts, so the pool's
                    # per-host skip_hosts guard cannot protect its
                    # promotion — reject the combo instead of promoting
                    # a dead-sharded mesh into rotation
                    raise ValueError(
                        "warm_pool cannot combine with mesh "
                        "(standby promotion is per-host; a mesh spans "
                        "several) — drop one of the two blocks"
                    )
            except (TypeError, ValueError) as e:
                # every config mistake on this path fails TYPED with the
                # deployment named — never a raw traceback
                raise AppBuildError(
                    f"invalid mesh/batching/scheduling/warm_pool/slo "
                    f"config for deployment '{ref.file_stem}': {e} "
                    f"(vocabulary reference: docs/apps-guide.md, "
                    f"'The deployment_config vocabulary')"
                ) from e
            specs.append(
                DeploymentSpec(
                    name=ref.file_stem,
                    instance_factory=factory,
                    num_replicas=int(cfg.get("num_replicas", 1)),
                    min_replicas=int(cfg.get("min_replicas", 1)),
                    max_replicas=int(cfg.get("max_replicas", 3)),
                    chips_per_replica=int(cfg.get("chips", 0)),
                    max_ongoing_requests=int(cfg.get("max_ongoing_requests", 10)),
                    autoscale=bool(cfg.get("autoscale", True)),
                    max_batch=spec_max_batch,
                    max_wait_ms=spec_max_wait_ms,
                    scheduling=scheduling,
                    slo=slo,
                    warm_pool=warm_pool,
                    mesh=mesh,
                    remote_payload={
                        **base_payload,
                        "deployment": ref.file_stem,
                    },
                )
            )

        entry_cls = classes[entry_ref.file_stem]
        schema_methods = {
            name: fn.__schema__
            for name, fn in inspect.getmembers(entry_cls, callable)
            if is_schema_method(fn)
        }
        if not schema_methods:
            raise AppBuildError(
                f"entry class {entry_cls.__name__} exposes no "
                f"@schema_method endpoints"
            )

        # authorized users: explicit override beats manifest; admins and
        # the deployer always included (ref builder.py:1522-1569)
        users = list(
            authorized_users_override
            if authorized_users_override is not None
            else manifest.authorized_users
        )
        for extra in [*self.admin_users, deployer]:
            if extra and extra not in users:
                users.append(extra)
        if not users:
            users = list(self.admin_users)

        # deploy entry LAST so its siblings exist first
        specs_sorted = [s for s in specs if s.name != entry_ref.file_stem] + [
            s for s in specs if s.name == entry_ref.file_stem
        ]
        return BuiltApp(
            app_id=app_id,
            manifest=manifest,
            specs=specs_sorted,
            entry_name=entry_ref.file_stem,
            schema_methods=schema_methods,
            authorized_users=users,
            app_dir=app_dir,
        )

    def _make_factory(
        self,
        cls: type,
        kwargs: dict[str, Any],
        handle_params: set[str],
        make_handle: Optional[Callable[[str], Any]],
        app_dir: Path,
    ) -> Callable[[], Any]:
        data_factory = self.data_client_factory

        def factory():
            call_kwargs = dict(kwargs)
            for p in handle_params:
                if make_handle is None:
                    raise AppBuildError(
                        f"deployment needs a handle for '{p}' but no "
                        f"handle provider was configured"
                    )
                call_kwargs[p] = make_handle(p)
            instance = cls(**call_kwargs)
            # per-app scratch dir + datasets client attach
            instance.workdir = app_dir
            if data_factory is not None and not hasattr(
                instance, "bioengine_datasets"
            ):
                instance.bioengine_datasets = data_factory()
            return instance

        factory.__name__ = f"factory_{cls.__name__}"
        return factory
