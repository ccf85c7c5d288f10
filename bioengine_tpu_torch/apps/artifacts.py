"""Versioned application artifact store.

The reference stores app packages in a remote Hypha artifact manager
with staged versioning: saving a NEW version snapshots the current one;
re-saving the LATEST version updates in place; re-saving an OLDER
version is an error (ref bioengine/utils/artifact_utils.py:320-478).
This module provides the same semantics over a local directory tree —
which also serves as the test/dev override the reference exposes via
``BIOENGINE_LOCAL_ARTIFACT_PATH`` (ref apps/builder.py:268-279).

Layout: ``root/<artifact_id>/<version>/{manifest.yaml, *.py, ...}``
with a ``latest`` marker file naming the current version.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Optional

from bioengine_tpu_torch.apps.manifest import AppManifest, load_manifest


class ArtifactVersionError(ValueError):
    pass


class LocalArtifactStore:
    def __init__(self, root: str | Path):
        self.root = Path(root).expanduser()
        self.root.mkdir(parents=True, exist_ok=True)

    # ---- read ---------------------------------------------------------------

    def list_artifacts(self) -> list[str]:
        return sorted(
            p.name
            for p in self.root.iterdir()
            if p.is_dir() and (p / "latest").exists()
        )

    def versions(self, artifact_id: str) -> list[str]:
        adir = self.root / artifact_id
        if not adir.exists():
            raise KeyError(f"artifact '{artifact_id}' not found")
        return sorted(
            p.name for p in adir.iterdir() if p.is_dir()
        )

    def latest_version(self, artifact_id: str) -> str:
        marker = self.root / artifact_id / "latest"
        if not marker.exists():
            raise KeyError(f"artifact '{artifact_id}' not found")
        return marker.read_text().strip()

    def artifact_dir(self, artifact_id: str, version: Optional[str] = None) -> Path:
        version = version or self.latest_version(artifact_id)
        d = self.root / artifact_id / version
        if not d.exists():
            raise KeyError(f"{artifact_id}@{version} not found")
        return d

    def get_manifest(
        self, artifact_id: str, version: Optional[str] = None
    ) -> AppManifest:
        return load_manifest(self.artifact_dir(artifact_id, version))

    def get_file(
        self, artifact_id: str, path: str, version: Optional[str] = None
    ) -> bytes:
        base = self.artifact_dir(artifact_id, version)
        f = (base / path).resolve()
        # defense in depth: paths can arrive from HTTP routes
        # (apps/artifact_http.py) — never read outside the version dir
        if not f.is_relative_to(base.resolve()):
            raise FileNotFoundError(f"{artifact_id}: path escapes artifact")
        if not f.is_file():
            raise FileNotFoundError(f"{artifact_id}@{version or 'latest'}:{path}")
        return f.read_bytes()

    def list_files(
        self, artifact_id: str, version: Optional[str] = None
    ) -> list[str]:
        d = self.artifact_dir(artifact_id, version)
        return sorted(
            str(p.relative_to(d)) for p in d.rglob("*") if p.is_file()
        )

    # ---- write (versioned staging semantics) --------------------------------

    def put(
        self,
        src_dir: str | Path,
        artifact_id: Optional[str] = None,
        version: Optional[str] = None,
    ) -> tuple[str, str]:
        """Upload an app directory. Returns (artifact_id, version).

        Version rules (parity with ref artifact_utils.py:320-478):
        - no existing artifact: creates it at ``version`` (default from
          manifest, then "1.0.0")
        - version == latest: in-place re-save
        - version > latest (new): snapshot as the new latest
        - version < latest: error
        """
        src = Path(src_dir)
        manifest = load_manifest(src)
        artifact_id = artifact_id or manifest.id
        version = version or manifest.version
        adir = self.root / artifact_id
        marker = adir / "latest"
        if marker.exists():
            latest = marker.read_text().strip()
            if version != latest:
                if _version_key(version) < _version_key(latest):
                    raise ArtifactVersionError(
                        f"cannot re-save older version {version} "
                        f"(latest is {latest})"
                    )
        dest = adir / version
        if dest.exists():
            shutil.rmtree(dest)
        dest.mkdir(parents=True)
        for p in src.rglob("*"):
            if p.is_file():
                rel = p.relative_to(src)
                target = dest / rel
                target.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy2(p, target)
        adir.mkdir(exist_ok=True)
        marker.write_text(version)
        return artifact_id, version

    def put_files(
        self,
        files: dict[str, bytes | str],
        artifact_id: Optional[str] = None,
        version: Optional[str] = None,
    ) -> tuple[str, str]:
        """Upload from an in-memory {relative_path: content} mapping —
        the wire form used by remote CLI uploads, where the client's
        filesystem is not visible to the worker."""
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            base = Path(tmp)
            for rel, content in files.items():
                target = (base / rel).resolve()
                if not str(target).startswith(str(base.resolve())):
                    raise ValueError(f"path traversal in upload: '{rel}'")
                target.parent.mkdir(parents=True, exist_ok=True)
                if isinstance(content, str):
                    content = content.encode()
                target.write_bytes(content)
            return self.put(base, artifact_id, version)

    def delete(self, artifact_id: str, version: Optional[str] = None) -> None:
        adir = self.root / artifact_id
        if not adir.exists():
            raise KeyError(f"artifact '{artifact_id}' not found")
        if version is None:
            shutil.rmtree(adir)
            return
        target = adir / version
        if not target.exists():
            raise KeyError(f"{artifact_id}@{version} not found")
        shutil.rmtree(target)
        marker = adir / "latest"
        remaining = sorted(
            (p.name for p in adir.iterdir() if p.is_dir()), key=_version_key
        )
        if remaining:
            marker.write_text(remaining[-1])
        else:
            shutil.rmtree(adir)


def _version_key(v: str) -> tuple:
    parts = []
    for piece in str(v).replace("-", ".").split("."):
        parts.append((0, int(piece)) if piece.isdigit() else (1, piece))
    return tuple(parts)
