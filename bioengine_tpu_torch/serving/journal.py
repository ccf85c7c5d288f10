"""Durable control-plane state: write-ahead intent journal + snapshot.

The controller holds everything — deployment specs, chip leases,
scheduler queues, warm pools — in one process's memory. This module
makes the *declarative* slice of that state (what SHOULD be running:
deployed apps with their full ``DeploymentSpec``s, admin bindings, and
the controller epoch) survive a crash or upgrade:

- **Intent journal** (``journal.log``): an append-only record stream,
  one CRC-guarded line per *intent commit* — ``deploy`` / ``undeploy``
  / ``scale`` accepted, ``epoch`` minted, ``admins`` bound. Never
  per-request: the journal write sits on the control path, not the
  data path. Each line is ``J1 <crc32hex> <json>``; replay stops
  cleanly at the first record whose CRC or JSON fails (a torn tail
  from a crash mid-append loses at most that one uncommitted record).
- **Compacted snapshot** (``snapshot.json``): the folded state, written
  atomically (tmp file + fsync + rename) every
  ``BIOENGINE_JOURNAL_SNAPSHOT_EVERY`` journal records and at
  recovery-complete; the journal restarts empty after each snapshot, so
  replay cost is bounded by the snapshot cadence, not uptime.
- **Epoch**: every controller start mints ``last_epoch + 1`` and
  persists it BEFORE serving, so a wedged-then-revived old controller
  can never out-epoch its replacement. The epoch is stamped on host
  verbs (``register_host`` / ``start_replica`` / ``drain_replica`` /
  ``stop_replica``) and hosts reject lower-epoch verbs typed
  (:class:`~bioengine_tpu_torch.serving.errors.StaleEpochError`) — the
  split-brain fence.

The journal directory is ``BIOENGINE_CONTROL_DIR``; unset means the
controller runs memory-only exactly as before (tests, toys). What is
deliberately NOT journaled: replica placements and chip leases — those
are *observed* state, reconciled at recovery from what live hosts
actually report (``register_host`` warm-replica inventory), because
the hosts are the ground truth the journal could only approximate.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import zlib
from pathlib import Path
from typing import Any, Optional

from bioengine_tpu_torch.utils import flight, metrics
from bioengine_tpu_torch.utils.logger import create_logger

SNAPSHOT_NAME = "snapshot.json"
JOURNAL_NAME = "journal.log"
_MAGIC = "J1"

JOURNAL_RECORDS = metrics.counter(
    "journal_records_total",
    "intent records appended to the control-plane journal",
)
JOURNAL_SNAPSHOTS = metrics.counter(
    "journal_snapshots_total",
    "compacted control-plane snapshots written (atomic rename)",
)
JOURNAL_REPLAYED = metrics.counter(
    "journal_replay_records_total",
    "journal records replayed into controller state at recovery",
)


# ---------------------------------------------------------------------------
# DeploymentSpec <-> dict (the full deployment_config vocabulary:
# scheduling / slo / warm_pool / mesh / batching blocks all round-trip)
# ---------------------------------------------------------------------------


def spec_to_dict(spec) -> dict:
    """Serialize a ``DeploymentSpec`` for the journal. Everything
    round-trips except ``instance_factory`` (a live callable): specs
    with a ``remote_payload`` rebuild it from the payload's shipped
    sources at recovery; purely-local specs without one are recorded
    but can only be re-served by an explicit redeploy."""

    def block(cfg) -> Optional[dict]:
        return None if cfg is None else dataclasses.asdict(cfg)

    return {
        "name": spec.name,
        "num_replicas": spec.num_replicas,
        "min_replicas": spec.min_replicas,
        "max_replicas": spec.max_replicas,
        "chips_per_replica": spec.chips_per_replica,
        "max_ongoing_requests": spec.max_ongoing_requests,
        "autoscale": spec.autoscale,
        "target_load": spec.target_load,
        "max_batch": spec.max_batch,
        "max_wait_ms": spec.max_wait_ms,
        "scheduling": block(spec.scheduling),
        "slo": block(spec.slo),
        "warm_pool": block(spec.warm_pool),
        "mesh": block(spec.mesh),
        "remote_payload": spec.remote_payload,
    }


class PayloadInstanceFactory:
    """Lazy local-build factory for a journal-recovered spec: on first
    call it writes the remote payload's shipped sources to a workdir
    and runs the standard AppBuilder — the same build a worker host
    performs in ``start_replica`` — returning the instance. Recovery
    itself never builds anything; only an actual LOCAL placement pays
    (remote placements ship the payload to the host as always)."""

    def __init__(self, payload: dict, workdir_root: Optional[Path] = None,
                 make_handle: Any = None):
        self._payload = payload
        self._workdir_root = workdir_root
        self._make_handle = make_handle
        self._factory = None

    def __call__(self):
        if self._factory is None:
            self._factory = self._build()
        return self._factory()

    def _build(self):
        import tempfile

        from bioengine_tpu_torch.apps.builder import AppBuilder

        payload = self._payload
        root = Path(
            self._workdir_root
            or tempfile.mkdtemp(prefix="bioengine-journal-build-")
        )
        app_id = payload["app_id"]
        src = root / f"recovered-{app_id}"
        src.mkdir(parents=True, exist_ok=True)
        for rel, text in payload["files"].items():
            target = src / rel
            if not target.resolve().is_relative_to(src.resolve()):
                raise ValueError(f"payload path escapes app dir: {rel}")
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_text(text)
        builder = AppBuilder(workdir_root=root / "apps")
        built = builder.build(
            app_id=app_id,
            local_path=src,
            deployment_kwargs=payload.get("deployment_kwargs"),
            env_vars=payload.get("env_vars"),
            make_handle=self._make_handle,
        )
        spec = next(
            s for s in built.specs if s.name == payload["deployment"]
        )
        return spec.instance_factory


class UnrecoverableFactory:
    """Factory stand-in for a journaled spec with no remote payload:
    the intent survives (status shows it, operators see what was lost)
    but a local placement fails loudly instead of serving garbage."""

    def __init__(self, app_id: str, deployment: str):
        self.app_id = app_id
        self.deployment = deployment

    def __call__(self):
        raise RuntimeError(
            f"{self.app_id}/{self.deployment} was recovered from the "
            f"journal without a remote payload — its instance_factory "
            f"was a live callable that died with the old controller; "
            f"redeploy the app to restore it"
        )


def spec_from_dict(d: dict, app_id: str, make_handle: Any = None):
    """Rebuild a ``DeploymentSpec`` from its journal form."""
    from bioengine_tpu_torch.serving.controller import DeploymentSpec
    from bioengine_tpu_torch.serving.mesh_plan import MeshConfig
    from bioengine_tpu_torch.serving.scheduler import SchedulingConfig
    from bioengine_tpu_torch.serving.slo import SLOConfig
    from bioengine_tpu_torch.serving.warm_pool import WarmPoolConfig

    def block(cls, data):
        if data is None:
            return None
        kwargs = dict(data)
        if cls is MeshConfig:
            kwargs["entry_methods"] = tuple(
                kwargs.get("entry_methods") or ()
            )
        return cls(**kwargs)

    payload = d.get("remote_payload")
    if payload is not None:
        factory: Any = PayloadInstanceFactory(
            payload, make_handle=make_handle
        )
    else:
        factory = UnrecoverableFactory(app_id, d["name"])
    return DeploymentSpec(
        name=d["name"],
        instance_factory=factory,
        num_replicas=int(d.get("num_replicas", 1)),
        min_replicas=int(d.get("min_replicas", 1)),
        max_replicas=int(d.get("max_replicas", 3)),
        chips_per_replica=int(d.get("chips_per_replica", 0)),
        max_ongoing_requests=int(d.get("max_ongoing_requests", 10)),
        autoscale=bool(d.get("autoscale", True)),
        target_load=float(d.get("target_load", 0.7)),
        max_batch=d.get("max_batch"),
        max_wait_ms=d.get("max_wait_ms"),
        scheduling=block(SchedulingConfig, d.get("scheduling")),
        slo=block(SLOConfig, d.get("slo")),
        warm_pool=block(WarmPoolConfig, d.get("warm_pool")),
        mesh=block(MeshConfig, d.get("mesh")),
        remote_payload=payload,
    )


# ---------------------------------------------------------------------------
# secret redaction (CLI inspection — journals carry remote payloads
# whose env_vars may hold tokens)
# ---------------------------------------------------------------------------

_SECRET_KEY_MARKERS = ("token", "secret", "password", "api_key", "apikey",
                       "credential", "auth")


def redact_secrets(obj: Any) -> Any:
    """Recursively mask values under secret-shaped keys and shrink the
    bulky ``files`` payload to a name->size map — what ``bioengine
    debug journal`` prints. The on-disk journal is untouched."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            lk = str(k).lower()
            if any(m in lk for m in _SECRET_KEY_MARKERS) and isinstance(
                v, (str, bytes)
            ):
                out[k] = "***redacted***"
            elif lk == "files" and isinstance(v, dict):
                out[k] = {
                    name: f"<{len(text)} chars>"
                    for name, text in v.items()
                }
            else:
                out[k] = redact_secrets(v)
        return out
    if isinstance(obj, list):
        return [redact_secrets(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JournalState:
    """Folded declarative state after snapshot load + journal replay."""

    epoch: int = 0
    seq: int = 0
    apps: dict[str, dict] = dataclasses.field(default_factory=dict)
    admins: list[str] = dataclasses.field(default_factory=list)
    snapshot_loaded: bool = False
    records_replayed: int = 0
    torn_tail: bool = False          # replay stopped at a bad record
    recovering_snapshot: bool = False  # snapshot written mid-recovery

    def apply(self, record: dict) -> None:
        op = record.get("op")
        data = record.get("data") or {}
        self.seq = max(self.seq, int(record.get("seq", 0)))
        self.epoch = max(self.epoch, int(record.get("epoch", 0)))
        if op == "epoch":
            pass  # the epoch max above is the whole effect
        elif op == "deploy":
            self.apps[data["app_id"]] = {
                "specs": data["specs"],
                "acl": data.get("acl"),
            }
        elif op == "undeploy":
            self.apps.pop(data.get("app_id", ""), None)
        elif op == "scale":
            app = self.apps.get(data.get("app_id", ""))
            if app:
                for spec in app["specs"]:
                    if spec.get("name") == data.get("deployment"):
                        spec["num_replicas"] = int(data["num_replicas"])
        elif op == "admins":
            self.admins = list(data.get("admins") or [])
        # unknown ops are skipped: an OLD controller replaying a NEWER
        # journal (downgrade) keeps what it understands


class ControlJournal:
    """Write-ahead intent journal + compacted snapshot in one
    directory. All writes are synchronous file appends with fsync —
    acceptable because they happen at intent commit (deploy/undeploy/
    scale), never per request."""

    def __init__(self, directory: str | Path,
                 snapshot_every: Optional[int] = None):
        self.directory = Path(directory).expanduser()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.snapshot_every = (
            snapshot_every
            if snapshot_every is not None
            else int(os.environ.get("BIOENGINE_JOURNAL_SNAPSHOT_EVERY", "64"))
        )
        self.logger = create_logger("journal", log_file="off")
        self.epoch = 0
        self.seq = 0
        self._records_since_snapshot = 0
        self.records_written = 0
        self.snapshots_written = 0
        # the folded view the periodic snapshot writes; refreshed via
        # set_snapshot_state, or pulled lazily from snapshot_provider
        # at snapshot time (so the owner doesn't pay a full-fleet
        # serialization on every append — only 1-in-snapshot_every
        # appends actually compacts)
        self._snapshot_state: dict = {"apps": {}, "admins": []}
        self._recovering = False
        # optional () -> (apps, admins, recovering) callable
        self.snapshot_provider = None

    # ---- construction -------------------------------------------------------

    @classmethod
    def from_env(cls) -> Optional["ControlJournal"]:
        directory = os.environ.get("BIOENGINE_CONTROL_DIR")
        if not directory:
            return None
        return cls(directory)

    @property
    def snapshot_path(self) -> Path:
        return self.directory / SNAPSHOT_NAME

    @property
    def journal_path(self) -> Path:
        return self.directory / JOURNAL_NAME

    # ---- load / replay ------------------------------------------------------

    def load(self) -> JournalState:
        """Snapshot + journal -> folded state. Never raises on bad
        content: a torn final record stops the replay cleanly (the
        records before it are kept) and the verdict rides
        ``state.torn_tail``."""
        state = JournalState()
        snap = self._read_snapshot()
        if snap is not None:
            state.snapshot_loaded = True
            state.epoch = int(snap.get("epoch", 0))
            state.seq = int(snap.get("seq", 0))
            state.apps = dict(snap.get("apps") or {})
            state.admins = list(snap.get("admins") or [])
            state.recovering_snapshot = bool(snap.get("recovering", False))
        records, torn, valid_bytes = self._scan()
        if torn:
            state.torn_tail = True
            self._truncate_torn_tail(valid_bytes)
        for record in records:
            if int(record.get("seq", 0)) <= state.seq and record.get(
                "op"
            ) != "epoch":
                continue  # already folded into the snapshot
            state.apply(record)
            state.records_replayed += 1
        if state.records_replayed:
            JOURNAL_REPLAYED.inc(state.records_replayed)
        self.epoch = state.epoch
        self.seq = state.seq
        self._snapshot_state = {
            "apps": dict(state.apps),
            "admins": list(state.admins),
        }
        flight.record(
            "journal.replay",
            directory=str(self.directory),
            snapshot=state.snapshot_loaded,
            records=state.records_replayed,
            torn_tail=state.torn_tail,
            epoch=state.epoch,
            apps=len(state.apps),
        )
        return state

    def _read_snapshot(self) -> Optional[dict]:
        try:
            raw = self.snapshot_path.read_text()
        except OSError:
            return None
        try:
            snap = json.loads(raw)
        except json.JSONDecodeError as e:
            # an atomic-rename snapshot should never be torn; a corrupt
            # one is surfaced loudly but recovery proceeds from the
            # journal alone rather than refusing to start
            self.logger.error(f"snapshot unreadable ({e}); ignoring it")
            return None
        return snap if isinstance(snap, dict) else None

    def read_records(self):
        """Yield parsed journal records in order; yields ``None`` once
        (then stops) at the first CRC/parse failure — the torn-tail
        sentinel the caller turns into a flag."""
        records, torn, _ = self._scan()
        yield from records
        if torn:
            yield None

    @staticmethod
    def _parse_line(line: bytes) -> Optional[dict]:
        parts = line.split(b" ", 2)
        if len(parts) != 3 or parts[0] != _MAGIC.encode():
            return None
        crc_hex, body = parts[1], parts[2]
        try:
            expect = int(crc_hex, 16)
        except ValueError:
            return None
        if zlib.crc32(body) & 0xFFFFFFFF != expect:
            return None
        try:
            record = json.loads(body)
        except json.JSONDecodeError:
            return None
        return record if isinstance(record, dict) else None

    def _scan(self) -> tuple[list[dict], bool, int]:
        """Parse the journal -> ``(records, torn, valid_bytes)`` where
        ``valid_bytes`` is the length of the longest clean prefix. A
        final line without its newline terminator is torn by definition:
        ``append`` fsyncs the full line, so an unterminated tail means
        the crash happened mid-append and the record was never acked."""
        records: list[dict] = []
        try:
            raw = self.journal_path.read_bytes()
        except OSError:
            return records, False, 0
        pos = 0
        n = len(raw)
        while pos < n:
            nl = raw.find(b"\n", pos)
            if nl < 0:
                return records, True, pos
            line = raw[pos:nl]
            if line.strip():
                record = self._parse_line(line)
                if record is None:
                    return records, True, pos
                records.append(record)
            pos = nl + 1
        return records, False, pos

    def _truncate_torn_tail(self, valid_bytes: int) -> None:
        """Cut the journal back to its clean prefix so the NEXT append
        starts on a fresh line — without this, a new record written
        after a torn tail merges onto the partial line, fails CRC on
        the next replay, and takes every later record (including the
        minted epoch) down with it."""
        try:
            with open(self.journal_path, "r+b") as f:
                f.truncate(valid_bytes)
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            self.logger.error(f"torn-tail truncate failed: {e}")
            return
        self.logger.warning(
            f"journal torn tail truncated to {valid_bytes} bytes "
            f"(the uncommitted record is discarded)"
        )

    # ---- append / snapshot --------------------------------------------------

    def mint_epoch(self) -> int:
        """``last_epoch + 1``, persisted (journal record + fsync)
        BEFORE the new controller serves anything — the monotonic fence
        a revived old controller can never climb over."""
        self.epoch += 1
        self.append("epoch", {})
        return self.epoch

    def append(self, op: str, data: Optional[dict] = None) -> dict:
        self.seq += 1
        record = {
            "seq": self.seq,
            "ts": time.time(),
            "epoch": self.epoch,
            "op": op,
            "data": data or {},
        }
        body = json.dumps(record, separators=(",", ":"), default=str).encode()
        crc = zlib.crc32(body) & 0xFFFFFFFF
        line = b"%s %08x %s\n" % (_MAGIC.encode(), crc, body)
        with open(self.journal_path, "ab") as f:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())
        self.records_written += 1
        self._records_since_snapshot += 1
        JOURNAL_RECORDS.inc()
        if self._records_since_snapshot >= self.snapshot_every:
            self.write_snapshot()
        return record

    def set_snapshot_state(
        self, apps: dict, admins: list, recovering: bool = False
    ) -> None:
        """Refresh the folded view the next snapshot will persist
        (called by the controller at every intent commit — apps maps
        app_id to ``{"specs": [...], "acl": ...}``)."""
        self._snapshot_state = {"apps": apps, "admins": list(admins)}
        self._recovering = recovering

    def write_snapshot(self) -> Path:
        """Atomic compaction: write tmp + fsync + rename, then start a
        fresh journal (the snapshot subsumes every record up to
        ``seq``). A crash between rename and truncate only means a few
        records replay as no-ops (their seq is <= the snapshot's)."""
        if self.snapshot_provider is not None:
            apps, admins, recovering = self.snapshot_provider()
            self._snapshot_state = {"apps": apps, "admins": list(admins)}
            self._recovering = bool(recovering)
        snap = {
            "version": 1,
            "epoch": self.epoch,
            "seq": self.seq,
            "written_at": time.time(),
            "recovering": self._recovering,
            **self._snapshot_state,
        }
        tmp = self.snapshot_path.with_suffix(".json.tmp")
        data = json.dumps(snap, indent=2, default=str)
        with open(tmp, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snapshot_path)
        # fsync the DIRECTORY so the rename's metadata is durable
        # before the truncate below — without it a power loss could
        # persist an empty journal next to the OLD snapshot, losing
        # every record since the previous compaction
        dir_fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        # the journal restarts empty — its records are folded in
        with open(self.journal_path, "wb") as f:
            f.flush()
            os.fsync(f.fileno())
        self._records_since_snapshot = 0
        self.snapshots_written += 1
        JOURNAL_SNAPSHOTS.inc()
        flight.record(
            "journal.snapshot",
            directory=str(self.directory),
            seq=self.seq,
            epoch=self.epoch,
            apps=len(self._snapshot_state.get("apps") or {}),
            recovering=self._recovering,
        )
        return self.snapshot_path

    # ---- inspection ---------------------------------------------------------

    def describe(self) -> dict:
        return {
            "directory": str(self.directory),
            "epoch": self.epoch,
            "seq": self.seq,
            "records_written": self.records_written,
            "snapshots_written": self.snapshots_written,
            "snapshot_every": self.snapshot_every,
            "journal_bytes": (
                self.journal_path.stat().st_size
                if self.journal_path.exists()
                else 0
            ),
            "snapshot_exists": self.snapshot_path.exists(),
        }

    def inspect(self, tail: int = 20) -> dict:
        """Offline dump for ``bioengine debug journal``: the snapshot
        plus the last ``tail`` journal records, secrets redacted."""
        records: list[dict] = []
        torn = False
        for record in self.read_records():
            if record is None:
                torn = True
                break
            records.append(record)
        snap = self._read_snapshot()
        return {
            "directory": str(self.directory),
            "snapshot": redact_secrets(snap) if snap else None,
            "journal_records": len(records),
            "torn_tail": torn,
            "tail": [redact_secrets(r) for r in records[-tail:]],
        }


__all__ = [
    "ControlJournal",
    "JournalState",
    "PayloadInstanceFactory",
    "UnrecoverableFactory",
    "redact_secrets",
    "spec_from_dict",
    "spec_to_dict",
]
