"""Controller-managed warm pool — preemption-tolerant standby replicas.

The predictive autoscaler (PR 8) and SLO burn pressure (PR 10) decide
to scale up BEFORE saturation, but the decision is worthless if the new
replica still pays full compile + checkpoint load first. A warm pool
keeps N fully-started standby replicas per deployment — instance built,
``async_init`` run (weights resident), ``test_deployment`` passed (so
programs are compiled wherever the app's self-test exercises them) —
OUT of the routing set. Scale-up and preemption recovery then PROMOTE a
standby (an O(ms) list move + flight event) instead of cold-starting,
and the pool refills in the background.

Config rides the manifest's ``deployment_config.<dep>.warm_pool`` block
(validated typed at build, like ``scheduling:``/``slo:``); sizing can
optionally follow the PR 10 telemetry history (a rising arrival rate
grows the pool toward ``max_size`` before the burst needs it).

Chip accounting: standbys lease chips exactly like serving replicas
(they are warm BECAUSE they sit on real devices), so pool size is a
capacity trade the operator makes explicitly.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

from bioengine_tpu_torch.utils import flight, metrics

WARMPOOL_PROMOTIONS = metrics.counter(
    "warmpool_promotions_total",
    "standby replicas promoted into the serving set",
    ("app", "deployment"),
)
WARMPOOL_FILLS = metrics.counter(
    "warmpool_fills_total",
    "standby replicas started to (re)fill a warm pool",
    ("app", "deployment"),
)


@dataclass
class WarmPoolConfig:
    """Per-deployment warm-pool knobs (manifest:
    ``deployment_config.<dep>.warm_pool``)."""

    size: int = 1                  # standbys kept ready
    max_size: Optional[int] = None  # telemetry sizing ceiling (None = size)
    # let PR 10 telemetry history grow the pool toward max_size when
    # the deployment's arrival rate is rising (off by default — sizing
    # follows the operator's number unless they opt in)
    telemetry_sized: bool = False
    # refill a promoted/dead standby in the background; off makes the
    # pool one-shot (drain on use), mostly useful in tests
    refill: bool = True

    @classmethod
    def from_config(cls, cfg: dict) -> "WarmPoolConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(cfg) - known)
        if unknown:
            raise ValueError(
                f"unknown warm_pool config keys: {unknown} "
                f"(accepted: {sorted(known)})"
            )
        out = cls()
        if "size" in cfg:
            out.size = int(cfg["size"])
            if out.size < 0:
                raise ValueError("warm_pool.size must be >= 0")
        if "max_size" in cfg and cfg["max_size"] is not None:
            out.max_size = int(cfg["max_size"])
        if "telemetry_sized" in cfg:
            out.telemetry_sized = bool(cfg["telemetry_sized"])
        if "refill" in cfg:
            out.refill = bool(cfg["refill"])
        if out.max_size is not None and out.max_size < out.size:
            raise ValueError(
                f"warm_pool.max_size ({out.max_size}) < size ({out.size})"
            )
        return out


class WarmPool:
    """The standby set for one deployment. The controller owns all
    placement/teardown; this class owns membership and accounting."""

    def __init__(self, app_id: str, deployment: str, config: WarmPoolConfig):
        self.app_id = app_id
        self.deployment = deployment
        self.config = config
        self.standbys: list = []        # Replica | RemoteReplica, all started
        # standbys currently being PLACED (cold start in flight, not yet
        # in standbys) — counted against target so a promotion-triggered
        # refill and the health tick can't both fill the same slot
        self.filling = 0
        self.promotions = 0
        self.fills = 0
        self.fill_failures = 0
        self.last_promotion_at: Optional[float] = None
        self._m_promotions = WARMPOOL_PROMOTIONS.labels(app_id, deployment)
        self._m_fills = WARMPOOL_FILLS.labels(app_id, deployment)

    # ---- membership ---------------------------------------------------------

    def add(self, replica) -> None:
        self.standbys.append(replica)
        self.fills += 1
        self._m_fills.inc()
        flight.record(
            "warmpool.fill",
            app=self.app_id,
            deployment=self.deployment,
            replica=replica.replica_id,
            host=getattr(replica, "host_id", None),
            occupancy=len(self.standbys),
        )

    def pop_routable(self, skip_hosts: Optional[set] = None):
        """Take the first routable standby (oldest first — it has been
        warm longest), or None. ``skip_hosts`` excludes standbys whose
        host the controller already knows is dead — promoting one would
        hand traffic a black hole whose health check hasn't run yet.
        Records the promotion; the caller moves it into the serving set
        and emits ``replica.place``."""
        from bioengine_tpu_torch.serving.replica import ROUTABLE_STATES

        for i, replica in enumerate(self.standbys):
            if (
                skip_hosts
                and getattr(replica, "host_id", None) in skip_hosts
            ):
                continue
            if replica.state in ROUTABLE_STATES:
                self.standbys.pop(i)
                self.promotions += 1
                self._m_promotions.inc()
                self.last_promotion_at = time.time()
                if hasattr(replica, "mark_promoted"):
                    replica.mark_promoted()
                flight.record(
                    "warmpool.promote",
                    app=self.app_id,
                    deployment=self.deployment,
                    replica=replica.replica_id,
                    host=getattr(replica, "host_id", None),
                    standby_seconds=replica.ttfr.get("standby_seconds"),
                    occupancy=len(self.standbys),
                )
                return replica
        return None

    def remove_dead(self) -> list:
        """Drop (and return) standbys that went non-routable — the
        controller releases their leases and refills."""
        from bioengine_tpu_torch.serving.replica import ROUTABLE_STATES

        dead = [r for r in self.standbys if r.state not in ROUTABLE_STATES]
        if dead:
            self.standbys = [
                r for r in self.standbys if r.state in ROUTABLE_STATES
            ]
        return dead

    def drain_all(self) -> list:
        out, self.standbys = self.standbys, []
        return out

    # ---- sizing -------------------------------------------------------------

    def target_size(self, telemetry=None) -> int:
        """The size this pool should hold right now. With
        ``telemetry_sized`` and a history store, a rising request rate
        (latest base-resolution bucket vs the window mean) grows the
        target toward ``max_size`` so the pool is already deep when the
        autoscaler fires."""
        base = self.config.size
        ceiling = (
            self.config.max_size
            if self.config.max_size is not None
            else base
        )
        if not self.config.telemetry_sized or telemetry is None:
            return base
        try:
            series = telemetry.series(
                self.app_id, self.deployment, "request_rate"
            )
            # zero-rate buckets are DATA, not gaps: an idle-then-burst
            # deployment needs its idle zeros in the mean for the burst
            # to register as a spike (and a just-gone-idle latest bucket
            # of 0 must read as "no burst", not inherit an old value)
            points = [
                p["value"]
                for p in (series or [])
                if p.get("value") is not None
            ]
        except Exception:  # noqa: BLE001 — sizing never breaks the health tick
            return base
        if len(points) < 3:
            return base
        mean = sum(points) / len(points)
        if mean > 0 and points[-1] > 1.5 * mean:
            return min(base + 1, ceiling)
        return base

    def stats(self) -> dict:
        return {
            "occupancy": len(self.standbys),
            "filling": self.filling,
            "target": self.config.size,
            "max_size": self.config.max_size,
            "telemetry_sized": self.config.telemetry_sized,
            "promotions": self.promotions,
            "fills": self.fills,
            "fill_failures": self.fill_failures,
            "last_promotion_at": self.last_promotion_at,
            "standby_replicas": [r.replica_id for r in self.standbys],
        }
