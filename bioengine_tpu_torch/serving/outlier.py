"""Gray-failure detection — per-replica latency outliers and probation.

The PR 4 breaker and failover only see **fail-stop** failures: a
replica must raise before any defense engages. A **gray-failing**
replica — still passing health checks, still answering, but at 10× the
latency of its siblings (thermal throttling, a wedged neighbor VM, a
dying disk behind the page cache) — is invisible to all of them, and at
production scale it dominates tail latency.

This module closes that gap with latency evidence the request path
already produces: every successful attempt's service time feeds a
per-replica EWMA, compared against the **deployment median** (the
lower median — with two replicas, the plain median averages the
outlier in and can never exceed ratio 2). A replica whose EWMA stays
above ``ratio × median`` for longer than ``excursion_s`` enters
**PROBATION**: soft-ejected from the scored pick like a breaker trip,
but — exactly like the scheduler's infeasible-probe pattern — still
probed with a trickle of real traffic (every ``probe_every``-th pick)
so recovery is observed, not assumed: when the probed EWMA falls back
under ``recovery_ratio × median``, the replica returns to HEALTHY on
its own.

The median comparison is also the adversarial-case guard: when the
WHOLE deployment slows down together (recompile, bigger batches, input
shift), every EWMA rises, the median rises with them, no ratio moves —
and nobody gets ejected. Probation is only ever a minority verdict
(``max_eject_fraction``), so a correlated excursion can never empty
the routing set.

The tracker also keeps a bounded reservoir of recent deployment-wide
service times; its p95 is what derives the request-hedging delay
(``DeploymentHandle`` launches a second attempt when the first is
slower than most requests ever are — see controller.py).

Knobs (read once at config construction):

=================================  ======= ==============================
``BIOENGINE_OUTLIER``              1       0 disables detection entirely
``BIOENGINE_OUTLIER_RATIO``        3.0     excursion threshold vs median
``BIOENGINE_OUTLIER_EXCURSION_S``  10.0    persistence before probation
``BIOENGINE_OUTLIER_PROBE_EVERY``  8       trickle: every Nth pick probes
``BIOENGINE_HEDGE_DELAY_MS``       0       fixed hedge delay (0 = p95)
=================================  ======= ==============================
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from bioengine_tpu_torch.utils import flight, metrics

REPLICA_PROBATIONS = metrics.counter(
    "replica_probations_total",
    "replicas soft-ejected as latency outliers (gray-failure defense)",
    ("app", "deployment"),
)

# floor under the derived hedge delay: hedging below a few ms just
# doubles load on an uncontended deployment without helping the tail
_HEDGE_FLOOR_S = 0.002
# before the reservoir has this many samples, the p95 is noise — use
# the default delay instead
_MIN_HEDGE_SAMPLES = 20
_DEFAULT_HEDGE_DELAY_S = 0.05


@dataclass(frozen=True)
class OutlierConfig:
    """Gray-failure detection knobs. One instance per controller,
    env-derived by default (read once — this sits on the hot path)."""

    enabled: bool = True
    ewma_alpha: float = 0.3
    ratio: float = 3.0               # EWMA vs deployment median → outlier
    recovery_ratio: float = 1.5      # EWMA back under this → recover
    excursion_s: float = 10.0        # persistence before probation
    min_samples: int = 8             # per-replica samples before eligible
    probe_every: int = 8             # trickle: every Nth pick probes
    max_eject_fraction: float = 0.5  # probation is a minority verdict
    min_latency_s: float = 0.001     # ignore sub-ms noise medians
    hedge_delay_s: float = 0.0       # fixed hedge delay; 0 = p95-derived
    # consecutive hedge losses (hedge launched after the p95 delay AND
    # a sibling finished first) before probation — the detection path
    # that still works when hedging itself has dried up the EWMA's
    # sample stream (losers are cancelled, not measured)
    hedge_streak_limit: int = 5

    @classmethod
    def from_env(cls) -> "OutlierConfig":
        env = os.environ.get
        return cls(
            enabled=env("BIOENGINE_OUTLIER", "1") not in ("0", "false", ""),
            ratio=float(env("BIOENGINE_OUTLIER_RATIO", "3.0")),
            excursion_s=float(env("BIOENGINE_OUTLIER_EXCURSION_S", "10.0")),
            probe_every=int(env("BIOENGINE_OUTLIER_PROBE_EVERY", "8")),
            hedge_delay_s=float(env("BIOENGINE_HEDGE_DELAY_MS", "0")) / 1000.0,
        )


@dataclass
class _ReplicaStats:
    ewma: Optional[float] = None
    samples: int = 0
    excursion_since: Optional[float] = None
    in_probation: bool = False
    hedge_streak: int = 0
    # probe completions measured since this probation began: exit needs
    # FRESH evidence — the EWMA frozen at entry time (hedging had dried
    # up the sample stream) must not exit the replica by itself
    samples_in_probation: int = 0


@dataclass
class DeploymentLatencyTracker:
    """Per-deployment latency bookkeeping: one EWMA per replica, a
    deployment-wide p95 reservoir, probation verdicts, and the probe
    ticket counter. Owned by the controller (one per (app, deployment)
    key, swept at undeploy like every other router-state dict)."""

    app_id: str
    deployment: str
    cfg: OutlierConfig
    replicas: dict[str, _ReplicaStats] = field(default_factory=dict)
    recent: deque = field(default_factory=lambda: deque(maxlen=256))
    _probe_tick: int = 0
    _hedge_cache: tuple[float, float] = (0.0, 0.0)  # (computed_at, value)

    # ---- observation ------------------------------------------------------

    def note(
        self, replica_id: str, seconds: float, now: Optional[float] = None
    ) -> list[tuple[str, str]]:
        """Record one successful attempt's service time and return the
        probation transitions it caused as ``[(replica_id, "enter" |
        "exit"), ...]``. Cancelled hedge losers and failed attempts
        must NOT be noted — a cancelled attempt's wall time measures
        the winner, and a failure's measures the transport, not the
        replica's service rate.

        EVERY replica is re-evaluated on every note, not just the
        sampled one: once hedging starts rescuing requests off a gray
        replica, its own sample stream dries up (losers are cancelled,
        not measured) and its EWMA freezes at the elevated value — the
        excursion clock and the deployment median must keep moving on
        the siblings' samples or detection would stall exactly when
        the defense engages."""
        now = time.monotonic() if now is None else now
        st = self.replicas.setdefault(replica_id, _ReplicaStats())
        st.samples += 1
        st.hedge_streak = 0  # a measured completion breaks the streak
        if st.in_probation:
            st.samples_in_probation += 1
        if st.ewma is None:
            st.ewma = seconds
        else:
            a = self.cfg.ewma_alpha
            st.ewma = a * seconds + (1.0 - a) * st.ewma
        if not st.in_probation:
            # the hedge-delay reservoir tracks the HEALTHY serving set:
            # probe completions against a gray replica are exactly the
            # slow samples that would drag the p95 up and soften the
            # very hedges steering around it
            self.recent.append(seconds)
        if not self.cfg.enabled:
            return []
        return self.evaluate_all(now)

    def note_hedge_loss(
        self, replica_id: str, now: Optional[float] = None
    ) -> list[tuple[str, str]]:
        """A hedge launched against this replica and WON. Not failure
        evidence and not a latency sample (the loser was cancelled —
        the satellite contract), but a sustained streak of them is an
        honest *relative* signal: each one means this replica ran past
        the deployment p95 while a sibling finished the same call
        first. Past ``hedge_streak_limit`` consecutive losses the
        replica enters probation even though its EWMA froze when
        hedging dried up its sample stream."""
        if not self.cfg.enabled:
            return []
        now = time.monotonic() if now is None else now
        st = self.replicas.setdefault(replica_id, _ReplicaStats())
        st.hedge_streak += 1
        transitions: list[tuple[str, str]] = []
        if (
            not st.in_probation
            and st.hedge_streak >= self.cfg.hedge_streak_limit
            and self._median() is not None
            and self._minority_ok()
        ):
            st.in_probation = True
            st.excursion_since = None
            st.samples_in_probation = 0
            transitions.append((replica_id, "enter"))
        for t in self.evaluate_all(now):
            if t not in transitions:
                transitions.append(t)
        return transitions

    def evaluate_all(self, now: Optional[float] = None) -> list[tuple[str, str]]:
        now = time.monotonic() if now is None else now
        # ONE median pass per evaluation, shared by every replica's
        # verdict — this runs on the request hot path, and a per-replica
        # re-sort would be O(R^2 log R) per noted request
        median = self._median()
        out = []
        for rid, st in self.replicas.items():
            transition = self._evaluate(rid, st, now, median)
            if transition is not None:
                out.append((rid, transition))
        return out

    def forget(self, replica_id: str) -> None:
        """A restarted/retired replica's samples must not haunt its
        successor (ids are fresh per start; every replica-death path —
        retire, health-loop restart, undeploy sweep — calls this)."""
        self.replicas.pop(replica_id, None)

    # ---- verdicts ---------------------------------------------------------

    def _median(self) -> Optional[float]:
        """LOWER median of the per-replica EWMAs (matured replicas
        only). ``median_low`` and not the mean-of-middle-two: with two
        replicas the plain median averages the outlier in, capping the
        observable ratio at 2 and blinding the detector exactly where
        gray failure hurts most (small deployments)."""
        vals = sorted(
            st.ewma
            for st in self.replicas.values()
            if st.ewma is not None and st.samples >= self.cfg.min_samples
        )
        if not vals:
            return None
        return vals[(len(vals) - 1) // 2]

    def _evaluate(
        self,
        replica_id: str,
        st: _ReplicaStats,
        now: float,
        median: Optional[float],
    ) -> Optional[str]:
        if median is None or st.samples < self.cfg.min_samples:
            return None
        floor = max(median, self.cfg.min_latency_s)
        if st.in_probation:
            if (
                st.samples_in_probation >= 2
                and st.ewma <= self.cfg.recovery_ratio * floor
            ):
                st.in_probation = False
                st.excursion_since = None
                st.samples_in_probation = 0
                return "exit"
            return None
        if st.ewma > self.cfg.ratio * floor:
            if st.excursion_since is None:
                st.excursion_since = now
                return None
            if now - st.excursion_since < self.cfg.excursion_s:
                return None
            # the excursion persisted — but probation stays a MINORITY
            # verdict: when half the deployment looks like an outlier,
            # the baseline is what moved, not the replicas
            if not self._minority_ok():
                return None
            st.in_probation = True
            st.samples_in_probation = 0
            return "enter"
        st.excursion_since = None
        return None

    def _minority_ok(self) -> bool:
        already = sum(1 for s in self.replicas.values() if s.in_probation)
        return (already + 1) <= self.cfg.max_eject_fraction * max(
            1, len(self.replicas)
        )

    def ewma(self, replica_id: str) -> Optional[float]:
        st = self.replicas.get(replica_id)
        return None if st is None else st.ewma

    def sample_count(self, replica_id: str) -> int:
        st = self.replicas.get(replica_id)
        return 0 if st is None else st.samples

    # ---- probe trickle ----------------------------------------------------

    def take_probe_ticket(self) -> bool:
        """True every ``probe_every``-th call — the pick that routes to
        a probation replica so its recovery can be observed with real
        traffic (the self-correcting half of soft ejection)."""
        self._probe_tick += 1
        return self._probe_tick % max(1, self.cfg.probe_every) == 0

    # ---- hedge delay ------------------------------------------------------

    def hedge_delay_s(self, now: Optional[float] = None) -> float:
        """The request-hedging trigger delay: deployment-wide p95 of
        recent service times (a fixed ``BIOENGINE_HEDGE_DELAY_MS``
        overrides). Cached for 1 s — sorting 256 floats per request
        would be an odd way to spend the fast path."""
        if self.cfg.hedge_delay_s > 0:
            return self.cfg.hedge_delay_s
        if len(self.recent) < _MIN_HEDGE_SAMPLES:
            return _DEFAULT_HEDGE_DELAY_S
        now = time.monotonic() if now is None else now
        computed_at, value = self._hedge_cache
        if value > 0.0 and now - computed_at < 1.0:
            return value
        s = sorted(self.recent)
        p95 = s[min(int(len(s) * 0.95), len(s) - 1)]
        value = max(_HEDGE_FLOOR_S, p95)
        self._hedge_cache = (now, value)
        return value

    # ---- status -----------------------------------------------------------

    def describe(self) -> dict:
        return {
            "enabled": self.cfg.enabled,
            "median_ewma_s": self._median(),
            "hedge_delay_s": round(self.hedge_delay_s(), 6),
            "replicas": {
                rid: {
                    "ewma_s": None if st.ewma is None else round(st.ewma, 6),
                    "samples": st.samples,
                    "in_probation": st.in_probation,
                    "hedge_streak": st.hedge_streak,
                }
                for rid, st in self.replicas.items()
            },
        }


def record_probation_event(
    app_id: str, deployment: str, replica_id: str, phase: str, **attrs
) -> None:
    """One flight event per probation transition — the incident-ring
    evidence `bioengine debug bundle` and the runbook read."""
    flight.record(
        "replica.probation",
        severity="warning" if phase == "enter" else "info",
        app=app_id,
        deployment=deployment,
        replica=replica_id,
        phase=phase,
        **attrs,
    )
