"""SLO engine — error-budget burn-rate alerting + anomaly detection.

The telemetry store (utils/telemetry.py) remembers what every
deployment did; this module decides whether that history is *meeting
the deployment's service objectives* and raises a hand BEFORE an
operator eyeballs a dashboard:

- **Objectives** come from the manifest's per-deployment ``slo:``
  block (:class:`SLOConfig`): a latency objective at a percentile
  ("99% of requests under 250 ms") and/or an availability target
  ("99.9% of requests succeed"), over a rolling window. Both reduce to
  the same good/bad-event arithmetic: the error budget is
  ``1 - target``, and the burn rate over a window is
  ``bad_fraction / budget`` (burn 1.0 = spending the budget exactly at
  the rate that exhausts it at the window's end).
- **Multi-window multi-burn-rate rules** (Google SRE workbook ch.5):
  an alert fires only when BOTH a long window (sustained) and a short
  window (still happening) exceed the severity's burn threshold —
  fast burns page in minutes, slow burns ticket in hours, and a
  recovered incident stops alerting as soon as the short window goes
  quiet. Rule windows are fractions of the SLO window, floored to the
  store's base resolution so second-scale test windows work.
- **An alert state machine** per (deployment, objective):
  ``inactive -> pending -> firing -> resolved``. Transitions land in
  the flight ring (``slo.pending`` / ``slo.firing`` / ``slo.resolved``),
  firing increments ``slo_alerts_total{app,deployment,severity}``, and
  a page-severity firing invokes the controller's auto-bundle hook —
  rate-limited — so the incident artifact exists before anyone is
  paged.
- **Anomaly detection** for what SLOs don't cover: EWMA+variance
  residual detectors over the stored base-resolution series
  (latency p99, error ratio, queue depth, request rate) flag
  excursions as ``anomaly.detect`` warn events.
- **Closing the loop**: :meth:`SLOEngine.burn_pressure` exposes the
  current worst short-window burn (normalized to the page threshold)
  as a scalar the scheduler's predictive autoscaler can consume
  (``scheduling.slo_pressure: true`` — off by default): a deployment
  burning its budget scales up even when queue projections alone say
  hold.
"""

from __future__ import annotations

import math
import re
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from bioengine_tpu_torch.utils import flight, metrics
from bioengine_tpu_torch.utils.telemetry import TelemetryStore, quantile_from_buckets

SLO_ALERTS = metrics.counter(
    "slo_alerts_total",
    "SLO alerts that reached firing, by severity",
    ("app", "deployment", "severity"),
)
ANOMALIES = metrics.counter(
    "anomalies_total",
    "series excursions flagged by the residual detectors",
    ("app", "deployment", "series"),
)

# (severity, burn threshold, long window fraction, short window fraction)
# of the SLO window — for the canonical 30d window these are the SRE
# workbook's 14.4x over 1h&5m page and 6x over 6h&30m ticket, scaled.
BURN_RULES: tuple[tuple[str, float, float, float], ...] = (
    ("page", 14.4, 1.0 / 720.0, 1.0 / 8640.0),
    ("ticket", 6.0, 1.0 / 120.0, 1.0 / 1440.0),
)

# a resolved alert reads "resolved" for this long, then quietly decays
# to inactive — status surfaces must distinguish "recently recovered"
# from "incident badge worn forever"
RESOLVED_DECAY_S = 3600.0

_DURATION_RE = re.compile(r"^\s*([0-9.]+)\s*(ms|s|m|h|d)?\s*$")
_DURATION_UNITS = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_duration_s(value: Any, default_unit: str = "s") -> float:
    """``"250ms" | "1h" | "30d" | 60 | "60"`` -> seconds."""
    if isinstance(value, (int, float)):
        return float(value) * _DURATION_UNITS[default_unit]
    m = _DURATION_RE.match(str(value))
    if not m:
        raise ValueError(f"unparseable duration: {value!r}")
    return float(m.group(1)) * _DURATION_UNITS[m.group(2) or default_unit]


SLO_KEYS = {
    "latency_objective_ms",
    "latency_objective",
    "latency_percentile",
    "availability",
    "inter_token_ms",
    "window",
    "for",
}


@dataclass(frozen=True)
class SLOConfig:
    """One deployment's service objectives (manifest:
    ``deployment_config.<dep>.slo``)."""

    latency_objective_s: Optional[float] = None
    latency_percentile: float = 99.0       # % of requests under objective
    availability: Optional[float] = None   # % of requests that succeed
    # token-streaming deployments: % (latency_percentile) of
    # inter-token gaps under this bound — the generative-serving SLO
    # (time BETWEEN tokens at the caller edge; burn-rate rules apply
    # to it exactly as to request latency)
    inter_token_objective_s: Optional[float] = None
    window_s: float = 30 * 86400.0
    for_s: float = 0.0                     # pending hold before firing

    @classmethod
    def from_config(cls, cfg: dict) -> "SLOConfig":
        unknown = sorted(set(cfg) - SLO_KEYS)
        if unknown:
            raise ValueError(
                f"unknown slo keys: {unknown} (accepted: {sorted(SLO_KEYS)})"
            )
        latency = None
        if "latency_objective_ms" in cfg:
            latency = float(cfg["latency_objective_ms"]) / 1000.0
        elif "latency_objective" in cfg:
            latency = parse_duration_s(cfg["latency_objective"])
        availability = (
            float(cfg["availability"]) if "availability" in cfg else None
        )
        inter_token = (
            float(cfg["inter_token_ms"]) / 1000.0
            if "inter_token_ms" in cfg
            else None
        )
        if inter_token is not None and inter_token <= 0:
            raise ValueError("inter_token_ms must be positive")
        if latency is None and availability is None and inter_token is None:
            raise ValueError(
                "slo block needs latency_objective_ms, availability, "
                "and/or inter_token_ms"
            )
        pct = float(cfg.get("latency_percentile", 99.0))
        # floor at 50: values below are either nonsense objectives or —
        # the common foot-gun — FRACTIONS (0.999 meaning 99.9%), which
        # would pass a (0,100) check and produce an SLO that can never
        # alert. Fail the build, not the incident.
        if not 50.0 <= pct < 100.0:
            raise ValueError(
                f"latency_percentile must be in [50, 100) percent, got "
                f"{pct} (use 99.9, not 0.999)"
            )
        if availability is not None and not 50.0 <= availability < 100.0:
            raise ValueError(
                f"availability must be in [50, 100) percent, got "
                f"{availability} (use 99.9, not 0.999)"
            )
        window = parse_duration_s(cfg.get("window", 30 * 86400.0))
        if window <= 0:
            raise ValueError("slo window must be positive")
        return cls(
            latency_objective_s=latency,
            latency_percentile=pct,
            availability=availability,
            inter_token_objective_s=inter_token,
            window_s=window,
            for_s=parse_duration_s(cfg.get("for", 0.0)),
        )

    def objectives(self) -> list[str]:
        out = []
        if self.latency_objective_s is not None:
            out.append("latency")
        if self.availability is not None:
            out.append("availability")
        if self.inter_token_objective_s is not None:
            out.append("inter_token")
        return out

    def budget(self, objective: str) -> float:
        if objective in ("latency", "inter_token"):
            return max(1e-6, 1.0 - self.latency_percentile / 100.0)
        return max(1e-6, 1.0 - (self.availability or 100.0) / 100.0)


# ---------------------------------------------------------------------------
# anomaly detection
# ---------------------------------------------------------------------------


class ResidualDetector:
    """EWMA mean + EW variance over one series; a point whose residual
    z-score exceeds ``z`` for ``consecutive`` points is an excursion.
    The mean/variance update is SKIPPED while a streak is building (a
    step change must not teach the detector it is normal before being
    flagged), but the FLAGGING point does update — the inflated
    variance then absorbs a sustained level shift after one event
    instead of re-flagging it forever."""

    def __init__(
        self,
        alpha: float = 0.3,
        z: float = 4.0,
        min_points: int = 8,
        consecutive: int = 2,
        min_delta: float = 0.0,
    ):
        self.alpha = alpha
        self.z = z
        self.min_points = min_points
        self.consecutive = consecutive
        self.min_delta = min_delta     # absolute floor: tiny wiggles never flag
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self._streak = 0

    def observe(self, value: float) -> bool:
        if self.n < self.min_points:
            # warmup: learn the baseline before judging anything
            self._update(value)
            return False
        std = math.sqrt(max(self.var, 1e-12))
        resid = abs(value - self.mean)
        if resid > self.z * std and resid > self.min_delta:
            self._streak += 1
            if self._streak >= self.consecutive:
                self._streak = 0
                # learn from the flagged point: the EW variance blows
                # up with d^2, so a persistent new level stops flagging
                # after ~one event and the baseline re-converges
                self._update(value)
                return True
            return False
        self._streak = 0
        self._update(value)
        return False

    def _update(self, value: float) -> None:
        self.n += 1
        if self.n == 1:
            self.mean = value
            return
        d = value - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)


# series the anomaly pass watches, with absolute floors so idle-noise
# never pages anyone (an error_ratio wiggle of 0.3% or one queued
# request is not an incident)
ANOMALY_SERIES: tuple[tuple[str, float], ...] = (
    ("latency_p99", 0.010),
    ("error_ratio", 0.02),
    ("queue_depth", 2.0),
    ("request_rate", 1.0),
)


# ---------------------------------------------------------------------------
# alert state machine
# ---------------------------------------------------------------------------


@dataclass
class AlertState:
    objective: str                    # "latency" | "availability"
    state: str = "inactive"           # inactive|pending|firing|resolved
    severity: Optional[str] = None
    since: Optional[float] = None     # wall clock of entering pending/firing
    last_transition: Optional[float] = None
    burn_long: float = 0.0
    burn_short: float = 0.0
    windows: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "objective": self.objective,
            "state": self.state,
            "severity": self.severity,
            "since": self.since,
            "last_transition": self.last_transition,
            "burn_long": round(self.burn_long, 3),
            "burn_short": round(self.burn_short, 3),
            "windows": dict(self.windows),
        }


class SLOEngine:
    """Evaluates every registered deployment's objectives against the
    telemetry store. Owned by the controller; ``evaluate()`` runs on
    the telemetry tick (no hot-path cost whatsoever)."""

    def __init__(
        self,
        store: TelemetryStore,
        on_page: Optional[Callable[[dict], Any]] = None,
        logger=None,
    ):
        self.store = store
        self.on_page = on_page         # controller's auto-bundle hook
        self.logger = logger
        self._slos: dict[tuple[str, str], SLOConfig] = {}
        self._alerts: dict[tuple[str, str, str], AlertState] = {}
        self._detectors: dict[tuple, ResidualDetector] = {}
        self._detector_cursor: dict[tuple, float] = {}
        self._recent_anomalies: deque = deque(maxlen=64)
        self._base_step = min(s for s, _ in store.resolutions)

    # ---- registration (deploy/undeploy) -------------------------------------

    def register(self, app: str, deployment: str, cfg: SLOConfig) -> None:
        self._slos[(app, deployment)] = cfg

    def unregister(self, app: str, deployment: Optional[str] = None) -> None:
        for key in [
            k
            for k in self._slos
            if k[0] == app and (deployment is None or k[1] == deployment)
        ]:
            del self._slos[key]
        for key in [
            k
            for k in self._alerts
            if k[0] == app and (deployment is None or k[1] == deployment)
        ]:
            del self._alerts[key]
        for key in [
            k
            for k in self._detectors
            if k[0] == app and (deployment is None or k[1] == deployment)
        ]:
            self._detectors.pop(key, None)
            self._detector_cursor.pop(key, None)

    def deployments(self) -> list[tuple[str, str]]:
        return sorted(self._slos)

    # ---- burn math ----------------------------------------------------------

    def _bad_fraction(
        self, app: str, dep: str, cfg: SLOConfig, objective: str, window_s: float, now: float
    ) -> tuple[Optional[float], float]:
        """(bad fraction over the window, total requests). None when
        the window holds no traffic — no traffic is not an outage."""
        agg = self.store.window_aggregate(app, dep, window_s, now=now)
        if objective == "inter_token":
            # the event is one inter-token GAP, not one request: the
            # budget burns against the gap-histogram count, so a single
            # stalled long generation burns proportionally to its stall
            total = agg.get("inter_token_count", 0.0)
            if total <= 0:
                return None, 0.0
            buckets = agg.get("inter_token_buckets", {})
            good = 0.0
            for edge_str, cum in buckets.items():
                edge = math.inf if edge_str == "+Inf" else float(edge_str)
                if edge <= cfg.inter_token_objective_s + 1e-9:
                    good = max(good, cum)
            return min(1.0, max(0.0, total - good) / total), total
        total = agg.get("requests", 0.0)
        if total <= 0:
            return None, 0.0
        if objective == "availability":
            return min(1.0, agg.get("errors", 0.0) / total), total
        # latency: good = finished under the objective. Stored bucket
        # deltas are ZERO-SUPPRESSED cumulative counts (an edge absent
        # from a delta saw no change), so count_le(objective) is the
        # count at the LARGEST present edge <= the objective — any
        # absent edge in between contributed zero. Bucket edges
        # quantize the objective conservatively: an objective between
        # edges counts the span up to the next edge as bad (align the
        # objective with a bucket edge — docs/observability.md).
        buckets = agg.get("latency_buckets", {})
        good = 0.0
        for edge_str, cum in buckets.items():
            edge = math.inf if edge_str == "+Inf" else float(edge_str)
            if edge <= cfg.latency_objective_s + 1e-9:
                good = max(good, cum)
        bad = max(0.0, total - good)
        return min(1.0, bad / total), total

    def _rule_windows(self, cfg: SLOConfig) -> list[tuple[str, float, float, float]]:
        out = []
        for severity, threshold, long_f, short_f in BURN_RULES:
            long_w = max(cfg.window_s * long_f, self._base_step)
            short_w = max(cfg.window_s * short_f, self._base_step)
            out.append((severity, threshold, long_w, short_w))
        return out

    def _evaluate_objective(
        self, app: str, dep: str, cfg: SLOConfig, objective: str, now: float
    ) -> AlertState:
        key = (app, dep, objective)
        alert = self._alerts.get(key)
        if alert is None:
            alert = self._alerts[key] = AlertState(objective=objective)
        budget = cfg.budget(objective)
        condition = None    # (severity, burn_long, burn_short, windows)
        burns = {}
        for severity, threshold, long_w, short_w in self._rule_windows(cfg):
            frac_long, _ = self._bad_fraction(app, dep, cfg, objective, long_w, now)
            frac_short, _ = self._bad_fraction(app, dep, cfg, objective, short_w, now)
            burn_long = (frac_long or 0.0) / budget
            burn_short = (frac_short or 0.0) / budget
            burns[severity] = {
                "burn_long": round(burn_long, 3),
                "burn_short": round(burn_short, 3),
                "threshold": threshold,
                "long_window_s": round(long_w, 3),
                "short_window_s": round(short_w, 3),
            }
            if (
                condition is None
                and frac_long is not None
                and burn_long >= threshold
                and burn_short >= threshold
            ):
                condition = (severity, burn_long, burn_short, {
                    "long_s": round(long_w, 3), "short_s": round(short_w, 3),
                })
        alert.windows = burns
        if condition is not None:
            severity, burn_long, burn_short, windows = condition
            alert.burn_long, alert.burn_short = burn_long, burn_short
            if alert.state in ("inactive", "resolved"):
                self._transition(app, dep, alert, "pending", severity, now)
            elif alert.state == "pending":
                if now - (alert.since or now) >= cfg.for_s:
                    self._transition(app, dep, alert, "firing", severity, now)
            elif alert.state == "firing" and severity != alert.severity:
                if severity == "page":
                    # ESCALATION to page while already firing (the
                    # slow-then-fast burn): a page is a new alert —
                    # re-fire so the counter, flight event, and
                    # auto-bundle hook all run
                    self._transition(app, dep, alert, "firing", severity, now)
                else:
                    # de-escalation: stay firing, record the new class
                    alert.severity = severity
        else:
            alert.burn_long = max(
                (b["burn_long"] for b in burns.values()), default=0.0
            )
            alert.burn_short = max(
                (b["burn_short"] for b in burns.values()), default=0.0
            )
            if alert.state in ("pending", "firing"):
                self._transition(app, dep, alert, "resolved", alert.severity, now)
            elif (
                alert.state == "resolved"
                and alert.last_transition is not None
                and now - alert.last_transition >= RESOLVED_DECAY_S
            ):
                # quiet decay (no flight event): after an hour of calm
                # the deployment reads "ok" again instead of wearing
                # last week's incident forever
                alert.state = "inactive"
                alert.severity = None
        return alert

    def _transition(
        self,
        app: str,
        dep: str,
        alert: AlertState,
        state: str,
        severity: Optional[str],
        now: float,
    ) -> None:
        prev = alert.state
        alert.state = state
        alert.severity = severity
        alert.last_transition = now
        if state == "pending":
            alert.since = now
        attrs = {
            "app": app,
            "deployment": dep,
            "objective": alert.objective,
            # "severity" is the flight event's own level — the alert's
            # page/ticket class rides as alert_severity
            "alert_severity": severity,
            "from": prev,
            "burn_long": round(alert.burn_long, 3),
            "burn_short": round(alert.burn_short, 3),
        }
        flight.record(
            f"slo.{state}",
            severity=(
                "error" if state == "firing" and severity == "page"
                else "warning" if state in ("pending", "firing")
                else "info"
            ),
            **attrs,
        )
        if self.logger is not None:
            self.logger.warning(
                f"slo_alert app={app} deployment={dep} "
                f"objective={alert.objective} state={prev}->{state} "
                f"severity={severity} burn_long={alert.burn_long:.2f} "
                f"burn_short={alert.burn_short:.2f}"
            )
        if state == "firing":
            SLO_ALERTS.labels(app, dep, severity or "none").inc()
            if severity == "page" and self.on_page is not None:
                try:
                    self.on_page(
                        {"app": app, "deployment": dep, **alert.as_dict()}
                    )
                except Exception as e:  # noqa: BLE001 — bundling never breaks eval
                    if self.logger is not None:
                        self.logger.error(f"slo on_page hook failed: {e}")

    # ---- anomaly pass -------------------------------------------------------

    def _anomaly_pass(self, app: str, dep: str, now: float) -> None:
        for series_name, min_delta in ANOMALY_SERIES:
            key = (app, dep, series_name)
            det = self._detectors.get(key)
            if det is None:
                det = self._detectors[key] = ResidualDetector(
                    min_delta=min_delta
                )
            cursor = self._detector_cursor.get(key, 0.0)
            points = self.store.series(
                app, dep, series_name,
                since=cursor or None,
                resolution=self._base_step,
                now=now,
            )
            for p in points:
                # never judge the still-open newest bucket — it holds a
                # partial interval and would alias as a rate dip
                if p["t"] + self._base_step > now:
                    continue
                if p["t"] <= cursor:
                    continue
                self._detector_cursor[key] = p["t"]
                v = p["value"]
                if v is None or not math.isfinite(v):
                    continue
                if det.observe(v):
                    ANOMALIES.labels(app, dep, series_name).inc()
                    evt = {
                        "app": app,
                        "deployment": dep,
                        "series": series_name,
                        "value": round(v, 6),
                        "expected": round(det.mean, 6),
                        "sigma": round(math.sqrt(max(det.var, 0.0)), 6),
                        "t": p["t"],
                    }
                    self._recent_anomalies.append({**evt, "detected_at": now})
                    flight.record(
                        "anomaly.detect", severity="warning", **evt
                    )

    # ---- the tick -----------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One evaluation pass over every registered deployment.
        Returns the same JSON-able status dict ``get_slo_status``
        serves."""
        now = now if now is not None else time.time()
        for (app, dep), cfg in list(self._slos.items()):
            for objective in cfg.objectives():
                self._evaluate_objective(app, dep, cfg, objective, now)
            self._anomaly_pass(app, dep, now)
        return self.status(now=now)

    def burn_pressure(self, app: str, deployment: str) -> float:
        """Worst current short-window burn across this deployment's
        objectives, normalized to the page threshold (>= 1.0 means
        page-rate budget burn). The scheduler's predictive autoscaler
        consumes this when ``scheduling.slo_pressure`` is on."""
        page_threshold = BURN_RULES[0][1]
        worst = 0.0
        for (a, d, _obj), alert in self._alerts.items():
            if a == app and d == deployment:
                worst = max(worst, alert.burn_short / page_threshold)
        return worst

    def status(self, now: Optional[float] = None) -> dict:
        now = now if now is not None else time.time()
        out: dict[str, Any] = {"generated_at": now, "deployments": {}}
        coverage = self.store.coverage_s()
        for (app, dep), cfg in sorted(self._slos.items()):
            objectives = {}
            for objective in cfg.objectives():
                alert = self._alerts.get((app, dep, objective))
                # honesty over a long SLO window: the store holds at
                # most ``coverage`` of history, so full-window budget
                # math is computed (and LABELED) over the covered span
                # — a 30d objective on the default 24h store reports
                # window_truncated rather than a silently-24h number
                effective_window = min(cfg.window_s, coverage)
                frac, total = self._bad_fraction(
                    app, dep, cfg, objective, effective_window, now
                )
                budget = cfg.budget(objective)
                objectives[objective] = {
                    "target": (
                        cfg.availability
                        if objective == "availability"
                        else cfg.latency_percentile
                    ),
                    "latency_objective_ms": (
                        round(cfg.latency_objective_s * 1000.0, 3)
                        if objective == "latency"
                        else None
                    ),
                    "inter_token_objective_ms": (
                        round(cfg.inter_token_objective_s * 1000.0, 3)
                        if objective == "inter_token"
                        else None
                    ),
                    "window_s": cfg.window_s,
                    "window_coverage_s": effective_window,
                    "window_truncated": coverage < cfg.window_s,
                    "requests_in_window": total,
                    "bad_fraction": (
                        round(frac, 6) if frac is not None else None
                    ),
                    "budget_remaining": (
                        round(1.0 - frac / budget, 4)
                        if frac is not None
                        else 1.0
                    ),
                    "alert": alert.as_dict() if alert else None,
                }
            out["deployments"][f"{app}/{dep}"] = {
                "objectives": objectives,
                "burn_pressure": round(self.burn_pressure(app, dep), 3),
            }
        out["anomalies"] = list(self._recent_anomalies)[-16:]
        return out
