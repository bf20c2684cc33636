"""Declarative SLOs, multi-window burn rates, and the alert manager.

An SLO spec is a JSON object (a file of them, or inline JSON in
``DKTPU_HEALTH_SLO``) naming a hub metric, a stat, and a bound::

    {"name": "serve-p99", "metric": "serving.latency", "stat": "p99",
     "max": 0.25, "fast_s": 30, "slow_s": 300, "severity": "page",
     "labels": {"tenant": "B"}}

``max`` caps the measurement (latency, shed rate, staleness, journal
lag); ``min`` floors it (per-tenant tokens/s). The **burn rate** is how
fast the objective is being consumed: ``measured / max`` for a cap,
``min / measured`` for a floor — 1.0 exactly at the objective. An alert
fires only when the burn exceeds 1 in **both** the fast and the slow
window (the multi-window rule: the fast window gives low detection
latency, the slow window vetoes one-scrape blips), and clears with
hysteresis once both windows are back under.

:class:`AlertManager` owns fire/clear for SLOs *and* sentinels: typed
``health_alert`` / ``health_clear`` telemetry events with the spec's
tenant/job labels, ``health.alerts_fired`` / ``health.alerts_cleared``
counters, and — on page-severity fires — a flight-recorder dump
(``tracing.flight_dump``) so every page ships its own evidence.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.runtime.config import env_str

SEVERITIES = ("page", "ticket")


@dataclass
class SloSpec:
    """One declarative objective over a hub metric."""

    name: str
    metric: str
    stat: str = "value"
    max: Optional[float] = None
    min: Optional[float] = None
    fast_s: float = 30.0
    slow_s: float = 300.0
    severity: str = "ticket"
    target: Optional[str] = None  # glob over target name/role
    labels: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if (self.max is None) == (self.min is None):
            raise ValueError(
                f"SLO {self.name!r}: exactly one of max/min required")
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"SLO {self.name!r}: severity must be one of {SEVERITIES}")
        if self.fast_s <= 0 or self.slow_s < self.fast_s:
            raise ValueError(
                f"SLO {self.name!r}: need 0 < fast_s <= slow_s")

    def burn(self, measured: Optional[float]) -> Optional[float]:
        """Burn rate: >1 means the objective is being violated. None when
        there is no measurement (no data is not a breach)."""
        if measured is None:
            return None
        if self.max is not None:
            if self.max <= 0:
                return float("inf") if measured > 0 else 0.0
            return measured / self.max
        assert self.min is not None
        if measured <= 0:
            return float("inf")
        return self.min / measured


def parse_slo_specs(text: Optional[str] = None) -> List[SloSpec]:
    """SLO specs from inline JSON, a file path, or ``DKTPU_HEALTH_SLO``
    (which may itself be inline JSON — starts with ``[`` or ``{`` — or a
    path). Accepts a single object or a list."""
    if text is None:
        text = env_str("DKTPU_HEALTH_SLO")
    text = (text or "").strip()
    if not text:
        return []
    if not text.startswith(("[", "{")):
        if not os.path.exists(text):
            raise ValueError(f"SLO spec file not found: {text}")
        with open(text, "r", encoding="utf-8") as f:
            text = f.read().strip()
    raw = json.loads(text)
    if isinstance(raw, dict):
        raw = [raw]
    specs = []
    for obj in raw:
        if not isinstance(obj, dict) or "name" not in obj or \
                "metric" not in obj:
            raise ValueError(f"SLO spec needs name+metric: {obj!r}")
        known = {"name", "metric", "stat", "max", "min", "fast_s",
                 "slow_s", "severity", "target", "labels"}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(
                f"SLO {obj.get('name')!r}: unknown keys {sorted(unknown)}")
        specs.append(SloSpec(**obj))
    return specs


@dataclass
class Alert:
    key: str
    severity: str
    message: str
    labels: Dict[str, str]
    fired_at: float
    value: Optional[float] = None


class AlertManager:
    """Fire/clear bookkeeping shared by the SLO engine and the sentinels.

    ``clear_after`` consecutive healthy evaluations are required before a
    fired alert clears (hysteresis — a breach that flaps around the
    threshold holds the alert instead of spamming fire/clear pairs).
    Fires emit ``health_alert`` events; page severity also drops a
    flight-recorder dump named after the alert key.
    """

    def __init__(self, clear_after: int = 2) -> None:
        self.clear_after = max(1, int(clear_after))
        self._lock = threading.Lock()
        self._active: Dict[str, Alert] = {}
        self._calm: Dict[str, int] = {}
        self.fired_total = 0
        self.cleared_total = 0
        self.history: List[dict] = []

    def update(self, key: str, breaching: bool, severity: str = "ticket",
               message: str = "", labels: Optional[Dict[str, str]] = None,
               value: Optional[float] = None) -> Optional[str]:
        """Advance one condition. Returns ``"fired"`` / ``"cleared"`` on
        a transition, None otherwise."""
        labels = dict(labels or {})
        with self._lock:
            active = key in self._active
            if breaching:
                self._calm[key] = 0
                if active:
                    self._active[key].value = value
                    return None
                alert = Alert(key=key, severity=severity, message=message,
                              labels=labels, fired_at=time.time(),
                              value=value)
                self._active[key] = alert
                self.fired_total += 1
                self.history.append({"event": "fired", "key": key,
                                     "severity": severity,
                                     "message": message, "value": value,
                                     **labels})
            else:
                if not active:
                    return None
                calm = self._calm.get(key, 0) + 1
                self._calm[key] = calm
                if calm < self.clear_after:
                    return None
                alert = self._active.pop(key)
                del self._calm[key]
                self.cleared_total += 1
                self.history.append({"event": "cleared", "key": key,
                                     "severity": alert.severity,
                                     **alert.labels})
        # Emit outside the lock: the event tap is user code.
        if breaching:
            telemetry.counter("health.alerts_fired").add(1)
            telemetry.event("health_alert",
                            {"alert": key, "severity": severity,
                             "message": message, "value": value, **labels})
            if severity == "page":
                from distkeras_tpu_torch.telemetry.tracing import flight_dump

                flight_dump(f"health:{key}", once=True)
            return "fired"
        telemetry.counter("health.alerts_cleared").add(1)
        telemetry.event("health_clear",
                        {"alert": key, "severity": alert.severity,
                         **alert.labels})
        return "cleared"

    def active(self) -> Dict[str, Alert]:
        with self._lock:
            return dict(self._active)

    def is_active(self, key: str) -> bool:
        with self._lock:
            return key in self._active


class SloEngine:
    """Evaluates every spec against the hub on demand (typically from the
    hub's ``on_sweep`` hook) and tracks per-spec attainment: the share of
    evaluations-with-data whose fast window met the objective."""

    def __init__(self, specs: List[SloSpec],
                 alerts: Optional[AlertManager] = None) -> None:
        self.specs = list(specs)
        self.alerts = alerts or AlertManager()
        self._evals: Dict[str, int] = {}
        self._ok: Dict[str, int] = {}

    def evaluate(self, hub) -> Dict[str, dict]:
        """One pass; returns per-spec ``{burn_fast, burn_slow, breaching,
        measured_fast}`` for the CLIs."""
        out: Dict[str, dict] = {}
        for spec in self.specs:
            fast = hub.measure(spec.metric, stat=spec.stat,
                               window_s=spec.fast_s, target=spec.target)
            slow = hub.measure(spec.metric, stat=spec.stat,
                               window_s=spec.slow_s, target=spec.target)
            burn_fast = spec.burn(fast)
            burn_slow = spec.burn(slow)
            breaching = bool(burn_fast is not None and burn_fast > 1.0
                             and burn_slow is not None and burn_slow > 1.0)
            if burn_fast is not None:
                self._evals[spec.name] = self._evals.get(spec.name, 0) + 1
                if burn_fast <= 1.0:
                    self._ok[spec.name] = self._ok.get(spec.name, 0) + 1
            bound = spec.max if spec.max is not None else spec.min
            word = "<=" if spec.max is not None else ">="
            self.alerts.update(
                f"slo:{spec.name}", breaching, severity=spec.severity,
                message=(f"{spec.metric} {spec.stat}={fast} violates "
                         f"{word} {bound} (burn fast={burn_fast}, "
                         f"slow={burn_slow})"),
                labels=spec.labels, value=fast)
            out[spec.name] = {"burn_fast": burn_fast,
                              "burn_slow": burn_slow,
                              "breaching": breaching,
                              "measured_fast": fast}
        return out

    def attainment(self) -> Dict[str, Optional[float]]:
        """Per-spec attainment in [0, 1]; None before any data."""
        out: Dict[str, Optional[float]] = {}
        for spec in self.specs:
            n = self._evals.get(spec.name, 0)
            out[spec.name] = (self._ok.get(spec.name, 0) / n) if n else None
        return out
