"""Anomaly sentinels: detectors computed from the hub's rings.

Where SLOs encode objectives someone declared, sentinels encode shapes
that are *always* wrong: a registered process going silent, staleness
creeping up round over round, a queue that only grows, a journal writer
falling behind its commit stream, sheds appearing out of nowhere, and a
live throughput gauge sliding out of its BENCH_PIN band. Each sentinel
routes through the shared :class:`~.slo.AlertManager`, so fire/clear
hysteresis, typed events, and page→flight-dump behavior are identical
to SLO alerts.

Drift detectors compare the **fast** window against the trailing **slow**
window of the same metric (recent-vs-established ratio above a floor),
so they self-calibrate to whatever the workload's normal is instead of
needing absolute thresholds per deployment.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from distkeras_tpu_torch.telemetry.health.slo import AlertManager


class Sentinels:
    """The standard detector set. All thresholds are instance attributes
    so tests (and operators embedding the hub) can tune them; the
    defaults are deliberately conservative — a sentinel that cries wolf
    is worse than none (the fault-free chaos leg pins zero alerts).
    """

    #: recent/established ratio a drift detector must exceed to fire.
    drift_factor: float = 2.0
    fast_s: float = 30.0
    slow_s: float = 300.0
    #: absolute floors under which drift is ignored (idle-fleet noise).
    staleness_floor: float = 1.0
    queue_floor: float = 16.0
    round_floor_s: float = 0.05
    journal_floor_s: float = 0.02
    shed_rate_floor: float = 0.5  # sheds/s in the fast window
    #: streaming eval loss under this is converged noise, not drift.
    stream_loss_floor: float = 0.05

    def __init__(self, alerts: Optional[AlertManager] = None,
                 bench_summary: Optional[str] = None,
                 bench_pin: Optional[str] = None) -> None:
        self.alerts = alerts or AlertManager()
        self.bench_summary = bench_summary
        self.bench_pin = bench_pin
        self._bench_keys: set = set()

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, hub) -> None:
        self._target_down(hub)
        self._drift(hub, "staleness_creep", "*staleness_mean*", "mean",
                    self.staleness_floor)
        self._drift(hub, "queue_growth", "serving.queue_depth", "mean",
                    self.queue_floor)
        self._drift(hub, "queue_growth_ps", "stats.queue_rows", "mean",
                    self.queue_floor)
        self._drift(hub, "straggler_drift", "fleet.round.*", "span_mean",
                    self.round_floor_s)
        self._drift(hub, "journal_lag", "netps.journal.*", "span_mean",
                    self.journal_floor_s)
        # Fleet-level mirror of the in-runtime DriftWatch: the streaming
        # trainer's fast-window eval loss climbing against its own trailing
        # history is drift visible from the health plane alone.
        self._drift(hub, "stream_loss_divergence", "stream.eval.loss_fast",
                    "mean", self.stream_loss_floor)
        self._shed_spike(hub)
        self._bench_regression(hub)

    def _target_down(self, hub) -> None:
        down = {t.name for t in hub.down_targets()}
        seen = {t.name for t in hub.targets() if t.ever_up}
        for name in sorted(seen):
            t = hub.target(name)
            self.alerts.update(
                f"target_down:{name}", name in down, severity="page",
                message=(f"{name} ({t.endpoint if t else '?'}) stopped "
                         f"answering scrapes"),
                labels={"target": name})

    def _drift(self, hub, kind: str, metric: str, stat: str,
               floor: float) -> None:
        fast = hub.measure(metric, stat=stat, window_s=self.fast_s)
        slow = hub.measure(metric, stat=stat, window_s=self.slow_s)
        breaching = bool(
            fast is not None and slow is not None and fast > floor
            and slow > 0 and fast / slow > self.drift_factor)
        self.alerts.update(
            kind, breaching, severity="ticket",
            message=(f"{metric} {stat} drifted: fast={fast} vs "
                     f"slow={slow} (> {self.drift_factor}x)"),
            value=fast)

    def _shed_spike(self, hub) -> None:
        fast = hub.measure("serving.shed", stat="rate", window_s=self.fast_s)
        slow = hub.measure("serving.shed", stat="rate", window_s=self.slow_s)
        breaching = bool(
            fast is not None and fast > self.shed_rate_floor
            and (slow is None or fast > self.drift_factor * max(slow, 1e-9)))
        self.alerts.update(
            "shed_spike", breaching, severity="ticket",
            message=f"serving.shed rate spiked to {fast}/s", value=fast)

    # -- bench regression ---------------------------------------------------

    def _bench_regression(self, hub) -> None:
        """Two sources, same alert family: (1) a BENCH_SUMMARY.json whose
        per-config ``within_band`` already went false (the bench harness
        computed the comparison against BENCH_PIN); (2) live throughput
        gauges compared against the pins directly, for fleets running
        while a bench summary is stale or absent."""
        fresh = set()
        for reg in self.bench_regressions(self.bench_summary):
            key = f"bench_regression:{reg['metric']}"
            fresh.add(key)
            self.alerts.update(
                key, True, severity="ticket",
                message=(f"bench {reg['metric']}={reg['value']} outside "
                         f"pinned band (pin {reg.get('pin')})"),
                value=reg.get("value"))
        for key in self._bench_keys - fresh:  # summary repaired → clear
            self.alerts.update(key, False)
        self._bench_keys = fresh
        pins = self._load_pins()
        if not pins:
            return
        band = pins.get("weather_band_pct", 15) / 100.0
        for metric, cfg in (pins.get("configs") or {}).items():
            pin = cfg.get("pin")
            if not isinstance(pin, (int, float)) or pin <= 0:
                continue
            live = hub.measure(f"bench.{metric}", stat="value",
                               window_s=self.fast_s)
            breaching = bool(live is not None
                             and live < pin * (1.0 - band))
            self.alerts.update(
                f"bench_regression:live:{metric}", breaching,
                severity="ticket",
                message=(f"live {metric}={live} below pin {pin} "
                         f"band -{band:.0%}"),
                value=live)

    @staticmethod
    def bench_regressions(path: Optional[str] = None) -> List[Dict]:
        """Out-of-band configs from a BENCH_SUMMARY.json (doctored or
        real): every config whose ``within_band`` is explicitly false —
        including a config's nested ``sim_drift`` block (the simulator's
        predicted-vs-measured calibration gate, same alert family)."""
        path = path or "BENCH_SUMMARY.json"
        if not os.path.exists(path):
            return []
        try:
            with open(path, "r", encoding="utf-8") as f:
                summary = json.load(f)
        except (OSError, ValueError):
            return []
        out = []
        rows = list(summary.get("configs") or [])
        if "metric" in summary:
            rows.append(summary)
        rows.extend([cfg["sim_drift"] for cfg in list(rows)
                     if isinstance(cfg.get("sim_drift"), dict)])
        for cfg in rows:
            if cfg.get("within_band") is False:
                out.append({"metric": cfg.get("metric"),
                            "value": cfg.get("value"),
                            "pin": cfg.get("pin"),
                            "vs_baseline": cfg.get("vs_baseline")})
        return out

    def _load_pins(self) -> Optional[dict]:
        pin_path = self.bench_pin or "BENCH_PIN.json"
        if not os.path.exists(pin_path):
            return None
        try:
            with open(pin_path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None
