"""Windowed online eval + drift handling for streaming training (the
port's copy of ``distkeras_tpu/streaming/evaluate.py``; host only).

The batch world evaluates after an epoch; a stream has no epochs, so
quality is a pair of sliding windows over per-item training loss: a
**fast** window (recent items) against a **slow** window (the
established baseline) — the health plane's self-calibrating
fast-vs-slow drift idiom (``telemetry/health/sentinels``), applied
at item granularity where it can also *act*:

* **Page**: the ratio breaching routes through the shared
  :class:`~distkeras_tpu_torch.telemetry.health.slo.AlertManager` at ``page``
  severity (``stream:loss_divergence``) — fire/clear hysteresis, typed
  alert events, and the page's flight dump all come with it.
* **Checkpoint-on-drift**: the fire transition invokes ``on_drift``
  (the runtime saves a pre-adaptation checkpoint — the rollback anchor
  and the forensics snapshot).
* **Recovery timing**: the clear transition records
  ``stream.recovery_seconds`` (drift detected -> loss back under the
  hysteresis) — the bench's time-to-recover metric — and invokes
  ``on_recover``.

The same windowed mean doubles as the serving registry's quality gate:
:meth:`DriftWatch.regression_gate` refuses a hot-swap candidate whose
held-out loss regressed past a floor over the incumbent's
(rollback-on-regression).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.telemetry.health.slo import AlertManager


class WindowedEval:
    """Fast/slow sliding means over a scalar loss stream. Thread-safe
    (workers observe concurrently; the drift check reads)."""

    def __init__(self, fast: Optional[int] = None,
                 slow: Optional[int] = None):
        self.fast_n = int(config.env_int("DKTPU_STREAM_EVAL_FAST")
                          if fast is None else fast)
        self.slow_n = int(config.env_int("DKTPU_STREAM_EVAL_SLOW")
                          if slow is None else slow)
        self._fast: collections.deque = collections.deque(maxlen=self.fast_n)
        self._slow: collections.deque = collections.deque(maxlen=self.slow_n)
        self._lock = threading.Lock()
        self.count = 0

    def observe(self, loss: float) -> None:
        v = float(loss)
        with self._lock:
            self._fast.append(v)
            self._slow.append(v)
            self.count += 1

    def fast_mean(self) -> Optional[float]:
        with self._lock:
            return (sum(self._fast) / len(self._fast)) if self._fast else None

    def slow_mean(self) -> Optional[float]:
        with self._lock:
            return (sum(self._slow) / len(self._slow)) if self._slow else None


class DriftWatch:
    """The acting end of windowed eval: gauges, the page, the
    checkpoint-on-drift hook, and recovery timing. One instance per
    streaming runtime; :meth:`update` is called per committed item."""

    def __init__(self, alerts: Optional[AlertManager] = None,
                 window: Optional[WindowedEval] = None,
                 drift_factor: Optional[float] = None,
                 floor: float = 0.05,
                 on_drift: Optional[Callable] = None,
                 on_recover: Optional[Callable] = None):
        self.alerts = alerts or AlertManager()
        self.window = window or WindowedEval()
        self.drift_factor = float(
            config.env_float("DKTPU_STREAM_DRIFT_FACTOR")
            if drift_factor is None else drift_factor)
        self.floor = float(floor)
        self.on_drift = on_drift
        self.on_recover = on_recover
        self.drift_events = 0
        self.detected_at: Optional[float] = None
        self.last_recovery_s: Optional[float] = None

    @property
    def paging(self) -> bool:
        return self.alerts.is_active("stream:loss_divergence")

    def update(self, loss: float) -> Optional[str]:
        """Observe one committed item's loss; returns the alert
        transition ("fired"/"cleared") when one happened."""
        self.window.observe(loss)
        fast = self.window.fast_mean()
        slow = self.window.slow_mean()
        if fast is not None:
            telemetry.gauge("stream.eval.loss_fast").set(round(fast, 5))
        if slow is not None:
            telemetry.gauge("stream.eval.loss_slow").set(round(slow, 5))
        # Warmup guard: until the slow window outgrows the fast one, the
        # two means track each other by construction and can never vouch
        # for a baseline.
        mature = self.window.count > self.window.fast_n
        breaching = bool(
            mature and fast is not None and slow is not None
            and fast > self.floor and slow > 0
            and fast / slow > self.drift_factor)
        transition = self.alerts.update(
            "stream:loss_divergence", breaching, severity="page",
            message=(f"streaming eval loss diverged: fast window {fast} vs "
                     f"slow {slow} (> {self.drift_factor}x)"),
            value=fast)
        if transition == "fired":
            self.drift_events += 1
            self.detected_at = time.monotonic()
            telemetry.counter("stream.drift_events").add(1)
            telemetry.event("stream_drift_detected",
                            {"fast": fast, "slow": slow})
            if self.on_drift is not None:
                self.on_drift(fast, slow)
        elif transition == "cleared" and self.detected_at is not None:
            self.last_recovery_s = time.monotonic() - self.detected_at
            self.detected_at = None
            telemetry.gauge("stream.recovery_seconds").set(
                round(self.last_recovery_s, 3))
            telemetry.event("stream_drift_recovered",
                            {"seconds": round(self.last_recovery_s, 3)})
            if self.on_recover is not None:
                self.on_recover(self.last_recovery_s)
        return transition

    # -- rollback-on-regression gate -----------------------------------------

    def regression_gate(self, eval_fn: Callable,
                        regress_floor: Optional[float] = None) -> Callable:
        """A quality gate for :class:`~distkeras_tpu_torch.serving.registry.
        ModelRegistry`: ``eval_fn(candidate_model) -> loss`` scores a
        hot-swap candidate on held-out recent data; the gate refuses it
        (returns False) when its loss regressed more than
        ``regress_floor`` (fractional, env ``DKTPU_STREAM_REGRESS_FLOOR``)
        over the best loss any accepted candidate achieved."""
        floor = float(config.env_float("DKTPU_STREAM_REGRESS_FLOOR")
                      if regress_floor is None else regress_floor)
        state = {"best": None}

        def gate(candidate, step: int) -> bool:
            loss = float(eval_fn(candidate))
            telemetry.gauge("stream.candidate_loss").set(round(loss, 5))
            best = state["best"]
            if best is not None and loss > best * (1.0 + floor):
                telemetry.event("stream_swap_rolled_back", {
                    "step": step, "loss": round(loss, 5),
                    "best": round(best, 5)})
                return False
            if best is None or loss < best:
                state["best"] = loss
            return True

        return gate
