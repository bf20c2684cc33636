"""Marginal-throughput elastic expansion: grow a job only while growing
pays (the port's copy of the JAX package's ``netps/tuner/fleet.py``).

A scheduler's static quota/priority logic answers "may this job have
another worker"; this policy answers "did the LAST worker it got actually
move the needle". It watches each job's cumulative commit count per
scheduler tick, keeps a small table of measured commit rates per
granted-worker count, and blocks the next expansion when the current rate
is not at least ``(1 + DKTPU_TUNE_MIN_GAIN)`` times the best rate measured
at a smaller worker count — when marginal throughput has flattened, the
free slot is left for a tenant that can still use it.

Shrink paths (preemption, floors, gang minimums) are untouched: the policy
only gates *expansion*, so it can never cause a floor violation. The
port's :class:`~distkeras_tpu_torch.fleet.scheduler.FleetScheduler`
consults it (``expansion_policy=``, the default under
``DKTPU_NET_AUTOTUNE``), as the JAX package's does.
"""

from __future__ import annotations

import time
from typing import Optional

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.runtime import config


class MarginalThroughputPolicy:
    """Expansion gate fed by :meth:`observe` from a scheduler's tick
    (one scheduler thread; no locking needed). ``min_gain`` is
    the fractional rate improvement a grown worker count must show over
    the best smaller count to keep growing (``DKTPU_TUNE_MIN_GAIN``)."""

    #: seconds of observation at a worker count before its rate is
    #: trusted (shorter windows measure ramp-up noise, not throughput).
    MIN_WINDOW_S = 0.25

    def __init__(self, min_gain: Optional[float] = None):
        if min_gain is None:
            min_gain = config.env_float("DKTPU_TUNE_MIN_GAIN")
        self.min_gain = float(min_gain)
        #: label -> {"workers", "t0", "p0", "rates": {count: rate}}
        self._jobs: dict = {}

    def observe(self, label: str, workers: int, progress: int,
                now: Optional[float] = None) -> None:
        """Feed one scheduler-tick sample: the job's currently granted
        worker count and cumulative commit progress."""
        if now is None:
            now = time.monotonic()
        st = self._jobs.get(label)
        if st is None:
            self._jobs[label] = {"workers": int(workers), "t0": now,
                                 "p0": int(progress), "rates": {}}
            return
        dt = now - st["t0"]
        if int(workers) != st["workers"]:
            # Count changed: seal the finished window's rate, re-anchor.
            if dt >= self.MIN_WINDOW_S:
                st["rates"][st["workers"]] = (int(progress) - st["p0"]) / dt
            st.update(workers=int(workers), t0=now, p0=int(progress))
            return
        if dt >= self.MIN_WINDOW_S:
            # Same count: keep the current window's rate fresh.
            rate = (int(progress) - st["p0"]) / dt
            st["rates"][st["workers"]] = rate
            telemetry.gauge(f"tuner.marginal_tput.{label}").set(rate)

    def allow_expand(self, label: str, workers: int) -> bool:
        """May ``label`` grow beyond its current ``workers`` count?
        True without evidence (never starves a cold job); False when the
        measured rate at the current count failed to clear the marginal
        gain bar over the best smaller count."""
        st = self._jobs.get(label)
        if st is None:
            return True
        rates = st["rates"]
        cur = rates.get(int(workers))
        smaller = [r for n, r in rates.items() if n < int(workers)]
        if cur is None or not smaller:
            return True
        if cur >= max(smaller) * (1.0 + self.min_gain):
            return True
        telemetry.counter("tuner.expand_blocked").add(1)
        telemetry.event("tuner_expand_blocked", {
            "job": label, "workers": int(workers),
            "rate": round(cur, 3),
            "best_smaller": round(max(smaller), 3)})
        return False
