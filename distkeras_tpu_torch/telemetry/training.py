"""Training-aware telemetry: discipline staleness gauges + straggler flags
(the port's copy of ``distkeras_tpu/telemetry/training.py``).

``parallel/disciplines.py`` computes per-worker staleness inside the fold
(DynSGD's rotating ``(worker_id + round) mod W`` schedule). This module
re-derives the same deterministic schedule host-side — the rotation is a
pure function of (round, W), so no device value need be fetched — and
surfaces it as gauges plus per-round record fields, alongside the
per-worker loss divergence every async engine's ``[W]`` loss vector
already carries.

The straggler heuristic is deliberately simple and data-source-agnostic:
``time > k * median(times)`` over whatever round/worker times the caller has
(live per-round wall times here; per-worker times from a multihost trace or
the report CLI's JSONL replay).
"""

from __future__ import annotations

import bisect
import collections
from typing import Optional, Sequence

import numpy as np

#: default straggler threshold: flag times above k x median.
STRAGGLER_K = 2.0


def flag_stragglers(times: Sequence[float],
                    k: float = STRAGGLER_K) -> list[int]:
    """Indices whose time exceeds ``k`` x the median of ``times``.

    With fewer than 3 samples the median is too weak an anchor — nothing is
    flagged rather than flagging half of a pair.
    """
    times = np.asarray(list(times), dtype=np.float64)
    if times.size < 3:
        return []
    med = float(np.median(times))
    if med <= 0.0:
        return []
    return [int(i) for i in np.flatnonzero(times > k * med)]


def staleness_schedule(discipline, round_idx: int,
                       num_workers: int) -> Optional[np.ndarray]:
    """Per-worker staleness at ``round_idx`` under the serialized-commit
    model, or None for disciplines where staleness is not defined.

    Matches ``disciplines.py`` exactly: commits within a round serialize in
    rotated worker order, so worker ``i``'s commit lands after
    ``(i + round) mod W`` fresher commits. Only DynSGD *folds* by it, but the
    schedule (and therefore the gauge) applies to every communicating
    discipline — they all share the serialized-commit semantics.
    """
    communicates = getattr(discipline, "communicates", False)
    if not communicates or num_workers < 1:
        return None
    w = np.arange(num_workers)
    return ((w + round_idx) % num_workers).astype(np.float64)


def dynsgd_scales(staleness: np.ndarray) -> np.ndarray:
    """DynSGD's fold scale per worker: ``1 / (staleness + 1)`` — the exact
    expression in ``DynSGDFold.commit``."""
    return 1.0 / (staleness + 1.0)


class DisciplineMonitor:
    """Per-round observer for an async engine's discipline.

    ``round_fields(r, loss)`` returns the discipline-aware fields a round
    record should carry; gauges land in the given telemetry registry as a
    side effect. Constructed by ``Trainer._execute`` when the engine exposes
    a discipline (sync engines have no staleness — the monitor is inert for
    them except loss divergence when a ``[W]`` loss arrives).
    """

    #: straggler-median window size: recent rounds only, bounding per-round
    #: cost and keeping the anchor current on long runs.
    MEDIAN_WINDOW = 512

    def __init__(self, discipline=None, num_workers: int = 1, telemetry=None):
        from distkeras_tpu_torch import telemetry as _t

        self.discipline = discipline
        self.num_workers = int(num_workers)
        self.telemetry = telemetry if telemetry is not None else _t.get()
        self._is_dynsgd = type(discipline).__name__ == "DynSGDFold"
        #: running-median anchor for live straggler flagging (rounds, not
        #: workers: the engine times a whole round). Bounded window: an unbounded sorted list would cost
        #: O(n) memmove per round forever and anchor on a lifetime median;
        #: the deque tracks insertion order for eviction, ``_times`` stays
        #: sorted for the median.
        self._window = collections.deque(maxlen=self.MEDIAN_WINDOW)
        self._times: list[float] = []

    def round_fields(self, round_idx: int, loss,
                     round_seconds: Optional[float] = None) -> dict:
        fields: dict = {}
        tele = self.telemetry
        stale = staleness_schedule(self.discipline, round_idx,
                                   self.num_workers)
        if stale is not None and self.num_workers > 1:
            fields["staleness"] = [int(s) for s in stale]
            tele.gauge("discipline.staleness_mean").set(float(stale.mean()))
            tele.gauge("discipline.staleness_max").set(float(stale.max()))
            if self._is_dynsgd:
                scales = dynsgd_scales(stale)
                fields["dynsgd_scale"] = [round(float(s), 6) for s in scales]
                tele.gauge("discipline.dynsgd_scale_min").set(
                    float(scales.min()))
        loss = np.asarray(loss)
        if loss.size > 1:
            div = loss.astype(np.float64).ravel() - float(loss.mean())
            fields["loss_divergence"] = [round(float(d), 6) for d in div]
            tele.gauge("discipline.loss_divergence_max").set(
                float(np.abs(div).max()))
        # Callers pass round_seconds=None for burst-tail callbacks (interior
        # rounds of a compiled block — MetricsLogger derives this from the
        # engine's state contract): tails must neither anchor the median nor
        # be flagged, or every real block would read as a straggler against
        # a tail-scale median. Real boundaries count however fast they are.
        if round_seconds is not None and round_seconds > 0:
            if len(self._window) == self._window.maxlen:
                evicted = self._window[0]
                del self._times[bisect.bisect_left(self._times, evicted)]
            self._window.append(round_seconds)
            bisect.insort(self._times, round_seconds)
            n = len(self._times)
            med = self._times[n // 2] if n % 2 else 0.5 * (
                self._times[n // 2 - 1] + self._times[n // 2])
            if n >= 3 and med > 0 and round_seconds > STRAGGLER_K * med:
                fields["straggler"] = True
                tele.counter("discipline.straggler_rounds").add(1)
        return fields
