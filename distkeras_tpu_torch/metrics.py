"""Structured training metrics + profiling hooks (the port's copy of
``distkeras_tpu/metrics.py``).

Every fold round can emit a JSONL record (loss, samples/sec/chip, scaling
efficiency inputs), and any span can be wrapped in a ``torch.profiler``
trace (CPU and CUDA activities) written as a Chrome trace.

``MetricsLogger`` is a client of the port's telemetry registry
(``distkeras_tpu_torch/telemetry/``): every round also feeds the ambient
registry's ``round_seconds`` histogram and loss gauge, an attached
:class:`~distkeras_tpu_torch.telemetry.training.DisciplineMonitor` augments
records with staleness/divergence/straggler fields, and ``close()``
appends the registry's aggregate summary to the JSONL — the records, the
fields and the burst-tail rule are the JAX package's, so its
``python -m distkeras_tpu.telemetry report`` reads the file.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Optional

import numpy as np
import torch


class MetricsLogger:
    """Per-round JSONL metrics writer with throughput accounting.

    Use as the ``on_round`` callback of an engine run — as a context manager,
    so the file handle can't leak when the run raises::

        with MetricsLogger("run.jsonl", samples_per_round=W*K*B,
                           num_chips=W) as logger:
            engine.run(plan, on_round=logger)
    """

    def __init__(
        self,
        path: Optional[str] = None,
        samples_per_round: int = 0,
        num_chips: int = 1,
        extra: Optional[dict] = None,
        monitor=None,
        telemetry=None,
    ):
        from distkeras_tpu_torch import telemetry as _telemetry

        self.path = path
        self.samples_per_round = samples_per_round
        self.num_chips = num_chips
        self.extra = extra or {}
        #: optional DisciplineMonitor: staleness/divergence/straggler fields
        #: per round (telemetry/training.py).
        self.monitor = monitor
        self.telemetry = telemetry if telemetry is not None else _telemetry.get()
        self.records: list[dict] = []
        #: registry window start: close() dumps only THIS run's activity
        #: (sequential runs share the process-global registry; a full dump
        #: would re-attribute the previous run's counters and spans).
        self._mark = self.telemetry.mark()
        self._file = open(path, "a") if path else None
        self._last_t = time.perf_counter()
        #: burst tracking (see __call__): the run's first callback is always
        #: a timing boundary.
        self._prev_had_state = True

    #: default for ``state``: distinguishes "caller passed nothing" (assume
    #: every call is a real timing boundary — standalone use) from an
    #: explicit ``None`` (the engine contract: blocked/auto runs hand
    #: interior rounds of a compiled block ``state=None``; only the burst's
    #: FINAL call carries a state).
    _UNSET = object()

    def __call__(self, round_idx: int, loss, state=_UNSET) -> None:
        now = time.perf_counter()
        dt = now - self._last_t
        self._last_t = now
        # Authoritative burst-tail signal, NOT a dt threshold: on slow hosts
        # a burst-tail callback still pays the previous record's JSONL write
        # (~0.2 ms), which can exceed any fixed epsilon and would poison the
        # straggler median / throughput segments. Attribution: a burst's
        # callbacks fire back-to-back AFTER the block retires, so the whole
        # block's wall time lands in the FIRST callback's dt — while the
        # state rides the LAST. A record is therefore a timing boundary iff
        # the PREVIOUS call carried a state (it closed the previous burst);
        # marking state-bearing records themselves as boundaries would
        # anchor the straggler median on JSONL-write jitter and hide every
        # genuinely slow block.
        is_tail = not self._prev_had_state
        self._prev_had_state = state is not None  # _UNSET counts as a state
        if isinstance(loss, torch.Tensor):
            loss = loss.detach().float().cpu().numpy()
        loss = np.asarray(loss)
        rec = {
            "ts": time.time(),
            "round": round_idx,
            "loss": float(loss.mean()),
            "round_seconds": round(dt, 6),
            **self.extra,
        }
        # Written on EVERY record (not just tails): an explicit False lets
        # readers classify a sub-100µs genuine boundary (in-memory logger on
        # a fast per-round engine) correctly instead of falling back to the
        # dt threshold.
        rec["burst_tail"] = is_tail
        if loss.size > 1:  # async engines report one loss per worker
            rec["worker_loss"] = [round(float(v), 6) for v in loss.ravel()]
        if self.samples_per_round and dt > 0:
            rec["samples_per_sec"] = round(self.samples_per_round / dt, 2)
            rec["samples_per_sec_per_chip"] = round(
                self.samples_per_round / dt / self.num_chips, 2
            )
        if self.monitor is not None:
            rec.update(self.monitor.round_fields(
                round_idx, loss,
                round_seconds=None if is_tail else dt))
        tele = self.telemetry
        if not is_tail:
            # Tails would bury the real per-round time under µs callback
            # dts (R-1 of every R observations in a blocked run).
            tele.histogram("round_seconds").observe(dt)
        tele.gauge("loss").set(rec["loss"])
        tele.counter("rounds").add(1)
        self.records.append(rec)
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
        return None

    def close(self) -> None:
        """Flush the telemetry summary and release the file. Idempotent —
        trainer paths call it from ``finally`` AND the happy path."""
        if self._file:
            from distkeras_tpu_torch.telemetry.exporters import write_jsonl

            # The aggregate dump rides the same JSONL: rounds + phases in one
            # file is what the report CLI renders. Windowed to this logger's
            # lifetime so back-to-back runs don't cross-contaminate.
            with contextlib.suppress(Exception):
                write_jsonl(self.telemetry, self._file, since=self._mark)
            self._file.close()
            self._file = None

    #: callbacks arriving within this window of their predecessor are part
    #: of the same dispatch burst (blocked/auto execution delivers one
    #: callback burst per compiled block). Shared constant: the live
    #: straggler monitor and the offline report segment by the same value.
    from distkeras_tpu_torch.telemetry.core import (  # noqa: F401 - class-attr re-export
        BURST_EPS_S as _BURST_EPS_S)

    def mean_throughput(self, skip: int = 1) -> float:
        """Aggregate samples/sec, skipping the first ``skip`` timing
        segments (compile/warmup). Blocked and auto execution deliver
        callbacks in per-block bursts — a burst's first record absorbs the
        whole block's duration and the rest read ~0 s — so records are
        grouped into segments (a timing boundary plus its burst tail) and
        throughput is computed from segment totals: per-round rates or raw
        record sums would misattribute samples across block boundaries.
        The grouping is ``telemetry.report.throughput_segments`` — ONE
        implementation, so the live number and the offline report cannot
        diverge."""
        from distkeras_tpu_torch.telemetry.report import throughput_segments

        segments = throughput_segments(
            [r for r in self.records if "samples_per_sec" in r])
        if len(segments) > skip:
            segments = segments[skip:]
        # else: everything landed in <= skip segments (e.g. one giant block)
        # — report over what exists rather than a meaningless 0.
        total_t = sum(s["seconds"] for s in segments)
        total_rounds = sum(s["rounds"] for s in segments)
        if not segments or total_t <= 0:
            return 0.0
        return self.samples_per_round * total_rounds / total_t


def scaling_efficiency(sps_n: float, sps_1: float, n_chips: int) -> float:
    """BASELINE.md's headline metric: throughput(N) / (N * throughput(1))."""
    if sps_1 <= 0 or n_chips <= 0:
        return 0.0
    return sps_n / (n_chips * sps_1)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` span (CPU and, where there is a card, CUDA
    activities) -> a Chrome trace ``trace-<pid>.json`` in ``log_dir``."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace-{os.getpid()}.json"))
