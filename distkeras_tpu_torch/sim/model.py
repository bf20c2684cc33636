"""The trace-calibrated timing model.

Calibration is a replay of evidence, not a guess: the per-segment latency
distributions come from :func:`distkeras_tpu_torch.telemetry.tracing.analysis.
segment_model` over a collector-merged trace stream — the SAME extraction
the ``--trace`` report renders, so the simulator and the report can never
disagree about what was measured. On top of the lifecycle segments this
module extracts one pseudo-segment the traces imply but never name:
**work**, the per-worker gap between consecutive commit roots minus the
commit's own end-to-end time — the compute+pull interval a simulated
worker spends between commits.

Sampling: a fitted segment draws from its lognormal (log-space moment
fit), capped at 4x the observed max so a thin tail cannot schedule an
outlier the deployment never produced; a segment too thin to fit
(``fit_ok`` False) replays its mean. All draws go through the engine RNG.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from distkeras_tpu_torch.telemetry.tracing import analysis

#: lifecycle segments that block the committing worker (``replicate`` is
#: the standby's async pull — off the commit's critical path).
BLOCKING_SEGMENTS = ("encode", "wire", "queue", "fold", "fsync", "ack")
#: cap factor over the observed max for fitted-tail draws.
TAIL_CAP = 4.0


class SegmentDist:
    """One segment's fitted distribution + provenance counts."""

    __slots__ = ("name", "count", "mean_s", "p50_s", "p99_s", "max_s",
                 "mu", "sigma", "fit_ok")

    def __init__(self, name: str, count: int, mean_s: float, p50_s: float,
                 p99_s: float, max_s: float, mu: Optional[float] = None,
                 sigma: Optional[float] = None, fit_ok: bool = False):
        self.name = name
        self.count = int(count)
        self.mean_s = float(mean_s)
        self.p50_s = float(p50_s)
        self.p99_s = float(p99_s)
        self.max_s = float(max_s)
        self.mu = mu
        self.sigma = sigma
        self.fit_ok = bool(fit_ok)

    @classmethod
    def from_info(cls, name: str, info: dict) -> "SegmentDist":
        """From one :func:`segment_model` segment entry."""
        fit = info.get("lognorm") or {}
        return cls(name, info["count"], info["mean_s"], info["p50_s"],
                   info["p99_s"], info["max_s"], fit.get("mu"),
                   fit.get("sigma"), info.get("fit_ok", False))

    @classmethod
    def fixed(cls, name: str, value_s: float) -> "SegmentDist":
        """A degenerate (constant) segment for parametric scenarios."""
        return cls(name, 0, value_s, value_s, value_s, value_s)

    def sample(self, engine) -> float:
        if self.fit_ok and self.mu is not None:
            return engine.lognormal(self.mu, self.sigma,
                                    cap=TAIL_CAP * self.max_s)
        return self.mean_s

    def describe(self) -> dict:
        return {"count": self.count, "mean_s": self.mean_s,
                "p50_s": self.p50_s, "p99_s": self.p99_s,
                "max_s": self.max_s, "lognorm_mu": self.mu,
                "lognorm_sigma": self.sigma, "fit_ok": self.fit_ok}


def _work_gaps(commits: list) -> list:
    """Per-worker inter-commit gaps: for each wid's commit roots in t0
    order, ``gap_i = t0[i+1] - (t0[i] + e2e[i])`` clamped at zero — the
    compute+pull time between one commit's ack and the next commit."""
    by_wid: Dict[object, list] = {}
    for _tid, root, _durs, e2e in commits:
        wid = root.get("wid")
        if wid is None:
            continue
        by_wid.setdefault(wid, []).append(
            (float(root.get("t0") or 0.0), e2e))
    gaps = []
    for seq in by_wid.values():
        seq.sort()
        for (t0, e2e), (t1, _next) in zip(seq, seq[1:]):
            gaps.append(max(0.0, t1 - (t0 + e2e)))
    return gaps


class TimingModel:
    """Fitted segment distributions + the work pseudo-segment."""

    def __init__(self, segments: Dict[str, SegmentDist],
                 work: Optional[SegmentDist], commits: int,
                 warnings: Iterable[str] = ()):
        self.segments = dict(segments)
        self.work = work
        self.commits = int(commits)
        self.warnings = list(warnings)

    @classmethod
    def from_records(cls, records: list,
                     min_samples: Optional[int] = None) -> "TimingModel":
        kw = {} if min_samples is None else {"min_samples": min_samples}
        commits = analysis.commit_paths(records)
        model = analysis.segment_model(commits=commits, **kw)
        segments = {seg: SegmentDist.from_info(seg, info)
                    for seg, info in model["segments"].items()}
        gaps = sorted(_work_gaps(commits))
        work = None
        warnings = list(model["warnings"])
        if gaps:
            fit = analysis._lognorm_fit(gaps)
            info = {"count": len(gaps), "mean_s": sum(gaps) / len(gaps),
                    "p50_s": analysis._quantile(gaps, 0.50),
                    "p99_s": analysis._quantile(gaps, 0.99),
                    "max_s": gaps[-1], "lognorm": fit,
                    "fit_ok": bool(fit and fit["samples"]
                                   >= model["min_samples"])}
            work = SegmentDist.from_info("work", info)
            if not work.fit_ok:
                warnings.append(
                    f"work gaps: {len(gaps)} sample(s) too thin to fit — "
                    "replaying the mean")
        return cls(segments, work, model["commits"], warnings)

    @classmethod
    def from_dir(cls, trace_dir: str,
                 min_samples: Optional[int] = None) -> "TimingModel":
        from distkeras_tpu_torch.telemetry.tracing.collector import (
            TelemetryCollector)

        records = TelemetryCollector.from_dir(trace_dir).records()
        return cls.from_records(records, min_samples=min_samples)

    def sample_segment(self, name: str, engine) -> float:
        dist = self.segments.get(name)
        return dist.sample(engine) if dist is not None else 0.0

    def sample_commit_client(self, engine) -> float:
        """The worker-side pre-server part of a commit: encode + wire."""
        return (self.sample_segment("encode", engine)
                + self.sample_segment("wire", engine))

    def sample_service(self, engine) -> float:
        """The serialized server-side part (the fold lock's critical
        section): fold + fsync. Queue time is NOT sampled — queueing
        emerges from contention on the simulated server resource; the
        measured ``queue`` segment stays as validation evidence."""
        return (self.sample_segment("fold", engine)
                + self.sample_segment("fsync", engine))

    def sample_ack(self, engine) -> float:
        return self.sample_segment("ack", engine)

    def sample_work(self, engine) -> float:
        return self.work.sample(engine) if self.work is not None else 0.0

    def describe(self) -> dict:
        out = {"commits": self.commits, "warnings": list(self.warnings),
               "segments": {name: d.describe()
                            for name, d in sorted(self.segments.items())}}
        if self.work is not None:
            out["work"] = self.work.describe()
        return out
