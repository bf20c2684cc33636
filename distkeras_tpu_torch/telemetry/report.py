"""Throughput segmentation of a run's round records — the part of
``distkeras_tpu/telemetry/report.py`` that ``MetricsLogger.mean_throughput``
needs (the live number and the offline report segment one way).

The rest of the report CLI (phase breakdown, staleness and straggler
tables, ``python -m ... telemetry report``) waits for the observability
slice, ROADMAP.md Queue 1 item 10; until then the JAX package's report
reads the JSONL the port writes.
"""

from __future__ import annotations

from distkeras_tpu_torch.telemetry.core import BURST_EPS_S


def _is_burst_tail(r: dict) -> bool:
    """Interior round of a dispatch burst — not a timing boundary. The
    explicit ``burst_tail`` marker (written by MetricsLogger from the
    engine's state=None contract) is authoritative; the dt threshold is the
    fallback for records that predate it."""
    return bool(r.get("burst_tail",
                      (r.get("round_seconds") or 0.0) < BURST_EPS_S))


def throughput_segments(rounds: list[dict]) -> list[dict]:
    """Burst-grouped throughput segments (rounds, seconds, samples/s)."""
    segments: list[dict] = []
    for r in rounds:
        dt = r.get("round_seconds")
        if dt is None:
            continue
        sps = r.get("samples_per_sec")
        spr = sps * dt if sps else 0.0
        if segments and _is_burst_tail(r):
            segments[-1]["rounds"] += 1
            segments[-1]["seconds"] += dt
            segments[-1]["samples"] += spr
        else:
            segments.append(
                {"rounds": 1, "seconds": dt, "samples": spr,
                 "first_round": r["round"]})
    for s in segments:
        s["samples_per_sec"] = (s["samples"] / s["seconds"]
                                if s["seconds"] > 0 else 0.0)
    return segments
