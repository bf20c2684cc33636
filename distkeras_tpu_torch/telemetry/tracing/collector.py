"""The telemetry collector: N per-process streams -> one aligned timeline.

Every process in a fleet run writes its own JSONL — worker telemetry
dumps, PS/standby/shard trace streams, flight-recorder dumps — each on
its own clock, each possibly rotated into numbered generations, each
possibly crash-truncated. :class:`TelemetryCollector` merges them:

* **generations in order** — for a stream ``p``, rotated files ``p.1``,
  ``p.2``, ... are read oldest-first, then the live file;
* **torn tails tolerated** — every file goes through
  :func:`~distkeras_tpu_torch.telemetry.exporters.read_jsonl`, whose contract
  (silent torn final line, warned interior damage) is exactly what a
  SIGKILL'd process's stream needs;
* **clock alignment** — each stream's best ``process_info`` record (the
  min-rtt NTP estimate from ``tracing/clock.py``) supplies the offset
  added to every ``ts``/``t0`` in that stream, putting all streams on the
  PS reference clock;
* **identity stamping** — records inherit their stream's
  ``host``/``pid``/``role`` so the report can attribute any line;
* **span dedup** — a span can legitimately appear twice (the telemetry
  event dump AND the trace stream); ``(trace, span)`` ids keep exactly
  one.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Iterable, Optional

from distkeras_tpu_torch.telemetry.exporters import read_jsonl
from distkeras_tpu_torch.telemetry.tracing.context import (PROCESS_INFO_KIND,
                                                     SPAN_KIND)


def generations(path: str) -> list[str]:
    """``path``'s rotated generations oldest-first, live file last (only
    files that exist; a never-rotated stream is just ``[path]``)."""
    out = []
    n = 1
    while os.path.exists(f"{path}.{n}"):
        out.append(f"{path}.{n}")
        n += 1
    if os.path.exists(path):
        out.append(path)
    return out


def _best_info(records: list[dict]) -> dict:
    """The stream's authoritative ``process_info``: the min-rtt estimate
    (ties -> latest), falling back to the last identity record seen."""
    best: Optional[dict] = None
    for rec in records:
        if rec.get("kind") != PROCESS_INFO_KIND:
            continue
        if best is None:
            best = rec
            continue
        r_new, r_old = rec.get("clock_rtt_s"), best.get("clock_rtt_s")
        if r_old is None or (r_new is not None and r_new <= r_old):
            best = rec
    return best or {}


class TelemetryCollector:
    """Merge per-process telemetry/trace streams into one aligned list.

    ``paths`` are stream *base* paths (generations are discovered); use
    :meth:`from_dir` to sweep a trace directory (``*.jsonl``, skipping
    numbered generation files — they are folded into their base)."""

    def __init__(self, paths: Iterable[str] = ()):
        self.paths: list[str] = []
        for p in paths:
            self.add(p)

    @classmethod
    def from_dir(cls, directory: str) -> "TelemetryCollector":
        coll = cls()
        base_paths = set(_glob.glob(os.path.join(directory, "*.jsonl")))
        # A stream whose live file was rotated away (or never re-created
        # before the process died) exists only as `<base>.jsonl.N`; the
        # collector is keyed by base path — `generations()` finds the
        # .N files — so discover bases from rotated names too.
        for p in _glob.glob(os.path.join(directory, "*.jsonl.*")):
            base, _, n = p.rpartition(".")
            if n.isdigit():
                base_paths.add(base)
        for p in sorted(base_paths):
            coll.add(p)
        return coll

    def add(self, path: str) -> None:
        if path not in self.paths:
            self.paths.append(path)

    def records(self) -> list[dict]:
        """The merged timeline: every stream's records, clock-aligned,
        identity-stamped, span-deduped, sorted by aligned timestamp."""
        merged: list[dict] = []
        seen_spans: set = set()
        for path in self.paths:
            recs: list[dict] = []
            for gen in generations(path):
                recs.extend(read_jsonl(gen))
            info = _best_info(recs)
            off = float(info.get("clock_offset_s") or 0.0)
            stamp = {k: info[k] for k in ("host", "pid", "role")
                     if k in info}
            for rec in recs:
                if rec.get("kind") == SPAN_KIND:
                    key = (rec.get("trace"), rec.get("span"))
                    if key in seen_spans:
                        continue
                    seen_spans.add(key)
                rec = dict(rec)
                for k, v in stamp.items():
                    rec.setdefault(k, v)
                if off:
                    for k in ("ts", "t0"):
                        if isinstance(rec.get(k), (int, float)):
                            rec[k] = rec[k] + off
                rec["stream"] = os.path.basename(path)
                merged.append(rec)
        merged.sort(key=_sort_ts)
        return merged

    def write(self, path_or_file) -> int:
        """Dump the merged timeline as JSONL; returns the record count."""
        import json

        recs = self.records()

        def _write(f) -> None:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")

        if isinstance(path_or_file, str):
            with open(path_or_file, "w", encoding="utf-8") as f:
                _write(f)
        else:
            _write(path_or_file)
        return len(recs)


def _sort_ts(rec: dict) -> float:
    ts = rec.get("ts")
    if isinstance(ts, (int, float)):
        return float(ts)
    t0 = rec.get("t0")
    if isinstance(t0, (int, float)):
        return float(t0)
    return 0.0
