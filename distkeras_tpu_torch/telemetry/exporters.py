"""Telemetry exporters: append-only JSONL and Prometheus text format (the
port's copy of ``distkeras_tpu/telemetry/exporters.py``; both packages
write and read the same records and the same exposition text).

JSONL records are shape-compatible with ``MetricsLogger``'s per-round records
(one JSON object per line); telemetry adds records carrying a ``kind`` field
(``telemetry_summary``, plus any :meth:`Telemetry.event` records), so one
``run.jsonl`` can hold the round stream and the aggregate dump together and
``python -m distkeras_tpu_torch.telemetry report`` renders both.

The Prometheus dump is the text exposition format (histograms as cumulative
``le`` buckets) for scraping or one-shot file drops; :func:`parse_prometheus`
is the matching reader used by the round-trip tests.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Optional, TextIO, Union

from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.telemetry.core import BUCKET_BOUNDS, Telemetry

SUMMARY_KIND = "telemetry_summary"


def rotate_jsonl(path: str) -> Optional[str]:
    """Size-bounded JSONL rotation (``DKTPU_TELEMETRY_ROTATE_MB``): a file
    at/over the bound is atomically renamed to the next ``<path>.<n>``
    generation (numbered from 1, oldest first) so the next append starts a
    fresh live file; the collector reads generations in order. Returns the
    generation path, or None when no rotation was due (0 = disabled)."""
    mb = config.env_float("DKTPU_TELEMETRY_ROTATE_MB") or 0.0
    limit = int(mb * (1 << 20))
    if not limit:
        return None
    try:
        if not os.path.exists(path) or os.path.getsize(path) < limit:
            return None
        n = 1
        while os.path.exists(f"{path}.{n}"):
            n += 1
        os.replace(path, f"{path}.{n}")
        return f"{path}.{n}"
    except OSError:
        return None


def write_jsonl(tele: Telemetry, path_or_file: Union[str, TextIO],
                extra: Optional[dict] = None,
                since: Optional[dict] = None) -> None:
    """Append every recorded event plus one aggregate-summary record.

    ``since`` (a :meth:`Telemetry.mark`) windows the dump to activity after
    the mark — how per-run clients (MetricsLogger) share the process-global
    registry without re-attributing a previous run's work. Each dump leads
    with one ``process_info`` identity record (host/pid/role/boot_id +
    clock-offset estimate) so the cross-process collector can attribute
    and align the stream; path dumps rotate first when
    ``DKTPU_TELEMETRY_ROTATE_MB`` says the file is due."""
    if since is not None:
        summary, events = tele.delta(since)
    else:
        summary, events = tele.snapshot(), tele.events()

    def _write(f: TextIO) -> None:
        from distkeras_tpu_torch.telemetry.tracing import process_info_record

        f.write(json.dumps(process_info_record()) + "\n")
        for ev in events:
            f.write(json.dumps(ev) + "\n")
        rec = {"kind": SUMMARY_KIND, "ts": time.time(), **summary}
        if extra:
            rec.update(extra)
        f.write(json.dumps(rec) + "\n")

    if isinstance(path_or_file, str):
        rotate_jsonl(path_or_file)
        with open(path_or_file, "a") as f:
            _write(f)
    else:
        _write(path_or_file)


def read_jsonl(path: str, strict: bool = False) -> list[dict]:
    """All records of a telemetry/metrics JSONL.

    Crash-tolerant by design: a process killed mid-append leaves a
    truncated final line, and post-mortem ``telemetry report`` matters most
    on exactly those runs — a torn *final* line is always skipped silently,
    never an error. Malformed *interior* lines are skipped with a warning
    (they indicate concurrent-writer damage, not a crash); ``strict=True``
    raises on them instead, still tolerating the torn tail."""
    records: list[dict] = []
    bad: list[int] = []
    # Streaming with a one-line hold-back (these files are exactly the ones
    # that grow for hours — never slurp them): a malformed line's verdict is
    # deferred until we know whether anything follows it. Followed by more
    # content -> interior damage; at EOF -> the torn tail.
    pending_bad = 0
    with open(path) as f:
        for i, raw in enumerate(f, 1):
            if pending_bad:
                if strict:
                    raise ValueError(
                        f"malformed JSONL record at {path}:{pending_bad}")
                bad.append(pending_bad)
                pending_bad = 0
            line = raw.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                pending_bad = i
    if bad:
        import warnings

        warnings.warn(
            f"{path}: skipped {len(bad)} malformed interior JSONL line(s) "
            f"(first at line {bad[0]})", stacklevel=2)
    return records


def _sanitize(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", name)


def prometheus_text(tele: Telemetry) -> str:
    """The registry in Prometheus text exposition format.

    Spans/histograms become one ``dktpu_span_seconds`` histogram family with
    a ``span`` label; counters and gauges become ``dktpu_counter_total`` /
    ``dktpu_gauge`` families with a ``name`` label — fixed families keep the
    dump schema-stable as instrumentation points are added.
    """
    snap = tele.snapshot()
    out = []
    out.append("# TYPE dktpu_counter_total counter")
    for name, value in sorted(snap["counters"].items()):
        out.append(f'dktpu_counter_total{{name="{_sanitize(name)}"}} {value}')
    out.append("# TYPE dktpu_gauge gauge")
    for name, g in sorted(snap["gauges"].items()):
        out.append(f'dktpu_gauge{{name="{_sanitize(name)}"}} '
                   f'{g.get("value", 0.0)}')
    out.append("# TYPE dktpu_span_seconds histogram")
    for name, h in sorted(snap["spans"].items()):
        label = _sanitize(name)
        cum = 0
        for bound, c in zip(BUCKET_BOUNDS, h.get("buckets", [])):
            cum += c
            out.append(
                f'dktpu_span_seconds_bucket{{span="{label}",le="{bound!r}"}} '
                f"{cum}")
        out.append(
            f'dktpu_span_seconds_bucket{{span="{label}",le="+Inf"}} '
            f'{h.get("count", 0)}')
        out.append(f'dktpu_span_seconds_sum{{span="{label}"}} '
                   f'{h.get("total", 0.0)}')
        out.append(f'dktpu_span_seconds_count{{span="{label}"}} '
                   f'{h.get("count", 0)}')
    return "\n".join(out) + "\n"


_PROM_LINE = re.compile(
    r'^(?P<metric>[a-zA-Z0-9_]+)(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$')


def parse_prometheus(text: str) -> dict:
    """Parse :func:`prometheus_text` output back into
    ``{metric: {label_tuple: value}}`` (the round-trip test's reader)."""
    parsed: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if not m:
            continue
        labels = tuple(
            tuple(kv.split("=", 1)) for kv in
            (m.group("labels") or "").split(",") if "=" in kv)
        labels = tuple((k, v.strip('"')) for k, v in labels)
        parsed.setdefault(m.group("metric"), {})[labels] = float(
            m.group("value"))
    return parsed
