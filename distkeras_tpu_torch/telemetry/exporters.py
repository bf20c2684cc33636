"""Telemetry exporters: append-only JSONL (the port's copy of
``distkeras_tpu/telemetry/exporters.py``; the Prometheus text format comes
with the observability slice, ROADMAP.md Queue 1 item 10).

JSONL records are shape-compatible with ``MetricsLogger``'s per-round
records (one JSON object per line); telemetry adds records carrying a
``kind`` field (``process_info``, ``telemetry_summary``, plus any
:meth:`Telemetry.event` records), so one ``run.jsonl`` holds the round
stream and the aggregate dump together, and the JAX package's
``python -m distkeras_tpu.telemetry report`` renders it.
"""

from __future__ import annotations

import json
import os
import socket
import time
import uuid
from typing import Optional, TextIO, Union

from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.telemetry.core import Telemetry

SUMMARY_KIND = "telemetry_summary"
PROCESS_INFO_KIND = "process_info"

_BOOT_ID: list = [None]


def boot_id() -> str:
    """The kernel boot id, or a per-process fallback uuid where /proc is
    absent."""
    if _BOOT_ID[0] is None:
        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                _BOOT_ID[0] = f.read().strip()
        except OSError:
            _BOOT_ID[0] = uuid.uuid4().hex
    return _BOOT_ID[0]


def process_info_record() -> dict:
    """The stream-identity record: who wrote this file, on which clock
    (the port exchanges no clock samples, so its offset is 0 and its rtt
    unknown)."""
    return {"kind": PROCESS_INFO_KIND, "ts": time.time(),
            "host": socket.gethostname(), "pid": os.getpid(),
            "role": "proc",
            "boot_id": boot_id(), "clock_offset_s": 0.0, "clock_rtt_s": None}


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
    with one ``process_info`` identity record (host/pid/role/boot_id);
    path dumps rotate first when ``DKTPU_TELEMETRY_ROTATE_MB`` says the
    file is due."""
    if since is not None:
        summary, events = tele.delta(since)
    else:
        summary, events = tele.snapshot(), tele.events()

    def _write(f: TextIO) -> None:
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
