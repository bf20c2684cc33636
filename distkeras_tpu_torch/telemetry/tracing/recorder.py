"""The crash flight recorder: a bounded ring of recent evidence (the port's
copy of ``distkeras_tpu/telemetry/tracing/recorder.py``).

Chaos postmortems need the last few seconds of a process's life — which
spans were in flight, which faults fired, which commits folded — without
paying full-rate logging on healthy runs. Every process keeps a
``DKTPU_TRACE_RING``-bounded deque of recent telemetry events and trace
spans (fed by the telemetry core's event tap, so instrumented code needs
no second call site), and dumps it to ``flight-<role>-<pid>.jsonl`` when
something goes wrong:

* **fault injection** — ``FaultPlan._fire`` dumps BEFORE the effect, so
  even ``ps_crash``'s SIGKILL leaves evidence on disk;
* **epoch fencing** — a client whose commit/pull was fenced dumps its
  view of the discarded lineage;
* **SIGTERM** — the netps CLI's drain path dumps on the first signal;
* **unhandled crash** — :func:`install_crash_hooks` wraps
  ``sys.excepthook`` / ``threading.excepthook``.

Dumps are additive (append-mode, one ``flight_dump`` marker record per
dump) and deduplicated per reason per process, so a fault storm does not
write the same ring a hundred times.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Optional

from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.telemetry.tracing import context


class FlightRecorder:
    """One bounded ring of recent records + the dump-on-fault writer."""

    def __init__(self, size: Optional[int] = None):
        if size is None:
            size = max(8, config.env_int("DKTPU_TRACE_RING"))
        self._ring: deque = deque(maxlen=int(size))
        self._lock = threading.Lock()
        self._dumped: set = set()

    def record(self, rec: dict) -> None:
        with self._lock:
            self._ring.append(rec)

    def head(self, n: int = 64) -> list:
        """The most recent ``n`` records, oldest first (the ``stats``
        op's live scrape payload). ``n <= 0`` is none: the JAX package's
        ``items[-0:]`` answers the whole ring to a scrape that asked for
        none (the health hub's every sweep)."""
        if int(n) <= 0:
            return []
        with self._lock:
            items = list(self._ring)
        return items[-int(n):]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def dump(self, reason: str, once: bool = True) -> Optional[str]:
        """Write the ring to ``flight-<role>-<pid>.jsonl`` in the trace
        dir (falling back to the PS state dir; no dir = no dump). Returns
        the path, or None when skipped/deduped. Best-effort: a dump must
        never mask the failure that triggered it."""
        d = context.trace_dir()
        if not d:
            return None
        with self._lock:
            if once and reason in self._dumped:
                return None
            self._dumped.add(reason)
            items = list(self._ring)
        path = os.path.join(
            d, f"flight-{context.role()}-{os.getpid()}.jsonl")
        try:
            os.makedirs(d, exist_ok=True)
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(context.process_info_record()) + "\n")
                f.write(json.dumps({"kind": "flight_dump",
                                    "reason": str(reason),
                                    "ts": time.time(),
                                    "records": len(items)}) + "\n")
                for rec in items:
                    f.write(json.dumps(rec, default=str) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except (OSError, TypeError, ValueError):
            return None
        return path


_RING: Optional[FlightRecorder] = None
_RING_LOCK = threading.Lock()


def get_ring() -> FlightRecorder:
    """The process-global flight recorder (created on first touch)."""
    global _RING
    if _RING is None:
        with _RING_LOCK:
            if _RING is None:
                _RING = FlightRecorder()
    return _RING


def ring_head(n: int = 64) -> list:
    """The global ring's most recent ``n`` records (empty before any
    activity — the accessor never creates work)."""
    if _RING is None:
        return []
    return _RING.head(n)


def flight_dump(reason: str, once: bool = True) -> Optional[str]:
    """Dump the global ring (no-op with tracing off — the ring is only
    fed when tracing is on, so there would be nothing to say)."""
    if not context.enabled():
        return None
    return get_ring().dump(reason, once=once)


def _tap(rec: dict) -> None:
    """The telemetry core's event tap: every recorded event (trace spans
    included — they ride the event stream) lands in the ring when tracing
    is on. Installed once at package import; the enabled() check keeps
    the off-path to one dict lookup."""
    if context.enabled():
        get_ring().record(rec)


_HOOKS = {"installed": False}


def install_crash_hooks() -> None:
    """Wrap ``sys.excepthook``/``threading.excepthook`` to flight-dump on
    any unhandled exception before the previous hook runs (idempotent;
    long-running entry points — the netps CLI, the serving frontend —
    call this at startup)."""
    if _HOOKS["installed"]:
        return
    _HOOKS["installed"] = True
    prev_sys = sys.excepthook
    prev_thread = threading.excepthook

    def _sys_hook(exc_type, exc, tb):
        try:
            flight_dump(f"crash:{exc_type.__name__}", once=False)
        except Exception:  # noqa: BLE001 - never mask the real crash
            pass
        prev_sys(exc_type, exc, tb)

    def _thread_hook(args):
        try:
            flight_dump(f"crash:{args.exc_type.__name__}", once=False)
        except Exception:  # noqa: BLE001 - never mask the real crash
            pass
        prev_thread(args)

    sys.excepthook = _sys_hook
    threading.excepthook = _thread_hook


def _reset() -> None:
    """Tests only: fresh ring + dump dedup."""
    global _RING
    with _RING_LOCK:
        _RING = None
