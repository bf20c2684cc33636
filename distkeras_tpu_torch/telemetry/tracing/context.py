"""Trace-context propagation: ids, ambient scopes, and the span stream.

One *trace* is the life of one logical operation across processes — a
commit from worker encode through wire, shard fold, journal fsync, and
standby replication; a served request from client submit through the
micro-batcher's dispatch. Every timed segment is a *span*: a record

    {"kind": "trace_span", "trace": ..., "span": ..., "parent": ...,
     "name": ..., "t0": <wall-clock start>, "dur": <seconds>, ...}

emitted into the process's telemetry event stream (so ``write_jsonl``
exports it) and — when a trace directory resolves — appended immediately
to a per-process ``trace-<role>-<pid>.jsonl`` so a SIGKILL'd process
loses at most one torn line (the collector tolerates that tail with the
same rule as ``read_jsonl``). The context travels:

* **within a thread** ambiently (thread-local), so nested scopes become
  parent/child spans without threading arguments through call sites;
* **across thread pools** explicitly via :func:`adopt` (pool threads do
  not inherit thread-locals — the sharded fan-out captures the context
  and re-establishes it inside each stripe closure);
* **across processes** as two JSON header fields (``trace``/``parent``)
  on netps/serving wire frames, gated behind ``CAPS["tracing"]`` — a
  peer that never advertised the bit is sent zero new bytes.

Everything here is stdlib + the env registry: no torch, no numpy — the
same contract as the telemetry core. With ``DKTPU_TRACE`` unset (the
default) every entry point is a cheap no-op.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import uuid
from contextlib import contextmanager
from typing import NamedTuple, Optional

from distkeras_tpu_torch.runtime import config

#: event kind of one span record (rides the telemetry event stream and
#: the per-process trace stream alike; the collector dedups on ids).
SPAN_KIND = "trace_span"
#: event kind of the per-process identity record every stream carries:
#: host, pid, role, boot_id, and the current clock-offset estimate.
PROCESS_INFO_KIND = "process_info"

_TLS = threading.local()
_STATE_LOCK = threading.Lock()
#: explicit role override (set_role); the env var is the fallback.
_ROLE: list = [""]
_BOOT_ID: list = [None]
#: lazily opened per-process span stream: {"f", "path", "pid"}.
_WRITER: dict = {"f": None, "path": None, "pid": None}


def enabled() -> bool:
    """Whether tracing is on (``DKTPU_TRACE``); read live so tests and
    late launchers can flip it without re-importing."""
    return config.env_bool("DKTPU_TRACE")


class TraceContext(NamedTuple):
    """The two ids that travel: the trace and the current span within it."""

    trace: str
    span: str


def new_id() -> str:
    """One 16-hex-char id (half a uuid4 — ample for per-run uniqueness)."""
    return uuid.uuid4().hex[:16]


def current() -> Optional[TraceContext]:
    """This thread's ambient trace context (None outside any scope)."""
    return getattr(_TLS, "ctx", None)


def set_role(role: str) -> None:
    """Stamp this process's role label (``ps``/``standby``/``shard0``/
    ``worker1``/...). An explicit ``DKTPU_TRACE_ROLE`` wins — the operator
    labeled the process on purpose; launchers calling in here are only
    providing the default."""
    with _STATE_LOCK:
        _ROLE[0] = str(role)


def role() -> str:
    """This process's role label: the env var, else :func:`set_role`'s
    value, else ``proc``."""
    env = config.env_str("DKTPU_TRACE_ROLE")
    if env:
        return env
    return _ROLE[0] or "proc"


def boot_id() -> str:
    """The kernel boot id (same source as the shm same-host check), or a
    per-process fallback uuid where /proc is absent."""
    if _BOOT_ID[0] is None:
        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                _BOOT_ID[0] = f.read().strip()
        except OSError:
            _BOOT_ID[0] = uuid.uuid4().hex
    return _BOOT_ID[0]


def trace_dir() -> str:
    """Where this process streams spans + flight dumps: ``DKTPU_TRACE_DIR``,
    falling back to the PS state dir (the chaos drills already point one at
    scratch space); empty = no streaming (events/ring only)."""
    d = config.env_str("DKTPU_TRACE_DIR")
    if d:
        return d
    return config.env_str("DKTPU_PS_STATE_DIR")


def process_info_record() -> dict:
    """The stream-identity record: who wrote this file, on which clock."""
    from distkeras_tpu_torch.telemetry.tracing import clock

    return {"kind": PROCESS_INFO_KIND, "ts": time.time(),
            "host": socket.gethostname(), "pid": os.getpid(),
            "role": role(), "boot_id": boot_id(),
            "clock_offset_s": clock.offset(), "clock_rtt_s": clock.rtt()}


# -- the per-process span stream -------------------------------------------

def _rotate_bytes() -> int:
    mb = config.env_float("DKTPU_TELEMETRY_ROTATE_MB") or 0.0
    return int(mb * (1 << 20))


def _stream_write(rec: dict) -> None:
    """Append one record to the per-process trace stream (best-effort:
    tracing must never take the data plane down). Rotation mirrors the
    exporter rule: at/over ``DKTPU_TELEMETRY_ROTATE_MB`` the live file is
    renamed to the next ``<path>.<n>`` generation before the append."""
    d = trace_dir()
    if not d:
        return
    line = json.dumps(rec)
    with _STATE_LOCK:
        f = _WRITER["f"]
        if f is None or _WRITER["pid"] != os.getpid():
            # Fresh open (first span, or a fork inherited the parent's
            # handle — each pid owns its own stream file).
            try:
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d, f"trace-{role()}-{os.getpid()}.jsonl")
                f = open(path, "a", encoding="utf-8")
            except OSError:
                return
            _WRITER.update(f=f, path=path, pid=os.getpid())
            f.write(json.dumps(process_info_record()) + "\n")
        try:
            limit = _rotate_bytes()
            if limit and f.tell() >= limit:
                f.close()
                _rotate_generations(_WRITER["path"])
                f = open(_WRITER["path"], "a", encoding="utf-8")
                _WRITER["f"] = f
                f.write(json.dumps(process_info_record()) + "\n")
            f.write(line + "\n")
            f.flush()
        except (OSError, ValueError):
            _WRITER.update(f=None, path=None, pid=None)


def _rotate_generations(path: str) -> None:
    """Atomic-rename rotation: the live file becomes the next numbered
    generation (``<path>.1`` is the oldest); the collector reads
    generations in numeric order, then the live file."""
    n = 1
    while os.path.exists(f"{path}.{n}"):
        n += 1
    os.replace(path, f"{path}.{n}")


def refresh_process_info() -> None:
    """Re-stamp the stream with a fresh identity record (the clock module
    calls in when its offset estimate improves, so the collector can use
    the best estimate the process ever had)."""
    if _WRITER["f"] is not None and _WRITER["pid"] == os.getpid():
        _stream_write(process_info_record())


def stream_path() -> Optional[str]:
    """The live trace-stream path, once anything has been written (None
    before, and in a child process until it writes its own)."""
    return _WRITER["path"] if _WRITER["pid"] == os.getpid() else None


def _reset_stream() -> None:
    """Tests only: drop the open stream so the next span re-resolves the
    directory/role."""
    with _STATE_LOCK:
        f = _WRITER["f"]
        if f is not None:
            try:
                f.close()
            except OSError:
                pass
        _WRITER.update(f=None, path=None, pid=None)


# -- span emission ----------------------------------------------------------

def record_span(name: str, trace: str, span: str, parent: Optional[str],
                t0: float, dur: float, **fields) -> None:
    """Emit one finished span: into the telemetry event stream (exported
    by ``write_jsonl``; the core's event tap feeds the flight ring) and
    onto the per-process trace stream."""
    rec = {"name": name, "trace": trace, "span": span,
           "t0": round(t0, 6), "dur": round(dur, 6)}
    if parent:
        rec["parent"] = parent
    if fields:
        rec.update(fields)
    from distkeras_tpu_torch import telemetry

    telemetry.event(SPAN_KIND, rec)
    _stream_write(dict(rec, kind=SPAN_KIND, ts=rec["t0"]))


def emit(name: str, ctx: Optional[TraceContext], t0: float, dur: float,
         **fields) -> None:
    """Record one already-timed span as a child of ``ctx`` (the server
    side's lock-wait measurement, where a context manager cannot wrap the
    acquire). No-op without a context or with tracing off."""
    if ctx is None or not enabled():
        return
    record_span(name, ctx.trace, new_id(), ctx.span, t0, dur, **fields)


@contextmanager
def trace_scope(name: str, **fields):
    """Timed span scope: joins the ambient trace as a child span, or ROOTS
    a new trace when no context is ambient (the client's ``commit`` root).
    Yields the scope's :class:`TraceContext` (None when tracing is off)."""
    if not enabled():
        yield None
        return
    prev = getattr(_TLS, "ctx", None)
    trace = prev.trace if prev is not None else new_id()
    parent = prev.span if prev is not None else None
    ctx = TraceContext(trace, new_id())
    _TLS.ctx = ctx
    t0 = time.time()
    p0 = time.perf_counter()
    try:
        yield ctx
    finally:
        dur = time.perf_counter() - p0
        _TLS.ctx = prev
        record_span(name, trace, ctx.span, parent, t0, dur, **fields)


@contextmanager
def child_scope(name: str, **fields):
    """Like :func:`trace_scope` but records ONLY inside an existing trace
    — a segment with no ambient context is a no-op, never an orphan root
    (the server's fold/fsync segments use this: an untraced commit must
    not mint trace ids)."""
    if not enabled() or getattr(_TLS, "ctx", None) is None:
        yield None
        return
    with trace_scope(name, **fields) as ctx:
        yield ctx


@contextmanager
def adopt(ctx: Optional[TraceContext]):
    """Establish ``ctx`` as this thread's ambient context without emitting
    a span — how the context crosses thread pools (stripe fan-out, the
    overlap lanes) and how a server adopts a request header's context."""
    if ctx is None or not enabled():
        yield None
        return
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


# -- wire-header helpers ----------------------------------------------------

def wire_fields() -> dict:
    """The two header fields an outgoing traced request carries (``{}``
    with tracing off or outside any scope — an absent JSON key is an
    absent wire byte, which is the whole capability-gating story)."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None or not enabled():
        return {}
    return {"trace": ctx.trace, "parent": ctx.span}


def header_ctx(header: dict) -> Optional[TraceContext]:
    """The context an incoming request header carries (None untraced).
    The carried ``parent`` is the CLIENT's span — server-side segments
    recorded under this context become its children."""
    trace = header.get("trace")
    if not trace or not enabled():
        return None
    return TraceContext(str(trace), str(header.get("parent") or ""))
