"""Telemetry primitives: spans, counters, gauges, histograms (the port's
copy of the JAX package's ``telemetry/core.py``).

One process-wide :class:`Telemetry` registry aggregates everything the
trainer, engines, data plane, and predictors observe (the reference recorded
wall-clock only — ``Trainer.record_training_start/stop``; SURVEY.md §5).
Design constraints, in order:

* **Low overhead.** A span is two ``perf_counter`` calls plus one locked
  histogram update (~1-2 µs); hot paths (a fold round, a native gather) are
  hundreds of µs to ms. ``DKTPU_TELEMETRY=0`` swaps in no-op singletons so
  even that cost vanishes.
* **Thread-safe.** The RoundFeeder stages batches on its own thread and the
  consumer loop observes from the main thread; every metric guards its state
  with one lock. Span nesting is tracked per-thread (``threading.local``).
* **Pure host-side.** No torch imports, no device work, no fences — telemetry
  must never perturb the async dispatch pipeline it measures.
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Optional

#: log2-spaced histogram boundaries (seconds): ~1 µs .. 64 s. Fixed buckets
#: keep ``observe`` O(log n) with no allocation, and export directly as
#: Prometheus ``le`` buckets.
BUCKET_BOUNDS = tuple(2.0 ** e for e in range(-20, 7))

#: round timings under this are burst-tail callbacks, not real timing
#: boundaries (blocked/auto execution delivers one callback burst per
#: compiled block; tail callbacks arrive ~µs apart while a real round
#: includes at least a JSONL write). The ONE home for the constant —
#: MetricsLogger segmentation, the live straggler monitor, and the offline
#: report must all agree or they silently diverge.
BURST_EPS_S = 1e-4


class Counter:
    """Monotonic counter (adds only)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> float:
        return self._value


class Gauge:
    """Last-value gauge that also tracks min/max/mean over its lifetime."""

    __slots__ = ("name", "_value", "_count", "_total", "_min", "_max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._count = 0
        self._total = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._value = v
            self._count += 1
            self._total += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        with self._lock:
            if not self._count:
                return {"value": 0.0, "count": 0}
            return {
                "value": self._value,
                "count": self._count,
                "mean": self._total / self._count,
                "min": self._min,
                "max": self._max,
            }


class Histogram:
    """Fixed-bucket latency histogram (seconds) with sum/count/min/max."""

    __slots__ = ("name", "_counts", "_count", "_total", "_min", "_max",
                 "_lock")

    def __init__(self, name: str):
        self.name = name
        self._counts = [0] * (len(BUCKET_BOUNDS) + 1)
        self._count = 0
        self._total = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(BUCKET_BOUNDS, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._total += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def total(self) -> float:
        return self._total

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the target bucket)."""
        with self._lock:
            if not self._count:
                return 0.0
            target = q * self._count
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= target and c:
                    return (BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS)
                            else self._max)
            return self._max

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "count": self._count,
                "total": self._total,
                "buckets": list(self._counts),
            }
            if self._count:
                snap.update(
                    mean=self._total / self._count,
                    min=self._min,
                    max=self._max,
                )
            return snap


# -- attribution labels (per-thread, ambient) -------------------------------
#: thread-local stack of label dicts pushed by :func:`scoped_labels`.
_LABELS = threading.local()

#: metric-name suffix order: the tenant owns the job, so the tenant comes
#: first — `fleet.commits.<tenant>.<job>` groups by tenant in sorted dumps.
_LABEL_ORDER = ("tenant", "job")

#: label values ride inside dotted metric names, so they must stay single
#: dot-free tokens; anything else is flattened to `-`.
_LABEL_SANITIZE = re.compile(r"[^0-9A-Za-z_-]+")


def sanitize_label(value) -> str:
    """One metric-name-safe token for a label value (dots and whitespace
    become ``-``; empty values read ``unknown``)."""
    return _LABEL_SANITIZE.sub("-", str(value)).strip("-") or "unknown"


def current_labels() -> dict:
    """The merged ambient label dict for this thread (innermost scope
    wins), ``{}`` when no scope is active."""
    stack = getattr(_LABELS, "stack", None)
    if not stack:
        return {}
    merged: dict = {}
    for d in stack:
        merged.update(d)
    return merged


def label_suffix() -> str:
    """The ambient labels as a metric-name suffix: ``.<tenant>.<job>``
    (sanitized, tenant first), ``""`` when no scope is active — so
    instrumented code can write ``counter("fleet.commits" +
    label_suffix())`` and stay label-free outside a fleet run."""
    labels = current_labels()
    parts = [sanitize_label(labels[k]) for k in _LABEL_ORDER if k in labels]
    return ("." + ".".join(parts)) if parts else ""


class _LabelScope:
    """Context manager pushing one label dict onto the thread's stack.
    Events recorded inside the scope carry the labels automatically
    (:meth:`Telemetry.event` merges them under any explicit fields)."""

    __slots__ = ("_labels",)

    def __init__(self, labels: dict):
        self._labels = labels

    def __enter__(self) -> "_LabelScope":
        stack = getattr(_LABELS, "stack", None)
        if stack is None:
            stack = _LABELS.stack = []
        stack.append(self._labels)
        return self

    def __exit__(self, *exc) -> None:
        stack = getattr(_LABELS, "stack", None)
        if stack and stack[-1] is self._labels:
            stack.pop()
        return None


def scoped_labels(**labels) -> _LabelScope:
    """Attach attribution labels (``tenant=``, ``job=``, ...) to this
    thread for the scope's duration. The fleet scheduler wraps every
    worker thread in one, so per-job metrics and every event fired under
    it (supervisor retries, host restarts, evictions) are attributable
    to a tenant without threading arguments through each call site."""
    return _LabelScope(dict(labels))


class _SpanContext:
    """Context manager recording one timed span into the registry.

    Nesting builds a per-thread dotted path: ``span("round")`` containing
    ``span("dispatch")`` records under ``round`` and ``round/dispatch``.
    """

    __slots__ = ("_tele", "_name", "_t0", "_path")

    def __init__(self, tele: "Telemetry", name: str):
        self._tele = tele
        self._name = name
        self._t0 = 0.0
        self._path = name

    def __enter__(self) -> "_SpanContext":
        stack = self._tele._span_stack()
        self._path = (stack[-1] + "/" + self._name) if stack else self._name
        stack.append(self._path)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        stack = self._tele._span_stack()
        if stack and stack[-1] == self._path:
            stack.pop()
        self._tele.histogram(self._path).observe(dt)
        return None


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NOOP_SPAN = _NoopSpan()


class _NoopMetric:
    """Shared do-nothing stand-in for Counter/Gauge/Histogram when disabled."""

    __slots__ = ()
    name = "noop"
    value = 0.0
    count = 0
    total = 0.0

    def add(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def quantile(self, q: float) -> float:
        return 0.0

    def snapshot(self):
        return {}


_NOOP_METRIC = _NoopMetric()


#: optional observer of every recorded event (the tracing flight ring
#: registers here at import) — a plain callable taking the event dict.
#: Core stays import-clean: it never imports tracing; tracing plugs in.
_EVENT_TAP = None


def set_event_tap(tap) -> None:
    """Install (or clear, with None) the process-wide event observer."""
    global _EVENT_TAP
    _EVENT_TAP = tap


class Telemetry:
    """Per-process metric registry: named spans, counters, gauges, histograms.

    ``enabled=False`` (or env ``DKTPU_TELEMETRY=0`` for the ambient registry)
    turns every accessor into a no-op — instrumented code needs no branches.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._events: list[dict] = []

    # -- span nesting ------------------------------------------------------
    def _span_stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str):
        """Timed context manager; nested spans record under ``parent/child``."""
        if not self.enabled:
            return _NOOP_SPAN
        return _SpanContext(self, name)

    # -- metric accessors (create-on-first-use) ----------------------------
    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NOOP_METRIC
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NOOP_METRIC
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str) -> Histogram:
        if not self.enabled:
            return _NOOP_METRIC
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name))
        return h

    def event(self, kind: str, fields: Optional[dict] = None) -> None:
        """Record a discrete event (kept in memory; written by the JSONL
        exporter). Use sparingly — one per round is fine, one per sample is
        not."""
        if not self.enabled:
            return
        rec = {"kind": kind, "ts": time.time()}
        # Ambient attribution labels ride under the explicit fields: an
        # event fired inside a fleet worker scope names its tenant/job
        # without the call site knowing the scope exists.
        rec.update(current_labels())
        if fields:
            rec.update(fields)
        with self._lock:
            self._events.append(rec)
        tap = _EVENT_TAP
        if tap is not None:
            tap(rec)

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """One JSON-serializable summary of every aggregate."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {n: c.snapshot() for n, c in counters.items()},
            "gauges": {n: g.snapshot() for n, g in gauges.items()},
            "spans": {n: h.snapshot() for n, h in hists.items()},
        }

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    # -- windows (per-run accounting on the shared registry) ----------------
    def mark(self) -> dict:
        """Opaque position marker for :meth:`delta` — take one at run start
        to report only that run's activity from the process-global registry
        (sequential trainer runs share it; without a window, run 2's dump
        would re-attribute run 1's counters, spans, and events)."""
        with self._lock:
            n_events = len(self._events)
        return {"snapshot": self.snapshot(), "events": n_events}

    def delta(self, mark: dict) -> tuple[dict, list]:
        """(summary, events) accumulated since ``mark``.

        Counters and histogram count/total/buckets subtract exactly; a
        window has no well-defined min/max, so histogram deltas carry
        count/total/mean/buckets only. Gauges are level signals — the
        current snapshot is reported for any gauge touched in the window.
        """
        before = mark["snapshot"]
        after = self.snapshot()
        counters = {}
        for name, v in after["counters"].items():
            dv = v - before["counters"].get(name, 0.0)
            if dv:
                counters[name] = dv
        gauges = {
            name: g for name, g in after["gauges"].items()
            if g.get("count", 0) > before["gauges"].get(name, {}).get(
                "count", 0)
        }
        spans = {}
        for name, h in after["spans"].items():
            prev = before["spans"].get(name,
                                       {"count": 0, "total": 0.0,
                                        "buckets": []})
            dc = h["count"] - prev["count"]
            if dc <= 0:
                continue
            dt = h["total"] - prev["total"]
            pb = prev["buckets"] or [0] * len(h["buckets"])
            spans[name] = {
                "count": dc,
                "total": dt,
                "mean": dt / dc,
                "buckets": [a - b for a, b in zip(h["buckets"], pb)],
            }
        with self._lock:
            events = list(self._events[mark["events"]:])
        return ({"counters": counters, "gauges": gauges, "spans": spans},
                events)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._events.clear()


# -- ambient (process-global) registry ------------------------------------
_GLOBAL: Optional[Telemetry] = None
_GLOBAL_LOCK = threading.Lock()


def enabled() -> bool:
    from distkeras_tpu_torch.runtime import config

    return config.env_bool("DKTPU_TELEMETRY")


def get() -> Telemetry:
    """The process-global registry (respects ``DKTPU_TELEMETRY=0``)."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = Telemetry(enabled=enabled())
    return _GLOBAL


def reset() -> None:
    """Clear the global registry (tests; between bench configs)."""
    get().reset()
