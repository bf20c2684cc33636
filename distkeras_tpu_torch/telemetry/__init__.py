"""Telemetry of the port: spans, counters, gauges and histograms in one
process-wide registry (``DKTPU_TELEMETRY=0`` turns every call into a
no-op), the JSONL exporter (``exporters.py``) and the training monitor
(``training.py``). Distributed tracing, vitals, Prometheus and the report
CLI come with a later slice.

Usage::

    from distkeras_tpu_torch import telemetry

    with telemetry.span("dispatch"):
        ...
    telemetry.counter("serving.batches").add(1)
"""

from __future__ import annotations

from distkeras_tpu_torch.telemetry.core import (
    Counter,
    Gauge,
    Histogram,
    Telemetry,
    get,
    reset,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "Telemetry", "get", "reset",
    "span", "counter", "gauge", "histogram", "event",
]


# -- module-level shorthands routing to the ambient registry ---------------
def span(name: str):
    return get().span(name)


def counter(name: str):
    return get().counter(name)


def gauge(name: str):
    return get().gauge(name)


def histogram(name: str):
    return get().histogram(name)


def event(kind: str, fields=None):
    return get().event(kind, fields)
