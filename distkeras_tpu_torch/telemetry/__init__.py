"""Telemetry of the port (the JAX package's ``telemetry/``, copied): spans,
counters, gauges and histograms in one process-wide registry
(``DKTPU_TELEMETRY=0`` turns every call into a no-op), the JSONL and
Prometheus exporters (``exporters.py``), the training monitor
(``training.py``), distributed tracing and the flight recorder
(``tracing/``), process vitals (``vitals.py``), the health plane
(``health/``), the metric-name registry (``registry.py``) and the report
CLI (``report.py``).

Usage::

    from distkeras_tpu_torch import telemetry

    with telemetry.span("dispatch"):
        ...                                   # nested spans -> "a/b" paths
    telemetry.counter("serving.batches").add(1)

    telemetry.write_jsonl(telemetry.get(), "run.jsonl")   # append-only JSONL
    print(telemetry.prometheus_text(telemetry.get()))     # Prometheus dump

Render a report with ``python -m distkeras_tpu_torch.telemetry report
run.jsonl`` (``--trace <dir>`` for the distributed-trace report).
"""

from __future__ import annotations

from distkeras_tpu_torch.telemetry.core import (
    Counter,
    Gauge,
    Histogram,
    Telemetry,
    current_labels,
    enabled,
    get,
    label_suffix,
    reset,
    sanitize_label,
    scoped_labels,
)
from distkeras_tpu_torch.telemetry.exporters import (
    parse_prometheus,
    prometheus_text,
    read_jsonl,
    write_jsonl,
)
from distkeras_tpu_torch.telemetry.training import (
    DisciplineMonitor,
    dynsgd_scales,
    flag_stragglers,
    staleness_schedule,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "Telemetry",
    "enabled", "get", "reset",
    "span", "counter", "gauge", "histogram", "event",
    "scoped_labels", "current_labels", "label_suffix", "sanitize_label",
    "write_jsonl", "read_jsonl", "prometheus_text", "parse_prometheus",
    "DisciplineMonitor", "flag_stragglers", "staleness_schedule",
    "dynsgd_scales",
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
