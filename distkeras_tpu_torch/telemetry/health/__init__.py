"""Fleet health plane: live SLO monitoring, burn-rate alerting, sentinels.

The observability layer ISSUE 15 adds on top of the per-process telemetry
core (PR 1) and the forensic tracing/flight plane (PR 14): something that
watches a *running* fleet and decides — before a chaos smoke would have
caught it post-hoc — that a tenant's serving p99 is burning its SLO, that
a shard's journal writer is falling behind, or that a registered process
has gone silent. Four pieces:

* :class:`~distkeras_tpu_torch.telemetry.health.hub.MetricsHub` — a lightweight
  aggregation loop scraping every registered process over the
  membership-free ``stats`` op, keeping bounded in-memory time-series
  rings per metric (gauges + counter-derived rates + span histograms)
  with per-target NTP-style clock-offset estimates;
* :class:`~distkeras_tpu_torch.telemetry.health.slo.SloEngine` — declarative
  SLO specs (JSON file or inline via ``DKTPU_HEALTH_SLO``) evaluated
  with multi-window burn-rate rules (fast + slow window), emitting typed
  ``health_alert`` / ``health_clear`` telemetry events and triggering a
  flight-recorder dump on page-severity alerts;
* :mod:`~distkeras_tpu_torch.telemetry.health.sentinels` — anomaly detectors
  computed from the hub's rings (straggler drift, staleness creep,
  queue-depth growth, journal lag, shed spikes, silent targets, bench
  regression against BENCH_PIN/BENCH_SUMMARY bands);
* the CLIs — ``python -m distkeras_tpu_torch.telemetry health`` (one-shot
  fleet summary) and ``... telemetry top`` (live refreshing view).

Everything stays stdlib-only and importable wherever the telemetry core
is. See docs/OBSERVABILITY.md ("Health & SLOs").
"""

from __future__ import annotations

from distkeras_tpu_torch.telemetry.health.hub import (
    MetricsHub,
    TargetState,
    env_targets,
    parse_targets,
    register_target,
    registered_targets,
    unregister_target,
)
from distkeras_tpu_torch.telemetry.health.sentinels import Sentinels
from distkeras_tpu_torch.telemetry.health.slo import (
    AlertManager,
    SloEngine,
    SloSpec,
    parse_slo_specs,
)

__all__ = [
    "MetricsHub", "TargetState",
    "register_target", "unregister_target", "registered_targets",
    "parse_targets", "env_targets",
    "AlertManager", "SloEngine", "SloSpec", "parse_slo_specs",
    "Sentinels",
]
