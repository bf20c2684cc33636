"""Fleet-wide distributed tracing: context, clocks, flight ring, collector.

The observability layer ISSUE 14 adds on top of the per-process telemetry
core: one commit (or one served request) becomes one *trace* whose spans
span processes — worker encode, wire, queue-behind-fold, fold, fsync,
standby replication — stitched by ``(trace, parent)`` ids carried in wire
headers behind ``CAPS["tracing"]`` and aligned onto one clock by the
NTP-style exchange piggybacked on join/heartbeat. See
docs/OBSERVABILITY.md ("Distributed tracing") for the model; render the
analysis with ``python -m distkeras_tpu_torch.telemetry report --trace <dir>``.

Everything is gated on ``DKTPU_TRACE`` (default off: no ids, no extra
wire bytes, no span records) and stays stdlib-only — importable wherever
the telemetry core is.
"""

from __future__ import annotations

from distkeras_tpu_torch.telemetry.tracing import clock
from distkeras_tpu_torch.telemetry.tracing.analysis import (render_trace_report,
                                                      trace_report)
from distkeras_tpu_torch.telemetry.tracing.collector import (TelemetryCollector,
                                                       generations)
from distkeras_tpu_torch.telemetry.tracing.context import (
    PROCESS_INFO_KIND,
    SPAN_KIND,
    TraceContext,
    adopt,
    boot_id,
    child_scope,
    current,
    emit,
    enabled,
    header_ctx,
    new_id,
    process_info_record,
    record_span,
    role,
    set_role,
    trace_dir,
    trace_scope,
    wire_fields,
)
from distkeras_tpu_torch.telemetry.tracing.recorder import (
    FlightRecorder,
    flight_dump,
    get_ring,
    install_crash_hooks,
    ring_head,
)

__all__ = [
    "SPAN_KIND", "PROCESS_INFO_KIND", "TraceContext",
    "enabled", "current", "new_id", "trace_scope", "child_scope", "adopt",
    "emit", "record_span", "wire_fields", "header_ctx",
    "role", "set_role", "boot_id", "trace_dir", "process_info_record",
    "FlightRecorder", "get_ring", "ring_head", "flight_dump",
    "install_crash_hooks",
    "TelemetryCollector", "generations",
    "trace_report", "render_trace_report",
    "clock",
]

# The flight ring is fed through the telemetry core's event tap: every
# event (trace spans included — they ride the event stream) lands in the
# ring when tracing is on, with no second call site in instrumented code.
from distkeras_tpu_torch.telemetry import core as _core  # noqa: E402
from distkeras_tpu_torch.telemetry.tracing import recorder as _recorder  # noqa: E402

_core.set_event_tap(_recorder._tap)
