"""NTP-style clock-offset estimation over the existing RPC round trips.

Cross-process trace alignment needs every stream on one clock. Rather
than a daemon, the estimate piggybacks on frames already flying: a traced
client stamps ``ct0`` (its wall clock) onto join/heartbeat requests; the
server echoes it back with ``st1`` (request receive) and ``st2`` (reply
build) — the four-timestamp exchange::

    offset = ((st1 - ct0) + (st2 - ct3)) / 2        # server - client
    rtt    = (ct3 - ct0) - (st2 - st1)

where ``ct3`` is the client's receive time. The estimate with the
SMALLEST observed rtt wins (asymmetric queuing corrupts high-rtt
samples; the min-rtt sample bounds the error by rtt/2). Each improvement
re-stamps the process's trace stream with a fresh ``process_info``
record, so the collector aligns with the best estimate the process ever
had. The fields ride only on requests that already carried ``ct0``, so a
peer without ``CAPS["tracing"]`` sees zero new bytes in either direction.

The offset is *this process -> its (primary) server peer*; server
processes never stamp ``ct0`` and keep offset 0.0 — the PS is the fleet's
reference clock, which is exactly what the commit critical path needs
(every segment either happens on the PS or is measured against it).
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()
#: best estimate so far: offset (server - client, seconds) at min rtt.
_EST: dict = {"offset": 0.0, "rtt": None}


def observe(ct0: float, st1: float, st2: float, ct3: float) -> None:
    """Fold one four-timestamp exchange into the estimate."""
    rtt = (ct3 - ct0) - (st2 - st1)
    offset = ((st1 - ct0) + (st2 - ct3)) / 2.0
    improved = False
    with _LOCK:
        best = _EST["rtt"]
        if best is None or rtt < best:
            _EST["offset"] = offset
            _EST["rtt"] = max(rtt, 0.0)
            improved = True
    if improved:
        from distkeras_tpu_torch.telemetry.tracing import context

        context.refresh_process_info()


def observe_reply(ct0: float, reply: dict, ct3: float) -> None:
    """Client convenience: feed a reply header's ``st1``/``st2`` echo (a
    no-op when the server did not answer the exchange)."""
    st1, st2 = reply.get("st1"), reply.get("st2")
    if st1 is None or st2 is None:
        return
    try:
        observe(float(ct0), float(st1), float(st2), float(ct3))
    except (TypeError, ValueError):
        return


def offset() -> float:
    """Best current offset estimate (seconds to ADD to this process's
    wall-clock timestamps to land on the reference clock)."""
    return _EST["offset"]


def rtt():
    """The rtt of the winning sample (None = no exchange yet)."""
    return _EST["rtt"]


def reset() -> None:
    """Tests only."""
    with _LOCK:
        _EST["offset"] = 0.0
        _EST["rtt"] = None
