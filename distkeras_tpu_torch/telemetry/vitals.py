"""Process-vitals sampler: periodic runtime gauges feeding the hub (the
port's copy of ``distkeras_tpu/telemetry/vitals.py``, reading the card).

A tiny background thread that samples, every ``DKTPU_VITALS_S`` seconds:

* ``runtime.rss_mb`` — resident set size (``/proc/self/status`` VmRSS,
  falling back to ``resource.getrusage`` off Linux);
* ``runtime.open_fds`` — open file descriptors (``/proc/self/fd``);
* ``device.bytes_in_use`` — the card's memory held by this process's
  tensors (``torch.cuda.memory_allocated()``), only when torch is already
  imported *and* this process has initialized CUDA. The sampler never
  imports torch and never initializes CUDA itself: a process that never
  touched the card reports no device gauge at all, and no CPU number is
  ever reported as the device's.

The gauges land in the ordinary telemetry registry, so they ride the
stats op for free and the health plane's ``MetricsHub`` picks them up on
the next scrape. Behind the master telemetry kill-switch: with
``DKTPU_TELEMETRY=0`` or a zero interval, :func:`start_vitals` is a
no-op.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Optional

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.runtime.config import env_float


def sample_vitals() -> dict:
    """One vitals sample, also written to the telemetry gauges. Split
    out from the loop so tests (and curious callers) can sample
    synchronously."""
    out = {}
    rss = _rss_mb()
    if rss is not None:
        telemetry.gauge("runtime.rss_mb").set(rss)
        out["runtime.rss_mb"] = rss
    fds = _open_fds()
    if fds is not None:
        telemetry.gauge("runtime.open_fds").set(float(fds))
        out["runtime.open_fds"] = float(fds)
    dev = _device_bytes_in_use()
    if dev is not None:
        telemetry.gauge("device.bytes_in_use").set(float(dev))
        out["device.bytes_in_use"] = float(dev)
    return out


def _rss_mb() -> Optional[float]:
    try:
        with open("/proc/self/status", "r", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0  # kB -> MiB
    except OSError:
        pass
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # Linux reports kB, macOS bytes; either way it's a usable gauge.
        return ru / 1024.0 if sys.platform.startswith("linux") else \
            ru / (1024.0 * 1024.0)
    except Exception:
        return None


def _open_fds() -> Optional[int]:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


def _device_bytes_in_use() -> Optional[int]:
    torch = sys.modules.get("torch")
    if torch is None:  # vitals never forces the torch import
        return None
    try:
        # is_initialized() reads a flag; is_available() or device_count()
        # could start the driver in a process that never asked for the card.
        if not torch.cuda.is_initialized():
            return None
        return int(torch.cuda.memory_allocated())
    except Exception:
        return None


_lock = threading.Lock()
_thread: Optional[threading.Thread] = None
_stop: Optional[threading.Event] = None


def start_vitals(interval_s: Optional[float] = None) -> bool:
    """Start the sampler if telemetry is on and the interval is > 0
    (default from ``DKTPU_VITALS_S``). Idempotent; returns whether a
    sampler is running after the call."""
    global _thread, _stop
    interval = (env_float("DKTPU_VITALS_S") if interval_s is None
                else float(interval_s))
    if not telemetry.enabled() or not interval or interval <= 0:
        return False
    with _lock:
        if _thread is not None and _thread.is_alive():
            return True
        stop = threading.Event()

        def run() -> None:
            while not stop.is_set():
                try:
                    sample_vitals()
                except Exception:
                    pass
                stop.wait(interval)

        _stop = stop
        _thread = threading.Thread(target=run, name="dktpu-vitals",
                                   daemon=True)
        _thread.start()
    return True


def stop_vitals() -> None:
    global _thread, _stop
    with _lock:
        thread, stop = _thread, _stop
        _thread = _stop = None
    if stop is not None:
        stop.set()
    if thread is not None:
        thread.join(timeout=5.0)
