"""Resilience exception taxonomy (the port's copy of the JAX package's
``resilience/errors.py``, holding the base class the serving and wire
errors derive from, and the input pipeline's stall error; the
fault-injection and checkpoint errors come with the slices that raise
them).

Every failure the subsystem *detects* (as opposed to merely propagates) is
raised as a subclass of :class:`ResilienceError`, so callers and tests
match on type instead of message strings.
"""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class for every resilience-layer failure."""


class FeederStalledError(ResilienceError):
    """The input pipeline produced nothing for longer than the watchdog
    timeout — the run loop declares the data plane dead rather than hanging
    forever on an empty queue."""
