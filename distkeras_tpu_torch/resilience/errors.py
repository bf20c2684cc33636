"""Resilience exception taxonomy (the port's copy of the JAX package's
``resilience/errors.py``, holding the base class the serving and wire
errors derive from, the input pipeline's stall error and the
checkpoint integrity error; the fault-injection errors come with the
slice that raises them).

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


class CheckpointCorruptError(ResilienceError):
    """A checkpoint step's restored content does not match its integrity
    digest sidecar (bit rot, a torn write, or injected corruption)."""
