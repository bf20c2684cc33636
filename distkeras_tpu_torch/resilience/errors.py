"""Resilience exception taxonomy (the port's copy of the JAX package's
``resilience/errors.py``, holding the base class the serving and wire
errors derive from; the fault-injection and checkpoint errors come with
the slices that raise them).

Every failure the subsystem *detects* (as opposed to merely propagates) is
raised as a subclass of :class:`ResilienceError`, so callers and tests
match on type instead of message strings.
"""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class for every resilience-layer failure."""
