"""Resilience exception taxonomy (the port's copy of the JAX package's
``resilience/errors.py``: the base class the serving and wire errors
derive from, the fault plan's injected fault, the input pipeline's stall
error and the checkpoint integrity error).

Every failure the subsystem *detects* (as opposed to merely propagates) is
raised as a subclass of :class:`ResilienceError`, so callers and tests
match on type instead of message strings.
"""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class for every resilience-layer failure."""


class InjectedFault(ResilienceError):
    """A fault deliberately injected by a :class:`~distkeras_tpu_torch.
    resilience.faults.FaultPlan` — raised so the recovery path under test
    sees a real exception, and so accidental production use of
    ``DKTPU_FAULTS`` is unmistakable in a traceback."""


class FeederStalledError(ResilienceError):
    """The input pipeline produced nothing for longer than the watchdog
    timeout — the run loop declares the data plane dead rather than hanging
    forever on an empty queue."""


class CheckpointCorruptError(ResilienceError):
    """A checkpoint step's restored content does not match its integrity
    digest sidecar (bit rot, a torn write, or injected corruption)."""
