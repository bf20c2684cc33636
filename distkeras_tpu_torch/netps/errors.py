"""Typed failure taxonomy of the wire transport and the parameter server
(the port's copy of the JAX package's ``netps/errors.py``; the failover and
sharding errors come with those slices).

Every way an RPC over the wire can fail is one of these, so callers and
tests match on type — never on message strings.
"""

from __future__ import annotations

from distkeras_tpu_torch.resilience.errors import ResilienceError


class NetPSError(ResilienceError):
    """Base class for every wire-transport failure."""


class ProtocolError(NetPSError):
    """A frame violated the wire contract: bad magic, unsupported version,
    checksum mismatch, oversized length, or a truncated body. The receiving
    side must tear the connection down — after a framing error the byte
    stream can never be trusted to re-align."""


class RPCTimeoutError(NetPSError):
    """An RPC exhausted its deadline *and* its retry budget. Carries the
    number of attempts made so callers (and tests) can see the budget was
    really spent, not skipped."""

    def __init__(self, message: str, attempts: int = 0):
        super().__init__(message)
        self.attempts = attempts


class ServerDrainingError(NetPSError):
    """The server is draining (``close()`` was called): it no longer accepts
    commits. Deliberately **not retryable** — a draining server never comes
    back, so the client surfaces this to the worker loop immediately."""


class LeaseExpiredError(NetPSError):
    """The server evicted this worker (its lease expired) before the RPC
    arrived. The hardened client reacts by re-joining; the worker loop
    discards the in-flight window and continues from a fresh pull."""


class ServerClosedError(NetPSError):
    """A parameter-server client was used after ``close()``. Worker threads
    blocked on it must exit, not commit into a dead center forever."""
