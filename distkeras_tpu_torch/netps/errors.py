"""Typed failure taxonomy of the wire transport (the port's copy of the JAX
package's ``netps/errors.py``).

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
