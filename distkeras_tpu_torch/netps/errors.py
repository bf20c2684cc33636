"""Typed failure taxonomy of the wire transport and the parameter server
(the port's copy of the JAX package's ``netps/errors.py``; the sharding
error comes with that slice).

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


class EpochFencedError(NetPSError):
    """The commit carried a primary epoch the server no longer honors: a
    standby promoted and fenced the old lineage (stale client epoch), or
    this server itself was fenced by a higher epoch (it is the zombie).
    The hardened client reacts like an eviction — re-join (walking the
    endpoint list to the promoted primary), adopt the new epoch, discard
    the stale window. Never folded: the whole point is zero stale-epoch
    folds after a failover."""


class ShardPlanError(ProtocolError):
    """A sharded-center plan violation: a peer without the ``sharding``
    capability joined a shard server, a join carried no partition plan, or
    the joiner's plan hash does not match the shard set's. A
    :class:`ProtocolError` the server answers typed at join time (never
    retried), so a mismatched or plan-unaware client can never fold a
    partial plan silently."""


class NotPrimaryError(NetPSError):
    """The peer answered but is not the primary: a warm standby that has
    not (yet) promoted, or a fenced ex-primary. Retryable *by walking the
    endpoint list* — the same RPC against the next endpoint (or this one
    after promotion) can succeed, so the client treats it like a transport
    failure rather than a terminal rejection."""


class ServerClosedError(NetPSError):
    """A parameter-server client was used after ``close()``. Worker threads
    blocked on it must exit, not commit into a dead center forever."""
