"""Typed failure taxonomy of the online serving plane (the port's copy of
the JAX package's ``serving/errors.py``).

Every way an inference RPC can fail is one of these, carried on the wire
as a typed ``error`` kind in the reply header, so clients and tests match
on type — never on message strings. The kinds are the JAX package's, so a
client of either package reads the other's errors.

The admission contract these types encode:

* a request the frontend cannot take is **shed before it is accepted** —
  :class:`OverloadedError` is the reply, and nothing of the request is
  queued;
* an **accepted** request is *never* silently dropped — it is answered
  with a result, or with :class:`DeadlineExceededError` (it aged past its
  deadline in the queue) or :class:`ModelUnavailableError` (the frontend
  shut down / has no warmed model) — a typed reply either way.
"""

from __future__ import annotations

from distkeras_tpu_torch.resilience.errors import ResilienceError


class ServingError(ResilienceError):
    """Base class for every serving-plane failure."""


class OverloadedError(ServingError):
    """Admission control shed this request BEFORE accepting it: the queue
    bound (``DKTPU_SERVE_QUEUE`` rows) would be exceeded, or the request is
    larger than the largest batch bucket. Nothing was queued; retrying
    later or against another replica is safe."""


class DeadlineExceededError(ServingError):
    """An *accepted* request aged past ``DKTPU_SERVE_DEADLINE_MS`` while
    queued, so the frontend answered it with this instead of computing a
    result nobody is waiting for."""


class ModelUnavailableError(ServingError):
    """The frontend has no model to answer with: the registry holds
    nothing warmed yet, or the frontend is shutting down and is answering
    its queue out with typed replies rather than dropping it."""


#: wire ``error`` kinds <-> exception types (the reply-header vocabulary;
#: the client's inverse map lives in ``serving/frontend.py``).
ERROR_KINDS = {
    OverloadedError: "overloaded",
    DeadlineExceededError: "deadline",
    ModelUnavailableError: "unavailable",
}


def error_kind(exc: BaseException) -> str:
    """The wire kind for ``exc`` (``"serving"`` for the generic base)."""
    return ERROR_KINDS.get(type(exc), "serving")
