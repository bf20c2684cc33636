"""Endpoint-walk/failover mechanics for every wire client (the port's copy
of the JAX package's ``netps/endpoints.py``).

* **split** — :func:`~distkeras_tpu_torch.netps.wire.split_endpoints`
  order: primary first, then the rest;
* **walk order** — :meth:`EndpointWalker.walk` is a CAS advance (N threads
  failing together move ONE step, not N); :meth:`EndpointWalker.advance`
  is the unconditional single-threaded form ``ServeClient`` uses. Both run
  the caller's teardown callback under the walker's lock so connection
  state can never straddle two endpoints;
* **patience window** — :meth:`EndpointWalker.patience`: with several
  endpoints the retry budget must bridge lease lapse + promotion (~2x the
  lease) plus one RPC deadline; :func:`budget_left` is the loop guard that
  honors it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.runtime import config


class EndpointWalker:
    """Ordered failover traversal of a ``"host:port[,host:port...]"``
    endpoint list. ``lock`` lets a caller share its own serialization
    domain; by default the walker owns a private lock."""

    def __init__(self, endpoint: str,
                 lock: Optional[threading.Lock] = None):
        #: ordered (host, port) list — primary first, then the rest.
        self.endpoints = wire.split_endpoints(endpoint)
        self._idx = 0
        self._lock = lock if lock is not None else threading.Lock()

    def __len__(self) -> int:
        return len(self.endpoints)

    @property
    def index(self) -> int:
        """The current position (monotonic under :meth:`advance`)."""
        return self._idx

    def current(self) -> tuple:
        return self.endpoints[self._idx % len(self.endpoints)]

    def walk(self, seen_idx: int,
             on_walk: Optional[Callable[[], None]] = None) -> bool:
        """CAS advance past a failure observed against ``seen_idx``: of N
        threads failing together exactly one wins and moves ONE step. The
        winner's ``on_walk`` teardown runs under the lock. Single-endpoint
        walkers never walk. Returns whether THIS call advanced."""
        if len(self.endpoints) <= 1:
            return False
        with self._lock:
            walked = self._idx == seen_idx
            if walked:
                self._idx = (seen_idx + 1) % len(self.endpoints)
                if on_walk is not None:
                    on_walk()
        return walked

    def reorder(self, order: list,
                on_walk: Optional[Callable[[], None]] = None) -> None:
        """Adopt a new traversal order (health-aware clients float ready
        replicas to the front) and restart from its head. Must be a
        permutation — reordering may deprioritize an endpoint, never
        forget one."""
        if sorted(order) != sorted(self.endpoints):
            raise ValueError("reorder() needs a permutation of the "
                             "walker's endpoints")
        with self._lock:
            self.endpoints = list(order)
            self._idx = 0
            if on_walk is not None:
                on_walk()

    def advance(self, on_walk: Optional[Callable[[], None]] = None) -> None:
        """Unconditional advance — the single-threaded client form (one
        request in flight, every failure is ours)."""
        with self._lock:
            self._idx += 1
            if on_walk is not None:
                on_walk()

    def patience(self, lease_s: Optional[float],
                 timeout: float) -> Optional[float]:
        """Monotonic deadline a multi-endpoint retry loop keeps walking
        until: 2x the lease plus one RPC deadline. ``None`` for a single
        endpoint — the strict attempt budget applies."""
        if len(self.endpoints) <= 1:
            return None
        lease = lease_s if lease_s else config.env_float("DKTPU_PS_LEASE")
        return time.monotonic() + 2.0 * float(lease or 0.0) + float(timeout)


def budget_left(attempt: int, attempts: int,
                patience: Optional[float]) -> bool:
    """May the retry loop go around again? The attempt budget, OR — when a
    patience window is set (multi-endpoint) — wall-clock inside it."""
    if attempt + 1 < attempts:
        return True
    return patience is not None and time.monotonic() < patience
