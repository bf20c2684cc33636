"""The claim queue, generalized: bounded schedules AND open-ended streams
(the port's copy of the JAX package's ``streaming/items.py``).

:class:`~distkeras_tpu_torch.fleet.run.ElasticTraining` introduced the claim
queue for a *fixed* ``num_rounds x W`` work set — item identity was an
integer and "done" was a count. A live stream has neither: items arrive
forever (or until the feed says otherwise) and the only invariant is
that every *admitted* item is eventually committed exactly once. This
class carries both shapes so the elastic runtime and the streaming
runtime share one claim/requeue/commit discipline (and its tests; the
port's streaming runtime is a later slice):

* ``WorkQueue(total=N)`` — the bounded mode: items are the ordinals
  ``0..N-1``, claimed retry-first then frontier, exactly the original
  ElasticTraining bookkeeping.
* ``WorkQueue(max_pending=M)`` — the open mode: arbitrary items are
  :meth:`put` by a reader thread (blocking at ``M`` pending — the
  backpressure that keeps a fast feed from ballooning host memory),
  ``close_intake()`` marks end-of-stream, and ``done()`` means intake
  closed + nothing pending + nothing in flight.

In both modes :meth:`claim` blocks politely while other claimants are
still in flight: an item they requeue (eviction, lease lapse) must find
a worker, not a drained pool.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional


class WorkQueue:
    """Claim/requeue/commit bookkeeping shared by the elastic (bounded)
    and streaming (open-ended) runtimes. Thread-safe."""

    def __init__(self, total: Optional[int] = None,
                 max_pending: int = 64):
        self.total = total
        self.max_pending = max(1, int(max_pending))
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._retry: collections.deque = collections.deque()
        #: open mode: admitted-but-unclaimed items.
        self._pending: collections.deque = collections.deque()
        #: bounded mode: the frontier ordinal.
        self._next = 0
        self._inflight = 0
        self.committed = 0
        self._intake_closed = total is not None

    # -- producer side (open mode) ------------------------------------------

    def put(self, item, should_stop=None) -> bool:
        """Admit one item, blocking while ``max_pending`` are already
        waiting (backpressure on the reader). Returns False when
        ``should_stop()`` went true (or intake closed) before admission."""
        if self.total is not None:
            raise RuntimeError("put() is for open-ended queues; "
                               "bounded queues own their ordinals")
        with self._not_full:
            while len(self._pending) >= self.max_pending:
                if self._intake_closed or (should_stop and should_stop()):
                    return False
                self._not_full.wait(0.05)
            if self._intake_closed:
                return False
            self._pending.append(item)
            return True

    def close_intake(self) -> None:
        """No more items will arrive (end-of-stream, or shutdown)."""
        with self._not_full:
            self._intake_closed = True
            self._not_full.notify_all()

    # -- worker side ---------------------------------------------------------

    def claim(self, should_run):
        """The next work item: retries first, then fresh. Blocks while
        peers' claims are in flight (their requeue must find a taker);
        returns None when the work set is exhausted or ``should_run()``
        goes false."""
        while should_run():
            with self._lock:
                if self._retry:
                    self._inflight += 1
                    return self._retry.popleft()
                if self.total is not None:
                    if self._next < self.total:
                        i = self._next
                        self._next += 1
                        self._inflight += 1
                        return i
                    if self.committed >= self.total:
                        return None
                else:
                    if self._pending:
                        item = self._pending.popleft()
                        self._inflight += 1
                        self._not_full.notify_all()
                        return item
                    if self._intake_closed and self._inflight == 0:
                        return None
            time.sleep(0.01)
        return None

    def requeue(self, item) -> None:
        """Return a claimed-but-uncommitted item (eviction, crash unwind)
        for whichever claimant comes next."""
        with self._lock:
            self._inflight -= 1
            self._retry.append(item)

    def commit_one(self) -> None:
        with self._lock:
            self._inflight -= 1
            self.committed += 1

    def abandon(self, item=None) -> None:
        """Drop a claimed item permanently (shutdown paths that must not
        leave ``_inflight`` pinned)."""
        with self._lock:
            self._inflight -= 1

    # -- queries -------------------------------------------------------------

    def done(self) -> bool:
        with self._lock:
            if self.total is not None:
                return self.committed >= self.total
            return (self._intake_closed and not self._pending
                    and not self._retry and self._inflight == 0)

    def pending_count(self) -> int:
        with self._lock:
            if self.total is not None:
                return (self.total - self.committed)
            return len(self._pending) + len(self._retry) + self._inflight

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight
