"""Continuous micro-batching with admission control (the port's copy of the
JAX package's ``serving/batcher.py``).

The frontend's handler threads each carry ONE in-flight request; this
module is where those concurrent requests meet. A handler *submits* its
request (admission control happens right there — a request that would
overflow the queue bound is shed with :class:`OverloadedError` before any
of it is queued) and blocks on the request's event; the dispatch thread
*collects* whatever is queued, waits up to the latency budget
(``DKTPU_SERVE_MAX_WAIT_MS``) for stragglers to coalesce, and hands one
batch to the model. The batch is capped at the largest shape bucket
(``DKTPU_SERVE_BUCKETS``) so padding — done by the model wrapper, not
here — always lands on a warmed shape.

Accounting contract: every request either fails admission with a typed
error and is never queued, or is accepted and later answered — with a
result, a :class:`DeadlineExceededError` (it aged past
``DKTPU_SERVE_DEADLINE_MS`` while queued), or a
:class:`ModelUnavailableError` (the batcher closed under it). There is no
path on which an accepted request is dropped without a reply.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.serving.errors import (
    DeadlineExceededError,
    ModelUnavailableError,
    OverloadedError,
)


def parse_buckets(spec: Optional[str] = None) -> tuple[int, ...]:
    """``DKTPU_SERVE_BUCKETS`` -> strictly-increasing positive batch sizes
    (one warmed forward shape per bucket; the last one is the per-batch
    row cap)."""
    spec = config.env_str("DKTPU_SERVE_BUCKETS") if spec is None else spec
    try:
        buckets = tuple(int(b.strip()) for b in spec.split(",") if b.strip())
    except ValueError as e:
        raise ValueError(f"malformed DKTPU_SERVE_BUCKETS {spec!r}: {e}") from e
    if not buckets:
        raise ValueError(f"no buckets in DKTPU_SERVE_BUCKETS {spec!r}")
    if any(b <= 0 for b in buckets) or list(buckets) != sorted(set(buckets)):
        raise ValueError(
            f"DKTPU_SERVE_BUCKETS must be strictly-increasing positive "
            f"sizes, got {spec!r}")
    return buckets


def bucket_for(rows: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket that fits ``rows`` (None when even the largest is
    too small — the admission-time size rejection)."""
    for b in buckets:
        if rows <= b:
            return b
    return None


class PendingRequest:
    """One accepted request riding through the batcher: its input arrays,
    its admission timestamp (the latency span origin), and the event its
    handler thread blocks on until ``result``/``error`` is set."""

    __slots__ = ("arrays", "rows", "admitted_at", "admitted_wall", "trace",
                 "deadline_at", "event", "result", "error", "version")

    def __init__(self, arrays: Sequence, rows: int,
                 deadline_s: Optional[float] = None):
        self.arrays = tuple(arrays)
        self.rows = int(rows)
        self.admitted_at = time.monotonic()
        #: wall-clock twin of ``admitted_at``: trace spans are stamped in
        #: wall time so the collector can align them across processes.
        self.admitted_wall = time.time()
        #: the request's :class:`~distkeras_tpu_torch.telemetry.tracing.
        #: TraceContext` (set by the frontend when the wire header carried
        #: one); the dispatch thread emits its queue and batch spans under
        #: it.
        self.trace = None
        self.deadline_at = (self.admitted_at + deadline_s
                            if deadline_s is not None else None)
        self.event = threading.Event()
        self.result = None      # per-request output arrays on success
        self.error: Optional[BaseException] = None
        self.version = None     # model version that answered

    def answer(self, result=None, error: Optional[BaseException] = None,
               version=None) -> None:
        self.result = result
        self.error = error
        self.version = version
        self.event.set()


class MicroBatcher:
    """Bounded FIFO of :class:`PendingRequest` with the shed-before-accept
    admission check at ``submit`` and the coalescing wait in ``collect``."""

    def __init__(self, buckets: Sequence[int],
                 max_queue_rows: Optional[int] = None,
                 max_wait_s: Optional[float] = None,
                 deadline_s: Optional[float] = None):
        self.buckets = tuple(buckets)
        self.max_rows = int(config.env_int("DKTPU_SERVE_QUEUE")
                            if max_queue_rows is None else max_queue_rows)
        if max_wait_s is None:
            max_wait_s = config.env_float("DKTPU_SERVE_MAX_WAIT_MS") / 1e3
        self.max_wait_s = float(max_wait_s)
        if deadline_s is None:
            ms = config.env_float("DKTPU_SERVE_DEADLINE_MS")
            deadline_s = ms / 1e3 if ms is not None else None
        self.deadline_s = deadline_s
        self._queue: list[PendingRequest] = []
        self._rows = 0
        self._cond = threading.Condition()
        self._closed = False

    # -- handler side -------------------------------------------------------

    def submit(self, arrays: Sequence, rows: int) -> PendingRequest:
        """Admission control: accept ``arrays`` into the queue or shed with
        a typed error BEFORE anything is queued. Returns the accepted
        request; the caller blocks on its event."""
        if bucket_for(rows, self.buckets) is None:
            telemetry.counter("serving.shed").add(1)
            raise OverloadedError(
                f"request of {rows} rows exceeds the largest serving "
                f"bucket ({self.buckets[-1]}); split it client-side")
        with self._cond:
            if self._closed:
                raise ModelUnavailableError("serving frontend is closed")
            if self._rows + rows > self.max_rows:
                telemetry.counter("serving.shed").add(1)
                raise OverloadedError(
                    f"serving queue full ({self._rows}/{self.max_rows} "
                    f"rows); request of {rows} rows shed")
            pending = PendingRequest(arrays, rows, deadline_s=self.deadline_s)
            self._queue.append(pending)
            self._rows += rows
            telemetry.counter("serving.accepted").add(1)
            telemetry.gauge("serving.queue_depth").set(float(self._rows))
            self._cond.notify_all()
        return pending

    # -- dispatch side ------------------------------------------------------

    def collect(self, poll_s: float = 0.2) -> list[PendingRequest]:
        """One micro-batch: block (up to ``poll_s``) for a first request,
        then keep coalescing until the latency budget elapses or the batch
        reaches the largest bucket. Expired requests are answered with
        :class:`DeadlineExceededError` here — the queue never computes work
        nobody is waiting for. Returns [] on poll timeout / close."""
        with self._cond:
            if not self._queue:
                self._cond.wait(timeout=poll_s)
            if not self._queue:
                return []
            batch_deadline = time.monotonic() + self.max_wait_s
            while True:
                self._expire_locked()
                rows = sum(p.rows for p in self._queue)
                if rows >= self.buckets[-1] or self._closed:
                    break
                remaining = batch_deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            # Pop FIFO whole-requests up to the row cap (a request's rows
            # are never split across batches — its reply is one frame).
            batch: list[PendingRequest] = []
            taken = 0
            while self._queue:
                nxt = self._queue[0]
                if batch and taken + nxt.rows > self.buckets[-1]:
                    break
                batch.append(self._queue.pop(0))
                taken += nxt.rows
            self._rows -= taken
            telemetry.gauge("serving.queue_depth").set(float(self._rows))
        return batch

    def _expire_locked(self) -> None:
        """Answer queued requests that aged past their deadline (typed
        reply, never a silent drop). Caller holds the condition lock."""
        if self.deadline_s is None or not self._queue:
            return
        now = time.monotonic()
        live = []
        for p in self._queue:
            if p.deadline_at is not None and now > p.deadline_at:
                self._rows -= p.rows
                telemetry.counter("serving.deadline_drops").add(1)
                p.answer(error=DeadlineExceededError(
                    f"request aged {(now - p.admitted_at) * 1e3:.1f}ms in "
                    f"queue, past its {self.deadline_s * 1e3:.1f}ms deadline"))
            else:
                live.append(p)
        self._queue[:] = live
        telemetry.gauge("serving.queue_depth").set(float(self._rows))

    def depth_rows(self) -> int:
        with self._cond:
            return self._rows

    def close(self) -> None:
        """Stop admitting; answer everything still queued with a typed
        :class:`ModelUnavailableError` — the accepted-never-dropped
        contract holds through shutdown."""
        with self._cond:
            self._closed = True
            for p in self._queue:
                p.answer(error=ModelUnavailableError(
                    "serving frontend closed before this request was "
                    "dispatched"))
            self._queue.clear()
            self._rows = 0
            self._cond.notify_all()
