"""Round prefetcher: overlap host-side gather + H2D transfer with device compute
(the port's copy of ``distkeras_tpu/data/prefetch.py``; threads only).

The reference got pipelining for free from Spark's executor iterators; here a
background thread materializes round ``r+depth`` and stages it on the device
while the card crunches round ``r``, so the main loop's synchronous cost
becomes a queue pop. The fault plan's feeder hooks fire before each stage
call: ``stall@r:s`` sleeps ``s`` seconds (the consumer's stall watchdog
sees it) and ``feeder_error@r`` raises :class:`~distkeras_tpu_torch.
resilience.errors.InjectedFault` once (the stage retry sees it).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional, Union

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.resilience import faults
from distkeras_tpu_torch.resilience.errors import (
    FeederStalledError,
    InjectedFault,
)
from distkeras_tpu_torch.runtime import config

#: how many per-round consumer waits :attr:`RoundFeeder.waits` retains.
#: Open-ended streams run forever; an unbounded ``list[float]`` is a slow
#: memory leak, so the tail is a deque and the *sum* is kept separately
#: (``wait_seconds``) so total-stall accounting never loses evicted entries.
WAITS_KEEP = 4096


class RoundFeeder:
    """Iterate ``(r, staged_batch)`` over a work-item source with lookahead.

    ``items`` is either an int N (the classic bounded mode: item indices
    ``start_round..N``, ``stage(r)`` receives the index) or any iterable —
    including an **unbounded** one (a live stream source): the feeder
    enumerates it and ``stage(item)`` receives each yielded item, while the
    ``r`` handed to the consumer is the item's ordinal (``start_round`` +
    position).

    ``stage(r_or_item) -> batch`` does the gather + device copy; it runs on
    the feeder thread. Exceptions propagate to the consumer on the next pop.

    Abandonment-safe: if the consumer stops iterating early (``engine.run``
    raised mid-loop, generator dropped), :meth:`close` runs from the
    generator's ``finally`` — the feeder thread is unblocked from a full
    queue, told to stop, and joined, and every staged batch still queued is
    dropped, so no staged device tensor stays pinned.

    Resilience:

    * **Stage retry**: ``stage_retries`` (env ``DKTPU_FEEDER_RETRIES``,
      default 0 = off) retries a *failed* stage call with exponential
      backoff before propagating.
    * **Stall watchdog**: the consumer warns (``resilience.
      feeder_stall_warnings``) at exponentially spaced thresholds starting
      at ``stall_warn`` seconds (env ``DKTPU_FEEDER_WARN``, default 1.0)
      while blocked on an empty queue, and after ``stall_timeout`` seconds
      (env ``DKTPU_FEEDER_TIMEOUT``, default 300) declares the input
      pipeline dead with :class:`FeederStalledError` instead of hanging.
    """

    def __init__(self, items: Union[int, Iterable], stage: Callable,
                 start_round: int = 0, depth: int = 2,
                 stall_timeout: Optional[float] = None,
                 stall_warn: Optional[float] = None,
                 stage_retries: Optional[int] = None,
                 retry_backoff_s: float = 0.05):
        self.items = items
        #: bounded-mode round count (None in iterable mode).
        self.num_rounds = items if isinstance(items, int) else None
        self.stage = stage
        self.start_round = start_round
        self.depth = max(1, depth)
        self.stall_timeout = (config.env_float("DKTPU_FEEDER_TIMEOUT")
                              if stall_timeout is None else float(stall_timeout))
        self.stall_warn = (config.env_float("DKTPU_FEEDER_WARN")
                           if stall_warn is None else float(stall_warn))
        self.stage_retries = (config.env_int("DKTPU_FEEDER_RETRIES")
                              if stage_retries is None else int(stage_retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        #: consumer-side seconds blocked waiting for each yielded round —
        #: the feed-overlap diagnostic. Waits beyond the warmup round mean
        #: the gather + transform + device-copy pipeline is slower than the
        #: run loop (staging NOT hidden). Bounded (last :data:`WAITS_KEEP`
        #: entries); :attr:`wait_seconds` keeps the exact running total.
        self.waits: collections.deque = collections.deque(maxlen=WAITS_KEEP)
        #: exact sum of EVERY recorded wait, including entries the bounded
        #: :attr:`waits` deque has already evicted.
        self.wait_seconds: float = 0.0

    def _put(self, item) -> bool:
        """Blocking put that aborts (returns False) once close() is called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _stage_once(self, r: int, item):
        """One stage attempt, with scheduled fault injection applied first.
        ``r`` is the ordinal the fault plan indexes by; ``item`` is what the
        stage callback receives (== r in bounded mode)."""
        plan = faults.active_plan()
        if plan is not None:
            stall = plan.feeder_stall(r)
            if stall > 0:
                time.sleep(stall)
            if plan.feeder_error(r):
                raise InjectedFault(
                    f"feeder error injected at item {r} (DKTPU_FAULTS)")
        return self.stage(item)

    def _stage_with_retry(self, r: int, item, tele):
        attempt = 0
        while True:
            try:
                return self._stage_once(r, item)
            except Exception:
                # Only plain Exceptions retry: KeyboardInterrupt/SystemExit
                # and close() must still win immediately.
                if attempt >= self.stage_retries or self._stop.is_set():
                    raise
                tele.counter("resilience.feeder_retries").add(1)
                time.sleep(self.retry_backoff_s * (2 ** attempt))
                attempt += 1

    def _item_source(self) -> Iterator:
        """``(ordinal, item)`` pairs: a range in bounded mode, an enumerate
        of the caller's iterable (offset by ``start_round``) in stream
        mode."""
        if self.num_rounds is not None:
            for r in range(self.start_round, self.num_rounds):
                yield r, r
        else:
            for i, item in enumerate(self.items):
                yield self.start_round + i, item

    def _run(self):
        tele = telemetry.get()
        stage_span = tele.histogram("feeder.stage")
        try:
            for r, item in self._item_source():
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                batch = self._stage_with_retry(r, item, tele)
                # Producer-side cost (gather + transform + device copy), the
                # counterpart of the consumer's ``input_stall``.
                stage_span.observe(time.perf_counter() - t0)
                if not self._put((r, batch, None)):
                    return
        except BaseException as e:  # noqa: BLE001 - propagate to consumer
            self._put((-1, None, e))
        else:
            self._put((None, None, None))  # sentinel

    def close(self, deadline_s: float = 10.0):
        """Stop the feeder thread and drop all staged batches. Idempotent.

        Bounded: a feeder wedged inside ``stage`` cannot be joined — after
        ``deadline_s`` the daemon thread is abandoned so the consumer's
        original exception still propagates instead of hanging."""
        self._stop.set()
        # Drain so a put blocked on a full queue wakes promptly; staged
        # device tensors die here (including when the feeder thread
        # already finished and left items + sentinel sitting in the queue).
        t_end = time.monotonic() + deadline_s
        while self._thread.is_alive() and time.monotonic() < t_end:
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        with self._q.mutex:
            self._q.queue.clear()

    def __iter__(self) -> Iterator:
        if self._stop.is_set():
            # Closed (or already fully consumed — normal exhaustion closes
            # too): fail loudly rather than silently yielding zero rounds.
            raise RuntimeError(
                "RoundFeeder is closed; construct a new feeder per run")
        tele = telemetry.get()
        depth_gauge = tele.gauge("feeder.queue_depth")
        fill_gauge = tele.gauge("feeder.fill_ratio")
        stall_counter = tele.counter("resilience.feeder_stall_warnings")
        self._thread.start()
        try:
            wait = 0.0
            next_warn = self.stall_warn
            while True:
                t0 = time.perf_counter()
                try:
                    # Timed get: a concurrent close() suppresses the
                    # sentinel, so an untimed get would block forever.
                    r, batch, err = self._q.get(timeout=0.1)
                except queue.Empty:
                    wait += time.perf_counter() - t0
                    if self._stop.is_set():
                        return
                    # Stall watchdog: exponentially backed-off warnings
                    # while the data plane produces nothing, then declare
                    # it dead. The clock resets at every delivery.
                    if wait >= next_warn and next_warn <= self.stall_timeout:
                        stall_counter.add(1)
                        tele.event("feeder_stall", {
                            "waited_s": round(wait, 3),
                            "timeout_s": self.stall_timeout})
                        import warnings as _warnings

                        _warnings.warn(
                            f"input pipeline stalled: no batch for "
                            f"{wait:.1f}s (timeout {self.stall_timeout:.0f}s)",
                            stacklevel=2)
                        next_warn *= 2
                    if wait >= self.stall_timeout:
                        tele.counter("resilience.feeder_stall_deaths").add(1)
                        raise FeederStalledError(
                            f"input pipeline produced nothing for "
                            f"{wait:.1f}s (stall_timeout="
                            f"{self.stall_timeout}s); declaring the data "
                            "plane dead")
                    continue
                wait += time.perf_counter() - t0
                next_warn = self.stall_warn
                if err is not None:
                    raise err
                if r is None:
                    return
                # Lookahead health at each pop: depth 0 = the consumer is
                # racing the feeder; fill 1.0 = staging is fully hidden.
                q = self._q.qsize()
                depth_gauge.set(q)
                fill_gauge.set(q / self.depth)
                self.waits.append(wait)
                self.wait_seconds += wait
                wait = 0.0
                yield r, batch
        finally:
            # Runs on normal exhaustion AND on abandonment (consumer raised /
            # dropped the generator -> GeneratorExit lands at the yield).
            self.close()
