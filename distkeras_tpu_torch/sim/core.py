"""The deterministic discrete-event core.

One heap, one virtual clock, one explicitly-threaded RNG. Determinism is
a contract, not an aspiration (pinned by ``tests/test_torch_sim.py``): two runs
with the same seed and scenario are bit-identical because

* the event heap orders by ``(time, seq)`` — ``seq`` is a monotonically
  assigned tie-breaker, so two events scheduled for the same instant pop
  in scheduling order and callables are never compared;
* every random draw goes through ``engine.rng`` (one
  :class:`random.Random` seeded from the scenario seed /
  ``DKTPU_SIM_SEED``) — no module-global RNG state;
* nothing in this package reads a wall clock — the seams
  (``FleetScheduler(clock=...)``, ``MetricsHub(clock=...)``) put the
  real subsystems on :meth:`SimEngine.now` too.
"""

from __future__ import annotations

import heapq
import math
import random
from typing import Callable, Optional

from distkeras_tpu_torch.runtime.config import env_int


class SimEngine:
    """The event loop: schedule with :meth:`at`/:meth:`after`, advance
    with :meth:`run`. ``current_thread`` is the cooperative stand-in the
    fleet driver binds while a scheduler-spawned "thread" body executes
    (see :class:`~distkeras_tpu_torch.sim.fleet_driver.SimThread`)."""

    def __init__(self, seed: Optional[int] = None):
        self.seed = env_int("DKTPU_SIM_SEED") if seed is None else int(seed)
        self.rng = random.Random(self.seed)
        self._heap: list = []
        self._seq = 0
        self._now = 0.0
        self.events_run = 0
        self.current_thread = None

    def now(self) -> float:
        return self._now

    def clock(self) -> Callable[[], float]:
        """The virtual clock as a zero-arg callable — drop-in for the
        ``clock=`` seams on the scheduler and the metrics hub."""
        return self.now

    def at(self, t: float, fn: Callable, *args) -> None:
        """Schedule ``fn(*args)`` at virtual time ``t`` (clamped to now —
        the past is not schedulable)."""
        self._seq += 1
        heapq.heappush(self._heap, (max(float(t), self._now),
                                    self._seq, fn, args))

    def after(self, dt: float, fn: Callable, *args) -> None:
        self.at(self._now + max(0.0, float(dt)), fn, *args)

    def run(self, until: Optional[float] = None,
            max_events: int = 5_000_000) -> float:
        """Pop-and-fire until the heap drains (or passes ``until``);
        returns the final virtual time. ``max_events`` is a runaway
        backstop — a scenario that trips it has a scheduling loop bug."""
        while self._heap:
            t = self._heap[0][0]
            if until is not None and t > until:
                break
            t, _seq, fn, args = heapq.heappop(self._heap)
            self._now = t
            fn(*args)
            self.events_run += 1
            if self.events_run >= max_events:
                raise RuntimeError(
                    f"sim exceeded {max_events} events at t={self._now:.3f}"
                    " — runaway event loop")
        if until is not None and until > self._now:
            self._now = until
        return self._now

    def pending(self) -> int:
        return len(self._heap)

    def lognormal(self, mu: float, sigma: float,
                  cap: Optional[float] = None) -> float:
        """One lognormal draw from the engine RNG, optionally capped (a
        fitted tail must not schedule a commit in the next century)."""
        v = self.rng.lognormvariate(mu, sigma) if sigma > 0.0 else \
            math.exp(mu)
        return min(v, cap) if cap is not None else v
