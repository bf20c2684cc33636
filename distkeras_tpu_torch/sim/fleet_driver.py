"""Driving the REAL FleetScheduler on a virtual clock.

The scheduler's two seams (``clock=``, ``thread_factory=``) are filled
here: :class:`SimThreadFactory` builds :class:`SimThread`\\ s — cooperative
stand-ins whose ``start()`` runs the scheduler's worker body
*synchronously*. The body is the scheduler's own closure: it calls
``runtime.worker_main(wid, should_run)``, which under simulation
registers an event-driven worker with the engine and returns immediately
instead of blocking. The SimThread then stays "alive" until that worker
finishes (released, crashed, or out of work), so the scheduler's REAL
reap logic — crash-restart budgets, drain completion, grace-window
revocation — runs unmodified against zero OS threads.

:class:`SimJobRuntime` satisfies the FleetJob runtime duck-type
(``ensure_started`` / ``worker_main`` / ``progress`` / ``done`` /
``revoke`` / ``close``). Each simulated worker alternates a work interval
(trace-fitted or parametric) with a commit against a
:class:`~distkeras_tpu_torch.sim.cluster.SimCenter` — pull counter sampled at
round start, so staleness under concurrency is emergent, not scripted.
Commit sequences persist across restarts and re-placements (the real
"PS kept warm" contract), and :meth:`SimJobRuntime.crash` can lose the
ack of an applied commit, forcing the restarted worker to retransmit and
the center's dedup to earn its exactly-once invariant.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from distkeras_tpu_torch.sim.cluster import SimCenter


class SimThread:
    """Cooperative thread stand-in (the scheduler only ever calls
    ``start`` / ``is_alive`` / ``join``)."""

    def __init__(self, engine, target: Callable[[], None],
                 name: str = "sim"):
        self.engine = engine
        self.name = name
        self._target = target
        self._state = None     # bound by SimJobRuntime.worker_main
        self._started = False

    def start(self) -> None:
        self._started = True
        prev = self.engine.current_thread
        self.engine.current_thread = self
        try:
            self._target()
        finally:
            self.engine.current_thread = prev

    def bind(self, state) -> None:
        self._state = state

    def is_alive(self) -> bool:
        return bool(self._started and self._state is not None
                    and not self._state.finished)

    def join(self, timeout: Optional[float] = None) -> None:
        return None


class SimThreadFactory:
    """``thread_factory=`` seam filler: engine-bound, Thread-signature
    compatible (extra kwargs like ``daemon`` are accepted and ignored)."""

    def __init__(self, engine):
        self.engine = engine
        self.created = 0

    def __call__(self, target=None, name: str = "sim", **_kw) -> SimThread:
        self.created += 1
        return SimThread(self.engine, target, name=name)


class _WorkerState:
    """One granted worker's live half (a fresh one per (re)spawn — stale
    scheduled events hold the old object and no-op on ``finished``)."""

    __slots__ = ("wid", "should_run", "thread", "pulled", "finished",
                 "revoked")

    def __init__(self, wid: int, should_run, thread):
        self.wid = wid
        self.should_run = should_run
        self.thread = thread
        self.pulled = None
        self.finished = False
        self.revoked = False


class SimJobRuntime:
    """Simulated job runtime; see the module docstring.

    ``round_time`` is ``(engine, wid) -> seconds`` (the work+commit
    interval); ``rounds_target`` is the job's total applied-commit goal
    across all workers. ``commit_value`` is the per-commit delta folded
    into the center (1.0 makes the center value a commit counter)."""

    def __init__(self, engine, name: str,
                 round_time: Callable[[object, int], float],
                 rounds_target: int,
                 center: Optional[SimCenter] = None,
                 commit_value: float = 1.0,
                 start_jitter_s: float = 0.05,
                 worker_slots: Optional[int] = None):
        self.engine = engine
        self.name = name
        self.round_time = round_time
        self.rounds_target = int(rounds_target)
        self.center = center if center is not None else SimCenter()
        self.commit_value = float(commit_value)
        self.start_jitter_s = float(start_jitter_s)
        if worker_slots is not None:
            #: optional data-layout bound (the scheduler checks it).
            self.worker_slots = int(worker_slots)
        self.endpoint = f"sim://{name}"
        self.rounds_done = 0
        self.started = False
        self.closed = False
        self.crashes = 0
        self.resends_expected = 0
        self._next_seq: Dict[int, int] = {}
        self._workers: Dict[int, _WorkerState] = {}
        #: per-tick-sampled worker counts (scenarios derive shrink/expand
        #: thrash from the direction changes of this series).
        self.granted_series: list = []

    # -- the FleetJob runtime protocol ---------------------------------

    def ensure_started(self) -> None:
        self.started = True

    def worker_main(self, worker_id: int, should_run) -> None:
        thread = self.engine.current_thread
        if thread is None:
            raise RuntimeError(
                "SimJobRuntime.worker_main outside a SimThread — pass "
                "thread_factory=SimThreadFactory(engine) to the scheduler")
        st = _WorkerState(worker_id, should_run, thread)
        thread.bind(st)
        self._workers[worker_id] = st
        jitter = (self.engine.rng.uniform(0.0, self.start_jitter_s)
                  if self.start_jitter_s > 0 else 0.0)
        self.engine.after(jitter, self._begin_round, st)

    def progress(self) -> int:
        return self.rounds_done

    def done(self) -> bool:
        return self.rounds_done >= self.rounds_target

    def revoke(self, worker_id: int) -> None:
        st = self._workers.get(worker_id)
        if st is not None:
            st.revoked = True

    def close(self) -> None:
        self.closed = True

    # -- the event-driven worker loop ----------------------------------

    def _finished(self, st: _WorkerState) -> bool:
        if st.finished:
            return True
        if (self.closed or self.done() or st.revoked
                or not st.should_run()):
            st.finished = True
            return True
        return False

    def _begin_round(self, st: _WorkerState) -> None:
        if self._finished(st):
            return
        st.pulled = self.center.pull()
        self.engine.after(self.round_time(self.engine, st.wid),
                          self._end_round, st)

    def _end_round(self, st: _WorkerState) -> None:
        if self._finished(st):
            return
        wid = st.wid
        seq = self._next_seq.get(wid, 0)
        res = self.center.commit(wid, seq, st.pulled, self.commit_value)
        self._next_seq[wid] = seq + 1
        if res["applied"]:
            # a lose_ack retransmit is deduped by the center and must not
            # double-count progress
            self.rounds_done += 1
        self._begin_round(st)

    # -- fault injection (scenario-controlled) -------------------------

    def crash(self, worker_id: int, lose_ack: bool = False) -> bool:
        """Kill one worker's stand-in thread mid-flight (the scheduler's
        reaper sees a dead, unreleased, unfinished worker — a crash —
        and spends restart budget on it). With ``lose_ack``, the last
        applied commit's ack is lost: the restarted worker re-sends that
        sequence and the center's dedup must absorb the duplicate."""
        st = self._workers.get(worker_id)
        if st is None or st.finished:
            return False
        st.finished = True
        self.crashes += 1
        if lose_ack and self._next_seq.get(worker_id, 0) > 0:
            self._next_seq[worker_id] -= 1
            self.resends_expected += 1
        return True

    def active_workers(self) -> int:
        return sum(1 for st in self._workers.values() if not st.finished)
