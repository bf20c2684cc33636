"""Exhaustive-interleaving checker for the port's distributed planes (the
JAX package's ``analysis/interleave.py``, on the port's objects).

dk-check's lint rules (DK2xx/DK5xx) reason about lock/ordering hazards
*lexically*; this module closes the loop dynamically: it enumerates EVERY
schedule of a small cooperative-thread scenario against the port's REAL
protocol machines — ``netps/server.py PSServer``'s dedup table and epoch
fence, ``streaming/journal.py OffsetJournal``'s crash-recovery
``resolve()``, and ``netps/hier.py AggregatorServer``'s combined-window
flush plane — and asserts the exactly-once and fence-monotonicity
invariants in every one.

Every server holds its center on a device named by the caller
(``device="cpu"`` or ``"cuda"``): the port's ``PSServer(device=None)``
means the card, so with no device given and no card present the suite
raises rather than fall back to the CPU.

The concurrency seam is the same one the fleet simulator fills
(``sim.fleet_driver.SimThreadFactory``): scenarios receive a
Thread-signature-compatible factory (``factory(target=..., name=...)``)
and register cooperative threads through it. The one divergence from the
sim is the unit of progress: here a thread's target is a *generator
function* and every ``yield`` is a preemption point, so the explorer —
not wall-clock scheduling — decides the interleaving. Code between two
yields is atomic, which matches the real system exactly when the segment
is one public API call (every ``PSServer._op_*`` runs under the center
lock; every ``OffsetJournal`` method runs under its own lock).

Exploration is stateless-model-checking DFS: each run replays a choice
prefix from a fresh scenario instance, then follows the default policy
(lowest runnable thread) while enqueueing every untaken alternative as a
new prefix. Each complete schedule executes exactly once. A scenario may
opt into *crash points*: at every choice point the explorer also branches
into "the process dies here" (budget 1 — the crash ends the run), after
which the scenario's ``finish()`` performs deterministic recovery and the
final invariants must still hold. RAM state is lost in a crash; the
in-memory ``MemJournal`` "disk" dict and the (separate-process) PS server
survive, exactly mirroring a trainer-process death in the streaming
runtime.

Determinism is load-bearing: scenarios must not branch on wall-clock or
randomness, so a violation's reproducer is just its schedule — the
choice sequence printed with the finding.

Run ``python -m distkeras_tpu_torch.analysis.interleave --device cpu``
(or ``--device cuda``) to enumerate all scenarios and exit 1 on any
violation; ``--mutate`` seeds a dedup-skipping server mutation and exits 0
only if the explorer catches it (the checker's own regression test).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np

CRASH = -1  # schedule token: the modeled process dies at this choice point


# ---------------------------------------------------------------------------
# The cooperative-thread seam (SimThreadFactory-shaped)
# ---------------------------------------------------------------------------

class CoopThread:
    """Cooperative thread over a generator target: ``step()`` advances it
    to the next ``yield``; the public surface (``start`` / ``is_alive`` /
    ``join``) matches what the sim's scheduler expects of a thread."""

    def __init__(self, target: Callable, name: str = "coop"):
        self.name = name
        self._target = target
        self._gen = None
        self._done = False

    def start(self) -> None:
        self._gen = self._target()

    def is_alive(self) -> bool:
        return self._gen is not None and not self._done

    def step(self) -> None:
        try:
            next(self._gen)
        except StopIteration:
            self._done = True

    def kill(self) -> None:
        self._done = True

    def join(self, timeout: Optional[float] = None) -> None:
        return None


class CoopThreadFactory:
    """``thread_factory=`` seam filler, Thread-signature compatible like
    ``SimThreadFactory`` (extra kwargs such as ``daemon`` are accepted
    and ignored); collects the threads for the explorer to schedule."""

    def __init__(self):
        self.threads: List[CoopThread] = []

    def __call__(self, target=None, name: str = "coop",
                 **_kw) -> CoopThread:
        t = CoopThread(target, name=name)
        self.threads.append(t)
        return t


# ---------------------------------------------------------------------------
# Explorer
# ---------------------------------------------------------------------------

class Violation:
    def __init__(self, scenario: str, schedule: Tuple[int, ...],
                 message: str):
        self.scenario = scenario
        self.schedule = schedule
        self.message = message

    def __repr__(self) -> str:
        sched = ",".join("X" if c == CRASH else str(c)
                         for c in self.schedule)
        return f"[{self.scenario}] schedule=({sched}): {self.message}"


class ExploreResult:
    def __init__(self, name: str):
        self.name = name
        self.complete = 0       # schedules run to completion
        self.crashed = 0        # schedules ending in a modeled crash
        self.transitions = 0    # atomic steps executed across all runs
        self.violations: List[Violation] = []

    @property
    def schedules(self) -> int:
        return self.complete + self.crashed


def explore(make_scenario: Callable, crash_points: bool = False,
            max_schedules: Optional[int] = None) -> ExploreResult:
    """DFS over all interleavings of ``make_scenario()``'s threads.

    Each pending entry is a choice prefix; a run replays it, then follows
    the lowest-runnable-thread policy, pushing every untaken alternative
    (and, when ``crash_points``, a CRASH branch) at each fresh choice
    point. Invariants are checked after every step and once more after
    ``finish()`` — so safety holds in every reachable state, not just at
    quiescence."""
    result = ExploreResult(getattr(make_scenario, "name", None)
                           or make_scenario().name)
    pending: List[Tuple[int, ...]] = [()]
    while pending:
        if max_schedules is not None and result.schedules >= max_schedules:
            break
        prefix = pending.pop()
        scen = make_scenario()
        factory = CoopThreadFactory()
        scen.build(factory)
        threads = factory.threads
        for t in threads:
            t.start()
        trace: List[int] = []
        crashed = False
        try:
            while True:
                runnable = [i for i, t in enumerate(threads)
                            if t.is_alive()]
                if not runnable:
                    break
                depth = len(trace)
                if depth < len(prefix):
                    choice = prefix[depth]
                else:
                    choice = runnable[0]
                    for alt in runnable[1:]:
                        pending.append(tuple(trace) + (alt,))
                    if crash_points and depth > 0:
                        pending.append(tuple(trace) + (CRASH,))
                if choice == CRASH:
                    crashed = True
                    for t in threads:
                        t.kill()
                    scen.crash()
                    trace.append(CRASH)
                    break
                threads[choice].step()
                trace.append(choice)
                result.transitions += 1
                for msg in scen.check_step():
                    result.violations.append(
                        Violation(scen.name, tuple(trace), msg))
            scen.finish()
            for msg in scen.check_final():
                result.violations.append(
                    Violation(scen.name, tuple(trace), msg))
        finally:
            scen.close()
        if crashed:
            result.crashed += 1
        else:
            result.complete += 1
    return result


# ---------------------------------------------------------------------------
# Scenario base + shared server plumbing
# ---------------------------------------------------------------------------

class Scenario:
    """One model-checked configuration: ``build`` registers cooperative
    threads via the factory seam; ``check_step`` runs after every atomic
    step; ``crash`` models process death (RAM lost, durable state kept);
    ``finish`` is deterministic recovery; ``check_final`` asserts the
    end-to-end invariants; ``close`` releases OS resources."""

    name = "scenario"

    def __init__(self, device=None):
        #: where every server of the scenario holds its center
        self.device = device

    def build(self, thread_factory: CoopThreadFactory) -> None:
        raise NotImplementedError

    def check_step(self) -> List[str]:
        return []

    def crash(self) -> None:
        return None

    def finish(self) -> None:
        return None

    def check_final(self) -> List[str]:
        return []

    def close(self) -> None:
        return None


def _new_server(server_cls=None, device=None, **kw):
    """A real ``PSServer`` with a 1-tensor center on ``device``, never
    ``serve()``d — scenarios drive ``_dispatch`` directly, so every op runs
    the genuine handler (lock, dedup table, fence, commit_log) minus the
    socket hop."""
    from distkeras_tpu_torch.netps.server import PSServer

    cls = server_cls or PSServer
    return cls(center=[np.zeros(4, np.float32)], lease_s=3600.0,
               device=device, **kw)


def _close_server(srv) -> None:
    try:
        srv._listener.close()
    except OSError:
        pass
    uds = getattr(srv, "_uds_listener", None)
    if uds is not None:
        try:
            uds.close()
        except OSError:
            pass


def _join(srv, wid: int) -> dict:
    from distkeras_tpu_torch.netps import wire

    reply, _ = srv._dispatch(wire.OP_JOIN, {"worker_id": wid}, [])
    assert reply.get("ok"), f"setup join failed: {reply}"
    return reply


def _commit(srv, wid: int, seq: int) -> dict:
    """A zero-delta commit of the center's shape (the port's server checks
    a commit's sizes against its center, so the reference's empty delta is
    refused there): the center never moves, but ``_fold_locked`` runs the
    full fold and the dedup / commit_log / last_seq bookkeeping — the
    machine under test."""
    from distkeras_tpu_torch.netps import wire

    reply, _ = srv._dispatch(
        wire.OP_COMMIT, {"worker_id": wid, "seq": seq, "pulled": 0},
        [np.zeros(4, np.float32)])
    return reply


def _fold_pairs(srv) -> List[Tuple[int, int]]:
    return [(w, s) for (w, s, _st) in srv.commit_log]


# ---------------------------------------------------------------------------
# Scenario 1: the dedup table (exactly-once under retransmit)
# ---------------------------------------------------------------------------

class DedupScenario(Scenario):
    """2 workers x 3 commits, every commit sent twice (the lost-ACK
    retransmit — serial per worker, exactly like the real client's
    retry-then-advance loop), all cross-worker interleavings.

    Invariants: the commit_log never holds two folds of one ``(wid,
    seq)``; ``last_seq`` is per-worker monotone; at quiescence every
    commit folded exactly once and exactly one of its two sends was
    answered ``applied``."""

    name = "dedup"
    WORKERS = 2
    COMMITS = 3

    def __init__(self, server_cls=None, device=None):
        self._server_cls = server_cls
        self.device = device

    def build(self, thread_factory: CoopThreadFactory) -> None:
        self.srv = _new_server(self._server_cls, self.device)
        self.wids = list(range(self.WORKERS))
        for w in self.wids:
            _join(self.srv, w)
        self.replies: List[Tuple[int, int, int, dict]] = []
        self._prev_last_seq: dict = {}
        for w in self.wids:
            thread_factory(target=self._worker(w), name=f"w{w}")

    def _worker(self, wid: int):
        # original, then lost-ACK retransmit, serially per worker
        sends = [(seq, attempt) for seq in range(self.COMMITS)
                 for attempt in (0, 1)]

        def script():
            for i, (seq, attempt) in enumerate(sends):
                if i:
                    yield  # preemption point BETWEEN sends, no trailing one
                reply = _commit(self.srv, wid, seq)
                self.replies.append((wid, seq, attempt, reply))
        return script

    def check_step(self) -> List[str]:
        out = []
        pairs = _fold_pairs(self.srv)
        if len(set(pairs)) != len(pairs):
            out.append(f"duplicate fold in commit_log: {pairs}")
        for w, s in self.srv._last_seq.items():
            if s < self._prev_last_seq.get(w, -1):
                out.append(f"last_seq regressed for worker {w}: "
                           f"{self._prev_last_seq[w]} -> {s}")
            self._prev_last_seq[w] = s
        return out

    def check_final(self) -> List[str]:
        out = []
        folds = _fold_pairs(self.srv)
        for w in self.wids:
            for seq in range(self.COMMITS):
                n = folds.count((w, seq))
                if n != 1:
                    out.append(f"(wid={w}, seq={seq}) folded {n} times, "
                               "want exactly 1")
                applied = sum(1 for rw, rs, _a, r in self.replies
                              if (rw, rs) == (w, seq) and r.get("applied"))
                if applied != 1:
                    out.append(f"(wid={w}, seq={seq}) answered applied "
                               f"{applied} times across 2 sends, want 1")
        want = self.WORKERS * self.COMMITS
        if self.srv.commits_total != want:
            out.append(f"commits_total={self.srv.commits_total}, "
                       f"want {want}")
        return out

    def close(self) -> None:
        _close_server(self.srv)


class _NoDedupServer:
    """Seeded mutant: forgets the dedup table entry before every commit,
    so a retransmit re-folds — the regression the explorer must catch.
    Built lazily (subclassing PSServer at import time would import numpy
    server machinery even for pure-lint callers)."""

    _cls = None

    def __new__(cls, *a, **kw):
        from distkeras_tpu_torch.netps.server import PSServer

        if cls._cls is None:
            class NoDedup(PSServer):
                def _op_commit(self, header, arrays):
                    wid = header.get("worker_id")
                    if wid is not None:
                        self._last_seq.pop(int(wid), None)
                    return PSServer._op_commit(self, header, arrays)
            cls._cls = NoDedup
        return cls._cls(*a, **kw)


# ---------------------------------------------------------------------------
# Scenario 2: the epoch fence (zombie primary can never fold again)
# ---------------------------------------------------------------------------

class FenceScenario(Scenario):
    """2 workers x 4 commits racing a fencer that raises the epoch three
    times (a failover storm) — 11!/(4!4!3!) = 11550 schedules.

    Invariants: ``epoch`` never decreases; ``_fenced`` never unsets; once
    any fence is accepted the commit_log is frozen (a fenced ex-primary
    answers ``not_primary`` and must never fold again); an ``applied``
    commit reply can only have been issued by an unfenced server."""

    name = "fence"
    WORKERS = 2
    COMMITS = 4
    FENCE_EPOCHS = (1, 2, 3)

    def build(self, thread_factory: CoopThreadFactory) -> None:
        self.srv = _new_server(device=self.device)
        self.wids = list(range(self.WORKERS))
        for w in self.wids:
            _join(self.srv, w)
        self.commit_replies: List[Tuple[int, int, bool, dict]] = []
        self.fence_replies: List[Tuple[int, dict]] = []
        self._prev_epoch = self.srv.epoch
        self._was_fenced = False
        self._frozen_log_len: Optional[int] = None
        for w in self.wids:
            thread_factory(target=self._worker(w), name=f"w{w}")
        thread_factory(target=self._fencer, name="fencer")

    def _worker(self, wid: int):
        def script():
            for seq in range(self.COMMITS):
                if seq:
                    yield
                fenced_before = self.srv._fenced
                reply = _commit(self.srv, wid, seq)
                self.commit_replies.append((wid, seq, fenced_before, reply))
        return script

    def _fencer(self):
        from distkeras_tpu_torch.netps import wire

        for i, epoch in enumerate(self.FENCE_EPOCHS):
            if i:
                yield
            reply, _ = self.srv._dispatch(wire.OP_FENCE, {"epoch": epoch},
                                          [])
            self.fence_replies.append((epoch, reply))

    def check_step(self) -> List[str]:
        out = []
        if self.srv.epoch < self._prev_epoch:
            out.append(f"epoch regressed: {self._prev_epoch} -> "
                       f"{self.srv.epoch}")
        self._prev_epoch = self.srv.epoch
        if self._was_fenced and not self.srv._fenced:
            out.append("fence lifted: _fenced went True -> False")
        if self.srv._fenced and self._frozen_log_len is None:
            self._frozen_log_len = len(self.srv.commit_log)
        self._was_fenced = self.srv._fenced or self._was_fenced
        if (self._frozen_log_len is not None
                and len(self.srv.commit_log) != self._frozen_log_len):
            out.append(
                f"fold after fence: commit_log grew "
                f"{self._frozen_log_len} -> {len(self.srv.commit_log)}")
        return out

    def check_final(self) -> List[str]:
        out = []
        pairs = _fold_pairs(self.srv)
        if len(set(pairs)) != len(pairs):
            out.append(f"duplicate fold in commit_log: {pairs}")
        for wid, seq, fenced_before, reply in self.commit_replies:
            if reply.get("applied") and fenced_before:
                out.append(f"(wid={wid}, seq={seq}) applied by an "
                           "already-fenced server")
            if fenced_before and "error" not in reply:
                out.append(f"(wid={wid}, seq={seq}) got a non-error reply "
                           "from a fenced server")
        accepted = [e for e, r in self.fence_replies if r.get("fenced")]
        if not accepted:
            out.append("no fence accepted despite epochs above the "
                       "server's")
        if not self.srv._fenced:
            out.append("server not fenced at quiescence")
        return out

    def close(self) -> None:
        _close_server(self.srv)


# ---------------------------------------------------------------------------
# Scenario 3: the offset journal (crash-recovery resolve(), exactly-once)
# ---------------------------------------------------------------------------

class MemJournal:
    """``OffsetJournal`` persisted to an in-memory dict standing in for
    the disk: a crash drops the journal OBJECT (RAM), the dict survives
    (the fsynced file). Overrides exactly the two seams the real class
    isolates persistence behind. Built lazily for the same import-cost
    reason as ``_NoDedupServer``."""

    _cls = None

    def __new__(cls, disk: dict):
        import json

        from distkeras_tpu_torch.streaming.journal import OffsetJournal

        if cls._cls is None:
            class _MemJournal(OffsetJournal):
                def __init__(self, disk):
                    self._disk = disk
                    OffsetJournal.__init__(self, "<mem-journal>")

                def _persist_locked(self):
                    self._disk["state"] = json.dumps(self._snapshot())

                def _load_one(self, path):
                    state = self._disk.get("state")
                    return json.loads(state) if state else None
            cls._cls = _MemJournal
        return cls._cls(disk)


class JournalScenario(Scenario):
    """The streaming plane's two-phase commit under every interleaving
    AND every crash point: 2 workers each ingest 2 records through the
    real ``intent -> commit RPC -> committed`` triple against a real
    ``PSServer`` and a shared ``MemJournal``. A crash kills both workers
    and the journal object; recovery loads a fresh journal from the
    surviving dict, runs the real ``resolve()`` against the server's
    surviving dedup evidence, then re-reads and re-sends whatever did not
    land — under fresh seqs from the real re-join's ``last_seq``.

    Invariants: after recovery every record offset folded into the
    center EXACTLY once (no loss, no double-train) and the journal holds
    all offsets committed with an empty out-of-order set."""

    name = "journal"
    WORKERS = 2
    RECORDS = 2  # offsets per worker

    def build(self, thread_factory: CoopThreadFactory) -> None:
        self.srv = _new_server(device=self.device)
        self.wids = list(range(self.WORKERS))
        for w in self.wids:
            _join(self.srv, w)
        self.disk: dict = {}
        self.journal = MemJournal(self.disk)
        self.offsets = {w: [w * self.RECORDS + i
                            for i in range(self.RECORDS)]
                        for w in self.wids}
        self.total = self.WORKERS * self.RECORDS
        #: god's-eye (wid, seq) -> offset map — the harness's view, NOT
        #: process RAM, so it survives the modeled crash for checking.
        self.sent: dict = {}
        self.next_seq = {w: 0 for w in self.wids}
        for w in self.wids:
            thread_factory(target=self._worker(w), name=f"w{w}")

    def _worker(self, wid: int):
        def script():
            for i, offset in enumerate(self.offsets[wid]):
                if i:
                    yield
                seq = self.next_seq[wid]
                self.next_seq[wid] += 1
                self.journal.intent(wid, seq, offset)
                self.sent[(wid, seq)] = offset
                yield
                _commit(self.srv, wid, seq)
                yield
                self.journal.committed(wid, offset)
        return script

    def check_step(self) -> List[str]:
        pairs = _fold_pairs(self.srv)
        if len(set(pairs)) != len(pairs):
            return [f"duplicate fold in commit_log: {pairs}"]
        return []

    def crash(self) -> None:
        self.journal = None  # RAM gone; self.disk (the "file") survives

    def finish(self) -> None:
        """Deterministic recovery — the streaming runtime's resume path
        in miniature. Runs on clean completion too (provably a no-op:
        no surviving intents, nothing uncommitted)."""
        journal = MemJournal(self.disk)
        journal.load()
        journal.resolve(
            {w: self.srv._last_seq.get(w, -1) for w in self.wids})
        done = journal.committed_offsets_upto(self.total)
        for w in self.wids:
            # Re-join recovers the seq watermark exactly like a restarted
            # trainer: dedup would eat any commit at or below last_seq.
            seq = int(_join(self.srv, w)["last_seq"]) + 1
            for offset in self.offsets[w]:
                if offset in done:
                    continue
                journal.intent(w, seq, offset)
                self.sent[(w, seq)] = offset
                _commit(self.srv, w, seq)
                journal.committed(w, offset)
                seq += 1
        self.journal = journal

    def check_final(self) -> List[str]:
        out = []
        fold_count = {o: 0 for w in self.wids for o in self.offsets[w]}
        for pair in _fold_pairs(self.srv):
            offset = self.sent.get(pair)
            if offset is None:
                out.append(f"fold of a never-sent commit: {pair}")
            else:
                fold_count[offset] += 1
        for offset, n in sorted(fold_count.items()):
            if n != 1:
                out.append(f"offset {offset} folded {n} times, want "
                           "exactly 1 (exactly-once broken)")
        done = self.journal.committed_offsets_upto(self.total)
        if done != set(range(self.total)):
            out.append(f"journal committed {sorted(done)}, want all of "
                       f"0..{self.total - 1}")
        if self.journal.skip_offsets():
            out.append("out-of-order set non-empty at quiescence: "
                       f"{sorted(self.journal.skip_offsets())}")
        if self.journal._intents:
            out.append(f"surviving intents after recovery: "
                       f"{self.journal._intents}")
        return out

    def close(self) -> None:
        _close_server(self.srv)


# ---------------------------------------------------------------------------
# Scenario 4: the aggregation tree's flush plane (no window folded twice
# at the root)
# ---------------------------------------------------------------------------

class TreeFlushScenario(Scenario):
    """An aggregator's flush racing its children's retransmits AND an
    upstream eviction: 2 children each send one commit twice (the
    lost-ACK retransmit) into a real ``AggregatorServer`` whose uplink
    dials a real, served root ``PSServer``; a flusher thread forwards
    combined windows (``_flush_once(force=True)`` — the tree node's
    drain path runs the same code); an evictor revokes the aggregator's
    root lease once (``revoke()`` — the deterministic stand-in for a
    lease lapse), so a flush can land evicted at any point relative to
    the absorbs. 7 steps, 630 schedules.

    The aggregator is never ``start()``ed (no real flusher thread, no
    heartbeats), so the explorer owns every interleaving; uplink RPCs
    are synchronous inside one atomic step, so the root is quiescent at
    every check point.

    Invariants: no child ``(wid, seq)`` double-absorbed at the
    aggregator; no combined window folded twice at the root (root
    commit_log pair uniqueness AND ``root.commits_total ==
    agg.forwarded``); the window-conservation ledger balances at EVERY
    step (``absorbed == forwarded_commits + lost_commits + open``) — an
    evicted flush must show up as a counted loss, never a silent gap,
    and never a re-fold."""

    name = "tree_flush"
    WORKERS = 2
    COMMITS = 1  # per child, each sent twice
    FLUSHES = 2

    def build(self, thread_factory: CoopThreadFactory) -> None:
        from distkeras_tpu_torch.netps.hier import AggregatorServer

        self.root = _new_server(device=self.device)
        self.root.start()
        self.agg = AggregatorServer(self.root.endpoint, lease_s=3600.0,
                                    flush_interval=3600.0,
                                    device=self.device)
        self.wids = list(range(self.WORKERS))
        for w in self.wids:
            _join(self.agg, w)
        self._prev_root_total = self.root.commits_total
        for w in self.wids:
            thread_factory(target=self._child(w), name=f"c{w}")
        thread_factory(target=self._flusher, name="flusher")
        thread_factory(target=self._evictor, name="evictor")

    def _child(self, wid: int):
        # original then lost-ACK retransmit, serially — the real client's
        # retry-then-advance loop against the AGGREGATOR, not the root
        sends = [(seq, attempt) for seq in range(self.COMMITS)
                 for attempt in (0, 1)]

        def script():
            for i, (seq, _attempt) in enumerate(sends):
                if i:
                    yield
                _commit(self.agg, wid, seq)
        return script

    def _flusher(self):
        for i in range(self.FLUSHES):
            if i:
                yield
            self.agg._flush_once(force=True)

    def _evictor(self):
        # The aggregator's root lease lapses mid-run: membership dropped
        # NOW, its next uplink RPC answers evicted (the client re-joins,
        # the in-flight window is a counted loss — never a retransmit).
        self.root.revoke(self.agg._up.worker_id)
        return
        yield  # pragma: no cover - makes the target a generator fn

    def check_step(self) -> List[str]:
        out = []
        agg_pairs = _fold_pairs(self.agg)
        if len(set(agg_pairs)) != len(agg_pairs):
            out.append(f"child commit double-absorbed: {agg_pairs}")
        root_pairs = _fold_pairs(self.root)
        if len(set(root_pairs)) != len(root_pairs):
            out.append(f"window folded twice at root: {root_pairs}")
        if self.root.commits_total < self._prev_root_total:
            out.append(f"root commits_total regressed: "
                       f"{self._prev_root_total} -> "
                       f"{self.root.commits_total}")
        self._prev_root_total = self.root.commits_total
        ledger = (self.agg.forwarded_commits + self.agg.lost_commits
                  + self.agg._acc_count)
        if self.agg.absorbed != ledger:
            out.append(f"conservation broken: absorbed={self.agg.absorbed} "
                       f"!= forwarded {self.agg.forwarded_commits} + lost "
                       f"{self.agg.lost_commits} + open "
                       f"{self.agg._acc_count}")
        return out

    def finish(self) -> None:
        # The tree node's close-path drain: one forced flush empties the
        # open window (forwarded, or a counted loss if it lands evicted).
        self.agg._flush_once(force=True)

    def check_final(self) -> List[str]:
        out = []
        want = self.WORKERS * self.COMMITS
        agg_pairs = _fold_pairs(self.agg)
        for w in self.wids:
            for seq in range(self.COMMITS):
                n = agg_pairs.count((w, seq))
                if n != 1:
                    out.append(f"child (wid={w}, seq={seq}) absorbed {n} "
                               "times, want exactly 1")
        if self.agg.absorbed != want:
            out.append(f"absorbed={self.agg.absorbed}, want {want}")
        if self.agg._acc_count:
            out.append(f"open window survived the forced drain: "
                       f"{self.agg._acc_count} commits")
        if (self.agg.forwarded_commits + self.agg.lost_commits
                != self.agg.absorbed):
            out.append(f"final ledger: forwarded {self.agg.forwarded_commits}"
                       f" + lost {self.agg.lost_commits} != absorbed "
                       f"{self.agg.absorbed}")
        if self.root.commits_total != self.agg.forwarded:
            out.append(f"root folded {self.root.commits_total} combined "
                       f"commits, aggregator forwarded "
                       f"{self.agg.forwarded} — a window folded twice or "
                       "vanished")
        root_pairs = _fold_pairs(self.root)
        if len(set(root_pairs)) != len(root_pairs):
            out.append(f"window folded twice at root: {root_pairs}")
        return out

    def close(self) -> None:
        import socket

        try:
            self.agg._up.leave()
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
        self.agg._up.close()
        _close_server(self.agg)
        # Poke the root's accept loop awake before joining it — without
        # this every schedule pays the full accept-poll interval in
        # close(), and 630 schedules of it blows the suite's budget.
        self.root._stop.set()
        try:
            host, port = self.root.endpoint.rsplit(":", 1)
            socket.create_connection((host, int(port)), timeout=1.0).close()
        except OSError:
            pass
        self.root.close()


# ---------------------------------------------------------------------------
# Suite + CLI
# ---------------------------------------------------------------------------

SCENARIOS = {
    "dedup": lambda: (DedupScenario, False),
    "fence": lambda: (FenceScenario, False),
    "journal": lambda: (JournalScenario, True),
    "tree_flush": lambda: (TreeFlushScenario, False),
}


def run_suite(names: Optional[Iterable[str]] = None,
              mutate: bool = False, device=None) -> List[ExploreResult]:
    """Explore ``names`` (default: every scenario) with every server's
    center on ``device`` (``None`` = the card, as ``PSServer`` reads it)."""
    results = []
    for name in (names or sorted(SCENARIOS)):
        cls, crash_points = SCENARIOS[name]()
        if mutate and name == "dedup":
            results.append(explore(
                lambda: DedupScenario(_NoDedupServer, device=device),
                crash_points=False))
        else:
            results.append(explore(lambda: cls(device=device),
                                   crash_points=crash_points))
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distkeras_tpu_torch.analysis.interleave",
        description="exhaustively model-check the dedup / fence / "
                    "journal / tree-flush machines across every thread "
                    "interleaving")
    parser.add_argument("--scenario", action="append", default=None,
                        choices=sorted(SCENARIOS),
                        help="run only this scenario (repeatable)")
    parser.add_argument("--mutate", action="store_true",
                        help="seed the no-dedup server mutation; exits 0 "
                             "only if the explorer CATCHES it")
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="where every server holds its center (default: "
                             "the card; raises without one)")
    args = parser.parse_args(argv)

    t0 = time.monotonic()
    results = run_suite(args.scenario, mutate=args.mutate,
                        device=args.device)
    wall = time.monotonic() - t0
    total_sched = sum(r.schedules for r in results)
    total_viol = sum(len(r.violations) for r in results)
    for r in results:
        print(f"interleave[{r.name}]: {r.complete} complete schedules, "
              f"{r.crashed} crash points, {r.transitions} transitions, "
              f"{len(r.violations)} violation(s)")
        for v in r.violations[:10]:
            print(f"  {v!r}")
        if len(r.violations) > 10:
            print(f"  ... and {len(r.violations) - 10} more")
    print(f"interleave: state space = {total_sched} schedules "
          f"({sum(r.transitions for r in results)} transitions) "
          f"in {wall:.1f}s")
    if args.mutate:
        caught = total_viol > 0
        print("interleave: seeded dedup mutation "
              + ("CAUGHT" if caught else "MISSED"))
        return 0 if caught else 1
    return 1 if total_viol else 0


if __name__ == "__main__":
    sys.exit(main())
