"""Hierarchical two-level folds: a per-host aggregator in front of the root
(the port's counterpart of the JAX package's ``netps/hier.py``).

Flat topology: W workers -> root, W commits a round at the root's ingress.
With ``DKTPU_NET_HIER=1`` each host interposes an :class:`AggregatorServer`
— a real :class:`~distkeras_tpu_torch.netps.server.PSServer` its workers
join exactly like a root (same wire, same leases, same dedup, and the shm
ring when negotiated) — that **pre-combines** its workers' commits and
forwards ONE combined commit upstream a flush, cutting root ingress by the
worker fan-in.

Semantics, against the discipline rule (the reference's, unchanged):

* Worker-normalized deltas are **additive**: for every scale-1 discipline
  (downpour/adag/aeasgd/eamsgd) folding ``sum(d_i)`` equals folding each
  ``d_i`` in turn, so the flat and hierarchical topologies produce the
  same center (up to f32 summation order).
* The combined commit's **pull-time counter is the min** of its
  constituents': the root charges it the staleness of its *oldest*
  constituent (one DynSGD scale for the combined commit).
* The aggregator's update counter **mirrors the root's lineage**: it
  advances only when a flush lands and the fresh root center is re-pulled,
  so worker ``pulled`` counters — lease renewals, dedup, the staleness the
  workers are charged — are in root units. Workers' retransmits dedup
  here; the aggregator's own commits dedup at the root: exactly-once at
  both levels.
* A flush whose upstream commit is **evicted** (the aggregator's lease
  lapsed) or dies in flight loses that combined window, counted in
  :attr:`AggregatorServer.lost_windows` and named in a
  ``netps_lost_window`` event, never silently.

Flush policy: a combined commit leaves when every current member has
contributed (fan-in reached) or the window is older than
``flush_interval``, whichever comes first. Between flushes the aggregator
heartbeats upstream so its root lease never lapses while workers are slow.

**The pre-combine runs on the server's device.** The window accumulator is
the tensor the server seats: one flat f32 tensor with one view a center
tensor (:func:`~distkeras_tpu_torch.netps.fold.seat_center`'s layout, which
a staged commit's default offsets address), filled with ``-0.0`` between
windows — ``-0.0 + x`` is ``x`` for every x, so the first absorb leaves the
bits the reference's copy of the decoded commit has. Each absorbed commit
is staged outside the lock like any commit and folded by
:func:`~distkeras_tpu_torch.netps.fold.fold_staged` at scale 1: one
``fold_commit`` launch on the server's stream, under the lock, after the
conservation check; the reference decodes each entry to f32 and adds it,
which the kernel does bit for bit (an int8 entry of scale 0, which the
kernel skips, is decoded on the host before staging, so its ``+0.0`` lands
as the reference's add lands it). At take time the window comes to host
memory in one device-to-host copy on the server's stream
(:func:`~distkeras_tpu_torch.netps.fold.host_mirror`, which waits on that
stream), goes upstream as the reference's f32 combined commit, and the
accumulator is reset. The center served to children is the adopted root
center, held only as the host mirror and replaced wholesale at each
re-pull: the aggregator never folds into it, so it never goes to the
device and back.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps.errors import NetPSError
from distkeras_tpu_torch.netps.fold import (check_discipline, counter_scalar,
                                            exact_zero_scale, fold_staged,
                                            host_mirror)
from distkeras_tpu_torch.netps.server import PSServer
from distkeras_tpu_torch.netps.shards import make_ps_client
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.runtime.device import resolve_device
from distkeras_tpu_torch.telemetry import tracing

#: default seconds an under-fan-in window may age before it is flushed
#: anyway (a straggler must not hold the whole host's progress).
_FLUSH_INTERVAL_S = 0.02

#: constituent ``(wid, seq)`` pairs a window keeps for the lost-window and
#: drop events (the reference's bound).
_PAIRS_KEEP = 512


def _read_only(center) -> list:
    """The adopted root center as read-only f32 arrays: replies hand them
    out after the lock is released (a mesh worker gets them as they are),
    so nobody may write into them."""
    out = []
    for a in center:
        a = np.asarray(a, np.float32)
        a.flags.writeable = False
        out.append(a)
    return out


class _AbsorbWindow:
    """The absorbing half of an aggregator, mixed into
    :class:`AggregatorServer` and, in a tree, into the warm standby that
    becomes one at promotion (which must not dial upstream before then, so
    none of this lives in a constructor). The host class is a
    :class:`PSServer` that provides ``_flush_once``,
    ``_heartbeat_upstream`` and the ``_up`` client, and calls
    :meth:`_init_absorb_state` and sets ``_flush_cv`` (a condition on the
    server lock), ``upstream``, ``flush_interval`` and ``fan_in``.

    Its journal holds absorbed worker deltas, which never fold into the
    served center (the root's): a restart recovers the dedup table, epoch
    and cursor from it without replaying a fold."""

    _replay_journal = False

    def _init_absorb_state(self) -> None:
        """The open window's accounting and the ledger's counters."""
        if not hasattr(self, "_absorbs"):
            self._absorbs = 0
        #: the open window: its commit count (0 = empty, the accumulator
        #: at -0.0), its min pull counter and its start time.
        self._acc_pulled: Optional[int] = None
        self._acc_count = 0
        self._acc_t0 = 0.0
        #: DISTINCT contributors to the open window: the fan-in check
        #: counts members heard from, not commits.
        self._acc_members: set = set()
        #: constituent (wid, seq) identities of the open window, named by a
        #: lost window's ``netps_lost_window`` event (bounded).
        self._acc_pairs: list = []
        #: trace ids of the open window's traced commits, linked from the
        #: combined commit's ``hier.flush`` trace (bounded).
        self._acc_traces: list = []
        #: combined commits forwarded upstream / worker commits absorbed.
        self.forwarded = 0
        self.absorbed = 0
        #: worker commits inside forwarded combined commits; with the lost
        #: (and, in a tree, dropped and buffered) ones, the ledger.
        self.forwarded_commits = 0
        self.lost_windows = 0
        self.lost_commits = 0

    # -- the device window ---------------------------------------------
    def _adopt_locked(self, center) -> None:
        """Serve ``center`` (the root's) to children from now on (lock
        held): it becomes the host mirror, replaced wholesale. A server
        with no device window yet (a cold tree standby) seats one shaped
        like it, empty."""
        host = _read_only(center)
        if self._flat is None:
            self._seat_locked(host)
            self._reset_window_locked()
        self._host = host

    def _reset_window_locked(self) -> None:
        """An empty window: the accumulator at ``-0.0`` everywhere, on the
        server's stream (after any take's copy on it)."""
        with self._on_stream():
            self._flat.fill_(-0.0)

    def _take_window_locked(self) -> list:
        """The open window's sum as host f32 arrays, one device-to-host
        copy on the server's stream, waited on that stream alone; then the
        accumulator is reset for the next window."""
        acc = host_mirror(self._flat, self._offsets, self._center,
                          self._stream)
        self._reset_window_locked()
        return acc

    def _stop_flusher(self) -> None:
        """Wake the flusher out of its wait (the server is stopped) and
        join it."""
        t = self._flusher_thread
        if t is not None:
            with self._flush_cv:
                self._flush_cv.notify_all()
            t.join()

    def set_fan_in(self, fan_in: Optional[int]) -> None:
        """Retune the flush fan-in mid-run (the tuner's HIER lever,
        ``netps/tuner/controller.py``): ``None`` combines the full
        membership, ``1`` makes the aggregator a pass-through forwarder.
        Wakes the flusher so a now-satisfied window flushes at once; the
        open window's accounting is untouched."""
        with self._flush_cv:
            self.fan_in = fan_in
            self._flush_cv.notify_all()

    def _op_commit(self, header: dict, arrays: list) -> tuple[dict, list]:
        return super()._op_commit(header,
                                  [exact_zero_scale(e) for e in arrays])

    def _fold_locked(self, wid: int, seq: int, pulled, staged,
                     wire_delta: list) -> int:
        """Absorb one worker commit (lock held): one ``fold_commit`` launch
        at scale 1 into the device window, the min pull counter, and the
        usual exactly-once bookkeeping — but the update counter (the root
        lineage) does not move and the center (the root's) is untouched."""
        pulled = counter_scalar(pulled)
        staleness = self._updates - pulled
        with tracing.child_scope("commit.fold", wid=wid, seq=seq,
                                 hier=True):
            t0 = time.perf_counter()
            with self._on_stream():
                fold_staged(self._center, staged, 1.0)
            dt = time.perf_counter() - t0
        ctx = tracing.current()
        if ctx is not None and len(self._acc_traces) < 64:
            self._acc_traces.append(ctx.trace)
        self._fold_stats = (len(staged.rows), dt)
        self.fold_seconds += dt
        if not self._acc_count:
            self._acc_pulled = pulled
            self._acc_t0 = time.monotonic()
        else:
            self._acc_pulled = min(self._acc_pulled, pulled)
        self._acc_count += 1
        self._acc_members.add(wid)
        if len(self._acc_pairs) < _PAIRS_KEEP:
            self._acc_pairs.append((wid, seq))
        self.absorbed += 1
        self.commit_log.append((wid, seq, staleness))
        self._last_seq[wid] = seq
        self.commits_total += 1
        # Durability tail, absorb order = journal order, indexed by the
        # absorb cursor. A storeless, standby-less aggregator pays nothing.
        u = self._absorbs
        self._absorbs += 1
        if self._repl_on:
            rec = {"u": u, "wid": wid, "seq": seq, "st": staleness,
                   "e": self.epoch, "n": self.commits_total,
                   "delta": list(wire_delta)}
            if ctx is not None:
                rec["tr"] = ctx.trace
            self._repl.append(rec)
        if self._store is not None:
            with tracing.child_scope("commit.fsync", wid=wid, seq=seq):
                self._store.append(epoch=self.epoch, wid=wid, seq=seq,
                                   staleness=staleness, updates=u,
                                   commits_total=self.commits_total,
                                   delta=list(wire_delta))
                if self._store.due(self._absorbs):
                    self._snapshot_locked()
        self._trim_log_locked(2 * self._log_keep)
        self._purge_pending(wid, below_seq=seq)
        self._flush_cv.notify_all()
        return staleness

    def _repl_cursor_locked(self) -> int:
        return self._absorbs

    def _window_due_locked(self) -> bool:
        """Whether the open window should leave now (lock held): every
        current member contributed, or it is older than
        ``flush_interval``."""
        if not self._acc_count:
            return False
        fan = self.fan_in if self.fan_in else max(1, len(self._members))
        return (len(self._acc_members) >= fan
                or time.monotonic() - self._acc_t0 >= self.flush_interval)

    def _take_acc_locked(self, force: bool):
        """The open window as ``(acc, pulled, count, members, traces,
        pairs)`` when it is due (fan-in reached, older than
        ``flush_interval``, or ``force``), else None."""
        if not self._acc_count or not (force or self._window_due_locked()):
            return None
        taken = (self._take_window_locked(), self._acc_pulled,
                 self._acc_count, len(self._acc_members), self._acc_traces,
                 self._acc_pairs)
        self._acc_pulled = None
        self._acc_count = 0
        self._acc_members = set()
        self._acc_traces = []
        self._acc_pairs = []
        return taken

    def _lose_window(self, pairs: Sequence = (), count: int = 1) -> None:
        """One combined window died (in flight, or landed evicted): count it
        AND name its constituents."""
        self.lost_windows += 1
        self.lost_commits += int(count)
        telemetry.counter("netps.hier.lost_windows").add(1)
        telemetry.event("netps_lost_window", {
            "count": int(count),
            "windows": [[int(w), int(s)] for w, s in pairs]})

    def _count_forwarded(self, count: int, members: int) -> None:
        self.forwarded += 1
        self.forwarded_commits += count
        telemetry.counter("netps.hier.combined_commits").add(1)
        telemetry.counter("netps.hier.worker_commits").add(count)
        # Distinct contributors, not commits: an overlapping worker's
        # double commit must not read as a wider fan-in.
        telemetry.gauge("netps.hier.fan_in").set(float(members))

    def _resync(self) -> None:
        """Re-adopt the root-lineage center and counter (best effort: a
        failure waits for the next flush). The pull doubles as the
        membership re-proof — the client's auto-rejoin restores a lapsed
        lease without consuming a commit seq."""
        try:
            center, updates = self._up.pull()
        except (NetPSError, OSError):
            return
        with self._lock:
            self._adopt_locked(center)
            self._updates = counter_scalar(updates)

    def _flusher_loop(self) -> None:
        lease = (getattr(self._up, "lease_s", None)
                 or config.env_float("DKTPU_PS_LEASE"))
        # The heartbeat fires only after a wait returns, so the wait must
        # never outlast the renewal deadline: a flush_interval above
        # lease/3 would let the root lease lapse across an idle stretch.
        wait_s = self.flush_interval
        if lease:
            wait_s = min(wait_s, max(0.001, float(lease) / 3.0))
        last_rpc = time.monotonic()
        while not self._stop.is_set():
            with self._flush_cv:
                # A window that came due while the last flush ran was
                # notified to nobody: flush it now, not a wait later.
                if not self._window_due_locked():
                    self._flush_cv.wait(wait_s)
            if self._flush_once(force=False):
                last_rpc = time.monotonic()
            elif time.monotonic() - last_rpc > float(lease) / 3.0:
                self._heartbeat_upstream()
                last_rpc = time.monotonic()


class AggregatorServer(_AbsorbWindow, PSServer):
    """A per-host pre-combining parameter server (see module docstring).

    ``upstream`` is the root's endpoint (a failover list, or a ``;`` shard
    matrix dialed through :func:`~distkeras_tpu_torch.netps.shards.
    make_ps_client`, with ``plan`` the partition plan when the caller has
    one, and ``compress`` the uplink's requested codec); ``init`` seeds
    an uninitialized root (the aggregator joins
    upstream as ONE worker and adopts the root's center and counter).
    Everything a :class:`PSServer` accepts — discipline, lease, transport
    (the shm ring included), ``device`` (the card by default; ``"cpu"``
    pre-combines through the fold's plain twin) — applies to the local side.
    """

    def __init__(self, upstream: str,
                 init: Optional[Sequence[np.ndarray]] = None,
                 discipline: str = "adag", host: str = "127.0.0.1",
                 port: int = 0, lease_s: Optional[float] = None,
                 transport: Optional[str] = None,
                 flush_interval: float = _FLUSH_INTERVAL_S,
                 fan_in: Optional[int] = None,
                 timeout: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff: Optional[float] = None,
                 state_dir: Optional[str] = None,
                 snapshot_every: Optional[int] = None,
                 epoch: int = 0, device=None, plan=None,
                 compress: Optional[str] = None):
        # Validate BEFORE the upstream join: a bad discipline or a missing
        # card must not leak a phantom root membership (the client
        # validates the transport).
        check_discipline(discipline)
        resolve_device(device)
        # Before super().__init__: a fresh state dir snapshots from the
        # PSServer ctor, and this class's snapshot reads the absorb cursor.
        self._absorbs = 0
        self._up = make_ps_client(upstream, plan=plan, timeout=timeout,
                                  retries=retries, backoff=backoff,
                                  transport=transport, compress=compress)
        try:
            center, updates = self._up.join(init=list(init or ()))
            super().__init__(center=center, discipline=discipline,
                             host=host, port=port, lease_s=lease_s,
                             device=device, transport=transport,
                             state_dir=state_dir,
                             snapshot_every=snapshot_every, epoch=epoch)
        except BaseException:
            try:
                self._up.leave()
            except Exception:  # noqa: BLE001 - best effort on teardown
                pass
            self._up.close()
            raise
        if state_dir:
            # The recovered update counter IS the absorb cursor (the journal
            # is indexed by absorbs; the root-lineage counter moves only on
            # a re-pull). Recovery kept the journal's dedup table, epoch and
            # commits_total and folded nothing; the upstream center just
            # re-pulled by the join above is the one served.
            self._absorbs = int(self._updates)
        with self._lock:
            self._adopt_locked(center)
            self._reset_window_locked()
        self._updates = counter_scalar(updates)  # root lineage, not local
        self.upstream = upstream
        self.flush_interval = float(flush_interval)
        self.fan_in = fan_in
        self._init_absorb_state()
        self._flush_cv = threading.Condition(self._lock)
        self._flusher_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def start(self) -> "AggregatorServer":
        if self._started:
            return self
        super().start()
        t = threading.Thread(target=self._flusher_loop,
                             name="netps-hier-flush")
        t.start()
        self._flusher_thread = t
        return self

    def close(self) -> None:
        """Drain local commits, stop the server, then flush the remainder
        upstream and leave: the root holds every absorbed commit before
        this returns, except windows lost to an upstream eviction or an
        outage past the retry budget, counted in :attr:`lost_windows`."""
        self.drain()
        super().close()  # joins handlers: no new local commits past here
        self._stop_flusher()
        self._flush_once(force=True)  # accounts its own failures
        try:
            self._up.leave()
        except (NetPSError, OSError):
            pass
        self._up.close()

    # ------------------------------------------------------------------
    def _snapshot_locked(self) -> None:
        """The snapshot's cursor is the absorb cursor (the journal's ``u``
        fields); its center is the adopted root center, a restarted
        aggregator's recovery base until it re-pulls upstream."""
        t0 = time.perf_counter()
        self._store.snapshot(center=self._host_center_locked(),
                             updates=self._absorbs, last_seq=self._last_seq,
                             epoch=self.epoch,
                             commits_total=self.commits_total)
        self.snapshot_seconds += time.perf_counter() - t0
        self.snapshots_written += 1
        self._trim_log_locked(self._log_keep + 1)

    # ------------------------------------------------------------------
    def _flush_once(self, force: bool) -> bool:
        """Forward the due window upstream (outside the lock) and re-adopt
        the root's center and counter. Returns whether a flush was
        attempted. Never raises for upstream failures; each outcome is
        accounted once: a commit that dies in flight or lands evicted is
        ONE lost window; a pull failure after a landed commit is not (the
        re-sync waits for the next flush)."""
        with self._lock:
            taken = self._take_acc_locked(force)
        if taken is None:
            return False
        acc, pulled, count, members, traces, pairs = taken
        try:
            # The combined commit gets its own trace, LINKING the
            # constituent worker traces (a fan-in is a DAG, not a tree:
            # links connect one upstream fold to its N origins).
            with tracing.trace_scope("hier.flush", count=count,
                                     links=traces[:16]):
                res = self._up.commit(acc, pulled)
        except (NetPSError, OSError):
            self._lose_window(pairs, count)
            return True
        if res.evicted:
            # The root lease lapsed with this window pending: discarded
            # upstream. The client already re-joined; re-adopt below.
            self._lose_window(pairs, count)
        else:
            self._count_forwarded(count, members)
        self._resync()
        return True

    def _heartbeat_upstream(self) -> None:
        try:
            self._up.heartbeat()
        except (NetPSError, OSError):
            pass  # lease renewal is best-effort between flushes
