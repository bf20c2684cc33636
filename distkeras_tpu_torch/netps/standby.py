"""Warm-standby failover: a second PSServer tailing the primary's journal
(the port's copy of the JAX package's ``netps/standby.py``; the
``replicate`` and ``fence`` frames are the same, so a port standby tails a
JAX primary and a JAX standby tails a port primary).

:mod:`~distkeras_tpu_torch.netps.state` fixes the *durability* half (a
killed primary cold-restarts from its state dir); this module fixes the
*availability* half: a :class:`StandbyServer` is a real
:class:`~distkeras_tpu_torch.netps.server.PSServer` that

* **tails the primary's journal stream** over the wire (``replicate``
  request frames, advertised by the ``replication`` bit in
  :data:`~distkeras_tpu_torch.netps.wire.CAPS`): each reply is a batch of
  folded commits in their **wire dtype**, re-folded here with the recorded
  staleness, in the recorded order — staged through
  :func:`~distkeras_tpu_torch.netps.fold.stage_commit` and folded by one
  ``fold_commit`` launch a record on the standby's own stream (the plain
  twin on the CPU) — so the standby's center is the primary's, bit for
  bit, at every replicated index. A fresh, gapped or lagging standby gets
  one full state sync (``mode=snapshot``) and resumes tailing from there.
  Until it promotes it serves nothing: every client op answers the typed
  ``not_primary`` and the hardened client walks its endpoint list onward.

* **promotes itself when the primary's lease lapses**: no successful
  replicate for ``promote_after`` seconds (default: the membership lease)
  means the primary is gone. The standby bumps the epoch past everything
  it replicated, persists the promotion (``epoch.json`` in its state dir,
  if it has one), starts serving, and **fences the old lineage**: a
  ``fence`` frame is re-sent at the old primary for as long as this
  server lives, and every join reply now carries the new epoch, so a
  commit from the old lineage answers ``EpochFencedError`` (never folded)
  and a zombie ex-primary that sees a higher-epoch request fences itself.

* keeps the replicated dedup table, so a worker whose commit the dead
  primary ACKed retransmits to the promoted standby and is answered
  ``duplicate=True``; a commit the primary folded but never replicated is
  lost with it (the client retransmits and it folds once, here).

Promotion is lease-based, so a partition that separates the standby from
a *healthy* primary promotes a second lineage. The epoch fence keeps the
center from ever mixing lineages, but which one survives is decided by
which endpoints the clients reach, not by a quorum this two-node design
does not have.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.netps.errors import ProtocolError
from distkeras_tpu_torch.netps.fold import (decode_entry, fold_delta,
                                            stage_commit)
from distkeras_tpu_torch.netps.server import PSServer


class StandbyServer(PSServer):
    """A warm standby of the primary at ``primary_endpoint``.

    Accepts everything a :class:`PSServer` does (``state_dir`` gives the
    standby its own durable store, so a promoted-then-killed standby
    cold-restarts at its promoted epoch); ``promote_after`` defaults to the
    membership lease. ``start()`` begins replication; :attr:`promoted`
    flips once the standby has taken over.
    """

    def __init__(self, primary_endpoint: str, *,
                 promote_after: Optional[float] = None,
                 rpc_timeout: Optional[float] = None, **kw):
        super().__init__(standby=True, **kw)
        self.primary_endpoint = primary_endpoint
        self.promote_after = float(promote_after if promote_after is not None
                                   else self.lease_s)
        #: per-replicate deadline: must resolve well inside the promotion
        #: budget or a hung primary would stall the lapse detection.
        self.rpc_timeout = float(rpc_timeout if rpc_timeout is not None
                                 else max(0.2, self.promote_after / 3.0))
        self.promoted = False
        #: monotonic time of the promotion (None before it).
        self.promoted_at: Optional[float] = None
        #: replicated commits applied / full snapshot syncs taken.
        self.replicated = 0
        self.snapshot_syncs = 0
        #: the primary incarnation this standby's state descends from: a
        #: change means the primary restarted and may have LOST journal
        #: tail this standby already replicated, so local state is
        #: discarded and fully re-synced (the primary is authoritative).
        self._primary_lineage: Optional[str] = None
        self._repl_thread: Optional[threading.Thread] = None
        self._fence_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def start(self) -> "StandbyServer":
        if self._started:
            return self
        super().start()
        t = threading.Thread(target=self._replicate_loop,
                             name="netps-standby-replicate")
        t.start()
        self._repl_thread = t
        return self

    def close(self) -> None:
        self._stop.set()
        for t in (self._repl_thread, self._fence_thread):
            if t is not None:
                t.join()
        super().close()

    # ------------------------------------------------------------------
    def _replicate_loop(self) -> None:
        """Tail the primary until promotion (or close). A plain socket, not
        a PSClient, because the stream must arrive ``decode=False``:
        replicated deltas re-fold in their wire dtype, the arithmetic the
        primary ran and the journal replay runs."""
        sock: Optional[socket.socket] = None
        req = 0
        last_ok = time.monotonic()
        tick = max(0.02, min(self.promote_after / 4.0, 0.25))
        while not self._stop.is_set():
            caught_up = True
            try:
                if sock is None:
                    sock = socket.create_connection(
                        wire.split_endpoint(self.primary_endpoint),
                        timeout=self.rpc_timeout)
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                req += 1
                sock.settimeout(self.rpc_timeout)
                wire.send_frame(sock, wire.KIND_REQUEST,
                                {"op": wire.OP_REPLICATE, "u": self._next_u(),
                                 "req": req}, [])
                rhdr, rarrays = self._recv_reply(sock, req)
                err = rhdr.get("error")
                if err == "uninitialized":
                    # The primary is alive, just has no center yet.
                    last_ok = time.monotonic()
                elif err:
                    # A typed rejection (not_primary: the primary itself
                    # was fenced; protocol: a pre-replication peer). The
                    # peer is alive — do not promote over it — but this
                    # link cannot replicate; keep probing.
                    telemetry.counter(
                        "netps.failover.replicate_rejected").add(1)
                    last_ok = time.monotonic()
                else:
                    caught_up = self._apply(rhdr, rarrays)
                    last_ok = time.monotonic()
            except (socket.timeout, ConnectionError, OSError,
                    ProtocolError):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
            if time.monotonic() - last_ok > self.promote_after:
                self._promote()
                break
            if caught_up:
                self._stop.wait(tick)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _recv_reply(self, sock: socket.socket, req: int):
        """One matched reply, wire-dtype arrays (``decode=False``)."""
        while True:
            prefix = wire.recv_exact(sock, wire.PREFIX_SIZE)
            kind, _n, rhdr, rarrays = wire.finish_frame(sock, prefix,
                                                        decode=False)
            if kind != wire.KIND_REPLY:
                raise ProtocolError(f"expected a reply frame, got {kind}")
            if rhdr.get("req") == req:
                return rhdr, rarrays

    def _next_u(self) -> int:
        with self._lock:
            # Until a snapshot sync has armed the lineage token, ask for a
            # full sync even if we hold a center: a restarted standby's own
            # recovered state may descend from another primary incarnation.
            if self._flat is None or self._primary_lineage is None:
                return -1
            return self._updates

    def _drop_center_locked(self) -> None:
        """Forget the center (lock held): the next pull asks for a full
        sync."""
        self._flat, self._center, self._offsets = None, [], []
        self._host = None

    def _apply(self, rhdr: dict, rarrays: list) -> bool:
        """Apply one replicate reply; returns whether we are caught up
        (False = a full batch arrived, pull again immediately)."""
        applied = 0
        lineage = rhdr.get("lineage")
        with self._lock:
            self.epoch = max(self.epoch, int(rhdr.get("epoch", 0)))
            if (rhdr.get("mode") != "snapshot"
                    and self._primary_lineage is not None
                    and lineage != self._primary_lineage):
                # The primary restarted between replicates: same index,
                # possibly different history. Discard and full-sync.
                self._drop_center_locked()
                return False
            if rhdr.get("mode") == "snapshot":
                self._primary_lineage = lineage
                self._seat_locked([decode_entry(e) for e in rarrays])
                self._updates = int(rhdr["updates"])
                self._last_seq = {int(k): int(v) for k, v in
                                  (rhdr.get("last_seq") or {}).items()}
                self._ever |= set(self._last_seq)
                self.commits_total = int(rhdr.get("commits_total",
                                                  self._updates))
                # Wholesale adoption: earlier commit-log entries are not
                # evidence about the adopted history.
                self.commit_log.clear()
                self._log_dropped = self.commits_total
                self.snapshot_syncs += 1
                if self._store is not None:
                    self._snapshot_locked()
                caught_up = True
            else:
                records = rhdr.get("records") or ()
                off = 0
                for rec in records:
                    k = int(rec["k"])
                    delta = rarrays[off:off + k]
                    off += k
                    if int(rec["u"]) != self._updates:
                        # A gap (we asked for our exact index): the next
                        # pull requests a full sync.
                        self._drop_center_locked()
                        break
                    self._apply_record_locked(rec, delta)
                    applied += 1
                caught_up = len(records) < 1 or int(
                    rhdr.get("updates", self._updates)) <= self._updates
        if applied:
            self.replicated += applied
            telemetry.counter("netps.failover.replicated_commits").add(
                applied)
        return caught_up

    def _apply_record_locked(self, rec: dict, delta: list) -> None:
        """One journal record onto the local center (lock held): one fold
        on the standby's stream, then the bookkeeping the primary's fold
        ran, the standby's own journal included."""
        wid, seq, st = int(rec["wid"]), int(rec["seq"]), int(rec["st"])
        t0 = time.perf_counter()
        with self._on_stream():
            fold_delta(self._center, stage_commit(delta, self.device,
                                                  self._pool),
                       self.discipline, st)
        self.fold_seconds += time.perf_counter() - t0
        self._host = None
        self._record_fold_locked(wid, seq, st, list(delta),
                                 epoch=rec.get("e", 0),
                                 commits_total=rec.get(
                                     "n", self.commits_total + 1))

    # ------------------------------------------------------------------
    def _promote(self) -> None:
        """Take over: bump the epoch past everything replicated, persist
        it, start serving, and fence the old lineage."""
        with self._lock:
            self.epoch += 1
            self._not_primary = False
            if self._store is not None:
                self._store.write_epoch(self.epoch)
            epoch = self.epoch
            cold = self._flat is None
        self.promoted_at = time.monotonic()
        self.promoted = True
        telemetry.counter("netps.failover.promotions").add(1)
        telemetry.event("netps_promotion", {
            "epoch": epoch, "updates": self._updates,
            "replicated": self.replicated, "cold": cold})
        t = threading.Thread(target=self._fence_loop, args=(epoch,),
                             name="netps-standby-fence")
        t.start()
        self._fence_thread = t

    def _fence_loop(self, epoch: int) -> None:
        """Fence the old primary for as long as this server lives: it may
        be dead (a no-op), restarting (caught the moment it answers) or
        reachable all along (then IT refuses our fence typed, and we stop:
        we are the stale lineage there). A storeless zombie forgets a
        landed fence on restart, so the loop never ends on success."""
        interval = max(0.1, self.promote_after)
        while not self._stop.is_set():
            try:
                with socket.create_connection(
                        wire.split_endpoint(self.primary_endpoint),
                        timeout=self.rpc_timeout) as sock:
                    wire.send_frame(sock, wire.KIND_REQUEST,
                                    {"op": wire.OP_FENCE, "epoch": epoch,
                                     "req": 1}, [])
                    sock.settimeout(self.rpc_timeout)
                    rhdr, _ = self._recv_reply(sock, 1)
                if rhdr.get("error"):
                    return  # typed refusal: the peer outranks this epoch
            except (socket.timeout, ConnectionError, OSError,
                    ProtocolError):
                pass
            self._stop.wait(interval)
