"""The networked parameter server with its center on the card (the port's
counterpart of the JAX package's ``netps/server.py``; the frames are the
same, so either package's client talks to either package's server).

``DeltaParameterServer``/``ADAGParameterServer`` re-created: a TCP
listener, **one handler thread per connection**, and a center variable
folded under a plain lock, with the production edges of the JAX server:

* **Idempotent commits.** Every commit carries a client-assigned
  ``(worker_id, seq)``; the server folds a given seq at most once and
  answers a retransmit (lost ACK) with ``applied=False, duplicate=True``.
  Assert it on :attr:`PSServer.commit_log`.
* **Lease-based elastic membership.** ``join`` grants a lease; ``pull`` /
  ``commit`` / ``heartbeat`` renew it; a monitor thread evicts workers whose
  lease expires, and an evicted (or brand-new) worker can ``join`` mid-run.
* **Graceful drain.** :meth:`close` stops accepting commits (clients get a
  typed ``ServerDrainingError``), then tears the listener and every thread
  down (all joined).

**The center lives on** ``device`` (``None`` means the first CUDA device,
and raises without one) as f32 views into one flat tensor, each view at a
64-byte offset (``ops/kernels/fold.py center_layout``). Commits arrive in
their wire dtype (the handlers read frames with ``decode=False``), are
staged outside the lock (:func:`~distkeras_tpu_torch.netps.fold.
stage_commit`: one packed buffer, one copy) and fold in place through
:func:`~distkeras_tpu_torch.netps.fold.fold_delta`: one launch of the CUDA
fold kernel a commit on the card, the plain twin on the CPU. Every read
(pull and join replies, :meth:`center`) comes from a host mirror,
refreshed by ONE device-to-host copy of the flat tensor under the lock on
the first read after a fold and replaced wholesale, never written in
place, so replies may hold it after the lock is released.

**On the card the server works on a stream of its own**, at the highest
priority PyTorch offers: seating the center, the staging copies (from a
pool of pinned buffers), the fold and the mirror's copy back all go there,
and the server waits on that stream alone, never on the device. So a
commit and a pull do not queue behind the kernels that training threads
of the same process put on the default stream. The flat center and the
staging buffers are allocated under that stream, so the caching allocator
never hands their blocks to another stream early.

**Durable state** (``state_dir``, :mod:`~distkeras_tpu_torch.netps.
state`): every fold is journaled in its wire dtype (the commit frame's own
arrays, not the staged buffer, whose pinned slot is reused), under the
lock, because fold order is journal order; the center is snapshotted every
``snapshot_every`` folds; a server built on a directory with state
recovers it — the snapshot seated on the device, each journal record
folded by one ``fold_commit`` launch on the server's stream. **Failover**
(:mod:`~distkeras_tpu_torch.netps.standby`): the ``replicate`` op serves a
warm standby a bounded wire-form tail of the folded commits (or one full
sync), and the epoch fence (``fence`` op, the ``epoch`` every member op
carries) keeps a stale lineage from ever folding.

**Transports** (``transport=``, default ``DKTPU_NET_TRANSPORT``): TCP
always. A ``shm`` server also serves the same-host shared-memory ring
(:mod:`~distkeras_tpu_torch.netps.shm`): a Unix-domain doorbell listener,
advertised with this host's boot id in the join reply, the payloads in the
client's memory segments. A ``mesh`` server serves the ring too (the
demotion target) and registers an in-process dispatch
(:mod:`~distkeras_tpu_torch.netps.mesh`): a worker thread of this process
hands its commit straight to the op dispatch, no frame and no copy
(``netps.mesh.folds`` counts the commits folded that came that way). Same
handlers, same dispatch, same fold into the one device center, same
guarantees in every dialect; a fold that fails on the card raises in all
of them.

**Striping** (``CAPS["striping"]``): a client may split one logical
pull or commit by tensors over several connections. A striped pull
answers the stripe's tensors (``idx``) with the update counter the client
cross-checks; a striped commit's stripes (one ``seq``, ``num_shards``,
``idx``) are stashed under the lock until the set is complete, then the
assembled commit is staged and folded ONCE — one ``fold_commit`` launch
however many stripes carried it — and a retransmitted stripe of a folded
commit is answered as a duplicate. Half-assembled stripe sets are dropped
on eviction and re-join.

**Shards** (``netps/shards/``): a server built with ``shard_index`` and
``shard_count`` holds one slice of a :class:`~distkeras_tpu_torch.netps.
shards.plan.PartitionPlan`'s center. It admits only joiners that carry
the ``sharding`` capability, claim its index and prove the plan by hash
(every rejection the typed ``shard_plan`` error), adopts the plan from the
first join when started empty, persists it as ``<state_dir>/plan.json``
(which a restart adopts and holds later joins to, in either package), and
re-proves it with ``plan_hash`` on every pull.

**Chaos** (``DKTPU_NET_FAULTS`` in the server's own process):
``ps_hang@R:S`` and ``ps_crash@R`` fire before commit ``R`` is folded, and
``shard_crash@N:R`` kills shard N once it has folded R commits
(:meth:`PSServer._chaos_hooks`, :meth:`PSServer._crash_hook_locked`).

**The tuner's probe** (``CAPS["tuner"]``, op ``probe``): a timed round
trip that pays the commit path's real decode cost and touches nothing
else. The payload is validated like a commit's, staged in its own layout
and decoded by one scale-1 ``fold_commit`` launch into the server's
scratch window at ``-0.0`` (:class:`~distkeras_tpu_torch.netps.fold.
ProbeWindow`), outside the center lock; the lock is taken only for the
epoch fence and to renew a member's lease. A probe never creates
membership, consumes a seq, folds into the center, journals or dedups;
the reply says how many f32 bytes were decoded (``probe_bytes``) and how
long the decode took on the device (``decode_s``).

The JAX server's tracing comes with a later slice; a peer learns that from
the join reply's ``caps``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import signal
import socket
import tempfile
import threading
import time
import uuid
from typing import Optional, Sequence, Union

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import mesh as _mesh
from distkeras_tpu_torch.netps import shm
from distkeras_tpu_torch.netps import state as _state
from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.netps.errors import ProtocolError
from distkeras_tpu_torch.netps.fold import (STREAM_PRIORITY, PinnedPool,
                                            ProbeWindow, backend_name,
                                            check_discipline,
                                            counter_staleness, decode_entry,
                                            fold_delta, host_mirror,
                                            seat_center, split_entry,
                                            stage_commit, validate_delta)
from distkeras_tpu_torch.ops.kernels import fold as fold_kernels
from distkeras_tpu_torch.resilience import faults as _faults
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.runtime.device import resolve_device

#: handler/accept poll tick: how often blocked threads wake to check stop.
_POLL_S = 0.2
#: once a frame's first bytes arrive, the rest must land within this —
#: a peer that stalls mid-frame is dead, not idle.
_FRAME_COMPLETE_S = 30.0
#: in-memory commit-log bound: the evidence list is trimmed to this once it
#: doubles it, and at snapshot time (dropped entries stay counted in
#: ``commits_total``).
_COMMIT_LOG_KEEP = 65536
#: replication tail depth: folded commits kept (in wire form) for a
#: standby's ``replicate`` pulls; a standby further behind gets a full
#: snapshot sync instead.
_REPL_BUFFER = 64
#: max journal records per ``replicate`` reply (bounds the frame size).
_REPL_BATCH = 16


class PSServer:
    """One center variable on ``device``, served over TCP to N worker
    clients.

    ``center=None`` starts uninitialized: the first ``join`` carrying init
    arrays seeds it (so a CLI-launched server needs no model knowledge —
    the workers bring the parameters). ``lease_s`` defaults to
    ``DKTPU_PS_LEASE``. ``state_dir`` makes the center durable (and, when
    the directory holds state, recovers it: the disk is authoritative over
    ``center``); ``snapshot_every`` defaults to
    ``DKTPU_PS_SNAPSHOT_EVERY``. ``epoch`` is the primary epoch this server
    starts at; ``standby=True`` serves nothing until promoted (what
    :class:`~distkeras_tpu_torch.netps.standby.StandbyServer` passes).
    ``transport`` (``tcp``, ``shm`` or ``mesh``; default
    ``DKTPU_NET_TRANSPORT``) picks the dialects served beside TCP.
    ``shard_index``/``shard_count`` make it shard K of an N-shard center,
    ``shard_plan`` (a :class:`~distkeras_tpu_torch.netps.shards.plan.
    PartitionPlan` or its dict) the plan it serves; without one it adopts
    the first joiner's. A ``plan.json`` in ``state_dir`` is authoritative
    over both.
    """

    #: whether recovery folds the journal into the recovered center (an
    #: aggregator's journal holds absorbed windows, never folded there).
    _replay_journal = True

    def __init__(self, center: Optional[Sequence[np.ndarray]] = None,
                 discipline: str = "adag", host: str = "127.0.0.1",
                 port: int = 0, lease_s: Optional[float] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 state_dir: Optional[str] = None,
                 snapshot_every: Optional[int] = None,
                 epoch: int = 0,
                 standby: bool = False,
                 transport: Optional[str] = None,
                 shard_index: Optional[int] = None,
                 shard_count: Optional[int] = None,
                 shard_plan=None):
        self.discipline = check_discipline(discipline)
        #: sharded-center identity: which slice of which PartitionPlan this
        #: server holds. ``None`` index means a plain (whole-center) server.
        #: The plan may arrive later: a shard launched empty adopts it from
        #: the first join and persists it next to the journal.
        self.shard_index = None if shard_index is None else int(shard_index)
        self.shard_count = (int(shard_count) if shard_count is not None
                            else (None if self.shard_index is None else 1))
        if self.shard_index is not None and not (
                0 <= self.shard_index < self.shard_count):
            raise ValueError(f"shard index {self.shard_index} outside "
                             f"0..{self.shard_count - 1}")
        self.shard_plan = None
        if shard_plan is not None:
            from distkeras_tpu_torch.netps.shards import plan as _plan_mod
            self.shard_plan = (shard_plan if isinstance(
                shard_plan, _plan_mod.PartitionPlan)
                else _plan_mod.PartitionPlan.from_dict(shard_plan))
        self.transport = (transport if transport is not None
                          else shm.transport_mode())
        if self.transport not in shm.TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r}; "
                             f"known: {list(shm.TRANSPORTS)}")
        self.device = resolve_device(device)
        #: the server's own stream and its pinned staging buffers (on the
        #: card; None on the CPU).
        self._stream = self._pool = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device,
                                             priority=STREAM_PRIORITY)
            self._pool = PinnedPool()
        #: the probe op's scratch window (never the center).
        self._probe = ProbeWindow(self.device, self._stream, self._pool)
        self._lock = threading.Lock()
        #: the center: f32 views (one per tensor) into one flat tensor on
        #: ``device``, at ``_offsets`` (``center_layout``); None until the
        #: first init.
        self._flat: Optional[torch.Tensor] = None
        self._center: list = []
        self._offsets: list = []
        #: the host mirror: read-only numpy views of one host copy of
        #: ``_flat``; None when a fold made it stale.
        self._host: Optional[list] = None
        self._mesh_token: Optional[str] = None
        if center is not None:
            self._seat_locked([np.asarray(a, np.float32) for a in center])
        self._updates = 0
        self.lease_s = float(lease_s if lease_s is not None
                             else config.env_float("DKTPU_PS_LEASE"))
        #: worker_id -> lease deadline (monotonic seconds).
        self._members: dict = {}
        #: worker_id -> highest folded commit seq (survives eviction, so a
        #: pre-eviction retransmit is still deduped after a rejoin).
        self._last_seq: dict = {}
        #: every worker_id ever admitted (rejoin accounting + id assignment).
        self._ever: set = set()
        #: primary epoch: member ops carry it; a request from a lineage this
        #: server no longer honors (or that no longer honors this server) is
        #: fenced, never folded. Bumped only by a standby's promotion.
        self.epoch = int(epoch)
        #: a higher epoch exists somewhere: this server is the zombie and
        #: never folds again (member ops answer ``not_primary``).
        self._fenced = False
        #: a warm standby serves nothing until it promotes.
        self._not_primary = bool(standby)
        #: all commits ever folded — ``commit_log`` is the bounded tail of
        #: it (``len(commit_log) + dropped == commits_total`` always).
        self.commits_total = 0
        self.snapshots_written = 0
        #: host seconds spent writing snapshots (the fsync included).
        self.snapshot_seconds = 0.0
        self._log_dropped = 0
        self._log_keep = _COMMIT_LOG_KEEP
        #: per-incarnation lineage token, echoed on every ``replicate``
        #: reply: a restarted primary may have LOST the tail of its fold
        #: history (the bounded journal writer's queue died with it), so a
        #: standby that sees the token change discards its state and
        #: full-syncs — same fold index, possibly different history.
        self.lineage = uuid.uuid4().hex
        #: replication tail of wire-form records; populated only once a
        #: standby's first ``replicate`` arrives.
        self._repl: collections.deque = collections.deque(
            maxlen=_REPL_BUFFER)
        self._repl_on = False
        #: striped commits awaiting assembly: (worker_id, seq) ->
        #: {stripe: (idx tuple, wire entries)}. The stripe that completes
        #: the set triggers the one fold; purged on eviction and (re)join.
        self._pending: dict = {}
        #: applied commits in fold order: (worker_id, seq, staleness) — the
        #: exactly-once evidence.
        self.commit_log: list = []
        #: (tensors, seconds) of the most recent fold — written under the
        #: lock, exported as the fold-throughput gauge after release.
        self._fold_stats = (0, 0.0)
        #: seconds spent in folds so far (host clock around each fold).
        self.fold_seconds = 0.0
        #: journal records the construction-time recovery folded, and its
        #: wall seconds (the server stream synchronized at its end).
        self.recovered_records = 0
        self.recovery_seconds = 0.0
        #: durable state: journal + snapshots + recovery.
        self._store: Optional[_state.StateStore] = None
        if state_dir:
            self._store = _state.StateStore(state_dir, snapshot_every)
            if self.device.type == "cuda":
                fold_kernels.prepare()  # replay launches the fold kernel
            with self._on_stream():
                rec = self._store.recover(self.discipline, self.device,
                                          self._pool, seat=self._seat_locked,
                                          replay=self._replay_journal)
            if rec is not None:
                # A restart resumes the folded lineage, it does not reseed.
                self._updates = rec.updates
                self._last_seq = dict(rec.last_seq)
                self._ever = set(rec.last_seq)
                self.epoch = max(self.epoch, rec.epoch)
                self.commits_total = rec.commits_total
                # A fence that landed on the previous incarnation is
                # durable: the zombie stays a zombie across restarts.
                self._fenced = rec.fenced
                # The pre-crash commits are not in this incarnation's log.
                self._log_dropped = rec.commits_total
                self.recovered_records = rec.replayed
                self.recovery_seconds = rec.replay_seconds
                self._host = None
            self._store.open_journal(self._updates)
            if self._flat is not None and rec is None:
                # Ctor-seeded center with a fresh dir: anchor the journal
                # with the base snapshot a recovery will replay onto.
                self._snapshot_locked()
        #: durable plan identity: a restarted shard must refuse a client
        #: whose plan drifted from the lineage on disk, so the plan file is
        #: authoritative over any ctor-passed plan (the center's rule).
        self._plan_path = (os.path.join(state_dir, "plan.json")
                           if state_dir else None)
        if self._plan_path is not None and os.path.exists(self._plan_path):
            from distkeras_tpu_torch.netps.shards import plan as _plan_mod
            with open(self._plan_path, "r", encoding="utf-8") as f:
                saved = json.load(f)
            self.shard_plan = _plan_mod.PartitionPlan.from_dict(
                saved["plan"])
            if self.shard_index is None:
                self.shard_index = int(saved["shard_index"])
                self.shard_count = self.shard_plan.num_shards
        elif self.shard_plan is not None:
            self._persist_plan_locked()
        self.evictions = 0
        self.rejoins = 0
        self._draining = False
        self._stop = threading.Event()
        self._listener = socket.create_server((host, port))
        self._listener.settimeout(_POLL_S)
        self._host_name = host
        self._port = self._listener.getsockname()[1]
        self._threads: list = []
        self._accept_thread: Optional[threading.Thread] = None
        self._monitor_thread: Optional[threading.Thread] = None
        self._started = False
        # The same-host ring: a UDS doorbell listener, advertised with this
        # host's boot id in every join reply. A mesh server serves it too:
        # the demotion ladder (mesh -> shm -> tcp) needs the next rung in
        # the same join reply the mesh advertisement rides in.
        self._boot_id = shm.local_boot_id()
        self._uds_dir: Optional[str] = None
        self._uds_path: Optional[str] = None
        self._uds_listener: Optional[socket.socket] = None
        self._uds_accept_thread: Optional[threading.Thread] = None
        if self.transport in ("shm", "mesh"):
            self._uds_dir = tempfile.mkdtemp(prefix="dknetps-")
            self._uds_path = os.path.join(self._uds_dir, "ring.sock")
            self._uds_listener = socket.socket(socket.AF_UNIX,
                                               socket.SOCK_STREAM)
            self._uds_listener.bind(self._uds_path)
            self._uds_listener.listen()
            self._uds_listener.settimeout(_POLL_S)

    # ------------------------------------------------------------------
    @property
    def endpoint(self) -> str:
        return f"{self._host_name}:{self._port}"

    @property
    def updates(self) -> int:
        return self._updates

    def center(self) -> list:
        """A private copy of the center, as host numpy arrays."""
        with self._lock:
            if self._flat is None:
                return []
            return [a.copy() for a in self._host_center_locked()]

    def members(self) -> list:
        with self._lock:
            return sorted(self._members)

    def _on_stream(self):
        """The server's stream as the current one (a no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _seat_locked(self, init: list) -> list:
        """Seat a center on the device (the first init, a recovered
        snapshot, a standby's full sync): one flat f32 tensor, one view per
        tensor at its ``center_layout`` offset (lock held, or
        construction). Returns the views."""
        with self._on_stream():
            self._flat, self._offsets, self._center = seat_center(
                init, self.device)
        self._host = None
        return self._center

    def _host_center_locked(self) -> list:
        """The host mirror (lock held): one device-to-host copy of the flat
        center on the first read after a fold (on the card: into pinned
        memory, on the server's stream, waiting on that stream alone), then
        the same read-only arrays until the next fold replaces them."""
        if self._host is None:
            self._host = host_mirror(self._flat, self._offsets, self._center,
                                     self._stream)
        return self._host

    # ------------------------------------------------------------------
    def start(self) -> "PSServer":
        """Begin accepting connections (idempotent). A center on the card
        builds the fold kernels first, outside the lock."""
        if self._started:
            return self
        if self.device.type == "cuda":
            fold_kernels.prepare()
        self._started = True
        t = threading.Thread(target=self._accept_loop, name="netps-accept")
        t.start()
        self._accept_thread = t
        t = threading.Thread(target=self._monitor_loop, name="netps-monitor")
        t.start()
        self._monitor_thread = t
        if self._uds_listener is not None:
            t = threading.Thread(target=self._uds_accept_loop,
                                 name="netps-shm-accept")
            t.start()
            self._uds_accept_thread = t
        if self.transport == "mesh":
            self._mesh_token = _mesh.register(self._serve_mesh)
        return self

    def _serve_mesh(self, header: dict, arrays: list):
        """One direct in-process request (the mesh dialect's data path): no
        frame, no socket, no copy, straight into the op dispatch with the
        payload bytes counted as received; a commit folded here counts in
        ``netps.mesh.folds``. Runs on the CLIENT's thread; the center lock
        serializes it as it does the socket handlers."""
        nbytes = sum(np.asarray(split_entry(e)[0]).nbytes for e in arrays)
        served = self._serve_frame(wire.KIND_REQUEST, nbytes, header, arrays,
                                   dialect=".mesh")
        if header.get("op") == wire.OP_COMMIT and served[0].get("applied"):
            telemetry.counter("netps.mesh.folds").add(1)
        return served

    def drain(self) -> None:
        """Enter draining mode: commits and joins are rejected with a typed
        ``ServerDrainingError``; pulls still serve (departing workers may
        fetch the final center). In-flight folds finish — the flip
        serializes behind any commit holding the lock."""
        with self._lock:
            self._draining = True

    def close(self) -> None:
        """Graceful shutdown: :meth:`drain`, then stop and join every
        thread (accept loop, per-connection handlers, lease monitor) and
        release the listeners. Idempotent."""
        # Unregister the mesh dispatch first: in-flight mesh clients see
        # ConnectionError and demote to the ring or TCP (where the drain
        # answers them typed) instead of racing a dying dispatch target.
        if self._mesh_token is not None:
            _mesh.unregister(self._mesh_token)
            self._mesh_token = None
        self.drain()
        self._stop.set()
        if self._store is not None:
            self._store.close()
        for t in (self._accept_thread, self._uds_accept_thread,
                  self._monitor_thread):
            if t is not None:
                t.join()
        for t in list(self._threads):
            t.join()
        try:
            self._listener.close()
        except OSError:
            pass
        if self._uds_listener is not None:
            try:
                self._uds_listener.close()
            except OSError:
                pass
            for remove, path in ((os.unlink, self._uds_path),
                                 (os.rmdir, self._uds_dir)):
                try:
                    if path and os.path.exists(path):
                        remove(path)
                except OSError:
                    pass

    # ------------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed under us
            conn.settimeout(_POLL_S)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 name="netps-handler")
            t.start()
            self._threads.append(t)

    def _uds_accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._uds_listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed under us
            conn.settimeout(_POLL_S)
            t = threading.Thread(target=self._handle_shm, args=(conn,),
                                 name="netps-shm-handler")
            t.start()
            self._threads.append(t)

    def _monitor_loop(self) -> None:
        """Evict members whose lease expired; training continues with the
        survivors."""
        tick = max(0.05, min(self.lease_s / 4.0, _POLL_S))
        while not self._stop.wait(tick):
            now = time.monotonic()
            with self._lock:
                expired = [w for w, dl in self._members.items() if dl < now]
                for w in expired:
                    del self._members[w]
                    self.evictions += 1
                    self._purge_pending(w)
            for w in expired:
                telemetry.counter("netps.evictions").add(1)
                telemetry.event("netps_eviction", {"worker": w})

    def revoke(self, worker_id: int) -> bool:
        """Administrative lease revocation: the worker is evicted NOW (not
        at its lease deadline) and its next RPC answers ``lease_expired``.
        Dedup state survives, as with a natural eviction; half-assembled
        stripes are dropped. Returns whether the worker was a member."""
        wid = int(worker_id)
        with self._lock:
            present = wid in self._members
            if present:
                del self._members[wid]
                self.evictions += 1
                self._purge_pending(wid)
        if present:
            telemetry.counter("netps.revocations").add(1)
            telemetry.event("netps_revocation", {"worker": wid})
        return present

    # ------------------------------------------------------------------
    def _handle(self, conn: socket.socket) -> None:
        """One connection's handler thread — the reference's
        ``handle_commit`` loop, framed and checksummed. Polls for the first
        byte of each frame (so ``close()`` can stop it) and switches to a
        completion timeout once a frame starts."""
        with conn:
            while not self._stop.is_set():
                try:
                    prefix = wire.recv_exact(conn, wire.PREFIX_SIZE)
                except socket.timeout:
                    continue
                except (ConnectionError, OSError):
                    return
                try:
                    conn.settimeout(_FRAME_COMPLETE_S)
                    # decode=False keeps codec'd commit tensors in their
                    # wire dtype for the compressed-domain fold.
                    kind, nbytes, header, arrays = wire.finish_frame(
                        conn, prefix, decode=False)
                    conn.settimeout(_POLL_S)
                except (socket.timeout, ConnectionError, OSError):
                    return
                except ProtocolError:
                    # The stream can never re-align: drop the connection.
                    # The client reconnects and retries.
                    telemetry.counter("netps.protocol_errors").add(1)
                    return
                try:
                    served = self._serve_frame(kind, nbytes, header, arrays)
                except ProtocolError:
                    # An op-level decode error (a join init with a bad codec
                    # spec) is the same contract violation as a bad frame.
                    telemetry.counter("netps.protocol_errors").add(1)
                    return
                if served is None:
                    return
                reply, out = served
                try:
                    sent = wire.send_frame(conn, wire.KIND_REPLY, reply, out)
                except (ConnectionError, OSError):
                    return
                telemetry.counter("netps.bytes_sent").add(sent)

    def _handle_shm(self, conn: socket.socket) -> None:
        """One ring connection's handler: the request/reply loop of
        :meth:`_handle` with the payload in the client's memory segments;
        the doorbell socket carries only 8-byte frame lengths. A bad ring
        frame (torn slot, bad crc) is a ProtocolError and tears this
        connection down like a corrupt TCP frame: the client reconnects
        with fresh segments and retransmits under the same seq. The
        segments are closed on every way out."""
        rings = None
        with conn:
            try:
                conn.settimeout(_FRAME_COMPLETE_S)
                rings = shm.accept_attach(conn)
                conn.settimeout(_POLL_S)
                c2s, s2c = rings
                while not self._stop.is_set():
                    try:
                        raw = wire.recv_exact(conn, wire.SHM_DOORBELL_SIZE)
                    except socket.timeout:
                        continue
                    kind, nbytes, header, arrays = c2s.read_frame(
                        wire.unpack_doorbell(raw), decode=False)
                    served = self._serve_frame(kind, nbytes, header, arrays,
                                               dialect=".shm")
                    if served is None:
                        return
                    reply, out = served
                    sent = s2c.write_frame(wire.KIND_REPLY, reply, out)
                    conn.sendall(wire.pack_doorbell(sent))
                    telemetry.counter("netps.bytes_sent").add(sent)
            except (socket.timeout, ConnectionError, OSError):
                return
            except ProtocolError:
                telemetry.counter("netps.protocol_errors").add(1)
                return
            finally:
                if rings is not None:
                    for slot in rings:
                        slot.close()

    def _serve_frame(self, kind: int, nbytes: int, header: dict,
                     arrays: list, dialect: str = ""):
        """Validate, count, dispatch under a per-op span (labeled with the
        transport dialect: ``.shm``, ``.mesh``, bare for TCP), and stamp
        the request-id echo. ``None`` = protocol violation, the caller
        tears the connection down."""
        if kind != wire.KIND_REQUEST:
            telemetry.counter("netps.protocol_errors").add(1)
            return None
        telemetry.counter("netps.bytes_received").add(nbytes)
        op = header.get("op", "")
        if op == wire.OP_COMMIT:
            self._chaos_hooks()
        with telemetry.span(f"netps.server.{op or 'unknown'}{dialect}"):
            reply, out = self._dispatch(op, header, arrays)
        err = reply.get("error")
        if op == wire.OP_COMMIT and err == "epoch_fenced":
            # Every fenced commit is a commit that did NOT reach the fold.
            telemetry.counter("netps.failover.fenced_commits").add(1)
        elif op == wire.OP_REPLICATE and reply.get("mode") == "snapshot":
            telemetry.counter("netps.failover.snapshot_syncs").add(1)
        elif op == wire.OP_FENCE and reply.get("fenced"):
            telemetry.counter("netps.failover.fences_accepted").add(1)
            telemetry.event("netps_fenced", {"epoch": reply.get("epoch")})
        if self._store is not None and op in (wire.OP_COMMIT, wire.OP_JOIN):
            telemetry.gauge("netps.recovery.snapshots").set(
                float(self.snapshots_written))
        reply["req"] = header.get("req")
        return reply, out

    def _chaos_hooks(self) -> None:
        """The server-side chaos kinds of ``DKTPU_NET_FAULTS``, consulted
        per commit request before its fold (no proxy can kill this process
        for us). ``ps_hang@R:S`` sleeps S seconds HOLDING the center lock,
        so every member's lease renewal queues behind a wedged server. ``R``
        counts the commits this server has folded. ``shard_crash@N:R`` kills
        SHARD N once it has folded R commits: the ``at`` slot selects the
        shard (every shard process runs its own plan, so the index is the
        one coordinate they share), polled with a non-consuming peek, so
        shard k != N never burns the one-shot. ``ps_crash@R`` is consulted
        at the fold itself (:meth:`_crash_hook_locked`)."""
        plan = _faults.active_net_plan()
        if plan is None:
            return
        arg = plan.fire("ps_hang", self.commits_total)
        if arg:
            with self._lock:
                time.sleep(arg)  # the drill: wedged while holding the lock
        if self.shard_index is not None:
            arg = plan.pending("shard_crash", self.shard_index)
            if arg is not None and self.commits_total >= (arg or 0):
                plan.fire("shard_crash", self.shard_index)
                os.kill(os.getpid(), signal.SIGKILL)

    def _crash_hook_locked(self) -> None:
        """``ps_crash@R``, the kill-the-primary drill (lock held, just
        before a fold): SIGKILL, mid-run, no goodbye, before commit R is
        folded. Under the lock every fold sees its own count, so R is
        never skipped; the JAX server reads the count when the request
        arrives, where two commits in flight can both read R - 1 and the
        drill never fires."""
        plan = _faults.active_net_plan()
        if plan is not None and plan.fire("ps_crash",
                                          self.commits_total) is not None:
            os.kill(os.getpid(), signal.SIGKILL)

    def _dispatch(self, op: str, header: dict,
                  arrays: list) -> tuple[dict, list]:
        if op == wire.OP_JOIN:
            return self._op_join(header, arrays)
        if op == wire.OP_PULL:
            return self._op_pull(header)
        if op == wire.OP_COMMIT:
            return self._op_commit(header, arrays)
        if op == wire.OP_HEARTBEAT:
            return self._op_heartbeat(header)
        if op == wire.OP_LEAVE:
            return self._op_leave(header)
        if op == wire.OP_REPLICATE:
            return self._op_replicate(header)
        if op == wire.OP_FENCE:
            return self._op_fence(header)
        if op == wire.OP_PROBE:
            return self._op_probe(header, arrays)
        if op == wire.OP_STATS:
            return self._op_stats(header)
        return {"error": "protocol", "message": f"unknown op {op!r}"}, []

    @staticmethod
    def _err(kind: str, message: str) -> tuple[dict, list]:
        return {"error": kind, "message": message}, []

    # -- sharded-center plan checks ------------------------------------
    def _persist_plan_locked(self) -> None:
        """Write the adopted plan next to the journal (tmp + rename), in
        the JAX package's format: a restarted shard of either package
        refuses plan drift against this file."""
        if self._plan_path is None or self.shard_plan is None:
            return
        tmp = self._plan_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"shard_index": self.shard_index,
                       "plan": self.shard_plan.to_dict()}, f)
        os.replace(tmp, self._plan_path)

    def _sharding_caps_locked(self) -> dict:
        """The ``sharding`` join-reply advertisement: this shard's identity
        plus the full plan (so a plan-less joiner — an observer — can adopt
        rather than guess)."""
        return {"index": self.shard_index, "count": self.shard_count,
                "plan_hash": self.shard_plan.plan_hash,
                "plan": self.shard_plan.to_dict()}

    def _check_shard_join_locked(self, header: dict,
                                 init: list) -> Optional[tuple]:
        """The sharded-center join contract (lock held). Every violation is
        the typed ``shard_plan`` error: a peer that cannot prove it holds
        THE plan never gets membership, so a partial-plan fold cannot
        happen."""
        claimed = header.get("shard_index")
        if self.shard_index is None:
            if claimed is not None:
                return self._err(
                    "shard_plan",
                    f"this server is not part of a sharded deployment but "
                    f"the join claims shard {claimed}")
            return None
        caps = header.get("caps")
        if not isinstance(caps, dict) or not caps.get("sharding"):
            return self._err(
                "shard_plan",
                "peer lacks the 'sharding' capability: a pre-sharding "
                "build joining a shard server (upgrade the worker)")
        if claimed is None:
            return self._err(
                "shard_plan",
                f"join carries no shard_index; this is shard "
                f"{self.shard_index}/{self.shard_count}: dial it through "
                f"a sharded client, not a plain PSClient")
        if int(claimed) != self.shard_index:
            return self._err(
                "shard_plan",
                f"join claims shard {claimed} but this server is shard "
                f"{self.shard_index}/{self.shard_count}")
        got_hash = header.get("plan_hash")
        if self.shard_plan is None:
            # An empty shard meets its first client: adopt (then persist)
            # the plan the join carries, but only a REAL plan; "adopt"
            # from both sides means nobody holds one.
            plan_dict = header.get("shard_plan")
            if not isinstance(plan_dict, dict) or got_hash == "adopt":
                return self._err(
                    "shard_plan",
                    "server has no partition plan yet; join must carry "
                    "one (shard_plan + plan_hash)")
            from distkeras_tpu_torch.netps.shards import plan as _plan_mod
            try:
                plan = _plan_mod.PartitionPlan.from_dict(plan_dict)
            except Exception as e:  # noqa: BLE001 - answered typed
                return self._err("shard_plan", f"malformed plan: {e}")
            if plan.num_shards != self.shard_count:
                return self._err(
                    "shard_plan",
                    f"plan has {plan.num_shards} shards, this deployment "
                    f"has {self.shard_count}")
            if got_hash != plan.plan_hash:
                return self._err(
                    "shard_plan",
                    f"plan_hash {str(got_hash)[:12]}... does not match the "
                    f"carried plan ({plan.plan_hash[:12]}...)")
            self.shard_plan = plan
            self._persist_plan_locked()
        elif got_hash != "adopt" and \
                got_hash != self.shard_plan.plan_hash:
            return self._err(
                "shard_plan",
                f"plan hash mismatch: yours {str(got_hash)[:12]}..., this "
                f"shard's {self.shard_plan.plan_hash[:12]}...: the "
                f"deployment was re-planned; rebuild or adopt")
        if init and self._flat is None:
            want = self.shard_plan.shard_shapes(self.shard_index)
            got = [tuple(np.asarray(a).shape) for a in init]
            if got != want:
                return self._err(
                    "shard_plan",
                    f"init arrays do not match shard {self.shard_index}'s "
                    f"plan slice: got {got[:4]}..., want {want[:4]}...")
        return None

    def _purge_pending(self, wid: int, below_seq: Optional[int] = None,
                       ) -> None:
        """Drop stashed commit stripes of ``wid`` (lock held): all of them
        on eviction and (re)join, or only seqs <= ``below_seq`` after a
        fold (a folded commit's stragglers are dedup's business)."""
        for key in [k for k in self._pending
                    if k[0] == wid
                    and (below_seq is None or k[1] <= below_seq)]:
            del self._pending[key]

    def _stash_stripe(self, wid: int, seq: int, num_shards: int,
                      header: dict, arrays: list):
        """Stash one commit stripe (lock held). Returns ``(delta, None)``
        with the assembled entry list once the LAST stripe lands, ``(None,
        None)`` while stripes are outstanding, or ``(None, error reply)``
        on malformed stripe metadata."""
        idx = header.get("idx")
        if idx is None:
            return None, self._err(
                "protocol", "striped commit requires stripe indices")
        try:
            idx = tuple(int(i) for i in idx)
        except (TypeError, ValueError):
            return None, self._err("protocol", f"bad stripe indices {idx!r}")
        if len(idx) != len(arrays):
            return None, self._err(
                "protocol",
                f"stripe declares {len(idx)} tensors, carries {len(arrays)}")
        pend = self._pending.setdefault((wid, seq), {})
        pend[int(header.get("shard", 0))] = (idx, list(arrays))
        if len(pend) < num_shards:
            return None, None
        total = sum(len(ix) for ix, _ in pend.values())
        delta: list = [None] * total
        for ix, arrs in pend.values():
            for i, a in zip(ix, arrs):
                if not 0 <= i < total or delta[i] is not None:
                    del self._pending[(wid, seq)]
                    return None, self._err(
                        "protocol",
                        f"inconsistent stripe set for ({wid}, {seq})")
                delta[i] = a
        del self._pending[(wid, seq)]
        if any(d is None for d in delta):
            return None, self._err(
                "protocol", f"stripe set for ({wid}, {seq}) has holes")
        return delta, None

    def _op_join(self, header: dict, arrays: list) -> tuple[dict, list]:
        wid = header.get("worker_id")
        # Join inits are plain tensors: decoding is a per-tensor
        # passthrough (frames arrive decode=False).
        init = [decode_entry(a) for a in arrays]
        with self._lock:
            # A join never carries an epoch — it ADOPTS the server's — so
            # only the fenced/standby half of the check applies.
            err = self._check_primary_locked({})
            if err is not None:
                return err
            if self._draining:
                return self._err("draining", "server is draining")
            shard_err = self._check_shard_join_locked(header, init)
            if shard_err is not None:
                return shard_err
            if wid is None:
                wid = (max(self._ever) + 1) if self._ever else 0
            wid = int(wid)
            rejoin = wid in self._ever and wid not in self._members
            if self._flat is None and init:
                self._seat_locked([np.asarray(a, np.float32) for a in init])
                if self._store is not None:
                    # First center this store has seen: anchor the journal
                    # with the base snapshot recovery will replay onto.
                    self._snapshot_locked()
            if self._flat is None:
                return self._err(
                    "uninitialized",
                    "server has no center yet; join with init arrays")
            self._ever.add(wid)
            self._members[wid] = time.monotonic() + self.lease_s
            self._purge_pending(wid)  # a re-join abandons half-sent stripes
            if rejoin:
                self.rejoins += 1
            center = list(self._host_center_locked())
            updates = self._updates
            last_seq = self._last_seq.get(wid, -1)
            sharding = (self._sharding_caps_locked()
                        if self.shard_index is not None else None)
        if rejoin:
            telemetry.counter("netps.rejoins").add(1)
            telemetry.event("netps_rejoin", {"worker": wid})
        # last_seq lets a restarted worker process resume its sequence past
        # what this server already folded; caps is the data-plane
        # negotiation (the client compresses only with an advertised codec).
        # A server serving a ring or a mesh replaces the static bit with its
        # live endpoint: the client upgrades only on a boot-id (ring) or a
        # process (mesh) match.
        caps = self._caps()
        if self._uds_path is not None:
            caps["shm"] = {"boot_id": self._boot_id, "uds": self._uds_path}
        if self._mesh_token is not None:
            caps["mesh"] = {"proc": _mesh.local_mesh_id(),
                            "token": self._mesh_token, "devices": 1,
                            "backend": self.device.type}
        if sharding is not None:
            # A shard server replaces the static bit with its identity and
            # plan, the shm upgrade's pattern.
            caps["sharding"] = sharding
        return ({"ok": True, "worker_id": wid, "updates": updates,
                 "lease_s": self.lease_s, "last_seq": last_seq,
                 "epoch": self.epoch, "caps": caps}, center)

    def _op_pull(self, header: dict) -> tuple[dict, list]:
        wid = header.get("worker_id")
        idx = header.get("idx")
        with self._lock:
            err = self._check_primary_locked(header)
            if err is not None:
                return err
            if header.get("want_plan") and self.shard_index is not None:
                # Membership-free plan fetch (the observer bootstrap): the
                # advertisement alone, no center payload, no lease.
                if self.shard_plan is None:
                    return self._err("uninitialized",
                                     "shard has no plan yet")
                return {"ok": True, "updates": self._updates,
                        "sharding": self._sharding_caps_locked()}, []
            if self._flat is None:
                return self._err("uninitialized", "no center yet")
            if wid is not None:
                # Members renew their lease by pulling; an evicted worker
                # must rejoin first. wid=None is an anonymous observer pull
                # (the trainer fetching the final center) — no lease.
                if int(wid) not in self._members:
                    return self._err(
                        "lease_expired", f"worker {wid} is not a member")
                self._members[int(wid)] = time.monotonic() + self.lease_s
            host = self._host_center_locked()
            if idx is None:
                out = list(host)
            else:
                # One stripe of the center (a striped pull). The reply
                # echoes the update counter; the client cross-checks the
                # counters over its stripes and re-pulls a torn read.
                try:
                    out = [host[int(i)] for i in idx]
                except (IndexError, TypeError, ValueError):
                    return self._err(
                        "protocol", f"bad pull stripe indices {idx!r}")
            reply = {"ok": True, "updates": self._updates}
            if self.shard_index is not None and self.shard_plan is not None:
                # Every pull re-proves the plan identity: a client that
                # kept running across a re-plan sees the hash change and
                # fails typed instead of assembling from two plans.
                reply["plan_hash"] = self.shard_plan.plan_hash
            return reply, out

    def _op_probe(self, header: dict, arrays: list) -> tuple[dict, list]:
        """The tuner's timed micro-A/B round trip: decode the payload as a
        commit is decoded (one ``fold_commit`` launch into the scratch
        window, outside the lock) and answer its f32 bytes and the
        decode's seconds. The center, the journal, the dedup table and
        membership are never touched: a member's probe renews its lease
        like any round trip, a non-member's (a pre-join A/B) creates
        nothing."""
        t0 = time.monotonic()
        try:
            validate_delta(arrays)
            nbytes, _ = self._probe.decode(arrays)
        except (ProtocolError, TypeError, ValueError) as e:
            return self._err("protocol", f"bad probe payload: {e}")
        decode_s = time.monotonic() - t0
        with self._lock:
            err = self._check_primary_locked(header)
            if err is not None:
                return err
            wid = header.get("worker_id")
            if wid is not None and int(wid) in self._members:
                self._members[int(wid)] = time.monotonic() + self.lease_s
        telemetry.counter("netps.probes").add(1)
        return {"ok": True, "probe_bytes": nbytes,
                "decode_s": round(decode_s, 6)}, []

    def _op_commit(self, header: dict, arrays: list) -> tuple[dict, list]:
        wid = header.get("worker_id")
        seq = header.get("seq")
        pulled = header.get("pulled", 0)
        if wid is None or seq is None:
            return self._err("protocol", "commit requires worker_id and seq")
        wid, seq = int(wid), int(seq)
        num_shards = int(header.get("num_shards", 1) or 1)
        duplicate = pending = False
        # Validate specs BEFORE any bookkeeping or fold: a bad spec that
        # raised mid-fold under the lock would leave a partially-applied
        # delta the retransmit then double-folds.
        try:
            validate_delta(arrays)
        except ProtocolError as e:
            telemetry.counter("netps.protocol_errors").add(1)
            return self._err("protocol", str(e))
        staged = None
        if num_shards <= 1:
            # Staging (the packing and the one host-to-device copy) happens
            # here, outside the lock, so pulls, joins and heartbeats never
            # wait on it. A striped commit is staged once it is assembled.
            with self._on_stream():
                staged = stage_commit(arrays, self.device, self._pool)
        with self._lock:
            err = self._check_primary_locked(header)
            if err is not None:
                return err
            if self._draining:
                return self._err("draining", "server is draining")
            if wid not in self._members:
                return self._err(
                    "lease_expired", f"worker {wid} is not a member")
            if self._flat is None:
                return self._err("uninitialized", "no center yet")
            if staged is not None:
                err = self._check_sizes_locked(arrays)
                if err is not None:
                    return err
            self._members[wid] = time.monotonic() + self.lease_s
            if seq <= self._last_seq.get(wid, -1):
                # Retransmit after a lost ACK: already folded. Answering
                # applied=False (instead of re-folding) is the whole
                # exactly-once story, and it covers a retransmitted stripe
                # of an already assembled commit too.
                duplicate = True
                staleness = -1
            elif staged is None:
                delta, err = self._stash_stripe(wid, seq, num_shards, header,
                                                arrays)
                if err is None and delta is not None:
                    err = self._check_sizes_locked(delta)
                if err is not None:
                    return err
                if delta is None:
                    pending = True  # more stripes to come; no fold yet
                    staleness = -1
                else:
                    # The assembled commit is staged under the lock: its
                    # (worker, seq) must go from stashed to folded with no
                    # window in which a full retransmit could assemble it
                    # twice.
                    with self._on_stream():
                        staged = stage_commit(delta, self.device, self._pool)
                    self._crash_hook_locked()
                    staleness = self._fold_locked(wid, seq, pulled, staged,
                                                  delta)
            else:
                self._crash_hook_locked()
                staleness = self._fold_locked(wid, seq, pulled, staged,
                                              arrays)
            updates = self._updates
            n, dt = self._fold_stats
        if duplicate:
            telemetry.counter("netps.commits_deduped").add(1)
        elif not pending:
            telemetry.counter("netps.commits").add(1)
            if n and dt > 0:
                telemetry.gauge("netps.fold.tensors_per_sec").set(
                    round(n / dt, 1))
        return ({"ok": True, "applied": not (duplicate or pending),
                 "duplicate": duplicate, "pending": pending,
                 "updates": updates, "staleness": staleness}, [])

    def _check_sizes_locked(self, entries: list):
        """None when ``entries`` match the center's tensors element for
        element, else the protocol error. Checked before the fold: a
        mismatch found mid-fold would leave a partially applied delta."""
        sizes = [int(np.size(split_entry(e)[0])) for e in entries]
        if sizes != [c.numel() for c in self._center]:
            return self._err(
                "protocol", f"commit tensor sizes {sizes[:4]}... do not "
                            f"match the center's")
        return None

    def _fold_locked(self, wid: int, seq: int, pulled,
                     staged: fold_kernels.StagedCommit,
                     wire_delta: list) -> int:
        """The ONE fold (lock held): staleness from the counter rule, then
        ``fold_delta`` on the device center, the exactly-once bookkeeping,
        and the durability tail — the journal append (fold order IS journal
        order, which is why this stays under the lock), snapshot-when-due,
        the replication tail, and the commit-log bound. ``wire_delta`` is
        the commit frame's own entries: each frame has a buffer of its own,
        so the journal and the tail may hold them until written or sent."""
        staleness = counter_staleness(self._updates, pulled)
        t0 = time.perf_counter()
        with self._on_stream():
            fold_delta(self._center, staged, self.discipline, staleness)
        dt = time.perf_counter() - t0
        self._host = None  # the mirror is stale from here on
        self._fold_stats = (len(staged.rows), dt)
        self.fold_seconds += dt
        self._record_fold_locked(wid, seq, staleness, list(wire_delta))
        self._purge_pending(wid, below_seq=seq)
        return staleness

    def _record_fold_locked(self, wid: int, seq: int, staleness: int,
                            wire_delta: list, epoch=None,
                            commits_total=None) -> None:
        """The bookkeeping of one fold (lock held), shared by the primary's
        fold and a standby's replicated record: the commit log, the dedup
        table, the counters, the replication tail, the journal and the
        snapshot when due."""
        u = self._updates
        self.commit_log.append((wid, seq, staleness))
        self._last_seq[wid] = seq
        self._ever.add(wid)
        self._updates += 1
        self.commits_total = (self.commits_total + 1 if commits_total is None
                              else int(commits_total))
        if epoch is not None:
            self.epoch = max(self.epoch, int(epoch))
        if self._repl_on:
            self._repl.append({"u": u, "wid": wid, "seq": seq,
                               "st": staleness, "e": self.epoch,
                               "n": self.commits_total, "delta": wire_delta})
        if self._store is not None:
            self._store.append(epoch=self.epoch, wid=wid, seq=seq,
                               staleness=staleness, updates=u,
                               commits_total=self.commits_total,
                               delta=wire_delta)
            if self._store.due(self._updates):
                self._snapshot_locked()
        self._trim_log_locked(2 * self._log_keep)

    def _trim_log_locked(self, threshold: int) -> None:
        """Drop the oldest commit-log entries back to the keep bound once
        the list reaches ``threshold`` (lock held) — the one place the
        ``len(commit_log) + dropped == commits_total`` invariant is kept."""
        if len(self.commit_log) >= threshold > self._log_keep:
            drop = len(self.commit_log) - self._log_keep
            del self.commit_log[:drop]
            self._log_dropped += drop

    def _snapshot_locked(self) -> None:
        """Write one center snapshot and rotate/compact the journal (lock
        held), then trim the commit log to its keep bound. The center comes
        through the host mirror, which waits on the server stream only."""
        t0 = time.perf_counter()
        self._store.snapshot(center=self._host_center_locked(),
                             updates=self._updates,
                             last_seq=self._last_seq, epoch=self.epoch,
                             commits_total=self.commits_total)
        self.snapshot_seconds += time.perf_counter() - t0
        self.snapshots_written += 1
        self._trim_log_locked(self._log_keep + 1)

    @property
    def journal_bytes(self) -> int:
        """Bytes of journal records written by this incarnation."""
        return self._store.journal_bytes if self._store is not None else 0

    def _check_primary_locked(self, header: dict):
        """The epoch fence (lock held): None when this server may serve
        the request, else the typed error reply. A fenced or
        not-yet-promoted server answers ``not_primary`` (the client walks
        its endpoint list); a request from a STALE epoch answers
        ``epoch_fenced`` (the client re-joins and adopts the new lineage);
        a request from a HIGHER epoch is proof somebody promoted past this
        server — it fences itself on the spot, so a zombie primary never
        folds again even if the promotion's ``fence`` op was lost."""
        if self._not_primary:
            return self._err("not_primary", "warm standby, not promoted")
        epoch = header.get("epoch")
        if epoch is not None and int(epoch) > self.epoch and not self._fenced:
            self._fenced = True
            if self._store is not None:
                self._store.write_epoch(int(epoch), fenced=True)
        if self._fenced:
            return self._err("not_primary",
                             f"fenced ex-primary (epoch {self.epoch})")
        if epoch is not None and int(epoch) < self.epoch:
            return self._err(
                "epoch_fenced",
                f"request epoch {int(epoch)} predates server epoch "
                f"{self.epoch}: re-join the promoted primary")
        return None

    def _op_heartbeat(self, header: dict) -> tuple[dict, list]:
        wid = header.get("worker_id")
        if wid is None:
            return self._err("protocol", "heartbeat requires worker_id")
        with self._lock:
            err = self._check_primary_locked(header)
            if err is not None:
                return err
            if int(wid) not in self._members:
                return self._err(
                    "lease_expired", f"worker {wid} is not a member")
            self._members[int(wid)] = time.monotonic() + self.lease_s
            return {"ok": True, "updates": self._updates}, []

    def _op_leave(self, header: dict) -> tuple[dict, list]:
        wid = header.get("worker_id")
        with self._lock:
            if wid is not None:
                self._members.pop(int(wid), None)
        return {"ok": True}, []

    def _op_stats(self, header: dict) -> tuple[dict, list]:
        """Membership-free scrape: this process's telemetry snapshot and
        the server's state, with ``caps`` echoed so an observer can probe
        capabilities without joining. Never touches membership, leases,
        the dedup table or the fold."""
        with self._lock:
            extra = {"updates": self._updates, "epoch": self.epoch,
                     "members": len(self._members),
                     "commits_total": self.commits_total,
                     "draining": self._draining,
                     # A primary that can take commits; standbys and
                     # fenced ex-primaries answer stats but are not ready.
                     "ready": (not self._draining and not self._fenced
                               and not self._not_primary),
                     "fold_backend": backend_name(self._center)}
        return ({"ok": True, "caps": dict(wire.CAPS), "role": "ps",
                 "snapshot": telemetry.get().snapshot(), "ring": [],
                 **extra}, [])

    def _caps(self) -> dict:
        """The static capability set a join reply starts from. An
        aggregation-tree node replaces the ``tree`` bit with its level and
        group identity here (the replace-the-static-bit pattern of the
        ring, mesh and sharding advertisements in :meth:`_op_join`)."""
        return dict(wire.CAPS)

    def _repl_cursor_locked(self) -> int:
        """The fold index replication advances by (lock held): the update
        counter here. An aggregator answers its absorb cursor: its counter
        mirrors the ROOT lineage and moves only on a re-pull, so it cannot
        index the journal its standby tails."""
        return self._updates

    def _op_replicate(self, header: dict) -> tuple[dict, list]:
        """One pull of the journal stream by a warm standby: ``u`` is the
        next fold index the standby needs. Answers a batch of records in
        wire form (``mode=records``; each record header carries its array
        count ``k``, the deltas ride flattened), or — for a fresh standby
        (``u < 0``), one behind the tail, gapped or ahead of this primary —
        one full state sync (``mode=snapshot``). Served during drain."""
        u = int(header.get("u", -1))
        with self._lock:
            if self._not_primary or self._fenced:
                return self._err(
                    "not_primary", "cannot replicate from a non-primary")
            if self._flat is None:
                return self._err("uninitialized", "no center yet")
            # The first replicate turns the tail on: no deployment without
            # a standby pays its memory.
            self._repl_on = True
            cursor = self._repl_cursor_locked()
            recs = [r for r in self._repl if r["u"] >= u]
            if u == cursor:
                recs = []
            elif u < 0 or u > cursor or not recs or recs[0]["u"] != u:
                # The primary's state is the authoritative lineage: one full
                # sync the standby adopts wholesale.
                hdr = {"ok": True, "mode": "snapshot",
                       "updates": cursor, "epoch": self.epoch,
                       "lineage": self.lineage,
                       "commits_total": self.commits_total,
                       "last_seq": {str(k): int(v)
                                    for k, v in self._last_seq.items()}}
                return hdr, list(self._host_center_locked())
            recs = recs[:_REPL_BATCH]
            headers = [{"u": r["u"], "wid": r["wid"], "seq": r["seq"],
                        "st": r["st"], "e": r["e"], "n": r["n"],
                        "k": len(r["delta"])} for r in recs]
            out: list = []
            for r in recs:
                out.extend(r["delta"])
            return ({"ok": True, "mode": "records", "records": headers,
                     "updates": cursor, "epoch": self.epoch,
                     "lineage": self.lineage}, out)

    def _op_fence(self, header: dict) -> tuple[dict, list]:
        """A promoted standby fencing the old lineage: an epoch strictly
        above ours means we are the zombie — stop folding forever, durably.
        An epoch at or below ours means the *fencer* is stale; refuse with
        the typed fence error."""
        try:
            epoch = int(header["epoch"])
        except (KeyError, TypeError, ValueError):
            return self._err("protocol", "fence requires an integer epoch")
        with self._lock:
            if epoch > self.epoch:
                self._fenced = True
                if self._store is not None:
                    self._store.write_epoch(epoch, fenced=True)
                return {"ok": True, "fenced": True, "epoch": epoch}, []
            return self._err(
                "epoch_fenced",
                f"fence epoch {epoch} does not exceed server epoch "
                f"{self.epoch}")

