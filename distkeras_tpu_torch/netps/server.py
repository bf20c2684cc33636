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

The JAX server's shared-memory ring, device mesh, durable state and
journal, warm standby and fencing, shards and stripes, tuner probe, chaos
hooks and tracing come with later slices; a peer learns that from the join
reply's ``caps``.
"""

from __future__ import annotations

import contextlib
import socket
import threading
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.netps.errors import ProtocolError
from distkeras_tpu_torch.netps.fold import (PinnedPool, backend_name,
                                            check_discipline,
                                            counter_staleness, decode_entry,
                                            fold_delta, split_entry,
                                            stage_commit, validate_delta)
from distkeras_tpu_torch.ops.kernels import fold as fold_kernels
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.runtime.device import resolve_device

#: handler/accept poll tick: how often blocked threads wake to check stop.
_POLL_S = 0.2
#: once a frame's first bytes arrive, the rest must land within this —
#: a peer that stalls mid-frame is dead, not idle.
_FRAME_COMPLETE_S = 30.0
#: the server stream's priority: lower is higher, and a value past the
#: range PyTorch's stream pool offers maps to its highest.
_STREAM_PRIORITY = -64
#: in-memory commit-log bound: the evidence list is trimmed to this once it
#: doubles it (dropped entries stay counted in ``commits_total``).
_COMMIT_LOG_KEEP = 65536


class PSServer:
    """One center variable on ``device``, served over TCP to N worker
    clients.

    ``center=None`` starts uninitialized: the first ``join`` carrying init
    arrays seeds it (so a CLI-launched server needs no model knowledge —
    the workers bring the parameters). ``lease_s`` defaults to
    ``DKTPU_PS_LEASE``.
    """

    def __init__(self, center: Optional[Sequence[np.ndarray]] = None,
                 discipline: str = "adag", host: str = "127.0.0.1",
                 port: int = 0, lease_s: Optional[float] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.discipline = check_discipline(discipline)
        self.device = resolve_device(device)
        #: the server's own stream and its pinned staging buffers (on the
        #: card; None on the CPU).
        self._stream = self._pool = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device,
                                             priority=_STREAM_PRIORITY)
            self._pool = PinnedPool()
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
        #: all commits ever folded — ``commit_log`` is the bounded tail of
        #: it (``len(commit_log) + dropped == commits_total`` always).
        self.commits_total = 0
        self._log_dropped = 0
        self._log_keep = _COMMIT_LOG_KEEP
        #: applied commits in fold order: (worker_id, seq, staleness) — the
        #: exactly-once evidence.
        self.commit_log: list = []
        #: (tensors, seconds) of the most recent fold — written under the
        #: lock, exported as the fold-throughput gauge after release.
        self._fold_stats = (0, 0.0)
        #: seconds spent in folds so far (host clock around each fold).
        self.fold_seconds = 0.0
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

    def _seat_locked(self, init: list) -> None:
        """Seat the first center on the device: one flat f32 tensor, one
        view per tensor at its ``center_layout`` offset (lock held, or
        construction)."""
        offsets, total = fold_kernels.center_layout([a.size for a in init])
        host = np.zeros(total, np.float32)
        for a, off in zip(init, offsets):
            host[off:off + a.size] = a.reshape(-1)
        with self._on_stream():
            self._flat = torch.from_numpy(host).to(self.device, copy=True)
        self._offsets = offsets
        self._center = [self._flat[off:off + a.size].view(a.shape)
                        for a, off in zip(init, offsets)]
        self._host = None

    def _host_center_locked(self) -> list:
        """The host mirror (lock held): one device-to-host copy of the flat
        center on the first read after a fold (on the card: into pinned
        memory, on the server's stream, waiting on that stream alone), then
        the same read-only arrays until the next fold replaces them."""
        if self._host is None:
            if self._stream is None:
                flat = self._flat.clone()
            else:
                with self._on_stream():
                    flat = torch.empty(self._flat.shape,
                                       dtype=self._flat.dtype,
                                       pin_memory=True)
                    flat.copy_(self._flat, non_blocking=True)
                self._stream.synchronize()
            flat = flat.numpy()
            flat.flags.writeable = False
            self._host = [flat[off:off + c.numel()].reshape(tuple(c.shape))
                          for c, off in zip(self._center, self._offsets)]
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
        return self

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
        release the listener. Idempotent."""
        self.drain()
        self._stop.set()
        if self._accept_thread is not None:
            self._accept_thread.join()
        if self._monitor_thread is not None:
            self._monitor_thread.join()
        for t in list(self._threads):
            t.join()
        try:
            self._listener.close()
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
            for w in expired:
                telemetry.counter("netps.evictions").add(1)
                telemetry.event("netps_eviction", {"worker": w})

    def revoke(self, worker_id: int) -> bool:
        """Administrative lease revocation: the worker is evicted NOW (not
        at its lease deadline) and its next RPC answers ``lease_expired``.
        Dedup state survives, as with a natural eviction. Returns whether
        the worker was a member."""
        wid = int(worker_id)
        with self._lock:
            present = wid in self._members
            if present:
                del self._members[wid]
                self.evictions += 1
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

    def _serve_frame(self, kind: int, nbytes: int, header: dict,
                     arrays: list):
        """Validate, count, dispatch under a per-op span, and stamp the
        request-id echo. ``None`` = protocol violation, the caller tears
        the connection down."""
        if kind != wire.KIND_REQUEST:
            telemetry.counter("netps.protocol_errors").add(1)
            return None
        telemetry.counter("netps.bytes_received").add(nbytes)
        op = header.get("op", "")
        with telemetry.span(f"netps.server.{op or 'unknown'}"):
            reply, out = self._dispatch(op, header, arrays)
        reply["req"] = header.get("req")
        return reply, out

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
        if op == wire.OP_STATS:
            return self._op_stats(header)
        return {"error": "protocol", "message": f"unknown op {op!r}"}, []

    @staticmethod
    def _err(kind: str, message: str) -> tuple[dict, list]:
        return {"error": kind, "message": message}, []

    def _op_join(self, header: dict, arrays: list) -> tuple[dict, list]:
        wid = header.get("worker_id")
        # Join inits are plain tensors: decoding is a per-tensor
        # passthrough (frames arrive decode=False).
        init = [decode_entry(a) for a in arrays]
        with self._lock:
            if self._draining:
                return self._err("draining", "server is draining")
            if wid is None:
                wid = (max(self._ever) + 1) if self._ever else 0
            wid = int(wid)
            rejoin = wid in self._ever and wid not in self._members
            if self._flat is None and init:
                self._seat_locked([np.asarray(a, np.float32) for a in init])
            if self._flat is None:
                return self._err(
                    "uninitialized",
                    "server has no center yet; join with init arrays")
            self._ever.add(wid)
            self._members[wid] = time.monotonic() + self.lease_s
            if rejoin:
                self.rejoins += 1
            center = list(self._host_center_locked())
            updates = self._updates
            last_seq = self._last_seq.get(wid, -1)
        if rejoin:
            telemetry.counter("netps.rejoins").add(1)
            telemetry.event("netps_rejoin", {"worker": wid})
        # last_seq lets a restarted worker process resume its sequence past
        # what this server already folded; caps is the data-plane
        # negotiation (the client compresses only with an advertised codec).
        return ({"ok": True, "worker_id": wid, "updates": updates,
                 "lease_s": self.lease_s, "last_seq": last_seq,
                 "caps": dict(wire.CAPS)}, center)

    def _op_pull(self, header: dict) -> tuple[dict, list]:
        wid = header.get("worker_id")
        with self._lock:
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
            return ({"ok": True, "updates": self._updates},
                    list(self._host_center_locked()))

    def _op_commit(self, header: dict, arrays: list) -> tuple[dict, list]:
        wid = header.get("worker_id")
        seq = header.get("seq")
        pulled = header.get("pulled", 0)
        if wid is None or seq is None:
            return self._err("protocol", "commit requires worker_id and seq")
        if int(header.get("num_shards", 1) or 1) > 1:
            return self._err("protocol", "striped commits are not served "
                                         "here (no 'striping' capability)")
        wid, seq = int(wid), int(seq)
        duplicate = False
        # Validate specs BEFORE any bookkeeping or fold: a bad spec that
        # raised mid-fold under the lock would leave a partially-applied
        # delta the retransmit then double-folds.
        try:
            validate_delta(arrays)
        except ProtocolError as e:
            telemetry.counter("netps.protocol_errors").add(1)
            return self._err("protocol", str(e))
        sizes = [int(np.size(split_entry(e)[0])) for e in arrays]
        # Staging (the packing and the one host-to-device copy) happens
        # here, outside the lock, so pulls, joins and heartbeats never wait
        # on it.
        with self._on_stream():
            staged = stage_commit(arrays, self.device, self._pool)
        with self._lock:
            if self._draining:
                return self._err("draining", "server is draining")
            if wid not in self._members:
                return self._err(
                    "lease_expired", f"worker {wid} is not a member")
            if self._flat is None:
                return self._err("uninitialized", "no center yet")
            if sizes != [c.numel() for c in self._center]:
                # Checked before the fold: a mismatch found mid-fold would
                # leave a partially applied delta behind.
                return self._err(
                    "protocol", f"commit tensor sizes {sizes[:4]}... do "
                                f"not match the center's")
            self._members[wid] = time.monotonic() + self.lease_s
            if seq <= self._last_seq.get(wid, -1):
                # Retransmit after a lost ACK: already folded. Answering
                # applied=False (instead of re-folding) is the whole
                # exactly-once story.
                duplicate = True
                staleness = -1
            else:
                staleness = self._fold_locked(wid, seq, pulled, staged)
            updates = self._updates
            n, dt = self._fold_stats
        if duplicate:
            telemetry.counter("netps.commits_deduped").add(1)
        else:
            telemetry.counter("netps.commits").add(1)
            if n and dt > 0:
                telemetry.gauge("netps.fold.tensors_per_sec").set(
                    round(n / dt, 1))
        return ({"ok": True, "applied": not duplicate,
                 "duplicate": duplicate, "pending": False,
                 "updates": updates, "staleness": staleness}, [])

    def _fold_locked(self, wid: int, seq: int, pulled,
                     staged: fold_kernels.StagedCommit) -> int:
        """The ONE fold (lock held): staleness from the counter rule, then
        ``fold_delta`` on the device center, the exactly-once bookkeeping,
        and the commit-log bound."""
        staleness = counter_staleness(self._updates, pulled)
        t0 = time.perf_counter()
        with self._on_stream():
            fold_delta(self._center, staged, self.discipline, staleness)
        dt = time.perf_counter() - t0
        self._host = None  # the mirror is stale from here on
        self._fold_stats = (len(staged.rows), dt)
        self.fold_seconds += dt
        self.commit_log.append((wid, seq, staleness))
        self._last_seq[wid] = seq
        self._updates += 1
        self.commits_total += 1
        if len(self.commit_log) >= 2 * self._log_keep:
            drop = len(self.commit_log) - self._log_keep
            del self.commit_log[:drop]
            self._log_dropped += drop
        return staleness

    def _op_heartbeat(self, header: dict) -> tuple[dict, list]:
        wid = header.get("worker_id")
        if wid is None:
            return self._err("protocol", "heartbeat requires worker_id")
        with self._lock:
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
            extra = {"updates": self._updates,
                     "members": len(self._members),
                     "commits_total": self.commits_total,
                     "draining": self._draining,
                     "ready": not self._draining,
                     "fold_backend": backend_name(self._center)}
        return ({"ok": True, "caps": dict(wire.CAPS), "role": "ps",
                 "snapshot": telemetry.get().snapshot(), "ring": [],
                 **extra}, [])

