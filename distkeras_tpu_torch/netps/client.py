"""The hardened parameter-server client (the port's copy of the JAX
package's ``netps/client.py``; the frames are the same, so it talks to
either package's server).

Every RPC has

* a **deadline** — ``DKTPU_NET_TIMEOUT`` seconds per attempt, covering
  connect, send, and the full reply;
* **bounded retries with exponential backoff + full jitter** —
  ``DKTPU_NET_RETRIES`` attempts spaced by
  :func:`~distkeras_tpu_torch.resilience.backoff.full_jitter` over a
  ``DKTPU_NET_BACKOFF``-based envelope, so W workers cut off by the same
  partition do not retry in lockstep; a failed attempt tears its
  connection down and reconnects, and the ``req`` id echo discards any
  duplicate reply that survives on a healthy one;
* **idempotent commit sequencing** — the client assigns ``(worker_id,
  seq)`` *before* the first send and reuses it on every retransmit, so a
  commit whose ACK was lost is folded exactly once (the server dedups and
  answers ``duplicate=True``);
* **automatic re-join** — an RPC rejected with ``lease_expired`` (the
  server evicted us while we were away) triggers a fresh ``join``; ``pull``
  then returns the re-joined center, while ``commit`` reports
  ``evicted=True`` so the worker loop discards its stale window.

**Compressed deltas** (``DKTPU_NET_COMPRESS=bf16|int8``), negotiated from
the join reply's ``caps``: commit tensors are quantized per tensor before
transmission; under ``int8`` the quantization error is carried forward as
an **error-feedback residual** added to the next window's delta. The
residual is discarded on rejoin.

Typed, **non-retryable** failures (:class:`ServerDrainingError`,
:class:`LeaseExpiredError`, any error the server answered) surface
immediately. With a comma-separated endpoint list (primary first, then
standbys) the client walks to the next endpoint once a retry against the
same one has also failed, and on every ``not_primary`` answer (an
unpromoted standby, a fenced ex-primary), for as long as the failover
patience window lasts (twice the lease plus one deadline). **Epochs**: a
join adopts the server's primary epoch and every member op carries it; a
stale one is answered ``epoch_fenced`` and handled like an eviction — the
client re-joins (adopting the promoted primary's epoch) and a fenced
commit reports ``evicted=True``: it was never folded.

**Transports** (``DKTPU_NET_TRANSPORT=tcp|shm|mesh``), negotiated at join:
a ``shm`` client upgrades to the server's shared-memory ring
(:mod:`~distkeras_tpu_torch.netps.shm`) when the join reply advertises one
on this host (boot id) whose doorbell this process can see; a ``mesh``
client negotiates the ring too and, when the advertisement names THIS
process (:func:`~distkeras_tpu_torch.netps.mesh.local_mesh_id`), hands its
requests straight to the server's in-process dispatch
(:mod:`~distkeras_tpu_torch.netps.mesh`). Everything else stays on TCP.
The ladder goes down, never up, until the next join: a mesh failure
demotes at once (one strike: a lost dispatch target does not come back),
two ring failures in a row (or the last attempt) fall back to TCP, and
either way the retransmit keeps its seq, so the server's dedup keeps the
commit exactly-once. RPC spans carry the dialect (``netps.rpc.commit.shm``,
``.mesh``; bare for TCP). Striping, tracing and the tuner's probe come
with later slices.

One client serves one worker thread; public methods are not safe to call
concurrently (the dialect's fallback sweep takes a lock of its own).
"""

from __future__ import annotations

import socket
import threading
import time
import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import mesh as _mesh
from distkeras_tpu_torch.netps import shm, wire
from distkeras_tpu_torch.netps.endpoints import EndpointWalker, budget_left
from distkeras_tpu_torch.netps.errors import (
    EpochFencedError,
    LeaseExpiredError,
    NetPSError,
    NotPrimaryError,
    ProtocolError,
    RPCTimeoutError,
    ServerClosedError,
    ServerDrainingError,
)
from distkeras_tpu_torch.resilience.backoff import full_jitter
from distkeras_tpu_torch.runtime import config

#: server error kind -> typed exception. Everything here except
#: ``not_primary`` is non-retryable: the server answered, it just said no.
#: ``not_primary`` is retried by walking the endpoint list; ``epoch_fenced``
#: surfaces typed and the caller re-joins, as after an eviction.
_ERROR_TYPES = {
    "draining": ServerDrainingError,
    "lease_expired": LeaseExpiredError,
    "uninitialized": NetPSError,
    "protocol": ProtocolError,
    "epoch_fenced": EpochFencedError,
    "not_primary": NotPrimaryError,
}


#: measured-bad knob pairings already warned about in this process: a fleet
#: of workers must not warn N times.
_BAD_KNOB_COMBOS_WARNED: set = set()


def _validate_knob_combo(codec: str, transport: str) -> None:
    """One warning per process (and a telemetry event) when a measured-bad
    pairing is asked for. Advisory only: the knobs apply as asked. The
    counter and event names are the JAX package's, so one report reads
    both."""
    combos = []
    if transport == "shm" and codec == wire.CODEC_INT8:
        combos.append((
            "int8+shm",
            "int8 loses on the shm ring: the quantize/dequantize passes "
            "cost more than the bytes they save at memcpy speed; prefer "
            "DKTPU_NET_COMPRESS=none"))
    if transport == "mesh" and codec == wire.CODEC_INT8:
        combos.append((
            "int8+mesh",
            "the mesh dialect moves no wire bytes, so the int8 codec buys "
            "nothing and still pays the quantization error and the "
            "encode/decode passes; prefer DKTPU_NET_COMPRESS=none"))
    for combo, why in combos:
        if combo in _BAD_KNOB_COMBOS_WARNED:
            continue
        _BAD_KNOB_COMBOS_WARNED.add(combo)
        telemetry.counter("tuner.knob_warnings").add(1)
        telemetry.event("netps_knob_warning", {"combo": combo, "why": why})
        warnings.warn(f"measured-bad knob combination {combo}: {why}",
                      RuntimeWarning, stacklevel=3)


class CommitResult(NamedTuple):
    """What happened to one commit: ``applied`` (folded now),
    ``duplicate`` (folded by an earlier retransmit — still success),
    ``evicted`` (lease expired; the window was discarded and the client
    re-joined — pull fresh and continue)."""

    applied: bool
    duplicate: bool
    evicted: bool
    updates: int
    staleness: int


class PSClient:
    """One worker's connection to a
    :class:`~distkeras_tpu_torch.netps.server.PSServer` (or anything
    speaking the wire protocol). ``timeout``/``retries``/``backoff``/
    ``compress`` default from the registry (``DKTPU_NET_TIMEOUT`` /
    ``DKTPU_NET_RETRIES`` / ``DKTPU_NET_BACKOFF`` /
    ``DKTPU_NET_COMPRESS``), and ``transport`` from
    ``DKTPU_NET_TRANSPORT``. An eviction or a fence re-joins on its own
    (a fence walks to the promoted primary first)."""

    def __init__(self, endpoint: str, worker_id: Optional[int] = None,
                 timeout: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff: Optional[float] = None,
                 compress: Optional[str] = None,
                 transport: Optional[str] = None):
        if ";" in endpoint:
            raise NotImplementedError(
                f"sharded endpoint {endpoint!r}: the sharded center plane "
                "is not ported to distkeras_tpu_torch yet; it comes with "
                "the sharded-center slice")
        #: serializes the shm->TCP fallback sweep, the mesh demotion and
        #: the endpoint walk (the walker shares it): one transition, one
        #: teardown.
        self._fallback_lock = threading.Lock()
        #: ordered failover traversal — ``endpoint`` may be a
        #: comma-separated list (primary first).
        self._walker = EndpointWalker(endpoint, lock=self._fallback_lock)
        self.endpoint = endpoint
        self.worker_id = worker_id
        self.timeout = float(timeout if timeout is not None
                             else config.env_float("DKTPU_NET_TIMEOUT"))
        self.retries = int(retries if retries is not None
                           else config.env_int("DKTPU_NET_RETRIES"))
        self.backoff = float(backoff if backoff is not None
                             else config.env_float("DKTPU_NET_BACKOFF"))
        requested = compress if compress is not None else wire.net_codec()
        if requested not in wire.CODECS:
            raise ValueError(f"unknown codec {requested!r}; "
                             f"known: {list(wire.CODECS)}")
        self.requested_codec = requested
        transport = (transport if transport is not None
                     else shm.transport_mode())
        if transport not in shm.TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}; "
                             f"known: {list(shm.TRANSPORTS)}")
        #: the requested dialect; what is used is :attr:`active_transport`.
        self.transport = transport
        _validate_knob_combo(requested, transport)
        #: negotiated at join; f32 until then.
        self.codec = wire.CODEC_NONE
        #: the server's ring endpoint (``{"boot_id", "uds"}``) when the
        #: same-host check passed at join, else None (TCP).
        self.shm_info: Optional[dict] = None
        #: the server's in-process dispatch (``{"proc", "token", ...}``)
        #: when the same-process check passed at join, else None.
        self.mesh_info: Optional[dict] = None
        self.lease_s: Optional[float] = None
        #: the primary epoch the last join adopted (None until a join
        #: against an epoch-aware server); stamped on every member op.
        self.epoch: Optional[int] = None
        self._sock: Optional[socket.socket] = None
        self._ring: Optional[shm.ShmConnection] = None
        self._req = 0
        self._ever_connected = False
        #: the last dialect established on the connection ("tcp", "shm"):
        #: only a same-dialect re-establishment is a reconnect; a
        #: negotiated switch (the post-join ring upgrade, a fallback's TCP
        #: connect) is not failure evidence.
        self._dialect: Optional[str] = None
        #: int8 error-feedback residual, one f32 array per delta tensor.
        self._residual: Optional[list] = None
        self._seq = -1
        self._closed = False
        #: times this client re-joined after an eviction or a fence
        #: (worker loops watch it to re-adopt the center on rejoin).
        self.rejoin_count = 0
        #: times the endpoint walker moved off an endpoint.
        self.walk_count = 0
        #: the last join's ``(center, updates)``.
        self._last_join: tuple = ([], -1)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        self._closed = True
        self._disconnect()

    def __enter__(self) -> "PSClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def active_transport(self) -> str:
        """The dialect the data connection speaks right now."""
        if self.mesh_info is not None:
            return "mesh"
        return "shm" if self.shm_info is not None else "tcp"

    def _connect(self, deadline: float) -> socket.socket:
        if self._sock is not None:
            return self._sock
        if self._ever_connected and self._dialect == "tcp":
            telemetry.counter("netps.reconnects").add(1)
        # The connect spends from the SAME per-attempt budget as the send
        # and the reply.
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise socket.timeout("deadline exceeded before connect")
        sock = socket.create_connection(self._walker.current(),
                                        timeout=remaining)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._ever_connected = True
        self._dialect = "tcp"
        return sock

    def _connect_ring(self, uds: str, deadline: float) -> shm.ShmConnection:
        """Attach a ring with FRESH segments (the post-join upgrade, or a
        re-attach after a failed one)."""
        if self._ring is not None:
            return self._ring
        if self._dialect == "shm":
            telemetry.counter("netps.reconnects").add(1)
        elif self._ever_connected:
            # The routine post-join TCP -> ring upgrade: its own counter,
            # not a reconnect (which is failure evidence).
            telemetry.counter("netps.shm_upgrades").add(1)
        # The attach (UDS connect, segments, fd passing) spends from the
        # same per-attempt budget as the doorbell round trip.
        ring = shm.ShmConnection(uds, deadline - time.monotonic())
        self._ring = ring
        # A fallback sweep may have run while we attached: it nulls
        # shm_info before closing connections, so checking after publishing
        # the ring guarantees one side closes it.
        if self.shm_info is None:
            self._disconnect()
            raise ConnectionError("shm fallback engaged during ring attach")
        self._ever_connected = True
        self._dialect = "shm"
        return ring

    def _disconnect(self) -> None:
        # Snapshot-and-null, then close: a sweep and the attempt's own
        # teardown may race, and both closes are idempotent.
        sock, self._sock = self._sock, None
        ring, self._ring = self._ring, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if ring is not None:
            ring.close()

    # -- the guarded RPC core ----------------------------------------------
    def _rpc(self, op: str, header: dict,
             arrays: Sequence = ()) -> tuple[dict, list]:
        if self._closed:
            raise ServerClosedError(f"client to {self.endpoint} is closed")
        attempts = self.retries + 1
        patience = self._walker.patience(self.lease_s, self.timeout)
        last_exc: Optional[BaseException] = None
        attempt = 0
        while True:
            self._req += 1
            req = self._req
            hdr = dict(header, op=op, req=req)
            if self.worker_id is not None:
                hdr.setdefault("worker_id", int(self.worker_id))
            # The span names the dialect of THIS attempt, so the TCP
            # attempts after a demotion are not billed to the faster one.
            dialect = (".mesh" if self.mesh_info is not None
                       else ".shm" if self.shm_info is not None else "")
            ep_seen = self._walker.index
            try:
                with telemetry.span(f"netps.rpc.{op}{dialect}"):
                    return self._attempt(req, hdr, arrays)
            except NotPrimaryError as e:
                # The peer answered, but it is an unpromoted standby or a
                # fenced ex-primary: retry by WALKING the endpoint list —
                # the same RPC against the next endpoint (or this one,
                # after promotion) can succeed.
                last_exc = e
                self._disconnect()
                self._walk(ep_seen)
            except (socket.timeout, ConnectionError, OSError,
                    ProtocolError) as e:
                if getattr(e, "from_reply", False):
                    raise  # the server said no; asking again won't help
                last_exc = e
                self._disconnect()
                self._demote(e, last_attempt=(attempt >= 1
                                              or attempt + 1 == attempts))
                # Walk to the next endpoint only once a retry against the
                # same one has also failed: one flaky frame against a
                # healthy server is not a reason to leave it.
                if attempt >= 1 or attempt + 1 == attempts:
                    self._walk(ep_seen)
            if not budget_left(attempt, attempts, patience):
                break
            telemetry.counter("netps.retries").add(1)
            time.sleep(full_jitter(self.backoff, min(attempt, 6)))
            attempt += 1
        telemetry.counter("netps.rpc_failures").add(1)
        if isinstance(last_exc, NotPrimaryError):
            # Every endpoint we reached is a standby or a fenced
            # ex-primary: "nobody is primary yet" surfaces typed.
            raise last_exc
        raise RPCTimeoutError(
            f"{op} to {self.endpoint} failed after {attempt + 1} attempts "
            f"(last: {type(last_exc).__name__}: {last_exc})",
            attempts=attempt + 1)

    def _demote(self, exc: BaseException, last_attempt: bool) -> None:
        """A transport failure's effect on the dialect. The mesh demotes at
        the first failure (one strike: a closed server's dispatch does not
        come back); the NEXT attempt of the same RPC lands on the ring or
        TCP with the same seq. The ring falls back to TCP (which the server
        always serves) after two failures in a row, or on the last attempt
        of a smaller budget, so a client with no retries still lands its
        next RPC on TCP; the next join negotiates the upgrade again."""
        with self._fallback_lock:
            mesh_swept = self.mesh_info is not None
            self.mesh_info = None
            shm_swept = (not mesh_swept and last_attempt
                         and self.shm_info is not None)
            if shm_swept:
                self.shm_info = None
                self._disconnect()
        if mesh_swept:
            telemetry.counter("netps.mesh.demotions").add(1)
            telemetry.event("netps_mesh_demotion",
                            {"why": f"{type(exc).__name__}: {exc}"})
        if shm_swept:
            telemetry.counter("netps.shm_fallbacks").add(1)

    def _walk(self, seen_idx: int) -> None:
        """Advance past a failure observed against ``seen_idx`` (the
        walker's CAS; the connection to the old endpoint is already
        dropped). The next endpoint is another process: neither its ring
        nor its dispatch were negotiated with this one."""
        def teardown():
            self.shm_info = None
            self.mesh_info = None
            self._disconnect()

        if self._walker.walk(seen_idx, on_walk=teardown):
            self.walk_count += 1
            telemetry.counter("netps.endpoint_walks").add(1)

    def _stamped(self, header: dict) -> dict:
        """Stamp the adopted epoch into a member-op header (nothing against
        a pre-epoch server: we never claim an epoch we were not given)."""
        if self.epoch is not None:
            header["epoch"] = self.epoch
        return header

    def _rejoin(self) -> None:
        """An eviction or a fence: re-join (walking to the promoted
        primary for a fence)."""
        self.rejoin_count += 1
        self.join()

    def _attempt(self, req: int, hdr: dict,
                 arrays: Sequence) -> tuple[dict, list]:
        """One connect + send + matched-reply receive under ONE deadline,
        on the dialect the join negotiated: the in-process dispatch, the
        ring, or TCP frames. The deadline, matching and error contract are
        the same on each."""
        minfo = self.mesh_info
        if minfo is not None:
            # One direct call: the server's dispatch enforces the same op
            # contract (dedup, lease, fence) under its lock; a gone peer
            # raises ConnectionError into the demotion above.
            rhdr, rarrays = _mesh.dispatch(minfo["token"], hdr, list(arrays))
            return self._checked(hdr, rhdr), rarrays
        deadline = time.monotonic() + self.timeout
        # One read: a fallback sweep may null shm_info at any point; this
        # attempt finishes on the dialect it started with (a closed ring
        # raises the retryable taxonomy).
        info = self.shm_info
        if info is not None:
            ring = self._connect_ring(info["uds"], deadline)
            ring.settimeout(max(0.001, deadline - time.monotonic()))
            sent = ring.send(wire.KIND_REQUEST, hdr, arrays)
            set_timeout, recv_one = ring.settimeout, ring.recv
        else:
            sock = self._connect(deadline)
            sock.settimeout(max(0.001, deadline - time.monotonic()))
            sent = wire.send_frame(sock, wire.KIND_REQUEST, hdr, arrays)
            set_timeout = sock.settimeout

            def recv_one():
                prefix = wire.recv_exact(sock, wire.PREFIX_SIZE)
                return wire.finish_frame(sock, prefix)
        telemetry.counter("netps.bytes_sent").add(sent)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout(f"{hdr['op']} deadline exceeded")
            set_timeout(remaining)
            kind, nbytes, rhdr, rarrays = recv_one()
            if kind != wire.KIND_REPLY:
                raise ProtocolError(f"expected a reply frame, got kind {kind}")
            if rhdr.get("req") != req:
                # A duplicated or late reply: discard and keep reading — the
                # req echo is what keeps the stream sane.
                telemetry.counter("netps.stale_replies").add(1)
                continue
            telemetry.counter("netps.bytes_received").add(nbytes)
            return self._checked(hdr, rhdr), rarrays

    @staticmethod
    def _checked(hdr: dict, rhdr: dict) -> dict:
        """A reply header, or the typed error the server answered."""
        err = rhdr.get("error")
        if err:
            exc = _ERROR_TYPES.get(err, NetPSError)(
                f"{hdr['op']}: server said {err}: "
                f"{rhdr.get('message', '')}")
            # The server ANSWERED: retrying a deterministic rejection burns
            # the whole budget for the same answer.
            exc.from_reply = True
            raise exc
        return rhdr

    # -- RPC surface --------------------------------------------------------
    def join(self, init: Optional[Sequence[np.ndarray]] = None,
             ) -> tuple[list, int]:
        """Become (or re-become) a member; returns ``(center, updates)``.
        ``init`` seeds an uninitialized server (first joiner wins; later
        inits are ignored — everyone adopts the server's center). The join
        reply's ``caps`` select the codec for every later commit."""
        hdr, center = self._rpc(wire.OP_JOIN, {"caps": wire.CAPS},
                                list(init or ()))
        self.worker_id = int(hdr["worker_id"])
        self.lease_s = hdr.get("lease_s")
        # A join ADOPTS the server's epoch (a failover re-join is exactly
        # this client arriving with a stale lineage).
        self.epoch = (int(hdr["epoch"]) if hdr.get("epoch") is not None
                      else None)
        caps = hdr.get("caps") or {}
        self.codec = (self.requested_codec
                      if self.requested_codec in caps.get("codecs", ())
                      else wire.CODEC_NONE)
        self._negotiate_transport(caps)
        # Error feedback restarts on every (re)join: the residual belongs
        # to the window lineage the rejoin just discarded.
        self._residual = None
        # Resume the commit sequence past what the server already folded
        # from this worker_id: a restarted worker process starts at seq -1.
        server_seq = int(hdr.get("last_seq", -1))
        if server_seq > self._seq:
            self._seq = server_seq
        self._last_join = (center, int(hdr["updates"]))
        return self._last_join

    def _negotiate_transport(self, caps: dict) -> None:
        """The join reply's transport upgrade. The ring: only when this
        client asked for shm (or mesh, whose demotion target it is) AND
        the server advertised a ring on this host (boot id) whose doorbell
        this process can see. The mesh: only when this client asked for it
        AND the advertisement names this process (the port's ``torch:``
        token; a JAX server's never matches). Anything else stays on TCP.
        A re-join that lands on another answer tears the old connection
        down."""
        adv = caps.get("shm")
        info = (adv if self.transport in ("shm", "mesh")
                and isinstance(adv, dict) and adv.get("uds")
                and adv.get("boot_id") == shm.local_boot_id()
                and shm.endpoint_visible(adv["uds"]) else None)
        madv = caps.get("mesh")
        minfo = (madv if self.transport == "mesh" and isinstance(madv, dict)
                 and madv.get("token")
                 and madv.get("proc") == _mesh.local_mesh_id() else None)
        with self._fallback_lock:
            if (info is None) != (self.shm_info is None):
                self._disconnect()
            self.shm_info = info
            upgraded = minfo is not None and self.mesh_info is None
            self.mesh_info = minfo
        if upgraded:
            telemetry.counter("netps.mesh.upgrades").add(1)

    def adopt_dialect(self, other: "PSClient",
                      center: Sequence[np.ndarray] = ()) -> None:
        """Adopt another client's join-negotiated dialect (codec, epoch,
        lease, transport) without a join of our own — membership is by
        worker_id, not by connection. The overlapped loop's pull-prefetch
        client uses this so both lanes speak the same wire, each on a ring
        (or a dispatch) of its own. ``center`` (the joined center) is what
        the JAX client sizes its stripes from; the port does not
        stripe."""
        del center
        self.codec = other.codec
        self.epoch = other.epoch
        self.lease_s = other.lease_s
        with self._fallback_lock:
            self.shm_info = other.shm_info
            self.mesh_info = other.mesh_info

    def pull(self) -> tuple[list, int]:
        """Current center + update counter; renews the lease. An evicted
        or fenced client transparently re-joins first."""
        try:
            hdr, center = self._rpc(wire.OP_PULL, self._stamped({}))
        except (LeaseExpiredError, EpochFencedError):
            self._rejoin()
            return self._last_join
        return center, int(hdr["updates"])

    def _compress_delta(self, delta: Sequence[np.ndarray]) -> list:
        """Delta tensors -> wire items under the negotiated codec, updating
        the int8 error-feedback residual (quantization error carried into
        the NEXT commit, so the wire's bias corrects over rounds)."""
        delta = [np.ascontiguousarray(d, np.float32) for d in delta]
        telemetry.counter("netps.bytes_precompress").add(
            sum(d.nbytes for d in delta))
        if self.codec == wire.CODEC_NONE:
            return delta
        if self.codec == wire.CODEC_INT8 and self._residual is None:
            self._residual = [np.zeros_like(d) for d in delta]
        items = []
        for i, d in enumerate(delta):
            if self.codec == wire.CODEC_INT8:
                d = d + self._residual[i]
            encoded, extras = wire.codec_encode(d, self.codec)
            if self.codec == wire.CODEC_INT8:
                self._residual[i] = d - wire.codec_decode(encoded, extras)
            items.append((encoded, extras) if extras else encoded)
        return items

    def commit(self, delta: Sequence[np.ndarray],
               pulled_counter: int) -> CommitResult:
        """Fold ``delta`` (worker-normalized) into the center. The seq is
        assigned before the first transmission and reused across retries:
        a lost ACK can never double-fold."""
        self._seq += 1
        seq = self._seq
        items = self._compress_delta(delta)
        try:
            hdr, _ = self._rpc(wire.OP_COMMIT, self._stamped(
                {"seq": seq, "pulled": int(pulled_counter)}), items)
        except (LeaseExpiredError, EpochFencedError):
            # Evicted or fenced: the commit was NEVER folded; discard the
            # window, re-join, continue from a fresh pull.
            self._rejoin()
            return CommitResult(applied=False, duplicate=False,
                                evicted=True, updates=-1, staleness=-1)
        return CommitResult(
            applied=bool(hdr.get("applied")),
            duplicate=bool(hdr.get("duplicate")),
            evicted=False, updates=int(hdr["updates"]),
            staleness=int(hdr.get("staleness", -1)))

    def heartbeat(self) -> int:
        """Renew the lease; returns the server's update counter."""
        try:
            hdr, _ = self._rpc(wire.OP_HEARTBEAT, self._stamped({}))
        except (LeaseExpiredError, EpochFencedError):
            self._rejoin()
            return self._last_join[1]
        return int(hdr["updates"])

    def stats(self) -> dict:
        """One membership-free scrape of the peer (op ``stats``): its
        telemetry snapshot and state, ``caps`` included."""
        hdr, _ = self._rpc(wire.OP_STATS, {"ring": 0})
        return hdr

    def leave(self) -> None:
        """Best-effort clean departure (a dead server is not an error —
        leaving was the goal)."""
        try:
            self._rpc(wire.OP_LEAVE, {})
        except (NetPSError, OSError):
            pass
