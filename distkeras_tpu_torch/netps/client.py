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
``.mesh``; bare for TCP).

**Striping** (``DKTPU_NET_SHARDS=N``, negotiated from the join reply's
``striping`` bit): the tensors are striped, byte-balanced and
deterministic, over N connections to the one server (each negotiating its
own dialect: over ``shm`` each stripe connection attaches a ring of its
own); pulls and commits issue one concurrent sub-RPC per stripe (span
``netps.rpc.<op>.s<k>``) and reassemble before the caller sees anything.
One logical commit keeps ONE ``seq`` across all stripes: the server
assembles the stripes and folds once. A striped pull whose stripes
straddled a concurrent fold (a torn read, seen in the echoed update
counters) is re-pulled, counting ``netps.pull_torn_retries``; after
``_PULL_CONSISTENT_TRIES`` torn reads it falls back to one unstriped pull.

**Self-tuning** (``netps/tuner/``): :meth:`PSClient.probe` sends one timed
micro-A/B round trip of a payload under a candidate codec to a peer that
advertises ``tuner``, and :meth:`PSClient.retune` adopts a new codec or
stripe count mid-run through the state the join negotiation writes, so a
retransmit after a retune keeps its seq and dedups as before. Tracing
comes with a later slice.

One client serves one worker thread; public methods are not safe to call
concurrently (the stripe sub-RPCs inside one call run on the client's own
pool over disjoint connections; the dialect's fallback sweep takes a lock
of its own).
"""

from __future__ import annotations

import socket
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
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
    ShardPlanError,
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
    "shard_plan": ShardPlanError,
}

#: striped-pull consistency budget: whole-pull re-reads before falling back
#: to one unstriped pull (a torn read needs a fold to land mid-pull).
_PULL_CONSISTENT_TRIES = 3


#: measured-bad knob pairings already warned about in this process: a fleet
#: of workers must not warn N times.
_BAD_KNOB_COMBOS_WARNED: set = set()


def _validate_knob_combo(codec: str, transport: str,
                        shards: int = 1) -> None:
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
    if transport == "shm" and shards > 1:
        combos.append((
            "shards>1+shm",
            "striping over the shm ring pays a doorbell per stripe for "
            "payloads that already move at memcpy speed; prefer "
            "DKTPU_NET_SHARDS=1"))
    if transport == "mesh" and codec == wire.CODEC_INT8:
        combos.append((
            "int8+mesh",
            "the mesh dialect moves no wire bytes, so the int8 codec buys "
            "nothing and still pays the quantization error and the "
            "encode/decode passes; prefer DKTPU_NET_COMPRESS=none"))
    if transport == "mesh" and shards > 1:
        combos.append((
            "shards>1+mesh",
            "striping splits commits across sockets the mesh dialect "
            "never opens: every stripe lands on the same in-process "
            "dispatch and the server just reassembles them; prefer "
            "DKTPU_NET_SHARDS=1"))
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


class _Conn:
    """One data connection — TCP socket or shared-memory ring — with its
    own request-id stream (reply matching is per connection, so ids need
    only be unique per stream)."""

    __slots__ = ("sock", "ring", "req", "ever_connected", "dialect")

    def __init__(self):
        self.sock: Optional[socket.socket] = None
        self.ring: Optional[shm.ShmConnection] = None
        self.req = 0
        self.ever_connected = False
        #: the last dialect established on this connection ("tcp",
        #: "shm"): only a same-dialect re-establishment is a reconnect; a
        #: negotiated switch (the post-join ring upgrade, a fallback's TCP
        #: connect) is not failure evidence.
        self.dialect: Optional[str] = None


class PSClient:
    """One worker's connection(s) to a
    :class:`~distkeras_tpu_torch.netps.server.PSServer` (or anything
    speaking the wire protocol). ``timeout``/``retries``/``backoff``/
    ``shards``/``compress`` default from the registry
    (``DKTPU_NET_TIMEOUT`` / ``DKTPU_NET_RETRIES`` / ``DKTPU_NET_BACKOFF``
    / ``DKTPU_NET_SHARDS`` / ``DKTPU_NET_COMPRESS``), and ``transport``
    from ``DKTPU_NET_TRANSPORT``. An eviction or a fence re-joins on its
    own (a fence walks to the promoted primary first). ``endpoint`` is one
    failover list; a ``;`` shard matrix is dialed through
    :func:`~distkeras_tpu_torch.netps.shards.make_ps_client`."""

    def __init__(self, endpoint: str, worker_id: Optional[int] = None,
                 timeout: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff: Optional[float] = None,
                 shards: Optional[int] = None,
                 compress: Optional[str] = None,
                 transport: Optional[str] = None):
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
        #: requested stripe connections; what is used is the
        #: join-negotiated :attr:`active_shards`.
        self.shards = max(1, int(shards if shards is not None
                                 else config.env_int("DKTPU_NET_SHARDS")))
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
        _validate_knob_combo(requested, transport, self.shards)
        #: negotiated at join; f32 on one connection until then.
        self.codec = wire.CODEC_NONE
        self.active_shards = 1
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
        self._conns = [_Conn() for _ in range(self.shards)]
        self._pool: Optional[ThreadPoolExecutor] = None
        #: tensor-index stripes, one list a stripe connection, from the
        #: joined center's shapes (None: unstriped).
        self._stripes: Optional[list] = None
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
        #: extra header fields merged into EVERY join, the re-join after an
        #: eviction or a fence included: the sharded client rides its shard
        #: identity and plan hash here.
        self._join_extra: dict = {}
        #: the last join reply's ``caps`` and the last ``plan_hash`` any
        #: reply echoed: the sharded client's cross-check surface.
        self.peer_caps: Optional[dict] = None
        self.peer_plan_hash: Optional[str] = None

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        self._closed = True
        self._disconnect()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

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

    def _connect(self, conn: _Conn, deadline: float) -> socket.socket:
        if conn.sock is not None:
            return conn.sock
        if conn.ever_connected and conn.dialect == "tcp":
            telemetry.counter("netps.reconnects").add(1)
        # The connect spends from the SAME per-attempt budget as the send
        # and the reply.
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise socket.timeout("deadline exceeded before connect")
        sock = socket.create_connection(self._walker.current(),
                                        timeout=remaining)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.sock = sock
        conn.ever_connected = True
        conn.dialect = "tcp"
        return sock

    def _connect_ring(self, conn: _Conn, uds: str,
                      deadline: float) -> shm.ShmConnection:
        """Attach a ring with FRESH segments (the post-join upgrade, or a
        re-attach after a failed one)."""
        if conn.ring is not None:
            return conn.ring
        if conn.dialect == "shm":
            telemetry.counter("netps.reconnects").add(1)
        elif conn.ever_connected:
            # The routine post-join TCP -> ring upgrade: its own counter,
            # not a reconnect (which is failure evidence).
            telemetry.counter("netps.shm_upgrades").add(1)
        # The attach (UDS connect, segments, fd passing) spends from the
        # same per-attempt budget as the doorbell round trip.
        ring = shm.ShmConnection(uds, deadline - time.monotonic())
        conn.ring = ring
        # A fallback sweep may have run while we attached: it nulls
        # shm_info before closing connections, so checking after publishing
        # the ring guarantees one side closes it.
        if self.shm_info is None:
            self._disconnect(conn)
            raise ConnectionError("shm fallback engaged during ring attach")
        conn.ever_connected = True
        conn.dialect = "shm"
        return ring

    def _disconnect(self, conn: Optional[_Conn] = None) -> None:
        """Drop ``conn``'s socket and ring (every connection's when None)."""
        for c in (self._conns if conn is None else (conn,)):
            # Snapshot-and-null, then close: a sweep and the attempt's own
            # teardown may race (from two stripe threads), and both closes
            # are idempotent.
            sock, c.sock = c.sock, None
            ring, c.ring = c.ring, None
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            if ring is not None:
                ring.close()

    def _shard_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.active_shards,
                thread_name_prefix="netps-stripe")
        return self._pool

    # -- the guarded RPC core ----------------------------------------------
    def _rpc(self, op: str, header: dict, arrays: Sequence = (),
             conn_idx: int = 0) -> tuple[dict, list]:
        if self._closed:
            raise ServerClosedError(f"client to {self.endpoint} is closed")
        conn = self._conns[conn_idx]
        attempts = self.retries + 1
        patience = self._walker.patience(self.lease_s, self.timeout)
        last_exc: Optional[BaseException] = None
        attempt = 0
        while True:
            conn.req += 1
            req = conn.req
            hdr = dict(header, op=op, req=req)
            if self.worker_id is not None:
                hdr.setdefault("worker_id", int(self.worker_id))
            # The span names the dialect of THIS attempt, so the TCP
            # attempts after a demotion are not billed to the faster one,
            # and a stripe sub-RPC its stripe.
            dialect = (".mesh" if self.mesh_info is not None
                       else ".shm" if self.shm_info is not None else "")
            label = (f"netps.rpc.{op}.s{header['shard']}{dialect}"
                     if "shard" in header else f"netps.rpc.{op}{dialect}")
            ep_seen = self._walker.index
            try:
                with telemetry.span(label):
                    return self._attempt(conn, req, hdr, arrays)
            except NotPrimaryError as e:
                # The peer answered, but it is an unpromoted standby or a
                # fenced ex-primary: retry by WALKING the endpoint list —
                # the same RPC against the next endpoint (or this one,
                # after promotion) can succeed.
                last_exc = e
                self._disconnect(conn)
                self._walk(ep_seen)
            except (socket.timeout, ConnectionError, OSError,
                    ProtocolError) as e:
                if getattr(e, "from_reply", False):
                    raise  # the server said no; asking again won't help
                last_exc = e
                self._disconnect(conn)
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
                # Every stripe's ring goes: stale attachments would leak
                # segments and a server handler thread.
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

    def _attempt(self, conn: _Conn, req: int, hdr: dict,
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
            ring = self._connect_ring(conn, info["uds"], deadline)
            ring.settimeout(max(0.001, deadline - time.monotonic()))
            sent = ring.send(wire.KIND_REQUEST, hdr, arrays)
            set_timeout, recv_one = ring.settimeout, ring.recv
        else:
            sock = self._connect(conn, deadline)
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

    # -- striping helpers ---------------------------------------------------
    def _compute_stripes(self, template: Sequence[np.ndarray]) -> None:
        """Byte-balanced greedy stripe assignment of tensor indices over the
        active stripe connections, from the joined center's shapes (the
        JAX client's rule). Deterministic; the indices ride in every
        stripe header, so the server never recomputes it."""
        n = min(self.active_shards, max(1, len(template)))
        if n <= 1:
            self._stripes = None
            return
        order = sorted(range(len(template)),
                       key=lambda i: (-int(np.asarray(template[i]).nbytes), i))
        loads = [0] * n
        stripes: list = [[] for _ in range(n)]
        for i in order:
            k = loads.index(min(loads))
            stripes[k].append(i)
            loads[k] += int(np.asarray(template[i]).nbytes)
        for st in stripes:
            st.sort()
        self._stripes = stripes

    def _striped(self) -> bool:
        return (self.active_shards > 1 and self._stripes is not None
                and len(self._stripes) > 1)

    @staticmethod
    def _gather(futures: list) -> list:
        """Results of stripe futures; waits for ALL (no connection left
        with an in-flight reply), then re-raises the highest-priority
        failure: a lease expiry or a fence beats a transport error (the
        caller's re-join handles it; a retry cannot)."""
        results, errors = [], []
        for f in futures:
            try:
                results.append(f.result())
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
        if errors:
            for e in errors:
                if isinstance(e, (LeaseExpiredError, EpochFencedError)):
                    raise e
            raise errors[0]
        return results

    # -- RPC surface --------------------------------------------------------
    def join(self, init: Optional[Sequence[np.ndarray]] = None,
             ) -> tuple[list, int]:
        """Become (or re-become) a member; returns ``(center, updates)``.
        ``init`` seeds an uninitialized server (first joiner wins; later
        inits are ignored — everyone adopts the server's center). The join
        reply's ``caps`` select the codec, the stripes and the dialect for
        every later pull and commit. ``_join_extra`` (the sharded client's
        shard identity and plan) rides on every join, re-joins included."""
        hdr, center = self._rpc(wire.OP_JOIN,
                                dict(self._join_extra, caps=wire.CAPS),
                                list(init or ()))
        self.worker_id = int(hdr["worker_id"])
        self.lease_s = hdr.get("lease_s")
        # A join ADOPTS the server's epoch (a failover re-join is exactly
        # this client arriving with a stale lineage).
        self.epoch = (int(hdr["epoch"]) if hdr.get("epoch") is not None
                      else None)
        caps = hdr.get("caps") or {}
        self.peer_caps = caps
        sharding = caps.get("sharding")
        self.peer_plan_hash = (sharding.get("plan_hash")
                               if isinstance(sharding, dict) else None)
        self.codec = (self.requested_codec
                      if self.requested_codec in caps.get("codecs", ())
                      else wire.CODEC_NONE)
        self.active_shards = self.shards if caps.get("striping") else 1
        self._compute_stripes(center)
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
        """Adopt another client's join-negotiated dialect (codec, stripes,
        epoch, lease, transport) without a join of our own — membership is
        by worker_id, not by connection. The overlapped loop's
        pull-prefetch client uses this so both lanes speak the same wire,
        each on connections (rings, a dispatch) of its own; ``center``
        (the joined center) sizes the stripes."""
        self.codec = other.codec
        self.active_shards = other.active_shards
        self.epoch = other.epoch
        self.lease_s = other.lease_s
        self.peer_caps = other.peer_caps
        self.peer_plan_hash = other.peer_plan_hash
        with self._fallback_lock:
            self.shm_info = other.shm_info
            self.mesh_info = other.mesh_info
        self._compute_stripes(center)

    # -- self-tuning surface (netps/tuner/) ---------------------------------
    def probe(self, arrays: Sequence[np.ndarray],
              codec: Optional[str] = None) -> Optional[dict]:
        """One timed micro-A/B round trip under ``codec`` (default: the
        negotiated one): the payload travels and is decoded as a commit
        is, but the server's ``probe`` op touches nothing else. Returns the
        reply header, or None when the joined peer does not speak the
        probe dialect (no ``tuner`` caps bit, or the codec not
        advertised)."""
        caps = self.peer_caps or {}
        if not caps.get("tuner"):
            return None
        use = codec if codec is not None else self.codec
        if use != wire.CODEC_NONE and use not in caps.get("codecs", ()):
            return None
        items: list = []
        for a in arrays:
            a = np.ascontiguousarray(a, np.float32)
            if use == wire.CODEC_NONE:
                items.append(a)
                continue
            encoded, extras = wire.codec_encode(a, use)
            items.append((encoded, extras) if extras else encoded)
        hdr, _ = self._rpc(wire.OP_PROBE,
                           self._stamped({"probe_codec": use}), items)
        return hdr

    def retune(self, codec: Optional[str] = None,
               shards: Optional[int] = None,
               template: Optional[Sequence[np.ndarray]] = None) -> dict:
        """Adopt a new wire dialect MID-RUN through the state the join
        negotiation writes: membership, seq, epoch and exactly-once are
        untouched (a retransmit after a retune carries its original seq
        and dedups as before). Returns ``{knob: (old, new)}`` of what
        changed; a codec the peer never advertised, or a stripe count
        outside ``[1, connections]`` (1 without ``striping``), is clamped,
        not an error. The caller quiesces its own in-flight commits first:
        one logical commit finishes under ONE dialect. ``template`` (the
        center's shapes) sizes the new stripes."""
        caps = self.peer_caps or {}
        changed: dict = {}
        if codec is not None and codec != self.codec:
            if codec == wire.CODEC_NONE or codec in caps.get("codecs", ()):
                changed["codec"] = (self.codec, codec)
                self.codec = codec
                # The residual belongs to the old codec's lineage: error
                # feedback restarts, as on a rejoin.
                self._residual = None
                # A rejoin renegotiates from the retuned preference, so a
                # failover does not undo the controller's decision.
                self.requested_codec = codec
        if shards is not None:
            want = max(1, min(int(shards), len(self._conns)))
            if not caps.get("striping"):
                want = 1
            if want != self.active_shards:
                changed["shards"] = (self.active_shards, want)
                self.active_shards = want
                self.shards = max(self.shards, want)
                if template is not None:
                    self._compute_stripes(template)
                else:
                    self._stripes = None
                # The stripe pool is sized to active_shards: rebuilt on
                # its next use.
                pool, self._pool = self._pool, None
                if pool is not None:
                    pool.shutdown(wait=True)
        return changed

    def pull(self) -> tuple[list, int]:
        """Current center + update counter; renews the lease. An evicted
        or fenced client transparently re-joins first. A striped pull
        reassembles a consistency-checked center."""
        try:
            if self._striped():
                return self._striped_pull()
            hdr, center = self._rpc(wire.OP_PULL, self._stamped({}))
        except (LeaseExpiredError, EpochFencedError):
            self._rejoin()
            return self._last_join
        if hdr.get("plan_hash") is not None:
            # A shard server re-proves its plan identity on every pull;
            # keep the latest so the sharded client can cross-check.
            self.peer_plan_hash = hdr["plan_hash"]
        return center, int(hdr["updates"])

    def _striped_pull(self) -> tuple[list, int]:
        """One sub-pull a stripe; a torn read (stripes from either side of
        a concurrent fold: their update counters differ) is re-read, and
        after ``_PULL_CONSISTENT_TRIES`` of them one unstriped pull, always
        consistent, answers."""
        pool = self._shard_pool()
        stripes = self._stripes
        total = sum(len(st) for st in stripes)
        for _ in range(_PULL_CONSISTENT_TRIES):
            futures = [
                pool.submit(self._rpc, wire.OP_PULL,
                            self._stamped({"shard": k,
                                           "num_shards": len(stripes),
                                           "idx": idx}), (), k)
                for k, idx in enumerate(stripes)]
            replies = self._gather(futures)
            counters = {int(h["updates"]) for h, _ in replies}
            if len(counters) == 1:
                center: list = [None] * total
                for (_h, arrays), idx in zip(replies, stripes):
                    for i, a in zip(idx, arrays):
                        center[i] = a
                plan_hash = replies[0][0].get("plan_hash")
                if plan_hash is not None:
                    self.peer_plan_hash = plan_hash
                return center, counters.pop()
            # A fold landed between stripe reads: a torn center, re-read.
            telemetry.counter("netps.pull_torn_retries").add(1)
        hdr, center = self._rpc(wire.OP_PULL, self._stamped({}))
        if hdr.get("plan_hash") is not None:
            self.peer_plan_hash = hdr["plan_hash"]
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

    def commit(self, delta: Sequence[np.ndarray], pulled_counter: int,
               seq: Optional[int] = None) -> CommitResult:
        """Fold ``delta`` (worker-normalized) into the center. The seq is
        assigned before the first transmission and reused across retries:
        a lost ACK can never double-fold. Striped, ONE seq spans every
        stripe sub-RPC: the server assembles them and folds once. An
        explicit ``seq`` is the sharded client's one logical seq (and its
        dedup-safe same-seq retransmit after a per-shard eviction); this
        client's own counter only ever moves forward."""
        if seq is None:
            self._seq += 1
            seq = self._seq
        else:
            seq = int(seq)
            self._seq = max(self._seq, seq)
        items = self._compress_delta(delta)
        base = self._stamped({"seq": seq, "pulled": int(pulled_counter)})
        try:
            if self._striped() and len(items) == sum(
                    len(st) for st in self._stripes):
                hdr = self._striped_commit(base, items)
            else:
                hdr, _ = self._rpc(wire.OP_COMMIT, base, items)
        except (LeaseExpiredError, EpochFencedError):
            # Evicted or fenced: the commit was NEVER folded; discard the
            # window, re-join, continue from a fresh pull.
            self._rejoin()
            return CommitResult(applied=False, duplicate=False,
                                evicted=True, updates=-1, staleness=-1)
        if hdr is None:
            # Every stripe answered ``pending``: membership churn (an
            # eviction or a re-join purging the server's half-assembled
            # stripe set) lost this commit. It was never folded and never
            # will be: the evicted path's recovery.
            self._rejoin()
            return CommitResult(applied=False, duplicate=False,
                                evicted=True, updates=-1, staleness=-1)
        return CommitResult(
            applied=bool(hdr.get("applied")),
            duplicate=bool(hdr.get("duplicate")),
            evicted=False, updates=int(hdr["updates"]),
            staleness=int(hdr.get("staleness", -1)))

    def _striped_commit(self, base: dict, items: list) -> Optional[dict]:
        """One logical commit over the stripe connections; returns the
        fold outcome's header, or None when every stripe came back
        ``pending`` (the server lost part of the set)."""
        stripes = self._stripes
        pool = self._shard_pool()
        futures = [
            pool.submit(self._rpc, wire.OP_COMMIT,
                        dict(base, shard=k, num_shards=len(stripes),
                             idx=idx),
                        [items[i] for i in idx], k)
            for k, idx in enumerate(stripes)]
        replies = self._gather(futures)
        # Exactly one stripe's reply carries the fold outcome (the one that
        # completed the assembly, or the dedup answer); the rest say
        # ``pending``.
        for hdr, _ in replies:
            if hdr.get("applied"):
                return hdr
        for hdr, _ in replies:
            if hdr.get("duplicate"):
                return hdr
        return None

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
