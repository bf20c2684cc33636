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
commit reports ``evicted=True``: it was never folded. Striping, the
shared-memory ring, the device mesh, tracing and the tuner's probe come
with later slices.

One client serves one worker thread; public methods are not safe to call
concurrently.
"""

from __future__ import annotations

import socket
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import wire
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
    ``DKTPU_NET_COMPRESS``). An eviction or a fence re-joins on its own
    (a fence walks to the promoted primary first)."""

    def __init__(self, endpoint: str, worker_id: Optional[int] = None,
                 timeout: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff: Optional[float] = None,
                 compress: Optional[str] = None):
        if ";" in endpoint:
            raise NotImplementedError(
                f"sharded endpoint {endpoint!r}: the sharded center plane "
                "is not ported to distkeras_tpu_torch yet; it comes with "
                "the sharded-center slice")
        #: ordered failover traversal — ``endpoint`` may be a
        #: comma-separated list (primary first).
        self._walker = EndpointWalker(endpoint)
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
        #: negotiated at join; f32 until then.
        self.codec = wire.CODEC_NONE
        self.lease_s: Optional[float] = None
        #: the primary epoch the last join adopted (None until a join
        #: against an epoch-aware server); stamped on every member op.
        self.epoch: Optional[int] = None
        self._sock: Optional[socket.socket] = None
        self._req = 0
        self._ever_connected = False
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

    def _connect(self, deadline: float) -> socket.socket:
        if self._sock is not None:
            return self._sock
        if self._ever_connected:
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
        return sock

    def _disconnect(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

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
            ep_seen = self._walker.index
            try:
                with telemetry.span(f"netps.rpc.{op}"):
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

    def _walk(self, seen_idx: int) -> None:
        """Advance past a failure observed against ``seen_idx`` (the
        walker's CAS; the connection to the old endpoint is already
        dropped)."""
        if self._walker.walk(seen_idx):
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
        """One connect + send + matched-reply receive under ONE deadline."""
        deadline = time.monotonic() + self.timeout
        sock = self._connect(deadline)
        sock.settimeout(max(0.001, deadline - time.monotonic()))
        sent = wire.send_frame(sock, wire.KIND_REQUEST, hdr, arrays)
        telemetry.counter("netps.bytes_sent").add(sent)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout(f"{hdr['op']} deadline exceeded")
            sock.settimeout(remaining)
            prefix = wire.recv_exact(sock, wire.PREFIX_SIZE)
            kind, nbytes, rhdr, rarrays = wire.finish_frame(sock, prefix)
            if kind != wire.KIND_REPLY:
                raise ProtocolError(f"expected a reply frame, got kind {kind}")
            if rhdr.get("req") != req:
                # A duplicated or late reply: discard and keep reading — the
                # req echo is what keeps the stream sane.
                telemetry.counter("netps.stale_replies").add(1)
                continue
            telemetry.counter("netps.bytes_received").add(nbytes)
            err = rhdr.get("error")
            if err:
                exc = _ERROR_TYPES.get(err, NetPSError)(
                    f"{hdr['op']}: server said {err}: "
                    f"{rhdr.get('message', '')}")
                # The server ANSWERED: retrying a deterministic rejection
                # burns the whole budget for the same answer.
                exc.from_reply = True
                raise exc
            return rhdr, rarrays

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

    def adopt_dialect(self, other: "PSClient",
                      center: Sequence[np.ndarray] = ()) -> None:
        """Adopt another client's join-negotiated dialect (codec, epoch,
        lease) without a join of our own — membership is by worker_id, not
        by connection. The overlapped loop's pull-prefetch client uses
        this so both lanes speak the same wire. ``center`` (the joined
        center) is what the JAX client sizes its stripes from; the port
        does not stripe."""
        del center
        self.codec = other.codec
        self.epoch = other.epoch
        self.lease_s = other.lease_s

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
