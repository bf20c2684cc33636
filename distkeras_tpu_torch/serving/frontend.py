"""The serving frontend: live requests in, micro-batched answers out
(counterpart of ``distkeras_tpu/serving/frontend.py``; the frames are the
same, so either package's client talks to either package's frontend).

Speaks the hardened wire protocol (``netps/wire.py`` — length prefix,
crc32, request-id echo) on a TCP listener whose port comes from the
bind-probed pool (``fleet/ports.py``) and is released at teardown. One
handler thread per connection; an ``infer`` handler *submits* its rows to
the :class:`~distkeras_tpu_torch.serving.batcher.MicroBatcher` and blocks
— the dispatch thread coalesces concurrent requests into one
padded-bucket forward pass on the registry's live model (on the card,
through the CUDA kernels) and fans the rows back out.

Chaos (``DKTPU_NET_FAULTS``), keyed by the process-wide index of accepted
``infer`` requests: ``serve_drop@F`` closes request F's connection before
admission (the client sees a transport failure and retries or fails
over), ``serve_slow@F:S`` holds request F's reply S seconds. Distributed
tracing and process vitals come with a later slice; the stats reply
carries an empty flight ring and a fixed role.

:class:`ServeClient` is the other half: per-attempt deadline, full-jitter
backoff, endpoint walking over ``wire.split_endpoints`` on connection
failure, request-id echo matching, and typed error replies raised as the
exceptions in ``serving/errors.py`` (never retried: the server answered).
"""

from __future__ import annotations

import itertools
import socket
import threading
import time
from typing import Optional

import numpy as np

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.fleet import ports
from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.netps.endpoints import EndpointWalker
from distkeras_tpu_torch.netps.errors import ProtocolError, RPCTimeoutError
from distkeras_tpu_torch.resilience import faults as _faults
from distkeras_tpu_torch.resilience.backoff import full_jitter
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.serving import errors as serrors
from distkeras_tpu_torch.serving.batcher import MicroBatcher, bucket_for

_POLL_S = 0.2
_FRAME_COMPLETE_S = 30.0

#: the role the stats reply names (the JAX frontend reads it from its
#: tracing plane, which the port does not have yet).
ROLE = "serve"

#: process-wide accepted-``infer`` index the chaos kinds key on, shared
#: across frontends, so a replica-set drill can address "the 7th request"
#: without caring which replica catches it.
_REQ_INDEX = itertools.count()


def reset_request_index() -> None:
    """Re-arm the chaos kinds' request index from zero (tests, drills)."""
    global _REQ_INDEX
    _REQ_INDEX = itertools.count()


class ServingFrontend:
    """One serving replica: listener + handlers + dispatch loop over a
    :class:`~distkeras_tpu_torch.serving.registry.ModelRegistry`."""

    def __init__(self, registry, host: str = "127.0.0.1",
                 port: Optional[int] = None,
                 max_wait_s: Optional[float] = None,
                 max_queue_rows: Optional[int] = None,
                 deadline_s: Optional[float] = None):
        self.registry = registry
        self.host = host
        # Bind-probed pool port unless the caller pins one; pool ports are
        # released at close so a torn-down replica's port is reusable.
        self._port_owned = port is None
        self.port = ports.reserve_port(host) if port is None else int(port)
        self.batcher = MicroBatcher(
            registry.buckets, max_queue_rows=max_queue_rows,
            max_wait_s=max_wait_s, deadline_s=deadline_s)
        self.served = 0
        self._listener: Optional[socket.socket] = None
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._started = False

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def ready(self) -> bool:
        """Liveness vs readiness: a started replica answers stats (live)
        but is only *ready* once the registry holds a warmed model."""
        return (self._started and not self._stop.is_set()
                and not getattr(self.registry, "warming", False))

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ServingFrontend":
        if self._started:
            return self
        self._started = True
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self._listener.listen(64)
        self._listener.settimeout(_POLL_S)
        for name, target in (("serve-accept", self._accept_loop),
                             ("serve-dispatch", self._dispatch_loop)):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def close(self) -> None:
        """Graceful teardown: stop admitting, answer the queue out with
        typed errors, join every thread, release the pool port."""
        self._stop.set()
        self.batcher.close()
        self._teardown_sockets()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=10.0)
        self._threads.clear()
        if self._port_owned:
            ports.release_port(self.port)
            self._port_owned = False

    def kill(self) -> None:
        """Crash simulation: drop the listener and every live connection
        mid-stream, no typed replies, no drain — clients see
        ConnectionError and walk to the next replica."""
        self._stop.set()
        self._teardown_sockets()
        self.batcher.close()
        if self._port_owned:
            ports.release_port(self.port)
            self._port_owned = False

    def _teardown_sockets(self) -> None:
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    # -- accept + handler ---------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            listener = self._listener
            if listener is None:
                return
            try:
                conn, _addr = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 name="serve-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _handle(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                conn.settimeout(_POLL_S)
                try:
                    prefix = wire.recv_exact(conn, wire.PREFIX_SIZE)
                except socket.timeout:
                    continue
                except (ConnectionError, OSError):
                    return
                conn.settimeout(_FRAME_COMPLETE_S)
                kind, _n, header, arrays = wire.finish_frame(conn, prefix)
                if kind != wire.KIND_REQUEST:
                    raise ProtocolError(
                        f"serving frontend got frame kind {kind}, "
                        f"expected a request")
                if not self._serve_request(conn, header, arrays):
                    return  # serve_drop: the connection dies unanswered
        except (ProtocolError, ConnectionError, OSError):
            telemetry.counter("serving.conn_errors").add(1)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_request(self, conn, header: dict, arrays: list) -> bool:
        """Answer one request frame; False drops the connection unanswered
        (the ``serve_drop`` drill)."""
        op = header.get("op")
        req = header.get("req")
        if op == wire.OP_STATS:
            st1 = time.time() if "ct0" in header else None
            b, version = self.registry.current()
            reply = {
                "op": op, "req": req, "version": version,
                "queue_rows": self.batcher.depth_rows(),
                "served": self.served, "compiles": b.compiles(),
                "caps": wire.CAPS, "role": ROLE,
                "ready": self.ready,
                "snapshot": telemetry.get().snapshot(),
                "ring": []}
            if st1 is not None:
                # NTP-style clock exchange, answered as the JAX frontend
                # does for a request that carried ``ct0``.
                reply["st1"] = st1
                reply["st2"] = time.time()
            wire.send_frame(conn, wire.KIND_REPLY, reply, [])
            return True
        if op != wire.OP_INFER:
            wire.send_frame(conn, wire.KIND_REPLY, {
                "error": "unknown_op", "req": req,
                "message": f"unknown serving op {op!r}"}, [])
            return True
        if not arrays:
            wire.send_frame(conn, wire.KIND_REPLY, {
                "error": "serving", "req": req,
                "message": "infer request carried no input arrays"}, [])
            return True
        idx = next(_REQ_INDEX)
        plan = _faults.active_net_plan()
        if plan is not None and plan.fire("serve_drop", idx) is not None:
            return False  # pre-admission: the connection dies, nothing queued
        slow = plan.fire("serve_slow", idx) if plan is not None else None
        # Wire arrays view the per-frame buffer; copy before they outlive
        # this handler's frame (the dispatch thread concatenates later).
        inputs = tuple(np.array(a, copy=True) for a in arrays)
        try:
            pending = self.batcher.submit(inputs, int(inputs[0].shape[0]))
        except serrors.ServingError as e:
            wire.send_frame(conn, wire.KIND_REPLY, {
                "error": serrors.error_kind(e), "req": req,
                "message": str(e)}, [])
            return True
        pending.event.wait()
        if slow is not None:
            time.sleep(slow)
        elapsed = time.monotonic() - pending.admitted_at
        telemetry.histogram("serving.latency").observe(elapsed)
        telemetry.counter("serving.answered").add(1)
        if pending.error is not None:
            wire.send_frame(conn, wire.KIND_REPLY, {
                "error": serrors.error_kind(pending.error), "req": req,
                "message": str(pending.error)}, [])
            return True
        self.served += 1
        wire.send_frame(conn, wire.KIND_REPLY, {
            "op": op, "req": req, "version": pending.version},
            [np.ascontiguousarray(pending.result)])
        return True

    # -- dispatch -----------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            batch = self.batcher.collect(poll_s=_POLL_S)
            if not batch:
                continue
            bucketed, version = self.registry.current()
            rows = sum(p.rows for p in batch)
            try:
                with telemetry.span("serving.dispatch"):
                    joined = tuple(
                        np.concatenate([p.arrays[i] for p in batch])
                        for i in range(len(batch[0].arrays)))
                    out = bucketed.infer(joined, rows=rows)
            except Exception as e:  # noqa: BLE001 - answer, don't drop
                telemetry.counter("serving.dispatch_errors").add(1)
                for p in batch:
                    p.answer(error=serrors.ServingError(
                        f"dispatch failed: {type(e).__name__}: {e}"))
                continue
            telemetry.counter("serving.batches").add(1)
            telemetry.counter("serving.batched_rows").add(rows)
            bucket = bucket_for(rows, bucketed.buckets)
            if bucket is not None:
                telemetry.counter("serving.padded_rows").add(bucket - rows)
            off = 0
            for p in batch:
                p.answer(result=out[off:off + p.rows], version=version)
                off += p.rows


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

#: typed reply kinds -> exceptions. ``from_reply`` marks "the server
#: answered" — never retried.
_ERROR_TYPES = {
    "overloaded": serrors.OverloadedError,
    "deadline": serrors.DeadlineExceededError,
    "unavailable": serrors.ModelUnavailableError,
    "unknown_op": serrors.ServingError,
    "serving": serrors.ServingError,
}


class ServeClient:
    """Inference client for a replica set: ``"host:port[,host:port...]"``
    endpoints walked in order on connection failure, typed server errors
    raised immediately. The port sends no trace context (it has no tracing
    plane yet), so its requests are the plain dialect every frontend
    reads."""

    def __init__(self, endpoints: str, timeout: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff: Optional[float] = None):
        self._walker = EndpointWalker(endpoints)
        self.timeout = (timeout if timeout is not None
                        else config.env_float("DKTPU_NET_TIMEOUT"))
        self.retries = (retries if retries is not None
                        else config.env_int("DKTPU_NET_RETRIES"))
        self.backoff = (backoff if backoff is not None
                        else config.env_float("DKTPU_NET_BACKOFF"))
        self._sock: Optional[socket.socket] = None
        self._req = itertools.count()
        self._lock = threading.Lock()

    @property
    def endpoints(self) -> list:
        """Ordered (host, port) replica list."""
        return self._walker.endpoints

    # -- transport ----------------------------------------------------------

    def _connect(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        host, port = self._walker.current()
        sock = socket.create_connection((host, port), timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        return sock

    def _drop_socket(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _fail_over(self) -> None:
        """Drop the connection and advance to the next endpoint (one
        request in flight under ``_lock``, so every failure is ours)."""
        self._walker.advance(on_walk=self._drop_socket)

    def _rpc(self, header: dict, arrays) -> tuple[dict, list]:
        last = None
        with self._lock:
            for attempt in range(self.retries):
                deadline = time.monotonic() + self.timeout
                req = next(self._req)
                header = dict(header, req=req)
                try:
                    sock = self._connect()
                    sock.settimeout(self.timeout)
                    wire.send_frame(sock, wire.KIND_REQUEST, header, arrays)
                    while True:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise socket.timeout("reply deadline exhausted")
                        sock.settimeout(remaining)
                        kind, rhdr, rarrays = wire.read_frame(sock)
                        if kind != wire.KIND_REPLY:
                            raise ProtocolError(
                                f"expected a reply frame, got kind {kind}")
                        if rhdr.get("req") == req:
                            break
                        # stale reply (reconnect raced an old answer):
                        # discard and keep reading inside the deadline.
                    err = rhdr.get("error")
                    if err is not None:
                        exc = _ERROR_TYPES.get(err, serrors.ServingError)(
                            rhdr.get("message", err))
                        exc.from_reply = True
                        raise exc
                    return rhdr, rarrays
                except serrors.ServingError:
                    raise  # the server answered: typed, never retried
                except (ConnectionError, ProtocolError, socket.timeout,
                        OSError) as e:
                    last = e
                    telemetry.counter("serving.client_failovers").add(1)
                    self._fail_over()
                    time.sleep(full_jitter(self.backoff,
                                           min(attempt, 6)))
        raise RPCTimeoutError(
            f"serving rpc failed after {self.retries} attempts over "
            f"{len(self.endpoints)} endpoint(s): {last!r}",
            attempts=self.retries)

    # -- ops ----------------------------------------------------------------

    def infer(self, *arrays) -> tuple[np.ndarray, int]:
        """One inference round-trip: ``(outputs, model_version)`` for the
        caller's rows (leading axis)."""
        arrays = tuple(np.ascontiguousarray(a) for a in arrays)
        header, out = self._rpc({"op": wire.OP_INFER}, arrays)
        return out[0], int(header.get("version", -1))

    def stats(self) -> dict:
        """The replica's live stats frame."""
        header, _ = self._rpc({"op": wire.OP_STATS}, [])
        return header

    def prefer_ready(self, probe_timeout: float = 0.5) -> list:
        """Health-aware walk ordering: one short stats probe per replica,
        then park the walker on the first *ready* one — warming replicas
        and unreachable ones sink to the back of the failover order. Best
        effort: nothing is removed. Returns the new (host, port) order."""
        ready, warming, dark = [], [], []
        for host, port in self._walker.endpoints:
            try:
                with socket.create_connection(
                        (host, port), timeout=probe_timeout) as sock:
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    sock.settimeout(probe_timeout)
                    wire.send_frame(sock, wire.KIND_REQUEST,
                                    {"op": wire.OP_STATS, "req": 0,
                                     "ring": 0}, [])
                    while True:
                        kind, rhdr, _ = wire.read_frame(sock)
                        if kind == wire.KIND_REPLY and rhdr.get("req") == 0:
                            break
                (ready if rhdr.get("ready", True) else warming).append(
                    (host, port))
            except (ConnectionError, ProtocolError, socket.timeout,
                    OSError):
                dark.append((host, port))
        order = ready + warming + dark
        with self._lock:
            self._walker.reorder(order, on_walk=self._drop_socket)
        return list(order)

    def close(self) -> None:
        self._drop_socket()
