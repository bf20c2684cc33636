"""Network-fault chaos: an in-process, frame-aware TCP proxy (the port's
copy of ``distkeras_tpu/netps/chaos.py``).

Sits between :class:`~distkeras_tpu_torch.netps.client.PSClient` and
:class:`~distkeras_tpu_torch.netps.server.PSServer` (or either package's
client and server: the wire is one) and injects the failure
modes that dominate production PS training — slow links, lost packets,
duplicated delivery, mid-frame connection death, and partitions — without
needing a real bad network. Because the wire protocol is length-prefixed,
the proxy operates on whole *frames*: it reads one client request at a
time, consults the fault plan by the frame's global index, and forwards
(or delays, drops, duplicates, truncates...) deterministically.

Faults come from the network grammar
(``resilience.FaultPlan.parse_net`` / ``DKTPU_NET_FAULTS``), one-shot each::

    DKTPU_NET_FAULTS="delay@3:0.2;drop@5;dup@6;truncate@8;partition@7:2"

=================  =====================================================
``delay@F:S``      hold request frame F for S seconds before forwarding
``drop@F``         swallow request frame F (no forward, no reply — the
                   client times out and retries)
``dup@F``          forward request frame F twice (the server sees a
                   retransmit; commit dedup answers the copy)
``truncate@F``     forward only half of frame F, then kill that upstream
                   connection (death mid-frame; crc/framing rejects it)
``partition@F:S``  at frame F sever every connection and refuse new ones
                   for S seconds (both directions dark)
``delay_r/drop_r/dup_r/truncate_r@F``  the same, applied to the *reply*
                   of request frame F — ``drop_r`` is the lost-ACK case
                   the idempotent commit seq exists for
``evict@R:S``      consumed by the remote worker loop, not the proxy: the
                   seeded worker goes silent S seconds at round R so its
                   lease expires (eviction + rejoin mid-run)
=================  =====================================================

Frame indices count client->server requests through this proxy, 0-based,
across all connections — deterministic for a single-worker flow; for many
racing workers the index selects "some" frame, which is exactly what chaos
needs.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.netps.errors import ProtocolError
from distkeras_tpu_torch.resilience import faults as _faults

_POLL_S = 0.2
_UPSTREAM_REPLY_S = 30.0


class ChaosProxy:
    """Frame-aware MITM between netps clients and one upstream server.

    ``plan`` defaults to the ambient network plan (``DKTPU_NET_FAULTS``);
    ``None``/empty forwards everything untouched (a latency-only proxy).
    Point clients at :attr:`endpoint` instead of the server's.
    """

    def __init__(self, upstream: str, plan: Optional[_faults.FaultPlan] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.upstream = upstream
        self.plan = plan if plan is not None else _faults.active_net_plan()
        self._lock = threading.Lock()
        self._frames = 0
        self._partition_until = 0.0
        self._conns: list = []
        self._stop = threading.Event()
        self._listener = socket.create_server((host, port))
        self._listener.settimeout(_POLL_S)
        self._host = host
        self._port = self._listener.getsockname()[1]
        self._threads: list = []
        self._accept_thread: Optional[threading.Thread] = None

    @property
    def endpoint(self) -> str:
        return f"{self._host}:{self._port}"

    @property
    def frames_seen(self) -> int:
        return self._frames

    def start(self) -> "ChaosProxy":
        t = threading.Thread(target=self._accept_loop, name="chaos-accept")
        t.start()
        self._accept_thread = t
        return self

    def close(self) -> None:
        self._stop.set()
        if self._accept_thread is not None:
            self._accept_thread.join()
        self._sever_all()
        for t in list(self._threads):
            t.join()
        try:
            self._listener.close()
        except OSError:
            pass

    # ------------------------------------------------------------------
    def _fire(self, kind: str, at: int) -> Optional[float]:
        if self.plan is None:
            return None
        return self.plan.fire(kind, at)

    def _partitioned(self) -> bool:
        return time.monotonic() < self._partition_until

    def _sever_all(self) -> None:
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def _track(self, *socks) -> None:
        with self._lock:
            self._conns.extend(socks)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            if self._partitioned():
                # The network is dark: a connection reset, not a listen
                # backlog — the client sees it instantly and backs off.
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            t = threading.Thread(target=self._handle, args=(conn,),
                                 name="chaos-handler")
            t.start()
            self._threads.append(t)

    # ------------------------------------------------------------------
    def _handle(self, client: socket.socket) -> None:
        try:
            upstream = socket.create_connection(
                wire.split_endpoint(self.upstream), timeout=_UPSTREAM_REPLY_S)
        except OSError:
            try:
                client.close()
            except OSError:
                pass
            return
        upstream.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        client.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        client.settimeout(_POLL_S)
        self._track(client, upstream)
        with client, upstream:
            while not self._stop.is_set() and not self._partitioned():
                try:
                    prefix = wire.recv_exact(client, wire.PREFIX_SIZE)
                    client.settimeout(_UPSTREAM_REPLY_S)
                    raw = wire.finish_raw_frame(client, prefix)
                    client.settimeout(_POLL_S)
                except socket.timeout:
                    continue
                except (ConnectionError, OSError, ProtocolError):
                    return
                with self._lock:
                    i = self._frames
                    self._frames += 1
                try:
                    if not self._inject(i, raw, client, upstream, telemetry):
                        return
                except (ConnectionError, OSError, ProtocolError):
                    return

    def _inject(self, i: int, raw: bytes, client: socket.socket,
                upstream: socket.socket, telemetry) -> bool:
        """Apply frame ``i``'s faults; False = tear this path down."""
        arg = self._fire("partition", i)
        if arg is not None:
            self._partition_until = time.monotonic() + (arg or 1.0)
            telemetry.event("chaos_partition", {"frame": i, "seconds": arg})
            self._sever_all()
            return False
        if self._fire("drop", i) is not None:
            telemetry.event("chaos_drop", {"frame": i})
            return True  # swallowed: no forward, no reply
        arg = self._fire("delay", i)
        if arg is not None:
            telemetry.event("chaos_delay", {"frame": i, "seconds": arg})
            time.sleep(arg)
        if self._fire("truncate", i) is not None:
            telemetry.event("chaos_truncate", {"frame": i})
            upstream.sendall(raw[:max(1, len(raw) // 2)])
            return False  # died mid-frame: connection is unrecoverable
        copies = 2 if self._fire("dup", i) is not None else 1
        if copies == 2:
            telemetry.event("chaos_dup", {"frame": i})
        for _ in range(copies):
            upstream.sendall(raw)
        for _ in range(copies):
            if not self._relay_reply(i, client, upstream, telemetry):
                return False
        return True

    def _relay_reply(self, i: int, client: socket.socket,
                     upstream: socket.socket, telemetry) -> bool:
        reply = wire.read_raw_frame(upstream)
        if self._fire("drop_r", i) is not None:
            # The lost ACK: the server already applied the request; the
            # client times out and retransmits — dedup must make the
            # retransmit fold-exactly-once.
            telemetry.event("chaos_drop_reply", {"frame": i})
            return True
        arg = self._fire("delay_r", i)
        if arg is not None:
            telemetry.event("chaos_delay_reply", {"frame": i, "seconds": arg})
            time.sleep(arg)
        if self._fire("truncate_r", i) is not None:
            telemetry.event("chaos_truncate_reply", {"frame": i})
            client.sendall(reply[:max(1, len(reply) // 2)])
            return False
        copies = 2 if self._fire("dup_r", i) is not None else 1
        if copies == 2:
            telemetry.event("chaos_dup_reply", {"frame": i})
        for _ in range(copies):
            client.sendall(reply)
        return True
