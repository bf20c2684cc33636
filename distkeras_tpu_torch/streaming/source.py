"""Stream sources: where unbounded training data comes from (the port's
copy of ``distkeras_tpu/streaming/source.py``; host numpy and sockets, no
device).

The contract is one method::

    source.read(start_index=0, skip=frozenset()) -> Iterator[StreamRecord]

yielding records in **absolute stream order** (``record.index`` is the
record's ordinal in the whole stream, stable across restarts — it IS the
offset the :class:`~distkeras_tpu_torch.streaming.journal.OffsetJournal`
journals). ``start_index``/``skip`` implement resume: deliver nothing
below the frontier, skip out-of-order-committed offsets. ``read`` may
block indefinitely waiting for the feed; consumers run it through the
RoundFeeder, whose stall watchdog turns a dried-up feed into
``FeederStalledError`` (the Supervisor path), not a silent hang.

Two transports:

* :class:`FileTailSource` — tails a growing frame file (a log of
  length-prefixed npz records, :class:`StreamFileWriter` the producer
  side). Polls for growth; a zero-length frame is end-of-stream.
* :class:`SocketSource` — a TCP feed from a :class:`StreamProducer`.
  The resume header carries ``start``; on a broken connection (source
  kill chaos) the client reconnects with the next undelivered index and
  keeps going, up to a reconnect budget.

The wire is the JAX package's, byte for byte in its framing: a 4-byte
big-endian payload length, then an ``np.savez`` payload (``xs``, ``ys``,
``ts``), and on a socket a newline-ended JSON resume header ``{"start":
i}``. Either package's producer feeds the other package's source, and
either package's writer the other's tail.

Fault injection (the ambient compute :class:`~distkeras_tpu_torch.
resilience.faults.FaultPlan`, indexes = absolute record index) — this
module is the consumer of the two stream kinds: ``feed_gap@R:S`` holds
record R back S seconds before delivery — upstream of staging, so the gap
propagates into the consumer's stall accounting. ``drift@R`` starts a
**distribution shift**: from record R on, every label is rotated one
class forward (``(y + 1) % num_classes``) — a real concept shift the model
must relearn, visible as windowed-eval loss divergence. The one-shot
trigger is consumed at R but the shift is permanent for the life of the
source; runtimes persist the trigger index (journal ``meta``) so a
post-kill restart re-enters the drifted world.
"""

from __future__ import annotations

import io
import json
import socket
import struct
import threading
import time
from typing import Iterator, NamedTuple, Optional

import numpy as np

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.resilience import faults
from distkeras_tpu_torch.runtime import config

_LEN = struct.Struct(">I")


class StreamRecord(NamedTuple):
    """One training item off the wire: ``xs`` ``[K, B, ...]`` features,
    ``ys`` ``[K, B]`` labels (one worker-window, the claim-queue work
    unit), the producer-side event timestamp, the absolute stream index,
    and whether the injected drift transform touched it."""

    index: int
    xs: np.ndarray
    ys: np.ndarray
    ts: float
    drifted: bool = False


def encode_record(xs: np.ndarray, ys: np.ndarray, ts: float) -> bytes:
    """One framed record: 4-byte big-endian length + npz payload."""
    buf = io.BytesIO()
    np.savez(buf, xs=np.asarray(xs), ys=np.asarray(ys),
             ts=np.float64(ts))
    payload = buf.getvalue()
    return _LEN.pack(len(payload)) + payload


#: the end-of-stream frame: a zero payload length.
EOS_FRAME = _LEN.pack(0)


def decode_record(payload: bytes, index: int = -1) -> StreamRecord:
    with np.load(io.BytesIO(payload)) as z:
        return StreamRecord(index=index, xs=z["xs"], ys=z["ys"],
                            ts=float(z["ts"]))


class StreamFileWriter:
    """Producer side of :class:`FileTailSource`: append framed records to
    a file, flushed per record so a live tail sees them promptly."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "ab")
        self.count = 0

    def append(self, xs, ys, ts: Optional[float] = None) -> int:
        self._f.write(encode_record(xs, ys,
                                    time.time() if ts is None else ts))
        self._f.flush()
        self.count += 1
        return self.count - 1

    def end(self) -> None:
        """Write the end-of-stream frame and close."""
        self._f.write(EOS_FRAME)
        self._f.flush()
        self._f.close()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class _SourceBase:
    """Shared fault injection + bookkeeping for both transports."""

    def __init__(self, drift_classes: Optional[int] = None,
                 drift_from: Optional[int] = None):
        #: class count the drift rotation uses; None = infer per record
        #: from that record's own label maximum (fine for test streams).
        self.drift_classes = drift_classes
        #: index the distribution shift began at (None = no drift yet).
        #: Pass the persisted value on resume — the fault one-shot was
        #: consumed before the kill, the drifted world was not.
        self.drift_from = drift_from
        self.delivered = 0
        self._stop = threading.Event()

    def close(self) -> None:
        self._stop.set()

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    def _apply_faults(self, rec: StreamRecord) -> StreamRecord:
        plan = faults.active_plan()
        if plan is not None:
            gap = plan.feed_gap(rec.index)
            if gap > 0:
                # The source goes silent: nothing reaches staging until the
                # gap passes (close() still wins promptly).
                self._stop.wait(gap)
            if plan.drift(rec.index):
                self.drift_from = rec.index
                telemetry.counter("stream.drift_injected").add(1)
                telemetry.event("stream_drift_injected", {"at": rec.index})
        if self.drift_from is not None and rec.index >= self.drift_from:
            ys = np.asarray(rec.ys)
            k = self.drift_classes or int(ys.max()) + 1
            rec = rec._replace(ys=(ys + 1) % max(k, 1), drifted=True)
        return rec

    def _deliver(self, rec: StreamRecord, skip) -> Optional[StreamRecord]:
        """Fault transform + skip filter; None = the journal holds it."""
        rec = self._apply_faults(rec)
        if rec.index in skip:
            return None
        self.delivered += 1
        return rec


class FileTailSource(_SourceBase):
    """Tail a growing frame file; polls for growth every ``poll_s``
    (env ``DKTPU_STREAM_POLL_S``). A zero-length frame ends the stream;
    :meth:`close` aborts a tail blocked on a silent file."""

    def __init__(self, path: str, poll_s: Optional[float] = None, **kw):
        super().__init__(**kw)
        self.path = path
        self.poll_s = (config.env_float("DKTPU_STREAM_POLL_S")
                       if poll_s is None else float(poll_s))

    def _read_exact(self, f, n: int) -> Optional[bytes]:
        """n bytes from the current position, polling for file growth;
        None = source closed while waiting."""
        chunks: list[bytes] = []
        got = 0
        pos = f.tell()
        while got < n:
            chunk = f.read(n - got)
            if chunk:
                chunks.append(chunk)
                got += len(chunk)
                continue
            if self._stop.is_set():
                f.seek(pos)
                return None
            time.sleep(self.poll_s)
        return b"".join(chunks)

    def read(self, start_index: int = 0,
             skip: frozenset = frozenset()) -> Iterator[StreamRecord]:
        with open(self.path, "rb") as f:
            index = 0
            while not self._stop.is_set():
                head = self._read_exact(f, _LEN.size)
                if head is None:
                    return
                (size,) = _LEN.unpack(head)
                if size == 0:  # end-of-stream frame
                    return
                payload = self._read_exact(f, size)
                if payload is None:
                    return
                if index >= start_index:
                    rec = self._deliver(
                        decode_record(payload, index), skip)
                    if rec is not None:
                        yield rec
                index += 1


class StreamProducer:
    """A TCP record feed for :class:`SocketSource`. Keeps every appended
    record as its decoded arrays (``np.savez`` stamps each zip entry with
    the time it was written, so two encodings of one record differ in
    bytes) and encodes each frame as it is sent, so any number of
    sequential connections can resume from any offset (the feed's durable
    upstream, playing the role a log broker would in production).
    :meth:`kill_connections` drops live connections without EOS — the
    source-kill chaos drill."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._records: list[tuple] = []
        self._ended = False
        self._cv = threading.Condition()
        self._srv = socket.create_server((host, port))
        self.endpoint = "%s:%d" % self._srv.getsockname()[:2]
        self._stop = threading.Event()
        self._conns: list[socket.socket] = []
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="stream-producer", daemon=True)
        self._thread.start()

    def feed(self, xs, ys, ts: Optional[float] = None) -> int:
        with self._cv:
            self._records.append((np.asarray(xs), np.asarray(ys),
                                  time.time() if ts is None else float(ts)))
            self._cv.notify_all()
            return len(self._records) - 1

    def end(self) -> None:
        with self._cv:
            self._ended = True
            self._cv.notify_all()

    @property
    def count(self) -> int:
        with self._cv:
            return len(self._records)

    def _accept_loop(self) -> None:
        try:
            self._srv.settimeout(0.2)
        except OSError:
            return  # closed before this thread first ran
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(10.0)
            header = b""
            while not header.endswith(b"\n"):
                chunk = conn.recv(1)
                if not chunk:
                    return
                header += chunk
            i = int(json.loads(header).get("start", 0))
            while not self._stop.is_set():
                with self._cv:
                    while (i >= len(self._records) and not self._ended
                           and not self._stop.is_set()):
                        self._cv.wait(0.2)
                    if i < len(self._records):
                        rec = self._records[i]
                    elif self._ended:
                        conn.sendall(EOS_FRAME)
                        return
                    else:
                        continue
                conn.sendall(encode_record(*rec))
                i += 1
        except OSError:
            pass  # client gone (or killed connection): resume handles it
        finally:
            conn.close()

    def kill_connections(self) -> None:
        """Sever every live feed connection without EOS (source kill)."""
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass
        self._conns = []

    def close(self) -> None:
        self._stop.set()
        self.kill_connections()
        try:
            self._srv.close()
        except OSError:
            pass


class SocketSource(_SourceBase):
    """A TCP feed with reconnect-and-resume: the resume header tells the
    producer where to start, so a killed connection (or killed-and-
    restarted producer) costs retransmits, never records. Gives up after
    ``reconnect_s`` (env ``DKTPU_STREAM_RECONNECT_S``) of failed
    reconnects — then the iterator ends and the consumer's stall/stream
    accounting decides what that means."""

    def __init__(self, endpoint: str, reconnect_s: Optional[float] = None,
                 **kw):
        super().__init__(**kw)
        host, port = endpoint.rsplit(":", 1)
        self.addr = (host, int(port))
        self.reconnect_s = (config.env_float("DKTPU_STREAM_RECONNECT_S")
                            if reconnect_s is None else float(reconnect_s))
        self.reconnects = 0

    def _connect(self, start: int) -> Optional[socket.socket]:
        deadline = time.monotonic() + self.reconnect_s
        delay = 0.05
        while not self._stop.is_set():
            try:
                s = socket.create_connection(self.addr, timeout=5.0)
                s.sendall(json.dumps({"start": start}).encode() + b"\n")
                return s
            except OSError:
                if time.monotonic() >= deadline:
                    return None
                self._stop.wait(delay)
                delay = min(delay * 2, 1.0)
        return None

    def _recv_exact(self, s: socket.socket, n: int) -> bytes:
        chunks: list[bytes] = []
        got = 0
        while got < n:
            chunk = s.recv(n - got)
            if not chunk:
                raise ConnectionError("feed connection closed mid-frame")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def read(self, start_index: int = 0,
             skip: frozenset = frozenset()) -> Iterator[StreamRecord]:
        index = start_index
        conn = self._connect(index)
        while conn is not None and not self._stop.is_set():
            try:
                conn.settimeout(0.5)
                try:
                    head = self._recv_exact(conn, _LEN.size)
                except socket.timeout:
                    continue  # feed quiet; keep waiting (watchdog's job)
                (size,) = _LEN.unpack(head)
                if size == 0:
                    break
                conn.settimeout(10.0)
                payload = self._recv_exact(conn, size)
            except OSError:
                # Source kill: reconnect resuming at the next undelivered
                # index — retransmits only, no lost or duplicate records.
                conn.close()
                self.reconnects += 1
                telemetry.counter("stream.source_reconnects").add(1)
                conn = self._connect(index)
                continue
            rec = self._deliver(decode_record(payload, index), skip)
            index += 1
            if rec is not None:
                yield rec
        if conn is not None:
            conn.close()
