"""The same-host fast path: a shared-memory ring under the wire protocol
(the port's copy of the JAX package's ``netps/shm.py``; the slot layout is
the same, so either package's ring client attaches to either package's
server).

When client and server share a host the network stack has no reason to
carry a commit: this module moves the *payload* into an mmap'd segment
and keeps only a doorbell on a Unix-domain socket.

* **Negotiation** rides the caps handshake: a server that serves rings
  advertises ``caps["shm"] = {"boot_id", "uds"}`` in its join reply
  (``PSServer``), and a client configured with ``DKTPU_NET_TRANSPORT=shm``
  (or ``mesh``, whose demotion target the ring is) upgrades its data
  connection iff the advertised boot id equals :func:`local_boot_id` (the
  same-host check) and the doorbell path is visible from this process.
  Everything else (an old peer, another host, ``tcp`` mode) stays on TCP;
  no guarantee depends on the upgrade.
* **Attach**: the *client* creates one segment per direction (anonymous
  memory files, ``memfd_create``) and passes the fds over the UDS by
  ``SCM_RIGHTS``: the server never trusts a path, and a dead peer's
  segments vanish with the last fd.
* **Transfer**: a frame is built straight into the slot (ONE copy of each
  array buffer; the crc covers the header section only), then an 8-byte
  doorbell carrying the frame length crosses the UDS. The reader copies
  the frame out of the slot into a fresh buffer (ONE copy) and decodes
  views over it, so the frame-buffer ownership of ``wire.read_frame``
  holds unchanged. The slot layout lives in ``wire.py``.
* **Failure = ProtocolError/ConnectionError/socket.timeout**: the taxonomy
  the retry, lease and dedup machinery already speaks, raised from the
  doorbell socket or the slot checks. A torn or corrupt slot kills the
  connection; the client reconnects with FRESH segments and retransmits
  under the same seq, and the server's dedup keeps it exactly-once.

The JAX module's chaos hooks (``shm_delay``, ``shm_corrupt``) read the
network fault plan (``DKTPU_NET_FAULTS``), which the port does not serve
yet; they come with that plan (ROADMAP Queue 1 item 6b). The ring frame
counter they key on is kept: :func:`reset_frames` zeroes it.
"""

from __future__ import annotations

import mmap
import os
import socket
import tempfile
import threading
import zlib
from typing import Optional

import numpy as np

from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.netps.errors import ProtocolError
from distkeras_tpu_torch.runtime import config

#: initial per-direction slot capacity; grows (ftruncate + remap) to fit the
#: largest frame the connection has carried.
_INITIAL_BYTES = 1 << 16

TRANSPORTS = ("tcp", "shm", "mesh")


def transport_mode() -> str:
    """The configured transport dialect (``DKTPU_NET_TRANSPORT``),
    validated."""
    mode = config.env_str("DKTPU_NET_TRANSPORT")
    if mode not in TRANSPORTS:
        raise ValueError(
            f"DKTPU_NET_TRANSPORT={mode!r} is not a known transport; "
            f"known: {list(TRANSPORTS)}")
    return mode


def local_boot_id() -> str:
    """This host's boot id: two processes reading the same value share a
    kernel, hence a page cache, hence may speak shm. Falls back to the
    hostname off Linux."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:  # pragma: no cover - non-Linux
        return f"host:{socket.gethostname()}"


def endpoint_visible(uds_path: str) -> bool:
    """Whether the advertised doorbell socket is reachable from THIS
    process's filesystem namespace. Two containers on one node share a
    boot id while the server's UDS path lives in its own mount namespace:
    the upgrade must stay on TCP there instead of burning retries on a
    socket that can never connect."""
    try:
        return os.path.exists(uds_path)
    except OSError:  # pragma: no cover - exotic fs errors = not visible
        return False


# -- ring frame counter (the fault plan's index) ------------------------------
_frames_lock = threading.Lock()
_frames = 0


def _next_frame() -> int:
    global _frames
    with _frames_lock:
        i = _frames
        _frames += 1
        return i


def reset_frames() -> None:
    """Zero the process-wide counter of client->server ring frames."""
    global _frames
    with _frames_lock:
        _frames = 0


# ---------------------------------------------------------------------------
# One direction: a seqlock'd slot over an mmap'd file
# ---------------------------------------------------------------------------

class Slot:
    """One direction's slot (layout in ``wire.py``). The creating side
    writes, the attached side reads; both remap as the file grows.

    Ops and :meth:`close` serialize on a per-slot lock: the client's
    shm->TCP fallback closes the ring a sibling thread may be mid-operation
    on. Without the lock that teardown yanks the mmap out from under the op
    (``ValueError``, which the retry machinery does not speak) and
    ``os.close`` frees an fd number the op may still hand to
    ``ftruncate``. With it, close waits out the (short, CPU-bound) op and
    later ops raise the retryable ``ConnectionError``."""

    def __init__(self, fd: int, size: Optional[int] = None):
        self.fd = fd
        self._op_lock = threading.Lock()
        self._closed = False
        self._size = int(size if size is not None else os.fstat(fd).st_size)
        if self._size < wire.SHM_SLOT_HEADER:
            os.ftruncate(fd, _INITIAL_BYTES)
            self._size = _INITIAL_BYTES
        self._mm = mmap.mmap(fd, self._size)
        self._seq = wire.U32.unpack_from(self._mm, wire.SHM_SEQ_OFF)[0]

    def _remap(self, size: int) -> None:
        self._mm.close()
        self._size = size
        self._mm = mmap.mmap(self.fd, size)

    def _ensure(self, payload_bytes: int) -> None:
        """Writer-side growth: make room for a frame of ``payload_bytes``."""
        need = wire.SHM_SLOT_HEADER + payload_bytes
        if need > self._size:
            size = max(need, 2 * self._size)
            size += (-size) % mmap.PAGESIZE
            os.ftruncate(self.fd, size)
            self._remap(size)

    def _refresh(self, payload_bytes: int) -> None:
        """Reader-side growth: the doorbell announced a frame larger than
        our mapping, so the writer grew the file; follow it."""
        need = wire.SHM_SLOT_HEADER + payload_bytes
        if need > self._size:
            size = os.fstat(self.fd).st_size
            if size < need:
                raise ProtocolError(
                    f"doorbell announces a {payload_bytes}-byte frame but "
                    f"the segment holds {size} bytes")
            self._remap(size)

    def write_frame(self, kind: int, header: dict, arrays=()) -> int:
        """Build one wire frame straight into the slot under the seqlock
        (each array buffer lands in the segment exactly once). The slot crc
        covers the frame's header section only. Returns the frame's byte
        count: what the doorbell announces."""
        buffers, total = wire._frame_buffers(kind, header, arrays,
                                             body_crc=False)
        with self._op_lock:
            return self._write_frame_locked(buffers, total)

    def _write_frame_locked(self, buffers, total: int) -> int:
        if self._closed:
            raise ConnectionError("ring slot closed during write")
        self._ensure(total)
        mm = self._mm
        self._seq = (self._seq + 1) & 0xFFFFFFFF  # odd: write in progress
        wire.U32.pack_into(mm, wire.SHM_SEQ_OFF, self._seq)
        off = wire.SHM_SLOT_HEADER
        crc = 0
        for i, b in enumerate(buffers):
            v = wire._byte_view(b)
            n = v.nbytes
            if n:
                _copy(mm, off, v, 0, n)
                if i == 0:  # buffers[0] is the prefix + JSON header section
                    crc = zlib.crc32(v, crc)
                off += n
        wire._SHM_SLOT.pack_into(mm, 0, wire.SHM_MAGIC, wire.SHM_VERSION,
                                 self._seq, crc, total, 0)
        self._seq = (self._seq + 1) & 0xFFFFFFFF  # even: complete
        wire.U32.pack_into(mm, wire.SHM_SEQ_OFF, self._seq)
        return total

    def read_frame(self, length: int, decode: bool = True,
                   ) -> tuple[int, int, dict, list]:
        """Copy, verify and decode the announced frame out of the slot:
        ``(kind, nbytes, header, arrays)``. ONE copy: the decoded arrays are
        views over a fresh private buffer, never over the slot (the next
        frame overwrites it)."""
        with self._op_lock:
            return self._read_frame_locked(length, decode)

    def _read_frame_locked(self, length: int, decode: bool,
                           ) -> tuple[int, int, dict, list]:
        if self._closed:
            raise ConnectionError("ring slot closed during read")
        if length > wire.max_frame_bytes():
            raise ProtocolError(
                f"ring frame of {length} bytes exceeds DKTPU_NET_MAX_FRAME="
                f"{wire.max_frame_bytes()}")
        if length < wire.PREFIX_SIZE + 4:
            raise ProtocolError(f"ring frame too short ({length} bytes)")
        self._refresh(length)
        mm = self._mm
        magic, version, seq1, crc, slot_len, _rsvd = \
            wire._SHM_SLOT.unpack_from(mm, 0)
        if magic != wire.SHM_MAGIC:
            raise ProtocolError(f"bad slot magic {magic:#x}")
        if version != wire.SHM_VERSION:
            raise ProtocolError(f"unsupported slot version {version}")
        if seq1 & 1:
            raise ProtocolError("torn slot read (write in progress)")
        if slot_len != length:
            raise ProtocolError(
                f"slot declares {slot_len} bytes, doorbell announced {length}")
        # THE single copy, into a buffer that is never zero-filled first.
        frame = np.empty(length, np.uint8)
        _copy(frame, 0, mm, wire.SHM_SLOT_HEADER, length)
        (seq2,) = wire.U32.unpack_from(mm, wire.SHM_SEQ_OFF)
        if seq2 != seq1:
            raise ProtocolError("torn slot read (writer raced the copy)")
        kind, _hdr_crc, body_len = wire.parse_prefix(
            frame[:wire.PREFIX_SIZE], max_frame=length)
        if wire.PREFIX_SIZE + body_len != length:
            raise ProtocolError(
                f"frame declares {body_len} body bytes inside a "
                f"{length}-byte slot frame")
        # The slot crc covers prefix + HLEN + JSON header (the bytes that
        # drive allocation and dispatch).
        (hlen,) = wire.U32.unpack_from(frame, wire.PREFIX_SIZE)
        head_end = min(wire.PREFIX_SIZE + 4 + hlen, length)
        if zlib.crc32(memoryview(frame)[:head_end]) != crc:
            raise ProtocolError("slot checksum mismatch (corrupt ring frame)")
        header, arrays = wire._decode_body(
            memoryview(frame)[wire.PREFIX_SIZE:], decode=decode)
        return kind, length, header, arrays

    def close(self) -> None:
        with self._op_lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._mm.close()
            except (BufferError, ValueError):  # exported views still alive
                pass
            try:
                os.close(self.fd)
            except OSError:
                pass


def _copy(dst, dst_off: int, src, src_off: int, n: int) -> None:
    """``n`` bytes from ``src`` to ``dst`` (buffers: the mmap, a frame, an
    array's bytes) through numpy, which releases the GIL for the copy: the
    worker's compute thread, the other comms lane and the server's handler
    threads go on while a frame moves. The mmap's views are dropped before
    returning, so the slot can still be remapped or closed."""
    d = np.frombuffer(dst, np.uint8, n, dst_off)
    try:
        d[:] = np.frombuffer(src, np.uint8, n, src_off)
    finally:
        del d


def _segment_fd() -> int:
    """An anonymous memory file (``memfd_create``: no path, nothing on any
    file system), or where the platform lacks it an unlinked temporary
    file under ``TMPDIR``."""
    if hasattr(os, "memfd_create"):
        return os.memfd_create("dknetps-ring", os.MFD_CLOEXEC)
    fd, path = tempfile.mkstemp(prefix="dknetps-ring-")
    os.unlink(path)
    return fd


def create_slot() -> Slot:
    """A fresh segment with no name (client side; the fd is the only
    handle and travels over the UDS by SCM_RIGHTS)."""
    fd = _segment_fd()
    try:
        os.ftruncate(fd, _INITIAL_BYTES)
        slot = Slot(fd, _INITIAL_BYTES)
    except BaseException:
        os.close(fd)
        raise
    wire._SHM_SLOT.pack_into(slot._mm, 0, wire.SHM_MAGIC, wire.SHM_VERSION,
                             0, 0, 0, 0)
    return slot


def accept_attach(conn: socket.socket) -> tuple[Slot, Slot]:
    """Server side of the attach: receive the (c2s, s2c) segment fds the
    connecting client passed over the UDS."""
    msg, fds, _flags, _addr = socket.recv_fds(conn, 64, 2)
    if not msg:
        for fd in fds:
            os.close(fd)
        raise ConnectionError("UDS closed before attach")
    if len(fds) != 2:
        for fd in fds:
            os.close(fd)
        raise ProtocolError(f"shm attach carried {len(fds)} fds, expected 2")
    # A Slot constructor that raises (fstat, ftruncate, mmap: ENOMEM) has
    # NOT taken ownership of its fd: close what it and the earlier slot
    # held, or every failed attach leaks 2 fds and a mapping until EMFILE.
    c2s = None
    try:
        c2s = Slot(fds[0])
        return c2s, Slot(fds[1])
    except BaseException:
        try:
            os.close(fds[1])
        except OSError:
            pass
        if c2s is not None:
            c2s.close()
        else:
            try:
                os.close(fds[0])
            except OSError:
                pass
        raise


# ---------------------------------------------------------------------------
# Client-side connection: two slots + the UDS doorbell
# ---------------------------------------------------------------------------

class ShmConnection:
    """One upgraded data connection: request slot, reply slot, doorbell.

    The TCP connection's contract: ``settimeout`` guards the doorbell
    waits, failures raise the retryable taxonomy, and requests and replies
    alternate strictly (what one ``PSClient`` guarantees)."""

    def __init__(self, uds_path: str, timeout: float):
        if timeout <= 0:
            raise socket.timeout("deadline exceeded before shm attach")
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            self.sock.settimeout(timeout)
            self.sock.connect(uds_path)
            self.c2s = create_slot()
            self.s2c = create_slot()
            socket.send_fds(self.sock, [b"DKATTACH"],
                            [self.c2s.fd, self.s2c.fd])
        except BaseException:
            self.close()
            raise

    def settimeout(self, t: float) -> None:
        self.sock.settimeout(t)

    def send(self, kind: int, header: dict, arrays=()) -> int:
        """Write the frame into the request slot and ring the doorbell;
        returns the frame's bytes."""
        nbytes = self.c2s.write_frame(kind, header, arrays)
        _next_frame()
        self.sock.sendall(wire.pack_doorbell(nbytes))
        return nbytes

    def recv(self, decode: bool = True) -> tuple[int, int, dict, list]:
        """Wait for the reply doorbell (under the socket timeout) and read
        the reply frame out of the reply slot."""
        raw = wire.recv_exact(self.sock, wire.SHM_DOORBELL_SIZE)
        return self.s2c.read_frame(wire.unpack_doorbell(raw), decode=decode)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
        for slot in (getattr(self, "c2s", None), getattr(self, "s2c", None)):
            if slot is not None:
                slot.close()
