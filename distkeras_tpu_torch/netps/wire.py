"""The hardened wire protocol: length-prefixed, checksummed binary frames
(the port's copy of the JAX package's ``netps/wire.py``; frames are
byte-compatible, so either package's client talks to either package's
server). One frame::

    MAGIC(2)='DK'  VERSION(1)  KIND(1)  CRC32(4)  LENGTH(4)  BODY(LENGTH)

and BODY is ``HLEN(4) + JSON header (HLEN bytes, utf-8) + raw array
buffers`` — array dtype/shape ride in the header (``arrays`` field), the
buffers follow in order, so a reply is one contiguous write with zero
pickling.

:func:`send_frame` scatter-gathers the prefix/header and every array
buffer straight out of their owning arrays via ``socket.sendmsg`` (crc32
computed incrementally over the same views), and :func:`read_frame` reads
into ONE preallocated buffer via ``recv_into`` and hands back numpy views
over it. The decoded arrays alias that per-frame buffer: treat them as
read-only inputs and copy before long-term mutation.

**Per-tensor codecs** (``DKTPU_NET_COMPRESS``): a float32 tensor may ride
the wire as ``bf16`` (top-16-bit truncation) or ``int8`` (per-tensor
symmetric scale); the spec records the wire dtype plus ``codec`` (and
``scale``) so :func:`decode_frame` transparently dequantizes to float32,
or, through :func:`finish_frame` with ``decode=False`` (the parameter
server's compressed-domain fold), hands each array back as a ``(wire
array, spec)`` pair.

Hardening, in the order a stray peer meets it: magic + version (a desync
fails in the first 3 bytes), a bounded length (``DKTPU_NET_MAX_FRAME``,
checked before any allocation), crc32 over the body, and request ids that
replies echo so a duplicated frame cannot desynchronize the stream. After
any :class:`ProtocolError` the connection is dead by contract.
"""

from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import NamedTuple, Optional, Sequence

import numpy as np

from distkeras_tpu_torch.netps.errors import ProtocolError
from distkeras_tpu_torch.runtime import config

MAGIC = b"DK"
VERSION = 1
#: frame kinds — the one-byte fast-reject before the JSON header is parsed.
KIND_REQUEST = 1
KIND_REPLY = 2

_PREFIX = struct.Struct("!2sBBII")  # magic, version, kind, crc32, body length
PREFIX_SIZE = _PREFIX.size

#: sendmsg scatter-gather batch bound (POSIX IOV_MAX is >= 1024).
_IOV_MAX = 1024

#: tensor codecs the wire speaks (``DKTPU_NET_COMPRESS``).
CODEC_NONE = "none"
CODEC_BF16 = "bf16"
CODEC_INT8 = "int8"
CODECS = (CODEC_NONE, CODEC_BF16, CODEC_INT8)

#: capabilities THIS build advertises — only what the port implements: the
#: tensor codecs, striping (one logical pull or commit split by tensors over
#: several connections to one server, which assembles a striped commit and
#: folds it once), warm-standby replication and fencing (``replicate``/
#: ``fence``), the serving ops (``infer``/``stats``), the sharded center
#: (``netps/shards/``: a shard server admits only joiners whose caps carry
#: the bit AND whose join header carries its partition plan's hash, and
#: replaces the bit in its join reply with its shard identity and plan),
#: the same-host ring (``shm``) and the same-process dispatch into the
#: device center (``mesh``). A server that actually serves a ring or a mesh
#: replaces the static ``shm``/``mesh`` bit with its live endpoint in the
#: join reply. ``tree`` advertises the aggregation-tree plane
#: (``netps/tree.py``): an interior tree node replaces the bit with its
#: ``{"level", "group", "spec"}`` identity in every join reply, its
#: ``stats`` replies carry the window-conservation ledger (``tree``) and
#: its replicate replies the root-lineage counter (``root_u``) its warm
#: standby seeds promotion from; a plain server's ``True`` just says the
#: build understands the tree dialect. ``tuner`` advertises the ``probe``
#: op the self-tuning data plane's join-time micro A/B rides on
#: (``netps/tuner/``): a timed round trip that is decoded like a commit,
#: on the server's device, but never touches the center, the journal, the
#: dedup table or membership; a peer without the bit answers the typed
#: unknown-op error and the client's autotuner leaves it alone.
#: ``tracing`` advertises distributed-trace context propagation
#: (``telemetry/tracing/``): with ``DKTPU_TRACE=1`` a client adds
#: ``trace``/``parent`` ids (and the NTP-style ``ct0`` clock-exchange
#: timestamp on join/heartbeat) to request headers, but ONLY after the
#: peer's caps carried the bit, so a peer without it sees zero new bytes;
#: the server answers the clock fields (``st1``/``st2``) only on requests
#: that carried ``ct0``. JSON headers make the gate structural: an absent
#: key is an absent byte. Either package stitches the other's traces.
CAPS = {"codecs": list(CODECS), "striping": True, "replication": True,
        "serving": True, "sharding": True, "shm": True, "mesh": True,
        "tree": True, "tuner": True, "tracing": True}

#: the core parameter-server ops carried in ``header["op"]``.
OP_JOIN = "join"
OP_PULL = "pull"
OP_COMMIT = "commit"
OP_HEARTBEAT = "heartbeat"
OP_LEAVE = "leave"

#: warm-standby replication + failover fencing (``CAPS["replication"]``).
OP_REPLICATE = "replicate"
OP_FENCE = "fence"

#: serving-plane ops carried in ``header["op"]`` (``stats`` is also the
#: parameter server's membership-free scrape).
OP_INFER = "infer"
OP_STATS = "stats"

#: the tuner's timed micro-A/B round trip (see ``CAPS["tuner"]``).
OP_PROBE = "probe"


class OpSpec(NamedTuple):
    """One op's wire contract: ``cap`` is the :data:`CAPS` key whose
    advertisement gates it (``None`` = core protocol), ``replies`` the
    distinguished reply-header keys a handler may answer it with, beyond
    ``ok``/``error``/``message``/``req``."""

    cap: Optional[str]
    replies: tuple


#: the ops the port serves, with their reply fields (the JAX package's
#: registry rows for the same ops). A server reply carries no key outside
#: its op's row, and the rows stay subsets of the JAX package's, so each
#: package can read the other's replies;
#: ``tests/test_torch_netps_failover.py`` holds both.
OP_REGISTRY = {
    OP_JOIN: OpSpec(None, ("worker_id", "updates", "lease_s", "last_seq",
                           "epoch", "caps")),
    OP_PULL: OpSpec(None, ("updates", "plan_hash", "sharding")),
    OP_COMMIT: OpSpec(None, ("applied", "duplicate", "pending", "updates",
                             "staleness")),
    OP_HEARTBEAT: OpSpec(None, ("updates",)),
    OP_LEAVE: OpSpec(None, ()),
    OP_REPLICATE: OpSpec("replication",
                         ("mode", "records", "updates", "epoch", "lineage",
                          "commits_total", "last_seq", "root_u")),
    OP_FENCE: OpSpec("replication", ("fenced", "epoch")),
    OP_INFER: OpSpec("serving", ("arrays", "error")),
    OP_STATS: OpSpec(None, ("caps", "role", "snapshot", "ring", "updates",
                            "epoch", "members", "commits_total", "draining",
                            "ready", "tree", "fold_backend")),
    OP_PROBE: OpSpec("tuner", ("probe_bytes", "decode_s")),
}


#: every typed ``error`` kind a reply header may carry: the netps server's
#: (``netps/errors.py``) and the serving plane's (``serving/errors.py``,
#: same frames, same key). A subset of the JAX package's set.
ERROR_KINDS = frozenset({
    # netps core (netps/errors.py)
    "protocol", "draining", "lease_expired", "uninitialized",
    "not_primary", "epoch_fenced", "shard_plan",
    # serving plane (serving/errors.py)
    "overloaded", "deadline", "unavailable", "serving",
})

#: every frame-header key either side may read or write: request fields,
#: reply fields, the replication-record sub-headers and the trace/clock
#: plumbing. A subset of the JAX package's set. A probe request's
#: ``probe_codec`` is not here, as it is not in the JAX package's set: the
#: server never reads it (each entry's spec says how it decodes).
HEADER_KEYS = frozenset({
    # envelope + request/reply bookkeeping
    "op", "req", "ok", "error", "message", "arrays", "version",
    # membership + commit protocol
    "worker_id", "seq", "pulled", "updates", "lease_s", "last_seq",
    "applied", "duplicate", "pending", "staleness", "epoch", "caps",
    # striping
    "num_shards", "shard", "idx",
    # replication / failover
    "u", "mode", "records", "lineage", "commits_total", "fenced",
    "wid", "st", "e", "n", "k", "tr",
    # aggregation tree (replicate's root-counter rider + the stats block)
    "root_u", "tree",
    # sharded center
    "want_plan", "plan_hash", "sharding", "shard_index", "shard_plan",
    "plan", "index", "count",
    # stats / health scrape
    "ring", "role", "snapshot", "members", "draining", "ready",
    "fold_backend",
    # tuner probe
    "probe_bytes", "decode_s",
    # tracing + clock exchange
    "trace", "parent", "ct0", "st1", "st2",
})


# ---------------------------------------------------------------------------
# Shared-memory segment layout (the same-host ring dialect, ``netps/shm.py``)
# ---------------------------------------------------------------------------
#
# One mmap'd file per direction (client->server and server->client), each a
# single seqlock'd slot sized to the largest frame it has carried::
#
#     MAGIC(4) VERSION(4) SEQ(4) CRC32(4) LENGTH(8) RESERVED(8) | frame bytes
#
# The payload is a regular wire frame (prefix + body), so every header and
# codec rule above applies unchanged. SEQ is the seqlock: the writer bumps
# it odd before touching the slot and even after; a reader that sees an odd
# SEQ (or a SEQ change across its copy) has raced a writer and treats the
# frame as corrupt (ProtocolError: the connection is dead by contract).
#
# CRC32 covers the frame's *header section* (prefix + length-prefixed JSON
# header: everything that drives allocation and dispatch). The array
# payload is not checksummed on this transport: a coherent mmap on one host
# has no lossy channel (lengths are checked, interleaving is caught by the
# seqlock), and skipping the payload crc pass is a large share of the
# ring's gain over loopback TCP. Socket frames keep the full-body crc.
#
# Strict request/reply alternation per connection means ONE slot per
# direction suffices; striping opens one ring per stripe connection. The doorbell (a UDS byte stream carrying 8-byte frame
# lengths) is the happens-before edge and the timeout surface; the segment
# fds travel over the same UDS by SCM_RIGHTS at attach, so the files are
# unlinked before any byte moves. The layout is the JAX package's, byte for
# byte, so either package's ring client attaches to either package's server.

SHM_MAGIC = 0x444B5348  # 'DKSH'
SHM_VERSION = 1
_SHM_SLOT = struct.Struct("!IIIIQQ")  # magic, version, seq, crc32, length, rsvd
#: one network-order u32: in-place reads and writes of single slot fields
#: (and of the frame's HLEN word).
U32 = struct.Struct("!I")
#: byte offsets of the seqlock and crc fields inside ``_SHM_SLOT``.
SHM_SEQ_OFF = 8
SHM_CRC_OFF = 12
SHM_SLOT_HEADER = _SHM_SLOT.size
_SHM_DOORBELL = struct.Struct("!Q")  # frame length rung across the UDS
SHM_DOORBELL_SIZE = _SHM_DOORBELL.size


def pack_doorbell(nbytes: int) -> bytes:
    """The 8-byte doorbell announcing an ``nbytes`` ring frame."""
    return _SHM_DOORBELL.pack(nbytes)


def unpack_doorbell(raw: bytes) -> int:
    """Frame length out of a received doorbell."""
    (length,) = _SHM_DOORBELL.unpack(raw)
    return length


def max_frame_bytes() -> int:
    return config.env_int("DKTPU_NET_MAX_FRAME")


def net_codec() -> str:
    """The configured tensor codec (``DKTPU_NET_COMPRESS``), validated."""
    codec = config.env_str("DKTPU_NET_COMPRESS")
    if codec not in CODECS:
        raise ValueError(
            f"DKTPU_NET_COMPRESS={codec!r} is not a known codec; "
            f"known: {list(CODECS)}")
    return codec


# ---------------------------------------------------------------------------
# Per-tensor codecs
# ---------------------------------------------------------------------------

def codec_encode(a: np.ndarray, codec: str) -> tuple[np.ndarray, dict]:
    """``a`` -> ``(wire array, spec extras)`` under ``codec``.

    Only float32 tensors compress (integer/bool tensors and any tensor with
    a non-finite value pass through untouched with empty extras)."""
    a = np.ascontiguousarray(a)
    if codec == CODEC_NONE or a.dtype != np.float32 or a.size == 0:
        return a, {}
    if codec == CODEC_BF16:
        wire16 = (a.view(np.uint32) >> np.uint32(16)).astype(np.uint16)
        return wire16, {"codec": CODEC_BF16}
    if codec == CODEC_INT8:
        amax = float(np.max(np.abs(a)))
        if not np.isfinite(amax):
            return a, {}
        if amax == 0.0:
            return np.zeros(a.shape, np.int8), {"codec": CODEC_INT8,
                                                "scale": 0.0}
        scale = amax / 127.0
        q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
        return q, {"codec": CODEC_INT8, "scale": scale}
    raise ValueError(f"unknown codec {codec!r}")


def codec_decode(a: np.ndarray, spec: dict) -> np.ndarray:
    """Invert :func:`codec_encode` from the wire array + its spec -> f32.
    Arrays without a ``codec`` key pass through (zero-copy)."""
    codec = spec.get("codec")
    if not codec:
        return a
    if codec == CODEC_BF16:
        return (np.ascontiguousarray(a).astype(np.uint32)
                << np.uint32(16)).view(np.float32)
    if codec == CODEC_INT8:
        try:
            scale = float(spec["scale"])
        except (KeyError, TypeError, ValueError) as e:
            raise ProtocolError(f"int8 array spec without a scale: {e}")
        return a.astype(np.float32) * np.float32(scale)
    raise ProtocolError(f"unknown codec {codec!r} in array spec")


def _byte_view(buf) -> memoryview:
    """A flat, 1-byte-itemsize view of any buffer (arrays included)."""
    if isinstance(buf, np.ndarray):
        return memoryview(buf.reshape(-1).view(np.uint8))
    view = memoryview(buf)
    if view.ndim != 1 or view.itemsize != 1:
        view = view.cast("B")
    return view


def _frame_buffers(kind: int, header: dict, arrays,
                   body_crc: bool = True) -> tuple[list, int]:
    """``(buffers, total_bytes)`` for one frame — zero-copy: the packed
    prefix+header bytes followed by flat views into the caller's arrays.
    ``arrays`` items are ``ndarray`` or ``(ndarray, spec_extras)``.

    ``body_crc=False`` checksums only the length-prefixed JSON header, not
    the array payload: the shm ring's contract (see the slot layout above).
    Socket transports and the journal always use the full-body crc."""
    items = []
    for it in arrays:
        a, extras = it if isinstance(it, tuple) else (it, {})
        items.append((np.ascontiguousarray(a), extras))
    header = dict(header)
    header["arrays"] = [
        dict({"dtype": a.dtype.str, "shape": list(a.shape)}, **extras)
        for a, extras in items]
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    views = [_byte_view(a) for a, _ in items]
    hlen = struct.pack("!I", len(hjson))
    crc = zlib.crc32(hjson, zlib.crc32(hlen))
    if body_crc:
        for v in views:
            crc = zlib.crc32(v, crc)
    length = 4 + len(hjson) + sum(v.nbytes for v in views)
    head = _PREFIX.pack(MAGIC, VERSION, kind, crc, length) + hlen + hjson
    return [memoryview(head), *views], PREFIX_SIZE + length


def encode_frame(kind: int, header: dict,
                 arrays: Sequence = ()) -> bytes:
    """Serialize ``header`` + ``arrays`` into one contiguous checksummed
    frame (tests; the RPC path sends the same buffers via
    :func:`send_frame`)."""
    buffers, _total = _frame_buffers(kind, header, arrays)
    return b"".join(bytes(b) for b in buffers)


def parse_prefix(prefix: bytes,
                 max_frame: Optional[int] = None) -> tuple[int, int, int]:
    """Validate a 12-byte frame prefix -> (kind, crc32, body_length)."""
    magic, version, kind, crc, length = _PREFIX.unpack(prefix)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    if version != VERSION:
        raise ProtocolError(f"unsupported protocol version {version}")
    if kind not in (KIND_REQUEST, KIND_REPLY):
        raise ProtocolError(f"unknown frame kind {kind}")
    limit = max_frame if max_frame is not None else max_frame_bytes()
    if length > limit:
        raise ProtocolError(
            f"frame of {length} bytes exceeds DKTPU_NET_MAX_FRAME={limit}")
    return kind, crc, length


def decode_frame(raw: bytes,
                 decode: bool = True) -> tuple[int, dict, list]:
    """Verify + decode one whole raw frame: ``(kind, header, arrays)``.
    ``decode=False`` returns ``(array, spec)`` wire pairs (the journal
    replay path — replayed deltas must re-fold in their wire dtype)."""
    kind, crc, length = parse_prefix(raw[:PREFIX_SIZE],
                                     max_frame=len(raw))
    body = raw[PREFIX_SIZE:]
    if len(body) != length:
        raise ProtocolError(
            f"frame declares {length} body bytes, got {len(body)}")
    if zlib.crc32(body) != crc:
        raise ProtocolError("frame checksum mismatch (corrupt or truncated)")
    header, arrays = _decode_body(body, decode=decode)
    return kind, header, arrays


def _decode_body(body, decode: bool = True) -> tuple[dict, list]:
    """``decode=False`` keeps codec'd tensors in their *wire* dtype: every
    array comes back as an ``(array, spec)`` pair (a plain tensor's spec
    has no codec) — the server's compressed-domain fold consumes the pairs
    directly."""
    if len(body) < 4:
        raise ProtocolError(f"frame body too short ({len(body)} bytes)")
    (hlen,) = struct.unpack_from("!I", body)
    if 4 + hlen > len(body):
        raise ProtocolError(
            f"header length {hlen} exceeds body ({len(body)} bytes)")
    try:
        header = json.loads(bytes(body[4:4 + hlen]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"undecodable frame header: {e}") from e
    arrays: list[np.ndarray] = []
    off = 4 + hlen
    for spec in header.get("arrays", ()):
        # Every decode error on untrusted header bytes surfaces as the
        # typed ProtocolError (a crafted negative dim would otherwise slip
        # past the truncation check and escape as a raw numpy ValueError).
        try:
            dt = np.dtype(spec["dtype"])
            shape = tuple(int(s) for s in spec["shape"])
        except (TypeError, ValueError, KeyError) as e:
            raise ProtocolError(f"bad array spec {spec!r}: {e}") from e
        if any(s < 0 for s in shape):
            raise ProtocolError(f"negative dimension in array spec {spec!r}")
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        n = dt.itemsize * count
        if off + n > len(body):
            raise ProtocolError(
                f"array section truncated: need {n} bytes at offset {off}, "
                f"body is {len(body)}")
        try:
            raw_arr = np.frombuffer(body, dtype=dt, count=count,
                                    offset=off).reshape(shape)
            arrays.append(codec_decode(raw_arr, spec) if decode
                          else (raw_arr, spec))
        except ValueError as e:
            raise ProtocolError(f"undecodable array {spec!r}: {e}") from e
        off += n
    if off != len(body):
        raise ProtocolError(
            f"{len(body) - off} trailing bytes after declared arrays")
    return header, arrays


def recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` exactly from ``sock`` or raise: ``ConnectionError`` on
    EOF, ``socket.timeout`` per the socket's timeout."""
    got, n = 0, len(view)
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise ConnectionError(
                f"connection closed mid-frame ({got}/{n} bytes)")
        got += r


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes (one preallocated buffer)."""
    buf = bytearray(n)
    recv_exact_into(sock, memoryview(buf))
    return bytes(buf)


def finish_raw_frame(sock: socket.socket, prefix: bytes,
                     max_frame: Optional[int] = None) -> bytes:
    """Given an already-received prefix, read the body: whole raw frame."""
    _kind, _crc, length = parse_prefix(prefix, max_frame)
    return prefix + recv_exact(sock, length)


def read_raw_frame(sock: socket.socket,
                   max_frame: Optional[int] = None) -> bytes:
    """One whole frame off ``sock`` as raw bytes, prefix checks applied but
    body neither checksummed nor decoded — the chaos proxy forwards frames
    opaquely, and *delivering* a corrupt frame is exactly its job."""
    return finish_raw_frame(sock, recv_exact(sock, PREFIX_SIZE), max_frame)


def finish_frame(sock: socket.socket, prefix: bytes,
                 max_frame: Optional[int] = None, decode: bool = True,
                 ) -> tuple[int, int, dict, list]:
    """Given an already-received prefix, read + verify + decode the rest:
    ``(kind, total_frame_bytes, header, arrays)`` — the server handler's
    half of :func:`read_frame` (it polls for the prefix itself so
    ``close()`` can interrupt it). ``decode=False`` returns every array as
    an ``(array, spec)`` pair in its wire dtype."""
    kind, crc, length = parse_prefix(prefix, max_frame)
    body = bytearray(length)
    recv_exact_into(sock, memoryview(body))
    if zlib.crc32(body) != crc:
        raise ProtocolError("frame checksum mismatch (corrupt or truncated)")
    header, arrays = _decode_body(body, decode=decode)
    return kind, PREFIX_SIZE + length, header, arrays


def read_frame(sock: socket.socket, max_frame: Optional[int] = None,
               ) -> tuple[int, dict, list[np.ndarray]]:
    """Read + verify + decode one frame: ``(kind, header, arrays)``."""
    prefix = recv_exact(sock, PREFIX_SIZE)
    kind, _nbytes, header, arrays = finish_frame(sock, prefix, max_frame)
    return kind, header, arrays


def send_frame(sock: socket.socket, kind: int, header: dict,
               arrays: Sequence = ()) -> int:
    """Scatter-gather send of one frame; returns bytes written."""
    buffers, total = _frame_buffers(kind, header, arrays)
    _sendmsg_all(sock, buffers)
    return total


def write_frame(fobj, kind: int, header: dict,
                arrays: Sequence = ()) -> int:
    """One frame appended to a binary file object, buffer by buffer — the
    durable journal's record writer (``netps/state.py``). The frame
    self-validates on read through the same crc and length checks the
    sockets use, so a torn tail is detected, not replayed."""
    buffers, total = _frame_buffers(kind, header, arrays)
    for b in buffers:
        fobj.write(b)
    return total


def _sendmsg_all(sock: socket.socket, buffers: list) -> None:
    """``sendmsg`` the buffer list fully, re-slicing across partial sends
    and chunking at ``_IOV_MAX``; falls back to per-buffer ``sendall``
    where the platform has no ``sendmsg``."""
    if not hasattr(sock, "sendmsg"):  # pragma: no cover - non-POSIX
        for b in buffers:
            sock.sendall(b)
        return
    # Zero-length views carry no wire bytes and would spin the advance
    # loop below; the header's shape entry round-trips an empty tensor.
    views = [v for v in (_byte_view(b) for b in buffers) if v.nbytes]
    i = 0
    while i < len(views):
        sent = sock.sendmsg(views[i:i + _IOV_MAX])
        while sent:
            n = views[i].nbytes
            if sent >= n:
                sent -= n
                i += 1
            else:
                views[i] = views[i][sent:]
                sent = 0


def split_endpoint(endpoint: str) -> tuple[str, int]:
    """``"host:port"`` -> (host, port) with a typed error on malformed input."""
    host, sep, port = endpoint.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(
            f"malformed endpoint {endpoint!r}: expected 'host:port'")
    return host, int(port)


def split_endpoints(endpoints: str) -> list[tuple[str, int]]:
    """``"host:port[,host:port...]"`` -> ordered (host, port) list — the
    client-failover form (primary first, then the rest)."""
    out = [split_endpoint(e.strip())
           for e in endpoints.split(",") if e.strip()]
    if not out:
        raise ValueError(f"no endpoints in {endpoints!r}")
    return out


def split_shard_endpoints(endpoints: str) -> list[str]:
    """The shard x failover endpoint matrix: ``;`` separates shards, ``,``
    separates each shard's failover list (primary first, then standbys):
    ``"p0:7077,s0:7078;p1:7177,s1:7178"`` is a two-shard deployment with a
    warm standby per shard. Returns one failover-list string per shard (the
    form :class:`~distkeras_tpu_torch.netps.client.PSClient` takes),
    validated; an endpoint without ``;`` parses to a one-element list."""
    groups = [g.strip() for g in endpoints.split(";") if g.strip()]
    if not groups:
        raise ValueError(f"no endpoints in {endpoints!r}")
    for g in groups:
        split_endpoints(g)  # typed error on any malformed member
    return groups
