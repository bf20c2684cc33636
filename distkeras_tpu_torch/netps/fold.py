"""The parameter server's fold: commit discipline semantics (the port's
copy of the JAX package's ``netps/fold.py``, on torch tensors).

Division of labor mirrors the reference: the *worker* pre-normalizes its
commit (ADAG divides by the window, the elastic disciplines send
``e = α·(w − center)``), and the *server* applies one scale —
``1/(staleness+1)`` for DynSGD, identity for everything else — and adds.
Staleness is the server's update counter minus the committer's pull-time
counter.

**Compressed-domain folds, one launch a commit.** A delta tensor may
arrive as an ``(array, spec)`` pair in its *wire* dtype (the server's
handlers read frames with ``decode=False``): int8 with a per-tensor scale,
or bf16 bit-truncated; a plain f32 entry is what the wire sends uncompressed.
:func:`stage_commit` packs a whole commit, every entry in its wire dtype,
into one buffer laid out by ``ops/kernels/fold.py plan_commit`` (a table at
its head, each payload 16-byte aligned): for a center on the card in pinned
host memory from the server's :class:`PinnedPool`, copied to the card in
one ``non_blocking`` copy on the caller's current stream; for a center on
the CPU in ordinary memory, in the same layout. :func:`fold_delta` then
folds it through :func:`fold_staged` with ``fold_commit_``: one launch of
the CUDA kernel, or its plain twin on the CPU, after the reference mesh
folder's element-count conservation check. Every fold of the port goes
this way (each server dialect, recovery, a standby, ``MeshFolder``, the
aggregator's pre-combine). There is no fallback: a kernel that fails to
build or launch raises, and so does the commit.

**The probe's decode** (:class:`ProbeWindow`, the tuner's ``probe`` op)
decodes a payload the way a commit is decoded: staged in its own layout,
then one scale-1 ``fold_commit_`` into a scratch window filled with
``-0.0``. ``-0.0 + x`` is ``x`` bit for bit, so the window then holds the
reference's host decode (``decode_entry``) exactly; the window is never
the center.

:func:`fold_compressed_numpy` is the JAX package's numpy oracle, kept here
for the tests and ``chip_smoke.py``, which hold the port's folds to it bit
for bit.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.netps.errors import ProtocolError
from distkeras_tpu_torch.ops.kernels.fold import (StagedCommit,
                                                  center_layout,
                                                  fold_commit_, pack_commit,
                                                  plan_commit, read_table)

#: every discipline the server accepts (the reference routed both elastic
#: trainers through the plain DeltaParameterServer — the fold is
#: identical; elasticity lives worker-side).
SUPPORTED_DISCIPLINES = ("downpour", "adag", "dynsgd", "aeasgd", "eamsgd")


def check_discipline(discipline: str) -> str:
    if discipline not in SUPPORTED_DISCIPLINES:
        raise ValueError(
            f"unsupported PS discipline {discipline!r}; "
            f"known: {list(SUPPORTED_DISCIPLINES)}")
    return discipline


def counter_scalar(counter) -> int:
    """One scalar from a possibly per-shard counter: a sharded center's
    pull and join return one update counter a shard; a consumer that
    mirrors one lineage counter (the aggregator in front of a sharded
    root) takes the MIN, so staleness charged from it can only be
    overstated, never negative."""
    if isinstance(counter, (tuple, list)):
        return min(int(u) for u in counter)
    return int(counter)


def counter_staleness(updates, pulled) -> int:
    """THE staleness counter rule: the server's update counter at fold
    time minus the committer's pull-time counter."""
    return counter_scalar(updates) - counter_scalar(pulled)


def commit_scale(discipline: str, staleness: int) -> float:
    """The server-side scale applied to a commit folded ``staleness``
    updates after its pull (DynSGD's counter semantics; 1.0 otherwise)."""
    if discipline == "dynsgd":
        return 1.0 / (float(staleness) + 1.0)
    return 1.0


def split_entry(entry) -> tuple[np.ndarray, Optional[dict]]:
    """A delta entry is a plain ndarray (in-process callers) or an
    ``(array, spec)`` wire pair (the raw-decode path)."""
    if isinstance(entry, tuple):
        a, spec = entry
        return a, (spec or None)
    return entry, None


def decode_entry(entry) -> np.ndarray:
    """One delta entry -> a plain f32-domain array (join inits)."""
    a, spec = split_entry(entry)
    return wire.codec_decode(a, spec) if spec else np.asarray(a)


def exact_zero_scale(entry):
    """An int8 wire entry of scale 0 decoded to f32 (``q * 0.0``: ``±0``
    by q's sign), every other entry as it is. The fold kernel skips a
    zero-scale entry; a decode-then-add turns a ``-0.0`` window element
    into ``+0.0``. A malformed spec passes through for the caller's own
    validation to refuse."""
    a, spec = split_entry(entry)
    if spec and spec.get("codec") == wire.CODEC_INT8:
        try:
            if float(spec["scale"]) == 0.0:
                return wire.codec_decode(np.asarray(a), spec)
        except (KeyError, TypeError, ValueError):
            pass
    return entry


def validate_delta(delta) -> bool:
    """Up-front spec validation for a commit's wire entries (unknown codec,
    int8 without a scale), applied BEFORE any fold or bookkeeping: a spec
    that failed mid-:func:`fold_delta` would leave the already-folded
    prefix tensors in the center with no commit_log entry, and the
    retransmit would fold them AGAIN. Raises ``ProtocolError``; returns
    whether any entry folds in the compressed domain."""
    compressed = False
    for entry in delta:
        _a, spec = split_entry(entry)
        codec = spec.get("codec") if spec else None
        if not codec:
            continue
        if codec == wire.CODEC_INT8:
            try:
                float(spec["scale"])
            except (KeyError, TypeError, ValueError) as e:
                raise ProtocolError(f"int8 array spec without a scale: {e}")
        elif codec != wire.CODEC_BF16:
            raise ProtocolError(f"unknown codec {codec!r} in array spec")
        compressed = True
    return compressed


def backend_name(center: Sequence[torch.Tensor]) -> str:
    """Which arithmetic folds compressed commits into ``center``:
    ``"cuda"`` (the kernel) for a center on the card, ``"torch-cpu"`` (the
    plain twin) for one on the CPU, ``"unresolved"`` before any center."""
    if not center:
        return "unresolved"
    return "cuda" if center[0].device.type == "cuda" else "torch-cpu"


def fold_compressed_numpy(center: np.ndarray, a: np.ndarray, spec: dict,
                          scale: float) -> None:
    """The numpy oracle (the JAX package's reference fold): accumulate a
    wire-dtype tensor into the f32 ``center`` in place, dequantization
    fused into the add. A missing int8 scale raises rather than silently
    folding zero."""
    codec = spec.get("codec")
    if codec == wire.CODEC_INT8:
        s = np.float32(scale * float(spec["scale"]))
        if s:
            np.add(center, a.astype(np.float32) * s, out=center)
        return
    if codec == wire.CODEC_BF16:
        np.add(center, np.float32(scale) * wire.codec_decode(a, spec),
               out=center)
        return
    raise ValueError(f"unknown codec {codec!r} in delta spec")


def wire_tensor(a: np.ndarray) -> torch.Tensor:
    """A wire array as a CPU tensor over the same bytes: bf16 bits ride as
    numpy ``uint16``, handed to torch as ``int16`` (same bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a)


#: the priority of a server's stream (and a ``MeshFolder``'s):
#: lower is higher, and a value past the range PyTorch's stream pool offers
#: maps to its highest.
STREAM_PRIORITY = -64


class PinnedPool:
    """Pinned host buffers that commits are staged in before their copy to
    the card. A slot goes back to the pool with a CUDA event recorded after
    the copy that reads it, and the next user waits on that event before
    writing, so no slot is rewritten before its copy has landed. The pool
    holds as many slots as commits were ever staged at once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: list = []

    def acquire(self, nbytes: int) -> list:
        """A ``[pinned uint8 tensor of at least nbytes, event]`` slot, free
        to write."""
        with self._lock:
            slot = self._free.pop() if self._free else None
        if slot is not None:
            slot[1].synchronize()  # its last copy has landed
        if slot is None or slot[0].numel() < nbytes:
            size = 1 << max(20, (int(nbytes) - 1).bit_length())
            slot = [torch.empty(size, dtype=torch.uint8, pin_memory=True),
                    torch.cuda.Event()]
        return slot

    def release(self, slot: list, stream) -> None:
        """Return ``slot`` after its copy was enqueued on ``stream``."""
        slot[1].record(stream)
        with self._lock:
            self._free.append(slot)


def seat_center(arrays, device) -> tuple:
    """``(flat, offsets, views)``: ``arrays`` as f32 views into one flat
    tensor on ``device``, each at its ``center_layout`` offset — the layout
    a staged commit's default offsets address. On the card the copy runs
    on the current stream."""
    arrays = [np.asarray(a, np.float32) for a in arrays]
    offsets, total = center_layout([a.size for a in arrays])
    host = np.zeros(total, np.float32)
    for a, off in zip(arrays, offsets):
        host[off:off + a.size] = a.reshape(-1)
    flat = torch.from_numpy(host).to(device, copy=True)
    views = [flat[off:off + a.size].view(a.shape)
             for a, off in zip(arrays, offsets)]
    return flat, offsets, views


def host_mirror(flat: torch.Tensor, offsets, views, stream=None) -> list:
    """A host copy of a seated center (:func:`seat_center`) as read-only
    numpy views, one per tensor: ONE device-to-host copy of the flat
    tensor (on the card: into pinned memory on ``stream``, waiting on that
    stream alone; default: the current one). Read-only, so it can be
    handed out and replaced wholesale, never written in place."""
    if flat.device.type != "cuda":
        host = flat.clone()
    else:
        stream = stream or torch.cuda.current_stream(flat.device)
        with torch.cuda.stream(stream):
            host = torch.empty(flat.shape, dtype=flat.dtype,
                               pin_memory=True)
            host.copy_(flat, non_blocking=True)
        stream.synchronize()
    host = host.numpy()
    host.flags.writeable = False
    return [host[off:off + c.numel()].reshape(tuple(c.shape))
            for c, off in zip(views, offsets)]


def stage_commit(delta, device, pool: Optional[PinnedPool] = None,
                 offsets=None) -> StagedCommit:
    """A commit's entries as a :class:`~distkeras_tpu_torch.ops.kernels.
    fold.StagedCommit` on ``device``: the copy a fold needs, which the
    server makes before it takes its lock. Every entry (an ``(array,
    spec)`` pair or a plain array; frame arrays are views over the
    handler's frame buffer) is packed in its wire dtype into one buffer by
    ``plan_commit``; ``offsets`` places the centers (default: the server's
    ``center_layout``). On the card the buffer is pinned (from ``pool``,
    or a fresh one) and goes over in one ``non_blocking`` copy on the
    current stream; on the CPU it is the staged buffer itself. A commit
    already staged passes through."""
    if isinstance(delta, StagedCommit):
        return delta
    entries = []
    for entry in delta:
        a, spec = split_entry(entry)
        entries.append((a, spec if spec and spec.get("codec") else None))
    plan = plan_commit(entries, offsets)
    device = torch.device(device)
    if device.type == "cpu":
        buf = torch.empty(plan.nbytes, dtype=torch.uint8)
        host = buf.numpy()
        pack_commit(plan, host)
        # The twin reads the table from the packed bytes themselves.
        return StagedCommit(buf, read_table(host, len(entries))[0],
                            plan.tiles)
    slot = (pool.acquire(plan.nbytes) if pool is not None
            else [torch.empty(plan.nbytes, dtype=torch.uint8,
                              pin_memory=True), None])
    pack_commit(plan, slot[0].numpy())
    buf = torch.empty(plan.nbytes, dtype=torch.uint8, device=device)
    buf.copy_(slot[0][:plan.nbytes], non_blocking=True)
    if pool is not None:
        pool.release(slot, torch.cuda.current_stream(device))
    return StagedCommit(buf, plan.rows, plan.tiles)


def fold_delta(center: Sequence[torch.Tensor], delta: Sequence,
               discipline: str, staleness: int) -> None:
    """Fold one worker-normalized commit into ``center`` (f32 tensors)
    **in place** — the body of the reference's ``handle_commit`` under the
    lock. ``delta`` is a staged commit (:func:`stage_commit`, what the
    server passes) or its entries, plain arrays or ``(array, spec)`` wire
    pairs, which are staged here against the centers where they lie; either
    way it folds in one ``fold_commit_`` call, codec'd pairs in the
    compressed domain.

    Telemetry-free: the server holds its center lock across this and
    exports ``netps.fold.tensors_per_sec`` after releasing it."""
    offsets = None
    if center and center[0].device.type == "cuda":
        base = next((c.data_ptr() for c in center if c.numel()), 0)
        offsets = [(c.data_ptr() - base) // 4 if c.numel() else 0
                   for c in center]
    staged = (delta if isinstance(delta, StagedCommit)
              else stage_commit(delta, center[0].device if center else "cpu",
                                offsets=offsets))
    fold_staged(center, staged, commit_scale(discipline, staleness))


def fold_staged(center: Sequence[torch.Tensor], staged: StagedCommit,
                scale: float) -> None:
    """``center += scale * dequant(q)`` a tensor, in place, in one
    ``fold_commit_`` call; the codecs' own scales fold in as the numpy
    oracle folds them, bit for bit. First the element-count conservation
    check of the reference's mesh folder: a commit that does not cover
    every element of the center exactly once raises and leaves the center
    untouched."""
    if len(staged.rows) != len(center):
        raise ValueError(f"delta has {len(staged.rows)} tensors, the "
                         f"center {len(center)}")
    counted = int(staged.rows["n"].sum())
    expected = sum(c.numel() for c in center)
    if counted != expected:
        raise RuntimeError(f"fold conservation check: the commit covers "
                           f"{counted} elements, the center {expected}")
    fold_commit_(center, staged, float(scale))


class ProbeWindow:
    """A server's scratch window for the ``probe`` op's decode: one flat
    f32 tensor on the server's ``device``, grown to the largest probe seen
    and reused while it is large enough. It is never the center. One probe
    decodes at a time (a lock), since two probes (a tree node's sweep and
    a worker's) share the window. ``stream`` and ``pool`` are the
    server's (None on the CPU)."""

    def __init__(self, device, stream=None, pool: Optional[PinnedPool] = None):
        self.device = torch.device(device)
        self._stream = stream
        self._pool = pool
        self._lock = threading.Lock()
        self._flat: Optional[torch.Tensor] = None

    def decode(self, delta, keep: bool = False) -> tuple:
        """Decode a probe's entries (plain arrays or ``(array, spec)`` wire
        pairs) as a commit is decoded: staged with :func:`stage_commit` in
        the payload's own layout (a probe may come before any join, so
        there is no center to lay it out by), folded at scale 1 by one
        ``fold_commit_`` into the window at ``-0.0``, and the stream waited
        on, so the time of this call is the decode's. Returns ``(f32
        bytes decoded, host copies of the decoded tensors or None)``; the
        copies only with ``keep``. Raises what staging raises for a
        malformed payload (``TypeError``, ``ValueError``)."""
        entries = [exact_zero_scale(e) for e in delta]
        shapes = [np.shape(split_entry(e)[0]) for e in entries]
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        with self._lock, stream:
            staged = stage_commit(entries, self.device, self._pool)
            offsets = [int(o) for o in staged.rows["center"]]
            sizes = [int(n) for n in staged.rows["n"]]
            total = center_layout(sizes)[1]
            if self._flat is None or self._flat.numel() < total:
                self._flat = torch.empty(max(total, 1), dtype=torch.float32,
                                         device=self.device)
            flat = self._flat[:total]
            flat.fill_(-0.0)
            views = [flat[o:o + n].view(shape)
                     for o, n, shape in zip(offsets, sizes, shapes)]
            fold_staged(views, staged, 1.0)
            if self._stream is not None:
                self._stream.synchronize()
            decoded = (host_mirror(flat, offsets, views, self._stream)
                       if keep else None)
        return 4 * sum(sizes), decoded
