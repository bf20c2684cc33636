"""The parameter server's fold: commit discipline semantics (the port's
copy of the JAX package's ``netps/fold.py``, on torch tensors).

Division of labor mirrors the reference: the *worker* pre-normalizes its
commit (ADAG divides by the window, the elastic disciplines send
``e = α·(w − center)``), and the *server* applies one scale —
``1/(staleness+1)`` for DynSGD, identity for everything else — and adds.
Staleness is the server's update counter minus the committer's pull-time
counter.

**Compressed-domain folds.** A delta tensor may arrive as an ``(array,
spec)`` pair in its *wire* dtype (the server's handlers read frames with
``decode=False``): int8 with a per-tensor scale, or bf16 bit-truncated.
Those fold without a decode-to-f32 pass through
``ops/kernels/fold.py fold_compressed_``: the CUDA kernel when the center
lies on the card, its plain twin on the CPU. A plain f32 entry folds as
``c += a * s`` in two ops. There is no probe and no fallback: a kernel
that fails to build or launch raises, and so does the commit.

:func:`fold_compressed_numpy` is the JAX package's numpy oracle, kept here
for the tests and ``chip_smoke.py``, which hold the port's folds to it bit
for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.netps.errors import ProtocolError
from distkeras_tpu_torch.ops.kernels.fold import fold_compressed_

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
    """The update counter as one int (the port serves no sharded center,
    whose per-shard counters the JAX package reduces here)."""
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


def stage_entry(entry, device) -> tuple[torch.Tensor, Optional[dict]]:
    """One delta entry as ``(tensor on device, spec or None)``: the copy a
    fold needs, which the server makes before it takes its lock. Frame
    arrays are views over the handler's frame buffer; ``.to()`` copies
    them to the card. An entry already staged passes through."""
    a, spec = split_entry(entry)
    spec = spec if spec and spec.get("codec") else None
    if not isinstance(a, torch.Tensor):
        a = (wire_tensor(a) if spec
             else torch.from_numpy(np.ascontiguousarray(a, np.float32)))
    return a.to(device), spec


def _fold_entry(c: torch.Tensor, entry, scale: float) -> None:
    t, spec = stage_entry(entry, c.device)
    if spec is None:
        s = float(np.float32(scale))
        c.add_(t.reshape(c.shape) * s)
        return
    fold_compressed_(c, t, spec, scale)


def fold_delta(center: Sequence[torch.Tensor], delta: Sequence,
               discipline: str, staleness: int) -> None:
    """Fold one worker-normalized commit into ``center`` (f32 tensors)
    **in place** — the body of the reference's ``handle_commit`` under the
    lock. Delta entries may be plain arrays or ``(array, spec)`` wire
    pairs, staged or not (:func:`stage_entry`); codec'd pairs fold in the
    compressed domain.

    Telemetry-free: the server holds its center lock across this and
    exports ``netps.fold.tensors_per_sec`` after releasing it."""
    scale = commit_scale(discipline, staleness)
    for c, d in zip(center, delta):
        _fold_entry(c, d, scale)
