"""Dequant-fused commit fold: accumulate a commit's deltas into an f32
center in place. The CUDA kernel, its wrappers and their plain PyTorch
twins (the port's counterpart of ``distkeras_tpu/ops/pallas/fold.py``).

Each tensor of a commit folds as ``center += s * dequant(w)``, in the
dtype it arrived in:

* int8 (``DKTPU_NET_COMPRESS=int8``): ``w`` int8, ``dequant(w) =
  float(w)``, ``s = f32(scale * spec["scale"])``;
* bf16 (``DKTPU_NET_COMPRESS=bf16``): ``w`` the bf16 bits in a 16-bit
  integer tensor (the wire's numpy ``uint16`` viewed as ``int16``),
  ``dequant(w)`` the bits shifted up 16 and read as f32, ``s =
  f32(scale)``;
* plain f32 (what the wire sends for a tensor it does not compress):
  ``dequant(w) = w``, ``s = f32(scale)``.

``scale`` is the discipline's commit scale. ``s`` is computed in double and
rounded once to f32, as the numpy oracle (``netps/fold.py
fold_compressed_numpy``) and the TPU wrapper round it; the product and the
sum are rounded separately, so the kernel, the twins and the oracle give
the same bits. ``s == 0`` leaves a compressed tensor's center unchanged, so
does an empty tensor; an unknown codec raises ``ValueError`` and an int8
spec without a scale ``KeyError``, as the TPU wrapper does.

**A whole commit** folds in one launch of ``csrc/fold.cu`` (the design note
is in that file): :func:`plan_commit` lays the commit out as one buffer, a
table of one :data:`ROW` per tensor and the tile prefix at its head, then
every payload at a 16-byte aligned offset; :func:`pack_commit` writes it
(``netps/fold.py stage_commit`` packs it into pinned memory and copies it
to the card in one piece); :func:`fold_commit_` folds it into centers laid
out as its rows say (:func:`center_layout`, the server's flat center).
:func:`fold_compressed_` folds one tensor through the same kernel, its one
row passed by value. CUDA tensors go to the kernel or raise; CPU tensors
take the twins, :func:`fold_commit_plain_` and
:func:`fold_compressed_plain_`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from distkeras_tpu_torch.ops.kernels import build

CODEC_INT8 = "int8"
CODEC_BF16 = "bf16"

#: the kernel's kinds of payload (``csrc/fold.cu`` ``Kind``).
KIND_INT8, KIND_BF16, KIND_F32 = 0, 1, 2
#: each kind's codec (None: plain f32), wire dtype and bytes an element.
_KINDS = {KIND_INT8: (CODEC_INT8, torch.int8, 1),
          KIND_BF16: (CODEC_BF16, torch.int16, 2),
          KIND_F32: (None, torch.float32, 4)}
#: the numpy dtypes each kind's tensor may come in, the packed one first
#: (bf16 bits may come as int16, a torch view: the same bits).
_WIRE_NUMPY = {KIND_INT8: (np.dtype(np.int8),),
               KIND_BF16: (np.dtype(np.uint16), np.dtype(np.int16)),
               KIND_F32: (np.dtype(np.float32),)}

#: one row of a commit's table (``csrc/fold.cu`` ``FoldRow``): the center's
#: element offset from the base the launch passes, the payload's byte offset
#: in the buffer, n, the factor of ``s`` (int8: the spec's scale; 1
#: otherwise) and the kind.
ROW = np.dtype([("center", "<i8"), ("wire", "<i8"), ("n", "<i8"),
                ("factor", "<f8"), ("kind", "<i4"), ("pad", "<i4")])
#: elements a block of the kernel folds.
TILE = 4096
#: payloads start at multiples of this many bytes (one wire load).
ALIGN = 16
#: the server's center seats every tensor at a multiple of this many
#: elements (64 bytes), so each takes the kernel's vector body.
CENTER_ALIGN = 16

#: the C entry points -> (source, argtypes), and the launches so far in
#: this process: ``fold_commit`` once per folded commit, ``fold_int8`` and
#: ``fold_bf16`` once per tensor folded alone (:func:`fold_compressed_`,
#: through ``fold_tensor``), so a run shows which path it took.
_P = build.PTR
_LIB = build.KernelLib({
    "fold_commit": ("fold", [_P, build.INT, build.I64, _P, build.F64]),
    "fold_tensor": ("fold", [_P, _P, build.I64, build.F64, build.INT,
                             build.F64]),
}, ("fold_commit", "fold_int8", "fold_bf16"))


def reset_launches() -> None:
    """Set the fold's launch counts to 0."""
    _LIB.reset()


def launch_counts() -> dict:
    """``{name: launches}``: ``fold_commit`` (whole commits),
    ``fold_int8`` and ``fold_bf16`` (one tensor each)."""
    return _LIB.counts()


def prepare() -> None:
    """Build and bind the fold kernel now. A server on the card calls this
    before it takes commits: a first-use build inside a fold, under the
    center's lock, would hold every RPC (lease renewals included) for the
    seconds ``nvcc`` takes."""
    _LIB.bind()


def fold_scale(codec: str, spec: dict, scale: float) -> float:
    """The one f32 factor ``s`` of a compressed tensor's fold, as a Python
    float holding an f32 value. Raises ``ValueError`` for an unknown codec
    and ``KeyError`` for an int8 spec without a scale."""
    if codec == CODEC_INT8:
        return float(np.float32(float(scale) * float(spec["scale"])))
    if codec == CODEC_BF16:
        return float(np.float32(scale))
    raise ValueError(f"unknown codec {codec!r} in delta spec")


def entry_kind(spec) -> tuple[int, float]:
    """A wire spec (None or ``{}`` for plain f32) -> ``(kind, factor)``,
    with :func:`fold_scale`'s errors."""
    codec = spec.get("codec") if spec else None
    if codec is None:
        return KIND_F32, 1.0
    if codec == CODEC_INT8:
        return KIND_INT8, float(spec["scale"])
    if codec == CODEC_BF16:
        return KIND_BF16, 1.0
    raise ValueError(f"unknown codec {codec!r} in delta spec")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def center_layout(sizes) -> tuple[list, int]:
    """``(offsets, total)``: each tensor of ``sizes`` elements at a multiple
    of :data:`CENTER_ALIGN` elements of one flat f32 center, in order, and
    the flat center's length."""
    offsets, end = [], 0
    for n in sizes:
        start = _round_up(end, CENTER_ALIGN)
        offsets.append(start)
        end = start + int(n)
    return offsets, end


@dataclass
class CommitPlan:
    """Where everything of one commit goes in its staging buffer:
    ``rows`` (:data:`ROW`, one per entry), ``first`` (the first tile of
    each entry, then the total), each payload's source array (its bytes,
    ``None`` for an empty one), ``nbytes`` and ``tiles``."""

    rows: np.ndarray
    first: np.ndarray
    payloads: list
    nbytes: int

    @property
    def tiles(self) -> int:
        return int(self.first[-1])

    @property
    def header_bytes(self) -> int:
        return self.rows.nbytes + self.first.nbytes


def plan_commit(entries, offsets=None) -> CommitPlan:
    """Lay out a commit of ``(array, spec or None)`` entries (numpy arrays
    or CPU tensors in their wire dtype; plain entries are cast to f32) as
    one staging buffer: the table (:data:`ROW` rows, then the tile prefix)
    at its head, then each payload at a multiple of :data:`ALIGN` bytes.
    ``offsets`` are the centers' element offsets from the kernel's base
    (default :func:`center_layout` of the entries' sizes)."""
    E = len(entries)
    rows = np.zeros(E, ROW)
    payloads = []
    for i, (a, spec) in enumerate(entries):
        kind, rows["factor"][i] = entry_kind(spec)
        a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
        packed = _WIRE_NUMPY[kind][0]
        if kind != KIND_F32:
            # A compressed tensor folds in its wire dtype or not at all.
            if a.dtype not in _WIRE_NUMPY[kind]:
                raise TypeError(f"a {_KINDS[kind][0]} delta must be one of "
                                f"{_WIRE_NUMPY[kind]}, got {a.dtype}")
            a = a.view(packed)
        a = np.ascontiguousarray(a, packed).reshape(-1)
        rows["n"][i], rows["kind"][i] = a.size, kind
        payloads.append(a.view(np.uint8) if a.size else None)
    if offsets is None:
        offsets = center_layout(rows["n"])[0]
    rows["center"] = np.asarray(offsets, np.int64).reshape(E)
    tiles = -(-rows["n"] // TILE)
    first = np.zeros(E + 1, np.int64)
    np.cumsum(tiles, out=first[1:])
    end = _round_up(rows.nbytes + first.nbytes, ALIGN)
    for i, p in enumerate(payloads):
        rows["wire"][i] = end
        end = _round_up(end + (0 if p is None else p.size), ALIGN)
    return CommitPlan(rows, first, payloads, end)


def pack_commit(plan: CommitPlan, out: np.ndarray) -> None:
    """Write the commit ``plan`` lays out into ``out`` (uint8, at least
    ``plan.nbytes``): the table, then every payload at its offset. Padding
    bytes are left as they are; the kernel never reads them."""
    head = plan.rows.nbytes
    out[:head] = plan.rows.view(np.uint8)
    out[head:plan.header_bytes] = plan.first.view(np.uint8)
    for r, p in zip(plan.rows, plan.payloads):
        if p is not None:
            out[r["wire"]:r["wire"] + p.size] = p


def read_table(buf: np.ndarray, E: int) -> tuple[np.ndarray, np.ndarray]:
    """The ``(rows, first)`` at the head of a packed commit (uint8)."""
    rows = buf[:E * ROW.itemsize].view(ROW)
    first = buf[E * ROW.itemsize:E * ROW.itemsize + 8 * (E + 1)].view(
        np.int64)
    return rows, first


def _dequant_plain(q: torch.Tensor, codec: str) -> torch.Tensor:
    if codec == CODEC_INT8:
        return q.float()
    # bf16 -> f32 is exactly the 16-bit shift of the TPU kernel.
    return q.view(torch.bfloat16).float()


def fold_compressed_plain_(center: torch.Tensor, q: torch.Tensor,
                           codec: str, s: float) -> torch.Tensor:
    """The plain twin of one compressed tensor's fold:
    ``center.add_(dequant(q) * s)``, two ops, two roundings (never
    ``add_(..., alpha=s)``, which may contract into an FMA)."""
    center.add_(_dequant_plain(q, codec).reshape(center.shape) * s)
    return center


@dataclass
class StagedCommit:
    """A commit ready for :func:`fold_commit_`: ``buf``, the packed staging
    buffer (uint8, on the center's device), ``rows``, its table on the host
    (each entry's kind, size and factor: an int8 entry's factor is its
    spec's scale), and ``tiles``."""

    buf: torch.Tensor
    rows: np.ndarray
    tiles: int


def wire_view(buf: torch.Tensor, row) -> torch.Tensor:
    """One row's payload, a view of the staging buffer in its wire
    dtype."""
    _codec, dtype, size = _KINDS[int(row["kind"])]
    start = int(row["wire"])
    return buf[start:start + int(row["n"]) * size].view(dtype)


def fold_commit_plain_(centers, staged: StagedCommit, scale: float) -> None:
    """The plain twin of :func:`fold_commit_`: each row's payload, read from
    the staging buffer where the row says, folded into its center by
    :func:`fold_compressed_plain_` or, plain f32, by ``c.add_(w * s)`` with
    ``s = f32(scale)``."""
    for c, row in zip(centers, staged.rows):
        if int(row["n"]) == 0:
            continue
        w = wire_view(staged.buf, row)
        codec = _KINDS[int(row["kind"])][0]
        if codec is None:
            c.add_(w.reshape(c.shape) * float(np.float32(scale)))
            continue
        s = float(np.float32(float(scale) * float(row["factor"])))
        if s != 0.0:
            fold_compressed_plain_(c, w, codec, s)


def _check_centers(centers, rows: np.ndarray) -> None:
    """One f32 contiguous center per row, of the row's size (one pass per
    property: the server's commits hold hundreds of tensors)."""
    if len(centers) != len(rows):
        raise ValueError(f"a commit of {len(rows)} tensors for a center of "
                         f"{len(centers)}")
    sizes = [c.numel() for c in centers]
    if sizes != rows["n"].tolist():
        i = next(i for i, n in enumerate(rows["n"]) if sizes[i] != n)
        raise ValueError(f"delta has {int(rows['n'][i])} elements, the "
                         f"center {sizes[i]}")
    if any(c.dtype != torch.float32 for c in centers):
        raise TypeError(f"the fold's center must be float32, got "
                        f"{sorted({str(c.dtype) for c in centers})}")
    if not all(c.is_contiguous() for c in centers):
        raise ValueError("the fold needs contiguous tensors")


def fold_commit_(centers, staged: StagedCommit, scale: float) -> None:
    """Fold one staged commit into ``centers`` in place, ``scale`` the
    commit scale. On CUDA one launch of ``fold_commit``, which needs the
    centers where the rows' offsets put them (views of one flat tensor
    seated by :func:`center_layout`, or wherever the plan was told) and
    raises otherwise; on the CPU the twin."""
    buf, rows, tiles = staged.buf, staged.rows, staged.tiles
    _check_centers(centers, rows)
    if build.on_cpu((*centers, buf)):
        fold_commit_plain_(centers, staged, scale)
        return
    dev = buf.device
    if dev.type != "cuda" or any(c.device != dev for c in centers):
        raise ValueError(
            f"the fold needs the centers and the staged commit on one CUDA "
            f"device (or all on the CPU); got {dev} and "
            f"{sorted({str(c.device) for c in centers})}")
    if tiles == 0:
        return
    # An empty entry is never read or written, wherever its view points.
    live = rows["n"] > 0
    ptrs = np.array([c.data_ptr() for c in centers], np.int64)[live]
    offs = rows["center"][live]
    base = int(ptrs[0] - 4 * offs[0])
    if not np.array_equal(ptrs, base + 4 * offs):
        raise ValueError("the commit kernel folds into centers laid out as "
                         "its rows say (one flat tensor, center_layout)")
    _LIB.launch("fold_commit", buf, len(rows), tiles, base, float(scale))
    _LIB.count("fold_commit")


#: the wire dtype each codec's tensor arrives in.
_WIRE_DTYPES = {codec: dtype for codec, dtype, _ in _KINDS.values() if codec}


def _check(center: torch.Tensor, q: torch.Tensor, codec: str) -> None:
    """The fold takes an f32 center and a wire tensor of the codec's
    dtype with as many elements, both contiguous and on one device."""
    if center.dtype != torch.float32:
        raise TypeError(f"the fold's center must be float32, got "
                        f"{center.dtype}")
    if q.dtype != _WIRE_DTYPES[codec]:
        raise TypeError(f"a {codec} delta must be one of "
                        f"{_WIRE_DTYPES[codec]}, got {q.dtype}")
    if q.numel() != center.numel():
        raise ValueError(f"delta has {q.numel()} elements, the center "
                         f"{center.numel()}")
    if center.device != q.device:
        raise ValueError(
            f"the fold needs center and delta on one device (or both on "
            f"the CPU); got {center.device} and {q.device}")
    if not (center.is_contiguous() and q.is_contiguous()):
        raise ValueError("the fold needs contiguous tensors")


def fold_compressed_(center: torch.Tensor, q: torch.Tensor, spec: dict,
                     scale: float) -> torch.Tensor:
    """One tensor: ``center += s * dequant(q)`` in place; returns
    ``center`` (the counterpart of the JAX ``fold_compressed``). CUDA
    tensors go to the commit kernel with one row (``fold_tensor``, which
    raises on a failed build or launch), CPU tensors to the plain twin."""
    codec = spec.get("codec")
    s = fold_scale(codec, spec, scale)
    _check(center, q, codec)
    if center.numel() == 0 or s == 0.0:
        return center
    if build.on_cpu((center, q)):
        return fold_compressed_plain_(center, q, codec, s)
    if center.device.type != "cuda":
        raise ValueError(f"the fold kernel runs on CUDA tensors, got "
                         f"{center.device}")
    kind, factor = entry_kind(spec)
    _LIB.launch("fold_tensor", center, q, center.numel(), factor, kind,
                float(scale))
    _LIB.count(f"fold_{codec}")
    return center
