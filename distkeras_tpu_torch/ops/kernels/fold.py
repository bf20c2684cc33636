"""Dequant-fused commit fold: accumulate a compressed delta into an f32
center in place. The CUDA kernel, its wrapper and its plain PyTorch twin
(the port's counterpart of ``distkeras_tpu/ops/pallas/fold.py``).

:func:`fold_compressed_` computes ``center += s * dequant(q)`` for one
tensor of a commit that arrived in its wire dtype
(``DKTPU_NET_COMPRESS=int8|bf16``):

* int8: ``q`` int8, ``dequant(q) = float(q)``, ``s = f32(scale *
  spec["scale"])``;
* bf16: ``q`` the bf16 bits in a 16-bit integer tensor (the wire's numpy
  ``uint16`` viewed as ``int16``), ``dequant(q)`` the bits shifted up 16
  and read as f32, ``s = f32(scale)``.

``scale`` is the discipline's commit scale. ``s`` is computed in Python
double and rounded once to f32, as the numpy oracle
(``netps/fold.py fold_compressed_numpy``) and the TPU wrapper round it; the
product and the sum are rounded separately, so the kernel, the twin and
the oracle give the same bits. ``s == 0`` or an empty tensor leaves the
center unchanged; an unknown codec raises ``ValueError`` and an int8 spec
without a scale ``KeyError``, as the TPU wrapper does.

On CUDA tensors the wrapper launches ``csrc/fold.cu``
(``fold_int8_f32``/``fold_bf16_f32``; the design note is in that file) or
raises; on CPU tensors it takes :func:`fold_compressed_plain_`.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.ops.kernels import build

CODEC_INT8 = "int8"
CODEC_BF16 = "bf16"

#: the C entry points -> (source, argtypes), and the launches so far in
#: this process, one per folded tensor: ``fold_int8`` (``fold_int8_f32``)
#: and ``fold_bf16`` (``fold_bf16_f32``).
_P = build.PTR
_LIB = build.KernelLib({
    "fold_int8_f32": ("fold", [_P, _P, build.I64, build.F32]),
    "fold_bf16_f32": ("fold", [_P, _P, build.I64, build.F32]),
}, ("fold_int8", "fold_bf16"))

#: the wire dtype each codec's tensor arrives in.
_WIRE_DTYPES = {CODEC_INT8: torch.int8, CODEC_BF16: torch.int16}


def reset_launches() -> None:
    """Set both fold kernels' launch counts to 0."""
    _LIB.reset()


def launch_counts() -> dict:
    """``{kernel name: launches}`` for the two fold kernels."""
    return _LIB.counts()


def prepare() -> None:
    """Build and bind both fold kernels now. A server on the card calls
    this before it takes commits: a first-use build inside a fold, under
    the center's lock, would hold every RPC (lease renewals included) for
    the seconds ``nvcc`` takes."""
    _LIB.bind()


def fold_scale(codec: str, spec: dict, scale: float) -> float:
    """The one f32 factor ``s`` of the fold, as a Python float holding an
    f32 value. Raises ``ValueError`` for an unknown codec and ``KeyError``
    for an int8 spec without a scale."""
    if codec == CODEC_INT8:
        return float(np.float32(float(scale) * float(spec["scale"])))
    if codec == CODEC_BF16:
        return float(np.float32(scale))
    raise ValueError(f"unknown codec {codec!r} in delta spec")


def _dequant_plain(q: torch.Tensor, codec: str) -> torch.Tensor:
    if codec == CODEC_INT8:
        return q.float()
    # bf16 -> f32 is exactly the 16-bit shift of the TPU kernel.
    return q.view(torch.bfloat16).float()


def fold_compressed_plain_(center: torch.Tensor, q: torch.Tensor,
                           codec: str, s: float) -> torch.Tensor:
    """The plain twin: ``center.add_(dequant(q) * s)``, two ops, two
    roundings (never ``add_(..., alpha=s)``, which may contract into an
    FMA)."""
    center.add_(_dequant_plain(q, codec).reshape(center.shape) * s)
    return center


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
    """``center += s * dequant(q)`` in place; returns ``center``. CUDA
    tensors go to the kernel (which raises on a failed build or launch),
    CPU tensors to the plain twin."""
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
    _LIB.launch(f"fold_{codec}_f32", center, q, center.numel(), s)
    _LIB.count(f"fold_{codec}")
    return center
