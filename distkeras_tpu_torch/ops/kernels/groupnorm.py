"""GroupNorm (+ReLU), forward and backward: the CUDA kernels, their wrappers
and their plain PyTorch twins (the port's counterpart of
``distkeras_tpu/ops/pallas/groupnorm.py``).

:func:`group_norm` takes ``x [B, spatial..., C]`` in NHWC memory order and
per-channel ``gamma``, ``beta [C]``, and returns ``x``'s shape and dtype.
Groups are flax's contiguous ones (channel ``c`` is in group
``c // (C / groups)``); the statistics are f32, one pass and biased, with
eps 1e-6, as the TPU kernel computes them.

* Without a gradient it runs the forward alone: ``csrc/groupnorm.cu``'s
  ``group_norm_fwd_f32`` or ``group_norm_fwd_bf16`` on CUDA tensors (the
  design note is in that file).
* With one, it goes through :class:`GroupNormFn`, the counterpart of the
  JAX package's ``custom_vjp``: the same forward, saving only ``(x, gamma,
  beta)``, and ``group_norm_bwd_*``, which recomputes the statistics and
  the ReLU mask from ``x``.

float32 and bfloat16 take the same path, one dtype for x, gamma, beta
(and dy). In bf16 the TPU kernels' points hold, in the kernels and the
twins alike: the values are read as bf16 and everything is computed in
f32 (statistics, ReLU mask, the sums); y and dx are rounded to bf16 where
they are stored, dgamma and dbeta (f32 sums) at the end.

Each kernel has a plain twin here (:func:`group_norm_fwd_plain`,
:func:`group_norm_bwd_plain`) with the same arithmetic. A wrapper takes its
twin only for tensors that lie on the CPU; on CUDA tensors it launches its
kernel or raises. Every shape goes to the kernel: the JAX wrapper's XLA
fallback for slabs that do not fit the TPU's VMEM has no counterpart here.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from distkeras_tpu_torch.ops.kernels import build
from distkeras_tpu_torch.ops.precision import widen

EPS = 1e-6

#: the C entry points -> (source, argtypes), and the launches so far in
#: this process by kernel: ``group_norm_fwd`` (``group_norm_fwd_f32``,
#: ``group_norm_fwd_bf16``: one launch) and ``group_norm_bwd``
#: (``group_norm_bwd_*``: two), one count per wrapper call.
_P, _I = build.PTR, build.INT
_LIB = build.KernelLib({
    **{f"group_norm_fwd_{s}": ("groupnorm", [_P] * 4 + [_I] * 10)
       for s in build.SUFFIXES.values()},
    **{f"group_norm_bwd_{s}": ("groupnorm", [_P] * 8 + [_I] * 10)
       for s in build.SUFFIXES.values()},
}, ("group_norm_fwd", "group_norm_bwd"))

#: the kernels' block: 512 threads where one block fills an SM's shared
#: memory, 256 where two fit (an SM holds 233,472 bytes, 1,024 of them
#: reserved a block); the shared memory a block may use on the card; the
#: cluster sizes (the portable ones).
GN_THREADS = 512
GN_SMALL_THREADS = 256
#: a block whose rows hold at most this many vectors takes 128 threads:
#: at most 16 a thread (ResNet-50's 14x14 and 7x7 slabs)
GN_FEW_SLOTS, GN_FEW_THREADS = 2048, 128
GN_SM_SMEM = 233472
GN_MAX_SMEM = 232448
GN_HALF_SMEM = GN_SM_SMEM // 2 - 1024
GN_CLUSTERS = (1, 2, 4, 8)
#: the non-portable cluster size the card also schedules (an H100 GPC
#: holds 16 or more SMs), taken only where 8 blocks cannot keep a slab's
#: rows in shared memory
GN_WIDE_CLUSTER = 16
#: the tile widths tried at two blocks an SM, in bytes a row: a 128-byte
#: line, then half a line (two 32-byte sectors) where a line-wide tile
#: cannot keep every row on chip
GN_LINES = (128, 64)


class GnTiling(NamedTuple):
    """How the kernels cover a ``[B, N, C]`` call (``csrc/groupnorm.cu``):
    a cluster of ``cluster`` blocks owns one (sample, ``ct``-channel tile),
    a thread reads ``vec`` channels of a row as one vector, a block of
    ``threads`` threads owns ``rows`` rows of the slab and keeps the first
    ``cached`` of them (x, and dy in the backward) in ``smem`` bytes of
    shared memory."""
    ct: int
    vec: int
    threads: int
    cluster: int
    rows: int
    cached: int
    smem: int


def reset_launches() -> None:
    """Set both GroupNorm kernels' launch counts to 0."""
    _LIB.reset()


def launch_counts(by_entry: bool = False) -> dict:
    """``{kernel name: launches}`` for the two GroupNorm kernels, or with
    ``by_entry`` the calls of each C entry point
    (``group_norm_fwd_bf16``, ...)."""
    return _LIB.entry_counts() if by_entry else _LIB.counts()


def warmup_counts() -> dict:
    """The launches of :func:`launch_counts` that the warm-up rounds before
    a CUDA graph capture made (``parallel/program.py``)."""
    return _LIB.warmup_counts()


def gn_smem_bytes(ct: int, vec: int, threads: int, cached: int,
                  itemsize: int, streams: int, groups_in_tile: int) -> int:
    """Shared memory of a block (``csrc/groupnorm.cu gn_smem``): the
    ``streams`` caches ``[cached][ct]`` (x; and dy in the backward), each
    rounded up to 16 bytes, the f32 reduction rows ``[2][rows][ct]`` (a
    warp's rows once its lanes have combined by shuffles where ct/vec
    divides 32, else each row of threads), the published partials, the
    gathered totals and the groups' values."""
    L = ct // vec
    red = threads // 32 if 32 % L == 0 else threads // L
    cache = -(-cached * ct * itemsize // 16) * 16
    return streams * cache + 4 * (2 * red * ct + 6 * ct + 4 * groups_in_tile)


def gn_layout(N: int, C: int, groups: int, itemsize: int, backward: bool,
              vec: int, ct: int, threads: int, smem: int,
              clusters: tuple = GN_CLUSTERS + (GN_WIDE_CLUSTER,)
              ) -> GnTiling:
    """The tiling of a ``[B, N, C]`` call at a given vector width, tile,
    block size and shared-memory budget a block: the fewest blocks of
    ``clusters`` whose share of the slab's rows, ``ceil(N / cluster)``,
    fits beside the reduction (x, and dy in the backward), or the most;
    ``cached`` is the rows of the share that fit, and the kernels read
    the rest again from global memory (L2) in each sweep."""
    cg = C // groups
    streams = 2 if backward else 1
    fixed = gn_smem_bytes(ct, vec, threads, 0, itemsize, streams, ct // cg)
    fit = max(0, (smem - fixed) // streams // 16 * 16 // (ct * itemsize))
    cluster = next((k for k in clusters if -(-N // k) <= fit), clusters[-1])
    rows = -(-N // cluster)
    cached = min(rows, fit)
    return GnTiling(ct, vec, threads, cluster, rows, cached,
                    gn_smem_bytes(ct, vec, threads, cached, itemsize,
                                  streams, ct // cg))


@functools.lru_cache(maxsize=1024)
def gn_tiling(N: int, C: int, groups: int, itemsize: int, backward: bool,
              align: int = 16) -> GnTiling:
    """The kernels' tiling of a ``[B, N, C]`` call with ``groups`` groups
    of ``itemsize``-byte values whose pointers are ``align``-byte aligned:

    * ``vec``: the most channels up to 16 bytes (8 bf16, 4 f32) that
      divide C and the alignment;
    * ``ct``: the narrowest tile of whole groups and whole vectors that
      divides C and is at least a 128-byte line wide (64 bf16 or 32 f32
      channels) where C is;
    * two blocks an SM where that caches every row: 256 threads and at
      most 115,712 bytes of shared memory a block, so that one block's
      barriers and arithmetic overlap the other's loads, with the fewest
      blocks a cluster (1, 2, 4, 8, 16) whose share of the slab's rows
      fits (:func:`gn_layout`); where a line-wide tile cannot, a tile half
      a line wide (two 32-byte sectors a row, ``GN_LINES``) halves the
      slab; a block whose rows hold at most 2048 vectors takes 128
      threads instead (ResNet-50's 14x14 and 7x7 slabs: 16 or fewer a
      thread);
    * else one block an SM: 512 threads (the block alone keeps the SM's
      loads in flight) and 232,448 bytes, the fewest blocks whose share
      fits, or the most; ``cached`` is the rows of the share that fit, and
      the kernels read the rest again from global memory (L2).

    16 blocks is past the portable cluster size; an H100's GPCs hold it,
    and only a slab that 8 blocks cannot keep on chip takes it: ResNet-50's
    stem at 112x112x64 (G=32), 784 rows a block, two blocks an SM, all rows
    cached: the forward in tiles of a line (64 bf16 or 32 f32 channels),
    the backward (x and dy) in tiles of half a line. Its 56x56 slabs take
    two blocks an SM in clusters of 4 and 8 at a line. A slab that 16
    blocks cannot keep (the stem of a 448x448 image, 224x224x64) takes one
    block an SM and caches part of its rows. Raises a ``ValueError`` where
    a row's lanes outgrow a block."""
    if C % groups:
        raise ValueError(f"C={C} not divisible by groups={groups}")
    cg = C // groups
    vec = max(1, min(16, align) // itemsize)
    while C % vec:
        vec //= 2
    unit = cg * vec // math.gcd(cg, vec)

    def tile(line_bytes: int) -> int:
        line = min(line_bytes // itemsize, C)
        return next(m for m in range(unit, C + 1, unit)
                    if C % m == 0 and m >= line)

    ct = tile(GN_LINES[0])
    if ct // vec > GN_THREADS:
        raise ValueError(
            f"group_norm: the CUDA GroupNorm kernels need the {ct // vec} "
            f"vector lanes of a {ct}-channel tile (whole groups of {cg}) "
            f"within one block of {GN_THREADS} threads")
    args = (N, C, groups, itemsize, backward, vec)
    for line_bytes in GN_LINES:
        c = tile(line_bytes)
        if c // vec <= GN_SMALL_THREADS:
            t = gn_layout(*args, c, GN_SMALL_THREADS, GN_HALF_SMEM)
            if t.cached == t.rows:
                if (t.rows * (c // vec) <= GN_FEW_SLOTS
                        and c // vec <= GN_FEW_THREADS):
                    return gn_layout(*args, c, GN_FEW_THREADS, GN_HALF_SMEM)
                return t
    return gn_layout(*args, ct, GN_THREADS, GN_MAX_SMEM)


def _tiling(tensors, groups: int, backward: bool) -> GnTiling:
    """:func:`gn_tiling` for the call's ``x3`` (``tensors[0]``), at the
    alignment of every tensor the kernel reads or writes in vectors."""
    _B, N, C = tensors[0].shape
    align = 16
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return gn_tiling(N, C, groups, tensors[0].element_size(), backward,
                     align)


def _stats_plain(x3: torch.Tensor, groups: int):
    """Per-(sample, group) ``mean, inv [B, G]``: f32 sums of x and x^2,
    ``var = ss/n - mean^2``, ``inv = rsqrt(var + eps)``."""
    B, N, C = x3.shape
    xg = widen(x3).reshape(B, N, groups, C // groups)
    n = N * (C // groups)
    mean = xg.sum(dim=(1, 3)) / n
    var = (xg * xg).sum(dim=(1, 3)) / n - mean * mean
    return mean, torch.rsqrt(var + EPS)


def _per_channel(v: torch.Tensor, C: int) -> torch.Tensor:
    """``[B, G]`` -> ``[B, 1, C]``, each group's value on its channels."""
    B, G = v.shape
    return v.repeat_interleave(C // G, dim=1).reshape(B, 1, C)


def group_norm_fwd_plain(x3: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, groups: int,
                         relu: bool) -> torch.Tensor:
    """The forward in plain PyTorch on ``x3 [B, N, C]``: ``y = x*a + b``
    with ``a = inv*gamma``, ``b = beta - mean*inv*gamma``, then ReLU. The
    CPU path of :func:`group_norm` and the reference its kernel is held
    against. Computed wide on the stored values; y stored in x's dtype."""
    C = x3.shape[2]
    gamma, beta = widen(gamma), widen(beta)
    mean, inv = _stats_plain(x3, groups)
    a = _per_channel(inv, C) * gamma
    b = beta - _per_channel(mean * inv, C) * gamma
    y = widen(x3) * a + b
    return (torch.relu(y) if relu else y).to(x3.dtype)


def group_norm_bwd_plain(x3: torch.Tensor, dy: torch.Tensor,
                         gamma: torch.Tensor, beta: torch.Tensor,
                         groups: int, relu: bool) -> tuple:
    """The backward in plain PyTorch, the TPU ``_bwd_kernel``'s arithmetic:
    statistics and ReLU mask recomputed from ``x3``, then ``dx [B, N, C]``,
    ``dgamma``, ``dbeta [C]``. Computed wide on the stored values; dx
    stored in x's dtype, dgamma and dbeta in gamma's and beta's."""
    B, N, C = x3.shape
    out_dtypes = (x3.dtype, gamma.dtype, beta.dtype)
    x3, dy, gamma, beta = (widen(t) for t in (x3, dy, gamma, beta))
    mean, inv = _stats_plain(x3, groups)
    inv_c = _per_channel(inv, C)
    xhat = (x3 - _per_channel(mean, C)) * inv_c
    if relu:
        dy = torch.where(xhat * gamma + beta > 0, dy, torch.zeros_like(dy))
    sdy = dy.sum(dim=1)                           # [B, C]
    sdx = (dy * xhat).sum(dim=1)
    n = N * (C // groups)
    m1 = (sdy * gamma).reshape(B, groups, -1).sum(dim=2) / n   # [B, G]
    m2 = (sdx * gamma).reshape(B, groups, -1).sum(dim=2) / n
    dx = inv_c * (dy * gamma - _per_channel(m1, C)
                  - xhat * _per_channel(m2, C))
    return tuple(t.to(d) for t, d in zip((dx, sdx.sum(dim=0),
                                          sdy.sum(dim=0)), out_dtypes))


def _check_cuda(tensors, what: str, C: int) -> str:
    """One dtype (float32 or bfloat16) for every tensor, contiguous, on one
    CUDA device; gamma and beta (the last two) ``[C]``. Returns the entry
    points' dtype suffix."""
    suffix = build.check_cuda(tensors, what, "GroupNorm")
    if any(tuple(t.shape) != (C,) for t in tensors[-2:]):
        raise ValueError(
            f"gamma and beta must be [C={C}]; got "
            f"{[tuple(t.shape) for t in tensors[-2:]]}")
    return suffix


def group_norm_fwd_cuda(x3: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, groups: int,
                        relu: bool) -> torch.Tensor:
    """``group_norm_fwd_f32`` / ``group_norm_fwd_bf16``: y of the forward
    on the card, in x's dtype, one launch at :func:`gn_tiling`'s tiling."""
    B, N, C = x3.shape
    suffix = _check_cuda((x3, gamma, beta), "group_norm_fwd", C)
    y = torch.empty_like(x3)
    t = _tiling((x3, y), groups, backward=False)
    _LIB.launch(f"group_norm_fwd_{suffix}", x3, gamma, beta, y, B, N, C,
                groups, t.ct, t.vec, t.threads, t.cluster, t.cached,
                int(relu))
    _LIB.count("group_norm_fwd")
    return y


def group_norm_bwd_cuda(x3: torch.Tensor, dy: torch.Tensor,
                        gamma: torch.Tensor, beta: torch.Tensor, groups: int,
                        relu: bool) -> tuple:
    """``group_norm_bwd_f32`` / ``group_norm_bwd_bf16``: ``dx, dgamma,
    dbeta`` on the card in the inputs' dtype (the same outputs as
    :func:`group_norm_bwd_plain`), two launches. Allocates the one f32
    buffer the kernels share: the per-(sample, channel) sums of dy and of
    dy * xhat, ``[2, B, C]``, summed over samples in sample order."""
    B, N, C = x3.shape
    if tuple(dy.shape) != (B, N, C):
        raise ValueError(f"dy must be x's shape {(B, N, C)}, got "
                         f"{tuple(dy.shape)}")
    suffix = _check_cuda((x3, dy, gamma, beta), "group_norm_bwd", C)
    dx = torch.empty_like(x3)
    t = _tiling((x3, dy, dx), groups, backward=True)
    part = torch.empty((2, B, C), dtype=torch.float32, device=x3.device)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(beta)
    _LIB.launch(f"group_norm_bwd_{suffix}", x3, dy, gamma, beta, dx, dgamma,
                dbeta, part, B, N, C, groups, t.ct, t.vec, t.threads,
                t.cluster, t.cached, int(relu))
    _LIB.count("group_norm_bwd")
    return dx, dgamma, dbeta


class GroupNormFn(torch.autograd.Function):
    """The differentiable GroupNorm on ``x3 [B, N, C]`` (the counterpart of
    the JAX package's ``custom_vjp``): the forward saves ``(x3, gamma,
    beta)`` and nothing else; ``backward`` recomputes the statistics.
    CUDA tensors go to the kernels, CPU tensors to the plain twins."""

    @staticmethod
    def forward(ctx, x3, gamma, beta, groups, relu):
        ctx.groups, ctx.relu = groups, relu
        ctx.save_for_backward(x3, gamma, beta)
        if build.on_cpu((x3, gamma, beta)):
            return group_norm_fwd_plain(x3, gamma, beta, groups, relu)
        return group_norm_fwd_cuda(x3, gamma, beta, groups, relu)

    @staticmethod
    def backward(ctx, dy):
        x3, gamma, beta = ctx.saved_tensors
        dy = dy.contiguous()
        if build.on_cpu((x3, dy, gamma, beta)):
            grads = group_norm_bwd_plain(x3, dy, gamma, beta, ctx.groups,
                                         ctx.relu)
        else:
            grads = group_norm_bwd_cuda(x3, dy, gamma, beta, ctx.groups,
                                        ctx.relu)
        return (*grads, None, None)


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               groups: int, relu: bool = False) -> torch.Tensor:
    """Fused GroupNorm (+ optional ReLU) over ``x [B, spatial..., C]``
    (NHWC, or already ``[B, N, C]``), ``gamma``/``beta`` per channel.

    Differentiable: when autograd needs a gradient of any input, the call
    goes through :class:`GroupNormFn`. CPU tensors take the plain twins.
    CUDA tensors must be contiguous, on one device and all float32 or all
    bfloat16; anything else raises, and so does a failed build or
    launch."""
    shape = x.shape
    C = shape[-1]
    if C % groups:
        raise ValueError(f"C={C} not divisible by groups={groups}")
    if not build.on_cpu((x, gamma, beta)):
        _check_cuda((x, gamma, beta), "group_norm", C)  # before any copy
    x3 = x.reshape(shape[0], -1, C)
    tensors = (x3, gamma, beta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        y = GroupNormFn.apply(x3, gamma, beta, groups, relu)
    elif build.on_cpu(tensors):
        y = group_norm_fwd_plain(x3, gamma, beta, groups, relu)
    else:
        y = group_norm_fwd_cuda(x3, gamma, beta, groups, relu)
    return y.reshape(shape)
