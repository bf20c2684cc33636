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

import torch

from distkeras_tpu_torch.ops.kernels import build
from distkeras_tpu_torch.ops.precision import widen

EPS = 1e-6

#: the C entry points -> (source, argtypes), and the launches so far in
#: this process by kernel: ``group_norm_fwd`` (``group_norm_fwd_f32``,
#: ``group_norm_fwd_bf16``) and ``group_norm_bwd`` (``group_norm_bwd_*``),
#: one per wrapper call.
_P, _I = build.PTR, build.INT
_LIB = build.KernelLib({
    **{f"group_norm_fwd_{s}": ("groupnorm", [_P] * 7 + [_I] * 6)
       for s in build.SUFFIXES.values()},
    **{f"group_norm_bwd_{s}": ("groupnorm", [_P] * 11 + [_I] * 6)
       for s in build.SUFFIXES.values()},
}, ("group_norm_fwd", "group_norm_bwd"))

#: elements of x one kernel block reads per row chunk: 32 per thread.
_CHUNK_ELEMS = 8192


def reset_launches() -> None:
    """Set both GroupNorm kernels' launch counts to 0."""
    _LIB.reset()


def launch_counts(by_entry: bool = False) -> dict:
    """``{kernel name: launches}`` for the two GroupNorm kernels, or with
    ``by_entry`` the calls of each C entry point
    (``group_norm_fwd_bf16``, ...)."""
    return _LIB.entry_counts() if by_entry else _LIB.counts()


def rows_per_chunk(N: int, C: int) -> int:
    """Rows of a ``[N, C]`` slab one kernel block covers: about
    ``_CHUNK_ELEMS`` elements of a tile at most 256 channels wide."""
    return min(N, max(1, _CHUNK_ELEMS // min(C, 256)))


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


def _scratch(x3: torch.Tensor, groups: int):
    B, N, C = x3.shape
    rows = rows_per_chunk(N, C)
    chunks = -(-N // rows)
    f32 = dict(dtype=torch.float32, device=x3.device)
    partial = torch.empty((2, B, chunks, C), **f32)
    persample = torch.empty((2, B, C), **f32)
    stats = torch.empty((2, B, groups), **f32)
    return rows, partial, persample, stats


def group_norm_fwd_cuda(x3: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, groups: int,
                        relu: bool) -> torch.Tensor:
    """``group_norm_fwd_f32`` / ``group_norm_fwd_bf16``: y of the forward
    on the card, in x's dtype."""
    B, N, C = x3.shape
    suffix = _check_cuda((x3, gamma, beta), "group_norm_fwd", C)
    rows, partial, persample, stats = _scratch(x3, groups)
    y = torch.empty_like(x3)
    _LIB.launch(f"group_norm_fwd_{suffix}", x3, gamma, beta, y, partial,
                persample, stats, B, N, C, groups, rows, int(relu))
    _LIB.count("group_norm_fwd")
    return y


def group_norm_bwd_cuda(x3: torch.Tensor, dy: torch.Tensor,
                        gamma: torch.Tensor, beta: torch.Tensor, groups: int,
                        relu: bool) -> tuple:
    """``group_norm_bwd_f32`` / ``group_norm_bwd_bf16``: ``dx, dgamma,
    dbeta`` on the card in the inputs' dtype (the same outputs as
    :func:`group_norm_bwd_plain`). Allocates the kernel's f32 scratch:
    per-chunk and per-sample partial sums, the statistics and the group
    coefficients."""
    B, N, C = x3.shape
    if tuple(dy.shape) != (B, N, C):
        raise ValueError(f"dy must be x's shape {(B, N, C)}, got "
                         f"{tuple(dy.shape)}")
    suffix = _check_cuda((x3, dy, gamma, beta), "group_norm_bwd", C)
    rows, partial, persample, stats = _scratch(x3, groups)
    coeffs = torch.empty_like(stats)
    dx = torch.empty_like(x3)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(beta)
    _LIB.launch(f"group_norm_bwd_{suffix}", x3, dy, gamma, beta, dx, dgamma,
                dbeta, partial, persample, stats, coeffs, B, N, C, groups,
                rows, int(relu))
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
