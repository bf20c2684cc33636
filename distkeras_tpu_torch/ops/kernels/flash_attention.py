"""Causal flash attention, forward and backward: the CUDA kernels, their
wrappers and their plain PyTorch twins (the port's counterpart of
``distkeras_tpu/ops/pallas/flash_attention.py``).

:func:`flash_attention` takes ``q, k, v [B, L, H, D]`` (the model's layout,
q pre-scaled by ``1/sqrt(D)``) and returns ``[B, L, H, D]`` in q's dtype,
float32 or bfloat16. The kernels read that strided layout directly (a row
of a (batch, head) slice is D contiguous elements), so nothing is
transposed on the way in or out (an f32 caller's one bf16 copy of its
inputs aside); the logsumexp and delta rows are
``[B*H, L]`` float32, where the TPU kernel keeps ``[BH, nq, 1, block_q]``
for its tiling.

* Without a gradient it runs the forward alone: ``csrc/flash_attn.cu``'s
  ``flash_fwd_*`` on CUDA tensors (the design note is in that file). The
  kernels load by TMA, which cannot convert, so an f32 caller's q, k, v
  are rounded to bf16 once first (nearest even: the rounding point of the
  TPU kernels); out is written in the caller's dtype.
* With one, it goes through :class:`FlashAttentionFn`, the counterpart of
  the JAX package's ``custom_vjp``: the same forward, saving the bf16 q,
  k, v it read (an f32 caller's one copy), out and lse; the backward
  computes ``delta = sum(dO * O)`` in f32 in torch (XLA's, not a kernel,
  in the JAX package), rounds dO to bf16, then launches dQ, then dK/dV on
  the saved copies, and returns the gradients in the caller's dtype.

Numerics are the TPU kernels': q, k, v, dO and p are rounded to bf16
before each product, products accumulate in f32, and ds is rounded to
bf16 before it multiplies K or Q. Each kernel has a plain twin here
(:func:`flash_fwd_plain`, :func:`flash_dq_plain`, :func:`flash_dkv_plain`)
with the same rounding points. The forward's result depends on its k-tile
(the online softmax rounds ``p`` to bf16 against the running max of the
tiles seen so far): the twin's ``block_k`` defaults to the kernel's 64 and
can be set to the JAX kernel's own to compare the two arithmetics.

A wrapper takes its twin only for tensors that lie on the CPU; on CUDA
tensors it launches its kernel or raises. Any ``L >= 1`` works (the kernels
mask their ragged edge). On the CPU any head dim ``D`` works, as in the
JAX package. The kernels take a multiple of 16 up to 256
(:func:`check_head_dim`, their contract), each at the tile width
:func:`padded_head_dim` (32, 64, 128 or 256; TMA fills zeros past D); the
CUDA wrappers zero-pad q, k, v and dO along D to the next multiple of 16
(:func:`kernel_head_dim`) and slice out and the gradients back. Zero
columns change no score (q is pre-scaled by the caller, so the scale does
not see the padding) and give zero output columns, so a padded call
computes the unpadded function; at D = 16, 32, ..., 256 nothing is copied.
``D > 256`` raises on CUDA: the JAX kernel's D axis is one whole block of
any width, and 256 is the widest tile the port's kernels keep in shared
memory (``csrc/flash_attn.cu`` checks at build time that each kernel's
block fits the 227 KB it may have; :func:`shared_bytes` reads what a
block asks for). The JAX wrapper's ``block_size``/``block_k``
divisibility rule is a TPU tiling constraint and has no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from distkeras_tpu_torch.ops.kernels import build

#: the kernels' query-row and key tile (and the twins' default k-tile).
BLOCK = 64
#: the running max's start and the masked score (``_NEG`` of the TPU kernel).
NEG = -1e30
#: the widest head dim the kernels take (their widest tile, ``DP = 256``).
MAX_HEAD_DIM = 256

#: the C entry points -> (source, argtypes), and the launches so far in
#: this process by kernel: ``flash_fwd``, ``flash_dq`` and ``flash_dkv``,
#: one per wrapper call whatever the dtype.
_P, _I = build.PTR, build.INT
_LIB = build.KernelLib({
    **{f"flash_fwd_{s}": ("flash_attn", [_P] * 5 + [_I] * 4 + [_P])
       for s in build.SUFFIXES.values()},
    **{f"flash_dq_{s}": ("flash_attn", [_P] * 7 + [_I] * 4 + [_P])
       for s in build.SUFFIXES.values()},
    **{f"flash_dkv_{s}": ("flash_attn", [_P] * 8 + [_I] * 4 + [_P])
       for s in build.SUFFIXES.values()},
}, ("flash_fwd", "flash_dq", "flash_dkv"))
#: the shared-memory query: ints in, bytes out (nothing launches; not
#: counted).
_QUERY = build.KernelLib({"flash_shared_bytes": ("flash_attn", [_I] * 2)},
                         ())


def reset_launches() -> None:
    """Set the three flash kernels' launch counts to 0."""
    _LIB.reset()


def launch_counts(by_entry: bool = False) -> dict:
    """``{kernel name: launches}`` for ``flash_fwd``, ``flash_dq`` and
    ``flash_dkv``, or with ``by_entry`` the calls of each C entry point
    (``flash_fwd_bf16``, ...)."""
    return _LIB.entry_counts() if by_entry else _LIB.counts()


def warmup_counts() -> dict:
    """The launches of :func:`launch_counts` that the warm-up rounds before
    a CUDA graph capture made (``parallel/program.py``)."""
    return _LIB.warmup_counts()


def check_head_dim(D: int) -> None:
    """The kernels take a head dim that is a multiple of 16, at most 256
    (one bf16 k-step of the tensor cores' product; the widest tile a block
    keeps in shared memory, and the widest N of ``wgmma``)."""
    if D % 16 or not 16 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash attention takes a head dim that is a "
                         f"multiple of 16 in [16, {MAX_HEAD_DIM}]; got {D}")


def kernel_head_dim(D: int) -> int:
    """The head dim a CUDA call at ``D`` runs the kernels at: ``D`` rounded
    up to a multiple of 16. Past 256 (or below 1) :func:`check_head_dim`'s
    ``ValueError``: no kernel keeps a wider tile."""
    dk = max(16, -(-D // 16) * 16)
    if D < 1 or dk > MAX_HEAD_DIM:
        check_head_dim(D)
    return dk


def pad_head_dim(*tensors) -> tuple:
    """``[B, L, H, D]`` tensors zero-padded along D to
    :func:`kernel_head_dim` (as they are where D needs no padding)."""
    D = tensors[0].shape[3]
    dk = kernel_head_dim(D)
    if dk == D:
        return tensors
    return tuple(torch.nn.functional.pad(t, (0, dk - D)) for t in tensors)


def _unpad(t: torch.Tensor, D: int) -> torch.Tensor:
    return t if t.shape[3] == D else t[..., :D].contiguous()


def padded_head_dim(D: int) -> int:
    """The head dim a kernel tile holds (zeros past ``D``): 32, 64, 128 or
    256."""
    return 32 if D <= 32 else 64 if D <= 64 else 128 if D <= 128 else 256


def shared_bytes(kernel: str, D: int) -> int:
    """The dynamic shared memory a block of ``kernel`` (``"fwd"``, ``"dq"``
    or ``"dkv"``) asks for at head dim ``D``, as ``csrc/flash_attn.cu``
    computes it for the launch (``fwd_smem``, ``dq_smem``, ``dkv_smem``).
    Builds the kernels if needed; a question to the card's library, so it
    needs ``nvcc`` and raises without one."""
    n = _QUERY.query("flash_shared_bytes", ("fwd", "dq", "dkv").index(kernel),
                     padded_head_dim(kernel_head_dim(D)))
    if n < 0:
        raise RuntimeError(f"flash_shared_bytes refused {kernel} at D = {D}")
    return n


def tma_geometry(B: int, L: int, H: int, D: int) -> dict:
    """The tensor-map geometry of the kernels' TMA loads over one
    ``[B, L, H, D]`` bf16 tensor, which the wrapper passes to the C entry
    points (``csrc/flash_attn.cu`` checks it against the kernel it
    launches and encodes the maps from it):

    * ``dims``: ``(D, H, L, B)``, innermost first;
    * ``strides``: the byte strides of dims 1-3, ``2D``, ``2HD``, ``2LHD``
      (TMA takes multiples of 16 bytes; D is a multiple of 16);
    * ``box``: ``(columns, 1, rows, 1)``: a box row is one swizzle span, so
      ``columns`` is ``min(DP, 64)`` bf16 (``DP`` the padded head dim) and a
      tile of ``DP = 128`` takes ``boxes = 2`` column boxes, ``DP = 256``
      four; ``rows`` is the dK/dV kernel's q-tile, 64, or 32 at ``DP >=
      128`` (the other kernels' 64-row tiles take two such boxes);
    * ``swizzle``: the span in bytes, 128, or 64 at ``DP = 32``: the
      shared-memory layouts that ``wgmma``'s descriptors read.

    TMA fills zeros past ``D`` (up to ``DP``) and past ``L``."""
    check_head_dim(D)
    dp = padded_head_dim(D)
    cols = min(dp, 64)
    return {"dims": (D, H, L, B), "strides": (2 * D, 2 * H * D, 2 * L * H * D),
            "box": (cols, 1, 32 if dp >= 128 else 64, 1),
            "swizzle": 2 * cols, "boxes": dp // cols, "padded": dp}


def _geometry_arg(geometry: dict):
    """The geometry as the twelve int64 the C entry points read."""
    return (ctypes.c_longlong * 12)(*geometry["dims"], *geometry["strides"],
                                    *geometry["box"], geometry["swizzle"])


def bf16_operands(*tensors) -> tuple:
    """q, k, v (and dO) as the kernels read them: bf16, an f32 caller's
    rounded once (nearest even, the TPU kernel's ``.astype(bfloat16)``), so
    that the forward, dQ and dK/dV can share the copies; bf16 tensors as
    they are."""
    if tensors[0].dtype == torch.bfloat16:
        return tensors
    return tuple(t.to(torch.bfloat16) for t in tensors)


def _bf16_bhld(x: torch.Tensor) -> torch.Tensor:
    """``[B, L, H, D]`` -> ``[B*H, L, D]`` f32, rounded to bf16 first (the
    kernels' and the TPU kernel's ``.astype(bfloat16)``)."""
    B, L, H, D = x.shape
    return (x.to(torch.bfloat16).to(torch.float32).permute(0, 2, 1, 3)
            .reshape(B * H, L, D))


def _to_blhd(x: torch.Tensor, B: int, H: int, dtype) -> torch.Tensor:
    BH, L, D = x.shape
    return x.reshape(B, H, L, D).permute(0, 2, 1, 3).to(dtype).contiguous()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_k: int = BLOCK, tiles: list | None = None) -> tuple:
    """The forward in plain PyTorch: ``(out [B, L, H, D] in q's dtype,
    lse [B*H, L] f32)``, the TPU ``_fwd_kernel``'s arithmetic with k-tiles
    of ``block_k`` keys. Each row visits the k-tiles from the first to the
    one that holds its diagonal, in order, as the kernel's block does; the
    rows that need a k-tile are updated together (a row's earlier tiles
    leave it unchanged by a fully masked one, so skipping those is exact).
    The CPU path of :func:`flash_attention` and the reference the kernel is
    held against.

    With a list ``tiles``, each k-tile appends ``(j0, p, m)``: the f32 p
    before its bf16 rounding, ``[B*H, L - j0, keys]`` for the rows from
    the tile's first key ``j0`` on (0 where masked), and the running max
    ``[B*H, L - j0]`` it was taken against (what
    :func:`~distkeras_tpu_torch.ops.kernels.flash_flips.forward_flips`
    reads)."""
    B, L, H, D = q.shape
    qb, kb, vb = (_bf16_bhld(x) for x in (q, k, v))
    BH = qb.shape[0]
    m = torch.full((BH, L), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((BH, L), dtype=torch.float32, device=q.device)
    acc = torch.zeros((BH, L, D), dtype=torch.float32, device=q.device)
    rows = torch.arange(L, device=q.device)
    for j0 in range(0, L, block_k):
        j1 = min(j0 + block_k, L)
        s = torch.matmul(qb[:, j0:], kb[:, j0:j1].transpose(1, 2))
        mask = rows[j0:j1][None, :] <= rows[j0:][:, None]    # key <= query
        s = torch.where(mask, s, NEG)
        m_old = m[:, j0:]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m_old - m_new)
        l[:, j0:] = l[:, j0:] * corr + p.sum(dim=-1)
        acc[:, j0:] = acc[:, j0:] * corr[..., None] + torch.matmul(
            _bf16(p), vb[:, j0:j1])
        m[:, j0:] = m_new
        if tiles is not None:
            tiles.append((j0, p, m_new))
    out = _to_blhd(acc / l[..., None], B, H, q.dtype)
    return out, m + torch.log(l)


def _chunks(BH: int, L: int):
    """Slices of the ``B*H`` axis whose dense ``[n, L, L]`` f32 scores stay
    near 256 MB, so the backward twins run at full width on the card."""
    n = max(1, (1 << 26) // (L * L))
    return [slice(i, min(i + n, BH)) for i in range(0, BH, n)]


def _probs(qb, kb, lse):
    """``p = exp(s - lse)`` with ``s = q k^T``, causally masked (the
    masked scores never reach the exponent's result)."""
    L = qb.shape[1]
    s = torch.matmul(qb, kb.transpose(1, 2))
    rows = torch.arange(L, device=qb.device)
    mask = rows[None, :] <= rows[:, None]
    return torch.where(mask, torch.exp(s - lse[..., None]), 0.0)


def flash_dq_plain(q, k, v, do, lse, delta) -> torch.Tensor:
    """dq in plain PyTorch, the TPU ``_dq_kernel``'s arithmetic: ``p =
    exp(s - lse)`` (masked), ``dp = dO V^T``, ``ds = bf16(p * (dp -
    delta))``, ``dq = ds K`` in f32; returned in q's dtype."""
    B, L, H, D = q.shape
    qb, kb, vb, dob = (_bf16_bhld(x) for x in (q, k, v, do))
    dq = torch.empty_like(qb)
    for c in _chunks(B * H, L):
        p = _probs(qb[c], kb[c], lse[c])
        dp = torch.matmul(dob[c], vb[c].transpose(1, 2))
        ds = _bf16(p * (dp - delta[c][..., None]))
        dq[c] = torch.matmul(ds, kb[c])
    return _to_blhd(dq, B, H, q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta) -> tuple:
    """dk and dv in plain PyTorch, the TPU ``_dkv_kernel``'s arithmetic:
    ``dv = bf16(p)^T dO``, ``dk = ds^T Q`` with ``ds`` as in
    :func:`flash_dq_plain`; returned in k's and v's dtypes."""
    B, L, H, D = q.shape
    qb, kb, vb, dob = (_bf16_bhld(x) for x in (q, k, v, do))
    dk, dv = torch.empty_like(kb), torch.empty_like(vb)
    for c in _chunks(B * H, L):
        p = _probs(qb[c], kb[c], lse[c])
        dv[c] = torch.matmul(_bf16(p).transpose(1, 2), dob[c])
        dp = torch.matmul(dob[c], vb[c].transpose(1, 2))
        ds = _bf16(p * (dp - delta[c][..., None]))
        dk[c] = torch.matmul(ds.transpose(1, 2), qb[c])
    return _to_blhd(dk, B, H, k.dtype), _to_blhd(dv, B, H, v.dtype)


def _check_cuda(tensors, rows, what: str) -> str:
    """One CUDA device, one dtype of float32 or bfloat16, ``[B, L, H, D]``
    contiguous and 16-byte aligned (the kernels load 16 bytes at a time),
    a head dim the kernels take once padded; ``rows`` (lse, delta) f32
    ``[B*H, L]``. Returns the entry points' dtype suffix."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in (*tensors, *rows)):
        raise ValueError(
            f"{what} needs all of its tensors on one CUDA device (or all on "
            f"the CPU); got {[str(t.device) for t in (*tensors, *rows)]}")
    dtype = tensors[0].dtype
    if dtype not in build.SUFFIXES or any(t.dtype != dtype for t in tensors):
        raise TypeError(
            f"the CUDA flash kernels take float32 or bfloat16, one dtype for "
            f"all of q, k, v (and dO); {what} got "
            f"{[str(t.dtype) for t in tensors]}")
    shape = tuple(tensors[0].shape)
    if len(shape) != 4 or any(tuple(t.shape) != shape for t in tensors):
        raise ValueError(f"{what} takes [B, L, H, D] tensors of one shape; "
                         f"got {[tuple(t.shape) for t in tensors]}")
    kernel_head_dim(shape[3])
    B, L, H, _ = shape
    for t in rows:
        if (t.dtype != torch.float32 or tuple(t.shape) != (B * H, L)
                or not t.is_contiguous()):
            raise ValueError(f"{what}: lse and delta must be contiguous "
                             f"float32 [B*H={B * H}, L={L}]")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"the CUDA flash kernels need contiguous, 16-byte "
                         f"aligned tensors ({what})")
    return build.SUFFIXES[dtype]


def _out_dtype(dtype, q) -> torch.dtype:
    """The outputs' dtype: ``dtype``, or q's where it is None; float32 or
    bfloat16."""
    dtype = q.dtype if dtype is None else dtype
    if dtype not in build.SUFFIXES:
        raise TypeError(f"the CUDA flash kernels write float32 or bfloat16; "
                        f"asked for {dtype}")
    return dtype


def flash_fwd_cuda(q, k, v, dtype=None) -> tuple:
    """``flash_fwd_*``: ``(out, lse)`` of the forward on the card, out in
    ``dtype`` (default q's). f32 inputs are rounded to bf16 once here
    (:func:`bf16_operands`); bf16 inputs are read as they are, so an f32
    caller's copies with ``dtype=torch.float32`` give its result. A head
    dim the kernels do not take runs zero-padded (:func:`pad_head_dim`)
    and out comes back at D."""
    _check_cuda((q, k, v), (), "flash_fwd")
    dtype = _out_dtype(dtype, q)
    B, L, H, D = q.shape
    ops = pad_head_dim(*bf16_operands(q, k, v))
    dk = ops[0].shape[3]
    out = torch.empty((B, L, H, dk), dtype=dtype, device=q.device)
    lse = torch.empty((B * H, L), dtype=torch.float32, device=q.device)
    geometry = _geometry_arg(tma_geometry(B, L, H, dk))
    _LIB.launch(f"flash_fwd_{build.SUFFIXES[dtype]}", *ops, out, lse,
                B, L, H, dk, ctypes.addressof(geometry))
    _LIB.count("flash_fwd")
    return _unpad(out, D), lse


def _launch_bwd(kernel: str, ops: tuple, lse, delta, dtype, D: int) -> tuple:
    """Launch ``flash_dq_*`` or ``flash_dkv_*`` on the bf16 operands
    (:func:`bf16_operands`, padded by :func:`pad_head_dim`), writing
    ``dtype`` (the suffix's): returns dq, or (dk, dv), at head dim D."""
    q = ops[0]
    B, L, H, dk = q.shape
    outs = tuple(torch.empty(q.shape, dtype=dtype, device=q.device)
                 for _ in range(1 if kernel == "flash_dq" else 2))
    geometry = _geometry_arg(tma_geometry(B, L, H, dk))
    _LIB.launch(f"{kernel}_{build.SUFFIXES[dtype]}", *ops, lse, delta, *outs,
                B, L, H, dk, ctypes.addressof(geometry))
    _LIB.count(kernel)
    return tuple(_unpad(t, D) for t in outs)


def _bwd_operands(q, k, v, do) -> tuple:
    return pad_head_dim(*bf16_operands(q, k, v, do))


def flash_dq_cuda(q, k, v, do, lse, delta) -> torch.Tensor:
    """``flash_dq_*``: dq on the card (the output of
    :func:`flash_dq_plain`), in q's dtype."""
    _check_cuda((q, k, v, do), (lse, delta), "flash_dq")
    return _launch_bwd("flash_dq", _bwd_operands(q, k, v, do), lse, delta,
                       q.dtype, q.shape[3])[0]


def flash_dkv_cuda(q, k, v, do, lse, delta) -> tuple:
    """``flash_dkv_*``: dk and dv on the card (the outputs of
    :func:`flash_dkv_plain`), in q's dtype."""
    _check_cuda((q, k, v, do), (lse, delta), "flash_dkv")
    return _launch_bwd("flash_dkv", _bwd_operands(q, k, v, do), lse, delta,
                       q.dtype, q.shape[3])


def flash_bwd_cuda(q, k, v, do, lse, delta, dtype=None) -> tuple:
    """dq, dk and dv on the card as the backward runs them: the inputs
    checked, rounded to bf16 once (an f32 caller's) and padded along D
    where the kernels need it, the copies shared by ``flash_dq_*`` and then
    ``flash_dkv_*``; in ``dtype`` (default q's), at q's head dim."""
    _check_cuda((q, k, v, do), (lse, delta), "flash_bwd")
    dtype = _out_dtype(dtype, q)
    ops, D = _bwd_operands(q, k, v, do), q.shape[3]
    dq, = _launch_bwd("flash_dq", ops, lse, delta, dtype, D)
    return (dq, *_launch_bwd("flash_dkv", ops, lse, delta, dtype, D))


def attention_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``delta = sum(dO * O)`` over the head dim in f32, as ``[B*H, L]``
    (XLA's in the JAX package, not a kernel)."""
    B, L, H, _ = out.shape
    return ((do.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)
            .permute(0, 2, 1).reshape(B * H, L).contiguous())


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable causal attention on ``q, k, v [B, L, H, D]`` (the
    counterpart of the JAX package's ``custom_vjp``): the forward saves
    the bf16 q, k, v the kernels read (an f32 caller's rounded once, see
    :func:`bf16_operands`), out and lse, and the caller's dtype; the
    backward rounds dO alone and launches dQ, then dK/dV, on the saved
    copies, writing the caller's dtype. CUDA tensors go to the kernels, CPU
    tensors to the plain twins (which round at the same points, so the
    copies give them their f32 results bit for bit). Everything saved and
    returned is at the caller's head dim: the CUDA wrappers pad inside
    their calls, so autograd never sees the padding."""

    @staticmethod
    def forward(ctx, q, k, v):
        ops = bf16_operands(q, k, v)
        if build.on_cpu((q, k, v)):
            out, lse = flash_fwd_plain(q, k, v)
        else:
            out, lse = flash_fwd_cuda(*ops, dtype=q.dtype)
        ctx.dtype = q.dtype
        ctx.save_for_backward(*ops, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(ctx.dtype).contiguous()
        delta = attention_delta(do, out)
        if build.on_cpu((q, k, v, do)):
            q, k, v = (t.to(ctx.dtype) for t in (q, k, v))
            dq = flash_dq_plain(q, k, v, do, lse, delta)
            dk, dv = flash_dkv_plain(q, k, v, do, lse, delta)
        else:
            dq, dk, dv = flash_bwd_cuda(q, k, v, do.to(q.dtype), lse, delta,
                                        dtype=ctx.dtype)
        return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal flash attention on ``q, k, v [B, L, H, D]``, q pre-scaled by
    ``1/sqrt(D)``; returns ``[B, L, H, D]`` in q's dtype.

    Differentiable: when autograd needs a gradient of any input, the call
    goes through :class:`FlashAttentionFn`. CPU tensors take the plain
    twins at any head dim. CUDA tensors must be float32 or bfloat16 (one
    dtype), on one device, with a head dim of at most 256 (zero-padded to
    the kernels' width); anything else raises, and so does a failed build
    or launch."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention takes q, k, v [B, L, H, D] of one "
                         f"shape; got {[tuple(t.shape) for t in (q, k, v)]}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v)
    if build.on_cpu((q, k, v)):
        return flash_fwd_plain(q, k, v)[0]
    return flash_fwd_cuda(q, k, v)[0]
