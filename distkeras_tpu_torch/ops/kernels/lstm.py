"""Whole-sequence LSTM, forward and BPTT backward: the CUDA kernels, their
wrappers and their plain PyTorch twins (the port's counterpart of
``distkeras_tpu/ops/pallas/lstm.py``).

:func:`lstm_seq` takes ``x [B, T, E]`` and the packed ``(Wx [E, 4H],
Wh [H, 4H], b [4H])`` and returns ``hs [B, T, H]`` with h0 = c0 = 0.

* Without a gradient (``no_grad``, ``inference_mode``, or no input that
  requires one) it runs the plain forward: ``csrc/lstm_fwd.cu``'s
  ``lstm_fwd_f32`` or ``lstm_fwd_bf16`` on CUDA tensors (one launch for
  all T steps; the design note is in that file).
* With one, it goes through :class:`LSTMSeq`, the counterpart of the JAX
  package's ``custom_vjp``: the stash forward (``lstm_fwd_stash_*``, which
  also writes the residuals ``cs`` and ``gates``) and the BPTT backward
  (``csrc/lstm_bwd.cu``, ``lstm_bwd_*``).

float32 and bfloat16 take the same path; all four tensors of a call share
one dtype. In bf16 (the mixed-precision step) the TPU kernels' rounding
points hold, in the kernels and in the twins alike: products of bf16
values summed in f32, the h/c carry f32 with h rounded to bf16 before the
recurrent product, hs/cs/gates and dx stored in bf16; the backward rounds
dpre to bf16 for dx, the dh carry, dWx and dWh but sums db from the f32
dpre, and returns dWx, dWh, db as f32 sums rounded to bf16.

Each kernel has a plain twin here (:func:`lstm_seq_plain`,
:func:`lstm_fwd_stash_plain`, :func:`lstm_bwd_plain`). A wrapper takes its
twin only for tensors that lie on the CPU; on CUDA tensors it launches its
kernel or raises. Ragged batches are masked inside the kernels; nothing is
padded.

Gate math follows flax's ``OptimizedLSTMCell`` exactly (i,f,g,o order,
``c' = f*c + i*g``, ``h' = o*tanh(c')``); :func:`pack_lstm_params` turns
that cell's per-gate parameter tree into the packed layout, so both of the
JAX package's LSTM layouts serve through this one function.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.ops.kernels import build
from distkeras_tpu_torch.ops.precision import widen

GATES = ("i", "f", "g", "o")

#: the C entry points -> (source, argtypes), and the launches so far in
#: this process, one per wrapper call that launched, by kernel:
#: ``lstm_fwd`` (``lstm_fwd_f32``, ``lstm_fwd_bf16``), ``lstm_fwd_stash``
#: (``lstm_fwd_stash_*``) and ``lstm_bwd`` (``lstm_bwd_*``).
_P, _I = build.PTR, build.INT
_LIB = build.KernelLib({
    **{f"lstm_fwd_{s}": ("lstm_fwd", [_P] * 5 + [_I] * 4)
       for s in build.SUFFIXES.values()},
    **{f"lstm_fwd_stash_{s}": ("lstm_fwd", [_P] * 7 + [_I] * 4)
       for s in build.SUFFIXES.values()},
    **{f"lstm_bwd_{s}": ("lstm_bwd", [_P] * 13 + [_I] * 5)
       for s in build.SUFFIXES.values()},
}, ("lstm_fwd", "lstm_fwd_stash", "lstm_bwd"))


def reset_launches() -> None:
    """Set every LSTM kernel's launch count to 0."""
    _LIB.reset()


def launch_counts(by_entry: bool = False) -> dict:
    """``{kernel name: launches}`` for the three LSTM kernels, or with
    ``by_entry`` the calls of each C entry point (``lstm_bwd_bf16``, ...)."""
    return _LIB.entry_counts() if by_entry else _LIB.counts()


def _fwd_plain(wx, wh, b, x, stash: bool):
    """The forward in ``x``'s dtype, at the TPU kernel's rounding points:
    the products of the stored values summed in the wide dtype, the h/c
    carry wide, h rounded to Wh's dtype before the recurrent product, hs,
    cs and gates stored in x's dtype."""
    B, T, _E = x.shape
    H = wh.shape[0]
    dt = x.dtype
    wxw, whw, bw = widen(wx), widen(wh), widen(b)
    h = widen(x.new_zeros(B, H))
    c = torch.zeros_like(h)
    hs, cs, gates = [], [], []
    for t in range(T):
        pre = (widen(x[:, t]) @ wxw + widen(h.to(wh.dtype)) @ whw) + bw
        i = torch.sigmoid(pre[:, 0 * H:1 * H])
        f = torch.sigmoid(pre[:, 1 * H:2 * H])
        g = torch.tanh(pre[:, 2 * H:3 * H])
        o = torch.sigmoid(pre[:, 3 * H:4 * H])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h.to(dt))
        if stash:
            cs.append(c.to(dt))
            gates.append(torch.cat([i, f, g, o], dim=1).to(dt))
    if not stash:
        return torch.stack(hs, dim=1)
    return (torch.stack(hs, dim=1), torch.stack(cs, dim=1),
            torch.stack(gates, dim=1))


def lstm_seq_plain(wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: a loop over t. The CPU path of
    :func:`lstm_seq`, and the reference its kernel is held against."""
    return _fwd_plain(wx, wh, b, x, stash=False)


def lstm_fwd_stash_plain(wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
                         x: torch.Tensor) -> tuple:
    """The stash forward in plain PyTorch: ``hs, cs [B, T, H]`` and
    ``gates [B, T, 4H]``, the activated i, f, g, o concatenated along 4H
    (the JAX kernel's ``stash=True`` outputs, batch-major)."""
    return _fwd_plain(wx, wh, b, x, stash=True)


def lstm_bwd_plain(wx: torch.Tensor, wh: torch.Tensor, x: torch.Tensor,
                   hs: torch.Tensor, cs: torch.Tensor, gates: torch.Tensor,
                   dhs: torch.Tensor) -> tuple:
    """BPTT through :func:`lstm_fwd_stash_plain`'s residuals in plain
    PyTorch, the reverse-time math of the JAX package's ``_bwd_kernel``:
    returns ``dwx [E, 4H], dwh [H, 4H], db [4H], dx [B, T, E]``.

    In the wide dtype on the stored values, at the TPU kernel's rounding
    points: dpre rounded to the weights' dtype for dx, the dh carry, dWx
    and dWh, db summed from the unrounded dpre, dx stored in x's dtype and
    dWx, dWh, db in the weights' (a no-op in f32)."""
    B, T, E = x.shape
    H = wh.shape[0]
    wdt = wx.dtype
    wxw, whw = widen(wx), widen(wh)
    dh = widen(x.new_zeros(B, H))
    dc = torch.zeros_like(dh)
    dpres, dpres_c, dxs = [None] * T, [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        i, f, g, o = widen(gates[:, t]).split(H, dim=1)
        c_t = widen(cs[:, t])
        c_prev = widen(cs[:, t - 1]) if t > 0 else torch.zeros_like(c_t)
        dh = dh + widen(dhs[:, t])
        tanh_c = torch.tanh(c_t)
        do = dh * tanh_c
        dc = dh * o * (1.0 - tanh_c * tanh_c) + dc
        dpre = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                          dc * i * (1.0 - g * g), do * o * (1.0 - o)], dim=1)
        dc = dc * f
        dpre_c = widen(dpre.to(wdt))
        dxs[t] = (dpre_c @ wxw.t()).to(x.dtype)
        dh = dpre_c @ whw.t()
        dpres[t], dpres_c[t] = dpre, dpre_c
    dpre = torch.stack(dpres, dim=1).reshape(B * T, 4 * H)
    dpre_c = torch.stack(dpres_c, dim=1).reshape(B * T, 4 * H)
    h_prev = torch.cat([hs.new_zeros(B, 1, H), hs[:, :-1]], dim=1)
    dwx = widen(x.reshape(B * T, E)).t() @ dpre_c
    dwh = widen(h_prev.reshape(B * T, H)).t() @ dpre_c
    return (dwx.to(wdt), dwh.to(wdt), dpre.sum(dim=0).to(wdt),
            torch.stack(dxs, dim=1))


def _check(wx, wh, b, x) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, E], got shape {tuple(x.shape)}")
    _B, _T, E = x.shape
    H = wh.shape[0] if wh.dim() == 2 else -1
    if (tuple(wx.shape) != (E, 4 * H) or tuple(wh.shape) != (H, 4 * H)
            or tuple(b.shape) != (4 * H,)):
        raise ValueError(
            f"packed LSTM params must be Wx [E, 4H], Wh [H, 4H], b [4H] for "
            f"x [B, T, E={E}]; got Wx {tuple(wx.shape)}, Wh "
            f"{tuple(wh.shape)}, b {tuple(b.shape)}")


def _check_cuda(tensors, what: str) -> str:
    """The kernels take contiguous tensors of one dtype, float32 or
    bfloat16, on one CUDA device, and 4H <= 512 (``tensors[1]`` is Wh
    [H, 4H]); anything else raises (nothing falls back to the plain path).
    Returns the entry points' dtype suffix."""
    suffix = build.check_cuda(tensors, what, "LSTM")
    H = tensors[1].shape[0]
    if 4 * H > 512:
        raise ValueError(
            f"the CUDA LSTM kernels take 4H <= 512 (one thread per gate "
            f"column), got H={H}")
    return suffix


def lstm_fwd_cuda(wx, wh, b, x) -> torch.Tensor:
    """``lstm_fwd_f32`` / ``lstm_fwd_bf16``: hs of the forward on the card,
    in x's dtype."""
    suffix = _check_cuda((x, wh, wx, b), "lstm_fwd")
    B, T, E = x.shape
    H = wh.shape[0]
    hs = torch.empty((B, T, H), dtype=x.dtype, device=x.device)
    _LIB.launch(f"lstm_fwd_{suffix}", x, wx, wh, b, hs, B, T, E, H)
    _LIB.count("lstm_fwd")
    return hs


def lstm_fwd_stash_cuda(wx, wh, b, x) -> tuple:
    """``lstm_fwd_stash_f32`` / ``lstm_fwd_stash_bf16``: ``hs, cs, gates``
    of the forward on the card, in x's dtype (the same outputs as
    :func:`lstm_fwd_stash_plain`)."""
    suffix = _check_cuda((x, wh, wx, b), "lstm_fwd_stash")
    B, T, E = x.shape
    H = wh.shape[0]
    hs = torch.empty((B, T, H), dtype=x.dtype, device=x.device)
    cs = torch.empty_like(hs)
    gates = torch.empty((B, T, 4 * H), dtype=x.dtype, device=x.device)
    _LIB.launch(f"lstm_fwd_stash_{suffix}", x, wx, wh, b, hs, cs, gates, B,
                T, E, H)
    _LIB.count("lstm_fwd_stash")
    return hs, cs, gates


#: reduction chunks of the weight-gradient kernel: enough 64x64 output
#: tiles times chunks to fill the card's 132 SMs several times over, each
#: chunk at least 256 rows of the B*T reduction.
_MAX_SPLITS = 64


def bwd_splits(rows: int) -> int:
    """Chunks the B*T rows of the weight-gradient reduction are cut into."""
    return max(1, min(_MAX_SPLITS, rows // 256))


def lstm_bwd_cuda(wx, wh, x, hs, cs, gates, dhs) -> tuple:
    """``lstm_bwd_f32`` / ``lstm_bwd_bf16``: ``dwx, dwh, db, dx`` on the
    card in the inputs' dtype (the same outputs as :func:`lstm_bwd_plain`).
    Allocates the kernel's f32 scratch: the dpre workspace [B, T, 4H] and
    the weight-gradient partials."""
    suffix = _check_cuda((x, wh, wx, hs, cs, gates, dhs), "lstm_bwd")
    B, T, E = x.shape
    H = wh.shape[0]
    if (tuple(hs.shape) != (B, T, H) or tuple(cs.shape) != (B, T, H)
            or tuple(dhs.shape) != (B, T, H)
            or tuple(gates.shape) != (B, T, 4 * H)):
        raise ValueError(
            f"lstm_bwd residuals must be hs, cs, dhs [B, T, H] and gates "
            f"[B, T, 4H] for x {tuple(x.shape)}; got hs {tuple(hs.shape)}, cs "
            f"{tuple(cs.shape)}, dhs {tuple(dhs.shape)}, gates "
            f"{tuple(gates.shape)}")
    dev = x.device
    splits = bwd_splits(B * T)
    wxt = wx.t().contiguous()          # layout copies: coalesced reads
    wht = wh.t().contiguous()
    dx = torch.empty_like(x)
    dwx = torch.empty_like(wx)
    dwh = torch.empty_like(wh)
    db = torch.empty((4 * H,), dtype=wx.dtype, device=dev)
    dpre = torch.empty((B, T, 4 * H), dtype=torch.float32, device=dev)
    partial = torch.empty((splits, E + H + 1, 4 * H), dtype=torch.float32,
                          device=dev)
    _LIB.launch(f"lstm_bwd_{suffix}", dhs, x, hs, cs, gates, wxt, wht, dx,
                dwx, dwh, db, dpre, partial, B, T, E, H, splits)
    _LIB.count("lstm_bwd")
    return dwx, dwh, db, dx


class LSTMSeq(torch.autograd.Function):
    """The differentiable whole-sequence LSTM (the counterpart of the JAX
    package's ``custom_vjp`` around ``_lstm_tbe``): the stash forward saves
    ``(wx, wh, x, hs, cs, gates)``; ``backward`` runs BPTT and returns
    ``dwx, dwh, db, dx``. CUDA tensors go to the kernels, CPU tensors to the
    plain twins, so the CPU tests exercise the same wiring."""

    @staticmethod
    def forward(ctx, wx, wh, b, x):
        if build.on_cpu((wx, wh, b, x)):
            hs, cs, gates = lstm_fwd_stash_plain(wx, wh, b, x)
        else:
            hs, cs, gates = lstm_fwd_stash_cuda(wx, wh, b, x)
        ctx.save_for_backward(wx, wh, x, hs, cs, gates)
        ctx.b_dtype = b.dtype
        return hs

    @staticmethod
    def backward(ctx, dhs):
        wx, wh, x, hs, cs, gates = ctx.saved_tensors
        # The head reads hs[:, -1] only, so dhs is mostly zeros; autograd
        # may hand it over in any layout. Make it the kernel's.
        dhs = dhs.contiguous()
        if build.on_cpu((wx, wh, x, hs, cs, gates, dhs)):
            dwx, dwh, db, dx = lstm_bwd_plain(wx, wh, x, hs, cs, gates, dhs)
        else:
            dwx, dwh, db, dx = lstm_bwd_cuda(wx, wh, x, hs, cs, gates, dhs)
        return dwx, dwh, db.to(ctx.b_dtype), dx


def lstm_seq(wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Full-sequence LSTM: ``x [B, T, E] -> hs [B, T, H]`` (h0 = c0 = 0).

    Differentiable: when autograd needs a gradient of any input, the call
    goes through :class:`LSTMSeq` (stash forward, BPTT backward). Otherwise
    it runs the forward alone. CPU tensors take the plain twins. CUDA
    tensors must be contiguous, on one device and all float32 or all
    bfloat16; anything else raises, and so does a failed build or
    launch."""
    tensors = (wx, wh, b, x)
    _check(*tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return LSTMSeq.apply(wx, wh, b, x)
    if build.on_cpu(tensors):
        return lstm_seq_plain(wx, wh, b, x)
    return lstm_fwd_cuda(wx, wh, b, x)


def pack_lstm_params(cell_params) -> tuple:
    """flax ``OptimizedLSTMCell`` param tree (numpy arrays or tensors) ->
    packed (Wx [E,4H], Wh [H,4H], b [4H]) float32 tensors in i,f,g,o gate
    order (the layout :func:`lstm_seq` consumes)."""
    def t(a):
        if isinstance(a, torch.Tensor):
            return a.to(torch.float32)
        return torch.from_numpy(np.array(a, dtype=np.float32))

    wx = torch.cat([t(cell_params["i" + g]["kernel"]) for g in GATES], dim=1)
    wh = torch.cat([t(cell_params["h" + g]["kernel"]) for g in GATES], dim=1)
    b = torch.cat([t(cell_params["h" + g]["bias"]) for g in GATES], dim=0)
    return wx, wh, b


def orthogonal_gates(hidden: int, generator: torch.Generator) -> torch.Tensor:
    """Per-gate orthogonal init for the packed recurrent kernel [H, 4H]:
    four independent [H, H] orthogonal blocks (QR of a Gaussian draw, signs
    fixed by R's diagonal so the draw is uniform over the group)."""
    blocks = []
    for _ in GATES:
        a = torch.randn(hidden, hidden, generator=generator)
        q, r = torch.linalg.qr(a)
        blocks.append(q * torch.sign(torch.diagonal(r)))
    return torch.cat(blocks, dim=1)
