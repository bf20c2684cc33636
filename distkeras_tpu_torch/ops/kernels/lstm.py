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
  (``csrc/lstm_bwd.cu``: ``lstm_bwd_recurrent_*`` then
  ``lstm_bwd_wgrad_*``, one ``lstm_bwd`` launch).

float32 and bfloat16 take the same path; all four tensors of a call share
one dtype. In bf16 (the mixed-precision step) the TPU kernels' rounding
points hold, in the kernels and in the twins alike: products of bf16
values summed in f32, the h/c carry f32 with h rounded to bf16 before the
recurrent product, hs/cs/gates and dx stored in bf16; the backward rounds
dpre to bf16 for dx, the dh carry, dWx and dWh but sums db from the f32
dpre, and returns dWx, dWh, db as f32 sums rounded to bf16.

The two dtypes have two kernel bodies, each with its layouts as plain
functions here, held against the twins on the CPU.

* f32 (FFMA on the FP32 pipes, f32 sums). The forward is x . Wx + b for
  every (b, t) as one tile product (:func:`f32_xproj_layout`), then the
  recurrence on a thread-block cluster of C blocks over the hidden units
  of an R-row batch tile: each block's slice of Wh in its shared memory
  (:func:`f32_fwd_weight_layout`), h handed to every block through
  distributed shared memory behind mbarriers, no barrier a step, and a
  cluster barrier at the end so that no block exits while a peer may write
  into it. :func:`f32_tiling` picks R by batch and C as the first of R's
  order (:data:`F32_PREFERENCE`) that fits the threads and the shared
  memory. The backward's serial half (:func:`lstm_bwd_recurrent_plain` at
  R rows a tile: an f32 dpre workspace and f32 db partials a tile; the
  cluster's own split in :func:`lstm_bwd_recurrent_f32_layout_plain`)
  reads :func:`f32_rec_weight_layout`, and its parallel half is
  :func:`lstm_bwd_wgrad_plain`. The kernels take E a multiple of 4 and H
  a multiple of 8 that some built tiling fits at both R
  (:func:`check_f32_widths`): every H = 8, 16, ..., 128, and 80, 192 and
  256 among the wider ones.
* bf16 (tensor cores). The kernels take E and H multiples of 16 with H <=
  128 (:func:`check_bf16_widths`). The forward has two bodies, chosen by
  width alone (:func:`bf16_fwd_body`): where all of ``[Wx; Wh]`` fits a
  block's shared memory (config #4's E=64, H=128) the resident body keeps
  it there (:func:`fwd_weight_layout`); elsewhere (E > 128, or E=H=128,
  ``imdb_lstm()``'s default) the ``xw`` body computes x . Wx for every
  (b, t) first as a tensor-core tile product into an f32 scratch
  (:func:`xw_xproj_layout`) and keeps only Wh resident
  (:func:`xw_rec_weight_layout`). The backward is split into a serial half
  (:func:`lstm_bwd_recurrent_plain`: a bf16 dpre workspace and f32 db
  partials a 16-row tile) and a parallel half (:func:`lstm_bwd_wgrad_plain`,
  with h_{t-1} from :func:`wgrad_rows_plain`); neither holds x, so any E
  runs.

Widths a kernel refuses are zero-padded at the model boundary, in
:func:`lstm_seq` and :class:`LSTMSeq` on CUDA tensors
(:func:`padded_widths`, :func:`pad_lstm_inputs`, :func:`pad_dhs`,
:func:`unpad_grads`): E rises to a multiple of 4 (f32) or 16 (bf16), H to
the next width the dtype's kernels take. Padded weight rows and columns
and their biases are zero, so a padded unit keeps c = h = 0 and gets dpre
= 0, and the real units' values are those of the unpadded call; hs, dx,
dWx, dWh and db are sliced back after the call. A width that needs no
padding takes no copy. What stays refused, with a ``ValueError`` naming
the constraint and never the twin on the card: f32 H > 256 (H=512 fits no
portable cluster) and bf16 H > 128 (a warp owns at most 16 hidden units).

Each kernel has a plain twin here (:func:`lstm_seq_plain`,
:func:`lstm_fwd_stash_plain`, :func:`lstm_bwd_plain`). A wrapper takes its
twin only for tensors that lie on the CPU; on CUDA tensors it launches its
kernel or raises. Ragged batches are masked inside the kernels; the batch
is never padded.

Gate math follows flax's ``OptimizedLSTMCell`` exactly (i,f,g,o order,
``c' = f*c + i*g``, ``h' = o*tanh(c')``); :func:`pack_lstm_params` turns
that cell's per-gate parameter tree into the packed layout, so both of the
JAX package's LSTM layouts serve through this one function.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from distkeras_tpu_torch.ops.kernels import build
from distkeras_tpu_torch.ops.precision import widen

GATES = ("i", "f", "g", "o")

#: the C entry points -> (source, argtypes), and the launches so far in
#: this process, one per wrapper call that launched, by kernel:
#: ``lstm_fwd`` (``lstm_fwd_f32``, ``lstm_fwd_bf16``, ``lstm_fwd_xw_bf16``),
#: ``lstm_fwd_stash`` (``lstm_fwd_stash_*``) and ``lstm_bwd``
#: (``lstm_bwd_recurrent_*`` then ``lstm_bwd_wgrad_*``).
_P, _I = build.PTR, build.INT
_LIB = build.KernelLib({
    "lstm_fwd_f32": ("lstm_fwd", [_P] * 6 + [_I] * 6),
    "lstm_fwd_stash_f32": ("lstm_fwd", [_P] * 8 + [_I] * 6),
    "lstm_fwd_bf16": ("lstm_fwd", [_P] * 4 + [_I] * 4),
    "lstm_fwd_stash_bf16": ("lstm_fwd", [_P] * 6 + [_I] * 4),
    "lstm_fwd_xw_bf16": ("lstm_fwd", [_P] * 6 + [_I] * 4),
    "lstm_fwd_stash_xw_bf16": ("lstm_fwd", [_P] * 8 + [_I] * 4),
    "lstm_bwd_recurrent_f32": ("lstm_bwd", [_P] * 6 + [_I] * 5),
    "lstm_bwd_wgrad_f32": ("lstm_bwd", [_P] * 10 + [_I] * 6),
    "lstm_bwd_recurrent_bf16": ("lstm_bwd", [_P] * 6 + [_I] * 3),
    "lstm_bwd_wgrad_bf16": ("lstm_bwd", [_P] * 10 + [_I] * 5),
}, ("lstm_fwd", "lstm_fwd_stash", "lstm_bwd"))


def reset_launches() -> None:
    """Set every LSTM kernel's launch count to 0."""
    _LIB.reset()


def launch_counts(by_entry: bool = False) -> dict:
    """``{kernel name: launches}`` for the three LSTM kernels, or with
    ``by_entry`` the calls of each C entry point (``lstm_bwd_bf16``, ...)."""
    return _LIB.entry_counts() if by_entry else _LIB.counts()


def warmup_counts() -> dict:
    """The launches of :func:`launch_counts` that the warm-up rounds before
    a CUDA graph capture made (``parallel/program.py``)."""
    return _LIB.warmup_counts()


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
    bfloat16, on one CUDA device (``tensors[0]`` is x [B, T, E],
    ``tensors[1]`` Wh [H, 4H], ``tensors[2]`` Wx); f32 takes the widths of
    :func:`check_f32_widths` and reads x and Wx in 16-byte vectors, bf16
    the widths of :func:`check_bf16_widths`. Anything else raises (nothing
    falls back to the plain path or to the other body). Returns the entry
    points' dtype suffix."""
    suffix = build.check_cuda(tensors, what, "LSTM")
    E, H = tensors[0].shape[2], tensors[1].shape[0]
    if suffix == "bf16":
        check_bf16_widths(E, H, what)
    else:
        check_f32_widths(E, H, what)
        _check_aligned((tensors[0], tensors[2]), what)
    return suffix


def _check_aligned(tensors, what: str) -> None:
    """The f32 kernels read these tensors in 16-byte vectors."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: the f32 CUDA LSTM kernels need x, Wx and "
                         f"hs to start on a 16-byte boundary")


# -- the bf16 tensor-core kernels' layouts ---------------------------------

#: batch rows of a bf16 block (the mma.sync M), and the shared memory a
#: block may use on the card.
BF16_ROWS = 16
_MAX_SMEM = 232448
_PAD = 8  # bf16 of padding a shared-memory row


def fwd_smem_bytes(E: int, H: int) -> int:
    """Shared memory of the bf16 forward: the weights [4H][E+H+8], two x
    tiles [16][E+8] and two h tiles [16][H+8] (``csrc/lstm_fwd.cu
    fwd_smem``)."""
    return 2 * (4 * H * (E + H + _PAD) + 2 * BF16_ROWS * (E + _PAD)
                + 2 * BF16_ROWS * (H + _PAD))


def rec_smem_bytes(H: int) -> int:
    """Shared memory of the bf16 recurrent backward: Wh [H][4H+8] and two
    dpre tiles [16][4H+8] (``csrc/lstm_bwd.cu rec_smem``)."""
    return 2 * (H * (4 * H + _PAD) + 2 * BF16_ROWS * (4 * H + _PAD))


def xw_smem_bytes(H: int) -> int:
    """Shared memory of the bf16 ``xw`` recurrence: Wh [4H][H+8] and two h
    tiles [16][H+8] (``csrc/lstm_fwd.cu xw_smem``)."""
    return 2 * (4 * H * (H + _PAD) + 2 * BF16_ROWS * (H + _PAD))


#: the widest bf16 layer: a forward warp owns 8 hidden units of 16 warps,
#: a recurrent-backward warp 16 units of 8.
BF16_MAX_H = 128


def bf16_fwd_body(E: int, H: int) -> str:
    """The bf16 forward body at these widths, by width alone: ``"resident"``
    (all of ``[Wx; Wh]`` in shared memory, x_t one 16-byte vector a thread:
    E <= 128) where it fits, else ``"xw"`` (x . Wx a tile product first,
    only Wh resident). Config #4 (E=64, H=128) is resident; E=H=128 and
    every E > 128 take ``xw``."""
    return ("resident" if E <= 128 and fwd_smem_bytes(E, H) <= _MAX_SMEM
            else "xw")


def check_bf16_widths(E: int, H: int, what: str = "lstm") -> None:
    """The widths the bf16 kernels take, or a ``ValueError`` naming the
    constraint: E and H multiples of 16 (mma k-tiles) and H <= 128 (a warp
    owns at most 16 hidden units). The forward body is the one
    :func:`bf16_fwd_body` picks, and at every such width its weights and
    tiles fit a block's shared memory (config #4's resident body 218,112
    bytes; the ``xw`` body at H=128 147,968; the recurrent backward
    166,400)."""
    if E <= 0 or H <= 0 or E % 16 or H % 16:
        raise ValueError(
            f"{what}: the bf16 CUDA LSTM kernels take E and H multiples of "
            f"16, got E={E}, H={H}")
    if H > BF16_MAX_H:
        raise ValueError(
            f"{what}: the bf16 CUDA LSTM kernels take H <= {BF16_MAX_H} (a "
            f"warp owns at most 16 hidden units), got H={H}")


def gate_permutation(hidden: int) -> torch.Tensor:
    """Column n of the bf16 forward's weight layout holds packed gate
    column ``perm[n]``: n = 32 q + 8 gate + u is gate ``gate`` (i, f, g,
    o) of hidden unit 8 q + u, so the four n-tiles of unit group q put a
    cell's four gates into one lane's accumulators."""
    n = torch.arange(4 * hidden)
    q, gate, u = n // 32, (n % 32) // 8, n % 8
    return gate * hidden + 8 * q + u


@functools.lru_cache(maxsize=64)
def _permutation_on(kind: str, hidden: int,
                    device: torch.device) -> torch.Tensor:
    """:func:`gate_permutation` (``kind="gate"``) or :func:`xw_permutation`
    (``"xw"``) on ``device``, copied there once: a layout call inside a
    captured CUDA graph cannot copy from the host."""
    make = gate_permutation if kind == "gate" else xw_permutation
    return make(hidden).to(device)


def fwd_weight_layout(wx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """``[Wx; Wh]`` as the bf16 forward reads it: ``[4H, E+H]``, row n
    holding packed gate column ``gate_permutation(H)[n]`` (k contiguous:
    mma's B operand). A layout copy made once a call."""
    perm = _permutation_on("gate", wh.shape[0], wx.device)
    return torch.cat([wx, wh], dim=0)[:, perm].t().contiguous()


def lstm_fwd_layout_plain(wt: torch.Tensor, b: torch.Tensor,
                          x: torch.Tensor, stash: bool = False):
    """The forward of :func:`_fwd_plain` read from
    :func:`fwd_weight_layout`'s ``wt``: the gate pre-activations computed
    in the permuted column order, as the kernel does, and read back
    through the permutation."""
    B, T, E = x.shape
    H = wt.shape[0] // 4
    perm = gate_permutation(H).to(x.device)
    inv = torch.argsort(perm)
    wxp = widen(wt[:, :E].t().contiguous())
    whp = widen(wt[:, E:].t().contiguous())
    bp = widen(b)[perm]
    dt = x.dtype
    h = widen(x.new_zeros(B, H))
    c = torch.zeros_like(h)
    hs, cs, gates = [], [], []
    for t in range(T):
        pre = ((widen(x[:, t]) @ wxp + widen(h.to(wt.dtype)) @ whp)
               + bp)[:, inv]
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


def xw_permutation(hidden: int) -> torch.Tensor:
    """Column p of the bf16 ``xw`` body's pre scratch holds packed gate
    column ``perm[p]``: p = 32 q + 8 t + 2 gate + u is gate ``gate`` of
    hidden unit 8 q + 2 t + u, so the lane of the recurrence that owns
    units 8 q + 2 t and + 1 reads all eight of its pre values of a row as
    eight contiguous floats."""
    p = torch.arange(4 * hidden)
    q, t, gate, u = p // 32, (p % 32) // 8, (p % 8) // 2, p % 2
    return gate * hidden + 8 * q + 2 * t + u


def xw_xproj_layout(wx: torch.Tensor) -> torch.Tensor:
    """Wx as the bf16 ``xw`` body's x . Wx product reads it: ``[4H, E]``,
    row p holding packed column ``xw_permutation(H)[p]`` (k contiguous:
    mma's B operand). A layout copy made once a call."""
    perm = _permutation_on("xw", wx.shape[1] // 4, wx.device)
    return wx[:, perm].t().contiguous()


def xw_rec_weight_layout(wh: torch.Tensor) -> torch.Tensor:
    """Wh as the bf16 ``xw`` recurrence keeps it: ``[4H, H]``, row n
    holding packed column ``gate_permutation(H)[n]`` (the resident body's
    order without the Wx rows). A layout copy made once a call."""
    perm = _permutation_on("gate", wh.shape[0], wh.device)
    return wh[:, perm].t().contiguous()


def lstm_fwd_xw_layout_plain(wxt: torch.Tensor, wht: torch.Tensor,
                             b: torch.Tensor, x: torch.Tensor,
                             stash: bool = False):
    """The forward of :func:`_fwd_plain` as the bf16 ``xw`` body splits it:
    the f32 scratch ``pre = x . Wx`` for every (b, t) in
    :func:`xw_permutation`'s column order from :func:`xw_xproj_layout`'s
    ``wxt``, then each step ``(pre + h . Wh) + b`` with h . Wh in
    :func:`gate_permutation`'s order from :func:`xw_rec_weight_layout`'s
    ``wht``, both read back into the packed order. pre stays f32, as the
    TPU kernel's x . Wx does (``preferred_element_type=f32``)."""
    B, T, E = x.shape
    H = wht.shape[1]
    inv_x = torch.argsort(xw_permutation(H).to(x.device))
    inv_h = torch.argsort(gate_permutation(H).to(x.device))
    pre = (widen(x.reshape(B * T, E)) @ widen(wxt).t())[:, inv_x]
    pre = pre.reshape(B, T, 4 * H)
    whp = widen(wht).t()
    bw = widen(b)
    dt = x.dtype
    h = widen(x.new_zeros(B, H))
    c = torch.zeros_like(h)
    hs, cs, gates = [], [], []
    for t in range(T):
        v = (pre[:, t] + (widen(h.to(wht.dtype)) @ whp)[:, inv_h]) + bw
        i = torch.sigmoid(v[:, 0 * H:1 * H])
        f = torch.sigmoid(v[:, 1 * H:2 * H])
        g = torch.tanh(v[:, 2 * H:3 * H])
        o = torch.sigmoid(v[:, 3 * H:4 * H])
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


def wgrad_rows_plain(hs: torch.Tensor) -> torch.Tensor:
    """h_{t-1} of each row n = b T + t of the weight-gradient reduction, as
    the bf16 kernel indexes it: ``hs`` flattened to [B*T, H] and read one
    row back, zero where n % T == 0 (t = 0), so a row never reads the
    previous sequence's last step."""
    B, T, H = hs.shape
    flat = hs.reshape(B * T, H)
    prev = torch.cat([flat.new_zeros(1, H), flat[:-1]], dim=0)
    first = (torch.arange(B * T, device=hs.device) % T == 0)[:, None]
    return torch.where(first, torch.zeros_like(prev), prev)


def lstm_bwd_recurrent_plain(wh, cs, gates, dhs, rows: int = BF16_ROWS
                             ) -> tuple:
    """The serial half of the backward's split, in plain PyTorch: the
    workspace ``dpre_c [B, T, 4H]`` (dpre rounded to Wh's dtype: bf16 for
    the bf16 body, no rounding in f32) and the f32 db partials
    ``[ceil(B / rows), 4H]`` of the kernel's ``rows``-row tiles (16 for
    bf16, :func:`f32_tiling`'s R for f32), summed from the unrounded
    dpre."""
    B, T, H = cs.shape
    whw = widen(wh)
    dh = widen(cs.new_zeros(B, H))
    dc = torch.zeros_like(dh)
    dpres, dpres_c = [None] * T, [None] * T
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
        dpre_c = dpre.to(wh.dtype)
        dh = widen(dpre_c) @ whw.t()
        dpres[t], dpres_c[t] = dpre, dpre_c
    return torch.stack(dpres_c, dim=1), _tile_sums(torch.stack(dpres, dim=1),
                                                   rows)


def _tile_sums(dpre: torch.Tensor, rows: int) -> torch.Tensor:
    """The f32 db partials ``[ceil(B / rows), 4H]``: dpre summed over each
    ``rows``-row tile's rows and all t."""
    B, T, G = dpre.shape
    tiles = -(-B // rows)
    pad = dpre.new_zeros(tiles * rows - B, T, G)
    return torch.cat([dpre, pad]).reshape(tiles, rows * T, G).sum(dim=1)


def lstm_bwd_wgrad_plain(wx, x, hs, dpre_c, dbp) -> tuple:
    """The parallel half, in plain PyTorch: ``dwx, dwh, db, dx`` from the
    workspace, with h_{t-1} from :func:`wgrad_rows_plain` and db the sum of
    the tiles' partials."""
    B, T, E = x.shape
    H = hs.shape[2]
    dp = widen(dpre_c.reshape(B * T, 4 * H))
    dwx = widen(x.reshape(B * T, E)).t() @ dp
    dwh = widen(wgrad_rows_plain(hs)).t() @ dp
    dx = (dp @ widen(wx).t()).to(x.dtype).reshape(B, T, E)
    return dwx.to(wx.dtype), dwh.to(wx.dtype), dbp.sum(dim=0).to(wx.dtype), dx


# -- the f32 cluster kernels' layouts ---------------------------------------

#: the f32 tilings built (``csrc/lstm_f32.cuh``): (R rows a tile, C blocks
#: a cluster), C in 1, 2, 4, 8 (8 is the largest portable cluster) at each
#: R. R=16 runs up to 1024 rows (latency-bound serving: little work a block
#: a step), R=32 above (config #4's training batch of 2048: 64 clusters of
#: two blocks, one wave). A thread owns one hidden unit's cells in RT rows.
F32_TILINGS = ((16, 8), (16, 4), (16, 2), (16, 1),
               (32, 8), (32, 4), (32, 2), (32, 1))
F32_SMALL_ROWS, F32_LARGE_ROWS = 16, 32
F32_ROWS_PER_THREAD = {F32_SMALL_ROWS: 2, F32_LARGE_ROWS: 4}
F32_LARGE_FROM = 1025
#: the order in which :func:`f32_tiling` tries the clusters at each R:
#: serving tiles spread a step over the most blocks, training tiles over
#: the fewest that hold their slice (config #4's (32, 2): 66 clusters fit
#: the card at once, one wave at B=2048).
F32_PREFERENCE = {F32_SMALL_ROWS: (8, 4, 2, 1), F32_LARGE_ROWS: (2, 4, 8, 1)}
#: the most threads of an f32 block (``lstm_f32::kThreads``)
F32_MAX_THREADS = 512


def f32_max_threads(R: int, C: int) -> int:
    """The most threads an f32 tiling's blocks are built for
    (``lstm_f32::rec_max_threads``): 256 at (32, 8), whose recurrent
    backward needs more than the 128 registers a thread of a 512-thread
    block has; 512 elsewhere."""
    return 256 if (R, C) == (32, 8) else F32_MAX_THREADS
#: the widest f32 layer padding reaches: H=512 fits no portable cluster.
F32_MAX_H = 256


def f32_misfit(H: int, R: int, C: int):
    """Why the f32 tiling ``(R, C)`` does not hold H, or None where it
    does: a block's H/C units must fill whole warps (a multiple of 8), its
    threads stay within 512 and its Wh slice and tiles within a block's
    shared memory, in the forward and the recurrent backward."""
    if H % C or (H // C) % 8:
        return f"H/C={H / C:g} is not a multiple of 8 at C={C}"
    threads = f32_threads(H, R, C)
    if threads > f32_max_threads(R, C):
        return (f"C={C} needs {threads} threads a block, more than "
                f"{f32_max_threads(R, C)} threads")
    need = max(f32_fwd_smem_bytes(H, R, C), f32_rec_smem_bytes(H, R, C))
    if need > _MAX_SMEM:
        return (f"C={C} needs {need} bytes of shared memory a block, more "
                f"than {_MAX_SMEM}")
    return None


@functools.lru_cache(maxsize=1024)
def f32_tiling(B: int, H: int) -> tuple:
    """``(R, C)`` of the f32 kernels at batch ``B``: the tile's batch rows
    by batch, then the first cluster of ``F32_PREFERENCE[R]`` that holds H
    (:func:`f32_misfit`: whole warps of units, the threads and the shared
    memory). Config #4 (H=128): R=16, C=8 up to B=1024 (B=256: 16 tiles x
    8 = 128 blocks); R=32, C=2 above (B=2048: 64 x 2 = 128 blocks). H=80
    takes (16, 2) and (32, 2), H=192 (16, 8) and (32, 4), H=256 (16, 8)
    and (32, 8). Raises a ``ValueError`` where none does."""
    R = F32_LARGE_ROWS if B >= F32_LARGE_FROM else F32_SMALL_ROWS
    whys = []
    for C in F32_PREFERENCE[R]:
        why = f32_misfit(H, R, C)
        if why is None:
            return R, C
        whys.append(why)
    raise ValueError(f"no f32 tiling holds H={H} at {R}-row tiles: "
                     + "; ".join(whys))


def f32_threads(H: int, R: int, C: int) -> int:
    """Threads of an f32 block: H/C unit slots by R/RT row groups."""
    return H // C * (R // F32_ROWS_PER_THREAD[R])


def f32_fwd_ksplit(H: int, R: int, C: int) -> int:
    """The thread groups the f32 recurrence cuts its product into over k
    (``csrc/lstm_fwd.cu f32_fwd_ksplit``): two at R=16 where twice the
    threads fit a block, else one."""
    return 2 if R == F32_SMALL_ROWS and 2 * f32_threads(H, R, C) <= \
        F32_MAX_THREADS else 1


def f32_fwd_smem_bytes(H: int, R: int, C: int) -> int:
    """Shared memory of the f32 recurrence: two mbarriers, the block's Wh
    slice [H][H/C][4], two h tiles [H][R] and, with the product cut over
    k, the second group's sums [H/C R][4] (``csrc/lstm_fwd.cu
    f32_fwd_smem``)."""
    U = H // C
    return 16 + 4 * (H * 4 * U + 2 * H * R
                     + (f32_fwd_ksplit(H, R, C) - 1) * 4 * U * R)


def f32_rec_smem_bytes(H: int, R: int, C: int) -> int:
    """Shared memory of the f32 recurrent backward: two mbarriers, the Wh
    slice [4U][H], the dpre tile [4U][R] and two receive buffers [C][U][R],
    U = H/C (``csrc/lstm_bwd.cu f32_rec_smem``)."""
    U = H // C
    return 16 + 4 * (4 * U * H + 4 * U * R + 2 * C * U * R)


def check_f32_widths(E: int, H: int, what: str = "lstm") -> None:
    """The widths the f32 kernels take, or a ``ValueError`` naming the
    constraint: E a multiple of 4 (x moves in 16-byte vectors), H a
    multiple of 8 (a warp spans 8 units), and a built tiling that holds H
    at both R (:func:`f32_tiling`). Config #4 (E=64, H=128), E=H=8, E=H=16,
    E=H=128, H=80, 192 and 256 run; H=72 and H=512 do not."""
    if E <= 0 or H <= 0 or E % 4 or H % 8:
        raise ValueError(
            f"{what}: the f32 CUDA LSTM kernels take E a multiple of 4 and H "
            f"a multiple of 8, got E={E}, H={H}")
    for B in (1, F32_LARGE_FROM):
        try:
            f32_tiling(B, H)
        except ValueError as e:
            raise ValueError(f"{what}: the f32 CUDA LSTM kernels keep a "
                             f"slice of Wh in each block of a cluster, and "
                             f"{e}") from None


#: the f32 kernels' occupancy queries: ints in, the most clusters the card
#: holds at once out (nothing launches; not counted).
_QUERY = build.KernelLib({
    "lstm_fwd_f32_clusters": ("lstm_fwd", [_I] * 4),
    "lstm_bwd_recurrent_f32_clusters": ("lstm_bwd", [_I] * 3),
}, ())


def f32_max_clusters(kernel: str, H: int, R: int, C: int) -> int:
    """The most clusters of the f32 ``kernel`` (``"lstm_fwd"``,
    ``"lstm_fwd_stash"`` or ``"lstm_bwd_recurrent"``) at tiling ``(R,
    C)`` that the card holds at once (``cudaOccupancyMaxActiveClusters``):
    a call needing ``ceil(B / R)`` clusters runs in that many over this
    waves. Builds the kernels if needed; raises on a CUDA error."""
    if kernel == "lstm_bwd_recurrent":
        n = _QUERY.query("lstm_bwd_recurrent_f32_clusters", H, R, C)
    else:
        n = _QUERY.query("lstm_fwd_f32_clusters", H, R, C,
                         int(kernel == "lstm_fwd_stash"))
    if n < 0:
        raise RuntimeError(f"{kernel} cluster query failed: cudaError {-n}")
    return n


def f32_xproj_layout(wx: torch.Tensor, b: torch.Tensor) -> tuple:
    """Wx and b as the f32 forward's x . Wx product writes its output:
    ``wxp [E, 4H]`` and ``bp [4H]`` with column ``4 k + g`` holding packed
    column ``g H + k`` (unit k's four gates side by side). A layout copy
    made once a call."""
    E, G = wx.shape
    H = G // 4
    wxp = wx.reshape(E, 4, H).transpose(1, 2).reshape(E, G).contiguous()
    return wxp, b.reshape(4, H).t().reshape(G).contiguous()


def f32_fwd_weight_layout(wh: torch.Tensor, C: int) -> torch.Tensor:
    """Wh as the f32 recurrence's blocks read it: ``[C, H, H/C, 4]``,
    ``[c, k, u, g]`` holding packed column ``g H + c H/C + u`` of row k, so
    block c's slice is contiguous and a unit's four gates are one 16-byte
    read. A layout copy made once a call."""
    H = wh.shape[0]
    return wh.reshape(H, 4, C, H // C).permute(2, 0, 3, 1).contiguous()


def lstm_fwd_f32_layout_plain(wxp: torch.Tensor, bp: torch.Tensor,
                              wl: torch.Tensor, x: torch.Tensor,
                              stash: bool = False):
    """The forward of :func:`_fwd_plain` as the f32 kernels split it: pre
    = x . wxp + bp for every (b, t) first (:func:`f32_xproj_layout`), then
    block c of a cluster adds h_{t-1} . Wh over its slice ``wl[c]``
    (:func:`f32_fwd_weight_layout`) to the four gates of its units [c U,
    (c+1) U), and the blocks' h are put together for the next step."""
    C, H, U, _ = wl.shape
    B, T, _E = x.shape
    pre = (x @ wxp + bp).reshape(B, T, C, U, 4)
    h = x.new_zeros(B, H)
    c = torch.zeros_like(h)
    hs, cs, gates = [], [], []
    for t in range(T):
        acts = torch.stack([pre[:, t, blk] + (h @ wl[blk].reshape(H, 4 * U))
                            .reshape(B, U, 4) for blk in range(C)], dim=1)
        i, f, g, o = (acts[..., k].reshape(B, H) for k in range(4))
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        if stash:
            cs.append(c)
            gates.append(torch.cat([i, f, g, o], dim=1))
    if not stash:
        return torch.stack(hs, dim=1)
    return (torch.stack(hs, dim=1), torch.stack(cs, dim=1),
            torch.stack(gates, dim=1))


def f32_rec_weight_layout(wh: torch.Tensor, C: int) -> torch.Tensor:
    """Wh as the f32 recurrent backward's blocks read it: ``[C, 4U, H]``,
    row j = 4 u' + g of block c holding the weights of packed column ``g H
    + c U + u'`` (block c's dpre column j) to every unit, ordered ``[h, s,
    q]`` for unit ``s + U (h CV + q)``, CV = min(C, 4): the thread of slot
    s reads its C outputs' weights as C/CV runs of CV contiguous floats. A
    layout copy made once a call."""
    H = wh.shape[0]
    U, CV = H // C, min(C, 4)
    w = wh.reshape(C // CV, CV, U, 4, C, U)  # [h, q, s, g, c, u']
    return w.permute(4, 5, 3, 0, 2, 1).reshape(C, 4 * U, H).contiguous()


def lstm_bwd_recurrent_f32_layout_plain(whl: torch.Tensor, cs, gates, dhs,
                                        R: int) -> tuple:
    """The serial half of the f32 backward as the cluster kernel splits it,
    from :func:`f32_rec_weight_layout`'s ``whl``, at R rows a tile: block c
    forms dpre of its units' four gate columns, multiplies them by its
    slice into partials of dh_{t-1} for every unit, and each unit's dh is
    its C partials summed in rank order, then dhs added. Returns
    :func:`lstm_bwd_recurrent_plain`'s ``(dpre [B, T, 4H], db partials
    [ceil(B / R), 4H])``."""
    C, U4, H = whl.shape
    U, CV = U4 // 4, min(C, 4)
    B, T, _ = cs.shape
    dh_carry = None
    dc = cs.new_zeros(B, H)
    dpres = [None] * T
    for t in range(T - 1, -1, -1):
        i, f, g, o = gates[:, t].split(H, dim=1)
        c_t = cs[:, t]
        c_prev = cs[:, t - 1] if t > 0 else torch.zeros_like(c_t)
        dh = dhs[:, t] if dh_carry is None else dh_carry + dhs[:, t]
        tanh_c = torch.tanh(c_t)
        do = dh * tanh_c
        dc = dh * o * (1.0 - tanh_c * tanh_c) + dc
        dpre = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                          dc * i * (1.0 - g * g), do * o * (1.0 - o)], dim=1)
        dc = dc * f
        dpres[t] = dpre
        cols = dpre.reshape(B, 4, C, U)  # [b, g, c, u']
        dh_carry = None
        for blk in range(C):
            mine = cols[:, :, blk].transpose(1, 2).reshape(B, 4 * U)
            part = (mine @ whl[blk]).reshape(B, C // CV, U, CV)  # [h, s, q]
            part = part.permute(0, 1, 3, 2).reshape(B, H)  # s + U (h CV + q)
            dh_carry = part if dh_carry is None else dh_carry + part
    dpre = torch.stack(dpres, dim=1)
    return dpre, _tile_sums(dpre, R)


def lstm_fwd_cuda(wx, wh, b, x) -> torch.Tensor:
    """``lstm_fwd_f32`` / ``lstm_fwd_bf16`` / ``lstm_fwd_xw_bf16`` (the
    bf16 body :func:`bf16_fwd_body` picks): hs of the forward on the card,
    in x's dtype."""
    suffix = _check_cuda((x, wh, wx, b), "lstm_fwd")
    B, T, E = x.shape
    H = wh.shape[0]
    hs = torch.empty((B, T, H), dtype=x.dtype, device=x.device)
    if suffix == "bf16" and bf16_fwd_body(E, H) == "resident":
        _LIB.launch("lstm_fwd_bf16", x, fwd_weight_layout(wx, wh), b, hs, B,
                    T, E, H)
    elif suffix == "bf16":
        _LIB.launch("lstm_fwd_xw_bf16", x, xw_xproj_layout(wx),
                    xw_rec_weight_layout(wh), b, _pre_workspace(x, H), hs, B,
                    T, E, H)
    else:
        R, C = f32_tiling(B, H)
        _LIB.launch("lstm_fwd_f32", x, *f32_xproj_layout(wx, b),
                    f32_fwd_weight_layout(wh, C), _pre_workspace(x, H), hs,
                    B, T, E, H, R, C)
    _LIB.count("lstm_fwd")
    return hs


def _pre_workspace(x: torch.Tensor, H: int) -> torch.Tensor:
    """The f32 scratch of the f32 forward (x . Wx + b) and of the bf16
    ``xw`` body (x . Wx) for every (b, t), [B, T, 4H]."""
    return torch.empty((*x.shape[:2], 4 * H), dtype=torch.float32,
                       device=x.device)


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
    if suffix == "bf16" and bf16_fwd_body(E, H) == "resident":
        _LIB.launch("lstm_fwd_stash_bf16", x, fwd_weight_layout(wx, wh), b,
                    hs, cs, gates, B, T, E, H)
    elif suffix == "bf16":
        _LIB.launch("lstm_fwd_stash_xw_bf16", x, xw_xproj_layout(wx),
                    xw_rec_weight_layout(wh), b, _pre_workspace(x, H), hs, cs,
                    gates, B, T, E, H)
    else:
        R, C = f32_tiling(B, H)
        _LIB.launch("lstm_fwd_stash_f32", x, *f32_xproj_layout(wx, b),
                    f32_fwd_weight_layout(wh, C), _pre_workspace(x, H), hs, cs,
                    gates, B, T, E, H, R, C)
    _LIB.count("lstm_fwd_stash")
    return hs, cs, gates


#: reduction chunks of the weight-gradient kernels: enough output tiles
#: times chunks to fill the card's 132 SMs several times over, each chunk
#: at least 256 rows of the B*T reduction.
_MAX_SPLITS = 64


def bwd_splits(rows: int) -> int:
    """Chunks the B*T rows of the weight-gradient reduction are cut into."""
    return max(1, min(_MAX_SPLITS, rows // 256))


def lstm_bwd_recurrent_cuda(wh, cs, gates, dhs) -> tuple:
    """``lstm_bwd_recurrent_f32`` / ``lstm_bwd_recurrent_bf16``, the serial
    half of the backward (:func:`lstm_bwd_recurrent_plain` on the card):
    the workspace ``dpre [B, T, 4H]`` (f32, or dpre rounded to bf16) and
    the f32 db partials ``[ceil(B / R), 4H]`` of the R-row tiles (16 in
    bf16, :func:`f32_tiling`'s R in f32). It counts no ``lstm_bwd``:
    :func:`lstm_bwd_cuda` counts one for both halves."""
    # The halves' widths are lstm_bwd_cuda's to check; the kernels refuse
    # others with an error.
    suffix = build.check_cuda((cs, gates, dhs, wh), "lstm_bwd_recurrent",
                              "LSTM")
    B, T, H = cs.shape
    if suffix == "bf16":
        R, C = BF16_ROWS, None
    else:
        R, C = f32_tiling(B, H)
    dpre = torch.empty((B, T, 4 * H), dtype=cs.dtype, device=cs.device)
    dbp = torch.empty((-(-B // R), 4 * H), dtype=torch.float32,
                      device=cs.device)
    if suffix == "bf16":
        _LIB.launch("lstm_bwd_recurrent_bf16", dhs, cs, gates, wh, dpre, dbp,
                    B, T, H)
    else:
        _LIB.launch("lstm_bwd_recurrent_f32", dhs, cs, gates,
                    f32_rec_weight_layout(wh, C), dpre, dbp, B, T, H, R, C)
    return dpre, dbp


def lstm_bwd_wgrad_cuda(wx, x, hs, dpre, dbp) -> tuple:
    """``lstm_bwd_wgrad_f32`` / ``lstm_bwd_wgrad_bf16``, the parallel half
    (:func:`lstm_bwd_wgrad_plain` on the card): ``dwx, dwh, db, dx`` in
    x's dtype from the workspace and the db partials."""
    suffix = build.check_cuda((x, hs, wx, dpre), "lstm_bwd_wgrad", "LSTM")
    B, T, E = x.shape
    H = hs.shape[2]
    splits = bwd_splits(B * T)
    partial = torch.empty((splits, E + H, 4 * H), dtype=torch.float32,
                          device=x.device)
    dx = torch.empty_like(x)
    dwx = torch.empty_like(wx)
    dwh = torch.empty((H, 4 * H), dtype=wx.dtype, device=x.device)
    db = torch.empty((4 * H,), dtype=wx.dtype, device=x.device)
    if suffix == "bf16":
        _LIB.launch("lstm_bwd_wgrad_bf16", x, hs, wx, dpre, dbp, partial, dx,
                    dwx, dwh, db, B, T, E, H, splits)
    else:
        _check_aligned((x, hs, wx), "lstm_bwd_wgrad")
        _LIB.launch("lstm_bwd_wgrad_f32", x, hs, wx, dpre, dbp, partial, dx,
                    dwx, dwh, db, B, T, E, H, splits, dbp.shape[0])
    return dwx, dwh, db, dx


def lstm_bwd_cuda(wx, wh, x, hs, cs, gates, dhs) -> tuple:
    """``lstm_bwd_recurrent_*`` then ``lstm_bwd_wgrad_*``: ``dwx, dwh, db,
    dx`` on the card in the inputs' dtype (the same outputs as
    :func:`lstm_bwd_plain`), one ``lstm_bwd`` launch. The halves allocate
    the kernels' scratch: the dpre workspace [B, T, 4H] (f32, or bf16 for
    the bf16 body), f32 db partials an R-row tile and the weight-gradient
    partials."""
    _check_cuda((x, wh, wx, hs, cs, gates, dhs), "lstm_bwd")
    B, T, _E = x.shape
    H = wh.shape[0]
    if (tuple(hs.shape) != (B, T, H) or tuple(cs.shape) != (B, T, H)
            or tuple(dhs.shape) != (B, T, H)
            or tuple(gates.shape) != (B, T, 4 * H)):
        raise ValueError(
            f"lstm_bwd residuals must be hs, cs, dhs [B, T, H] and gates "
            f"[B, T, 4H] for x {tuple(x.shape)}; got hs {tuple(hs.shape)}, cs "
            f"{tuple(cs.shape)}, dhs {tuple(dhs.shape)}, gates "
            f"{tuple(gates.shape)}")
    dwx, dwh, db, dx = lstm_bwd_wgrad_cuda(
        wx, x, hs, *lstm_bwd_recurrent_cuda(wh, cs, gates, dhs))
    _LIB.count("lstm_bwd")
    return dwx, dwh, db, dx


@functools.lru_cache(maxsize=256)
def padded_widths(E: int, H: int, dtype: torch.dtype) -> tuple:
    """``(E', H')``, the widths the ``dtype`` kernels run a call of widths
    ``(E, H)`` at: E rises to a multiple of 4 (f32) or 16 (bf16), H to the
    next width the kernels take (:func:`check_f32_widths` up to
    ``F32_MAX_H``, :func:`check_bf16_widths`'s multiples of 16 up to
    ``BF16_MAX_H``). Where none does, H stays as it is, and the kernels
    refuse the call with a ``ValueError`` naming the constraint. f32: (5,
    6) -> (8, 8), (64, 72) -> (64, 80), (8, 4) -> (8, 8), (64, 200) -> (64,
    256); bf16: (5, 6) -> (16, 16), (128, 128) -> (128, 128)."""
    if dtype == torch.bfloat16:
        Hp = -(-H // 16) * 16
        return -(-E // 16) * 16, Hp if Hp <= BF16_MAX_H else H
    Ep = -(-E // 4) * 4
    for Hp in range(-(-H // 8) * 8, F32_MAX_H + 1, 8):
        try:
            check_f32_widths(Ep, Hp)
        except ValueError:
            continue
        return Ep, Hp
    return Ep, H


def _pad_gate_columns(w: torch.Tensor, Hp: int) -> torch.Tensor:
    """``[rows, 4H]`` -> ``[rows, 4Hp]``: gate g's columns at ``g Hp``,
    zeros after them."""
    rows, G = w.shape
    H = G // 4
    out = w.new_zeros(rows, 4, Hp)
    out[:, :, :H] = w.reshape(rows, 4, H)
    return out.reshape(rows, 4 * Hp)


def pad_lstm_inputs(wx, wh, b, x, Ep: int, Hp: int) -> tuple:
    """``(wx, wh, b, x)`` zero-padded to widths ``(Ep, Hp)``: the weight
    columns and biases of padded units zero in all four gates, the Wh rows
    of padded units and the Wx rows (and x columns) of padded features
    zero. A padded unit then keeps c = h = 0 (its pre-activations are 0,
    so c = sigmoid(0) c + sigmoid(0) tanh(0) = 0), adds nothing to a real
    unit's gates and gets dpre = 0 in the backward. The same tensors where
    nothing is padded (no copy)."""
    E, H = x.shape[2], wh.shape[0]
    if (Ep, Hp) == (E, H):
        return wx, wh, b, x
    wxp = wx.new_zeros(Ep, 4 * Hp)
    wxp[:E] = _pad_gate_columns(wx, Hp)
    whp = wh.new_zeros(Hp, 4 * Hp)
    whp[:H] = _pad_gate_columns(wh, Hp)
    bp = _pad_gate_columns(b.reshape(1, 4 * H), Hp).reshape(4 * Hp)
    xp = torch.nn.functional.pad(x, (0, Ep - E)) if Ep > E else x
    return wxp, whp, bp, xp


def unpad_hs(hs: torch.Tensor, H: int) -> torch.Tensor:
    """hs (or cs) ``[B, T, Hp]`` sliced back to the caller's H units."""
    return hs if hs.shape[2] == H else hs[:, :, :H].contiguous()


def pad_dhs(dhs: torch.Tensor, Hp: int) -> torch.Tensor:
    """The incoming ``dhs [B, T, H]`` with zeros for the padded units."""
    H = dhs.shape[2]
    return dhs if Hp == H else torch.nn.functional.pad(dhs, (0, Hp - H))


def unpad_grads(dwx, dwh, db, dx, E: int, H: int) -> tuple:
    """``dwx [Ep, 4Hp], dwh [Hp, 4Hp], db [4Hp], dx [B, T, Ep]`` of a
    padded call sliced back to the caller's ``[E, 4H], [H, 4H], [4H]`` and
    ``[B, T, E]``: the real rows, and in each gate the real units."""
    Hp = dwh.shape[0]

    def cols(w):
        return w.reshape(w.shape[0], 4, Hp)[:, :, :H].reshape(-1, 4 * H)

    if dwx.shape[0] == E and Hp == H:
        return dwx, dwh, db, dx
    return (cols(dwx[:E]).contiguous(), cols(dwh[:H]).contiguous(),
            cols(db.reshape(1, 4 * Hp)).reshape(4 * H).contiguous(),
            dx[:, :, :E].contiguous())


class LSTMSeq(torch.autograd.Function):
    """The differentiable whole-sequence LSTM (the counterpart of the JAX
    package's ``custom_vjp`` around ``_lstm_tbe``): the stash forward saves
    ``(wx, wh, x, hs, cs, gates)``; ``backward`` runs BPTT and returns
    ``dwx, dwh, db, dx``. CUDA tensors go to the kernels, at
    :func:`padded_widths` (padded before the forward and the backward,
    sliced after each); CPU tensors to the plain twins, unpadded, so the
    CPU tests exercise the same wiring."""

    @staticmethod
    def forward(ctx, wx, wh, b, x):
        ctx.b_dtype = b.dtype
        E, H = x.shape[2], wh.shape[0]
        ctx.widths = (E, H)
        if build.on_cpu((wx, wh, b, x)):
            hs, cs, gates = lstm_fwd_stash_plain(wx, wh, b, x)
        else:
            build.check_cuda((x, wh, wx, b), "lstm_fwd_stash", "LSTM")
            wx, wh, b, x = pad_lstm_inputs(
                wx, wh, b, x, *padded_widths(E, H, x.dtype))
            hs, cs, gates = lstm_fwd_stash_cuda(wx, wh, b, x)
        ctx.save_for_backward(wx, wh, x, hs, cs, gates)
        return unpad_hs(hs, H)

    @staticmethod
    def backward(ctx, dhs):
        wx, wh, x, hs, cs, gates = ctx.saved_tensors
        # The head reads hs[:, -1] only, so dhs is mostly zeros; autograd
        # may hand it over in any layout. Make it the kernel's.
        dhs = pad_dhs(dhs.contiguous(), wh.shape[0])
        if build.on_cpu((wx, wh, x, hs, cs, gates, dhs)):
            dwx, dwh, db, dx = lstm_bwd_plain(wx, wh, x, hs, cs, gates, dhs)
        else:
            dwx, dwh, db, dx = unpad_grads(
                *lstm_bwd_cuda(wx, wh, x, hs, cs, gates, dhs), *ctx.widths)
        return dwx, dwh, db.to(ctx.b_dtype), dx


def lstm_seq(wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Full-sequence LSTM: ``x [B, T, E] -> hs [B, T, H]`` (h0 = c0 = 0).

    Differentiable: when autograd needs a gradient of any input, the call
    goes through :class:`LSTMSeq` (stash forward, BPTT backward). Otherwise
    it runs the forward alone. CPU tensors take the plain twins. CUDA
    tensors run at :func:`padded_widths` (zero-padded, hs sliced back) and
    must be contiguous, on one device and all float32 or all bfloat16;
    anything else raises, and so does a width no kernel takes, a failed
    build or a failed launch."""
    tensors = (wx, wh, b, x)
    _check(*tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return LSTMSeq.apply(wx, wh, b, x)
    if build.on_cpu(tensors):
        return lstm_seq_plain(wx, wh, b, x)
    build.check_cuda((x, wh, wx, b), "lstm_fwd", "LSTM")  # before any copy
    E, H = x.shape[2], wh.shape[0]
    padded = pad_lstm_inputs(wx, wh, b, x, *padded_widths(E, H, x.dtype))
    return unpad_hs(lstm_fwd_cuda(*padded), H)


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
