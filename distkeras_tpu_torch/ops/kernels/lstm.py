"""Whole-sequence LSTM forward: the CUDA kernel, its wrapper and its plain
PyTorch twin (the port's counterpart of ``distkeras_tpu/ops/pallas/lstm.py``).

:func:`lstm_seq` takes ``x [B, T, E]`` and the packed ``(Wx [E, 4H],
Wh [H, 4H], b [4H])`` and returns ``hs [B, T, H]`` with h0 = c0 = 0. On
CUDA tensors it launches ``csrc/lstm_fwd.cu`` (one launch for all T steps;
the design note is in that file) or raises; it takes
:func:`lstm_seq_plain` only for tensors that lie on the CPU.

Gate math follows flax's ``OptimizedLSTMCell`` exactly (i,f,g,o order,
``c' = f*c + i*g``, ``h' = o*tanh(c')``); :func:`pack_lstm_params` turns
that cell's per-gate parameter tree into the packed layout, so both of the
JAX package's LSTM layouts serve through this one function.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from distkeras_tpu_torch.ops.kernels import build

GATES = ("i", "f", "g", "o")

#: kernel launches so far in this process (one per wrapper call that
#: launched); a run sets it to 0 and reads it back to show that its path
#: went through the kernel.
launches = 0
_COUNT_LOCK = threading.Lock()

_SIG = None


def _kernel():
    """The ``lstm_fwd_f32`` C entry point, built and typed at first use."""
    global _SIG
    if _SIG is None:
        fn = build.load("lstm_fwd").lstm_fwd_f32
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        _SIG = fn
    return _SIG


def lstm_seq_plain(wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: a loop over t. The CPU path of
    :func:`lstm_seq`, and the reference its kernel is held against."""
    B, T, _E = x.shape
    H = wh.shape[0]
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    out = []
    for t in range(T):
        pre = x[:, t] @ wx + h @ wh + b
        i = torch.sigmoid(pre[:, 0 * H:1 * H])
        f = torch.sigmoid(pre[:, 1 * H:2 * H])
        g = torch.tanh(pre[:, 2 * H:3 * H])
        o = torch.sigmoid(pre[:, 3 * H:4 * H])
        c = f * c + i * g
        h = o * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=1)


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


def lstm_seq(wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Full-sequence LSTM: ``x [B, T, E] -> hs [B, T, H]`` (h0 = c0 = 0).

    CPU tensors take the plain path. CUDA tensors must be float32,
    contiguous and on one device; anything else raises, and so does a
    failed build or launch. The CUDA path is inference-only: the BPTT
    backward kernel is not ported yet, so a call that would need a
    gradient raises instead of returning a result autograd cannot
    differentiate."""
    global launches
    tensors = (wx, wh, b, x)
    _check(*tensors)
    if all(t.device.type == "cpu" for t in tensors):
        return lstm_seq_plain(wx, wh, b, x)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "lstm_seq needs all of Wx, Wh, b, x on one CUDA device (or all "
            f"on the CPU); got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(
            "the CUDA LSTM kernel takes float32 only; got "
            f"{[str(t.dtype) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA LSTM kernel needs contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the CUDA LSTM path is forward-only (the BPTT backward kernel "
            "is not ported yet); call it under torch.inference_mode() or "
            "torch.no_grad()")
    B, T, E = x.shape
    H = wh.shape[0]
    if 4 * H > 512:
        raise ValueError(
            f"the CUDA LSTM kernel takes 4H <= 512 (one thread per gate "
            f"column), got H={H}")
    hs = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
                hs.data_ptr(), B, T, E, H, stream)
    if rc != 0:
        raise RuntimeError(f"lstm_fwd_f32 launch failed: cudaError {rc}")
    with _COUNT_LOCK:
        launches += 1
    return hs


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
