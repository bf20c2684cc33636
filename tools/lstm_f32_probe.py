#!/usr/bin/env python3
"""Time the f32 LSTM cluster kernels at every tiling they are built for.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 tools/lstm_f32_probe.py [--batches 1,16,256,2048] [--seed N]

For each batch B (config #4's widths: T=200, E=64, H=128) and each (R, C)
that ``csrc/lstm_fwd.cu`` and ``csrc/lstm_bwd.cu`` instantiate, it calls
the C entry points directly (bypassing ``f32_tiling``'s choice), checks hs
against the plain twin (atol 1e-5), and prints one JSON line with the
milliseconds of the forward (x . Wx and the recurrence), the stash
forward and the recurrent half of the backward (CUDA events, the three timed in turns, median of three
readings), the clusters the call needs and the most the card holds at once
(``f32_max_clusters``), beside ``torch.nn.LSTM``'s forward. The evidence
behind ``f32_tiling``; the first line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import cuda_ms  # noqa: E402

T, E, H = 200, 64, 128


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="1,16,256,2048")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    from distkeras_tpu_torch.ops.kernels import lstm as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"gpu": gpu, "torch": torch.__version__}), flush=True)
    rng = np.random.default_rng(args.seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).cuda()

    wx, wh, b = t(E, 4 * H, scale=E ** -0.5), t(H, 4 * H, scale=H ** -0.5), \
        t(4 * H, scale=0.1)
    lib = torch.nn.LSTM(E, H, batch_first=True).cuda()
    with torch.no_grad():
        lib.weight_ih_l0.copy_(wx.t())
        lib.weight_hh_l0.copy_(wh.t())
        lib.bias_ih_l0.copy_(b)
        lib.bias_hh_l0.zero_()
    for B in (int(v) for v in args.batches.split(",")):
        x = t(B, T, E)
        dhs = t(B, T, H, scale=0.1)
        ref = K.lstm_fwd_stash_plain(wx, wh, b, x)
        with torch.no_grad():
            lib_ms = float(np.median([cuda_ms(torch, lambda: lib(x), 10)
                                      for _ in range(3)]))
        wxp, bp = K.f32_xproj_layout(wx, b)
        pre = torch.empty(B, T, 4 * H, device="cuda")
        for R, C in K.F32_TILINGS:
            if (H % (8 * C) or K.f32_threads(H, R, C) > K.F32_MAX_THREADS
                    or max(K.f32_fwd_smem_bytes(H, R, C),
                           K.f32_rec_smem_bytes(H, R, C)) > K._MAX_SMEM):
                continue
            wl = K.f32_fwd_weight_layout(wh, C)
            whl = K.f32_rec_weight_layout(wh, C)
            hs = torch.empty(B, T, H, device="cuda")
            cs, gates = torch.empty_like(hs), torch.empty(B, T, 4 * H,
                                                          device="cuda")
            dpre = torch.empty(B, T, 4 * H, device="cuda")
            dbp = torch.empty(-(-B // R), 4 * H, device="cuda")
            fns = {
                "fwd": lambda: K._LIB.launch("lstm_fwd_f32", x, wxp, bp, wl,
                                             pre, hs, B, T, E, H, R, C),
                "stash": lambda: K._LIB.launch(
                    "lstm_fwd_stash_f32", x, wxp, bp, wl, pre, hs, cs, gates,
                    B, T, E, H, R, C),
                "recurrent": lambda: K._LIB.launch(
                    "lstm_bwd_recurrent_f32", dhs, ref[1], ref[2], whl, dpre,
                    dbp, B, T, H, R, C)}
            fns["stash"]()
            torch.cuda.synchronize()
            err = max((a - r).abs().max().item()
                      for a, r in zip((hs, cs, gates), ref))
            got = {k: [] for k in fns}
            for _ in range(3):
                for k, fn in fns.items():
                    got[k].append(cuda_ms(torch, fn, 10 if B <= 256 else 5))
            row = {"B": B, "R": R, "C": C, "clusters": -(-B // R),
                   "fwd_threads": K.f32_threads(H, R, C)
                   * K.f32_fwd_ksplit(H, R, C),
                   "bwd_threads": K.f32_threads(H, R, C),
                   "max_abs_err": err, "library_fwd_ms": lib_ms}
            for k in fns:
                kern = {"fwd": "lstm_fwd", "stash": "lstm_fwd_stash",
                        "recurrent": "lstm_bwd_recurrent"}[k]
                row[f"{k}_ms"] = float(np.median(got[k]))
                row[f"{k}_max_clusters"] = K.f32_max_clusters(kern, H, R, C)
            row["ok"] = err <= 1e-5
            print(json.dumps(row), flush=True)
        profile(torch, K, wx, wh, b, x, dhs)


def profile(torch, K, wx, wh, b, x, dhs) -> None:
    """Device time by kernel (``torch.profiler``) of the wrappers as the
    training and serving paths call them at ``f32_tiling``'s choice: the
    forward, the stash forward and the backward, three calls each."""
    from torch.profiler import ProfilerActivity, profile as prof

    B = x.shape[0]
    calls = [lambda: K.lstm_fwd_cuda(wx, wh, b, x),
             lambda: K.lstm_bwd_cuda(wx, wh, x,
                                     *K.lstm_fwd_stash_cuda(wx, wh, b, x),
                                     dhs)]
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(3):
            for fn in calls:
                fn()
        torch.cuda.synchronize()
    rows = {}
    for ev in p.key_averages():
        dev = getattr(ev, "device_time_total", None)
        if dev is None:
            dev = getattr(ev, "cuda_time_total", 0.0)
        if dev and ("lstm" in ev.key or "Kernel" in ev.key):
            rows[ev.key[:80]] = {"ms_per_call": dev / 1e3 / ev.count,
                                 "calls": ev.count}
    print(json.dumps({"B": B, "tiling": K.f32_tiling(B, H),
                      "profile": rows}), flush=True)


if __name__ == "__main__":
    main()
