#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distkeras_tpu_torch``) on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure exits non-zero:

1. ``card`` / ``build`` — the card's name and power limit, then every CUDA
   kernel of the port built from ``distkeras_tpu_torch/csrc/`` into
   ``build/kernels/`` (one ``nvcc`` per source, all started together).
2. ``kernel`` — each kernel's wrapper against its plain PyTorch version on
   the same CUDA tensors, at the shapes serving gives it (the IMDB LSTM at
   full width: T=200, E=64, H=128, f32, batch buckets 1, 16 and 256), with
   the tolerance stated; the kernel, the plain version and one PyTorch
   library call of the same function (``torch.nn.LSTM``, a yardstick the
   port never calls) timed with CUDA events.
3. ``serve`` — the port's serving path as a user drives it:
   ``imdb_lstm(device="cuda")`` -> ``ModelRegistry`` -> ``ServingFrontend``
   -> ``ServeClient.infer`` with ragged and concurrent requests. Every
   answer is held against the same weights run through the plain path on
   the CPU; the kernels' launch counts are set to 0 just before and read
   just after, and must cover every batch served.

Then the ``kernels`` line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np

# IMDB LSTM classifier at full width (BASELINE config #4).
VOCAB, EMBED, HIDDEN, SEQ_LEN = 20000, 64, 128, 200
BUCKETS = (1, 4, 16, 64, 256)
KERNEL_BATCHES = (1, 16, 256)

#: kernel vs plain on hs in (-1, 1): the same f32 arithmetic summed in
#: another order (192-term gate sums), over a 200-step recurrence.
KERNEL_ATOL = 1e-5
#: served logits vs the plain CPU forward of the same weights: the kernel's
#: hs error above, carried through the 128-wide head, plus CPU-vs-card
#: float32 matmul order in the head.
SERVE_ATOL = 1e-4

#: H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM bytes/s and
#: float32 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lstm_bound_ms(B: int, T: int, E: int, H: int) -> tuple[float, str]:
    """Least time for the LSTM forward on this card: x, the weights and b
    read once and hs written once, against the gate products and bias adds
    at the float32 rate."""
    nbytes = 4 * (B * T * E + (E + H + 1) * 4 * H + B * T * H)
    flops = 2 * T * B * (E + H) * 4 * H + T * B * 4 * H
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, K, model, rng) -> dict:
    """The LSTM kernel against its plain version at the serving shapes, on
    the served model's own weights and embedded tokens."""
    m = model.module
    wx, wh, b = m.lstm_wx.detach(), m.lstm_wh.detach(), m.lstm_b.detach()
    lib = torch.nn.LSTM(EMBED, HIDDEN, batch_first=True).cuda()
    with torch.no_grad():
        lib.weight_ih_l0.copy_(wx.t())
        lib.weight_hh_l0.copy_(wh.t())
        lib.bias_ih_l0.copy_(b)
        lib.bias_hh_l0.zero_()
    rows = []
    with torch.inference_mode():
        for B in KERNEL_BATCHES:
            tokens = torch.as_tensor(
                rng.integers(0, VOCAB, (B, SEQ_LEN)), device="cuda")
            x = m.embed(tokens).contiguous()
            got = K.lstm_seq(wx, wh, b, x)
            torch.cuda.synchronize()
            ref = K.lstm_seq_plain(wx, wh, b, x)
            lib_out = lib(x)[0]
            err = (got - ref).abs().max().item()
            rel = err / max(ref.abs().max().item(), 1e-30)
            lib_err = (lib_out - ref).abs().max().item()
            reps = 20 if B <= 16 else 10
            ms = cuda_ms(torch, lambda: K.lstm_seq(wx, wh, b, x), reps)
            plain_ms = cuda_ms(torch, lambda: K.lstm_seq_plain(wx, wh, b, x),
                               5)
            library_ms = cuda_ms(torch, lambda: lib(x), reps)
            bound, bound_by = lstm_bound_ms(B, SEQ_LEN, EMBED, HIDDEN)
            row = {"phase": "kernel", "name": "lstm_fwd", "B": B,
                   "T": SEQ_LEN, "E": EMBED, "H": HIDDEN, "dtype": "float32",
                   "max_abs_err": err, "max_rel_err": rel,
                   "atol": KERNEL_ATOL, "library_max_abs_err": lib_err,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound, "bound_by": bound_by}
            emit(row)
            if not err <= KERNEL_ATOL:
                fail(f"lstm_fwd disagrees with lstm_seq_plain at B={B}: "
                     f"max abs err {err} > {KERNEL_ATOL}")
            rows.append(row)
    return {r["B"]: r for r in rows}


def serve_phase(torch, K, model, cpu_model, rng, gpu: str) -> int:
    """Serve through the port's entry points; return the LSTM launches of
    this run."""
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.netps.errors import RPCTimeoutError
    from distkeras_tpu_torch.serving import (
        ModelRegistry,
        ServeClient,
        ServingError,
        ServingFrontend,
    )

    telemetry.reset()
    K.launches = 0  # counts start at 0 just before the main path runs
    registry = ModelRegistry(model, BUCKETS, device="cuda")
    frontend = ServingFrontend(registry).start()
    records, errors = [], []
    lock = threading.Lock()

    def one(client, rows: int, seed: int) -> None:
        tokens = np.random.default_rng(seed).integers(
            0, VOCAB, (rows, SEQ_LEN)).astype(np.int32)
        t0 = time.perf_counter()
        try:
            out, version = client.infer(tokens)
        except (ServingError, RPCTimeoutError) as e:
            with lock:
                errors.append(f"{type(e).__name__}: {e}")
            return
        lat = time.perf_counter() - t0
        with lock:
            records.append((tokens, np.array(out), version, lat))

    sizes = (1, 3, 17, 64)
    seed = int(rng.integers(1 << 30))
    try:
        client = ServeClient(frontend.endpoint)
        for r in range(3):                       # sequential, ragged
            for k, rows in enumerate(sizes):
                one(client, rows, seed + 10 * r + k)
        client.close()

        def worker(w: int) -> None:              # concurrent: coalescing
            c = ServeClient(frontend.endpoint)
            for k in range(4):
                one(c, sizes[(w + k) % len(sizes)], seed + 1000 + 10 * w + k)
            c.close()

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads):
            fail("a serving client thread did not finish")
        client = ServeClient(frontend.endpoint)
        stats = client.stats()
        client.close()
    finally:
        frontend.close()
        registry.close()
    launches = K.launches
    counters = telemetry.get().snapshot()["counters"]
    batches = int(counters.get("serving.batches", 0))
    retrace = int(counters.get("serving.retrace_after_warmup", 0))

    worst = 0.0
    with torch.inference_mode():
        for tokens, out, version, _lat in records:
            ref = cpu_model.predict(tokens).numpy()
            if out.shape != ref.shape or not np.all(np.isfinite(out)):
                fail(f"served output shape {out.shape} / finiteness wrong "
                     f"for a {tokens.shape[0]}-row request")
            worst = max(worst, float(np.abs(out - ref).max()))
    lat_ms = np.array([r[3] for r in records]) * 1e3
    emit({"phase": "serve", "gpu": gpu, "requests": len(records) + len(errors),
          "served": stats["served"], "rows": int(sum(r[0].shape[0]
                                                     for r in records)),
          "batches": batches, "lstm_launches": launches,
          "warmup_buckets": len(BUCKETS),
          "lstm_launches_per_batch":
              (launches - len(BUCKETS)) / batches if batches else None,
          "retrace_after_warmup": retrace, "error_replies": len(errors),
          "max_abs_err_vs_cpu_plain": worst, "atol": SERVE_ATOL,
          "p50_ms": float(np.percentile(lat_ms, 50)) if len(lat_ms) else None,
          "p99_ms": float(np.percentile(lat_ms, 99)) if len(lat_ms) else None,
          "latency": "client wall clock per request, sequential and "
                     "8 concurrent clients mixed"})
    if errors:
        fail(f"{len(errors)} error replies, first: {errors[0]}")
    if len(records) != 3 * len(sizes) + 8 * 4:
        fail(f"{len(records)} of {3 * len(sizes) + 8 * 4} requests answered")
    if not worst <= SERVE_ATOL:
        fail(f"served logits differ from the CPU plain forward by {worst}")
    if retrace != 0:
        fail(f"serving.retrace_after_warmup = {retrace}")
    if batches <= 0 or launches < batches:
        fail(f"lstm_fwd launched {launches} times for {batches} batches")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    try:
        from distkeras_tpu_torch.ops.kernels import build
        from distkeras_tpu_torch.ops.kernels import lstm as K
        from distkeras_tpu_torch import imdb_lstm
    except ImportError as e:
        fail(f"distkeras_tpu_torch not importable ({e}); run from the "
             f"repository root")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gpu = card_line()
    emit({"phase": "card", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    libs = build.build(["lstm_fwd"])
    ptxas = {k: [ln.strip() for ln in v.with_suffix(".log").read_text()
                 .splitlines() if "Used" in ln or "spill" in ln]
             for k, v in libs.items() if v.with_suffix(".log").exists()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": dict(build.BUILD_SECONDS),
          "libraries": {k: str(v) for k, v in libs.items()},
          "ptxas": ptxas})

    rng = np.random.default_rng(args.seed)
    model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                      seq_len=SEQ_LEN, seed=args.seed, device="cuda")
    cpu_model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED,
                          hidden_size=HIDDEN, seq_len=SEQ_LEN, seed=args.seed,
                          device="cpu")
    cpu_model.module.load_state_dict(
        {k: v.cpu() for k, v in model.module.state_dict().items()})

    by_b = kernel_phase(torch, K, model, rng)
    launches = serve_phase(torch, K, model, cpu_model, rng, gpu)

    top = by_b[max(by_b)]
    emit({"kernels": [{
        "name": "lstm_fwd", "route": "cuda",
        "source": "distkeras_tpu_torch/csrc/lstm_fwd.cu",
        "replaces": "distkeras_tpu/ops/pallas/lstm.py:189",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in by_b.values()),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "shape": f"B={top['B']},T={SEQ_LEN},E={EMBED},H={HIDDEN} float32"}]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
