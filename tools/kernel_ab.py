#!/usr/bin/env python3
"""Time the LSTM kernels at config #4, the GroupNorm kernels at every
ResNet-50 slab and one ResNet-50 training step, or (``--fold``) the
parameter server's fold of whole commits and remote training against the
server, in one tree of the port, for comparing two trees on one card.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 tools/kernel_ab.py [--root DIR] [--seed N] [--tilings auto,...]
    python3 tools/kernel_ab.py --fold [--root DIR] [--seed N] [--reps N]

``--root`` is the checkout whose ``distkeras_tpu_torch`` is timed (default:
this one; a copy of another commit, unpacked with ``git archive`` into a
directory git ignores, times that commit's kernels). The timing helpers
and the slab table are this checkout's ``chip_smoke.py``. It prints one
JSON line: the card's name and power limit, then, in f32 and bf16, the
milliseconds (CUDA events, 10 back-to-back calls after a warm one, the
median of three readings taken in turns) of ``lstm_fwd`` at B = 1, 16,
256, the stash forward and the backward at B = 2048 (T=200, E=64, H=128),
the GroupNorm forward and backward at each slab (B=128, G=32, the model's
ReLU flag) with the sum over one ResNet-50 step's 53 GroupNorms, and one
local step of ``resnet50(norm_impl="pallas")`` at B=128 split by CUDA
events (``chip_smoke.step_split``: the forward, the backward, the update,
and the GroupNorm calls inside them). Compare two trees in one call, in
turns: parent, change, change, parent.

``--tilings`` times the GroupNorm kernels at other layouts
(``groupnorm.gn_layout``, launched through the C entry points) beside the
wrappers' own (``auto``), each held to the plain twins at
``chip_smoke.py``'s limits first: ``one``, one block of 512 threads an SM
with clusters up to 16; ``portable``, the same with clusters up to 8,
where the stem's backward reads part of its rows again from L2.

``--fold`` times instead, for one commit of config #4's model (IMDB LSTM,
6 tensors) and one of ResNet-50 (161 tensors), in int8 and bf16:

* ``kernel_ms``: the fold of a commit whose wire tensors are already on the
  card, by CUDA events with L2 flushed (by a read) and the card held by a
  spin kernel that outlasts the host's enqueue (``chip_smoke.cuda_ms_cold``
  with ``head_start``: the card's time alone): the tree's ``fold_commit_``
  on a staged commit where it has one, else ``fold_compressed_`` once per
  tensor; ``call_ms`` the same without the spin, the wrapper's host time
  showing;
* ``fold_delta_ms``: host clock around ``netps.fold.fold_delta(centers,
  entries, "dynsgd", 0)`` from the host wire arrays, as the server's
  handler receives them (both trees take that call), to the end of its
  work on the card (median);
* ``add_loop_ms``: ``c.add_(w, alpha=s)`` for each tensor, the yardstick;

and, from ``DynSGD(imdb_lstm(...), remote=srv.endpoint)`` against a
``PSServer`` on the card at config #4's width and batch (4 workers, window
4, batch 2048; every kernel built and one int8 round run first, untimed;
then int8 3 rounds and bf16 2): samples/s and the server's commit and pull
handlers, one by one (``chip_smoke.time_handlers``: p50 and max, ms).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as S  # noqa: E402  (this tree's helpers, before --root)

T, E, H = 200, 64, 128


def layouts(G, N: int, C: int, itemsize: int, kind: str):
    """The forward's and the backward's tiling of a slab under ``kind``
    (None: the wrappers' own)."""
    if kind == "auto":
        return None
    clusters = G.GN_CLUSTERS + ((G.GN_WIDE_CLUSTER,) if kind == "one"
                                else ())
    out = []
    for backward in (False, True):
        d = G.gn_tiling(N, C, S.GN_GROUPS, itemsize, backward)
        out.append(G.gn_layout(N, C, S.GN_GROUPS, itemsize, backward, d.vec,
                               max(128 // itemsize, C // S.GN_GROUPS),
                               G.GN_THREADS, G.GN_MAX_SMEM, clusters))
    return tuple(out)


def launchers(torch, G, x, dy, gamma, beta, relu, tilings) -> tuple:
    """The forward and the backward at ``tilings``, through the C entry
    points (``group_norm_fwd_*``, ``group_norm_bwd_*``) with the wrappers'
    arguments and outputs allocated once, each held first to the plain
    twins at ``chip_smoke.py``'s limits (f32: GN_ATOL, GN_BWD_RTOL; bf16:
    GN_BF16_TOP)."""
    B, N, C = x.shape
    suffix = "f32" if x.element_size() == 4 else "bf16"
    tf, tb = tilings
    y, dx = torch.empty_like(x), torch.empty_like(x)
    part = torch.empty((2, B, C), dtype=torch.float32, device=x.device)
    dg, db = torch.empty_like(gamma), torch.empty_like(beta)

    def fwd():
        G._LIB.launch(f"group_norm_fwd_{suffix}", x, gamma, beta, y, B, N, C,
                      S.GN_GROUPS, tf.ct, tf.vec, tf.threads, tf.cluster,
                      tf.cached, int(relu))

    def bwd():
        G._LIB.launch(f"group_norm_bwd_{suffix}", x, dy, gamma, beta, dx, dg,
                      db, part, B, N, C, S.GN_GROUPS, tb.ct, tb.vec,
                      tb.threads, tb.cluster, tb.cached, int(relu))

    fwd()
    bwd()
    args = (gamma, beta, S.GN_GROUPS, relu)
    y_ref = G.group_norm_fwd_plain(x, *args)
    y_rel = S.rel_err(torch, y, y_ref)
    y_err = (y.float() - y_ref.float()).abs().max().item()
    dx_rel = S.rel_err(torch, dx, G.group_norm_bwd_plain(x, dy, *args)[0])
    if x.dtype == torch.float32:
        ok = y_err <= S.GN_ATOL and dx_rel <= S.GN_BWD_RTOL
    else:
        ok = max(y_rel, dx_rel) <= S.GN_BF16_TOP
    if not ok:
        sys.exit(f"GroupNorm at {tilings} disagrees with the twins: "
                 f"y {y_rel}, dx {dx_rel}")
    return fwd, bwd


def lstm_rows(torch, K, gen) -> dict:
    wx32 = torch.randn((E, 4 * H), device="cuda", generator=gen) / 8
    wh32 = torch.randn((H, 4 * H), device="cuda", generator=gen) / 11
    b32 = torch.randn(4 * H, device="cuda", generator=gen) / 10
    out = {}
    for name in S.DTYPES:
        dt = getattr(torch, name)
        wx, wh, b = (t.to(dt) for t in (wx32, wh32, b32))
        fns = {}
        with torch.no_grad():
            for B in (1, 16, 256):
                x = torch.randn((B, T, E), device="cuda",
                                generator=gen).to(dt)
                fns[f"lstm_fwd B={B}"] = (
                    lambda x=x: K.lstm_fwd_cuda(wx, wh, b, x))
            x = torch.randn((2048, T, E), device="cuda", generator=gen).to(dt)
            fns["lstm_fwd_stash B=2048"] = (
                lambda: K.lstm_fwd_stash_cuda(wx, wh, b, x))
            res = K.lstm_fwd_stash_cuda(wx, wh, b, x)
            dhs = (torch.randn((2048, T, H), device="cuda", generator=gen)
                   / 10).to(dt)
            fns["lstm_bwd B=2048"] = (
                lambda: K.lstm_bwd_cuda(wx, wh, x, *res, dhs))
            out[name] = {k: v[0] for k, v in
                         S.interleaved_ms(torch, fns, 10).items()}
        del res, x, dhs, fns
    return out


def group_norm_rows(torch, G, gen, kinds) -> dict:
    out = {}
    for name in S.DTYPES:
        dt = getattr(torch, name)
        slabs, step = {}, {k: [0.0, 0.0] for k in kinds}
        for N, C, relu, per_step in S.GN_SLABS:
            x, dy = (torch.randn((128, N, C), device="cuda",
                                 generator=gen).to(dt) for _ in range(2))
            gamma, beta = (torch.randn(C, device="cuda", generator=gen).to(dt)
                           for _ in range(2))
            if relu:
                dy = S.relu_margin(torch, G, x, dy, gamma, beta,
                                   1e-3 if name == "float32" else 1e-2)
            args = (gamma, beta, S.GN_GROUPS, relu)
            row, fns = {}, {}
            for kind in kinds:
                t = layouts(G, N, C, x.element_size(), kind)
                if t is None:
                    fwd = (lambda: G.group_norm_fwd_cuda(x, *args))
                    bwd = (lambda: G.group_norm_bwd_cuda(x, dy, *args))
                else:
                    fwd, bwd = launchers(torch, G, x, dy, gamma, beta, relu,
                                         t)
                    row[f"{kind} tiling"] = [v._asdict() for v in t]
                fns[f"{kind} fwd"], fns[f"{kind} bwd"] = fwd, bwd
            for k, (ms, _) in S.interleaved_ms(torch, fns, 10).items():
                row[k] = ms
                kind, way = k.split(" ")
                step[kind][way == "bwd"] += ms * per_step
            slabs[f"{N}x{C}"] = row
            del x, dy, fns
        torch.cuda.empty_cache()
        out[name] = {"slabs": slabs, "step_fwd_bwd": step}
    return out


def resnet_steps(torch, G, seed: int) -> dict:
    """One local step of ResNet-50 at B=128 in f32 and bf16, split by CUDA
    events (mean of 3 after a warm step)."""
    from distkeras_tpu_torch import resnet50
    from distkeras_tpu_torch.ops.optimizers import sgd

    B = S.RESNET["batch_size"]
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.random((B, 224, 224, 3), dtype=np.float32),
                        device="cuda")
    y = torch.as_tensor(rng.integers(0, 1000, B).astype(np.int32),
                        device="cuda")
    out = {}
    for name in S.DTYPES:
        model = resnet50(norm_impl="pallas", seed=seed, device="cuda")
        out[name] = S.step_split(
            torch, model, x, y, sgd(S.RESNET["learning_rate"]),
            timed=(G, {"group_norm_fwd_cuda": "gn_forward",
                       "group_norm_bwd_cuda": "gn_backward"}),
            dtype=getattr(torch, name))
        del model
        torch.cuda.empty_cache()
    return out


def commit_rows(torch, F, nfold, seed: int, reps: int) -> dict:
    """The commit-fold times of both models in both codecs."""
    from distkeras_tpu_torch import imdb_lstm, resnet50

    rng = np.random.default_rng(seed)
    flush = torch.empty(S.FLUSH_BYTES // 4, device="cuda")
    models = {
        "imdb_lstm": imdb_lstm(vocab_size=S.VOCAB, embed_dim=S.EMBED,
                               hidden_size=S.HIDDEN, seq_len=S.SEQ_LEN,
                               seed=seed, device="cuda").params,
        "resnet50": resnet50(norm_impl="pallas", seed=seed,
                             device="cuda").params}
    out = {}
    for model, params in models.items():
        sizes = [p.numel() for p in params.values()]
        flat = torch.cat([p.detach().reshape(-1) for p in params.values()])
        centers = list(torch.split(flat, sizes))
        if hasattr(F, "center_layout"):  # seated as the server seats them
            offsets, total = F.center_layout(sizes)
            seated = torch.zeros(total, device="cuda")
            centers = [seated[o:o + n] for o, n in zip(offsets, sizes)]
            for c, p in zip(centers, params.values()):
                c.copy_(p.detach().reshape(-1))
        for codec in ("int8", "bf16"):
            inputs = [S.fold_inputs(torch, c, codec, rng) for c in centers]
            entries = [(enc, spec) for enc, spec, _q in inputs]
            if hasattr(F, "fold_commit_"):
                staged = nfold.stage_commit(entries, "cuda")

                def kernel():
                    F.fold_commit_(centers, staged, 1.0)
            else:
                def kernel():
                    for c, (_e, spec, q) in zip(centers, inputs):
                        F.fold_compressed_(c, q, spec, 1.0)

            def add_loop():
                for c, (_e, spec, q) in zip(centers, inputs):
                    S.library_fold(torch, c, q, codec,
                                   F.fold_scale(codec, spec, 1.0))

            walls = []
            for _ in range(reps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                nfold.fold_delta(centers, entries, "dynsgd", 0)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            out[f"{model}.{codec}"] = {
                "tensors": len(sizes), "params": sum(sizes),
                "kernel_ms": S.cuda_ms_cold(torch, kernel, reps, flush,
                                            head_start=True),
                "call_ms": S.cuda_ms_cold(torch, kernel, reps, flush),
                "add_loop_ms": S.cuda_ms_cold(torch, add_loop, reps, flush,
                                              head_start=True),
                "fold_delta_ms": float(np.median(walls[1:])),
                "bound_ms": sum(S.fold_bound_ms(n, codec)[0] for n in sizes)}
            del inputs
    return out


def remote_rows(torch, seed: int) -> dict:
    """Remote DynSGD against a server on the card, int8 then bf16."""
    from distkeras_tpu_torch.netps import PSServer
    from distkeras_tpu_torch.trainers import DynSGD

    W, Kw, B = (S.REMOTE["num_workers"], S.REMOTE["communication_window"],
                S.REMOTE["batch_size"])
    out = {}
    runs = [("warm_up", "int8", 1)] + [(c, c, r)
                                       for c, r in S.REMOTE_ROUNDS.items()]
    for name, codec, rounds in runs:
        model, df = S.remote_inputs(seed, rounds)
        srv = PSServer(discipline="dynsgd", device="cuda").start()
        ms = S.time_handlers(srv)
        try:
            with S.env_set(DKTPU_NET_COMPRESS=codec):
                trainer = DynSGD(model, worker_optimizer="sgd",
                                 loss="sparse_categorical_crossentropy",
                                 remote=srv.endpoint, **S.REMOTE)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train(df)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            commits = len(srv.commit_log)
        finally:
            srv.close()
        if name == "warm_up":
            out[name] = {"seconds": wall}
            continue
        out[name] = {"samples_per_s": rounds * W * Kw * B / wall,
                     "commits": commits, **S.handler_stats(ms),
                     "commit_ms": ms["commit"]}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tilings", default="auto")
    ap.add_argument("--fold", action="store_true",
                    help="time whole-commit folds and remote training")
    ap.add_argument("--reps", type=int, default=20,
                    help="cold calls a fold reading averages (--fold)")
    args = ap.parse_args()
    kinds = args.tilings.split(",")
    if not set(kinds) <= {"auto", "one", "portable"}:
        sys.exit(f"unknown tilings {kinds}")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    from distkeras_tpu_torch.ops.kernels import fold as F
    from distkeras_tpu_torch.ops.kernels import groupnorm as G
    from distkeras_tpu_torch.ops.kernels import lstm as K

    if not Path(K.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {K.__file__}, not the tree at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # as chip_smoke.py runs
    out = {"root": str(root), "gpu": S.card_line()}
    if args.fold:
        from distkeras_tpu_torch.netps import fold as nfold
        from distkeras_tpu_torch.ops.kernels import build

        build.build(build.all_sources())
        F.prepare()
        out["commit"] = commit_rows(torch, F, nfold, args.seed, args.reps)
        out["remote"] = remote_rows(torch, args.seed)
    else:
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        out["lstm"] = lstm_rows(torch, K, gen)
        out["group_norm"] = group_norm_rows(torch, G, gen, kinds)
        out["resnet50_step_ms"] = resnet_steps(torch, G, args.seed)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
