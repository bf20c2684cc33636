#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distkeras_tpu_torch``) on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py [--seed N]

Phases, each printing JSON lines; any failure exits non-zero. Every
kernel phase has a bf16 row beside each f32 row, at the same shapes, held
to the bf16 plain twin (the rounding points of the mixed-precision step,
``compute_dtype="bfloat16"``) and timed beside the library call in bf16;
every training phase runs once more at ``compute_dtype="bfloat16"`` with
the same launch checks (and only the ``*_bf16`` entry points launched),
and every parity phase holds the card's bf16 run to the CPU's within
``BF16_PARITY_SHARE`` of the CPU's own bf16-vs-f32 distance:

1. ``card`` / ``build`` — the card's name and power limit, then every CUDA
   kernel of the port built from ``distkeras_tpu_torch/csrc/`` into
   ``build/kernels/`` (one ``nvcc`` per source, all started together):
   ``lstm_fwd.cu``, ``lstm_bwd.cu``, ``groupnorm.cu``, ``fold.cu`` and
   ``flash_attn.cu``.
2. ``kernel`` — each kernel's wrapper against its plain PyTorch version on
   the same CUDA tensors, at the shapes its path gives it (the IMDB LSTM at
   full width: T=200, E=64, H=128, f32): the forward at the serving buckets
   1, 16 and 256; the stash forward at 256 and 2048; the BPTT backward at
   1, 131 (ragged), 256 and 2048, also against autograd through the plain
   forward. Each row states its tolerance and carries the kernel's, the
   plain version's and one PyTorch library call's time (``torch.nn.LSTM``,
   a yardstick the port never calls), by CUDA events, beside its bound,
   with ``ratio_to_library``, ``bound_share`` and ``us_per_step``. The
   stash forward and the backward time the kernel and cuDNN in turns,
   three readings each (the medians are ``ms`` and ``library_ms``); the
   backward also times its two entry points apart (``recurrent_ms``,
   ``wgrad_ms``), and every f32 row gives the tiling it ran with (``R``
   rows a tile, ``C`` blocks a cluster). Before the rows, ``lstm_build``
   gives the registers and spills of the bf16 and f32 LSTM kernels (a
   spill fails the run).
3. ``train`` — the port's training path as a user drives it:
   ``DynSGD(imdb_lstm(...)).train(imdb(...))`` at config #4's width and
   batch (4 workers, window 4, batch 2048, 3 rounds, f32; then 3 rounds
   at bf16). The launch counts are set to 0 just before and read just
   after: the stash forward and the backward must each have launched once
   per local step. Then the split of one step's time (the two LSTM
   wrappers' calls timed inside it), and a parity run:
   the same trainer at full width and batch 32 on the card and on the CPU
   (the plain twins), from the same weights, whose centers must agree.
   Then ``lstm_widths``: ``lstm_seq`` forward and gradient at widths the
   kernels take only zero-padded or through the bf16 xw body (E=5, H=6 and
   H=72 in both dtypes, bf16 E=H=128 at B=2048, f32 H=192 and 256 at both
   tilings), against the twins at the kernel rows' limits, the launch
   counts set to 0 before each call and read after; ``lstm_refused``
   (f32 H=512 and bf16 H=144 raise a ``ValueError`` naming the
   constraint, nothing launched); ``lstm_bf16_bodies`` (config #4's bf16
   stash forward on the resident body its width picks and on the xw body,
   timed in turns); and ``imdb_lstm()`` at its own defaults (E=H=128,
   sequence 80) trained 2 rounds in bf16 as ``train`` trains config #4,
   every stash forward on the xw body.
4. ``serve`` — the port's serving path as a user drives it, on the weights
   ``train`` returned: ``ModelRegistry`` -> ``ServingFrontend`` ->
   ``ServeClient.infer`` with ragged and concurrent requests. Every answer
   is held against the same weights run through the plain path on the
   CPU; the launch counts are set to 0 just before and read just after,
   and must cover every batch served.

5. ``gn_kernel`` — the GroupNorm kernels against their plain twins at
   every distinct ResNet-50 slab at B=128 (with the ReLU flag the model
   uses there): forward and backward errors, two backward calls' bits,
   kernel, plain and ``F.group_norm`` (+ReLU, forward and autograd
   backward; a yardstick the port never calls) times by CUDA events,
   beside the bound (bytes over 3.35 TB/s), with the share of the bound,
   the ratio to the library call and the tiling each call ran
   (``gn_tiling``); before the phases, ``gn_build`` gives the GroupNorm
   kernels' registers and spills (a spill fails the run). Then
   ``gn_uncached``: the same checks (and two forward calls' bits) at a
   slab whose rows outgrow 16 blocks' shared memory (``GN_UNCACHED``, the
   stem of a 448x448 image), read again from L2 in each sweep.
6. ``resnet_train`` — BASELINE config #5 as a user drives it:
   ``SynchronousDistributedTrainer(resnet50(norm_impl="pallas"))`` at
   224x224, 1000 classes, batch 128, ``steps_per_program=2``, 3 rounds, f32,
   then bf16 (random images as ``bench.py`` makes them). The launch counts are set to
   0 just before and read just after: every local step must launch each
   GroupNorm kernel 53 times. Then the split of one step by CUDA events
   (forward and its GroupNorm share, backward and its GroupNorm share,
   update), and a parity run (``resnet_parity``): the same trainer at full
   width, batch 2, 2 steps, on the card and on the CPU (the plain twins),
   from the same weights.

7. ``fold_kernel`` — the dequant-fused fold kernel (``csrc/fold.cu``, one
   launch a commit) against its plain twin on the same CUDA tensors, bit
   for bit. One tensor at a time (``fold_compressed_``, the kernel with one
   row) at every tensor shape of config #4's model and ResNet-50's two
   largest tensors, both codecs, commit scales 1 and 1/3 (one row also
   against the JAX package's numpy oracle, copied into the port, on the
   host copy); kernel, plain and ``c.add_(q, alpha=s)`` times by CUDA
   events with L2 flushed by a read before every call (the server finds a
   center cold), beside the bound (bytes over 3.35 TB/s) and the floor
   (one 1-element launch after the same flush). Then ``fold_commit``: one
   whole commit of each model in each codec, seated and staged as the
   server does it, folded by one launch, bit for bit against the twin on
   the same staged buffer (config #4's also against the numpy oracle);
   the kernel's, the twin's, the same kernel tensor by tensor and the
   ``add_`` loop's cold times beside the bound, and the host wall of
   ``stage_commit`` + ``fold_delta`` to the end of the fold.
8. ``remote_train`` — remote training as a user drives it: a
   ``PSServer(discipline="dynsgd")`` with its center on the card and
   ``DynSGD(imdb_lstm(...), remote=srv.endpoint)`` at config #4's width and
   batch (4 workers, window 4, batch 2048, 3 rounds) with
   ``DKTPU_NET_COMPRESS=int8``, then a 2-round run with ``bf16``. The
   launch counts are set to 0 just before each run and read just after:
   one ``fold_commit`` launch per folded commit (none of a tensor alone),
   and the stash forward and the backward once per local step; the model
   returned is the server's center bit for bit. The server's commit and
   pull handlers are timed one by one (p50 and max).
9. ``remote_parity`` — one worker, batch 32, 2 rounds, full width, from
   the same weights: server and model on the card against both on the CPU,
   with codec ``none`` (centers within 1e-5) and ``int8`` (centers within
   the sum of each commit's largest quantization step; the losses within
   that plus 1e-5).

10. ``flash_kernel`` — the causal flash attention kernels (forward, dQ,
    dK/dV; ``csrc/flash_attn.cu``) against their plain twins on the same
    CUDA tensors, in f32 and bf16, at config #7's shape [8, 2048, 16, 64]
    and ragged ones (L = 40, 72, 136 and 200, D = 32 and 128, B*H = 1,
    L = 1024 and 512, and D = 40, which the wrappers zero-pad to 48):
    errors with their limits, two calls' bits of each
    kernel, the f32 forward's and backward's errors at each of those
    shapes but config #7's and at two with few rows (B*L*H 272 and 144)
    attributed row by row to bf16 rounding flips of p or ds
    (``flash_fwd_flips``, ``flash_bwd_flips``: no row left over), kernel
    and plain times by CUDA events, ``F.scaled_dot_product_attention``'s
    (bf16, a yardstick the port never calls), beside the bound (bytes over
    3.35 TB/s against the causal products at 989 TFLOP/s bf16). Each
    ``flash_fwd`` row gives its share of the bound and its ratio to SDPA's
    forward (and, in f32, the time of the inputs' one bf16 rounding, which
    its own time includes). A ``flash_bwd`` row per shape and dtype
    times the whole backward as the autograd Function runs it (f32 inputs
    rounded to bf16 once, then dQ and dK/dV; the bits of the two wrappers'
    outputs) against SDPA's backward, with the ratio and the share of the
    backward's own bound (S and dP once: five causal products), the two
    kernels' summed bounds beside it; the ``flash_build`` line before the
    phases gives the registers and spills of the 18 flash kernel
    instantiations from the compiler's report (a spill fails the run).
11. ``transformer_train`` — BASELINE config #7 as a user drives it:
    ``AEASGD(small_transformer_lm(vocab 32768, 8 layers, d_model 1024,
    16 heads, d_ff 4096, seq 2048, attn_impl="flash", remat=True), "adam",
    ...)`` at batch 8, window 8, lr 1e-4, rho 500, 2 rounds, f32 then
    bf16 (the bench's dtype). The
    launch counts are set to 0 just before and read just after: each
    local step must launch the forward 16 times (8 layers, twice with
    remat) and dQ and dK/dV 8 times each. Then tokens/s, the rounds apart,
    the peak memory and the split of one step by CUDA events (forward,
    loss, backward, adam update, and the flash kernels' share).
12. ``transformer_parity`` — a small transformer (2 layers, d_model 128,
    4 heads, L 256) from one seed: logits and the center after one AEASGD
    round, on the card and on the CPU (the twins), held within a quarter
    (logits) and a half (center) of the CPU run's flash-vs-dense
    distance.

13. ``mlp_train`` — BASELINE config #1 as a user drives it:
    ``SingleTrainer(mnist_mlp(device="cuda"), "adam", batch_size=1024,
    rounds_per_program="auto")`` on ``mnist(flat=True)``, window 8, 3
    rounds, f32 then bf16. ``cnn_train`` — configs #2 and #3:
    ``ADAG(mnist_cnn(), "adam", num_workers=4, batch_size=2048,
    communication_window=8)`` and ``AEASGD(cifar10_cnn(), "sgd",
    num_workers=2, ..., rho=3.0)``, 2 rounds each, f32 then bf16, each
    frame made once. Each row: samples/s, the host milliseconds a local
    step and the split of one by CUDA events, peak memory, the history;
    the losses finite, the parameters moved, and every kernel count set to
    0 before and still 0 after (no TPU kernel's counterpart is on these
    paths: cuDNN and cuBLAS). ``cnn_parity`` — each CNN config at full
    width cut to 2 workers, batch 128, window 1, one round: the card's f32
    center within 4x the CPU f32 run's mean distance from a float64 CPU
    run, the first loss within 1e-4 of the CPU's, and bf16 as every parity
    phase.
14. ``workflow`` — ``examples/mnist_workflow.py``'s chain in the port on
    the card: ``mnist()`` -> ``MinMaxTransformer`` -> ``ReshapeTransformer``
    -> ``OneHotTransformer`` -> ``split`` -> ``ADAG(mnist_cnn(), "adam",
    features_col="img")`` -> ``ClassPredictor``, ``ProbabilityPredictor``,
    ``ModelPredictor`` (2,000 rows at chunk 1024) -> ``AccuracyEvaluator``,
    ``F1Evaluator``, ``LossEvaluator``: rows predicted a second, accuracy
    (must beat 0.5), F1 and loss; the logits within 1e-4 of the CPU plain
    forward on the same weights and the evaluators equal on both but for
    rows whose top two CPU logits lie within 1e-4.
15. ``remote_cnn`` — ``ADAG(mnist_cnn(), remote=srv.endpoint)`` against
    ``PSServer(discipline="adag", device="cuda")`` with int8 commits at
    ``cnn_train``'s workers, batch and window, 2 rounds: one
    ``fold_commit`` launch per folded commit and no other kernel, the
    model equal to the server's center, the handlers' p50 and largest
    times and samples/s. (``fold_kernel`` has the mnist_cnn commit's rows,
    8 tensors, 421,642 parameters, in both codecs.)

16. ``ckpt_serve`` — the persistence plane on config #4 (``TRAIN``'s
    DynSGD at full width and batch), in f32 then bf16: two uninterrupted
    4-round runs (their distance, 0 when the card repeats itself bit for
    bit, is the limit below); a 2-round run with ``checkpoint_dir``,
    ``checkpoint_every=1`` and ``metrics_path``, then a fresh trainer with
    ``resume=True`` to 4 rounds, whose center must equal the uninterrupted
    one within that limit, whose history is 2 rounds long, and whose
    metrics JSONL has one record a round with samples/s and a summary a
    run; the newest step corrupted (``integrity.corrupt_step_dir``) and a
    further resume, which must warn, count ``resilience.ckpt_fallback_steps``
    and run the last round again from the step before; then
    ``serialize_model`` -> bytes -> ``deserialize_model`` on the card, whose
    logits on 256 rows must equal the trained model's bit for bit. Every
    run's stash forward and backward must launch once a local step and the
    inference forward never. ``ckpt_swap`` (f32): ``ModelRegistry(model,
    BUCKETS, directory=...)`` behind a ``ServingFrontend`` and a
    ``ServeClient`` answers at version -1; ``Checkpointer.save(7,
    trained.params)`` and ``poll_once()`` swap in version 7, whose warmup
    probe launches ``lstm_fwd`` once a bucket; the answers after the swap,
    one launch or more a batch, within ``SERVE_ATOL`` of the trained
    weights' CPU plain forward; a newer step saved and corrupted is refused
    (``serving.swap_failures``) and version 7 keeps answering. The rows
    give the ms of a save (the copy to the host, the digest and the write
    apart), of a verified restore, of ``serialize_model`` and
    ``deserialize_model`` (with the blob's bytes) and of one swap (restore
    + probe). The launch counts are set to 0 before each run and read after
    it; this phase's counts are not the ``kernels`` line's.

17. ``remote_overlap`` — the durable server and the overlapped loop on
    config #4 (``REMOTE``'s DynSGD, int8 commits, ``OVERLAP_ROUNDS``
    rounds) against ``PSServer(discipline="dynsgd", device="cuda")``
    three ways, each once: the serial loop without a state directory, the
    serial loop with ``state_dir`` and ``snapshot_every=4`` (what the
    journal costs) and ``DKTPU_NET_INFLIGHT=2`` with both. Each row:
    samples/s (one reading an arm: it does not resolve the arms' samples/s
    against each other), the mean
    realized staleness, ``netps.overlap.hidden_fraction``, the journal's
    bytes and the ms of a snapshot; one ``fold_commit`` launch per folded
    commit, no ``(worker, seq)`` folded twice, the model equal to the
    center. Each directory is then recovered by a fresh ``PSServer(device=
    "cuda", state_dir=...)`` as it is and with its newest snapshot removed:
    both centers bit-equal to the server's, one ``fold_commit`` launch per
    replayed record, the replay's ms per record.
18. ``ps_failover`` — the same training against ``"<primary>,<standby>"``,
    a ``PSServer`` and a ``StandbyServer`` on the card with 1 s leases.
    Once round 1 is folded and replicated (a record at least folded on the
    standby) the primary stops as a dead process would (no drain); the standby must promote to epoch 1
    holding the primary's center at the index it last replicated (the
    primary's center is kept after every fold), the workers walk to it and
    finish with finite losses, no ``(worker, seq)`` folds twice across the
    two servers, no commit carrying the old epoch folds, and
    ``fold_commit`` launches once per primary fold, replicated record and
    standby fold. It prints the seconds from the kill to the promotion and
    to the first commit the standby folded.
19. ``ps_restart`` — the port's CLI, ``python -m distkeras_tpu_torch.netps
    --device cuda --state-dir D``, in a subprocess, SIGKILLed once it has
    folded ``RESTART_KILL_AT`` commits and started again on the same port
    and directory while the workers ride through on retries. The journal
    across both lives holds no ``(worker, seq)`` twice, at most
    ``_WRITE_QUEUE`` acknowledged commits are missing from it, and the
    restarted server's final center is bit-equal to this process's
    recovery of its directory, which launches ``fold_commit`` once per
    replayed record.
20. ``netps_config8`` — config #8 (``bench.py:1465-1468``, the AEASGD
    transformer through the parameter server: 4 layers, d_model 512, 8
    heads, d_ff 2048, vocab 8192, seq 128, batch 4, window 2, 12 rounds,
    one worker, adam at lr 1e-4, alpha 0.05, bf16, flash, remat) at full
    width through the arms the port serves: ``inprocess`` (``AEASGD(...)
    .train(df)``), ``pr4`` (``run_remote`` over TCP, inflight 1), ``shm``
    (the ring, inflight 2) and ``mesh`` (the in-process dispatch into the
    server's device center, inflight 2), one warm run (2 rounds) and two
    timed runs each against a fresh ``PSServer(device="cuda",
    transport=...)``:
    tokens/s (the median of the timed runs), ``shm_vs_pr4``,
    ``mesh_vs_shm``, ``mesh_vs_inprocess``, the dialect counters and the
    RPC spans. The counts are set to 0 before each run and read after it:
    the losses finite and the center moved; the server's commit log holds
    each ``(0, seq)`` once; one ``fold_commit`` launch per folded commit;
    every commit on the arm's dialect, on the client's and on the server's
    side, none on another, and no demotion or ring fallback (in the mesh
    arm ``netps.mesh.folds``, the folds that came through the dispatch,
    equals the commits); the flash kernels in
    bf16 only, 2/1/1 a layer a step. Then a ``MeshFolder`` on the card
    with config #8's 70 tensors folds an f32, a bf16 and two int8 commits
    bit-equal to the numpy oracle; the mesh arm again with the server's
    token unregistered after 4 folds (each of the worker's two clients
    demotes once, onto the ring; the server folds at least 4 commits from
    the dispatch and the rest from the ring, each once); and a mesh run
    at inflight 1 whose center must equal ``pr4``'s (or lie within the
    distance of two ``pr4`` runs, when the card does not repeat itself).
    The arms that need an unported item (``optimized``, ``durable``,
    ``auto``, ``hier_curve``, ``sim_drift``) are named as such.

Then ``seconds`` (each phase's wall time), the ``kernels`` line, the
card's name and power limit, and as the last line ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

# IMDB LSTM classifier at full width (BASELINE config #4).
VOCAB, EMBED, HIDDEN, SEQ_LEN = 20000, 64, 128, 200
BUCKETS = (1, 4, 16, 64, 256)
KERNEL_BATCHES = (1, 16, 256)
STASH_BATCHES = (256, 2048)
BWD_BATCHES = (1, 131, 256, 2048)
# Config #4's training run (bench.py: DynSGD, batch 2048, window 4, sgd,
# lr 0.01), cut to 4 workers and 3 rounds.
TRAIN = dict(num_workers=4, batch_size=2048, communication_window=4,
             learning_rate=0.01)
TRAIN_ROUNDS = 3
PARITY = dict(num_workers=2, batch_size=32, communication_window=2,
              learning_rate=0.01)
PARITY_ROUNDS = 2
#: ``imdb_lstm()`` at its own defaults (E=H=128, seq_len 80), trained in
#: bf16 as config #4's run is, cut to 2 rounds.
IMDB_ROUNDS = 2

#: kernel vs plain on hs in (-1, 1): the same f32 arithmetic summed in
#: another order (192-term gate sums), over a 200-step recurrence. The
#: stash forward's cs and gates carry the same error.
KERNEL_ATOL = 1e-5
#: backward vs plain and vs autograd, as a share of each gradient's
#: largest magnitude: dWx/dWh/db are sums over B*T = up to 409,600 rows and
#: dx/dh over 512 gate columns, in another order than the plain twin's
#: matrix products (f32 carries about 7 digits).
BWD_RTOL = 1e-4
#: trained center, card vs CPU: 8 SGD steps at lr 0.01 on gradients that
#: agree to about 1e-6 of their size.
PARITY_ATOL = 1e-5
#: served logits vs the plain CPU forward of the same weights: the kernel's
#: hs error above, carried through the 128-wide head, plus CPU-vs-card
#: float32 matmul order in the head.
SERVE_ATOL = 1e-4

#: the dtypes of the kernel rows: float32, and bfloat16, the
#: mixed-precision step's (``compute_dtype="bfloat16"``).
DTYPES = ("float32", "bfloat16")
#: one bf16 unit in the last place, as a share of the value (8 bits).
BF16_ULP = 2.0 ** -8
#: bf16 LSTM kernels vs their bf16 twins, as shares of the twin's largest
#: (``top``) and mean (``mean``) magnitude. Both round at the same points
#: (bf16 operands, f32 sums and carry, bf16 stores); the f32 sums run in
#: another order, so a rounding now and then flips by one ulp, and the
#: recurrence feeds the rounded h (forward) and dpre (backward) on, so a
#: flip moves later sums and flips more: a few ulps at the top, about an
#: ulp in the mean.
LSTM_BF16 = {"top": 8 * BF16_ULP, "mean": 2 * BF16_ULP}
#: bf16 GroupNorm kernels vs their bf16 twins: no carry, f32 statistics
#: and sums on the same bf16 values, so one flipped rounding of one
#: output, at most one ulp of the largest magnitude (dy zeroed within 1e-2
#: of the ReLU edge, as for f32).
GN_BF16_TOP = BF16_ULP
#: the bf16 parity runs (``*_parity`` phases, ``compute_dtype=
#: "bfloat16"``): the card's bf16 run against the CPU's bf16 run (the plain
#: twins) from the same weights and data, each distance as a share of the
#: CPU's own bf16-vs-f32 distance (the size of bf16's rounding in that
#: run). The two bf16 runs round at the same points, but their f32 sums
#: run in another order, so roundings flip and the runs decorrelate: two
#: independent bf16 roundings sit up to sqrt(2) ~ 1.41 of one rounding's
#: distance from f32 apart. A wrong gradient strays by a share of the
#: whole update, printed beside. Written before the first run of these
#: phases.
BF16_PARITY_SHARE = 1.5
#: the CNN parity rows' bf16 share, tighter: one window-1 step barely
#: decorrelates the two bf16 runs (0.00001 and 0.037 of the CPU's
#: bf16-vs-f32 distance, mnist_cnn and cifar10_cnn), while a card run that
#: stayed in f32 would read about 1.0, which 1.5 lets pass.
CNN_BF16_PARITY_SHARE = 0.3

# ResNet-50 (BASELINE config #5, bench.py: "sync", batch 128, window 2,
# sgd, lr 0.01, 224x224x3, 1000 classes), f32, cut to 3 rounds.
RESNET = dict(batch_size=128, steps_per_program=2, num_workers=1,
              learning_rate=0.01)
RESNET_ROUNDS = 3
RESNET_PARITY = dict(batch_size=2, steps_per_program=2, num_workers=1,
                     learning_rate=0.01)
#: every distinct GroupNorm slab of ResNet-50 at 224x224: (N = H*W, C,
#: fused ReLU, GroupNorms of that slab in one forward). 53 in all: the
#: stem, three in each of the 16 blocks, one residual projection a stage.
GN_SLABS = ((112 * 112, 64, True, 1), (56 * 56, 64, True, 6),
            (56 * 56, 256, False, 4), (56 * 56, 128, True, 1),
            (28 * 28, 128, True, 7), (28 * 28, 512, False, 5),
            (28 * 28, 256, True, 1), (14 * 14, 256, True, 11),
            (14 * 14, 1024, False, 7), (14 * 14, 512, True, 1),
            (7 * 7, 512, True, 5), (7 * 7, 2048, False, 4))
GN_PER_STEP = sum(n for *_, n in GN_SLABS)
GN_GROUPS = 32
#: GroupNorm forward vs the plain twin on unit-normal x: f32 statistics
#: over up to 25,088 elements a group summed in another order, outputs
#: of a few units.
GN_ATOL = 1e-5
#: GroupNorm backward vs the plain twin, as a share of each gradient's
#: largest magnitude: dgamma and dbeta are sums over B*N = up to 1.6 M
#: rows, in another order.
GN_BWD_RTOL = 1e-4
#: ResNet-50 at its random init, batch 2, in f32 is ill-conditioned: ReLU
#: inputs within rounding of 0 flip with the summation order, and on the
#: CPU the f32 gradients of one step differ from the f64 ones by 2.5 % of
#: their size with either GroupNorm impl. So the card's trained center is
#: held to a float64 CPU run from the same weights and data: its error may
#: be at most this many times the CPU f32 run's error (a wrong gradient
#: strays by a share of the whole update, which is printed beside it).
RESNET_PARITY_FACTOR = 4.0
#: the round loss, card vs CPU, as a share of itself: the forward alone,
#: 53 normalized layers of f32 convolutions summed in another order.
RESNET_LOSS_RTOL = 1e-4

#: The fold's commit scales (DynSGD at staleness 0 and 2); its shapes are
#: every tensor of config #4's model and ResNet-50's two largest (3x3x512x512
#: conv kernels, 2,359,296 elements each), read off the models themselves.
FOLD_SCALES = (1.0, 1.0 / 3.0)
FOLD_RESNET_TENSORS = 2
FOLD_REPS = 20
#: the remote runs: config #4's training run (as ``train``) against the
#: port's parameter server, int8 commits, then a shorter one in bf16.
REMOTE = dict(TRAIN)
REMOTE_ROUNDS = {"int8": 3, "bf16": 2}
REMOTE_PARITY = dict(num_workers=1, batch_size=32, communication_window=2,
                     learning_rate=0.01)
REMOTE_PARITY_ROUNDS = 2
#: remote card vs CPU with codec none: the same limit as ``train_parity``.
REMOTE_PARITY_ATOL = 1e-5
#: the durable and failover phases, at config #4's remote run (int8): the
#: three arms of ``remote_overlap`` (serial, serial with a state directory,
#: ``DKTPU_NET_INFLIGHT=2`` with one) train this many rounds each, the
#: server snapshotting every ``OVERLAP_SNAPSHOT_EVERY`` folds (so with 4
#: workers the last snapshot covers every fold, and the fallback recovery
#: replays the journal after the one before);  ``ps_failover`` trains
#: ``FAILOVER_ROUNDS`` against a primary and a standby with leases (and
#: the standby's silence budget) of ``FAILOVER_LEASE`` seconds;
#: ``ps_restart`` trains ``RESTART_ROUNDS`` against the CLI server (its
#: journal alone, no snapshots, so it holds both lives), SIGKILLed once it
#: has folded ``RESTART_KILL_AT`` commits.
OVERLAP_ROUNDS = 4
OVERLAP_SNAPSHOT_EVERY = 4
FAILOVER_ROUNDS = 5
FAILOVER_LEASE = 1.0
RESTART_ROUNDS = 5
RESTART_KILL_AT = 8
#: L2 is 50 MB: reading this many bytes between timed calls leaves a
#: center and its delta cold, as the server finds them between commits.
FLUSH_BYTES = 256 << 20

#: H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM bytes/s,
#: float32 outside the tensor cores, and bf16 on the tensor cores (the
#: flash kernels' products, and the bf16 LSTM's: bf16 operands, f32
#: sums).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

# The flash transformer at full width (BASELINE config #7, bench.py:
# TransformerLM(vocab 32768, 8 layers, d_model 1024, 16 heads, d_ff 4096,
# seq 2048, attn_impl="flash", remat=True) as one AEASGD worker, adam,
# lr 1e-4, rho 500 (alpha 0.05), batch 8, window 8), f32 where the bench
# runs bf16, cut to 2 rounds (16 local steps).
LM = dict(vocab_size=32768, num_layers=8, d_model=1024, num_heads=16,
          d_ff=4096, max_seq_len=2048)
LM_SEQ = 2048
LM_TRAIN = dict(num_workers=1, batch_size=8, communication_window=8,
                learning_rate=1e-4, rho=500.0)
LM_ROUNDS = 2
#: the flash kernels' shapes [B, L, H, D]: config #7's, then ragged ones
#: (L not a tile multiple, D = 32, B*H = 1), then the design's edges: L
#: not a multiple of a tile's rows (72, 136; the forward's second
#: warpgroup with and without rows before L), a load ring wrapped many
#: times (L = 1024, B*H = 2) and D = 128 (two column boxes, 32-query tiles
#: in dK/dV) at L = 512, then a head dim the kernels take only zero-padded
#: (D = 40, run at 48); each of those at least 1024 rows (B*L*H), since
#: one order-flipped bf16 rounding of p moves a whole output row and over
#: fewer rows can alone pass the mean limit (an earlier forward at [1, 72,
#: 2, 64] f32 read 1.22e-5, its largest error 4.5e-4).
FLASH_SHAPES = ((8, LM_SEQ, 16, 64), (2, 40, 4, 64), (2, 200, 4, 64),
                (2, 256, 4, 32), (1, LM_SEQ, 1, 64), (4, 72, 4, 64),
                (2, 136, 4, 128), (2, 1024, 1, 64), (1, 512, 2, 128),
                (2, 512, 2, 40))
#: flash kernels vs their twins, as shares of the twin's largest (``top``)
#: and mean (``mean``) magnitude. f32: the same bf16 rounding points and
#: only the order of the f32 sums differs, so the mean error is f32 level;
#: where the order flips the bf16 rounding of one p or ds, that element
#: moves by one bf16 step (2^-8 of itself), which ``top`` allows. bf16
#: outputs add their own rounding (2^-8 of each element). lse in absolute
#: terms (f32 sums of up to 2048 terms near log(2048)).
FLASH_LIMITS = {"float32": {"top": 2e-3, "mean": 1e-5},
                "bfloat16": {"top": 1e-2, "mean": 1e-3}}
FLASH_LSE_ATOL = 1e-5
#: the shapes at which the f32 forward's and backward's errors against the
#: twins are attributed to bf16 rounding flips (``flash_flips.
#: forward_flips``, ``backward_flips``): each of FLASH_SHAPES but config
#: #7's, and two with few rows (B*L*H 272 and 144) where one flip of p or
#: ds can alone pass the mean limit, so that only this measure, which rows
#: cannot dilute, holds them.
FLASH_FLIP_SHAPES = tuple(s for s in FLASH_SHAPES if s != FLASH_SHAPES[0]) \
    + ((1, 136, 2, 128), (1, 72, 2, 64))
#: the small transformer run on the card and on the CPU from one seed
#: (2 layers, d_model 128, 4 heads of 32, d_ff 512, vocab 1024, L 256,
#: batch 2, one AEASGD round of window 2): the card-vs-CPU distance may
#: be at most a share of the CPU run's flash-vs-dense-f32 distance (the
#: rounding the design puts in: bf16 operands). A quarter for the logits
#: (a forward: the two differ only where an f32 sum order flips a bf16
#: rounding of p). Half for the center after training: ds = bf16(p * (dp
#: - delta)) rounds a difference that cancels at random init, so sum-order
#: noise flips ds's rounding often, and on the CPU the JAX package's flash
#: run and the port's, the same arithmetic in another order, already read
#: 0.24-0.33 of their flash-vs-dense distance on the center.
LM_PARITY = dict(vocab_size=1024, num_layers=2, d_model=128, num_heads=4,
                 d_ff=512, max_seq_len=256)
LM_PARITY_SEQ = 256
LM_PARITY_TRAIN = dict(num_workers=1, batch_size=2, communication_window=2,
                       learning_rate=1e-4, rho=500.0)
LM_PARITY_LOGITS_SHARE = 0.25
LM_PARITY_CENTER_SHARE = 0.5

# BASELINE configs #1-#3 at full width (bench.py:1398-1417, learning rate
# 0.01 as bench.py trains them): the MNIST MLP under SingleTrainer (adam,
# batch 1024, window 8, rounds_per_program="auto") cut to 3 rounds; the
# MNIST CNN under ADAG (adam) and the CIFAR-10 CNN under AEASGD (sgd, rho
# 3.0, as examples/cifar10_aeasgd.py), both at batch 2048 and window 8,
# cut to 4 and 2 workers and 2 rounds. No TPU kernel is on these paths:
# the convolutions, pools and dense layers are cuDNN's and cuBLAS's.
MLP_TRAIN = dict(batch_size=1024, steps_per_program=8, learning_rate=0.01,
                 rounds_per_program="auto")
MLP_ROUNDS = 3
CNN_TRAIN = (
    ("mnist_cnn", "ADAG", dict(worker_optimizer="adam", num_workers=4,
                               batch_size=2048, communication_window=8,
                               learning_rate=0.01)),
    ("cifar10_cnn", "AEASGD", dict(worker_optimizer="sgd", num_workers=2,
                                   batch_size=2048, communication_window=8,
                                   learning_rate=0.01, rho=3.0)))
CNN_ROUNDS = 2
#: the CNN parity runs: the same trainers and widths cut to 2 workers,
#: batch 128 and window 1, one round. The card's f32 center is held to a
#: float64 CPU run from the same weights as ResNet-50's is
#: (``RESNET_PARITY_FACTOR``: ReLU and max-pool edges flip with the sum
#: order, and adam's eps turns f32 gradient rounding into update
#: differences up to a share of the learning rate), bf16 to
#: ``CNN_BF16_PARITY_SHARE``.
CNN_PARITY = dict(num_workers=2, batch_size=128, communication_window=1)
#: examples/mnist_workflow.py's chain on the card: mnist() rows, split
#: 0.9, ADAG(mnist_cnn, adam, lr 0.002 as the example) with 4 workers,
#: batch 256 and window 8 (2 rounds of the 18,000 training rows), then
#: the predictors at chunk 1024 on the 2,000 test rows (not a multiple).
WORKFLOW = dict(rows=20000, num_workers=4, batch_size=256,
                communication_window=8, learning_rate=0.002,
                chunk_size=1024)
#: the workflow's predict rate: ClassPredictor over the test images
#: repeated to 25 chunks of 1024 (the last 976 rows, padded), after one
#: warm call at that size; the median of 3 calls.
WORKFLOW_RATE_ROWS = 25 * 1024 - 48
#: the workflow's accuracy must beat this (chance is 0.1; the synthetic
#: classes separate).
WORKFLOW_MIN_ACCURACY = 0.5


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


def interleaved_ms(torch, fns: dict, reps: int, readings: int = 3) -> dict:
    """Each of ``fns`` timed ``readings`` times by :func:`cuda_ms`, in turns
    (a, b, a, b, ...), so that a drift of the card's clock or of its
    neighbours reaches all of them alike: ``{name: (median ms,
    [readings])}``."""
    got = {k: [] for k in fns}
    for _ in range(readings):
        for k, fn in fns.items():
            got[k].append(cuda_ms(torch, fn, reps))
    return {k: (float(np.median(v)), v) for k, v in got.items()}


def lstm_speed(row: dict) -> dict:
    """An LSTM row's ratio to the library call (below 1: faster than
    cuDNN), its share of the bound (bound over kernel time) and its
    microseconds a time step."""
    return {"ratio_to_library": row["ms"] / row["library_ms"],
            "bound_share": row["bound_ms"] / row["ms"],
            "us_per_step": row["ms"] * 1e3 / row["T"]}


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple:
    """The larger of the bytes over the memory rate and the FLOPs over
    ``peak_flops``, in ms, and which of the two it is."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def lstm_peak(itemsize: int) -> float:
    """The rate the LSTM's products could run at: f32 outside the tensor
    cores for f32 operands, the tensor cores' bf16 rate for bf16 ones."""
    return PEAK_F32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS


def lstm_bound_ms(B: int, T: int, E: int, H: int,
                  itemsize: int = 4) -> tuple[float, str]:
    """Least time for the LSTM forward on this card: x, the weights and b
    read once and hs written once (``itemsize`` bytes each), against the
    gate products and bias adds at :func:`lstm_peak`."""
    nbytes = itemsize * (B * T * E + (E + H + 1) * 4 * H + B * T * H)
    flops = 2 * T * B * (E + H) * 4 * H + T * B * 4 * H
    return bound(nbytes, flops, lstm_peak(itemsize))


def stash_bound_ms(B: int, T: int, E: int, H: int,
                   itemsize: int = 4) -> tuple[float, str]:
    """The stash forward: the forward's reads and FLOPs, and hs, cs and
    gates written once."""
    nbytes = itemsize * (B * T * E + (E + H + 1) * 4 * H
                         + B * T * (2 * H + 4 * H))
    flops = 2 * T * B * (E + H) * 4 * H + T * B * 4 * H
    return bound(nbytes, flops, lstm_peak(itemsize))


def bwd_bound_ms(B: int, T: int, E: int, H: int,
                 itemsize: int = 4) -> tuple[float, str]:
    """The BPTT backward: dhs, x, hs, cs, gates, Wx and Wh read once, dx,
    dWx, dWh and db written once (the kernel's dpre workspace is its own
    choice and not counted), against the four products of 2*T*B*(E+H)*4H
    FLOPs' worth each pair (dx and dh; dWx and dWh) at
    :func:`lstm_peak`."""
    nbytes = itemsize * (B * T * (3 * H + E + 4 * H) + 2 * (E + H) * 4 * H
                         + B * T * E + 4 * H)
    flops = 4 * T * B * (E + H) * 4 * H
    return bound(nbytes, flops, lstm_peak(itemsize))


def library_lstm(torch, m, dtype=None):
    """``torch.nn.LSTM`` (cuDNN) loaded with the model's packed weights, in
    ``dtype`` (default f32): the yardstick the kernel rows time, never
    called by the port."""
    lib = torch.nn.LSTM(EMBED, HIDDEN, batch_first=True).cuda()
    with torch.no_grad():
        lib.weight_ih_l0.copy_(m.lstm_wx.detach().t())
        lib.weight_hh_l0.copy_(m.lstm_wh.detach().t())
        lib.bias_ih_l0.copy_(m.lstm_b.detach())
        lib.bias_hh_l0.zero_()
    return lib.to(dtype or torch.float32)


def rel_err(torch, got, ref) -> float:
    """Largest error as a share of the reference's largest magnitude."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def shares(got, ref) -> tuple:
    """(largest abs error, as a share of the largest magnitude, mean error
    as a share of the mean magnitude), in f32."""
    d = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    return (d.max().item(), d.max().item() / max(r.max().item(), 1e-30),
            d.mean().item() / max(r.mean().item(), 1e-30))


def check_bf16_lstm(name: str, B: int, pairs) -> dict:
    """The bf16 LSTM rows' error fields over (got, ref) pairs; fails past
    :data:`LSTM_BF16`."""
    errs = [shares(a, r) for a, r in pairs]
    out = {"max_abs_err": max(e[0] for e in errs),
           "max_err_share": max(e[1] for e in errs),
           "mean_err_share": max(e[2] for e in errs),
           "limit_max_share": LSTM_BF16["top"],
           "limit_mean_share": LSTM_BF16["mean"]}
    if not (out["max_err_share"] <= LSTM_BF16["top"]
            and out["mean_err_share"] <= LSTM_BF16["mean"]):
        fail(f"{name} bf16 disagrees with its plain twin at B={B}: {out}")
    return out


def f32_tiling(K, B: int, kernel: str) -> dict:
    """The tiling the f32 LSTM ``kernel`` runs at batch ``B``: the tile's
    rows ``R`` and the cluster's blocks ``C`` (``K.f32_tiling``), the
    clusters the call needs and the most the card holds at once."""
    R, C = K.f32_tiling(B, HIDDEN)
    return {"R": R, "C": C, "clusters": -(-B // R),
            "max_active_clusters": K.f32_max_clusters(kernel, HIDDEN, R, C)}


def kernel_phase(torch, K, model, rng) -> dict:
    """The LSTM kernel against its plain version at the serving shapes, on
    the served model's own weights and embedded tokens, in f32 and in bf16
    (the weights and x cast). Returns ``{dtype: {B: row}}``."""
    m = model.module
    rows = {dt: {} for dt in DTYPES}
    with torch.inference_mode():
        for B in KERNEL_BATCHES:
            tokens = torch.as_tensor(
                rng.integers(0, VOCAB, (B, SEQ_LEN)), device="cuda")
            x32 = m.embed(tokens).contiguous()
            for name in DTYPES:
                dt = getattr(torch, name)
                wx, wh, b, x = (t.detach().to(dt) for t in (
                    m.lstm_wx, m.lstm_wh, m.lstm_b, x32))
                lib = library_lstm(torch, m, dt)
                got = K.lstm_seq(wx, wh, b, x)
                torch.cuda.synchronize()
                ref = K.lstm_seq_plain(wx, wh, b, x)
                lib_err = (lib(x)[0] - ref).abs().max().item()
                reps = 20 if B <= 16 else 10
                row = {"phase": "kernel", "name": "lstm_fwd", "B": B,
                       "T": SEQ_LEN, "E": EMBED, "H": HIDDEN, "dtype": name,
                       "library_max_abs_err": lib_err}
                if name == "float32":
                    row.update(f32_tiling(K, B, "lstm_fwd"))
                    err = (got - ref).abs().max().item()
                    row.update(max_abs_err=err, atol=KERNEL_ATOL,
                               max_rel_err=err / max(
                                   ref.abs().max().item(), 1e-30))
                    if not err <= KERNEL_ATOL:
                        fail(f"lstm_fwd disagrees with lstm_seq_plain at "
                             f"B={B}: max abs err {err} > {KERNEL_ATOL}")
                else:
                    row.update(check_bf16_lstm("lstm_fwd", B, [(got, ref)]))
                bound_ms, bound_by = lstm_bound_ms(
                    B, SEQ_LEN, EMBED, HIDDEN, x.element_size())
                row.update(
                    ms=cuda_ms(torch, lambda: K.lstm_seq(wx, wh, b, x), reps),
                    plain_ms=cuda_ms(
                        torch, lambda: K.lstm_seq_plain(wx, wh, b, x), 5),
                    library_ms=cuda_ms(torch, lambda: lib(x), reps),
                    bound_ms=bound_ms, bound_by=bound_by)
                row.update(lstm_speed(row))
                emit(row)
                rows[name][B] = row
    return rows


def stash_phase(torch, K, model, rng) -> dict:
    """The stash forward against its plain version on hs, cs and gates, at
    the training batch and below, on the model's weights and embedded
    tokens, in f32 and bf16; the library row is ``torch.nn.LSTM``'s
    forward with a gradient wanted (cuDNN then keeps its own backward
    workspace). Returns ``{dtype: {B: row}}``."""
    m = model.module
    rows = {dt: {} for dt in DTYPES}
    for B in STASH_BATCHES:
        tokens = torch.as_tensor(rng.integers(0, VOCAB, (B, SEQ_LEN)),
                                 device="cuda")
        with torch.no_grad():
            x32 = m.embed(tokens).contiguous()
        for name in DTYPES:
            dt = getattr(torch, name)
            wx, wh, b, x = (t.detach().to(dt) for t in (
                m.lstm_wx, m.lstm_wh, m.lstm_b, x32))
            lib = library_lstm(torch, m, dt)
            with torch.no_grad():
                got = K.lstm_fwd_stash_cuda(wx, wh, b, x)
                torch.cuda.synchronize()
                ref = K.lstm_fwd_stash_plain(wx, wh, b, x)
                row = {"phase": "kernel", "name": "lstm_fwd_stash", "B": B,
                       "T": SEQ_LEN, "E": EMBED, "H": HIDDEN, "dtype": name,
                       "compared": "hs, cs, gates vs lstm_fwd_stash_plain"}
                if name == "float32":
                    row.update(f32_tiling(K, B, "lstm_fwd_stash"))
                    err = max((a - r).abs().max().item()
                              for a, r in zip(got, ref))
                    row.update(max_abs_err=err, atol=KERNEL_ATOL)
                    if not err <= KERNEL_ATOL:
                        fail(f"lstm_fwd_stash disagrees with "
                             f"lstm_fwd_stash_plain at B={B}: max abs err "
                             f"{err} > {KERNEL_ATOL}")
                else:
                    row.update(check_bf16_lstm("lstm_fwd_stash", B,
                                               zip(got, ref)))
                del got, ref
                plain_ms = cuda_ms(
                    torch, lambda: K.lstm_fwd_stash_plain(wx, wh, b, x), 3)
            xg = x.clone().requires_grad_()

            def kernel():
                with torch.no_grad():
                    return K.lstm_fwd_stash_cuda(wx, wh, b, x)

            t = interleaved_ms(torch, {"kernel": kernel,
                                       "library": lambda: lib(xg)}, 10)
            bound_ms, bound_by = stash_bound_ms(B, SEQ_LEN, EMBED, HIDDEN,
                                                x.element_size())
            row.update(ms=t["kernel"][0], plain_ms=plain_ms,
                       library_ms=t["library"][0],
                       ms_readings=t["kernel"][1],
                       library_readings=t["library"][1],
                       bound_ms=bound_ms, bound_by=bound_by)
            row.update(lstm_speed(row))
            emit(row)
            rows[name][B] = row
    return rows


def bwd_phase(torch, K, model, rng) -> dict:
    """The BPTT kernel on the stash forward's residuals and a dense random
    dhs, held against the plain twin (and, in f32, against autograd
    through the plain forward), on dx, dWx, dWh and db, in f32 and bf16;
    the library row is ``torch.nn.LSTM``'s backward alone
    (``autograd.grad`` on a retained graph). Returns ``{dtype: {B:
    row}}``."""
    m = model.module
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    rows = {dt: {} for dt in DTYPES}
    names = ("dwx", "dwh", "db", "dx")
    for B in BWD_BATCHES:
        tokens = torch.as_tensor(rng.integers(0, VOCAB, (B, SEQ_LEN)),
                                 device="cuda")
        with torch.no_grad():
            x32 = m.embed(tokens).contiguous()
        dhs32 = torch.randn((B, SEQ_LEN, HIDDEN), device="cuda",
                            generator=gen) / 10
        for name in DTYPES:
            dt = getattr(torch, name)
            wx, wh, b, x, dhs = (t.detach().to(dt) for t in (
                m.lstm_wx, m.lstm_wh, m.lstm_b, x32, dhs32))
            lib = library_lstm(torch, m, dt)
            with torch.no_grad():
                hs, cs, gates = K.lstm_fwd_stash_cuda(wx, wh, b, x)
            got = K.lstm_bwd_cuda(wx, wh, x, hs, cs, gates, dhs)
            again = K.lstm_bwd_cuda(wx, wh, x, hs, cs, gates, dhs)
            torch.cuda.synchronize()
            plain = K.lstm_bwd_plain(wx, wh, x, hs, cs, gates, dhs)
            repeatable = all(torch.equal(a, a2) for a, a2 in zip(got, again))
            row = {"phase": "kernel", "name": "lstm_bwd", "B": B,
                   "T": SEQ_LEN, "E": EMBED, "H": HIDDEN, "dtype": name,
                   "repeatable_bits": repeatable,
                   "splits": K.bwd_splits(B * SEQ_LEN)}
            if name == "float32":
                row.update(f32_tiling(K, B, "lstm_bwd_recurrent"))
                leaves = [t.clone().requires_grad_() for t in (wx, wh, b, x)]
                # dwx, dwh, db, dx: the leaves' order
                auto = torch.autograd.grad(
                    (K.lstm_seq_plain(*leaves) * dhs).sum(), leaves)
                rel_plain = {n: rel_err(torch, a, r)
                             for n, a, r in zip(names, got, plain)}
                rel_auto = {n: rel_err(torch, a, r)
                            for n, a, r in zip(names, got, auto)}
                del auto, leaves
                row.update(max_abs_err=max((a - r).abs().max().item()
                                           for a, r in zip(got, plain)),
                           rel_err_vs_plain=rel_plain,
                           rel_err_vs_autograd=rel_auto, rtol=BWD_RTOL)
                worst = max(max(rel_plain.values()), max(rel_auto.values()))
                if not worst <= BWD_RTOL:
                    fail(f"lstm_bwd disagrees at B={B}: relative error "
                         f"{worst} > {BWD_RTOL} (vs plain {rel_plain}, vs "
                         f"autograd {rel_auto})")
            else:
                row.update(check_bf16_lstm("lstm_bwd", B, zip(got, plain)))
            if not repeatable:
                fail(f"lstm_bwd gave different bits on two calls at B={B} "
                     f"{name}")
            del plain, again, got
            plain_ms = cuda_ms(torch, lambda: K.lstm_bwd_plain(
                wx, wh, x, hs, cs, gates, dhs), 3)
            # cuDNN's backward alone: autograd.grad on a retained graph.
            xg = x.clone().requires_grad_()
            out = lib(xg)[0]
            inputs = [xg, *lib.parameters()]
            fns = {"kernel": lambda: K.lstm_bwd_cuda(wx, wh, x, hs, cs,
                                                     gates, dhs),
                   "library": lambda: torch.autograd.grad(
                       out, inputs, dhs, retain_graph=True)}
            # the two entry points apart, on the workspace of one call
            dp, dbp = K.lstm_bwd_recurrent_cuda(wh, cs, gates, dhs)
            fns["recurrent"] = lambda: K.lstm_bwd_recurrent_cuda(
                wh, cs, gates, dhs)
            fns["wgrad"] = lambda: K.lstm_bwd_wgrad_cuda(wx, x, hs, dp, dbp)
            t = interleaved_ms(torch, fns, 10)
            del out, inputs, fns, dp, dbp
            bound_ms, bound_by = bwd_bound_ms(B, SEQ_LEN, EMBED, HIDDEN,
                                              x.element_size())
            row.update(ms=t["kernel"][0], plain_ms=plain_ms,
                       library_ms=t["library"][0],
                       ms_readings=t["kernel"][1],
                       library_readings=t["library"][1],
                       recurrent_ms=t["recurrent"][0],
                       wgrad_ms=t["wgrad"][0],
                       bound_ms=bound_ms, bound_by=bound_by)
            row.update(lstm_speed(row))
            emit(row)
            rows[name][B] = row
    return rows


def step_split(torch, model, x, y, tx, steps: int = 3, timed=None,
               dtype=None, head_start: bool = False) -> dict:
    """Milliseconds of one local training step on ``x, y`` with the
    optimizer ``tx``, split by CUDA events into the forward, the loss, the
    backward and the update; the mean of ``steps`` steps after a warm one.
    With ``timed = (module, {wrapper name: key})`` it also sums CUDA events
    around every call of each named kernel wrapper of ``module`` inside
    the step (``key`` in the result, and its calls a step under
    ``calls``). ``dtype`` (bf16) is the mixed-precision step: the f32
    leaves and a float ``x`` cast inside the forward, as the local loop
    does. Events read when the card reaches them, so where the host
    enqueues a step more slowly than the card runs it the split is the
    host's pace; with ``head_start`` a spin kernel holds the card before
    each timed step for at least twice the warm step's host time, so the
    host enqueues the whole step first and the split is the card's own
    time (the host's milliseconds for the warm step under ``host_ms``)."""
    from torch.func import functional_call

    from distkeras_tpu_torch.ops import cast_floats
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import apply_updates

    loss_fn = get_loss("sparse_categorical_crossentropy")
    params = model.params
    opt = tx.init(params)
    module = model.module
    kmod, names = timed if timed is not None else (None, {})
    spans = {key: [] for key in names.values()}
    patched = {}
    if kmod is not None:
        def wrap(fn, key):
            def call(*args, **kwargs):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = fn(*args, **kwargs)
                ev[1].record()
                spans[key].append(ev)
                return out
            return call

        for name, key in names.items():
            patched[name] = getattr(kmod, name)
            setattr(kmod, name, wrap(patched[name], key))
    module.train()
    parts = {"forward": 0.0, "loss": 0.0, "backward": 0.0, "update": 0.0}
    kernel_ms = {k: 0.0 for k in spans}
    cycles = 0
    try:
        for i in range(steps + 1):
            for v in spans.values():
                v.clear()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            if cycles:
                torch.cuda._sleep(cycles)
            t0 = time.perf_counter()
            ev[0].record()
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            out = functional_call(module, cast_floats(leaves, dtype),
                                  (cast_floats(x, dtype),))
            ev[1].record()
            loss = loss_fn(out.float(), y)
            ev[2].record()
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            del out, loss
            ev[3].record()
            updates, opt = tx.update(grads, opt, params)
            params = apply_updates(params, updates)
            del grads, updates
            ev[4].record()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            if head_start and not i:
                cycles = head_start_cycles(torch, host_ms)
                parts_host_ms = host_ms
            if i:
                for j, k in enumerate(parts):
                    parts[k] += ev[j].elapsed_time(ev[j + 1]) / steps
                for k, v in spans.items():
                    kernel_ms[k] += sum(a.elapsed_time(b)
                                        for a, b in v) / steps
    finally:
        module.eval()
        for name, fn in patched.items():
            setattr(kmod, name, fn)
    parts["step"] = sum(parts.values())
    if head_start:
        parts["host_ms"] = parts_host_ms
    if kmod is not None:
        parts.update(kernel_ms)
        parts["calls"] = {k: len(v) for k, v in spans.items()}
    return parts


def only_dtype(name: str, entries: dict, dtype: str) -> None:
    """Fail unless every entry point launched in a run is of ``dtype``'s
    instantiation (``*_f32`` or ``*_bf16``)."""
    suffix = {"float32": "_f32", "bfloat16": "_bf16"}[dtype]
    other = {k: v for k, v in entries.items() if v and not k.endswith(suffix)}
    if other:
        fail(f"the {dtype} {name} run launched other instantiations: {other}")


def train_phase(torch, K, gpu: str, seed: int, dtype: str = "float32",
                rounds: int = TRAIN_ROUNDS, widths: dict = None,
                stash_entry: str = None):
    """Train as a user would, at ``compute_dtype=dtype``, config #4's
    model or ``imdb_lstm(**widths)``; returns the trained model and the
    launch counts of the run. With ``stash_entry``, every stash forward of
    the run must have launched that C entry point."""
    from distkeras_tpu_torch import imdb_lstm, telemetry
    from distkeras_tpu_torch.datasets import imdb
    from distkeras_tpu_torch.ops.optimizers import sgd
    from distkeras_tpu_torch.trainers import DynSGD

    widths = widths or dict(vocab_size=VOCAB, embed_dim=EMBED,
                            hidden_size=HIDDEN, seq_len=SEQ_LEN)
    model = imdb_lstm(**widths, seed=seed, device="cuda")
    W, Kw, B = (TRAIN["num_workers"], TRAIN["communication_window"],
                TRAIN["batch_size"])
    df = imdb(n=rounds * W * Kw * B, vocab_size=widths["vocab_size"],
              seq_len=widths["seq_len"], seed=seed)
    trainer = DynSGD(model, worker_optimizer="sgd",
                     loss="sparse_categorical_crossentropy", **TRAIN,
                     compute_dtype=dtype)
    telemetry.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()  # counts start at 0 just before the main path runs
    t0 = time.perf_counter()
    trained = trainer.train(df)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    entries = K.launch_counts(by_entry=True)
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.get_history()
    steps = rounds * W * Kw
    moved = max((trained.params[k] - v).abs().max().item()
                for k, v in model.params.items())
    split = step_split(torch, trained,
                       torch.as_tensor(df["features"][:B], device="cuda"),
                       torch.as_tensor(df["label"][:B], device="cuda"),
                       sgd(TRAIN["learning_rate"]),
                       timed=(K, {"lstm_fwd_stash_cuda": "lstm_fwd_stash_ms",
                                  "lstm_bwd_cuda": "lstm_bwd_ms"}),
                       dtype=getattr(torch, dtype))
    snap = telemetry.get().snapshot()
    emit({"phase": "train", "gpu": gpu, "trainer": "DynSGD",
          "model": f"imdb_lstm({widths})", "rounds": rounds, **TRAIN,
          "dtype": dtype,
          "compute_dtype": dtype, "launches_by_entry": entries,
          "peak_memory_gb": peak / 1e9,
          "seconds": wall, "samples_per_s": steps * B / wall,
          "ms_per_local_step": wall / steps * 1e3,
          "history": [float(v) for v in hist],
          "worker_histories": trainer.get_worker_histories().tolist(),
          "launches": launches, "local_steps": steps,
          "center_max_abs_change": moved,
          "input_stall_s": snap["counters"].get("input_stall_seconds"),
          # per-round wall time: each round ends in the NaN guard's host
          # read of the [W] losses, so a dispatch span is a whole round.
          "spans_s": {k: {f: v.get(f) for f in ("count", "total", "min",
                                                 "max")}
                      for k, v in snap["spans"].items()
                      if k.startswith("engine_run")},
          "step_split_ms": split,
          "step_split": "one local step at B=2048 by CUDA events, outside "
                        "the trainer (mean of 3 after a warm step); the "
                        "two LSTM wrappers' calls timed inside it"})
    if not np.all(np.isfinite(trainer.get_worker_histories())):
        fail(f"non-finite training loss: {hist}")
    if not moved > 0:
        fail("the trained center equals its initialization")
    for name in ("lstm_fwd_stash", "lstm_bwd"):
        if launches[name] < steps:
            fail(f"{name} launched {launches[name]} times in {steps} local "
                 f"steps")
    if launches["lstm_fwd"] != 0:
        fail(f"training launched the inference forward "
             f"{launches['lstm_fwd']} times")
    if stash_entry and entries[stash_entry] != launches["lstm_fwd_stash"]:
        fail(f"imdb_lstm({widths}) ran {entries[stash_entry]} of its "
             f"{launches['lstm_fwd_stash']} stash forwards on "
             f"{stash_entry}")
    only_dtype("DynSGD", entries, dtype)
    return trained, launches


#: widths the kernels refuse and the model boundary pads (``ops/kernels/
#: lstm.py padded_widths``), run through ``lstm_seq`` as the model calls
#: it, at ``imdb_lstm()``'s default sequence length (80): (dtype, B, E, H). The JAX package's own test width (5, 6) in
#: both dtypes (f32 runs it at (8, 8), bf16 at (16, 16)), H=72 (both at
#: 80), ``imdb_lstm()``'s E=H=128 in bf16 at the training batch (the xw
#: body: x . Wx first, only Wh resident), and f32 H=192 and 256 at a
#: serving and a training batch (both R).
LSTM_WIDTHS = (("float32", 16, 5, 6), ("bfloat16", 16, 5, 6),
               ("float32", 256, 64, 72), ("bfloat16", 256, 64, 72),
               ("bfloat16", 2048, 128, 128),
               ("float32", 256, 64, 192), ("float32", 2048, 64, 192),
               ("float32", 256, 64, 256), ("float32", 2048, 64, 256))
#: widths that stay refused on the card: (dtype, E, H, what the ValueError
#: names); nothing may launch.
LSTM_WIDTHS_SEQ = 80
LSTM_REFUSED = (("float32", 64, 512, "shared memory"),
                ("bfloat16", 64, 144, "H <= 128"))


def lstm_widths_phase(torch, K, seed: int) -> list:
    """``lstm_seq`` at :data:`LSTM_WIDTHS`, without a gradient (the
    forward) and with one (the stash forward and the backward, through
    ``LSTMSeq``), against the plain twins on the same inputs at the
    unpadded widths, at the kernel rows' limits; the launch counts set to
    0 just before each call and read just after. Then the refused widths,
    and config #4's bf16 stash forward on both bf16 bodies in turns (the
    resident one its width picks, and the xw body launched directly)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    names = ("dwx", "dwh", "db", "dx")
    T = LSTM_WIDTHS_SEQ
    for name, B, E, H in LSTM_WIDTHS:
        dt = getattr(torch, name)

        def draw(*size, scale=1.0):
            return (torch.randn(size, device="cuda", generator=gen)
                    * scale).to(dt)

        wx, wh = draw(E, 4 * H, scale=E ** -0.5), draw(H, 4 * H,
                                                        scale=H ** -0.5)
        b, x, dhs = draw(4 * H, scale=0.1), draw(B, T, E), draw(B, T, H,
                                                                scale=0.1)
        row = {"phase": "lstm_widths", "dtype": name, "B": B, "T": T,
               "E": E, "H": H, "padded": list(K.padded_widths(E, H, dt))}
        K.reset_launches()
        with torch.no_grad():
            hs = K.lstm_seq(wx, wh, b, x)
        torch.cuda.synchronize()
        fwd_counts = K.launch_counts()
        fwd_entries = {k: v for k, v in K.launch_counts(by_entry=True).items()
                       if v}
        leaves = [t.clone().requires_grad_() for t in (wx, wh, b, x)]
        K.reset_launches()
        grads = torch.autograd.grad(K.lstm_seq(*leaves), leaves, dhs)
        torch.cuda.synchronize()
        grad_counts = K.launch_counts()
        grad_entries = {k: v for k, v in
                        K.launch_counts(by_entry=True).items() if v}
        row.update(fwd_launches=fwd_entries, grad_launches=grad_entries)
        if fwd_counts != {"lstm_fwd": 1, "lstm_fwd_stash": 0,
                          "lstm_bwd": 0} or grad_counts != {
                "lstm_fwd": 0, "lstm_fwd_stash": 1, "lstm_bwd": 1}:
            fail(f"lstm_seq at E={E}, H={H} {name} launched {fwd_counts} "
                 f"(forward) and {grad_counts} (gradient)")
        ref = K.lstm_seq_plain(wx, wh, b, x)
        res = K.lstm_fwd_stash_plain(wx, wh, b, x)
        plain = K.lstm_bwd_plain(wx, wh, x, *res, dhs)
        del res
        if name == "float32":
            err = (hs - ref).abs().max().item()
            rel = {n: rel_err(torch, a, r)
                   for n, a, r in zip(names, grads, plain)}
            row.update(max_abs_err=err, atol=KERNEL_ATOL, bwd_rel_err=rel,
                       rtol=BWD_RTOL)
            if not (err <= KERNEL_ATOL and max(rel.values()) <= BWD_RTOL):
                fail(f"lstm_seq at E={E}, H={H} f32 disagrees with the "
                     f"twins: {row}")
        else:
            row.update(fwd=check_bf16_lstm("lstm_fwd", B, [(hs, ref)]),
                       bwd=check_bf16_lstm("lstm_bwd", B,
                                           zip(grads, plain)))
            row["max_abs_err"] = max(row["fwd"]["max_abs_err"],
                                     row["bwd"]["max_abs_err"])
        del hs, ref, plain, grads

        def train_step():
            return torch.autograd.grad(K.lstm_seq(*leaves), leaves, dhs)

        with torch.no_grad():
            row["ms"] = cuda_ms(torch, lambda: K.lstm_seq(wx, wh, b, x), 3)
        row["grad_ms"] = cuda_ms(torch, train_step, 3)
        emit(row)
        rows.append(row)
        del leaves, wx, wh, b, x, dhs
        torch.cuda.empty_cache()

    for name, E, H, what in LSTM_REFUSED:
        dt = getattr(torch, name)
        wx, wh, b = (torch.zeros(s, device="cuda", dtype=dt)
                     for s in ((E, 4 * H), (H, 4 * H), (4 * H,)))
        x = torch.zeros((2, 3, E), device="cuda", dtype=dt)
        K.reset_launches()
        try:
            K.lstm_seq(wx, wh, b, x)
            fail(f"lstm_seq ran E={E}, H={H} {name}, which the kernels "
                 f"do not take")
        except ValueError as e:
            said = str(e)
        if what not in said or any(K.launch_counts(by_entry=True).values()):
            fail(f"lstm_seq at E={E}, H={H} {name} raised {said!r} and "
                 f"launched {K.launch_counts(by_entry=True)}")
        emit({"phase": "lstm_refused", "dtype": name, "E": E, "H": H,
              "error": said})

    # config #4 in bf16: the resident body (its width's) against the xw
    # body, which the wrapper never picks there, launched directly.
    B, T, E, H = STASH_BATCHES[-1], SEQ_LEN, EMBED, HIDDEN
    dt = torch.bfloat16
    wx = (torch.randn((E, 4 * H), device="cuda", generator=gen) / 8).to(dt)
    wh = (torch.randn((H, 4 * H), device="cuda", generator=gen) / 11).to(dt)
    b = (torch.randn(4 * H, device="cuda", generator=gen) / 10).to(dt)
    x = torch.randn((B, T, E), device="cuda", generator=gen).to(dt)

    def xw_stash():
        hs = torch.empty((B, T, H), device="cuda", dtype=dt)
        cs = torch.empty_like(hs)
        gates = torch.empty((B, T, 4 * H), device="cuda", dtype=dt)
        K._LIB.launch("lstm_fwd_stash_xw_bf16", x, K.xw_xproj_layout(wx),
                      K.xw_rec_weight_layout(wh), b,
                      K._pre_workspace(x, H), hs, cs, gates, B, T, E, H)
        return hs, cs, gates

    with torch.no_grad():
        errs = check_bf16_lstm("lstm_fwd_stash_xw", B, zip(
            xw_stash(), K.lstm_fwd_stash_plain(wx, wh, b, x)))
        t = interleaved_ms(torch, {
            "resident": lambda: K.lstm_fwd_stash_cuda(wx, wh, b, x),
            "xw": xw_stash}, 10)
    emit({"phase": "lstm_bf16_bodies", "B": B, "T": T, "E": E, "H": H,
          "body": K.bf16_fwd_body(E, H), **errs,
          "resident_ms": t["resident"][0], "xw_ms": t["xw"][0],
          "resident_readings": t["resident"][1], "xw_readings": t["xw"][1]})
    return rows


def center_dist(a: dict, b: dict, how: str) -> float:
    """The largest (``how="max"``) or mean elementwise distance between two
    parameter dicts, in float64."""
    d = [(a[k].double() - v.double()).abs() for k, v in b.items()]
    if how == "max":
        return max(x.max().item() for x in d)
    return (sum(x.sum() for x in d) / sum(x.numel() for x in d)).item()


def bf16_parity(phase: str, out: dict, change: float, extra=None,
                share: float = BF16_PARITY_SHARE) -> None:
    """Hold the card's bf16 run to the CPU's: ``out[run] = (center, ...)``
    for runs ``cuda_bf16``, ``cpu_bf16`` and ``cpu`` (f32); the center's
    mean distance card-vs-CPU at bf16 within ``share`` of the CPU's
    bf16-vs-f32 distance. ``extra`` adds ``{name: (card, design)}`` pairs
    held to the same share."""
    pairs = {"center_mean": (
        center_dist(out["cuda_bf16"][0], out["cpu_bf16"][0], "mean"),
        center_dist(out["cpu_bf16"][0], out["cpu"][0], "mean"))}
    pairs.update(extra or {})
    row = {"phase": phase, "dtype": "bfloat16", "share": share,
           "center_max_abs_err_card_vs_cpu_bf16": center_dist(
               out["cuda_bf16"][0], out["cpu_bf16"][0], "max"),
           "center_max_abs_err_cpu_bf16_vs_f32": center_dist(
               out["cpu_bf16"][0], out["cpu"][0], "max"),
           "center_max_abs_change": change}
    for name, (card, design) in pairs.items():
        row[f"{name}_card_vs_cpu_bf16"] = card
        row[f"{name}_cpu_bf16_vs_f32"] = design
        row[f"{name}_share"] = card / design if design else None
    emit(row)
    for name, (card, design) in pairs.items():
        if not (0 < design and card <= share * design):
            fail(f"{phase}: {name} card vs CPU at bf16 {card} > "
                 f"{share} x the CPU bf16-vs-f32 {design}")


def parity_phase(torch, seed: int) -> None:
    """The same trainer, full width at batch 32, on the card and on the
    CPU (the plain twins), from the same weights, in f32 and at
    ``compute_dtype="bfloat16"``."""
    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch.datasets import imdb
    from distkeras_tpu_torch.trainers import DynSGD

    W, Kw, B = (PARITY["num_workers"], PARITY["communication_window"],
                PARITY["batch_size"])
    df = imdb(n=PARITY_ROUNDS * W * Kw * B, vocab_size=VOCAB,
              seq_len=SEQ_LEN, seed=seed + 1)
    out = {}
    for run, dev, dtype in (("cuda", "cuda", None), ("cpu", "cpu", None),
                            ("cuda_bf16", "cuda", "bfloat16"),
                            ("cpu_bf16", "cpu", "bfloat16")):
        model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED,
                          hidden_size=HIDDEN, seq_len=SEQ_LEN, seed=seed + 1,
                          device=dev)
        init = {k: v.detach().cpu().clone() for k, v in model.params.items()}
        t = DynSGD(model, worker_optimizer="sgd",
                   loss="sparse_categorical_crossentropy", **PARITY,
                   compute_dtype=dtype)
        trained = t.train(df)
        out[run] = ({k: v.cpu() for k, v in trained.params.items()},
                    t.get_worker_histories())
    center_err = center_dist(out["cuda"][0], out["cpu"][0], "max")
    hist_err = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
    # How far training moved the center, beside the tolerance, so a reader
    # can judge what a gradient fault would have to exceed to be caught.
    change = max((v - init[k]).abs().max().item()
                 for k, v in out["cpu"][0].items())
    emit({"phase": "train_parity", "trainer": "DynSGD", **PARITY,
          "rounds": PARITY_ROUNDS, "center_max_abs_err_card_vs_cpu":
              center_err, "center_max_abs_change": change,
          "history_max_abs_err": hist_err, "atol": PARITY_ATOL})
    if not change > 0:
        fail("the parity run's center did not move from its init")
    if not (center_err <= PARITY_ATOL and hist_err <= PARITY_ATOL):
        fail(f"card and CPU training disagree: center {center_err}, "
             f"history {hist_err} > {PARITY_ATOL}")
    bf16_parity("train_parity", out, change)


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

    sizes, clients = (1, 3, 17, 64), 8
    telemetry.reset()
    K.reset_launches()  # counts start at 0 just before the main path runs
    registry = ModelRegistry(model, BUCKETS, device="cuda")
    # Each client has one request in flight, so at most clients x 64 rows
    # wait. The default bound (DKTPU_SERVE_QUEUE, 256 rows) sheds such a
    # load by design whenever the dispatcher falls a batch behind (a slow
    # host did: 230 rows queued, a 64-row request shed). This phase checks
    # that every request is answered right, so its queue holds the whole
    # load and any error reply is a fault.
    frontend = ServingFrontend(
        registry, max_queue_rows=clients * max(sizes)).start()
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
                   for w in range(clients)]
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
    counts = K.launch_counts()
    launches = counts["lstm_fwd"]
    counters = telemetry.get().snapshot()["counters"]
    batches = int(counters.get("serving.batches", 0))
    retrace = int(counters.get("serving.retrace_after_warmup", 0))
    depth = telemetry.get().snapshot()["gauges"].get(
        "serving.queue_depth", {})
    peak_rows = int(depth.get("max", 0))

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
          "max_queue_rows": frontend.batcher.max_rows,
          "peak_queue_rows": peak_rows,
          "max_abs_err_vs_cpu_plain": worst, "atol": SERVE_ATOL,
          "p50_ms": float(np.percentile(lat_ms, 50)) if len(lat_ms) else None,
          "p99_ms": float(np.percentile(lat_ms, 99)) if len(lat_ms) else None,
          "latency": "client wall clock per request, sequential and "
                     f"{clients} concurrent clients mixed"})
    if errors:
        fail(f"{len(errors)} error replies, first: {errors[0]}")
    if len(records) != 3 * len(sizes) + clients * 4:
        fail(f"{len(records)} of {3 * len(sizes) + clients * 4} requests "
             "answered")
    if not worst <= SERVE_ATOL:
        fail(f"served logits differ from the CPU plain forward by {worst}")
    if retrace != 0:
        fail(f"serving.retrace_after_warmup = {retrace}")
    if batches <= 0 or launches < batches:
        fail(f"lstm_fwd launched {launches} times for {batches} batches")
    if counts["lstm_fwd_stash"] or counts["lstm_bwd"]:
        fail(f"serving launched training kernels: {counts}")
    return launches


def gn_bound_ms(B: int, N: int, C: int, backward: bool,
                itemsize: int = 4) -> tuple:
    """Least time for one GroupNorm on this card: the forward reads x and
    writes y, the backward reads x and dy and writes dx (gamma, beta,
    dgamma and dbeta, 4 C values, included), ``itemsize`` bytes each, over
    3.35 TB/s. A dozen f32 FLOPs an element (the statistics are f32 in
    either dtype) at 67 TFLOP/s is under a tenth of that."""
    nbytes = itemsize * ((3 if backward else 2) * B * N * C + 4 * C)
    flops = (12 if backward else 6) * B * N * C
    return bound(nbytes, flops, PEAK_F32_FLOPS)


def relu_margin(torch, G, x, dy, gamma, beta, margin: float = 1e-3):
    """``dy`` with zeros where the pre-ReLU output lies within ``margin``
    of 0. The kernel and the plain twin compute the statistics in another
    order, so an element that close to the ReLU's edge may be masked by
    one and not the other; among 10^8 elements some are, and one such
    element moves dx by about |inv * dy * gamma|. With dy zero there, both
    masks give the same gradient, and the comparison holds the kernel to
    its arithmetic everywhere else."""
    pre = G.group_norm_fwd_plain(x, gamma, beta, GN_GROUPS, False).float()
    return torch.where(pre.abs() > margin, dy, torch.zeros_like(dy))


def gn_kernel_phase(torch, G, seed: int) -> dict:
    """The GroupNorm kernels against their plain twins at every ResNet-50
    slab at B=128, in f32 and bf16, with ``F.group_norm`` (+ReLU) on an
    NCHW copy of the same input, in the same dtype, as the library
    yardstick. Returns ``{dtype: [row per slab]}``."""
    import torch.nn.functional as F

    B = RESNET["batch_size"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {dt: [] for dt in DTYPES}
    for N, C, relu, per_step in GN_SLABS:
        x32, dy32 = (torch.randn((B, N, C), device="cuda", generator=gen)
                     for _ in range(2))
        g32, b32 = (torch.randn(C, device="cuda", generator=gen)
                    for _ in range(2))
        for name in DTYPES:
            x, dy, gamma, beta = (t.to(getattr(torch, name))
                                  for t in (x32, dy32, g32, b32))
            args = (gamma, beta, GN_GROUPS, relu)
            if relu:
                dy = relu_margin(torch, G, x, dy, gamma, beta,
                                 1e-3 if name == "float32" else 1e-2)
            y = G.group_norm_fwd_cuda(x, *args)
            got = G.group_norm_bwd_cuda(x, dy, *args)
            again = G.group_norm_bwd_cuda(x, dy, *args)
            torch.cuda.synchronize()
            y_ref = G.group_norm_fwd_plain(x, *args)
            plain = G.group_norm_bwd_plain(x, dy, *args)
            fwd_err = (y.float() - y_ref.float()).abs().max().item()
            bwd_rel = {n: rel_err(torch, a, r) for n, a, r in
                       zip(("dx", "dgamma", "dbeta"), got, plain)}
            bwd_abs = max((a.float() - r.float()).abs().max().item()
                          for a, r in zip(got, plain))
            repeatable = all(torch.equal(a, a2) for a, a2 in zip(got, again))
            fwd_rel = rel_err(torch, y, y_ref)
            del y, y_ref, got, again, plain
            ms = cuda_ms(torch, lambda: G.group_norm_fwd_cuda(x, *args), 10)
            bwd_ms = cuda_ms(
                torch, lambda: G.group_norm_bwd_cuda(x, dy, *args), 10)
            plain_ms = cuda_ms(
                torch, lambda: G.group_norm_fwd_plain(x, *args), 3)
            plain_bwd_ms = cuda_ms(
                torch, lambda: G.group_norm_bwd_plain(x, dy, *args), 3)
            xc = x.transpose(1, 2).contiguous().requires_grad_()  # [B, C, N]
            dyc = dy.transpose(1, 2).contiguous()
            lib_leaves = [xc, gamma.clone().requires_grad_(),
                          beta.clone().requires_grad_()]

            def lib_fwd():
                out = F.group_norm(xc, GN_GROUPS, lib_leaves[1],
                                   lib_leaves[2], G.EPS)
                return F.relu(out) if relu else out

            def lib_bwd():
                out = lib_fwd()
                return cuda_ms(torch, lambda: torch.autograd.grad(
                    out, lib_leaves, dyc, retain_graph=True), 10)

            with torch.no_grad():
                library_ms = cuda_ms(torch, lib_fwd, 10)
            library_bwd_ms = lib_bwd()
            del xc, dyc, lib_leaves
            size = x.element_size()
            bound_ms, bound_by = gn_bound_ms(B, N, C, False, size)
            bwd_bound, bwd_bound_by = gn_bound_ms(B, N, C, True, size)
            row = {"phase": "gn_kernel", "B": B, "N": N, "C": C,
                   "groups": GN_GROUPS, "relu": relu, "per_step": per_step,
                   "dtype": name,
                   "fwd_max_abs_err": fwd_err, "fwd_rel_err": fwd_rel,
                   "bwd_max_abs_err": bwd_abs, "bwd_rel_err": bwd_rel,
                   "repeatable_bits": repeatable,
                   "tiling": G.gn_tiling(N, C, GN_GROUPS, size,
                                         False)._asdict(),
                   "bwd_tiling": G.gn_tiling(N, C, GN_GROUPS, size,
                                             True)._asdict(),
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bwd_ms": bwd_ms, "bwd_plain_ms": plain_bwd_ms,
                   "bwd_library_ms": library_bwd_ms,
                   "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_bound_by,
                   "bound_share": bound_ms / ms,
                   "bwd_bound_share": bwd_bound / bwd_ms,
                   "ratio_to_library": ms / library_ms,
                   "bwd_ratio_to_library": bwd_ms / library_bwd_ms}
            if name == "float32":
                row.update(atol=GN_ATOL, rtol=GN_BWD_RTOL)
                fwd_ok = fwd_err <= GN_ATOL
                bwd_ok = max(bwd_rel.values()) <= GN_BWD_RTOL
            else:
                row.update(limit_max_share=GN_BF16_TOP)
                fwd_ok = fwd_rel <= GN_BF16_TOP
                bwd_ok = max(bwd_rel.values()) <= GN_BF16_TOP
            emit(row)
            if not fwd_ok:
                fail(f"group_norm_fwd disagrees with its plain twin at N={N}, "
                     f"C={C} {name}: {row}")
            if not bwd_ok:
                fail(f"group_norm_bwd disagrees with its plain twin at N={N}, "
                     f"C={C} {name}: relative errors {bwd_rel}")
            if not repeatable:
                fail(f"group_norm_bwd gave different bits on two calls at "
                     f"N={N}, C={C} {name}")
            rows[name].append(row)
            del x, dy
        del x32, dy32
        torch.cuda.empty_cache()
    return rows


#: a slab past what 16 blocks keep in shared memory: the stem of a
#: 448x448 image (224x224x64, G=32, ReLU), at a batch of 16
GN_UNCACHED = (16, 224 * 224, 64, True)


def gn_uncached_phase(torch, G, seed: int) -> None:
    """The GroupNorm kernels where a block's rows outgrow its shared
    memory (``GN_UNCACHED``), at the wrappers' own tiling, in f32 and
    bf16: part of each block's rows is read from global memory (L2) in
    every sweep. Held to the plain twins at the slabs' limits, with
    repeatable bits, and timed beside the bound."""
    B, N, C, relu = GN_UNCACHED
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    x32, dy32 = (torch.randn((B, N, C), device="cuda", generator=gen)
                 for _ in range(2))
    g32, b32 = (torch.randn(C, device="cuda", generator=gen)
                for _ in range(2))
    for name in DTYPES:
        x, dy, gamma, beta = (t.to(getattr(torch, name))
                              for t in (x32, dy32, g32, b32))
        size = x.element_size()
        tilings = [G.gn_tiling(N, C, GN_GROUPS, size, bwd)
                   for bwd in (False, True)]
        if any(t.cached >= t.rows for t in tilings):
            fail(f"GroupNorm at {GN_UNCACHED} {name} caches every row: "
                 f"{tilings}")
        args = (gamma, beta, GN_GROUPS, relu)
        dy = relu_margin(torch, G, x, dy, gamma, beta,
                         1e-3 if name == "float32" else 1e-2)
        y = G.group_norm_fwd_cuda(x, *args)
        y2 = G.group_norm_fwd_cuda(x, *args)
        got = G.group_norm_bwd_cuda(x, dy, *args)
        again = G.group_norm_bwd_cuda(x, dy, *args)
        torch.cuda.synchronize()
        y_ref = G.group_norm_fwd_plain(x, *args)
        plain = G.group_norm_bwd_plain(x, dy, *args)
        fwd_err = (y.float() - y_ref.float()).abs().max().item()
        fwd_rel = rel_err(torch, y, y_ref)
        bwd_rel = {n: rel_err(torch, a, r) for n, a, r in
                   zip(("dx", "dgamma", "dbeta"), got, plain)}
        repeatable = torch.equal(y, y2) and all(
            torch.equal(a, a2) for a, a2 in zip(got, again))
        del y, y2, y_ref, got, again, plain
        ms = cuda_ms(torch, lambda: G.group_norm_fwd_cuda(x, *args), 10)
        bwd_ms = cuda_ms(
            torch, lambda: G.group_norm_bwd_cuda(x, dy, *args), 10)
        bound_ms, _ = gn_bound_ms(B, N, C, False, size)
        bwd_bound, _ = gn_bound_ms(B, N, C, True, size)
        if name == "float32":
            ok = fwd_err <= GN_ATOL and max(bwd_rel.values()) <= GN_BWD_RTOL
        else:
            ok = max(fwd_rel, *bwd_rel.values()) <= GN_BF16_TOP
        emit({"phase": "gn_uncached", "B": B, "N": N, "C": C,
              "groups": GN_GROUPS, "relu": relu, "dtype": name,
              "tiling": tilings[0]._asdict(),
              "bwd_tiling": tilings[1]._asdict(),
              "fwd_max_abs_err": fwd_err, "fwd_rel_err": fwd_rel,
              "bwd_rel_err": bwd_rel, "repeatable_bits": repeatable,
              "ms": ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms,
              "bwd_ms": bwd_ms, "bwd_bound_ms": bwd_bound,
              "bwd_bound_share": bwd_bound / bwd_ms, "ok": ok})
        if not ok:
            fail(f"GroupNorm past the cached rows disagrees with its plain "
                 f"twins at {GN_UNCACHED} {name}")
        if not repeatable:
            fail(f"GroupNorm past the cached rows gave different bits on "
                 f"two calls at {GN_UNCACHED} {name}")
        del x, dy
    del x32, dy32
    torch.cuda.empty_cache()


def resnet_data(n: int, seed: int):
    """Random 224x224x3 f32 images in [0, 1) and labels in [0, 1000), as
    ``bench.py`` makes them for config #5."""
    from distkeras_tpu_torch.data import DataFrame

    rng = np.random.default_rng(seed)
    x = rng.random(size=(n, 224, 224, 3), dtype=np.float32)
    y = rng.integers(0, 1000, size=n).astype(np.int32)
    return DataFrame({"features": x, "label": y})


def resnet_train_phase(torch, G, gpu: str, seed: int, dtype: str = "float32",
                       rounds: int = RESNET_ROUNDS) -> dict:
    """Train config #5 as a user would, at ``compute_dtype=dtype``;
    returns the launch counts."""
    from distkeras_tpu_torch import SynchronousDistributedTrainer, resnet50
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.ops.optimizers import sgd

    B, Kw = RESNET["batch_size"], RESNET["steps_per_program"]
    steps = rounds * Kw
    t0 = time.perf_counter()
    model = resnet50(norm_impl="pallas", seed=seed, device="cuda")
    df = resnet_data(steps * B, seed)
    setup_s = time.perf_counter() - t0
    trainer = SynchronousDistributedTrainer(
        model, "sgd", "sparse_categorical_crossentropy", **RESNET,
        compute_dtype=dtype)
    telemetry.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    G.reset_launches()  # counts start at 0 just before the main path runs
    t0 = time.perf_counter()
    trained = trainer.train(df)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = G.launch_counts()
    entries = G.launch_counts(by_entry=True)
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.get_history()
    moved = max((trained.params[k] - v).abs().max().item()
                for k, v in model.params.items())
    snap = telemetry.get().snapshot()
    split = step_split(torch, trained,
                       torch.as_tensor(df["features"][:B], device="cuda"),
                       torch.as_tensor(df["label"][:B], device="cuda"),
                       sgd(RESNET["learning_rate"]),
                       timed=(G, {"group_norm_fwd_cuda": "gn_forward",
                                  "group_norm_bwd_cuda": "gn_backward"}),
                       dtype=getattr(torch, dtype))
    emit({"phase": "resnet_train", "gpu": gpu,
          "trainer": "SynchronousDistributedTrainer",
          "model": "resnet50(norm_impl='pallas')", "image": [224, 224, 3],
          "classes": 1000, "rounds": rounds, **RESNET,
          "dtype": dtype, "compute_dtype": dtype,
          "launches_by_entry": entries,
          "setup_s": setup_s, "seconds": wall,
          "samples_per_s": steps * B / wall,
          "ms_per_local_step": wall / steps * 1e3,
          "history": [float(v) for v in hist],
          "worker_histories": trainer.get_worker_histories(),
          "launches": launches, "local_steps": steps,
          "gn_per_step": GN_PER_STEP, "center_max_abs_change": moved,
          "peak_memory_gb": peak / 1e9,
          "input_stall_s": snap["counters"].get("input_stall_seconds"),
          "spans_s": {k: {f: v.get(f) for f in ("count", "total", "min",
                                                 "max")}
                      for k, v in snap["spans"].items()
                      if k.startswith("engine_run")},
          "step_split_ms": split,
          "step_split": "one local step at B=128 by CUDA events, outside "
                        "the trainer (mean of 3 after a warm step); "
                        "gn_forward/gn_backward: events around each "
                        "GroupNorm kernel call"})
    if not np.all(np.isfinite(hist)):
        fail(f"non-finite ResNet-50 training loss: {hist}")
    if not moved > 0:
        fail("the trained ResNet-50 equals its initialization")
    want = GN_PER_STEP * steps
    if launches != {"group_norm_fwd": want, "group_norm_bwd": want}:
        fail(f"GroupNorm launches {launches} in {steps} local steps; "
             f"want {GN_PER_STEP} of each a step ({want})")
    if split["calls"] != {"gn_forward": GN_PER_STEP,
                          "gn_backward": GN_PER_STEP}:
        fail(f"the step split timed {split['calls']} GroupNorm calls")
    only_dtype("ResNet-50", entries, dtype)
    return launches


def resnet_parity_phase(torch, seed: int) -> None:
    """The same trainer at full width, batch 2, 2 steps, from the same
    weights: on the card, on the CPU (the plain twins), and on the CPU in
    float64 as the reference both f32 runs are measured against."""
    from distkeras_tpu_torch import SynchronousDistributedTrainer, resnet50
    from distkeras_tpu_torch.data import DataFrame

    n = RESNET_PARITY["batch_size"] * RESNET_PARITY["steps_per_program"]
    df = resnet_data(n, seed + 1)
    df64 = DataFrame({"features": df["features"].astype(np.float64),
                      "label": df["label"]})
    out = {}
    for run, dev, frame, dtype in (
            ("cuda", "cuda", df, None), ("cpu", "cpu", df, None),
            ("cpu_f64", "cpu", df64, None),
            ("cuda_bf16", "cuda", df, "bfloat16"),
            ("cpu_bf16", "cpu", df, "bfloat16")):
        model = resnet50(norm_impl="pallas", seed=seed + 1, device=dev)
        if run == "cpu_f64":
            model.module.double()
        init = {k: v.detach().cpu().double()
                for k, v in model.params.items()}
        t = SynchronousDistributedTrainer(
            model, "sgd", "sparse_categorical_crossentropy", **RESNET_PARITY,
            compute_dtype=dtype)
        trained = t.train(frame)
        out[run] = ({k: v.cpu().double() for k, v in trained.params.items()},
                    t.get_history())

    def center_err(a, b):
        return center_dist(out[a][0], out[b][0], "max")

    card_vs_cpu = center_err("cuda", "cpu")
    card_vs_f64 = center_err("cuda", "cpu_f64")
    cpu_vs_f64 = center_err("cpu", "cpu_f64")
    loss_rel = float(np.abs(out["cuda"][1] - out["cpu"][1]).max()
                     / np.abs(out["cpu"][1]).max())
    change = max((v - init[k]).abs().max().item()
                 for k, v in out["cpu_f64"][0].items())
    limit = RESNET_PARITY_FACTOR * cpu_vs_f64
    emit({"phase": "resnet_parity", "trainer": "SynchronousDistributedTrainer",
          "model": "resnet50(norm_impl='pallas')", **RESNET_PARITY,
          "rounds": 1, "center_max_abs_err_card_vs_cpu": card_vs_cpu,
          "center_max_abs_err_card_vs_cpu_f64": card_vs_f64,
          "center_max_abs_err_cpu_vs_cpu_f64": cpu_vs_f64,
          "center_max_abs_change": change, "limit_card_vs_cpu_f64": limit,
          "history_card": [float(v) for v in out["cuda"][1]],
          "history_cpu": [float(v) for v in out["cpu"][1]],
          "history_cpu_f64": [float(v) for v in out["cpu_f64"][1]],
          "history_rel_err": loss_rel, "loss_rtol": RESNET_LOSS_RTOL})
    if not change > 0:
        fail("the ResNet-50 parity run's center did not move from its init")
    if not (0 < cpu_vs_f64 and card_vs_f64 <= limit
            and loss_rel <= RESNET_LOSS_RTOL):
        fail(f"ResNet-50 card training strays from the f64 reference: "
             f"{card_vs_f64} > {RESNET_PARITY_FACTOR} x the CPU f32 run's "
             f"{cpu_vs_f64}, or loss {loss_rel} > {RESNET_LOSS_RTOL}")
    bf16_parity("resnet_parity", out, change)


def fold_bound_ms(n: int, codec: str) -> tuple[float, str]:
    """Least time for one fold on this card: the center read and written
    once and the wire tensor read once, (4 + 4 + 1) n bytes in int8 and
    (4 + 4 + 2) n in bf16, over 3.35 TB/s, against 2 n FLOPs at the f32
    rate."""
    return bound((9 if codec == "int8" else 10) * n, 2 * n, PEAK_F32_FLOPS)


#: GPU cycles of the shortest spin kernel that gives the host a head start
#: (about 2 ms at the H100's clock).
HEAD_START_CYCLES = 4_000_000


def head_start_cycles(torch, host_ms: float) -> int:
    """Cycles of a ``torch.cuda._sleep`` spin that lasts at least twice
    ``host_ms`` (and at least :data:`HEAD_START_CYCLES`), after the
    card is synchronized."""
    spin = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    spin[0].record()
    torch.cuda._sleep(HEAD_START_CYCLES)
    spin[1].record()
    torch.cuda.synchronize()
    return int(HEAD_START_CYCLES * max(
        1.0, 2.0 * host_ms / spin[0].elapsed_time(spin[1])))


def cuda_ms_cold(torch, fn, reps: int, flush, head_start: bool = False
                 ) -> float:
    """Mean milliseconds of ``fn`` by CUDA events around each call alone,
    with ``flush`` summed before every call so the call finds its inputs
    outside L2 (after one warm call). The flush reads, so the lines it
    leaves in L2 are clean and the timed call writes none of them back.
    With ``head_start`` a spin kernel holds the card after the flush, long
    enough for the host to enqueue ``fn``'s launches, so the time is the
    card's alone (without it, host work inside ``fn`` longer than the flush
    shows as idle card time between the events): the spin lasts at least
    twice the host time of one call of ``fn``, timed after the warm one."""
    fn()
    torch.cuda.synchronize()
    cycles = HEAD_START_CYCLES
    if head_start:
        t0 = time.perf_counter()
        fn()
        cycles = head_start_cycles(torch, (time.perf_counter() - t0) * 1e3)
    events = []
    for _ in range(reps):
        flush.sum()
        if head_start:
            torch.cuda._sleep(cycles)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        events.append(ev)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def fold_inputs(torch, center, codec: str, rng):
    """A commit's tensor for ``center`` as the client sends it: a random
    delta encoded by the port's ``wire.codec_encode``, on the card."""
    from distkeras_tpu_torch.netps import fold as nfold
    from distkeras_tpu_torch.netps import wire

    d = (rng.normal(size=center.numel()) * 1e-3).astype(np.float32)
    enc, spec = wire.codec_encode(d, codec)
    return enc, spec, nfold.wire_tensor(enc).cuda()


def library_fold(torch, center, q, codec: str, s: float):
    """One PyTorch call for the same function, ``c.add_(q, alpha=s)`` (the
    yardstick; the port never calls it, as it may contract into an FMA)."""
    other = q if codec == "int8" else q.view(torch.bfloat16)
    return center.add_(other, alpha=s)


def fold_commit_row(torch, F, model: str, params, codec: str, rng,
                    flush) -> dict:
    """One whole commit of ``model`` in ``codec``, as the server folds it:
    centers seated as the server seats them (views of one flat tensor at
    ``center_layout``'s 64-byte offsets), the commit staged by
    ``stage_commit`` (one pinned buffer, one copy), then one
    ``fold_commit_`` launch, bit for bit against ``fold_commit_plain_`` on
    the same staged buffer (and, but for ResNet-50's, against the numpy
    oracle on the host). Cold times by CUDA events of the kernel, the twin,
    the same kernel one tensor at a time (``fold_compressed_``, a launch
    a tensor) and ``c.add_(w,
    alpha=s)`` for each tensor (no one PyTorch call folds a commit), beside
    the bound; and the host wall of a commit, staged and folded as the
    server does (``stage_commit`` from a ``PinnedPool`` on a stream of its
    own, then ``fold_delta``), to its end on the card."""
    from distkeras_tpu_torch.netps import fold as nfold

    sizes = [p.numel() for p in params.values()]
    offsets, total = F.center_layout(sizes)
    flat0 = torch.zeros(total, device="cuda")
    for p, off in zip(params.values(), offsets):
        flat0[off:off + p.numel()] = p.detach().reshape(-1)
    work = flat0.clone()
    centers = [work[o:o + n] for o, n in zip(offsets, sizes)]
    inputs = [fold_inputs(torch, c, codec, rng) for c in centers]
    entries = [(enc, spec) for enc, spec, _q in inputs]
    staged = nfold.stage_commit(entries, "cuda")
    wires = [F.wire_view(staged.buf, r) for r in staged.rows]
    specs = [spec for _e, spec, _q in inputs]
    scale = 1.0 / 3.0
    got_flat = flat0.clone()
    got = [got_flat[o:o + n] for o, n in zip(offsets, sizes)]
    F.fold_commit_(got, staged, scale)
    ref_flat = flat0.clone()
    F.fold_commit_plain_([ref_flat[o:o + n] for o, n in zip(offsets, sizes)],
                         staged, scale)
    torch.cuda.synchronize()
    row = {"phase": "fold_commit", "model": model, "codec": codec,
           "tensors": len(sizes), "params": sum(sizes),
           "commit_scale": scale,
           "max_abs_err": (got_flat - ref_flat).abs().max().item(),
           "bit_equal_to_plain": bool(torch.equal(
               got_flat.view(torch.int32), ref_flat.view(torch.int32))),
           "tiles": staged.tiles, "staged_bytes": staged.buf.numel()}
    if model != "resnet50":
        host = [c.cpu().numpy() for c in centers]
        for h, (enc, spec, _q) in zip(host, inputs):
            nfold.fold_compressed_numpy(h, enc, spec, scale)
        row["bit_equal_to_numpy_oracle"] = all(
            np.array_equal(g.cpu().numpy().view(np.uint32),
                           h.view(np.uint32)) for g, h in zip(got, host))
    s = [F.fold_scale(codec, spec, 1.0) for spec in specs]

    def tensor_loop():
        for c, q, spec in zip(centers, wires, specs):
            F.fold_compressed_(c, q, spec, 1.0)

    def add_loop():
        for c, q, si in zip(centers, wires, s):
            library_fold(torch, c, q, codec, si)

    times = {"ms": lambda: F.fold_commit_(centers, staged, 1.0),
             "plain_ms": lambda: F.fold_commit_plain_(centers, staged, 1.0),
             "tensor_loop_ms": tensor_loop, "library_ms": add_loop}
    for key, fn in times.items():
        row[key] = cuda_ms_cold(torch, fn, FOLD_REPS, flush, head_start=True)
    row["call_ms"] = cuda_ms_cold(torch, times["ms"], FOLD_REPS, flush)
    row["bound_ms"] = sum(fold_bound_ms(n, codec)[0] for n in sizes)
    row["bound_by"] = "bytes"
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["ratio_to_library"] = row["ms"] / row["library_ms"]
    stream, pool = torch.cuda.Stream(priority=-64), nfold.PinnedPool()
    walls = []
    for _ in range(FOLD_REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            nfold.fold_delta(centers, nfold.stage_commit(entries, "cuda",
                                                         pool),
                             "dynsgd", 0)
        stream.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    row["fold_delta_wall_ms"] = float(np.median(walls[1:]))
    row["fold_delta_wall_readings"] = walls[1:]
    row["library"] = "c.add_(w, alpha=s) for each tensor"
    row["timing"] = ("CUDA events around one whole commit, L2 flushed (by a "
                     "read) and the card held by a spin kernel before it, so "
                     "the host's enqueue is not timed (call_ms: without the "
                     "spin, the wrapper's host time showing); "
                     "fold_delta_wall_ms: host clock, stage_commit + "
                     "fold_delta + stream sync, median")
    return row


def fold_kernel_phase(torch, F, seed: int) -> list:
    """The fold kernel against its plain twin at every tensor of config
    #4's model and ResNet-50's largest two, both codecs, scales 1 and 1/3;
    then one whole commit of each model (and of config #2's CNN, the
    commit ``remote_cnn`` folds)."""
    from distkeras_tpu_torch import imdb_lstm, mnist_cnn, resnet50
    from distkeras_tpu_torch.netps import fold as nfold

    rng = np.random.default_rng(seed)
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    models = {
        "imdb_lstm": imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED,
                               hidden_size=HIDDEN, seq_len=SEQ_LEN,
                               seed=seed, device="cuda").params,
        "resnet50": resnet50(norm_impl="pallas", seed=seed,
                             device="cuda").params,
        "mnist_cnn": mnist_cnn(seed=seed, device="cuda").params}
    largest = sorted(models["resnet50"].items(),
                     key=lambda kv: -kv[1].numel())[:FOLD_RESNET_TENSORS]
    tensors = [(f"imdb_lstm.{k}", v)
               for k, v in models["imdb_lstm"].items()]
    tensors += [(f"resnet50.{k}", v) for k, v in largest]
    # The floor of every cold time below: one 1-element PyTorch launch
    # timed after the same flush.
    tiny = torch.zeros(1, device="cuda")
    floor_ms = cuda_ms_cold(torch, tiny.zero_, FOLD_REPS, flush)
    emit({"phase": "fold_floor", "cold_launch_floor_ms": floor_ms,
          "timing": "CUDA events around one 1-element launch, L2 flushed "
                    "(by a read) before it"})
    rows = []
    for i, (name, param) in enumerate(tensors):
        c0 = param.detach().reshape(-1).clone()
        n = c0.numel()
        for codec in ("int8", "bf16"):
            enc, spec, q = fold_inputs(torch, c0, codec, rng)
            for scale in FOLD_SCALES:
                s = F.fold_scale(codec, spec, scale)
                got = F.fold_compressed_(c0.clone(), q, spec, scale)
                ref = F.fold_compressed_plain_(c0.clone(), q, codec, s)
                lib = library_fold(torch, c0.clone(), q, codec, s)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                row = {"phase": "fold_kernel", "tensor": name,
                       "shape": list(param.shape), "n": n, "codec": codec,
                       "commit_scale": scale, "s": s, "max_abs_err": err,
                       "bit_equal_to_plain": bool(torch.equal(got, ref)),
                       "library_max_abs_err": (lib - ref).abs().max().item()}
                if i == 0:
                    host = c0.cpu().numpy()
                    nfold.fold_compressed_numpy(host, enc, spec, scale)
                    row["bit_equal_to_numpy_oracle"] = bool(
                        np.array_equal(got.cpu().numpy(), host))
                work = c0.clone()
                row["ms"] = cuda_ms_cold(
                    torch, lambda: F.fold_compressed_(work, q, spec, scale),
                    FOLD_REPS, flush)
                row["warm_ms"] = cuda_ms(
                    torch, lambda: F.fold_compressed_(work, q, spec, scale),
                    FOLD_REPS)
                row["plain_ms"] = cuda_ms_cold(
                    torch, lambda: F.fold_compressed_plain_(work, q, codec, s),
                    FOLD_REPS, flush)
                row["library_ms"] = cuda_ms_cold(
                    torch, lambda: library_fold(torch, work, q, codec, s),
                    FOLD_REPS, flush)
                row["bound_ms"], row["bound_by"] = fold_bound_ms(n, codec)
                row["cold_launch_floor_ms"] = floor_ms
                row["timing"] = ("CUDA events around each call, L2 flushed "
                                 "(by a read) before it; warm_ms back to "
                                 "back")
                emit(row)
                if not (row["bit_equal_to_plain"]
                        and row.get("bit_equal_to_numpy_oracle", True)):
                    fail(f"the fold kernel is not bit-equal to its plain "
                         f"twin (or the oracle) on {name} {codec} "
                         f"scale={scale}: {row}")
                rows.append(row)
    for model, params in models.items():
        for codec in ("int8", "bf16"):
            row = fold_commit_row(torch, F, model, params, codec, rng, flush)
            row["cold_launch_floor_ms"] = floor_ms
            emit(row)
            if not (row["bit_equal_to_plain"]
                    and row.get("bit_equal_to_numpy_oracle", True)):
                fail(f"the commit fold is not bit-equal to its plain twin "
                     f"(or the oracle) on a {model} {codec} commit: {row}")
            rows.append(row)
    del models, flush
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def env_set(**values):
    """Set environment variables for the ``with`` block, then restore."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def quant_steps():
    """Record, for every commit the port's server folds in the block, its
    largest quantization step ``spec["scale"] * commit_scale`` (0 for a
    commit with no int8 tensor)."""
    from distkeras_tpu_torch.netps import server as server_mod
    from distkeras_tpu_torch.netps.fold import commit_scale
    from distkeras_tpu_torch.ops.kernels.fold import KIND_INT8

    steps = []
    real = server_mod.fold_delta

    def recording(center, delta, discipline, staleness):
        scale = commit_scale(discipline, staleness)
        rows = delta.rows  # the server passes its staged commit
        steps.append(max((float(f) * scale for f in
                          rows["factor"][rows["kind"] == KIND_INT8]),
                         default=0.0))
        return real(center, delta, discipline, staleness)

    server_mod.fold_delta = recording
    try:
        yield steps
    finally:
        server_mod.fold_delta = real


def time_handlers(srv, ops=("commit", "pull")) -> dict:
    """Wrap ``srv``'s ``_op_<op>`` handlers so each call's host milliseconds
    (the body of the server's ``netps.server.<op>`` span) are recorded:
    ``{op: [ms, ...]}``, filled as the server answers."""
    times = {op: [] for op in ops}
    for op, got in times.items():
        real = getattr(srv, f"_op_{op}")

        def timed(*a, _real=real, _got=got):
            t0 = time.perf_counter()
            try:
                return _real(*a)
            finally:
                _got.append((time.perf_counter() - t0) * 1e3)

        setattr(srv, f"_op_{op}", timed)
    return times


def handler_stats(times: dict) -> dict:
    """The p50 and the largest of each handler's milliseconds."""
    out = {}
    for op, ms in times.items():
        out[f"server_{op}_ms_p50"] = float(np.median(ms))
        out[f"server_{op}_ms_max"] = max(ms)
    return out


def remote_inputs(seed: int, rounds: int):
    """Config #4's model on the card from ``seed`` and an ``imdb()`` frame
    of ``rounds`` rounds of :data:`REMOTE`'s workers, window and batch."""
    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch.datasets import imdb

    W, Kw, B = (REMOTE["num_workers"], REMOTE["communication_window"],
                REMOTE["batch_size"])
    model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                      seq_len=SEQ_LEN, seed=seed, device="cuda")
    df = imdb(n=rounds * W * Kw * B, vocab_size=VOCAB, seq_len=SEQ_LEN,
              seed=seed)
    return model, df


def remote_train_phase(torch, K, F, gpu: str, seed: int, codec: str) -> dict:
    """``DynSGD(imdb_lstm(...), remote=srv.endpoint).train(df)`` against a
    ``PSServer(discipline="dynsgd")`` on the card, commits in ``codec``;
    returns the fold launch counts of the run."""
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.netps import PSClient, PSServer
    from distkeras_tpu_torch.trainers import DynSGD

    W, Kw, B = (REMOTE["num_workers"], REMOTE["communication_window"],
                REMOTE["batch_size"])
    rounds = REMOTE_ROUNDS[codec]
    model, df = remote_inputs(seed, rounds)
    srv = PSServer(discipline="dynsgd", device="cuda").start()
    handler_ms = time_handlers(srv)
    try:
        with env_set(DKTPU_NET_COMPRESS=codec):
            trainer = DynSGD(model, worker_optimizer="sgd",
                             loss="sparse_categorical_crossentropy",
                             remote=srv.endpoint, **REMOTE)
            telemetry.reset()
            torch.cuda.synchronize()
            # counts start at 0 just before the main path runs
            K.reset_launches()
            F.reset_launches()
            t0 = time.perf_counter()
            trained = trainer.train(df)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            lstm, fold = K.launch_counts(), F.launch_counts()
        with PSClient(srv.endpoint) as observer:
            stats = observer.stats()
        center = srv.center()
        log = list(srv.commit_log)
        fold_s, evictions = srv.fold_seconds, srv.evictions
    finally:
        srv.close()
    snap = telemetry.get().snapshot()
    spans = snap["spans"]

    def total(name):
        return spans.get(name, {}).get("total", 0.0)

    steps = rounds * W * Kw
    tensors = len(center)
    moved = max(float(np.abs(c - p.cpu().numpy()).max())
                for c, p in zip(center, model.params.values()))
    same = all(np.array_equal(p.cpu().numpy(), c)
               for p, c in zip(trained.params.values(), center))
    hist = trainer.get_worker_histories()
    comms = total("netps.rpc.pull") + total("netps.rpc.commit")
    emit({"phase": "remote_train", "gpu": gpu, "trainer": "DynSGD",
          "server": "PSServer(discipline='dynsgd', device='cuda')",
          "codec": codec, "rounds": rounds, **REMOTE, "dtype": "float32",
          "seconds": wall, "samples_per_s": steps * B / wall,
          "history": [float(v) for v in trainer.get_history()],
          "worker_histories": hist.tolist(), "commits": len(log),
          "staleness": [st for _w, _s, st in log], "evictions": evictions,
          "fold_backend": stats.get("fold_backend"),
          "launches": {**lstm, **fold}, "local_steps": steps,
          "tensors_per_commit": tensors, "center_max_abs_change": moved,
          "model_equals_server_center": same,
          "worker_comms_s": comms,
          "worker_pull_s": total("netps.rpc.pull"),
          "worker_commit_s": total("netps.rpc.commit"),
          "worker_local_window_s": total("netps.remote.local_window"),
          "server_fold_ms_per_commit": fold_s / max(1, len(log)) * 1e3,
          "server_commit_ms_per_commit":
              total("netps.server.commit") / max(1, len(log)) * 1e3,
          **handler_stats(handler_ms),
          "server_commit_ms": handler_ms["commit"],
          "bytes_sent": snap["counters"].get("netps.bytes_sent"),
          "bytes_precompress": snap["counters"].get(
              "netps.bytes_precompress"),
          "timing": "host clock; worker_* are sums over the W worker "
                    "threads (each blocks through its own pull and commit "
                    "RPCs); the local window ends when its delta is on the "
                    "host"})
    if stats.get("fold_backend") != "cuda":
        fail(f"the server folded with {stats.get('fold_backend')!r}, not "
             f"the CUDA kernel")
    if not np.all(np.isfinite(hist)):
        fail(f"non-finite remote training loss: {hist}")
    if not moved > 0:
        fail("the remote run's center did not move")
    if not same:
        fail("the trained model is not the server's center")
    if len(log) != W * rounds:
        fail(f"{len(log)} commits folded of {W * rounds} ({evictions} "
             f"evictions)")
    if fold != {"fold_commit": len(log), "fold_int8": 0, "fold_bf16": 0}:
        fail(f"fold launches {fold} for {len(log)} commits of {tensors} "
             f"{codec} tensors: one fold_commit a commit, none a tensor")
    if not (lstm["lstm_fwd_stash"] == lstm["lstm_bwd"] == steps
            and lstm["lstm_fwd"] == 0):
        fail(f"LSTM launches {lstm} in {steps} local steps")
    return fold


def remote_parity_phase(torch, seed: int) -> None:
    """One worker at full width, batch 32: server and model on the card,
    then both on the CPU, from the same weights, codec none and int8."""
    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch.datasets import imdb
    from distkeras_tpu_torch.netps import PSServer
    from distkeras_tpu_torch.trainers import DynSGD

    W, Kw, B = (REMOTE_PARITY["num_workers"],
                REMOTE_PARITY["communication_window"],
                REMOTE_PARITY["batch_size"])
    df = imdb(n=REMOTE_PARITY_ROUNDS * W * Kw * B, vocab_size=VOCAB,
              seq_len=SEQ_LEN, seed=seed + 2)
    for codec in ("none", "int8"):
        out = {}
        for dev in ("cuda", "cpu"):
            model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED,
                              hidden_size=HIDDEN, seq_len=SEQ_LEN,
                              seed=seed + 2, device=dev)
            init = {k: v.detach().cpu().clone()
                    for k, v in model.params.items()}
            srv = PSServer(discipline="dynsgd", device=dev).start()
            try:
                with env_set(DKTPU_NET_COMPRESS=codec), \
                        quant_steps() as steps:
                    t = DynSGD(model, worker_optimizer="sgd",
                               loss="sparse_categorical_crossentropy",
                               remote=srv.endpoint, **REMOTE_PARITY)
                    trained = t.train(df)
            finally:
                srv.close()
            out[dev] = ({k: v.cpu() for k, v in trained.params.items()},
                        t.get_worker_histories(), steps)
        center_err = max((out["cuda"][0][k] - v).abs().max().item()
                         for k, v in out["cpu"][0].items())
        hist_err = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
        change = max((v - init[k]).abs().max().item()
                     for k, v in out["cpu"][0].items())
        step_sum = sum(max(a, b) for a, b in zip(out["cuda"][2],
                                                  out["cpu"][2]))
        # int8: the centers are the same init plus integer multiples of
        # each commit's step, so they can differ by a flipped rounding, at
        # most one step per commit. The losses also carry the f32 noise.
        limit = step_sum if codec == "int8" else REMOTE_PARITY_ATOL
        hist_limit = REMOTE_PARITY_ATOL + step_sum
        emit({"phase": "remote_parity", "trainer": "DynSGD", "codec": codec,
              **REMOTE_PARITY, "rounds": REMOTE_PARITY_ROUNDS,
              "center_max_abs_err_card_vs_cpu": center_err,
              "history_max_abs_err": hist_err,
              "center_max_abs_change": change,
              "quant_steps_per_commit": {d: out[d][2] for d in out},
              "quant_step_sum": step_sum, "limit": limit,
              "history_limit": hist_limit})
        if not change > 0:
            fail("the remote parity run's center did not move")
        if len(out["cuda"][2]) != len(out["cpu"][2]):
            fail(f"remote parity runs folded {len(out['cuda'][2])} and "
                 f"{len(out['cpu'][2])} commits")
        if not (center_err <= limit and hist_err <= hist_limit):
            fail(f"remote card and CPU runs disagree with codec {codec}: "
                 f"center {center_err} (limit {limit}), history {hist_err} "
                 f"(limit {hist_limit})")


def remote_run(torch, K, F, seed: int, df, endpoint: str, rounds: int,
               **env) -> dict:
    """One ``DynSGD(imdb_lstm(...), remote=endpoint)`` run at config #4's
    width and :data:`REMOTE`'s workers, window and batch, int8 commits and
    ``env`` set; the launch counts are set to 0 just before ``train`` and
    read just after. Returns the run's numbers and trainer."""
    from distkeras_tpu_torch import imdb_lstm, telemetry
    from distkeras_tpu_torch.trainers import DynSGD

    W, Kw, B = (REMOTE["num_workers"], REMOTE["communication_window"],
                REMOTE["batch_size"])
    model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                      seq_len=SEQ_LEN, seed=seed, device="cuda")
    with env_set(DKTPU_NET_COMPRESS="int8", **env):
        trainer = DynSGD(model, worker_optimizer="sgd",
                         loss="sparse_categorical_crossentropy",
                         remote=endpoint, **REMOTE)
        telemetry.reset()
        torch.cuda.synchronize()
        # counts start at 0 just before the main path runs
        K.reset_launches()
        F.reset_launches()
        t0 = time.perf_counter()
        trained = trainer.train(df)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    hist = trainer.get_worker_histories()
    snap = telemetry.get().snapshot()
    return {"trainer": trainer, "trained": trained, "wall": wall,
            "steps": rounds * W * Kw,
            "samples_per_s": rounds * W * Kw * B / wall,
            "lstm": K.launch_counts(), "fold": F.launch_counts(),
            "finite": bool(np.all(np.isfinite(hist))), "snap": snap}


def exactly_once(log) -> bool:
    """No ``(worker, seq)`` folded twice in ``log``."""
    keys = [(w, s) for w, s, *_ in log]
    return len(keys) == len(set(keys))


def same_bits(a, b) -> bool:
    return len(a) == len(b) and all(
        np.asarray(x).tobytes() == np.asarray(y).tobytes()
        for x, y in zip(a, b))


def recover_on_card(torch, F, state_dir: str) -> dict:
    """Build a fresh ``PSServer(device="cuda", state_dir=...)`` (not
    started): its center, the records its recovery replayed, the
    ``fold_commit`` launches that took (counts set to 0 just before) and
    the replay's ms per record."""
    from distkeras_tpu_torch.netps import PSServer

    F.reset_launches()
    srv = PSServer(discipline="dynsgd", device="cuda", state_dir=state_dir)
    try:
        launches = F.launch_counts()["fold_commit"]
        out = {"center": srv.center(), "updates": srv.updates,
               "replayed": srv.recovered_records, "launches": launches,
               "replay_ms_per_record": (srv.recovery_seconds * 1e3
                                        / max(1, srv.recovered_records))}
    finally:
        srv.close()
    return out


def remote_overlap_phase(torch, K, F, gpu: str, seed: int, workdir: str
                         ) -> dict:
    """Config #4 against ``PSServer(device="cuda")`` three ways at the same
    rounds, each once: the serial loop without a state directory, the
    serial loop with one (what the journal costs) and the overlapped loop
    (``DKTPU_NET_INFLIGHT=2``) with one. One reading an arm does not
    resolve samples/s between them (host times spread between runs of one
    tree); that comparison is left to a benchmark cell. Each durable
    run's directory is then recovered on the card, as it is and with its
    newest snapshot removed (the fallback replays the journal after the
    one before). Returns the ``fold_commit`` launches of the replays."""
    from distkeras_tpu_torch.datasets import imdb
    from distkeras_tpu_torch.netps import PSServer

    W, Kw, B = (REMOTE["num_workers"], REMOTE["communication_window"],
                REMOTE["batch_size"])
    df = imdb(n=OVERLAP_ROUNDS * W * Kw * B, vocab_size=VOCAB,
              seq_len=SEQ_LEN, seed=seed)
    arms = (("serial", "1", False), ("serial_journal", "1", True),
            ("overlap_journal", "2", True))
    runs, replay_launches = {}, 0
    for arm, inflight, durable in arms:
        d = os.path.join(workdir, arm)
        shutil.rmtree(d, ignore_errors=True)
        srv = PSServer(discipline="dynsgd", device="cuda",
                       state_dir=d if durable else None,
                       snapshot_every=OVERLAP_SNAPSHOT_EVERY).start()
        try:
            run = remote_run(torch, K, F, seed, df, srv.endpoint,
                             OVERLAP_ROUNDS, DKTPU_NET_INFLIGHT=inflight)
            log = list(srv.commit_log)
            center = srv.center()
            journal_bytes = srv.journal_bytes
            snaps, snap_s = srv.snapshots_written, srv.snapshot_seconds
        finally:
            srv.close()
        model_is_center = same_bits(
            [p.cpu().numpy() for p in run["trained"].params.values()], center)
        stale = [st for _w, _s, st in log]
        gauges = run["snap"]["gauges"]
        row = {"phase": "remote_overlap", "gpu": gpu, "arm": arm,
               "inflight": int(inflight), "state_dir": durable,
               "snapshot_every": OVERLAP_SNAPSHOT_EVERY if durable else None,
               "rounds": OVERLAP_ROUNDS, **REMOTE, "codec": "int8",
               "seconds": run["wall"], "samples_per_s": run["samples_per_s"],
               "commits": len(log), "mean_staleness": float(np.mean(stale)),
               "max_staleness": max(stale),
               "hidden_fraction": gauges.get(
                   "netps.overlap.hidden_fraction", {}).get("value"),
               "journal_bytes": journal_bytes,
               "journal_bytes_per_commit": journal_bytes / max(1, len(log)),
               "snapshots": snaps,
               "snapshot_ms": snap_s * 1e3 / snaps if snaps else None,
               "launches": {**run["lstm"], **run["fold"]},
               "model_equals_server_center": model_is_center,
               "timing": "host clock around trainer.train; snapshot_ms is "
                         "the server's host time a snapshot (the fsync "
                         "included)"}
        if durable:
            rec = recover_on_card(torch, F, d)
            fallback = d + "-fallback"
            shutil.rmtree(fallback, ignore_errors=True)
            shutil.copytree(d, fallback)
            newest = max(p for p in os.listdir(fallback)
                         if p.endswith(".dks"))
            os.unlink(os.path.join(fallback, newest))
            back = recover_on_card(torch, F, fallback)
            replay_launches += rec["launches"] + back["launches"]
            row.update(
                recovered_equal=same_bits(rec["center"], center),
                recovered_updates=rec["updates"],
                replayed=rec["replayed"], replay_launches=rec["launches"],
                fallback_equal=same_bits(back["center"], center),
                fallback_replayed=back["replayed"],
                fallback_replay_launches=back["launches"],
                replay_ms_per_record=back["replay_ms_per_record"])
            shutil.rmtree(fallback, ignore_errors=True)
        emit(row)
        runs[arm] = row
        steps = run["steps"]
        if not run["finite"]:
            fail(f"remote_overlap {arm}: non-finite losses")
        if len(log) != W * OVERLAP_ROUNDS or not exactly_once(log):
            fail(f"remote_overlap {arm}: {len(log)} commits folded, or one "
                 f"twice")
        if run["fold"] != {"fold_commit": len(log), "fold_int8": 0,
                           "fold_bf16": 0}:
            fail(f"remote_overlap {arm}: fold launches {run['fold']} for "
                 f"{len(log)} commits")
        if not (run["lstm"]["lstm_fwd_stash"] == run["lstm"]["lstm_bwd"]
                == steps):
            fail(f"remote_overlap {arm}: LSTM launches {run['lstm']} in "
                 f"{steps} steps")
        if not model_is_center:
            fail(f"remote_overlap {arm}: the model is not the center")
        if durable and not (row["recovered_equal"] and row["fallback_equal"]
                            and row["recovered_updates"] == len(log)
                            and row["replay_launches"] == row["replayed"]
                            and row["fallback_replay_launches"]
                            == row["fallback_replayed"]
                            == OVERLAP_SNAPSHOT_EVERY):
            fail(f"remote_overlap {arm}: the recovered center or its "
                 f"replay launches are wrong: {row}")
        shutil.rmtree(d, ignore_errors=True)
    if runs["overlap_journal"]["hidden_fraction"] is None:
        fail("remote_overlap: no netps.overlap.hidden_fraction gauge")
    emit({"phase": "remote_overlap_summary", "gpu": gpu,
          **{f"{arm}_samples_per_s": row["samples_per_s"]
             for arm, row in runs.items()},
          "hidden_fraction": runs["overlap_journal"]["hidden_fraction"],
          "mean_staleness": {arm: row["mean_staleness"]
                             for arm, row in runs.items()}})
    return {"replay": replay_launches}


def hard_stop(srv) -> None:
    """Stop a server as its process's death would, without a drain: no
    ``draining`` answer, the listener gone, every handler ended after the
    frame it is serving."""
    srv._stop.set()
    try:
        srv._listener.close()
    except OSError:
        pass
    for t in [srv._accept_thread, srv._monitor_thread, *srv._threads]:
        if t is not None:
            t.join()


def ps_failover_phase(torch, K, F, gpu: str, seed: int) -> dict:
    """Config #4 against ``"<primary>,<standby>"``, both on the card, lease
    ``FAILOVER_LEASE``: once round 1 is folded and replicated the primary
    stops as a dead process would; the standby promotes and the workers
    walk to it.
    Returns the standby's ``fold_commit`` launches (replicated records and
    its own folds): the run's count less the primary's folds."""
    from distkeras_tpu_torch.datasets import imdb
    from distkeras_tpu_torch.netps import PSServer, StandbyServer

    W, Kw, B = (REMOTE["num_workers"], REMOTE["communication_window"],
                REMOTE["batch_size"])
    df = imdb(n=FAILOVER_ROUNDS * W * Kw * B, vocab_size=VOCAB,
              seq_len=SEQ_LEN, seed=seed + 3)
    srv = PSServer(discipline="dynsgd", device="cuda",
                   lease_s=FAILOVER_LEASE).start()
    sb = StandbyServer(srv.endpoint, discipline="dynsgd", device="cuda",
                       lease_s=FAILOVER_LEASE,
                       promote_after=FAILOVER_LEASE).start()
    # The primary's center after each fold, by update count: what the
    # standby must hold at whatever index it last replicated.
    history = {}
    real_seat, real_fold = srv._seat_locked, srv._fold_locked

    def seat_and_keep(init):
        history[0] = [np.array(a, np.float32) for a in init]
        return real_seat(init)

    def fold_and_keep(*a):
        st = real_fold(*a)
        history[srv._updates] = [x.copy() for x in srv._host_center_locked()]
        return st

    srv._seat_locked, srv._fold_locked = seat_and_keep, fold_and_keep
    seen = {}
    real_promote = sb._promote

    def promote():
        seen["center"], seen["updates"] = sb.center(), sb.updates
        seen["log_len"] = len(sb.commit_log)
        real_promote()

    sb._promote = promote
    real_commit = sb._op_commit
    post = []  # (epoch the request carried, applied) after promotion

    def op_commit(header, arrays):
        reply, out = real_commit(header, arrays)
        post.append((header.get("epoch"), bool(reply.get("applied"))))
        if reply.get("applied") and "first_fold" not in seen:
            seen["first_fold"] = time.monotonic()
        return reply, out

    sb._op_commit = op_commit
    killed = {}

    def killer():
        # Round 1 folded and replicated, a record among it: the standby
        # then holds a center it folded itself, not only a synced one.
        while (srv.commits_total < W or sb.updates < W
               or sb.replicated < 1) and not killed.get("cancel"):
            time.sleep(0.005)
        if killed.get("cancel"):
            return
        killed["at"] = time.monotonic()
        hard_stop(srv)
        killed["done"] = time.monotonic()

    watcher = threading.Thread(target=killer, name="ps-killer")
    watcher.start()
    try:
        run = remote_run(torch, K, F, seed + 3, df,
                         f"{srv.endpoint},{sb.endpoint}", FAILOVER_ROUNDS,
                         DKTPU_NET_TIMEOUT="10")
    finally:
        killed["cancel"] = True
        watcher.join()
        sb.close()
        srv.close()
    primary_log, sb_log = list(srv.commit_log), list(sb.commit_log)
    after = sb_log[seen.get("log_len", len(sb_log)):]
    fenced = run["snap"]["counters"].get("netps.failover.fenced_commits", 0)
    promoted_center_equal = (
        seen.get("updates", -1) in history
        and same_bits(seen["center"], history[seen["updates"]]))
    stale_folded = [e for e, applied in post if applied and e != sb.epoch]
    launches = run["fold"]["fold_commit"]
    want = len(primary_log) + sb.replicated + len(after)
    row = {"phase": "ps_failover", "gpu": gpu, "rounds": FAILOVER_ROUNDS,
           **REMOTE, "codec": "int8", "lease_s": FAILOVER_LEASE,
           "promote_after": FAILOVER_LEASE, "seconds": run["wall"],
           "samples_per_s": run["samples_per_s"],
           "primary_commits": len(primary_log),
           "replicated": sb.replicated, "snapshot_syncs": sb.snapshot_syncs,
           "standby_updates_at_promotion": seen.get("updates"),
           "primary_updates_at_kill": max(history, default=0),
           "standby_commits_after_promotion": len(after),
           "epoch": sb.epoch, "promoted": sb.promoted,
           "promoted_center_equal": promoted_center_equal,
           "kill_to_promotion_s": (sb.promoted_at - killed["at"]
                                   if sb.promoted_at and "at" in killed
                                   else None),
           "kill_to_first_standby_fold_s": (
               seen["first_fold"] - killed["at"]
               if "first_fold" in seen and "at" in killed else None),
           "fenced_commits": fenced, "stale_epoch_folds": len(stale_folded),
           "fold_launches": launches, "fold_launches_expected": want,
           "rejoins": sb.rejoins, "evictions": sb.evictions,
           "launches": {**run["lstm"], **run["fold"]}}
    emit(row)
    if "at" not in killed or not sb.promoted or sb.epoch != 1:
        fail(f"ps_failover: the primary was not killed or the standby did "
             f"not promote to epoch 1: {row}")
    if not promoted_center_equal:
        fail("ps_failover: the standby's center at promotion is not the "
             "primary's at the index it last replicated")
    if not run["finite"]:
        fail("ps_failover: non-finite losses")
    if not exactly_once(primary_log + after) or not exactly_once(sb_log):
        fail("ps_failover: a (worker, seq) was folded twice across the two "
             "servers")
    if stale_folded or fenced < 0:
        fail(f"ps_failover: {len(stale_folded)} stale-epoch commits folded")
    if launches != want:
        fail(f"ps_failover: {launches} fold_commit launches, want {want} "
             f"(primary folds + replicated records + standby folds)")
    if not after:
        fail("ps_failover: nothing was folded on the promoted standby")
    return {"standby": launches - len(primary_log)}


def cli_server(workdir: str) -> dict:
    """Start the port's CLI server for ``ps_restart`` (journal only, on a
    free port, state in ``workdir/ps_restart``) without waiting for it:
    its start-up (torch, the card, the fold library) overlaps the phase
    before. ``ps_restart_phase`` reads its ``NETPS_READY`` line."""
    d = os.path.join(workdir, "ps_restart")
    shutil.rmtree(d, ignore_errors=True)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    cmd = [sys.executable, "-m", "distkeras_tpu_torch.netps", "--host",
           "127.0.0.1", "--port", str(port), "--discipline", "dynsgd",
           "--device", "cuda", "--state-dir", d, "--snapshot-every", "0"]
    return {"dir": d, "endpoint": f"127.0.0.1:{port}", "cmd": cmd,
            "lives": [(time.monotonic(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        text=True))]}


def ps_restart_phase(torch, K, F, gpu: str, seed: int, cli: dict) -> dict:
    """The port's CLI server (``python -m distkeras_tpu_torch.netps
    --device cuda --state-dir D --snapshot-every 0``: the journal alone,
    never pruned, so it holds both lives) in a subprocess, SIGKILLed
    mid-run and restarted on the same port and directory while config #4
    trains against it; the workers ride through on retries. Returns the
    ``fold_commit`` launches of this process's replay of the final
    directory."""
    from distkeras_tpu_torch.datasets import imdb
    from distkeras_tpu_torch.netps import PSClient, state

    W, Kw, B = (REMOTE["num_workers"], REMOTE["communication_window"],
                REMOTE["batch_size"])
    d, endpoint, lives = cli["dir"], cli["endpoint"], cli["lives"]
    df = imdb(n=RESTART_ROUNDS * W * Kw * B, vocab_size=VOCAB,
              seq_len=SEQ_LEN, seed=seed + 4)

    def ready() -> float:
        """Seconds from the newest life's start to its ``NETPS_READY``."""
        t0, proc = lives[-1]
        line = proc.stdout.readline()
        if not line.startswith("NETPS_READY"):
            fail(f"ps_restart: the server did not start: {line!r}")
        return time.monotonic() - t0

    acked = set()
    real_commit = PSClient.commit

    def commit(self, delta, pulled_counter):
        seq = self._seq + 1
        res = real_commit(self, delta, pulled_counter)
        if res.applied or res.duplicate:
            acked.add((self.worker_id, seq))
        return res

    killed = {}

    def killer():
        with PSClient(endpoint, timeout=10.0) as observer:
            while not killed.get("cancel"):
                if observer.stats()["updates"] >= RESTART_KILL_AT:
                    break
                time.sleep(0.02)
        if killed.get("cancel"):
            return
        lives[0][1].send_signal(signal.SIGKILL)
        lives[0][1].wait()
        killed["at"] = time.monotonic()
        lives.append((killed["at"], subprocess.Popen(
            cli["cmd"], stdout=subprocess.PIPE, text=True)))
        killed["restart_s"] = ready()

    PSClient.commit = commit
    try:
        first_start = ready()
        watcher = threading.Thread(target=killer, name="ps-restart-killer")
        watcher.start()
        try:
            run = remote_run(torch, K, F, seed + 4, df, endpoint,
                             RESTART_ROUNDS, DKTPU_NET_RETRIES="60",
                             DKTPU_NET_TIMEOUT="20")
        finally:
            killed["cancel"] = True
            watcher.join()
        with PSClient(endpoint, timeout=20.0) as observer:
            live_center, live_updates = observer.pull()
            stats = observer.stats()
        lives[-1][1].send_signal(signal.SIGTERM)
        drained = lives[-1][1].stdout.read()
        lives[-1][1].wait(timeout=60)
    finally:
        PSClient.commit = real_commit
        for _t0, proc in lives:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    records = state.read_journal(d)
    journaled = [(int(r["wid"]), int(r["seq"])) for r in records]
    lost = sorted(acked - set(journaled))
    rec = recover_on_card(torch, F, d)
    row = {"phase": "ps_restart", "gpu": gpu, "rounds": RESTART_ROUNDS,
           **REMOTE, "codec": "int8", "kill_at_updates": RESTART_KILL_AT,
           "lives": len(lives), "first_start_s": first_start,
           "first_start_overlapped": "ps_failover",
           "restart_s": killed.get("restart_s"),
           "seconds": run["wall"], "samples_per_s": run["samples_per_s"],
           "journal_records": len(journaled),
           "acked_commits": len(acked), "lost_acked_records": lost,
           "write_queue": state._WRITE_QUEUE,
           "final_updates": live_updates,
           "recovered_equal": same_bits(rec["center"], live_center),
           "recovered_updates": rec["updates"],
           "replayed": rec["replayed"], "replay_launches": rec["launches"],
           "replay_ms_per_record": rec["replay_ms_per_record"],
           "server_fold_backend": stats.get("fold_backend"),
           "drained": drained.strip().splitlines()[-1:],
           "model_equals_server_center": same_bits(
               [p.cpu().numpy() for p in run["trained"].params.values()],
               live_center),
           "launches": run["lstm"]}
    emit(row)
    shutil.rmtree(d, ignore_errors=True)
    if len(lives) != 2 or "restart_s" not in killed:
        fail(f"ps_restart: the server was not killed and restarted: {row}")
    if not run["finite"]:
        fail("ps_restart: non-finite losses")
    if len(journaled) != len(set(journaled)):
        fail("ps_restart: a (worker, seq) is journaled twice across the two "
             "lives")
    if len(lost) > state._WRITE_QUEUE:
        fail(f"ps_restart: {len(lost)} acknowledged records lost, more than "
             f"the writer queue's {state._WRITE_QUEUE}")
    if not (row["recovered_equal"] and rec["updates"] == live_updates):
        fail("ps_restart: the restarted server's center is not its own "
             "replay")
    if rec["launches"] != rec["replayed"]:
        fail(f"ps_restart: {rec['launches']} fold_commit launches for "
             f"{rec['replayed']} replayed records")
    if not row["model_equals_server_center"]:
        fail("ps_restart: the model is not the server's center")
    if stats.get("fold_backend") != "cuda":
        fail(f"ps_restart: the server folded with "
             f"{stats.get('fold_backend')!r}")
    return {"replay": rec["launches"]}


# -- config #8: the AEASGD transformer through the parameter server ---------

#: config #8 (``bench.py:1465-1468``, the run at ``:484-760``): the model,
#: the window and the rounds; one worker, AEASGD alpha 0.05 (rho 500 at lr
#: 1e-4), adam, bf16 with flash attention and remat, as the reference runs
#: it on its chip.
C8 = dict(vocab_size=8192, num_layers=4, d_model=512, num_heads=8,
          d_ff=2048, max_seq_len=128)
C8_SEQ, C8_BATCH, C8_WINDOW, C8_ROUNDS = 128, 4, 2, 12
C8_ALPHA, C8_LR = 0.05, 1e-4
#: timed runs of each arm after one warm run (the median is reported).
C8_TIMED = 2
#: the warm run's rounds: enough to attach every lane and launch every
#: kernel of the arm once, at a sixth of a timed run's time.
C8_WARM_ROUNDS = 2
#: the span suffix of each dialect: TCP bare, then the ring and the mesh.
C8_DIALECTS = ("", ".shm", ".mesh")
#: the demotion drill's server goes away (its token is unregistered) once
#: this many commits are folded.
C8_DEMOTE_AT = 4
#: the arms that need an item the port does not serve yet.
C8_NOT_PORTED = {"optimized": "striping over 2 shards (item 4c)",
                 "durable": "the journal on the striped plane (item 4c)",
                 "auto": "the tuner (item 4e)",
                 "hier_curve": "the per-host aggregator (item 4d)",
                 "sim_drift": "sim/ (item 10)"}


def c8_mesh_fold_check(torch, F, params: dict, seed: int) -> dict:
    """Check (d): a ``MeshFolder`` seated on the card with config #8's
    tensors folds a seeded f32, bf16 and int8 commit (scale 1, AEASGD's)
    and one more int8 commit at scale 1/3 bit-equal to the numpy oracle,
    one ``fold_commit`` launch each."""
    from distkeras_tpu_torch.netps import MeshFolder, wire
    from distkeras_tpu_torch.netps.fold import fold_compressed_numpy

    rng = np.random.default_rng(seed + 8)
    center = [v.detach().float().cpu().numpy().copy()
              for v in params.values()]
    folder = MeshFolder(center, device="cuda")
    ref = [a.copy() for a in center]
    F.reset_launches()
    t0 = time.perf_counter()
    for codec, scale in (("none", 1.0), ("bf16", 1.0), ("int8", 1.0),
                         ("int8", 1.0 / 3.0)):
        entries = []
        for r in ref:
            d = rng.normal(scale=1e-3, size=r.shape).astype(np.float32)
            q, spec = wire.codec_encode(d, codec)
            entries.append((q, spec) if spec else q)
            if spec:
                fold_compressed_numpy(r, q, spec, scale)
            else:
                r += np.float32(scale) * q
        folder.fold(entries, scale)
    got = folder.center_host()
    seconds = time.perf_counter() - t0
    launches = F.launch_counts()
    folder.close()
    bad = [i for i, (a, b) in enumerate(zip(got, ref))
           if a.tobytes() != b.tobytes()]
    return {"tensors": len(center), "commits": 4, "launches": launches,
            "bit_equal": not bad, "tensors_off": bad[:8],
            "seconds": seconds}


def c8_run(torch, F, FA, arm: str, model, plan, loop, df, tokens: int,
           inflight: int = 1, on_fold=None) -> dict:
    """One run of arm ``arm`` from the model's weights: ``inprocess`` is
    ``AEASGD(...).train(df)`` in process (the engine's elastic fold); the
    others ``run_remote`` against a fresh ``PSServer(device="cuda")`` of
    that transport (``pr4`` is TCP), one worker, f32 commits. The launch
    counts are set to 0 just before and read just after; ``on_fold(srv)``
    runs in a thread that watches the server's commit log."""
    from distkeras_tpu_torch import AEASGD, telemetry
    from distkeras_tpu_torch.netps import PSServer
    from distkeras_tpu_torch.netps.remote import run_remote
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import adam

    transport = {"pr4": "tcp"}.get(arm, arm)
    srv = watcher = None
    telemetry.reset()
    if arm != "inprocess":
        srv = PSServer(discipline="aeasgd", device="cuda",
                       transport=transport).start()
    try:
        if on_fold is not None:
            watcher = threading.Thread(target=on_fold, args=(srv,))
            watcher.start()
        torch.cuda.synchronize()
        F.reset_launches()  # counts start at 0 just before the run
        FA.reset_launches()
        t0 = time.perf_counter()
        if srv is None:
            trainer = AEASGD(model, "adam", "sparse_categorical_crossentropy",
                             num_workers=1, batch_size=C8_BATCH,
                             communication_window=C8_WINDOW,
                             learning_rate=C8_LR, rho=C8_ALPHA / C8_LR,
                             compute_dtype="bfloat16")
            params = trainer.train(df).params
            losses = np.asarray(trainer.get_worker_histories()).T
        else:
            params, losses = run_remote(
                endpoint=srv.endpoint, model=model, tx=adam(C8_LR),
                loss_fn=get_loss("sparse_categorical_crossentropy"),
                plan=plan, discipline="aeasgd", window=C8_WINDOW,
                alpha=C8_ALPHA, seed=0, inflight=inflight,
                transport=transport, compress="none", loop_fn=loop)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fold, flash = F.launch_counts(), FA.launch_counts()
        flash_entries = FA.launch_counts(by_entry=True)
        if watcher is not None:
            watcher.join()
        log = list(srv.commit_log) if srv is not None else []
        center = srv.center() if srv is not None else None
    finally:
        if srv is not None:
            srv.close()
    snap = telemetry.get().snapshot()
    counters = snap["counters"]
    dialect = {"tcp": ""}.get(transport, "." + transport)
    spans = {name: span_stats(snap, name) for name in (
        ["netps.remote.local_window"]
        + [f"netps.{side}.pull{dialect}" for side in ("rpc", "server")]
        + [f"netps.{side}.commit{d}" for side in ("rpc", "server")
           for d in C8_DIALECTS] if srv is not None else [])}
    return {"arm": arm, "transport": transport, "inflight": inflight,
            "dialect": dialect, "rounds": plan.num_rounds,
            "seconds": wall, "tokens_per_s": tokens / wall,
            "params": params, "center": center, "losses": losses,
            "log": log, "fold": fold, "flash": flash,
            "flash_entries": flash_entries, "spans": spans,
            "counters": {k: counters.get(k, 0) for k in (
                "netps.shm_upgrades", "netps.mesh.upgrades",
                "netps.mesh.folds", "netps.mesh.demotions",
                "netps.shm_fallbacks", "netps.bytes_sent",
                "netps.reconnects")}}


def c8_check_run(torch, run: dict, init: dict, label: str,
                 drill: bool = False) -> list:
    """Checks (a)-(c) of one run (``label`` names it in a failure);
    returns the failures. A ``drill`` run changes dialect on purpose: its
    dialect checks are the phase's own (e)."""
    bad, arm, rounds = [], run["arm"], run["rounds"]
    steps = rounds * C8_WINDOW
    if not np.all(np.isfinite(run["losses"])):
        bad.append(f"{label}: non-finite losses {run['losses'].tolist()}")
    moved = max((run["params"][k] - v).abs().max().item()
                for k, v in init.items())
    run["center_max_abs_change"] = moved
    if not moved > 0:
        bad.append(f"{label}: the center did not move")
    want_flash = {"flash_fwd": 2 * C8["num_layers"] * steps,
                  "flash_dq": C8["num_layers"] * steps,
                  "flash_dkv": C8["num_layers"] * steps}
    if run["flash"] != want_flash:
        bad.append(f"{label}: flash launches {run['flash']}, want "
                   f"{want_flash} (4 layers, remat, {steps} steps)")
    other = {k: v for k, v in run["flash_entries"].items()
             if v and not k.endswith("_bf16")}
    if other:
        bad.append(f"{label}: flash launched outside bf16: {other}")
    if arm == "inprocess":
        if any(run["fold"].values()):
            bad.append(f"{label}: the fold kernel launched {run['fold']}")
        return bad
    seqs = [(w, s) for w, s, _st in run["log"]]
    if sorted(seqs) != [(0, s) for s in range(rounds)]:
        bad.append(f"{label}: commit log {seqs}, want (0, 0..{rounds - 1}) "
                   f"once each")
    if run["fold"].get("fold_commit") != len(run["log"]) or any(
            v for k, v in run["fold"].items() if k != "fold_commit"):
        bad.append(f"{label}: fold launches {run['fold']} for "
                   f"{len(run['log'])} folded commits")
    if not drill:
        # Every commit went out and was served on the arm's dialect: the
        # fold launches above came from that dialect's path.
        for side in ("rpc", "server"):
            got = {d or ".tcp": run["spans"][f"netps.{side}.commit{d}"][
                "count"] for d in C8_DIALECTS}
            want = {d or ".tcp": rounds if d == run["dialect"] else 0
                    for d in C8_DIALECTS}
            if got != want:
                bad.append(f"{label}: {side} commits by dialect {got}, "
                           f"want {want}")
        c = run["counters"]
        if c["netps.mesh.demotions"] or c["netps.shm_fallbacks"]:
            bad.append(f"{label}: the client left its dialect: {c}")
        want_mesh = len(run["log"]) if arm == "mesh" else 0
        if c["netps.mesh.folds"] != want_mesh:
            bad.append(f"{label}: netps.mesh.folds {c['netps.mesh.folds']}, "
                       f"want {want_mesh}")
    if not same_bits([v.cpu().numpy() for v in run["params"].values()],
                     run["center"]):
        bad.append(f"{label}: the returned params are not the server's center")
    return bad


def netps_config8_phase(torch, F, FA, gpu: str, seed: int) -> dict:
    """Config #8 (``netps_loopback_aeasgd``) at full width through the arms
    the port serves: ``inprocess``, ``pr4`` (TCP, inflight 1), ``shm`` (the
    ring, inflight 2) and ``mesh`` (the in-process dispatch, inflight 2),
    one warm run and ``C8_TIMED`` timed runs each; then the mesh fold's
    bit check (d), the demotion drill (e) and a mesh run at inflight 1
    against ``pr4``'s center (f). Returns the fold and flash launches of
    the mesh arm's first timed run."""
    import copy

    from distkeras_tpu_torch import small_transformer_lm
    from distkeras_tpu_torch.data.batching import make_batches
    from distkeras_tpu_torch.netps import mesh as netps_mesh
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import adam
    from distkeras_tpu_torch.workers import make_local_loop

    t_phase = time.perf_counter()
    model = small_transformer_lm(**C8, seq_len=C8_SEQ, attn_impl="flash",
                                 remat=True, seed=seed, device="cuda")
    n_params = sum(v.numel() for v in model.params.values())
    init = {k: v.detach().clone() for k, v in model.params.items()}

    def data(rounds):
        df = lm_frame(rounds * C8_WINDOW * C8_BATCH, C8["vocab_size"],
                      C8_SEQ, seed)
        return (make_batches(df, "features", "label", C8_BATCH,
                             num_workers=1, window=C8_WINDOW), df,
                rounds * C8_WINDOW * C8_BATCH * C8_SEQ)

    plan, df, tokens = data(C8_ROUNDS)
    warm = data(C8_WARM_ROUNDS)
    # One local loop for every remote run, as bench.py shares one jitted
    # window; one worker, so no two threads call it at once.
    loop = make_local_loop(copy.deepcopy(model.module),
                           get_loss("sparse_categorical_crossentropy"),
                           adam(C8_LR), compute_dtype=torch.bfloat16)
    failures: list = []
    arms = {}
    for arm, inflight in (("inprocess", 1), ("pr4", 1), ("shm", 2),
                          ("mesh", 2)):
        runs = [c8_run(torch, F, FA, arm, model, warm[0], loop, *warm[1:],
                       inflight)] + [
            c8_run(torch, F, FA, arm, model, plan, loop, df, tokens, inflight)
            for _ in range(C8_TIMED)]
        for i, run in enumerate(runs):
            failures += c8_check_run(torch, run, init, f"{arm}[{i}]")
        arms[arm] = runs
    timed = {arm: runs[1:] for arm, runs in arms.items()}
    tps = {arm: float(np.median([r["tokens_per_s"] for r in runs]))
           for arm, runs in timed.items()}

    fold_check = c8_mesh_fold_check(torch, F, model.params, seed)
    if not fold_check["bit_equal"] or fold_check["launches"].get(
            "fold_commit") != fold_check["commits"]:
        failures.append(f"(d) mesh fold on the card: {fold_check}")

    def unregister_after(srv):
        deadline = time.monotonic() + 120.0
        while (len(srv.commit_log) < C8_DEMOTE_AT
               and time.monotonic() < deadline):
            time.sleep(0.001)
        netps_mesh.unregister(srv._mesh_token)

    drill = c8_run(torch, F, FA, "mesh", model, plan, loop, df, tokens, 2,
                   on_fold=unregister_after)
    failures += c8_check_run(torch, drill, init, "mesh_drill", drill=True)
    drill_c = drill["counters"]
    served = {d or ".tcp": drill["spans"][f"netps.server.commit{d}"]["count"]
              for d in C8_DIALECTS}
    # Each of the worker's two clients (the commit lane and the prefetch
    # client) was on the mesh and demotes once, onto the ring: the server
    # folded the first commits from the dispatch, the rest from the ring.
    if (drill_c["netps.mesh.demotions"] != 2 or drill_c["netps.shm_fallbacks"]
            or served[".tcp"] or served[".mesh"] < C8_DEMOTE_AT
            or not served[".shm"]
            or served[".mesh"] + served[".shm"] != C8_ROUNDS
            or drill_c["netps.mesh.folds"] != served[".mesh"]):
        failures.append(f"(e) the demotion drill's counters: {drill_c}, "
                        f"commits served by dialect {served}")

    pr4_a, pr4_b = (r["center"] for r in timed["pr4"])
    pr4_spread = max(float(np.abs(a - b).max()) for a, b in zip(pr4_a,
                                                                pr4_b))
    mesh1 = c8_run(torch, F, FA, "mesh", model, plan, loop, df, tokens, 1)
    failures += c8_check_run(torch, mesh1, init, "mesh_inflight1")
    mesh1_off = max(float(np.abs(a - b).max())
                    for a, b in zip(mesh1["center"], pr4_a))
    if mesh1_off > pr4_spread:
        failures.append(f"(f) the mesh run at inflight 1 is {mesh1_off} "
                        f"from pr4's center; two pr4 runs are {pr4_spread} "
                        f"apart")

    def arm_row(runs):
        last = runs[-1]
        return {"tokens_per_s": [r["tokens_per_s"] for r in runs],
                "seconds": [r["seconds"] for r in runs],
                "fold_launches": [r["fold"].get("fold_commit", 0)
                                  for r in runs],
                "flash_launches": last["flash"],
                "counters": last["counters"], "spans": last["spans"],
                "history": [float(v) for v in last["losses"].reshape(-1)],
                "center_max_abs_change": last["center_max_abs_change"]}

    emit({"phase": "netps_config8", "gpu": gpu,
          "config": "netps_loopback_aeasgd (bench.py:1465-1468, run "
                    ":484-760)", "model": "TransformerLM(attn_impl='flash', "
                                          "remat=True)", **C8,
          "seq_len": C8_SEQ, "params": n_params,
          "center_mb": 4 * n_params / 1e6, "batch": C8_BATCH,
          "window": C8_WINDOW, "rounds": C8_ROUNDS, "workers": 1,
          "discipline": "aeasgd", "alpha": C8_ALPHA, "optimizer": "adam",
          "learning_rate": C8_LR, "compute_dtype": "bfloat16",
          "tokens_per_run": tokens, "timed_runs": C8_TIMED,
          "warm_rounds": C8_WARM_ROUNDS,
          "tokens_per_s": tps,
          "shm_vs_pr4": tps["shm"] / tps["pr4"],
          "mesh_vs_shm": tps["mesh"] / tps["shm"],
          "mesh_vs_inprocess": tps["mesh"] / tps["inprocess"],
          "arms": {arm: arm_row(runs) for arm, runs in timed.items()},
          "warm_tokens_per_s": {arm: runs[0]["tokens_per_s"]
                                for arm, runs in arms.items()},
          "mesh_fold_check": fold_check,
          "demotion_drill": {"demote_after_commits": C8_DEMOTE_AT,
                             "counters": drill_c,
                             "commits_served_by_dialect": served,
                             "commits": len(drill["log"]),
                             "fold_launches": drill["fold"],
                             "tokens_per_s": drill["tokens_per_s"]},
          "transport_parity": {"pr4_runs_apart": pr4_spread,
                               "mesh_inflight1_from_pr4": mesh1_off,
                               "bit_equal": mesh1_off == 0.0},
          "not_ported": C8_NOT_PORTED,
          "reduced": "none of width or depth; the arms that need an "
                     "unported item are left out (not_ported)",
          "seconds": time.perf_counter() - t_phase})
    if failures:
        fail("netps_config8: " + "; ".join(failures))
    first = timed["mesh"][0]
    return {"mesh_fold_launches": sum(r["fold"].get("fold_commit", 0)
                                      for r in timed["mesh"]),
            "mesh_commits": sum(len(r["log"]) for r in timed["mesh"]),
            "flash": first["flash"]}


def flash_bound_ms(B: int, L: int, H: int, D: int, itemsize: int,
                   kernel: str) -> tuple[float, str]:
    """Least time for one flash kernel on this card: its [B, L, H, D]
    inputs read once and outputs written once (forward: q, k, v in, out
    and the f32 lse out; dq: q, k, v, dO, lse, delta in, dq out; dkv: the
    same in, dk and dv out; bwd, the whole backward: the same in, dq, dk
    and dv out), over 3.35 TB/s, against the causal products this input
    needs (L(L+1)/2 query-key pairs a head; forward QK^T and PV, dq adds
    dO V^T and dS K, dkv QK^T, dO V^T, P^T dO and dS^T Q; bwd computes S
    and dP once for all three gradients: QK^T, dO V^T, P^T dO, dS^T Q and
    dS K) at the tensor cores' bf16 rate."""
    big, rows = B * L * H * D * itemsize, B * H * L * 4
    nbytes = {"fwd": 4 * big + rows, "dq": 5 * big + 2 * rows,
              "dkv": 6 * big + 2 * rows, "bwd": 7 * big + 2 * rows}[kernel]
    products = {"fwd": 2, "dq": 3, "dkv": 4, "bwd": 5}[kernel]
    flops = products * 2 * B * H * (L * (L + 1) // 2) * D
    return bound(nbytes, flops, PEAK_BF16_FLOPS)


def flash_kernel_phase(torch, FA, seed: int) -> list:
    """The three flash kernels against their plain twins, on the same
    CUDA tensors, at config #7's shape and the ragged ones, f32 and bf16;
    dq and dkv are held alone (their twins take the kernel's lse and
    delta). The library yardstick is ``F.scaled_dot_product_attention``
    (causal, scale 1, bf16 [B, H, L, D]): its forward for the forward row,
    its backward (dq, dk and dv together) for the dq and dkv rows; the
    port never calls it."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for B, L, H, D in FLASH_SHAPES:
        big = L == LM_SEQ and B * H > 1
        base = [torch.randn((B, L, H, D), device="cuda", generator=gen)
                for _ in range(4)]
        base[0] = base[0] / D ** 0.5
        lib = [t.to(torch.bfloat16).transpose(1, 2).contiguous()
               .requires_grad_() for t in base[:3]]
        lib_do = base[3].to(torch.bfloat16).transpose(1, 2).contiguous()
        with torch.no_grad():
            lib_fwd_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                *lib, is_causal=True, scale=1.0), 10)
        lib_out = F.scaled_dot_product_attention(*lib, is_causal=True,
                                                 scale=1.0)
        lib_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            lib_out, lib, lib_do, retain_graph=True), 10)
        del lib, lib_do, lib_out
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            q, k, v, do = (t.to(dtype) for t in base)
            out, lse = FA.flash_fwd_cuda(q, k, v)
            out2, lse2 = FA.flash_fwd_cuda(q, k, v)
            delta = FA.attention_delta(do, out)
            dq = FA.flash_dq_cuda(q, k, v, do, lse, delta)
            dk, dv = FA.flash_dkv_cuda(q, k, v, do, lse, delta)
            dq2 = FA.flash_dq_cuda(q, k, v, do, lse, delta)
            dk2, dv2 = FA.flash_dkv_cuda(q, k, v, do, lse, delta)
            torch.cuda.synchronize()
            ref_out, ref_lse = FA.flash_fwd_plain(q, k, v)
            lse_err = (lse - ref_lse).abs().max().item()
            del ref_lse
            refs = {"fwd": [(out, ref_out)],
                    "dq": [(dq, FA.flash_dq_plain(q, k, v, do, lse, delta))],
                    "dkv": list(zip((dk, dv), FA.flash_dkv_plain(
                        q, k, v, do, lse, delta)))}
            repeatable = {
                "fwd": torch.equal(out, out2) and torch.equal(lse, lse2),
                "dq": torch.equal(dq, dq2),
                "dkv": torch.equal(dk, dk2) and torch.equal(dv, dv2)}
            del out2, lse2, dq2, dk2, dv2
            calls = {
                "fwd": (lambda: FA.flash_fwd_cuda(q, k, v),
                        lambda: FA.flash_fwd_plain(q, k, v), lib_fwd_ms),
                "dq": (lambda: FA.flash_dq_cuda(q, k, v, do, lse, delta),
                       lambda: FA.flash_dq_plain(q, k, v, do, lse, delta),
                       lib_bwd_ms),
                "dkv": (lambda: FA.flash_dkv_cuda(q, k, v, do, lse, delta),
                        lambda: FA.flash_dkv_plain(q, k, v, do, lse, delta),
                        lib_bwd_ms)}
            lim = FLASH_LIMITS[name]
            for kernel, pairs in refs.items():
                errs = []
                for got, ref in pairs:
                    d = (got.float() - ref.float()).abs()
                    r = ref.float().abs()
                    errs.append((d.max().item(), d.max().item()
                                 / max(r.max().item(), 1e-30),
                                 d.mean().item() / max(r.mean().item(),
                                                       1e-30)))
                kern, plain, library_ms = calls[kernel]
                bound, bound_by = flash_bound_ms(B, L, H, D,
                                                 q.element_size(), kernel)
                row = {"phase": "flash_kernel", "name": f"flash_{kernel}",
                       "B": B, "L": L, "H": H, "D": D, "dtype": name,
                       "max_abs_err": max(e[0] for e in errs),
                       "max_err_share": max(e[1] for e in errs),
                       "mean_err_share": max(e[2] for e in errs),
                       "limit_max_share": lim["top"],
                       "limit_mean_share": lim["mean"],
                       "ms": cuda_ms(torch, kern, 10 if big else 20),
                       "plain_ms": cuda_ms(torch, plain, 2 if big else 5),
                       "library_ms": library_ms,
                       "library": "F.scaled_dot_product_attention bf16 "
                                  "[B,H,L,D] causal, "
                                  + ("forward" if kernel == "fwd" else
                                     "backward (dq, dk, dv together)"),
                       "bound_ms": bound, "bound_by": bound_by}
                row["repeatable_bits"] = repeatable[kernel]
                if kernel == "fwd":
                    row.update(lse_max_abs_err=lse_err,
                               lse_atol=FLASH_LSE_ATOL,
                               ratio_to_library=row["ms"] / library_ms,
                               bound_share=bound / row["ms"])
                    if dtype == torch.float32:
                        row["rounding_ms"] = cuda_ms(
                            torch, lambda: FA.bf16_operands(q, k, v),
                            10 if big else 20)
                emit(row)
                if not (row["max_err_share"] <= lim["top"]
                        and row["mean_err_share"] <= lim["mean"]):
                    fail(f"flash_{kernel} disagrees with its plain twin at "
                         f"{(B, L, H, D)} {name}: {row}")
                if kernel == "fwd" and not lse_err <= FLASH_LSE_ATOL:
                    fail(f"flash_fwd's lse is {lse_err} from its twin's at "
                         f"{(B, L, H, D)} {name}")
                if not repeatable[kernel]:
                    fail(f"flash_{kernel} gave other bits on a second call "
                         f"at {(B, L, H, D)} {name}")
                rows.append(row)
            rows.append(flash_bwd_row(torch, FA, (q, k, v, do, lse, delta),
                                      (dq, dk, dv), rows[-2:], big))
            del refs, calls, q, k, v, do, out, lse, delta, dq, dk, dv
            torch.cuda.empty_cache()
        del base
    for shape in FLASH_FLIP_SHAPES:
        rows += flash_flip_rows(torch, FA, shape, seed)
    return rows


def flash_flip_rows(torch, FA, shape, seed: int) -> list:
    """The f32 forward, dQ and dK/dV kernels against their twins at
    ``shape``, every output row with an element past f32 level attributed
    to one-step bf16 rounding flips of its own p or ds
    (``flash_flips.forward_flips``, ``backward_flips``): a
    ``flash_fwd_flips`` and a ``flash_bwd_flips`` row. Fails if a row stays
    unexplained, if the mean error without the flips passes FLASH_LIMITS'
    f32 mean, or if the largest error passes its top; the mean error with
    the flips is shown beside. The inputs are made on the host from
    ``seed`` as ``tests/test_torch_cuda.py`` makes them, so at seed 0 a
    shape of both sees the same numbers."""
    from distkeras_tpu_torch.ops.kernels.flash_flips import (
        backward_flips, forward_flips)

    B, L, H, D = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g) for _ in range(4))
    q, k, v, do = (t.cuda() for t in (q / D ** 0.5, k, v, do))
    out, lse = FA.flash_fwd_cuda(q, k, v)
    delta = FA.attention_delta(do, out)
    got = {"out": out, "dq": FA.flash_dq_cuda(q, k, v, do, lse, delta)}
    got["dk"], got["dv"] = FA.flash_dkv_cuda(q, k, v, do, lse, delta)
    ref = {"out": FA.flash_fwd_plain(q, k, v)[0],
           "dq": FA.flash_dq_plain(q, k, v, do, lse, delta)}
    ref["dk"], ref["dv"] = FA.flash_dkv_plain(q, k, v, do, lse, delta)
    found = {"out": forward_flips(q, k, v, out),
             **backward_flips(q, k, v, do, lse, delta, got["dq"], got["dk"],
                              got["dv"])}
    lim = FLASH_LIMITS["float32"]
    for name, f in found.items():
        d = (got[name] - ref[name]).abs()
        f["max_err_share"] = (d.max() / ref[name].abs().max()).item()
    rows = []
    for kernel, names in (("fwd", ("out",)), ("bwd", ("dq", "dk", "dv"))):
        row = {"phase": "flash_kernel", "name": f"flash_{kernel}_flips",
               "B": B, "L": L, "H": H, "D": D, "dtype": "float32",
               **{n: found[n] for n in names},
               "limit_max_share": lim["top"], "limit_mean_share": lim["mean"]}
        emit(row)
        rows.append(row)
    for name, f in found.items():
        if (f["unexplained_rows"] or f["max_err_share"] > lim["top"]
                or f["mean_err_share_without_flips"] > lim["mean"]):
            fail(f"flash {name}'s errors at {shape} f32 are not bf16 "
                 f"rounding flips of p or ds alone: {f}")
    return rows


def flash_bwd_row(torch, FA, args, outs, kernel_rows, big) -> dict:
    """The whole backward as ``FlashAttentionFn`` runs it on the card
    (``flash_bwd_cuda``: f32 inputs rounded to bf16 once, then dQ and
    dK/dV) beside SDPA's backward (dq, dk and dv together) from the same
    call: its time, the ratio to SDPA's, the function's own bound (S and
    dP counted once, as SDPA's backward computes them) and its share of
    it; beside them, the sum of the two kernels' bounds, which counts S
    and dP twice because dQ and dK/dV each recompute them. Its outputs
    must be the bits of the two wrappers' (``outs``), so the dq and dkv
    rows' errors are its own."""
    dq_row, dkv_row = kernel_rows
    got = FA.flash_bwd_cuda(*args)
    torch.cuda.synchronize()
    ms = cuda_ms(torch, lambda: FA.flash_bwd_cuda(*args), 10 if big else 20)
    q = args[0]
    bound, bound_by = flash_bound_ms(*q.shape, q.element_size(), "bwd")
    row = {"phase": "flash_kernel", "name": "flash_bwd",
           **{k: dq_row[k] for k in ("B", "L", "H", "D", "dtype")},
           **{k: max(dq_row[k], dkv_row[k])
              for k in ("max_abs_err", "max_err_share", "mean_err_share")},
           "same_bits_as_dq_and_dkv": all(
               torch.equal(a, b) for a, b in zip(got, outs)),
           "ms": ms, "dq_ms": dq_row["ms"], "dkv_ms": dkv_row["ms"],
           "plain_ms": dq_row["plain_ms"] + dkv_row["plain_ms"],
           "library_ms": dq_row["library_ms"],
           "library": dq_row["library"],
           "ratio_to_library": ms / dq_row["library_ms"],
           "bound_ms": bound, "bound_by": bound_by,
           "bound_share": bound / ms,
           "kernels_bound_sum_ms": dq_row["bound_ms"] + dkv_row["bound_ms"]}
    emit(row)
    if not row["same_bits_as_dq_and_dkv"]:
        fail(f"flash_bwd_cuda's gradients are not flash_dq_cuda's and "
             f"flash_dkv_cuda's at {row}")
    return row


def ptxas_kernels(log: str, name) -> list:
    """Registers, stack and spills of the kernels of a build's ``-Xptxas
    -v`` report that ``name`` (an entry line -> a dict or None) picks, one
    entry per instantiation."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            cur = name(ln)
            if cur:
                out.append(cur)
        elif cur is not None and "spill" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            cur.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif cur is not None and "Used" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
    return out


def flash_registers(log: str) -> list:
    """The 18 flash kernel instantiations' registers and spills."""
    def name(ln):
        m = re.search(
            r"(flash_(?:fwd|dq|dkv)_kernel)I(13__nv_bfloat16|f)Li(\d+)E", ln)
        return None if m is None else {
            "kernel": m.group(1),
            "out": "bf16" if m.group(2) != "f" else "f32",
            "DP": int(m.group(3))}
    return ptxas_kernels(log, name)


#: the bf16 LSTM tensor-core kernels of csrc/lstm_fwd.cu (stash and plain)
#: and csrc/lstm_bwd.cu.
LSTM_TC_KERNELS = ("lstm_fwd_tc", "lstm_fwd_tc", "lstm_xproj_tc",
                   "lstm_fwd_xw_tc", "lstm_fwd_xw_tc", "lstm_bwd_rec_tc",
                   "lstm_bwd_wgrad_tc", "lstm_dx_tc", "lstm_wgrad_reduce_tc")
#: the f32 LSTM kernels: x . Wx, the cluster recurrence at each of the 8
#: tilings of ``K.F32_TILINGS`` (stash and plain), the cluster recurrent
#: backward at each, and the weight-gradient, dx and reduce kernels.
LSTM_F32_KERNELS = (("lstm_xproj_f32",)
                    + ("lstm_fwd_cluster",) * 2 * 8
                    + ("lstm_bwd_rec_cluster",) * 8
                    + ("lstm_wgrad_f32", "lstm_dx_f32",
                       "lstm_wgrad_reduce_f32"))


def lstm_registers(log: str) -> list:
    """The bf16 and f32 LSTM kernels' registers and spills."""
    def name(ln):
        m = re.search(r"\d(lstm_\w+_tc)(?:ILb([01])E)?E", ln)
        if m is not None:
            return {"kernel": m.group(1), "dtype": "bf16",
                    **({"stash": m.group(2) == "1"} if m.group(2) else {})}
        m = re.search(r"\d(lstm_\w+_cluster)ILi(\d+)ELi(\d+)E(?:Lb([01])E)?",
                      ln)
        if m is not None:
            return {"kernel": m.group(1), "dtype": "f32",
                    "R": int(m.group(2)), "C": int(m.group(3)),
                    **({"stash": m.group(4) == "1"} if m.group(4) else {})}
        m = re.search(r"\d(lstm_\w+_f32)E", ln)
        return None if m is None else {"kernel": m.group(1), "dtype": "f32"}
    return ptxas_kernels(log, name)


#: the GroupNorm kernels of csrc/groupnorm.cu: the forward and the
#: backward's first kernel at each vector width (f32 1, 2, 4; bf16 1, 2, 4,
#: 8) and the backward's parameter-gradient sum in each dtype.
GN_KERNELS = 2 * 7 + 2


def gn_registers(log: str) -> list:
    """The GroupNorm kernels' registers and spills."""
    def name(ln):
        m = re.search(r"\d(gn_fwd|gn_bwd|gn_param_grads)I(13__nv_bfloat16|f)"
                      r"(?:Li(\d+)E)?", ln)
        return None if m is None else {
            "kernel": m.group(1),
            "dtype": "bf16" if m.group(2) != "f" else "f32",
            **({"V": int(m.group(3))} if m.group(3) else {})}
    return ptxas_kernels(log, name)


def lm_frame(rows: int, vocab: int, seq: int, seed: int):
    """Tokens and next-token labels as ``bench.py`` makes config #7's."""
    from distkeras_tpu_torch.data import DataFrame

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(rows, seq))
    return DataFrame({"features": toks.astype(np.int32),
                      "label": np.roll(toks, -1, 1).astype(np.int32)})


@contextlib.contextmanager
def last_center():
    """Keep, in the yielded dict, the center of the last state the async
    engine's round returned in the block."""
    from distkeras_tpu_torch.parallel.engine import AsyncEngine

    seen = {}
    real = AsyncEngine._round_fn

    def recording(self, state, xs, ys):
        new, loss = real(self, state, xs, ys)
        seen["center"] = new.center
        return new, loss

    AsyncEngine._round_fn = recording
    try:
        yield seen
    finally:
        AsyncEngine._round_fn = real


def transformer_train_phase(torch, FA, gpu: str, seed: int,
                            dtype: str = "float32",
                            rounds: int = LM_ROUNDS) -> dict:
    """Train config #7 as a user would, at ``compute_dtype=dtype``;
    returns the launch counts."""
    from distkeras_tpu_torch import AEASGD, small_transformer_lm
    from distkeras_tpu_torch.ops.optimizers import adam

    W, Kw, B = (LM_TRAIN["num_workers"], LM_TRAIN["communication_window"],
                LM_TRAIN["batch_size"])
    steps = rounds * W * Kw
    t0 = time.perf_counter()
    model = small_transformer_lm(**LM, seq_len=LM_SEQ, attn_impl="flash",
                                 remat=True, seed=seed, device="cuda")
    df = lm_frame(steps * B, LM["vocab_size"], LM_SEQ, seed)
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.params.values())
    round_ends = []

    def on_round(r, loss):
        torch.cuda.synchronize()
        round_ends.append(time.perf_counter())

    trainer = AEASGD(model, "adam", "sparse_categorical_crossentropy",
                     on_round=on_round, **LM_TRAIN, compute_dtype=dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with last_center() as seen:
        FA.reset_launches()  # counts start at 0 just before the main path
        t0 = time.perf_counter()
        trained = trainer.train(df)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = FA.launch_counts()
        entries = FA.launch_counts(by_entry=True)
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.get_worker_histories()
    moved = max((trained.params[k] - v).abs().max().item()
                for k, v in model.params.items())
    holds_center = all(torch.equal(trained.params[k], v)
                       for k, v in seen["center"].items())
    del seen
    rounds_s = [b - a for a, b in zip([t0] + round_ends, round_ends)]
    x = torch.as_tensor(df["features"][:B], device="cuda")
    y = torch.as_tensor(df["label"][:B], device="cuda")
    del model
    torch.cuda.empty_cache()
    split = step_split(torch, trained, x, y, adam(LM_TRAIN["learning_rate"]),
                       timed=(FA, {"flash_fwd_cuda": "flash_fwd",
                                   "flash_bwd_cuda": "flash_bwd"}),
                       dtype=getattr(torch, dtype))
    per_step = {"flash_fwd": 2 * LM["num_layers"],
                "flash_dq": LM["num_layers"], "flash_dkv": LM["num_layers"]}
    split_calls = {"flash_fwd": 2 * LM["num_layers"],
                   "flash_bwd": LM["num_layers"]}
    want = {k: v * steps for k, v in per_step.items()}
    tokens = steps * B * LM_SEQ
    emit({"phase": "transformer_train", "gpu": gpu, "trainer": "AEASGD",
          "model": "TransformerLM(attn_impl='flash', remat=True)", **LM,
          "seq_len": LM_SEQ, "params": n_params, "optimizer": "adam",
          **LM_TRAIN, "rounds": rounds, "dtype": dtype,
          "compute_dtype": dtype, "launches_by_entry": entries,
          "reduced": f"{rounds} round(s) of window 8 ({steps} local steps)"
                     + ("; float32 where bench.py runs bfloat16"
                        if dtype == "float32" else ""),
          "setup_s": setup_s, "seconds": wall,
          "tokens_per_s": tokens / wall,
          "ms_per_local_step": wall / steps * 1e3,
          "round_s": rounds_s,
          "tokens_per_s_last_round": Kw * B * LM_SEQ / rounds_s[-1],
          "history": [float(v) for v in trainer.get_history()],
          "worker_histories": hist.tolist(), "launches": launches,
          "launches_wanted": want, "local_steps": steps,
          "center_max_abs_change": moved,
          "model_holds_final_center": holds_center,
          "peak_memory_gb": peak / 1e9,
          "step_split_ms": split,
          "step_split": "one local step at B=8, L=2048 by CUDA events, "
                        "outside the trainer (mean of 3 after a warm "
                        "step); flash_fwd: events around each forward "
                        "kernel call, the recompute's inside the backward "
                        "included (the f32 inputs' one bf16 rounding, "
                        "which the backward shares, is outside it); "
                        "flash_bwd: around each backward call (dQ and "
                        "dK/dV, and dO's bf16 rounding)"})
    if not np.all(np.isfinite(hist)):
        fail(f"non-finite transformer training loss: {hist}")
    if not moved > 0:
        fail("the trained transformer's center equals its initialization")
    if not holds_center:
        fail("the model AEASGD returned does not hold the engine's final "
             "center")
    if launches != want:
        fail(f"flash launches {launches} in {steps} local steps; want "
             f"{want} (remat: the forward twice a layer a step)")
    if split["calls"] != split_calls:
        fail(f"the step split timed {split['calls']} flash calls a step; "
             f"want {split_calls}")
    only_dtype("transformer", entries, dtype)
    return launches


def bf16_forward(torch, model, x):
    """The model's forward as the bf16 training step runs it: parameters
    cast to bf16, logits back in f32."""
    from torch.func import functional_call

    from distkeras_tpu_torch.ops import cast_floats

    x = torch.as_tensor(x, device=model.device)
    return functional_call(model.module, cast_floats(
        model.params, torch.bfloat16), (x,)).float()


def transformer_parity_phase(torch, seed: int) -> None:
    """A small transformer from one seed: logits, then one AEASGD round,
    on the card (the kernels) and on the CPU (the twins), and on the CPU
    with dense f32 attention, the yardstick for the rounding the design
    puts in."""
    from distkeras_tpu_torch import AEASGD, small_transformer_lm

    W, Kw, B = (LM_PARITY_TRAIN["num_workers"],
                LM_PARITY_TRAIN["communication_window"],
                LM_PARITY_TRAIN["batch_size"])
    df = lm_frame(W * Kw * B, LM_PARITY["vocab_size"], LM_PARITY_SEQ,
                  seed + 3)
    probe = df["features"][:B]
    out = {}
    for run, dev, impl, dtype in (
            ("card", "cuda", "flash", None), ("cpu", "cpu", "flash", None),
            ("cpu_dense", "cpu", "dense", None),
            ("card_bf16", "cuda", "flash", "bfloat16"),
            ("cpu_bf16", "cpu", "flash", "bfloat16")):
        model = small_transformer_lm(**LM_PARITY, seq_len=LM_PARITY_SEQ,
                                     attn_impl=impl, seed=seed + 3,
                                     device=dev)
        if dtype is None:
            logits = model.predict(probe).cpu()
        else:   # the forward of the bf16 step: the parameters cast
            with torch.inference_mode():
                logits = bf16_forward(torch, model, probe).cpu()
        init = {k: v.detach().cpu().clone() for k, v in model.params.items()}
        t = AEASGD(model, "adam", "sparse_categorical_crossentropy",
                   **LM_PARITY_TRAIN, compute_dtype=dtype)
        trained = t.train(df)
        out[run] = (logits, {k: v.cpu() for k, v in trained.params.items()},
                    t.get_history())

    def dist(a, b, i, how):
        x, y = out[a][i], out[b][i]
        if i == 0:
            d = (x - y).abs()
            return (d.max() if how == "max" else d.mean()).item()
        d = [(x[k] - y[k]).abs() for k in y]
        if how == "max":
            return max(v.max().item() for v in d)
        return (sum(v.sum() for v in d) / sum(v.numel() for v in d)).item()

    logits_card = dist("card", "cpu", 0, "max")
    logits_design = dist("cpu", "cpu_dense", 0, "max")
    center_card = dist("card", "cpu", 1, "mean")
    center_design = dist("cpu", "cpu_dense", 1, "mean")
    change = max((v - init[k]).abs().max().item()
                 for k, v in out["cpu"][1].items())
    emit({"phase": "transformer_parity", "trainer": "AEASGD",
          "model": "TransformerLM(attn_impl='flash')", **LM_PARITY,
          "seq_len": LM_PARITY_SEQ, **LM_PARITY_TRAIN, "rounds": 1,
          "logits_max_abs_err_card_vs_cpu": logits_card,
          "logits_max_abs_err_cpu_flash_vs_dense": logits_design,
          "center_mean_abs_err_card_vs_cpu": center_card,
          "center_mean_abs_err_cpu_flash_vs_dense": center_design,
          "center_max_abs_err_card_vs_cpu": dist("card", "cpu", 1, "max"),
          "center_max_abs_err_cpu_flash_vs_dense":
              dist("cpu", "cpu_dense", 1, "max"),
          "center_max_abs_change": change,
          "logits_share": LM_PARITY_LOGITS_SHARE,
          "center_share": LM_PARITY_CENTER_SHARE,
          "history": {k: [float(h) for h in v[2]] for k, v in out.items()},
          "compared": "logits by their largest error; the center by its "
                      "mean error (adam turns gradients that are rounding "
                      "noise into steps of about lr of either sign, so a "
                      "few elements differ by that in every pair of runs)"})
    if not change > 0:
        fail("the transformer parity run's center did not move")
    if not (0 < logits_design and logits_card
            <= LM_PARITY_LOGITS_SHARE * logits_design):
        fail(f"transformer logits, card vs CPU {logits_card} > "
             f"{LM_PARITY_LOGITS_SHARE} x the CPU flash-vs-dense "
             f"{logits_design}")
    if not (0 < center_design and center_card
            <= LM_PARITY_CENTER_SHARE * center_design):
        fail(f"transformer center, card vs CPU {center_card} > "
             f"{LM_PARITY_CENTER_SHARE} x the CPU flash-vs-dense "
             f"{center_design}")
    bf16 = {"cuda_bf16": (out["card_bf16"][1],), "cpu_bf16": (
        out["cpu_bf16"][1],), "cpu": (out["cpu"][1],)}
    bf16_parity("transformer_parity", bf16, change, extra={
        "logits_max": (dist("card_bf16", "cpu_bf16", 0, "max"),
                       dist("cpu_bf16", "cpu", 0, "max"))})


def kernel_modules() -> dict:
    """The port's kernel wrapper modules, each with its launch counts."""
    from distkeras_tpu_torch.ops.kernels import flash_attention, fold
    from distkeras_tpu_torch.ops.kernels import groupnorm, lstm

    return {"lstm": lstm, "groupnorm": groupnorm,
            "flash_attention": flash_attention, "fold": fold}


def reset_all_launches() -> None:
    for mod in kernel_modules().values():
        mod.reset_launches()


def launched_kernels() -> dict:
    """``{"module.kernel": count}`` of every kernel launched since the
    counts were last set to 0."""
    return {f"{name}.{k}": v for name, mod in kernel_modules().items()
            for k, v in mod.launch_counts().items() if v}


def check_no_kernel(phase: str) -> None:
    """Fail if any of the port's kernels launched: configs #1-#3 in
    process run no TPU kernel's counterpart (the JAX package computes their
    convolutions, pools and dense layers outside Pallas), so their path is
    cuDNN and cuBLAS through torch."""
    launched = launched_kernels()
    if launched:
        fail(f"{phase}: the path is cuDNN and cuBLAS, yet the port's "
             f"kernels launched: {launched}")


def config_train(torch, gpu: str, phase: str, trainer, model, df,
                 steps: int, batch: int, tx, dtype: str,
                 extra: dict) -> dict:
    """Run ``trainer.train(df)`` as a user would, with every kernel count
    set to 0 just before, and emit the phase's row: samples/s (host clock
    around ``train``), the host milliseconds a local step, the split of one
    step by CUDA events outside the trainer, peak memory, the history.
    Fails unless the losses are finite, the parameters moved and no kernel
    of the port launched. Returns the row."""
    from distkeras_tpu_torch import telemetry

    telemetry.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()  # counts start at 0 just before the path runs
    t0 = time.perf_counter()
    trained = trainer.train(df)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = launched_kernels()
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.get_history()
    moved = max((trained.params[k] - v).abs().max().item()
                for k, v in model.params.items())
    features = df[trainer.features_col]
    xb = torch.as_tensor(features[:batch], device="cuda")
    yb = torch.as_tensor(df[trainer.label_col][:batch], device="cuda")
    split = step_split(torch, trained, xb, yb, tx, dtype=getattr(torch, dtype))
    card = step_split(torch, trained, xb, yb, tx, dtype=getattr(torch, dtype),
                      head_start=True)
    snap = telemetry.get().snapshot()
    step_ms = wall / steps * 1e3
    row = {"phase": phase, "gpu": gpu, "trainer": type(trainer).__name__,
           **extra, "dtype": dtype, "compute_dtype": dtype,
           "seconds": wall, "samples_per_s": steps * batch / wall,
           "ms_per_local_step": step_ms, "local_steps": steps,
           "peak_memory_gb": peak / 1e9,
           "history": [float(v) for v in hist],
           "worker_histories": (None if trainer.get_worker_histories()
                                is None else
                                trainer.get_worker_histories().tolist()),
           "center_max_abs_change": moved, "kernel_launches": launched,
           "input_stall_s": snap["counters"].get("input_stall_seconds"),
           "step_split_ms": split, "card_step_split_ms": card,
           # the card's share of a local step: its own time a step over
           # the host wall a step in the run; far below 1 means the host
           # (or the data plane) paces the run
           "card_share_of_step": card["step"] / step_ms,
           "step_split": f"one local step at B={batch} by CUDA events, "
                         f"outside the trainer (mean of 3 after a warm "
                         f"step): step_split_ms as the host paces it, "
                         f"card_step_split_ms the card's own time (a spin "
                         f"kernel first gives the host a head start; "
                         f"host_ms: the host's time for one step); no "
                         f"kernel of the port on this path"}
    emit(row)
    if not np.all(np.isfinite(hist)):
        fail(f"{phase}: non-finite training loss: {hist}")
    if not moved > 0:
        fail(f"{phase}: the trained center equals its initialization")
    check_no_kernel(f"{phase} ({row['trainer']}, {dtype})")
    return row


def mlp_train_phase(torch, gpu: str, seed: int, dtype: str, df) -> dict:
    """BASELINE config #1 as a user drives it: ``SingleTrainer(mnist_mlp(
    device="cuda"), "adam", batch_size=1024, rounds_per_program="auto")``
    on ``mnist(flat=True)``."""
    from distkeras_tpu_torch import SingleTrainer, mnist_mlp
    from distkeras_tpu_torch.ops.optimizers import get_optimizer

    model = mnist_mlp(seed=seed, device="cuda")
    trainer = SingleTrainer(model, "adam", "sparse_categorical_crossentropy",
                            compute_dtype=dtype, **MLP_TRAIN)
    steps = MLP_ROUNDS * MLP_TRAIN["steps_per_program"]
    return config_train(
        torch, gpu, "mlp_train", trainer, model, df, steps,
        MLP_TRAIN["batch_size"],
        get_optimizer("adam", MLP_TRAIN["learning_rate"]), dtype,
        {"model": "mnist_mlp()", "config": 1, "rounds": MLP_ROUNDS,
         **MLP_TRAIN})


def cnn_frames(seed: int) -> dict:
    """One frame per CNN config, enough rows for its ``CNN_ROUNDS``
    rounds (131,072 MNIST and 65,536 CIFAR-10 images), made once and
    reused by both dtypes and the remote run."""
    from distkeras_tpu_torch.datasets import cifar10, mnist

    frames = {}
    for name, _trainer, kw in CNN_TRAIN:
        n = (CNN_ROUNDS * kw["num_workers"] * kw["communication_window"]
             * kw["batch_size"])
        frames[name] = (mnist(n=n, seed=seed) if name == "mnist_cnn"
                        else cifar10(n=n, seed=seed))
    return frames


def cnn_train_phase(torch, gpu: str, seed: int, dtype: str,
                    frames: dict) -> list:
    """BASELINE configs #2 and #3 as a user drives them:
    ``ADAG(mnist_cnn(), "adam", num_workers=4, batch_size=2048,
    communication_window=8)`` and ``AEASGD(cifar10_cnn(), "sgd",
    num_workers=2, ..., rho=3.0)``, 2 rounds each."""
    from distkeras_tpu_torch import models, trainers
    from distkeras_tpu_torch.ops.optimizers import get_optimizer

    rows = []
    for name, trainer_name, kw in CNN_TRAIN:
        model = getattr(models, name)(seed=seed, device="cuda")
        trainer = getattr(trainers, trainer_name)(
            model, loss="sparse_categorical_crossentropy",
            compute_dtype=dtype, **kw)
        steps = CNN_ROUNDS * kw["num_workers"] * kw["communication_window"]
        rows.append(config_train(
            torch, gpu, "cnn_train", trainer, model, frames[name], steps,
            kw["batch_size"],
            get_optimizer(kw["worker_optimizer"], kw["learning_rate"]),
            dtype, {"model": f"{name}()",
                    "config": 2 if name == "mnist_cnn" else 3,
                    "rounds": CNN_ROUNDS, **kw}))
        del model, trainer
        torch.cuda.empty_cache()
    return rows


def cnn_parity_phase(torch, seed: int) -> None:
    """Each CNN config's trainer at full width, cut to ``CNN_PARITY``, from
    the same weights and data: on the card, on the CPU, on the CPU in
    float64 (the reference both f32 runs are measured against), and on the
    card and the CPU at bf16."""
    from distkeras_tpu_torch import models, trainers
    from distkeras_tpu_torch.data import DataFrame
    from distkeras_tpu_torch.datasets import cifar10, mnist

    for name, trainer_name, kw in CNN_TRAIN:
        kw = dict(kw, **CNN_PARITY)
        n = kw["num_workers"] * kw["communication_window"] * kw["batch_size"]
        df = (mnist if name == "mnist_cnn" else cifar10)(n=n, seed=seed + 3)
        df64 = DataFrame({"features": df["features"].astype(np.float64),
                          "label": df["label"]})
        out = {}
        for run, dev, frame, dtype in (
                ("cuda", "cuda", df, None), ("cpu", "cpu", df, None),
                ("cpu_f64", "cpu", df64, None),
                ("cuda_bf16", "cuda", df, "bfloat16"),
                ("cpu_bf16", "cpu", df, "bfloat16")):
            model = getattr(models, name)(seed=seed + 3, device=dev)
            if run == "cpu_f64":
                model.module.double()
            init = {k: v.detach().cpu().double()
                    for k, v in model.params.items()}
            t = getattr(trainers, trainer_name)(
                model, loss="sparse_categorical_crossentropy",
                compute_dtype=dtype, **kw)
            trained = t.train(frame)
            out[run] = ({k: v.cpu().double()
                         for k, v in trained.params.items()},
                        t.get_history())

        def dist(a, b, how):
            return center_dist(out[a][0], out[b][0], how)

        change = max((v - init[k]).abs().max().item()
                     for k, v in out["cpu_f64"][0].items())
        card_vs_f64 = dist("cuda", "cpu_f64", "mean")
        cpu_vs_f64 = dist("cpu", "cpu_f64", "mean")
        loss_rel = float(np.abs(out["cuda"][1] - out["cpu"][1]).max()
                         / np.abs(out["cpu"][1]).max())
        limit = RESNET_PARITY_FACTOR * cpu_vs_f64
        emit({"phase": "cnn_parity", "model": f"{name}()",
              "trainer": trainer_name, **kw, "rounds": 1,
              "center_mean_abs_err_card_vs_cpu_f64": card_vs_f64,
              "center_mean_abs_err_cpu_vs_cpu_f64": cpu_vs_f64,
              "limit_card_vs_cpu_f64": limit,
              "center_max_abs_err_card_vs_cpu": dist("cuda", "cpu", "max"),
              "center_max_abs_err_card_vs_cpu_f64": dist("cuda", "cpu_f64",
                                                         "max"),
              "center_max_abs_err_cpu_vs_cpu_f64": dist("cpu", "cpu_f64",
                                                        "max"),
              "center_max_abs_change": change,
              "history_card": [float(v) for v in out["cuda"][1]],
              "history_cpu": [float(v) for v in out["cpu"][1]],
              "history_rel_err": loss_rel, "loss_rtol": RESNET_LOSS_RTOL})
        if not change > 0:
            fail(f"the {name} parity run's center did not move")
        if not (0 < cpu_vs_f64 and card_vs_f64 <= limit
                and loss_rel <= RESNET_LOSS_RTOL):
            fail(f"{name} card training strays from the f64 reference: "
                 f"{card_vs_f64} > {RESNET_PARITY_FACTOR} x the CPU f32 "
                 f"run's {cpu_vs_f64}, or loss {loss_rel} > "
                 f"{RESNET_LOSS_RTOL}")
        bf16_parity("cnn_parity", out, change, share=CNN_BF16_PARITY_SHARE)


def workflow_phase(torch, gpu: str, seed: int) -> None:
    """``examples/mnist_workflow.py``'s chain in the port, on the card:
    ``mnist()`` -> ``MinMaxTransformer`` -> ``ReshapeTransformer`` ->
    ``OneHotTransformer`` -> ``split(0.9, seed=1)`` -> ``ADAG(mnist_cnn(),
    "adam", features_col="img")`` -> ``ClassPredictor``,
    ``ProbabilityPredictor``, ``ModelPredictor`` -> ``AccuracyEvaluator``,
    ``F1Evaluator``, ``LossEvaluator``. The logits are held within
    ``SERVE_ATOL`` of the CPU plain forward on the same weights, and the
    evaluators on the card's predictions equal them on the CPU's, but for
    rows whose top two CPU logits lie within ``SERVE_ATOL``."""
    from distkeras_tpu_torch import (
        ADAG,
        AccuracyEvaluator,
        ClassPredictor,
        F1Evaluator,
        LossEvaluator,
        MinMaxTransformer,
        ModelPredictor,
        OneHotTransformer,
        ProbabilityPredictor,
        ReshapeTransformer,
        mnist_cnn,
    )
    from distkeras_tpu_torch.data import DataFrame
    from distkeras_tpu_torch.datasets import mnist

    t0 = time.perf_counter()
    df = mnist(n=WORKFLOW["rows"], seed=seed)
    df = MinMaxTransformer(0.0, 1.0, input_col="features",
                           output_col="features_norm").transform(df)
    df = ReshapeTransformer("features_norm", "img", (28, 28, 1)).transform(df)
    df = OneHotTransformer(10, input_col="label",
                           output_col="label_one_hot").transform(df)
    train_df, test_df = df.split(0.9, seed=1)
    prep_s = time.perf_counter() - t0
    trainer = ADAG(mnist_cnn(seed=seed, device="cuda"), "adam",
                   "sparse_categorical_crossentropy", features_col="img",
                   label_col="label",
                   **{k: WORKFLOW[k] for k in (
                       "num_workers", "batch_size", "communication_window",
                       "learning_rate")})
    torch.cuda.synchronize()
    reset_all_launches()  # counts start at 0 just before the path runs
    t0 = time.perf_counter()
    trained = trainer.train(train_df, shuffle=True)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    kw = dict(features_col="img", chunk_size=WORKFLOW["chunk_size"])
    classes = ClassPredictor(trained, output_col="prediction", **kw)
    t0 = time.perf_counter()
    pred = classes.predict(test_df)
    predict_cold_s = time.perf_counter() - t0
    pred = ProbabilityPredictor(trained, output_col="probability",
                                **kw).predict(pred)
    pred = ModelPredictor(trained, output_col="logits", **kw).predict(pred)
    rate_df = DataFrame({"img": test_df["img"][
        np.resize(np.arange(len(test_df)), WORKFLOW_RATE_ROWS)]})
    classes.predict(rate_df)  # warm: the chunk shape's first calls
    rate_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        classes.predict(rate_df)
        rate_s.append(time.perf_counter() - t0)
    check_no_kernel("workflow")

    def evaluate(frame, col):
        return {"accuracy": AccuracyEvaluator(col, "label").evaluate(frame),
                "f1": F1Evaluator(col, "label").evaluate(frame)}

    card = evaluate(pred, "prediction")
    card["loss"] = LossEvaluator("sparse_categorical_crossentropy", "logits",
                                 "label").evaluate(pred)
    cpu_model = mnist_cnn(device="cpu")
    cpu_model.module.load_state_dict(
        {k: v.cpu() for k, v in trained.module.state_dict().items()})
    cpu = ModelPredictor(cpu_model, output_col="logits",
                         **kw).predict(test_df)
    logits_err = float(np.abs(pred["logits"] - cpu["logits"]).max())
    top2 = np.sort(cpu["logits"], axis=-1)[:, -2:]
    clear = np.nonzero(top2[:, 1] - top2[:, 0] > SERVE_ATOL)[0]
    on_card = evaluate(pred.take_rows(clear), "prediction")
    on_cpu = evaluate(cpu.take_rows(clear), "logits")
    cpu_loss = LossEvaluator("sparse_categorical_crossentropy", "logits",
                             "label").evaluate(cpu)
    probs = pred["probability"]
    n_test = len(test_df)
    emit({"phase": "workflow", "gpu": gpu, "trainer": "ADAG",
          "model": "mnist_cnn()", **WORKFLOW, "train_rows": len(train_df),
          "test_rows": n_test, "prep_s": prep_s, "train_s": train_s,
          "train_samples_per_s": (trainer.get_history().size
                                  * WORKFLOW["num_workers"]
                                  * WORKFLOW["communication_window"]
                                  * WORKFLOW["batch_size"] / train_s),
          "predict_cold_s": predict_cold_s, "predict_rate_rows":
          WORKFLOW_RATE_ROWS, "predict_rate_s": rate_s,
          "rows_predicted_per_s": WORKFLOW_RATE_ROWS / float(np.median(rate_s)),
          "history": [float(v) for v in trainer.get_history()], **card,
          "cpu_loss": cpu_loss, "logits_max_abs_err_card_vs_cpu": logits_err,
          "atol": SERVE_ATOL, "rows_compared": int(clear.size),
          "evaluators_card_on_clear_rows": on_card,
          "evaluators_cpu_on_clear_rows": on_cpu,
          "probability_row_sum_max_err": float(np.abs(probs.sum(-1) - 1).max()),
          "timing": "host clock; ClassPredictor.predict (staging, forward, "
                    "copy back): predict_cold_s the first call, on the test "
                    "rows; rows_predicted_per_s over predict_rate_rows, the "
                    "median of predict_rate_s, after a warm call"})
    if not np.all(np.isfinite(trainer.get_history())):
        fail(f"workflow: non-finite training loss {trainer.get_history()}")
    if logits_err > SERVE_ATOL:
        fail(f"workflow: the card's logits are {logits_err} from the CPU "
             f"plain forward on the same weights (> {SERVE_ATOL})")
    if on_card != on_cpu:
        fail(f"workflow: the evaluators on the card's predictions {on_card} "
             f"differ from the CPU's {on_cpu} on the {clear.size} rows whose "
             f"top two logits are apart")
    if abs(card["loss"] - cpu_loss) > SERVE_ATOL:
        fail(f"workflow: test loss {card['loss']} on the card, {cpu_loss} "
             f"on the CPU")
    if not card["accuracy"] > WORKFLOW_MIN_ACCURACY:
        fail(f"workflow: test accuracy {card['accuracy']} <= "
             f"{WORKFLOW_MIN_ACCURACY}")
    if not (pred["prediction"].dtype == np.int32
            and probs.shape == (n_test, 10)
            and np.abs(probs.sum(-1) - 1).max() < 1e-5):
        fail("workflow: the class or probability predictions are malformed")


def remote_cnn_phase(torch, gpu: str, seed: int, df) -> dict:
    """``ADAG(mnist_cnn(), "adam", remote=srv.endpoint).train(df)`` against
    a ``PSServer(discipline="adag", device="cuda")``, int8 commits, on
    ``cnn_train``'s MNIST frame at its workers, batch and window (2
    rounds); returns the fold launch counts of the run."""
    from distkeras_tpu_torch import ADAG, mnist_cnn, telemetry
    from distkeras_tpu_torch.netps import PSClient, PSServer
    from distkeras_tpu_torch.ops.kernels import fold as F

    _name, _trainer, kw = CNN_TRAIN[0]
    W, Kw, B = (kw["num_workers"], kw["communication_window"],
                kw["batch_size"])
    model = mnist_cnn(seed=seed, device="cuda")
    srv = PSServer(discipline="adag", device="cuda").start()
    handler_ms = time_handlers(srv)
    try:
        with env_set(DKTPU_NET_COMPRESS="int8"):
            trainer = ADAG(model, loss="sparse_categorical_crossentropy",
                           remote=srv.endpoint, **kw)
            telemetry.reset()
            torch.cuda.synchronize()
            reset_all_launches()  # counts start at 0 just before the path
            t0 = time.perf_counter()
            trained = trainer.train(df)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched, fold = launched_kernels(), F.launch_counts()
        with PSClient(srv.endpoint) as observer:
            stats = observer.stats()
        center = srv.center()
        log = list(srv.commit_log)
        evictions = srv.evictions
    finally:
        srv.close()
    rounds = CNN_ROUNDS
    steps = rounds * W * Kw
    moved = max(float(np.abs(c - p.cpu().numpy()).max())
                for c, p in zip(center, model.params.values()))
    same = all(np.array_equal(p.cpu().numpy(), c)
               for p, c in zip(trained.params.values(), center))
    hist = trainer.get_worker_histories()
    emit({"phase": "remote_cnn", "gpu": gpu, "trainer": "ADAG",
          "model": "mnist_cnn()",
          "server": "PSServer(discipline='adag', device='cuda')",
          "codec": "int8", "rounds": rounds, **kw, "dtype": "float32",
          "seconds": wall, "samples_per_s": steps * B / wall,
          "history": [float(v) for v in trainer.get_history()],
          "worker_histories": hist.tolist(), "commits": len(log),
          "evictions": evictions, "fold_backend": stats.get("fold_backend"),
          "launches": launched, "local_steps": steps,
          "tensors_per_commit": len(center),
          "params_per_commit": int(sum(c.size for c in center)),
          "center_max_abs_change": moved,
          "model_equals_server_center": same, **handler_stats(handler_ms),
          "server_commit_ms": handler_ms["commit"],
          "timing": "host clock; the handlers' times one by one"})
    if stats.get("fold_backend") != "cuda":
        fail(f"remote_cnn: the server folded with "
             f"{stats.get('fold_backend')!r}, not the CUDA kernel")
    if not np.all(np.isfinite(hist)):
        fail(f"remote_cnn: non-finite training loss: {hist}")
    if not moved > 0:
        fail("remote_cnn: the center did not move")
    if not same:
        fail("remote_cnn: the trained model is not the server's center")
    if len(log) != W * rounds:
        fail(f"remote_cnn: {len(log)} commits folded of {W * rounds} "
             f"({evictions} evictions)")
    if (fold != {"fold_commit": len(log), "fold_int8": 0, "fold_bf16": 0}
            or set(launched) != {"fold.fold_commit"}):
        fail(f"remote_cnn: launches {launched} for {len(log)} commits of "
             f"{len(center)} int8 tensors: one fold_commit a commit, no "
             f"other kernel")
    return fold


#: ``ckpt_serve``: config #4's DynSGD run is 2 epochs of ``CKPT_SAVED``
#: rounds (the data holds 2 rounds' rows); the interrupted run takes the
#: first epoch, then resumes.
CKPT_SAVED = 2
CKPT_ROUNDS = 2 * CKPT_SAVED
#: rows whose logits the deserialized model must give bit for bit
CKPT_PREDICT_ROWS = 256
#: the steps the hot swap saves: the trained weights, then a newer one
#: that is corrupted after its save
SWAP_STEP, SWAP_BAD_STEP = 7, 9
#: request sizes answered after the swap
SWAP_REQUESTS = (1, 3, 17, 64, 200)


def span_stats(snap: dict, name: str) -> dict:
    """Count and mean/max ms of every span whose path ends in ``name``
    (a span nests under its caller's, e.g. ``engine_run/checkpoint.save``)."""
    hits = [v for k, v in snap["spans"].items()
            if k == name or k.endswith("/" + name)]
    n = sum(h["count"] for h in hits)
    total = sum(h["total"] for h in hits)
    return {"count": n, "mean_ms": total / n * 1e3 if n else None,
            "max_ms": max((h.get("max") or 0.0 for h in hits),
                          default=0.0) * 1e3}


def centers_apart(a, b) -> float:
    """Largest absolute difference between two models' parameters."""
    return max((a.params[k] - v).abs().max().item()
               for k, v in b.params.items())


def ckpt_run(torch, K, seed: int, dtype: str, df, epochs: int, **extra):
    """One config #4 DynSGD run from the seed's weights through
    ``trainer.train(df)``, the LSTM counts set to 0 just before and read
    just after: the stash forward and the backward once a local step, the
    inference forward never. Returns ``(trainer, model, launches, s)``."""
    from distkeras_tpu_torch import DynSGD, imdb_lstm

    model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                      seq_len=SEQ_LEN, seed=seed, device="cuda")
    trainer = DynSGD(model, worker_optimizer="sgd",
                     loss="sparse_categorical_crossentropy", **TRAIN,
                     num_epoch=epochs, compute_dtype=dtype, **extra)
    torch.cuda.synchronize()
    K.reset_launches()  # counts start at 0 just before the main path runs
    t0 = time.perf_counter()
    trained = trainer.train(df)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    steps = len(trainer.get_history()) * TRAIN["num_workers"] * \
        TRAIN["communication_window"]
    for name in ("lstm_fwd_stash", "lstm_bwd"):
        if launches[name] != steps:
            fail(f"ckpt_serve ({dtype}): {name} launched {launches[name]} "
                 f"times in {steps} local steps")
    if launches["lstm_fwd"]:
        fail(f"ckpt_serve ({dtype}): training launched the inference "
             f"forward {launches['lstm_fwd']} times")
    if not np.all(np.isfinite(trainer.get_worker_histories())):
        fail(f"ckpt_serve ({dtype}): non-finite loss")
    return trainer, trained, launches, wall


def ckpt_serve_phase(torch, K, gpu: str, seed: int, dtype: str,
                     workdir: str):
    """Checkpoint, resume, fall back past a corrupt step and serialize, on
    config #4 at ``dtype``; returns the resumed trained model."""
    import warnings

    from distkeras_tpu_torch import (
        deserialize_model,
        serialize_model,
        telemetry,
    )
    from distkeras_tpu_torch.checkpoint import Checkpointer
    from distkeras_tpu_torch.datasets import imdb
    from distkeras_tpu_torch.resilience import integrity
    from distkeras_tpu_torch.telemetry.exporters import read_jsonl

    W, Kw, B = (TRAIN["num_workers"], TRAIN["communication_window"],
                TRAIN["batch_size"])
    df = imdb(n=CKPT_SAVED * W * Kw * B, vocab_size=VOCAB, seq_len=SEQ_LEN,
              seed=seed)
    ck = os.path.join(workdir, f"ckpt_{dtype}")
    metrics = os.path.join(workdir, f"metrics_{dtype}.jsonl")
    shutil.rmtree(ck, ignore_errors=True)
    with contextlib.suppress(FileNotFoundError):
        os.remove(metrics)
    full_t, full, full_launches, full_s = ckpt_run(torch, K, seed, dtype,
                                                   df, 2)
    _, again, _, again_s = ckpt_run(torch, K, seed, dtype, df, 2)
    repeat = centers_apart(full, again)
    del again

    telemetry.reset()
    first_t, _, first_launches, first_s = ckpt_run(
        torch, K, seed, dtype, df, 1, checkpoint_dir=ck, checkpoint_every=1,
        metrics_path=metrics)
    resumed_t, resumed, resumed_launches, resumed_s = ckpt_run(
        torch, K, seed, dtype, df, 2, checkpoint_dir=ck, checkpoint_every=1,
        metrics_path=metrics, resume=True)
    snap = telemetry.get().snapshot()
    apart = centers_apart(resumed, full)
    reader = Checkpointer(ck)
    latest = reader.latest_step()
    state_bytes = os.path.getsize(os.path.join(ck, str(latest), "state.pt"))
    digest_bytes = (reader.digest(latest) or {}).get("bytes")
    records = read_jsonl(metrics)
    rounds = [r for r in records if "round" in r and "kind" not in r]
    summaries = [r for r in records if r.get("kind") == "telemetry_summary"]

    # the newest step corrupted: the next resume falls back one step and
    # runs the last round again
    integrity.corrupt_step_dir(os.path.join(ck, str(latest)))
    before = snap["counters"].get("resilience.ckpt_fallback_steps", 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fallback_t, fallback, fallback_launches, _ = ckpt_run(
            torch, K, seed, dtype, df, 2, checkpoint_dir=ck,
            checkpoint_every=1, resume=True)
    fell_back = telemetry.get().snapshot()["counters"].get(
        "resilience.ckpt_fallback_steps", 0) - before
    warned = [str(w.message) for w in caught
              if "falling back" in str(w.message)]
    fallback_apart = centers_apart(fallback, full)

    t0 = time.perf_counter()
    blob = serialize_model(resumed)
    ser_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = deserialize_model(blob, device="cuda")
    torch.cuda.synchronize()
    deser_s = time.perf_counter() - t0
    x = np.random.default_rng(seed).integers(
        0, VOCAB, (CKPT_PREDICT_ROWS, SEQ_LEN)).astype(np.int32)
    want, got = resumed.predict(x), loaded.predict(x)
    logits_equal = bool(torch.equal(want, got))
    shutil.rmtree(ck, ignore_errors=True)

    rounds_s = min(full_s, again_s) / CKPT_ROUNDS   # a warm run's round
    save = span_stats(snap, "checkpoint.save")
    emit({"phase": "ckpt_serve", "gpu": gpu, "dtype": dtype,
          "trainer": "DynSGD", **TRAIN, "rounds": CKPT_ROUNDS,
          "resumed_after": CKPT_SAVED,
          "uninterrupted_s": [full_s, again_s],
          "uninterrupted_repeat_max_abs_diff": repeat,
          "resumed_max_abs_diff": apart, "limit": repeat,
          "resumed_rounds": len(resumed_t.get_history()),
          "first_rounds": len(first_t.get_history()),
          "history": [float(v) for v in full_t.get_history()],
          "resumed_history": [float(v) for v in resumed_t.get_history()],
          "launches": {"uninterrupted": full_launches,
                       "first": first_launches,
                       "resumed": resumed_launches,
                       "fallback": fallback_launches},
          "round_s_uninterrupted": rounds_s,
          "round_s_checkpointed": (first_s + resumed_s) / CKPT_ROUNDS,
          "save_count": save["count"], "save_ms": save["mean_ms"],
          "save_max_ms": save["max_ms"],
          "save_copy_ms": span_stats(snap, "checkpoint.save/copy")["mean_ms"],
          "save_digest_ms": span_stats(snap,
                                       "checkpoint.save/digest")["mean_ms"],
          "save_write_ms": span_stats(snap,
                                      "checkpoint.save/write")["mean_ms"],
          "save_share_of_round": save["mean_ms"] / 1e3 / rounds_s,
          "state_pt_bytes": state_bytes, "digest_bytes": digest_bytes,
          "restore_verified_ms": span_stats(
              snap, "checkpoint.restore")["mean_ms"],
          "restore_verify_ms": span_stats(
              snap, "checkpoint.restore/verify")["mean_ms"],
          "metrics_round_records": len(rounds),
          "metrics_summaries": len(summaries),
          "fallback_steps_counted": fell_back,
          "fallback_rounds": len(fallback_t.get_history()),
          "fallback_max_abs_diff": fallback_apart,
          "serialized_bytes": len(blob), "serialize_ms": ser_s * 1e3,
          "deserialize_ms": deser_s * 1e3,
          "predict_rows": CKPT_PREDICT_ROWS,
          "deserialized_logits_bit_equal": logits_equal,
          "timing": "host clock; save parts from the checkpoint.save spans "
                    "of the interrupted and resumed runs' saves"})
    if len(resumed_t.get_history()) != CKPT_ROUNDS - CKPT_SAVED:
        fail(f"ckpt_serve ({dtype}): the resumed run ran "
             f"{len(resumed_t.get_history())} rounds")
    if not apart <= repeat:
        fail(f"ckpt_serve ({dtype}): the resumed center is {apart} from the "
             f"uninterrupted one (two uninterrupted runs: {repeat})")
    if [r["round"] for r in rounds] != list(range(CKPT_ROUNDS)) or not all(
            r.get("samples_per_sec", 0) > 0 for r in rounds) or len(
            summaries) != 2:
        fail(f"ckpt_serve ({dtype}): the metrics log has rounds "
             f"{[r['round'] for r in rounds]} and {len(summaries)} summaries")
    if save["count"] != CKPT_ROUNDS:
        fail(f"ckpt_serve ({dtype}): {save['count']} saves in "
             f"{CKPT_ROUNDS} rounds")
    if fell_back < 1 or not warned or len(fallback_t.get_history()) != 1:
        fail(f"ckpt_serve ({dtype}): no fallback past the corrupt step "
             f"(counted {fell_back}, warned {warned}, "
             f"{len(fallback_t.get_history())} rounds run)")
    if not fallback_apart <= repeat:
        fail(f"ckpt_serve ({dtype}): the run resumed past the corrupt step "
             f"is {fallback_apart} from the uninterrupted one")
    if not logits_equal:
        fail(f"ckpt_serve ({dtype}): the deserialized model's logits differ "
             f"by {(want - got).abs().max().item()}")
    return resumed


def ckpt_swap_phase(torch, K, gpu: str, seed: int, trained,
                    workdir: str) -> dict:
    """Hot-swap ``trained``'s weights into a running server through a
    checkpoint directory; refuse a corrupt newer step."""
    import warnings

    from distkeras_tpu_torch import imdb_lstm, telemetry
    from distkeras_tpu_torch.checkpoint import Checkpointer
    from distkeras_tpu_torch.resilience import integrity
    from distkeras_tpu_torch.serving import (
        ModelRegistry,
        ServeClient,
        ServingFrontend,
    )

    serve_dir = os.path.join(workdir, "serve")
    shutil.rmtree(serve_dir, ignore_errors=True)
    widths = dict(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                  seq_len=SEQ_LEN)
    cpu_model = imdb_lstm(**widths, device="cpu")
    cpu_model.module.load_state_dict(
        {k: v.cpu() for k, v in trained.module.state_dict().items()})
    rng = np.random.default_rng(seed)

    def tokens(rows):
        return rng.integers(0, VOCAB, (rows, SEQ_LEN)).astype(np.int32)

    telemetry.reset()
    incumbent = imdb_lstm(**widths, seed=seed + 1, device="cuda")
    registry = ModelRegistry(incumbent, BUCKETS, directory=serve_dir,
                             poll_s=3600.0, device="cuda")
    frontend = ServingFrontend(registry).start()
    client = ServeClient(frontend.endpoint)
    worst, answered = 0.0, []

    def answer(rows: int) -> int:
        nonlocal worst
        x = tokens(rows)
        out, version = client.infer(x)
        ref = cpu_model.predict(x).numpy()
        worst = max(worst, float(np.abs(np.asarray(out) - ref).max()))
        answered.append(rows)
        return version

    try:
        _, v0 = client.infer(tokens(3))
        ckpt = Checkpointer(serve_dir)
        t0 = time.perf_counter()
        ckpt.save(SWAP_STEP, trained.params, meta={"round": CKPT_ROUNDS - 1})
        save_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        K.reset_launches()  # counts start at 0 just before the swap
        t0 = time.perf_counter()
        swapped = registry.poll_once()
        swap_s = time.perf_counter() - t0
        probe = K.launch_counts()
        batches0 = telemetry.get().snapshot()["counters"].get(
            "serving.batches", 0)
        K.reset_launches()  # and before the answered batches
        versions = [answer(rows) for rows in SWAP_REQUESTS]
        served = K.launch_counts()
        batches = telemetry.get().snapshot()["counters"].get(
            "serving.batches", 0) - batches0
        ckpt.save(SWAP_BAD_STEP, trained.params,
                  meta={"round": CKPT_ROUNDS - 1})
        integrity.corrupt_step_dir(os.path.join(serve_dir,
                                                str(SWAP_BAD_STEP)))
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            bad_swapped = registry.poll_once()
        after_bad = answer(SWAP_REQUESTS[2])
        counters = telemetry.get().snapshot()["counters"]
    finally:
        client.close()
        frontend.close()
        registry.close()
        shutil.rmtree(serve_dir, ignore_errors=True)
    row = {"phase": "ckpt_swap", "gpu": gpu, "buckets": list(BUCKETS),
           "version_before": v0, "swapped": swapped,
           "version_after": versions, "save_ms": save_s * 1e3,
           "swap_ms": swap_s * 1e3, "probe_launches": probe,
           "answered_rows": answered, "answered_batches": int(batches),
           "answered_launches": served, "max_abs_err_vs_cpu_plain": worst,
           "atol": SERVE_ATOL, "corrupt_step_swapped": bad_swapped,
           "version_after_corrupt_step": after_bad,
           "swap_failures": counters.get("serving.swap_failures", 0),
           "retrace_after_warmup": counters.get(
               "serving.retrace_after_warmup", 0),
           "timing": "host clock: save of the params, poll_once = restore "
                     "(verified) + a fresh warmup probe of every bucket"}
    emit(row)
    if v0 != -1 or not swapped or set(versions) != {SWAP_STEP}:
        fail(f"ckpt_swap: versions {v0} -> {versions} (swapped {swapped})")
    if probe["lstm_fwd"] != len(BUCKETS) or probe["lstm_fwd_stash"] or \
            probe["lstm_bwd"]:
        fail(f"ckpt_swap: the warmup probe launched {probe}")
    if not batches or served["lstm_fwd"] < batches:
        fail(f"ckpt_swap: lstm_fwd launched {served['lstm_fwd']} times for "
             f"{batches} answered batches")
    if not worst <= SERVE_ATOL:
        fail(f"ckpt_swap: answers differ from the CPU plain forward by "
             f"{worst}")
    if bad_swapped or after_bad != SWAP_STEP or \
            counters.get("serving.swap_failures", 0) != 1:
        fail(f"ckpt_swap: the corrupt step {SWAP_BAD_STEP} was not refused "
             f"(swapped {bad_swapped}, version {after_bad}, failures "
             f"{counters.get('serving.swap_failures', 0)})")
    if counters.get("serving.retrace_after_warmup", 0):
        fail("ckpt_swap: serving.retrace_after_warmup fired")
    return row


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
        from distkeras_tpu_torch.ops.kernels import flash_attention as FA
        from distkeras_tpu_torch.ops.kernels import fold as F
        from distkeras_tpu_torch.ops.kernels import groupnorm as G
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
    libs = build.build(["lstm_fwd", "lstm_bwd", "groupnorm", "fold",
                        "flash_attn"])
    ptxas = {k: [ln.strip() for ln in v.with_suffix(".log").read_text()
                 .splitlines() if "Used" in ln or "spill" in ln]
             for k, v in libs.items() if v.with_suffix(".log").exists()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": dict(build.BUILD_SECONDS),
          "libraries": {k: str(v) for k, v in libs.items()},
          "ptxas": ptxas})
    flash_log = libs["flash_attn"].with_suffix(".log")
    flash_regs = flash_registers(flash_log.read_text()
                                 if flash_log.exists() else "")
    emit({"phase": "flash_build", "kernels": flash_regs})
    if flash_log.exists() and len(flash_regs) != 18:
        fail(f"expected 18 flash kernel instantiations in the build report, "
             f"found {len(flash_regs)}")
    spilled = [r for r in flash_regs
               if r.get("spill_stores") or r.get("spill_loads")]
    if spilled:
        fail(f"flash kernels spill registers: {spilled}")

    lstm_regs = [r for src in ("lstm_fwd", "lstm_bwd")
                 if libs[src].with_suffix(".log").exists()
                 for r in lstm_registers(
                     libs[src].with_suffix(".log").read_text())]
    emit({"phase": "lstm_build", "kernels": lstm_regs})
    want = sorted(LSTM_TC_KERNELS + LSTM_F32_KERNELS)
    if sorted(r["kernel"] for r in lstm_regs) != want:
        fail(f"expected the LSTM kernels {want} in the build report, found "
             f"{lstm_regs}")
    spilled = [r for r in lstm_regs
               if r.get("spill_stores") or r.get("spill_loads")]
    if spilled:
        fail(f"LSTM kernels spill registers: {spilled}")

    gn_log = libs["groupnorm"].with_suffix(".log")
    gn_regs = gn_registers(gn_log.read_text() if gn_log.exists() else "")
    emit({"phase": "gn_build", "kernels": gn_regs})
    if gn_log.exists() and len(gn_regs) != GN_KERNELS:
        fail(f"expected {GN_KERNELS} GroupNorm kernels in the build report, "
             f"found {gn_regs}")
    spilled = [r for r in gn_regs
               if r.get("spill_stores") or r.get("spill_loads")]
    if spilled:
        fail(f"GroupNorm kernels spill registers: {spilled}")

    # seconds from each mark to the next, printed before the kernels line
    laps, last = {}, [None, time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        if last[0] is not None:
            laps[last[0]] = now - last[1]
        last[:] = [name, now]

    rng = np.random.default_rng(args.seed)
    model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                      seq_len=SEQ_LEN, seed=args.seed, device="cuda")
    lap("lstm_kernels")
    fwd = kernel_phase(torch, K, model, rng)
    stash = stash_phase(torch, K, model, rng)
    bwd = bwd_phase(torch, K, model, rng)
    del model
    torch.cuda.empty_cache()

    lap("train")
    trained, train_launches = train_phase(torch, K, gpu, args.seed)
    bf16_trained, bf16_train_launches = train_phase(
        torch, K, gpu, args.seed, "bfloat16")
    del bf16_trained
    parity_phase(torch, args.seed)
    lap("lstm_widths")
    lstm_widths_phase(torch, K, args.seed)
    defaults = {k: v.default for k, v in
                inspect.signature(imdb_lstm).parameters.items()
                if k in ("vocab_size", "embed_dim", "hidden_size", "seq_len")}
    imdb_trained, _ = train_phase(torch, K, gpu, args.seed, "bfloat16",
                                  IMDB_ROUNDS, defaults,
                                  "lstm_fwd_stash_xw_bf16")
    del imdb_trained
    torch.cuda.empty_cache()

    cpu_model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED,
                          hidden_size=HIDDEN, seq_len=SEQ_LEN, device="cpu")
    cpu_model.module.load_state_dict(
        {k: v.cpu() for k, v in trained.module.state_dict().items()})
    lap("serve")
    serve_launches = serve_phase(torch, K, trained, cpu_model, rng, gpu)
    del trained, cpu_model
    torch.cuda.empty_cache()

    lap("group_norm")
    gn_rows = gn_kernel_phase(torch, G, args.seed)
    gn_uncached_phase(torch, G, args.seed)
    gn_launches = resnet_train_phase(torch, G, gpu, args.seed)
    torch.cuda.empty_cache()
    bf16_gn_launches = resnet_train_phase(torch, G, gpu, args.seed,
                                          "bfloat16")
    resnet_parity_phase(torch, args.seed)
    torch.cuda.empty_cache()

    lap("fold")
    fold_rows = fold_kernel_phase(torch, F, args.seed)
    fold_launches = {codec: remote_train_phase(
        torch, K, F, gpu, args.seed, codec)["fold_commit"]
        for codec in ("int8", "bf16")}
    remote_parity_phase(torch, args.seed)
    torch.cuda.empty_cache()

    lap("flash")
    flash_rows = flash_kernel_phase(torch, FA, args.seed)
    flash_launches = transformer_train_phase(torch, FA, gpu, args.seed)
    torch.cuda.empty_cache()
    bf16_flash_launches = transformer_train_phase(torch, FA, gpu, args.seed,
                                                  "bfloat16")
    transformer_parity_phase(torch, args.seed)
    torch.cuda.empty_cache()

    lap("mlp_train")
    from distkeras_tpu_torch.datasets import mnist

    mlp_df = mnist(n=MLP_ROUNDS * MLP_TRAIN["steps_per_program"]
                   * MLP_TRAIN["batch_size"], flat=True, seed=args.seed)
    for dtype in DTYPES:
        mlp_train_phase(torch, gpu, args.seed, dtype, mlp_df)
    del mlp_df
    lap("cnn_train")
    frames = cnn_frames(args.seed)
    for dtype in DTYPES:
        cnn_train_phase(torch, gpu, args.seed, dtype, frames)
    lap("cnn_parity")
    cnn_parity_phase(torch, args.seed)
    lap("workflow")
    workflow_phase(torch, gpu, args.seed)
    lap("remote_cnn")
    adag_fold_launches = remote_cnn_phase(torch, gpu, args.seed,
                                          frames["mnist_cnn"])
    del frames
    torch.cuda.empty_cache()

    lap("ckpt_serve")
    workdir = os.path.join("build", "ckpt_serve")
    os.makedirs(workdir, exist_ok=True)
    resumed = ckpt_serve_phase(torch, K, gpu, args.seed, "float32", workdir)
    ckpt_serve_phase(torch, K, gpu, args.seed, "bfloat16", workdir)
    ckpt_swap_phase(torch, K, gpu, args.seed, resumed, workdir)
    del resumed
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()

    lap("remote_overlap")
    workdir = os.path.join("build", "netps_state")
    os.makedirs(workdir, exist_ok=True)
    durable = remote_overlap_phase(torch, K, F, gpu, args.seed, workdir)
    lap("ps_failover")
    cli = cli_server(workdir)  # starts while ps_failover runs
    try:
        durable.update(ps_failover_phase(torch, K, F, gpu, args.seed))
        lap("ps_restart")
        restart = ps_restart_phase(torch, K, F, gpu, args.seed, cli)
    finally:
        for _t0, proc in cli["lives"]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    durable["replay"] += restart["replay"]
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()

    lap("netps_config8")
    config8 = netps_config8_phase(torch, F, FA, gpu, args.seed)
    torch.cuda.empty_cache()

    def entry(name, source, replaces, rows, launches, bf16_launches):
        """The largest batch's f32 row, the largest error over every f32
        row, and the bf16 row at that batch beside."""
        f32, bf16 = rows["float32"], rows["bfloat16"]
        top, top16 = f32[max(f32)], bf16[max(f32)]
        return {"name": name, "route": "cuda",
                "source": f"distkeras_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in f32.values()),
                "ms": top["ms"], "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                "library_ms": top["library_ms"],
                "shape": f"B={top['B']},T={SEQ_LEN},E={EMBED},H={HIDDEN} "
                         "float32",
                "bf16_launches": bf16_launches,
                "bf16_ms": top16["ms"], "bf16_plain_ms": top16["plain_ms"],
                "bf16_bound_ms": top16["bound_ms"],
                "bf16_bound_by": top16["bound_by"],
                "bf16_library_ms": top16["library_ms"],
                "bf16_max_abs_err": max(r["max_abs_err"]
                                        for r in bf16.values()),
                **{f"{pre}{k}": row[k] for pre, row in (("", top),
                                                        ("bf16_", top16))
                   for k in ("ratio_to_library", "bound_share",
                             "us_per_step", "recurrent_ms", "wgrad_ms", "R",
                             "C")
                   if k in row}}

    def gn_entry(name, key, bwd):
        """The largest slab's row (the stem's, 112x112x64), and the sum
        over one step's 53 GroupNorms of the per-slab times and bounds;
        the bf16 rows' beside."""
        pre = "bwd_" if bwd else ""
        err_key = "bwd_max_abs_err" if bwd else "fwd_max_abs_err"

        def step_sum(rows, k):
            return sum(r[k] * r["per_step"] for r in rows)

        f32, bf16 = gn_rows["float32"], gn_rows["bfloat16"]
        top, top16 = f32[0], bf16[0]
        return {"name": name, "route": "cuda",
                "source": "distkeras_tpu_torch/csrc/groupnorm.cu",
                "replaces": f"distkeras_tpu/ops/pallas/groupnorm.py:{key}",
                "launches": gn_launches[name],
                "max_abs_err": max(r[err_key] for r in f32),
                "ms": top[f"{pre}ms"], "plain_ms": top[f"{pre}plain_ms"],
                "bound_ms": top[f"{pre}bound_ms"],
                "bound_by": top[f"{pre}bound_by"],
                "library_ms": top[f"{pre}library_ms"],
                "shape": f"B={top['B']},N={top['N']},C={top['C']},"
                         f"G={GN_GROUPS},relu={top['relu']} float32",
                "step_ms": step_sum(f32, f"{pre}ms"),
                "step_plain_ms": step_sum(f32, f"{pre}plain_ms"),
                "step_library_ms": step_sum(f32, f"{pre}library_ms"),
                "step_bound_ms": step_sum(f32, f"{pre}bound_ms"),
                "bf16_launches": bf16_gn_launches[name],
                "bf16_ms": top16[f"{pre}ms"],
                "bf16_plain_ms": top16[f"{pre}plain_ms"],
                "bf16_bound_ms": top16[f"{pre}bound_ms"],
                "bf16_bound_by": top16[f"{pre}bound_by"],
                "bf16_library_ms": top16[f"{pre}library_ms"],
                "bf16_max_abs_err": max(r[err_key] for r in bf16),
                "bf16_step_ms": step_sum(bf16, f"{pre}ms"),
                "bf16_step_library_ms": step_sum(bf16, f"{pre}library_ms"),
                "bf16_step_bound_ms": step_sum(bf16, f"{pre}bound_ms")}

    def fold_entry():
        """One IMDB commit (config #4, what ``remote_train`` folds) in
        int8 (with the launches of the journal replays and of the standby
        in ``remote_overlap``, ``ps_failover`` and ``ps_restart``, and of
        config #8's mesh arm: the traced call site's counterpart), the
        bf16 commit beside, ResNet-50's and config #2's CNN's
        commits (with ``remote_cnn``'s launches) and the largest tensor
        folded alone (the same kernel, one row) after them."""
        commit = {(r["model"], r["codec"]): r for r in fold_rows
                  if r["phase"] == "fold_commit"}
        i8, b16 = commit["imdb_lstm", "int8"], commit["imdb_lstm", "bf16"]
        rn8, rn16 = commit["resnet50", "int8"], commit["resnet50", "bf16"]
        cn8, cn16 = commit["mnist_cnn", "int8"], commit["mnist_cnn", "bf16"]
        tensor = max((r for r in fold_rows if r["phase"] == "fold_kernel"
                      and r["codec"] == "int8"),
                     key=lambda r: (r["n"], -r["commit_scale"]))
        return {"name": "fold_commit", "route": "cuda",
                "source": "distkeras_tpu_torch/csrc/fold.cu",
                "replaces": "distkeras_tpu/ops/pallas/fold.py:68",
                "call_sites": [
                    "distkeras_tpu/ops/pallas/fold.py:114 fold_compressed "
                    "(the host fold: remote_train and every server)",
                    "distkeras_tpu/ops/pallas/fold.py:84 fold_traced (the "
                    "mesh collective: netps_config8's mesh dispatch)"],
                "launches": fold_launches["int8"],
                "replay_launches": durable["replay"],
                "standby_launches": durable["standby"],
                "mesh_launches": config8["mesh_fold_launches"],
                "mesh_commits": config8["mesh_commits"],
                "max_abs_err": max(r["max_abs_err"] for r in fold_rows),
                "ms": i8["ms"], "plain_ms": i8["plain_ms"],
                "bound_ms": i8["bound_ms"], "bound_by": i8["bound_by"],
                "library_ms": i8["library_ms"], "library": i8["library"],
                "shape": f"one imdb_lstm commit, {i8['tensors']} tensors, "
                         f"{i8['params']} parameters, int8 into f32",
                "cold_launch_floor_ms": i8["cold_launch_floor_ms"],
                "tensor_loop_ms": i8["tensor_loop_ms"],
                "fold_delta_wall_ms": i8["fold_delta_wall_ms"],
                "bf16_launches": fold_launches["bf16"],
                "bf16_ms": b16["ms"], "bf16_plain_ms": b16["plain_ms"],
                "bf16_bound_ms": b16["bound_ms"],
                "bf16_library_ms": b16["library_ms"],
                "resnet50_ms": rn8["ms"], "resnet50_bound_ms": rn8["bound_ms"],
                "resnet50_library_ms": rn8["library_ms"],
                "resnet50_bf16_ms": rn16["ms"],
                "resnet50_bf16_bound_ms": rn16["bound_ms"],
                "resnet50_bf16_library_ms": rn16["library_ms"],
                "mnist_cnn_shape": f"one mnist_cnn commit, {cn8['tensors']} "
                                   f"tensors, {cn8['params']} parameters",
                "mnist_cnn_ms": cn8["ms"],
                "mnist_cnn_plain_ms": cn8["plain_ms"],
                "mnist_cnn_bound_ms": cn8["bound_ms"],
                "mnist_cnn_library_ms": cn8["library_ms"],
                "mnist_cnn_bf16_ms": cn16["ms"],
                "mnist_cnn_bf16_plain_ms": cn16["plain_ms"],
                "mnist_cnn_bf16_bound_ms": cn16["bound_ms"],
                "mnist_cnn_bf16_library_ms": cn16["library_ms"],
                "adag_mnist_cnn_launches": adag_fold_launches["fold_commit"],
                "tensor_ms": tensor["ms"], "tensor_bound_ms": tensor["bound_ms"],
                "tensor_library_ms": tensor["library_ms"],
                "tensor_shape": f"{tensor['tensor']} n={tensor['n']} int8"}

    def flash_entry(kernel, line):
        """Config #7's shape in f32 (the path's); the largest error over
        every f32 row, and the bf16 row's times beside."""
        rows = [r for r in flash_rows if r["name"] == f"flash_{kernel}"]
        f32 = [r for r in rows if r["dtype"] == "float32"]
        top = f32[0]
        bf16 = next(r for r in rows if r["dtype"] == "bfloat16"
                    and (r["B"], r["L"]) == (top["B"], top["L"]))
        return {"name": f"flash_{kernel}", "route": "cuda",
                "source": "distkeras_tpu_torch/csrc/flash_attn.cu",
                "replaces": f"distkeras_tpu/ops/pallas/flash_attention.py:"
                            f"{line}",
                "launches": flash_launches[f"flash_{kernel}"],
                "max_abs_err": max(r["max_abs_err"] for r in f32),
                "ms": top["ms"], "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                "library_ms": top["library_ms"],
                "shape": f"B={top['B']},L={top['L']},H={top['H']},"
                         f"D={top['D']} float32",
                "bf16_launches": bf16_flash_launches[f"flash_{kernel}"],
                "bf16_ms": bf16["ms"], "bf16_bound_ms": bf16["bound_ms"],
                "bf16_bound_by": bf16["bound_by"],
                "bf16_library_ms": bf16["library_ms"],
                "bf16_max_abs_err": max(r["max_abs_err"] for r in rows
                                        if r["dtype"] == "bfloat16"),
                "config8_bf16_launches": config8["flash"][f"flash_{kernel}"]}

    lap(None)
    emit({"phase": "seconds", "from_build": time.perf_counter() - t0,
          "phases": laps})
    emit({"kernels": [
        entry("lstm_fwd", "lstm_fwd.cu",
              "distkeras_tpu/ops/pallas/lstm.py:189", fwd, serve_launches,
              None),
        entry("lstm_fwd_stash", "lstm_fwd.cu",
              "distkeras_tpu/ops/pallas/lstm.py:189", stash,
              train_launches["lstm_fwd_stash"],
              bf16_train_launches["lstm_fwd_stash"]),
        entry("lstm_bwd", "lstm_bwd.cu",
              "distkeras_tpu/ops/pallas/lstm.py:230", bwd,
              train_launches["lstm_bwd"], bf16_train_launches["lstm_bwd"]),
        gn_entry("group_norm_fwd", 239, bwd=False),
        gn_entry("group_norm_bwd", 262, bwd=True),
        fold_entry(),
        flash_entry("fwd", 213),
        flash_entry("dq", 249),
        flash_entry("dkv", 261),
    ]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
