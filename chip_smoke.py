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
   and must cover every batch served. Then the serving chaos drill on the
   same frontend (``DKTPU_NET_FAULTS`` installed in process):
   ``serve_slow@1:0.3`` holds request 1's reply, ``serve_drop@2`` closes
   request 2's connection before admission and the ``ServeClient``
   retries it (one failover); every answer within ``SERVE_ATOL`` of the
   CPU plain forward, both faults fired.

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
   from the same weights. Then ``sharded_feed``: config #5 fed from a
   uint8 shard store, as ``examples/imagenet_disk.py`` feeds it. (a) 768
   random 224x224x3 uint8 rows and their labels written through
   ``ShardWriter`` in shards of 128 rows (115.6 MB; a round's 2 x 128 rows
   span two shards), round 0 of the sharded plan bit-equal to the in-RAM
   plan's; (b) three arms of ``SynchronousDistributedTrainer(resnet50(
   norm_impl="pallas"), compute_dtype="bfloat16")``, 3 rounds each:
   ``device`` (the store, ``device_transform=flip_crop_transform()``),
   ``host`` (the store, ``transform=`` the example's numpy crop and flip)
   and ``ram`` (the rows in an in-RAM ``DataFrame``): samples/s, ms a
   local step, ``input_stall_seconds``, the staging ms a round timed alone
   over the plan, the ``native.gather*`` counters (no fallback); 53
   launches of each GroupNorm kernel a step, in bf16 only, counted from 0
   just before each run; (c) ``flip_crop`` on a 256-row batch on the card
   bit-equal to the CPU's, by CUDA events beside its bound; (d) one round
   from the store, the native gather against numpy
   (``DKTPU_NO_NATIVE=1``), median of 5 in turns, bit-equal; (e) config
   #3 (``AEASGD(cifar10_cnn())``, bf16) from RAM with the native gather
   and with numpy, after a warm run, A B B A: samples/s and the stall;
   (f) ``ModelPredictor.predict`` over the store on the card equal to the
   in-RAM predict within 1e-5, ``AccuracyEvaluator`` equal on both
   frames, a second predict versioning the column and ``vacuum``
   reclaiming the first. The native loader (``native/loader.cc``) is
   built with g++ in the ``build`` phase.

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
    L = 1024 and 512, and D = 40, which the wrappers zero-pad to 48), and
    at the widest tile, DP = 256: config #6 at 4 heads of 256 [8, 2048, 4,
    256], then L = 136 and 512 and D = 160 and 192 (TMA's zeros up to the
    tile): errors with their limits, two calls' bits of each
    kernel, the f32 forward's and backward's errors at each of those
    shapes but config #7's and its tensor-parallel share, and at three with
    few rows (B*L*H 272, 144, 272)
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
    phases gives the registers and spills of the 24 flash kernel
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
    distance; then the same at 2 heads of 256 (d_model 512, the DP = 256
    kernels), ``transformer_parity_hd256``, its logits within a half
    (``LM_PARITY_HD256_LOGITS_SHARE``: f32-level differences before the
    kernels move bf16 roundings of q, k and v there).

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
    --device cuda --state-dir D``, in a subprocess whose environment
    schedules ``ps_crash@8`` (``DKTPU_NET_FAULTS``) with a fired-fault
    journal (``DKTPU_FAULTS_STATE``): it SIGKILLs itself before folding its
    ninth commit and is started again on the same port, directory and
    journal (and does not crash again) while the workers ride through on
    retries. The journal
    across both lives holds no ``(worker, seq)`` twice, at most
    ``_WRITE_QUEUE`` acknowledged commits are missing from it, and the
    restarted server's final center is bit-equal to this process's
    recovery of its directory, which launches ``fold_commit`` once per
    replayed record.
20. ``netps_config8`` — config #8 (``bench.py:1465-1468``, the AEASGD
    transformer through the parameter server: 4 layers, d_model 512, 8
    heads, d_ff 2048, vocab 8192, seq 128, batch 4, window 2, 12 rounds
    in the bench, cut to 8 here, one worker, adam at lr 1e-4, alpha 0.05, bf16, flash, remat) at full
    width through the arms the port serves: ``inprocess`` (``AEASGD(...)
    .train(df)``), ``pr4`` (``run_remote`` over TCP, inflight 1), ``shm``
    (the ring, inflight 2), ``mesh`` (the in-process dispatch into the
    server's device center, inflight 2) and ``optimized`` (TCP, inflight
    2, 2 stripes, int8), one warm run (2 rounds) and two timed runs each
    against a fresh ``PSServer(device="cuda", transport=...)``;
    ``durable`` (``optimized`` against a server seeded with the weights
    and journaling into a fresh directory) in 2 ABBA pairs with a
    baseline ``optimized`` run (the reference runs at least 10):
    tokens/s (the median of the timed runs), ``shm_vs_pr4``,
    ``mesh_vs_shm``, ``mesh_vs_inprocess``, ``optimized_vs_pr4``,
    ``shm_vs_tcp_optimized``, ``durable_overhead_vs_optimized`` (the
    geometric mean of the pairs' ratios, less 1), the dialect counters and
    the RPC spans. The counts are set to 0 before each run and read after it:
    the losses finite and the center moved; the server's commit log holds
    each ``(0, seq)`` once (a durable run's journal too); one
    ``fold_commit`` launch per folded commit, however many stripes carried
    it; every commit on the arm's dialect, on the client's and on the
    server's side (a stripe a span), none on another, and no demotion or
    ring fallback (in the mesh
    arm ``netps.mesh.folds``, the folds that came through the dispatch,
    equals the commits); the flash kernels in
    bf16 only, 2/1/1 a layer a step. Then a ``MeshFolder`` on the card
    with config #8's 70 tensors folds an f32, a bf16 and two int8 commits
    bit-equal to the numpy oracle; the mesh arm again under
    ``mesh_down@4`` (the dispatch of commit seq 4 fails as a lost device
    would: the commit lane demotes once, onto the ring, and retransmits
    that seq there; the server folds seqs 0-3 from the dispatch and 4-11
    from the ring, each once); and a mesh run
    at inflight 1 whose center must equal ``pr4``'s (or lie within the
    distance of two ``pr4`` runs, when the card does not repeat itself);
    and an int8 run at inflight 1 over 2 stripes bit-equal to the same run
    over 1. Then the ``hier_curve`` arm (``bench.py:689-733``): flat
    against a per-host aggregator on the card (``run_remote(hier=True)``,
    the ring, inflight 1, one stripe, f32, a flush at most every 0.5 s)
    at 1, 2 and 4 workers, 6 rounds a point, one warm run (4 workers,
    hier) and one timed run a point: tokens/s, root commits and their
    rate, worker commits a second; at every hier point each worker commit
    absorbed once, the aggregator's ledger balanced with nothing open, the
    root holding only the aggregator's commits and no more than the flat
    run's, and ``fold_commit`` launched once an absorbed commit plus once a
    root commit; each point beside ``controller_topology``, what the
    tuner's ``recommended_topology`` picks at its fan-in. The ``auto`` arm
    (``bench.py:672-687``): the ring and ``autotune=True`` from a cold
    start, no other data-plane knob, one warm and two timed runs with
    every check above, held to the ring's rule (codec ``none``, one
    stripe, read from the run's ``tuner_run_summary`` event):
    ``auto_tokens_per_sec``, ``auto_vs_best_hand_tuned`` (over ``shm``),
    ``auto_knobs``. (c) A TCP cold start (``autotune=True``, the control
    loop evaluating every 3 rounds): every probe result and the winner,
    every decision, the converged knobs; each seq folded once, one
    ``fold_commit`` a probe of the sweep plus one a folded commit; the
    probe's decode on the card in each codec bit-equal to the numpy
    ``decode_entry`` (one launch a probe) and timed beside its bound; a
    sweep against an idle journaling server leaving its center, log, dedup
    table and journal as they were. (d) A client retuned from 1 to 2
    stripes between seeded int8 commits: every pull equal to an unstriped
    observer's, the center bit-equal to the same commits folded
    unstriped. ``sim_drift`` (``bench.py:769-815``): one more ``pr4`` run
    after the timed arms with ``DKTPU_TRACE=1`` into a trace directory of
    its own; the simulator fits its timing model from that stream, replays
    the run and reports predicted against measured tokens/s (a null ratio
    fails the phase; a ratio outside the band is reported, as the
    reference only records it). Then ``hier_crossover`` replays the
    phase's own ``hier_curve``: the predicted and measured crossover and
    the largest held-out error.

21. ``ensemble_train`` — the reference's ``AveragingTrainer`` and
    ``EnsembleTrainer`` on config #4 (``TRAIN``: 4 workers, window 4,
    batch 2048) for 2 rounds, f32 then bf16: the stash forward and the
    backward once a local step (32 in 32) in the run's dtype only, the
    ensemble's 4 members pairwise apart; then each at batch 32 on the card
    and on the CPU from the same weights and per-worker draws (f32 within
    1e-5, bf16 within ``BF16_PARITY_SHARE``).
22. ``fault_drills`` — the resilience plane on the card, each drill's
    plan installed in process and cleared after it, every scheduled fault
    fired: (a) ``ADAG(mnist_cnn())`` (config #2) with ``nan@1`` and
    ``divergence_reset=1000``: one non-finite round, one worker reset (the
    one ``poison_worker(1, 4)`` names), a finite center, and at
    ``CNN_PARITY``'s cut with 4 workers the card within
    ``RESNET_PARITY_FACTOR`` of the CPU f32 run's distance from float64;
    (b) config #4 DynSGD with a checkpoint a round under
    ``Supervisor(backoff_s=0, retry_on=(InjectedFault,))`` and
    ``crash@2``: two attempts, bit-equal to the uninterrupted run, the
    LSTM kernels once a local step over both attempts; (c) the same with
    ``ckpt_corrupt@1`` too: the resume falls back to step 0
    (``resilience.ckpt_corrupt_detected`` 1), bit-equal again.
23. ``netps_chaos`` — config #4 remote DynSGD (int8) against the port's
    server on the card: (a) one worker through the ``ChaosProxy`` under
    ``delay@6:0.2;drop@11;dup@8;drop_r@9;partition@14:0.8``; (b) 4
    workers with ``evict@2:0`` and a 1 s lease (at least one eviction);
    (c) one worker on the shm ring under ``shm_delay@3:0.2;
    shm_corrupt@6``. Each: every fault fired, each ``(worker, seq)``
    folded once, every acknowledged commit folded, one ``fold_commit`` a
    folded commit; (a) and (c) bit-equal to the same run without faults.
24. ``netps_sharded`` — two real models through a 2-shard center
    (``ShardSet(2, device="cuda")``): config #8's, with
    ``DKTPU_PS_SHARD_RULES=tok_embed=split`` (the 8192 x 512 embedding
    row-split over both shards), codec none, inflight 1, bit-equal to
    ``pr4``'s single-server center, two launches a commit; then config #4
    as a user drives it, ``DynSGD(imdb_lstm(...), remote=<the matrix>)``
    (int8, 4 workers, 3 rounds): each logical seq folded once on each
    shard, two launches a logical commit, finite losses, the model the
    assembled center.
25. ``sharded_center`` — config #10 (``bench.py:898-979`` at its
    accelerator size, ``:1484-1487``): 16 tensors of 256 x 512 f32, 4
    workers, 6 commits of 1e-3 each, against one ``PSServer`` and
    ``ShardSet`` gangs of 2 and 4 on the card: ``folds_per_sec``,
    ``bytes_per_sec``, ``speedup_vs_1`` and ``speedup_vs_single_ps``;
    each point's center bit-equal to the numpy oracle, 24 launches on
    each shard.
26. ``shard_crash`` — two CLI shard servers (``python -m
    distkeras_tpu_torch.netps --shard k/2 --device cuda --state-dir ...``,
    started before ``netps_config8``) under ``shard_crash@1:4`` with a
    fired-fault journal each: config #4 remote DynSGD (int8) against the
    matrix; shard 1 SIGKILLs itself after 4 folds (status -9) and is
    restarted on its port and directory; the run completes. Checked: the
    fault fired once, on shard 1; every acknowledged logical commit
    journaled once on each shard; a server built here on shard 1's
    directory adopts its ``plan.json``, replays its journal (one
    ``fold_commit`` a record) into the live shard's center, admits the
    plan and refuses a drifted one.
27. ``netps_tree`` — the aggregation plane on the card: (a) three windows
    (f32, bf16, int8) of three commits of config #8's 70 tensors through
    an ``AggregatorServer(fan_in=3)`` in front of a root: each flushed
    combined commit bit-equal to the numpy decode-then-add (the int8
    window with a zero-scale tensor), the root's center bit-equal to the
    same run on the CPU, 3 aggregator launches and 1 root launch a window,
    and one pre-combine's time beside its bound; (b) config #4 remote
    DynSGD (int8, 4 workers, 3 rounds) under ``DKTPU_NET_HIER=1`` over
    the ring: exactly-once at both levels; (c) ``build_tree("host:2,
    region:2")`` under ``link_down@1:3``: the cut uplink's windows
    buffered, then drained in order, no silent loss, the root folding the
    top node's forwarded windows; (d) a journaled ``TreeNode`` stopped as
    its death would stop it, with a window open, and its ``TreeStandby``:
    promotion, the children re-parented, no constituent landed twice, the
    dead window counted lost ((c) and (d) with ``probe_links=False``, so
    their links keep f32 and their sums stay exact); (e) a leaf with
    ``probe_links=True`` against a root on the card over TCP: the codec
    sweep with config #8's center as the payload (one root launch a
    probe), ``how="probed"``, one commit through the picked link.
28. ``observability`` — the observability plane: (a) config #4's remote
    DynSGD (int8, 4 workers, window 4, batch 2048, 3 rounds) against the
    port's CLI server (``python -m distkeras_tpu_torch.netps --device
    cuda`` with ``DKTPU_TRACE=1``, a trace directory and
    ``DKTPU_VITALS_S=0.5``), untraced, traced, traced, untraced, then
    ``python -m distkeras_tpu_torch.telemetry report --trace <dir>`` in a
    subprocess without ``DKTPU_TRACE``: it exits 0 with the critical path,
    every traced commit a complete trace and no WARNING line; the server's
    fold launches (counted in its process, written at its exit) equal the
    commits it folded and each run launches the stash forward and the
    backward 48 times; samples/s traced beside untraced, and beside
    ``remote_train``'s int8 run; (b) one worker at batch 32, traced and
    untraced, from the same weights, against a CUDA server in process:
    the final centers bit-equal; (c) ``telemetry scrape <ep> --json`` (one
    line: ``fold_backend`` ``cuda``, role ``ps``, a non-empty ring),
    ``telemetry health --targets ps=<ep> --samples 2`` (exit 0) and the
    server's Prometheus text parsed back, ``device.bytes_in_use`` above 0;
    (d) a second traced CLI server under ``ps_crash@2`` leaves a flight
    dump for ``fault:ps_crash`` before its SIGKILL, and SIGTERM to (a)'s
    leaves one for ``sigterm``; (e) ``serve``'s 44 requests on the traced
    run's model, untraced then traced: every ``serve.request`` trace
    complete (``serve.wire``, ``serve.queue``, ``serve.batch``),
    ``ServeClient.stats(ring=8)`` a non-empty ring, p50 and p99 beside.

29. ``moe_train`` (run after the flash phases) — ``SingleTrainer(
    MoETransformerLM(attn_impl="flash"))`` at the class's own defaults
    (vocab 32000, 4 layers, d_model 256, 8 heads, d_ff 1024, 8 experts,
    capacity factor 1.5; 34.8 M parameters), batch 8 at length 512, adam
    under ``warmup_cosine_decay_schedule``, 2 rounds of 2 steps, in f32
    and bf16 with ``num_selected`` 1 and 2: the loss finite and moving,
    each flash kernel launched once a layer a step (16) and nothing else,
    a step split (flash forward and backward, the dispatch and combine
    einsums) and ``moe_parity``: one step at B=2 on the card and on the
    CPU, the card routed as the CPU routed (its own picks off the CPU's
    only where the two runs' probability difference explains it), the
    logits, the gradients and the sown values within a share of the
    design's yardstick (f32: the CPU's flash-vs-dense distance; bf16:
    the CPU's bf16-vs-f32), the expert fractions equal.
30. ``bn_carry`` — ``examples/keras_batchnorm.py``'s model built natively
    (Dense 64, ``models.base.BatchNorm``, relu, Dense 64, BatchNorm,
    relu, Dense 4 over 16 features) on its 4096-row blobs under ADAG (4
    workers, batch 32, window 4, 2 epochs), sgd and adam with
    ``mu_dtype=bfloat16``; no kernel of the port may launch. Checked: one
    fold's statistics bit-equal to the mean of the four workers' own
    windows; the card within rtol 1e-4 of the CPU over 2 rounds; a blob
    round trip and a checkpoint resume bit-equal; ``EnsembleTrainer``'s
    members keep distinct statistics.
31. ``elastic_parity`` (after ``observability``) — config #4 at full width
    (DynSGD, sgd lr 0.01, batch 2048, window 4, int8 commits, 3 rounds)
    as an ``ElasticTraining`` job on a one-slot ``FleetScheduler`` and
    through ``run_remote`` with one worker, the same plan and seed, each
    against its own ``PSServer`` on the card: the two centers bit-equal,
    12 stash-forward and 12 backward launches and one ``fold_commit`` a
    commit in each run.
32. ``fleet_card`` — one pool of 4 slots on the card (the reference's
    fleet chaos smoke): ``acme/imdb`` (config #4 as ``ElasticTraining``, up
    to 4 workers, floor 1, 12 items, int8 commits into its PS on the
    card), ``serve/imdb`` (a ``ServingService`` of config #4's model in
    f32, floor 1, up to 2 replicas, a client sending 1, 3, 17 and 64 rows
    the whole run) and ``corp/mlp`` (priority 5, gang 2, an MLP
    ``ElasticTraining``) submitted after acme's 4th commit; once corp
    runs, ``preempt@R:1`` with R one past the fleet's commits. Checked:
    both training jobs done, acme's 12 items committed once each, no
    ``(wid, seq)`` folded twice, no floor violation, acme shrunk and
    re-expanded, the serving tenant never below one replica and its
    refused drain counted, every request answered (or shed with its typed
    error) within ``SERVE_ATOL`` of the CPU forward, ``fold_commit`` = the
    int8 commits applied, stash forward = backward = the local steps run
    (retried windows included), and the telemetry report's fleet rollup
    naming all three tenants.
33. ``sim`` — every scenario of ``distkeras_tpu_torch.sim`` at its default
    size with seed 0, twice (the same bytes, every check passing), and the
    CLI's ``run preemption_storm --json`` once: host only, no kernel.
34. ``streaming_config11`` — BASELINE config #11 (``bench.py``
    ``_measure_streaming``) on the card: a ``StreamingTraining`` job (MLP
    16 hidden on 4 features, 3 classes; 2 workers, ADAG, sgd 0.1, its
    parameter server on the card) on a 2-slot ``FleetScheduler``, fed 90
    records of K=2 x B=16 by a ``StreamProducer`` under
    ``feed_gap@8:0.2;drift@30`` with its connections severed at record 45,
    a ``ModelRegistry`` hot-swapping its checkpoints through the drift
    watch's regression gate (floor 0.5). Checked (the reference's streaming
    chaos smoke, leg 1): the job done with no error, both drills fired, a
    reconnect, the drift paged and cleared with a positive recovery time,
    every ``(wid, seq)`` folded once (90), the journal's committed set
    ``range(90)``, the served step past record 30 with its event
    timestamp, served accuracy on the drifted held-out set above 0.8, the
    report's Streaming section filled, freshness under 60 s, one
    ``fold_commit`` a commit and no other kernel. Printed: items/s, the
    recovery time, freshness p50/p99, swaps and the served accuracy.
35. ``streaming_kill`` — the smoke's leg 2 on config #4 at full width: a
    child process runs a one-worker ``StreamingTraining`` (DynSGD) of 12
    records of K=2 x B=256 against a durable ``python -m
    distkeras_tpu_torch.netps --device cuda`` server (state directory,
    fold journal, started during ``streaming_config11``); ``kill@6``
    SIGKILLs it, a second child resumes. Checked: the first child died of
    SIGKILL, the journal then held ``range(6)``, nothing replayed, the
    stream finished with every record in the journal, the server's journal
    one fold a record and its fold launches (counted in its process) one a
    record, the resumed child's stash forward and backward once a step.
36. ``stream_engine`` — ``AsyncEngine.run_stream`` of config #4 (DynSGD,
    2 workers, window 2, batch 2048) over an endless generator with
    ``max_items=4``: a finite ``[4, 2]`` loss, ``on_item`` seeing 0..3, the
    stash forward and the backward once a local step; then
    ``SyncEngine.run_stream`` of ResNet-50 in bf16 at ``RESNET``'s widths,
    2 items: 53 launches of each GroupNorm kernel a step, bf16 entry points
    only.
37. ``raced`` — ``racelab.run_raced`` of config #4 at full width (DynSGD,
    4 threads, one local loop each, ``overlap_first_round``, the center on
    the card, 6 rounds): the first 4 commits realize staleness 0..3, one
    ``fold_commit`` a commit, the stash forward and the backward once a
    step, the center finite, the last windows' mean loss below the first
    windows'; then one worker, whose center is bit-equal to a plain loop
    applying its window deltas through ``fold_delta`` on the card.
38. ``ranks`` — training across the ranks of a ``torch.distributed``
    group, every rank a child process (``python chip_smoke.py
    --ranks-child``) that the port's ``job_deployment.Job`` launches on
    this host with the rendezvous environment and supervises, each
    rank's launch counts set to 0 just before its run and written at its
    end. ``nccl1``: one rank of an NCCL group trains config #4 as
    ``train`` does (48 stash forwards and 48 backwards; its center
    bit-equal to ``train``'s, a one-rank all-reduce being an identity),
    then config #5 in bf16 at batch 128 for one round of 2 steps (106
    launches of each GroupNorm kernel, bf16 entry points only).
    ``gloo2``: two ranks on the one card over gloo (NCCL refuses two ranks
    on one device; the line says so, and counts the collectives staged
    through the host) train config #4 as 2 ranks x 2 workers: 24 and 24
    launches a rank, the two centers bit-equal, within ``train_parity``'s
    limit of ``train``'s (the 4-term sum in another order). No run on two
    or more cards is made here: the card's machine has one. Each rank then
    trains config #4 again with ``rounds_per_program=3``: on the NCCL group
    one captured graph (the fold's all-reduce and the losses' all-gather
    inside it), on the gloo ranks a host loop; bit-equal to the rank's
    per-round run, the same launches plus one warm-up round a capture.
39. ``blocked`` — the multi-round programs: each part trains twice from
    one seed, one round a program and then R rounds a program (one
    captured CUDA graph a block size), with its launch counts set to 0
    just before each run and read just after, and a profiled repeat of
    each run for the card's busy share: (a) config #1 under "auto" for 28
    rounds (past auto's 16-round head), (b) config #4 in f32 and bf16 at
    R=3 (stash forward and backward in the graph), (c) config #5 in bf16
    at R=2 for 4 rounds with the crop and flip on the card (both
    GroupNorm kernels; the transform's draws staged with each block), (d)
    config #6 on ``parallel``'s one-rank NCCL group at R=2 (flash's three
    kernels; run in that phase's nccl1 child), (e) a small MLP under
    ``nan@2`` at R=4. Checked: every blocked run in graph mode, bit-equal
    to its per-round run (or, (a), (c), (d) only, within
    ``BLOCKED_ATOL``), its launch counts the per-round run's plus its
    warm-up rounds' (one round a capture, on scratch state, counted as
    launches and as warm-up launches), the kernels that the profiler saw
    the card run in each profiled run equal to the launches the wrappers
    counted in it (``DEVICE_FAMILIES``), and (e) skipping exactly round 2.
    ``--blocked-only`` runs (a), (b), (c) and (e) alone.
40. ``analysis`` — dk-check for the port, on this machine (no JAX here),
    (a) and (b) each in a process of its own while (c) runs:
    (a) ``python -m distkeras_tpu_torch.analysis`` over the port, 0
    findings; (b) the interleave suite
    (``distkeras_tpu_torch.analysis.interleave``, ``--interleave-child``)
    with every server's center on the card, scenario by scenario within
    ``INTERLEAVE_BUDGET_S`` (a cut is a whole scenario, and the phase's
    line names those that ran on the card), each at the CPU's counts
    (``INTERLEAVE_COUNTS``) with no violation, its fold launches counted;
    (c) the lock-order witness over a ``PSServer`` on the card holding
    config #4's center, with ``WITNESS_CLIENTS`` racing ``PSClient``s
    committing ``WITNESS_COMMITS`` int8 deltas each: no inversion, the
    witnessed ``server.PSServer`` edges within the port's static lock
    graph, the fold kernel launched once a commit (counts set to 0 just
    before the commits, read just after) and the center bit-equal to the
    numpy oracle folded in the server's commit order.
    ``--analysis-only`` runs it alone.

Then ``seconds`` (each phase's wall time), the ``kernels`` line (the
flash entries with ``moe_launches``, the LSTM and fold entries with
``fleet_launches``; #1 stash, #2 and the fold with ``streaming_launches``,
``raced_launches``, #1 stash, #2 and GroupNorm with
``stream_engine_launches``; #1 stash and #2 with ``ranks_launches``, one
entry a rank, GroupNorm with ``ranks_bf16_launches``; #1 stash and #2
with ``blocked_launches``, GroupNorm and flash with
``blocked_bf16_launches``, each the blocked run's launches, its warm-up
rounds' share of them and the per-round run's; the fold with
``analysis_launches``), the card's name
and power limit, and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
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
import types
import warnings

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
#: ``train``'s samples/s of config #4 by dtype (its widths, no group)
TRAIN_SAMPLES_PER_S: dict = {}
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
#: 2, 64] f32 read 1.22e-5, its largest error 4.5e-4); then the MoE LM's
#: (``moe_train``: MOE_BATCH, MOE_SEQ, 8 heads of 32); then one rank's
#: share of config #6's heads under two-way tensor parallelism (the
#: ``parallel`` phase's parts b and e: 8 of the 16 heads); last the widest
#: tile, DP = 256: config #6 at 4 heads of 256 (``parallel`` part a_hd256),
#: then its edges, the forward's rows past L (136), the ring wrapped (512)
#: and head dims TMA fills with zeros up to the tile (160, 192).
TP_FLASH_SHAPE = (8, LM_SEQ, LM["num_heads"] // 2, 64)
#: config #6 with its 16 heads of 64 replaced by 4 heads of 256 (the same
#: 170,010,624 parameters and attention FLOPs: H x Dh is still 1024)
LM_HD256 = dict(LM, num_heads=4)
HD256_FLASH_SHAPE = (8, LM_SEQ, LM_HD256["num_heads"],
                     LM["d_model"] // LM_HD256["num_heads"])
FLASH_SHAPES = ((8, LM_SEQ, 16, 64), (2, 40, 4, 64), (2, 200, 4, 64),
                (2, 256, 4, 32), (1, LM_SEQ, 1, 64), (4, 72, 4, 64),
                (2, 136, 4, 128), (2, 1024, 1, 64), (1, 512, 2, 128),
                (2, 512, 2, 40), (8, 512, 8, 32), TP_FLASH_SHAPE,
                HD256_FLASH_SHAPE, (2, 136, 4, 256), (1, 512, 2, 256),
                (2, 200, 4, 160), (4, 72, 4, 192))
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
#: #7's and its tensor-parallel share (over 10^5 rows each, which the mean
#: limit holds), and three with few rows (B*L*H 272, 144 and 272) where one
#: flip of p or ds can alone pass the mean limit, so that only this
#: measure, which rows cannot dilute, holds them. Config #6's at heads of
#: 256 is kept: at D = 256 a flip moves more of a row, and there the f32
#: dK/dV's mean error reads near the mean limit (9.55e-6 of 1e-5 on an
#: H100), so its rows are attributed too.
FLASH_FLIP_SHAPES = tuple(s for s in FLASH_SHAPES
                          if s not in (FLASH_SHAPES[0], TP_FLASH_SHAPE)) \
    + ((1, 136, 2, 128), (1, 72, 2, 64), (1, 136, 2, 256))
#: the flash kernel instantiations of csrc/flash_attn.cu: forward, dQ and
#: dK/dV, f32 and bf16 outputs, at DP = 32, 64, 128 and 256.
FLASH_KERNELS = 3 * 2 * 4
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
#: the same run at heads of 256 (2 layers, d_model 512, 2 heads of 256),
#: the DP = 256 kernels. Its center and its bf16 run keep LM_PARITY's
#: shares; its logits are held to half (not a quarter) of the CPU's
#: flash-vs-dense distance: at d_model 512 an f32-level difference in the
#: q, k and v projections (the card's other sum order) moves some of their
#: bf16 roundings, and with each a whole row or column of scores, which
#: the quarter (set at d_model 128, where such moves are rare) does not
#: allow for. The CPU alone reads 0.34 of that distance between its f32
#: run and one with the ops outside the kernel in float64 (the row prints
#: it beside), and an H100 against it 0.33.
LM_PARITY_HD256 = dict(LM_PARITY, d_model=512, num_heads=2)
LM_PARITY_HD256_LOGITS_SHARE = 0.5

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
    With ``timed = (module, {wrapper name: key})`` (or a list of such
    pairs) it also sums CUDA events around every call of each named
    function of ``module`` inside the step (``key`` in the result, and its
    calls a step under ``calls``). ``dtype`` (bf16) is the
    mixed-precision step: the f32 leaves and a float ``x`` cast inside the
    forward, as the local loop does. Events read when the card reaches them, so where the host
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
    pairs = ([] if timed is None else [timed] if isinstance(timed, tuple)
             else list(timed))
    spans = {key: [] for _, names in pairs for key in names.values()}
    patched = []
    if pairs:
        def wrap(fn, key):
            def call(*args, **kwargs):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = fn(*args, **kwargs)
                ev[1].record()
                spans[key].append(ev)
                return out
            return call

        for kmod, names in pairs:
            for name, key in names.items():
                patched.append((kmod, name, getattr(kmod, name)))
                setattr(kmod, name, wrap(patched[-1][2], key))
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
        for kmod, name, fn in patched:
            setattr(kmod, name, fn)
    parts["step"] = sum(parts.values())
    if head_start:
        parts["host_ms"] = parts_host_ms
    if pairs:
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

    widths_given = widths
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
    if widths_given is None:
        TRAIN_SAMPLES_PER_S[dtype] = steps * B / wall
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


def serve_phase(torch, K, model, cpu_model, rng, gpu: str) -> tuple:
    """Serve through the port's entry points, then run the serving chaos
    drill on the same frontend (:func:`serve_drill`); return the LSTM
    launches of the main run and the drill's."""
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
        # the main path's numbers, read before the drill adds its own
        counts = K.launch_counts()
        snap = telemetry.get().snapshot()
        drill = serve_drill(torch, K, frontend, cpu_model)
    finally:
        frontend.close()
        registry.close()
    launches = counts["lstm_fwd"]
    counters = snap["counters"]
    batches = int(counters.get("serving.batches", 0))
    retrace = int(counters.get("serving.retrace_after_warmup", 0))
    depth = snap["gauges"].get("serving.queue_depth", {})
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
                     f"{clients} concurrent clients mixed",
          "chaos_drill": drill})
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
    return launches, drill["launches"]["lstm_fwd"]


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


# Config #5 fed from a uint8 shard store, the reference's
# examples/imagenet_disk.py: RESNET's trainer in bf16 for RESNET_ROUNDS
# rounds over 768 rows of 224x224x3 uint8 (115.6 MB) in shards of 128 rows,
# so each round's 2 x 128 rows span two shards.
FEED_ROWS = RESNET_ROUNDS * RESNET["steps_per_program"] * RESNET["batch_size"]
FEED_ROWS_PER_SHARD = 128
FEED_DTYPE = "bfloat16"
#: the augmentation on the card: one 256-row batch (a round's rows)
FEED_AUG_BATCH = 256
FEED_AUG_REPS = 20
#: the gather of one round from the store, native against numpy, in turns
FEED_GATHER_READS = 5
#: config #3's data-paced pair: native gather against DKTPU_NO_NATIVE=1,
#: after one warm run, in the order A B B A
FEED_PAIR_ORDER = ("native", "numpy", "numpy", "native")
#: the sharded predictor: chunk rows, and the limit against the in-RAM
#: predict of the same rows (tests/test_torch_workflow.py's f32 atol)
FEED_PREDICT_CHUNK = 256
FEED_PREDICT_ATOL = 1e-5


def host_augment(feats, labels, rng):
    """``examples/imagenet_disk.py``'s ``augment``, copied (this script
    imports nothing of the JAX package): per-image random horizontal flip
    and random crop from the 4-pixel reflect-padded image, on the host, a
    ``Trainer(transform=...)``."""
    n, h, w, _ = feats.shape
    out = np.where(
        (rng.random(n) < 0.5)[:, None, None, None], feats[:, :, ::-1], feats)
    pad = 4
    padded = np.pad(out, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    mode="reflect")
    ys = rng.integers(0, 2 * pad + 1, size=n)
    xs = rng.integers(0, 2 * pad + 1, size=n)
    windows = np.lib.stride_tricks.sliding_window_view(
        padded, (h, w), axis=(1, 2))
    out = windows[np.arange(n), ys, xs].transpose(0, 2, 3, 1)
    return np.ascontiguousarray(out), labels


def native_counters(snap: dict) -> dict:
    c = snap["counters"]
    return {k: c.get(f"native.{k}", 0.0)
            for k in ("gather_calls", "gather_bytes",
                      "gather_fallback_calls")}


def feed_store(gpu: str, seed: int, workdir: str):
    """(a) The store: ``FEED_ROWS`` random uint8 images and labels written
    through ``ShardWriter``; round 0 of the sharded plan bit-equal to the
    in-RAM plan's. Returns ``(sdf, ram frame, x, y)``."""
    from distkeras_tpu_torch import ShardedDataFrame, ShardWriter
    from distkeras_tpu_torch.data import DataFrame, make_batches

    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(FEED_ROWS, 224, 224, 3), dtype=np.uint8)
    y = rng.integers(0, 1000, size=FEED_ROWS).astype(np.int32)
    root = os.path.join(workdir, "store")
    t0 = time.perf_counter()
    with ShardWriter(root, rows_per_shard=FEED_ROWS_PER_SHARD) as w:
        for lo in range(0, FEED_ROWS, FEED_ROWS_PER_SHARD):
            w.append(features=x[lo:lo + FEED_ROWS_PER_SHARD],
                     label=y[lo:lo + FEED_ROWS_PER_SHARD])
    write_s = time.perf_counter() - t0
    sdf = ShardedDataFrame(root)
    ram = DataFrame({"features": x, "label": y})
    B, Kw = RESNET["batch_size"], RESNET["steps_per_program"]
    splan = make_batches(sdf, "features", "label", B, 1, window=Kw)
    rplan = make_batches(ram, "features", "label", B, 1, window=Kw)
    (sx, sy), (rx, ry) = splan.round(0), rplan.round(0)
    equal = bool(np.array_equal(sx, rx) and np.array_equal(sy, ry))
    emit({"phase": "sharded_feed", "part": "store", "gpu": gpu,
          "rows": FEED_ROWS, "row_bytes": int(x[0].nbytes),
          "store_mb": x.nbytes / 1e6, "rows_per_shard": FEED_ROWS_PER_SHARD,
          "shards": sdf.store.num_shards, "write_s": write_s,
          "plan": type(splan).__name__, "round_rows": int(sx.shape[0]
                                                          * sx.shape[1]
                                                          * sx.shape[2]),
          "round0_shards": sdf.store.shards_for_rows(0, Kw * B),
          "round0_bit_equal_to_ram": equal})
    if type(splan).__name__ != "ShardedBatchPlan" or not equal:
        fail(f"the shard store's round 0 ({type(splan).__name__}) is not "
             f"bit-equal to the in-RAM plan's")
    return sdf, ram, x, y


def feed_arm(torch, G, gpu: str, seed: int, arm: str, frame,
             extra: dict) -> tuple:
    """(b) One arm: ``SynchronousDistributedTrainer(resnet50(norm_impl=
    "pallas"))`` in bf16 trained on ``frame`` as a user would, the
    GroupNorm counts set to 0 just before and read just after; then the
    staging of each round timed alone over the same plan. Returns
    ``(trained, launches)``."""
    from distkeras_tpu_torch import SynchronousDistributedTrainer, resnet50
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.data import make_batches

    B, Kw = RESNET["batch_size"], RESNET["steps_per_program"]
    steps = RESNET_ROUNDS * Kw
    model = resnet50(norm_impl="pallas", seed=seed, device="cuda")
    trainer = SynchronousDistributedTrainer(
        model, "sgd", "sparse_categorical_crossentropy", **RESNET,
        compute_dtype=FEED_DTYPE, **extra)
    telemetry.reset()
    torch.cuda.synchronize()
    G.reset_launches()  # counts start at 0 just before the main path runs
    t0 = time.perf_counter()
    trained = trainer.train(frame)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = G.launch_counts()
    entries = G.launch_counts(by_entry=True)
    snap = telemetry.get().snapshot()
    hist = trainer.get_history()
    moved = max((trained.params[k] - v).abs().max().item()
                for k, v in model.params.items())
    plan = make_batches(frame, "features", "label", B, 1, window=Kw,
                        transform=extra.get("transform"))
    stage_ms = []
    for r in range(plan.num_rounds):
        t0 = time.perf_counter()
        plan.round(r)
        stage_ms.append((time.perf_counter() - t0) * 1e3)
    native = native_counters(snap)
    emit({"phase": "sharded_feed", "part": "train", "arm": arm, "gpu": gpu,
          "trainer": "SynchronousDistributedTrainer",
          "model": "resnet50(norm_impl='pallas')", "rounds": RESNET_ROUNDS,
          **RESNET, "dtype": FEED_DTYPE,
          "frame": type(frame).__name__,
          "augment": ("device_transform=flip_crop_transform()"
                      if "device_transform" in extra else
                      "transform=host_augment" if "transform" in extra
                      else None),
          "seconds": wall, "samples_per_s": steps * B / wall,
          "ms_per_local_step": wall / steps * 1e3,
          "input_stall_s": snap["counters"].get("input_stall_seconds"),
          "stage_ms_per_round": float(np.mean(stage_ms)),
          "stage_ms": stage_ms,
          "stage": "plan.round(r) on the host alone, after the run: the "
                   "gather (and the host transform, in the host arm); the "
                   "store's pages warm",
          **{f"native_{k}": v for k, v in native.items()},
          "launches": launches, "launches_by_entry": entries,
          "local_steps": steps, "gn_per_step": GN_PER_STEP,
          "history": [float(v) for v in hist],
          "center_max_abs_change": moved})
    if not np.all(np.isfinite(hist)):
        fail(f"sharded_feed {arm}: non-finite loss {hist}")
    if not moved > 0:
        fail(f"sharded_feed {arm}: the trained ResNet-50 equals its init")
    want = GN_PER_STEP * steps
    if launches != {"group_norm_fwd": want, "group_norm_bwd": want}:
        fail(f"sharded_feed {arm}: GroupNorm launches {launches} in {steps} "
             f"local steps; want {GN_PER_STEP} of each a step ({want})")
    only_dtype(f"sharded_feed {arm} ResNet-50", entries, FEED_DTYPE)
    if native["gather_fallback_calls"] or not native["gather_calls"]:
        fail(f"sharded_feed {arm}: the rounds were not all gathered "
             f"natively: {native}")
    del model, trainer
    return trained, launches


def feed_augment(torch, gpu: str, seed: int, x) -> dict:
    """(c) ``flip_crop`` on a ``FEED_AUG_BATCH``-row uint8 batch on the
    card, bit-equal to the CPU's on the same batch and draws; its CUDA-event
    ms beside its bound (the batch read and written once) and the host
    times of the CPU ``flip_crop`` and of ``host_augment``."""
    from distkeras_tpu_torch.ops.augment import flip_crop

    pad = 4
    cpu = torch.from_numpy(np.ascontiguousarray(x[:FEED_AUG_BATCH]))
    gen = torch.Generator().manual_seed(seed)
    flip = torch.rand(FEED_AUG_BATCH, generator=gen) < 0.5
    ys = torch.randint(0, 2 * pad + 1, (FEED_AUG_BATCH,), generator=gen)
    xs = torch.randint(0, 2 * pad + 1, (FEED_AUG_BATCH,), generator=gen)
    card = cpu.cuda()
    got = flip_crop(card, flip, ys, xs, pad)
    t0 = time.perf_counter()
    want = flip_crop(cpu, flip, ys, xs, pad)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    equal = bool(torch.equal(got.cpu(), want))
    draws = tuple(t.cuda() for t in (flip, ys, xs))
    ms = cuda_ms(torch, lambda: flip_crop(card, *draws, pad), FEED_AUG_REPS)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    host_augment(x[:FEED_AUG_BATCH], None, rng)
    host_ms = (time.perf_counter() - t0) * 1e3
    bound_ms, bound_by = bound(2 * cpu.numel(), 0, PEAK_BF16_FLOPS)
    row = {"phase": "sharded_feed", "part": "augment", "gpu": gpu,
           "shape": list(cpu.shape), "dtype": "uint8", "pad": pad,
           "bit_equal_to_cpu": equal, "ms": ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "cpu_flip_crop_ms": cpu_ms,
           "host_augment_ms": host_ms,
           "timing": f"CUDA events, mean of {FEED_AUG_REPS} after a warm "
                     "call, the draws already on the card; the host times "
                     "one call each"}
    emit(row)
    if not equal:
        fail("flip_crop on the card differs from the CPU's")
    return row


def feed_gather(gpu: str, sdf, x) -> dict:
    """(d) One round from the store (``2 x 128`` rows) through
    ``ShardStore.gather``, native against numpy (``DKTPU_NO_NATIVE=1``), in
    turns, and the same for the in-RAM array: host ms, medians of
    ``FEED_GATHER_READS``, bit-equal."""
    B, Kw = RESNET["batch_size"], RESNET["steps_per_program"]
    idx = np.arange(Kw * B).reshape(1, Kw, B)
    times = {k: [] for k in ("store_native", "store_numpy", "ram_native",
                             "ram_numpy")}
    outs = {}
    from distkeras_tpu_torch.data.native_loader import gather_rows

    for _ in range(FEED_GATHER_READS):
        for how in ("native", "numpy"):
            with contextlib.ExitStack() as stack:
                if how == "numpy":
                    stack.enter_context(env_set(DKTPU_NO_NATIVE="1"))
                for where, fn in (
                        ("store", lambda: sdf.store.gather("features", idx)),
                        ("ram", lambda: gather_rows(x, idx))):
                    t0 = time.perf_counter()
                    outs[f"{where}_{how}"] = fn()
                    times[f"{where}_{how}"].append(
                        (time.perf_counter() - t0) * 1e3)
    equal = all(np.array_equal(outs[k], x[idx]) for k in outs)
    med = {f"{k}_ms": float(np.median(v)) for k, v in times.items()}
    row = {"phase": "sharded_feed", "part": "gather", "gpu": gpu,
           "rows": int(idx.size), "mb": idx.size * x[0].nbytes / 1e6,
           **med, "readings_ms": times, "bit_equal": equal,
           "store_numpy_over_native": med["store_numpy_ms"]
           / med["store_native_ms"],
           "ram_numpy_over_native": med["ram_numpy_ms"]
           / med["ram_native_ms"],
           "timing": f"host clock, median of {FEED_GATHER_READS} in turns; "
                     "the store's pages warm (just written)"}
    emit(row)
    if not equal:
        fail("the native gather differs from numpy's fancy indexing")
    return row


def feed_pairs(torch, gpu: str, seed: int) -> dict:
    """(e) Config #3 (``AEASGD(cifar10_cnn())``, ``CNN_TRAIN``'s widths,
    bf16, ``CNN_ROUNDS`` rounds) from the in-RAM frame, with the native
    gather and with ``DKTPU_NO_NATIVE=1``, after a warm run, in the order
    ``FEED_PAIR_ORDER``: samples/s and ``input_stall_seconds`` of each."""
    from distkeras_tpu_torch import telemetry, trainers
    from distkeras_tpu_torch.datasets import cifar10
    from distkeras_tpu_torch.models import cifar10_cnn

    name, trainer_name, kw = CNN_TRAIN[1]
    n = CNN_ROUNDS * kw["num_workers"] * kw["communication_window"] \
        * kw["batch_size"]
    frame = cifar10(n=n, seed=seed)
    runs = []
    for how in ("warm",) + FEED_PAIR_ORDER:
        model = cifar10_cnn(seed=seed, device="cuda")
        trainer = getattr(trainers, trainer_name)(
            model, loss="sparse_categorical_crossentropy",
            compute_dtype=FEED_DTYPE, **kw)
        with contextlib.ExitStack() as stack:
            if how == "numpy":
                stack.enter_context(env_set(DKTPU_NO_NATIVE="1"))
            telemetry.reset()
            torch.cuda.synchronize()
            reset_all_launches()
            t0 = time.perf_counter()
            trainer.train(frame)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        snap = telemetry.get().snapshot()
        hist = trainer.get_history()
        if not np.all(np.isfinite(hist)):
            fail(f"sharded_feed pairs ({how}): non-finite loss {hist}")
        check_no_kernel(f"sharded_feed pairs ({how})")
        native = native_counters(snap)
        if how == "numpy" and native["gather_calls"]:
            fail(f"DKTPU_NO_NATIVE=1 still gathered natively: {native}")
        if how != "numpy" and native["gather_fallback_calls"]:
            fail(f"the native gather fell back to numpy: {native}")
        runs.append({"gather": how, "seconds": wall,
                     "samples_per_s": n / wall,
                     "input_stall_s": snap["counters"].get(
                         "input_stall_seconds"), **native})
        del model, trainer
    timed = runs[1:]
    rate = {how: [r["samples_per_s"] for r in timed if r["gather"] == how]
            for how in ("native", "numpy")}
    row = {"phase": "sharded_feed", "part": "data_paced_pair", "gpu": gpu,
           "config": 3, "model": f"{name}()", "trainer": trainer_name,
           "dtype": FEED_DTYPE, "rounds": CNN_ROUNDS, **kw,
           "round_mb": kw["num_workers"] * kw["communication_window"]
           * kw["batch_size"] * frame["features"][0].nbytes / 1e6,
           "runs": runs,
           "native_over_numpy": float(np.mean(rate["native"])
                                      / np.mean(rate["numpy"]))}
    emit(row)
    return row


def feed_predict(torch, gpu: str, sdf, ram, trained, root: str) -> dict:
    """(f) ``ModelPredictor(trained).predict(sdf)`` over the store on the
    card against the in-RAM predict of the same rows; ``AccuracyEvaluator``
    on the sharded frame against the same column in RAM; a second predict
    versions the column and ``vacuum`` reclaims the first."""
    from distkeras_tpu_torch import AccuracyEvaluator, ModelPredictor
    from distkeras_tpu_torch.data import DataFrame
    from distkeras_tpu_torch.data.shards import _shard_file
    from distkeras_tpu_torch.predictors import vacuum

    pred = ModelPredictor(trained, chunk_size=FEED_PREDICT_CHUNK)
    t0 = time.perf_counter()
    out = pred.predict(sdf)
    predict_s = time.perf_counter() - t0
    col = np.concatenate([c["prediction"] for c in
                          out.iter_column_chunks("prediction")])
    ref = pred.predict(ram)["prediction"]
    err = float(np.abs(col - ref).max())
    acc = AccuracyEvaluator().evaluate(out)
    acc_ram = AccuracyEvaluator().evaluate(
        DataFrame({"prediction": col, "label": ram["label"]}))
    out2 = pred.predict(out)
    spec = dict(out2.store.columns["prediction"])
    garbage = out2.store.manifest.get("garbage")
    shards = out2.store.num_shards
    old = [os.path.join(root, _shard_file(s, "prediction"))
           for s in range(shards)]
    kept = all(os.path.exists(p) for p in old)
    removed = vacuum(root)
    gone = not any(os.path.exists(p) for p in old)
    again = np.concatenate([c["prediction"] for c in
                            out2.iter_column_chunks("prediction")])
    row = {"phase": "sharded_feed", "part": "predict", "gpu": gpu,
           "rows": len(col), "chunk_size": FEED_PREDICT_CHUNK,
           "seconds": predict_s, "rows_per_s": len(col) / predict_s,
           "max_abs_err_vs_ram": err, "atol": FEED_PREDICT_ATOL,
           "accuracy_sharded": acc, "accuracy_ram": acc_ram,
           "second_column": spec, "garbage": garbage,
           "old_files_kept_until_vacuum": kept, "vacuum_removed": removed,
           "old_files_gone": gone,
           "second_equals_first": bool(np.array_equal(again, col))}
    emit(row)
    if not err <= FEED_PREDICT_ATOL:
        fail(f"the sharded predict strays from the in-RAM one: {err}")
    if acc != acc_ram:
        fail(f"AccuracyEvaluator on the sharded frame {acc} != {acc_ram}")
    if not (spec.get("file", "").startswith("prediction.")
            and garbage == ["prediction"] and kept and removed == shards
            and gone and row["second_equals_first"]):
        fail(f"the second predict or vacuum misbehaved: {row}")
    return row


def sharded_feed_phase(torch, G, gpu: str, seed: int, workdir: str) -> dict:
    """Config #5 trained from a uint8 shard store as the reference's
    ``examples/imagenet_disk.py`` does, (a)-(f); returns the GroupNorm
    launches of each arm of (b)."""
    sdf, ram, x, y = feed_store(gpu, seed, workdir)
    from distkeras_tpu_torch.ops.augment import flip_crop_transform

    launches, trained = {}, None
    for arm, frame, extra in (
            ("device", sdf, {"device_transform": flip_crop_transform()}),
            ("host", sdf, {"transform": host_augment}),
            ("ram", ram, {})):
        model, launches[arm] = feed_arm(torch, G, gpu, seed, arm, frame,
                                        extra)
        if arm == "device":
            trained = model
        del model
        torch.cuda.empty_cache()
    feed_augment(torch, gpu, seed, x)
    feed_gather(gpu, sdf, x)
    feed_pairs(torch, gpu, seed)
    torch.cuda.empty_cache()
    feed_predict(torch, gpu, sdf, ram, trained, sdf.store.path)
    del trained
    return launches


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
    return dict(fold, samples_per_s=steps * B / wall)


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
               workers: int = None, **env) -> dict:
    """One ``DynSGD(imdb_lstm(...), remote=endpoint)`` run at config #4's
    width and :data:`REMOTE`'s workers (or ``workers``), window and batch,
    int8 commits and ``env`` set; the launch counts are set to 0 just
    before ``train`` and read just after. Returns the run's numbers and
    trainer."""
    from distkeras_tpu_torch import imdb_lstm, telemetry
    from distkeras_tpu_torch.trainers import DynSGD

    kw = dict(REMOTE, num_workers=workers or REMOTE["num_workers"])
    W, Kw, B = (kw["num_workers"], kw["communication_window"],
                kw["batch_size"])
    model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                      seq_len=SEQ_LEN, seed=seed, device="cuda")
    with env_set(DKTPU_NET_COMPRESS="int8", **env):
        trainer = DynSGD(model, worker_optimizer="sgd",
                         loss="sparse_categorical_crossentropy",
                         remote=endpoint, **kw)
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


@contextlib.contextmanager
def acked_commits():
    """Record, as ``(worker, seq)``, every commit a port client saw
    acknowledged (applied, or answered as a duplicate) in the block."""
    from distkeras_tpu_torch.netps import PSClient

    acked = set()
    real_commit = PSClient.commit

    def commit(self, delta, pulled_counter):
        seq = self._seq + 1
        res = real_commit(self, delta, pulled_counter)
        if res.applied or res.duplicate:
            acked.add((self.worker_id, seq))
        return res

    PSClient.commit = commit
    try:
        yield acked
    finally:
        PSClient.commit = real_commit


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
    before. ``ps_restart_phase`` reads its ``NETPS_READY`` line. Its
    environment schedules ``ps_crash@RESTART_KILL_AT`` with a fired-fault
    journal (``DKTPU_FAULTS_STATE``) beside the state directory, so the
    server kills itself once and its restarted life does not."""
    d = os.path.join(workdir, "ps_restart")
    shutil.rmtree(d, ignore_errors=True)
    fired = os.path.join(workdir, "ps_restart.fired")
    if os.path.exists(fired):
        os.remove(fired)
    env = dict(os.environ, DKTPU_NET_FAULTS=f"ps_crash@{RESTART_KILL_AT}",
               DKTPU_FAULTS_STATE=fired)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    cmd = [sys.executable, "-m", "distkeras_tpu_torch.netps", "--host",
           "127.0.0.1", "--port", str(port), "--discipline", "dynsgd",
           "--device", "cuda", "--state-dir", d, "--snapshot-every", "0"]
    return {"dir": d, "endpoint": f"127.0.0.1:{port}", "cmd": cmd,
            "env": env, "fired": fired,
            "lives": [(time.monotonic(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        text=True, env=env))]}


def ps_restart_phase(torch, K, F, gpu: str, seed: int, cli: dict) -> dict:
    """The port's CLI server (``python -m distkeras_tpu_torch.netps
    --device cuda --state-dir D --snapshot-every 0``: the journal alone,
    never pruned, so it holds both lives) in a subprocess, which its own
    ``ps_crash@RESTART_KILL_AT`` SIGKILLs mid-run (the reference's
    kill-the-primary drill) and which is restarted on the same port,
    directory and fault journal while config #4 trains against it; the
    workers ride through on retries. Returns the ``fold_commit`` launches
    of this process's replay of the final directory."""
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

    killed = {}

    def babysitter():
        """Restart the server once it has killed itself (a supervisor's
        role; the crash is the server's own fault plan)."""
        first = lives[0][1]
        while not killed.get("cancel") and first.poll() is None:
            time.sleep(0.02)
        if first.poll() is None:
            return
        killed["at"] = time.monotonic()
        killed["returncode"] = first.returncode
        lives.append((killed["at"], subprocess.Popen(
            cli["cmd"], stdout=subprocess.PIPE, text=True, env=cli["env"])))
        killed["restart_s"] = ready()

    with acked_commits() as acked:
        try:
            first_start = ready()
            watcher = threading.Thread(target=babysitter,
                                       name="ps-restart-babysitter")
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
            for _t0, proc in lives:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    records = state.read_journal(d)
    journaled = [(int(r["wid"]), int(r["seq"])) for r in records]
    lost = sorted(acked - set(journaled))
    with open(cli["fired"]) as f:
        fired = f.read().split()
    os.remove(cli["fired"])
    rec = recover_on_card(torch, F, d)
    row = {"phase": "ps_restart", "gpu": gpu, "rounds": RESTART_ROUNDS,
           **REMOTE, "codec": "int8",
           "faults": f"ps_crash@{RESTART_KILL_AT}",
           "first_life_returncode": killed.get("returncode"),
           "fired_journal": fired,
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
    if (len(lives) != 2 or "restart_s" not in killed
            or killed["returncode"] != -signal.SIGKILL
            or fired != [f"ps_crash@{RESTART_KILL_AT}"]):
        fail(f"ps_restart: the server did not kill itself once and "
             f"restart: {row}")
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
#: 8 rounds a run, cut from the bench's 12 for the script's time limit.
C8_SEQ, C8_BATCH, C8_WINDOW, C8_ROUNDS = 128, 4, 2, 8
C8_ALPHA, C8_LR = 0.05, 1e-4
#: timed runs of each arm after one warm run (the median is reported).
C8_TIMED = 2
#: the warm run's rounds: enough to attach every lane and launch every
#: kernel of the arm once, at a quarter of a timed run's time.
C8_WARM_ROUNDS = 2
#: the span suffix of each dialect: TCP bare, then the ring and the mesh.
C8_DIALECTS = ("", ".shm", ".mesh")
#: the demotion drill: ``mesh_down@C8_DEMOTE_AT`` fails commit seq 4's
#: dispatch as a lost device would (the reference's drill).
C8_DEMOTE_AT = 4
#: the traced shot (``bench.py:769-815``): one extra ``pr4`` run after the
#: timed arms with ``DKTPU_TRACE=1`` into a trace directory of its own; the
#: simulator fits its timing model from that stream and replays the run
#: (``sim.calibrate.sim_drift``). A ratio outside ``DKTPU_SIM_BAND_PCT``
#: is a finding the line reports, as the reference only records it; a
#: null ratio (the calibration read nothing) fails the phase.
C8_TRACE_DIR = os.path.join("build", "c8_trace")
#: the ``auto`` arm (``bench.py:672-687``): the ring and the tuner from a
#: cold start, no other data-plane knob; the ring's rule must hold it at
#: codec ``none`` and one stripe.
C8_AUTO = dict(transport="shm", autotune=True)
C8_AUTO_RULE = {"codec": "none", "shards": 1, "transport": "shm"}
#: the TCP cold start: the tuner's probe sweep at join over TCP, and the
#: control loop evaluating every ``C8_TUNE_INTERVAL`` rounds mid-run.
C8_COLD = dict(transport="tcp", autotune=True)
C8_TUNE_INTERVAL = 3
#: the mid-run restripe: seeded int8 commits, the client retuned from 1
#: to 2 stripes before commit ``C8_RESTRIPE_AT``.
C8_RESTRIPE_COMMITS, C8_RESTRIPE_AT = 4, 2
#: the ``hier_curve`` arm (``bench.py:689-733``): flat against a per-host
#: aggregator at 1, 2 and 4 workers over the ring, inflight 1, one stripe,
#: f32 commits, a flush at most every 0.5 s; ``max(4, rounds // 2)``
#: rounds a point, one timed run a point after the arm's warm run.
C8_CURVE_WORKERS = (1, 2, 4)
C8_CURVE_ROUNDS = max(4, C8_ROUNDS // 2)
C8_HIER_FLUSH = 0.5
#: the ``optimized`` arm's plane (``bench.py:599``): TCP, two commits in
#: flight, two stripes, int8; ``durable`` is the same with a journal.
C8_OPTIMIZED = dict(transport="tcp", inflight=2, shards=2, compress="int8")
#: ABBA pairs of (durable, baseline) ``optimized`` runs. The reference runs
#: ``max(reps + 2, 10)`` pairs; the port runs 2, for the time limit.
C8_DURABLE_PAIRS = 2
#: config #8 against a 2-shard center: the token embedding (8192 x 512)
#: row-split over both shards, so the split path runs on the card.
C8_SHARD_RULES = "tok_embed=split"


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
           inflight: int = 1, *, transport: str = None, shards: int = 1,
           compress: str = "none", state_dir: str = None,
           shard_count: int = 0, autotune: bool = False) -> dict:
    """One run of arm ``arm`` from the model's weights: ``inprocess`` is
    ``AEASGD(...).train(df)`` in process (the engine's elastic fold); the
    others ``run_remote`` against a fresh ``PSServer(device="cuda")`` of
    ``transport`` (default: the arm's name; ``pr4`` is TCP), one worker,
    ``shards`` stripes and ``compress`` commits. With ``state_dir`` the
    server is seeded with the model's weights and journals there (the
    base snapshot is written before the clock starts); with
    ``shard_count`` it is a ``ShardSet`` of that many shards. With
    ``autotune`` the tuner is aboard from a cold start: no window, stripe
    count or codec is passed, and the run's ``inflight``/``shards``/
    ``compress`` are what its ``tuner_run_summary`` event says it
    converged to (``tuner`` holds that event, every ``tuner_decision`` and
    every ``tuner_probe``). The launch counts are set to 0 just before and
    read just after; ``probe_launches`` is the server's ``netps.probes``
    (one ``fold_commit`` launch a probe)."""
    from distkeras_tpu_torch import AEASGD, telemetry
    from distkeras_tpu_torch.netps import PSServer, ShardSet, state
    from distkeras_tpu_torch.netps.remote import run_remote
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import adam

    transport = transport or {"pr4": "tcp"}.get(arm, arm)
    srv = None
    servers = []
    telemetry.reset()
    if arm != "inprocess" and shard_count:
        srv = ShardSet(shard_count, discipline="aeasgd", device="cuda",
                       transport=transport).start()
        servers = srv.servers
    elif arm != "inprocess":
        seed = ([v.detach().float().cpu().numpy()
                 for v in model.params.values()] if state_dir else None)
        srv = PSServer(center=seed, discipline="aeasgd", device="cuda",
                       transport=transport, state_dir=state_dir).start()
        servers = [srv]
    try:
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
            knobs = (dict(inflight=None, shards=None, compress=None)
                     if autotune else dict(inflight=inflight, shards=shards,
                                           compress=compress))
            params, losses = run_remote(
                endpoint=srv.endpoint, model=model, tx=adam(C8_LR),
                loss_fn=get_loss("sparse_categorical_crossentropy"),
                plan=plan, discipline="aeasgd", window=C8_WINDOW,
                alpha=C8_ALPHA, seed=0, transport=transport,
                autotune=autotune, loop_fn=loop, **knobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fold, flash = F.launch_counts(), FA.launch_counts()
        flash_entries = FA.launch_counts(by_entry=True)
        logs = [list(x.commit_log) for x in servers]
        center = srv.center() if srv is not None else None
        shard_plan = srv.plan if shard_count else None
        pending = sum(len(x._pending) for x in servers)
    finally:
        if srv is not None:
            srv.close()
    journal = ([(int(r["wid"]), int(r["seq"]))
                for r in state.read_journal(state_dir)] if state_dir else None)
    snap = telemetry.get().snapshot()
    counters = snap["counters"]
    tuner = None
    if autotune:
        events = telemetry.get().events()
        summary = [e for e in events if e["kind"] == "tuner_run_summary"]
        tuner = {"summary": {k: summary[-1].get(k) for k in (
                     "inflight", "codec", "shards", "transport", "decisions",
                     "retunes", "fallbacks", "deferred")}
                 if summary else None,
                 "decisions": [{k: e.get(k) for k in (
                     "knob", "from", "to", "trigger", "round")}
                     for e in events if e["kind"] == "tuner_decision"],
                 "probes": [{k: e.get(k) for k in (
                     "codec", "probes", "seconds", "score")}
                     for e in events if e["kind"] == "tuner_probe"]}
        if summary:
            inflight = summary[-1]["inflight"]
            shards = summary[-1]["shards"] or 1
            compress = summary[-1]["codec"]
    dialect = {"tcp": ""}.get(transport, "." + transport)
    spans = {name: span_stats(snap, name) for name in (
        ["netps.remote.local_window"]
        + [f"netps.{side}.pull{dialect}" for side in ("rpc", "server")]
        + [f"netps.{side}.commit{d}" for side in ("rpc", "server")
           for d in C8_DIALECTS]
        + [f"netps.rpc.commit.s{k}{dialect}"
           for k in range(max(shards, 2 if autotune else 1))]
        if srv is not None else [])}
    return {"arm": arm, "transport": transport, "inflight": inflight,
            "shards": shards, "compress": compress,
            "servers": len(servers), "dialect": dialect,
            "rounds": plan.num_rounds,
            "seconds": wall, "tokens_per_s": tokens / wall,
            "params": params, "center": center, "losses": losses,
            "log": logs[0] if logs else [], "logs": logs,
            "plan": shard_plan, "pending": pending, "journal": journal,
            "fold": fold, "flash": flash,
            "flash_entries": flash_entries, "spans": spans,
            "tuner": tuner,
            "probe_launches": int(counters.get("netps.probes", 0)),
            "counters": {k: counters.get(k, 0) for k in (
                "netps.shm_upgrades", "netps.mesh.upgrades",
                "netps.mesh.folds", "netps.mesh.demotions",
                "netps.shm_fallbacks", "netps.bytes_sent",
                "netps.reconnects", "netps.probes",
                "netps.pull_torn_retries")}}


@contextlib.contextmanager
def recorded_aggregators():
    """Yield a list that every ``AggregatorServer`` built in the block
    appends itself to (``run_remote`` builds its own), so a caller can
    read the aggregator's ledger and evidence after the run."""
    from distkeras_tpu_torch.netps import hier

    made, real = [], hier.AggregatorServer

    class Recorded(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    hier.AggregatorServer = Recorded
    try:
        yield made
    finally:
        hier.AggregatorServer = real


def c8_hier_point(torch, F, FA, model, loop, workers: int, topo: str,
                  seed: int, rounds: int) -> dict:
    """One point of the ``hier_curve`` arm, as ``bench.py:705-733`` runs
    it: ``run_remote`` of ``workers`` threads against a fresh
    ``PSServer(device="cuda", transport="shm")``, ``hier`` on for
    ``topo="hier"`` (the aggregator on the card, flushing at most every
    ``C8_HIER_FLUSH`` s), inflight 1, one stripe, f32 commits; the shared
    local loop at one worker (a loop serves one thread), one loop a worker
    built by ``run_remote`` otherwise. The launch counts are set to 0 just
    before and read just after."""
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.data.batching import make_batches
    from distkeras_tpu_torch.netps import PSServer
    from distkeras_tpu_torch.netps.remote import run_remote
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import adam

    df = lm_frame(workers * C8_BATCH * C8_WINDOW * rounds, C8["vocab_size"],
                  C8_SEQ, seed + workers)
    plan = make_batches(df, "features", "label", C8_BATCH,
                        num_workers=workers, window=C8_WINDOW)
    tokens = rounds * workers * C8_WINDOW * C8_BATCH * C8_SEQ
    telemetry.reset()
    srv = PSServer(discipline="aeasgd", device="cuda",
                   transport="shm").start()
    try:
        with recorded_aggregators() as made:
            torch.cuda.synchronize()
            F.reset_launches()  # counts start at 0 just before the run
            FA.reset_launches()
            t0 = time.perf_counter()
            params, losses = run_remote(
                endpoint=srv.endpoint, model=model, tx=adam(C8_LR),
                loss_fn=get_loss("sparse_categorical_crossentropy"),
                plan=plan, discipline="aeasgd", window=C8_WINDOW,
                alpha=C8_ALPHA, seed=0, compute_dtype=torch.bfloat16,
                transport="shm", hier=topo == "hier",
                hier_flush=C8_HIER_FLUSH, inflight=1, shards=1,
                compress="none", loop_fn=loop if workers == 1 else None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            fold, flash = F.launch_counts(), FA.launch_counts()
        log = list(srv.commit_log)
        center = srv.center()
    finally:
        srv.close()
    snap = telemetry.get().snapshot()
    agg = made[0] if made else None
    return {"workers": workers, "topology": topo, "rounds": rounds,
            "seconds": wall, "tokens": tokens,
            "tokens_per_sec": tokens / wall,
            "root_commits": len(log),
            "root_commits_per_sec": len(log) / wall,
            "worker_commits_per_sec": workers * rounds / wall,
            "params": params, "losses": losses, "log": log,
            "center": center, "fold": fold, "flash": flash, "agg": agg,
            "aggregators": len(made),
            "spans": {name: span_stats(snap, name) for name in (
                "netps.remote.local_window", "netps.rpc.commit.shm",
                "netps.server.commit.shm", "netps.rpc.pull.shm")},
            "counters": {k: snap["counters"].get(k, 0) for k in (
                "netps.hier.combined_commits", "netps.hier.worker_commits",
                "netps.hier.lost_windows", "netps.shm_upgrades",
                "netps.shm_fallbacks")}}


def c8_check_hier_point(point: dict, init: dict, flat_root: int) -> list:
    """The ``hier_curve`` checks of one point: finite losses, the center
    moved, the returned params the root's center, the flash kernels 2/1/1
    a layer a step; flat: each worker commit folded once at the root, one
    ``fold_commit`` each; hier: every worker commit absorbed once, the
    ledger balanced with nothing open after close, the root holding only
    the aggregator's commits (each once, no more than the flat run's), and
    one ``fold_commit`` an absorbed commit plus one a root commit."""
    bad = []
    W, rounds = point["workers"], point["rounds"]
    label = f"hier_curve[{point['topology']} W={W}]"
    if not np.all(np.isfinite(point["losses"])):
        bad.append(f"{label}: non-finite losses")
    moved = max((point["params"][k] - v).abs().max().item()
                for k, v in init.items())
    point["center_max_abs_change"] = moved
    if not moved > 0:
        bad.append(f"{label}: the center did not move")
    if not same_bits([v.cpu().numpy() for v in point["params"].values()],
                     point["center"]):
        bad.append(f"{label}: the returned params are not the root's center")
    steps = W * rounds * C8_WINDOW
    want_flash = {"flash_fwd": 2 * C8["num_layers"] * steps,
                  "flash_dq": C8["num_layers"] * steps,
                  "flash_dkv": C8["num_layers"] * steps}
    if point["flash"] != want_flash:
        bad.append(f"{label}: flash launches {point['flash']}, want "
                   f"{want_flash}")
    every = sorted((w, s) for w in range(W) for s in range(rounds))
    log, fold = point["log"], point["fold"]
    if point["topology"] == "flat":
        if point["aggregators"] or sorted((w, s) for w, s, _ in log) != every:
            bad.append(f"{label}: root log {sorted(log)[:8]}, "
                       f"aggregators {point['aggregators']}")
        if fold.get("fold_commit") != len(log):
            bad.append(f"{label}: fold launches {fold} for {len(log)} "
                       f"commits")
        return bad
    agg = point["agg"]
    if point["aggregators"] != 1 or agg is None:
        return bad + [f"{label}: {point['aggregators']} aggregators built"]
    absorbed = sorted((w, s) for w, s, _ in agg.commit_log)
    ledger = {"absorbed": agg.absorbed, "forwarded": agg.forwarded,
              "forwarded_commits": agg.forwarded_commits,
              "lost_windows": agg.lost_windows,
              "lost_commits": agg.lost_commits,
              "open_commits": agg._acc_count}
    point["ledger"] = ledger
    if absorbed != every or agg.absorbed != W * rounds:
        bad.append(f"{label}: absorbed {absorbed}, want each of {every} "
                   f"once")
    if (agg.absorbed != agg.forwarded_commits + agg.lost_commits
            or agg._acc_count):
        bad.append(f"{label}: the ledger does not balance: {ledger}")
    up = agg._up.worker_id
    if (not exactly_once(log) or {w for w, _s, _ in log} != {up}
            or len(log) != agg.forwarded):
        bad.append(f"{label}: root log {log} for {agg.forwarded} "
                   f"combined commits of worker {up}")
    if len(log) > flat_root:
        bad.append(f"{label}: the root saw {len(log)} commits, the flat "
                   f"run {flat_root}")
    if (fold.get("fold_commit") != agg.absorbed + len(log)
            or fold.get("fold_int8") or fold.get("fold_bf16")):
        bad.append(f"{label}: fold launches {fold}, want {agg.absorbed} "
                   f"absorbs + {len(log)} root folds")
    return bad


def c8_hier_curve(torch, F, FA, model, loop, init: dict, seed: int
                  ) -> tuple:
    """The ``hier_curve`` arm: one warm run (4 workers, hier,
    ``C8_WARM_ROUNDS``), then one timed run a point, flat then hier at 1,
    2 and 4 workers. Returns ``(points, failures, warm)``."""
    failures = []
    warm = c8_hier_point(torch, F, FA, model, loop,
                         max(C8_CURVE_WORKERS), "hier", seed,
                         C8_WARM_ROUNDS)
    failures += c8_check_hier_point(warm, init, max(C8_CURVE_WORKERS)
                                    * C8_WARM_ROUNDS)
    points = []
    for W in C8_CURVE_WORKERS:
        flat = c8_hier_point(torch, F, FA, model, loop, W, "flat", seed,
                             C8_CURVE_ROUNDS)
        failures += c8_check_hier_point(flat, init, len(flat["log"]))
        hier_p = c8_hier_point(torch, F, FA, model, loop, W, "hier", seed,
                               C8_CURVE_ROUNDS)
        failures += c8_check_hier_point(hier_p, init, len(flat["log"]))
        points += [flat, hier_p]
    return points, failures, warm


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
    folded = 0
    for k, log in enumerate(run["logs"]):
        seqs = [(w, s) for w, s, _st in log]
        folded += len(log)
        if sorted(seqs) != [(0, s) for s in range(rounds)]:
            bad.append(f"{label}: server {k}'s commit log {seqs}, want "
                       f"(0, 0..{rounds - 1}) once each")
    # One fold_commit launch a folded commit on each server: a striped
    # commit is assembled and folded once, a sharded one once a shard; and
    # one a probe the tuner's sweep sent (its decode into the scratch
    # window).
    want = folded + run["probe_launches"]
    if run["fold"].get("fold_commit") != want or any(
            v for k, v in run["fold"].items() if k != "fold_commit"):
        bad.append(f"{label}: fold launches {run['fold']} for "
                   f"{folded} folded commits and {run['probe_launches']} "
                   f"probes")
    if run["pending"]:
        bad.append(f"{label}: {run['pending']} half-assembled stripes left")
    if run["journal"] is not None and sorted(run["journal"]) != [
            (0, s) for s in range(rounds)]:
        bad.append(f"{label}: journal {run['journal']}, want each commit "
                   f"once")
    if not drill:
        # Every commit went out and was served on the arm's dialect: the
        # fold launches above came from that dialect's path. A striped
        # commit is one client span a stripe (``.s<k>``) and one server
        # span a stripe; a sharded one a span a shard on both sides.
        n, stripes = run["servers"], run["shards"]
        for side in ("rpc", "server"):
            got = {d or ".tcp": run["spans"][f"netps.{side}.commit{d}"][
                "count"] for d in C8_DIALECTS}
            per = (n * stripes if side == "server"
                   else n if stripes == 1 else 0)
            want = {d or ".tcp": rounds * per if d == run["dialect"] else 0
                    for d in C8_DIALECTS}
            if got != want:
                bad.append(f"{label}: {side} commits by dialect {got}, "
                           f"want {want}")
        if stripes > 1:
            got = [run["spans"][f"netps.rpc.commit.s{k}{run['dialect']}"][
                "count"] for k in range(stripes)]
            if got != [rounds] * stripes:
                bad.append(f"{label}: commits a stripe {got}, want "
                           f"{rounds} on each of {stripes}")
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


def c8_probe_window_check(torch, F, params: dict, seed: int,
                          workdir: str) -> tuple:
    """Check (c)'s decode and state halves at config #8's width: a server
    on the card decodes a seeded payload of the 70 tensors under each codec
    into its scratch window, one ``fold_commit`` launch each, bit-equal to
    the numpy ``decode_entry`` (signed zeros and a zero-scale int8 tensor
    included); a sweep against an idle server with a ``state_dir`` leaves
    the center's bytes, the commit log, the dedup table and the journal's
    length as they were; and one probe's decode times by CUDA events in
    each codec (the window's fill and the fold, L2 flushed and the card
    held by a spin before each), beside the fold alone, the plain twin and
    the bound. Returns ``(row, failures)``."""
    from distkeras_tpu_torch.netps import PSClient, PSServer, state, wire
    from distkeras_tpu_torch.netps.fold import (decode_entry, fold_staged,
                                                stage_commit)
    from distkeras_tpu_torch.netps.tuner import probe_codecs
    from distkeras_tpu_torch.ops.kernels.fold import center_layout
    from distkeras_tpu_torch.runtime import config

    bad = []
    init = [v.detach().float().cpu().numpy() for v in params.values()]
    n = int(sum(a.size for a in init))
    rng = np.random.default_rng(seed + 20)
    payloads = {}
    for codec in wire.CODECS:
        items = []
        for i, a in enumerate(init):
            d = (rng.normal(size=a.shape) * 1e-2).astype(np.float32)
            d.reshape(-1)[0], d.reshape(-1)[-1] = -0.0, 0.0
            if codec == "int8" and i == 1:
                d[:] = 0.0  # scale 0: the kernel skips it, the window not
            q, spec = wire.codec_encode(d, codec)
            items.append((q, spec) if spec else q)
        payloads[codec] = items
    srv = PSServer(discipline="aeasgd", device="cuda").start()
    bits, launches, walls = {}, {}, {}
    try:
        for codec, items in payloads.items():
            F.reset_launches()
            nbytes, got = srv._probe.decode(items, keep=True)
            launches[codec] = F.launch_counts()["fold_commit"]
            ref = [np.asarray(decode_entry(e), np.float32) for e in items]
            bits[codec] = (nbytes == 4 * n and all(
                a.tobytes() == b.tobytes() and a.shape == b.shape
                for a, b in zip(got, ref)))
            # The host wall of the op's whole decode: packing, the copy
            # over, the fill, the fold and the wait on the server's stream.
            wall = []
            for _ in range(4):
                t0 = time.perf_counter()
                srv._probe.decode(items)
                wall.append((time.perf_counter() - t0) * 1e3)
            walls[codec] = float(np.median(wall[1:]))
    finally:
        srv.close()
    if not all(bits.values()) or set(launches.values()) != {1}:
        bad.append(f"(c) the probe decode on the card: bit-equal {bits}, "
                   f"launches {launches}")

    # A sweep against an idle server that journals: nothing moves.
    state_dir = os.path.join(workdir, "c8_probe_state")
    shutil.rmtree(state_dir, ignore_errors=True)
    srv = PSServer(center=init, discipline="aeasgd", device="cuda",
                   state_dir=state_dir).start()
    try:
        with PSClient(srv.endpoint, worker_id=0, timeout=60.0) as c:
            _, u = c.join()
            assert c.commit([np.full(a.shape, 1e-3, np.float32)
                             for a in init], u).applied
            wait_until(lambda: len(state.read_journal(state_dir)) == 1,
                       30.0, "the commit's journal record")
            before = (srv.center(), list(srv.commit_log),
                      dict(srv._last_seq), srv.updates,
                      len(state.read_journal(state_dir)))
            F.reset_launches()
            sweep = probe_codecs(c, init)
            sweep_launches = F.launch_counts()["fold_commit"]
            time.sleep(0.5)  # anything the sweep queued would land now
            after = (srv.center(), list(srv.commit_log),
                     dict(srv._last_seq), srv.updates,
                     len(state.read_journal(state_dir)))
    finally:
        srv.close()
        shutil.rmtree(state_dir, ignore_errors=True)
    untouched = {"center_bits": same_bits(before[0], after[0]),
                 "commit_log": before[1] == after[1],
                 "dedup_table": before[2] == after[2],
                 "updates": before[3] == after[3],
                 "journal_records": [before[4], after[4]]}
    probes = config.env_int("DKTPU_TUNE_PROBES")
    if (not all(v for k, v in untouched.items() if k != "journal_records")
            or before[4] != after[4]
            or [r.codec for r in sweep] != list(wire.CODECS)
            or sweep_launches != probes * len(wire.CODECS)):
        bad.append(f"(c) a sweep against an idle journaling server: "
                   f"{untouched}, sweep {sweep}, {sweep_launches} launches")

    # One probe's decode by CUDA events, in each codec.
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    wire_bytes = {"none": 4, "bf16": 2, "int8": 1}
    times = {}
    for codec, items in payloads.items():
        staged = stage_commit(items, "cuda")
        offsets = [int(o) for o in staged.rows["center"]]
        total = center_layout([int(k) for k in staged.rows["n"]])[1]
        flat = torch.empty(total, device="cuda")
        views = [flat[o:o + a.size].view(a.shape)
                 for o, a in zip(offsets, init)]

        def decode():
            flat.fill_(-0.0)
            fold_staged(views, staged, 1.0)

        def plain():
            flat.fill_(-0.0)
            F.fold_commit_plain_(views, staged, 1.0)

        row = {key: cuda_ms_cold(torch, fn, FOLD_REPS, flush,
                                 head_start=True)
               for key, fn in (("ms", decode),
                               ("fold_ms", lambda: fold_staged(
                                   views, staged, 1.0)),
                               ("plain_ms", plain))}
        # The decode's bytes (the payload read, the f32 window written)
        # and the fill's write of the window.
        w = wire_bytes[codec]
        row["bound_ms"], row["bound_by"] = bound((w + 4 + 4) * n, 2 * n,
                                                 PEAK_F32_FLOPS)
        row["bytes_per_param"] = w + 4 + 4
        row["library_ms"] = None
        row["decode_wall_ms"] = walls[codec]
        times[codec] = row
        del staged, flat, views
    del flush
    torch.cuda.empty_cache()
    return {"params": n, "tensors": len(init), "bit_equal": bits,
            "launches_a_decode": launches, "sweep_untouched": untouched,
            "sweep_launches": sweep_launches, "times": times,
            "timing": "CUDA events around one probe decode's device work "
                      "(the window's fill to -0.0 and one fold_commit at "
                      "scale 1; fold_ms the fold alone), L2 flushed and the "
                      "card held by a spin before each; bound: the payload "
                      "read, the decoded f32 written and the window's fill "
                      "written, over 3.35 TB/s; no one PyTorch call decodes "
                      "a packed commit, so library_ms is null; "
                      "decode_wall_ms: host clock of the server window's "
                      "whole decode (packing, copy, fill, fold, stream "
                      "wait), median of 3 after one"}, bad


def c8_restripe_check(torch, F, params: dict, seed: int) -> tuple:
    """Check (d): a client of a server on the card, built with two
    connections and retuned to one stripe after its join, commits
    ``C8_RESTRIPE_COMMITS`` seeded int8 deltas of config #8's tensors and
    is retuned to two stripes before commit ``C8_RESTRIPE_AT``; after every
    commit its pull (striped once retuned) must equal an unstriped
    observer's pull of the same server, bit for bit and counter for
    counter, and the center must equal a second server's that folded the
    same commits from an unstriped client. One ``fold_commit`` a commit on
    each server. Returns ``(row, failures)``."""
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.netps import PSClient, PSServer

    init = [v.detach().float().cpu().numpy() for v in params.values()]
    rng = np.random.default_rng(seed + 21)
    deltas = [[(rng.normal(size=a.shape) * 1e-3).astype(np.float32)
               for a in init] for _ in range(C8_RESTRIPE_COMMITS)]
    telemetry.reset()
    servers = [PSServer(center=init, discipline="aeasgd",
                        device="cuda").start() for _ in range(2)]
    pulls, changes, stripes = [], [], []
    try:
        F.reset_launches()
        with PSClient(servers[0].endpoint, worker_id=0, shards=2,
                      compress="int8", timeout=60.0) as c, \
                PSClient(servers[0].endpoint, worker_id=1,
                         timeout=60.0) as observer, \
                PSClient(servers[1].endpoint, worker_id=0, compress="int8",
                         timeout=60.0) as plain:
            c.join()
            observer.join()
            plain.join()
            changes.append(c.retune(shards=1, template=init))
            for k, delta in enumerate(deltas):
                if k == C8_RESTRIPE_AT:
                    changes.append(c.retune(shards=2, template=init))
                stripes.append(len(c._stripes or [0]))
                _, u = c.pull()
                c.commit(delta, u)
                _, u = plain.pull()
                plain.commit(delta, u)
                got, gu = c.pull()
                want, wu = observer.pull()
                pulls.append(gu == wu and same_bits(got, want))
        launches = F.launch_counts()["fold_commit"]
        centers = [x.center() for x in servers]
        logs = [[(w, q) for w, q, _ in x.commit_log] for x in servers]
    finally:
        for x in servers:
            x.close()
    torn = telemetry.get().snapshot()["counters"].get(
        "netps.pull_torn_retries", 0)
    row = {"commits": C8_RESTRIPE_COMMITS, "restriped_at": C8_RESTRIPE_AT,
           "retunes": [{k: list(v) for k, v in ch.items()}
                       for ch in changes],
           "stripes_a_commit": stripes, "pulls_untorn": pulls,
           "torn_retries": torn, "fold_launches": launches,
           "bit_equal_unstriped": same_bits(centers[0], centers[1])}
    want_log = [(0, q) for q in range(C8_RESTRIPE_COMMITS)]
    bad = []
    if (not all(pulls) or not row["bit_equal_unstriped"]
            or logs != [want_log, want_log]
            or launches != 2 * C8_RESTRIPE_COMMITS
            or changes != [{"shards": (2, 1)}, {"shards": (1, 2)}]
            or stripes != [1] * C8_RESTRIPE_AT + [2] * (
                C8_RESTRIPE_COMMITS - C8_RESTRIPE_AT)):
        bad.append(f"(d) the mid-run restripe: {row}, logs {logs}")
    return row, bad


@contextlib.contextmanager
def tuner_evaluations():
    """Yield a list that gets the round of every control-loop evaluation
    a ``Tuner`` makes in the block (a ``maybe_decide`` that moved its
    clock)."""
    from distkeras_tpu_torch.netps.tuner import controller

    rounds, real = [], controller.Tuner.maybe_decide

    def counted(self, r, active_transport="tcp"):
        before = self._last_eval
        out = real(self, r, active_transport)
        if self._last_eval != before:
            rounds.append(r)
        return out

    controller.Tuner.maybe_decide = counted
    try:
        yield rounds
    finally:
        controller.Tuner.maybe_decide = real


def c8_check_tuned(run: dict, label: str, rule: dict = None) -> list:
    """The tuner's own checks of an autotuned run: one run summary, the
    topology chosen by the fan-in crossover (flat at one worker), every
    codec swept once with ``DKTPU_TUNE_PROBES`` probes each on TCP and
    none on the ring, and, with ``rule``, the converged dialect."""
    from distkeras_tpu_torch.netps import wire
    from distkeras_tpu_torch.runtime import config

    tun, bad = run["tuner"], []
    summary = tun["summary"] if tun else None
    if summary is None:
        return [f"{label}: no tuner_run_summary event"]
    topo = [d["to"] for d in tun["decisions"] if d["knob"] == "topology"]
    if topo != ["flat"]:
        bad.append(f"{label}: topology decisions {topo}, want ['flat']")
    probes = config.env_int("DKTPU_TUNE_PROBES")
    swept = [(p["codec"], p["probes"]) for p in tun["probes"]]
    want = ([(c, probes) for c in wire.CODECS]
            if run["transport"] == "tcp" else [])
    if swept != want or run["probe_launches"] != len(want) * probes:
        bad.append(f"{label}: probes {swept} ({run['probe_launches']} "
                   f"served), want {want}")
    if rule and any(summary[k] != v for k, v in rule.items()):
        bad.append(f"{label}: converged to {summary}, the rule says {rule}")
    return bad


def c8_sim_drift(torch, F, FA, model, plan, loop, df, tokens: int) -> tuple:
    """The traced shot and the simulator's replay of it: one ``pr4`` run
    (TCP, inflight 1, one stripe, f32 commits) with ``DKTPU_TRACE=1`` into
    :data:`C8_TRACE_DIR`, then ``TelemetryCollector.from_dir(...).records()``
    into ``sim_drift(records, tokens / seconds, tokens_per_round=window *
    batch * seq_len)``. Returns the block and the run."""
    from distkeras_tpu_torch.sim.calibrate import sim_drift
    from distkeras_tpu_torch.telemetry import tracing
    from distkeras_tpu_torch.telemetry.tracing import context, recorder

    shutil.rmtree(C8_TRACE_DIR, ignore_errors=True)
    os.makedirs(C8_TRACE_DIR)
    context._reset_stream()
    try:
        with env_set(DKTPU_TRACE="1", DKTPU_TRACE_DIR=C8_TRACE_DIR):
            run = c8_run(torch, F, FA, "pr4", model, plan, loop, df, tokens)
    finally:
        context._reset_stream()
        recorder._reset()
    records = tracing.TelemetryCollector.from_dir(C8_TRACE_DIR).records()
    shutil.rmtree(C8_TRACE_DIR, ignore_errors=True)
    block = sim_drift(records, tokens / run["seconds"],
                      tokens_per_round=C8_WINDOW * C8_BATCH * C8_SEQ)
    block["trace_records"] = len(records)
    return block, run


def netps_config8_phase(torch, F, FA, gpu: str, seed: int) -> dict:
    """Config #8 (``netps_loopback_aeasgd``) at full width through the arms
    the port serves: ``inprocess``, ``pr4`` (TCP, inflight 1), ``shm`` (the
    ring, inflight 2), ``mesh`` (the in-process dispatch, inflight 2) and
    ``optimized`` (TCP, inflight 2, 2 stripes, int8), one warm run and
    ``C8_TIMED`` timed runs each; ``durable`` (``optimized`` with a fresh
    journal) in ``C8_DURABLE_PAIRS`` ABBA pairs with a baseline
    ``optimized`` run; then the mesh fold's bit check (d), the demotion
    drill (e), a mesh run at inflight 1 against ``pr4``'s center (f) and
    a striped int8 run at inflight 1 against the same run unstriped (g).
    Returns the fold and flash launches of the mesh and striped arms, and
    what ``netps_sharded`` reuses (the model, its local loop, the data and
    ``pr4``'s center)."""
    import copy

    from distkeras_tpu_torch import small_transformer_lm
    from distkeras_tpu_torch.data.batching import make_batches
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
    for arm, kw in (("inprocess", {}), ("pr4", {}), ("shm", {"inflight": 2}),
                    ("mesh", {"inflight": 2}), ("optimized", C8_OPTIMIZED),
                    ("auto", C8_AUTO)):
        runs = [c8_run(torch, F, FA, arm, model, warm[0], loop, *warm[1:],
                       **kw)] + [
            c8_run(torch, F, FA, arm, model, plan, loop, df, tokens, **kw)
            for _ in range(C8_TIMED)]
        for i, run in enumerate(runs):
            failures += c8_check_run(torch, run, init, f"{arm}[{i}]")
            if arm == "auto":
                failures += c8_check_tuned(run, f"auto[{i}]", C8_AUTO_RULE)
        arms[arm] = runs
    timed = {arm: runs[1:] for arm, runs in arms.items()}
    tps = {arm: float(np.median([r["tokens_per_s"] for r in runs]))
           for arm, runs in timed.items()}

    drift, traced = c8_sim_drift(torch, F, FA, model, plan, loop, df, tokens)
    failures += c8_check_run(torch, traced, init, "traced_pr4")
    if drift["value"] is None:
        failures.append(f"sim_drift read nothing from the traced run: "
                        f"{drift}")

    # durable: the optimized plane with a fresh journal, in ABBA pairs with
    # a baseline optimized run (a ratio a pair, their geometric mean).
    ratios, durable_runs = [], []
    for i in range(C8_DURABLE_PAIRS):
        state_dir = os.path.join("build", "c8_durable")
        shutil.rmtree(state_dir, ignore_errors=True)
        pair = {}
        for journaled in ((True, False) if i % 2 == 0 else (False, True)):
            run = c8_run(torch, F, FA, "durable" if journaled else
                         "optimized", model, plan, loop, df, tokens,
                         state_dir=state_dir if journaled else None,
                         **C8_OPTIMIZED)
            failures += c8_check_run(torch, run, init,
                                     f"{run['arm']}_pair{i}")
            pair[journaled] = run["seconds"]
            if journaled:
                durable_runs.append(run)
        shutil.rmtree(state_dir, ignore_errors=True)
        ratios.append(pair[True] / pair[False])
    durable_ratio = float(np.exp(np.mean(np.log(ratios))))

    # (g) stripes change nothing that is folded: int8 at inflight 1, two
    # stripes against one.
    striped = {n: c8_run(torch, F, FA, f"int8_s{n}", model, plan, loop, df,
                         tokens, transport="tcp", shards=n, compress="int8")
               for n in (1, 2)}
    for n, run in striped.items():
        failures += c8_check_run(torch, run, init, f"int8_s{n}")
    striped_equal = same_bits(striped[1]["center"], striped[2]["center"])
    if not striped_equal:
        failures.append("(g) the 2-stripe int8 run's center is not the "
                        "1-stripe run's")

    fold_check = c8_mesh_fold_check(torch, F, model.params, seed)
    if not fold_check["bit_equal"] or fold_check["launches"].get(
            "fold_commit") != fold_check["commits"]:
        failures.append(f"(d) mesh fold on the card: {fold_check}")

    with fault_plan(net=f"mesh_down@{C8_DEMOTE_AT}") as (_, down):
        drill = c8_run(torch, F, FA, "mesh", model, plan, loop, df, tokens,
                       inflight=2)
        missed = unfired(down)
    failures += c8_check_run(torch, drill, init, "mesh_drill", drill=True)
    drill_c = drill["counters"]
    served = {d or ".tcp": drill["spans"][f"netps.server.commit{d}"]["count"]
              for d in C8_DIALECTS}
    # The committing client (the commit lane) demotes once, onto the ring,
    # and retransmits the failed seq there: seqs below C8_DEMOTE_AT came
    # through the dispatch, the rest through the ring, each folded once.
    if (missed or drill_c["netps.mesh.demotions"] != 1
            or drill_c["netps.shm_fallbacks"] or served[".tcp"]
            or served[".mesh"] != C8_DEMOTE_AT
            or served[".shm"] != C8_ROUNDS - C8_DEMOTE_AT
            or drill_c["netps.mesh.folds"] != served[".mesh"]):
        failures.append(f"(e) the demotion drill: unfired {missed}, "
                        f"counters {drill_c}, commits served by dialect "
                        f"{served}")

    pr4_a, pr4_b = (r["center"] for r in timed["pr4"])
    pr4_spread = max(float(np.abs(a - b).max()) for a, b in zip(pr4_a,
                                                                pr4_b))
    mesh1 = c8_run(torch, F, FA, "mesh", model, plan, loop, df, tokens)
    failures += c8_check_run(torch, mesh1, init, "mesh_inflight1")
    mesh1_off = max(float(np.abs(a - b).max())
                    for a, b in zip(mesh1["center"], pr4_a))
    if mesh1_off > pr4_spread:
        failures.append(f"(f) the mesh run at inflight 1 is {mesh1_off} "
                        f"from pr4's center; two pr4 runs are {pr4_spread} "
                        f"apart")

    curve, curve_failures, curve_warm = c8_hier_curve(
        torch, F, FA, model, loop, init, seed)
    failures += curve_failures

    # (c) the TCP cold start: the probe sweep at join over TCP, the control
    # loop evaluating mid-run; then the probe's decode on the card and a
    # sweep against an idle journaling server.
    with env_set(DKTPU_TUNE_INTERVAL=str(C8_TUNE_INTERVAL)), \
            tuner_evaluations() as evaluated:
        cold = c8_run(torch, F, FA, "auto_tcp", model, plan, loop, df,
                      tokens, **C8_COLD)
    failures += c8_check_run(torch, cold, init, "auto_tcp", drill=True)
    failures += c8_check_tuned(cold, "auto_tcp", {"transport": "tcp"})
    want_eval = list(range(C8_TUNE_INTERVAL, C8_ROUNDS, C8_TUNE_INTERVAL))
    if not exactly_once(cold["log"]) or evaluated != want_eval:
        failures.append(f"(c) the TCP cold start: exactly-once "
                        f"{exactly_once(cold['log'])}, evaluations at "
                        f"rounds {evaluated}, want {want_eval}")
    probe_check, probe_failures = c8_probe_window_check(
        torch, F, model.params, seed, "build")
    failures += probe_failures

    # (d) a mid-run restripe, 1 -> 2 stripes between commits.
    restripe, restripe_failures = c8_restripe_check(torch, F, model.params,
                                                    seed)
    failures += restripe_failures

    from distkeras_tpu_torch.netps.tuner import recommended_topology

    def curve_row(p):
        row = {k: p[k] for k in (
            "workers", "topology", "rounds", "seconds", "tokens_per_sec",
            "root_commits", "root_commits_per_sec", "worker_commits_per_sec",
            "counters", "spans")}
        # What the tuner would pick at this fan-in, beside both topologies.
        row["controller_topology"] = recommended_topology(p["workers"])
        row["fold_launches"] = p["fold"].get("fold_commit", 0)
        row["center_max_abs_change"] = p.get("center_max_abs_change")
        if p["agg"] is not None:
            row["ledger"] = p.get("ledger")
            row["precombine_launches"] = p["agg"].absorbed
            row["aggregator_fold_host_ms"] = (
                1e3 * p["agg"].fold_seconds / max(1, p["agg"].absorbed))
        return row

    def arm_row(runs):
        last = runs[-1]
        return {"tokens_per_s": [r["tokens_per_s"] for r in runs],
                "tuner": [r["tuner"] for r in runs] if last["tuner"] else None,
                "seconds": [r["seconds"] for r in runs],
                "fold_launches": [r["fold"].get("fold_commit", 0)
                                  for r in runs],
                "flash_launches": last["flash"],
                "counters": last["counters"], "spans": last["spans"],
                "history": [float(v) for v in last["losses"].reshape(-1)],
                "center_max_abs_change": last["center_max_abs_change"]}

    # The simulator's crossover replay on this phase's own curve (the
    # reference reads its BENCH_SUMMARY.json; the card's curve is this one).
    from distkeras_tpu_torch.sim.calibrate import hier_crossover

    rows = [curve_row(p) for p in curve]
    try:
        xo = hier_crossover(summary={"configs": [{
            "metric": "netps_loopback_aeasgd", "hier_curve": rows}]})
        crossover = {k: xo[k] for k in (
            "predicted_crossover_workers", "measured_crossover_workers",
            "crossover_reproduced", "max_held_out_error_pct",
            "within_band", "band_pct", "calibration", "predicted_ratio",
            "measured_ratio", "predicted_ingress_cut",
            "measured_ingress_cut")}
        crossover["points"] = [{k: pt[k] for k in (
            "workers", "topology", "measured_tokens_per_sec",
            "predicted_tokens_per_sec", "error_pct", "held_out")}
            for pt in xo["points"]]
    except (KeyError, ValueError, ZeroDivisionError) as e:
        crossover = None
        failures.append(f"hier_crossover on the phase's curve: {e!r}")

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
          "auto_tokens_per_sec": tps["auto"],
          "auto_vs_best_hand_tuned": tps["auto"] / tps["shm"],
          "auto_knobs": [r["tuner"]["summary"] for r in timed["auto"]],
          "auto_rule": C8_AUTO_RULE,
          "tcp_cold_start": {
              "knobs": C8_COLD, "tune_interval": C8_TUNE_INTERVAL,
              "probes": cold["tuner"]["probes"],
              "winner": max(cold["tuner"]["probes"],
                            key=lambda r: r["score"])["codec"]
              if cold["tuner"]["probes"] else None,
              "decisions": cold["tuner"]["decisions"],
              "converged": cold["tuner"]["summary"],
              "evaluated_rounds": evaluated,
              "tokens_per_s": cold["tokens_per_s"],
              "commits": len(cold["log"]),
              "exactly_once": exactly_once(cold["log"]),
              "fold_launches": cold["fold"],
              "probe_launches": cold["probe_launches"],
              "counters": cold["counters"], "spans": cold["spans"]},
          "probe_decode": probe_check,
          "restripe": restripe,
          "optimized_knobs": C8_OPTIMIZED,
          "optimized_tokens_per_sec": tps["optimized"],
          "optimized_vs_pr4": tps["optimized"] / tps["pr4"],
          "shm_vs_tcp_optimized": tps["shm"] / tps["optimized"],
          "durable_tokens_per_sec": tps["optimized"] / durable_ratio,
          "durable_overhead_vs_optimized": durable_ratio - 1.0,
          "durable_pair_ratios": ratios,
          "durable_pairs": C8_DURABLE_PAIRS,
          "durable_journal_records": [len(r["journal"])
                                      for r in durable_runs],
          "durable_fold_launches": [r["fold"].get("fold_commit", 0)
                                    for r in durable_runs],
          "stripe_parity": {"runs": {f"int8_s{n}": {
              "tokens_per_s": r["tokens_per_s"],
              "fold_launches": r["fold"].get("fold_commit", 0)}
              for n, r in striped.items()},
              "bit_equal": striped_equal},
          "arms": {arm: arm_row(runs) for arm, runs in timed.items()},
          "warm_tokens_per_s": {arm: runs[0]["tokens_per_s"]
                                for arm, runs in arms.items()},
          "mesh_fold_check": fold_check,
          "demotion_drill": {"faults": f"mesh_down@{C8_DEMOTE_AT}",
                             "counters": drill_c,
                             "commits_served_by_dialect": served,
                             "commits": len(drill["log"]),
                             "fold_launches": drill["fold"],
                             "tokens_per_s": drill["tokens_per_s"]},
          "transport_parity": {"pr4_runs_apart": pr4_spread,
                               "mesh_inflight1_from_pr4": mesh1_off,
                               "bit_equal": mesh1_off == 0.0},
          "hier_curve": rows,
          "hier_curve_knobs": {"transport": "shm", "inflight": 1,
                               "shards": 1, "compress": "none",
                               "hier_flush": C8_HIER_FLUSH,
                               "rounds": C8_CURVE_ROUNDS,
                               "warm": curve_row(curve_warm)},
          "hier_vs_flat": {W: next(p["tokens_per_sec"] for p in curve
                                   if p["workers"] == W
                                   and p["topology"] == "hier")
                           / next(p["tokens_per_sec"] for p in curve
                                  if p["workers"] == W
                                  and p["topology"] == "flat")
                           for W in C8_CURVE_WORKERS},
          "sim_drift": drift,
          "sim_drift_traced_run": {
              "seconds": traced["seconds"],
              "tokens_per_s": traced["tokens_per_s"],
              "commits": len(traced["log"]),
              "fold_launches": traced["fold"].get("fold_commit", 0)},
          "hier_crossover": crossover,
          "reduced": f"none of width; {C8_ROUNDS} rounds a run (the "
                     f"bench's 12); durable runs {C8_DURABLE_PAIRS} ABBA "
                     f"pairs (the reference max(reps + 2, 10))",
          "seconds": time.perf_counter() - t_phase})
    if failures:
        fail("netps_config8: " + "; ".join(failures))
    first = timed["mesh"][0]
    stripe_runs = timed["optimized"] + durable_runs + [striped[2]]
    hier_points = [p for p in curve if p["topology"] == "hier"]
    return {"hier_launches": sum(p["fold"].get("fold_commit", 0)
                                 for p in hier_points),
            "hier_absorbed": sum(p["agg"].absorbed for p in hier_points),
            "hier_root_commits": sum(p["root_commits"] for p in hier_points),
            "mesh_fold_launches": sum(r["fold"].get("fold_commit", 0)
                                      for r in timed["mesh"]),
            "mesh_commits": sum(len(r["log"]) for r in timed["mesh"]),
            "striped_fold_launches": sum(r["fold"].get("fold_commit", 0)
                                         for r in stripe_runs),
            "striped_commits": sum(len(r["log"]) for r in stripe_runs),
            "flash": first["flash"],
            "auto_fold_launches": sum(r["fold"].get("fold_commit", 0)
                                      for r in timed["auto"]),
            "auto_commits": sum(len(r["log"]) for r in timed["auto"]),
            "cold_fold_launches": cold["fold"].get("fold_commit", 0),
            "cold_commits": len(cold["log"]),
            "cold_probe_launches": cold["probe_launches"],
            "probe_decode": probe_check,
            "drill_fold_launches": drill["fold"].get("fold_commit", 0),
            "drill_flash": drill["flash"],
            "ctx": {"model": model, "plan": plan, "loop": loop, "df": df,
                    "tokens": tokens, "init": init,
                    "pr4_center": pr4_a,
                    "pr4_tokens_per_s": tps["pr4"]}}


# -- the sharded center: config #8 and config #4 through it, config #10 ----

#: config #10 (``bench.py:898-979``, sized at ``:1484-1487`` on an
#: accelerator): 16 tensors of 256 x 512 f32 (8.4 MB), 4 workers, 6
#: commits each of 1e-3 everywhere (ADAG, scale 1), against 1, 2 and 4
#: shards.
C10 = dict(tensors=16, rows=256, cols=512, workers=4, commits=6)
C10_SHARDS = (1, 2, 4)
C10_DELTA = 1e-3
#: config #4 remote DynSGD (int8) through a 2-shard center: 3 rounds of
#: ``REMOTE``'s 4 workers, window 4, batch 2048.
SHARDED_ROUNDS = 3
#: the ``shard_crash`` drill: shard 1 of 2 SIGKILLs itself once it has
#: folded 4 commits; config #4 remote DynSGD (int8) rides through on
#: retries, its leases long enough for the restart.
SHARD_CRASH = "shard_crash@1:4"
SHARD_CRASH_ROUNDS = 3
SHARD_CRASH_LEASE = 60.0


@contextlib.contextmanager
def acked_logical_commits():
    """Record, as ``(worker, seq)``, every logical commit a port
    ``ShardedPSClient`` saw acknowledged (applied, or answered as a
    duplicate) in the block."""
    from distkeras_tpu_torch.netps import ShardedPSClient

    acked = set()
    real_commit = ShardedPSClient.commit

    def commit(self, delta, pulled_counter):
        seq = self._seq + 1
        res = real_commit(self, delta, pulled_counter)
        if res.applied or res.duplicate:
            acked.add((self.worker_id, seq))
        return res

    ShardedPSClient.commit = commit
    try:
        yield acked
    finally:
        ShardedPSClient.commit = real_commit


def netps_sharded_phase(torch, K, F, FA, gpu: str, seed: int, ctx: dict,
                        frame) -> dict:
    """Two real models through a 2-shard center on the card. (1) Config
    #8's model, ``run_remote`` against ``ShardSet(2)`` under
    ``DKTPU_PS_SHARD_RULES=tok_embed=split`` (codec none, inflight 1):
    the token embedding is row-split, each shard folds every seq once,
    one ``fold_commit`` a shard a commit, and the assembled center is
    bit-equal to ``pr4``'s (one server, the same knobs). (2) Config #4 as
    a user drives it, ``DynSGD(imdb_lstm(...), remote=<ShardSet(2)
    endpoint>)``, int8, 4 workers, 3 rounds: each logical seq folded once
    on each shard, two launches a logical commit, losses finite and the
    center moved. Returns the ``fold_commit`` launches of both runs."""
    from distkeras_tpu_torch.netps import ShardSet

    t_phase = time.perf_counter()
    failures = []
    with env_set(DKTPU_PS_SHARD_RULES=C8_SHARD_RULES):
        c8 = c8_run(torch, F, FA, "sharded", ctx["model"], ctx["plan"],
                    ctx["loop"], ctx["df"], ctx["tokens"], transport="tcp",
                    shard_count=2)
    failures += c8_check_run(torch, c8, ctx["init"], "config8_sharded")
    names = list(ctx["model"].params)
    embed = c8["plan"].segments[names.index("tok_embed.weight")]
    if [k for k, _a, _b in embed] != [0, 1]:
        failures.append(f"config8_sharded: tok_embed.weight is not split "
                        f"over both shards: {embed}")
    c8_equal = same_bits(c8["center"], ctx["pr4_center"])
    if not c8_equal:
        failures.append("config8_sharded: the 2-shard center is not pr4's")
    if c8["fold"].get("fold_commit") != 2 * c8["rounds"]:
        failures.append(f"config8_sharded: {c8['fold']} for "
                        f"{c8['rounds']} commits on 2 shards")

    W = REMOTE["num_workers"]
    rows = SHARDED_ROUNDS * W * REMOTE["communication_window"] \
        * REMOTE["batch_size"]
    ss = ShardSet(2, discipline="dynsgd", device="cuda").start()
    try:
        with acked_logical_commits() as acked:
            run = remote_run(torch, K, F, seed + 6, first_rows(frame, rows),
                             ss.endpoint, SHARDED_ROUNDS)
        logs = [list(x.commit_log) for x in ss.servers]
        center = ss.center()
        plan = ss.plan
    finally:
        ss.close()
    want = sorted((w, s) for w in range(W) for s in range(SHARDED_ROUNDS))
    for k, log in enumerate(logs):
        if sorted((w, s) for w, s, _ in log) != want:
            failures.append(f"config4_sharded: shard {k} folded "
                            f"{sorted((w, s) for w, s, _ in log)}")
    if sorted(acked) != want:
        failures.append(f"config4_sharded: acknowledged {sorted(acked)}")
    if run["fold"].get("fold_commit") != 2 * len(want):
        failures.append(f"config4_sharded: {run['fold']} for {len(want)} "
                        f"logical commits on 2 shards")
    if not run["finite"]:
        failures.append("config4_sharded: non-finite losses")
    trained = [p.cpu().numpy() for p in run["trained"].params.values()]
    moved = max(float(np.abs(a - b.detach().cpu().numpy()).max())
                for a, b in zip(trained,
                                run["trainer"].model.params.values()))
    if not moved > 0 or not same_bits(trained, center):
        failures.append(f"config4_sharded: center moved {moved}; the model "
                        f"is the assembled center: "
                        f"{same_bits(trained, center)}")
    emit({"phase": "netps_sharded", "gpu": gpu,
          "config8": {"shards": 2, "rules": C8_SHARD_RULES,
                      "compress": "none", "inflight": 1,
                      "tokens_per_s": c8["tokens_per_s"],
                      "pr4_tokens_per_s": ctx["pr4_tokens_per_s"],
                      "vs_pr4": c8["tokens_per_s"] / ctx["pr4_tokens_per_s"],
                      "seconds": c8["seconds"],
                      "plan_loads": c8["plan"].loads,
                      "plan_skew": c8["plan"].skew(),
                      "tok_embed_segments": embed,
                      "fold_launches": c8["fold"],
                      "commits_per_shard": [len(x) for x in c8["logs"]],
                      "bit_equal_to_pr4": c8_equal},
          "config4": {"shards": 2, **REMOTE, "rounds": SHARDED_ROUNDS,
                      "codec": "int8", "seconds": run["wall"],
                      "samples_per_s": run["samples_per_s"],
                      "plan_loads": plan.loads, "plan_skew": plan.skew(),
                      "commits_per_shard": [len(x) for x in logs],
                      "acked_logical_commits": len(acked),
                      "fold_launches": run["fold"],
                      "lstm_launches": run["lstm"],
                      "center_max_abs_change": moved},
          "seconds": time.perf_counter() - t_phase})
    if failures:
        fail("netps_sharded: " + "; ".join(failures))
    return {"config8": c8["fold"].get("fold_commit", 0),
            "config8_commits": c8["rounds"],
            "config4": run["fold"].get("fold_commit", 0),
            "config4_commits": len(want)}


def sharded_center_phase(torch, F, gpu: str) -> dict:
    """Config #10's fold-throughput curve on the card: the same 8.4 MB
    center committed to by 4 concurrent workers, 6 commits each (then a
    pull), against one ``PSServer`` and ``ShardSet`` gangs of 2 and 4, each
    server's slice on the card, dialed through ``make_ps_client`` (joins
    untimed, as the reference's barrier leaves them). Each point's
    assembled center must be bit-equal to the numpy oracle (24 successive
    f32 adds of 1e-3: ADAG folds at scale 1) and ``fold_commit`` must
    have launched 24 times on each shard holding a tensor."""
    from distkeras_tpu_torch.netps import PSServer, ShardSet, make_ps_client

    t_phase = time.perf_counter()
    n_t, rows, cols = C10["tensors"], C10["rows"], C10["cols"]
    W, commits = C10["workers"], C10["commits"]
    rng = np.random.default_rng(0)
    center = [rng.standard_normal((rows, cols)).astype(np.float32)
              for _ in range(n_t)]
    center_bytes = sum(a.nbytes for a in center)
    oracle = [a.copy() for a in center]
    for _ in range(W * commits):
        for o in oracle:
            o += np.float32(C10_DELTA)
    curve, failures = [], []
    for n in C10_SHARDS:
        if n == 1:
            srv = PSServer(center=[a.copy() for a in center],
                           discipline="adag", device="cuda").start()
            endpoint, plan, holders = srv.endpoint, None, 1
        else:
            srv = ShardSet(n, center=[a.copy() for a in center],
                           discipline="adag", device="cuda").start()
            endpoint, plan = srv.endpoint, srv.plan
            holders = sum(1 for k in range(n) if plan.shard_shapes(k))
        try:
            barrier = threading.Barrier(W + 1)
            errors: list = []

            def work(endpoint=endpoint, plan=plan, barrier=barrier,
                     errors=errors):
                client = make_ps_client(endpoint, plan=plan)
                try:
                    _c, counter = client.join(init=center)
                    delta = [np.full_like(a, C10_DELTA) for a in center]
                    barrier.wait()
                    for _ in range(commits):
                        client.commit(delta, counter)
                        _c, counter = client.pull()
                    client.leave()
                except Exception as e:  # surfaced below, never swallowed
                    errors.append(e)
                    barrier.abort()
                finally:
                    client.close()

            threads = [threading.Thread(target=work, name=f"c10-{w}")
                       for w in range(W)]
            for t in threads:
                t.start()
            try:
                barrier.wait()  # the joins stay untimed
            except threading.BrokenBarrierError:
                pass
            torch.cuda.synchronize()
            F.reset_launches()  # counts start at 0 just before the folds
            t0 = time.perf_counter()
            for t in threads:
                t.join()
            dt = time.perf_counter() - t0
            launches = F.launch_counts()
            got = srv.center()
            folds = ([len(srv.commit_log)] if n == 1
                     else [len(x.commit_log) for x in srv.servers])
        finally:
            srv.close()
        if errors:
            fail(f"sharded_center: {n} shards: {errors[0]!r}")
        equal = same_bits(got, oracle)
        total = W * commits
        point = {"shards": n, "folds_per_sec": total / dt,
                 "bytes_per_sec": total * center_bytes / dt,
                 "seconds": dt, "fold_launches": launches,
                 "folds_per_shard": folds, "shards_holding": holders,
                 "bit_equal_to_oracle": equal}
        if plan is not None:
            point["plan_loads"] = plan.loads
        curve.append(point)
        if not equal:
            failures.append(f"{n} shards: the center is not the oracle's")
        if launches.get("fold_commit") != total * holders or any(
                v for k, v in launches.items() if k != "fold_commit"):
            failures.append(f"{n} shards: {launches} for {total} commits "
                            f"on {holders} shards")
        if folds != [total] * len(folds):
            failures.append(f"{n} shards: folds a shard {folds}")
    base = curve[0]["folds_per_sec"]
    for pt in curve:
        pt["speedup_vs_1"] = pt["folds_per_sec"] / base
    emit({"phase": "sharded_center", "gpu": gpu,
          "config": "sharded_center (bench.py:898-979, sized at "
                    ":1484-1487)", **C10, "delta": C10_DELTA,
          "discipline": "adag", "codec": "none",
          "center_bytes": center_bytes, "shard_curve": curve,
          "speedup_vs_single_ps": curve[-1]["speedup_vs_1"],
          "reduced": "none",
          "seconds": time.perf_counter() - t_phase})
    if failures:
        fail("sharded_center: " + "; ".join(failures))
    return {str(pt["shards"]): pt["fold_launches"].get("fold_commit", 0)
            for pt in curve}


def cli_shards(workdir: str) -> dict:
    """Start the two CLI shard servers of the ``shard_crash`` drill
    (``python -m distkeras_tpu_torch.netps --shard k/2``, journal only,
    state in ``workdir/shard_crash/shard-<k>``) without waiting for them:
    their start-up overlaps the phases before. Both environments schedule
    ``SHARD_CRASH`` (only shard 1 fires it), each with a fired-fault
    journal of its own, so shard 1's restarted life does not crash
    again."""
    root = os.path.join(workdir, "shard_crash")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    shards = []
    for k in range(2):
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
        probe.close()
        d = os.path.join(root, f"shard-{k}")
        fired = os.path.join(root, f"shard-{k}.fired")
        env = dict(os.environ, DKTPU_NET_FAULTS=SHARD_CRASH,
                   DKTPU_FAULTS_STATE=fired)
        cmd = [sys.executable, "-m", "distkeras_tpu_torch.netps", "--host",
               "127.0.0.1", "--port", str(port), "--discipline", "dynsgd",
               "--device", "cuda", "--state-dir", d, "--snapshot-every", "0",
               "--lease", str(SHARD_CRASH_LEASE), "--shard", f"{k}/2"]
        shards.append({"dir": d, "endpoint": f"127.0.0.1:{port}", "cmd": cmd,
                       "env": env, "fired": fired,
                       "lives": [(time.monotonic(), subprocess.Popen(
                           cmd, stdout=subprocess.PIPE, text=True,
                           env=env))]})
    return {"root": root, "shards": shards,
            "endpoint": ";".join(x["endpoint"] for x in shards)}


def stop_cli(lives) -> None:
    """Kill every life of a CLI server still running."""
    for _t0, proc in lives:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def shard_crash_phase(torch, K, F, gpu: str, seed: int, cli: dict,
                      frame) -> dict:
    """The ``shard_crash`` drill: config #4 remote DynSGD (int8, 4 workers,
    3 rounds) against the two CLI shard servers of :func:`cli_shards`;
    shard 1 SIGKILLs itself after 4 folds (status -9) and is restarted on
    the same port and directory (a supervisor's role) while the workers
    ride through on retries. Checked: ``shard_crash`` fired once, on shard
    1; every acknowledged logical commit is journaled exactly once on each
    shard; the model is the assembled center; a server of this process
    built on shard 1's directory adopts its ``plan.json`` (shard 1 of 2,
    the run's plan), replays its journal with one ``fold_commit`` a record
    into shard 1's live center, admits a join with the plan and refuses a
    drifted one. Returns that replay's launches."""
    from distkeras_tpu_torch.netps import (PartitionPlan, PSClient,
                                           PSServer, ShardedPSClient,
                                           ShardPlanError, state)

    t_phase = time.perf_counter()
    W = REMOTE["num_workers"]
    rows = SHARD_CRASH_ROUNDS * W * REMOTE["communication_window"] \
        * REMOTE["batch_size"]
    shard0, shard1 = cli["shards"]

    def ready(sh) -> float:
        """Seconds from the shard's newest life's start to its
        ``NETPS_READY``."""
        t0, proc = sh["lives"][-1]
        line = proc.stdout.readline()
        if not line.startswith("NETPS_READY"):
            fail(f"shard_crash: a shard server did not start: {line!r}")
        return time.monotonic() - t0

    killed = {}

    def babysitter():
        first = shard1["lives"][0][1]
        while not killed.get("cancel") and first.poll() is None:
            time.sleep(0.02)
        if first.poll() is None:
            return
        killed["returncode"] = first.returncode
        shard1["lives"].append((time.monotonic(), subprocess.Popen(
            shard1["cmd"], stdout=subprocess.PIPE, text=True,
            env=shard1["env"])))
        killed["restart_s"] = ready(shard1)

    try:
        starts = [ready(shard0), ready(shard1)]
        watcher = threading.Thread(target=babysitter,
                                   name="shard-crash-babysitter")
        watcher.start()
        try:
            with acked_logical_commits() as acked:
                run = remote_run(torch, K, F, seed + 5,
                                 first_rows(frame, rows), cli["endpoint"],
                                 SHARD_CRASH_ROUNDS,
                                 DKTPU_NET_RETRIES="60",
                                 DKTPU_NET_TIMEOUT="20")
        finally:
            killed["cancel"] = True
            watcher.join()
        with ShardedPSClient(cli["endpoint"], timeout=20.0) as observer:
            live_center, live_updates = observer.pull()
            plan = observer.plan
        backends = []
        for sh in (shard0, shard1):
            with PSClient(sh["endpoint"], timeout=20.0) as c:
                backends.append(c.stats().get("fold_backend"))
        drained = []
        for sh in (shard0, shard1):
            proc = sh["lives"][-1][1]
            proc.send_signal(signal.SIGTERM)
            drained.append(proc.stdout.read().strip().splitlines()[-1:])
            proc.wait(timeout=60)
    finally:
        stop_cli(shard0["lives"])
        stop_cli(shard1["lives"])
    journaled = [[(int(r["wid"]), int(r["seq"]))
                  for r in state.read_journal(sh["dir"])]
                 for sh in (shard0, shard1)]
    fired = []
    for sh in (shard0, shard1):
        if os.path.exists(sh["fired"]):
            with open(sh["fired"]) as f:
                fired.append(f.read().split())
        else:
            fired.append([])
    # Shard 1's directory in this process: plan.json adopted, the journal
    # replayed one launch a record, the plan's joins admitted and a drifted
    # plan refused.
    F.reset_launches()
    back = PSServer(discipline="dynsgd", device="cuda",
                    state_dir=shard1["dir"])
    try:
        replay = F.launch_counts()["fold_commit"]
        replayed = back.recovered_records
        adopted = (back.shard_index, back.shard_count,
                   back.shard_plan.plan_hash if back.shard_plan else None)
        back_center = back.center()
        back.start()
        drifted = PartitionPlan.build(plan.names, plan.shapes, 2,
                                      rules=[(".*", 1)])

        def join_with(p):
            with PSClient(back.endpoint, timeout=20.0) as c:
                c._join_extra = {"shard_index": 1, "plan_hash": p.plan_hash,
                                 "shard_plan": p.to_dict()}
                try:
                    c.join()
                    return "admitted"
                except ShardPlanError:
                    return "refused"

        joins = {"plan": join_with(plan), "drifted": join_with(drifted)}
    finally:
        back.close()
    live1 = plan.shard_slice(live_center, 1)
    lost = [sorted(set(acked) - set(j)) for j in journaled]
    trained = [p.cpu().numpy() for p in run["trained"].params.values()]
    row = {"phase": "shard_crash", "gpu": gpu, "faults": SHARD_CRASH,
           **REMOTE, "rounds": SHARD_CRASH_ROUNDS, "codec": "int8",
           "lease_s": SHARD_CRASH_LEASE,
           "first_start_s": starts, "restart_s": killed.get("restart_s"),
           "first_life_returncode": killed.get("returncode"),
           "lives": [len(shard0["lives"]), len(shard1["lives"])],
           "fired_journals": fired, "seconds": run["wall"],
           "samples_per_s": run["samples_per_s"],
           "acked_logical_commits": len(acked),
           "journal_records": [len(j) for j in journaled],
           "lost_acked_records": lost, "final_updates": live_updates,
           "server_fold_backends": backends, "drained": drained,
           "plan_adopted": {"shard_index": adopted[0],
                            "shard_count": adopted[1],
                            "plan_hash_equal": adopted[2] == plan.plan_hash},
           "joins": joins, "replayed": replayed, "replay_launches": replay,
           "replay_equal_live": same_bits(back_center, live1),
           "model_equals_center": same_bits(trained, live_center),
           "launches": run["lstm"],
           "seconds_phase": time.perf_counter() - t_phase}
    emit(row)
    shutil.rmtree(cli["root"], ignore_errors=True)
    bad = []
    if (killed.get("returncode") != -signal.SIGKILL
            or "restart_s" not in killed or len(shard1["lives"]) != 2
            or len(shard0["lives"]) != 1):
        bad.append("shard 1 did not kill itself once and restart")
    if fired != [[], ["shard_crash@1"]]:
        bad.append(f"fired journals {fired}")
    for k, j in enumerate(journaled):
        if len(j) != len(set(j)):
            bad.append(f"shard {k} journaled a (worker, seq) twice")
    if any(lost):
        bad.append(f"acknowledged commits not journaled: {lost}")
    if not run["finite"]:
        bad.append("non-finite losses")
    if not row["model_equals_center"]:
        bad.append("the model is not the assembled center")
    if adopted[:2] != (1, 2) or adopted[2] != plan.plan_hash:
        bad.append(f"the restarted shard's plan {adopted}")
    if joins != {"plan": "admitted", "drifted": "refused"}:
        bad.append(f"joins {joins}")
    if replay != replayed or not row["replay_equal_live"]:
        bad.append(f"{replay} fold_commit launches for {replayed} replayed "
                   f"records; replay equal to the live shard: "
                   f"{row['replay_equal_live']}")
    if backends != ["cuda", "cuda"]:
        bad.append(f"the shards folded with {backends}")
    if bad:
        fail("shard_crash: " + "; ".join(bad))
    return {"replay": replay}


# -- the aggregation plane: the per-host aggregator and the trees ----------

#: ``netps_tree`` (b): config #4 remote DynSGD (int8) through a per-host
#: aggregator over the ring: ``REMOTE``'s 4 workers, window 4, batch 2048.
TREE_TRAIN_ROUNDS = 3
#: (c) the partition drill: the tree, its workers and rounds, and how long
#: the level-0 group-1 uplink is black-holed (``link_down@1:S``).
TREE_SPEC = "host:2,region:2"
TREE_WORKERS = 4
TREE_ROUNDS = 4
TREE_LINK_DOWN_S = 3.0
#: (d) the failover drill: rounds through the node, then through its
#: promoted standby; the standby promotes after this much silence.
TREE_FAILOVER_ROUNDS = (3, 3)
TREE_PROMOTE_AFTER = 1.0
#: the failover drill's commit, every element 2**-10 (exact in f32), so a
#: constituent landed twice moves the root's center by a whole step.
TREE_STEP = 2.0 ** -10


def wait_until(cond, seconds: float, what: str) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            fail(f"netps_tree: timed out waiting for {what}")
        time.sleep(0.02)


def precombine_windows(init: list, seed: int) -> list:
    """Three windows of three commits of ``init``'s tensors: f32, then
    bf16, then int8 (``wire.codec_encode`` of seeded deltas), each delta
    with a ``-0.0`` and a ``+0.0`` element; the int8 window's first commit
    carries a zero-scale tensor (all zeros: scale 0, which the kernel
    skips)."""
    from distkeras_tpu_torch.netps import wire

    rng = np.random.default_rng(seed)
    windows = []
    for codec in ("none", "bf16", "int8"):
        window = []
        for w in range(3):
            entries = []
            for i, a in enumerate(init):
                d = (rng.normal(size=a.shape) * 1e-3).astype(np.float32)
                d.reshape(-1)[0], d.reshape(-1)[-1] = -0.0, 0.0
                if codec == "int8" and w == 0 and i == 1:
                    d[...] = 0.0
                q, spec = wire.codec_encode(d, codec)
                entries.append((q, spec) if spec else q)
            window.append(entries)
        windows.append(window)
    return windows


def numpy_window(window: list) -> list:
    """The reference aggregator's window: the first commit decoded and
    copied, the rest decoded and added, in absorb order."""
    from distkeras_tpu_torch.netps import wire

    acc = None
    for entries in window:
        dec = [np.asarray(wire.codec_decode(*e) if isinstance(e, tuple)
                          else e, np.float32) for e in entries]
        if acc is None:
            acc = [a.copy() for a in dec]
        else:
            for a, d in zip(acc, dec):
                a += d
    return acc


def precombine_chain(torch, F, init: list, windows: list, device: str
                     ) -> dict:
    """An aggregator (``fan_in=3``) in front of a root, both on
    ``device``; three workers commit each window's wire entries as sent.
    Records every combined commit the aggregator flushes and the
    ``fold_commit`` launches of each window (counts set to 0 just before
    it, read once the root folded it)."""
    from distkeras_tpu_torch.netps import (AggregatorServer, PSClient,
                                           PSServer)

    root = PSServer(center=init, discipline="aeasgd", device=device).start()
    agg = AggregatorServer(upstream=root.endpoint, discipline="aeasgd",
                           fan_in=3, flush_interval=3600.0, device=device,
                           timeout=120.0).start()
    sent, launches = [], []
    real_commit = agg._up.commit

    def recording(delta, pulled, *a, **kw):
        sent.append([np.array(d, np.float32) for d in delta])
        return real_commit(delta, pulled, *a, **kw)

    agg._up.commit = recording
    clients = [PSClient(agg.endpoint, worker_id=w, timeout=120.0)
               for w in range(3)]
    try:
        for c in clients:
            c.join()
        for k, window in enumerate(windows):
            if device == "cuda":
                torch.cuda.synchronize()
            F.reset_launches()
            for c, entries in zip(clients, window):
                _, u = c.pull()
                hdr, _ = c._rpc("commit", {"seq": k, "pulled": u}, entries)
                if not hdr.get("applied"):
                    fail(f"netps_tree (a): a commit was not absorbed: {hdr}")
            wait_until(lambda: len(root.commit_log) == k + 1, 120.0,
                       f"window {k} at the root")
            launches.append(F.launch_counts()["fold_commit"])
    finally:
        for c in clients:
            c.close()
        agg.close()
    center, log = root.center(), list(root.commit_log)
    root.close()
    return {"sent": sent, "center": center, "launches": launches,
            "root_commits": len(log), "absorbed": agg.absorbed,
            "fold_backend": "cuda" if agg._flat.is_cuda else "torch-cpu"}


def precombine_times(torch, F, init: list, entries: list) -> dict:
    """One scale-1 pre-combine of a config #8 f32 commit into a window
    seated as the aggregator seats it, by CUDA events (L2 flushed, the card
    held by a spin before each call): the kernel, its plain twin and the
    per-tensor ``add_`` loop (no one PyTorch call folds a commit); the
    bound; and the host wall of the take's device-to-host copy of the
    window."""
    from distkeras_tpu_torch.netps.fold import (fold_staged, host_mirror,
                                                seat_center, stage_commit)

    flat, offsets, views = seat_center(init, "cuda")
    flat.fill_(-0.0)
    staged = stage_commit(entries, "cuda")
    wires = [F.wire_view(staged.buf, r) for r in staged.rows]
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")

    def add_loop():
        for v, w in zip(views, wires):
            v.add_(w.view(v.shape))

    out = {key: cuda_ms_cold(torch, fn, FOLD_REPS, flush, head_start=True)
           for key, fn in (
               ("ms", lambda: fold_staged(views, staged, 1.0)),
               ("plain_ms", lambda: F.fold_commit_plain_(views, staged, 1.0)),
               ("library_ms", add_loop))}
    n = sum(v.numel() for v in views)
    out["bound_ms"], out["bound_by"] = bound(12 * n, 2 * n, PEAK_F32_FLOPS)
    takes = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host_mirror(flat, offsets, views)
        takes.append((time.perf_counter() - t0) * 1e3)
    out["take_ms"] = float(np.median(takes[1:]))
    out["params"] = n
    out["timing"] = ("CUDA events around one fold_staged (one fold_commit "
                     "launch) of an f32 commit at scale 1, L2 flushed and "
                     "the card held by a spin before it; take_ms: host "
                     "clock of the window's device-to-host copy, median "
                     "of 5 after one")
    del flush
    return out


def netps_tree_phase(torch, K, F, gpu: str, seed: int, c8init: dict,
                     frame) -> dict:
    """The aggregation plane on the card. (a) The pre-combine's bits at
    config #8's width: three windows of three commits of its 70 tensors
    (f32, bf16, int8) through an aggregator (``fan_in=3``) in front of a
    root, both on the card: each flushed combined commit bit-equal to the
    numpy decode-then-add, the root's center bit-equal to a CPU run of the
    same commits and to the numpy chain, 3 aggregator launches and 1 root
    launch a window; and the pre-combine's time beside its bound. (b)
    Config #4 ``DynSGD(..., remote=...)`` under ``DKTPU_NET_HIER=1`` over
    the ring, 4 workers: finite losses, the center moved, each worker
    commit absorbed once, each combined commit folded once at the root.
    (c) A ``build_tree("host:2,region:2", root, workers=4)`` on the card
    under ``link_down@1:S`` (the level-0 group-1 uplink): its windows
    buffer, then drain in order; no silent loss anywhere; the root folds
    exactly the top node's forwarded windows. (d) A ``TreeNode`` with a
    journal and its ``TreeStandby``; the node is stopped as its death
    would stop it, with a window open: the standby promotes, fences and
    joins the root, the children re-parent through their endpoint list,
    no constituent lands twice, and the dead window is counted lost.
    Returns the ``fold_commit`` launches of (a)-(d)."""
    from distkeras_tpu_torch import imdb_lstm, telemetry
    from distkeras_tpu_torch.netps import (PSClient, PSServer, TreeNode,
                                           TreeSpec, TreeStandby,
                                           build_tree, state)

    t_phase = time.perf_counter()
    failures = []

    # (a) the pre-combine's bits and time at config #8's width.
    init8 = [v.detach().float().cpu().numpy() for v in c8init.values()]
    windows = precombine_windows(init8, seed + 19)
    card = precombine_chain(torch, F, init8, windows, "cuda")
    host = precombine_chain(torch, F, init8, windows, "cpu")
    want = [a.copy() for a in init8]
    window_bits = []
    for k, window in enumerate(windows):
        acc = numpy_window(window)
        window_bits.append(k < len(card["sent"])
                           and same_bits(card["sent"][k], acc))
        for c, a in zip(want, acc):
            c += a
    pre = {"tensors": len(init8), "params": int(sum(a.size for a in init8)),
           "codecs": ["none", "bf16", "int8"],
           "windows_bit_equal": window_bits,
           "root_equal_cpu_run": same_bits(card["center"], host["center"]),
           "root_equal_numpy": same_bits(card["center"], want),
           "launches_per_window": card["launches"],
           "root_commits": card["root_commits"],
           "absorbed": card["absorbed"],
           "fold_backend": card["fold_backend"]}
    if (not all(window_bits) or not pre["root_equal_cpu_run"]
            or not pre["root_equal_numpy"] or card["launches"] != [4] * 3
            or card["root_commits"] != 3 or card["absorbed"] != 9
            or card["fold_backend"] != "cuda"):
        failures.append(f"(a) the pre-combine: {pre}")
    times = precombine_times(torch, F, init8, windows[0][0])
    pre["times"] = times
    del card, host, windows
    torch.cuda.empty_cache()

    # (b) config #4 remote DynSGD through a per-host aggregator.
    W = REMOTE["num_workers"]
    rows = TREE_TRAIN_ROUNDS * W * REMOTE["communication_window"] \
        * REMOTE["batch_size"]
    root = PSServer(discipline="dynsgd", device="cuda",
                    transport="shm").start()
    try:
        with recorded_aggregators() as made:
            run = remote_run(torch, K, F, seed + 9, first_rows(frame, rows),
                             root.endpoint, TREE_TRAIN_ROUNDS,
                             DKTPU_NET_HIER="1", DKTPU_NET_TRANSPORT="shm")
        log, center = list(root.commit_log), root.center()
    finally:
        root.close()
    every = sorted((w, s) for w in range(W) for s in range(TREE_TRAIN_ROUNDS))
    trained = [p.cpu().numpy() for p in run["trained"].params.values()]
    moved = max(float(np.abs(a - b.detach().cpu().numpy()).max())
                for a, b in zip(trained,
                                run["trainer"].model.params.values()))
    agg = made[0] if len(made) == 1 else None
    steps = TREE_TRAIN_ROUNDS * W * REMOTE["communication_window"]
    trainer_row = {"workers": W, "rounds": TREE_TRAIN_ROUNDS,
                   "transport": "shm", "codec": "int8",
                   "seconds": run["wall"],
                   "samples_per_s": run["samples_per_s"],
                   "root_commits": len(log), "fold_launches": run["fold"],
                   "lstm_launches": run["lstm"],
                   "center_max_abs_change": moved}
    if agg is None:
        failures.append(f"(b) {len(made)} aggregators built")
    else:
        trainer_row.update(absorbed=agg.absorbed, forwarded=agg.forwarded,
                           forwarded_commits=agg.forwarded_commits,
                           lost_commits=agg.lost_commits,
                           aggregator_device=str(agg.device))
        if (sorted((w, s) for w, s, _ in agg.commit_log) != every
                or agg.absorbed != agg.forwarded_commits + agg.lost_commits
                or agg._acc_count or not exactly_once(log)
                or {w for w, _s, _ in log} != {agg._up.worker_id}
                or len(log) != agg.forwarded
                or run["fold"].get("fold_commit") != agg.absorbed + len(log)
                or agg.device.type != "cuda"):
            failures.append(f"(b) exactly-once at both levels: {trainer_row}")
    if (not run["finite"] or not moved > 0 or not same_bits(trained, center)
            or run["lstm"].get("lstm_fwd_stash") != steps
            or run["lstm"].get("lstm_bwd") != steps):
        failures.append(f"(b) the run: finite {run['finite']}, moved "
                        f"{moved}, the model the root's center "
                        f"{same_bits(trained, center)}, {run['lstm']}")
    del run, trained
    torch.cuda.empty_cache()

    # (c) the partition drill through a two-level tree.
    init4 = [v.detach().float().cpu().numpy() for v in imdb_lstm(
        vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
        seq_len=SEQ_LEN, seed=seed, device="cpu").params.values()]
    rng = np.random.default_rng(seed + 23)
    deltas = {(w, r): [(rng.normal(size=a.shape) * 1e-3).astype(np.float32)
                       for a in init4]
              for w in range(TREE_WORKERS) for r in range(TREE_ROUNDS)}
    spec = TreeSpec.parse(TREE_SPEC)
    key = TreeSpec.link_key(0, 1)
    telemetry.reset()
    root = PSServer(center=init4, discipline="adag", device="cuda").start()
    tree = None
    dark = None
    try:
        with fault_plan(net=f"link_down@{key}:{TREE_LINK_DOWN_S}") as (
                _, net):
            tree = build_tree(spec, root.endpoint, workers=TREE_WORKERS,
                              discipline="adag", device="cuda",
                              flush_interval=0.05, timeout=60.0,
                              probe_links=False)
            nodes = [n for lvl in tree.nodes.values() for n in lvl.values()]
            errors = []

            def work(w: int) -> None:
                try:
                    with PSClient(tree.leaf_endpoint(w), worker_id=w,
                                  timeout=60.0) as c:
                        c.join()
                        for r in range(TREE_ROUNDS):
                            _, u = c.pull()
                            if not c.commit(deltas[w, r], u).applied:
                                errors.append(f"({w}, {r}) not applied")
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(repr(e))

            torch.cuda.synchronize()
            F.reset_launches()  # counts start at 0 just before the drill
            t0 = time.perf_counter()
            threads = [threading.Thread(target=work, args=(w,))
                       for w in range(TREE_WORKERS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            dark = tree.node(0, 1).tree_stats()
            cut = tree.node(0, 1)
            wait_until(lambda: cut.tree_stats()["buffered_windows"] == 0
                       and not cut.tree_stats()["link_down"], 60.0,
                       "the partitioned uplink to drain")
            tree.close()
            partition_s = time.perf_counter() - t0
            ledgers = {f"L{n.level}g{n.group}": n.tree_stats()
                       for n in nodes}
            tree_launches_c = F.launch_counts()
            missed = unfired(net)
        drained = telemetry.get().snapshot()["counters"].get(
            "netps.tree.drained_windows", 0)
        log, center = list(root.commit_log), root.center()
    finally:
        if tree is not None and dark is None:
            tree.close()
        root.close()
    top = tree.node(1, 0)
    cut_wid = cut._up.worker_id
    from_cut = [s for w, s, _ in top.commit_log if w == cut_wid]
    sum_want = [a + sum(deltas[w, r][i] for w in range(TREE_WORKERS)
                        for r in range(TREE_ROUNDS))
                for i, a in enumerate(init4)]
    # Every delta folded once, summed in another order: within f32
    # rounding of the values (a lost or doubled delta is ~1e-3 off).
    off = max(float((np.abs(c - w) / (np.abs(w) + 1e-1)).max())
              for c, w in zip(center, sum_want))
    leaves = [tree.node(0, g) for g in range(spec.nodes_at(0, TREE_WORKERS))]
    partition = {"spec": TREE_SPEC, "workers": TREE_WORKERS,
                 "rounds": TREE_ROUNDS, "fault": f"link_down@{key}:"
                                                 f"{TREE_LINK_DOWN_S}",
                 "unfired": missed, "errors": errors,
                 "dark": {k: dark[k] for k in (
                     "link_down", "buffered_windows", "buffered_commits",
                     "absorbed", "forwarded", "silent_loss")},
                 "ledgers": ledgers, "drained_windows": drained,
                 "root_commits": len(log),
                 "seqs_from_the_cut_uplink": from_cut,
                 "center_rel_off_the_sum": off,
                 "fold_launches": tree_launches_c, "seconds": partition_s}
    absorbed_all = sum(n.absorbed for n in nodes)
    if (missed or errors or not dark["link_down"]
            or dark["buffered_windows"] < 1
            or any(v["silent_loss"] or v["dropped_commits"]
                   or v["lost_commits"] or v["buffered_commits"]
                   or v["open_commits"] for v in ledgers.values())
            or sum(n.absorbed for n in leaves)
            != TREE_WORKERS * TREE_ROUNDS
            or top.absorbed != sum(n.forwarded for n in leaves)
            or len(log) != top.forwarded or not exactly_once(log)
            or any(not exactly_once(n.commit_log) for n in nodes)
            or from_cut != list(range(cut.forwarded)) or not drained
            or off > 2e-6
            or tree_launches_c.get("fold_commit") != absorbed_all + len(log)):
        failures.append(f"(c) the partition drill: {partition}")

    # (d) the failover drill: a journaled node, its standby, a hard stop.
    workdir = os.path.join("build", "netps_tree")
    shutil.rmtree(workdir, ignore_errors=True)
    root = PSServer(center=init4, discipline="adag", device="cuda",
                    lease_s=30.0).start()
    node = TreeNode(root.endpoint, level=0, group=0, spec="host:2",
                    fan_in=1, flush_interval=0.05, device="cuda",
                    state_dir=os.path.join(workdir, "node"),
                    timeout=60.0, probe_links=False).start()
    sb = TreeStandby(node.endpoint, upstream=root.endpoint, level=0,
                     group=0, spec="host:2", fan_in=1, flush_interval=0.05,
                     promote_after=TREE_PROMOTE_AFTER, device="cuda",
                     state_dir=os.path.join(workdir, "standby"),
                     timeout=60.0, probe_links=False).start()
    landed = {"node": [], "standby": []}

    def record(srv, label):
        real = srv._send_window

        def send(win):
            out = real(win)
            if out == "ok":
                landed[label].extend(win.pairs)
            return out

        srv._send_window = send

    record(node, "node")
    record(sb, "standby")
    step = [np.full(a.shape, TREE_STEP, np.float32) for a in init4]
    served = f"{node.endpoint},{sb.endpoint}"
    clients = [PSClient(served, worker_id=w, timeout=10.0, retries=20,
                        backoff=0.05) for w in range(2)]
    before, after = TREE_FAILOVER_ROUNDS
    acked = 0
    try:
        torch.cuda.synchronize()
        F.reset_launches()  # counts start at 0 just before the drill
        for c in clients:
            c.join()
        for r in range(before + after):
            if r == before - 1:
                # The last window before the death stays open.
                wait_until(lambda: node.forwarded_commits == node.absorbed,
                           30.0, "the node's windows at the root")
                node.flush_interval = 3600.0
                node.set_fan_in(10 ** 6)
            if r == before:
                wait_until(lambda: sb._updates == node._absorbs, 30.0,
                           "the standby to replicate the node's absorbs")
                at_death = node.tree_stats()
                t_kill = time.perf_counter()
                hard_stop(node)
                node._flusher_thread.join()
                node._up.close()  # its uplink dies with it
                wait_until(lambda: sb.promoted, 30.0, "the promotion")
                promoted_s = time.perf_counter() - t_kill
            for c in clients:
                _, u = c.pull()
                acked += bool(c.commit(step, u).applied)
        wait_until(lambda: sb.forwarded_commits == sb.absorbed, 30.0,
                   "the standby's windows at the root")
    finally:
        for c in clients:
            c.close()
        sb.close()
        node.close()  # its final flush fails: a counted lost window
    failover_launches = F.launch_counts()
    log, center = list(root.commit_log), root.center()
    root.close()
    journals = {label: [(int(x["wid"]), int(x["seq"]), int(x["e"]))
                        for x in state.read_journal(
                            os.path.join(workdir, label))]
                for label in ("node", "standby")}
    shutil.rmtree(workdir, ignore_errors=True)
    pairs = landed["node"] + landed["standby"]
    k = len(pairs)
    # Every window the root folded held one commit of one step: its
    # center is the init plus k steps, added one at a time, bit for bit.
    steps_center = [a.copy() for a in init4]
    for _ in range(k):
        for c, st in zip(steps_center, step):
            c += st
    k_bits = same_bits(center, steps_center)
    node_l, sb_l = node.tree_stats(), sb.tree_stats()
    failover = {"rounds": TREE_FAILOVER_ROUNDS, "acked": acked,
                "promoted": sb.promoted, "epoch": sb.epoch,
                "seconds_to_promotion": promoted_s,
                "promote_after": TREE_PROMOTE_AFTER,
                "open_at_death": at_death["open_commits"],
                "node": {k_: node_l[k_] for k_ in (
                    "absorbed", "forwarded_commits", "lost_windows",
                    "lost_commits", "silent_loss")},
                "standby": {k_: sb_l[k_] for k_ in (
                    "absorbed", "forwarded_commits", "lost_windows",
                    "lost_commits", "silent_loss")},
                "landed_constituents": k, "root_commits": len(log),
                "root_workers": sorted({w for w, _s, _ in log}),
                "center_is_init_plus_landed_steps": k_bits,
                "journal_records": {lb: len(j) for lb, j in
                                    journals.items()},
                "fold_launches": failover_launches}
    total = 2 * (before + after)
    if (not sb.promoted or sb.epoch < 1 or acked != total
            or len(pairs) != len(set(pairs))
            or k != node.forwarded_commits + sb.forwarded_commits
            or k + node.lost_commits + sb.lost_commits != total
            or at_death["open_commits"] != 2 or node.lost_windows != 1
            or node_l["silent_loss"] or sb_l["silent_loss"]
            or not exactly_once(log) or len({w for w, _s, _ in log}) != 2
            or not k_bits
            or any(len({(w, s) for w, s, _e in j}) != len(j)
                   for j in journals.values())
            or max(e for _w, _s, e in journals["standby"]) < 1
            or failover_launches.get("fold_commit")
            != node.absorbed + sb.absorbed + len(log)):
        failures.append(f"(d) the failover drill: {failover}")

    # (e) a leaf's uplink probe sweep: one TreeNode with probe_links
    # against a root on the card over TCP, config #8's center as the
    # payload; then one commit through the link it picked.
    probe_link, probe_link_launches = tree_probe_link(torch, F, init8, seed)
    if probe_link["failures"]:
        failures += probe_link.pop("failures")
    else:
        probe_link.pop("failures")

    emit({"phase": "netps_tree", "gpu": gpu, "precombine": pre,
          "aggregator_trainer": trainer_row, "partition": partition,
          "failover": failover, "probe_link": probe_link,
          "reduced": "none of width: (a) and (e) at config #8's 70 "
                     "tensors, (b)-(d) at config #4's; (c), (d) and (e) "
                     "drive raw commits of seeded deltas, not a trainer; "
                     "(c) and (d) keep their links' negotiated codec "
                     "(probe_links=False), so their sums stay exact",
          "seconds": time.perf_counter() - t_phase})
    if failures:
        fail("netps_tree: " + "; ".join(failures))
    return {"precombine": sum(pre["launches_per_window"]),
            "trainer": trainer_row["fold_launches"].get("fold_commit", 0),
            "partition": tree_launches_c.get("fold_commit", 0),
            "failover": failover_launches.get("fold_commit", 0),
            "probe_link": probe_link_launches,
            "probe_link_probes": probe_link["root_probes"],
            "times": times}


def tree_probe_link(torch, F, init: list, seed: int) -> tuple:
    """Check (e) of ``netps_tree``: a ``TreeNode`` on the card with
    ``probe_links=True`` (the default) joins a root on the card over TCP,
    sweeps the codecs over its uplink with its center as the payload (the
    root decodes each probe into its scratch window: one ``fold_commit``
    a probe) and retunes to the winner; its ``netps_tree_link_codec``
    event must read ``how="probed"`` and name the codec its uplink runs.
    Then one seeded commit through the leaf: absorbed once, folded once at
    the root. Returns ``(row, fold_commit launches)``; the row's
    ``failures`` lists what failed."""
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.netps import PSClient, PSServer, TreeNode, wire
    from distkeras_tpu_torch.runtime import config

    rng = np.random.default_rng(seed + 24)
    delta = [(rng.normal(size=a.shape) * 1e-3).astype(np.float32)
             for a in init]
    telemetry.reset()
    root = PSServer(center=init, discipline="adag", device="cuda").start()
    node = None
    try:
        torch.cuda.synchronize()
        F.reset_launches()  # counts start at 0 just before the leaf joins
        t0 = time.perf_counter()
        node = TreeNode(root.endpoint, level=0, group=0, spec="host:1",
                        fan_in=1, flush_interval=0.05, device="cuda",
                        timeout=60.0, probe_links=True).start()
        sweep_s = time.perf_counter() - t0
        with PSClient(node.endpoint, worker_id=0, timeout=60.0) as c:
            _, u = c.join()
            applied = c.commit(delta, u).applied
        wait_until(lambda: node.forwarded == 1, 60.0,
                   "the leaf's window to land at the root")
        leaf, node = node, None
        link, uplink = leaf.link_codec, leaf._up.codec
        leaf.close()
        launches = F.launch_counts()
        log = list(root.commit_log)
    finally:
        if node is not None:
            node.close()
        root.close()
    events = telemetry.get().events()
    picks = [{k: e.get(k) for k in ("how", "codec")} for e in events
             if e["kind"] == "netps_tree_link_codec"]
    probes = [{k: e.get(k) for k in ("codec", "probes", "seconds", "score")}
              for e in events if e["kind"] == "tuner_probe"]
    served = int(telemetry.get().snapshot()["counters"].get("netps.probes",
                                                            0))
    per = config.env_int("DKTPU_TUNE_PROBES")
    row = {"tensors": len(init), "params": int(sum(a.size for a in init)),
           "transport": "tcp", "link_codec_events": picks, "probes": probes,
           "winner": max(probes, key=lambda r: r["score"])["codec"]
           if probes else None,
           "link_codec": link, "uplink_codec": uplink,
           "root_probes": served, "sweep_seconds": sweep_s,
           "commit_applied": applied, "root_commits": len(log),
           "fold_launches": launches, "failures": []}
    if (picks != [{"how": "probed", "codec": link}] or link != uplink
            or [p["codec"] for p in probes] != list(wire.CODECS)
            or served != per * len(wire.CODECS) or not applied
            or len(log) != 1 or not exactly_once(log)
            or launches.get("fold_commit") != served + 2):
        row["failures"].append(f"(e) the leaf's probe sweep: {row}")
    return row, launches.get("fold_commit", 0)


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
    """The flash kernel instantiations' registers and spills
    (FLASH_KERNELS)."""
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


def transformer_parity_phase(torch, seed: int, cfg: dict = LM_PARITY,
                             phase: str = "transformer_parity",
                             logits_share: float = LM_PARITY_LOGITS_SHARE,
                             f64_beside: bool = False) -> None:
    """A small transformer (``cfg``) from one seed: logits, then one AEASGD
    round, on the card (the kernels) and on the CPU (the twins), and on
    the CPU with dense f32 attention, the yardstick for the rounding the
    design puts in. With ``f64_beside``, also the CPU's logits with every
    op outside the flash twin in float64: how far f32 rounding before the
    kernel's bf16 roundings moves them (what sets
    LM_PARITY_HD256_LOGITS_SHARE)."""
    from distkeras_tpu_torch import AEASGD, small_transformer_lm

    W, Kw, B = (LM_PARITY_TRAIN["num_workers"],
                LM_PARITY_TRAIN["communication_window"],
                LM_PARITY_TRAIN["batch_size"])
    df = lm_frame(W * Kw * B, cfg["vocab_size"], LM_PARITY_SEQ, seed + 3)
    probe = df["features"][:B]
    out = {}
    for run, dev, impl, dtype in (
            ("card", "cuda", "flash", None), ("cpu", "cpu", "flash", None),
            ("cpu_dense", "cpu", "dense", None),
            ("card_bf16", "cuda", "flash", "bfloat16"),
            ("cpu_bf16", "cpu", "flash", "bfloat16")):
        model = small_transformer_lm(**cfg, seq_len=LM_PARITY_SEQ,
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

    upstream = {}
    if f64_beside:
        model = small_transformer_lm(**cfg, seq_len=LM_PARITY_SEQ,
                                     attn_impl="flash", seed=seed + 3,
                                     device="cpu")
        with torch.no_grad():
            f64 = model.module.double()(torch.as_tensor(probe)).float()
        upstream["logits_max_abs_err_cpu_f32_vs_f64_outside_flash"] = (
            f64 - out["cpu"][0]).abs().max().item()
        del model

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
    emit({"phase": phase, "trainer": "AEASGD",
          "model": "TransformerLM(attn_impl='flash')", **cfg,
          "head_dim": cfg["d_model"] // cfg["num_heads"],
          "seq_len": LM_PARITY_SEQ, **LM_PARITY_TRAIN, "rounds": 1,
          "logits_max_abs_err_card_vs_cpu": logits_card,
          "logits_max_abs_err_cpu_flash_vs_dense": logits_design,
          **upstream,
          "center_mean_abs_err_card_vs_cpu": center_card,
          "center_mean_abs_err_cpu_flash_vs_dense": center_design,
          "center_max_abs_err_card_vs_cpu": dist("card", "cpu", 1, "max"),
          "center_max_abs_err_cpu_flash_vs_dense":
              dist("cpu", "cpu_dense", 1, "max"),
          "center_max_abs_change": change,
          "logits_share": logits_share,
          "center_share": LM_PARITY_CENTER_SHARE,
          "history": {k: [float(h) for h in v[2]] for k, v in out.items()},
          "compared": "logits by their largest error; the center by its "
                      "mean error (adam turns gradients that are rounding "
                      "noise into steps of about lr of either sign, so a "
                      "few elements differ by that in every pair of runs)"})
    if not change > 0:
        fail(f"{phase}: the run's center did not move")
    if not (0 < logits_design and logits_card
            <= logits_share * logits_design):
        fail(f"{phase}: logits, card vs CPU {logits_card} > "
             f"{logits_share} x the CPU flash-vs-dense {logits_design}")
    if not (0 < center_design and center_card
            <= LM_PARITY_CENTER_SHARE * center_design):
        fail(f"{phase}: center, card vs CPU {center_card} > "
             f"{LM_PARITY_CENTER_SHARE} x the CPU flash-vs-dense "
             f"{center_design}")
    bf16 = {"cuda_bf16": (out["card_bf16"][1],), "cpu_bf16": (
        out["cpu_bf16"][1],), "cpu": (out["cpu"][1],)}
    bf16_parity(phase, bf16, change, extra={
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


def warmup_kernels() -> dict:
    """``{"module.kernel": count}`` of the launches that warm-up rounds
    before a CUDA graph capture made since the counts were last set to 0
    (``ops/kernels/build.py launch_tape``), which :func:`launched_kernels`
    holds too."""
    return {f"{name}.{k}": v for name, mod in kernel_modules().items()
            for k, v in mod.warmup_counts().items() if v}


#: the device kernels that one counted launch runs once each, by the
#: counted kernels that run them (the profiler's kernel name, its template
#: arguments and parameters left out): in a profile, a family's kernel
#: events equal the sum of its counted launches
DEVICE_FAMILIES = {
    ("lstm.lstm_fwd", "lstm.lstm_fwd_stash"):
        ("lstm_fwd_cluster", "lstm_fwd_tc", "lstm_fwd_xw_tc"),
    ("lstm.lstm_bwd",): ("lstm_bwd_rec_cluster", "lstm_bwd_rec_tc"),
    ("groupnorm.group_norm_fwd",): ("gn_fwd",),
    ("groupnorm.group_norm_bwd",): ("gn_bwd",),
    ("flash_attention.flash_fwd",): ("flash_fwd_kernel",),
    ("flash_attention.flash_dq",): ("flash_dq_kernel",),
    ("flash_attention.flash_dkv",): ("flash_dkv_kernel",),
}


def device_kernel_name(name: str) -> str:
    """A profiler's CUDA kernel name without its return type, namespaces,
    template arguments and parameters: ``void ns::gn_fwd<float, 4>(...)``
    gives ``gn_fwd``."""
    head = re.split(r"[<(]", name.replace("(anonymous namespace)", ""), 1)[0]
    return head.split("::")[-1].split()[-1] if head.split() else head


def device_family_counts(torch, prof) -> dict:
    """``{family: kernel events}`` (:data:`DEVICE_FAMILIES`, keyed by its
    counted kernels joined by ``+``) of the device kernels ``prof`` saw."""
    cuda = torch.autograd.DeviceType.CUDA
    seen = collections.Counter(
        device_kernel_name(e.name())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == cuda)
    return {"+".join(counted): sum(seen[k] for k in kernels)
            for counted, kernels in DEVICE_FAMILIES.items()}


def family_launches(launches: dict) -> dict:
    """``launches`` (``{"module.kernel": count}``) summed as
    :func:`device_family_counts` keys its families."""
    return {"+".join(counted): sum(launches.get(k, 0) for k in counted)
            for counted in DEVICE_FAMILIES}


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


# -- the resilience plane: ensembles, fault drills, network chaos -----------

#: ``ensemble_train``: config #4's training run (``TRAIN``'s 4 workers,
#: window 4, batch 2048) for ``ENSEMBLE_ROUNDS`` rounds under
#: ``AveragingTrainer`` and ``EnsembleTrainer``; the card-vs-CPU parity at
#: ``ENSEMBLE_PARITY`` (full width, 4 workers, batch 32, window 2, as
#: ``train_parity`` cuts config #4), ``ENSEMBLE_PARITY_ROUNDS`` round.
ENSEMBLE_ROUNDS = 2
ENSEMBLE_PARITY = dict(PARITY, num_workers=4)
ENSEMBLE_PARITY_ROUNDS = 1
#: ``fault_drills`` (a): config #2 (``CNN_TRAIN``'s mnist_cnn ADAG: adam,
#: batch 2048, window 8, 4 workers), 2 rounds, round 1's batch poisoned on
#: the seeded worker and the divergent-worker reset on; its parity at
#: ``CNN_PARITY``'s cut with 4 workers and 2 rounds.
DRILL_NAN = "nan@1"
DRILL_RESET = 1000.0
DRILL_CNN_PARITY = dict(CNN_PARITY, num_workers=4)
#: (b) and (c): config #4's DynSGD (``TRAIN``) for ``DRILL_ROUNDS`` rounds
#: with a checkpoint a round, under ``Supervisor(backoff_s=0)``; (b)
#: crashes before round 2, (c) also corrupts step 1 after it is written, so
#: the resume falls back to step 0.
DRILL_ROUNDS = 3
DRILL_CRASH = "crash@2"
DRILL_CORRUPT = "ckpt_corrupt@1;crash@2"
#: ``netps_chaos``: config #4 remote DynSGD with int8 commits against the
#: port's server on the card. (a) one worker through the ``ChaosProxy``
#: (frame 0 is the join, then a pull and a commit a round, so
#: ``CHAOS_ROUNDS`` rounds reach frame 16); (b) 4 workers, the seeded one
#: silent for twice the lease before round 2; (c) one worker on the shm
#: ring with the ring's own faults. A short deadline so a drop costs 2 s
#: (``DKTPU_NET_TIMEOUT``), enough retries to ride out the partition, and
#: in (b) alone a short lease so the eviction costs 2 s (the server's
#: ``lease_s``; (a) and (c) keep the default lease, which outlasts a
#: dropped frame's deadline, so no worker there is evicted).
CHAOS_WIRE = "delay@6:0.2;drop@11;dup@8;drop_r@9;partition@14:0.8;seed=3"
CHAOS_EVICT = "evict@2:0"
CHAOS_RING = "shm_delay@3:0.2;shm_corrupt@6"
CHAOS_ROUNDS = 8
CHAOS_EVICT_ROUNDS = 3
CHAOS_LEASE = 1.0
CHAOS_ENV = dict(DKTPU_NET_TIMEOUT="2", DKTPU_NET_RETRIES="30")
#: the serving drill: the accepted-request index of the held reply (and
#: the seconds it is held) and of the dropped connection.
SERVE_SLOW_AT, SERVE_SLOW_S, SERVE_DROP_AT = 1, 0.3, 2
#: rows of the one config #4 frame these three phases share, made once
#: (``imdb()`` takes seconds at this size): the most any of them trains on,
#: 3 rounds of 4 workers, window 4, batch 2048; each takes its first rows.
RESILIENCE_ROWS = (max(ENSEMBLE_ROUNDS, DRILL_ROUNDS, CHAOS_EVICT_ROUNDS)
                   * TRAIN["num_workers"] * TRAIN["communication_window"]
                   * TRAIN["batch_size"])


def first_rows(frame, n: int):
    """The first ``n`` rows of ``frame`` as a DataFrame of their own."""
    from distkeras_tpu_torch.data import DataFrame

    if n > len(frame):
        fail(f"the shared frame has {len(frame)} rows, {n} asked for")
    return DataFrame(frame.head(n))


@contextlib.contextmanager
def fault_plan(spec: str = "", net: str = ""):
    """Install ``spec`` (``DKTPU_FAULTS`` grammar) and ``net``
    (``DKTPU_NET_FAULTS``) as this process's ambient plans for the block,
    yield them, and clear every plan after it (``resilience.reset``), so
    no fault leaks into a later phase or is used up there."""
    from distkeras_tpu_torch import resilience
    from distkeras_tpu_torch.resilience import faults

    resilience.reset()
    plan = resilience.FaultPlan.parse(spec) if spec else None
    net_plan = resilience.FaultPlan.parse_net(net) if net else None
    resilience.set_plan(plan)
    faults.set_net_plan(net_plan)
    try:
        yield plan, net_plan
    finally:
        resilience.reset()


def unfired(*plans) -> list:
    """The scheduled faults of ``plans`` that did not fire."""
    return sorted(k for p in plans if p is not None
                  for k in set(p.faults) - set(p._fired))


def counters(*names) -> dict:
    from distkeras_tpu_torch import telemetry

    got = telemetry.get().snapshot()["counters"]
    return {n: got.get(n, 0) for n in names}


def member_dict(models) -> dict:
    """One parameter dict of a list of models (``"<i>.<name>"`` keys), so
    the parity helpers hold every ensemble member at once."""
    return {f"{i}.{k}": v.detach().cpu() for i, m in enumerate(models)
            for k, v in m.params.items()}


def ensemble_phase(torch, K, gpu: str, seed: int, frame) -> dict:
    """``AveragingTrainer`` then ``EnsembleTrainer`` on config #4 as a user
    drives them, in f32 and bf16: each run's LSTM counts set to 0 just
    before ``train`` and read just after (the stash forward and the
    backward once a local step, in the run's dtype only). Then each
    trainer at ``ENSEMBLE_PARITY`` on the card and on the CPU from the same
    weights and per-worker draws. Returns the main runs' launches by
    trainer and dtype."""
    from distkeras_tpu_torch import (AveragingTrainer, EnsembleTrainer,
                                     imdb_lstm, telemetry)
    from distkeras_tpu_torch.datasets import imdb

    t_phase = time.perf_counter()
    W, Kw, B = (TRAIN["num_workers"], TRAIN["communication_window"],
                TRAIN["batch_size"])
    steps = ENSEMBLE_ROUNDS * W * Kw
    df = first_rows(frame, steps * B)
    widths = dict(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                  seq_len=SEQ_LEN)
    classes = {"AveragingTrainer": AveragingTrainer,
               "EnsembleTrainer": EnsembleTrainer}
    launches, rows = {}, []
    for dtype in DTYPES:
        for name, cls in classes.items():
            model = imdb_lstm(**widths, seed=seed + 7, device="cuda")
            t = cls(model, "sgd", "sparse_categorical_crossentropy",
                    **TRAIN, compute_dtype=dtype)
            telemetry.reset()
            torch.cuda.synchronize()
            K.reset_launches()  # counts start at 0 just before the path
            t0 = time.perf_counter()
            out = t.train(df)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, entries = K.launch_counts(), K.launch_counts(
                by_entry=True)
            members = out if isinstance(out, list) else [out]
            moved = max((m.params[k] - v).abs().max().item()
                        for m in members for k, v in model.params.items())
            apart = [center_dist(member_dict([members[i]]),
                                 member_dict([members[j]]), "max")
                     for i in range(len(members))
                     for j in range(i + 1, len(members))] \
                if len(members) > 1 else []
            hist = t.get_worker_histories()
            launches.setdefault(name, {})[dtype] = counts
            row = {"phase": "ensemble_train", "gpu": gpu, "trainer": name,
                   "model": f"imdb_lstm({widths})", **TRAIN,
                   "rounds": ENSEMBLE_ROUNDS, "dtype": dtype,
                   "seconds": wall, "samples_per_s": steps * B / wall,
                   "ms_per_local_step": wall / steps * 1e3,
                   "local_steps": steps, "launches": counts,
                   "launches_by_entry": entries, "members": len(members),
                   "members_min_max_abs_apart": min(apart) if apart
                   else None, "center_max_abs_change": moved,
                   "worker_histories": hist.tolist()}
            rows.append(row)
            emit(row)
            if not np.all(np.isfinite(hist)):
                fail(f"ensemble_train {name} ({dtype}): non-finite loss")
            if not moved > 0:
                fail(f"ensemble_train {name} ({dtype}): nothing moved")
            for k in ("lstm_fwd_stash", "lstm_bwd"):
                if counts[k] != steps:
                    fail(f"ensemble_train {name} ({dtype}): {k} launched "
                         f"{counts[k]} times in {steps} local steps")
            if counts["lstm_fwd"]:
                fail(f"ensemble_train {name} ({dtype}): the inference "
                     f"forward launched {counts['lstm_fwd']} times")
            only_dtype(f"ensemble_train {name}", entries, dtype)
            if name == "EnsembleTrainer" and not (
                    len(members) == W and min(apart) > 0):
                fail(f"ensemble_train ({dtype}): {len(members)} members, "
                     f"pairwise max distances {apart}")
            del model, t, out, members
            torch.cuda.empty_cache()

    Wp, Kp, Bp = (ENSEMBLE_PARITY["num_workers"],
                  ENSEMBLE_PARITY["communication_window"],
                  ENSEMBLE_PARITY["batch_size"])
    pdf = imdb(n=ENSEMBLE_PARITY_ROUNDS * Wp * Kp * Bp, vocab_size=VOCAB,
               seq_len=SEQ_LEN, seed=seed + 8)
    for name, cls in classes.items():
        out = {}
        for run, dev, dtype in (("cuda", "cuda", None), ("cpu", "cpu", None),
                                ("cuda_bf16", "cuda", "bfloat16"),
                                ("cpu_bf16", "cpu", "bfloat16")):
            model = imdb_lstm(**widths, seed=seed + 8, device=dev)
            init = {k: v.detach().cpu().clone()
                    for k, v in model.params.items()}
            t = cls(model, "sgd", "sparse_categorical_crossentropy",
                    **ENSEMBLE_PARITY, compute_dtype=dtype)
            got = t.train(pdf)
            members = got if isinstance(got, list) else [got]
            out[run] = (member_dict(members), t.get_worker_histories())
        err = center_dist(out["cuda"][0], out["cpu"][0], "max")
        hist_err = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
        change = max((v - init[k.split(".", 1)[1]]).abs().max().item()
                     for k, v in out["cpu"][0].items())
        emit({"phase": "ensemble_parity", "trainer": name,
              **ENSEMBLE_PARITY, "rounds": ENSEMBLE_PARITY_ROUNDS,
              "members": len(members),
              "max_abs_err_card_vs_cpu": err,
              "history_max_abs_err": hist_err,
              "center_max_abs_change": change, "atol": PARITY_ATOL})
        if not (change > 0 and err <= PARITY_ATOL
                and hist_err <= PARITY_ATOL):
            fail(f"ensemble_parity {name}: card vs CPU {err}, history "
                 f"{hist_err} > {PARITY_ATOL} (moved {change})")
        bf16_parity(f"ensemble_parity {name}", out, change)
    emit({"phase": "ensemble_seconds",
          "seconds": time.perf_counter() - t_phase})
    return launches


def drill_cnn_run(torch, dev: str, seed: int, kw: dict, df, double=False):
    """One ADAG(mnist_cnn()) run under :data:`DRILL_NAN` with the reset
    on; returns ``(params, history, counters, worker_reset events)``."""
    from distkeras_tpu_torch import ADAG, mnist_cnn, telemetry

    model = mnist_cnn(seed=seed, device=dev)
    if double:
        model.module.double()
    t = ADAG(model, loss="sparse_categorical_crossentropy",
             divergence_reset=DRILL_RESET, **kw)
    with fault_plan(DRILL_NAN) as (plan, _):
        telemetry.reset()
        trained = t.train(df)
        missed = unfired(plan)
    got = counters("resilience.nonfinite_rounds", "resilience.worker_resets",
                   "resilience.faults_injected")
    resets = [e["workers"] for e in telemetry.get().events()
              if e["kind"] == "worker_reset"]
    if missed:
        fail(f"fault_drills (a) on {dev}: faults {missed} did not fire")
    return ({k: v.detach().cpu().double() for k, v in
             trained.params.items()}, t.get_history(), got, resets, model)


def fault_drills_phase(torch, K, gpu: str, seed: int, frames: dict,
                       frame, workdir: str) -> dict:
    """(a) the NaN skip and the divergent-worker reset on config #2; (b)
    ``Supervisor`` over a ``crash@2`` on config #4 with a checkpoint a
    round, bit-equal to the uninterrupted run; (c) the same with step 1
    corrupted, resumed from step 0. Returns the LSTM launches of (b) and
    (c), each counted across both attempts."""
    from distkeras_tpu_torch import DynSGD, Supervisor, imdb_lstm, telemetry
    from distkeras_tpu_torch.data import DataFrame
    from distkeras_tpu_torch.datasets import mnist
    from distkeras_tpu_torch.resilience import FaultPlan, InjectedFault

    t_phase = time.perf_counter()
    name, _trainer, kw = CNN_TRAIN[0]
    poisoned = FaultPlan.parse(DRILL_NAN).poison_worker(
        int(DRILL_NAN.split("@")[1]), kw["num_workers"])
    reset_all_launches()  # the CNN path launches none of the port's kernels
    t0 = time.perf_counter()
    center, hist, got, resets, model = drill_cnn_run(
        torch, "cuda", seed, kw, frames[name])
    wall = time.perf_counter() - t0
    check_no_kernel("fault_drills (a)")
    finite = all(bool(np.isfinite(v.numpy()).all()) for v in center.values())
    row_a = {"phase": "fault_drills", "drill": "nan_skip_reset",
             "gpu": gpu, "model": f"{name}()", "trainer": "ADAG", **kw,
             "rounds": CNN_ROUNDS, "faults": DRILL_NAN,
             "divergence_reset": DRILL_RESET, "counters": got,
             "reset_workers": resets, "poison_worker": poisoned,
             "history": [float(v) for v in hist], "seconds": wall}
    # Parity: the same plan on the card, the CPU and the CPU in float64,
    # at the CNN parity cut with 4 workers.
    pkw = dict(kw, **DRILL_CNN_PARITY)
    n = CNN_ROUNDS * pkw["num_workers"] * pkw["communication_window"] * \
        pkw["batch_size"]
    df = mnist(n=n, seed=seed + 5)
    df64 = DataFrame({"features": df["features"].astype(np.float64),
                      "label": df["label"]})
    par = {}
    for run, dev, data in (("cuda", "cuda", df), ("cpu", "cpu", df),
                           ("cpu_f64", "cpu", df64)):
        par[run] = drill_cnn_run(torch, dev, seed + 5, pkw, data,
                                 double=run == "cpu_f64")
    init = {k: v.detach().cpu().double()
            for k, v in par["cpu_f64"][4].params.items()}
    card_vs_f64 = center_dist(par["cuda"][0], par["cpu_f64"][0], "mean")
    cpu_vs_f64 = center_dist(par["cpu"][0], par["cpu_f64"][0], "mean")
    change = max((v - init[k]).abs().max().item()
                 for k, v in par["cpu_f64"][0].items())
    row_a.update({"parity": {**pkw, "rounds": CNN_ROUNDS,
                             "center_mean_abs_err_card_vs_cpu_f64":
                                 card_vs_f64,
                             "center_mean_abs_err_cpu_vs_cpu_f64":
                                 cpu_vs_f64,
                             "limit": RESNET_PARITY_FACTOR * cpu_vs_f64,
                             "center_max_abs_change": change,
                             "counters": {r: p[2] for r, p in par.items()},
                             "reset_workers": {r: p[3]
                                               for r, p in par.items()}}})
    emit(row_a)
    want = {"resilience.nonfinite_rounds": 1, "resilience.worker_resets": 1,
            "resilience.faults_injected": 1}
    for label, (c, r) in {"main": (got, resets),
                          **{k: (p[2], p[3]) for k, p in par.items()}}.items():
        if c != want or r != [[poisoned]]:
            fail(f"fault_drills (a) {label}: counters {c}, resets {r}; want "
                 f"{want} and worker {poisoned} reset once")
    if not finite or np.isfinite(hist[1]) or not np.isfinite(hist[0]):
        fail(f"fault_drills (a): center finite {finite}, history {hist}")
    if not (change > 0 and 0 < cpu_vs_f64
            and card_vs_f64 <= RESNET_PARITY_FACTOR * cpu_vs_f64):
        fail(f"fault_drills (a): card {card_vs_f64} from the f64 run, more "
             f"than {RESNET_PARITY_FACTOR} x the CPU f32 run's {cpu_vs_f64}")
    del model, par
    torch.cuda.empty_cache()

    # (b) and (c): config #4 under the Supervisor.
    W, Kw, B = (TRAIN["num_workers"], TRAIN["communication_window"],
                TRAIN["batch_size"])
    df = first_rows(frame, DRILL_ROUNDS * W * Kw * B)
    widths = dict(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                  seq_len=SEQ_LEN)

    def run(spec: str = "", ckdir: str = None):
        model = imdb_lstm(**widths, seed=seed + 6, device="cuda")
        extra = ({"checkpoint_dir": ckdir, "checkpoint_every": 1}
                 if ckdir else {})
        t = DynSGD(model, worker_optimizer="sgd",
                   loss="sparse_categorical_crossentropy", **TRAIN, **extra)
        # The uninterrupted run trains bare; a drill under the Supervisor,
        # which retries only the injected crash: an attempt that died of
        # anything else (a kernel's build or launch) raises here.
        sup = (Supervisor(t, max_retries=1, backoff_s=0,
                          retry_on=(InjectedFault,)) if ckdir else t)
        with fault_plan(spec) as (plan, _):
            telemetry.reset()
            torch.cuda.synchronize()
            K.reset_launches()  # across every attempt of the run
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                trained = sup.train(df)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            missed = unfired(plan)
        return {"params": {k: v.detach().cpu()
                           for k, v in trained.params.items()},
                "attempts": getattr(sup, "attempts", 1), "seconds": wall,
                "history_len": len(t.get_history()),
                "finite": bool(np.all(np.isfinite(
                    t.get_worker_histories()))),
                "launches": K.launch_counts(), "missed": missed,
                "warnings": [str(w.message)[:120] for w in caught
                             if "attempt" in str(w.message)
                             or "falling back" in str(w.message)],
                "counters": counters(
                    "resilience.supervisor_retries",
                    "resilience.faults_injected",
                    "resilience.ckpt_corrupt_detected",
                    "resilience.ckpt_fallback_steps")}

    clean = run()
    out = {}
    for drill, spec, attempt_rounds in (
            ("crash_resume", DRILL_CRASH, 2 + 1),
            ("ckpt_fallback", DRILL_CORRUPT, 2 + 2)):
        d = os.path.join(workdir, drill)
        shutil.rmtree(d, ignore_errors=True)
        got = run(spec, d)
        shutil.rmtree(d, ignore_errors=True)
        steps = attempt_rounds * W * Kw
        equal = all(torch.equal(got["params"][k], v)
                    for k, v in clean["params"].items())
        dist = center_dist(got["params"], clean["params"], "max")
        row = {"phase": "fault_drills", "drill": drill, "gpu": gpu,
               "trainer": "DynSGD", "model": f"imdb_lstm({widths})",
               **TRAIN, "rounds": DRILL_ROUNDS, "faults": spec,
               "attempts": got["attempts"], "seconds": got["seconds"],
               "uninterrupted_seconds": clean["seconds"],
               "retry_cost_s": got["seconds"] - clean["seconds"],
               "resumed_history_rounds": got["history_len"],
               "launches": got["launches"], "local_steps": steps,
               "bit_equal_to_uninterrupted": equal,
               "max_abs_from_uninterrupted": dist,
               "counters": got["counters"], "warnings": got["warnings"]}
        emit(row)
        want_hist = 1 if drill == "crash_resume" else 2
        corrupt = 1 if drill == "ckpt_fallback" else 0
        if got["missed"]:
            fail(f"fault_drills ({drill}): faults {got['missed']} did not "
                 f"fire")
        if got["attempts"] != 2 or got["counters"][
                "resilience.supervisor_retries"] != 1:
            fail(f"fault_drills ({drill}): {got['attempts']} attempts, "
                 f"counters {got['counters']}")
        if got["history_len"] != want_hist or got["counters"][
                "resilience.ckpt_corrupt_detected"] != corrupt:
            fail(f"fault_drills ({drill}): the resume ran "
                 f"{got['history_len']} rounds (want {want_hist}), "
                 f"counters {got['counters']}")
        if not (got["finite"] and equal):
            fail(f"fault_drills ({drill}): the resumed center is {dist} "
                 f"from the uninterrupted run's")
        for k in ("lstm_fwd_stash", "lstm_bwd"):
            if got["launches"][k] != steps:
                fail(f"fault_drills ({drill}): {k} launched "
                     f"{got['launches'][k]} times in {steps} local steps "
                     f"over both attempts")
        out[drill] = got["launches"]
    emit({"phase": "fault_drills_seconds",
          "seconds": time.perf_counter() - t_phase})
    return out


def chaos_run(torch, K, F, seed: int, df, workers: int, rounds: int,
              spec: str = "", transport: str = "tcp",
              via_proxy: bool = False, lease_s: float = None) -> dict:
    """One config #4 remote DynSGD run (int8 commits, ``workers`` workers)
    against a fresh ``PSServer(device="cuda", lease_s=lease_s)`` under
    the network plan ``spec``, through a ``ChaosProxy`` when
    ``via_proxy``; every commit a worker saw acknowledged is recorded.
    The launch counts are set to 0 just before ``train`` and read just
    after (in ``remote_run``)."""
    from distkeras_tpu_torch.netps import ChaosProxy, PSServer
    from distkeras_tpu_torch.netps import shm as netps_shm

    srv = PSServer(discipline="dynsgd", device="cuda", lease_s=lease_s,
                   transport=transport).start()
    px = None
    try:
        with fault_plan(net=spec) as (_, plan), acked_commits() as acked:
            netps_shm.reset_frames()
            if via_proxy:
                px = ChaosProxy(srv.endpoint).start()
            run = remote_run(torch, K, F, seed, df,
                             px.endpoint if px else srv.endpoint, rounds,
                             workers=workers, DKTPU_NET_TRANSPORT=transport,
                             **CHAOS_ENV)
            run["missed"] = unfired(plan)
            run["frames"] = px.frames_seen if px else None
        run.update({"log": list(srv.commit_log), "center": srv.center(),
                    "evictions": srv.evictions, "rejoins": srv.rejoins,
                    "acked": acked})
    finally:
        if px is not None:
            px.close()
        srv.close()
    return run


def netps_chaos_phase(torch, K, F, gpu: str, seed: int, frame) -> dict:
    """(a) the wire kinds through the ``ChaosProxy``, one worker; (b) an
    eviction among 4 workers; (c) the ring's own faults, one worker. Every
    scheduled fault must fire, each commit fold once, ``fold_commit``
    launch once a folded commit; (a) and (c) end bit-equal to the same
    run without faults. Returns the fold launches of the three runs."""
    t_phase = time.perf_counter()
    Kw, B = REMOTE["communication_window"], REMOTE["batch_size"]
    one = first_rows(frame, CHAOS_ROUNDS * Kw * B)
    four = first_rows(frame,
                      CHAOS_EVICT_ROUNDS * REMOTE["num_workers"] * Kw * B)
    base = chaos_run(torch, K, F, seed + 9, one, 1, CHAOS_ROUNDS)
    runs = {
        "wire": chaos_run(torch, K, F, seed + 9, one, 1, CHAOS_ROUNDS,
                          CHAOS_WIRE, via_proxy=True),
        "evict": chaos_run(torch, K, F, seed + 9, four,
                           REMOTE["num_workers"], CHAOS_EVICT_ROUNDS,
                           CHAOS_EVICT, lease_s=CHAOS_LEASE),
        "ring": chaos_run(torch, K, F, seed + 9, one, 1, CHAOS_ROUNDS,
                          CHAOS_RING, transport="shm"),
    }
    specs = {"wire": CHAOS_WIRE, "evict": CHAOS_EVICT, "ring": CHAOS_RING}
    failures, launches = [], {}
    for name, run in runs.items():
        log = run["log"]
        folded = [(w, s) for w, s, *_ in log]
        lost = sorted(run["acked"] - set(folded))
        equal = (same_bits(run["center"], base["center"])
                 if name != "evict" else None)
        launches[name] = run["fold"].get("fold_commit", 0)
        emit({"phase": "netps_chaos", "drill": name, "gpu": gpu,
              "faults": specs[name], "workers": 1 if name != "evict"
              else REMOTE["num_workers"], "window": Kw, "batch_size": B,
              "rounds": CHAOS_ROUNDS if name != "evict"
              else CHAOS_EVICT_ROUNDS, "codec": "int8",
              "transport": "shm" if name == "ring" else "tcp",
              **CHAOS_ENV,
              "lease_s": CHAOS_LEASE if name == "evict" else "default",
              "seconds": run["wall"], "baseline_seconds": base["wall"],
              "commits": len(log), "acked": len(run["acked"]),
              "acked_not_folded": lost, "exactly_once": exactly_once(log),
              "evictions": run["evictions"], "rejoins": run["rejoins"],
              "frames_through_proxy": run["frames"],
              "fold_launches": run["fold"], "lstm_launches": run["lstm"],
              "bit_equal_to_faultless": equal,
              "counters": {k: v for k, v in run["snap"]["counters"].items()
                           if k.startswith(("resilience.", "netps.retries",
                                            "netps.reconnects",
                                            "netps.rejoins",
                                            "netps.commits",
                                            "netps.shm_"))}})
        if run["missed"]:
            failures.append(f"{name}: faults {run['missed']} did not fire")
        if not (run["finite"] and exactly_once(log) and not lost):
            failures.append(f"{name}: finite {run['finite']}, exactly once "
                            f"{exactly_once(log)}, acked but not folded "
                            f"{lost}")
        if run["fold"].get("fold_commit") != len(log) or any(
                v for k, v in run["fold"].items() if k != "fold_commit"):
            failures.append(f"{name}: fold launches {run['fold']} for "
                            f"{len(log)} folded commits")
        if equal is False:
            failures.append(f"{name}: the center differs from the run "
                            f"without faults")
    if runs["evict"]["evictions"] < 1 or runs["evict"]["rejoins"] < 1:
        failures.append(f"evict: {runs['evict']['evictions']} evictions, "
                        f"{runs['evict']['rejoins']} rejoins")
    emit({"phase": "netps_chaos_seconds",
          "seconds": time.perf_counter() - t_phase})
    if failures:
        fail("netps_chaos: " + "; ".join(failures))
    launches["faultless"] = base["fold"].get("fold_commit", 0)
    return launches


def serve_drill(torch, K, frontend, cpu_model) -> dict:
    """The serving frontend's chaos on a running frontend: request
    ``SERVE_SLOW_AT`` is held ``SERVE_SLOW_S`` s, request
    ``SERVE_DROP_AT``'s connection is closed before admission and the
    ``ServeClient`` retries it; every answer must match the CPU plain
    forward. Returns the drill's numbers (its own LSTM counts)."""
    from distkeras_tpu_torch.serving import ServeClient
    from distkeras_tpu_torch.serving import frontend as frontend_mod

    spec = (f"serve_slow@{SERVE_SLOW_AT}:{SERVE_SLOW_S};"
            f"serve_drop@{SERVE_DROP_AT}")
    before = counters("serving.client_failovers")["serving.client_failovers"]
    lat, worst = [], 0.0
    with fault_plan(net=spec) as (_, plan):
        frontend_mod.reset_request_index()
        K.reset_launches()
        client = ServeClient(frontend.endpoint)
        try:
            for i in range(4):
                tokens = np.random.default_rng(i).integers(
                    0, VOCAB, (3 + i, SEQ_LEN)).astype(np.int32)
                t0 = time.perf_counter()
                out, _v = client.infer(tokens)
                lat.append(time.perf_counter() - t0)
                with torch.inference_mode():
                    ref = cpu_model.predict(tokens).numpy()
                worst = max(worst, float(np.abs(np.asarray(out)
                                                - ref).max()))
        finally:
            client.close()
        missed = unfired(plan)
    failovers = counters("serving.client_failovers")[
        "serving.client_failovers"] - before
    row = {"faults": spec, "latency_s": lat, "max_abs_err": worst,
           "client_failovers": failovers, "launches": K.launch_counts()}
    if missed or failovers != 1 or lat[SERVE_SLOW_AT] < SERVE_SLOW_S \
            or not worst <= SERVE_ATOL:
        fail(f"serve drill: unfired {missed}, {row}")
    return row


# -- the observability plane (phase 28) ------------------------------------

#: config #4's remote runs against the traced CLI server, as
#: ``remote_train`` runs them (int8, 4 workers, window 4, batch 2048), in
#: this order; each traced run's commits are complete traces.
OBS_ROUNDS = REMOTE_ROUNDS["int8"]
OBS_ORDER = ("untraced", "traced", "traced", "untraced")
#: the flight-dump drill: the traced CLI server SIGKILLs itself before it
#: folds commit ``OBS_CRASH_AT`` (``ps_crash@R``).
OBS_CRASH_AT = 2
OBS_VITALS_S = "0.5"
OBS_RING = 8
#: the span names every traced served request carries (client and server).
OBS_SERVE_SPANS = frozenset({"serve.request", "serve.wire", "serve.queue",
                             "serve.batch"})
#: how a CLI server of this phase is started: the module as ``python -m``
#: runs it, with an exit hook that writes the process's fold launch counts
#: (the wrappers' own counts, which live in that process) to the file named
#: by the first argument.
OBS_CLI = (
    "import atexit, json, runpy, sys\n"
    "from distkeras_tpu_torch.ops.kernels import fold\n"
    "out = sys.argv.pop(1)\n"
    "def dump():\n"
    "    with open(out, 'w') as f:\n"
    "        json.dump(fold.launch_counts(), f)\n"
    "atexit.register(dump)\n"
    "runpy.run_module('distkeras_tpu_torch.netps', run_name='__main__',\n"
    "                 alter_sys=True)\n")


def obs_cli(workdir: str, **env) -> dict:
    """Start one traced CLI server of the phase (``python -m
    distkeras_tpu_torch.netps --device cuda``, dynsgd, on a free port,
    ``DKTPU_TRACE=1`` with its trace directory ``workdir``) without waiting
    for it: its start-up overlaps the work before its first use."""
    os.makedirs(workdir, exist_ok=True)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    launches = os.path.join(workdir, "fold_launches.json")
    cmd = [sys.executable, "-c", OBS_CLI, launches, "--host", "127.0.0.1",
           "--port", str(port), "--discipline", "dynsgd", "--device", "cuda"]
    full_env = dict(os.environ, DKTPU_TRACE="1", DKTPU_TRACE_DIR=workdir,
                    **env)
    full_env.pop("DKTPU_TRACE_ROLE", None)
    return {"dir": workdir, "endpoint": f"127.0.0.1:{port}",
            "launches": launches, "t0": time.monotonic(),
            "proc": subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                     env=full_env)}


def obs_ready(cli: dict) -> float:
    """Seconds from the CLI server's start to its ``NETPS_READY``."""
    line = cli["proc"].stdout.readline()
    if not line.startswith("NETPS_READY"):
        fail(f"observability: the CLI server did not start: {line!r}")
    return time.monotonic() - cli["t0"]


def obs_env(trace_dir: str, traced: bool) -> dict:
    """This process's tracing switch for one arm."""
    return ({"DKTPU_TRACE": "1", "DKTPU_TRACE_DIR": trace_dir} if traced
            else {"DKTPU_TRACE": "0"})


def obs_cli_start(*args, cwd: str = None) -> subprocess.Popen:
    """Start ``python -m distkeras_tpu_torch.telemetry <args>`` in a
    subprocess without ``DKTPU_TRACE`` (an operator's shell), the checkout
    on its path; the health CLI runs in the phase's directory, away from
    the repository's benchmark files that its sentinels would read.
    :func:`obs_cli_wait` collects it."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DKTPU_TRACE")}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.getcwd()] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.Popen(
        [sys.executable, "-m", "distkeras_tpu_torch.telemetry", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=cwd)


def obs_cli_wait(proc: subprocess.Popen) -> subprocess.CompletedProcess:
    out, err = proc.communicate(timeout=300)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def obs_spans(trace_dir: str) -> dict:
    """The collector-merged span records of ``trace_dir``, by trace id."""
    from distkeras_tpu_torch.telemetry import tracing

    traces = {}
    for rec in tracing.TelemetryCollector.from_dir(trace_dir).records():
        if rec.get("kind") == tracing.SPAN_KIND and rec.get("trace"):
            traces.setdefault(rec["trace"], []).append(rec)
    return traces


def obs_remote_run(torch, K, seed: int, df, endpoint: str, traced: bool,
                   trace_dir: str) -> tuple:
    """One config #4 remote run (int8) on ``df`` against ``endpoint``, the
    model built from ``seed``; returns its row and the trained model. The
    LSTM launch counts start at 0 just before the run."""
    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch.trainers import DynSGD

    W, Kw, B = (REMOTE["num_workers"], REMOTE["communication_window"],
                REMOTE["batch_size"])
    model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                      seq_len=SEQ_LEN, seed=seed, device="cuda")
    with env_set(DKTPU_NET_COMPRESS="int8", **obs_env(trace_dir, traced)):
        trainer = DynSGD(model, worker_optimizer="sgd",
                         loss="sparse_categorical_crossentropy",
                         remote=endpoint, **REMOTE)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        trained = trainer.train(df)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lstm = K.launch_counts()
    steps = OBS_ROUNDS * W * Kw
    hist = trainer.get_worker_histories()
    if not np.all(np.isfinite(hist)):
        fail(f"observability: non-finite remote loss ({'traced' if traced else 'untraced'}): {hist}")
    if not (lstm["lstm_fwd_stash"] == lstm["lstm_bwd"] == steps
            and lstm["lstm_fwd"] == 0):
        fail(f"observability: LSTM launches {lstm} in {steps} local steps")
    return {"traced": traced, "seconds": wall,
            "samples_per_s": steps * B / wall, "launches": lstm}, trained


def obs_bit_parity(torch, seed: int, trace_dir: str) -> dict:
    """(b): one worker, batch 32, traced and untraced, from the same
    weights and data, against a CUDA server in process each: the final
    centers bit-equal, the commit logs equal."""
    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch.datasets import imdb
    from distkeras_tpu_torch.netps import PSServer
    from distkeras_tpu_torch.trainers import DynSGD

    W, Kw, B = (REMOTE_PARITY["num_workers"],
                REMOTE_PARITY["communication_window"],
                REMOTE_PARITY["batch_size"])
    df = imdb(n=REMOTE_PARITY_ROUNDS * W * Kw * B, vocab_size=VOCAB,
              seq_len=SEQ_LEN, seed=seed + 9)
    out = {}
    for traced in (False, True):
        model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED,
                          hidden_size=HIDDEN, seq_len=SEQ_LEN,
                          seed=seed + 9, device="cuda")
        srv = PSServer(discipline="dynsgd", device="cuda").start()
        try:
            with env_set(DKTPU_NET_COMPRESS="int8",
                         **obs_env(trace_dir, traced)):
                DynSGD(model, worker_optimizer="sgd",
                       loss="sparse_categorical_crossentropy",
                       remote=srv.endpoint, **REMOTE_PARITY).train(df)
            out[traced] = (srv.center(), list(srv.commit_log))
        finally:
            srv.close()
    same = all(a.tobytes() == b.tobytes()
               for a, b in zip(out[False][0], out[True][0]))
    row = {"center_bit_equal": same,
           "commits": len(out[True][1]),
           "commit_logs_equal": out[False][1] == out[True][1],
           "center_max_abs_diff": max(float(np.abs(a - b).max())
                                      for a, b in zip(out[False][0],
                                                      out[True][0]))}
    if not (same and row["commit_logs_equal"] and row["commits"] > 0):
        fail(f"observability (b): tracing changed what was folded: {row}")
    return row


def obs_serve(torch, K, model, traced: bool, trace_dir: str,
              frontend) -> dict:
    """(e): ``serve_phase``'s 44 requests (12 sequential, 8 concurrent
    clients x 4) against ``frontend``, traced or not; the LSTM launch
    counts start at 0 just before."""
    from distkeras_tpu_torch.serving import ServeClient

    sizes, clients = (1, 3, 17, 64), 8
    lat, errors, ring = [], [], None
    lock = threading.Lock()

    def one(client, rows: int, s: int) -> None:
        tokens = np.random.default_rng(s).integers(
            0, VOCAB, (rows, SEQ_LEN)).astype(np.int32)
        t0 = time.perf_counter()
        try:
            out, _version = client.infer(tokens)
        except Exception as e:  # noqa: BLE001 - every miss fails the phase
            with lock:
                errors.append(f"{type(e).__name__}: {e}")
            return
        dt = time.perf_counter() - t0
        if out.shape != (rows, 2) or not np.all(np.isfinite(out)):
            with lock:
                errors.append(f"bad answer {out.shape} for {rows} rows")
        with lock:
            lat.append(dt)

    with env_set(**obs_env(trace_dir, traced)):
        K.reset_launches()
        client = ServeClient(frontend.endpoint)
        for r in range(3):
            for k, rows in enumerate(sizes):
                one(client, rows, 10 * r + k)
        client.close()

        def worker(w: int) -> None:
            c = ServeClient(frontend.endpoint)
            for k in range(4):
                one(c, sizes[(w + k) % len(sizes)], 1000 + 10 * w + k)
            c.close()

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        launches = K.launch_counts()
        client = ServeClient(frontend.endpoint)
        ring = client.stats(ring=OBS_RING)["ring"]
        client.close()
    if any(t.is_alive() for t in threads):
        fail("observability (e): a serving client thread did not finish")
    if errors or len(lat) != 3 * len(sizes) + clients * 4:
        fail(f"observability (e): {len(lat)} answers, errors {errors[:3]}")
    ms = np.array(lat) * 1e3
    return {"traced": traced, "requests": len(lat),
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "lstm_fwd_launches": launches["lstm_fwd"],
            "training_launches": launches["lstm_fwd_stash"]
            + launches["lstm_bwd"], "ring": len(ring)}


def observability_phase(torch, K, F, gpu: str, seed: int,
                        untraced_sps: float) -> dict:
    """Phase 28, the observability plane on the card: (a) config #4's
    traced remote run against a traced CLI server, rendered by the report
    CLI; (b) tracing folds the same bits; (c) scrape, health and
    Prometheus against (a)'s server; (d) the flight dumps of a fired
    ``ps_crash`` and of SIGTERM; (e) traced serving. Returns the launch
    counts of its paths."""
    from distkeras_tpu_torch.netps import PSClient
    from distkeras_tpu_torch.netps.errors import NetPSError
    from distkeras_tpu_torch.serving import ModelRegistry, ServingFrontend
    from distkeras_tpu_torch.telemetry import exporters, tracing

    t_phase = time.perf_counter()
    split, mark = {}, [t_phase]

    def lap(name: str) -> None:
        now = time.perf_counter()
        split[name] = now - mark[0]
        mark[0] = now

    root = os.path.abspath(os.path.join("build", "observability"))
    shutil.rmtree(root, ignore_errors=True)
    trace_dir, crash_dir = (os.path.join(root, "trace"),
                            os.path.join(root, "crash"))
    srv = obs_cli(trace_dir, DKTPU_VITALS_S=OBS_VITALS_S)
    crash = obs_cli(crash_dir, DKTPU_NET_FAULTS=f"ps_crash@{OBS_CRASH_AT}")
    tracing.set_role("trainer")
    out = {}
    try:
        # (b) in process while both CLI servers start; this process keeps
        # one trace stream, so (b)'s traced commits are in (a)'s report
        parity = obs_bit_parity(torch, seed, trace_dir)
        _model, df = remote_inputs(seed, OBS_ROUNDS)
        del _model
        lap("b_parity")
        ready_s = obs_ready(srv)
        lap("cli_wait")
        ep = srv["endpoint"]
        # (a) untraced and traced runs against the one server, in turns
        runs, trained = [], None
        for arm in OBS_ORDER:
            row, model = obs_remote_run(torch, K, seed, df, ep,
                                        arm == "traced", trace_dir)
            runs.append(row)
            if arm == "traced":
                trained = model
            else:
                del model
        del df
        lap("a_runs")
        # (c) scrape, health and Prometheus against the live server, the
        # two CLIs side by side while (d) runs
        scraping = obs_cli_start("scrape", ep, "--json")
        checking = obs_cli_start("health", "--targets", f"ps={ep}",
                                 "--samples", "2", cwd=root)
        # (d) the fault's dump: a client commits until the server dies
        obs_ready(crash)
        crash_client = PSClient(crash["endpoint"], worker_id=0,
                                timeout=2.0, retries=2, backoff=0.05)
        acked = 0
        try:
            _c, u = crash_client.join(init=[np.zeros(4096, np.float32)])
            for _ in range(OBS_CRASH_AT + 2):
                crash_client.commit([np.ones(4096, np.float32)], u)
                acked += 1
        except (NetPSError, OSError):
            pass
        finally:
            crash_client.close()
        crash_rc = crash["proc"].wait(timeout=60)
        scrape, health = obs_cli_wait(scraping), obs_cli_wait(checking)
        lines = scrape.stdout.splitlines()
        if scrape.returncode != 0 or len(lines) != 1:
            fail(f"observability (c): scrape rc {scrape.returncode}, "
                 f"{len(lines)} lines: {scrape.stderr[-500:]}")
        stats = json.loads(lines[0])
        snap = stats.get("snapshot") or {}
        prom = exporters.prometheus_text(
            types.SimpleNamespace(snapshot=lambda: snap))
        parsed = exporters.parse_prometheus(prom)
        dev_bytes = parsed.get("dktpu_gauge", {}).get(
            (("name", "device_bytes_in_use"),))
        lap("cd_cli_and_crash")
        # (e) traced serving, on the model the traced run trained
        registry = ModelRegistry(trained, BUCKETS, device="cuda")
        frontend = ServingFrontend(registry, max_queue_rows=8 * 64).start()
        try:
            serve = [obs_serve(torch, K, trained, traced, trace_dir,
                               frontend)
                     for traced in (False, True)]
        finally:
            frontend.close()
            registry.close()
        del trained
        lap("e_serve")
        # SIGTERM: the server dumps its ring, drains and writes its
        # telemetry beside its trace stream
        srv["proc"].send_signal(signal.SIGTERM)
        srv_rc = srv["proc"].wait(timeout=120)
        srv_tail = srv["proc"].stdout.read()
        with open(srv["launches"]) as f:
            fold = json.load(f)
        lap("sigterm")
        report = obs_cli_wait(obs_cli_start("report", "--trace", trace_dir))
        # the numbers the rendered report prints, structured
        rep = tracing.trace_report(
            tracing.TelemetryCollector.from_dir(trace_dir).records())
        lap("report")
    finally:
        tracing.set_role("")
        for cli in (srv, crash):
            if cli["proc"].poll() is None:
                cli["proc"].kill()
                cli["proc"].wait()
    def dumps(d: str) -> list:
        found = []
        for name in sorted(os.listdir(d)):
            if name.startswith("flight-"):
                with open(os.path.join(d, name)) as f:
                    found += [(name, json.loads(ln)["reason"]) for ln in f
                              if '"flight_dump"' in ln]
        return found

    traced_runs = [r for r in runs if r["traced"]]
    untraced_runs = [r for r in runs if not r["traced"]]
    traced_sps = float(np.median([r["samples_per_s"] for r in traced_runs]))
    plain_sps = float(np.median([r["samples_per_s"]
                                 for r in untraced_runs]))
    traces = obs_spans(trace_dir)
    serve_traces = [names for names in (
        {s["name"] for s in spans} for spans in traces.values())
        if "serve.request" in names]
    complete_serves = sum(OBS_SERVE_SPANS <= names
                          for names in serve_traces)
    W, Kw = REMOTE["num_workers"], REMOTE["communication_window"]
    steps = OBS_ROUNDS * W * Kw
    commits_per_run = OBS_ROUNDS * W
    crash_dumps, srv_dumps = dumps(crash_dir), dumps(trace_dir)
    out = {
        "phase": "observability", "gpu": gpu,
        "server": "python -m distkeras_tpu_torch.netps --discipline dynsgd "
                  "--device cuda (DKTPU_TRACE=1, DKTPU_VITALS_S="
                  f"{OBS_VITALS_S})",
        "cli_ready_s": ready_s,
        **REMOTE, "rounds": OBS_ROUNDS, "codec": "int8",
        "runs": runs, "order": list(OBS_ORDER),
        "traced_samples_per_s": traced_sps,
        "untraced_samples_per_s": plain_sps,
        "traced_over_untraced": traced_sps / plain_sps,
        "remote_train_untraced_samples_per_s": untraced_sps,
        "server_commits": stats.get("commits_total"),
        "server_fold_launches": fold,
        "report_rc": report.returncode,
        "report_warnings": [ln for ln in report.stdout.splitlines()
                            if ln.startswith("WARNING")],
        "trace_commits": rep.get("commits"),
        "trace_complete": rep.get("complete"),
        "trace_completeness": rep.get("completeness"),
        "trace_orphans": len(rep.get("orphans", [])),
        "trace_skew_violations": rep.get("skew_violations"),
        "trace_e2e_p50_ms": (rep.get("e2e_p50_s") or 0) * 1e3,
        "trace_e2e_p99_ms": (rep.get("e2e_p99_s") or 0) * 1e3,
        "critical_path_p50_ms": {
            seg: h["p50_s"] * 1e3
            for seg, h in (rep.get("segments") or {}).items()},
        "critical_path_total_ms": {
            seg: h["total_s"] * 1e3
            for seg, h in (rep.get("segments") or {}).items()},
        "processes": rep.get("processes"),
        "bit_parity": parity,
        "scrape": {"role": stats.get("role"),
                   "fold_backend": stats.get("fold_backend"),
                   "ring": len(stats.get("ring") or []),
                   "caps_tracing": (stats.get("caps") or {}).get("tracing")},
        "health_rc": health.returncode,
        "health": health.stdout.splitlines()[:3],
        "prometheus_lines": len(prom.splitlines()),
        "device_bytes_in_use": dev_bytes,
        "crash": {"acked_commits": acked, "rc": crash_rc,
                  "dumps": crash_dumps},
        "sigterm": {"rc": srv_rc, "dumps": srv_dumps,
                    "drained": srv_tail.strip().splitlines()[-1:]},
        "serve": serve,
        "serve_traces": len(serve_traces),
        "serve_traces_complete": complete_serves,
        "seconds": time.perf_counter() - t_phase, "split_s": split,
        "timing": "host clock; samples/s is the remote run's wall clock "
                  "over its samples, untraced and traced against the same "
                  "CLI server in the order given; serving latency is the "
                  "client's wall clock a request"}
    emit(out)
    traced_commits = commits_per_run * len(traced_runs) + parity["commits"]
    if report.returncode != 0 or "Critical path" not in report.stdout:
        fail(f"observability (a): report --trace rc {report.returncode}: "
             f"{report.stderr[-800:]}")
    if out["report_warnings"]:
        fail(f"observability (a): the report warns: "
             f"{out['report_warnings']}")
    if not (rep.get("commits") == rep.get("complete") == traced_commits
            and rep.get("completeness") == 1.0):
        fail(f"observability (a): {rep.get('complete')} complete of "
             f"{rep.get('commits')} commit traces, {traced_commits} "
             f"traced commits")
    if stats.get("commits_total") != commits_per_run * len(OBS_ORDER):
        fail(f"observability (a): the server folded "
             f"{stats.get('commits_total')} commits of "
             f"{commits_per_run * len(OBS_ORDER)}")
    if fold != {"fold_commit": stats.get("commits_total"), "fold_int8": 0,
                "fold_bf16": 0}:
        fail(f"observability (a): the server's fold launches {fold} for "
             f"{stats.get('commits_total')} commits")
    if any(r["launches"]["lstm_fwd_stash"] != steps for r in runs):
        fail(f"observability (a): stash launches {runs}")
    if not (stats.get("fold_backend") == "cuda" and stats.get("role") == "ps"
            and stats.get("ring")):
        fail(f"observability (c): scrape {out['scrape']}")
    if health.returncode != 0:
        fail(f"observability (c): health rc {health.returncode}: "
             f"{health.stdout[-800:]} {health.stderr[-800:]}")
    if not (dev_bytes or 0) > 0:
        fail(f"observability (c): device.bytes_in_use {dev_bytes}")
    if crash_rc != -signal.SIGKILL or acked != OBS_CRASH_AT or not any(
            reason == "fault:ps_crash" for _n, reason in crash_dumps):
        fail(f"observability (d): ps_crash drill {out['crash']}")
    if srv_rc != 0 or not any(reason == "sigterm"
                              for _n, reason in srv_dumps):
        fail(f"observability (d): SIGTERM rc {srv_rc}, dumps {srv_dumps}")
    traced_serve = serve[1]
    if not (len(serve_traces) == complete_serves
            == traced_serve["requests"] and traced_serve["ring"] > 0):
        fail(f"observability (e): {complete_serves} complete of "
             f"{len(serve_traces)} serve traces for "
             f"{traced_serve['requests']} requests, ring "
             f"{traced_serve['ring']}")
    if any(s["training_launches"] or s["lstm_fwd_launches"] <= 0
           for s in serve):
        fail(f"observability (e): serving launches {serve}")
    shutil.rmtree(root, ignore_errors=True)
    return {"stash": {arm: [r["launches"]["lstm_fwd_stash"] for r in runs
                            if r["traced"] == (arm == "traced")]
                      for arm in ("traced", "untraced")},
            "bwd": {arm: [r["launches"]["lstm_bwd"] for r in runs
                          if r["traced"] == (arm == "traced")]
                    for arm in ("traced", "untraced")},
            "fold": fold["fold_commit"], "commits": stats["commits_total"],
            "serve": {("traced" if s["traced"] else "untraced"):
                      s["lstm_fwd_launches"] for s in serve}}



# -- the remaining model slices: the MoE LM and mutable model state ----------

#: ``moe_train``: ``MoETransformerLM``'s own defaults with flash attention
#: (about 35 M parameters), batch 8 at length 512, adam under a
#: warmup-cosine schedule, MOE_ROUNDS rounds of MOE_STEPS steps.
MOE = dict(vocab_size=32000, num_layers=4, d_model=256, num_heads=8,
           d_ff=1024, num_experts=8, capacity_factor=1.5, max_seq_len=2048)
MOE_SEQ = 512
MOE_BATCH = 8
MOE_STEPS = 2
MOE_ROUNDS = 2
MOE_PEAK_LR = 3e-4
#: the card-vs-CPU step: one batch of MOE_PARITY_BATCH at full width.
MOE_PARITY_BATCH = 2
#: the bf16 card-vs-CPU step's share of the CPU's bf16-vs-f32 distance:
#: below a card step that stayed in f32 (the control, routed and held
#: alike, read 0.996-1.013 on an H100), above the bf16 readings (logits
#: 0.75, 0.72; gradients 0.59, 0.59; sown values 0.094, 0.60 at K = 1,
#: 2), which repeat to the bit from run to run.
MOE_BF16_PARITY_SHARE = 0.85

#: ``bn_carry``: ``examples/keras_batchnorm.py``'s model and data, built
#: natively (Dense 64, BatchNorm, relu, Dense 64, BatchNorm, relu, Dense
#: 4 over 16 features), under ADAG as the example runs it.
BN_ROWS, BN_FEATURES, BN_CLASSES, BN_HIDDEN = 4096, 16, 4, 64
BN_TRAIN = dict(num_workers=4, batch_size=32, communication_window=4,
                num_epoch=2)
BN_ARMS = {"sgd": ("sgd", 0.05), "adam_mu_bf16": ("adam", 0.005)}
#: card vs CPU over BN_PARITY_ROUNDS rounds: params and statistics
BN_PARITY_ROUNDS = 2
BN_PARITY_RTOL, BN_PARITY_ATOL = 1e-4, 1e-5


def routing_recorder(model, ref=None):
    """Wrap every MoE layer's ``route`` of ``model``: record its
    probabilities, their deciding gaps (the smallest difference between
    neighbours among the K + 1 largest: the picks and their order hold
    while none closes) and its picks, one entry a layer a forward. With ``ref``
    (another recorder, of a run on the same inputs) the layer routes every
    token as ``ref`` did, with its own probabilities as the gates, and
    counts where its own picks differ (``off``) and where no difference
    of the two runs' probabilities explains it (``bad``: a token's picks
    can swap only where its gap in ``ref`` is at most twice the largest
    change of its probabilities): the rule that holds a card step to a
    CPU step on the same routing. ``max_dp`` is the largest probability
    change seen."""
    rec = {"p": [], "idx": [], "gap": [], "off": 0, "bad": 0,
           "max_dp": 0.0}
    calls = [0]
    for name in model.module.blocks:
        moe = getattr(model.module, name).moe
        own = moe.route

        def route(p, own=own, moe=moe):
            gates, idx = own(p)
            srt = p.detach().sort(dim=-1, descending=True).values
            K = moe.num_selected
            # the smallest of the top K + 1's adjacent gaps: the picks and
            # their order hold unless one of them closes
            rec["gap"].append((srt[:, :K] - srt[:, 1:K + 1]).min(-1)
                              .values.cpu())
            rec["p"].append(p.detach().cpu())
            if ref is not None:
                c = calls[0]
                want_idx = ref["idx"][c].to(idx.device)
                dp = (p.detach().cpu() - ref["p"][c]).abs().max(-1).values
                off = (idx.cpu() != ref["idx"][c]).any(-1)
                rec["off"] += int(off.sum())
                rec["bad"] += int((off & (ref["gap"][c] > 2 * dp)).sum())
                rec["max_dp"] = max(rec["max_dp"], float(dp.max()))
                idx = want_idx
                gates = p.gather(-1, idx)
                if K > 1:
                    gates = gates / gates.sum(-1, keepdim=True)
            calls[0] += 1
            rec["idx"].append(idx.cpu())
            return gates, idx

        moe.route = route
    return rec


def moe_step(torch, model, x, y, dtype):
    """One training step's forward and backward as the local loop runs it
    (parameters cast to ``dtype`` inside): the loss, the logits, the f32
    gradients and each layer's sown values, all on the host."""
    from torch.func import functional_call

    from distkeras_tpu_torch.ops import cast_floats
    from distkeras_tpu_torch.ops.losses import (collect_aux_loss,
                                                get_loss)

    module = model.module
    module.train()
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in model.params.items()}
    x = torch.as_tensor(x, device=model.device)
    y = torch.as_tensor(y, device=model.device)
    logits, inter = functional_call(
        module, cast_floats(leaves, dtype), (x,),
        {"return_intermediates": True})
    loss = get_loss("sparse_categorical_crossentropy")(logits.float(), y)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    module.eval()
    sown = {name: {k: v[0].detach().float().cpu()
                   for k, v in inter["intermediates"][name]["moe"].items()}
            for name in module.blocks}
    return {"loss": loss.item(), "logits": logits.detach().float().cpu(),
            "grads": {k: g.cpu() for k, g in zip(leaves, grads)},
            "aux": collect_aux_loss(inter).item(), "sown": sown}


def moe_build(torch, seed: int, K: int, device: str, attn_impl="flash"):
    from distkeras_tpu_torch import small_moe_lm

    return small_moe_lm(**MOE, seq_len=MOE_SEQ, num_selected=K,
                        attn_impl=attn_impl, seed=seed, device=device)


def moe_parity(torch, seed: int, K: int, dtype: str, x, y) -> dict:
    """One step at full width, batch MOE_PARITY_BATCH: the card (the flash
    kernels) against the CPU (the twins) from the same seed, the card
    routed as the CPU routed (``routing_recorder``; a pick of its own off
    the CPU's must be explained by the two runs' probability difference),
    the logits, the gradients and the sown values held within a share of
    the design's yardstick: in f32 the CPU's flash-vs-dense distance, in
    bf16 the CPU's bf16-vs-f32 distance (``MOE_BF16_PARITY_SHARE``), each
    yardstick run routed as the CPU reference run too; the expert
    fractions equal. In bf16 a control, the card's step in f32 routed
    alike, must stay outside that share: the check tells a card step that
    computed in f32 from one in bf16."""
    dt = getattr(torch, dtype)
    ref_model = moe_build(torch, seed, K, "cpu")
    ref_rec = routing_recorder(ref_model)
    ref = moe_step(torch, ref_model, x, y, dt)
    del ref_model
    card_model = moe_build(torch, seed, K, "cuda")
    card_rec = routing_recorder(card_model, ref_rec)
    card = moe_step(torch, card_model, x, y, dt)
    del card_model
    control = None
    if dtype == "bfloat16":
        ctl_model = moe_build(torch, seed, K, "cuda")
        routing_recorder(ctl_model, ref_rec)
        control = moe_step(torch, ctl_model, x, y, torch.float32)
        del ctl_model
    torch.cuda.empty_cache()
    if dtype == "float32":
        yard_model = moe_build(torch, seed, K, "cpu", "dense")
        yard_dt, share = dt, (LM_PARITY_LOGITS_SHARE, LM_PARITY_CENTER_SHARE)
    else:
        yard_model = moe_build(torch, seed, K, "cpu")
        yard_dt, share = torch.float32, (MOE_BF16_PARITY_SHARE,
                                         MOE_BF16_PARITY_SHARE)
    routing_recorder(yard_model, ref_rec)
    yard = moe_step(torch, yard_model, x, y, yard_dt)
    del yard_model

    def grad_mean(a, b):
        d = [(a["grads"][k] - b["grads"][k]).abs() for k in b["grads"]]
        return (sum(v.sum() for v in d) / sum(v.numel() for v in d)).item()

    def logit_max(a, b):
        return (a["logits"] - b["logits"]).abs().max().item()

    def sown_max(a, b):
        return max((a["sown"][n][k] - b["sown"][n][k]).abs().max().item()
                   for n in b["sown"] for k in b["sown"][n])

    fraction_equal = all(torch.equal(run["sown"][n]["expert_fraction"],
                                     ref["sown"][n]["expert_fraction"])
                         for run in (card, yard) for n in ref["sown"])
    row = {"phase": "moe_parity", "num_selected": K, "dtype": dtype,
           "batch": int(x.shape[0]), "seq_len": int(x.shape[1]),
           "loss_card": card["loss"], "loss_cpu": ref["loss"],
           "loss_abs_err": abs(card["loss"] - ref["loss"]),
           "logits_max_abs_err_card_vs_cpu": logit_max(card, ref),
           "logits_max_abs_err_yardstick": logit_max(yard, ref),
           "grad_mean_abs_err_card_vs_cpu": grad_mean(card, ref),
           "grad_mean_abs_err_yardstick": grad_mean(yard, ref),
           "yardstick": ("CPU dense vs CPU flash" if dtype == "float32"
                         else "CPU f32 vs CPU bf16"),
           "shares": share, "aux_loss_card": card["aux"],
           "aux_loss_cpu": ref["aux"],
           "sown_max_abs_err_card_vs_cpu": sown_max(card, ref),
           "sown_max_abs_err_yardstick": sown_max(yard, ref),
           "expert_fraction_equal": fraction_equal,
           "tokens_routed": sum(int(t.shape[0]) for t in ref_rec["idx"]),
           "card_picks_off_cpu": card_rec["off"],
           "card_picks_off_unexplained": card_rec["bad"],
           "router_prob_max_abs_err_card_vs_cpu": card_rec["max_dp"],
           "min_deciding_gap_cpu": min(float(g.min())
                                       for g in ref_rec["gap"])}
    if control is not None:
        row.update(
            control="the card's step in f32, routed as the CPU's bf16 step",
            logits_max_abs_err_control=logit_max(control, ref),
            grad_mean_abs_err_control=grad_mean(control, ref),
            sown_max_abs_err_control=sown_max(control, ref))
        for name in ("logits_max_abs_err", "grad_mean_abs_err",
                     "sown_max_abs_err"):
            row[f"{name}_control_share"] = (row[f"{name}_control"]
                                            / row[f"{name}_yardstick"])
    emit(row)
    if card_rec["bad"]:
        fail(f"moe_parity K={K} {dtype}: the card routed "
             f"{card_rec['bad']} tokens away from the CPU's picks where the "
             "gap exceeds twice the two runs' probability difference")
    for name, s in (("logits_max_abs_err", share[0]),
                    ("grad_mean_abs_err", share[1]),
                    ("sown_max_abs_err", share[1])):
        got, design = row[f"{name}_card_vs_cpu"], row[f"{name}_yardstick"]
        if not (0 < design and got <= s * design):
            fail(f"moe_parity K={K} {dtype}: {name} card vs CPU {got} > "
                 f"{s} x the yardstick {design}")
        if control is not None and not row[f"{name}_control"] > s * design:
            fail(f"moe_parity K={K} {dtype}: the card's f32 control passes "
                 f"the bf16 check ({name} {row[f'{name}_control']} <= {s} x "
                 f"{design}), so the check cannot tell f32 from bf16")
    if not fraction_equal:
        fail(f"moe_parity K={K} {dtype}: the expert fractions differ on "
             "the same routing")
    return row


def moe_train_phase(torch, FA, gpu: str, seed: int, dtype: str,
                    K: int) -> dict:
    """``SingleTrainer(MoETransformerLM(...))`` at full width as a user
    drives it, at ``compute_dtype=dtype`` with ``num_selected=K``: flash
    counts set to 0 just before ``train`` and read just after (each kernel
    once a layer a step, no remat); then a step split by CUDA events and
    the card-vs-CPU step (:func:`moe_parity`). Returns the launches."""
    from distkeras_tpu_torch import SingleTrainer
    from distkeras_tpu_torch.models import moe as moe_mod
    from distkeras_tpu_torch.ops.optimizers import adam
    from distkeras_tpu_torch.ops.schedules import (
        warmup_cosine_decay_schedule)

    steps = MOE_ROUNDS * MOE_STEPS
    head = MOE["d_model"] // MOE["num_heads"]
    if (MOE_BATCH, MOE_SEQ, MOE["num_heads"], head) not in FLASH_SHAPES:
        fail("moe_train: the flash kernels are not held against their "
             "twins at the MoE LM's shape (FLASH_SHAPES)")
    t0 = time.perf_counter()
    model = moe_build(torch, seed, K, "cuda")
    df = lm_frame(steps * MOE_BATCH, MOE["vocab_size"], MOE_SEQ, seed + K)
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.params.values())
    sched = warmup_cosine_decay_schedule(0.0, MOE_PEAK_LR, 2, 4 * steps)
    trainer = SingleTrainer(model, "adam", "sparse_categorical_crossentropy",
                            batch_size=MOE_BATCH, num_epoch=1,
                            steps_per_program=MOE_STEPS,
                            learning_rate=sched, compute_dtype=dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()  # every count 0 just before the main path
    t0 = time.perf_counter()
    trained = trainer.train(df)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = FA.launch_counts()
    entries = FA.launch_counts(by_entry=True)
    others = {k: v for k, v in launched_kernels().items()
              if not k.startswith("flash_attention.")}
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.get_history()
    moved = max((trained.params[k] - v).abs().max().item()
                for k, v in model.params.items())
    x = torch.as_tensor(df["features"][:MOE_BATCH], device="cuda")
    y = torch.as_tensor(df["label"][:MOE_BATCH], device="cuda")
    del model
    split = step_split(
        torch, trained, x, y, adam(MOE_PEAK_LR),
        timed=[(FA, {"flash_fwd_cuda": "flash_fwd",
                     "flash_bwd_cuda": "flash_bwd"}),
               (moe_mod, {"dispatch_tokens": "dispatch_einsum",
                          "combine_tokens": "combine_einsum"})],
        dtype=getattr(torch, dtype), head_start=True)
    del trained
    torch.cuda.empty_cache()
    L = MOE["num_layers"]
    want = {"flash_fwd": L * steps, "flash_dq": L * steps,
            "flash_dkv": L * steps}
    step_ms = split["step"]
    share = {k: split[k] / step_ms for k in
             ("flash_fwd", "flash_bwd", "dispatch_einsum", "combine_einsum")}
    T = MOE_BATCH * MOE_SEQ
    C = max(1, int(np.ceil(MOE["capacity_factor"] * K * T
                           / MOE["num_experts"])))
    row = {"phase": "moe_train", "gpu": gpu, "trainer": "SingleTrainer",
           "model": "MoETransformerLM(attn_impl='flash')", **MOE,
           "num_selected": K, "capacity": C, "seq_len": MOE_SEQ,
           "batch_size": MOE_BATCH, "params": n_params,
           "optimizer": "adam, warmup_cosine_decay_schedule(0, "
                        f"{MOE_PEAK_LR}, 2, {4 * steps})",
           "rounds": MOE_ROUNDS, "steps_per_program": MOE_STEPS,
           "local_steps": steps, "dtype": dtype,
           "reduced": f"{steps} steps; depth and widths are the class's "
                      "own defaults",
           "dispatch_tensor_gb": K * T * MOE["num_experts"] * C * 4 / 1e9,
           "setup_s": setup_s, "seconds": wall,
           "tokens_per_s": steps * T / wall,
           "ms_per_local_step": wall / steps * 1e3,
           "history": [float(v) for v in hist], "launches": launches,
           "launches_wanted": want, "launches_by_entry": entries,
           "other_kernels": others, "center_max_abs_change": moved,
           "peak_memory_gb": peak / 1e9, "step_split_ms": split,
           "step_share": share,
           "step_split": "one local step at B=8, L=512 by CUDA events, "
                         "outside the trainer (mean of 3 after a warm "
                         "step, a spin kernel holding the card until the "
                         "host enqueued the step); flash_fwd/flash_bwd "
                         "around each kernel wrapper call, dispatch/"
                         "combine_einsum around each forward einsum (their "
                         "backward is inside 'backward')"}
    emit(row)
    if not (np.all(np.isfinite(hist)) and moved > 0
            and hist[0] != hist[-1]):
        fail(f"moe_train K={K} {dtype}: the loss is not finite or did not "
             f"move: {hist}, center change {moved}")
    if launches != want:
        fail(f"moe_train K={K} {dtype}: flash launches {launches} in "
             f"{steps} steps; want {want} (once a layer a step)")
    if others:
        fail(f"moe_train K={K} {dtype}: other kernels launched: {others}")
    if split["calls"] != {"flash_fwd": L, "flash_bwd": L,
                          "dispatch_einsum": L, "combine_einsum": L}:
        fail(f"moe_train K={K} {dtype}: the step split timed "
             f"{split['calls']}")
    only_dtype("moe", entries, dtype)
    moe_parity(torch, seed, K, dtype,
               df["features"][:MOE_PARITY_BATCH],
               df["label"][:MOE_PARITY_BATCH])
    return launches


_BN_NET = []


def bn_net_class():
    """The port's counterpart of ``examples/keras_batchnorm.py``'s keras
    model, registered so a blob of it deserializes (defined once, after
    torch is imported)."""
    if _BN_NET:
        return _BN_NET[0]
    from torch import nn

    from distkeras_tpu_torch.models.base import (BatchNorm, ConfigMixin,
                                                 register_model)

    @register_model
    class KerasBNNet(ConfigMixin, nn.Module):
        config_fields = ("features", "hidden", "num_classes")

        def __init__(self, features=BN_FEATURES, hidden=BN_HIDDEN,
                     num_classes=BN_CLASSES, seed: int = 0):
            super().__init__()
            import torch

            self.config = dict(features=features, hidden=hidden,
                               num_classes=num_classes)
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)  # nn.Linear draws from it
                self.Dense_0 = nn.Linear(features, hidden)
                self.BatchNorm_0 = BatchNorm(hidden, momentum=0.9)
                self.Dense_1 = nn.Linear(hidden, hidden)
                self.BatchNorm_1 = BatchNorm(hidden, momentum=0.9)
                self.Dense_2 = nn.Linear(hidden, num_classes)

        def forward(self, x):
            import torch

            x = torch.relu(self.BatchNorm_0(self.Dense_0(x)))
            x = torch.relu(self.BatchNorm_1(self.Dense_1(x)))
            return self.Dense_2(x)

    _BN_NET.append(KerasBNNet)
    return KerasBNNet


def bn_frame(seed: int):
    """The example's data: deliberately unnormalized blobs (x25 + 11)."""
    from distkeras_tpu_torch.data import DataFrame

    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(BN_CLASSES, BN_FEATURES))
    y = rng.integers(0, BN_CLASSES, size=BN_ROWS)
    x = ((centers[y] + rng.normal(scale=0.5, size=(BN_ROWS, BN_FEATURES)))
         * 25 + 11).astype(np.float32)
    return DataFrame({"features": x, "label": y.astype(np.int32)})


def bn_model(torch, seed: int, device: str):
    from distkeras_tpu_torch.models.base import Model

    return Model.build(bn_net_class()(seed=seed),
                       np.zeros((1, BN_FEATURES), np.float32), device=device)


def bn_optimizer(arm: str):
    from distkeras_tpu_torch.ops.optimizers import adam

    name, lr = BN_ARMS[arm]
    return (name if name == "sgd" else adam(lr, mu_dtype="bfloat16")), lr


def bn_state_equal(a, b) -> bool:
    """Parameters and buffers of two models bit-equal."""
    sa, sb = a.module.state_dict(), b.module.state_dict()
    return set(sa) == set(sb) and all(
        sa[k].shape == sb[k].shape and bool((sa[k].cpu() == sb[k].cpu())
                                            .all()) for k in sa)


def bn_carry_phase(torch, gpu: str, seed: int, workdir: str) -> dict:
    """Mutable model state through the engines on the card: the example's
    BatchNorm model under ADAG (4 workers, batch 32, window 4) in two arms
    (sgd, and adam with ``mu_dtype=bfloat16``), every kernel count 0 just
    before each run (the path is cuBLAS: none may launch). Checked: the
    statistics after a fold equal the mean of the four workers' own
    windows; the card's run within ``BN_PARITY_*`` of the same run on the
    CPU; ``EnsembleTrainer``'s members keep distinct statistics; a
    serialize/deserialize round trip and a checkpoint resume bit-equal."""
    from distkeras_tpu_torch import ADAG, EnsembleTrainer
    from distkeras_tpu_torch.data import make_batches
    from distkeras_tpu_torch.parallel import ADAGFold, AsyncEngine
    from distkeras_tpu_torch.runtime.serialization import (deserialize_model,
                                                           serialize_model)
    from distkeras_tpu_torch.workers import derive_seed

    df = bn_frame(seed)
    W, Kw, B = (BN_TRAIN["num_workers"], BN_TRAIN["communication_window"],
                BN_TRAIN["batch_size"])
    rows = {}
    for arm in BN_ARMS:
        opt, lr = bn_optimizer(arm)
        model = bn_model(torch, seed, "cuda")
        init = {k: v.clone() for k, v in model.module.state_dict().items()}
        t = ADAG(model, opt, "sparse_categorical_crossentropy",
                 learning_rate=lr, **BN_TRAIN)
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        trained = t.train(df)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_no_kernel(f"bn_carry {arm}")
        hist = t.get_worker_histories()
        stats_moved = max((trained.state["buffers"][k] - init[k]).abs()
                          .max().item() for k in trained.state["buffers"])
        # the fold: one round by hand, the statistics against the workers'
        eng = AsyncEngine(model, bn_optimizer(arm)[0],
                          "sparse_categorical_crossentropy", ADAGFold(),
                          window=Kw, num_workers=W, learning_rate=lr)
        plan = make_batches(df, "features", "label", B, num_workers=W,
                            window=Kw)
        st = eng.init_state()
        xs, ys = (torch.as_tensor(a).to("cuda") for a in plan.round(0))
        new, _ = eng._round_fn(st, xs, ys)
        own = [eng._local_loop(st.center, eng.tx.init(st.center), xs[w],
                               ys[w], rng=derive_seed(st.rng, w),
                               state=st.model_state[w])[2]
               for w in range(W)]
        fold_mean = all(torch.equal(new.model_state[w][k], torch.stack(
            [o[k] for o in own]).mean(0)) for w in range(W) for k in own[0])
        workers_apart = min((own[0][k] - own[1][k]).abs().max().item()
                            for k in own[0])
        # card vs CPU, BN_PARITY_ROUNDS rounds from the same weights
        rows_n = BN_PARITY_ROUNDS * W * Kw * B
        small = {"features": df["features"][:rows_n],
                 "label": df["label"][:rows_n]}
        from distkeras_tpu_torch.data import DataFrame

        runs = {}
        for dev in ("cuda", "cpu"):
            m = bn_model(torch, seed, dev)
            runs[dev] = ADAG(m, bn_optimizer(arm)[0],
                             "sparse_categorical_crossentropy",
                             learning_rate=lr, **{**BN_TRAIN,
                                                  "num_epoch": 1}).train(
                DataFrame(small))
        card_sd = runs["cuda"].module.state_dict()
        cpu_sd = runs["cpu"].module.state_dict()
        # A bias that feeds a BatchNorm has a gradient of 0 in exact
        # arithmetic (the batch mean removes it): adam's normalised step
        # turns its rounding noise into moves up to the rate, on the card
        # and on the CPU apart, and the running mean follows it; any
        # nearly cancelling gradient does the same to a few elements. So
        # the adam arm holds every element within twice the rate a local
        # step, and each other tensor by its mean error; sgd every element.
        if arm == "sgd":
            noise, noise_err = None, None
            close = all(torch.allclose(card_sd[k].cpu(), v,
                                       rtol=BN_PARITY_RTOL,
                                       atol=BN_PARITY_ATOL)
                        for k, v in cpu_sd.items())
            rel = max(((card_sd[k].cpu() - v).abs()
                       / (BN_PARITY_ATOL / BN_PARITY_RTOL + v.abs()))
                      .max().item() for k, v in cpu_sd.items())
        else:
            noise = 2 * lr * BN_PARITY_ROUNDS * Kw
            fed = {"Dense_0.bias", "Dense_1.bias", "BatchNorm_0.mean",
                   "BatchNorm_1.mean"}
            noise_err = max((card_sd[k].cpu() - v).abs().max().item()
                            for k, v in cpu_sd.items())
            rel = max(((card_sd[k].cpu() - v).abs().mean()
                       / (BN_PARITY_ATOL / BN_PARITY_RTOL + v.abs().mean()))
                      .item() for k, v in cpu_sd.items() if k not in fed)
            close = noise_err <= noise and rel <= BN_PARITY_RTOL
        # serialize / deserialize on the card
        blob = serialize_model(trained)
        back = deserialize_model(blob, device="cuda")
        probe = torch.as_tensor(df["features"][:256], device="cuda")
        round_trip = (bn_state_equal(back, trained) and torch.equal(
            back.predict(probe), trained.predict(probe)))
        # checkpoint resume against the uninterrupted run
        ck = os.path.join(workdir, arm)
        shutil.rmtree(ck, ignore_errors=True)
        half = {**BN_TRAIN, "num_epoch": 1}
        ADAG(bn_model(torch, seed, "cuda"), bn_optimizer(arm)[0],
             "sparse_categorical_crossentropy", learning_rate=lr, **half,
             checkpoint_dir=ck, checkpoint_every=1).train(df)
        resumed = ADAG(bn_model(torch, seed, "cuda"), bn_optimizer(arm)[0],
                       "sparse_categorical_crossentropy", learning_rate=lr,
                       **BN_TRAIN, checkpoint_dir=ck, checkpoint_every=1,
                       resume=True).train(df)
        resume_equal = bn_state_equal(resumed, trained)
        row = {"phase": "bn_carry", "gpu": gpu, "arm": arm,
               "trainer": "ADAG", "model": "Dense 64, BatchNorm, relu, "
               "Dense 64, BatchNorm, relu, Dense 4 (16 features)",
               "optimizer": arm, "learning_rate": lr, **BN_TRAIN,
               "rows": BN_ROWS, "seconds": wall,
               "samples_per_s": plan.samples_per_round * plan.num_rounds
               * BN_TRAIN["num_epoch"] / wall,
               "history": [float(v) for v in t.get_history()],
               "stats_max_abs_change": stats_moved,
               "fold_state_is_workers_mean": fold_mean,
               "workers_stats_min_max_abs_apart": workers_apart,
               "card_vs_cpu_rel_err": rel,
               "card_vs_cpu_rel_err_is": "max" if arm == "sgd" else
               "mean a tensor, the pre-BN biases and running means aside",
               "card_vs_cpu_max_abs_err": noise_err,
               "adam_noise_bound": noise,
               "card_vs_cpu_close": close,
               "parity": f"{BN_PARITY_ROUNDS} rounds, params and statistics "
                         f"within rtol {BN_PARITY_RTOL}, atol "
                         f"{BN_PARITY_ATOL}",
               "blob_bytes": len(blob), "round_trip_bit_equal": round_trip,
               "resume_bit_equal": resume_equal}
        rows[arm] = row
        emit(row)
        if not (np.all(np.isfinite(hist)) and stats_moved > 0.1):
            fail(f"bn_carry {arm}: loss not finite or statistics did not "
                 f"move ({stats_moved})")
        if not (fold_mean and workers_apart > 0):
            fail(f"bn_carry {arm}: the folded statistics are not the mean "
                 f"of the workers' (apart {workers_apart})")
        if not close:
            fail(f"bn_carry {arm}: card vs CPU beyond rtol "
                 f"{BN_PARITY_RTOL}/atol {BN_PARITY_ATOL} ({rel}; largest "
                 f"{noise_err} against {noise})")
        if not round_trip:
            fail(f"bn_carry {arm}: the blob round trip is not bit-equal")
        if not resume_equal:
            fail(f"bn_carry {arm}: the resumed run is not bit-equal to the "
                 "uninterrupted one")
    # EnsembleTrainer: every member keeps its own statistics
    reset_all_launches()
    members = EnsembleTrainer(bn_model(torch, seed, "cuda"), "sgd",
                              "sparse_categorical_crossentropy",
                              learning_rate=0.05, **{
                                  **BN_TRAIN, "num_epoch": 1}).train(df)
    check_no_kernel("bn_carry ensemble")
    stats = [torch.cat([v.ravel() for v in m.state["buffers"].values()])
             for m in members]
    apart = min((stats[i] - stats[j]).abs().max().item()
                for i in range(len(stats)) for j in range(i + 1, len(stats)))
    emit({"phase": "bn_carry", "trainer": "EnsembleTrainer",
          "members": len(members), "stats_min_max_abs_apart": apart})
    if not apart > 0:
        fail("bn_carry: EnsembleTrainer members share their statistics")
    return rows


# -- the fleet control plane and the simulator -------------------------------

#: ``elastic_parity``: config #4 (DynSGD, sgd lr 0.01, batch 2048, window 4,
#: int8 commits) at full width, one worker, as an ``ElasticTraining`` job on
#: a one-slot ``FleetScheduler`` and through ``run_remote``: the same plan
#: and seed, so the two centers must be the same bits (one claimant takes
#: the items in round-major order, ``run_remote``'s serial path; the JAX
#: package's own pair is bit-equal too, ``tests/test_torch_fleet.py``).
ELASTIC = dict(batch_size=2048, communication_window=4, learning_rate=0.01)
ELASTIC_ROUNDS = 3
#: ``fleet_card``: one pool of 4 slots on the one card (the reference's
#: ``tests/smoke_fleet_chaos.py`` on the card): ``acme/imdb`` (config #4 as
#: ``ElasticTraining``, up to 4 workers, floor 1, ``FLEET_ROUNDS`` rounds),
#: ``serve/imdb`` (a ``ServingService`` of the same model in f32, floor 1,
#: up to 2 replicas) and ``corp/mlp`` (priority 5, gang 2, the smoke's MLP
#: ``ElasticTraining``) submitted after acme's ``FLEET_CORP_AFTER``-th
#: commit. Once corp runs, ``preempt@R:1`` is installed with R one past
#: the fleet's commits then: the forced preemption finds every job at its
#: floor, so the serving drain is refused and acme is drained and requeued.
FLEET_CAPACITY = 4
FLEET_ROUNDS = 3
FLEET_CORP_AFTER = 4
FLEET_REQUESTS = (1, 3, 17, 64)
FLEET_MLP = dict(rows=512, batch_size=16, window=4, num_epoch=3, workers=2,
                 learning_rate=0.1)
FLEET_TIMEOUT_S = 300.0


def elastic_inputs(seed: int, workers: int, rounds: int):
    """Config #4's model on the card from ``seed`` and the plan of an
    ``imdb()`` frame of ``rounds`` rounds of ``workers`` x window x batch."""
    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch.data.batching import make_batches
    from distkeras_tpu_torch.datasets import imdb

    Kw, B = ELASTIC["communication_window"], ELASTIC["batch_size"]
    model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                      seq_len=SEQ_LEN, seed=seed, device="cuda")
    df = imdb(n=rounds * workers * Kw * B, vocab_size=VOCAB,
              seq_len=SEQ_LEN, seed=seed)
    return model, make_batches(df, "features", "label", B,
                               num_workers=workers, window=Kw)


def elastic_parity_phase(torch, K, F, gpu: str, seed: int) -> dict:
    """``elastic_parity``: see :data:`ELASTIC`. The launch counts are set
    to 0 just before each run and read just after. Returns the elastic
    run's counts."""
    from distkeras_tpu_torch.fleet import (ElasticTraining, FleetJob,
                                           FleetScheduler)
    from distkeras_tpu_torch.netps import PSServer
    from distkeras_tpu_torch.netps.remote import run_remote
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer

    Kw, B, lr = (ELASTIC["communication_window"], ELASTIC["batch_size"],
                 ELASTIC["learning_rate"])
    loss = get_loss("sparse_categorical_crossentropy")
    steps = ELASTIC_ROUNDS * Kw
    runs = {}
    with env_set(DKTPU_NET_COMPRESS="int8"):
        model, plan = elastic_inputs(seed, 1, ELASTIC_ROUNDS)
        rt = ElasticTraining(model=model, tx=get_optimizer("sgd", lr),
                             loss_fn=loss, plan=plan, discipline="dynsgd",
                             seed=seed)
        sched = FleetScheduler(capacity=1, tick_s=0.005)
        job = sched.submit(FleetJob("parity", "acme", rt, min_gang=1,
                                    max_workers=1))
        torch.cuda.synchronize()
        K.reset_launches()
        F.reset_launches()
        t0 = time.perf_counter()
        sched.run(timeout=FLEET_TIMEOUT_S)
        torch.cuda.synchronize()
        runs["elastic"] = dict(
            seconds=time.perf_counter() - t0, lstm=K.launch_counts(),
            fold=F.launch_counts(), log=list(rt.server.commit_log),
            params=rt.result().params, losses=rt.losses, state=job.state)
        sched.close()
        model, plan = elastic_inputs(seed, 1, ELASTIC_ROUNDS)
        srv = PSServer(discipline="dynsgd", device="cuda").start()
        try:
            torch.cuda.synchronize()
            K.reset_launches()
            F.reset_launches()
            t0 = time.perf_counter()
            params, losses = run_remote(
                endpoint=srv.endpoint, model=model,
                tx=get_optimizer("sgd", lr), loss_fn=loss, plan=plan,
                discipline="dynsgd", window=Kw, seed=seed)
            torch.cuda.synchronize()
            runs["run_remote"] = dict(
                seconds=time.perf_counter() - t0, lstm=K.launch_counts(),
                fold=F.launch_counts(), log=list(srv.commit_log),
                params=params, losses=losses, state="done")
        finally:
            srv.close()
    a, b = runs["elastic"], runs["run_remote"]
    equal = all(torch.equal(a["params"][k], b["params"][k])
                for k in b["params"])
    diff = max((a["params"][k] - b["params"][k]).abs().max().item()
               for k in b["params"])
    failures = []
    for name, r in runs.items():
        if r["state"] != "done" or len(r["log"]) != ELASTIC_ROUNDS:
            failures.append(f"{name}: {r['state']}, {len(r['log'])} commits")
        if not (r["lstm"]["lstm_fwd_stash"] == r["lstm"]["lstm_bwd"] == steps
                and r["lstm"]["lstm_fwd"] == 0):
            failures.append(f"{name}: LSTM launches {r['lstm']} in {steps} "
                            f"local steps")
        if r["fold"] != {"fold_commit": len(r["log"]), "fold_int8": 0,
                         "fold_bf16": 0}:
            failures.append(f"{name}: fold launches {r['fold']} for "
                            f"{len(r['log'])} commits")
    if not equal:
        failures.append(f"the elastic center is {diff} from run_remote's")
    if not np.array_equal(a["losses"], b["losses"]):
        failures.append("the elastic losses are not run_remote's")
    emit({"phase": "elastic_parity", "gpu": gpu,
          "config": "config #4: imdb_lstm at full width, DynSGD, sgd",
          **ELASTIC, "rounds": ELASTIC_ROUNDS, "workers": 1,
          "codec": "int8", "discipline": "dynsgd",
          "center_bit_equal": equal, "center_max_abs_diff": diff,
          "losses_equal": bool(np.array_equal(a["losses"], b["losses"])),
          **{f"{name}_{k}": v for name, r in runs.items() for k, v in (
              ("seconds", r["seconds"]),
              ("samples_per_s", steps * B / r["seconds"]),
              ("launches", {**r["lstm"], **r["fold"]}),
              ("staleness", [st for _w, _s, st in r["log"]]))}})
    if failures:
        fail("elastic_parity: " + "; ".join(failures))
    return {**a["lstm"], **a["fold"]}


def fleet_mlp_runtime(torch, seed: int):
    """``corp/mlp``: the reference smoke's MLP (16 hidden, 3 classes on 4
    features, seeded blobs) as an ``ElasticTraining`` job on the card."""
    from distkeras_tpu_torch.data import DataFrame
    from distkeras_tpu_torch.data.batching import make_batches
    from distkeras_tpu_torch.fleet import ElasticTraining
    from distkeras_tpu_torch.models import MLP, Model
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer

    rng = np.random.default_rng(seed + 12)
    centers = rng.normal(scale=4.0, size=(3, 4))
    y = rng.integers(0, 3, size=FLEET_MLP["rows"])
    x = (centers[y] + rng.normal(scale=0.5, size=(len(y), 4))).astype(
        np.float32)
    torch.manual_seed(seed + 12)
    model = Model.build(MLP(hidden=(16,), num_outputs=3, in_features=4),
                        np.zeros((1, 4), np.float32), device="cuda")
    frame = DataFrame({"features": x, "label": y.astype(np.int32)})
    plan = make_batches(frame, "features", "label", FLEET_MLP["batch_size"],
                        num_workers=FLEET_MLP["workers"],
                        window=FLEET_MLP["window"],
                        num_epoch=FLEET_MLP["num_epoch"], shuffle=True,
                        seed=seed)
    rt = ElasticTraining(
        model=model, tx=get_optimizer("sgd", FLEET_MLP["learning_rate"]),
        loss_fn=get_loss("sparse_categorical_crossentropy"), plan=plan,
        discipline="adag", seed=seed + 2)
    return rt, x, y


def fleet_card_phase(torch, K, F, gpu: str, seed: int,
                     remote_samples_per_s: float) -> dict:
    """``fleet_card``: see :data:`FLEET_CAPACITY`. Every kernel count is set
    to 0 just before the scheduler starts and read after the last training
    job is done. Returns ``{kernel: launches}``."""
    from distkeras_tpu_torch import imdb_lstm, telemetry
    from distkeras_tpu_torch.fleet import (DONE, FAILED, RUNNING,
                                           ElasticTraining, FleetJob,
                                           FleetScheduler)
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer
    from distkeras_tpu_torch.serving import (ServeClient, ServingError,
                                             ServingService)
    from distkeras_tpu_torch.telemetry.report import build_report

    Kw, B = ELASTIC["communication_window"], ELASTIC["batch_size"]
    workdir = os.path.join("build", "fleet_card")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    model, plan = elastic_inputs(seed, FLEET_CAPACITY, FLEET_ROUNDS)
    acme = ElasticTraining(
        model=model, tx=get_optimizer("sgd", ELASTIC["learning_rate"]),
        loss_fn=get_loss("sparse_categorical_crossentropy"), plan=plan,
        discipline="dynsgd", seed=seed)
    windows = [0]
    acme.ensure_started()

    def counted(loop):
        def run(*a, **kw):
            out = loop(*a, **kw)
            with lock:
                windows[0] += 1
            return out
        return run

    lock = threading.Lock()
    acme._loops = [counted(lp) for lp in acme._loops]
    serve_model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED,
                            hidden_size=HIDDEN, seq_len=SEQ_LEN,
                            seed=seed + 3, device="cuda")
    cpu_model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED,
                          hidden_size=HIDDEN, seq_len=SEQ_LEN, device="cpu")
    cpu_model.module.load_state_dict(
        {k: v.cpu() for k, v in serve_model.module.state_dict().items()})
    rng = np.random.default_rng(seed + 4)
    requests = {n: rng.integers(0, VOCAB, (n, SEQ_LEN)).astype(np.int32)
                for n in FLEET_REQUESTS}
    want = {n: cpu_model.predict(x).numpy() for n, x in requests.items()}
    svc = ServingService(serve_model, buckets=BUCKETS)
    corp_rt, corp_x, corp_y = fleet_mlp_runtime(torch, seed)

    sched = FleetScheduler(capacity=FLEET_CAPACITY, tick_s=0.02)
    jobs = {"acme/imdb": sched.submit(FleetJob(
                "imdb", "acme", acme, min_gang=1, max_workers=FLEET_CAPACITY)),
            "serve/imdb": sched.submit(FleetJob(
                "imdb", "serve", svc, min_gang=1, max_workers=2,
                kind="serving"))}
    served = {"answered": 0, "shed": 0, "failed": [], "max_err": 0.0}
    floor, times = [], {}
    stop = threading.Event()

    def client_loop():
        i = 0
        while not stop.is_set():
            eps = svc.endpoints()
            if not eps:
                time.sleep(0.005)
                continue
            n = FLEET_REQUESTS[i % len(FLEET_REQUESTS)]
            i += 1
            c = ServeClient(eps, timeout=10.0, retries=5, backoff=0.02)
            try:
                out, _v = c.infer(requests[n])
                err = float(np.abs(out - want[n]).max())
                served["answered"] += 1
                served["max_err"] = max(served["max_err"], err)
            except ServingError:
                served["shed"] += 1
            except Exception as e:  # noqa: BLE001 - a request lost
                served["failed"].append(repr(e))
            finally:
                c.close()

    def watch():
        # one last pass after ``stop``: the main thread may see the jobs
        # end before this loop's next poll does, and their end times must
        # still be read
        while True:
            last = stop.is_set()
            st = sched.stats()
            now = time.perf_counter()
            for jid, row in st.items():
                if row["state"] == RUNNING:
                    times.setdefault(jid, [now, None])
                if row["state"] in (DONE, FAILED) and jid in times:
                    times[jid][1] = times[jid][1] or now
            if st["serve/imdb"]["state"] == RUNNING:
                floor.append(st["serve/imdb"]["active"])
            if last:
                return
            time.sleep(0.005)

    telemetry.reset()
    torch.cuda.synchronize()
    reset_all_launches()
    threads = [threading.Thread(target=client_loop, name="fleet-client"),
               threading.Thread(target=watch, name="fleet-watch")]
    stack = contextlib.ExitStack()
    t0 = time.perf_counter()
    try:
        stack.enter_context(env_set(DKTPU_NET_COMPRESS="int8"))
        sched.start()
        for t in threads:
            t.start()
        deadline = time.monotonic() + FLEET_TIMEOUT_S

        def wait_for(cond, what):
            while not cond():
                if time.monotonic() > deadline:
                    fail(f"fleet_card: timed out waiting for {what}: "
                         f"{sched.stats()}")
                time.sleep(0.005)

        wait_for(lambda: acme.progress() >= FLEET_CORP_AFTER,
                 f"acme's commit {FLEET_CORP_AFTER}")
        jobs["corp/mlp"] = sched.submit(FleetJob(
            "mlp", "corp", corp_rt, priority=5, min_gang=2,
            max_workers=FLEET_MLP["workers"]))
        wait_for(lambda: jobs["corp/mlp"].state != "queued",
                 "corp's placement")
        at = sum(j.runtime.progress() for j in jobs.values()) + 1
        _plan, net = stack.enter_context(fault_plan(net=f"preempt@{at}:1"))
        wait_for(lambda: all(jobs[j].state in (DONE, FAILED)
                             for j in ("acme/imdb", "corp/mlp")),
                 "the training jobs")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launched_kernels()
        missed = unfired(net)
    finally:
        stop.set()
        for t in threads:
            if t.ident is not None:
                t.join()
        sched.close()
        stack.close()
    counters = telemetry.get().snapshot()["counters"]
    jsonl = os.path.join(workdir, "fleet_run.jsonl")
    telemetry.write_jsonl(telemetry.get(), jsonl)
    rollup = build_report(jsonl)["fleet"]
    shutil.rmtree(workdir, ignore_errors=True)

    logs = {"acme/imdb": list(acme.server.commit_log),
            "corp/mlp": list(corp_rt.server.commit_log)}
    stats = sched.stats()
    failures = []
    for jid in ("acme/imdb", "corp/mlp"):
        if jobs[jid].state != DONE:
            failures.append(f"{jid} ended {jobs[jid].state} "
                            f"({jobs[jid].error!r})")
        pairs = [(w, q) for w, q, _st in logs[jid]]
        if len(pairs) != len(set(pairs)):
            failures.append(f"{jid}: a (wid, seq) was folded twice")
    items = FLEET_ROUNDS * FLEET_CAPACITY
    if not (acme._queue.committed == acme.progress() == items
            == len(logs["acme/imdb"]) and acme.done()
            and not np.isnan(acme.losses).any()):
        failures.append(f"acme/imdb committed {acme._queue.committed} "
                        f"items ({len(logs['acme/imdb'])} folds) of {items}")
    if sched.floor_violations:
        failures.append(f"{sched.floor_violations} floor violations")
    a = stats["acme/imdb"]
    if not (a["shrinks"] >= 1 and a["expands"] >= 1):
        failures.append(f"acme/imdb never shrank and re-expanded: {a}")
    refused = counters.get("fleet.serving_drains_refused", 0)
    if not floor or min(floor) < 1 or refused < 1 or missed:
        failures.append(f"the serving floor: min replicas "
                        f"{min(floor) if floor else None}, drains refused "
                        f"{refused}, unfired {missed}")
    if served["failed"] or not served["answered"]:
        failures.append(f"requests: {served['answered']} answered, "
                        f"{served['shed']} shed, failed "
                        f"{served['failed'][:3]}")
    if served["max_err"] > SERVE_ATOL:
        failures.append(f"served logits {served['max_err']} from the CPU "
                        f"forward (limit {SERVE_ATOL})")
    folds = len(logs["acme/imdb"]) + len(logs["corp/mlp"])
    fold = {k: launches.get(f"fold.{k}", 0) for k in (
        "fold_commit", "fold_int8", "fold_bf16")}
    if fold != {"fold_commit": folds, "fold_int8": 0, "fold_bf16": 0}:
        failures.append(f"fold launches {fold} for {folds} applied int8 "
                        f"commits")
    lstm = {k: launches.get(f"lstm.{k}", 0) for k in (
        "lstm_fwd", "lstm_fwd_stash", "lstm_bwd")}
    if not (lstm["lstm_fwd_stash"] == lstm["lstm_bwd"] == Kw * windows[0]):
        failures.append(f"LSTM launches {lstm} for {windows[0]} windows of "
                        f"{Kw} local steps (retried windows included)")
    if lstm["lstm_fwd"] < served["answered"]:
        failures.append(f"{lstm['lstm_fwd']} forward launches for "
                        f"{served['answered']} answered requests")
    others = {k: v for k, v in launches.items()
              if not k.startswith(("lstm.", "fold."))}
    if others:
        failures.append(f"kernels off the path launched: {others}")
    tenants = {r["tenant"] for r in rollup}
    if not {"acme", "serve", "corp"} <= tenants:
        failures.append(f"the report's fleet rollup names {sorted(tenants)}")

    def tenant(jid):
        row = {k: stats[jid][k] for k in ("state", "shrinks", "expands",
                                          "preemptions", "requeues",
                                          "restarts")}
        span = times.get(jid, [None, None])
        # the serving tenant runs until the scheduler closes: to the end
        row["seconds"] = ((span[1] or t0 + wall) - span[0]) if span[0] \
            else None
        if jid in logs:
            st = [x for _w, _q, x in logs[jid]]
            row.update(commits=len(st), staleness_mean=float(np.mean(st)),
                       staleness_max=int(max(st)))
        else:
            row.update(requests_answered=served["answered"],
                       requests_shed=served["shed"],
                       min_replicas=min(floor) if floor else None,
                       served_progress=svc.progress())
        return row

    acc = float((corp_rt.result().predict(corp_x).argmax(-1).cpu().numpy()
                 == corp_y).mean())
    acme_sps = items * Kw * B / (times["acme/imdb"][1]
                                 - times["acme/imdb"][0])
    emit({"phase": "fleet_card", "gpu": gpu, "capacity": FLEET_CAPACITY,
          "tenants": {jid: tenant(jid) for jid in jobs},
          "acme_config": {"config": "config #4 (imdb_lstm at full width)",
                          **ELASTIC, "rounds": FLEET_ROUNDS,
                          "items": items, "discipline": "dynsgd",
                          "codec": "int8"},
          "corp_config": {"model": "MLP(hidden=(16,), 3 classes, 4 "
                                   "features)", **FLEET_MLP,
                          "discipline": "adag", "priority": 5,
                          "accuracy": acc},
          "acme_samples_per_s": acme_sps,
          "run_remote_4_workers_samples_per_s": remote_samples_per_s,
          "acme_vs_run_remote": acme_sps / remote_samples_per_s,
          "preempt_fault": f"preempt@{at}:1",
          "serving_drains_refused": refused,
          "liveness_requeues": counters.get("fleet.liveness_requeues", 0),
          "floor_violations": sched.floor_violations,
          "serve_max_abs_err": served["max_err"],
          "serve_atol": SERVE_ATOL, "windows_run": windows[0],
          "launches": launches, "seconds": wall,
          "report_tenants": sorted(tenants)})
    if failures:
        fail("fleet_card: " + "; ".join(failures))
    return lstm | fold


def sim_phase(gpu: str) -> None:
    """``sim``: every entry of ``SCENARIOS`` at its default size with seed
    0, twice (the outputs must be the same bytes and each scenario's own
    checks must pass), then ``python -m distkeras_tpu_torch.sim run
    preemption_storm --seed 0 --json`` once (exit 0, the same output).
    Host only: the simulator touches no device, and no kernel may launch."""
    from distkeras_tpu_torch.sim import SCENARIOS, run_scenario

    reset_all_launches()
    rows, failures, outs = {}, [], {}
    for name in SCENARIOS:
        texts, secs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            out = run_scenario(name, seed=0)
            secs.append(time.perf_counter() - t0)
            texts.append(json.dumps(out, sort_keys=True))
        outs[name] = out
        rows[name] = {"seconds": secs, "identical": texts[0] == texts[1],
                      "ok": out["ok"], "checks": out["checks"],
                      "virtual_s": out.get("virtual_s"),
                      "events": out.get("events")}
        if texts[0] != texts[1] or not out["ok"]:
            failures.append(f"{name}: identical {texts[0] == texts[1]}, "
                            f"checks {out['checks']}")
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "distkeras_tpu_torch.sim",
                          "run", "preemption_storm", "--seed", "0",
                          "--json"], capture_output=True, text=True,
                         timeout=300)
    cli_s = time.perf_counter() - t0
    try:
        same = json.loads(cli.stdout) == json.loads(json.dumps(
            outs["preemption_storm"]))
    except ValueError:
        same = False
    if cli.returncode != 0 or not same:
        failures.append(f"the CLI: rc {cli.returncode}, same output {same}, "
                        f"stderr {cli.stderr[-400:]}")
    if launched_kernels():
        failures.append(f"kernels launched: {launched_kernels()}")
    emit({"phase": "sim", "gpu": gpu,
          "host_only": "the simulator runs on the host, as the JAX "
                       "package's does; the card is idle in this phase",
          "scenarios": rows,
          "crossover_curve": "BENCH_SUMMARY.json of the repository (the "
                             "reference's recorded curve; the card's own "
                             "curve is replayed in netps_config8)",
          "cli": {"argv": cli.args[1:], "returncode": cli.returncode,
                  "same_output": same, "seconds": cli_s}})
    if failures:
        fail("sim: " + "; ".join(failures))


#: ``streaming_config11``: BASELINE config #11 as ``bench.py``'s
#: ``_measure_streaming`` defines it (the reference's
#: ``tests/smoke_streaming_chaos.py`` leg 1 checks), on the card: an MLP
#: (16 hidden, 3 classes on 4 features) trained by a ``StreamingTraining``
#: job (2 workers, ADAG, sgd 0.1, its parameter server on the card) on a
#: ``FleetScheduler`` pool of 2 slots, off a ``StreamProducer`` socket feed
#: of 90 records of K=2 x B=16 whose labels rotate from record 30 on
#: (``drift@30``), held silent 0.2 s at record 8 (``feed_gap@8:0.2``) and
#: severed at record 45, the producer at most 24 records ahead of the
#: job's progress; a ``ModelRegistry`` hot-swaps its checkpoints (every 8
#: committed records) through the drift watch's regression gate.
STREAM = dict(total=90, drift_at=30, workers=2, k=2, batch=16, features=4,
              classes=3, checkpoint_every=8, fast=8, slow=40, ahead=24,
              sever_at=45, capacity=2, tick_s=0.02, regress_floor=0.5,
              poll_s=0.1, learning_rate=0.1, held_out=64)
STREAM_FAULTS = "feed_gap@8:0.2;drift@30;seed=3"
STREAM_TIMEOUT_S = 420.0
STREAM_MIN_ACCURACY = 0.8
STREAM_MAX_FRESHNESS_S = 60.0
#: ``streaming_kill``: the reference smoke's leg 2 on config #4 at full
#: width: a one-worker ``StreamingTraining`` child (DynSGD, sgd lr 0.01,
#: records of K=2 x B=256 ``imdb()`` rows) against a durable ``python -m
#: distkeras_tpu_torch.netps --device cuda`` server with a state directory;
#: ``kill@6`` SIGKILLs the child as it claims record 6, and a second child
#: resumes from the offset journal and the newest checkpoint.
STREAM_KILL = dict(total=12, kill_at=6, k=2, batch=256, checkpoint_every=4,
                   learning_rate=0.01)
#: ``stream_engine``: ``AsyncEngine.run_stream`` of config #4 (DynSGD, 2
#: workers, window 2, batch 2048, sgd lr 0.01) over an endless generator,
#: bounded by ``max_items``; then ``SyncEngine.run_stream`` of config #5's
#: ResNet-50 in bf16 at ``RESNET``'s widths, 2 items.
STREAM_ENGINE = dict(items=4, workers=2, window=2, batch=2048,
                     learning_rate=0.01)
STREAM_ENGINE_RESNET_ITEMS = 2
#: ``raced``: ``run_raced`` of config #4 at full width (DynSGD) on 4 worker
#: threads, each with its own local loop, the first round held at a barrier
#: (``overlap_first_round``), each worker cycling its shard of 2 windows of
#: K=2 x B=256 rows over 6 rounds (every worker's second window starts
#: once all first-round commits landed); then one worker for 3 rounds,
#: replayed through ``fold_delta`` on the card. The local optimizer is adam at 3e-3
#: (fresh each window, as the reference's raced workers start theirs):
#: config #4's sgd at 0.01 moves the LSTM's loss by less than its noise in
#: a dozen windows (0.6929 -> 0.6940 over 4 windows on the CPU at B=128,
#: lr 0.05), so the falling-loss check needs an optimizer that learns in
#: that many steps.
RACED = dict(workers=4, rounds=6, shard=2, window=2, batch=256,
             optimizer="adam", learning_rate=3e-3, one_worker_rounds=3)


def stream_blobs(rng, centers, k: int, b: int):
    """``k`` x ``b`` rows of the config #11 blobs: labels and features."""
    y = rng.integers(0, len(centers), size=(k, b))
    x = (centers[y] + rng.normal(scale=0.5, size=(k, b, centers.shape[1]))
         ).astype(np.float32)
    return x, y.astype(np.int32)


def streaming_config11_phase(torch, K, F, gpu: str, seed: int,
                             workdir: str) -> dict:
    """``streaming_config11``: see :data:`STREAM`. Every kernel count is set
    to 0 just before the scheduler starts and read after the job is done.
    Returns the fold counts and the commits folded."""
    from distkeras_tpu_torch import checkpoint as ckpt_mod
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.fleet import DONE, FleetJob, FleetScheduler
    from distkeras_tpu_torch.models import MLP, Model
    from distkeras_tpu_torch.netps.fold import backend_name
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer
    from distkeras_tpu_torch.serving import ModelRegistry
    from distkeras_tpu_torch.streaming import (DriftWatch, OffsetJournal,
                                               SocketSource,
                                               StreamingTraining,
                                               StreamProducer, WindowedEval)
    from distkeras_tpu_torch.telemetry.report import build_report

    S = STREAM
    C, D = S["classes"], S["features"]

    def build():
        return Model.build(MLP(hidden=(16,), num_outputs=C, in_features=D,
                               seed=seed),
                           np.zeros((1, D), np.float32), device="cuda")

    rng = np.random.default_rng(seed + 7)
    centers = rng.normal(scale=4.0, size=(C, D))
    xh, yh = stream_blobs(rng, centers, 1, S["held_out"])
    xh, yh_drift = xh[0], ((yh[0] + 1) % C).astype(np.int32)

    def held_out_loss(cand) -> float:
        logits = np.asarray(cand.infer((xh,)), np.float64)
        logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        return float(-logp[np.arange(len(yh_drift)), yh_drift].mean())

    ckpt_dir = os.path.join(workdir, "ckpt")
    journal_path = os.path.join(workdir, "offsets.json")
    telemetry.reset()
    with fault_plan(STREAM_FAULTS) as (plan, _net):
        prod = StreamProducer()
        watch = DriftWatch(window=WindowedEval(fast=S["fast"],
                                               slow=S["slow"]))
        rt = StreamingTraining(
            model=build(), tx=get_optimizer("sgd", S["learning_rate"]),
            loss_fn=get_loss("sparse_categorical_crossentropy"),
            source=SocketSource(prod.endpoint, drift_classes=C),
            num_workers=S["workers"], discipline="adag", seed=seed,
            journal=journal_path, checkpoint_dir=ckpt_dir,
            checkpoint_every=S["checkpoint_every"], drift_watch=watch,
            max_pending=8, device="cuda")
        severed = []

        def produce():
            prng = np.random.default_rng(seed + 11)
            t0 = time.monotonic()
            for i in range(S["total"]):
                while (i - rt.progress() > S["ahead"]
                       and time.monotonic() - t0 < STREAM_TIMEOUT_S):
                    time.sleep(0.02)
                prod.feed(*stream_blobs(prng, centers, S["k"], S["batch"]))
                if i == S["sever_at"]:
                    # the source kill: reconnect-and-resume is part of the
                    # measured run
                    prod.kill_connections()
                    severed.append(rt.progress())
            prod.end()

        registry = ModelRegistry(
            build(), (S["held_out"],), directory=ckpt_dir,
            poll_s=S["poll_s"],
            quality_gate=watch.regression_gate(
                held_out_loss, regress_floor=S["regress_floor"]),
            device="cuda")
        registry.start()
        sched = FleetScheduler(capacity=S["capacity"], tick_s=S["tick_s"])
        job = sched.submit(FleetJob("stream", "bench", rt, priority=0,
                                    min_gang=1, max_workers=S["workers"]))
        producer = threading.Thread(target=produce, daemon=True)
        torch.cuda.synchronize()
        reset_all_launches()  # counts start at 0 just before the main path
        producer.start()
        t0 = time.perf_counter()
        sched.start()
        try:
            ok = sched.wait(timeout=STREAM_TIMEOUT_S)
            wall = time.perf_counter() - t0
        finally:
            sched.close()
            registry.close()
            prod.close()
        torch.cuda.synchronize()
        fold = F.launch_counts()
        others = {k: v for k, v in launched_kernels().items()
                  if not k.startswith("fold.")}
        not_fired = unfired(plan)
    producer.join(timeout=10)
    reg = telemetry.get()
    events = reg.events()
    kinds = {e["kind"] for e in events}
    fired = {e.get("fault") for e in events if e["kind"] == "fault_injected"}
    reconnects = int(reg.counter("stream.source_reconnects").value)
    pairs = [(w, s) for w, s, _st in rt.server.commit_log]
    journal = OffsetJournal(journal_path)
    journal_ok = journal.load()
    committed = journal.committed_offsets_upto(S["total"])
    registry.poll_once()  # the final checkpoint
    bm, version = registry.current()
    meta = ckpt_mod.read_meta(ckpt_dir, version) or {}
    acc = float((np.asarray(bm.infer((xh,))).argmax(-1) == yh_drift).mean())
    jsonl = os.path.join(workdir, "run.jsonl")
    telemetry.write_jsonl(reg, jsonl)
    strm = build_report(jsonl).get("streaming") or {}
    fresh = sorted(e["seconds"] for e in events
                   if e["kind"] == "serve_freshness")
    n = len(fresh)
    failures = []
    if not ok or job.state != DONE or rt.errors:
        failures.append(f"the job ended {job.state} (drained {ok}), errors "
                        f"{rt.errors[:2]}")
    if not {"feed_gap", "drift"} <= fired or not_fired:
        failures.append(f"drills fired {sorted(fired)}, unfired {not_fired}")
    if reconnects < 1:
        failures.append("the severed feed connection never reconnected")
    if not {"stream_drift_detected", "stream_drift_recovered"} <= kinds:
        failures.append(f"the drift page: events {sorted(kinds)}")
    if not (watch.last_recovery_s or 0) > 0 or watch.paging:
        failures.append(f"recovery {watch.last_recovery_s}, still paging "
                        f"{watch.paging}")
    if len(pairs) != S["total"] or len(set(pairs)) != len(pairs):
        failures.append(f"{len(pairs)} folds ({len(set(pairs))} distinct) "
                        f"for {S['total']} records")
    if not journal_ok or committed != set(range(S["total"])):
        failures.append(f"the journal holds {len(committed)} of "
                        f"{S['total']} records")
    if version < 0 or not meta.get("items", 0) > S["drift_at"] \
            or meta.get("event_ts") is None:
        failures.append(f"served step {version}, meta {meta}")
    if not acc > STREAM_MIN_ACCURACY:
        failures.append(f"served accuracy on the drifted world {acc}")
    if not (strm.get("items_committed", 0) >= S["total"]
            and strm.get("drift_events", 0) >= 1
            and strm.get("source_reconnects", 0) >= 1
            and strm.get("freshness_count", 0) >= 1
            and "recovery_s" in strm and "candidate_loss" in strm):
        failures.append(f"the report's Streaming section: {strm}")
    fmax = strm.get("freshness_max_s")
    if fmax is None or not fmax < STREAM_MAX_FRESHNESS_S:
        failures.append(f"freshness_max_s {fmax}")
    if fold != {"fold_commit": len(pairs), "fold_int8": 0, "fold_bf16": 0}:
        failures.append(f"fold launches {fold} for {len(pairs)} commits")
    if others:
        failures.append(f"other kernels launched: {others}")
    if backend_name(rt.server._center) != "cuda":
        failures.append("the job's parameter server folds off the card")
    emit({"phase": "streaming_config11", "gpu": gpu,
          "config": "BASELINE config #11 (bench.py _measure_streaming): "
                    "MLP(16) on 4 features, 3 classes; ADAG, sgd 0.1",
          **S, "faults": STREAM_FAULTS, "seconds": wall,
          "items_per_s": S["total"] / wall,
          "drift_recovery_s": watch.last_recovery_s,
          "drift_events": watch.drift_events,
          "freshness_p50_s": fresh[n // 2] if n else None,
          "freshness_p99_s": fresh[min(n - 1, int(n * 0.99))] if n else None,
          "swaps": n, "served_step": version,
          "served_acc_drifted": acc, "source_reconnects": reconnects,
          "severed_at_progress": severed,
          "staleness": [st for _w, _s, st in rt.server.commit_log],
          "fold_backend": backend_name(rt.server._center),
          "launches": fold, "commits": len(pairs),
          "fold_launches_per_commit": fold["fold_commit"] / max(len(pairs),
                                                                1),
          "report_streaming": strm})
    if failures:
        fail("streaming_config11: " + "; ".join(failures))
    return {"fold_commit": fold["fold_commit"], "commits": len(pairs)}


def stream_child(argv) -> int:
    """The ``streaming_kill`` child: one life of a one-worker
    ``StreamingTraining`` of config #4 against the CLI server at
    ``argv[1]``, reading ``argv[0]/stream.bin``, journaling to
    ``argv[0]/offsets.json`` and checkpointing under ``argv[0]/ckpt``,
    resumed from both. ``DKTPU_FAULTS`` in its environment may SIGKILL it.
    At its end it writes what it delivered and launched to
    ``argv[0]/child.json``."""
    work, endpoint, seed = argv[0], argv[1], int(argv[2])
    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch.ops.kernels import lstm
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer
    from distkeras_tpu_torch.streaming import (FileTailSource,
                                               StreamingTraining)

    S = STREAM_KILL
    src = FileTailSource(os.path.join(work, "stream.bin"), poll_s=0.02)
    delivered = []

    class Recorder:
        drift_from = None

        def read(self, start_index, skip):
            for rec in src.read(start_index, skip):
                delivered.append(rec.index)
                yield rec

        def close(self):
            src.close()

    model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                      seq_len=SEQ_LEN, seed=seed, device="cuda")
    rt = StreamingTraining(
        model=model, tx=get_optimizer("sgd", S["learning_rate"]),
        loss_fn=get_loss("sparse_categorical_crossentropy"),
        source=Recorder(), num_workers=1, discipline="dynsgd", seed=seed,
        endpoint=endpoint, journal=os.path.join(work, "offsets.json"),
        checkpoint_dir=os.path.join(work, "ckpt"),
        checkpoint_every=S["checkpoint_every"], resume=True, device="cuda")
    rt.ensure_started()
    lstm.reset_launches()
    rt.worker_main(0, lambda: True)
    rt.close()
    with open(os.path.join(work, "child.json"), "w") as f:
        json.dump({"delivered": delivered, "lstm": lstm.launch_counts(),
                   "committed": rt.journal.items_committed,
                   "errors": [repr(e) for e in rt.errors]}, f)
    return 1 if rt.errors else 0


#: how ``streaming_kill`` starts a child: this file's :func:`stream_child`
#: through ``python -c`` from the repository root.
STREAM_CHILD = ("import sys, chip_smoke\n"
                "sys.exit(chip_smoke.stream_child(sys.argv[1:]))\n")


def stream_kill_server(workdir: str) -> dict:
    """Start ``streaming_kill``'s durable CLI server (dynsgd, on the card,
    its state and fold journal in ``workdir/ps-state``, no compaction, its
    fold launches written at its exit) without waiting for it: its start
    overlaps ``streaming_config11``."""
    state = os.path.join(workdir, "ps-state")
    os.makedirs(state, exist_ok=True)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    launches = os.path.join(workdir, "fold_launches.json")
    env = {k: v for k, v in os.environ.items()
           if k not in ("DKTPU_FAULTS", "DKTPU_FAULTS_STATE",
                        "DKTPU_NET_FAULTS")}
    cmd = [sys.executable, "-c", OBS_CLI, launches, "--host", "127.0.0.1",
           "--port", str(port), "--discipline", "dynsgd", "--device", "cuda",
           "--state-dir", state, "--snapshot-every", "100000"]
    return {"dir": workdir, "state": state, "launches": launches,
            "endpoint": f"127.0.0.1:{port}", "t0": time.monotonic(),
            "proc": subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                     env=env)}


def streaming_kill_phase(torch, gpu: str, seed: int, srv: dict) -> dict:
    """``streaming_kill``: see :data:`STREAM_KILL`. The resumed child's
    LSTM counts start at 0 after its start-up; the server's fold counts
    cover both lives. Returns ``{kernel: launches}``."""
    from distkeras_tpu_torch.datasets import imdb
    from distkeras_tpu_torch.netps import state as netps_state
    from distkeras_tpu_torch.streaming import (OffsetJournal,
                                               StreamFileWriter,
                                               replayed_offsets)

    S = STREAM_KILL
    work = srv["dir"]
    n, k, b = S["total"], S["k"], S["batch"]
    frame = imdb(n=n * k * b, vocab_size=VOCAB, seq_len=SEQ_LEN,
                 seed=seed + 31)
    xs = frame["features"].reshape(n, k, b, SEQ_LEN)
    ys = frame["label"].reshape(n, k, b)
    w = StreamFileWriter(os.path.join(work, "stream.bin"))
    for i in range(n):
        w.append(xs[i], ys[i], ts=float(i))
    w.end()
    line = srv["proc"].stdout.readline()
    if not line.startswith("NETPS_READY"):
        fail(f"streaming_kill: the CLI server did not start: {line!r}")
    ready_s = time.monotonic() - srv["t0"]
    env = dict(os.environ, DKTPU_FAULTS=f"kill@{S['kill_at']}",
               DKTPU_FAULTS_STATE=os.path.join(work, "faults.state"))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.getcwd()] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-c", STREAM_CHILD, work, srv["endpoint"],
           str(seed)]
    failures, lives = [], []
    try:
        for life in (1, 2):
            t0 = time.perf_counter()
            r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=300)
            lives.append({"returncode": r.returncode,
                          "seconds": time.perf_counter() - t0,
                          "stderr_tail": r.stderr[-600:]})
            if life == 1:
                if r.returncode != -signal.SIGKILL:
                    fail(f"streaming_kill: the first child ended "
                         f"{r.returncode}, not by its scheduled SIGKILL: "
                         f"{r.stderr[-1200:]}")
                j = OffsetJournal(os.path.join(work, "offsets.json"))
                before = (j.committed_offsets_upto(n) if j.load()
                          else set())
            elif r.returncode != 0:
                fail(f"streaming_kill: the resumed child failed "
                     f"({r.returncode}): {r.stderr[-1200:]}")
        srv["proc"].send_signal(signal.SIGTERM)
        srv_rc = srv["proc"].wait(timeout=120)
    finally:
        if srv["proc"].poll() is None:
            srv["proc"].kill()
            srv["proc"].wait()
    with open(os.path.join(work, "child.json")) as f:
        child = json.load(f)
    with open(srv["launches"]) as f:
        fold = json.load(f)
    j = OffsetJournal(os.path.join(work, "offsets.json"))
    after = j.committed_offsets_upto(n) if j.load() else set()
    replay = replayed_offsets(before, child["delivered"])
    records = netps_state.read_journal(srv["state"])
    pairs = [(int(r["wid"]), int(r["seq"])) for r in records]
    steps = (n - S["kill_at"]) * k
    lstm = child["lstm"]
    if before != set(range(S["kill_at"])):
        failures.append(f"the journal at the kill holds {sorted(before)}")
    if replay:
        failures.append(f"the resume replayed {sorted(replay)}")
    if child["committed"] != n or after != set(range(n)):
        failures.append(f"the stream ended with {child['committed']} "
                        f"committed, the journal holding {len(after)}")
    if len(pairs) != n or len(set(pairs)) != n:
        failures.append(f"the PS journal holds {len(pairs)} folds "
                        f"({len(set(pairs))} distinct) for {n} records")
    if fold.get("fold_commit") != n or srv_rc != 0:
        failures.append(f"server fold launches {fold} (exit {srv_rc}) for "
                        f"{n} records")
    if not (lstm["lstm_fwd_stash"] == lstm["lstm_bwd"] == steps
            and lstm["lstm_fwd"] == 0):
        failures.append(f"the resumed child's LSTM launches {lstm} in "
                        f"{steps} local steps")
    emit({"phase": "streaming_kill", "gpu": gpu,
          "config": "config #4 at full width (imdb_lstm: vocab 20000, "
                    "embed 64, hidden 128, seq 200), DynSGD, one worker",
          **S, "server_ready_s": ready_s, "lives": lives,
          "journal_at_kill": sorted(before),
          "delivered_after_resume": child["delivered"],
          "replayed": sorted(replay), "ps_journal_folds": len(pairs),
          "server_exit": srv_rc, "server_fold_launches": fold,
          "resumed_child_launches": lstm})
    if failures:
        fail("streaming_kill: " + "; ".join(failures))
    return {**lstm, "fold_commit": fold["fold_commit"]}


def endless(x, y, shape: tuple, seed: int):
    """An endless source of round batches ``(x[idx], y[idx])``, ``idx`` a
    fresh draw of ``shape`` rows of the pool ``x``, ``y`` for each item;
    the pool is made before the run, so the source costs one gather an
    item (the staging a stream's feeder hides)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    while True:
        idx = rng.permutation(len(y))[:n].reshape(shape)
        yield x[idx], y[idx]


def stream_engine_phase(torch, K, G, gpu: str, seed: int) -> dict:
    """``stream_engine``: see :data:`STREAM_ENGINE`. Each run's counts are
    set to 0 just before it and read just after. Returns ``{"lstm": ...,
    "groupnorm": ...}``."""
    from distkeras_tpu_torch import imdb_lstm, resnet50
    from distkeras_tpu_torch.parallel import AsyncEngine, DynSGDFold
    from distkeras_tpu_torch.parallel.sync import SyncEngine

    from distkeras_tpu_torch.datasets import imdb

    E = STREAM_ENGINE
    W, Kw, B = E["workers"], E["window"], E["batch"]
    frame = imdb(n=2 * W * Kw * B, vocab_size=VOCAB, seq_len=SEQ_LEN,
                 seed=seed + 41)
    model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                      seq_len=SEQ_LEN, seed=seed, device="cuda")
    eng = AsyncEngine(model, "sgd", "sparse_categorical_crossentropy",
                      DynSGDFold(), window=Kw, num_workers=W,
                      learning_rate=E["learning_rate"], seed=seed)
    seen = []
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    state, losses = eng.run_stream(
        endless(frame["features"], frame["label"], (W, Kw, B), seed),
        on_item=lambda i, loss, st: seen.append(i), max_items=E["items"])
    torch.cuda.synchronize()
    async_s = time.perf_counter() - t0
    lstm = K.launch_counts()
    async_others = {k: v for k, v in launched_kernels().items()
                    if not k.startswith("lstm.")}
    moved = max((state.center[k] - v).abs().max().item()
                for k, v in model.params.items())
    steps = E["items"] * W * Kw
    del model, eng, state
    torch.cuda.empty_cache()

    RB, RK = RESNET["batch_size"], RESNET["steps_per_program"]
    rmodel = resnet50(norm_impl="pallas", seed=seed, device="cuda")
    reng = SyncEngine(rmodel, "sgd", "sparse_categorical_crossentropy",
                      num_workers=1, learning_rate=RESNET["learning_rate"],
                      compute_dtype=torch.bfloat16, seed=seed)

    pool = resnet_data(RK * RB, seed + 43)
    rseen = []
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    _rstate, rlosses = reng.run_stream(
        endless(pool["features"], pool["label"], (1, RK, RB), seed),
        on_item=lambda i, loss, st: rseen.append(i),
        max_items=STREAM_ENGINE_RESNET_ITEMS)
    torch.cuda.synchronize()
    sync_s = time.perf_counter() - t0
    gn = G.launch_counts()
    entries = G.launch_counts(by_entry=True)
    sync_others = {k: v for k, v in launched_kernels().items()
                   if not k.startswith("groupnorm.")}
    rsteps = STREAM_ENGINE_RESNET_ITEMS * RK
    del rmodel, reng, _rstate
    torch.cuda.empty_cache()
    failures = []
    if losses.shape != (E["items"], W) or not np.all(np.isfinite(losses)):
        failures.append(f"async losses {losses.tolist()}")
    if seen != list(range(E["items"])) or not moved > 0:
        failures.append(f"async items seen {seen}, center moved {moved}")
    if not (lstm["lstm_fwd_stash"] == lstm["lstm_bwd"] == steps
            and lstm["lstm_fwd"] == 0) or async_others:
        failures.append(f"async launches {lstm} {async_others} in {steps} "
                        f"local steps")
    if rlosses.shape != (STREAM_ENGINE_RESNET_ITEMS,) \
            or not np.all(np.isfinite(rlosses)) \
            or rseen != list(range(STREAM_ENGINE_RESNET_ITEMS)):
        failures.append(f"sync losses {rlosses.tolist()}, seen {rseen}")
    want = GN_PER_STEP * rsteps
    if gn != {"group_norm_fwd": want, "group_norm_bwd": want} or sync_others:
        failures.append(f"sync GroupNorm launches {gn} {sync_others} in "
                        f"{rsteps} steps; want {GN_PER_STEP} of each a step")
    other = {k: v for k, v in entries.items() if v and not k.endswith("_bf16")}
    if other:
        failures.append(f"the bf16 run launched {other}")
    emit({"phase": "stream_engine", "gpu": gpu,
          "async": {"config": "config #4 at full width, DynSGD",
                    **E, "seconds": async_s,
                    "samples_per_s": steps * B / async_s,
                    "losses": losses.tolist(), "launches": lstm,
                    "local_steps": steps, "center_max_abs_change": moved},
          "sync": {"config": "config #5: resnet50(norm_impl='pallas'), "
                             "bf16", **RESNET,
                   "items": STREAM_ENGINE_RESNET_ITEMS, "seconds": sync_s,
                   "samples_per_s": rsteps * RB / sync_s,
                   "losses": rlosses.tolist(), "launches": gn,
                   "launches_by_entry": entries, "local_steps": rsteps,
                   "gn_per_step": GN_PER_STEP}})
    if failures:
        fail("stream_engine: " + "; ".join(failures))
    return {"lstm": lstm, "groupnorm": gn}


def raced_phase(torch, K, F, gpu: str, seed: int) -> dict:
    """``raced``: see :data:`RACED`. The counts are set to 0 just before
    each run and read just after. Returns ``{"race": ..., "one_worker":
    ...}`` launch counts."""
    import copy

    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch.datasets import imdb
    from distkeras_tpu_torch.netps.fold import (fold_delta, host_mirror,
                                                seat_center)
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer
    from distkeras_tpu_torch.racelab import run_raced
    from distkeras_tpu_torch.workers import derive_seed, make_local_loop

    R = RACED
    W, Kw, B = R["workers"], R["window"], R["batch"]
    model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                      seq_len=SEQ_LEN, seed=seed, device="cuda")
    names = list(model.params)
    init = [v.detach().cpu().numpy().copy() for v in model.params.values()]
    tx = get_optimizer(R["optimizer"], R["learning_rate"])
    loss_fn = get_loss("sparse_categorical_crossentropy")
    frame = imdb(n=W * R["shard"] * Kw * B, vocab_size=VOCAB,
                 seq_len=SEQ_LEN, seed=seed + 53)
    fx = frame["features"].reshape(W, R["shard"], Kw, B, SEQ_LEN)
    fy = frame["label"].reshape(W, R["shard"], Kw, B)

    def batches(workers: int, rounds: int) -> list:
        return [[(fx[w, r % R["shard"]], fy[w, r % R["shard"]])
                 for r in range(rounds)] for w in range(workers)]

    def window_fn(workers: int, record: list):
        """``local_steps`` on the port's local loops, one per worker
        thread (handed out on a thread's first call), recording each
        window's mean loss per thread and each (pulled, new) pair. A
        thread's second window waits until every thread has made its
        first commit (entered its second window), so the first W commits
        are the W first-round ones, each pulled at counter 0: staleness
        0..W-1 in commit order. The later rounds race freely."""
        pool = [make_local_loop(copy.deepcopy(model.module), loss_fn, tx)
                for _ in range(workers)]
        mine, lock, losses = {}, threading.Lock(), {}
        second = threading.Barrier(workers)

        def steps(flat, batch):
            me = threading.get_ident()
            with lock:
                if me not in mine:
                    mine[me] = pool.pop()
                    losses[me] = []
            if len(losses[me]) == 1:
                second.wait(timeout=300)
            params = {k: torch.as_tensor(a, device="cuda")
                      for k, a in zip(names, flat)}
            xs, ys = (torch.as_tensor(a, device="cuda") for a in batch)
            new, _opt, _st, step_losses = mine[me](
                params, tx.init(params), xs, ys,
                rng=derive_seed(seed, len(losses[me])), state=None)
            losses[me].append(float(step_losses.mean()))
            out = [new[k] for k in names]
            if record is not None:
                record.append(([a.copy() for a in flat],
                               [o.detach().cpu().numpy() for o in out]))
            return out

        return steps, losses

    steps, losses = window_fn(W, None)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    center, ps = run_raced(center=init, local_steps=steps,
                           worker_batches=batches(W, R["rounds"]),
                           window=Kw, discipline="dynsgd",
                           overlap_first_round=True, device="cuda")
    torch.cuda.synchronize()
    race_s = time.perf_counter() - t0
    race = {**K.launch_counts(), **F.launch_counts()}
    race_others = {k: v for k, v in launched_kernels().items()
                   if not k.startswith(("lstm.", "fold."))}
    first = float(np.mean([v[0] for v in losses.values()]))
    last = float(np.mean([v[-1] for v in losses.values()]))
    commits = len(ps.commit_log)

    record1: list = []
    steps1, _losses1 = window_fn(1, record1)
    rounds1 = R["one_worker_rounds"]
    torch.cuda.synchronize()
    reset_all_launches()
    center1, ps1 = run_raced(center=init, local_steps=steps1,
                             worker_batches=batches(1, rounds1), window=Kw,
                             discipline="dynsgd", device="cuda")
    torch.cuda.synchronize()
    one = {**K.launch_counts(), **F.launch_counts()}
    # the plain loop: the same window deltas through fold_delta on a
    # center seated on the card, one commit after another
    flat, offsets, views = seat_center(init, "cuda")
    for pulled, new in record1:
        fold_delta(views, [n - p for n, p in zip(new, pulled)], "dynsgd", 0)
    plain = host_mirror(flat, offsets, views)
    bit_equal = all(np.array_equal(a, b) for a, b in zip(center1, plain))
    failures = []
    if ps.commit_log[:W] != list(range(W)) or commits != W * R["rounds"]:
        failures.append(f"commit log {ps.commit_log}")
    steps_run = commits * Kw
    if not (race["lstm_fwd_stash"] == race["lstm_bwd"] == steps_run
            and race["lstm_fwd"] == 0 and race["fold_commit"] == commits
            and race["fold_int8"] == race["fold_bf16"] == 0) or race_others:
        failures.append(f"race launches {race} {race_others} for {commits} "
                        f"commits of {Kw} steps")
    if not all(np.all(np.isfinite(a)) for a in center):
        failures.append("the raced center is not finite")
    if not last < first:
        failures.append(f"the last windows' mean loss {last} is not below "
                        f"the first's {first}")
    if not bit_equal or ps1.commit_log != [0] * rounds1 \
            or one["fold_commit"] != rounds1:
        failures.append(f"one worker: bit-equal {bit_equal}, log "
                        f"{ps1.commit_log}, launches {one}")
    emit({"phase": "raced", "gpu": gpu,
          "config": "config #4 at full width, DynSGD, center on the card",
          **R, "seconds": race_s, "commit_log": ps.commit_log,
          "first_window_loss": first, "last_window_loss": last,
          "window_losses": [v for v in losses.values()],
          "launches": race, "commits": commits,
          "one_worker_launches": one,
          "one_worker_bit_equal_to_plain_fold_loop": bit_equal})
    if failures:
        fail("raced: " + "; ".join(failures))
    return {"race": race, "one_worker": one}


#: the ``ranks`` phase: config #4's run as ``train`` runs it (DynSGD, 4
#: workers, window 4, batch 2048, 3 rounds, f32) and config #5's as
#: ``resnet_train`` runs it in bf16 (batch 128, 2 steps a round), cut to
#: one round, each in child processes that ``job_deployment.Job`` starts on
#: this host: ``nccl1`` is one rank of an NCCL group, ``gloo2`` two ranks
#: of a gloo group on the one card (NCCL refuses two ranks on one device).
RANKS_PARTS = {"nccl1": 1, "gloo2": 2}
RANKS_RESNET_ROUNDS = 1
RANKS_TIMEOUT_S = 420.0


def ranks_child(part: str, out: str, seed: str) -> int:
    """One rank of the ``ranks`` phase (``--ranks-child PART OUT SEED``),
    in the environment ``Job`` rendered: it joins the group (``nccl1``: the
    card's NCCL; ``gloo2``: gloo with the tensors on the card), trains
    config #4 with its launch counts set to 0 just before and read just
    after, and, for ``nccl1``, config #5 in bf16 the same way; it writes
    its center to ``OUT/PART-rank<r>.pt`` and its counts and times to
    ``OUT/PART-rank<r>.json``. It prints nothing."""
    import torch

    from distkeras_tpu_torch import (DynSGD, SynchronousDistributedTrainer,
                                     imdb_lstm, resnet50)
    from distkeras_tpu_torch.datasets import imdb
    from distkeras_tpu_torch.ops import collectives
    from distkeras_tpu_torch.ops.kernels import groupnorm as G
    from distkeras_tpu_torch.ops.kernels import lstm as K
    from distkeras_tpu_torch.runtime import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = int(seed)
    dev = mesh.distributed_initialize(
        backend="nccl" if part == "nccl1" else "gloo", timeout=180)
    r = mesh.rank()
    res = {"rank": r, "world": mesh.world_size(), "device": str(dev),
           "backend": torch.distributed.get_backend()}
    W, Kw, B = (TRAIN["num_workers"], TRAIN["communication_window"],
                TRAIN["batch_size"])
    model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                      seq_len=SEQ_LEN, seed=seed, device="cuda")
    df = imdb(n=TRAIN_ROUNDS * W * Kw * B, vocab_size=VOCAB,
              seq_len=SEQ_LEN, seed=seed)
    trainer = DynSGD(model, worker_optimizer="sgd",
                     loss="sparse_categorical_crossentropy", **TRAIN,
                     compute_dtype="float32")
    collectives.reset_host_staged()
    torch.cuda.synchronize()
    collectives.barrier()
    K.reset_launches()  # counts start at 0 just before the main path runs
    t0 = time.perf_counter()
    trained = trainer.train(df)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res.update(lstm=K.launch_counts(), lstm_seconds=wall,
               lstm_samples_per_s=TRAIN_ROUNDS * W * Kw * B / wall,
               workers_per_rank=W // mesh.world_size(),
               history=[float(v) for v in trainer.get_history()],
               host_staged=dict(collectives.HOST_STAGED))
    # The same run as multi-round programs of BLOCKED_LSTM_R rounds: on
    # the NCCL group the fold's all-reduce and the losses' all-gather are
    # captured into the graph; a gloo group runs its blocks eagerly.
    from distkeras_tpu_torch import telemetry

    blocked = DynSGD(model, worker_optimizer="sgd",
                     loss="sparse_categorical_crossentropy", **TRAIN,
                     compute_dtype="float32",
                     rounds_per_program=BLOCKED_LSTM_R)
    telemetry.reset()
    torch.cuda.synchronize()
    collectives.barrier()
    K.reset_launches()
    t0 = time.perf_counter()
    blocked_trained = blocked.train(df)
    torch.cuda.synchronize()
    snap = telemetry.get().snapshot()
    counters = snap["counters"]
    res.update(blocked_lstm=K.launch_counts(),
               blocked_warmup=K.warmup_counts(),
               blocked_captures=sum(
                   v["count"] for k, v in snap["spans"].items()
                   if k.endswith("program.capture")),
               blocked_seconds=time.perf_counter() - t0,
               blocked_blocks={k: counters.get(f"program.blocks.{k}", 0)
                               for k in ("graph", "eager")},
               blocked_bit_equal=all(
                   torch.equal(v, blocked_trained.params[k])
                   for k, v in trained.params.items()) and (
                   blocked.get_history().tolist()
                   == trainer.get_history().tolist()))
    torch.save({k: v.detach().cpu() for k, v in trained.params.items()},
               os.path.join(out, f"{part}-rank{r}.pt"))
    del model, trained, trainer, blocked, blocked_trained
    torch.cuda.empty_cache()
    if part == "nccl1":
        Bn, Kn = RESNET["batch_size"], RESNET["steps_per_program"]
        steps = RANKS_RESNET_ROUNDS * Kn
        model = resnet50(norm_impl="pallas", seed=seed, device="cuda")
        rdf = resnet_data(steps * Bn, seed)
        trainer = SynchronousDistributedTrainer(
            model, "sgd", "sparse_categorical_crossentropy", **RESNET,
            compute_dtype="bfloat16")
        torch.cuda.synchronize()
        G.reset_launches()
        t0 = time.perf_counter()
        trainer.train(rdf)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res.update(gn=G.launch_counts(),
                   gn_entries=G.launch_counts(by_entry=True),
                   gn_seconds=wall, gn_samples_per_s=steps * Bn / wall,
                   gn_history=[float(v) for v in trainer.get_history()])
    with open(os.path.join(out, f"{part}-rank{r}.json"), "w") as f:
        json.dump(res, f)
    mesh.distributed_shutdown()
    return 0


def ranks_phase(torch, gpu: str, seed: int, center: dict,
                train_samples_per_s: float) -> dict:
    """``ranks``: training across ranks, each part's ranks launched by the
    port's ``Job`` on this host (``python chip_smoke.py --ranks-child``,
    one process a rank) and supervised to their end. ``center`` is
    ``train``'s config #4 center from the same seed in this process, with
    no group. Returns the children's launch counts by part."""
    from distkeras_tpu_torch.job_deployment import Job, Punchcard

    out = os.path.join("build", "ranks")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    W, Kw = TRAIN["num_workers"], TRAIN["communication_window"]
    steps = TRAIN_ROUNDS * W * Kw
    gn_steps = RANKS_RESNET_ROUNDS * RESNET["steps_per_program"]
    launches = {}
    for part, n in RANKS_PARTS.items():
        card = Punchcard(job_name=f"chip-smoke-ranks-{part}",
                         script="chip_smoke.py", hosts=["localhost"] * n,
                         args=["--ranks-child", part, out, str(seed)])
        job = Job(card, python=sys.executable)
        t0 = time.perf_counter()
        cmds = job.launch(dry_run=False)
        rcs = job.supervise(timeout=RANKS_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if rcs != [0] * n:
            fail(f"ranks {part}: the ranks exited {rcs}")
        ranks = []
        for r in range(n):
            with open(os.path.join(out, f"{part}-rank{r}.json")) as f:
                ranks.append(json.load(f))
        centers = [torch.load(os.path.join(out, f"{part}-rank{r}.pt"),
                              weights_only=True) for r in range(n)]
        apart = max((centers[0][k] - v).abs().max().item()
                    for k, v in center.items())
        ranks_equal = all(torch.equal(c[k], centers[0][k])
                          for c in centers[1:] for k in center)
        staged = [x["host_staged"] for x in ranks]
        row = {"phase": "ranks", "part": part, "gpu": gpu, "ranks": n,
               "backend": ranks[0]["backend"],
               "devices": [x["device"] for x in ranks],
               "model": "imdb_lstm (config #4)", "trainer": "DynSGD",
               **TRAIN, "rounds": TRAIN_ROUNDS,
               "workers_per_rank": ranks[0]["workers_per_rank"],
               "launches": [x["lstm"] for x in ranks],
               "seconds": [x["lstm_seconds"] for x in ranks],
               "samples_per_s": [x["lstm_samples_per_s"] for x in ranks],
               "train_samples_per_s_no_group": train_samples_per_s,
               "job_seconds": wall, "command": cmds[0],
               "center_vs_no_group_max_abs": apart,
               "centers_bit_equal_across_ranks": ranks_equal,
               "host_staged": staged,
               "history": ranks[0]["history"]}
        row.update({"blocked_rounds_per_program": BLOCKED_LSTM_R,
                    "blocked_launches": [x["blocked_lstm"] for x in ranks],
                    "blocked_warmup_launches": [x["blocked_warmup"]
                                                for x in ranks],
                    "blocked_captures": [x["blocked_captures"]
                                         for x in ranks],
                    "blocked_blocks": [x["blocked_blocks"] for x in ranks],
                    "blocked_seconds": [x["blocked_seconds"] for x in ranks],
                    "blocked_bit_equal": [x["blocked_bit_equal"]
                                          for x in ranks]})
        if part == "gloo2":
            row["note"] = ("gloo on purpose: two ranks share the one card, "
                           "which NCCL refuses; every collective of the "
                           "run was staged through the host (host_staged)")
        if part == "nccl1":
            x = ranks[0]
            row.update({"resnet": "resnet50(norm_impl='pallas') (config #5)",
                        "resnet_trainer": "SynchronousDistributedTrainer",
                        "resnet_dtype": "bfloat16", **{
                            f"resnet_{k}": v for k, v in RESNET.items()},
                        "resnet_rounds": RANKS_RESNET_ROUNDS,
                        "resnet_launches": x["gn"],
                        "resnet_launches_by_entry": x["gn_entries"],
                        "resnet_seconds": x["gn_seconds"],
                        "resnet_samples_per_s": x["gn_samples_per_s"],
                        "resnet_history": x["gn_history"]})
        emit(row)
        per_rank = steps // n
        blocks = -(-TRAIN_ROUNDS // BLOCKED_LSTM_R)
        mode = "graph" if part == "nccl1" else "eager"
        for x in ranks:
            if x["world"] != n:
                fail(f"ranks {part}: a rank saw a world of {x['world']}")
            # the blocked run launches the per-round run's kernels plus
            # one warm-up round a capture (none in a gloo group's host loop)
            warm = {k: v // TRAIN_ROUNDS * x["blocked_captures"]
                    for k, v in x["lstm"].items()}
            replayed = {k: v - x["blocked_warmup"][k]
                        for k, v in x["blocked_lstm"].items()}
            if x["blocked_blocks"][mode] != blocks or not \
                    x["blocked_bit_equal"] or replayed != x["lstm"] or \
                    x["blocked_warmup"] != warm or \
                    x["blocked_captures"] != (1 if mode == "graph" else 0):
                fail(f"ranks {part}: the blocked run ran {x['blocked_blocks']}"
                     f" (want {blocks} {mode} blocks), bit-equal "
                     f"{x['blocked_bit_equal']}, launched {x['blocked_lstm']}"
                     f" ({x['blocked_warmup']} in {x['blocked_captures']} "
                     f"warm-up rounds) against {x['lstm']}")
            if (x["lstm"]["lstm_fwd_stash"], x["lstm"]["lstm_bwd"],
                    x["lstm"]["lstm_fwd"]) != (per_rank, per_rank, 0):
                fail(f"ranks {part}: rank {x['rank']} launched {x['lstm']}, "
                     f"want {per_rank} stash forwards and backwards")
            if not np.all(np.isfinite(x["history"])):
                fail(f"ranks {part}: non-finite loss {x['history']}")
        if not ranks_equal:
            fail(f"ranks {part}: the ranks' centers differ")
        if part == "nccl1":
            if ranks[0]["backend"] != "nccl":
                fail(f"ranks nccl1 ran on {ranks[0]['backend']}")
            if apart != 0.0:
                fail(f"ranks nccl1: the one-rank NCCL center is "
                     f"{apart} from the run without a group (a one-rank "
                     "all-reduce is an identity)")
            want = 53 * gn_steps
            gn = ranks[0]["gn"]
            if (gn["group_norm_fwd"], gn["group_norm_bwd"]) != (want, want):
                fail(f"ranks nccl1: ResNet-50 launched {gn}, want {want} "
                     "of each GroupNorm kernel")
            if not all(k.endswith("_bf16") for k, v in
                       ranks[0]["gn_entries"].items() if v):
                fail(f"ranks nccl1: an f32 GroupNorm entry launched in bf16: "
                     f"{ranks[0]['gn_entries']}")
            if not np.all(np.isfinite(ranks[0]["gn_history"])):
                fail(f"ranks nccl1: non-finite ResNet-50 loss")
        else:
            if ranks[0]["backend"] != "gloo":
                fail(f"ranks gloo2 ran on {ranks[0]['backend']}")
            if not apart <= PARITY_ATOL:
                fail(f"ranks gloo2: the centers are {apart} from the run "
                     f"without a group (limit {PARITY_ATOL}, train_parity's)")
        launches[part] = {"lstm": [x["lstm"] for x in ranks],
                          "gn": ranks[0].get("gn")}
    shutil.rmtree(out, ignore_errors=True)
    return launches



# -- the multi-round programs -------------------------------------------------

#: ``blocked``: each part trains twice from one seed, one round a program
#: (``rounds_per_program=1``), then R rounds a program (one captured CUDA
#: graph a block on the card, ``parallel/program.py``), and the two runs
#: are compared. (a) config #1 (``mlp_train``'s trainer) under "auto",
#: past auto's 16-round head; (b) config #4 (``train``'s DynSGD at its
#: widths, 4 workers), f32 then bf16, R=3 (kernels #1 stash and #2 inside
#: the graph, the DynSGD scales rotating through their table); (c) config
#: #5 (``resnet_train``'s trainer) in bf16, R=2 (kernels #6 and #7 inside
#: the graph); (d) config #6 on a one-rank NCCL group, R=2 (kernels #3-#5;
#: ``parallel``'s nccl1 child runs it beside its part a); (e) a small MLP
#: with ``nan@2`` inside a block of 4, which the graph's select skips.
BLOCKED_MLP_ROUNDS = 28
BLOCKED_LSTM_R = 3
BLOCKED_RESNET_R = 2
BLOCKED_RESNET_ROUNDS = 4
BLOCKED_PAR_R = 2
BLOCKED_FAULT = "nan@2"
BLOCKED_FAULT_R = 4
BLOCKED_FAULT_ROUNDS = 8
BLOCKED_FAULT_MLP = dict(num_workers=2, batch_size=64,
                         communication_window=2, learning_rate=0.05)
#: a part whose blocked run is not bit-equal to its per-round run is held
#: to this largest parameter difference (f32, PARITY_ATOL: the
#: card-vs-CPU LSTM parities' limit); (b) must be bit-equal
BLOCKED_ATOL = PARITY_ATOL


def busy_share(torch, prof, wall: float, skip=()):
    """The time the card was busy over ``wall`` seconds: the union of the
    intervals of every device activity ``prof`` recorded (kernels, copies
    and fills, inside graphs too; overlaps counted once), leaving out the
    activity that starts inside a ``skip`` window (wall-clock ns, the
    profiler's clock). None when the profiler saw no device activity."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda
                   and not any(a <= e.start_ns() < b for a, b in skip))
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e9 / wall if busy > 0 else None


def blocked_run(torch, make, df, profile: bool = False) -> dict:
    """``make().train(df)`` with every launch count set to 0 just before
    and read just after; with ``profile``, under ``torch.profiler`` for
    the card's busy share (a separate run: the profiler's own cost stays
    out of the timed one)."""
    from distkeras_tpu_torch import telemetry

    trainer = make()
    telemetry.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    prof = None
    if profile:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    trained = trainer.train(df)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = telemetry.get().snapshot()
    capture = sum(v.get("total", 0.0) for k, v in snap["spans"].items()
                  if k.endswith("program.capture"))
    captures = sum(v.get("count", 0) for k, v in snap["spans"].items()
                   if k.endswith("program.capture"))
    if prof is not None:
        # the captures (the warm-up round's kernels, then host work) are
        # in the run's wall: the share is also read over the rest of it
        prof.__exit__(None, None, None)
        windows = [(e["t0_ns"], e["t1_ns"]) for e in telemetry.get().events()
                   if e["kind"] == "program_capture"]
        # what the card ran against what the wrappers counted (the warm-up
        # rounds' launches and every replay's included)
        return {"busy_share": busy_share(torch, prof, wall),
                "busy_share_after_capture": busy_share(
                    torch, prof, wall - capture, skip=windows),
                "profiled_seconds": wall,
                "device_kernels": device_family_counts(torch, prof),
                "counted_kernels": family_launches(launched_kernels())}
    counters = snap["counters"]
    mode = ("graph" if counters.get("program.blocks.graph") else
            "eager" if counters.get("program.blocks.eager") else "per-round")
    gauge = snap["gauges"].get("program.rounds_per_program") or {}
    return {"seconds": wall, "peak_memory_gb":
            torch.cuda.max_memory_allocated() / 1e9,
            "launches": launched_kernels(), "warmup": warmup_kernels(),
            "captures": captures, "history": np.asarray(
                trainer.get_history(), np.float64),
            "params": {k: v.detach().cpu() for k, v in
                       trained.params.items()},
            "mode": mode, "blocks": {k: counters.get(f"program.blocks.{k}")
                                     for k in ("graph", "eager")},
            "R": gauge.get("value") if gauge.get("count") else 1,
            "capture_s": capture}


def blocked_pair(torch, gpu: str, part: str, make, df, rounds: int,
                 extra: dict, bit_equal_required: bool = False,
                 profile: bool = True) -> dict:
    """Part ``part`` of ``blocked``: ``make(rpp)`` builds the trainer,
    ``rpp`` 1 for the per-round run, None for the part's own R. Returns
    the row (emitted by the caller)."""
    t_part = time.perf_counter()
    # The profiled runs first: they also warm the process for the timed
    # runs (a part's first run pays its first calls).
    busy = {k: blocked_run(torch, lambda: make(rpp), df, profile=True)
            if profile else {}
            for k, rpp in (("per_round", 1), ("blocked", None))}
    runs = {"per_round": blocked_run(torch, lambda: make(1), df),
            "blocked": blocked_run(torch, lambda: make(None), df)}
    for k, extra in busy.items():
        runs[k].update(extra)
    a, b = runs["per_round"], runs["blocked"]
    hist_equal = bool(np.array_equal(a["history"], b["history"],
                                     equal_nan=True))
    params_equal = all(torch.equal(v, b["params"][k])
                       for k, v in a["params"].items())
    diff = max((v.double() - b["params"][k].double()).abs().max().item()
               for k, v in a["params"].items())
    hdiff = float(np.nanmax(np.abs(a["history"] - b["history"]))) if \
        a["history"].size else 0.0
    row = {"phase": "blocked", "part": part, "gpu": gpu, **extra,
           "rounds": rounds, "mode": b["mode"], "blocks": b["blocks"],
           "rounds_per_program": b["R"], "capture_s": b["capture_s"],
           "ms_per_round": {k: r["seconds"] / rounds * 1e3
                            for k, r in runs.items()},
           # the blocked run's wall holds its captures (the first block of
           # each size): its rounds' ms without them
           "blocked_ms_per_round_after_capture":
               (b["seconds"] - b["capture_s"]) / rounds * 1e3,
           "busy_share": {k: r.get("busy_share") for k, r in runs.items()},
           "busy_share_after_capture": {
               k: r.get("busy_share_after_capture")
               for k, r in runs.items()},
           "peak_memory_gb": {k: r["peak_memory_gb"]
                              for k, r in runs.items()},
           "bit_equal": hist_equal and params_equal,
           "params_max_abs_diff": diff, "history_max_abs_diff": hdiff,
           "limit": 0.0 if bit_equal_required else BLOCKED_ATOL,
           "launches": {k: r["launches"] for k, r in runs.items()},
           # of the blocked run's launches, its warm-up rounds' (one a
           # capture, on scratch state)
           "blocked_warmup_launches": b["warmup"], "captures": b["captures"],
           "device_kernels": {k: r.get("device_kernels")
                              for k, r in runs.items()},
           "history": [float(v) for v in b["history"]],
           "seconds": time.perf_counter() - t_part}
    problems = []
    if b["mode"] != "graph":
        problems.append(f"ran in mode {b['mode']}, not graph")
    replayed = {k: v - b["warmup"].get(k, 0)
                for k, v in b["launches"].items()}
    replayed = {k: v for k, v in replayed.items() if v}
    if a["launches"] != replayed:
        problems.append(f"launched {b['launches']} with {b['warmup']} in "
                        f"its warm-up rounds, the per-round run "
                        f"{a['launches']}")
    one_round = {k: v // rounds for k, v in a["launches"].items()}
    if any(v % rounds for v in a["launches"].values()) or b["warmup"] != {
            k: v * b["captures"] for k, v in one_round.items()}:
        problems.append(f"warm-up launches {b['warmup']} are not "
                        f"{b['captures']} rounds of {one_round}")
    for k, r in runs.items():
        if profile and r["device_kernels"] != r["counted_kernels"]:
            problems.append(f"{k}: the card ran {r['device_kernels']}, the "
                            f"wrappers counted {r['counted_kernels']}")
    if not row["bit_equal"] and (bit_equal_required
                                 or not diff <= BLOCKED_ATOL
                                 or not hdiff <= BLOCKED_ATOL):
        problems.append(f"parameters {diff} and history {hdiff} from the "
                        f"per-round run (limit {row['limit']})")
    row["problems"] = problems
    return row


def blocked_phase(torch, gpu: str, seed: int) -> dict:
    """``blocked``, parts (a), (b), (c) and (e) in this process (see
    BLOCKED_MLP_ROUNDS). Returns the rows of parts (b) and (c) by part."""
    from distkeras_tpu_torch import (DynSGD, SingleTrainer,
                                     SynchronousDistributedTrainer, ADAG,
                                     imdb_lstm, mnist_mlp, resnet50)
    from distkeras_tpu_torch.datasets import imdb, mnist

    t_phase = time.perf_counter()
    rows, launches = [], {}
    loss = "sparse_categorical_crossentropy"

    # (a) config #1 under "auto"
    mlp = dict(MLP_TRAIN)
    mlp.pop("rounds_per_program")
    df = mnist(n=BLOCKED_MLP_ROUNDS * mlp["steps_per_program"]
               * mlp["batch_size"], flat=True, seed=seed)
    model = mnist_mlp(seed=seed, device="cuda")
    rows.append(blocked_pair(
        torch, gpu, "a", lambda rpp: SingleTrainer(
            model, "adam", loss, rounds_per_program=rpp or "auto", **mlp),
        df, BLOCKED_MLP_ROUNDS,
        {"config": 1, "model": "mnist_mlp()", "trainer": "SingleTrainer",
         "optimizer": "adam", **mlp, "dtype": "float32",
         "rounds_per_program_asked": "auto"}))
    del df, model

    # (b) config #4, f32 then bf16
    W, Kw, B = (TRAIN["num_workers"], TRAIN["communication_window"],
                TRAIN["batch_size"])
    df = imdb(n=TRAIN_ROUNDS * W * Kw * B, vocab_size=VOCAB,
              seq_len=SEQ_LEN, seed=seed)
    model = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED, hidden_size=HIDDEN,
                      seq_len=SEQ_LEN, seed=seed, device="cuda")
    for dtype in DTYPES:
        row = blocked_pair(
            torch, gpu, f"b_{dtype}", lambda rpp, dt=dtype: DynSGD(
                model, worker_optimizer="sgd", loss=loss, **TRAIN,
                compute_dtype=dt, rounds_per_program=rpp or BLOCKED_LSTM_R),
            df, TRAIN_ROUNDS,
            {"config": 4, "model": "imdb_lstm (config #4)",
             "trainer": "DynSGD", **TRAIN, "dtype": dtype,
             "rounds_per_program_asked": BLOCKED_LSTM_R},
            bit_equal_required=True)
        got = row["launches"]["per_round"]
        steps = TRAIN_ROUNDS * W * Kw
        for name in ("lstm.lstm_fwd_stash", "lstm.lstm_bwd"):
            if got.get(name) != steps:
                row["problems"].append(f"{name} launched {got.get(name)} "
                                       f"times in {steps} local steps")
        rows.append(row)
        launches[f"b_{dtype}"] = row
    del df, model
    torch.cuda.empty_cache()

    # (c) config #5 in bf16, with the crop and flip on the card
    # (sharded_feed's device arm): the draws staged with each block
    from distkeras_tpu_torch.ops.augment import flip_crop_transform

    Bn, Kn = RESNET["batch_size"], RESNET["steps_per_program"]
    df = resnet_data(BLOCKED_RESNET_ROUNDS * Kn * Bn, seed)
    model = resnet50(norm_impl="pallas", seed=seed, device="cuda")
    row = blocked_pair(
        torch, gpu, "c", lambda rpp: SynchronousDistributedTrainer(
            model, "sgd", loss, **RESNET, compute_dtype="bfloat16",
            device_transform=flip_crop_transform(),
            rounds_per_program=rpp or BLOCKED_RESNET_R),
        df, BLOCKED_RESNET_ROUNDS,
        {"config": 5, "model": "resnet50(norm_impl='pallas')",
         "trainer": "SynchronousDistributedTrainer", **RESNET,
         "device_transform": "flip_crop_transform()",
         "dtype": "bfloat16", "rounds_per_program_asked": BLOCKED_RESNET_R})
    want = 53 * BLOCKED_RESNET_ROUNDS * Kn
    got = row["launches"]["per_round"]
    for name in ("groupnorm.group_norm_fwd", "groupnorm.group_norm_bwd"):
        if got.get(name) != want:
            row["problems"].append(f"{name} launched {got.get(name)} times, "
                                   f"want {want}")
    rows.append(row)
    launches["c"] = row
    del df, model
    torch.cuda.empty_cache()

    # (e) nan@2 inside a block of 4
    from distkeras_tpu_torch.data import DataFrame

    kw = BLOCKED_FAULT_MLP
    n = (BLOCKED_FAULT_ROUNDS * kw["num_workers"]
         * kw["communication_window"] * kw["batch_size"])
    frame = mnist(n=n, flat=True, seed=seed + 3)
    df = DataFrame({"features": frame["features"].astype(np.float32) / 255,
                    "label": frame["label"]})
    model = mnist_mlp(hidden=(64,), seed=seed, device="cuda")

    class Faulted:
        """The ADAG trainer with BLOCKED_FAULT installed around its run."""

        def __init__(self, rpp):
            self.t = ADAG(model, "sgd", loss,
                          rounds_per_program=rpp or BLOCKED_FAULT_R, **kw)

        def train(self, d):
            with fault_plan(BLOCKED_FAULT):
                return self.t.train(d)

        def get_history(self):
            return self.t.get_history()

    row = blocked_pair(
        torch, gpu, "e", Faulted, df, BLOCKED_FAULT_ROUNDS,
        {"model": "mnist_mlp(hidden=(64,))", "trainer": "ADAG",
         "optimizer": "sgd", **kw, "dtype": "float32",
         "faults": BLOCKED_FAULT,
         "rounds_per_program_asked": BLOCKED_FAULT_R}, profile=False)
    h = np.asarray(row["history"])
    skipped = [i for i, v in enumerate(h) if not np.isfinite(v)]
    row["skipped_rounds"] = skipped
    if skipped != [2]:
        row["problems"].append(f"rounds {skipped} non-finite, want [2]")
    rows.append(row)
    del df, model
    torch.cuda.empty_cache()

    for row in rows:
        emit(row)
    bad = [f"({r['part']}) {p}" for r in rows for p in r["problems"]]
    if bad:
        fail(f"blocked: {bad}")
    emit({"phase": "blocked_seconds", "gpu": gpu,
          "seconds": time.perf_counter() - t_phase})
    return launches


# -- the model-parallel engines -----------------------------------------------

#: ``parallel``: config #6 (bench.py ``transformer_lm_flash``: the
#: TransformerLM at LM's widths, flash attention, no remat, adam 1e-4,
#: batch 8 at length 2048) through ``ParallelTrainer(parallel={"data":
#: 1})`` on a one-rank NCCL group, PAR_A_ROUNDS rounds of 2 steps in bf16
#: (part a); then two gloo ranks sharing the card (NCCL refuses two ranks
#: on one device) run, in turn, config #6's widths cut to PAR_LAYERS
#: layers under tensor (b), pipeline (c) and sequence (d) parallelism,
#: config #7's model (flash, remat) cut alike under AEASGD with
#: ``parallel={"model": 2}`` (e), and ``moe_train``'s MoE LM with its
#: experts split over two ranks (f); (g) is config #8's center over two
#: devices (two shards on the one card) in this process. Part a_hd256 is
#: part a at 4 heads of 256 (``LM_HD256``: the DP = 256 kernels) and its
#: plain loop from the same initial parameters, in the nccl1 child after
#: part a and blocked (d).
PAR_A = dict(worker_optimizer="adam", learning_rate=1e-4, batch_size=8,
             steps_per_program=2)
PAR_A_ROUNDS = 2
PAR_LAYERS = 2
#: (c) runs f32 sgd (no adam step turns rounding noise into a step of
#: about lr), at this rate
PAR_PIPE = dict(worker_optimizer="sgd", learning_rate=1e-2, batch_size=8,
                steps_per_program=2, num_microbatches=4)
#: (c)'s f32 limit: the pipelined and one-process runs are one function,
#: summed in another order (the microbatches change the matmuls' shapes)
PAR_PIPE_ATOL = 1e-5
PAR_E = dict(num_workers=1, batch_size=8, communication_window=2,
             learning_rate=1e-4, rho=500.0)
PAR_MOE = dict(worker_optimizer="adam", learning_rate=MOE_PEAK_LR,
               batch_size=MOE_BATCH, steps_per_program=2,
               aux_loss_weight=0.01)
PAR_PARTS = {"nccl1": 1, "gloo2": 2}
PAR_TIMEOUT_S = 600.0


def par_lm(torch, seed: int, layers: int, device: str, cfg: dict = LM,
           **kw):
    from distkeras_tpu_torch import small_transformer_lm

    return small_transformer_lm(**dict(cfg, num_layers=layers),
                                seq_len=LM_SEQ, seed=seed, device=device,
                                **kw)


def par_frame(rows: int, seed: int):
    return lm_frame(rows, LM["vocab_size"], LM_SEQ, seed)


def par_moe_frame(seed: int):
    return lm_frame(2 * MOE_BATCH, MOE["vocab_size"], MOE_SEQ, seed + 5)


def flops_per_token(model) -> float:
    """bench.py's train FLOPs a token: 6 x the matmul parameters (every
    parameter but the embeddings) + 6 x L x d_model a layer (the causal
    scores and values)."""
    cfg = model.module.config
    p_embed = (cfg["vocab_size"] + cfg["max_seq_len"]) * cfg["d_model"]
    p_mm = sum(p.numel() for p in model.params.values()) - p_embed
    return 6 * p_mm + 6 * LM_SEQ * cfg["d_model"] * cfg["num_layers"]


def par_train(torch, FA, F, trainer, df, dtype=None) -> dict:
    """``trainer.train(df)`` with every count set to 0 just before and
    read just after; the trained params on the host, and the card's peak
    memory over the run."""
    from distkeras_tpu_torch.ops import collectives

    collectives.reset_host_staged()
    torch.cuda.synchronize()
    collectives.barrier()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launches()
    F.reset_launches()
    t0 = time.perf_counter()
    trained = trainer.train(df)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"params": {k: v.detach().cpu() for k, v in
                       trained.params.items()},
            "launches": FA.launch_counts(),
            "entries": {k: v for k, v in
                        FA.launch_counts(by_entry=True).items() if v},
            "seconds": wall, "history": [float(h) for h in
                                         trainer.get_history()],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "host_staged": dict(collectives.HOST_STAGED)}


def parallel_child(part: str, out: str, seed: str) -> int:
    """One rank of the ``parallel`` phase (``--parallel-child PART OUT
    SEED``), in the environment ``Job`` rendered: ``nccl1`` runs (a) on a
    one-rank NCCL group; ``gloo2`` runs (b) to (f) in turn on two gloo
    ranks sharing the card. Each part's launch counts are set to 0 just
    before its run and read just after; the results go to
    ``OUT/PART-rank<r>.pt``. It prints nothing."""
    import torch

    from distkeras_tpu_torch import AEASGD, ParallelTrainer
    from distkeras_tpu_torch.ops.kernels import build
    from distkeras_tpu_torch.ops.kernels import flash_attention as FA
    from distkeras_tpu_torch.ops.kernels import fold as F
    from distkeras_tpu_torch.runtime import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(["flash_attn", "fold"])
    seed = int(seed)
    mesh.distributed_initialize(
        backend="nccl" if part == "nccl1" else "gloo", timeout=300)
    r = mesh.rank()
    res = {"rank": r, "world": mesh.world_size(),
           "backend": torch.distributed.get_backend()}
    loss = "sparse_categorical_crossentropy"
    if part == "nccl1":
        model = par_lm(torch, seed, LM["num_layers"], "cuda",
                       attn_impl="flash")
        df = par_frame(PAR_A_ROUNDS * 2 * PAR_A["batch_size"], seed)
        t = ParallelTrainer(model, parallel={"data": 1}, loss=loss,
                            compute_dtype="bfloat16", **PAR_A)
        res["a"] = par_train(torch, FA, F, t, df)
        res["a"]["strategy"] = t._resolve_strategy()
        res["a"]["flops_per_token"] = flops_per_token(model)
        # blocked (d): the same run, one round a program, then
        # BLOCKED_PAR_R rounds a captured program
        res["blocked_d"] = blocked_pair(
            torch, "", "d", lambda rpp: ParallelTrainer(
                model, parallel={"data": 1}, loss=loss,
                compute_dtype="bfloat16",
                rounds_per_program=rpp or BLOCKED_PAR_R, **PAR_A),
            df, PAR_A_ROUNDS,
            {"config": 6, "model": "TransformerLM (config #6, flash)",
             "trainer": "ParallelTrainer", "parallel": {"data": 1},
             "backend": res["backend"], **PAR_A, "dtype": "bfloat16",
             "rounds_per_program_asked": BLOCKED_PAR_R})
        # a_hd256: part a at 4 heads of 256, then its plain loop from the
        # same initial parameters, kept on the host meanwhile; only the
        # comparison leaves the process
        del model, t
        model = par_lm(torch, seed, LM["num_layers"], "cuda", cfg=LM_HD256,
                       attn_impl="flash")
        init = {k: v.detach().cpu() for k, v in model.params.items()}
        t = ParallelTrainer(model, parallel={"data": 1}, loss=loss,
                            compute_dtype="bfloat16", **PAR_A)
        hd = res["a_hd256"] = par_train(torch, FA, F, t, df)
        hd["flops_per_token"] = flops_per_token(model)
        plain, hd["plain_loop_losses"] = par_plain_loop(
            torch, seed, df, (model.module, init))
        hd["bit_equal"] = all(torch.equal(hd["params"][k], v)
                              for k, v in plain.items())
        hd["apart"] = center_dist(hd["params"], plain, "max")
        hd["params"] = None
    else:
        rows = 2 * PAR_A["batch_size"]
        df = par_frame(rows, seed + 1)
        model = par_lm(torch, seed, PAR_LAYERS, "cuda", attn_impl="flash")
        t = ParallelTrainer(model, parallel={"data": 1, "model": 2},
                            loss=loss, compute_dtype="bfloat16", **PAR_A)
        res["b"] = par_train(torch, FA, F, t, df)
        model = par_lm(torch, seed, PAR_LAYERS, "cuda")
        t = ParallelTrainer(model, parallel={"data": 1, "pipe": 2},
                            loss=loss, **PAR_PIPE)
        res["c"] = par_train(torch, FA, F, t, df)
        model = par_lm(torch, seed, PAR_LAYERS, "cuda", seq_axis="seq",
                       attn_impl="ring")
        t = ParallelTrainer(model, parallel={"data": 1, "seq": 2},
                            loss=loss, compute_dtype="bfloat16", **PAR_A)
        res["d"] = par_train(torch, FA, F, t, df)
        model = par_lm(torch, seed, PAR_LAYERS, "cuda", attn_impl="flash",
                       remat=True)
        t = AEASGD(model, "adam", loss, parallel={"model": 2},
                   compute_dtype="bfloat16", **PAR_E)
        res["e"] = par_train(torch, FA, F, t, df)
        model = moe_build(torch, seed, 1, "cuda")
        ref = torch.load(os.path.join(out, "moe_ref.pt"), weights_only=True)
        rec = routing_recorder(model, ref)
        t = ParallelTrainer(model, parallel={"data": 1, "expert": 2},
                            loss=loss, compute_dtype="bfloat16", **PAR_MOE)
        res["f"] = par_train(torch, FA, F, t, par_moe_frame(seed))
        res["f"].update(picks_off=rec["off"], picks_off_unexplained=rec["bad"],
                        router_prob_max_abs_err=rec["max_dp"])
    torch.save(res, os.path.join(out, f"{part}-rank{r}.pt"))
    mesh.distributed_shutdown()
    return 0


def par_one(torch, FA, F, model, df, **kw) -> dict:
    """The one-process run: ``ParallelTrainer(parallel={"data": 1})`` with
    no group (or the async trainer given as ``trainer``)."""
    from distkeras_tpu_torch import ParallelTrainer

    make = kw.pop("trainer", None)
    t = (make(model) if make is not None else ParallelTrainer(
        model, loss="sparse_categorical_crossentropy", **kw))
    out = par_train(torch, FA, F, t, df)
    torch.cuda.empty_cache()
    return out


def par_references(torch, FA, F, seed: int) -> dict:
    """The one-process runs that (b) to (e) are held to, each beside its
    f32 yardstick where the part runs bf16 (the bf16 limit is
    ``BF16_PARITY_SHARE`` of the one-process bf16-vs-f32 distance, as
    ``transformer_parity`` holds the card to the CPU)."""
    from distkeras_tpu_torch import AEASGD

    df = par_frame(2 * PAR_A["batch_size"], seed + 1)
    refs = {}
    for dt in ("bfloat16", "float32"):
        refs[f"b_{dt}"] = par_one(
            torch, FA, F, par_lm(torch, seed, PAR_LAYERS, "cuda",
                                 attn_impl="flash"), df,
            parallel={"data": 1}, compute_dtype=dt, **PAR_A)
        refs[f"d_{dt}"] = par_one(
            torch, FA, F, par_lm(torch, seed, PAR_LAYERS, "cuda",
                                 seq_axis="seq", attn_impl="ring"), df,
            parallel={"data": 1}, compute_dtype=dt, **PAR_A)
        refs[f"e_{dt}"] = par_one(
            torch, FA, F, par_lm(torch, seed, PAR_LAYERS, "cuda",
                                 attn_impl="flash", remat=True), df,
            trainer=lambda m, dt=dt: AEASGD(
                m, "adam", "sparse_categorical_crossentropy",
                compute_dtype=dt, **PAR_E))
    refs["c"] = par_one(torch, FA, F, par_lm(torch, seed, PAR_LAYERS,
                                             "cuda"), df,
                        parallel={"data": 1, "pipe": 1}, **PAR_PIPE)
    refs["init"] = {k: v.detach().cpu() for k, v in par_lm(
        torch, seed, PAR_LAYERS, "cpu").params.items()}
    return refs


def par_moe_reference(torch, FA, F, seed: int, out: str) -> dict:
    """The MoE LM's one-process runs: bf16, its routing recorded and saved
    for (f) to route by, then f32 routed alike (the yardstick)."""
    runs = {}
    ref_rec = None
    for dt in ("bfloat16", "float32"):
        model = moe_build(torch, seed, 1, "cuda")
        rec = routing_recorder(model, ref_rec)
        runs[dt] = par_one(torch, FA, F, model, par_moe_frame(seed),
                           parallel={"data": 1}, compute_dtype=dt,
                           **PAR_MOE)
        if ref_rec is None:
            ref_rec = rec
            torch.save({k: ref_rec[k] for k in ("p", "idx", "gap")},
                       os.path.join(out, "moe_ref.pt"))
    runs["init"] = {k: v.detach().cpu() for k, v in
                    moe_build(torch, seed, 1, "cpu").params.items()}
    return runs


def par_plain_loop(torch, seed: int, df, start: tuple = None) -> tuple:
    """Config #6's 4 steps as a plain port loop: the model, the loss, adam
    and ``cast_floats``, on the same batches the trainer's plan gives, from
    ``start`` (a module and its initial parameters) or part a's model built
    from ``seed``. Returns the parameters on the host and the losses."""
    from torch.func import functional_call

    from distkeras_tpu_torch.data.batching import make_batches
    from distkeras_tpu_torch.ops import cast_floats
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import (apply_updates,
                                                    get_optimizer)

    if start is None:
        model = par_lm(torch, seed, LM["num_layers"], "cuda",
                       attn_impl="flash")
        start = (model.module, model.params)
    module, init = start
    module.train()
    loss_fn = get_loss("sparse_categorical_crossentropy")
    tx = get_optimizer("adam", PAR_A["learning_rate"])
    params = {k: v.detach().to("cuda", copy=True) for k, v in init.items()}
    opt = tx.init(params)
    plan = make_batches(df, "features", "label", PAR_A["batch_size"],
                        num_workers=1, window=PAR_A["steps_per_program"])
    losses = []
    for r in range(plan.num_rounds):
        xs, ys = plan.round(r)
        for k in range(xs.shape[1]):
            x = torch.as_tensor(np.ascontiguousarray(xs[0, k])).cuda()
            y = torch.as_tensor(np.ascontiguousarray(ys[0, k])).cuda()
            leaves = {n: v.detach().requires_grad_(True)
                      for n, v in params.items()}
            out = functional_call(module, cast_floats(leaves,
                                                      torch.bfloat16), (x,))
            loss = loss_fn(out.to(torch.float32), y)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            updates, opt = tx.update(grads, opt, params)
            params = apply_updates(params, updates)
            losses.append(loss.item())
    torch.cuda.synchronize()
    return {k: v.detach().cpu() for k, v in params.items()}, losses


def par_mesh_fold(torch, F, seed: int) -> dict:
    """(g): config #8's center as a ``MeshFolder`` over two devices (two
    shards on the one card) and over one, folding the same int8 commit:
    bit-equal, one ``fold_commit`` launch a device shard."""
    from distkeras_tpu_torch import small_transformer_lm
    from distkeras_tpu_torch.netps import MeshFolder, wire

    model = small_transformer_lm(**C8, seq_len=C8_SEQ, seed=seed,
                                 device="cpu")
    center = [v.detach().float().numpy().copy()
              for v in model.params.values()]
    rng = np.random.default_rng(seed + 27)
    entries = []
    for a in center:
        d = rng.normal(scale=1e-3, size=a.shape).astype(np.float32)
        entries.append(wire.codec_encode(d, "int8"))
    one = MeshFolder([a.copy() for a in center], device="cuda")
    two = MeshFolder([a.copy() for a in center],
                     devices=["cuda:0", "cuda:0"])
    F.reset_launches()
    one.fold(entries, 1.0)
    torch.cuda.synchronize()
    one_launches = F.launch_counts()["fold_commit"]
    F.reset_launches()
    t0 = time.perf_counter()
    two.fold(entries, 1.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = F.launch_counts()["fold_commit"]
    a, b = one.center_host(), two.center_host()
    split = sum(any(s) for s in two._specs)
    row = {"tensors": len(center), "tensors_split": split,
           "devices": [str(d) for d in two.devices],
           "launches": launches, "one_device_launches": one_launches,
           "bit_equal": all(x.tobytes() == y.tobytes()
                            for x, y in zip(a, b)), "seconds": seconds}
    one.close()
    two.close()
    return row


def par_speed(run: dict, steps: int) -> dict:
    """Tokens/s, ms a step, MFU against the bf16 peak and peak memory of a
    config #6 run of ``steps`` steps (``par_train``'s result)."""
    tokens_s = steps * PAR_A["batch_size"] * LM_SEQ / run["seconds"]
    return {"seconds": run["seconds"], "tokens_per_s": tokens_s,
            "ms_per_step": run["seconds"] / steps * 1e3,
            "mfu_vs_bf16_peak": run["flops_per_token"] * tokens_s
            / PEAK_BF16_FLOPS,
            "peak_memory_gb": run["peak_memory_gb"]}


def parallel_hd256(rank: dict, a: dict, gpu: str, steps: int,
                   want: dict) -> dict:
    """Part a_hd256: config #6 at 4 heads of 256 through
    ``ParallelTrainer({"data": 1})`` on the one-rank NCCL group (the nccl1
    child's ``rank`` result), against its plain loop there (bit-equal),
    each flash kernel launched once a layer a step through the bf16 entry
    points (at head dim 256 every launch runs the DP = 256 kernels), its
    speed beside part a's. A reading, not a claim: the two do the same work
    (the same parameters and attention FLOPs), but part a is its process's
    first training and a_hd256 follows it and blocked (d) in that process.
    Returns its launches and the failures found."""
    from distkeras_tpu_torch.ops.kernels import flash_attention as FA

    hd = rank["a_hd256"]
    bit_equal, apart = hd["bit_equal"], hd["apart"]
    head_dim = LM["d_model"] // LM_HD256["num_heads"]
    speed, speed_a = par_speed(hd, steps), par_speed(a, steps)
    emit({"phase": "parallel", "part": "a_hd256", "gpu": gpu,
          "config": "config #6 at 4 heads of 256 (16 heads of 64 in "
                    "bench.py)", **LM_HD256, "head_dim": head_dim,
          "kernel_tile": FA.padded_head_dim(head_dim), "seq_len": LM_SEQ,
          "attn_impl": "flash", **PAR_A, "steps": steps, "dtype": "bfloat16",
          "trainer": "ParallelTrainer(parallel={'data': 1})",
          "backend": rank["backend"], "world": rank["world"],
          "flops_per_token": hd["flops_per_token"], **speed,
          "heads_of_64": speed_a,
          "tokens_per_s_ratio_to_heads_of_64": speed["tokens_per_s"]
          / speed_a["tokens_per_s"],
          "launches": hd["launches"], "entries": hd["entries"],
          "history": hd["history"],
          "plain_loop_losses": hd["plain_loop_losses"],
          "params_bit_equal_to_plain_loop": bit_equal,
          "params_max_abs_err_vs_plain_loop": apart,
          "reading": "the same work as part a; part a is the first training "
                     "of the nccl1 process, a_hd256 runs after it and "
                     "blocked (d) there; a reading, not a claim"})
    failures = []
    if hd["launches"] != {**hd["launches"], **want} or sorted(
            hd["entries"]) != sorted(f"{k}_bf16" for k in want):
        failures.append(f"a_hd256 launched {hd['entries']}, want {want} "
                        f"bf16")
    if not bit_equal:
        failures.append(f"a_hd256 is {apart} from the plain loop, not "
                        f"bit-equal")
    if not all(np.isfinite(hd["history"])):
        failures.append(f"a_hd256's losses are not finite: {hd['history']}")
    return {"launches": hd["launches"], "failures": failures}


def parallel_phase(torch, FA, F, gpu: str, seed: int) -> dict:
    """``parallel``: the model-parallel engines through the entry points a
    user calls, each part's ranks launched by the port's ``Job`` on this
    host (``python chip_smoke.py --parallel-child``); the one-process
    runs they are held to run here, each alone on the card (before the
    gloo ranks start), so that every part's seconds are uncontended.
    No run spans two cards: the machine has one. Returns the launch
    counts by part."""
    from distkeras_tpu_torch.job_deployment import Job, Punchcard

    if TP_FLASH_SHAPE not in FLASH_SHAPES or TP_FLASH_SHAPE != (
            PAR_A["batch_size"], LM_SEQ, LM["num_heads"] // 2,
            LM["d_model"] // LM["num_heads"]) or PAR_E["batch_size"] != \
            PAR_A["batch_size"]:
        fail("parallel: the flash kernels are not held against their twins "
             "at one rank's heads under tensor parallelism (FLASH_SHAPES)")
    if HD256_FLASH_SHAPE not in FLASH_SHAPES or HD256_FLASH_SHAPE != (
            PAR_A["batch_size"], LM_SEQ, LM_HD256["num_heads"],
            LM["d_model"] // LM_HD256["num_heads"]):
        fail("parallel: the flash kernels are not held against their twins "
             "at config #6's heads of 256 (FLASH_SHAPES)")

    out = os.path.join("build", "parallel")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    jobs = {}

    def launch(part):
        n = PAR_PARTS[part]
        card = Punchcard(job_name=f"chip-smoke-parallel-{part}",
                         script="chip_smoke.py", hosts=["localhost"] * n,
                         args=["--parallel-child", part, out, str(seed)])
        job = Job(card, python=sys.executable)
        jobs[part] = (job, time.perf_counter(), job.launch(dry_run=False))

    def wait(part):
        job, t0, cmds = jobs[part]
        rcs = job.supervise(timeout=PAR_TIMEOUT_S)
        if rcs != [0] * PAR_PARTS[part]:
            fail(f"parallel {part}: the ranks exited {rcs}")
        return ([torch.load(os.path.join(out, f"{part}-rank{r}.pt"),
                            weights_only=False)
                 for r in range(PAR_PARTS[part])],
                time.perf_counter() - t0, cmds[0])

    failures = []
    # (a) config #6 at full size, one NCCL rank, alone on the card; then,
    # each alone on the card in this process, the plain loop (a) is held
    # to, (f)'s routing reference and the one-process references; then
    # (b) to (f) on two gloo ranks
    launch("nccl1")
    ranks, job_s, cmd = wait("nccl1")
    a = ranks[0]["a"]
    blocked_d = dict(ranks[0]["blocked_d"], gpu=gpu)
    steps_d = PAR_A_ROUNDS * PAR_A["steps_per_program"]
    for name in ("fwd", "dq", "dkv"):
        got = blocked_d["launches"]["per_round"].get(
            f"flash_attention.flash_{name}")
        want_d = LM["num_layers"] * steps_d
        if got != want_d:
            blocked_d["problems"].append(f"flash_{name} launched {got} "
                                         f"times, want {want_d}")
    emit(blocked_d)
    if blocked_d["problems"]:
        fail(f"blocked: (d) {blocked_d['problems']}")
    df = par_frame(PAR_A_ROUNDS * 2 * PAR_A["batch_size"], seed)
    plain, plain_losses = par_plain_loop(torch, seed, df)
    torch.cuda.empty_cache()
    bit_equal = all(torch.equal(a["params"][k], v) for k, v in plain.items())
    apart = center_dist(a["params"], plain, "max")
    steps = PAR_A_ROUNDS * PAR_A["steps_per_program"]
    tokens_s = steps * PAR_A["batch_size"] * LM_SEQ / a["seconds"]
    mfu = a["flops_per_token"] * tokens_s / PEAK_BF16_FLOPS
    want = {"flash_fwd": LM["num_layers"] * steps,
            "flash_dq": LM["num_layers"] * steps,
            "flash_dkv": LM["num_layers"] * steps}
    emit({"phase": "parallel", "part": "a", "gpu": gpu,
          "config": "config #6 (bench.py transformer_lm_flash) at full size",
          **LM, "seq_len": LM_SEQ, "attn_impl": "flash", **PAR_A,
          "rounds": PAR_A_ROUNDS, "steps": steps, "dtype": "bfloat16",
          "trainer": "ParallelTrainer(parallel={'data': 1})",
          "strategy": a["strategy"], "backend": ranks[0]["backend"],
          "world": ranks[0]["world"], "seconds": a["seconds"],
          "job_seconds": job_s, "tokens_per_s": tokens_s,
          "flops_per_token": a["flops_per_token"],
          "mfu_vs_bf16_peak": mfu, "peak_flops": PEAK_BF16_FLOPS,
          "launches": a["launches"], "entries": a["entries"],
          "history": a["history"], "plain_loop_losses": plain_losses,
          "params_bit_equal_to_plain_loop": bit_equal,
          "params_max_abs_err_vs_plain_loop": apart,
          "host_staged": a["host_staged"], "command": cmd})
    if ranks[0]["backend"] != "nccl" or ranks[0]["world"] != 1:
        failures.append(f"a ran on {ranks[0]['backend']} over "
                        f"{ranks[0]['world']} ranks")
    if a["launches"] != {**a["launches"], **want} or not all(
            k.endswith("_bf16") for k in a["entries"]):
        failures.append(f"a launched {a['entries']}, want {want} bf16")
    if not bit_equal:
        failures.append(f"a is {apart} from the plain loop, not bit-equal")
    hd256 = parallel_hd256(ranks[0], a, gpu, steps, want)
    failures += hd256.pop("failures")
    moe = par_moe_reference(torch, FA, F, seed, out)
    refs = par_references(torch, FA, F, seed)
    launch("gloo2")
    ranks, job_s, cmd = wait("gloo2")
    if [x["backend"] for x in ranks] != ["gloo"] * 2:
        failures.append(f"gloo2 ran on {[x['backend'] for x in ranks]}")
    launches = {"a": a["launches"]}

    def bf16_limit(part, got, one, f32, init, extra):
        d = center_dist(got, one, "mean")
        design = center_dist(one, f32, "mean")
        change = center_dist(one, init, "max")
        row = {"phase": "parallel", "part": part, "gpu": gpu,
               "ranks": 2, "backend": "gloo",
               "params_mean_abs_err_vs_one_process": d,
               "params_max_abs_err_vs_one_process": center_dist(got, one,
                                                                 "max"),
               "one_process_bf16_vs_f32_mean": design,
               "limit": BF16_PARITY_SHARE * design,
               "limit_rule": f"{BF16_PARITY_SHARE} x the one-process "
                             "bf16-vs-f32 mean distance "
                             "(transformer_parity's bf16 share)",
               "max_abs_change": change, **extra}
        emit(row)
        if not (0 < design and d <= BF16_PARITY_SHARE * design):
            failures.append(f"{part}: {d} from the one-process run, limit "
                            f"{BF16_PARITY_SHARE} x {design}")

    def replicated_equal(part, names):
        p0, p1 = ranks[0][part]["params"], ranks[1][part]["params"]
        return all(torch.equal(p0[k], p1[k]) for k in names)

    def ranks_equal(part):
        """Rank 1's gathered parameters bit-equal to rank 0's (which are
        held to the one-process run): every rank assembled the same whole
        tensors, and its replicated copies stayed in step."""
        p0, p1 = ranks[0][part]["params"], ranks[1][part]["params"]
        same = list(p0) == list(p1) and replicated_equal(part, list(p0))
        if not same:
            failures.append(f"{part}: rank 1's gathered parameters differ "
                            "from rank 0's")
        return same

    def common(part, x):
        return {"seconds": [r[part]["seconds"] for r in ranks],
                "launches": [r[part]["launches"] for r in ranks],
                "entries": [r[part]["entries"] for r in ranks],
                "history": x["history"],
                "host_staged": [r[part]["host_staged"] for r in ranks],
                "job_seconds": job_s}

    per_rank = {k: PAR_LAYERS * 2 for k in ("flash_fwd", "flash_dq",
                                            "flash_dkv")}
    rep_names = [k for k in refs["b_float32"]["params"]
                 if "ln_" in k or k.endswith("out.bias")
                 or k.endswith("mlp_down.bias")]
    b = ranks[0]["b"]
    bf16_limit("b", b["params"], refs["b_bfloat16"]["params"],
               refs["b_float32"]["params"], refs["init"], {
                   "grid": {"data": 1, "model": 2}, "layers": PAR_LAYERS,
                   "heads_per_rank": LM["num_heads"] // 2,
                   "replicated_bit_equal_across_ranks":
                       replicated_equal("b", rep_names),
                   "gathered_bit_equal_across_ranks": ranks_equal("b"),
                   "tokens_per_s": 2 * PAR_A["batch_size"] * LM_SEQ
                   / max(r["b"]["seconds"] for r in ranks),
                   **common("b", b)})
    for r in ranks:
        if {**r["b"]["launches"], **per_rank} != r["b"]["launches"] or \
                not all(k.endswith("_bf16") for k in r["b"]["entries"]):
            failures.append(f"b: rank {r['rank']} launched "
                            f"{r['b']['entries']}, want {per_rank} bf16")
    c = ranks[0]["c"]
    c_err = center_dist(c["params"], refs["c"]["params"], "max")
    emit({"phase": "parallel", "part": "c", "gpu": gpu, "ranks": 2,
          "grid": {"data": 1, "pipe": 2}, "layers": PAR_LAYERS,
          "dtype": "float32", "attn_impl": "dense (the engine's stages)",
          **PAR_PIPE, "params_max_abs_err_vs_one_process": c_err,
          "limit": PAR_PIPE_ATOL,
          "max_abs_change": center_dist(refs["c"]["params"], refs["init"],
                                        "max"),
          "gathered_bit_equal_across_ranks": ranks_equal("c"),
          **common("c", c)})
    if not c_err <= PAR_PIPE_ATOL:
        failures.append(f"c: {c_err} from the one-process run, limit "
                        f"{PAR_PIPE_ATOL}")
    if any(sum(r["c"]["launches"].values()) for r in ranks):
        failures.append("c: a flash kernel launched under dense stages")
    d = ranks[0]["d"]
    bf16_limit("d", d["params"], refs["d_bfloat16"]["params"],
               refs["d_float32"]["params"], refs["init"], {
                   "grid": {"data": 1, "seq": 2}, "attn_impl": "ring",
                   "seq_len": LM_SEQ, "seq_per_rank": LM_SEQ // 2,
                   "gathered_bit_equal_across_ranks": ranks_equal("d"),
                   **common("d", d)})
    e = ranks[0]["e"]
    remat = {"flash_fwd": 2 * PAR_LAYERS * 2, "flash_dq": PAR_LAYERS * 2,
             "flash_dkv": PAR_LAYERS * 2}
    bf16_limit("e", e["params"], refs["e_bfloat16"]["params"],
               refs["e_float32"]["params"], refs["init"], {
                   "trainer": "AEASGD(parallel={'model': 2})",
                   "model": "config #7 (flash, remat) cut to 2 layers",
                   **PAR_E, "want_launches_per_rank": remat,
                   "gathered_bit_equal_across_ranks": ranks_equal("e"),
                   **common("e", e)})
    for r in ranks:
        if {**r["e"]["launches"], **remat} != r["e"]["launches"]:
            failures.append(f"e: rank {r['rank']} launched "
                            f"{r['e']['launches']}, want {remat} under remat")
    f = ranks[0]["f"]
    moe_flash = {k: MOE["num_layers"] * 2 for k in per_rank}
    bf16_limit("f", f["params"], moe["bfloat16"]["params"],
               moe["float32"]["params"], moe["init"], {
                   "model": "moe_train's MoETransformerLM (K=1, flash)",
                   "grid": {"data": 1, "expert": 2},
                   "experts_per_rank": MOE["num_experts"] // 2, **PAR_MOE,
                   "routing": "every run routed as the one-process bf16 "
                              "run (routing_recorder)",
                   "picks_off": [r["f"]["picks_off"] for r in ranks],
                   "picks_off_unexplained": [r["f"]["picks_off_unexplained"]
                                             for r in ranks],
                   "router_prob_max_abs_err": [
                       r["f"]["router_prob_max_abs_err"] for r in ranks],
                   "replicated_bit_equal_across_ranks": replicated_equal(
                       "f", [k for k in f["params"] if "experts" not in k]),
                   "gathered_bit_equal_across_ranks": ranks_equal("f"),
                   **common("f", f)})
    for r in ranks:
        if {**r["f"]["launches"], **moe_flash} != r["f"]["launches"]:
            failures.append(f"f: rank {r['rank']} launched "
                            f"{r['f']['launches']}, want {moe_flash}")
        if r["f"]["picks_off_unexplained"]:
            failures.append(f"f: rank {r['rank']} routed "
                            f"{r['f']['picks_off_unexplained']} tokens off "
                            "the reference beyond the probability change")
    g = par_mesh_fold(torch, F, seed)
    emit({"phase": "parallel", "part": "g", "gpu": gpu,
          "config": "config #8's center (TransformerLM C8) as a "
                    "MeshFolder over two devices, one int8 commit", **g})
    if not g["bit_equal"] or g["launches"] != 2 or g["one_device_launches"] \
            != 1:
        failures.append(f"g: {g}")
    for part in "bcdef":
        launches[part] = [r[part]["launches"] for r in ranks]
    launches["g"] = g["launches"]
    launches["a_hd256"] = hd256["launches"]
    launches["blocked_d"] = blocked_d
    shutil.rmtree(out, ignore_errors=True)
    if failures:
        fail("parallel: " + "; ".join(failures))
    return launches


#: ``analysis``: the interleave suite's counts on the CPU (the JAX
#: package's, scenario by scenario; ``tests/test_torch_interleave.py``),
#: which the card's run must equal: (complete, crash points, transitions)
INTERLEAVE_COUNTS = {"dedup": (924, 0, 11088), "fence": (11550, 0, 127050),
                     "journal": (924, 2506, 35180),
                     "tree_flush": (630, 0, 4410)}
#: the scenarios in the order the card runs them, cheapest first; a
#: scenario starts only if the suite's seconds so far plus its own, at the
#: rate a transition the suite has shown, stay within the budget (the cut
#: is a whole scenario, never part of one)
INTERLEAVE_ORDER = ("dedup", "tree_flush", "journal", "fence")
INTERLEAVE_BUDGET_S = 120.0
#: the witness run: racing clients x int8 commits each, config #4's center
WITNESS_CLIENTS, WITNESS_COMMITS = 4, 5


def witness_oracle(center: list, deltas: dict, commit_log) -> list:
    """The numpy oracle of the witness run: each client's int8 wire items
    as its error-feedback encoder makes them (``netps/client.py
    _compress_delta``: the residual added, encoded, carried), folded at
    ADAG's scale 1 (``fold_compressed_numpy``) in the server's fold order,
    ``commit_log``'s."""
    from distkeras_tpu_torch.netps import wire
    from distkeras_tpu_torch.netps.fold import fold_compressed_numpy

    sent = {}
    for wid, seq_deltas in deltas.items():
        residual = [np.zeros_like(a) for a in center]
        for k, delta in enumerate(seq_deltas):
            items = []
            for i, d in enumerate(delta):
                d = d + residual[i]
                q, spec = wire.codec_encode(d, "int8")
                residual[i] = d - wire.codec_decode(q, spec)
                items.append((q, spec))
            sent[(wid, k)] = items
    out = [a.copy() for a in center]
    seqs = {}
    for wid, seq, _staleness in commit_log:
        seqs.setdefault(wid, []).append(seq)
    rank = {(wid, s): k for wid, ss in seqs.items()
            for k, s in enumerate(sorted(ss))}
    for wid, seq, _staleness in commit_log:
        for o, (q, spec) in zip(out, sent[(wid, rank[(wid, seq)])]):
            fold_compressed_numpy(o, q, spec, 1.0)
    return out


def interleave_child(out: str) -> int:
    """The ``analysis`` phase's interleave suite (``--interleave-child
    OUT``), in a process of its own: every scenario with its servers'
    centers on the card, in ``INTERLEAVE_ORDER``, within
    ``INTERLEAVE_BUDGET_S``; the fold's launch counts set to 0 just before
    and read just after. Writes its counts, seconds and launches to ``OUT``
    as JSON. It prints nothing."""
    import torch

    from distkeras_tpu_torch.analysis import interleave
    from distkeras_tpu_torch.ops.kernels import fold as F

    suite, ran, cut = {}, [], []
    torch.cuda.synchronize()
    F.reset_launches()  # counts start at 0 just before the suite runs
    t0 = time.perf_counter()
    done = 0  # transitions run so far
    for name in INTERLEAVE_ORDER:
        spent = time.perf_counter() - t0
        if done and spent + spent / done * INTERLEAVE_COUNTS[name][2] > \
                INTERLEAVE_BUDGET_S:
            cut.append(name)
            continue
        t1 = time.perf_counter()
        r, = interleave.run_suite([name], device="cuda")
        suite[name] = {"complete": r.complete, "crashed": r.crashed,
                       "transitions": r.transitions,
                       "violations": len(r.violations),
                       "first_violations": [repr(v) for v in
                                            r.violations[:3]],
                       "seconds": time.perf_counter() - t1}
        ran.append(name)
        done += r.transitions
    torch.cuda.synchronize()
    with open(out, "w") as f:
        json.dump({"scenarios": suite, "ran_on_card": ran, "cut": cut,
                   "seconds": time.perf_counter() - t0,
                   "fold_launches": F.launch_counts()}, f)
    return 0


def analysis_phase(torch, F, gpu: str, seed: int) -> dict:
    """``analysis``: (a) the port's dk-check CLI over the port and (b) the
    interleave suite (:func:`interleave_child`) each in a process of its
    own (no JAX on this machine), both while (c) runs here. (a) must find
    nothing; (b) runs every server's center on the card, scenario by
    scenario within ``INTERLEAVE_BUDGET_S``, each at the CPU's counts with
    no violation; (c) the lock-order witness over a ``PSServer`` on the
    card with ``WITNESS_CLIENTS`` racing ``PSClient``s committing
    ``WITNESS_COMMITS`` int8 deltas each: no inversion, the witnessed
    server edges within the port's static lock graph, one fold launch a
    commit, the center bit-equal to the numpy oracle. Returns the fold
    launches of (b) and (c)."""
    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch.analysis import core, witness
    from distkeras_tpu_torch.analysis.rules_concurrency import (
        _find_cycles, build_lock_graph)
    from distkeras_tpu_torch.netps import PSClient, PSServer

    t_phase = time.perf_counter()
    failures = []
    here = os.path.dirname(os.path.abspath(__file__))
    suite_out = os.path.join(here, "build", "analysis_interleave.json")
    os.makedirs(os.path.dirname(suite_out), exist_ok=True)
    if os.path.exists(suite_out):
        os.remove(suite_out)
    cli = subprocess.Popen(
        [sys.executable, "-m", "distkeras_tpu_torch.analysis", "--format",
         "json"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=here)
    suite_proc = subprocess.Popen(
        [sys.executable, os.path.join(here, "chip_smoke.py"),
         "--interleave-child", suite_out], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=here)
    try:
        # (c) the witness over a server on the card
        params = imdb_lstm(vocab_size=VOCAB, embed_dim=EMBED,
                           hidden_size=HIDDEN, seq_len=SEQ_LEN, seed=seed,
                           device="cpu").params
        center = [v.detach().float().numpy().copy() for v in params.values()]
        rng = np.random.default_rng(seed + 29)
        deltas = {w: [[rng.normal(scale=1e-3, size=a.shape).astype(
            np.float32) for a in center] for _ in range(WITNESS_COMMITS)]
            for w in range(WITNESS_CLIENTS)}
        modules, errs = core.parse_modules([os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "distkeras_tpu_torch")])
        static_edges, _, _ = build_lock_graph(modules)
        errors: list = []
        with witness() as w:
            srv = PSServer(center=[a.copy() for a in center],
                           discipline="adag", lease_s=60.0,
                           device="cuda").start()
            try:
                clients = [PSClient(srv.endpoint, worker_id=i,
                                    compress="int8", transport="tcp")
                           for i in range(WITNESS_CLIENTS)]
                counters = [c.join()[1] for c in clients]
                barrier = threading.Barrier(WITNESS_CLIENTS + 1)

                def work(i):
                    try:
                        barrier.wait()
                        upd = counters[i]
                        for delta in deltas[i]:
                            clients[i].commit(delta, upd)
                            _center, upd = clients[i].pull()
                    except Exception as e:  # surfaced below
                        errors.append(e)
                        barrier.abort()

                threads = [threading.Thread(target=work, args=(i,),
                                            name=f"witness-{i}")
                           for i in range(WITNESS_CLIENTS)]
                for t in threads:
                    t.start()
                torch.cuda.synchronize()
                F.reset_launches()  # counts start at 0 just before the folds
                t1 = time.perf_counter()
                try:
                    barrier.wait()
                except threading.BrokenBarrierError:
                    pass
                for t in threads:
                    t.join()
                torch.cuda.synchronize()
                witness_s = time.perf_counter() - t1
                witness_launches = F.launch_counts()
                got = [np.asarray(a) for a in srv.center()]
                log = list(srv.commit_log)
                for c in clients:
                    c.leave()
                    c.close()
            finally:
                srv.close()
        if errors:
            fail(f"analysis: witness client: {errors[0]!r}")
        commits = WITNESS_CLIENTS * WITNESS_COMMITS
        edges = w.edges()
        server_edges = {e for e in edges if "server.PSServer" in e[0]
                        or "server.PSServer" in e[1]}
        oracle = witness_oracle(center, deltas, log)
        bit_equal = same_bits(got, oracle)
        row = {"phase": "analysis_witness", "gpu": gpu, "device": "cuda",
               "clients": WITNESS_CLIENTS, "commits_each": WITNESS_COMMITS,
               "codec": "int8", "discipline": "adag",
               "center": f"config #4 imdb_lstm, {len(center)} tensors, "
                         f"{sum(a.size for a in center)} parameters",
               "folds": len(log), "fold_launches": witness_launches,
               "inversions": w.cycles(), "witnessed_edges": len(edges),
               "server_edges": sorted(server_edges),
               "static_edges": len(static_edges),
               "static_cycles": _find_cycles(static_edges),
               "server_edges_within_static": server_edges <= static_edges,
               "bit_equal_to_numpy_oracle": bit_equal,
               "seconds": witness_s}
        emit(row)
        if row["inversions"] or row["static_cycles"]:
            failures.append(f"witness: lock-order cycle {row['inversions']} "
                            f"{row['static_cycles']}")
        if not row["server_edges_within_static"]:
            failures.append(f"witness: server edges {server_edges} outside "
                            "the static graph")
        if len(log) != commits or witness_launches.get("fold_commit") != \
                commits or any(v for k, v in witness_launches.items()
                               if k != "fold_commit"):
            failures.append(f"witness: {len(log)} folds, launches "
                            f"{witness_launches} for {commits} commits")
        if not bit_equal:
            failures.append("witness: the center is not the numpy oracle's")
    finally:
        done = {}
        for name, proc in (("cli", cli), ("suite", suite_proc)):
            try:
                done[name] = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                done[name] = proc.communicate()
    # (b) the interleave suite, centers on the card
    suite_err = done["suite"][1]
    if suite_proc.returncode != 0 or not os.path.exists(suite_out):
        fail(f"analysis: the interleave child exited "
             f"{suite_proc.returncode}: {suite_err[-2000:]}")
    with open(suite_out) as f:
        res = json.load(f)
    suite, ran, cut = res["scenarios"], res["ran_on_card"], res["cut"]
    suite_s, suite_launches = res["seconds"], res["fold_launches"]
    for name, sc in suite.items():
        if (sc["complete"], sc["crashed"], sc["transitions"]) != \
                INTERLEAVE_COUNTS[name]:
            failures.append(f"interleave {name}: {sc} is not the CPU's "
                            f"{INTERLEAVE_COUNTS[name]}")
        if sc["violations"]:
            failures.append(f"interleave {name}: {sc['first_violations']}")
    emit({"phase": "analysis_interleave", "gpu": gpu, "device": "cuda",
          "scenarios": suite, "ran_on_card": ran, "cut": cut,
          "budget_s": INTERLEAVE_BUDGET_S, "seconds": suite_s,
          "schedules": sum(v["complete"] + v["crashed"]
                           for v in suite.values()),
          "fold_launches": suite_launches})
    out, err = done["cli"]
    # (a) the port's dk-check over the port
    try:
        found = json.loads(out)
    except ValueError:
        found = None
    emit({"phase": "analysis_dkcheck", "gpu": gpu, "exit": cli.returncode,
          "findings": None if found is None else found["count"],
          "first": None if found is None else found["findings"][:5],
          "stderr_tail": err[-400:] if cli.returncode else ""})
    if cli.returncode != 0 or found is None or found["count"]:
        failures.append(f"dk-check: exit {cli.returncode}, "
                        f"{None if found is None else found['count']} "
                        "finding(s)")
    print(card_line(), flush=True)
    emit({"phase": "analysis", "gpu": gpu,
          "seconds": time.perf_counter() - t_phase,
          "interleave_seconds": suite_s, "interleave_ran_on_card": ran,
          "interleave_cut": cut})
    if failures:
        fail("analysis: " + "; ".join(failures))
    return {"interleave": suite_launches.get("fold_commit", 0),
            "witness": witness_launches.get("fold_commit", 0),
            "witness_commits": commits}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks-child", nargs=3, metavar=("PART", "OUT", "SEED"),
                    help="run one rank of the ranks phase (what the phase's "
                         "Job launches; not for direct use)")
    ap.add_argument("--parallel-child", nargs=3,
                    metavar=("PART", "OUT", "SEED"),
                    help="run one rank of the parallel phase (what the "
                         "phase's Job launches; not for direct use)")
    ap.add_argument("--interleave-child", metavar="OUT",
                    help="run the analysis phase's interleave suite on the "
                         "card (what the phase starts; not for direct use)")
    ap.add_argument("--blocked-only", action="store_true",
                    help="build the LSTM and GroupNorm kernels, run the "
                         "blocked phase's parts (a), (b), (c) and (e) alone "
                         "and stop (no kernels line, no ok line)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="build the flash and fold kernels, run the "
                         "parallel phase alone and stop (no kernels line, "
                         "no ok line)")
    ap.add_argument("--analysis-only", action="store_true",
                    help="build the fold kernel, run the analysis phase "
                         "alone and stop (no kernels line, no ok line)")
    args = ap.parse_args()
    if args.ranks_child:
        sys.exit(ranks_child(*args.ranks_child))
    if args.parallel_child:
        sys.exit(parallel_child(*args.parallel_child))
    if args.interleave_child:
        sys.exit(interleave_child(args.interleave_child))
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    try:
        from distkeras_tpu_torch.data import native_loader
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
    if args.blocked_only:
        build.build(["lstm_fwd", "lstm_bwd", "groupnorm"])
        blocked_phase(torch, gpu, args.seed)
        emit({"phase": "seconds", "from_build": time.perf_counter() - t0})
        print(card_line(), flush=True)
        return
    if args.analysis_only:
        build.build(["fold"])
        launches = analysis_phase(torch, F, gpu, args.seed)
        emit({"phase": "seconds", "from_build": time.perf_counter() - t0,
              "analysis_launches": launches})
        print(card_line(), flush=True)
        return
    if args.parallel_only:
        build.build(["fold", "flash_attn"])
        launches = parallel_phase(torch, FA, F, gpu, args.seed)
        emit({"phase": "seconds", "from_build": time.perf_counter() - t0,
              "parallel_launches": launches})
        print(card_line(), flush=True)
        return
    libs = build.build(["lstm_fwd", "lstm_bwd", "groupnorm", "fold",
                        "flash_attn"])
    ptxas = {k: [ln.strip() for ln in v.with_suffix(".log").read_text()
                 .splitlines() if "Used" in ln or "spill" in ln]
             for k, v in libs.items() if v.with_suffix(".log").exists()}
    cuda_s = time.perf_counter() - t0
    # The native data-plane loop (host C++, g++: nvcc's host compiler),
    # built from the checkout before any phase gathers a round.
    cxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, timeout=60)
    t1 = time.perf_counter()
    native_lib = native_loader.build()
    native_loader.get_lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "cuda_seconds": cuda_s,
          "per_source_s": dict(build.BUILD_SECONDS),
          "libraries": {k: str(v) for k, v in libs.items()},
          "ptxas": ptxas,
          "native_loader": {"library": str(native_lib),
                            "seconds": time.perf_counter() - t1,
                            "compiler": cxx.stdout.splitlines()[0],
                            "threads": native_loader.num_threads()}})
    flash_log = libs["flash_attn"].with_suffix(".log")
    flash_regs = flash_registers(flash_log.read_text()
                                 if flash_log.exists() else "")
    emit({"phase": "flash_build", "kernels": flash_regs})
    if flash_log.exists() and len(flash_regs) != FLASH_KERNELS:
        fail(f"expected {FLASH_KERNELS} flash kernel instantiations in the "
             f"build report, found {len(flash_regs)}")
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
    # config #4's center without a group, for the ranks phase's check
    train_center = {k: v.detach().cpu().clone()
                    for k, v in trained.params.items()}
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
    serve_launches, serve_drill_launches = serve_phase(
        torch, K, trained, cpu_model, rng, gpu)
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
    lap("sharded_feed")
    workdir = os.path.join("build", "sharded_feed")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    feed_launches = sharded_feed_phase(torch, G, gpu, args.seed, workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()

    lap("fold")
    fold_rows = fold_kernel_phase(torch, F, args.seed)
    remote_runs = {codec: remote_train_phase(torch, K, F, gpu, args.seed,
                                             codec)
                   for codec in ("int8", "bf16")}
    fold_launches = {codec: r["fold_commit"]
                     for codec, r in remote_runs.items()}
    remote_parity_phase(torch, args.seed)
    torch.cuda.empty_cache()

    lap("flash")
    flash_rows = flash_kernel_phase(torch, FA, args.seed)
    flash_launches = transformer_train_phase(torch, FA, gpu, args.seed)
    torch.cuda.empty_cache()
    bf16_flash_launches = transformer_train_phase(torch, FA, gpu, args.seed,
                                                  "bfloat16")
    transformer_parity_phase(torch, args.seed)
    transformer_parity_phase(torch, args.seed, LM_PARITY_HD256,
                             "transformer_parity_hd256",
                             LM_PARITY_HD256_LOGITS_SHARE, f64_beside=True)
    torch.cuda.empty_cache()

    lap("moe_train")
    moe_launches = {f"{dtype}_k{K}": moe_train_phase(torch, FA, gpu,
                                                     args.seed, dtype, K)
                    for dtype in DTYPES for K in (1, 2)}
    torch.cuda.empty_cache()
    lap("bn_carry")
    workdir = os.path.join("build", "bn_carry")
    os.makedirs(workdir, exist_ok=True)
    bn_carry_phase(torch, gpu, args.seed, workdir)
    shutil.rmtree(workdir, ignore_errors=True)
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
    torch.cuda.empty_cache()

    lap("ensemble_train")
    from distkeras_tpu_torch.datasets import imdb

    lstm_frame = imdb(n=RESILIENCE_ROWS, vocab_size=VOCAB, seq_len=SEQ_LEN,
                      seed=args.seed + 7)
    ensemble_launches = ensemble_phase(torch, K, gpu, args.seed, lstm_frame)
    torch.cuda.empty_cache()
    lap("fault_drills")
    workdir = os.path.join("build", "fault_drills")
    os.makedirs(workdir, exist_ok=True)
    drill_launches = fault_drills_phase(torch, K, gpu, args.seed, frames,
                                        lstm_frame, workdir)
    shutil.rmtree(workdir, ignore_errors=True)
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

    lap("netps_chaos")
    chaos_launches = netps_chaos_phase(torch, K, F, gpu, args.seed,
                                       lstm_frame)
    torch.cuda.empty_cache()

    # The drill's two CLI shard servers start while config #8 runs.
    shard_cli = cli_shards("build")
    try:
        lap("netps_config8")
        config8 = netps_config8_phase(torch, F, FA, gpu, args.seed)
        torch.cuda.empty_cache()
        lap("netps_sharded")
        c8ctx = config8.pop("ctx")
        sharded = netps_sharded_phase(torch, K, F, FA, gpu, args.seed,
                                      c8ctx, lstm_frame)
        torch.cuda.empty_cache()
        lap("sharded_center")
        c10_launches = sharded_center_phase(torch, F, gpu)
        torch.cuda.empty_cache()
        lap("shard_crash")
        crash = shard_crash_phase(torch, K, F, gpu, args.seed, shard_cli,
                                  lstm_frame)
    finally:
        for sh in shard_cli["shards"]:
            stop_cli(sh["lives"])
    torch.cuda.empty_cache()
    lap("netps_tree")
    tree = netps_tree_phase(torch, K, F, gpu, args.seed, c8ctx["init"],
                            lstm_frame)
    del lstm_frame, c8ctx
    torch.cuda.empty_cache()
    lap("observability")
    obs = observability_phase(torch, K, F, gpu, args.seed,
                              remote_runs["int8"]["samples_per_s"])
    torch.cuda.empty_cache()
    lap("elastic_parity")
    elastic = elastic_parity_phase(torch, K, F, gpu, args.seed)
    torch.cuda.empty_cache()
    lap("fleet_card")
    fleet = fleet_card_phase(torch, K, F, gpu, args.seed,
                             remote_runs["int8"]["samples_per_s"])
    torch.cuda.empty_cache()
    lap("sim")
    sim_phase(gpu)
    lap("streaming_config11")
    workdir = os.path.join("build", "streaming")
    shutil.rmtree(workdir, ignore_errors=True)
    # the durable CLI server of streaming_kill starts while config #11 runs
    kill_srv = stream_kill_server(os.path.join(workdir, "kill"))
    try:
        config11 = streaming_config11_phase(torch, K, F, gpu, args.seed,
                                            os.path.join(workdir, "c11"))
        torch.cuda.empty_cache()
        lap("streaming_kill")
        kill = streaming_kill_phase(torch, gpu, args.seed, kill_srv)
    finally:
        if kill_srv["proc"].poll() is None:
            kill_srv["proc"].kill()
            kill_srv["proc"].wait()
    shutil.rmtree(workdir, ignore_errors=True)
    lap("stream_engine")
    engine = stream_engine_phase(torch, K, G, gpu, args.seed)
    lap("raced")
    raced = raced_phase(torch, K, F, gpu, args.seed)
    torch.cuda.empty_cache()
    lap("ranks")
    ranks = ranks_phase(torch, gpu, args.seed, train_center,
                        TRAIN_SAMPLES_PER_S["float32"])
    torch.cuda.empty_cache()
    lap("parallel")
    parallel = parallel_phase(torch, FA, F, gpu, args.seed)
    torch.cuda.empty_cache()
    lap("blocked")
    blocked = blocked_phase(torch, gpu, args.seed)
    torch.cuda.empty_cache()
    lap("analysis")
    analysis = analysis_phase(torch, F, gpu, args.seed)

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
                "bf16_step_bound_ms": step_sum(bf16, f"{pre}bound_ms"),
                # config #5 fed from the uint8 shard store, each arm
                # counted from 0 just before its run and read just after
                "sharded_feed_bf16_launches": {
                    arm: c[name] for arm, c in feed_launches.items()}}

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
    kernels = [
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
    ]
    # The resilience plane's paths, each counted from 0 just
    # before its run and read just after.
    kernels[0]["serve_drill_launches"] = serve_drill_launches
    for k in (kernels[1], kernels[2]):
        k["ensemble_launches"] = {
            trainer: {dtype: c[k["name"]] for dtype, c in runs.items()}
            for trainer, runs in ensemble_launches.items()}
        k["fault_drill_launches"] = {drill: c[k["name"]]
                                     for drill, c in drill_launches.items()}
    kernels[5]["chaos_launches"] = chaos_launches
    kernels[5]["mesh_down_drill_launches"] = config8["drill_fold_launches"]
    # The striping and sharded-center paths, each counted from 0 just
    # before its run and read just after: one launch a striped logical
    # commit, one a shard a sharded commit, one a replayed record.
    kernels[5]["striped_launches"] = config8["striped_fold_launches"]
    kernels[5]["striped_commits"] = config8["striped_commits"]
    kernels[5]["sharded_launches"] = {
        "config8_2_shards": sharded["config8"],
        "config8_commits": sharded["config8_commits"],
        "config4_2_shards": sharded["config4"],
        "config4_commits": sharded["config4_commits"]}
    kernels[5]["sharded_center_launches"] = c10_launches
    kernels[5]["shard_crash_replay_launches"] = crash["replay"]
    # The aggregation plane, each path counted from 0 just before its run
    # and read just after: one launch an absorbed commit (the aggregator's
    # pre-combine at scale 1) and one a commit the root folds.
    kernels[5]["hier_launches"] = config8["hier_launches"]
    kernels[5]["hier_absorbed"] = config8["hier_absorbed"]
    kernels[5]["hier_root_commits"] = config8["hier_root_commits"]
    kernels[5]["tree_launches"] = tree["partition"] + tree["failover"]
    kernels[5]["tree_path_launches"] = {
        k: tree[k] for k in ("precombine", "trainer", "partition",
                             "failover", "probe_link")}
    # The self-tuning plane, each path counted from 0 just before its run
    # and read just after: the probe op's decode is one launch a probe into
    # the server's scratch window (the new call site), beside one a folded
    # commit.
    probe = config8["probe_decode"]
    kernels[5]["call_sites"].append(
        "distkeras_tpu/netps/server.py:939 _op_probe's decode (the tuner's "
        "probe: one scale-1 fold into a -0.0 scratch window, "
        "netps/fold.py ProbeWindow)")
    kernels[5].update({
        "auto_launches": config8["auto_fold_launches"],
        "auto_commits": config8["auto_commits"],
        "cold_start_launches": config8["cold_fold_launches"],
        "cold_start_commits": config8["cold_commits"],
        "probe_launches": config8["cold_probe_launches"]
        + tree["probe_link_probes"],
        "probe_launches_by_path": {
            "tcp_cold_start_sweep": config8["cold_probe_launches"],
            "tree_uplink_sweep": tree["probe_link_probes"],
            "idle_server_sweep": probe["sweep_launches"]},
        "probe_shape": f"one config #8 probe, {probe['params']} parameters "
                       f"in {probe['tensors']} tensors, into the f32 "
                       f"scratch window, scale 1",
        "probe_bit_equal": probe["bit_equal"],
        **{f"probe_{codec}_{k}": probe["times"][codec][k]
           for codec in ("none", "bf16", "int8")
           for k in ("ms", "fold_ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "decode_wall_ms")}})
    times = tree["times"]
    kernels[5].update({
        "precombine_shape": f"one config #8 commit, {times['params']} "
                            f"parameters, f32 into the f32 window, scale 1",
        "precombine_ms": times["ms"],
        "precombine_plain_ms": times["plain_ms"],
        "precombine_bound_ms": times["bound_ms"],
        "precombine_bound_by": times["bound_by"],
        "precombine_library_ms": times["library_ms"],
        "precombine_take_ms": times["take_ms"]})
    for k in kernels[6:]:
        k["config8_drill_bf16_launches"] = config8["drill_flash"][k["name"]]
        # the MoE LM (moe_train), each arm counted from 0 just before its
        # run and read just after: once a layer a step
        k["moe_launches"] = {arm: c[k["name"]]
                             for arm, c in moe_launches.items()}
        # and held against its twin at the MoE LM's shape, at one rank's
        # heads under tensor parallelism and at config #6's heads of 256,
        # the DP = 256 kernels (flash_kernel)
        shapes = {(MOE_BATCH, MOE_SEQ, MOE["num_heads"],
                   MOE["d_model"] // MOE["num_heads"]): "moe_shape",
                  TP_FLASH_SHAPE: "tp_shape",
                  HD256_FLASH_SHAPE: "hd256_shape"}
        for r in flash_rows:
            if r["name"] != k["name"]:
                continue
            tag = shapes.get((r["B"], r["L"], r["H"], r["D"]))
            if tag:
                k.update({f"{tag}_{r['dtype']}_{f}": r[f]
                          for f in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")})
    # The observability plane's paths, each counted from 0 just before its
    # run and read just after: config #4's remote runs against the traced
    # CLI server (its fold launches counted in that process), and the
    # served requests, untraced and traced.
    kernels[0]["observability_launches"] = obs["serve"]
    kernels[1]["observability_launches"] = obs["stash"]
    kernels[2]["observability_launches"] = obs["bwd"]
    kernels[5]["observability_launches"] = obs["fold"]
    kernels[5]["observability_commits"] = obs["commits"]
    # The fleet control plane's paths, each counted from 0 just before its
    # run and read just after: the one-worker elastic job (elastic_parity)
    # and the pool of three tenants (fleet_card: the serving replicas'
    # forwards, acme's windows, both jobs' folded int8 commits).
    kernels[0]["fleet_launches"] = {"fleet_card": fleet["lstm_fwd"]}
    for k in kernels[1:3]:
        k["fleet_launches"] = {"elastic_parity": elastic[k["name"]],
                               "fleet_card": fleet[k["name"]]}
    kernels[5]["fleet_launches"] = {"elastic_parity": elastic["fold_commit"],
                                    "fleet_card": fleet["fold_commit"]}
    # The streaming plane's paths, each counted from 0 just before its run
    # and read just after: config #11's job (its parameter server's folds,
    # one a commit), the resumed config #4 child of streaming_kill (its
    # windows; its CLI server's folds over both lives, counted in that
    # process), the engines' run_stream and the raced server.
    for k in kernels[1:3]:
        k["streaming_launches"] = {"streaming_kill_resumed_child":
                                   kill[k["name"]]}
        k["stream_engine_launches"] = engine["lstm"][k["name"]]
        k["raced_launches"] = {arm: c[k["name"]] for arm, c in raced.items()}
    for k in kernels[3:5]:
        k["stream_engine_launches"] = engine["groupnorm"][k["name"]]
    kernels[5]["streaming_launches"] = {
        "config11": config11["fold_commit"],
        "config11_commits": config11["commits"],
        "streaming_kill_server": kill["fold_commit"]}
    kernels[5]["raced_launches"] = {arm: c["fold_commit"]
                                    for arm, c in raced.items()}
    # Training across ranks, each rank's counts set to 0 just before its
    # run and read just after, in its own process: config #4 on a one-rank
    # NCCL group and on two gloo ranks (one list entry a rank), config #5
    # in bf16 on the one-rank NCCL group.
    for k in kernels[1:3]:
        k["ranks_launches"] = {part: [c[k["name"]] for c in r["lstm"]]
                               for part, r in ranks.items()}
    for k in kernels[3:5]:
        k["ranks_bf16_launches"] = {"nccl1": ranks["nccl1"]["gn"][k["name"]]}
    # The model-parallel engines (parallel), each part's counts set to 0
    # just before its run and read just after, in its ranks' processes:
    # config #6 on a one-rank NCCL group (a), then each of two gloo ranks
    # on its own heads (b, e), on its sequence blocks (d), on its experts'
    # model (f); the pipeline's dense stages launch none (c); config #8's
    # center over two devices folds one launch a device (g); config #6 at
    # 4 heads of 256 on the one-rank NCCL group, the DP = 256 kernels
    # (a_hd256).
    for k in kernels[6:]:
        k["parallel_launches"] = {
            "a_config6_nccl1": parallel["a"][k["name"]],
            "a_hd256_config6_nccl1": parallel["a_hd256"][k["name"]],
            **{f"{part}_gloo2": [c[k["name"]] for c in parallel[part]]
               for part in "bcdef"}}
    kernels[5]["parallel_mesh_launches"] = parallel["g"]
    # The multi-round programs (blocked), each run's counts set to 0 just
    # before it and read just after: config #4 as captured graphs of 3
    # rounds in f32 and bf16 (b), config #5 in bf16 of 2 (c), config #6 of
    # 2 on a one-rank NCCL group (d, in parallel's nccl1 child); the
    # replays add what their capture recorded.
    # Each blocked count holds its run's warm-up rounds (one a capture, on
    # scratch state), shown beside it; the device's own count of each
    # kernel in the profiled repeat of the run matched the wrappers'.
    def blocked_entry(row, name):
        return {"launches": row["launches"]["blocked"][name],
                "warmup": row["blocked_warmup_launches"].get(name, 0),
                "per_round": row["launches"]["per_round"][name]}

    for k in kernels[1:3]:
        k["blocked_launches"] = {
            part: blocked_entry(blocked[part], f"lstm.{k['name']}")
            for part in ("b_float32", "b_bfloat16")}
    for k in kernels[3:5]:
        k["blocked_bf16_launches"] = blocked_entry(
            blocked["c"], f"groupnorm.{k['name']}")
    for k in kernels[6:]:
        k["blocked_bf16_launches"] = blocked_entry(
            parallel["blocked_d"], f"flash_attention.{k['name']}")
    # dk-check's phase (analysis), each run's counts set to 0 just before
    # it and read just after: the interleave suite's zero-delta commits on
    # servers whose centers sit on the card, and the witness run's racing
    # int8 commits (one launch a commit).
    kernels[5]["analysis_launches"] = {
        "interleave": analysis["interleave"],
        "witness": analysis["witness"],
        "witness_commits": analysis["witness_commits"]}
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
