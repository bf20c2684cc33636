"""Rank programs for the port's multi-process tests.

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``
(spawned, one thread each), joins them under a gloo group on a free
loopback port (or runs them with no group at all), calls a function of
this module in each, and returns every rank's result. A rank that raises
sends its traceback instead; a rank still alive at the time limit is
killed and the call fails, so a hung rank fails its test rather than
eating the suite's clock.

This module imports torch and the port only: the spawned processes never
load JAX.
"""

from __future__ import annotations

import os
import pickle
import shutil
import socket
import tempfile
import time
import traceback

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn_name, rank, world, port, group, out_dir, args):
    torch.set_num_threads(1)
    from distkeras_tpu_torch.runtime import mesh

    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        if group:
            mesh.distributed_initialize(
                device="cpu", master_addr="127.0.0.1", master_port=port,
                rank=rank, world_size=world, local_rank=0, timeout=60)
        result = ("ok", globals()[fn_name](*args))
    except BaseException:  # the parent re-raises it with the rank's trace
        result = ("error", traceback.format_exc())
    finally:
        mesh.distributed_shutdown()
    with open(path, "wb") as f:
        pickle.dump(result, f)


def spawn(fn_name: str, world: int, args=(), group: bool = True,
          timeout: float = 240.0) -> list:
    """Run ``fn_name(*args)`` of this module in ``world`` processes; returns
    the results in rank order."""
    ctx = torch.multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="dk_ranks_")
    port = free_port()
    procs = [ctx.Process(target=_entry,
                         args=(fn_name, r, world, port, group, out_dir, args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        results = []
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(
                    f"rank {r} wrote no result (exit {procs[r].exitcode}; "
                    f"hung ranks {hung} after {timeout} s)")
            with open(path, "rb") as f:
                kind, value = pickle.load(f)
            if kind == "error":
                raise RuntimeError(f"rank {r} failed:\n{value}")
            results.append(value)
        if hung:
            raise RuntimeError(f"ranks {hung} did not exit in {timeout} s")
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


# -- models and data ----------------------------------------------------------

SMALL_LSTM = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)
CNN = dict(conv_features=(8, 16), dense=(16,), num_outputs=10)
IMAGE = (28, 28, 1)
MLP_CFG = dict(hidden=(32, 32), num_outputs=10)
BN_D, BN_HIDDEN, BN_C = 4, 16, 3


def _bn_module():
    from torch import nn

    from distkeras_tpu_torch.models.base import BatchNorm

    class BNNet(nn.Module):
        """Dense, BatchNorm (momentum 0.9), relu, Dense."""

        def __init__(self):
            super().__init__()
            self.Dense_0 = nn.Linear(BN_D, BN_HIDDEN)
            self.BatchNorm_0 = BatchNorm(BN_HIDDEN, momentum=0.9)
            self.Dense_1 = nn.Linear(BN_HIDDEN, BN_C)

        def forward(self, x):
            return self.Dense_1(torch.relu(self.BatchNorm_0(self.Dense_0(x))))

    return BNNet()


def build_model(kind: str, weights=None):
    """A port model on the CPU: ``lstm`` (a small IMDB LSTM), ``cnn`` (the
    small MNIST CNN), ``mlp`` (flat MNIST) or ``bn`` (a BatchNorm MLP, its
    init drawn from torch seed 0). ``weights`` is a state dict of numpy
    arrays to load."""
    from distkeras_tpu_torch.models import MLP, Model, SimpleCNN, imdb_lstm

    if kind == "lstm":
        m = imdb_lstm(**SMALL_LSTM, device="cpu")
    elif kind == "cnn":
        m = Model.build(SimpleCNN(**CNN, input_shape=IMAGE),
                        np.zeros((1,) + IMAGE, np.float32), device="cpu")
    elif kind == "mlp":
        m = Model.build(MLP(**MLP_CFG), np.zeros((1, 784), np.float32),
                        device="cpu")
    elif kind == "bn":
        torch.manual_seed(0)
        m = Model.build(_bn_module(), np.zeros((1, BN_D), np.float32),
                        device="cpu")
    else:
        raise ValueError(kind)
    if weights is not None:
        m.module.load_state_dict({k: torch.as_tensor(v)
                                  for k, v in weights.items()})
    return m


def columns(kind: str, n: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    if kind == "lstm":
        return {"features": rng.integers(0, 50, (n, 6)).astype(np.int32),
                "label": rng.integers(0, 2, n).astype(np.int32)}
    if kind == "bn":
        centers = rng.normal(scale=4.0, size=(BN_C, BN_D))
        y = rng.integers(0, BN_C, size=n)
        x = (centers[y] + rng.normal(scale=0.5, size=(n, BN_D))) * 10 + 5
        return {"features": x.astype(np.float32), "label": y.astype(np.int32)}
    shape = IMAGE if kind == "cnn" else (784,)
    return {"features": rng.uniform(size=(n,) + shape).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}


def _np_tree(d: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in d.items()}


def train_case(case: dict) -> dict:
    """Train one case in this process (every rank runs the same case):
    ``{"trainer", "kind", "kw", "rows", "weights"?, "seed"?, "faults"?,
    "shards"?, "private"?, "ckpt"?, "shuffle"?}``. Returns the center (or
    params), the histories and the model state as numpy."""
    from distkeras_tpu_torch import resilience, trainers as T
    from distkeras_tpu_torch.data import DataFrame
    from distkeras_tpu_torch.models.base import state_buffers
    from distkeras_tpu_torch.resilience import faults
    from distkeras_tpu_torch.runtime import mesh

    model = build_model(case["kind"], case.get("weights"))
    kw = dict(case["kw"])
    if case.get("ckpt"):
        kw.update(checkpoint_dir=case["ckpt"], checkpoint_every=1,
                  resume=bool(case.get("resume")))
    if case.get("shards"):
        df = _sharded_frame(case)
    else:
        df = DataFrame(columns(case["kind"], case["rows"],
                               case.get("seed", 0)))
    if case.get("faults"):
        faults.set_plan(faults.FaultPlan.parse(case["faults"]))
    try:
        t = getattr(T, case["trainer"])(
            model, loss="sparse_categorical_crossentropy", **kw)
        out = t.train(df, shuffle=bool(case.get("shuffle")))
    finally:
        resilience.reset()
    h = t.get_worker_histories()
    return {"params": _np_tree(out.params),
            "history": np.asarray(t.get_history()),
            "worker_histories": None if h is None else np.asarray(h),
            "state": (None if out.state is None else
                      _np_tree(state_buffers(out.module, out.state))),
            "rank": mesh.rank(), "world": mesh.world_size()}


def _sharded_frame(case: dict):
    """The case's store; with ``private``, a private directory holding
    only the shard files this rank's workers read (hard links), so a read
    of any other shard raises ``FileNotFoundError``."""
    from distkeras_tpu_torch.data.shards import (
        ShardedDataFrame, ShardStore, worker_partition)
    from distkeras_tpu_torch.runtime import mesh

    root = case["shards"]
    if not case.get("private"):
        return ShardedDataFrame(root)
    store = ShardStore.open(root)
    W = case["kw"]["num_workers"]
    parts = worker_partition(store.count(), W)
    needed = set()
    for w in mesh.local_worker_ids(W):
        needed.update(store.shards_for_rows(*parts[w]))
    priv = os.path.join(case["private"], f"rank{mesh.rank()}")
    os.makedirs(priv, exist_ok=True)
    os.link(os.path.join(root, "manifest.json"),
            os.path.join(priv, "manifest.json"))
    for s in sorted(needed):
        for col in store.columns:
            fn = f"shard-{s:05d}.{col}.npy"
            os.link(os.path.join(root, fn), os.path.join(priv, fn))
    return ShardedDataFrame(priv)


def train_cases(cases: list) -> list:
    return [train_case(c) for c in cases]


def collectives_probe() -> dict:
    """Every collective of ``ops/collectives.py`` on this rank's own
    values (rank r holds ``r + 1`` and ``[r, r + 0.5]``)."""
    from distkeras_tpu_torch.ops import collectives as C
    from distkeras_tpu_torch.runtime import mesh

    r = mesh.rank()
    tree = {"a": torch.full((3,), float(r + 1)),
            "b": torch.tensor([r, r + 0.5], dtype=torch.float64),
            "c": torch.arange(4, dtype=torch.float32) * (r + 1)}
    again = mesh.distributed_initialize(device="cpu")  # a no-op now
    return {
        "sum": _np_tree(C.all_reduce(tree, "sum")),
        "mean": _np_tree(C.all_reduce(tree, "mean")),
        "input_kept": _np_tree(tree),
        "gather": C.all_gather(torch.tensor([r, 10 * r])).numpy(),
        "objects": C.all_gather_object({"rank": r}),
        "bcast": C.broadcast_object(f"from{r}"),
        "axis_size": C.axis_size(),
        "device_count": mesh.device_count(),
        "again": str(again),
        "mesh": mesh.data_mesh().shape,
        "hybrid": mesh.hybrid_mesh({"data": -1, "model": 1}).shape,
        "local_workers": mesh.local_worker_ids(4),
    }


def predict_case(case: dict) -> dict:
    """Predict a sharded store (``case["root"]``, or this rank's private
    copy of the shards it holds under ``case["private"]``) into column
    ``case["col"]``; returns that column read back, in shard order."""
    from distkeras_tpu_torch.data.shards import ShardStore
    from distkeras_tpu_torch.predictors import ModelPredictor
    from distkeras_tpu_torch.runtime import mesh

    model = build_model(case["kind"], case.get("weights"))
    root = case["root"]
    if case.get("holds") is not None:
        # this rank's disk: only the shards it holds (hard links)
        priv = os.path.join(case["private"], f"rank{mesh.rank()}")
        os.makedirs(priv, exist_ok=True)
        store = ShardStore.open(root)
        os.link(os.path.join(root, "manifest.json"),
                os.path.join(priv, "manifest.json"))
        for s in case["holds"][mesh.rank()]:
            for col in store.columns:
                fn = f"shard-{s:05d}.{col}.npy"
                os.link(os.path.join(root, fn), os.path.join(priv, fn))
        root = priv
    from distkeras_tpu_torch.data.shards import ShardedDataFrame

    ModelPredictor(model, output_col=case["col"],
                   chunk_size=case.get("chunk", 16)).predict(
                       ShardedDataFrame(root))
    store = ShardStore.open(root)
    spec = store.columns[case["col"]]
    physical = spec.get("file", case["col"]) if isinstance(spec, dict) \
        else case["col"]
    mine = {}
    for s in range(store.num_shards):
        path = os.path.join(root, f"shard-{s:05d}.{physical}.npy")
        if os.path.exists(path):
            mine[s] = np.load(path)
    return {"shards": mine, "manifest": store.manifest}


# -- the model-parallel engines -----------------------------------------------

LM_CFG = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, d_ff=64,
              max_seq_len=32)
MOE_CFG = dict(LM_CFG, num_experts=4)


def build_lm(kind: str = "lm", weights=None, **kw):
    """A port transformer LM (``lm``) or MoE LM (``moe``) on the CPU at the
    tests' widths (``kw`` over them), with ``weights`` (numpy) loaded."""
    from distkeras_tpu_torch.models import Model
    from distkeras_tpu_torch.models.moe import MoETransformerLM
    from distkeras_tpu_torch.models.transformer import TransformerLM

    cls, cfg = ((MoETransformerLM, MOE_CFG) if kind == "moe"
                else (TransformerLM, LM_CFG))
    module = cls(**dict(cfg, **kw))
    m = Model.build(module, np.zeros((1, cfg["max_seq_len"]), np.int32),
                    device="cpu")
    if weights is not None:
        m.module.load_state_dict({k: torch.as_tensor(v)
                                  for k, v in weights.items()})
    return m


def lm_frame(n: int, seed: int = 0, seq: int = 32, vocab: int = 64):
    from distkeras_tpu_torch.datasets import synthetic_lm

    return synthetic_lm(n=n, vocab_size=vocab, seq_len=seq + 1, seed=seed)


class _Stop(RuntimeError):
    pass


def parallel_train(case: dict) -> dict:
    """``ParallelTrainer(model, parallel=case["parallel"], **case["kw"])``
    on ``lm_frame(case["rows"])`` (``case["shards"]``: a store directory
    instead); ``die_at`` raises from ``on_round`` at that round (the run
    then returns what it had). Returns the whole params, the history and
    the engine's ``local`` shards."""
    from distkeras_tpu_torch import ParallelTrainer
    from distkeras_tpu_torch.runtime import mesh

    model = build_lm(case.get("kind", "lm"), case.get("weights"),
                     **case.get("model", {}))
    kw = dict(case.get("kw", {}))
    if case.get("shards"):
        from distkeras_tpu_torch.data.shards import ShardedDataFrame

        df = ShardedDataFrame(case["shards"])
    else:
        df = lm_frame(case.get("rows", 128), case.get("seed", 0))
    t = ParallelTrainer(model, parallel=dict(case["parallel"]),
                        loss="sparse_categorical_crossentropy", **kw)
    if case.get("die_at") is not None:
        def die(r, loss):
            if r == case["die_at"]:
                raise _Stop()
        t.on_round = die
    out = {"rank": mesh.rank(), "strategy": t._resolve_strategy()}
    try:
        trained = t.train(df)
    except _Stop:
        out["stopped"] = True
        return out
    out.update(params=_np_tree(trained.params),
               history=np.asarray(t.get_history()))
    return out


def tp_grads(case: dict) -> dict:
    """One forward and backward of the LM (``case["parallel"]`` grid,
    rules ``case["rules"]`` default TP) on ``case["tokens"]``: this rank's
    loss and gradients of its shards, and the shards' specs."""
    from distkeras_tpu_torch.parallel import sharding
    from distkeras_tpu_torch.parallel.spmd import SPMDEngine
    from distkeras_tpu_torch.runtime import mesh as M

    model = build_lm(case.get("kind", "lm"), case.get("weights"),
                     **case.get("model", {}))
    grid = M.hybrid_mesh(dict(case["parallel"]))
    rules = case.get("rules", sharding.TRANSFORMER_TP_RULES)
    eng = SPMDEngine(model, "sgd", "sparse_categorical_crossentropy", grid,
                     rules, compute_dtype=case.get("dtype"))
    st = eng.init_state()
    x = torch.as_tensor(eng.local_block(case["tokens"][None])[0])
    y = torch.as_tensor(eng.local_block(case["targets"][None])[0])
    loss, grads = eng.loss_and_grads(st.params, x, y, 0)
    whole = sharding.gather_params(grads, grid, eng.specs)
    return {"loss": float(loss), "grads": _np_tree(grads),
            "whole": _np_tree(whole), "specs": eng.specs,
            "coords": grid.coords(), "rank": M.rank()}


def ring_probe(case: dict) -> dict:
    """Ring attention and gather attention over a ``seq`` grid of the
    world: this rank's block of ``case["q"]``/``k``/``v`` (global
    ``[B, L, H, D]``) forward, then backward with the block of
    ``case["dout"]``. Returns the blocks of the output and the input
    gradients."""
    from distkeras_tpu_torch.ops import collectives
    from distkeras_tpu_torch.ops.ring_attention import ring_attention
    from distkeras_tpu_torch.runtime import mesh as M

    grid = M.hybrid_mesh({"seq": -1}).bind()
    g = grid.group("seq")
    n = case["q"].shape[1] // g.size
    blk = lambda a: torch.as_tensor(  # noqa: E731
        a[:, g.index * n:(g.index + 1) * n]).clone()
    out = {}
    for how in ("ring", "gather"):
        q, k, v = (blk(case[c]).requires_grad_(True) for c in "qkv")
        if how == "ring":
            o = ring_attention(q, k, v, g)
        else:
            kk = collectives.gather_shards(k, g, 1)
            vv = collectives.gather_shards(v, g, 1)
            s = torch.einsum("bqhd,bkhd->bhqk", q, kk)
            qp = g.index * n + torch.arange(n)
            mask = qp[:, None] >= torch.arange(kk.shape[1])[None, :]
            s = torch.where(mask, s, torch.finfo(s.dtype).min)
            o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vv)
        gq, gk, gv = torch.autograd.grad(o, (q, k, v), blk(case["dout"]))
        out[how] = {"out": o.detach().numpy(), "dq": gq.numpy(),
                    "dk": gk.numpy(), "dv": gv.numpy()}
    out["index"] = g.index
    return out


def lm_forward(case: dict) -> dict:
    """The LM's eval forward of ``case["tokens"]`` on this rank's block of
    the ``case["parallel"]`` grid (``case["model"]`` over the widths):
    the rank's logits (whole over ``model``)."""
    from distkeras_tpu_torch.ops import collectives
    from distkeras_tpu_torch.parallel import sharding
    from distkeras_tpu_torch.parallel.spmd import SPMDEngine
    from distkeras_tpu_torch.runtime import mesh as M

    model = build_lm(case.get("kind", "lm"), case.get("weights"),
                     **case.get("model", {}))
    grid = M.hybrid_mesh(dict(case["parallel"]))
    eng = SPMDEngine(model, "sgd", "sparse_categorical_crossentropy", grid,
                     sharding.TRANSFORMER_TP_RULES)
    st = eng.init_state()
    x = torch.as_tensor(eng.local_block(case["tokens"][None])[0])
    from torch.func import functional_call

    with torch.no_grad(), M.axis_context(eng.groups):
        out = functional_call(model.module, st.params, (x,))
        if eng.vocab_split:
            out = collectives.gather_replicated(out, eng.groups["model"], -1)
    return {"logits": out.numpy(), "coords": grid.coords()}


def async_train(case: dict) -> dict:
    """An async trainer (``case["trainer"]``) with ``parallel=``, or flat
    (``parallel`` None), on ``case["frame"]`` (``"blobs"`` or ``"lm"``)."""
    from distkeras_tpu_torch import trainers as T
    from distkeras_tpu_torch.data import DataFrame
    from distkeras_tpu_torch.runtime import mesh

    if case.get("frame") == "lm":
        model = build_lm("lm", case.get("weights"), **case.get("model", {}))
        df = lm_frame(case.get("rows", 128), case.get("seed", 0))
    else:
        from distkeras_tpu_torch.models import MLP, Model

        model = Model.build(MLP(hidden=(16,), num_outputs=3, in_features=8),
                            np.zeros((1, 8), np.float32), device="cpu")
        if case.get("weights") is not None:
            model.module.load_state_dict({
                k: torch.as_tensor(v) for k, v in case["weights"].items()})
        df = DataFrame(blob_columns(case.get("rows", 512)))
    kw = dict(case.get("kw", {}))
    if case.get("ckpt"):
        kw.update(checkpoint_dir=case["ckpt"], checkpoint_every=1,
                  resume=bool(case.get("resume")))
    t = getattr(T, case["trainer"])(
        model, loss="sparse_categorical_crossentropy",
        parallel=case.get("parallel"), **kw)
    if case.get("die_at") is not None:
        def die(r, loss):
            if r == case["die_at"]:
                raise _Stop()
        t.on_round = die
    try:
        out = t.train(df)
    except _Stop:
        return {"stopped": True, "rank": mesh.rank()}
    return {"params": _np_tree(out.params),
            "history": np.asarray(t.get_history()),
            "worker_histories": np.asarray(t.get_worker_histories()),
            "rank": mesh.rank()}


def blob_columns(n: int = 512, d: int = 8, c: int = 3, seed: int = 0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=3.0, size=(c, d))
    y = rng.integers(0, c, size=n)
    x = (centers[y] + rng.normal(scale=0.5, size=(n, d))).astype(np.float32)
    return {"features": x, "label": y.astype(np.int32)}


def run_calls(calls: list) -> list:
    """``[(function name, case), ...]`` run in order in this process (every
    rank the same calls): one spawn for many cases."""
    return [globals()[fn](case) for fn, case in calls]


def shard_roundtrip(case: dict) -> dict:
    """``shard_params`` then ``gather_params`` of ``case["weights"]`` on the
    ``case["parallel"]`` grid under ``case["rules"]``: this rank's shapes
    and the whole state dict back."""
    from distkeras_tpu_torch.parallel import sharding
    from distkeras_tpu_torch.runtime import mesh as M

    model = build_lm(case.get("kind", "lm"), case.get("weights"))
    grid = M.hybrid_mesh(dict(case["parallel"])).bind()
    specs = sharding.param_specs(model.params, grid, case["rules"],
                                 model.module)
    local = sharding.shard_params(model.params, grid, specs=specs)
    back = sharding.gather_params(local, grid, specs)
    return {"shapes": {k: tuple(v.shape) for k, v in local.items()},
            "back": _np_tree(back), "coords": grid.coords()}


def vp_ce(case: dict) -> dict:
    """``vocab_parallel_cross_entropy`` of this rank's columns of
    ``case["logits"]`` (``[N, V]``) over a ``model`` grid of the world:
    the loss and this rank's columns of its gradient."""
    from distkeras_tpu_torch.ops import collectives
    from distkeras_tpu_torch.runtime import mesh as M

    g = M.hybrid_mesh({"model": -1}).bind().group("model")
    V = case["logits"].shape[1]
    n = V // g.size
    x = torch.as_tensor(case["logits"][:, g.index * n:(g.index + 1) * n]
                        ).clone().requires_grad_(True)
    loss = collectives.vocab_parallel_cross_entropy(
        x, torch.as_tensor(case["targets"]), g)
    (grad,) = torch.autograd.grad(loss, x)
    return {"loss": float(loss), "grad": grad.numpy(), "index": g.index}


def gpipe_probe(case: dict) -> dict:
    """``gpipe`` of affine stages ``x * w[s] + b[s]`` over a ``pipe`` grid
    of the world on ``case["x"]`` (``[M, b, D]``), then backward with
    ``case["dout"]``: the broadcast outputs and this stage's gradients."""
    from distkeras_tpu_torch.parallel.pipeline import (
        gpipe,
        last_stage_broadcast,
    )
    from distkeras_tpu_torch.runtime import mesh as M

    g = M.hybrid_mesh({"pipe": -1}).bind().group("pipe")
    s = g.index
    w = torch.as_tensor(case["w"][s]).clone().requires_grad_(True)
    b = torch.as_tensor(case["b"][s]).clone().requires_grad_(True)
    x = torch.as_tensor(case["x"]).clone().requires_grad_(True)
    y = gpipe(lambda p, h: h * p[0] + p[1], (w, b), x, g)
    last = s == g.size - 1
    obj = (y * torch.as_tensor(case["dout"])).sum() if last else y.sum() * 0
    gw, gb, gx = torch.autograd.grad(obj, (w, b, x), allow_unused=True)
    return {"y": last_stage_broadcast(y.detach(), g).numpy(), "stage": s,
            "gw": gw.numpy(), "gb": gb.numpy(),
            "gx": None if gx is None else gx.numpy()}


def pipe_steps(case: dict) -> dict:
    """``PipelineEngine`` on ``case["parallel"]``: the last stage's logits
    of ``case["tokens"]`` broadcast over ``pipe`` (before any step), then
    one step a batch of ``case["batches"]`` (``[(x, y), ...]``, global);
    returns the logits, the losses and the merged parameters."""
    from distkeras_tpu_torch.parallel.pipeline import last_stage_broadcast
    from distkeras_tpu_torch.parallel.pipeline_engine import PipelineEngine
    from distkeras_tpu_torch.runtime import mesh as M

    model = build_lm("lm", case.get("weights"), **case.get("model", {}))
    grid = M.hybrid_mesh(dict(case["parallel"]))
    eng = PipelineEngine(model, case.get("optimizer", "sgd"),
                         "sparse_categorical_crossentropy", grid,
                         num_microbatches=case.get("micro", 2),
                         learning_rate=case.get("lr", 0.1))
    st = eng.init_state()
    out = {"coords": grid.coords()}
    if case.get("tokens") is not None:
        with torch.no_grad():
            x = torch.as_tensor(eng.local_block(case["tokens"][None])[0])
            logits = eng._forward(st.params, x)
            if eng.stage != eng.num_stages - 1:  # no head: zeros
                logits = torch.zeros(tuple(x.shape) + (
                    model.module.config["vocab_size"],))
            out["logits"] = last_stage_broadcast(logits, eng.pipe).numpy()
    losses = []
    for xb, yb in case.get("batches", ()):
        x = torch.as_tensor(eng.local_block(xb[None])[0])
        y = torch.as_tensor(eng.local_block(yb[None])[0])
        st, loss = eng.step(st, x, y)
        losses.append(float(loss))
    out["losses"] = losses
    out["params"] = _np_tree(eng.export_params(st))
    return out


def engine_probe(case: dict) -> dict:
    """``ParallelTrainer._build_engine()`` for ``case["parallel"]``: the
    resolved grid and the inner engine's module's ``seq_axis``."""
    from distkeras_tpu_torch import ParallelTrainer

    model = build_lm(case.get("kind", "lm"), **case.get("model", {}))
    t = ParallelTrainer(model, parallel=dict(case["parallel"]),
                        loss="sparse_categorical_crossentropy",
                        **case.get("kw", {}))
    eng = t._build_engine()
    return {"shape": dict(eng.mesh.shape), "strategy": t._resolve_strategy(),
            "seq_axis": eng.inner.model.module.seq_axis,
            "user_seq_axis": t.model.module.seq_axis,
            "num_chips": eng.num_chips}


def rank_major_probe(case: dict) -> dict:
    """One round staged from a ``[1, K, B]`` plan and from its rank-major
    ``[dp, K, B/dp]`` split, through the windowed engine of
    ``case["parallel"]``: this rank's blocks and the round's results."""
    from distkeras_tpu_torch import ParallelTrainer

    class Plan:
        def __init__(self, xs, ys):
            self.xs, self.ys, self.num_workers = xs, ys, xs.shape[0]
            self.num_rounds = 1

        def round(self, r):
            return self.xs, self.ys

    model = build_lm("lm", case.get("weights"))
    t = ParallelTrainer(model, parallel=dict(case["parallel"]),
                        loss="sparse_categorical_crossentropy",
                        worker_optimizer="sgd", learning_rate=0.1)
    eng = t._build_engine()
    out = {}
    for name, (xs, ys) in case["plans"].items():
        x, y = eng._stage_round(Plan(xs, ys), 0)
        st, loss = eng._round_fn(eng.init_state(), x, y)
        out[name] = {"x": x.numpy(), "loss": float(loss),
                     "params": _np_tree(eng.global_state(st).params)}
    return out


def blocked_auto() -> dict:
    """An ``AsyncEngine`` (ADAG, adam, 4 workers: 2 a rank) over 24 rounds
    per round and under ``rounds_per_program="auto"``; rank 0's auto R
    (``engine.auto_rounds_per_program``) is every rank's. Returns this
    rank's R, the program mode and both runs' losses."""
    from distkeras_tpu_torch.data import DataFrame, make_batches
    from distkeras_tpu_torch.models import MLP, Model
    from distkeras_tpu_torch.parallel.disciplines import get_discipline
    from distkeras_tpu_torch.parallel.engine import AsyncEngine

    model = Model.build(MLP(hidden=(16,), num_outputs=3, in_features=8),
                        np.zeros((1, 8), np.float32), device="cpu")
    plan = make_batches(DataFrame(blob_columns(24 * 4 * 2 * 8)), "features",
                        "label", batch_size=8, num_workers=4, window=2,
                        num_epoch=1)
    out = {}
    for key, rpp in (("per_round", 1), ("blocked", "auto")):
        eng = AsyncEngine(model, "adam", "sparse_categorical_crossentropy",
                          get_discipline("adag"), window=2, num_workers=4,
                          learning_rate=0.05)
        _, losses = eng.run(plan, rounds_per_program=rpp)
        out[key] = losses.tolist()
    out["R"] = eng.auto_rounds_per_program
    out["mode"] = eng._program_seat.mode
    return out
