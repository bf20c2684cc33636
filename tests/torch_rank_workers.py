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


# -- models and data -----------------------------------------------------------

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
