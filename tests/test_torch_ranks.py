"""The engines across ranks: the port's trainers on a 2-rank gloo group
(spawned processes, one thread each, ``tests/torch_rank_workers.py``)
against the port in one process and against the JAX trainers.

* W=2 as 2 ranks x 1 worker is bit-equal to the port in one process at
  W=2 (that baseline is a spawned process too, with one thread and no
  group): DynSGD on a small LSTM, ADAG and AEASGD on a small CNN, and
  ``AveragingTrainer`` (every rank's replicas gathered and averaged). The
  fold's one all-reduce adds the two ranks' commits, and a sum of two
  terms is the same in either order. The sync engine is held within
  1e-6 instead: one process means the gradient over the merged ``[2B]``
  batch, two ranks average two ``B``-row means, and the two round apart
  (as the JAX engine's ``workers_per_chip=2`` and two chips do).
* W=4 as 2 ranks x 2 workers matches the JAX trainers at
  ``num_workers=4`` on the conftest's 8 virtual devices within rtol =
  atol = 1e-5 (``tests/test_torch_trainers.py``'s and
  ``tests/test_torch_sync.py``'s limits).
* A ``nan@1`` fault skips round 1 on both ranks; a BatchNorm model's
  state is the mean over the ranks; a sharded store stages only each
  rank's rows (each rank sees only its shards' files); a checkpoint
  written at 2 ranks resumes in one process.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import distkeras_tpu as dk
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.cnn import SimpleCNN as JaxCNN
from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
from distkeras_tpu.models.mlp import MLP as JaxMLP
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.data.shards import write_shards
from distkeras_tpu_torch.runtime import mesh

import torch_rank_workers as RW

LSTM_KW = dict(worker_optimizer="sgd", batch_size=5, communication_window=2,
               learning_rate=0.1)
CNN_KW = dict(worker_optimizer="sgd", batch_size=4, communication_window=2,
              learning_rate=0.05)
SYNC_KW = dict(worker_optimizer="sgd", batch_size=4, steps_per_program=2,
               learning_rate=0.1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_models():
    lstm = jax_imdb_lstm(**RW.SMALL_LSTM, cell_impl="pallas", seed=1)
    cnn = JaxModel.build(JaxCNN(**RW.CNN),
                         jnp.zeros((1,) + RW.IMAGE, jnp.float32), seed=1)
    mlp = JaxModel.build(JaxMLP(**RW.MLP_CFG),
                         jnp.zeros((1, 784), jnp.float32), seed=1)
    return {"lstm": lstm, "cnn": cnn, "mlp": mlp}


def _weights(kind, jm):
    module = RW.build_model(kind).module
    return {k: v.numpy() for k, v in
            params_from_jax(_np(jm.params), module).items()}


def _case(trainer, kind, kw, W, rounds, weights, **extra):
    per_round = W * kw.get("communication_window",
                           kw.get("steps_per_program", 1)) * kw["batch_size"]
    return dict(trainer=trainer, kind=kind, kw=dict(kw, num_workers=W),
                rows=per_round * rounds, weights=weights, **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case, run once: 2 ranks first (the checkpoint the one-process
    resume reads), then the one-process baseline."""
    jms = _jax_models()
    w = {k: _weights(k, m) for k, m in jms.items()}
    tmp = tmp_path_factory.mktemp("ranks")
    store = str(tmp / "store")
    write_shards(store, RW.columns("cnn", 2 * 2 * 4 * 2, seed=3), 5)
    ckpt = str(tmp / "ckpt")
    pair = {
        "dynsgd": _case("DynSGD", "lstm", LSTM_KW, 2, 3, w["lstm"]),
        "adag": _case("ADAG", "cnn", CNN_KW, 2, 2, w["cnn"]),
        "aeasgd": _case("AEASGD", "cnn", dict(CNN_KW, rho=3.0), 2, 2,
                        w["cnn"]),
        "sync": _case("SynchronousDistributedTrainer", "mlp", SYNC_KW, 2, 2,
                      w["mlp"]),
        "nan": _case("ADAG", "cnn", CNN_KW, 2, 3, w["cnn"], faults="nan@1"),
        "bn": _case("ADAG", "bn", dict(CNN_KW, batch_size=8), 2, 3, None),
        "sharded": _case("ADAG", "cnn", CNN_KW, 2, 2, w["cnn"],
                         shards=store),
        "averaging": _case("AveragingTrainer", "cnn", CNN_KW, 2, 2,
                           w["cnn"]),
    }
    four = {
        "dynsgd": _case("DynSGD", "lstm", LSTM_KW, 4, 3, w["lstm"]),
        "adag": _case("ADAG", "cnn", CNN_KW, 4, 2, w["cnn"]),
        "aeasgd": _case("AEASGD", "cnn", dict(CNN_KW, rho=3.0), 4, 2,
                        w["cnn"]),
        "sync": _case("SynchronousDistributedTrainer", "mlp", SYNC_KW, 4, 2,
                      w["mlp"]),
    }
    half = _case("ADAG", "cnn", dict(CNN_KW, num_epoch=1), 2, 2, w["cnn"],
                 ckpt=ckpt)
    whole = dict(half, kw=dict(half["kw"], num_epoch=2), ckpt=None)
    ranked_cases = (list(pair.values()) + list(four.values())
                    + [dict(pair["sharded"], private=str(tmp / "priv")),
                       half])
    ranked = RW.spawn("train_cases", 2, (ranked_cases,))
    resumed = dict(whole, ckpt=ckpt, resume=True)
    base = RW.spawn("train_cases", 1,
                    (list(pair.values()) + [whole, resumed],),
                    group=False)[0]
    names = list(pair)
    n = len(names)
    return {
        "jax": jms, "cases": {**pair, **{f"{k}4": v for k, v in four.items()}},
        "base": dict(zip(names, base[:n])),
        "ranks": [dict(zip(names, r[:n])) for r in ranked],
        "four": [dict(zip(four, r[n:n + 4])) for r in ranked],
        "private": [r[n + 4] for r in ranked],
        "half": [r[n + 5] for r in ranked],
        "whole": base[n], "resumed": base[n + 1],
    }


def _assert_bit_equal(a, b):
    assert a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k],
                                      err_msg=k)


@pytest.mark.parametrize("name", ["dynsgd", "adag", "aeasgd", "averaging"])
def test_two_ranks_are_bit_equal_to_one_process(runs, name):
    r0, r1 = (r[name] for r in runs["ranks"])
    base = runs["base"][name]
    assert (r0["rank"], r0["world"], r1["rank"]) == (0, 2, 1)
    assert base["world"] == 1
    _assert_bit_equal(r0, base)
    _assert_bit_equal(r1, base)
    np.testing.assert_array_equal(r0["worker_histories"],
                                  base["worker_histories"])
    kw = runs["cases"][name]["kw"]
    rounds = runs["cases"][name]["rows"] // (2 * 2 * kw["batch_size"])
    assert r0["worker_histories"].shape == (2, rounds)


def test_sync_two_ranks_match_one_process(runs):
    r0, r1 = (r["sync"] for r in runs["ranks"])
    base = runs["base"]["sync"]
    _assert_bit_equal(r0, r1)  # the ranks never diverge
    for k, v in base["params"].items():
        np.testing.assert_allclose(r0["params"][k], v, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(r0["history"], base["history"], rtol=1e-6,
                               atol=1e-6)
    assert r0["worker_histories"] is None


def _jax_train(runs, name):
    case = runs["cases"][name]
    kind = case["kind"]
    jm = runs["jax"][kind]
    kw = {k: v for k, v in case["kw"].items()}
    t = getattr(dk, case["trainer"])(
        jm, loss="sparse_categorical_crossentropy", **kw)
    out = t.train(JaxDataFrame(RW.columns(kind, case["rows"])))
    module = RW.build_model(kind).module
    ref = {k: v.numpy() for k, v in
           params_from_jax(_np(out.params), module).items()}
    h = t.get_worker_histories()
    return ref, np.asarray(t.get_history() if h is None else h)


@pytest.mark.parametrize("name", ["dynsgd", "adag", "aeasgd", "sync"])
def test_four_workers_on_two_ranks_match_jax(runs, name):
    r0, r1 = (r[name] for r in runs["four"])
    _assert_bit_equal(r0, r1)
    ref, hist = _jax_train(runs, name + "4")
    for k, v in ref.items():
        np.testing.assert_allclose(r0["params"][k], v, err_msg=k, **TOL)
    got = (r0["history"] if r0["worker_histories"] is None
           else r0["worker_histories"])
    if name != "sync":
        assert got.shape[0] == 4  # [W, rounds], every rank's workers
    np.testing.assert_allclose(got, hist, **TOL)


def test_nan_fault_skips_the_round_on_both_ranks(runs):
    r0, r1 = (r["nan"] for r in runs["ranks"])
    base = runs["base"]["nan"]
    for got in (r0, r1):
        h = got["worker_histories"]
        assert h.shape == (2, 3)
        assert np.isnan(h[:, 1]).any() and np.isfinite(h[:, [0, 2]]).all()
        _assert_bit_equal(got, base)
    np.testing.assert_array_equal(r0["worker_histories"],
                                  r1["worker_histories"])


def test_batchnorm_state_is_the_mean_over_ranks(runs):
    r0, r1 = (r["bn"] for r in runs["ranks"])
    base = runs["base"]["bn"]
    assert set(base["state"]) == {"BatchNorm_0.mean", "BatchNorm_0.var"}
    for got in (r0, r1):
        _assert_bit_equal(got, base)
        for k, v in base["state"].items():
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)


def test_sharded_plan_stages_only_each_rank_s_rows(runs):
    """Each rank trains from a directory holding only the shard files of
    its own worker (any other read raises), and lands on the center of
    the shared store's run, in one process and on 2 ranks."""
    base = runs["base"]["sharded"]
    for got, shared in zip(runs["private"], runs["ranks"]):
        _assert_bit_equal(got, base)
        _assert_bit_equal(shared["sharded"], base)
    root = runs["cases"]["sharded"]["shards"]
    priv = os.path.join(os.path.dirname(root), "priv")
    held = [sorted(f for f in os.listdir(os.path.join(priv, f"rank{r}"))
                   if f.endswith(".npy")) for r in range(2)]
    assert held[0] and held[1] and held[0] != held[1]
    every = sorted(f for f in os.listdir(root) if f.endswith(".npy"))
    assert len(held[0]) < len(every) and len(held[1]) < len(every)


def test_checkpoint_written_at_two_ranks_resumes_in_one_process(runs):
    h0, h1 = runs["half"]
    _assert_bit_equal(h0, h1)
    _assert_bit_equal(runs["resumed"], runs["whole"])
    assert runs["resumed"]["worker_histories"].shape == (2, 2)


def test_a_group_refuses_fewer_workers_than_ranks(monkeypatch):
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="fewer than the 2 ranks"):
        mesh.workers_per_rank(1)
    with pytest.raises(ValueError, match="does not divide evenly"):
        mesh.workers_per_rank(3)
    assert mesh.workers_per_rank(4) == 2
