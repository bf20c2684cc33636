"""Async disciplines x tensor (and sequence) parallelism in the port
(``parallel/async_tp.py``, the async trainers' ``parallel=``) on gloo
groups of spawned ranks (``tests/torch_rank_workers.py``), mirroring
``tests/test_async_tp.py``.

The JAX ``AsyncTPEngine`` cannot run on this jaxlib (key-array sharding
with an auto axis, ``tests/envcaps.py``); its own test holds the
tensor-parallel run to the flat one, and so does this file:

* a model the rules do not split (an MLP) at ``W=2 x tp=2`` (4 ranks)
  against the flat ``W=2`` run in one process, for every discipline,
  within rtol = atol = 1e-6 (the fold's one all-reduce adds the two
  workers' commits, and a sum of two terms is the same in either order;
  the model's peers compute the same replica);
* the transformer, split over ``model`` (``tp=2``), and over ``seq`` and
  ``model`` (4 ranks), against the flat one-worker run in one process
  within 1e-5 (the split projections sum in another order), and with
  flash attention within 3e-3 of the center's largest move (the flash
  twin's bf16 rounding flips, ``tests/test_torch_transformer_train.py``);
* a checkpointed tp run resumes to the uninterrupted run's center
  within rtol 1e-6 / atol 1e-7, and every refusal of the JAX engine and
  trainer raises with its message.
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.data import DataFrame
from distkeras_tpu_torch.models import MLP, Model
from distkeras_tpu_torch.parallel.async_tp import AsyncTPEngine
from distkeras_tpu_torch.parallel.disciplines import get_discipline
from distkeras_tpu_torch.runtime.mesh import RankMesh

import torch_rank_workers as RW

DISCIPLINES = ["DOWNPOUR", "ADAG", "DynSGD", "AEASGD", "EAMSGD"]
MLP_KW = dict(batch_size=8, communication_window=2, learning_rate=0.05,
              num_workers=2)
LM_KW = dict(worker_optimizer="sgd", batch_size=4, communication_window=2,
             learning_rate=0.1, num_workers=1)
LM_ROWS = 64


def _mlp_weights():
    m = Model.build(MLP(hidden=(16,), num_outputs=3, in_features=8),
                    np.zeros((1, 8), np.float32), device="cpu")
    return {k: v.numpy() for k, v in m.module.state_dict().items()}


@pytest.fixture(scope="module")
def weights():
    return {"mlp": _mlp_weights(),
            "lm": {k: v.numpy() for k, v in
                   RW.build_lm().module.state_dict().items()}}


@pytest.fixture(scope="module")
def four(weights):
    """4 ranks: every discipline at W=2 x tp=2 on the MLP, then the
    transformer at W=1 x seq=2 x tp=2."""
    calls = [("async_train", dict(trainer=d, weights=weights["mlp"],
                                  parallel={"model": 2}, kw=MLP_KW))
             for d in DISCIPLINES]
    calls.append(("async_train", dict(
        trainer="AEASGD", frame="lm", weights=weights["lm"],
        rows=LM_ROWS, parallel={"model": 2, "seq": 2}, kw=LM_KW)))
    res = RW.spawn("run_calls", 4, (calls,), timeout=300)
    return [[r[i] for r in res] for i in range(len(calls))]


@pytest.fixture(scope="module")
def two(weights, tmp_path_factory):
    """2 ranks: the transformer at tp=2 (dense, then flash), the trainer
    surface on the MLP, and a checkpointed run stopped and resumed."""
    ck = str(tmp_path_factory.mktemp("async_tp") / "ck")
    lm = dict(trainer="AEASGD", frame="lm", weights=weights["lm"],
              rows=LM_ROWS, parallel={"model": 2}, kw=LM_KW)
    calls = [
        ("async_train", lm),
        ("async_train", dict(lm, model=dict(attn_impl="flash"))),
        ("async_train", dict(trainer="AEASGD", weights=weights["mlp"],
                             parallel={"model": 2},
                             kw=dict(MLP_KW, num_workers=None,
                                     num_epoch=2))),
        ("async_train", dict(lm, ckpt=ck, die_at=4)),
        ("async_train", dict(lm, ckpt=ck, resume=True)),
    ]
    res = RW.spawn("run_calls", 2, (calls,), timeout=300)
    names = ["lm", "flash", "surface", "died", "resumed"]
    return {n: [r[i] for r in res] for i, n in enumerate(names)}


def _flat(trainer, frame, weights, kw, rows=512, **model):
    if frame == "lm":
        m = RW.build_lm("lm", weights, **model)
        df = RW.lm_frame(rows, 0)
    else:
        m = Model.build(MLP(hidden=(16,), num_outputs=3, in_features=8),
                        np.zeros((1, 8), np.float32), device="cpu")
        m.module.load_state_dict({k: torch.as_tensor(v)
                                  for k, v in weights.items()})
        df = DataFrame(RW.blob_columns(rows))
    t = getattr(T, trainer)(m, loss="sparse_categorical_crossentropy", **kw)
    out = t.train(df)
    return ({k: v.numpy() for k, v in out.params.items()},
            np.asarray(t.get_history()))


def _close(a, b, **tol):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


@pytest.mark.parametrize("disc", DISCIPLINES)
def test_tp_async_matches_flat_worker_run(four, weights, disc):
    """(W=2, tp=2) == flat W=2 on a model the rules leave whole: same
    worker ids, seeds and commits; the fold over the ``data`` group."""
    params, hist = _flat(disc, "blobs", weights["mlp"], MLP_KW)
    for r in four[DISCIPLINES.index(disc)]:
        np.testing.assert_allclose(r["history"], hist, rtol=1e-6, atol=1e-6)
        _close(r["params"], params, rtol=1e-6, atol=1e-6)


def test_transformer_tensor_shards_under_aeasgd(two, weights):
    """The transformer split over ``model`` under AEASGD: the center and
    the history within 1e-5 of the flat run, the loss falling, both ranks
    alike."""
    params, hist = _flat("AEASGD", "lm", weights["lm"], LM_KW, LM_ROWS)
    r0, r1 = two["lm"]
    for r in (r0, r1):
        np.testing.assert_allclose(r["history"], hist, rtol=1e-5)
        _close(r["params"], params, rtol=1e-5, atol=1e-5)
        assert r["history"][-1] < r["history"][0]
    for k in ("block_0.ln_attn.weight", "lm_head.weight"):
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k])


def test_sequence_and_tensor_parallel_async(four, weights):
    """``parallel={"model": 2, "seq": 2}``: the module rebinds to
    ``seq_axis="seq"`` (gather attention), each step's gradient and loss
    take the ``seq`` mean; against the flat run within 1e-5."""
    params, hist = _flat("AEASGD", "lm", weights["lm"], LM_KW, LM_ROWS)
    for r in four[len(DISCIPLINES)]:
        np.testing.assert_allclose(r["history"], hist, rtol=1e-5)
        _close(r["params"], params, rtol=1e-5, atol=1e-5)


def test_flash_under_async_tp(two, weights):
    """Flash attention on each rank's 2 of the 4 heads under AEASGD:
    within 3e-3 of the center's largest move from the flat flash run, the
    history within 1e-4."""
    params, hist = _flat("AEASGD", "lm", weights["lm"], LM_KW, LM_ROWS,
                         attn_impl="flash")
    move = max(float(np.abs(v - weights["lm"][k]).max())
               for k, v in params.items())
    for r in two["flash"]:
        np.testing.assert_allclose(r["history"], hist, rtol=1e-4)
        _close(r["params"], params, rtol=0, atol=3e-3 * move)


def test_trainer_surface_accepts_parallel_model(two):
    """``AEASGD(model, parallel={"model": 2})`` with ``num_workers``
    inferred (the ranks over tp: 1) trains the MLP to the reference
    test's accuracy."""
    df = RW.blob_columns()
    for r in two["surface"]:
        m = Model.build(MLP(hidden=(16,), num_outputs=3, in_features=8),
                        np.zeros((1, 8), np.float32), device="cpu")
        m = m.with_params({k: torch.as_tensor(v)
                           for k, v in r["params"].items()})
        acc = (m.predict(df["features"]).numpy().argmax(-1)
               == df["label"]).mean()
        assert acc > 0.85, acc
        assert r["worker_histories"].shape == (1, 2 * 512 // 16)


def test_checkpoint_resume_under_tp_async(two):
    """Stopped after round 4 (a save every round), resumed: the center
    equals the uninterrupted run's."""
    for died in two["died"]:
        assert died.get("stopped")
    for clean, resumed in zip(two["lm"], two["resumed"]):
        _close(resumed["params"], clean["params"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            resumed["history"], clean["history"][-len(resumed["history"]):],
            rtol=1e-6)


# -- refusals -----------------------------------------------------------------

def _mlp():
    return Model.build(MLP(hidden=(16,), num_outputs=3, in_features=8),
                       np.zeros((1, 8), np.float32), device="cpu")


def _engine(model, grid, **kw):
    return AsyncTPEngine(model, "sgd", "sparse_categorical_crossentropy",
                         kw.pop("disc", get_discipline("adag")), grid,
                         window=2, **kw)


def test_engine_refusals_keep_the_reference_messages():
    """Every construction-time refusal of the JAX engine, with its
    message (checked before any group forms)."""
    dm = RankMesh(("data", "model"), (2, 2), (0, 1, 2, 3))
    with pytest.raises(ValueError, match="does not multiplex"):
        _engine(_mlp(), dm, workers_per_chip=2)
    with pytest.raises(ValueError, match="needs a 'model' mesh axis"):
        _engine(_mlp(), RankMesh(("data",), (2,), (0, 1)))
    with pytest.raises(ValueError, match="has no 'seq' axis"):
        _engine(RW.build_lm(seq_axis="seq"), dm)
    dsm = RankMesh(("data", "seq", "model"), (1, 2, 2), (0, 1, 2, 3))
    with pytest.raises(ValueError, match="silently ignore"):
        _engine(RW.build_lm(), dsm)
    bn = RW.build_model("bn")
    bn.module.seq_axis = "seq"
    with pytest.raises(ValueError, match="state-syncing"):
        _engine(bn, dsm, disc=get_discipline("ensemble"))


def test_trainer_refusals_keep_the_reference_messages(monkeypatch):
    """Extra axes, too few ranks and a remote parameter server raise as
    in the JAX trainers; the trainers without a submesh variant refuse
    ``parallel=`` with its guidance."""
    df = DataFrame(RW.blob_columns(64))
    with pytest.raises(ValueError, match="supports only"):
        T.ADAG(_mlp(), parallel={"model": 2, "pipe": 2}).train(df)
    with pytest.raises(ValueError, match="available devices"):
        T.ADAG(_mlp(), parallel={"model": 2}).train(df)
    with pytest.raises(ValueError, match="cannot combine"):
        T.ADAG(_mlp(), parallel={"model": 2}, remote="127.0.0.1:1")
    monkeypatch.setenv("DKTPU_PS_ENDPOINT", "127.0.0.1:1")
    with pytest.raises(ValueError, match="cannot combine"):
        T.ADAG(_mlp(), parallel={"model": 2})
    monkeypatch.delenv("DKTPU_PS_ENDPOINT")
    for cls in (T.AveragingTrainer, T.EnsembleTrainer, T.SingleTrainer):
        with pytest.raises(ValueError, match="ParallelTrainer"):
            cls(_mlp(), parallel={"model": 2})
