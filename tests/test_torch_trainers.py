"""The training slice as a whole: the port's discipline trainers
(``distkeras_tpu_torch/trainers.py``) against the same trainers in the JAX
package, through ``.train(df)`` on the same DataFrame from the same
weights. The JAX model runs ``cell_impl="pallas"``, its Pallas LSTM kernels
in interpret mode inside the engine's ``shard_map`` on the CPU (4 workers
on 4 of the 8 virtual devices); the port runs its plain twins on the CPU.
Compared: ``get_worker_histories()`` ([W, rounds]) and the final center,
within rtol = atol = 1e-5 (f32; sums in another order, including the fold's
psum against the port's in-order sum). Also the kwargs the port refuses
and the engine's NaN round skip."""

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
from distkeras_tpu_torch import imdb_lstm
from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.data import DataFrame, make_batches
from distkeras_tpu_torch.ops.kernels import lstm as K
from distkeras_tpu_torch.parallel import AsyncEngine, DynSGDFold

SMALL = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)
W, K_STEPS, B, ROUNDS = 4, 2, 5, 3
KW = dict(worker_optimizer="sgd", loss="sparse_categorical_crossentropy",
          num_workers=W, batch_size=B, communication_window=K_STEPS,
          learning_rate=0.1)


def _columns(rounds=ROUNDS, seed=0):
    rng = np.random.default_rng(seed)
    n = W * K_STEPS * B * rounds
    return {"features": rng.integers(0, 50, (n, 6)).astype(np.int32),
            "label": rng.integers(0, 2, n).astype(np.int32)}


def _port_model(jm):
    pm = imdb_lstm(**SMALL, device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return pm


@pytest.mark.parametrize("name", ["DynSGD", "ADAG", "DOWNPOUR", "AEASGD",
                                  "EAMSGD"])
def test_trainer_matches_jax(name):
    cols = _columns()
    jm = jax_imdb_lstm(**SMALL, cell_impl="pallas", seed=1)
    pm = _port_model(jm)
    jt = getattr(dk, name)(jm, **KW)
    jout = jt.train(JaxDataFrame(cols))
    pt = getattr(T, name)(pm, **KW)
    before = K.launch_counts()
    pout = pt.train(DataFrame(cols))
    assert K.launch_counts() == before  # CPU: the plain twins
    assert pt.get_worker_histories().shape == (W, ROUNDS)
    assert pt.get_history().shape == (ROUNDS,)
    np.testing.assert_allclose(pt.get_worker_histories(),
                               np.asarray(jt.get_worker_histories()),
                               rtol=1e-5, atol=1e-5)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jout.params),
                          pm.module)
    got = pout.module.state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert pout.device == pm.device and not pout.module.training
    assert not torch.equal(got["lstm_wx"], pm.module.lstm_wx.detach())


def test_on_round_and_rounds_per_program():
    seen = []
    pm = imdb_lstm(**SMALL, device="cpu")
    t = T.DynSGD(pm, **KW, rounds_per_program="auto",
                 on_round=lambda r, loss: seen.append((r, loss.shape)))
    t.train(DataFrame(_columns()))
    assert seen == [(r, (W,)) for r in range(ROUNDS)]
    assert t.get_training_time() > 0
    with pytest.raises(ValueError, match="rounds_per_program"):
        T.DynSGD(pm, **KW, rounds_per_program=0)


@pytest.mark.parametrize("kwargs,match", [
    # remote= itself is ported, a sharded endpoint matrix included
    # (tests/test_torch_remote.py, tests/test_torch_netps_shards.py);
    # parallel= too (tests/test_torch_async_tp.py), here short of ranks.
    ({"parallel": {"model": 2}}, "parallel"),
    # The in-process engine resets divergent workers; the remote loop has
    # no reset, as the reference's has none.
    ({"divergence_reset": 1.0, "remote": "127.0.0.1:1"}, "divergence_reset"),
    # In process device_transform is ported (tests/test_torch_augment.py);
    # the remote loop refuses it, as the reference's drops it unapplied.
    ({"device_transform": lambda gen, x, y: (x, y), "remote": "127.0.0.1:1"},
     "input_transform"),
])
def test_unported_kwargs_raise(kwargs, match):
    """``parallel={"model": 2}`` is ported: in one process it needs two
    ranks and raises the JAX package's ``ValueError``."""
    pm = imdb_lstm(**SMALL, device="cpu")
    exc = ValueError if "parallel" in kwargs else NotImplementedError
    with pytest.raises(exc, match=match):
        T.DynSGD(pm, **KW, **kwargs).train(DataFrame(_columns()))


def test_ps_endpoint_env_and_unknown_kwargs_raise(monkeypatch):
    """Unknown kwargs raise; ``DKTPU_PS_ENDPOINT`` routes to the remote
    loop, and a ``;`` matrix there into the sharded client: every shard
    folds each of the W workers' commits once a round, and the model is
    the assembled center."""
    from distkeras_tpu_torch.netps import ShardSet
    from distkeras_tpu_torch.netps.shards import client as shard_client

    pm = imdb_lstm(**SMALL, device="cpu")
    with pytest.raises(TypeError, match="unexpected kwargs"):
        T.DynSGD(pm, **KW, bogus=1)
    made = []
    real = shard_client.ShardedPSClient.__init__

    def recording(self, endpoint, *a, **kw):
        made.append(endpoint)
        real(self, endpoint, *a, **kw)

    monkeypatch.setattr(shard_client.ShardedPSClient, "__init__", recording)
    with ShardSet(2, discipline="dynsgd", device="cpu") as ss:
        monkeypatch.setenv("DKTPU_PS_ENDPOINT", ss.endpoint)
        out = T.DynSGD(pm, **KW).train(DataFrame(_columns()))
        for srv in ss.servers:
            assert sorted((w, s) for w, s, _ in srv.commit_log) == sorted(
                (w, s) for w in range(W) for s in range(ROUNDS))
        center = ss.center()
    assert made and set(made) == {ss.endpoint}
    for p, c in zip(out.params.values(), center):
        np.testing.assert_array_equal(p.numpy(), c)


def test_float32_compute_dtype_is_the_default_path():
    cols = _columns()
    pm = imdb_lstm(**SMALL, device="cpu")
    a = T.ADAG(pm, **KW).train(DataFrame(cols))
    b = T.ADAG(pm, **KW, compute_dtype="float32").train(DataFrame(cols))
    for k, v in a.params.items():
        torch.testing.assert_close(b.params[k], v, rtol=0, atol=0)


def test_nan_round_is_skipped_and_kept_in_the_history():
    """A non-finite worker loss discards the whole round: the center and
    the fold counter stay as they were, and the NaN stays in the history."""
    pm = imdb_lstm(**SMALL, device="cpu")

    def loss(out, y):
        base = torch.nn.functional.cross_entropy(out, y.long())
        return base * float("nan") if (y == 0).all() else base

    cols = _columns()
    cols["label"][W * K_STEPS * B:W * K_STEPS * B + K_STEPS * B] = 0
    engine = AsyncEngine(pm, "sgd", loss, DynSGDFold(), window=K_STEPS,
                         num_workers=W, learning_rate=0.1)
    plan = make_batches(DataFrame(cols), "features", "label", B, W,
                        window=K_STEPS)
    state0 = engine.init_state()
    st1, _ = engine._round_fn(state0, *engine._put_batch(*plan.round(0)))
    st2, loss2 = engine._round_fn(st1, *engine._put_batch(*plan.round(1)))
    assert not np.isfinite(loss2.numpy()).all()
    assert st2.fold_state == st1.fold_state == 1
    for k, v in st1.center.items():
        assert torch.equal(st2.center[k], v)
    _, hist = engine.run(plan)
    assert hist.shape == (ROUNDS, W) and not np.isfinite(hist[1]).all()
