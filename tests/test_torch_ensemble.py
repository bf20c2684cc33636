"""The reference's ``AveragingTrainer`` and ``EnsembleTrainer`` in the port
against the JAX package's, and the port's own ``Model.reinit_params``.

``AveragingTrainer``: the replicas share one init and train alone (the
no-communication fold); the model returned is their mean. Held to the JAX
trainer from the same weights on the same DataFrame within rtol = atol =
1e-5 (f32 sums in another order, as ``tests/test_torch_trainers.py``), with
8 workers on a narrow MLP and 4 on the MNIST CNN cut to
``conv_features=(8, 16)``, ``dense=(16,)`` (its widths as
``tests/test_torch_cnn_trainers.py`` cuts them, for CPU time).

``EnsembleTrainer``: worker ``i`` starts from its own draw
``reinit_params(seed * 1009 + 1 + i)``. JAX's PRNG cannot be replayed in
torch, so the port's ``reinit_params`` is monkeypatched to return the JAX
model's draw (converted); each member is then held to its JAX member
within 1e-5. The port's own draws are held apart: the same seed gives the
same bits, another seed another draw, each leaf of 4096 elements or more
has the spread of the JAX draw's within 5 %, and the bias leaves are the
JAX draw's constants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.cnn import SimpleCNN as JaxCNN
from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
from distkeras_tpu.models.mlp import MLP as JaxMLP
from distkeras_tpu_torch import AveragingTrainer, DataFrame, EnsembleTrainer
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.models import MLP, Model, SimpleCNN, imdb_lstm

CNN = dict(conv_features=(8, 16), dense=(16,), num_outputs=10)
IMAGE = (28, 28, 1)
MLP_CFG = dict(hidden=(16,), num_outputs=3)
LOSS = "sparse_categorical_crossentropy"
CASES = {
    "mlp8": ("mlp", dict(num_workers=8, batch_size=8,
                         communication_window=2, learning_rate=0.1,
                         num_epoch=2)),
    "cnn4": ("cnn", dict(num_workers=4, batch_size=4,
                         communication_window=2, learning_rate=0.05)),
}


def _jax_model(kind):
    if kind == "cnn":
        return JaxModel.build(JaxCNN(**CNN),
                              jnp.zeros((1,) + IMAGE, jnp.float32), seed=1)
    return JaxModel.build(JaxMLP(**MLP_CFG), jnp.zeros((1, 4), jnp.float32),
                          seed=1)


def _to_port(jm, module):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                           module)


def _port_model(kind, jm):
    if kind == "cnn":
        module = SimpleCNN(**CNN, input_shape=IMAGE)
        sample = np.zeros((1,) + IMAGE, np.float32)
    else:
        module = MLP(**MLP_CFG, in_features=4)
        sample = np.zeros((1, 4), np.float32)
    module.load_state_dict(_to_port(jm, module))
    return Model.build(module, sample, device="cpu")


def _columns(kind, rows):
    rng = np.random.default_rng(3)
    if kind == "cnn":
        return {"features": rng.random((rows,) + IMAGE).astype(np.float32),
                "label": rng.integers(0, 10, rows).astype(np.int32)}
    centers = rng.normal(scale=3.0, size=(3, 4))
    y = rng.integers(0, 3, rows)
    x = centers[y] + rng.normal(scale=0.5, size=(rows, 4))
    return {"features": x.astype(np.float32), "label": y.astype(np.int32)}


def _rows(kw):
    return kw["num_workers"] * kw["batch_size"] * kw["communication_window"] \
        * 2


def _close(port_params, want, what):
    for k, v in want.items():
        np.testing.assert_allclose(port_params[k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_averaging_trainer_matches_jax(case):
    kind, kw = CASES[case]
    cols = _columns(kind, _rows(kw))
    jm = _jax_model(kind)
    pm = _port_model(kind, jm)
    jt = dk.AveragingTrainer(jm, loss=LOSS, **kw)
    javg = jt.train(dk.DataFrame(cols), shuffle=True)
    pt = AveragingTrainer(pm, loss=LOSS, **kw)
    pavg = pt.train(DataFrame(cols), shuffle=True)
    _close(pavg.params, _to_port(javg, pavg.module), "averaged")
    np.testing.assert_allclose(pt.get_worker_histories(),
                               jt.get_worker_histories(), rtol=1e-5,
                               atol=1e-5)
    # the replicas trained apart: their mean moved off the shared init
    assert any(not torch.equal(pavg.params[k], v)
               for k, v in pm.params.items())


@pytest.mark.parametrize("case", list(CASES))
def test_ensemble_trainer_matches_jax_member_by_member(case, monkeypatch):
    kind, kw = CASES[case]
    cols = _columns(kind, _rows(kw))
    jm = _jax_model(kind)
    pm = _port_model(kind, jm)
    seeds = []

    def jax_draw(self, seed):
        seeds.append(seed)
        return _to_port(jm.with_params(jm.reinit_params(seed)), self.module)

    monkeypatch.setattr(Model, "reinit_params", jax_draw)
    jmembers = dk.EnsembleTrainer(jm, loss=LOSS, seed=5, **kw).train(
        dk.DataFrame(cols), shuffle=True)
    pt = EnsembleTrainer(pm, loss=LOSS, seed=5, **kw)
    members = pt.train(DataFrame(cols), shuffle=True)
    W = kw["num_workers"]
    assert seeds == [5 * 1009 + 1 + i for i in range(W)]
    assert len(members) == len(jmembers) == W
    for i, (m, j) in enumerate(zip(members, jmembers)):
        _close(m.params, _to_port(j, m.module), f"member {i}")
    # the members differ pairwise (their draws and data differ)
    for i in range(W):
        for j in range(i + 1, W):
            assert any(not torch.equal(members[i].params[k],
                                       members[j].params[k])
                       for k in members[i].params)


@pytest.mark.parametrize("kind", ["cnn", "lstm"])
def test_port_reinit_params_draws(kind):
    if kind == "cnn":
        jm = JaxModel.build(JaxCNN(conv_features=(32, 64), dense=(128,),
                                   num_outputs=10),
                            jnp.zeros((1,) + IMAGE, jnp.float32), seed=0)
        pm = Model.build(SimpleCNN(input_shape=IMAGE),
                         np.zeros((1,) + IMAGE, np.float32), device="cpu")
    else:
        small = dict(vocab_size=500, embed_dim=32, hidden_size=64,
                     seq_len=8)
        jm = jax_imdb_lstm(**small)
        pm = imdb_lstm(**small, device="cpu")
    a, b, c = pm.reinit_params(7), pm.reinit_params(7), pm.reinit_params(8)
    assert set(a) == set(pm.params)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert a[k].shape == pm.params[k].shape
    assert any(not torch.equal(a[k], c[k]) for k in a)
    jdraw = _to_port(jm.with_params(jm.reinit_params(7)), pm.module)
    checked = 0
    for k, v in a.items():
        ref = jdraw[k]
        if float(ref.std()) == 0.0:  # a constant leaf (biases)
            assert torch.equal(v, ref), k
        elif v.numel() >= 4096:
            ratio = float(v.std()) / float(ref.std())
            assert abs(ratio - 1.0) < 0.05, (k, ratio)
            checked += 1
    assert checked >= 2


def test_reinit_params_without_a_sample_spec_permutes():
    """A deserialized model (no ``sample_spec``) falls back to a seeded
    permutation of each float tensor: the same values, another order."""
    pm = imdb_lstm(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6,
                   device="cpu")
    bare = Model(pm.module, pm.device, None)
    a, b = bare.reinit_params(3), bare.reinit_params(3)
    for k, v in pm.params.items():
        assert torch.equal(a[k], b[k])
        assert torch.equal(a[k].flatten().sort().values,
                           v.flatten().sort().values)
    assert any(not torch.equal(a[k], v) for k, v in pm.params.items()
               if v.numel() > 1 and float(v.std()) > 0)
