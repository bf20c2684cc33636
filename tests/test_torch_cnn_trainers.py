"""BASELINE configs #1-#3's trainers on the port's MLP and CNN against the
JAX package's, through ``.train(df, shuffle=True)`` on the same DataFrame
(features in an ``"img"`` column, as ``examples/mnist_workflow.py`` names
it) from the same weights: ``SingleTrainer`` on the MLP with adam, ``ADAG``
on the CNN with adam and ``AEASGD`` on the CNN with sgd and ``rho``, the
discipline trainers with 8 workers (the JAX ones on the 8 virtual
devices). The CNN is cut to ``conv_features=(8, 16)``, ``dense=(16,)``
on 28x28x1 images and the MLP to ``hidden=(32, 32)`` to keep the CPU time
small.

f32: ``get_worker_histories()`` (``get_history()`` for the single
trainer) and the final center within rtol = atol = 1e-5, as
``tests/test_torch_trainers.py`` holds the LSTM. ``ADAG(remote=...)``
against the port's parameter server (one worker, so commit order is
fixed) is held to the JAX trainer against the JAX server as
``tests/test_torch_remote.py`` holds the LSTM: within 1e-5 with codec
``none``, and within 1e-5 plus the sum of each commit's largest
quantization step with ``int8``.

bf16 (``compute_dtype="bfloat16"``), by the rule of
``tests/test_torch_precision.py``: AEASGD on the CNN, the center's mean
difference from the JAX trainer at bf16 within 0.6 of the JAX trainer's
own bf16-vs-f32 distance (measured 0.11 and 0.19 at two data seeds) and
the history within 1.5 of it (measured 0.83 and 0.39). An f32 step would
sit at about 1.0 on the center.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.cnn import SimpleCNN as JaxCNN
from distkeras_tpu.models.mlp import MLP as JaxMLP
from distkeras_tpu.netps import PSServer as JaxPSServer
from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.data import DataFrame
from distkeras_tpu_torch.models import MLP, Model, SimpleCNN
from distkeras_tpu_torch.netps import PSServer
from distkeras_tpu_torch.netps import server as server_mod
from distkeras_tpu_torch.netps.fold import commit_scale
from distkeras_tpu_torch.ops.kernels import flash_attention as FA
from distkeras_tpu_torch.ops.kernels import fold as F
from distkeras_tpu_torch.ops.kernels import groupnorm as G
from distkeras_tpu_torch.ops.kernels import lstm as K

CNN = dict(conv_features=(8, 16), dense=(16,), num_outputs=10)
MLP_CFG = dict(hidden=(32, 32), num_outputs=10)
IMAGE, FLAT = (28, 28, 1), (784,)
LOSS = "sparse_categorical_crossentropy"
CASES = {
    "SingleTrainer": ("mlp", dict(worker_optimizer="adam", batch_size=8,
                                  steps_per_program=2, learning_rate=1e-3),
                      3),
    "ADAG": ("cnn", dict(worker_optimizer="adam", num_workers=8,
                         batch_size=4, communication_window=2,
                         learning_rate=1e-3), 2),
    "AEASGD": ("cnn", dict(worker_optimizer="sgd", num_workers=8,
                           batch_size=4, communication_window=2,
                           learning_rate=0.05, rho=3.0), 2),
}


def _jax_model(kind):
    if kind == "cnn":
        return JaxModel.build(JaxCNN(**CNN),
                              jnp.zeros((1,) + IMAGE, jnp.float32), seed=1)
    return JaxModel.build(JaxMLP(**MLP_CFG), jnp.zeros((1,) + FLAT,
                                                       jnp.float32), seed=1)


def _port_model(kind, jm):
    if kind == "cnn":
        pm = Model.build(SimpleCNN(**CNN, input_shape=IMAGE),
                         np.zeros((1,) + IMAGE, np.float32), device="cpu")
    else:
        pm = Model.build(MLP(**MLP_CFG), np.zeros((1,) + FLAT, np.float32),
                         device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return pm


def _columns(kind, kw, rounds, seed=0):
    n = kw.get("num_workers", 1) * 2 * kw["batch_size"] * rounds
    rng = np.random.default_rng(seed)
    shape = IMAGE if kind == "cnn" else FLAT
    return {"img": rng.uniform(size=(n,) + shape).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}


def _launches():
    return (K.launch_counts(), G.launch_counts(), FA.launch_counts(),
            F.launch_counts())


def _histories(t):
    h = t.get_worker_histories()
    return np.asarray(t.get_history() if h is None else h)


@pytest.mark.parametrize("name", sorted(CASES))
def test_trainer_matches_jax(name):
    kind, kw, rounds = CASES[name]
    cols = _columns(kind, kw, rounds)
    jm = _jax_model(kind)
    pm = _port_model(kind, jm)
    common = dict(loss=LOSS, features_col="img", label_col="label")
    jt = getattr(dk, name)(jm, **kw, **common)
    jout = jt.train(JaxDataFrame(cols), shuffle=True)
    pt = getattr(T, name)(pm, **kw, **common)
    before = _launches()
    pout = pt.train(DataFrame(cols), shuffle=True)
    assert _launches() == before  # no kernel on this path; the CPU anyway
    W = kw.get("num_workers")
    if W:
        assert pt.get_worker_histories().shape == (W, rounds)
    else:
        assert pt.get_worker_histories() is None
    np.testing.assert_allclose(_histories(pt), _histories(jt), rtol=1e-5,
                               atol=1e-5)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jout.params),
                          pm.module)
    got = pout.module.state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert any(not torch.equal(got[k], v)
               for k, v in pm.module.state_dict().items())
    assert pout.device == pm.device and not pout.module.training


def test_aeasgd_cnn_four_rounds_match_jax_in_float64():
    """Four AEASGD rounds of the same case. Here the JAX trainer's f32
    center lies 2.7e-5 from the same run in float64 (a pre-activation
    within f32 rounding of a ReLU or pooling edge, its gradient taken on
    the other side), past the 1e-5 limit, while the port's f32 center stays
    within 1e-7 of its own float64 run. So the case is held in float64:
    the port (``module.double()``, float64 images) against the JAX trainer
    under ``jax.enable_x64`` (float64 parameters and images) within rtol = atol
    = 1e-5 (measured 3e-8), and the port's f32 center against its float64
    one within 1e-5."""
    kind, kw, _ = CASES["AEASGD"]
    cols = _columns(kind, kw, rounds=4)
    cols64 = dict(cols, img=cols["img"].astype(np.float64))
    jm = _jax_model(kind)
    with jax.enable_x64(True):
        jm64 = jm.with_params(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), jm.params))
        jout = dk.AEASGD(jm64, **kw, loss=LOSS, features_col="img").train(
            JaxDataFrame(cols64), shuffle=True)
        tree = jax.tree_util.tree_map(np.asarray, jout.params)
    outs = {}
    for dtype, frame in (("f32", cols), ("f64", cols64)):
        pm = _port_model(kind, jm)
        if dtype == "f64":
            pm.module.double()
        trained = T.AEASGD(pm, **kw, loss=LOSS, features_col="img").train(
            DataFrame(frame), shuffle=True)
        outs[dtype] = {k: v.double() for k, v in
                       trained.module.state_dict().items()}
    # carried across in f32 (within 1e-8 of the f64 values here), then
    # held at 1e-5
    ref = params_from_jax(tree, pm.module)
    for k, v in ref.items():
        np.testing.assert_allclose(outs["f64"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(outs["f32"][k].numpy(),
                                   outs["f64"][k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def _center_mean(a: dict, b: dict) -> float:
    d = [(a[k].double() - b[k].double()).abs() for k in b]
    return (sum(x.sum() for x in d) / sum(x.numel() for x in d)).item()


def test_aeasgd_cnn_bf16_matches_jax():
    kind, kw, rounds = CASES["AEASGD"]
    cols = _columns(kind, kw, rounds)
    common = dict(loss=LOSS, features_col="img")
    refs, hists = {}, {}
    for dtype in ("bfloat16", None):
        jm = _jax_model(kind)
        jt = dk.AEASGD(jm, **kw, **common, compute_dtype=dtype)
        out = jt.train(JaxDataFrame(cols), shuffle=True)
        pm = _port_model(kind, jm)
        refs[dtype] = params_from_jax(
            jax.tree_util.tree_map(np.asarray, out.params), pm.module)
        hists[dtype] = np.asarray(jt.get_history(), np.float64)
    pt = T.AEASGD(pm, **kw, **common, compute_dtype="bfloat16")
    pout = pt.train(DataFrame(cols), shuffle=True)
    assert all(v.dtype == torch.float32 for v in pout.params.values())
    c = _center_mean(pout.module.state_dict(), refs["bfloat16"])
    c_ref = _center_mean(refs["bfloat16"], refs[None])
    h = np.abs(pt.get_history() - hists["bfloat16"]).max()
    h_ref = np.abs(hists["bfloat16"] - hists[None]).max()
    assert 0 < c <= 0.6 * c_ref, (c, c_ref)
    assert h <= 1.5 * h_ref, (h, h_ref)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_remote_adag_cnn_matches_jax(monkeypatch, codec):
    """``ADAG(cnn, "adam", remote=...)``, 1 worker, 3 rounds: the commit is
    the CNN's 8 tensors; the model returned is the server's center."""
    monkeypatch.setenv("DKTPU_NET_COMPRESS", codec)
    steps = []
    real = server_mod.fold_delta

    def recording(center, delta, discipline, staleness):
        rows = delta.rows
        steps.append(max((float(f) * commit_scale(
            discipline, staleness) for f in
            rows["factor"][rows["kind"] == F.KIND_INT8]), default=0.0))
        return real(center, delta, discipline, staleness)

    monkeypatch.setattr(server_mod, "fold_delta", recording)
    kind, kw, _ = CASES["ADAG"]
    kw = dict(kw, num_workers=1)
    cols = _columns(kind, kw, rounds=3)
    jm = _jax_model(kind)
    pm = _port_model(kind, jm)
    common = dict(loss=LOSS, features_col="img")
    jsrv = JaxPSServer(discipline="adag").start()
    tsrv = PSServer(discipline="adag", device="cpu").start()
    try:
        jt = dk.ADAG(jm, **kw, **common, remote=jsrv.endpoint)
        jout = jt.train(JaxDataFrame(cols), shuffle=True)
        pt = T.ADAG(pm, **kw, **common, remote=tsrv.endpoint)
        before = _launches()
        pout = pt.train(DataFrame(cols), shuffle=True)
        assert _launches() == before  # CPU: the fold's plain twin
        assert len(tsrv.commit_log) == len(jsrv.commit_log) == 3
        center = tsrv.center()
    finally:
        jsrv.close()
        tsrv.close()
    assert len(center) == 8
    bound = 1e-5 + (sum(steps) if codec == "int8" else 0.0)
    assert (codec == "int8") == (len(steps) == 3 and min(steps) > 0)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jout.params),
                          pm.module)
    got = pout.module.state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=bound, err_msg=k)
    np.testing.assert_allclose(pt.get_worker_histories(),
                               np.asarray(jt.get_worker_histories()),
                               rtol=1e-5, atol=bound)
    for p, c in zip(pout.params.values(), center):
        np.testing.assert_array_equal(p.numpy(), c)
