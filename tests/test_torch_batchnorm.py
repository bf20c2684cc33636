"""Mutable model state through every engine of the port, against the JAX
package (the counterpart of ``tests/test_batchnorm.py``).

The same small BatchNorm MLP in both packages (flax ``nn.BatchNorm`` and
the port's ``models.base.BatchNorm``), its weights converted from the JAX
draw, trains on the same DataFrame: features scaled by 10 and shifted by
5, so the one-pass variance the flax layer uses really differs from a
two-pass one. Compared, within rtol = atol = 1e-5 unless a case says
otherwise: the trained parameters and the running statistics
(``Model.state``), the per-worker loss curves, and the predictions that
inference (the running averages) gives. The resume and the
serialization round trip are bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from torch import nn as tnn

import distkeras_tpu as dk
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models.base import DKModule
from distkeras_tpu.models.base import register_model as jax_register
from distkeras_tpu.netps import PSServer as JaxPSServer
from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.checkpoint import Checkpointer
from distkeras_tpu_torch.convert import (
    params_from_jax,
    params_to_jax,
    state_from_jax,
    state_to_jax,
)
from distkeras_tpu_torch.data import DataFrame, make_batches
from distkeras_tpu_torch.models.base import (
    BatchNorm,
    ConfigMixin,
    Model,
    register_model,
    state_buffers,
)
from distkeras_tpu_torch.netps import PSServer
from distkeras_tpu_torch.runtime.serialization import (
    deserialize_model,
    serialize_model,
)

D, C, HIDDEN = 4, 3, 16
TOL = dict(rtol=1e-5, atol=1e-5)
COMMON = dict(loss="sparse_categorical_crossentropy", batch_size=16,
              num_epoch=2, learning_rate=0.05)


@jax_register
class BNNet(DKModule):
    """flax: Dense, BatchNorm (momentum 0.9), relu, Dense."""

    hidden: int = HIDDEN
    num_outputs: int = C

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = nn.Dense(self.hidden)(x)
        x = nn.BatchNorm(use_running_average=not train, momentum=0.9)(x)
        x = nn.relu(x)
        return nn.Dense(self.num_outputs)(x)


JaxBNNet = BNNet


@register_model
class BNNet(ConfigMixin, tnn.Module):  # noqa: F811 - the port's twin
    """The port's: ``Dense_0``, ``BatchNorm_0``, relu, ``Dense_1``."""

    config_fields = ("hidden", "num_outputs")

    def __init__(self, in_features: int = D, hidden: int = HIDDEN,
                 num_outputs: int = C, seed: int = 0):
        super().__init__()
        self.config = dict(in_features=in_features, hidden=hidden,
                           num_outputs=num_outputs)
        self.Dense_0 = tnn.Linear(in_features, hidden)
        self.BatchNorm_0 = BatchNorm(hidden, momentum=0.9)
        self.Dense_1 = tnn.Linear(hidden, num_outputs)

    @staticmethod
    def input_widths(params):
        return {"in_features": int(params["Dense_0"]["kernel"].shape[0])}

    def forward(self, x):
        return self.Dense_1(torch.relu(self.BatchNorm_0(self.Dense_0(x))))


def blob_columns(n=320, seed=0, scale=10.0, shift=5.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(C, D))
    y = rng.integers(0, C, size=n)
    x = (centers[y] + rng.normal(scale=0.5, size=(n, D))) * scale + shift
    return {"features": x.astype(np.float32), "label": y.astype(np.int32)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(seed=0):
    jm = JaxModel.build(JaxBNNet(num_outputs=C),
                        jnp.zeros((1, D), jnp.float32), seed=seed)
    module = BNNet()
    module.load_state_dict({**params_from_jax(_np(jm.params), module),
                            **state_from_jax(_np(jm.state), module)})
    pm = Model.build(module, np.zeros((1, D), np.float32), device="cpu")
    return jm, pm


def _assert_model_matches(pout, jout, tol=TOL):
    ref = params_from_jax(_np(jout.params), pout.module)
    for k, v in ref.items():
        np.testing.assert_allclose(pout.params[k].numpy(), v.numpy(),
                                   err_msg=k, **tol)
    ref = state_from_jax(_np(jout.state), pout.module)
    got = state_buffers(pout.module, pout.state)
    assert set(got) == {"BatchNorm_0.mean", "BatchNorm_0.var"}
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                   **tol)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_layer_matches_flax(fast, dtype):
    """Train mode (batch statistics, the running averages' update) and
    eval mode against ``flax.linen.BatchNorm`` on features scaled by 10
    and shifted by 5; f32 within 1e-5 relative, bf16 inputs within one
    bf16 ulp of the output."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(32, 6)) * 10 + 5).astype(np.float32)
    scale = rng.normal(size=6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    stats = {"mean": rng.normal(size=6).astype(np.float32),
             "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    flax_bn = nn.BatchNorm(momentum=0.9, use_fast_variance=fast)
    variables = {"params": {"scale": jnp.asarray(scale, jdt),
                            "bias": jnp.asarray(bias, jdt)},
                 "batch_stats": {k: jnp.asarray(v) for k, v in
                                 stats.items()}}
    bn = BatchNorm(6, momentum=0.9, use_fast_variance=fast)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.mean.copy_(torch.from_numpy(stats["mean"]))
        bn.var.copy_(torch.from_numpy(stats["var"]))
    for p in bn.parameters():  # the statistics stay f32, as flax keeps them
        p.data = p.data.to(tdt)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=2 ** -7))
    for train in (True, False):
        out, mut = flax_bn.apply(variables, jnp.asarray(x, jdt),
                                 use_running_average=not train,
                                 mutable=["batch_stats"])
        bn.train(train)
        got = bn(torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().detach().numpy(),
                                   np.asarray(out, np.float32), **tol)
        for k in ("mean", "var"):
            assert getattr(bn, k).dtype == torch.float32
            np.testing.assert_allclose(getattr(bn, k).numpy(),
                                       np.asarray(mut["batch_stats"][k]),
                                       rtol=1e-5, atol=1e-5)
        variables = {**variables, "batch_stats": mut["batch_stats"]}


def test_single_trainer_matches_jax_and_updates_stats():
    cols = blob_columns()
    jm, pm = _pair()
    init = {k: v.clone() for k, v in state_buffers(pm.module,
                                                   pm.state).items()}
    jt = dk.SingleTrainer(jm, **COMMON)
    jout = jt.train(JaxDataFrame(cols))
    pt = T.SingleTrainer(pm, **COMMON)
    pout = pt.train(DataFrame(cols))
    assert pm.state_collections == ("buffers",)
    _assert_model_matches(pout, jout)
    np.testing.assert_allclose(pt.get_history(), jt.get_history(), **TOL)
    got = state_buffers(pout.module, pout.state)
    assert max(float((got[k] - init[k]).abs().max()) for k in init) > 0.1
    # the input model is untouched; inference reads the running statistics
    assert all(torch.equal(state_buffers(pm.module, pm.state)[k], v)
               for k, v in init.items())
    x = cols["features"][:16]
    np.testing.assert_allclose(pout.predict(x).numpy(),
                               np.asarray(jout.predict(jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("name,kw", [
    ("ADAG", dict(communication_window=4)),
    ("DOWNPOUR", dict(communication_window=4)),
    ("AEASGD", dict(communication_window=4, rho=2.0)),
])
def test_async_trainers_average_the_state_as_jax(name, kw):
    """4 workers on 4 of the 8 virtual devices in JAX: each worker's
    statistics from its own slice, their mean on every worker after each
    round, as the port's engine folds them on one device."""
    cols = blob_columns()
    jm, pm = _pair()
    jt = getattr(dk, name)(jm, num_workers=4, **COMMON, **kw)
    jout = jt.train(JaxDataFrame(cols))
    pt = getattr(T, name)(pm, num_workers=4, **COMMON, **kw)
    pout = pt.train(DataFrame(cols))
    _assert_model_matches(pout, jout)
    np.testing.assert_allclose(pt.get_worker_histories(),
                               np.asarray(jt.get_worker_histories()), **TOL)


def test_fold_state_is_the_workers_mean():
    """One round of the port's engine by hand: the statistics after the
    fold are the mean of the four workers' own windows."""
    from distkeras_tpu_torch.parallel import ADAGFold, AsyncEngine
    from distkeras_tpu_torch.workers import derive_seed

    cols = blob_columns(n=4 * 4 * 16)
    _, pm = _pair()
    eng = AsyncEngine(pm, "sgd", COMMON["loss"], ADAGFold(), window=4,
                      num_workers=4, learning_rate=0.05)
    plan = make_batches(DataFrame(cols), "features", "label", 16,
                        num_workers=4, window=4)
    st = eng.init_state()
    xs, ys = (torch.as_tensor(a) for a in plan.round(0))
    new, _ = eng._round_fn(st, xs, ys)
    own = [eng._local_loop(st.center, eng.tx.init(st.center), xs[w], ys[w],
                           rng=derive_seed(st.rng, w),
                           state=st.model_state[w])[2] for w in range(4)]
    for k in own[0]:
        want = torch.stack([o[k] for o in own]).mean(0)
        assert not torch.equal(own[0][k], own[1][k])
        for w in range(4):
            assert torch.equal(new.model_state[w][k], want)


def test_sync_engine_matches_the_jax_one_chip_multiplex():
    """The port's sync engine merges the W workers into one batch a step,
    so its BatchNorm statistics are the merged batch's: the JAX engine's
    one-chip multiplex (``workers_per_chip=W`` on a one-device mesh)."""
    from distkeras_tpu.data.batching import make_batches as jax_batches
    from distkeras_tpu.parallel.sync import SyncEngine as JaxSync
    from distkeras_tpu.runtime.mesh import data_mesh
    from distkeras_tpu_torch.parallel.sync import SyncEngine

    cols = blob_columns()
    jm, pm = _pair()
    W, K = 4, 2
    with pytest.warns(UserWarning, match="merged"):
        jeng = JaxSync(jm, "sgd", COMMON["loss"], data_mesh(num_workers=1),
                       learning_rate=0.05, workers_per_chip=W)
    jplan = jax_batches(JaxDataFrame(cols), "features", "label", 8,
                        num_workers=W, window=K)
    jstate, jl = jeng.run(jplan)
    with pytest.warns(UserWarning, match="merged"):
        peng = SyncEngine(pm, "sgd", COMMON["loss"], num_workers=W,
                          learning_rate=0.05)
    pplan = make_batches(DataFrame(cols), "features", "label", 8,
                         num_workers=W, window=K)
    pstate, pl = peng.run(pplan)
    np.testing.assert_allclose(pl, np.asarray(jl), **TOL)
    jout = jm.with_params(jstate.params).with_state(jstate.model_state)
    pout = pm.with_params(pstate.params).with_state(
        {"buffers": pstate.model_state})
    _assert_model_matches(pout, jout)
    # and the trainer returns the engine's state
    st = T.SynchronousDistributedTrainer(pm, num_workers=W,
                                         steps_per_program=K, **COMMON)
    with pytest.warns(UserWarning, match="merged"):
        trained = st.train(DataFrame(cols))
    assert not torch.equal(trained.state["buffers"]["BatchNorm_0.var"],
                           pm.state["buffers"]["BatchNorm_0.var"])


def test_averaging_and_ensemble_members_state():
    """AveragingTrainer: the members' mean statistics, as the JAX
    package's ``state_reduce``; EnsembleTrainer: every member keeps its
    own statistics (its own init draw and its own data)."""
    cols = blob_columns()
    jm, pm = _pair()
    kw = dict(COMMON, num_workers=4, communication_window=4)
    jout = dk.AveragingTrainer(jm, **kw).train(JaxDataFrame(cols))
    pout = T.AveragingTrainer(pm, **kw).train(DataFrame(cols))
    _assert_model_matches(pout, jout)
    members = T.EnsembleTrainer(pm, **kw).train(DataFrame(cols),
                                                 shuffle=True)
    stats = [torch.cat([v.ravel() for v in m.state["buffers"].values()])
             for m in members]
    assert min(float((stats[0] - s).abs().max()) for s in stats[1:]) > 1e-4
    for m in members:  # each member's statistics go with its own params
        assert m.predict(cols["features"][:8]).isfinite().all()


def test_blob_with_state_both_ways():
    """A blob the JAX package writes with state (format 2) loads in the
    port and predicts the same; the port's blob loads in the JAX package;
    the two packages write the same bytes for the same model."""
    cols = blob_columns(n=160)
    jm, pm = _pair()
    jout = dk.SingleTrainer(jm, **COMMON).train(JaxDataFrame(cols))
    blob = dk.serialize_model(jout)
    back = deserialize_model(blob, device="cpu")
    x = cols["features"][:16]
    np.testing.assert_allclose(back.predict(x).numpy(),
                               np.asarray(jout.predict(jnp.asarray(x))),
                               **TOL)
    # byte for byte on the built pair (a trained JAX tree comes back from
    # jax.tree.map with its keys sorted; a built one in flax's order)
    assert serialize_model(pm) == dk.serialize_model(jm)
    pout = T.SingleTrainer(pm, **COMMON).train(DataFrame(cols))
    jback = dk.deserialize_model(serialize_model(pout))
    np.testing.assert_allclose(np.asarray(jback.predict(jnp.asarray(x))),
                               pout.predict(x).numpy(), **TOL)
    # the port's own round trip is bit-equal
    again = deserialize_model(serialize_model(pout), device="cpu")
    for k, v in pout.module.state_dict().items():
        assert torch.equal(again.module.state_dict()[k], v), k
    assert params_to_jax(pout.params, pout.module).keys() == {
        "Dense_0", "BatchNorm_0", "Dense_1"}
    assert list(state_to_jax(state_buffers(pout.module, pout.state),
                             pout.module)) == ["batch_stats"]


def test_checkpoint_resume_carries_the_state(tmp_path):
    """4 epochs straight vs 2 epochs + checkpoint + resume: bit-equal
    params and statistics."""
    cols = blob_columns()
    kw = dict(COMMON, num_workers=4, communication_window=4)
    _, pm = _pair()
    full = T.ADAG(pm, **{**kw, "num_epoch": 4}).train(DataFrame(cols))
    ck = str(tmp_path / "ck")
    T.ADAG(pm, **kw, checkpoint_dir=ck, checkpoint_every=1).train(
        DataFrame(cols))
    assert Checkpointer(ck).latest_step() is not None
    resumed = T.ADAG(pm, **{**kw, "num_epoch": 4}, checkpoint_dir=ck,
                     checkpoint_every=1, resume=True).train(DataFrame(cols))
    for k, v in full.module.state_dict().items():
        assert torch.equal(resumed.module.state_dict()[k], v), k


def test_remote_keeps_per_worker_state_unsynced(monkeypatch):
    """``remote=``: the worker threads its own statistics through its
    windows (they shape its commits) and the server never sees them; the
    trained model keeps the model's own state, as the JAX package's loop
    does. One worker, so the commit order is fixed."""
    cols = blob_columns(n=160)
    jm, pm = _pair()
    kw = dict(COMMON, num_workers=1, communication_window=2, num_epoch=1)
    jsrv = JaxPSServer(discipline="adag").start()
    tsrv = PSServer(discipline="adag", device="cpu").start()
    try:
        jout = dk.ADAG(jm, **kw, remote=jsrv.endpoint).train(
            JaxDataFrame(cols))
        pout = T.ADAG(pm, **kw, remote=tsrv.endpoint).train(DataFrame(cols))
    finally:
        jsrv.close()
        tsrv.close()
    _assert_model_matches(pout, jout)
    for k, v in state_buffers(pm.module, pm.state).items():
        assert torch.equal(pout.state["buffers"][k], v)


def test_model_state_with_state_and_apply_with_state():
    """``Model.state`` is the buffers' view; ``with_state`` puts a state
    into a copy of the module; ``apply(..., state=)`` reads another state
    in inference mode without touching the module's own, as the JAX
    ``Model.apply(params, x, state=...)`` does."""
    cols = blob_columns(n=160)
    jm, pm = _pair()
    trained = T.SingleTrainer(pm, **COMMON).train(DataFrame(cols))
    x = cols["features"][:8]
    before = {k: v.clone() for k, v in pm.state["buffers"].items()}
    got = pm.apply(x, state=trained.state)
    want = pm.with_state(trained.state).predict(x)
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
    assert all(torch.equal(pm.state["buffers"][k], v)
               for k, v in before.items())
    assert not pm.module.training
    ref = np.asarray(jm.apply(jm.params, jnp.asarray(x), state={
        "batch_stats": {"BatchNorm_0": {
            k: jnp.asarray(v.numpy()) for k, v in (
                ("mean", trained.state["buffers"]["BatchNorm_0.mean"]),
                ("var", trained.state["buffers"]["BatchNorm_0.var"]))}}}))
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)
    with pytest.raises(KeyError, match="buffers"):
        pm.with_state({"buffers": {"nope": torch.zeros(1)}})


def test_elastic_resume_averages_the_workers_state():
    """``adopt_state`` (a checkpoint resumed at another worker count)
    gives every worker the mean of the saved workers' statistics, as the
    JAX engine's ``adopt_state`` does; the predictors read the running
    statistics."""
    from distkeras_tpu_torch import ModelPredictor
    from distkeras_tpu_torch.parallel import ADAGFold, AsyncEngine

    _, pm = _pair()
    eng = AsyncEngine(pm, "sgd", COMMON["loss"], ADAGFold(), window=2,
                      num_workers=2, learning_rate=0.05)
    host = eng.host_state(3)
    rng = np.random.default_rng(5)
    saved = [{k: torch.from_numpy(rng.normal(size=v.shape).astype(
        np.float32)) for k, v in pm.state["buffers"].items()}
        for _ in range(3)]
    center = {k: v.clone() for k, v in pm.params.items()}
    host = host._replace(center=center, model_state=saved,
                         locals_=[center] * 3)
    st = eng.adopt_state(host)
    assert len(st.model_state) == 2
    for k in saved[0]:
        want = torch.stack([s[k] for s in saved]).mean(0)
        for w in range(2):
            torch.testing.assert_close(st.model_state[w][k], want,
                                       rtol=0, atol=0)
    cols = blob_columns(n=128)
    trained = T.SingleTrainer(pm, **COMMON).train(DataFrame(cols))
    out = ModelPredictor(trained, output_col="p").predict(DataFrame(cols))
    np.testing.assert_allclose(np.asarray(out["p"])[:8],
                               trained.predict(cols["features"][:8]).numpy(),
                               rtol=1e-6, atol=1e-6)
