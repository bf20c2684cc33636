"""The synchronous path as a whole: the port's ``SingleTrainer`` and
``SynchronousDistributedTrainer`` (``parallel/sync.py SyncEngine``) against
the same trainers in the JAX package, through ``.train(df)`` on the same
DataFrame from the same weights, on ``tiny_resnet``-shaped models. The JAX
model runs ``norm_impl="pallas"``, its Pallas GroupNorm in interpret mode
inside the engine's ``shard_map`` (2 workers on 2 of the 8 virtual
devices, the gradient ``pmean``'d each step); the port merges the 2
workers into one batch and runs the plain twins on the CPU. Compared:
``get_history()`` and the final params, within rtol = atol = 1e-5 (f32;
the pmean and the merged batch sum in another order). Also the engine's
NaN round skip and the histories a sync trainer does not have."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.resnet import ResNet as JaxResNet
from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.data import DataFrame, make_batches
from distkeras_tpu_torch.datasets import cifar10
from distkeras_tpu_torch.models import Model, resnet
from distkeras_tpu_torch.ops.kernels import groupnorm as G
from distkeras_tpu_torch.parallel import SyncEngine

TINY = dict(stage_sizes=(1, 1), base_features=8, num_outputs=10,
            stem_kernel=3, groups=4)
K_STEPS, B, ROUNDS = 2, 4, 2
KW = dict(worker_optimizer="sgd", loss="sparse_categorical_crossentropy",
          batch_size=B, steps_per_program=K_STEPS, learning_rate=0.1)


def _columns(workers, seed=0):
    rng = np.random.default_rng(seed)
    n = workers * K_STEPS * B * ROUNDS
    return {"features": rng.uniform(size=(n, 32, 32, 3)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}


def _models(seed=1):
    jm = JaxModel.build(JaxResNet(**TINY, norm_impl="pallas"),
                        jnp.zeros((1, 32, 32, 3), jnp.float32), seed=seed)
    pm = resnet.tiny_resnet(norm_impl="pallas", device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return jm, pm


@pytest.mark.parametrize("name,workers", [
    ("SingleTrainer", 1), ("SynchronousDistributedTrainer", 2)])
def test_sync_trainer_matches_jax(name, workers):
    cols = _columns(workers)
    jm, pm = _models()
    kw = dict(KW, num_workers=workers) if workers > 1 else KW
    jt = getattr(dk, name)(jm, **kw)
    jout = jt.train(JaxDataFrame(cols))
    pt = getattr(T, name)(pm, **kw)
    before = G.launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the W > 1 merge warning
        pout = pt.train(DataFrame(cols))
    assert G.launch_counts() == before  # CPU: the plain twins
    assert pt.get_worker_histories() is None
    assert jt.get_worker_histories() is None
    assert pt.get_history().shape == (ROUNDS,)
    np.testing.assert_allclose(pt.get_history(),
                               np.asarray(jt.get_history()),
                               rtol=1e-5, atol=1e-5)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jout.params),
                          pm.module)
    got = pout.module.state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert pout.device == pm.device and not pout.module.training
    assert not torch.equal(got["Conv_0.weight"],
                           pm.module.Conv_0.weight.detach())


def test_merging_workers_warns_and_num_workers_none_is_one():
    pm = resnet.tiny_resnet(device="cpu")
    with pytest.warns(UserWarning, match="merged"):
        SyncEngine(pm, "sgd", "sparse_categorical_crossentropy",
                   num_workers=2)
    t = T.SynchronousDistributedTrainer(pm, **KW)
    t.train(cifar10(n=K_STEPS * B * ROUNDS))
    assert t.num_workers is None and t.get_history().shape == (ROUNDS,)


def test_nan_round_is_skipped_and_kept_in_the_history():
    """A non-finite step loss discards the whole round: the params and the
    optimizer state stay as they were, and the NaN stays in the history."""
    pm = resnet.tiny_resnet(device="cpu")

    def loss(out, y):
        base = torch.nn.functional.cross_entropy(out, y.long())
        return base * float("nan") if (y == 0).all() else base

    cols = _columns(1)
    cols["label"][K_STEPS * B:K_STEPS * B + B] = 0  # round 1, step 0
    engine = SyncEngine(pm, "momentum", loss, learning_rate=0.1)
    plan = make_batches(DataFrame(cols), "features", "label", B, 1,
                        window=K_STEPS)
    st0 = engine.init_state()
    st1, _ = engine._round_fn(st0, *engine._put_batch(*plan.round(0)))
    st2, loss2 = engine._round_fn(st1, *engine._put_batch(*plan.round(1)))
    assert not np.isfinite(loss2.item())
    for k, v in st1.params.items():
        assert torch.equal(st2.params[k], v)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: torch.equal(a, b), st2.opt_state, st1.opt_state))
    assert st2.rng != st1.rng
    _, hist = engine.run(plan)
    assert hist.shape == (ROUNDS,) and not np.isfinite(hist[1])


@pytest.mark.parametrize("kwargs,match", [
    ({"parallel": {"model": 2}}, "parallel"),
])
def test_unported_kwargs_raise(kwargs, match):
    """``parallel=`` is the async and parallel trainers' option: the sync
    trainers refuse it with the JAX package's ``ValueError``."""
    pm = resnet.tiny_resnet(device="cpu")
    for cls in (T.SingleTrainer, T.SynchronousDistributedTrainer):
        with pytest.raises(ValueError, match=match):
            cls(pm, **KW, **kwargs).train(DataFrame(_columns(1)))
