"""The port's loss set and optimizer rules (``distkeras_tpu_torch/ops/``)
against the JAX package's ``get_loss`` and ``get_optimizer`` (optax) on the
same numpy inputs. f32; tolerances per test."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.ops.losses import get_loss as jax_get_loss
from distkeras_tpu.ops.optimizers import get_optimizer as jax_get_optimizer
from distkeras_tpu_torch.ops import optimizers as O
from distkeras_tpu_torch.ops.losses import get_loss


def _labels(name, rng, shape):
    n, c = shape
    if name == "sparse_categorical_crossentropy":
        return rng.integers(0, c, n).astype(np.int32)
    if name == "categorical_crossentropy":
        return np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    if name == "binary_crossentropy":
        return rng.integers(0, 2, shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


LOSSES = ["categorical_crossentropy", "sparse_categorical_crossentropy",
          "binary_crossentropy", "mse", "mean_squared_error", "mae",
          "mean_absolute_error"]


@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_jax(name):
    """rtol 1e-6: the same f32 formula, reduced in another order."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 3)).astype(np.float32) * 3
    labels = _labels(name, rng, logits.shape)
    got = get_loss(name)(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = jax_get_loss(name)(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def test_sparse_crossentropy_takes_sequence_labels():
    """[B, L] labels vs [B, L, C] logits (LM heads), as in the JAX loss."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 4, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (2, 4)).astype(np.int32)
    name = "sparse_categorical_crossentropy"
    got = get_loss(name)(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = jax_get_loss(name)(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def test_get_loss_passes_callables_and_rejects_unknown_names():
    fn = lambda a, b: a  # noqa: E731
    assert get_loss(fn) is fn
    with pytest.raises(KeyError, match="unknown loss"):
        get_loss("hinge")


OPTIMIZERS = [
    ("sgd", {}), ("momentum", {}), ("nesterov", {}), ("adam", {}),
    ("adam", {"nesterov": True, "eps_root": 1e-8}), ("adamw", {}),
    ("adagrad", {}), ("rmsprop", {}), ("rmsprop", {"eps_in_sqrt": False}),
    ("rmsprop", {"centered": True, "momentum": 0.5, "bias_correction": True}),
    ("adadelta", {}), ("adadelta", {"weight_decay": 0.1}),
]


@pytest.mark.parametrize("name,kwargs", OPTIMIZERS)
def test_optimizer_matches_optax_step_by_step(name, kwargs):
    """Five steps on the same gradients; params after every step within
    rtol 1e-6 (most rules come out bit-equal: the same f32 operations in
    the same order)."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    jtx = jax_get_optimizer(name, 0.1, **kwargs)
    ttx = O.get_optimizer(name, 0.1, **kwargs)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        u, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        u, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
        tp = O.apply_updates(tp, u)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)


def test_get_optimizer_surface():
    tx = O.sgd(0.1)
    assert O.get_optimizer(tx) is tx
    with pytest.raises(KeyError, match="unknown optimizer"):
        O.get_optimizer("lbfgs")
    with pytest.raises(NotImplementedError, match="schedule"):
        O.get_optimizer("sgd", lambda step: 0.1)
