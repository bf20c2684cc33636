"""The port's loss set and optimizer rules (``distkeras_tpu_torch/ops/``)
against the JAX package's ``get_loss`` and ``get_optimizer`` (optax) on the
same numpy inputs. f32; tolerances per test."""

import jax
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
    # a learning-rate schedule is ported: update n scales by -schedule(n)
    # and the count lives in the optimizer state (the parity cases below)
    tx = O.get_optimizer("sgd", lambda step: 0.1 * (step + 1))
    p = {"w": torch.ones(2)}
    g = {"w": torch.ones(2)}
    state = tx.init(p)
    for n in range(3):
        u, state = tx.update(g, state, p)
        torch.testing.assert_close(u["w"], torch.full((2,), -0.1 * (n + 1)))


# -- schedules, and the optimizers' dtype and mask options ------------------

from distkeras_tpu_torch.ops import schedules as S  # noqa: E402

SCHEDULES = [
    ("constant_schedule", (0.3,), {}),
    ("linear_schedule", (0.1, 0.01, 12), {"transition_begin": 3}),
    ("cosine_decay_schedule", (0.2, 15), {"alpha": 0.1}),
    ("cosine_decay_schedule", (0.2, 15), {"exponent": 2.0}),
    ("warmup_cosine_decay_schedule", (0.0, 0.3, 5, 20), {"end_value": 0.01}),
    ("exponential_decay", (0.5, 4, 0.7), {"transition_begin": 2}),
    ("exponential_decay", (0.5, 4, 0.7),
     {"staircase": True, "end_value": 0.2}),
    ("exponential_decay", (0.1, 3, 1.5), {"end_value": 0.4}),
    ("piecewise_constant_schedule", (0.4, {4: 0.5, 9: 0.1}), {}),
]


@pytest.mark.parametrize("name,args,kwargs", SCHEDULES)
def test_schedule_matches_optax(name, args, kwargs):
    """The rate at every count 0..24 within rtol 1e-6 (float32; cos and pow
    may sit one ulp from XLA's)."""
    mine, ref = getattr(S, name)(*args, **kwargs), getattr(optax, name)(
        *args, **kwargs)
    for n in range(25):
        np.testing.assert_allclose(
            float(mine(n)), float(ref(jnp.asarray(n, jnp.int32))),
            rtol=1e-6, atol=1e-9, err_msg=f"count {n}")


def test_join_schedules_matches_optax():
    parts = [(S.linear_schedule(0.0, 1.0, 4), optax.linear_schedule(
        0.0, 1.0, 4)), (S.constant_schedule(0.5), optax.constant_schedule(
            0.5)), (S.exponential_decay(0.5, 2, 0.5),
                    optax.exponential_decay(0.5, 2, 0.5))]
    mine = S.join_schedules([a for a, _ in parts], [4, 9])
    ref = optax.join_schedules([b for _, b in parts], [4, 9])
    for n in range(16):
        np.testing.assert_allclose(float(mine(n)), float(ref(n)), rtol=1e-6)


OPTION_CASES = [
    ("sgd", {"learning_rate": "sched"}),
    ("momentum", {"learning_rate": "sched", "accumulator_dtype": "bfloat16"}),
    ("nesterov", {"accumulator_dtype": "bfloat16"}),
    ("adam", {"learning_rate": "sched"}),
    ("adam", {"mu_dtype": "bfloat16"}),
    ("adam", {"mu_dtype": "bfloat16", "nesterov": True}),
    ("adamw", {"mask": "dict", "weight_decay": 0.1}),
    ("adamw", {"mask": "callable", "mu_dtype": "bfloat16",
               "learning_rate": "sched"}),
    ("adadelta", {"weight_decay": 0.1, "weight_decay_mask": "dict"}),
    ("adadelta", {"learning_rate": "sched", "weight_decay": 0.1,
                  "weight_decay_mask": "callable"}),
    ("rmsprop", {"learning_rate": "sched", "momentum": 0.5}),
    ("adagrad", {"learning_rate": "sched"}),
]


def _options(kwargs, jax_side):
    out = {}
    for k, v in kwargs.items():
        if v == "sched":
            out[k] = (optax.warmup_cosine_decay_schedule if jax_side
                      else S.warmup_cosine_decay_schedule)(0.0, 0.1, 5, 20,
                                                           end_value=0.01)
        elif v == "bfloat16":
            out[k] = jnp.bfloat16 if jax_side else "bfloat16"
        elif v == "dict":
            out[k] = {"w": True, "b": False}
        elif v == "callable":
            out[k] = lambda params: {n: n == "w" for n in params}
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("name,kwargs", OPTION_CASES)
def test_optimizer_options_match_optax(name, kwargs):
    """A schedule, mu_dtype, accumulator_dtype, mask or weight_decay_mask:
    20 updates on the same gradients, params within rtol 1e-6 after every
    one, and a reduced-precision moment stored in its dtype."""
    rng = np.random.default_rng(1)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(20)]
    jkw, tkw = _options(kwargs, True), _options(kwargs, False)
    jlr, tlr = jkw.pop("learning_rate", 0.1), tkw.pop("learning_rate", 0.1)
    jtx = jax_get_optimizer(name, jlr, **jkw)
    ttx = O.get_optimizer(name, tlr, **tkw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    # jitted, as the JAX engines run it (XLA keeps a bf16 moment's decayed
    # product in f32 there; eager JAX rounds it to bf16)
    jupdate = jax.jit(jtx.update)
    for g in grads:
        u, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        u, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
        tp = O.apply_updates(tp, u)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    low = [t for t in _tensors(ts) if t.dtype == torch.bfloat16]
    assert bool(low) == ("bfloat16" in kwargs.values())


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def test_schedule_count_resumes_and_restarts():
    """The count lives in the optimizer state: an update from a saved
    state continues the schedule, a fresh init restarts it."""
    tx = O.adam(S.linear_schedule(1.0, 0.0, 10))
    p = {"w": torch.ones(3)}
    g = {"w": torch.ones(3)}
    state = tx.init(p)
    for _ in range(4):
        _, state = tx.update(g, state, p)
    assert state[1]["count"] == 4 and state[0]["count"] == 4
    assert tx.init(p)[1]["count"] == 0
