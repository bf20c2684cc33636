"""The port's worker loop (``distkeras_tpu_torch/workers.py``
``make_local_loop``) against the JAX package's on the same
``LSTMClassifier`` weights (carried over by ``params_from_jax``) and the
same batches: per-step losses and the params after the window, with
``grad_accum`` 1 and 2. The JAX model runs ``cell_impl="pallas"`` (its
kernel in interpret mode on the CPU). Also the functional model surface
the loop needs (``Model.params``, ``with_params``) and dropout's train and
eval modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
from distkeras_tpu.ops.losses import get_loss as jax_get_loss
from distkeras_tpu.ops.optimizers import get_optimizer as jax_get_optimizer
from distkeras_tpu.workers import make_local_loop as jax_make_local_loop
from distkeras_tpu_torch import imdb_lstm
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.optimizers import get_optimizer
from distkeras_tpu_torch.workers import derive_seed, make_local_loop

SMALL = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)
LOSS = "sparse_categorical_crossentropy"


def _pair(seed=1):
    jm = jax_imdb_lstm(**SMALL, cell_impl="pallas", seed=seed)
    pm = imdb_lstm(**SMALL, device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return jm, pm


def _batches(K=3, B=4, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 50, (K, B, 6)).astype(np.int32)
    ys = rng.integers(0, 2, (K, B)).astype(np.int32)
    return xs, ys


@pytest.mark.parametrize("opt,grad_accum,atol", [("sgd", 1, 1e-5),
                                                 ("sgd", 2, 1e-5),
                                                 ("adam", 1, 1e-4)])
def test_local_loop_matches_jax(opt, grad_accum, atol):
    """Per-step losses within rtol = atol = 1e-5 and final params within
    rtol 1e-5 and ``atol`` (f32, the same math through another framework's
    kernels). Adam's atol is 1e-4: it divides each gradient by its own
    running magnitude, so an element whose gradient is near zero turns the
    two frameworks' f32 rounding into a visible share of its lr-sized
    step."""
    jm, pm = _pair()
    xs, ys = _batches()
    jloop = jax_make_local_loop(jm.module, jax_get_loss(LOSS),
                                jax_get_optimizer(opt, 0.1),
                                grad_accum=grad_accum)
    jtx = jax_get_optimizer(opt, 0.1)
    jp, _, _, jl = jloop(jm.params, jtx.init(jm.params), jnp.asarray(xs),
                         jnp.asarray(ys), jax.random.key(0))
    tx = get_optimizer(opt, 0.1)
    loop = make_local_loop(pm.module, get_loss(LOSS), tx,
                           grad_accum=grad_accum)
    p, _, _, losses = loop(pm.params, tx.init(pm.params),
                           torch.from_numpy(xs), torch.from_numpy(ys), 0)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), pm.module)
    for k, v in ref.items():
        np.testing.assert_allclose(p[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=atol)
    assert not pm.module.training  # back in eval mode after the window


def test_grad_accum_is_the_same_step_as_the_full_batch():
    """For a dropout-free model, A micro-batches give the full batch's mean
    gradient: params within 1e-6 of the unaccumulated loop."""
    _, pm = _pair()
    xs, ys = _batches(K=2, B=4)
    out = []
    for a in (1, 2, 4):
        tx = get_optimizer("sgd", 0.1)
        loop = make_local_loop(pm.module, get_loss(LOSS), tx, grad_accum=a)
        out.append(loop(pm.params, tx.init(pm.params), torch.from_numpy(xs),
                        torch.from_numpy(ys))[0])
    for other in out[1:]:
        for k in out[0]:
            torch.testing.assert_close(other[k], out[0][k], rtol=1e-6,
                                       atol=1e-6)


def test_unported_options_raise():
    _, pm = _pair()
    tx = get_optimizer("sgd", 0.1)
    loss = get_loss(LOSS)
    with pytest.raises(TypeError, match="compute_dtype"):
        make_local_loop(pm.module, loss, tx, compute_dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="state_collections"):
        make_local_loop(pm.module, loss, tx, state_collections=("batch_stats",))
    with pytest.raises(NotImplementedError, match="input_transform"):
        make_local_loop(pm.module, loss, tx, input_transform=lambda *a: a)
    with pytest.raises(ValueError, match="grad_accum"):
        make_local_loop(pm.module, loss, tx, grad_accum=0)
    loop = make_local_loop(pm.module, loss, tx, grad_accum=3)
    xs, ys = _batches(K=1, B=4)
    with pytest.raises(ValueError, match="divisible"):
        loop(pm.params, tx.init(pm.params), torch.from_numpy(xs),
             torch.from_numpy(ys))


def test_model_params_and_with_params():
    _, pm = _pair()
    params = pm.params
    assert set(params) == {k for k, _ in pm.module.named_parameters()}
    assert pm.state_collections == ()
    doubled = pm.with_params({k: v * 2 for k, v in params.items()})
    assert doubled.device == pm.device and not doubled.module.training
    torch.testing.assert_close(doubled.params["lstm_wx"],
                               params["lstm_wx"] * 2)
    torch.testing.assert_close(pm.params["lstm_wx"], params["lstm_wx"])
    with pytest.raises(KeyError):
        pm.with_params({"lstm_wx": params["lstm_wx"]})


def test_dropout_only_in_train_mode_and_seeded():
    m = imdb_lstm(**SMALL, device="cpu", dropout_rate=0.5).module
    tokens = torch.from_numpy(_batches(K=1, B=8)[0][0])
    assert m.get_config()["dropout_rate"] == 0.5
    with torch.no_grad():
        ev = m(tokens)
        m.train()
        a = m(tokens, rng=torch.Generator().manual_seed(derive_seed(3, 1)))
        b = m(tokens, rng=torch.Generator().manual_seed(derive_seed(3, 1)))
        c = m(tokens, rng=torch.Generator().manual_seed(derive_seed(3, 2)))
        m.eval()
        torch.testing.assert_close(m(tokens), ev, rtol=0, atol=0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and not torch.equal(a, ev)


def test_derive_seed_is_deterministic_and_mixes():
    assert derive_seed(1, 2) == derive_seed(1, 2)
    assert len({derive_seed(0, w) for w in range(8)}) == 8
    assert 0 <= derive_seed(7) < 2 ** 64
