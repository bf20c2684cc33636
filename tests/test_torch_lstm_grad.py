"""The port's LSTM training path (``distkeras_tpu_torch/ops/kernels/lstm.py``:
the stash forward, the BPTT backward and the ``LSTMSeq`` autograd Function)
against the JAX package's Pallas kernels in interpret mode and against
flax's ``OptimizedLSTMCell``, on the same numpy inputs, on the CPU (where
the Function dispatches to the plain twins). f32; each test states its
tolerance.

The CUDA kernels themselves run only on a card: ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from distkeras_tpu.ops.pallas import lstm as JL
from distkeras_tpu_torch.ops.kernels import lstm as K

#: (B, T, E, H): the JAX package's own test shape, and a ragged batch (the
#: JAX wrapper pads 5 to 8; the port masks).
SHAPES = [(3, 7, 5, 6), (5, 6, 8, 8)]


def _inputs(shape, seed=0):
    B, T, E, H = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, E)).astype(np.float32)
    wx = (rng.normal(size=(E, 4 * H)) / np.sqrt(E)).astype(np.float32)
    wh = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    b = (rng.normal(size=(4 * H,)) / 10).astype(np.float32)
    dhs = rng.normal(size=(B, T, H)).astype(np.float32)
    return x, wx, wh, b, dhs


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
def test_stash_forward_matches_jax_run_fwd(shape):
    """hs, cs, gates of the plain stash forward against JAX ``_run_fwd(...,
    stash=True, interpret=True)`` transposed to [B, T, .]: rtol = atol =
    1e-5, the same f32 arithmetic summed in another order."""
    x, wx, wh, b, _ = _inputs(shape)
    got = K.lstm_fwd_stash_plain(*_t(wx, wh, b, x))
    ref = JL._run_fwd(jnp.asarray(wx), jnp.asarray(wh), jnp.asarray(b),
                      jnp.asarray(x.transpose(1, 0, 2)), interpret=True,
                      stash=True)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(),
                                   np.asarray(r).transpose(1, 0, 2),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_matches_jax_bwd_kernel(shape):
    """``lstm_bwd_plain`` against the JAX ``_bwd_kernel`` (through
    ``_lstm_bwd`` in interpret mode) on the same residuals and a dense dhs:
    rtol = atol = 1e-5 (sums over B*T rows in another order)."""
    x, wx, wh, b, dhs = _inputs(shape)
    hs, cs, gates = K.lstm_fwd_stash_plain(*_t(wx, wh, b, x))
    got = K.lstm_bwd_plain(*_t(wx, wh, x), hs, cs, gates, *_t(dhs))
    tbe = lambda a: jnp.asarray(np.asarray(a).transpose(1, 0, 2))
    res = (jnp.asarray(wx), jnp.asarray(wh), jnp.asarray(b), tbe(x),
           tbe(hs), tbe(cs), tbe(gates))
    dwx, dwh, db, dx = JL._lstm_bwd(True, res, tbe(dhs))
    for a, r in zip(got, (dwx, dwh, db, np.asarray(dx).transpose(1, 0, 2))):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def _port_grads(wx, wh, b, x, dhs):
    params = [t.requires_grad_() for t in _t(wx, wh, b, x)]
    hs = K.lstm_seq(*params)
    (hs * torch.from_numpy(dhs)).sum().backward()
    return [p.grad.numpy() for p in params]


@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_function_matches_jax_grad_of_pallas_lstm_seq(shape):
    """Gradients through the port's ``LSTMSeq`` (stash forward + BPTT) vs
    ``jax.grad`` of the Pallas ``lstm_seq`` in interpret mode (its
    ``custom_vjp``), ragged B included: rtol = atol = 1e-5."""
    x, wx, wh, b, dhs = _inputs(shape)
    got = _port_grads(wx, wh, b, x, dhs)

    def f(wx_, wh_, b_, x_):
        return jnp.sum(JL.lstm_seq(wx_, wh_, b_, x_, interpret=True)
                       * jnp.asarray(dhs))

    ref = jax.grad(f, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (wx, wh, b, x)))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_function_matches_flax_cell_gradients(shape):
    """The same gradients against flax's ``OptimizedLSTMCell`` under
    ``nn.RNN`` (XLA's own autodiff of the reference cell), via
    ``pack_lstm_params``: rtol = atol = 1e-5."""
    x, _wx, _wh, _b, dhs = _inputs(shape)
    H = shape[3]
    cell = nn.RNN(nn.OptimizedLSTMCell(H))
    variables = cell.init(jax.random.key(1), jnp.asarray(x))

    def f(params, x_):
        return jnp.sum(cell.apply({"params": params}, x_) * jnp.asarray(dhs))

    gp, gx = jax.grad(f, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    cell_np = jax.tree_util.tree_map(np.asarray, variables["params"]["cell"])
    wx, wh, b = (t.numpy() for t in K.pack_lstm_params(cell_np))
    got = _port_grads(wx, wh, b, x, dhs)
    ref = [t.numpy() for t in K.pack_lstm_params(
        jax.tree_util.tree_map(np.asarray, gp["cell"]))] + [np.asarray(gx)]
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a, r, rtol=1e-5, atol=1e-5)


def test_cpu_gradient_takes_the_twins_and_launches_nothing():
    x, wx, wh, b, dhs = _inputs(SHAPES[1])
    before = K.launch_counts()
    _port_grads(wx, wh, b, x, dhs)
    assert K.launch_counts() == before


def test_no_grad_keeps_the_forward_only_path():
    """Without a gradient the call is the plain forward: same values as the
    stash forward's hs and no autograd graph."""
    x, wx, wh, b, _ = _inputs(SHAPES[0])
    params = [t.requires_grad_() for t in _t(wx, wh, b, x)]
    with torch.no_grad():
        hs = K.lstm_seq(*params)
    assert hs.grad_fn is None
    with torch.inference_mode():
        hs2 = K.lstm_seq(*params)
    ref = K.lstm_fwd_stash_plain(*_t(wx, wh, b, x))[0]
    torch.testing.assert_close(hs, ref, rtol=0, atol=0)
    torch.testing.assert_close(hs2, ref, rtol=0, atol=0)
    assert K.lstm_seq(*params).grad_fn is not None


def test_gradient_on_meta_or_mixed_devices_raises():
    x, wx, wh, b, _ = _inputs(SHAPES[0])
    wx_t, wh_t, b_t, x_t = _t(wx, wh, b, x)
    with pytest.raises(ValueError, match="CUDA device"):
        K.lstm_seq(wx_t.requires_grad_(), wh_t, b_t, x_t.to("meta"))
    meta = [t.to("meta").requires_grad_() for t in _t(wx, wh, b, x)]
    with pytest.raises(ValueError, match="CUDA device"):
        K.lstm_seq(*meta)


def test_bwd_splits_keep_chunks_of_at_least_256_rows():
    assert K.bwd_splits(1 * 200) == 1
    assert K.bwd_splits(40 * 200) == 31
    assert K.bwd_splits(2048 * 200) == 64
