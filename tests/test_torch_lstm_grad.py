"""The port's LSTM training path (``distkeras_tpu_torch/ops/kernels/lstm.py``:
the stash forward, the BPTT backward and the ``LSTMSeq`` autograd Function)
against the JAX package's Pallas kernels in interpret mode and against
flax's ``OptimizedLSTMCell``, on the same numpy inputs, on the CPU (where
the Function dispatches to the plain twins). f32 and bf16; each test
states its tolerance.

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


def _bf(*arrays):
    """The arrays as bf16 tensors and as bf16 JAX arrays (the same bits)."""
    ts = [torch.from_numpy(a.copy()).to(torch.bfloat16) for a in arrays]
    return ts, [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in ts]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _within_bf16_ulp(got, ref, name=""):
    """``got`` within one bf16 ulp of ``ref``'s largest magnitude: the
    port and the TPU kernel round at the same points, and a sum taken in
    another order can flip one rounding by one ulp."""
    got, ref = _f32(got), _f32(ref)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    err = np.abs(got - ref).max()
    assert err <= ulp, (name, err, ulp)


#: a longer sequence for the bf16 cases: a rounding flip can compound
#: through the carry over 40 steps.
BF16_SHAPES = SHAPES + [(4, 40, 16, 16)]


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


@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_stash_forward_bf16_matches_jax_run_fwd(shape):
    """bf16 hs, cs, gates (f32 carry inside, stored in bf16) against JAX
    ``_run_fwd(..., stash=True, interpret=True)`` on the same bf16 inputs:
    within one bf16 ulp of each output's largest magnitude."""
    x, wx, wh, b, _ = _inputs(shape)
    (twx, twh, tb, tx), (jwx, jwh, jb, jx) = _bf(wx, wh, b, x)
    got = K.lstm_fwd_stash_plain(twx, twh, tb, tx)
    ref = JL._run_fwd(jwx, jwh, jb, jnp.transpose(jx, (1, 0, 2)),
                      interpret=True, stash=True)
    for name, a, r in zip(("hs", "cs", "gates"), got, ref):
        assert a.dtype == torch.bfloat16
        _within_bf16_ulp(a, jnp.transpose(r, (1, 0, 2)), name)


@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_bwd_plain_bf16_matches_jax_bwd_kernel(shape):
    """``lstm_bwd_plain`` at bf16 against the JAX ``_bwd_kernel`` on the
    same bf16 residuals and dhs: dpre rounded to bf16 for dx, dh, dWx and
    dWh, db from the f32 dpre; dx, dWx, dWh, db returned in bf16, each
    within one bf16 ulp of its largest magnitude."""
    x, wx, wh, b, dhs = _inputs(shape)
    (twx, twh, tb, tx, tdhs), (jwx, jwh, jb, jx, jdhs) = _bf(
        wx, wh, b, x, dhs)
    hs, cs, gates = K.lstm_fwd_stash_plain(twx, twh, tb, tx)
    got = K.lstm_bwd_plain(twx, twh, tx, hs, cs, gates, tdhs)

    def tbe(a):
        return jnp.transpose(jnp.asarray(_f32(a), jnp.bfloat16), (1, 0, 2))

    res = (jwx, jwh, jb, tbe(tx), tbe(hs), tbe(cs), tbe(gates))
    dwx, dwh, db, dx = JL._lstm_bwd(True, res, tbe(tdhs))
    for name, a, r in zip(("dwx", "dwh", "db", "dx"), got,
                          (dwx, dwh, db, jnp.transpose(dx, (1, 0, 2)))):
        assert a.dtype == torch.bfloat16, name
        _within_bf16_ulp(a, r, name)


@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_autograd_function_bf16_matches_jax_grad_of_pallas_lstm_seq(shape):
    """Gradients through ``LSTMSeq`` at bf16 against ``jax.grad`` of the
    Pallas ``lstm_seq`` (interpret mode, its ``custom_vjp``) at bf16,
    ragged B included: bf16 gradients within one bf16 ulp of each one's
    largest magnitude."""
    x, wx, wh, b, dhs = _inputs(shape)
    (twx, twh, tb, tx, tdhs), (jwx, jwh, jb, jx, jdhs) = _bf(
        wx, wh, b, x, dhs)
    params = [t.requires_grad_() for t in (twx, twh, tb, tx)]
    (K.lstm_seq(*params).float() * tdhs.float()).sum().backward()

    def f(wx_, wh_, b_, x_):
        hs = JL.lstm_seq(wx_, wh_, b_, x_, interpret=True)
        return jnp.sum(hs.astype(jnp.float32) * jdhs.astype(jnp.float32))

    ref = jax.grad(f, argnums=(0, 1, 2, 3))(jwx, jwh, jb, jx)
    for name, p, r in zip(("dwx", "dwh", "db", "dx"), params, ref):
        assert p.grad.dtype == torch.bfloat16, name
        _within_bf16_ulp(p.grad, r, name)


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
