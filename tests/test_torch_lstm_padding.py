"""Zero-padding at the LSTM's model boundary
(``distkeras_tpu_torch/ops/kernels/lstm.py``: ``padded_widths``,
``pad_lstm_inputs``, ``unpad_hs``, ``pad_dhs``, ``unpad_grads``), the path
``lstm_seq`` and ``LSTMSeq`` take on CUDA tensors for widths the kernels
refuse. Here it runs through the plain twins: pad, the stash forward and
the backward at the padded widths, slice back. Held against the unpadded
twins and against the JAX package's Pallas ``lstm_seq`` in interpret mode
(forward, and ``jax.grad`` through its ``custom_vjp``), on the same numpy
inputs, in f32 and bf16. The kernels themselves run only on a card:
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.pallas.lstm import lstm_seq as jax_lstm_seq
from distkeras_tpu_torch.ops.kernels import lstm as K

#: (B, T, E, H): the JAX package's own test widths (5, 6) and (3, 4), one
#: the f32 cluster pads to 80 and the bf16 body to 80, ``imdb_lstm()``'s
#: E=H=128 (bf16 unpadded, through the xw body on the card), and an f32 H
#: between 129 and 256 (200 pads to 256).
SHAPES = [(3, 5, 5, 6), (5, 4, 3, 4), (3, 3, 64, 72), (2, 3, 128, 128),
          (2, 3, 8, 200)]
BF16_SHAPES = SHAPES[:4]

#: the widths each dtype runs these at
WANT = {torch.float32: [(8, 8), (4, 8), (64, 80), (128, 128), (8, 256)],
        torch.bfloat16: [(16, 16), (16, 16), (64, 80), (128, 128)]}


def _inputs(B, T, E, H, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, E)).astype(np.float32)
    wx = (rng.normal(size=(E, 4 * H)) / np.sqrt(E)).astype(np.float32)
    wh = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    b = (rng.normal(size=(4 * H,)) / 10).astype(np.float32)
    dhs = (rng.normal(size=(B, T, H)) / 10).astype(np.float32)
    return wx, wh, b, x, dhs


def _padded_run(wx, wh, b, x, dhs):
    """The card's padded path with the twins in the kernels' place:
    ``(hs, (dwx, dwh, db, dx))`` at the caller's widths."""
    E, H = x.shape[2], wh.shape[0]
    Ep, Hp = K.padded_widths(E, H, x.dtype)
    pwx, pwh, pb, px = K.pad_lstm_inputs(wx, wh, b, x, Ep, Hp)
    hs, cs, gates = K.lstm_fwd_stash_plain(pwx, pwh, pb, px)
    grads = K.unpad_grads(*K.lstm_bwd_plain(pwx, pwh, px, hs, cs, gates,
                                            K.pad_dhs(dhs, Hp)), E, H)
    return K.unpad_hs(hs, H), grads


def _jax(wx, wh, b, x, dhs, dtype):
    """hs and the gradients of sum(hs * dhs) through the Pallas lstm_seq
    (interpret mode), as float32 numpy."""
    args = [jnp.asarray(a, dtype) for a in (wx, wh, b, x)]
    hs = jax_lstm_seq(*args, interpret=True)

    def f(*a):
        out = jax_lstm_seq(*a, interpret=True).astype(jnp.float32)
        return jnp.sum(out * jnp.asarray(dhs))

    grads = jax.grad(f, argnums=(0, 1, 2, 3))(*args)
    return [np.asarray(t.astype(jnp.float32)) for t in (hs, *grads)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_widths(dtype):
    """E to a multiple of 4 (f32) or 16 (bf16), H to the next width the
    dtype's kernels take; each padded width passes the kernels' check."""
    shapes = SHAPES if dtype == torch.float32 else BF16_SHAPES
    for (_B, _T, E, H), want in zip(shapes, WANT[dtype]):
        assert K.padded_widths(E, H, dtype) == want
        check = (K.check_f32_widths if dtype == torch.float32
                 else K.check_bf16_widths)
        check(*want)


@pytest.mark.parametrize("dtype,E,H,what", [
    (torch.float32, 64, 512, "shared memory"),
    (torch.float32, 64, 304, "512 threads"),
    (torch.bfloat16, 64, 144, "H <= 128"),
    (torch.bfloat16, 128, 256, "H <= 128")])
def test_widths_past_the_padding_stay_refused(dtype, E, H, what):
    """f32 H > 256 and bf16 H > 128: ``padded_widths`` leaves H as it is
    and the kernels' check raises, naming the constraint."""
    Ep, Hp = K.padded_widths(E, H, dtype)
    assert Hp == H
    check = K.check_f32_widths if dtype == torch.float32 else \
        K.check_bf16_widths
    with pytest.raises(ValueError, match=what):
        check(Ep, Hp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_padding_takes_no_copy(dtype):
    """Config #4 (E=64, H=128) in both dtypes and f32 E=H=128: the same
    tensors come back, and the slicing functions hand theirs through."""
    for E, H in ((64, 128), (128, 128)):
        wx, wh, b, x, dhs = (torch.from_numpy(a).to(dtype)
                             for a in _inputs(2, 2, E, H))
        assert K.padded_widths(E, H, dtype) == (E, H)
        out = K.pad_lstm_inputs(wx, wh, b, x, E, H)
        assert all(o is t for o, t in zip(out, (wx, wh, b, x)))
        assert K.pad_dhs(dhs, H) is dhs and K.unpad_hs(dhs, H) is dhs
        grads = (wx, wh, b, x)
        assert all(o is t for o, t in zip(K.unpad_grads(*grads, E, H),
                                          grads))


def test_padding_is_zero_and_slicing_gives_back_the_caller_widths():
    """Padded rows, columns and biases are exactly zero; the real ones are
    the caller's, each gate at ``g Hp``; ``unpad_grads`` of the padded
    tensors themselves gives the originals back bit for bit."""
    wx, wh, b, x, dhs = (torch.from_numpy(a) for a in _inputs(2, 3, 5, 6))
    pwx, pwh, pb, px = K.pad_lstm_inputs(wx, wh, b, x, 8, 16)
    assert (pwx.shape, pwh.shape, pb.shape, px.shape) == (
        (8, 64), (16, 64), (64,), (2, 3, 8))
    for g in range(4):
        assert torch.equal(pwx[:5, 16 * g:16 * g + 6], wx[:, 6 * g:6 * g + 6])
        assert torch.equal(pwh[:6, 16 * g:16 * g + 6], wh[:, 6 * g:6 * g + 6])
        assert torch.equal(pb[16 * g:16 * g + 6], b[6 * g:6 * g + 6])
        assert not pwx[:, 16 * g + 6:16 * g + 16].any()
        assert not pwh[:, 16 * g + 6:16 * g + 16].any()
        assert not pb[16 * g + 6:16 * g + 16].any()
    assert not pwx[5:].any() and not pwh[6:].any() and not px[..., 5:].any()
    assert torch.equal(px[..., :5], x)
    back = K.unpad_grads(pwx, pwh, pb, px, 5, 6)
    for a, r in zip(back, (wx, wh, b, x)):
        assert torch.equal(a, r) and a.is_contiguous()
    pd = K.pad_dhs(dhs, 16)
    assert pd.shape == (2, 3, 16) and not pd[..., 6:].any()
    assert torch.equal(K.unpad_hs(pd, 6), dhs)


@pytest.mark.parametrize("shape", SHAPES)
def test_padded_f32_forward_is_bit_equal_and_gradients_agree(shape):
    """f32: the padded forward's hs equals the unpadded twin's bit for bit
    at the reference's widths (padded units stay at c = h = 0 and add exact
    zeros); at H 200 -> 256 the CPU's matrix product blocks its 1024
    columns otherwise, so there within atol 1e-6. The gradients agree
    within 1e-6 of each one's largest magnitude (the zero terms move the
    products' summation blocking), and the padded units' own hs and cs are
    exactly zero."""
    wx, wh, b, x, dhs = (torch.from_numpy(a) for a in _inputs(*shape))
    hs, grads = _padded_run(wx, wh, b, x, dhs)
    ref_hs, _cs, _g = K.lstm_fwd_stash_plain(wx, wh, b, x)
    if shape[3] <= 128:
        assert torch.equal(hs, ref_hs)
    else:
        torch.testing.assert_close(hs, ref_hs, rtol=0, atol=1e-6)
    ref = K.lstm_bwd_plain(wx, wh, x, *K.lstm_fwd_stash_plain(wx, wh, b, x),
                           dhs)
    for name, a, r in zip(("dwx", "dwh", "db", "dx"), grads, ref):
        assert a.shape == r.shape, name
        err = ((a - r).abs().max() / r.abs().max()).item()
        assert err <= 1e-6, (name, err)
    E, H = shape[2:]
    Ep, Hp = K.padded_widths(E, H, torch.float32)
    p = K.pad_lstm_inputs(wx, wh, b, x, Ep, Hp)
    phs, pcs, _pg = K.lstm_fwd_stash_plain(*p)
    assert not phs[..., H:].any() and not pcs[..., H:].any()


@pytest.mark.parametrize("shape", SHAPES)
def test_padded_f32_path_matches_jax_pallas_lstm_seq(shape):
    """f32, padded through the twins, against the JAX Pallas ``lstm_seq``
    (interpret mode) and ``jax.grad`` of it: rtol = atol = 1e-5 (the same
    arithmetic summed in another order)."""
    wx, wh, b, x, dhs = _inputs(*shape)
    hs, grads = _padded_run(*(torch.from_numpy(a) for a in
                              (wx, wh, b, x, dhs)))
    ref = _jax(wx, wh, b, x, dhs, jnp.float32)
    for name, a, r in zip(("hs", "dwx", "dwh", "db", "dx"),
                          (hs, *grads), ref):
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_padded_bf16_path_matches_jax_pallas_lstm_seq(shape):
    """bf16, padded through the bf16 twins, against the JAX Pallas
    ``lstm_seq`` (interpret mode) on the same bf16 values: hs within one
    bf16 ulp of its largest magnitude (as ``test_torch_lstm.py``), each
    gradient within two of its own (its f32 sums of bf16-rounded dpre run
    in another order, so a rounding may flip and feed the dh carry)."""
    wx, wh, b, x, dhs = _inputs(*shape)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (wx, wh, b, x)]
    hs, grads = _padded_run(*bf, torch.from_numpy(dhs).to(torch.bfloat16))
    assert hs.dtype == torch.bfloat16
    ref = _jax(*(t.float().numpy() for t in bf),
               torch.from_numpy(dhs).to(torch.bfloat16).float().numpy(),
               jnp.bfloat16)
    for k, (name, a, r) in enumerate(zip(("hs", "dwx", "dwh", "db", "dx"),
                                         (hs, *grads), ref)):
        top = np.abs(r).max()
        err = np.abs(a.float().numpy() - r).max()
        assert err <= (1 if k == 0 else 2) * 2.0 ** -8 * top, (name, err, top)
