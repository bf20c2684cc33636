"""The port's LSTM recurrence (``distkeras_tpu_torch/ops/kernels/lstm.py``)
against the JAX package's: its CPU path (the plain PyTorch twin of the
CUDA kernel) vs the Pallas kernel run in interpret mode and vs flax's
``OptimizedLSTMCell``, on the same numpy inputs. f32, rtol = atol = 1e-5:
the same arithmetic summed in another order over a few steps. bf16 (the
mixed-precision step's dtype): within one bf16 ulp of the output's
largest magnitude, the same rounding points (bf16 products summed in
f32, h rounded before the recurrent product, hs stored in bf16), where a
sum order can flip one rounding by one ulp.

The kernel itself runs only on a card: ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from distkeras_tpu.ops.pallas.lstm import lstm_seq as jax_lstm_seq
from distkeras_tpu.ops.pallas.lstm import pack_lstm_params as jax_pack
from distkeras_tpu_torch.ops.kernels import lstm as K

#: (B, T, E, H): the JAX package's own test shape, and an odd batch (the
#: JAX wrapper pads it to 8; the port masks it).
SHAPES = [(3, 7, 5, 6), (5, 4, 3, 4)]


def _setup(shape, seed=0):
    B, T, E, H = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, E)).astype(np.float32)
    cell = nn.RNN(nn.OptimizedLSTMCell(H))
    variables = cell.init(jax.random.key(1), jnp.asarray(x))
    cell_np = jax.tree_util.tree_map(np.asarray, variables["params"]["cell"])
    return x, cell, variables, cell_np


@pytest.mark.parametrize("shape", SHAPES)
def test_lstm_seq_matches_jax_pallas_interpret(shape):
    x, _cell, _vars, cell_np = _setup(shape)
    wx, wh, b = K.pack_lstm_params(cell_np)
    got = K.lstm_seq(wx, wh, b, torch.from_numpy(x))
    ref = jax_lstm_seq(*(jnp.asarray(a.numpy()) for a in (wx, wh, b)),
                       jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def bf16_ulp(m: float) -> float:
    """One bf16 unit in the last place at magnitude ``m`` (8 significant
    bits)."""
    return 2.0 ** (np.floor(np.log2(m)) - 7)


@pytest.mark.parametrize("shape", SHAPES + [(4, 40, 16, 16)])
def test_lstm_seq_bf16_matches_jax_pallas_interpret(shape):
    """bf16 x and weights (the packed tree cast as the JAX model casts it)
    through the plain forward and the Pallas kernel in interpret mode: hs
    in bf16, within one bf16 ulp of its largest magnitude; T=40 lets a
    rounding flip compound through the carry."""
    x, _cell, _vars, cell_np = _setup(shape)
    ws = [w.to(torch.bfloat16) for w in K.pack_lstm_params(cell_np)]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = K.lstm_seq(*ws, xb)
    assert got.dtype == torch.bfloat16
    ref = jax_lstm_seq(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                         for a in (*ws, xb)), interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= bf16_ulp(np.abs(ref).max()), err


@pytest.mark.parametrize("shape", SHAPES)
def test_lstm_seq_matches_flax_cell(shape):
    x, cell, variables, cell_np = _setup(shape)
    wx, wh, b = K.pack_lstm_params(cell_np)
    got = K.lstm_seq(wx, wh, b, torch.from_numpy(x))
    ref = cell.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_pack_lstm_params_matches_jax():
    _x, _cell, variables, cell_np = _setup(SHAPES[0])
    ours = K.pack_lstm_params(cell_np)
    theirs = jax_pack(variables["params"]["cell"])
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cpu_wrapper_leaves_launches_unchanged():
    x, _cell, _vars, cell_np = _setup(SHAPES[0])
    wx, wh, b = K.pack_lstm_params(cell_np)
    before = K.launch_counts()["lstm_fwd"]
    K.lstm_seq(wx, wh, b, torch.from_numpy(x))
    assert K.launch_counts()["lstm_fwd"] == before


def test_wrapper_raises_on_bad_inputs():
    wx, wh, b = torch.zeros(5, 24), torch.zeros(6, 24), torch.zeros(24)
    with pytest.raises(ValueError, match="packed LSTM params"):
        K.lstm_seq(wx, wh, b, torch.zeros(2, 3, 4))  # E mismatch
    # Neither all-CPU nor CUDA: no silent plain fallback.
    with pytest.raises(ValueError, match="CUDA device"):
        K.lstm_seq(wx, wh, b, torch.zeros(2, 3, 5, device="meta"))


def test_orthogonal_gates_blocks_are_orthogonal():
    H = 6
    w = K.orthogonal_gates(H, torch.Generator().manual_seed(0))
    assert w.shape == (H, 4 * H)
    for g in range(4):
        q = w[:, g * H:(g + 1) * H]
        torch.testing.assert_close(q.T @ q, torch.eye(H), rtol=0, atol=1e-5)

