"""The host-side layouts of the bf16 tensor-core LSTM kernels
(``distkeras_tpu_torch/ops/kernels/lstm.py``): the forward's permuted
weight copy, the backward's split into a serial half (the bf16 dpre
workspace and per-tile db partials) and a parallel half, and the
weight-gradient pass's h_{t-1} rows. Each is held bit for bit against the
plain twins on the CPU, in f32 and bf16. The kernels themselves run only
on a card: ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.ops.kernels import lstm as K

#: (B, T, E, H): one 16-row tile and a ragged second one (19 rows), at
#: widths the bf16 kernels take.
SHAPES = [(3, 5, 16, 16), (19, 4, 32, 48)]
DTYPES = [torch.float32, torch.bfloat16]


def _inputs(shape, dtype, seed=0):
    B, T, E, H = shape
    rng = np.random.default_rng(seed)

    def t(*size, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=size) * scale).astype(np.float32)).to(dtype)

    return (t(E, 4 * H, scale=E ** -0.5), t(H, 4 * H, scale=H ** -0.5),
            t(4 * H, scale=0.1), t(B, T, E), t(B, T, H, scale=0.1))


@pytest.mark.parametrize("H", [16, 48, 128])
def test_gate_permutation_puts_a_units_four_gates_in_one_group(H):
    """Every packed column once; block column 32 q + 8 gate + u is gate
    ``gate`` of unit 8 q + u, so n-tiles 4q .. 4q+3 hold i, f, g, o of the
    same eight units."""
    perm = K.gate_permutation(H)
    assert torch.equal(perm.sort().values, torch.arange(4 * H))
    n = torch.arange(4 * H)
    assert torch.equal(perm // H, (n % 32) // 8)
    assert torch.equal(perm % H, 8 * (n // 32) + n % 8)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_fwd_weight_layout_round_trips(shape, dtype):
    """``[4H, E+H]``, contiguous, read back through the inverse
    permutation to Wx and Wh exactly."""
    E, H = shape[2], shape[3]
    wx, wh, *_ = _inputs(shape, dtype)
    wt = K.fwd_weight_layout(wx, wh)
    assert wt.shape == (4 * H, E + H) and wt.is_contiguous()
    assert wt.dtype == dtype
    inv = torch.argsort(K.gate_permutation(H))
    back = wt.t()[:, inv]
    assert torch.equal(back[:E], wx) and torch.equal(back[E:], wh)


@pytest.mark.parametrize("stash", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_on_the_permuted_layout_equals_the_twin(shape, dtype, stash):
    """The forward computed in the kernel's permuted column order gives
    the twin's hs (and cs, gates) bit for bit."""
    wx, wh, b, x, _ = _inputs(shape, dtype)
    got = K.lstm_fwd_layout_plain(K.fwd_weight_layout(wx, wh), b, x, stash)
    if stash:
        for a, r in zip(got, K.lstm_fwd_stash_plain(wx, wh, b, x)):
            assert torch.equal(a, r)
    else:
        assert torch.equal(got, K.lstm_seq_plain(wx, wh, b, x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_split_backward_equals_the_twin(shape, dtype):
    """The serial half (bf16 workspace of dpre rounded to the weights'
    dtype, f32 db partials a 16-row tile) and the parallel half give the
    twin's dwx, dwh, db and dx bit for bit."""
    B, T, E, H = shape
    wx, wh, b, x, dhs = _inputs(shape, dtype)
    hs, cs, gates = K.lstm_fwd_stash_plain(wx, wh, b, x)
    dpre_c, dbp = K.lstm_bwd_recurrent_plain(wh, cs, gates, dhs)
    assert dpre_c.shape == (B, T, 4 * H) and dpre_c.dtype == dtype
    assert dbp.shape == (-(-B // K.BF16_ROWS), 4 * H)
    assert dbp.dtype == torch.float32
    got = K.lstm_bwd_wgrad_plain(wx, x, hs, dpre_c, dbp)
    ref = K.lstm_bwd_plain(wx, wh, x, hs, cs, gates, dhs)
    for name, a, r in zip(("dwx", "dwh", "db", "dx"), got, ref):
        assert a.dtype == r.dtype and torch.equal(a, r), name


@pytest.mark.parametrize("shape", SHAPES)
def test_wgrad_rows_shift_equals_the_twins_h_prev(shape):
    """h_{t-1} as the weight-gradient kernel indexes the flat rows (one row
    back, zero where t = 0) equals ``lstm_bwd_plain``'s ``h_prev``."""
    B, T, _E, H = shape
    hs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, T, H)).astype(np.float32))
    h_prev = torch.cat([hs.new_zeros(B, 1, H), hs[:, :-1]], dim=1)
    assert torch.equal(K.wgrad_rows_plain(hs), h_prev.reshape(B * T, H))


@pytest.mark.parametrize("E,H,what", [(24, 128, "multiples of 16"),
                                      (64, 40, "multiples of 16"),
                                      (8, 64, "multiples of 16"),
                                      (64, 144, "H <= 128"),
                                      (128, 256, "H <= 128")])
def test_bf16_widths_the_kernels_refuse(E, H, what):
    """E or H off the mma k-tile, and H past the 16 units a warp owns (the
    widths padding reaches no further than)."""
    with pytest.raises(ValueError, match=what):
        K.check_bf16_widths(E, H)


@pytest.mark.parametrize("E,H", [(64, 128), (16, 16), (128, 96), (144, 64),
                                 (128, 128)])
def test_bf16_widths_the_kernels_take(E, H):
    """Config #4 (E=64, H=128: the resident forward keeps 218,112 bytes of
    shared memory), the card tests' small training width, and E > 128 and
    ``imdb_lstm()``'s E=H=128, which the ``xw`` body runs (x . Wx first,
    only Wh resident: 147,968 bytes)."""
    K.check_bf16_widths(E, H)
    assert K.fwd_smem_bytes(64, 128) == 218112
    assert K.rec_smem_bytes(128) == 166400
    assert K.xw_smem_bytes(128) == 147968


@pytest.mark.parametrize("E,H,body", [(64, 128, "resident"),
                                      (16, 16, "resident"),
                                      (128, 96, "resident"),
                                      (128, 128, "xw"), (144, 64, "xw"),
                                      (256, 16, "xw")])
def test_bf16_forward_body_follows_the_width_alone(E, H, body):
    """Resident wherever ``[Wx; Wh]`` and the tiles fit a block and x_t is
    one vector a thread (E <= 128); the ``xw`` body elsewhere."""
    assert K.bf16_fwd_body(E, H) == body
    assert (K.fwd_smem_bytes(E, H) <= 232448 and E <= 128) == (
        body == "resident")


@pytest.mark.parametrize("H", [16, 48, 128])
def test_xw_permutation_puts_a_lanes_eight_pre_values_side_by_side(H):
    """Every packed column once; column 32 q + 8 t + 2 gate + u of the
    scratch is gate ``gate`` of unit 8 q + 2 t + u, so the lane owning
    units 8 q + 2 t, + 1 reads i, i, f, f, g, g, o, o contiguously."""
    perm = K.xw_permutation(H)
    assert torch.equal(perm.sort().values, torch.arange(4 * H))
    p = torch.arange(4 * H)
    assert torch.equal(perm // H, (p % 8) // 2)
    assert torch.equal(perm % H, 8 * (p // 32) + 2 * ((p % 32) // 8) + p % 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_xw_layouts_round_trip(shape, dtype):
    """``[4H, E]`` and ``[4H, H]``, contiguous, read back through the
    inverse permutations to Wx and Wh exactly."""
    E, H = shape[2], shape[3]
    wx, wh, *_ = _inputs(shape, dtype)
    wxt, wht = K.xw_xproj_layout(wx), K.xw_rec_weight_layout(wh)
    assert wxt.shape == (4 * H, E) and wxt.is_contiguous()
    assert wht.shape == (4 * H, H) and wht.is_contiguous()
    assert wxt.dtype == wht.dtype == dtype
    assert torch.equal(wxt.t()[:, torch.argsort(K.xw_permutation(H))], wx)
    assert torch.equal(wht.t()[:, torch.argsort(K.gate_permutation(H))], wh)


@pytest.mark.parametrize("stash", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES + [(2, 6, 144, 16)])
def test_forward_as_the_xw_body_splits_it_matches_the_twin(shape, dtype,
                                                            stash):
    """x . Wx for every (b, t) first (f32, in the scratch's order), then
    (pre + h . Wh) + b each step: the twin's association, with the
    products summed in another order. f32: within atol 1e-6. bf16: within
    two bf16 ulps of each output's largest magnitude (a sum order can flip
    one rounding of h, which the carry feeds on); E=144 is past the
    resident body."""
    wx, wh, b, x, _ = _inputs(shape, dtype)
    got = K.lstm_fwd_xw_layout_plain(K.xw_xproj_layout(wx),
                                     K.xw_rec_weight_layout(wh), b, x, stash)
    ref = K.lstm_fwd_stash_plain(wx, wh, b, x)
    if not stash:
        got, ref = (got,), ref[:1]
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype == dtype and a.shape == r.shape
        if dtype == torch.float32:
            torch.testing.assert_close(a, r, rtol=0, atol=1e-6)
        else:
            err = (a.float() - r.float()).abs().max()
            assert err <= 2 * 2.0 ** -8 * r.float().abs().max(), err
