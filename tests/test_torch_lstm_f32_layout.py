"""The host-side layouts of the f32 cluster LSTM kernels
(``distkeras_tpu_torch/ops/kernels/lstm.py``): the tiling choice, the
x . Wx product's column order, the per-block Wh slices of the recurrence
and of the recurrent backward, and the forward and the backward's serial
half computed the way the kernels split them. Each is held against the
plain twins and, through them, against the JAX package's Pallas LSTM in
interpret mode, on numpy inputs, on the CPU. The kernels themselves run
only on a card: ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.pallas import lstm as JL
from distkeras_tpu_torch.ops.kernels import lstm as K

#: (B, T, E, H, R, C): every tiling the kernels are built for, with a
#: ragged last tile where B > R; H=64 is the smallest width a cluster of 8
#: tiles.
SHAPES = [(3, 5, 8, 8, 16, 1), (19, 4, 12, 32, 16, 4),
          (5, 3, 8, 64, 16, 8), (40, 3, 8, 16, 32, 2),
          (35, 2, 4, 8, 32, 1), (18, 2, 4, 80, 16, 2),
          (33, 2, 8, 192, 32, 4), (34, 2, 4, 256, 32, 8)]


def _inputs(B, T, E, H, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, E)).astype(np.float32)
    wx = (rng.normal(size=(E, 4 * H)) / np.sqrt(E)).astype(np.float32)
    wh = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    b = (rng.normal(size=(4 * H,)) / 10).astype(np.float32)
    dhs = (rng.normal(size=(B, T, H)) / 10).astype(np.float32)
    return [torch.from_numpy(a) for a in (wx, wh, b, x, dhs)]


def _tbe(a):
    return jnp.asarray(np.asarray(a).transpose(1, 0, 2))


@pytest.mark.parametrize("B,H,want", [
    (1, 128, (16, 8)), (256, 128, (16, 8)), (1024, 128, (16, 8)),
    (1025, 128, (32, 2)), (2048, 128, (32, 2)), (1, 8, (16, 1)),
    (2048, 8, (32, 1)), (5, 32, (16, 4)), (2048, 16, (32, 2)),
    (1, 80, (16, 2)), (2048, 80, (32, 2)), (1, 192, (16, 8)),
    (2048, 192, (32, 4)), (1, 256, (16, 8)), (2048, 256, (32, 8)),
    (1, 16, (16, 2))])
def test_f32_tiling_picks_the_preferred_cluster_that_fills_warps(B, H, want):
    """R by batch (16 up to 1024 rows, 32 above), then the first C of R's
    order whose blocks own a multiple of 8 units within 512 threads and a
    block's shared memory (H=192 at R=32: C=2 needs 768 threads; H=256:
    C=4 needs 327,696 bytes)."""
    R, C = K.f32_tiling(B, H)
    assert (R, C) == want and (R, C) in K.F32_TILINGS
    assert (H // C) % 8 == 0 and K.f32_misfit(H, R, C) is None
    for earlier in K.F32_PREFERENCE[R][:K.F32_PREFERENCE[R].index(C)]:
        assert K.f32_misfit(H, R, earlier) is not None


def test_f32_tiling_sizes_at_config_4():
    """Config #4 (H=128): 128 cells' threads a block at R=16, C=8 (the
    forward's product cut over k into two groups: 256 threads) and 512 at
    R=32, C=2; the shared memory the kernels ask for (``f32_fwd_smem``,
    ``f32_rec_smem``: two mbarriers and the f32 slices and tiles)."""
    assert K.f32_threads(128, 16, 8) == 128
    assert K.f32_threads(128, 32, 2) == 512
    assert K.f32_fwd_ksplit(128, 16, 8) == 2
    assert K.f32_fwd_ksplit(128, 32, 2) == 1
    assert K.f32_fwd_ksplit(48, 16, 1) == 1  # 384 threads: no room for two
    assert K.f32_fwd_smem_bytes(128, 16, 8) == 16 + 4 * (
        128 * 64 + 2 * 128 * 16 + 4 * 16 * 16)
    assert K.f32_fwd_smem_bytes(128, 32, 2) == 163856
    assert K.f32_rec_smem_bytes(128, 16, 8) == 53264
    assert K.f32_rec_smem_bytes(128, 32, 2) == 196624


@pytest.mark.parametrize("H,R,C,threads,fwd,rec", [
    (80, 16, 2, 320, 61456, 71696), (192, 16, 8, 192, 104464, 104464),
    (192, 32, 4, 384, 196624, 221200), (256, 16, 8, 256, 172048, 172048),
    (256, 32, 8, 256, 196624, 213008)])
def test_f32_wider_tilings_fit_the_block(H, R, C, threads, fwd, rec):
    """The tilings built for H=80, 192 and 256: threads a block and the
    shared memory of the recurrence and the recurrent backward, each within
    512 threads and 232,448 bytes."""
    assert K.f32_threads(H, R, C) == threads <= K.F32_MAX_THREADS
    assert K.f32_fwd_smem_bytes(H, R, C) == fwd <= 232448
    assert K.f32_rec_smem_bytes(H, R, C) == rec <= 232448


@pytest.mark.parametrize("E,H,what", [(5, 8, "multiple of 4"),
                                      (64, 12, "multiple of 8"),
                                      (64, 72, "512 threads"),
                                      (8, 120, "512 threads"),
                                      (64, 512, "shared memory")])
def test_f32_widths_the_kernels_refuse(E, H, what):
    """Widths no built tiling holds: the kernels' contract, which padding
    at the model boundary reaches around (H=72 runs at 80, H=120 at 128);
    H=512 fits no portable cluster and stays refused."""
    with pytest.raises(ValueError, match=what):
        K.check_f32_widths(E, H)


@pytest.mark.parametrize("E,H", [(64, 128), (8, 8), (16, 16), (128, 128),
                                 (32, 48), (4, 64), (64, 80), (8, 192),
                                 (64, 256)])
def test_f32_widths_the_kernels_take(E, H):
    """Config #4, the card tests' E=H=8 and every E a multiple of 4 (the
    x . Wx product reads E in 16-byte vectors; the recurrence never holds
    x), among them E=H=128, and the wider tilings' H=80, 192 and 256."""
    K.check_f32_widths(E, H)


@pytest.mark.parametrize("E,H", [(8, 8), (12, 32)])
def test_f32_xproj_layout_puts_a_units_four_gates_side_by_side(E, H):
    """Column 4 k + g of ``wxp`` (and entry 4 k + g of ``bp``) is packed
    column g H + k, exactly."""
    wx, _wh, b, _x, _dhs = _inputs(2, 1, E, H)
    wxp, bp = K.f32_xproj_layout(wx, b)
    assert wxp.shape == (E, 4 * H) and wxp.is_contiguous()
    for k in range(H):
        for g in range(4):
            assert torch.equal(wxp[:, 4 * k + g], wx[:, g * H + k])
            assert bp[4 * k + g] == b[g * H + k]


@pytest.mark.parametrize("H,C", [(8, 1), (32, 4), (64, 8), (16, 2)])
def test_f32_fwd_weight_layout_gives_each_block_its_units(H, C):
    """``wl[c, k, u, g]`` is Wh[k, g H + c U + u], exactly."""
    _wx, wh, *_ = _inputs(1, 1, 4, H)
    wl = K.f32_fwd_weight_layout(wh, C)
    U = H // C
    assert wl.shape == (C, H, U, 4) and wl.is_contiguous()
    for c in range(C):
        for g in range(4):
            assert torch.equal(wl[c, :, :, g], wh[:, g * H + c * U:
                                                  g * H + (c + 1) * U])


@pytest.mark.parametrize("H,C", [(8, 1), (32, 4), (64, 8), (16, 2)])
def test_f32_rec_weight_layout_orders_a_threads_outputs(H, C):
    """Row j = 4 u' + g of block c holds, at offset (h U + s) CV + q, the
    weight of unit s + U (h CV + q) to block c's dpre column j (packed
    column g H + c U + u'), exactly."""
    _wx, wh, *_ = _inputs(1, 1, 4, H)
    whl = K.f32_rec_weight_layout(wh, C)
    U, CV = H // C, min(C, 4)
    assert whl.shape == (C, 4 * U, H) and whl.is_contiguous()
    for c in range(C):
        for u2 in range(U):
            for g in range(4):
                row = whl[c, 4 * u2 + g]
                for h in range(C // CV):
                    for s in range(U):
                        for q in range(CV):
                            unit = s + U * (h * CV + q)
                            assert (row[(h * U + s) * CV + q]
                                    == wh[unit, g * H + c * U + u2])


@pytest.mark.parametrize("stash", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_as_the_cluster_splits_it_equals_the_twin(shape, stash):
    """pre = x . wxp + bp, then each block's four gates of its units from
    its slice: hs (and cs, gates) within atol 1e-6 of the twin (the same
    f32 arithmetic, the bias added before h . Wh instead of after)."""
    B, T, E, H, _R, C = shape
    wx, wh, b, x, _dhs = _inputs(B, T, E, H)
    got = K.lstm_fwd_f32_layout_plain(*K.f32_xproj_layout(wx, b),
                                      K.f32_fwd_weight_layout(wh, C), x,
                                      stash)
    ref = K.lstm_fwd_stash_plain(wx, wh, b, x)
    if not stash:
        got, ref = (got,), ref[:1]
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_forward_as_the_cluster_splits_it_matches_jax_run_fwd(shape):
    """The same against the JAX ``_run_fwd(..., stash=True,
    interpret=True)``: hs, cs, gates within rtol = atol = 1e-5."""
    B, T, E, H, _R, C = shape
    wx, wh, b, x, _dhs = _inputs(B, T, E, H)
    got = K.lstm_fwd_f32_layout_plain(*K.f32_xproj_layout(wx, b),
                                      K.f32_fwd_weight_layout(wh, C), x, True)
    ref = JL._run_fwd(jnp.asarray(wx.numpy()), jnp.asarray(wh.numpy()),
                      jnp.asarray(b.numpy()), _tbe(x), interpret=True,
                      stash=True)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r).transpose(1, 0, 2),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_serial_half_as_the_cluster_splits_it_equals_the_twin(shape):
    """dpre [B, T, 4H] (f32: no rounding) and the f32 db partials of the
    R-row tiles, from the per-block partials of dh summed in rank order:
    within atol 1e-6 of ``lstm_bwd_recurrent_plain`` at R rows a tile."""
    B, T, E, H, R, C = shape
    wx, wh, b, x, dhs = _inputs(B, T, E, H)
    _hs, cs, gates = K.lstm_fwd_stash_plain(wx, wh, b, x)
    dpre, dbp = K.lstm_bwd_recurrent_f32_layout_plain(
        K.f32_rec_weight_layout(wh, C), cs, gates, dhs, R)
    ref_dpre, ref_dbp = K.lstm_bwd_recurrent_plain(wh, cs, gates, dhs, R)
    assert dpre.dtype == torch.float32 and dbp.shape == (-(-B // R), 4 * H)
    assert ref_dbp.shape == dbp.shape
    torch.testing.assert_close(dpre, ref_dpre, rtol=0, atol=1e-6)
    torch.testing.assert_close(dbp, ref_dbp, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_split_backward_equals_the_twin(shape):
    """The serial half at R rows a tile (the twin's split, and the
    cluster's), then the parallel half: dwx, dwh, db, dx within rtol 1e-5
    of each output's largest magnitude of ``lstm_bwd_plain``."""
    B, T, E, H, R, C = shape
    wx, wh, b, x, dhs = _inputs(B, T, E, H)
    hs, cs, gates = K.lstm_fwd_stash_plain(wx, wh, b, x)
    ref = K.lstm_bwd_plain(wx, wh, x, hs, cs, gates, dhs)
    for serial in (K.lstm_bwd_recurrent_plain(wh, cs, gates, dhs, R),
                   K.lstm_bwd_recurrent_f32_layout_plain(
                       K.f32_rec_weight_layout(wh, C), cs, gates, dhs, R)):
        got = K.lstm_bwd_wgrad_plain(wx, x, hs, *serial)
        for name, a, r in zip(("dwx", "dwh", "db", "dx"), got, ref):
            err = (a - r).abs().max() / r.abs().max()
            assert a.dtype == torch.float32 and err <= 1e-5, (name, err)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_f32_split_backward_matches_jax_bwd_kernel(shape):
    """The cluster's split against the JAX ``_bwd_kernel`` (through
    ``_lstm_bwd`` in interpret mode) on the same residuals and dhs: rtol =
    atol = 1e-5."""
    B, T, E, H, R, C = shape
    wx, wh, b, x, dhs = _inputs(B, T, E, H)
    hs, cs, gates = K.lstm_fwd_stash_plain(wx, wh, b, x)
    got = K.lstm_bwd_wgrad_plain(
        wx, x, hs, *K.lstm_bwd_recurrent_f32_layout_plain(
            K.f32_rec_weight_layout(wh, C), cs, gates, dhs, R))
    res = (jnp.asarray(wx.numpy()), jnp.asarray(wh.numpy()),
           jnp.asarray(b.numpy()), _tbe(x), _tbe(hs), _tbe(cs), _tbe(gates))
    dwx, dwh, db, dx = JL._lstm_bwd(True, res, _tbe(dhs))
    for a, r in zip(got, (dwx, dwh, db, np.asarray(dx).transpose(1, 0, 2))):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_f32_split_matches_jax_grad_of_pallas_lstm_seq(shape):
    """The cluster's forward and split backward end to end (dhs = the
    cotangent of hs) against ``jax.grad`` of the Pallas ``lstm_seq`` in
    interpret mode (its ``custom_vjp``): rtol = atol = 1e-5."""
    B, T, E, H, R, C = shape
    wx, wh, b, x, dhs = _inputs(B, T, E, H)
    hs, cs, gates = K.lstm_fwd_f32_layout_plain(
        *K.f32_xproj_layout(wx, b), K.f32_fwd_weight_layout(wh, C), x, True)
    dwx, dwh, db, dx = K.lstm_bwd_wgrad_plain(
        wx, x, hs, *K.lstm_bwd_recurrent_f32_layout_plain(
            K.f32_rec_weight_layout(wh, C), cs, gates, dhs, R))

    def f(wx_, wh_, b_, x_):
        return jnp.sum(JL.lstm_seq(wx_, wh_, b_, x_, interpret=True)
                       * jnp.asarray(dhs.numpy()))

    ref = jax.grad(f, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(t.numpy()) for t in (wx, wh, b, x)))
    for a, r in zip((dwx, dwh, db, dx), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_bf16_serial_half_keeps_its_16_row_tiles():
    """``lstm_bwd_recurrent_plain`` without ``rows`` is the bf16 body's
    split as before: 16-row db partials, dpre rounded to bf16."""
    wx, wh, b, x, dhs = (t.to(torch.bfloat16) for t in _inputs(19, 3, 16, 16))
    _hs, cs, gates = K.lstm_fwd_stash_plain(wx, wh, b, x)
    dpre, dbp = K.lstm_bwd_recurrent_plain(wh, cs, gates, dhs)
    assert dpre.dtype == torch.bfloat16 and dbp.dtype == torch.float32
    assert dbp.shape == (2, 64) and K.BF16_ROWS == 16
    assert torch.equal(dbp, K.lstm_bwd_recurrent_plain(wh, cs, gates, dhs,
                                                       K.BF16_ROWS)[1])


def test_f32_tilings_mirror_the_kernels_header():
    """``F32_TILINGS`` and ``F32_ROWS_PER_THREAD`` name the (R, C) pairs
    and rows a thread that ``csrc/lstm_f32.cuh`` builds, in its order."""
    import pathlib
    import re

    src = (pathlib.Path(K.__file__).resolve().parents[2] / "csrc"
           / "lstm_f32.cuh").read_text()
    line = re.search(r"#define LSTM_F32_TILINGS\(X\)(.*)", src).group(1)
    pairs = tuple((int(r), int(c))
                  for r, c in re.findall(r"X\((\d+), (\d+)\)", line))
    assert pairs == K.F32_TILINGS
    assert "return R == 16 ? 2 : 4;" in src
    assert K.F32_ROWS_PER_THREAD == {16: 2, 32: 4}
    assert "constexpr int kThreads = 512;" in src
    assert K.F32_MAX_THREADS == 512


def test_f32_max_threads_mirror_the_kernels_header():
    """``f32_max_threads`` names the block sizes ``csrc/lstm_f32.cuh``
    builds the recurrent backward for: 256 at (32, 8), 512 elsewhere; no
    width that fits (32, 8)'s shared memory needs more than 256."""
    import pathlib

    src = (pathlib.Path(K.__file__).resolve().parents[2] / "csrc"
           / "lstm_f32.cuh").read_text()
    assert "return R == 32 && C == 8 ? 256 : kThreads;" in src
    for R, C in K.F32_TILINGS:
        assert K.f32_max_threads(R, C) == (256 if (R, C) == (32, 8) else 512)
    for H in range(64, 513, 8):
        if K.f32_misfit(H, 32, 8) is None:
            assert K.f32_threads(H, 32, 8) <= 256
        if K.f32_threads(H, 32, 8) > 256 and H % 64 == 0:
            assert K.f32_misfit(H, 32, 8) is not None
