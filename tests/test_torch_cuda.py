"""The port's CUDA kernels on the card, against their plain PyTorch twins.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, so it also runs on a machine
that has none (``tests/conftest.py`` imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.ops.kernels import flash_attention as FA
from distkeras_tpu_torch.ops.kernels import fold as F
from distkeras_tpu_torch.ops.kernels import groupnorm as G
from distkeras_tpu_torch.ops.kernels import lstm as K
from distkeras_tpu_torch.ops.kernels.flash_flips import (
    backward_flips, forward_flips)

pytestmark = pytest.mark.cuda

#: the IMDB classifier's serving widths
E, H, T = 64, 128, 200


@pytest.fixture
def packed():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    wx = (torch.randn(E, 4 * H, generator=g) / 8).cuda()
    wh = (torch.randn(H, 4 * H, generator=g) / 11).cuda()
    b = (torch.randn(4 * H, generator=g) / 10).cuda()
    return wx, wh, b, g


@pytest.mark.parametrize("B", [1, 3, 131])
def test_kernel_matches_plain_on_card(packed, B):
    """Batches below one 16-row tile (1, 3) and a ragged last tile (131);
    atol 1e-5 on hs in (-1, 1): the same f32 arithmetic summed in another
    order over 200 steps."""
    wx, wh, b, g = packed
    x = torch.randn(B, T, E, generator=g).cuda()
    before = K.launch_counts()["lstm_fwd"]
    got = K.lstm_seq(wx, wh, b, x)
    torch.cuda.synchronize()
    assert K.launch_counts()["lstm_fwd"] == before + 1
    torch.testing.assert_close(got, K.lstm_seq_plain(wx, wh, b, x),
                               rtol=0, atol=1e-5)


def test_kernel_refuses_what_it_does_not_take(packed):
    wx, wh, b, g = packed
    x = torch.randn(2, T, E, generator=g).cuda()
    before = K.launch_counts()
    with pytest.raises(TypeError, match="one dtype"):
        K.lstm_seq(wx, wh, b, x.to(torch.bfloat16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.lstm_seq(wx.half(), wh.half(), b.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        K.lstm_seq(wx, wh, b, x.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="CUDA device"):
        K.lstm_seq(wx, wh, b.cpu(), x)
    with pytest.raises(ValueError, match="CUDA device"):
        K.lstm_seq(wx.clone().requires_grad_(), wh, b.cpu(), x)
    assert K.launch_counts() == before


def _grad_err(got, ref) -> float:
    """Largest error relative to the reference's largest magnitude."""
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def test_gradient_on_card_runs_stash_forward_and_backward_kernels(packed):
    """A gradient through lstm_seq on the card launches the stash forward
    and the BPTT kernel once each (never the plain loop under autograd),
    and matches autograd through the plain loop: rtol 1e-4 of each
    gradient's largest magnitude (f32 sums over B*T = 3*200 rows and 4H
    gate columns, in another order)."""
    wx, wh, b, g = packed
    x = torch.randn(3, T, E, generator=g).cuda()
    params = [t.clone().requires_grad_() for t in (wx, wh, b, x)]
    before = K.launch_counts()
    hs = K.lstm_seq(*params)
    got = torch.autograd.grad(hs[:, -1].square().sum(), params)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["lstm_fwd_stash"] == before["lstm_fwd_stash"] + 1
    assert after["lstm_bwd"] == before["lstm_bwd"] + 1
    assert after["lstm_fwd"] == before["lstm_fwd"]
    ref_params = [t.clone().requires_grad_() for t in (wx, wh, b, x)]
    ref_hs = K.lstm_seq_plain(*ref_params)
    ref = torch.autograd.grad(ref_hs[:, -1].square().sum(), ref_params)
    for a, r in zip(got, ref):
        assert _grad_err(a, r) <= 1e-4


@pytest.mark.parametrize("B", [1, 3, 131])
def test_stash_forward_matches_plain_on_card(packed, B):
    """hs, cs, gates of the stash kernel against the plain twin, atol 1e-5
    (gates and hs in (-1, 1); cs grows at most by one a step, stays small
    at these weights)."""
    wx, wh, b, g = packed
    x = torch.randn(B, T, E, generator=g).cuda()
    got = K.lstm_fwd_stash_cuda(wx, wh, b, x)
    torch.cuda.synchronize()
    for a, r in zip(got, K.lstm_fwd_stash_plain(wx, wh, b, x)):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B", [1, 3, 131])
def test_backward_matches_plain_on_card(packed, B):
    """dwx, dwh, db, dx of the BPTT kernel against the plain twin on the
    same residuals and a dense random dhs: rtol 1e-4 of each output's
    largest magnitude; two calls give the same bits (no float atomics)."""
    wx, wh, b, g = packed
    x = torch.randn(B, T, E, generator=g).cuda()
    hs, cs, gates = K.lstm_fwd_stash_plain(wx, wh, b, x)
    dhs = (torch.randn(B, T, H, generator=g) / 10).cuda()
    got = K.lstm_bwd_cuda(wx, wh, x, hs, cs, gates, dhs)
    again = K.lstm_bwd_cuda(wx, wh, x, hs, cs, gates, dhs)
    torch.cuda.synchronize()
    ref = K.lstm_bwd_plain(wx, wh, x, hs, cs, gates, dhs)
    for a, a2, r in zip(got, again, ref):
        assert torch.equal(a, a2)
        assert _grad_err(a, r) <= 1e-4


#: batches on each side of the f32 tiling's switch (``K.f32_tiling``),
#: each with a ragged last tile: 1000 rows are 62 16-row tiles and 8 rows,
#: 1100 are 34 32-row tiles and 12 rows.
F32_SWITCH_BATCHES = [K.F32_LARGE_FROM - 25, K.F32_LARGE_FROM + 75]


@pytest.mark.parametrize("B", F32_SWITCH_BATCHES)
def test_f32_kernels_on_each_side_of_the_tiling_switch(packed, B):
    """The f32 forward, stash forward and backward at a batch of each
    tiling, ragged: hs, cs, gates within atol 1e-5 of the twins (as above);
    dwx, dwh, db, dx within rtol 1e-4 of each output's largest magnitude of
    the twin on the same residuals; two backward calls give the same
    bits."""
    wx, wh, b, g = packed
    R, _C = K.f32_tiling(B, H)
    assert B % R and R == (K.F32_LARGE_ROWS if B >= K.F32_LARGE_FROM
                           else K.F32_SMALL_ROWS)
    x = torch.randn(B, T, E, generator=g).cuda()
    dhs = (torch.randn(B, T, H, generator=g) / 10).cuda()
    hs = K.lstm_fwd_cuda(wx, wh, b, x)
    stash = K.lstm_fwd_stash_cuda(wx, wh, b, x)
    got = K.lstm_bwd_cuda(wx, wh, x, *stash, dhs)
    again = K.lstm_bwd_cuda(wx, wh, x, *stash, dhs)
    torch.cuda.synchronize()
    ref = K.lstm_fwd_stash_plain(wx, wh, b, x)
    for a, r in zip((hs, *stash), (ref[0], *ref)):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-5)
    for a, a2, r in zip(got, again,
                        K.lstm_bwd_plain(wx, wh, x, *stash, dhs)):
        assert torch.equal(a, a2)
        assert _grad_err(a, r) <= 1e-4


#: the f32 body's C entry points: the forward, the stash forward and the
#: backward's two halves.
F32_ENTRIES = ("lstm_fwd_f32", "lstm_fwd_stash_f32", "lstm_bwd_recurrent_f32",
               "lstm_bwd_wgrad_f32")


def test_f32_entry_points_launch_once_per_wrapper_call(packed):
    """Inference launches ``lstm_fwd_f32`` once; a gradient launches the
    stash forward once and each half of the backward once, counted as one
    ``lstm_bwd``; nothing else of the LSTM launches."""
    wx, wh, b, g = packed
    x = torch.randn(5, T, E, generator=g).cuda()
    K.reset_launches()
    with torch.inference_mode():
        K.lstm_seq(wx, wh, b, x)
    params = [t.clone().requires_grad_() for t in (wx, wh, b, x)]
    hs = K.lstm_seq(*params)
    torch.autograd.grad(hs[:, -1].square().sum(), params)
    torch.cuda.synchronize()
    launched = {k: v for k, v in K.launch_counts(by_entry=True).items() if v}
    assert launched == dict.fromkeys(F32_ENTRIES, 1)
    assert K.launch_counts() == {"lstm_fwd": 1, "lstm_fwd_stash": 1,
                                 "lstm_bwd": 1}


@pytest.mark.parametrize("E_,H_,what", [(6, 128, "multiple of 4"),
                                        (64, 12, "multiple of 8"),
                                        (64, 72, "512 threads"),
                                        (8, 120, "512 threads")])
def test_f32_widths_the_kernels_refuse_raise(card, E_, H_, what):
    """Widths the earlier scalar f32 body took (4H <= 512) and the cluster
    body does not: every f32 wrapper raises a ValueError naming the
    constraint, and nothing launches (no other body, no twin)."""
    g = torch.Generator().manual_seed(0)
    wx, wh, b = (torch.randn(*s, generator=g).cuda()
                 for s in ((E_, 4 * H_), (H_, 4 * H_), (4 * H_,)))
    x = torch.randn(2, 3, E_, generator=g).cuda()
    res = [torch.zeros(2, 3, n, device="cuda") for n in (H_, H_, 4 * H_, H_)]
    before = K.launch_counts(by_entry=True)
    for call in (lambda: K.lstm_fwd_cuda(wx, wh, b, x),
                 lambda: K.lstm_fwd_stash_cuda(wx, wh, b, x),
                 lambda: K.lstm_bwd_cuda(wx, wh, x, *res)):
        with pytest.raises(ValueError, match=what):
            call()
    assert K.launch_counts(by_entry=True) == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("B,N,C,relu", [(3, 56 * 56, 64, True),
                                        (2, 7 * 7, 2048, False)])
def test_group_norm_kernels_match_plain_on_card(card, B, N, C, relu):
    """ResNet-50 slabs with C = 64 and C = 2048 (32 groups): y within atol
    1e-5 of the plain twin (f32 statistics over up to 6,272 elements a
    group, summed in another order); dx, dgamma, dbeta within 1e-4 of each
    output's largest magnitude; two backward calls give the same bits."""
    g = torch.Generator().manual_seed(0)
    x, dy = (torch.randn(B, N, C, generator=g).cuda() for _ in range(2))
    gamma, beta = (torch.randn(C, generator=g).cuda() for _ in range(2))
    # dy = 0 where the pre-ReLU output is within 1e-3 of 0: there the two
    # versions' statistics, summed in another order, may mask differently.
    pre = G.group_norm_fwd_plain(x, gamma, beta, 32, False)
    dy = torch.where(pre.abs() > 1e-3, dy, torch.zeros_like(dy))
    before = G.launch_counts()
    y = G.group_norm_fwd_cuda(x, gamma, beta, 32, relu)
    got = G.group_norm_bwd_cuda(x, dy, gamma, beta, 32, relu)
    again = G.group_norm_bwd_cuda(x, dy, gamma, beta, 32, relu)
    torch.cuda.synchronize()
    after = G.launch_counts()
    assert after["group_norm_fwd"] == before["group_norm_fwd"] + 1
    assert after["group_norm_bwd"] == before["group_norm_bwd"] + 2
    torch.testing.assert_close(
        y, G.group_norm_fwd_plain(x, gamma, beta, 32, relu), rtol=0,
        atol=1e-5)
    ref = G.group_norm_bwd_plain(x, dy, gamma, beta, 32, relu)
    for a, a2, r in zip(got, again, ref):
        assert torch.equal(a, a2)
        assert _grad_err(a, r) <= 1e-4


def test_group_norm_refuses_what_it_does_not_take(card):
    x = torch.randn(2, 4, 4, 64, device="cuda")
    gamma, beta = torch.ones(64, device="cuda"), torch.zeros(64,
                                                            device="cuda")
    before = G.launch_counts()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        G.group_norm(x.double(), gamma.double(), beta.double(), groups=8)
    with pytest.raises(ValueError, match="contiguous"):
        G.group_norm(x.transpose(1, 2), gamma, beta, groups=8)
    with pytest.raises(ValueError, match="CUDA device"):
        G.group_norm(x, gamma.cpu(), beta, groups=8)
    assert G.launch_counts() == before


def _check_group_norm_kernels(dtype, B, N, C, groups, relu):
    """y and the gradients of the kernels against the twins, f32 within
    atol 1e-5 (y) and 1e-4 of each gradient's largest magnitude, bf16
    within one bf16 ulp of each output's largest magnitude; dy zeroed
    within 1e-2 of the ReLU edge; two calls give the same bits."""
    g = torch.Generator().manual_seed(1)
    x, dy = (torch.randn(B, N, C, generator=g).cuda().to(dtype)
             for _ in range(2))
    gamma, beta = (torch.randn(C, generator=g).cuda().to(dtype)
                   for _ in range(2))
    pre = G.group_norm_fwd_plain(x, gamma, beta, groups, False).float()
    dy = torch.where(pre.abs() > 1e-2, dy, torch.zeros_like(dy))
    y = G.group_norm_fwd_cuda(x, gamma, beta, groups, relu)
    y2 = G.group_norm_fwd_cuda(x, gamma, beta, groups, relu)
    got = G.group_norm_bwd_cuda(x, dy, gamma, beta, groups, relu)
    again = G.group_norm_bwd_cuda(x, dy, gamma, beta, groups, relu)
    torch.cuda.synchronize()
    ref = (G.group_norm_fwd_plain(x, gamma, beta, groups, relu),
           *G.group_norm_bwd_plain(x, dy, gamma, beta, groups, relu))
    assert torch.equal(y, y2)
    for a, a2 in zip(got, again):
        assert torch.equal(a, a2)
    for k, (a, r) in enumerate(zip((y, *got), ref)):
        assert a.dtype == dtype
        if dtype == torch.bfloat16:
            assert _grad_err(a.float(), r.float()) <= BF16_ULP
        elif k == 0:
            torch.testing.assert_close(a, r, rtol=0, atol=1e-5)
        else:
            assert _grad_err(a, r) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,C,groups,relu", [
    (2, 112 * 112, 64, 32, True), (3, 16 * 16, 16, 8, True),
    (3, 8 * 8, 64, 8, False), (2, 5, 24, 8, True), (2, 7, 6, 3, False)])
def test_group_norm_kernels_at_the_stem_and_tiny_resnet_shapes(
        card, dtype, B, N, C, groups, relu):
    """The stem slab (clusters of 16 blocks, two an SM, every row cached),
    tiny_resnet's slabs (C=16 at 8 groups, C=64) and channels that take 8-
    and 4-byte vectors, at the wrappers' own tilings, held to the twins
    (:func:`_check_group_norm_kernels`)."""
    _check_group_norm_kernels(dtype, B, N, C, groups, relu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,relu", [
    (224 * 224, True), (224 * 224 + 3, False), (160 * 160, True),
    (160 * 160 + 7, False)])
def test_group_norm_kernels_past_the_cached_rows(card, dtype, N, relu):
    """Rows a block cannot keep in shared memory, read from global memory
    (L2) in every sweep: the stems of a 448x448 image (224x224x64), where
    16 blocks cache part of their rows in both kernels, and of a 320x320
    one (160x160x64), where the backward (x and dy) caches 868 of 1600
    rows a block in bf16 and the forward all; with a few rows more, so
    the last block's share is ragged. Held to the twins as the cached
    shapes are (:func:`_check_group_norm_kernels`)."""
    size = 2 if dtype == torch.bfloat16 else 4
    bwd = G.gn_tiling(N, 64, 32, size, True)
    assert bwd.cluster == 16 and bwd.cached < bwd.rows
    _check_group_norm_kernels(dtype, 2, N, 64, 32, relu)


#: widths the kernels refuse and ``lstm_seq`` pads on the card: (E, H, B)
#: per dtype; f32 H=192 and 256 at a batch of each tiling.
PADDED_WIDTHS = {torch.float32: [(5, 6, 3), (64, 72, 19), (64, 192, 5),
                                 (64, 192, 1100), (8, 256, 3)],
                 torch.bfloat16: [(5, 6, 3), (64, 72, 19), (128, 128, 19),
                                  (144, 64, 3)]}


@pytest.mark.parametrize("dtype,E_,H_,B", [
    (dt, *w) for dt, ws in PADDED_WIDTHS.items() for w in ws])
def test_lstm_seq_at_padded_widths_on_card(card, dtype, E_, H_, B):
    """``lstm_seq`` forward and gradient at widths the kernels take only
    padded (or, bf16 E=H=128 and E=144, through the xw body): against the
    twins at the caller's widths, f32 within ``KERNEL_ATOL`` 1e-5 (hs) and
    ``BWD_RTOL`` 1e-4 of each gradient's largest magnitude, bf16 within the
    LSTM's bf16 limits; one forward launch, then one stash forward and one
    backward."""
    g = torch.Generator().manual_seed(2)

    def draw(*size, scale=1.0):
        return (torch.randn(*size, generator=g) * scale).cuda().to(dtype)

    wx, wh = draw(E_, 4 * H_, scale=E_ ** -0.5), draw(H_, 4 * H_,
                                                     scale=H_ ** -0.5)
    b, x, dhs = draw(4 * H_, scale=0.1), draw(B, 40, E_), draw(B, 40, H_,
                                                               scale=0.1)
    K.reset_launches()
    with torch.no_grad():
        hs = K.lstm_seq(wx, wh, b, x)
    leaves = [t.clone().requires_grad_() for t in (wx, wh, b, x)]
    grads = torch.autograd.grad(K.lstm_seq(*leaves), leaves, dhs)
    torch.cuda.synchronize()
    assert K.launch_counts() == {"lstm_fwd": 1, "lstm_fwd_stash": 1,
                                 "lstm_bwd": 1}
    ref = K.lstm_seq_plain(wx, wh, b, x)
    plain = K.lstm_bwd_plain(wx, wh, x, *K.lstm_fwd_stash_plain(wx, wh, b,
                                                                x), dhs)
    assert hs.shape == ref.shape
    for a, r in zip(grads, plain):
        assert a.shape == r.shape and a.dtype == r.dtype
    if dtype == torch.float32:
        torch.testing.assert_close(hs, ref, rtol=0, atol=1e-5)
        for a, r in zip(grads, plain):
            assert _grad_err(a, r) <= 1e-4
    else:
        for a, r in ((hs, ref), *zip(grads, plain)):
            d, m = (a.float() - r.float()).abs(), r.float().abs()
            assert d.max() <= LSTM_BF16["top"] * m.max()
            assert d.mean() <= LSTM_BF16["mean"] * m.mean()


@pytest.mark.parametrize("dtype,E_,H_,what", [
    (torch.float32, 64, 512, "shared memory"),
    (torch.bfloat16, 64, 144, "H <= 128")])
def test_lstm_seq_refuses_widths_past_the_padding_on_card(card, dtype, E_,
                                                          H_, what):
    """f32 H > 256 and bf16 H > 128: a ValueError naming the constraint,
    nothing launched, never the twin."""
    wx, wh, b = (torch.zeros(*s, device="cuda", dtype=dtype)
                 for s in ((E_, 4 * H_), (H_, 4 * H_), (4 * H_,)))
    x = torch.zeros(2, 3, E_, device="cuda", dtype=dtype)
    K.reset_launches()
    with pytest.raises(ValueError, match=what):
        K.lstm_seq(wx, wh, b, x)
    with pytest.raises(ValueError, match=what):
        K.lstm_seq(*(t.clone().requires_grad_() for t in (wx, wh, b)), x)
    assert not any(K.launch_counts(by_entry=True).values())


def test_tiny_resnet_step_on_card_launches_the_group_norm_kernels(card):
    """One SingleTrainer step of tiny_resnet (9 GroupNorms: the stem, three
    in each of two blocks, two residual projections) launches each
    GroupNorm kernel 9 times, and the trained weights are finite."""
    from distkeras_tpu_torch import SingleTrainer, tiny_resnet
    from distkeras_tpu_torch.data import DataFrame

    model = tiny_resnet(norm_impl="pallas", device="cuda")
    rng = np.random.default_rng(0)
    df = DataFrame({"features": rng.uniform(size=(8, 32, 32, 3)).astype(
        np.float32), "label": rng.integers(0, 10, 8).astype(np.int32)})
    G.reset_launches()
    out = SingleTrainer(model, loss="sparse_categorical_crossentropy",
                        batch_size=8, steps_per_program=1).train(df)
    torch.cuda.synchronize()
    assert G.launch_counts() == {"group_norm_fwd": 9, "group_norm_bwd": 9}
    assert all(torch.isfinite(p).all() for p in out.params.values())


# -- bf16: the mixed-precision step's instantiations ----------------------

#: bf16 kernels vs their bf16 twins on the card, as shares of the twin's
#: largest (``top``) and mean (``mean``) magnitude. Both round at the same
#: points; the f32 sums run in another order, so now and then one rounding
#: flips by one bf16 ulp (2^-8 = 3.9e-3 of the value). GroupNorm has no
#: carry: one ulp of the largest magnitude is the limit. The LSTM feeds
#: the rounded h back for 200 steps and dh through the rounded dpre, so a
#: flip moves the next steps' sums by about an ulp times a weight and
#: flips more of them: the outputs drift by a few ulps (``top``), about an
#: ulp in the mean.
BF16_ULP = 2.0 ** -8
LSTM_BF16 = {"top": 8 * BF16_ULP, "mean": 2 * BF16_ULP}


def _bf16(*ts):
    return [t.to(torch.bfloat16) for t in ts]


#: bf16 batches: ragged (1, 3, 131), one 16-row tile and a tile and a row
#: (64, 65; the tile edges of the tensor-core bodies), and config #4's
#: training batch (2048: 128 blocks, one wave).
BF16_BATCHES = [1, 3, 64, 65, 131, 2048]


@pytest.mark.parametrize("B", BF16_BATCHES)
def test_bf16_forward_kernels_match_plain_on_card(packed, B):
    """``lstm_fwd_bf16`` and ``lstm_fwd_stash_bf16`` against the bf16
    twins: hs (and cs, gates) in bf16 within ``LSTM_BF16``."""
    wx, wh, b, g = packed
    x = torch.randn(B, T, E, generator=g).cuda()
    wx, wh, b, x = _bf16(wx, wh, b, x)
    before = K.launch_counts(by_entry=True)
    hs = K.lstm_seq(wx, wh, b, x)
    stash = K.lstm_fwd_stash_cuda(wx, wh, b, x)
    torch.cuda.synchronize()
    after = K.launch_counts(by_entry=True)
    assert after["lstm_fwd_bf16"] == before["lstm_fwd_bf16"] + 1
    assert after["lstm_fwd_stash_bf16"] == before["lstm_fwd_stash_bf16"] + 1
    ref = K.lstm_fwd_stash_plain(wx, wh, b, x)
    for name, got, r in zip(("hs", "stash hs", "cs", "gates"),
                            (hs, *stash), (ref[0], *ref)):
        assert got.dtype == torch.bfloat16, name
        top, mean = _flash_err(got, r)
        assert top <= LSTM_BF16["top"] and mean <= LSTM_BF16["mean"], (
            name, top, mean)


@pytest.mark.parametrize("B", BF16_BATCHES)
def test_bf16_backward_matches_plain_on_card(packed, B):
    """The bf16 backward (``lstm_bwd_recurrent_bf16`` then
    ``lstm_bwd_wgrad_bf16``) against the bf16 twin on the same bf16
    residuals and dhs: dwx, dwh, db, dx in bf16 within ``LSTM_BF16``; two
    calls give the same bits."""
    wx, wh, b, g = packed
    x = torch.randn(B, T, E, generator=g).cuda()
    dhs = (torch.randn(B, T, H, generator=g) / 10).cuda()
    wx, wh, b, x, dhs = _bf16(wx, wh, b, x, dhs)
    hs, cs, gates = K.lstm_fwd_stash_plain(wx, wh, b, x)
    before = K.launch_counts(by_entry=True)
    got = K.lstm_bwd_cuda(wx, wh, x, hs, cs, gates, dhs)
    again = K.lstm_bwd_cuda(wx, wh, x, hs, cs, gates, dhs)
    torch.cuda.synchronize()
    after = K.launch_counts(by_entry=True)
    for entry in BWD_BF16_ENTRIES:
        assert after[entry] == before[entry] + 2, entry
    ref = K.lstm_bwd_plain(wx, wh, x, hs, cs, gates, dhs)
    for name, a, a2, r in zip(("dwx", "dwh", "db", "dx"), got, again, ref):
        assert a.dtype == torch.bfloat16 and torch.equal(a, a2), name
        top, mean = _flash_err(a, r)
        assert top <= LSTM_BF16["top"] and mean <= LSTM_BF16["mean"], (
            name, top, mean)


#: the bf16 backward's two C entry points, one launch each a backward.
BWD_BF16_ENTRIES = ("lstm_bwd_recurrent_bf16", "lstm_bwd_wgrad_bf16")


def test_bf16_backward_launches_each_entry_once(packed):
    """One bf16 backward through autograd launches the stash forward once,
    each of the backward's two entry points once and counts one
    ``lstm_bwd``; nothing else of the LSTM launches."""
    wx, wh, b, g = packed
    x = torch.randn(5, T, E, generator=g).cuda()
    params = [t.to(torch.bfloat16).requires_grad_() for t in (wx, wh, b, x)]
    K.reset_launches()
    hs = K.lstm_seq(*params)
    torch.autograd.grad(hs[:, -1].float().square().sum(), params)
    torch.cuda.synchronize()
    launched = {k: v for k, v in K.launch_counts(by_entry=True).items() if v}
    assert launched == {"lstm_fwd_stash_bf16": 1,
                        **dict.fromkeys(BWD_BF16_ENTRIES, 1)}
    assert K.launch_counts() == {"lstm_fwd": 0, "lstm_fwd_stash": 1,
                                 "lstm_bwd": 1}


@pytest.mark.parametrize("E_,H_,what", [(24, 128, "multiples of 16"),
                                        (64, 40, "multiples of 16"),
                                        (8, 64, "multiples of 16"),
                                        (64, 144, "H <= 128"),
                                        (128, 256, "H <= 128")])
def test_bf16_widths_the_kernels_refuse_raise(card, E_, H_, what):
    """Widths the bf16 tensor-core kernels do not take (E or H off the mma
    k-tile, H past the 16 units a warp owns): every bf16 wrapper raises a
    ValueError naming the constraint, and nothing launches (no quiet
    switch to another body or to the twin)."""
    g = torch.Generator().manual_seed(0)
    wx, wh, b = (torch.randn(*s, generator=g).cuda().bfloat16()
                 for s in ((E_, 4 * H_), (H_, 4 * H_), (4 * H_,)))
    x = torch.randn(2, 3, E_, generator=g).cuda().bfloat16()
    res = [torch.zeros(2, 3, n, device="cuda", dtype=torch.bfloat16)
           for n in (H_, H_, 4 * H_, H_)]
    before = K.launch_counts(by_entry=True)
    for call in (lambda: K.lstm_fwd_cuda(wx, wh, b, x),
                 lambda: K.lstm_fwd_stash_cuda(wx, wh, b, x),
                 lambda: K.lstm_bwd_cuda(wx, wh, x, *res)):
        with pytest.raises(ValueError, match=what):
            call()
    assert K.launch_counts(by_entry=True) == before


@pytest.mark.parametrize("B,N,C,relu", [(3, 56 * 56, 64, True),
                                        (2, 7 * 7, 2048, False)])
def test_bf16_group_norm_kernels_match_plain_on_card(card, B, N, C, relu):
    """``group_norm_fwd_bf16`` and ``group_norm_bwd_bf16`` against the
    bf16 twins: y, dx, dgamma, dbeta in bf16 within one bf16 ulp of each
    one's largest magnitude (dy zeroed within 1e-2 of the ReLU edge, where
    a statistic summed in another order may mask otherwise)."""
    g = torch.Generator().manual_seed(0)
    x, dy = (torch.randn(B, N, C, generator=g).cuda() for _ in range(2))
    gamma, beta = (torch.randn(C, generator=g).cuda() for _ in range(2))
    x, dy, gamma, beta = _bf16(x, dy, gamma, beta)
    pre = G.group_norm_fwd_plain(x, gamma, beta, 32, False).float()
    dy = torch.where(pre.abs() > 1e-2, dy, torch.zeros_like(dy))
    before = G.launch_counts(by_entry=True)
    y = G.group_norm_fwd_cuda(x, gamma, beta, 32, relu)
    got = G.group_norm_bwd_cuda(x, dy, gamma, beta, 32, relu)
    again = G.group_norm_bwd_cuda(x, dy, gamma, beta, 32, relu)
    torch.cuda.synchronize()
    after = G.launch_counts(by_entry=True)
    assert after["group_norm_fwd_bf16"] == before["group_norm_fwd_bf16"] + 1
    assert after["group_norm_bwd_bf16"] == before["group_norm_bwd_bf16"] + 2
    ref = (G.group_norm_fwd_plain(x, gamma, beta, 32, relu),
           *G.group_norm_bwd_plain(x, dy, gamma, beta, 32, relu))
    for name, a, r in zip(("y", "dx", "dgamma", "dbeta"), (y, *got), ref):
        assert a.dtype == torch.bfloat16, name
        assert _flash_err(a, r)[0] <= BF16_ULP, name
    for a, a2 in zip(got, again):
        assert torch.equal(a, a2)


def test_mixed_dtypes_raise_on_card(packed):
    """One dtype a call: a bf16 tensor among f32 ones (or the reverse)
    raises in every wrapper of this slice, and nothing launches."""
    wx, wh, b, g = packed
    x = torch.randn(2, T, E, generator=g).cuda()
    before = (K.launch_counts(by_entry=True), G.launch_counts(by_entry=True))
    with pytest.raises(TypeError, match="one dtype"):
        K.lstm_fwd_stash_cuda(wx.bfloat16(), wh, b, x)
    hs, cs, gates = K.lstm_fwd_stash_plain(wx, wh, b, x)
    with pytest.raises(TypeError, match="one dtype"):
        K.lstm_bwd_cuda(wx, wh, x, hs, cs, gates, hs.bfloat16())
    x3 = torch.randn(2, 16, 64, device="cuda")
    ones = torch.ones(64, device="cuda")
    with pytest.raises(TypeError, match="one dtype"):
        G.group_norm(x3.bfloat16(), ones, ones, groups=8)
    with pytest.raises(TypeError, match="one dtype"):
        G.group_norm_bwd_cuda(x3, x3.bfloat16(), ones, ones, 8, False)
    assert (K.launch_counts(by_entry=True),
            G.launch_counts(by_entry=True)) == before


def test_bf16_training_steps_launch_bf16_kernels_only(card):
    """``compute_dtype="bfloat16"`` on the card: a DynSGD step of a small
    LSTM, a SingleTrainer step of tiny_resnet and an AEASGD step of a
    2-layer flash transformer launch each kernel of their path, and only
    its bf16 instantiation; the master weights stay f32 and finite."""
    from distkeras_tpu_torch import (
        AEASGD,
        DynSGD,
        SingleTrainer,
        imdb_lstm,
        small_transformer_lm,
        tiny_resnet,
    )
    from distkeras_tpu_torch.data import DataFrame

    rng = np.random.default_rng(0)
    runs = []
    toks = rng.integers(0, 64, (4, 128))
    lm = DataFrame({"features": toks.astype(np.int32),
                    "label": np.roll(toks, -1, 1).astype(np.int32)})
    # two steps of 2 layers: the forward twice a layer under remat
    runs.append((FA, {"flash_fwd_bf16": 8, "flash_dq_bf16": 4,
                      "flash_dkv_bf16": 4},
                 lambda: AEASGD(small_transformer_lm(
                     vocab_size=64, num_layers=2, d_model=64, num_heads=2,
                     d_ff=64, max_seq_len=128, seq_len=128,
                     attn_impl="flash", remat=True, device="cuda"),
                     "adam", "sparse_categorical_crossentropy",
                     num_workers=1, batch_size=2, communication_window=2,
                     learning_rate=1e-4, rho=500.0,
                     compute_dtype="bfloat16").train(lm)))
    images = DataFrame({"features": rng.uniform(size=(8, 32, 32, 3)).astype(
        np.float32), "label": rng.integers(0, 10, 8).astype(np.int32)})
    runs.append((G, {"group_norm_fwd_bf16": 9, "group_norm_bwd_bf16": 9},
                 lambda: SingleTrainer(
                     tiny_resnet(norm_impl="pallas", device="cuda"),
                     loss="sparse_categorical_crossentropy", batch_size=8,
                     steps_per_program=1,
                     compute_dtype="bfloat16").train(images)))
    tokens = DataFrame({"features": rng.integers(0, 50, (16, 20)).astype(
        np.int32), "label": rng.integers(0, 2, 16).astype(np.int32)})
    runs.append((K, {"lstm_fwd_stash_bf16": 2,
                     **dict.fromkeys(BWD_BF16_ENTRIES, 2)},
                 lambda: DynSGD(
                     imdb_lstm(vocab_size=50, embed_dim=16, hidden_size=16,
                               seq_len=20, device="cuda"),
                     "sgd", "sparse_categorical_crossentropy",
                     num_workers=1, batch_size=8, communication_window=2,
                     learning_rate=0.1,
                     compute_dtype="bfloat16").train(tokens)))
    for mod, want, train in runs:
        mod.reset_launches()
        out = train()
        torch.cuda.synchronize()
        launched = {k: v for k, v in mod.launch_counts(by_entry=True).items()
                    if v}
        assert launched == want
        assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
                   for p in out.params.values())


def _wire(codec: str, n: int, g: torch.Generator):
    """A random wire tensor of ``codec`` on the card and its spec."""
    if codec == "int8":
        q = torch.randint(-127, 128, (n,), generator=g, dtype=torch.int8)
        return q.cuda(), {"codec": "int8", "scale": 0.0123}
    bits = (torch.randn(n, generator=g) / 100).view(torch.int32) >> 16
    return bits.to(torch.int16).cuda(), {"codec": "bf16"}


@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("n,offset", [(1_000_003, 0), (4099, 0), (3, 0),
                                      (70_001, 1), (70_001, 3)])
def test_fold_kernel_bit_equal_to_plain_on_card(card, codec, n, offset):
    """The fold kernel against its plain twin, bit for bit (the product
    and the sum rounded apart, no FMA): a ragged n (not a multiple of the
    8-element vector), and centers that start 1 or 3 floats into their
    storage, so the pointers are misaligned and the scalar path runs."""
    g = torch.Generator().manual_seed(n + offset)
    base = torch.randn(n + offset, generator=g).cuda()
    center = base[offset:]
    head = base[:offset].clone()
    q, spec = _wire(codec, n, g)
    ref = center.clone()
    s = F.fold_scale(codec, spec, 1.0 / 3.0)
    F.fold_compressed_plain_(ref, q, codec, s)
    before = F.launch_counts()[f"fold_{codec}"]
    F.fold_compressed_(center, q, spec, 1.0 / 3.0)
    torch.cuda.synchronize()
    assert F.launch_counts()[f"fold_{codec}"] == before + 1
    assert torch.equal(center, ref)
    assert torch.equal(base[:offset], head)  # nothing before it written


def test_fold_refuses_what_it_does_not_take(card):
    q = torch.ones(8, dtype=torch.int8, device="cuda")
    spec = {"codec": "int8", "scale": 1.0}
    before = F.launch_counts()
    with pytest.raises(ValueError, match="one device"):
        F.fold_compressed_(torch.ones(8, device="cuda"), q.cpu(), spec, 1.0)
    with pytest.raises(TypeError, match="float32"):
        F.fold_compressed_(torch.ones(8, device="cuda").half(), q, spec, 1.0)
    assert F.launch_counts() == before


def _commit_on_card(g: torch.Generator, sizes, offsets, spare: int = 5):
    """Centers as views of one flat card tensor at ``offsets`` (with
    ``spare`` floats after the last), and a mixed commit for them as the
    wire carries it: int8 (one all-zero, spec scale 0), bf16, plain f32
    with inf and -inf, empty and ragged entries, cycling by index."""
    from distkeras_tpu_torch.netps import wire

    flat = torch.randn(max(o + n for o, n in zip(offsets, sizes)) + spare,
                       generator=g).cuda()
    centers = [flat[o:o + n] for o, n in zip(offsets, sizes)]
    entries = []
    for i, n in enumerate(sizes):
        d = (torch.randn(n, generator=g) / 100).numpy()
        kind = i % 4
        if kind == 3 and n:
            d[0], d[-1] = np.inf, -np.inf
        if i == 4:
            d[:] = 0.0
        entries.append(wire.codec_encode(d, ("int8", "bf16", "none",
                                             "int8")[kind]))
    return flat, centers, entries


@pytest.mark.parametrize("layout", ["seated", "misaligned"])
def test_commit_kernel_bit_equal_to_plain_on_card(card, layout):
    """One ``fold_commit`` launch folds a whole mixed commit (int8, a zero
    scale, bf16, plain f32 with inf, an empty tensor, ragged sizes from 1
    to 2,359,296 elements), bit for bit like its plain twin on the same
    staged buffer and like the numpy oracle on the host; every center
    either at ``center_layout``'s 64-byte offsets (the server's, the vector
    body) or 1 and 3 floats off them (the scalar body, same launch), and
    no float between or after the views written."""
    from distkeras_tpu_torch.netps import fold as nfold

    g = torch.Generator().manual_seed(7)
    sizes = [2_359_296, 7, 0, 4099, 1, 70_001, 33 * 5, 16, 1_000_003]
    offsets, _ = F.center_layout(sizes)
    if layout == "misaligned":
        offsets, end = [], 0
        for i, n in enumerate(sizes):
            offsets.append(-(-end // 16) * 16 + (1 if i % 2 else 3))
            end = offsets[-1] + n
    flat, centers, entries = _commit_on_card(g, sizes, offsets)
    twin_flat = flat.clone()
    twin = [twin_flat[o:o + n] for o, n in zip(offsets, sizes)]
    host = [c.cpu().numpy() for c in centers]
    staged = nfold.stage_commit(entries, "cuda", offsets=offsets)
    F.reset_launches()
    F.fold_commit_(centers, staged, 1.0 / 3.0)
    torch.cuda.synchronize()
    assert F.launch_counts() == {"fold_commit": 1, "fold_int8": 0,
                                 "fold_bf16": 0}
    F.fold_commit_plain_(twin, staged, 1.0 / 3.0)
    assert torch.equal(flat.view(torch.int32), twin_flat.view(torch.int32))
    for h, e in zip(host, entries):
        a, spec = nfold.split_entry(e)
        if spec:
            nfold.fold_compressed_numpy(h, a, spec, 1.0 / 3.0)
        else:
            h += np.float32(1.0 / 3.0) * a
    for c, h in zip(centers, host):
        assert np.array_equal(c.cpu().numpy().view(np.uint32),
                              h.view(np.uint32))


def test_fold_delta_on_card_stages_where_the_centers_lie(card):
    """``fold_delta`` given plain entries and centers that are separate
    card tensors stages the commit against the centers' own addresses and
    folds it in one launch, as the twin does on the CPU copies."""
    from distkeras_tpu_torch.netps import fold as nfold

    g = torch.Generator().manual_seed(3)
    sizes = [513, 9, 40_000]
    _flat, _c, entries = _commit_on_card(g, sizes, F.center_layout(sizes)[0])
    centers = [torch.randn(n, generator=g).cuda() for n in sizes]
    cpu = [c.cpu() for c in centers]
    F.reset_launches()
    nfold.fold_delta(centers, entries, "dynsgd", 2)
    nfold.fold_delta(cpu, entries, "dynsgd", 2)
    torch.cuda.synchronize()
    assert F.launch_counts()["fold_commit"] == 1
    for c, h in zip(centers, cpu):
        assert torch.equal(c.cpu().view(torch.int32), h.view(torch.int32))


def test_server_works_on_its_own_stream_on_card(card, monkeypatch):
    """A ``PSServer`` on the card launches its fold on a stream of its own,
    not the default one, at a higher priority; and a commit and a pull
    answer while a long multi-block kernel still runs on the default
    stream (a non-blocking stream does not wait for it)."""
    from distkeras_tpu_torch.netps import PSClient, PSServer

    streams = []
    real = F._LIB.launch

    def recording(entry, *args):
        streams.append(torch.cuda.current_stream().cuda_stream)
        return real(entry, *args)

    monkeypatch.setattr(F._LIB, "launch", recording)
    init = [np.zeros(4096, np.float32), np.ones(3, np.float32)]
    delta = [np.full(4096, 0.25, np.float32), np.full(3, 1.0, np.float32)]
    srv = PSServer(discipline="adag", device="cuda").start()
    # Outputs allocated up front: a device or pinned allocation between two
    # launches is an implicit synchronization of the whole card.
    big, out, out2 = (torch.randn(16384, 16384, device="cuda")
                      for _ in range(3))
    try:
        with PSClient(srv.endpoint, worker_id=0, timeout=30.0,
                      compress="int8") as c:
            _, upd = c.join(init=init)
            # a first commit and pull leave the server's staging and
            # mirror buffers cached, as they are in a run's steady state
            upd = c.commit(delta, upd).updates
            c.pull()
            torch.cuda.synchronize()
            long_done = torch.cuda.Event()
            torch.matmul(big, big, out=out)  # about 0.2 s each
            torch.matmul(out, big, out=out2)
            long_done.record()
            assert c.commit(delta, upd).applied
            center, _ = c.pull()
            still_running = not long_done.query()
        torch.cuda.synchronize()
        default = torch.cuda.default_stream().cuda_stream
        assert streams == [srv._stream.cuda_stream] * 2
        assert streams[0] != default
        assert srv._stream.priority < torch.cuda.default_stream().priority
        assert still_running, "the server waited on the default stream"
        np.testing.assert_allclose(center[0], 0.5, rtol=1e-2)
        np.testing.assert_allclose(center[1], 3.0, rtol=1e-2)
    finally:
        srv.close()
        del big, out, out2


def test_remote_run_on_card_folds_every_commit_through_the_kernel(
        card, monkeypatch):
    """A 2-round DynSGD remote= run with the server and the model on the
    card, int8 commits: one fold launch per folded commit (the whole commit,
    no tensor alone), the LSTM kernels once per local step, and the model
    is the center."""
    from distkeras_tpu_torch import DynSGD, imdb_lstm
    from distkeras_tpu_torch.data import DataFrame
    from distkeras_tpu_torch.netps import PSClient, PSServer

    monkeypatch.setenv("DKTPU_NET_COMPRESS", "int8")
    W, Kw, B, rounds = 2, 2, 8, 2
    model = imdb_lstm(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6,
                      device="cuda")
    rng = np.random.default_rng(0)
    n = W * Kw * B * rounds
    df = DataFrame({"features": rng.integers(0, 50, (n, 6)).astype(np.int32),
                    "label": rng.integers(0, 2, n).astype(np.int32)})
    srv = PSServer(discipline="dynsgd", device="cuda").start()
    try:
        F.reset_launches()
        K.reset_launches()
        out = DynSGD(model, worker_optimizer="sgd",
                     loss="sparse_categorical_crossentropy", num_workers=W,
                     batch_size=B, communication_window=Kw,
                     learning_rate=0.1, remote=srv.endpoint).train(df)
        torch.cuda.synchronize()
        with PSClient(srv.endpoint) as observer:
            assert observer.stats()["fold_backend"] == "cuda"
        center = srv.center()
        commits = len(srv.commit_log)
    finally:
        srv.close()
    tensors = len(model.params)
    assert commits == W * rounds, f"{srv.evictions} evictions"
    assert tensors == 6
    assert F.launch_counts() == {"fold_commit": commits, "fold_int8": 0,
                                 "fold_bf16": 0}
    counts = K.launch_counts()
    assert counts["lstm_fwd_stash"] == counts["lstm_bwd"] == W * rounds * Kw
    for p, c in zip(out.params.values(), center):
        assert np.array_equal(p.cpu().numpy(), c)


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_mesh_folder_on_card_is_the_numpy_oracle_bit_for_bit(card, codec):
    """The mesh dialect's fold entry on the card: one ``fold_commit``
    launch a commit, bit-equal to the JAX package's numpy oracle (copied
    into the port) for each codec, at two commit scales."""
    from distkeras_tpu_torch.netps import MeshFolder, wire
    from distkeras_tpu_torch.netps.fold import fold_compressed_numpy

    rng = np.random.default_rng(21)
    center = [rng.normal(size=s).astype(np.float32)
              for s in ((64, 33), (129,), (7, 5), (0,))]
    folder = MeshFolder([a.copy() for a in center], device="cuda")
    assert folder.backend == "cuda" and folder.views[0].is_cuda
    ref = [a.copy() for a in center]
    F.reset_launches()
    for scale in (1.0, 1.0 / 3.0):
        entries = []
        for r in ref:
            q, spec = wire.codec_encode(
                rng.normal(scale=0.1, size=r.shape).astype(np.float32),
                codec)
            entries.append((q, spec) if spec else q)
            if spec:
                fold_compressed_numpy(r, q, spec, scale)
            else:
                r += np.float32(scale) * q
        folder.fold(entries, scale)
    assert F.launch_counts()["fold_commit"] == 2
    for a, b in zip(folder.center_host(), ref):
        assert a.tobytes() == b.tobytes()
    folder.close()


@pytest.mark.parametrize("transport", ["shm", "mesh"])
def test_transports_on_card_fold_once_through_the_kernel(card, transport):
    """A server on the card serving the ring (``shm``) or the in-process
    dispatch (``mesh``): every commit of a client on that dialect folds
    once, one ``fold_commit`` launch each, into the card's center, which
    equals a TCP server's fed the same commits."""
    from distkeras_tpu_torch.netps import PSClient, PSServer

    def run(transport_):
        srv = PSServer(discipline="adag", device="cuda",
                       transport=transport_).start()
        rng = np.random.default_rng(3)
        init = [rng.normal(size=s).astype(np.float32)
                for s in ((64, 33), (129,))]
        try:
            with PSClient(srv.endpoint, worker_id=0, timeout=30.0,
                          transport=transport_) as c:
                center, upd = c.join(init=init)
                F.reset_launches()
                for _ in range(4):
                    c.commit([rng.normal(scale=0.1, size=a.shape)
                              .astype(np.float32) for a in center], upd)
                    center, upd = c.pull()
                launches = F.launch_counts()["fold_commit"]
                active = c.active_transport
            return srv.center(), launches, active, list(srv.commit_log)
        finally:
            srv.close()

    got, launches, active, log = run(transport)
    ref, _, _, _ = run("tcp")
    assert active == transport and launches == 4
    assert [s for _w, s, _t in log] == [0, 1, 2, 3]
    for a, b in zip(got, ref):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_striped_commits_on_card_fold_once(card, codec):
    """Two stripes a commit against a server on the card: the server
    assembles each commit and folds it with ONE ``fold_commit`` launch,
    into the center an unstriped client's identical commits give."""
    from distkeras_tpu_torch.netps import PSClient, PSServer

    def run(shards):
        rng = np.random.default_rng(4)
        init = [rng.normal(size=s).astype(np.float32)
                for s in ((64, 33), (129,), (7, 5))]
        srv = PSServer(center=init, discipline="adag", device="cuda").start()
        try:
            with PSClient(srv.endpoint, shards=shards, compress=codec,
                          timeout=30.0) as c:
                center, upd = c.join()
                assert c.active_shards == shards
                F.reset_launches()
                for _ in range(4):
                    c.commit([rng.normal(scale=0.1, size=a.shape)
                              .astype(np.float32) for a in center], upd)
                    center, upd = c.pull()
                launches = F.launch_counts()["fold_commit"]
            return srv.center(), launches, len(srv.commit_log)
        finally:
            srv.close()

    got, launches, folded = run(2)
    ref, _, _ = run(1)
    assert launches == folded == 4
    for a, b in zip(got, ref):
        assert a.tobytes() == b.tobytes()


def test_shard_set_on_card_folds_once_a_shard(card):
    """A 2-shard center on the card with a row-split tensor: one
    ``fold_commit`` launch a shard a commit, and the assembled center is
    bit-equal to one server's on the card fed the same commits."""
    from distkeras_tpu_torch.netps import (PartitionPlan, PSClient,
                                           PSServer, ShardedPSClient,
                                           ShardSet)

    rng = np.random.default_rng(8)
    init = [rng.normal(size=s).astype(np.float32)
            for s in ((96, 16), (33,), (8, 8))]
    deltas = [[rng.normal(scale=0.1, size=a.shape).astype(np.float32)
               for a in init] for _ in range(3)]
    plan = PartitionPlan.build(["embed", "bias", "w"],
                               [a.shape for a in init], 2,
                               rules=[("embed", "split")])
    ss = ShardSet(2, center=init, plan=plan, discipline="adag",
                  device="cuda").start()
    try:
        with ShardedPSClient(ss.endpoint, plan=plan, timeout=30.0) as c:
            _, counters = c.join()
            F.reset_launches()
            for d in deltas:
                assert c.commit(d, counters).applied
                _, counters = c.pull()
            launches = F.launch_counts()["fold_commit"]
        got = ss.center()
    finally:
        ss.close()
    srv = PSServer(center=init, discipline="adag", device="cuda").start()
    try:
        with PSClient(srv.endpoint, timeout=30.0) as c:
            _, upd = c.join()
            for d in deltas:
                c.commit(d, upd)
                _, upd = c.pull()
        ref = srv.center()
    finally:
        srv.close()
    assert launches == 2 * len(deltas)
    for a, b in zip(got, ref):
        assert a.tobytes() == b.tobytes()


def _drive_commits(endpoint, n, compress, first_worker=0):
    """Two workers commit seeded deltas from one pull a round, so every
    other commit folds at staleness 1."""
    from distkeras_tpu_torch.netps import PSClient

    rng = np.random.default_rng(first_worker + 11)
    init = [rng.normal(size=s).astype(np.float32)
            for s in ((64, 33), (129,), (7, 5))]
    clients = [PSClient(endpoint, worker_id=first_worker + i, timeout=30.0,
                        compress=compress) for i in range(2)]
    try:
        for c in clients:
            c.join(init=init)
        done = 0
        while done < n:
            pulls = [c.pull() for c in clients]
            for c, (center, upd) in zip(clients, pulls):
                if done < n:
                    c.commit([rng.normal(scale=0.1, size=a.shape)
                              .astype(np.float32) for a in center], upd)
                    done += 1
    finally:
        for c in clients:
            c.close()


def _precombine_commits(codec: str, shapes, workers: int):
    """``workers`` seeded commits encoded per ``codec`` (``mixed`` cycles
    the codecs over tensors), each with a ``-0.0`` and a ``+0.0`` element;
    int8 adds the zero-scale corners the kernel skips: an all-zero tensor
    (scale 0, q = 0) and a scale-0 entry with negative q."""
    from distkeras_tpu_torch.netps import wire

    rng = np.random.default_rng(19)
    codecs = ("none", "bf16", "int8")
    out = []
    for w in range(workers):
        entries = []
        for i, shape in enumerate(shapes):
            d = (rng.normal(size=shape) * 1e-2).astype(np.float32)
            if d.size:
                d.reshape(-1)[0], d.reshape(-1)[-1] = -0.0, 0.0
            c = codecs[(w + i) % 3] if codec == "mixed" else codec
            if c == "int8" and i == 2 and w == 0:
                d[:] = 0.0
            q, spec = wire.codec_encode(d, c)
            if c == "int8" and i == 2 and w == 1:
                q, spec = -np.abs(q) - 1, {"codec": "int8", "scale": 0.0}
            entries.append((q, spec) if spec else q)
        out.append(entries)
    return out


@pytest.mark.parametrize("codec", ["none", "bf16", "int8", "mixed"])
def test_precombine_on_card_is_the_numpy_decode_then_add(card, codec):
    """The aggregator's pre-combine on the card: one scale-1
    ``fold_commit`` launch an absorbed commit into the device window
    (which starts at ``-0.0``), the window bit-equal to the reference's
    decode-then-add (the first commit copied, the rest added, zero-scale
    int8 entries included), and one more launch at the root, whose center
    is bit-equal to the numpy chain."""
    from distkeras_tpu_torch.netps import (AggregatorServer, PSClient,
                                           PSServer, wire)

    shapes = ((64, 33), (4099,), (7, 5), (0,))
    commits = _precombine_commits(codec, shapes, 3)
    init = [np.full(shapes[0], -0.0, np.float32),
            np.random.default_rng(2).normal(size=shapes[1]).astype(
                np.float32),
            np.zeros(shapes[2], np.float32), np.zeros(0, np.float32)]
    acc = None
    for entries in commits:
        dec = [np.asarray(wire.codec_decode(*e) if isinstance(e, tuple)
                          else e, np.float32) for e in entries]
        acc = ([a.copy() for a in dec] if acc is None
               else [a + d for a, d in zip(acc, dec)])
    want = [c + a for c, a in zip(init, acc)]
    root = PSServer(center=init, discipline="adag", device="cuda").start()
    agg = AggregatorServer(upstream=root.endpoint, fan_in=8,
                           flush_interval=3600.0, device="cuda",
                           timeout=30.0).start()
    try:
        assert agg._flat.is_cuda and torch.equal(
            torch.signbit(agg._flat), torch.ones_like(agg._flat, dtype=bool))
        clients = [PSClient(agg.endpoint, worker_id=w, timeout=30.0)
                   for w in range(3)]
        try:
            F.reset_launches()
            for c, entries in zip(clients, commits):
                _, u = c.join()
                hdr, _ = c._rpc("commit", {"seq": 0, "pulled": u}, entries)
                assert hdr["applied"], hdr
            assert F.launch_counts() == {"fold_commit": 3, "fold_int8": 0,
                                         "fold_bf16": 0}
            assert clients[0].stats()["fold_backend"] == "cuda"
            with agg._lock:
                got, _p, count, _m, _pairs = agg._take_acc_locked(True)
            assert count == 3
            for a, b in zip(got, acc):
                assert a.tobytes() == b.tobytes()
            assert bool(torch.signbit(agg._flat).all())
            for c, entries in zip(clients, commits):
                _, u = c.pull()
                hdr, _ = c._rpc("commit", {"seq": 1, "pulled": u}, entries)
                assert hdr["applied"], hdr
        finally:
            for c in clients:
                c.close()
        agg.close()  # flushes the second window: the root folds it once
        assert F.launch_counts()["fold_commit"] == 7
        assert len(root.commit_log) == 1
        for a, b in zip(root.center(), want):
            assert a.tobytes() == b.tobytes()
    finally:
        agg.close()
        root.close()


@pytest.mark.parametrize("codec", ["none", "bf16", "int8", "mixed"])
def test_probe_decode_on_card_is_the_twin_bit_for_bit(card, codec):
    """The ``probe`` op's decode on the card: one scale-1 ``fold_commit``
    launch a probe into a ``-0.0`` scratch window on a server's stream,
    bit-equal to the plain twin's window and to the numpy
    ``decode_entry`` (zero-scale int8 entries and signed zeros included);
    a smaller probe after a larger one reuses the window, refilled first;
    and through the server's op, the center, the log and the counter are
    untouched."""
    from distkeras_tpu_torch.netps import PSClient, PSServer
    from distkeras_tpu_torch.netps.fold import (STREAM_PRIORITY, PinnedPool,
                                                ProbeWindow, decode_entry)

    stream = torch.cuda.Stream(priority=STREAM_PRIORITY)
    win = ProbeWindow("cuda", stream, PinnedPool())
    twin = ProbeWindow("cpu")
    for shapes in (((64, 33), (4099,), (7, 5), (0,)), ((5,), (3, 3))):
        (entries,) = _precombine_commits(codec, shapes, 1)
        F.reset_launches()
        nbytes, got = win.decode(entries, keep=True)
        assert F.launch_counts() == {"fold_commit": 1, "fold_int8": 0,
                                     "fold_bf16": 0}
        _n, plain = twin.decode(entries, keep=True)
        ref = [np.asarray(decode_entry(e), np.float32) for e in entries]
        assert nbytes == sum(r.nbytes for r in ref)
        for a, b, c in zip(got, plain, ref):
            assert a.tobytes() == b.tobytes() == c.tobytes()
            assert a.shape == c.shape
    init = [np.ones((64, 33), np.float32), np.zeros(4099, np.float32)]
    srv = PSServer(center=init, discipline="adag", device="cuda").start()
    try:
        with PSClient(srv.endpoint, worker_id=0, timeout=30.0) as c:
            c.join()
            F.reset_launches()
            for codec_ in ("none", "bf16", "int8"):
                hdr = c.probe([a + 0.5 for a in init], codec=codec_)
                assert hdr["probe_bytes"] == sum(a.nbytes for a in init)
            assert F.launch_counts()["fold_commit"] == 3
            assert srv.commit_log == [] and srv.updates == 0
            for a, b in zip(srv.center(), init):
                assert a.tobytes() == b.tobytes()
    finally:
        srv.close()


@pytest.mark.parametrize("codec", ["none", "int8", "bf16"])
def test_recovery_on_card_is_bit_equal_to_the_cpu_twin(card, tmp_path,
                                                       codec):
    """A card server's state directory recovers on the card (one
    ``fold_commit`` launch per replayed record) and on the CPU (the twin)
    to the pre-crash center, bit for bit."""
    from distkeras_tpu_torch.netps import PSServer

    d = str(tmp_path / "state")
    srv = PSServer(discipline="dynsgd", device="cuda", state_dir=d,
                   snapshot_every=4).start()
    try:
        _drive_commits(srv.endpoint, 11, codec)
        pre = srv.center()
    finally:
        srv.close()
    F.reset_launches()
    back = PSServer(discipline="dynsgd", device="cuda", state_dir=d)
    try:
        assert back.updates == 11 and back.recovered_records == 3
        assert F.launch_counts()["fold_commit"] == 3
        got = back.center()
    finally:
        back.close()
    twin = PSServer(discipline="dynsgd", device="cpu", state_dir=d)
    try:
        ref = twin.center()
    finally:
        twin.close()
    for a, b, c in zip(pre, got, ref):
        assert a.tobytes() == b.tobytes() == c.tobytes()


@pytest.mark.parametrize("codec", ["none", "int8", "bf16"])
def test_standby_on_card_replays_bit_equal_to_the_cpu_primary(card, codec):
    """A standby on the card tails a primary on the CPU record by record
    (each commit waits until it is replicated): one ``fold_commit`` launch
    per replicated record, the centers bit-equal after each."""
    import time as _time

    from distkeras_tpu_torch.netps import PSClient, PSServer, StandbyServer

    def wait(predicate):
        deadline = _time.monotonic() + 20
        while not predicate() and _time.monotonic() < deadline:
            _time.sleep(0.01)
        assert predicate()

    rng = np.random.default_rng(5)
    init = [rng.normal(size=s).astype(np.float32)
            for s in ((64, 33), (129,), (7, 5))]
    srv = PSServer(discipline="dynsgd", device="cpu", lease_s=30.0).start()
    sb = StandbyServer(srv.endpoint, discipline="dynsgd", device="cuda",
                       lease_s=30.0, promote_after=60.0).start()
    clients = [PSClient(srv.endpoint, worker_id=i, timeout=30.0,
                        compress=codec) for i in range(2)]
    try:
        for c in clients:
            c.join(init=init)
        wait(lambda: sb._flat is not None)  # the full sync
        F.reset_launches()  # only the standby folds on the card here
        for k in range(6):
            c = clients[k % 2]
            center, upd = c.pull()
            c.commit([rng.normal(scale=0.1, size=a.shape).astype(np.float32)
                      for a in center], upd - k % 2)
            wait(lambda: sb.updates == srv.updates)
            for a, b in zip(srv.center(), sb.center()):
                assert a.tobytes() == b.tobytes()
        assert sb.replicated == 6 and sb.snapshot_syncs == 1
        assert F.launch_counts()["fold_commit"] == 6
        assert [st for _w, _s, st in srv.commit_log][-6:] == [0, 1] * 3
    finally:
        for c in clients:
            c.close()
        sb.close()
        srv.close()


def _flash_inputs(B, L, H, D, dtype, seed=0):
    """q (pre-scaled), k, v and a cotangent [B, L, H, D] on the card."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, L, H, D, generator=g) for _ in range(4))
    return [t.to(dtype).cuda() for t in (q / D ** 0.5, k, v, do)]


def _flash_err(got, ref):
    """Largest and mean error, each as a share of the reference's largest
    and mean magnitude."""
    d = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    return ((d.max() / r.max().clamp_min(1e-30)).item(),
            (d.mean() / r.mean().clamp_min(1e-30)).item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,D", [(2, 40, 2, 32), (1, 200, 3, 64),
                                     (2, 128, 2, 128), (1, 1, 1, 16),
                                     (1, 256, 2, 48), (4, 72, 4, 64),
                                     (2, 136, 4, 128), (2, 1024, 1, 64),
                                     (1, 512, 2, 128), (2, 256, 2, 8),
                                     (2, 272, 2, 40), (1, 1024, 1, 24)])
def test_flash_kernels_match_plain_on_card(card, B, L, H, D, dtype):
    """The three flash kernels against their plain twins (the same bf16
    rounding points, k-tile 64), ragged L and every head-dim pad (D = 8,
    40, 24: head dims the wrappers zero-pad to 16, 48, 32); L not a
    multiple of a tile's rows (72, 136), long enough to wrap the backward's
    load ring many times (1024 at B*H = 2), and D = 128 (two column boxes,
    32-query tiles in dK/dV) at L = 512. f32 outputs: mean error within
    1e-5 of the mean magnitude (only the order of f32 sums differs) and the
    largest within 2e-3 (an order-flipped bf16 rounding of one p or ds
    moves it by one bf16 step); bf16 outputs add their own rounding: mean
    within 1e-3, largest within 1e-2. lse within 1e-5; two calls of the
    forward, of dQ and of dK/dV give the same bits. The shapes added for
    the kernels' edges
    hold at least 1024 rows (B*L*H): one such flip moves a whole output
    row, and over fewer rows that alone can pass the mean limit (at
    [1, 136, 2, 128] dv read 1.76e-5 while the largest error stayed at
    7.1e-4); the test below holds those small shapes by a measure that
    rows cannot dilute."""
    q, k, v, do = _flash_inputs(B, L, H, D, dtype)
    FA.reset_launches()
    out, lse = FA.flash_fwd_cuda(q, k, v)
    delta = FA.attention_delta(do, out)
    dq = FA.flash_dq_cuda(q, k, v, do, lse, delta)
    dk, dv = FA.flash_dkv_cuda(q, k, v, do, lse, delta)
    again = FA.flash_dkv_cuda(q, k, v, do, lse, delta)
    dq_again = FA.flash_dq_cuda(q, k, v, do, lse, delta)
    out_again, lse_again = FA.flash_fwd_cuda(q, k, v)
    torch.cuda.synchronize()
    assert FA.launch_counts() == {"flash_fwd": 2, "flash_dq": 2,
                                  "flash_dkv": 2}
    ref_out, ref_lse = FA.flash_fwd_plain(q, k, v)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5)
    refs = [ref_out, FA.flash_dq_plain(q, k, v, do, lse, delta),
            *FA.flash_dkv_plain(q, k, v, do, lse, delta)]
    top, mean = (2e-3, 1e-5) if dtype == torch.float32 else (1e-2, 1e-3)
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv),
                              refs):
        assert got.dtype == dtype and got.shape == q.shape
        err_max, err_mean = _flash_err(got, ref)
        assert err_max <= top and err_mean <= mean, (name, err_max,
                                                     err_mean)
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)
    assert torch.equal(dq_again, dq)
    assert torch.equal(out_again, out) and torch.equal(lse_again, lse)


@pytest.mark.parametrize("B,L,H,D", [(1, 136, 2, 128), (1, 72, 2, 64),
                                     (2, 40, 2, 32), (1, 200, 3, 64),
                                     (1, 1, 1, 16)])
def test_flash_backward_errors_are_bf16_flips_on_card(card, B, L, H, D):
    """At few rows (B*H*L down to 1), where one bf16 rounding flip of p or
    ds moves a whole output row and can alone pass the mean limit, the f32
    dq, dk and dv are held by a measure that more rows cannot dilute:
    every row with an element past f32 level against the twins is one to
    three one-step bf16 flips of that row's own p or ds, each times the
    operand row it scales (``flash_flips.backward_flips``); without those
    flips the mean error is within the f32 limit, 1e-5 of the mean
    magnitude, and the largest error is within 2e-3 as in the test
    above."""
    q, k, v, do = _flash_inputs(B, L, H, D, torch.float32)
    out, lse = FA.flash_fwd_cuda(q, k, v)
    delta = FA.attention_delta(do, out)
    dq = FA.flash_dq_cuda(q, k, v, do, lse, delta)
    dk, dv = FA.flash_dkv_cuda(q, k, v, do, lse, delta)
    found = backward_flips(q, k, v, do, lse, delta, dq, dk, dv)
    refs = {"dq": FA.flash_dq_plain(q, k, v, do, lse, delta),
            **dict(zip(("dk", "dv"), FA.flash_dkv_plain(q, k, v, do, lse,
                                                        delta)))}
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        f = found[name]
        assert f["unexplained_rows"] == 0, (name, f)
        assert f["mean_err_share_without_flips"] <= 1e-5, (name, f)
        assert _flash_err(got, refs[name])[0] <= 2e-3, (name, f)


@pytest.mark.parametrize("B,L,H,D", [(1, 136, 2, 128), (1, 72, 2, 64),
                                     (2, 40, 2, 32), (1, 200, 3, 64),
                                     (1, 1, 1, 16)])
def test_flash_forward_errors_are_bf16_flips_on_card(card, B, L, H, D):
    """The f32 forward at the same few-row shapes: every row of out with an
    element past f32 level against the twin is one to three one-step bf16
    flips of that row's own p, each times the V row it scales and the
    factor its k-tile's running max leaves on it
    (``flash_flips.forward_flips``); without those flips the mean error is
    within 1e-5 of the mean magnitude, and the largest error is within
    2e-3 as in the test above."""
    q, k, v, _ = _flash_inputs(B, L, H, D, torch.float32)
    out, _ = FA.flash_fwd_cuda(q, k, v)
    f = forward_flips(q, k, v, out)
    assert f["unexplained_rows"] == 0, f
    assert f["mean_err_share_without_flips"] <= 1e-5, f
    assert _flash_err(out, FA.flash_fwd_plain(q, k, v)[0])[0] <= 2e-3, f


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_shares_one_bf16_copy_on_card(card, dtype):
    """The autograd forward rounds f32 inputs to bf16 once, launches the
    forward on the copies and saves them; the backward rounds only dO and
    runs dQ and dK/dV on the saved copies: each kernel launches once,
    through the entry point of the inputs' dtype, and out and the
    gradients equal the wrappers' own (which round per call) bit for
    bit."""
    q, k, v, do = _flash_inputs(2, 136, 2, 64, dtype, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    sfx = "f32" if dtype == torch.float32 else "bf16"
    FA.reset_launches()
    out = FA.flash_attention(*leaves)
    assert FA.launch_counts(by_entry=True)[f"flash_fwd_{sfx}"] == 1
    saved = out.grad_fn.saved_tensors
    for t, x in zip(saved[:3], (q, k, v)):
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, x.to(torch.bfloat16))
    FA.reset_launches()
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    counts = FA.launch_counts(by_entry=True)
    assert counts[f"flash_dq_{sfx}"] == counts[f"flash_dkv_{sfx}"] == 1
    assert sum(counts.values()) == 2
    want_out, lse = FA.flash_fwd_cuda(q, k, v)
    assert out.dtype == dtype and torch.equal(out.detach(), want_out)
    delta = FA.attention_delta(do, out.detach())
    want = (FA.flash_dq_cuda(q, k, v, do, lse, delta),
            *FA.flash_dkv_cuda(q, k, v, do, lse, delta))
    for g, w in zip(grads, want):
        assert g.dtype == dtype and torch.equal(g, w)


def test_flash_refuses_what_it_does_not_take(card):
    q = torch.randn(1, 8, 1, 32, device="cuda")
    before = FA.launch_counts()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_attention(q, q.cpu(), q)
    wide = torch.randn(1, 8, 1, 144, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(wide, wide, wide)  # past the widest tile
    assert FA.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 40])
def test_flash_autograd_at_padded_head_dims_on_card(card, D, dtype):
    """The autograd Function at head dims the wrappers pad: out and the
    gradients at D, the bits of the wrappers' own calls, each kernel
    launched once."""
    q, k, v, do = _flash_inputs(2, 272, 2, D, dtype, seed=D)
    out, lse = FA.flash_fwd_cuda(q, k, v)
    delta = FA.attention_delta(do, out)
    want = (FA.flash_dq_cuda(q, k, v, do, lse, delta),
            *FA.flash_dkv_cuda(q, k, v, do, lse, delta))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.reset_launches()
    got = FA.flash_attention(*leaves)
    grads = torch.autograd.grad(got, leaves, do)
    torch.cuda.synchronize()
    assert FA.launch_counts() == {"flash_fwd": 1, "flash_dq": 1,
                                  "flash_dkv": 1}
    assert got.shape == q.shape and torch.equal(got.detach(), out)
    for g, w in zip(grads, want):
        assert g.shape == q.shape and torch.equal(g, w)


@pytest.mark.parametrize("remat", [False, True])
def test_transformer_step_on_card_launches_the_flash_kernels(card, remat):
    """One AEASGD local step of a 2-layer flash transformer on the card:
    each layer launches dQ and dK/dV once and the forward once, or twice
    with remat (the backward recomputes the block); the weights stay
    finite."""
    from distkeras_tpu_torch import AEASGD, small_transformer_lm
    from distkeras_tpu_torch.data import DataFrame

    model = small_transformer_lm(vocab_size=64, num_layers=2, d_model=64,
                                 num_heads=2, d_ff=64, max_seq_len=128,
                                 seq_len=128, attn_impl="flash", remat=remat,
                                 device="cuda")
    toks = np.random.default_rng(0).integers(0, 64, (2, 128))
    df = DataFrame({"features": toks.astype(np.int32),
                    "label": np.roll(toks, -1, 1).astype(np.int32)})
    FA.reset_launches()
    out = AEASGD(model, "adam", "sparse_categorical_crossentropy",
                 num_workers=1, batch_size=2, communication_window=1,
                 learning_rate=1e-4, rho=500.0).train(df)
    torch.cuda.synchronize()
    assert FA.launch_counts() == {"flash_fwd": 4 if remat else 2,
                                  "flash_dq": 2, "flash_dkv": 2}
    assert all(torch.isfinite(p).all() for p in out.params.values())


@pytest.mark.parametrize("name,shape", [("mnist_mlp", (784,)),
                                        ("mnist_cnn", (28, 28, 1)),
                                        ("cifar10_cnn", (32, 32, 3))])
def test_config_models_on_card_match_the_cpu(card, name, shape):
    """BASELINE configs #1-#3's models at their real widths, the same
    weights on the card and on the CPU: logits within 1e-4 (the serving
    rule: f32 convolutions and products summed in another order, TF32
    off) and the loss gradient of every parameter within 1e-4 of its
    largest magnitude; no kernel of the port launches (cuDNN and cuBLAS
    only)."""
    from torch.func import functional_call

    from distkeras_tpu_torch import models
    from distkeras_tpu_torch.ops.losses import get_loss

    cpu = getattr(models, name)(seed=1, device="cpu")
    gpu = getattr(models, name)(seed=1, device="cuda")
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(64,) + shape).astype(np.float32)
    y = torch.from_numpy(rng.integers(0, 10, 64).astype(np.int64))
    mods = (K, G, FA, F)
    for m in mods:
        m.reset_launches()
    got = gpu.predict(x).cpu()
    torch.testing.assert_close(got, cpu.predict(x), rtol=0, atol=1e-4)
    loss = get_loss("sparse_categorical_crossentropy")
    grads = {}
    for model in (cpu, gpu):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in model.params.items()}
        out = functional_call(model.module, leaves,
                              (torch.as_tensor(x, device=model.device),))
        g = torch.autograd.grad(loss(out, y.to(model.device)),
                                list(leaves.values()))
        grads[model.device.type] = {k: t.cpu() for k, t in zip(leaves, g)}
    torch.cuda.synchronize()
    for k, ref in grads["cpu"].items():
        err = (grads["cuda"][k] - ref).abs().max() / ref.abs().max()
        assert err <= 1e-4, (k, err.item())
    assert all(not any(m.launch_counts().values()) for m in mods)


@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_mnist_cnn_commit_bit_equal_to_plain_on_card(card, codec):
    """One commit of config #2's CNN (8 tensors, 421,642 parameters, what
    ``ADAG(mnist_cnn(), remote=...)`` sends) seated and staged as the
    server does it, folded by one ``fold_commit`` launch: bit for bit like
    the plain twin on the same staged buffer and like the numpy oracle on
    the host."""
    from distkeras_tpu_torch import mnist_cnn
    from distkeras_tpu_torch.netps import fold as nfold
    from distkeras_tpu_torch.netps import wire

    params = list(mnist_cnn(seed=2, device="cuda").params.values())
    sizes = [p.numel() for p in params]
    assert len(sizes) == 8 and sum(sizes) == 421_642
    offsets, total = F.center_layout(sizes)
    flat = torch.zeros(total, device="cuda")
    for p, o in zip(params, offsets):
        flat[o:o + p.numel()] = p.reshape(-1)
    twin_flat = flat.clone()
    centers = [flat[o:o + n] for o, n in zip(offsets, sizes)]
    twin = [twin_flat[o:o + n] for o, n in zip(offsets, sizes)]
    host = [c.cpu().numpy() for c in centers]
    g = torch.Generator().manual_seed(5)
    entries = [wire.codec_encode((torch.randn(n, generator=g) / 100).numpy(),
                                 codec) for n in sizes]
    staged = nfold.stage_commit(entries, "cuda")
    F.reset_launches()
    F.fold_commit_(centers, staged, 1.0 / 8.0)
    torch.cuda.synchronize()
    assert F.launch_counts() == {"fold_commit": 1, "fold_int8": 0,
                                 "fold_bf16": 0}
    F.fold_commit_plain_(twin, staged, 1.0 / 8.0)
    assert torch.equal(flat.view(torch.int32), twin_flat.view(torch.int32))
    for h, (enc, spec) in zip(host, entries):
        nfold.fold_compressed_numpy(h, enc, spec, 1.0 / 8.0)
    for c, h in zip(centers, host):
        assert np.array_equal(c.cpu().numpy().view(np.uint32),
                              h.view(np.uint32))


# -- the persistence plane on the card ----------------------------------------

#: config #4's widths, the vocabulary and sequence cut for a quick test
CKPT_WIDTHS = dict(vocab_size=2000, embed_dim=64, hidden_size=128,
                   seq_len=40)
CKPT_TRAIN = dict(worker_optimizer="sgd",
                  loss="sparse_categorical_crossentropy", num_workers=2,
                  batch_size=64, communication_window=2, learning_rate=0.01)


def _ckpt_run(df, epochs, **extra):
    from distkeras_tpu_torch import DynSGD, imdb_lstm

    t = DynSGD(imdb_lstm(**CKPT_WIDTHS, seed=3, device="cuda"),
               **CKPT_TRAIN, num_epoch=epochs, **extra)
    K.reset_launches()
    model = t.train(df)
    torch.cuda.synchronize()
    return t, model, K.launch_counts()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resume_is_bit_equal_on_card(card, tmp_path, dtype):
    """2 rounds with checkpoints, then a resume to 4: the center equals an
    uninterrupted 4-round run's bit for bit (the kernels sum in a fixed
    order, without atomics), each run launching the stash forward and the
    backward once a local step."""
    from distkeras_tpu_torch.datasets import imdb

    df = imdb(n=2 * 2 * 2 * 64, vocab_size=2000, seq_len=40, seed=1)
    _, full, launches = _ckpt_run(df, 2, compute_dtype=dtype)
    assert launches == {"lstm_fwd": 0, "lstm_fwd_stash": 16, "lstm_bwd": 16}
    ck = dict(checkpoint_dir=str(tmp_path), checkpoint_every=1,
              compute_dtype=dtype)
    _ckpt_run(df, 1, **ck)
    t, resumed, launches = _ckpt_run(df, 2, resume=True, **ck)
    assert len(t.get_history()) == 2
    assert launches == {"lstm_fwd": 0, "lstm_fwd_stash": 8, "lstm_bwd": 8}
    for k, v in full.params.items():
        assert torch.equal(resumed.params[k], v), k


def test_deserialize_on_card_is_bit_equal(card):
    """``serialize_model`` -> bytes -> ``deserialize_model`` on the card:
    the same parameters and the same logits bit for bit."""
    from distkeras_tpu_torch import (
        deserialize_model,
        imdb_lstm,
        serialize_model,
    )

    model = imdb_lstm(**CKPT_WIDTHS, seed=4, device="cuda")
    loaded = deserialize_model(serialize_model(model))
    assert loaded.device.type == "cuda"
    for k, v in model.params.items():
        assert torch.equal(loaded.params[k], v), k
    x = np.random.default_rng(0).integers(0, 2000, (64, 40)).astype(np.int32)
    K.reset_launches()
    assert torch.equal(loaded.predict(x), model.predict(x))
    assert K.launch_counts()["lstm_fwd"] == 2


def test_registry_hot_swap_launches_lstm_fwd(card, tmp_path):
    """A verified step swapped into a registry on the card: the warmup
    probe launches ``lstm_fwd`` once a bucket, every answer after the swap
    comes from the new weights; a corrupt newer step is refused."""
    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch.checkpoint import Checkpointer
    from distkeras_tpu_torch.resilience import integrity
    from distkeras_tpu_torch.serving import ModelRegistry

    buckets = (1, 4, 16)
    trained = imdb_lstm(**CKPT_WIDTHS, seed=5, device="cuda")
    registry = ModelRegistry(imdb_lstm(**CKPT_WIDTHS, seed=6, device="cuda"),
                             buckets, directory=str(tmp_path), poll_s=3600.0,
                             device="cuda")
    try:
        Checkpointer(str(tmp_path)).save(7, trained.params, meta={"r": 1})
        K.reset_launches()
        assert registry.poll_once() and registry.version == 7
        assert K.launch_counts()["lstm_fwd"] == len(buckets)
        x = np.random.default_rng(1).integers(0, 2000, (3, 40)).astype(
            np.int32)
        K.reset_launches()
        got = registry.current()[0].infer([x])
        assert K.launch_counts()["lstm_fwd"] == 1
        np.testing.assert_array_equal(
            got, trained.predict(np.concatenate(
                [x, np.zeros((1, 40), np.int32)])).cpu().numpy()[:3])
        Checkpointer(str(tmp_path)).save(9, trained.params, meta={"r": 2})
        integrity.corrupt_step_dir(str(tmp_path / "9"))
        with pytest.warns(UserWarning, match="candidate step 9"):
            assert registry.poll_once() is False
        assert registry.version == 7
    finally:
        registry.close()
