"""The port's CUDA kernels on the card, against their plain PyTorch twins.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, so it also runs on a machine
that has none (``tests/conftest.py`` imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from distkeras_tpu_torch.ops.kernels import lstm as K

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
    """One row per block (B <= 128) and two (B > 128, with a ragged last
    block at 131); atol 1e-5 on hs in (-1, 1): the same f32 arithmetic
    summed in another order over 200 steps."""
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
    with pytest.raises(TypeError, match="float32"):
        K.lstm_seq(wx, wh, b, x.to(torch.bfloat16))
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
