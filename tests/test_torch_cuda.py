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
    before = K.launches
    got = K.lstm_seq(wx, wh, b, x)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    torch.testing.assert_close(got, K.lstm_seq_plain(wx, wh, b, x),
                               rtol=0, atol=1e-5)


def test_kernel_refuses_what_it_does_not_take(packed):
    wx, wh, b, g = packed
    x = torch.randn(2, T, E, generator=g).cuda()
    before = K.launches
    with pytest.raises(TypeError, match="float32"):
        K.lstm_seq(wx, wh, b, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        K.lstm_seq(wx, wh, b, x.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="CUDA device"):
        K.lstm_seq(wx, wh, b.cpu(), x)
    with pytest.raises(NotImplementedError, match="forward-only"):
        K.lstm_seq(wx.requires_grad_(), wh, b, x)
    assert K.launches == before
