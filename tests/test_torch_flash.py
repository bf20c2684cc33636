"""The port's causal flash attention (``distkeras_tpu_torch/ops/kernels/
flash_attention.py``) on the CPU, where the wrappers take the kernels'
plain twins through the same autograd Function the card uses, against the
JAX package's ``flash_attention`` with its Pallas kernels in interpret
mode, on the same seeded numpy inputs.

Tolerances, and why:

* twin vs the JAX kernel at the JAX kernel's own k-tile (``block_k``): the
  same bf16 rounding points and the same running max, so only the order of
  the f32 sums differs. The mean error of out, dq, dk and dv is within 1e-5
  of their mean magnitude (f32 level; it reads 1e-8 to 1.2e-6) and lse
  within 1e-5. Where the order flips a bf16 rounding of one p or ds, that
  element moves by one bf16 step (2^-8 of itself), so the largest error
  is held only within 2e-3 of the output's largest magnitude;
* twin at the kernel's 64-key tile vs the JAX kernel (L >= 128): the online
  softmax rounds p to bf16 against another running max, so the two differ
  at bf16 level (mean error 7e-5 to 4e-4): largest error within 1e-2;
* twins vs float64 dense causal attention: the JAX tests' own limits
  (``tests/test_flash_attention.py``: 5e-2 forward; atol 0.35, rtol 0.02
  backward), the distance bf16 operands put between the two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash,
)
from distkeras_tpu_torch.ops.kernels import flash_attention as FA
from distkeras_tpu_torch.ops.kernels.flash_flips import (
    backward_flips, flip_steps, forward_flips)

H = 2


def _inputs(L, D, B=2, seed=0):
    """q (pre-scaled), k, v and a cotangent, [B, L, H, D] f32."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, L, H, D)).astype(np.float32)
                   for _ in range(4))
    return q / np.sqrt(D, dtype=np.float32), k, v, do


def _jax_tiles(L):
    """The JAX model's q-block (``min(128, L)``) and the JAX wrapper's
    default k-chunk for it."""
    bq = min(128, L)
    bk = bq
    for mult in range(2, 9):
        if L % (bq * mult) == 0:
            bk = bq * mult
    return bq, bk


def _jax(q, k, v, do):
    """out and dq, dk, dv through the JAX kernel in interpret mode."""
    bq, _ = _jax_tiles(q.shape[1])

    def f(q, k, v):
        return jax_flash(q, k, v, block_size=bq, interpret=True)

    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp(jnp.asarray(do))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _jax_lse(q, k):
    """The logsumexp of the causal scores on bf16-rounded q, k in float64
    (the JAX kernel keeps its lse private; its value is this)."""
    qb, kb = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float64)
              for a in (q, k))
    s = np.einsum("bqhd,bkhd->bhqk", qb, kb)
    L = q.shape[1]
    s = np.where(np.tril(np.ones((L, L), bool)), s, -np.inf)
    mx = s.max(axis=-1, keepdims=True)
    lse = mx[..., 0] + np.log(np.exp(s - mx).sum(axis=-1))
    B, Hh = q.shape[0], q.shape[2]
    return lse.reshape(B * Hh, L)


def _port_grads(q, k, v, do, block_k=FA.BLOCK):
    """out and dq, dk, dv through the port's twins with the forward at
    ``block_k``."""
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    out, lse = FA.flash_fwd_plain(*t[:3], block_k=block_k)
    delta = FA.attention_delta(t[3], out)
    dq = FA.flash_dq_plain(*t, lse, delta)
    dk, dv = FA.flash_dkv_plain(*t, lse, delta)
    return out.numpy(), lse.numpy(), [g.numpy() for g in (dq, dk, dv)]


def _scaled_err(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _mean_err(got, ref):
    return float(np.abs(got - ref).mean() / max(np.abs(ref).mean(), 1e-30))


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("L", [40, 64, 128, 256])
def test_twins_match_the_jax_kernel_at_its_tiling(L, D):
    q, k, v, do = _inputs(L, D)
    ref_out, ref_grads = _jax(q, k, v, do)
    _, bk = _jax_tiles(L)
    out, lse, grads = _port_grads(q, k, v, do, block_k=bk)
    np.testing.assert_allclose(lse, _jax_lse(q, k), rtol=0, atol=1e-5)
    for name, g, r in zip(("out", "dq", "dk", "dv"), [out, *grads],
                          [ref_out, *ref_grads]):
        assert _mean_err(g, r) <= 1e-5, name
        assert _scaled_err(g, r) <= 2e-3, name


@pytest.mark.parametrize("L", [128, 256])
def test_twin_at_the_kernel_tile_matches_the_jax_kernel_at_bf16_level(L):
    q, k, v, do = _inputs(L, 64, seed=1)
    ref_out, ref_grads = _jax(q, k, v, do)
    out, _, grads = _port_grads(q, k, v, do)
    for g, r in zip([out, *grads], [ref_out, *ref_grads]):
        assert _scaled_err(g, r) <= 1e-2


def _dense64(q, k, v):
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q, k)
    L = q.shape[1]
    s = np.where(np.tril(np.ones((L, L), bool)), s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("L", [40, 200])
def test_autograd_function_matches_float64_dense_attention(L):
    """Forward and the gradients of ``sum(out^2)`` through
    :class:`FlashAttentionFn` against float64 dense causal attention
    (gradients by torch autograd in float64), at the JAX tests' limits."""
    q, k, v, _ = _inputs(L, 32, seed=2)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = FA.launch_counts()
    out = FA.flash_attention(*leaves)
    grads = torch.autograd.grad(out.square().sum(), leaves)
    assert FA.launch_counts() == before  # CPU: the plain twins
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.detach().numpy(), _dense64(q, k, v),
                               atol=5e-2)
    ref_leaves = [torch.from_numpy(a).double().requires_grad_()
                  for a in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", *ref_leaves[:2])
    s = s.masked_fill(~torch.ones(L, L, dtype=torch.bool).tril(),
                      float("-inf"))
    ref = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), ref_leaves[2])
    ref_grads = torch.autograd.grad(ref.square().sum(), ref_leaves)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=0.35,
                                   rtol=0.02)


def test_bf16_inputs_give_bf16_outputs_and_gradients():
    q, k, v, do = _inputs(40, 32, seed=3)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
              for a in (q, k, v)]
    out = FA.flash_attention(*leaves)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, leaves,
                                torch.from_numpy(do).to(torch.bfloat16))
    assert all(g.dtype == torch.bfloat16 for g in grads)
    # bf16 inputs are what the f32 path rounds them to: the same result,
    # up to out's own rounding to bf16.
    f32 = FA.flash_fwd_plain(*(t.detach().float() for t in leaves))[0]
    np.testing.assert_allclose(out.detach().float().numpy(), f32.numpy(),
                               rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("D", [8, 24, 144])
def test_unsupported_head_dim_raises(D):
    """The kernels' own contract still refuses a head dim that is not a
    multiple of 16 in [16, 128] (their tensor maps are built for those);
    the CUDA wrappers pad D <= 128 up to it, and past 128 they raise with
    it. On the CPU the wrappers take any D (below)."""
    with pytest.raises(ValueError, match="head dim"):
        FA.check_head_dim(D)
    with pytest.raises(ValueError, match="head dim"):
        FA.tma_geometry(1, 4, 1, D)
    if D > 128:
        with pytest.raises(ValueError, match="head dim"):
            FA.kernel_head_dim(D)
    else:
        assert FA.kernel_head_dim(D) == -(-D // 16) * 16


@pytest.mark.parametrize("D", [8, 24, 40, 144])
def test_head_dims_the_kernels_pad_match_the_jax_kernel(D):
    """``flash_attention`` with its gradient through the autograd Function
    at head dims the CUDA kernels take only zero-padded (8, 24, 40) or not
    at all (144), on the CPU (the twins, which take any D, and nothing
    launched), against the JAX package's flash kernel in interpret mode,
    which takes any D. L = 64 is one k-tile for both, so only the order of
    the f32 sums differs: the mean error of out, dq, dk and dv within 1e-5
    of their mean magnitude and the largest within 2e-3 of the largest (one
    order-flipped bf16 rounding of a p or ds), as in the tiling test
    above."""
    q, k, v, do = _inputs(64, D, seed=D)
    ref_out, ref_grads = _jax(q, k, v, do)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = FA.launch_counts()
    out = FA.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert FA.launch_counts() == before
    assert out.shape == q.shape and all(g.shape == q.shape for g in grads)
    for name, g, r in zip(("out", "dq", "dk", "dv"),
                          [out.detach(), *grads], [ref_out, *ref_grads]):
        assert _mean_err(g.numpy(), r) <= 1e-5, name
        assert _scaled_err(g.numpy(), r) <= 2e-3, name


@pytest.mark.parametrize("D", [8, 24, 40, 100])
def test_zero_padded_head_dim_computes_the_unpadded_function(D):
    """What the CUDA wrappers do with a head dim the kernels do not take,
    run through the twins: q, k, v and dO zero-padded to
    ``kernel_head_dim(D)`` (``pad_head_dim``), the forward, dQ and dK/dV at
    that width, sliced back to D, against the same twins at D. Zero
    columns add exact zeros to every score and give zero output columns;
    only the order of the f32 sums over D may differ, so out, lse, dq, dk
    and dv agree within 1e-6 of their largest magnitude and the padded
    columns of every output are exactly zero."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(72, D, seed=D + 1))
    padded = FA.pad_head_dim(q, k, v, do)
    dk_ = FA.kernel_head_dim(D)
    assert all(t.shape[3] == dk_ and torch.equal(t[..., :D], x)
               and not t[..., D:].any() for t, x in zip(padded, (q, k, v, do)))
    ref = _port_grads(*(t.numpy() for t in (q, k, v, do)))
    got = _port_grads(*(t.numpy() for t in padded))
    assert np.abs(got[1] - ref[1]).max() <= 1e-6
    for g, r in zip([got[0], *got[2]], [ref[0], *ref[2]]):
        assert not g[..., D:].any()
        assert _scaled_err(g[..., :D], r) <= 1e-6


def test_forward_without_grad_takes_the_plain_twin_on_the_cpu():
    q, k, v, _ = _inputs(64, 32, seed=4)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    FA.reset_launches()
    with torch.no_grad():
        out = FA.flash_attention(*t)
    assert torch.equal(out, FA.flash_fwd_plain(*t)[0])
    assert FA.launch_counts() == {"flash_fwd": 0, "flash_dq": 0,
                                  "flash_dkv": 0}


@pytest.mark.parametrize("D", [16, 32, 48, 64, 80, 96, 112, 128])
def test_tma_geometry_fits_the_backward_kernels(D):
    """The backward kernels' tensor maps over [B, L, H, D] bf16 (the
    wrapper's helper, which the C entry points check and encode): dims
    innermost first, byte strides TMA takes (multiples of 16), a box row
    that fits its swizzle span, column boxes that cover the padded head
    dim (two at D > 64), and box rows that tile a 64-key tile."""
    B, L, Hh = 3, 200, 5
    g = FA.tma_geometry(B, L, Hh, D)
    assert g["dims"] == (D, Hh, L, B)
    assert g["strides"] == (2 * D, 2 * Hh * D, 2 * L * Hh * D)
    assert all(s % 16 == 0 for s in g["strides"])
    cols, one, rows, one_b = g["box"]
    assert (one, one_b) == (1, 1)
    assert cols * 2 <= g["swizzle"] and g["swizzle"] in (64, 128)
    assert cols * 2 % 16 == 0 and FA.BLOCK % rows == 0
    assert g["padded"] >= D and g["boxes"] * cols == g["padded"]
    assert g["boxes"] == (2 if D > 64 else 1)
    if D == 128:
        assert (cols, rows, g["swizzle"]) == (64, 32, 128)


@pytest.mark.parametrize("L,D", [(40, 32), (136, 64), (72, 128)])
def test_one_bf16_rounding_of_the_inputs_gives_the_twins_bit_for_bit(L, D):
    """The f32 backward rounds q, k, v and dO to bf16 once and feeds those
    copies to both kernels. The twins round their inputs the same way
    (nearest even), so fed the copies they give today's results bit for
    bit: no rounding point moved."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(L, D, seed=5))
    out, lse = FA.flash_fwd_plain(q, k, v)
    delta = FA.attention_delta(do, out)
    ops = FA.bf16_operands(q, k, v, do)
    assert all(t.dtype == torch.bfloat16 for t in ops)
    wide = [t.float() for t in ops]
    assert torch.equal(FA.flash_dq_plain(*wide, lse, delta),
                       FA.flash_dq_plain(q, k, v, do, lse, delta))
    for a, b in zip(FA.flash_dkv_plain(*wide, lse, delta),
                    FA.flash_dkv_plain(q, k, v, do, lse, delta)):
        assert torch.equal(a, b)
    bf16 = [t.to(torch.bfloat16) for t in (q, k, v, do)]
    assert all(a is b for a, b in zip(FA.bf16_operands(*bf16), bf16))


def test_flip_steps_cross_the_nearest_bf16_midpoint():
    """A flip moves an f32 value's bf16 rounding to the neighbour across
    its nearest midpoint; a bf16 value has none to cross."""
    x = torch.tensor([1 + 2 ** -8 + 2 ** -20, 1 + 2 ** -8 - 2 ** -20,
                      -(1 + 2 ** -8 + 2 ** -20), 1.5, 0.0])
    step, tie = flip_steps(x)
    assert step.tolist() == [-2 ** -7, 2 ** -7, 2 ** -7, 0.0, 0.0]
    assert torch.allclose(tie[:3], 2 ** -20 / x[:3].abs(), rtol=1e-3)


def _perturbed_backward(q, k, v, do, lse, delta, seed=0):
    """dq, dk, dv at the kernels' bf16 rounding points, from a p and dp
    each off by up to 2^-18 of itself (more than another order of f32 sums
    moves them, so that flips are many), with the products summed in
    float64 and rounded to f32 (another order, as the kernels' is)."""
    B, L, Hh, D = q.shape
    qb, kb, vb, dob = (FA._bf16_bhld(t) for t in (q, k, v, do))
    g = torch.Generator().manual_seed(seed)
    jitter = lambda x: x * (1 + (torch.rand(x.shape, generator=g) * 2 - 1)
                            * 2 ** -18)
    p = jitter(FA._probs(qb, kb, lse))
    dp = jitter(torch.matmul(dob, vb.mT))
    ds = FA._bf16(p * (dp - delta[..., None])).double()
    qb, kb, dob = qb.double(), kb.double(), dob.double()
    grads = (torch.matmul(ds, kb), torch.matmul(ds.mT, qb),
             torch.matmul(FA._bf16(p).double().mT, dob))
    return [FA._to_blhd(g.float(), B, Hh, torch.float32) for g in grads]


def _flip_case(B, L, Hh, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, L, Hh, D))
                                    .astype(np.float32)) for _ in range(4))
    q = q / D ** 0.5
    out, lse = FA.flash_fwd_plain(q, k, v)
    return q, k, v, do, lse, FA.attention_delta(do, out)


@pytest.mark.parametrize("B,L,Hh,D", [(1, 136, 2, 128), (1, 72, 2, 64),
                                      (2, 40, 2, 32)])
def test_backward_flips_explain_a_perturbed_backward(B, L, Hh, D):
    """A backward that keeps the kernels' bf16 rounding points but computes
    p and dp a little otherwise differs from the twins past f32 level only
    by one-step bf16 flips of p and ds: every such row is explained, flips
    are found, and without them the mean error is within the card's f32
    limit, 1e-5 of the mean magnitude (with them dq reads up to 4.1e-5 at
    [1, 72, 2, 64])."""
    args = _flip_case(B, L, Hh, D, seed=3)
    found = backward_flips(*args, *_perturbed_backward(*args))
    assert sum(f["flips"] for f in found.values()) > 0, found
    for name, f in found.items():
        assert f["unexplained_rows"] == 0, (name, f)
        assert f["mean_err_share_without_flips"] <= 1e-5, (name, f)


def test_backward_flips_leave_a_faulty_row_unexplained():
    """The twins against themselves: nothing past f32 level. A lost last
    query row of dq (as a ragged edge tile not stored) and a key row of dv
    off by 1e-3 of its size are not bf16 flips, and stay unexplained."""
    args = _flip_case(1, 72, 2, 64, seed=4)
    dq = FA.flash_dq_plain(*args)
    dk, dv = FA.flash_dkv_plain(*args)
    clean = backward_flips(*args, dq, dk, dv)
    assert all(f["elements_past_f32"] == 0 for f in clean.values()), clean
    dq_bad, dv_bad = dq.clone(), dv.clone()
    dq_bad[:, -1] = 0.0
    dv_bad[:, 5, 1] *= 1 + 1e-3
    bad = backward_flips(*args, dq_bad, dk, dv_bad)
    assert bad["dq"]["unexplained_rows"] >= 1, bad
    assert bad["dv"]["unexplained_rows"] == 1, bad
    assert bad["dk"]["elements_past_f32"] == 0, bad


def _perturbed_forward(q, k, v, seed=0):
    """out at the forward kernel's bf16 rounding points and 64-key k-tile,
    from a p each off by up to 2^-16 of itself (more than another order of
    f32 sums or exp2f moves it, so that flips are many), l summed from
    that p, and the products summed in float64 and rounded to f32 (another
    order, as the kernel's is)."""
    B, L, Hh, D = q.shape
    qb, kb, vb = (FA._bf16_bhld(t) for t in (q, k, v))
    g = torch.Generator().manual_seed(seed)
    m = torch.full((B * Hh, L), FA.NEG, dtype=torch.float64)
    l = torch.zeros((B * Hh, L), dtype=torch.float64)
    acc = torch.zeros((B * Hh, L, D), dtype=torch.float64)
    rows = torch.arange(L)
    for j0 in range(0, L, FA.BLOCK):
        j1 = min(j0 + FA.BLOCK, L)
        s = torch.matmul(qb[:, j0:], kb[:, j0:j1].mT)
        mask = rows[j0:j1][None, :] <= rows[j0:][:, None]
        s = torch.where(mask, s, FA.NEG)
        m_new = torch.maximum(m[:, j0:], s.amax(-1).double())
        p = torch.where(mask, torch.exp(s - m_new[..., None].float()), 0.0)
        p = p * (1 + (torch.rand(p.shape, generator=g) * 2 - 1) * 2 ** -16)
        corr = torch.exp(m[:, j0:] - m_new)
        l[:, j0:] = l[:, j0:] * corr + p.double().sum(-1)
        acc[:, j0:] = acc[:, j0:] * corr[..., None] + torch.matmul(
            FA._bf16(p).double(), vb[:, j0:j1].double())
        m[:, j0:] = m_new
    return FA._to_blhd((acc / l[..., None]).float(), B, Hh, torch.float32)


@pytest.mark.parametrize("B,L,Hh,D", [(1, 136, 2, 128), (1, 72, 2, 64),
                                      (2, 40, 2, 32)])
def test_forward_flips_explain_a_perturbed_forward(B, L, Hh, D):
    """A forward that keeps the kernel's bf16 rounding points but computes
    p a little otherwise differs from the twin past f32 level only by
    one-step bf16 flips of p: every such row of out is explained, flips
    are found, and without them the mean error is within the card's f32
    limit, 1e-5 of the mean magnitude."""
    q, k, v = _flip_case(B, L, Hh, D, seed=6)[:3]
    found = forward_flips(q, k, v, _perturbed_forward(q, k, v))
    assert found["flips"] > 0, found
    assert found["unexplained_rows"] == 0, found
    assert found["mean_err_share_without_flips"] <= 1e-5, found


def test_forward_flips_leave_a_faulty_row_unexplained():
    """The twin against itself: nothing past f32 level. A lost last query
    row of out (as a ragged edge row not stored) and a row skewed by 1e-3
    of its size are not bf16 flips of p, and stay unexplained."""
    q, k, v = _flip_case(1, 72, 2, 64, seed=7)[:3]
    out, _ = FA.flash_fwd_plain(q, k, v)
    clean = forward_flips(q, k, v, out)
    assert clean["elements_past_f32"] == 0, clean
    zeroed, skewed = out.clone(), out.clone()
    zeroed[:, -1] = 0.0
    skewed[:, 5, 1] *= 1 + 1e-3
    for bad in (zeroed, skewed):
        found = forward_flips(q, k, v, bad)
        assert found["unexplained_rows"] >= 1, found


@pytest.mark.parametrize("L,D", [(40, 32), (136, 64)])
def test_autograd_function_keeps_one_bf16_copy_of_f32_inputs(L, D):
    """For an f32 caller the forward saves the bf16 copies of q, k, v it
    read (not the f32 originals) and the backward rounds only dO; out and
    the f32 gradients through :class:`FlashAttentionFn` are the twins'
    on the f32 inputs bit for bit."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(L, D, seed=8))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FA.flash_attention(*leaves)
    saved = out.grad_fn.saved_tensors
    assert [t.dtype for t in saved[:3]] == [torch.bfloat16] * 3
    for t, x in zip(saved[:3], (q, k, v)):
        assert torch.equal(t, x.to(torch.bfloat16))
    grads = torch.autograd.grad(out, leaves, do)
    ref_out, lse = FA.flash_fwd_plain(q, k, v)
    delta = FA.attention_delta(do, ref_out)
    want = (FA.flash_dq_plain(q, k, v, do, lse, delta),
            *FA.flash_dkv_plain(q, k, v, do, lse, delta))
    assert torch.equal(out.detach(), ref_out)
    for g, w in zip(grads, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
