"""The port's fused GroupNorm (``distkeras_tpu_torch/ops/kernels/groupnorm.py``)
on the CPU, where :func:`group_norm` takes the kernels' plain twins through
the same autograd Function the card uses, against the JAX package's
``group_norm`` with its Pallas kernels in interpret mode, on the same
seeded numpy inputs. Forward within atol 2e-5 and the gradients of
``sum(sin(y))`` within atol 3e-4 (the JAX package's own tolerances against
flax: f32 statistics summed in another order, unit-scale inputs). At bf16
(the mixed-precision step's dtype) y, dx, dgamma and dbeta come out in
bf16, each within one bf16 ulp of its largest magnitude: the same f32
statistics and sums on the same bf16 values, rounded where the kernels
store, so only a sum order that flips one rounding may differ, by one
ulp. The plain backward twin is also held against autograd through the
plain forward in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.pallas.groupnorm import group_norm as jax_group_norm
from distkeras_tpu_torch.ops.kernels import groupnorm as G


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=C).astype(np.float32),
            rng.normal(size=C).astype(np.float32))


def _jax(x, g, b, groups, relu):
    """y and the gradients of sum(sin(y)) through the JAX kernel."""
    def loss(args):
        return jnp.sum(jnp.sin(jax_group_norm(*args, groups=groups,
                                              relu=relu, interpret=True)))

    args = tuple(jnp.asarray(a) for a in (x, g, b))
    y = jax_group_norm(*args, groups=groups, relu=relu, interpret=True)
    return np.asarray(y), [np.asarray(d) for d in jax.grad(loss)(args)]


def _port(x, g, b, groups, relu):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    y = G.group_norm(*leaves, groups=groups, relu=relu)
    grads = torch.autograd.grad(torch.sin(y).sum(), leaves)
    return y.detach().numpy(), [d.numpy() for d in grads]


@pytest.mark.parametrize("shape,groups", [
    ((3, 8, 8, 64), 16),    # the JAX kernel's lane-folded C < 128 path
    ((2, 4, 4, 256), 32),   # its direct path
    ((2, 16, 128), 16),     # 3-D input, already [B, N, C]
])
@pytest.mark.parametrize("relu", [False, True])
def test_group_norm_matches_jax_kernel(shape, groups, relu):
    x, g, b = _inputs(shape)
    y_ref, d_ref = _jax(x, g, b, groups, relu)
    before = G.launch_counts()
    y, d = _port(x, g, b, groups, relu)
    assert G.launch_counts() == before  # CPU: the plain twins
    assert y.shape == shape
    np.testing.assert_allclose(y, y_ref, atol=2e-5, rtol=0)
    for name, got, ref in zip(("dx", "dgamma", "dbeta"), d, d_ref):
        np.testing.assert_allclose(got, ref, atol=3e-4, rtol=0,
                                   err_msg=name)


def _within_bf16_ulp(got, ref, name):
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    err = np.abs(got - ref).max()
    assert err <= ulp, (name, err, ulp)


@pytest.mark.parametrize("shape,groups", [
    ((3, 8, 8, 64), 16), ((2, 4, 4, 256), 32), ((2, 16, 128), 16)])
@pytest.mark.parametrize("relu", [False, True])
def test_group_norm_bf16_matches_jax_kernel(shape, groups, relu):
    """bf16 x, gamma and beta through both kernels (the JAX package's own
    bf16 case, ``tests/test_pallas_groupnorm.py``, at the shapes above);
    the loss ``sum(sin(y))`` is taken in f32 on both sides."""
    x, g, b = _inputs(shape)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
              for a in (x, g, b)]
    args = tuple(jnp.asarray(t.detach().float().numpy(), jnp.bfloat16)
                 for t in leaves)

    def loss(a):
        y = jax_group_norm(*a, groups=groups, relu=relu, interpret=True)
        return jnp.sum(jnp.sin(y.astype(jnp.float32)))

    y_ref = jax_group_norm(*args, groups=groups, relu=relu, interpret=True)
    d_ref = jax.grad(loss)(args)
    y = G.group_norm(*leaves, groups=groups, relu=relu)
    d = torch.autograd.grad(torch.sin(y.float()).sum(), leaves)
    assert y.dtype == torch.bfloat16
    _within_bf16_ulp(y.detach().float().numpy(),
                     np.asarray(y_ref.astype(jnp.float32)), "y")
    for name, got, ref in zip(("dx", "dgamma", "dbeta"), d, d_ref):
        assert got.dtype == torch.bfloat16, name
        _within_bf16_ulp(got.float().numpy(),
                         np.asarray(ref.astype(jnp.float32)), name)


@pytest.mark.parametrize("relu", [False, True])
def test_group_norm_meets_the_jax_fallback(relu):
    """(1, 8*1009, 128): a slab the JAX wrapper cannot chunk for VMEM, so it
    takes its XLA path; the port's kernel path takes every shape. Forward
    within atol 2e-5; dx within atol 3e-4; dgamma and dbeta, sums over
    8072 rows that reach 1e3, within rtol 1e-4 of their largest value."""
    x, g, b = _inputs((1, 8 * 1009, 128))
    y_ref, d_ref = _jax(x, g, b, 16, relu)
    y, d = _port(x, g, b, 16, relu)
    np.testing.assert_allclose(y, y_ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(d[0], d_ref[0], atol=3e-4, rtol=0)
    for got, ref in zip(d[1:], d_ref[1:]):
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_forward_alone_matches_the_autograd_forward():
    x, g, b = _inputs((2, 5, 5, 32))
    with torch.no_grad():
        y = G.group_norm(*map(torch.from_numpy, (x, g, b)), groups=8,
                         relu=True)
    y_ref, _ = _port(x, g, b, 8, True)
    assert torch.equal(y, torch.from_numpy(y_ref))


def test_indivisible_groups_raise():
    x, g, b = map(torch.from_numpy, _inputs((2, 4, 4, 24)))
    with pytest.raises(ValueError, match="divisible"):
        G.group_norm(x, g, b, groups=5)


@pytest.mark.parametrize("relu", [False, True])
def test_bwd_plain_matches_autograd_of_fwd_plain_in_float64(relu):
    rng = np.random.default_rng(1)
    B, N, C, groups = 3, 10, 12, 3
    x, g, b, dy = (torch.from_numpy(rng.normal(size=s))
                   for s in ((B, N, C), C, C, (B, N, C)))
    leaves = [t.clone().requires_grad_() for t in (x, g, b)]
    y = G.group_norm_fwd_plain(*leaves, groups, relu)
    ref = torch.autograd.grad((y * dy).sum(), leaves)
    got = G.group_norm_bwd_plain(x, dy, g, b, groups, relu)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-10, atol=1e-10)


def test_rows_per_chunk_covers_every_slab():
    for N, C in ((12544, 64), (49, 2048), (3136, 256), (1, 8), (7, 24)):
        rows = G.rows_per_chunk(N, C)
        assert 1 <= rows <= N
        assert rows * min(C, 256) <= 8192 or rows == 1
