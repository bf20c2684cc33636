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


#: every distinct GroupNorm slab of ResNet-50 at 224x224 (N = H*W, C),
#: G=32, and odd ones: channels that take no 16-byte vector, a tile wider
#: than a line, one group of all channels.
RESNET_SLABS = ((112 * 112, 64), (56 * 56, 64), (56 * 56, 256),
                (56 * 56, 128), (28 * 28, 128), (28 * 28, 512),
                (28 * 28, 256), (14 * 14, 256), (14 * 14, 1024),
                (14 * 14, 512), (7 * 7, 512), (7 * 7, 2048))
ODD_SLABS = ((10, 12, 3), (7, 6, 3), (5, 24, 8), (100, 96, 1), (3, 2, 2),
             (9, 1000, 10))


def _check_tiling(N, C, groups, itemsize, backward, t):
    cg = C // groups
    assert C % t.ct == 0 and t.ct % cg == 0 and t.ct % t.vec == 0
    assert C % t.vec == 0 and t.vec * itemsize <= 16
    # a line wide where C is; half a line only where two blocks an SM
    # keep every row on chip
    assert t.ct * itemsize >= 128 or t.ct == C or (
        t.threads < G.GN_THREADS and t.ct * itemsize >= 64)
    assert t.ct // t.vec <= t.threads
    assert t.threads in (G.GN_FEW_THREADS, G.GN_SMALL_THREADS, G.GN_THREADS)
    if t.threads < G.GN_THREADS:
        # two blocks an SM (or more), every row cached
        assert 2 * (t.smem + 1024) <= G.GN_SM_SMEM and t.cached == t.rows
    else:
        assert t.smem <= G.GN_MAX_SMEM
    if t.threads == G.GN_FEW_THREADS:
        assert t.rows * (t.ct // t.vec) <= G.GN_FEW_SLOTS
    assert t.cluster in G.GN_CLUSTERS + (G.GN_WIDE_CLUSTER,)
    assert t.rows == -(-N // t.cluster) and 0 < t.cached <= t.rows
    assert t.smem == G.gn_smem_bytes(t.ct, t.vec, t.threads, t.cached,
                                     itemsize, 2 if backward else 1,
                                     t.ct // cg)
    # the blocks' row shares cover the slab once, in rank order
    starts = [min(N, r * t.rows) for r in range(t.cluster)]
    ends = [min(N, s + t.rows) for s in starts]
    assert starts[0] == 0 and ends[-1] == N
    assert all(e == s for e, s in zip(ends, starts[1:]))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("N,C", RESNET_SLABS)
def test_gn_tiling_covers_every_resnet_slab(N, C, itemsize, backward):
    """Whole groups and whole 16-byte vectors a tile, a line wide, the
    slab's rows split over the fewest blocks whose share fits a block's
    shared memory, cached where it fits, within the block's limits."""
    t = G.gn_tiling(N, C, 32, itemsize, backward)
    _check_tiling(N, C, 32, itemsize, backward, t)
    line = max(128 // itemsize, C // 32)
    assert t.vec == 16 // itemsize and t.ct in (line, line // 2)
    assert t.threads < G.GN_THREADS  # every slab: two blocks an SM or more
    # one block an SM: 16 blocks keep every slab on chip, and a smaller
    # cluster's share would not fit
    sizes = G.GN_CLUSTERS + (G.GN_WIDE_CLUSTER,)
    one = G.gn_layout(N, C, 32, itemsize, backward, t.vec, line,
                      G.GN_THREADS, G.GN_MAX_SMEM)
    assert one.cached == one.rows
    for k in sizes:
        if k < one.cluster:
            assert G.gn_layout(N, C, 32, itemsize, backward, t.vec, line,
                               G.GN_THREADS, G.GN_MAX_SMEM,
                               sizes[:sizes.index(k) + 1]).cached < \
                -(-N // k)


@pytest.mark.parametrize("itemsize,backward,ct,cluster,cached", [
    (2, False, 64, 8, 1568), (2, True, 64, 8, 868),
    (4, False, 32, 8, 1568), (4, True, 32, 8, 888)])
def test_gn_tiling_at_the_stem(itemsize, backward, ct, cluster, cached):
    """112x112x64 laid out with the portable clusters alone and one block
    an SM (the card tests' uncached case): a cluster of 8 over 1568 rows a
    block; the forward caches them all, the backward (x and dy) what fits
    of them, and reads the rest again from L2."""
    t = G.gn_layout(112 * 112, 64, 32, itemsize, backward, 16 // itemsize,
                    ct, G.GN_THREADS, G.GN_MAX_SMEM, G.GN_CLUSTERS)
    assert (t.ct, t.cluster, t.rows, t.cached) == (ct, cluster, 1568, cached)
    assert t.vec * itemsize == 16 and t.threads == 512


@pytest.mark.parametrize("backward,cluster,rows", [(False, 4, 784),
                                                   (True, 8, 392)])
def test_gn_tiling_puts_two_blocks_an_sm_at_56x56(backward, cluster, rows):
    """3136x256 bf16: 256 threads a block and every row cached within
    115,712 bytes, so two blocks share an SM."""
    t = G.gn_tiling(56 * 56, 256, 32, 2, backward)
    assert (t.threads, t.cluster, t.rows, t.cached) == (256, cluster, rows,
                                                        rows)
    assert t.smem <= G.GN_HALF_SMEM


@pytest.mark.parametrize("itemsize", [2, 4])
def test_gn_tiling_takes_clusters_of_16_at_the_stem_alone(itemsize):
    """Only where 8 blocks cannot keep every row on chip two blocks an SM:
    the stem, 784 rows a block, all cached, the forward in tiles a line
    wide, the backward (x and dy) half a line; every other ResNet-50 slab
    keeps a portable cluster."""
    fwd = G.gn_tiling(112 * 112, 64, 32, itemsize, False)
    bwd = G.gn_tiling(112 * 112, 64, 32, itemsize, True)
    assert (fwd.cluster, fwd.rows, fwd.cached, fwd.threads) == (16, 784,
                                                                784, 256)
    assert (bwd.cluster, bwd.rows, bwd.cached, bwd.threads) == (16, 784,
                                                                784, 256)
    assert fwd.ct * itemsize == 128 and bwd.ct * itemsize == 64
    for N, C in RESNET_SLABS[1:]:
        for backward in (False, True):
            assert G.gn_tiling(N, C, 32, itemsize, backward).cluster <= 8


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("N,C,groups", ODD_SLABS)
def test_gn_tiling_covers_odd_slabs(N, C, groups, itemsize, backward):
    """Channels that no 16-byte vector divides take narrower vectors,
    one kernel for every shape."""
    t = G.gn_tiling(N, C, groups, itemsize, backward)
    _check_tiling(N, C, groups, itemsize, backward, t)


@pytest.mark.parametrize("align,vec", [(16, 8), (8, 4), (4, 2), (2, 1)])
def test_gn_tiling_follows_the_pointers_alignment(align, vec):
    """A vector never straddles the alignment of the tensors it moves."""
    t = G.gn_tiling(56 * 56, 256, 32, 2, False, align=align)
    assert t.vec == vec and t.ct == 64


def test_gn_tiling_refuses_a_row_past_one_block():
    """1026 f32 channels in one group: 513 vector lanes a row, more than a
    block's 512 threads."""
    with pytest.raises(ValueError, match="512 threads"):
        G.gn_tiling(4, 1026, 1, 4, False)
    with pytest.raises(ValueError, match="divisible"):
        G.gn_tiling(4, 24, 5, 4, False)


def test_gn_smem_bytes_mirrors_the_kernels_layout():
    """bf16 stem forward one block an SM in clusters of 8: 1568 cached
    rows of 64 channels (200,704 bytes),
    the reduction rows of 16 warps (8,192) and the partials, totals and
    group values (6 x 64 + 4 x 32 floats); the same as the layout's."""
    assert G.gn_smem_bytes(64, 8, 512, 1568, 2, 1, 32) == (
        1568 * 64 * 2 + 4 * (2 * 16 * 64 + 6 * 64 + 4 * 32)) == G.gn_layout(
            112 * 112, 64, 32, 2, False, 8, 64, G.GN_THREADS, G.GN_MAX_SMEM,
            G.GN_CLUSTERS).smem
    # ct/vec = 3 lanes do not divide a warp: a reduction row a thread row
    assert G.gn_smem_bytes(6, 2, 512, 7, 4, 2, 2) == (
        2 * 176 + 4 * (2 * 170 * 6 + 6 * 6 + 4 * 2))


@pytest.mark.parametrize("N,C", [(7 * 7, 2048), (14 * 14, 512)])
def test_gn_tiling_gives_small_blocks_128_threads(N, C):
    """ResNet-50's 7x7 and 14x14 slabs: a block's rows hold at most 2048
    vectors, 16 a thread of 128."""
    for itemsize in (2, 4):
        for backward in (False, True):
            t = G.gn_tiling(N, C, 32, itemsize, backward)
            assert t.threads == G.GN_FEW_THREADS and t.cluster == 1
            assert t.rows * (t.ct // t.vec) <= G.GN_FEW_SLOTS


#: other layouts of a slab, at a tile a line wide: (threads, shared
#: memory a block, cluster sizes); two, three and four blocks an SM, one
#: block an SM with clusters up to 16 and up to 8 (``tools/kernel_ab.py
#: --tilings`` times the last two beside the default).
ALTERNATIVES = ((256, G.GN_HALF_SMEM, None), (128, G.GN_SM_SMEM // 3 - 1024,
                                               None),
                (128, G.GN_SM_SMEM // 4 - 1024, None),
                (G.GN_THREADS, G.GN_MAX_SMEM, None),
                (G.GN_THREADS, G.GN_MAX_SMEM, G.GN_CLUSTERS))


@pytest.mark.parametrize("kw", [dict(zip(("threads", "smem", "clusters"), a))
                                for a in ALTERNATIVES])
def test_gn_tiling_alternatives_hold_the_kernels_limits(kw):
    """:func:`gn_layout` at the alternatives to the default: every
    ResNet-50 slab within the kernels' limits, the rows covered once."""
    for N, C in RESNET_SLABS:
        for itemsize in (2, 4):
            for backward in (False, True):
                d = G.gn_tiling(N, C, 32, itemsize, backward)
                line = max(128 // itemsize, C // 32)
                t = G.gn_layout(N, C, 32, itemsize, backward, d.vec, line,
                                kw["threads"], kw["smem"],
                                kw["clusters"] or G.GN_CLUSTERS
                                + (G.GN_WIDE_CLUSTER,))
                assert t.smem <= kw["smem"]
                cg = C // 32
                assert C % t.ct == 0 and t.ct % cg == 0 and t.ct % t.vec == 0
                assert t.ct // t.vec <= t.threads <= G.GN_THREADS
                assert t.smem <= G.GN_MAX_SMEM and 0 < t.cached <= t.rows
                assert t.rows * t.cluster >= N > t.rows * (t.cluster - 1)
                if t.threads < G.GN_THREADS:  # more than one block an SM
                    assert G.GN_SM_SMEM // (t.smem + 1024) >= 2
