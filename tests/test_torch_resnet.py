"""The port's GroupNorm ResNet (``distkeras_tpu_torch/models/resnet.py``)
against the JAX package's, on parameters carried across by
``convert.params_from_jax`` (flax's HWIO conv kernels become OIHW). The
JAX model runs ``norm_impl="pallas"`` (its Pallas GroupNorm in interpret
mode) and ``"xla"``; the port runs both of its impls on the CPU. Logits
within rtol 1e-4, atol 1e-5 (f32 convolutions and statistics summed in
another order). The 7x7-stem case at 64x64 pins flax's asymmetric "SAME"
padding (2 low, 3 high) of the strided stem and max-pool. At bf16 (the
parameters and images cast as the mixed-precision step casts them) the
logits agree within one bf16 ulp of their largest magnitude: torch's and
XLA's bf16 convolutions, and the two GroupNorms, round at the same
points."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.resnet import ResNet as JaxResNet
from distkeras_tpu.models.resnet import (
    remap_legacy_params as jax_remap_legacy_params,
)
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.models import Model, resnet
from distkeras_tpu_torch.ops.kernels import groupnorm as G

TINY = dict(stage_sizes=(1, 1), base_features=8, num_outputs=10,
            stem_kernel=3, groups=4)
STEM7 = dict(stage_sizes=(1, 1), base_features=8, num_outputs=10,
             stem_kernel=7, groups=4)


def _pair(cfg, size, impl, seed=0):
    jm = JaxModel.build(JaxResNet(**cfg, norm_impl=impl),
                        jnp.zeros((1, size, size, 3), jnp.float32),
                        seed=seed)
    pm = Model.build(resnet.ResNet(**cfg, norm_impl=impl),
                     np.zeros((1, size, size, 3), np.float32), device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return jm, pm


def _images(n, size, seed=0):
    return np.random.default_rng(seed).uniform(
        size=(n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("cfg,size", [(TINY, 32), (STEM7, 64)],
                         ids=["tiny", "stem7"])
def test_logits_match_jax(cfg, size, impl):
    jm, pm = _pair(cfg, size, impl)
    x = _images(3, size)
    ref = np.asarray(jax.jit(jm.apply)(jm.params, jnp.asarray(x)))
    before = G.launch_counts()
    got = pm.predict(x).numpy()
    assert G.launch_counts() == before  # CPU: the plain twins
    assert got.shape == (3, 10)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("cfg,size", [(TINY, 32), (STEM7, 64)],
                         ids=["tiny", "stem7"])
def test_bf16_logits_match_jax(cfg, size, impl, monkeypatch):
    from torch.func import functional_call

    from distkeras_tpu.ops.precision import cast_floats as jax_cast_floats
    from distkeras_tpu_torch.ops.precision import cast_floats

    seen = []
    real = G.group_norm_fwd_plain

    def recording(x3, *args):
        seen.append(x3.dtype)
        return real(x3, *args)

    monkeypatch.setattr(G, "group_norm_fwd_plain", recording)
    jm, pm = _pair(cfg, size, impl)
    x = _images(3, size)
    ref = jm.module.apply(
        {"params": jax_cast_floats(jm.params, jnp.bfloat16)},
        jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = functional_call(
            pm.module, cast_floats(pm.params, torch.bfloat16),
            (torch.from_numpy(x).to(torch.bfloat16),))
    assert got.dtype == torch.bfloat16
    # every GroupNorm took the bf16 activations (9 of them in these nets)
    assert seen == ([torch.bfloat16] * 9 if impl == "pallas" else [])
    ref = np.asarray(ref.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert np.abs(got.float().numpy() - ref).max() <= ulp


def test_tiny_resnet_is_the_jax_tiny_resnet():
    pm = resnet.tiny_resnet(device="cpu", norm_impl="pallas")
    assert pm.module.get_config()["stage_sizes"] == TINY["stage_sizes"]
    jm, ref = _pair(TINY, 32, "pallas")
    assert set(pm.module.state_dict()) == set(ref.module.state_dict())


def test_remat_forward_and_gradients_equal_the_plain_ones():
    x = torch.from_numpy(_images(2, 32))
    outs = []
    for remat in (False, True):
        m = resnet.ResNet(**TINY, norm_impl="pallas", remat=remat, seed=3)
        out = m(x)
        grads = torch.autograd.grad(out.square().sum(), list(m.parameters()))
        outs.append((out.detach(), grads))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cfg,size", [
    (TINY, 32), (dict(stage_sizes=(3, 4, 6, 3)), 224)], ids=["tiny", "r50"])
def test_parameter_count_equals_the_jax_one(cfg, size):
    shapes = jax.eval_shape(JaxResNet(**cfg).init, jax.random.key(0),
                            jnp.zeros((1, size, size, 3)))["params"]
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    m = resnet.ResNet(**cfg)
    assert sum(p.numel() for p in m.parameters()) == n_jax
    if size == 224:
        assert n_jax == 25_557_032


def test_same_pads_follow_flax():
    assert resnet.same_pads(224, 7, 2) == (2, 3)
    assert resnet.same_pads(56, 3, 2) == (0, 1)
    assert resnet.same_pads(32, 3, 2) == (0, 1)
    assert resnet.same_pads(112, 3, 2) == (0, 1)
    assert resnet.same_pads(56, 1, 2) == (0, 0)
    assert resnet.same_pads(56, 3, 1) == (1, 1)


def _legacy(tree):
    """A current JAX ResNet tree renamed to the legacy auto-generated
    layout (BottleneckBlock_n, GroupNorm_k)."""
    out, n = {}, 0
    for k, v in tree.items():
        if k.startswith("stage"):
            out[f"BottleneckBlock_{n}"] = {
                kk.replace("GN_", "GroupNorm_", 1): vv for kk, vv in v.items()}
            n += 1
        else:
            out[k.replace("GN_", "GroupNorm_", 1)] = v
    return out


def test_remap_legacy_params_matches_jax():
    jm, pm = _pair(TINY, 32, "xla")
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    legacy = _legacy(dict(tree))
    assert resnet.detect_legacy_layout(legacy)
    assert not resnet.detect_legacy_layout(tree)
    got = resnet.remap_legacy_params(legacy, TINY["stage_sizes"])
    ref = jax_remap_legacy_params(legacy, TINY["stage_sizes"])
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(ref)
    sd = params_from_jax(got, pm.module)
    for k, v in pm.module.state_dict().items():
        assert torch.equal(sd[k], v)
    with pytest.raises(KeyError, match="legacy"):
        resnet.remap_legacy_params(tree)
    with pytest.raises(KeyError, match="stage_sizes"):
        resnet.remap_legacy_params(legacy, (1,))
    with pytest.raises(KeyError, match="remap_legacy_params"):
        params_from_jax(legacy, pm.module)


def test_uint8_images_are_rescaled_as_in_jax():
    """Raw image bytes go through the /255 rule on the port's predict path
    and on the JAX one alike."""
    jm, pm = _pair(TINY, 32, "xla")
    x8 = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3)).astype(
        np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the once-a-process /255 notice
        got = pm.predict(x8).numpy()
        want = np.asarray(jm.predict(x8))
    np.testing.assert_array_equal(
        got, pm.predict(x8.astype(np.float32) / 255.0).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
