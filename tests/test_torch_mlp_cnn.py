"""The port's MNIST MLP and CNNs (``distkeras_tpu_torch/models/mlp.py``,
``models/cnn.py``; BASELINE configs #1-#3) and ``datasets.mnist`` against
the JAX package's, on parameters carried across by
``convert.params_from_jax`` (flax's HWIO conv kernels become OIHW, Dense
kernels are transposed).

Tolerances: ``mnist()`` bit-equal; logits and the gradient of
``sparse_categorical_crossentropy`` with respect to every parameter within
rtol = atol = 1e-5 in f32 (the products and the convolutions' sums run in
another order). The configs run at their real widths: the CNNs' first
dense layer reads 7*7*64 = 3136 (MNIST) and 4*4*256 = 4096 (CIFAR-10)
features, so a flatten in any order but flax's H, W, C would permute its
rows and fail here. A 30x30 input with an even kernel (2 and 4) checks
flax's asymmetric ``"SAME"`` padding and the pool's floor of odd sizes
(30 -> 15 -> 7).
"""

import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import datasets as jax_datasets
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.cnn import SimpleCNN as JaxCNN
from distkeras_tpu.models.cnn import cifar10_cnn as jax_cifar10_cnn
from distkeras_tpu.models.cnn import mnist_cnn as jax_mnist_cnn
from distkeras_tpu.models.mlp import MLP as JaxMLP
from distkeras_tpu.models.mlp import mnist_mlp as jax_mnist_mlp
from distkeras_tpu.ops.losses import get_loss as jax_get_loss
from distkeras_tpu_torch import datasets
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.models import (
    MLP,
    Model,
    SimpleCNN,
    cifar10_cnn,
    mnist_cnn,
    mnist_mlp,
    normalize_features,
)
from distkeras_tpu_torch.ops.losses import get_loss

LOSS = "sparse_categorical_crossentropy"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_mnist_matches_jax(flat, seed):
    ref = jax_datasets.mnist(n=257, flat=flat, seed=seed)
    got = datasets.mnist(n=257, flat=flat, seed=seed)
    assert got.synthetic and ref.synthetic
    assert got.columns == ref.columns
    for k in ref.columns:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        np.testing.assert_array_equal(got[k], ref[k])
    assert got["features"].shape[1:] == ((784,) if flat else (28, 28, 1))


def test_mnist_reads_idx_files_as_jax_does(tmp_path):
    """``data_dir`` with the two gzipped IDX files: the real-data path,
    bit-equal to the JAX loader's (``n`` cuts it)."""
    rng = np.random.default_rng(0)
    n = 12
    images = rng.integers(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    with gzip.open(tmp_path / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with gzip.open(tmp_path / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    for flat in (False, True):
        ref = jax_datasets.mnist(n=10, data_dir=str(tmp_path), flat=flat)
        got = datasets.mnist(n=10, data_dir=str(tmp_path), flat=flat)
        assert not got.synthetic and not ref.synthetic
        for k in ref.columns:
            np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(got["label"], labels[:10].astype(np.int32))


def _port(jm, module, sample):
    pm = Model.build(module, sample, device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return pm


def _logits_and_grads_match(jm, pm, x, y):
    """Logits (through ``Model.predict``, so the uint8 rule applies on
    both sides) and the loss gradient of every parameter."""
    ref = np.asarray(jm.predict(jnp.asarray(x)))
    got = pm.predict(x).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    jloss = jax_get_loss(LOSS)
    grads = jax.grad(lambda p: jloss(jm.apply(p, jnp.asarray(x)),
                                     jnp.asarray(y)))(jm.params)
    ref_g = params_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                            pm.module)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in pm.params.items()}
    out = torch.func.functional_call(pm.module, leaves, (_normalized(pm, x),))
    loss = get_loss(LOSS)(out, torch.from_numpy(y))
    got_g = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    assert set(got_g) == set(ref_g)
    for k, v in ref_g.items():
        np.testing.assert_allclose(got_g[k].numpy(), v.numpy(), **TOL,
                                   err_msg=k)
    return got


def _normalized(pm, x):
    return normalize_features(torch.from_numpy(x), pm.normalize_uint8)


def _batch(shape, n=6, seed=0, classes=10):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n,) + shape).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32))


@pytest.mark.parametrize("name,shape,params", [
    ("mnist_mlp", (784,), 648_010),
    ("mnist_cnn", (28, 28, 1), 421_642),
    ("cifar10_cnn", (32, 32, 3), 1_422_218)])
def test_configs_match_jax_at_real_widths(name, shape, params):
    jax_fn = {"mnist_mlp": jax_mnist_mlp, "mnist_cnn": jax_mnist_cnn,
              "cifar10_cnn": jax_cifar10_cnn}[name]
    port_fn = {"mnist_mlp": mnist_mlp, "mnist_cnn": mnist_cnn,
               "cifar10_cnn": cifar10_cnn}[name]
    jm = jax_fn(seed=2)
    pm = port_fn(device="cpu")
    assert sum(v.numel() for v in pm.params.values()) == params
    assert sum(np.size(v) for v in jax.tree_util.tree_leaves(
        jm.params)) == params
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    x, y = _batch(shape)
    _logits_and_grads_match(jm, pm, x, y)


@pytest.mark.parametrize("activation", ["relu", "tanh", "gelu", "sigmoid"])
def test_mlp_activations_match_jax(activation):
    """flax's ``nn.gelu`` is the tanh approximation; the port's too. A
    [B, 4, 5] input is flattened to 20 features."""
    cfg = dict(hidden=(32, 16), num_outputs=7, activation=activation)
    jm = JaxModel.build(JaxMLP(**cfg), jnp.zeros((1, 4, 5), jnp.float32),
                        seed=1)
    pm = _port(jm, MLP(**cfg, in_features=20),
               np.zeros((1, 4, 5), np.float32))
    x, y = _batch((4, 5), n=5, classes=7)
    _logits_and_grads_match(jm, pm, 3.0 * x - 1.5, y)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_cnn_same_padding_and_odd_pools_match_jax(k):
    """A 30x30x3 input: 30 -> 15 -> 7 after the pools (VALID, floored); an
    even ``kernel_size`` pads (k-1)//2 before and k//2 after."""
    cfg = dict(conv_features=(8, 16), kernel_size=k, dense=(16,),
               num_outputs=10)
    jm = JaxModel.build(JaxCNN(**cfg), jnp.zeros((1, 30, 30, 3), jnp.float32),
                        seed=4)
    pm = _port(jm, SimpleCNN(**cfg, input_shape=(30, 30, 3)),
               np.zeros((1, 30, 30, 3), np.float32))
    assert pm.module.Dense_0.in_features == 7 * 7 * 16
    x, y = _batch((30, 30, 3), n=4)
    _logits_and_grads_match(jm, pm, x, y)


@pytest.mark.filterwarnings("ignore:uint8 features detected")
def test_uint8_images_take_the_255_rule_as_jax_does():
    """Both packages warn once a process when the rule fires, so whether
    this test sees the notice depends on what ran before it: it checks
    the values only."""
    jm = jax_mnist_cnn(seed=5)
    pm = mnist_cnn(device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (4, 28, 28, 1)).astype(np.uint8)
    y = rng.integers(0, 10, 4).astype(np.int32)
    got = _logits_and_grads_match(jm, pm, x, y)
    np.testing.assert_allclose(
        got, pm.predict(x.astype(np.float32) / 255.0).numpy(), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("make", ["mlp", "cnn"])
def test_dropout_in_train_mode_only(make):
    """``dropout_rate > 0`` (the port's own generator; the bits cannot
    match flax's): eval mode is the rate-0 forward exactly; train mode
    drops a share of hidden units near the rate and scales the rest by
    1/(1 - rate), and one generator seed gives one mask."""
    rate = 0.25
    if make == "mlp":
        kw = dict(hidden=(256, 256), num_outputs=10, in_features=784)
        drop, keep = MLP(**kw, dropout_rate=rate), MLP(**kw)
        x = torch.rand(64, 784, generator=torch.Generator().manual_seed(0))
        hidden = "Dense_1"
    else:
        kw = dict(conv_features=(8,), dense=(512,), num_outputs=10,
                  input_shape=(8, 8, 1))
        drop, keep = SimpleCNN(**kw, dropout_rate=rate), SimpleCNN(**kw)
        x = torch.rand(64, 8, 8, 1, generator=torch.Generator().manual_seed(0))
        hidden = "Dense_1"
    drop.eval()
    keep.eval()
    assert torch.equal(drop(x), keep(x))
    seen = []
    getattr(drop, hidden).register_forward_pre_hook(
        lambda _m, args: seen.append(args[0].detach()))
    getattr(keep, hidden).register_forward_pre_hook(
        lambda _m, args: seen.append(args[0].detach()))
    drop.train()
    a = drop(x, rng=torch.Generator().manual_seed(7))
    b = drop(x, rng=torch.Generator().manual_seed(7))
    keep(x)
    assert torch.equal(a, b)
    dropped, full = seen[0], seen[2]
    live = full != 0
    zeroed = (dropped[live] == 0).float().mean().item()
    assert abs(zeroed - rate) < 0.03, zeroed
    kept = dropped[live] != 0
    torch.testing.assert_close(dropped[live][kept],
                               full[live][kept] / (1 - rate))


def test_unknown_activation_and_modules_raise():
    with pytest.raises(ValueError, match="activation"):
        MLP(activation="swish")
    pm = mnist_mlp(device="cpu")
    with pytest.raises(KeyError, match="unknown MLP/SimpleCNN module"):
        params_from_jax({"Embed_0": {}}, pm.module)


def test_entry_points_raise_without_a_card(monkeypatch):
    """``device=None`` means the card: without one the new entry points
    raise rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (mnist_mlp, mnist_cnn, cifar10_cnn):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert make(device="cpu").device.type == "cpu"
