"""On-device augmentation in the port (``distkeras_tpu_torch/ops/
augment.py`` behind ``device_transform=`` and the local loop's
``input_transform``) against the JAX package's ``ops/augment.py``.

The port draws its flips and offsets from a CPU ``torch.Generator``; it
cannot reproduce ``jax.random``'s bits (as with dropout), so parity is
held given the same draws: ``flip_crop`` fed the JAX package's own
``split``/``bernoulli``/``randint`` draws is bit-equal to
``random_flip_crop`` (a gather: no tolerance), in uint8 and f32, at pad 0
and 4 and at a batch of one. The port's own draws are deterministic in
(seed, round, worker, step), a checkpointed run under ``device_transform``
resumes bit-equal to the uninterrupted one, and uint8 rows are divided by
255 after the transform.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops import augment as jax_augment
from distkeras_tpu_torch import ADAG, DataFrame, SynchronousDistributedTrainer
from distkeras_tpu_torch.models import Model, SimpleCNN
from distkeras_tpu_torch.ops.augment import (flip_crop, flip_crop_transform,
                                             random_flip_crop)
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.optimizers import get_optimizer
from distkeras_tpu_torch.workers import (AUGMENT_STREAM, derive_seed,
                                         make_local_loop)


def _images(n=8, h=16, w=16, dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, size=(n, h, w, 3)).astype(np.uint8)
    return rng.random((n, h, w, 3)).astype(dtype)


def _jax_draws(key, B, pad):
    """The JAX package's draws in ``random_flip_crop``'s order."""
    k1, k2, k3 = jax.random.split(key, 3)
    flip = jax.random.bernoulli(k1, 0.5, (B,))
    ys = jax.random.randint(k2, (B,), 0, 2 * pad + 1)
    xs = jax.random.randint(k3, (B,), 0, 2 * pad + 1)
    return (torch.from_numpy(np.asarray(a).copy()) for a in (flip, ys, xs))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("pad", [0, 4])
@pytest.mark.parametrize("B,h,w", [(8, 16, 16), (1, 12, 9), (5, 7, 11)])
def test_flip_crop_is_the_jax_packages_given_its_draws(dtype, pad, B, h, w):
    x = _images(B, h, w, dtype, seed=B + pad)
    for seed in range(3):
        key = jax.random.key(seed)
        want = np.asarray(jax_augment.random_flip_crop(key, jnp.asarray(x),
                                                       pad=pad))
        got = flip_crop(torch.from_numpy(x), *_jax_draws(key, B, pad), pad)
        assert got.dtype == torch.from_numpy(x).dtype
        assert got.numpy().tobytes() == want.tobytes()


def test_flip_crop_is_one_gather_of_reflected_indices():
    """Every output image is one (flip, y, x) crop of its input padded by
    numpy's reflect, the edge not repeated; a pad larger than the image
    reflects on, as ``np.pad`` does."""
    x = _images(4, 6, 5)
    for pad in (2, 7):
        B = len(x)
        flip = torch.tensor([False, True, True, False])
        ys = torch.tensor([0, 2 * pad, pad, 1])
        xs = torch.tensor([2 * pad, 0, 3, pad])
        got = flip_crop(torch.from_numpy(x), flip, ys, xs, pad).numpy()
        for i in range(B):
            img = x[i, :, ::-1] if flip[i] else x[i]
            padded = np.pad(img, ((pad, pad), (pad, pad), (0, 0)),
                            mode="reflect")
            np.testing.assert_array_equal(
                got[i], padded[ys[i]:ys[i] + 6, xs[i]:xs[i] + 5])


def test_random_flip_crop_draws_from_its_generator():
    x = torch.from_numpy(_images())
    a = random_flip_crop(torch.Generator().manual_seed(4), x)
    b = random_flip_crop(torch.Generator().manual_seed(4), x)
    c = random_flip_crop(torch.Generator().manual_seed(5), x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    gen = torch.Generator().manual_seed(4)
    flip = torch.rand(8, generator=gen) < 0.5
    ys = torch.randint(0, 9, (8,), generator=gen)
    xs = torch.randint(0, 9, (8,), generator=gen)
    assert torch.equal(a, flip_crop(x, flip, ys, xs, 4))
    y = torch.arange(8)
    fx, fy = flip_crop_transform(pad=4)(torch.Generator().manual_seed(4),
                                        x, y)
    assert torch.equal(fx, a) and fy is y


def _cnn(hw, c=3):
    module = SimpleCNN(conv_features=(8,), dense=(16,), num_outputs=c,
                       input_shape=(hw, hw, 3))
    return Model.build(module, np.zeros((1, hw, hw, 3), np.float32),
                       device="cpu")


def _frame(n=64, hw=12, c=3, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, size=n).astype(np.int32)
    x = (rng.integers(0, 60, size=(n, hw, hw, 3))
         + y[:, None, None, None] * 80).clip(0, 255).astype(np.uint8)
    return DataFrame({"features": x, "label": y})


class _Recording:
    """``flip_crop_transform`` recording each call's generator seed and
    output batch."""

    def __init__(self, pad=2):
        self.inner = flip_crop_transform(pad=pad)
        self.calls = []

    def __call__(self, gen, x, y):
        seed = gen.initial_seed()
        out = self.inner(gen, x, y)
        self.calls.append((seed, out[0].clone()))
        return out


def test_port_draws_are_deterministic_in_seed_round_worker_and_step():
    """Two runs of one seed augment identically; each (round, worker, step)
    draws from its own generator, seeded ``derive_seed(round seed of the
    worker, step, 0, AUGMENT_STREAM)``; another seed augments otherwise."""
    df = _frame()
    runs = []
    for seed in (0, 0, 1):
        rec = _Recording()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ADAG(_cnn(12), loss="sparse_categorical_crossentropy",
                 num_workers=2, batch_size=8, communication_window=2,
                 learning_rate=0.05, seed=seed, device_transform=rec
                 ).train(df)
        runs.append(rec.calls)
    (a, b, c) = runs
    assert len(a) == 2 * 2 * 2  # rounds x workers x steps
    assert [s for s, _ in a] == [s for s, _ in b]
    assert all(torch.equal(p, q) for (_, p), (_, q) in zip(a, b))
    assert len({s for s, _ in a}) == len(a)
    rng = 0
    want = []
    for _r in range(2):
        for w in range(2):
            want += [derive_seed(derive_seed(rng, w), k, 0, AUGMENT_STREAM)
                     for k in range(2)]
        rng = derive_seed(rng)
    assert [s for s, _ in a] == want
    assert [s for s, _ in a] != [s for s, _ in c]


@pytest.mark.parametrize("trainer", ["ADAG", "SynchronousDistributedTrainer"])
def test_checkpoint_resume_is_exact_under_device_transform(tmp_path,
                                                           trainer):
    """A 2-epoch run with a checkpoint a round, resumed to 4 epochs, is
    bit-equal to the uninterrupted 4-epoch run: the augmentation seeds ride
    the engine's checkpointed seed chain."""
    df = _frame(n=64)
    cls = {"ADAG": ADAG,
           "SynchronousDistributedTrainer": SynchronousDistributedTrainer}[
        trainer]
    common = dict(loss="sparse_categorical_crossentropy", num_workers=2,
                  batch_size=8, learning_rate=0.05,
                  device_transform=flip_crop_transform(pad=2))
    common.update({"communication_window": 2} if trainer == "ADAG"
                  else {"steps_per_program": 2})
    ck = str(tmp_path / "ck")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        full = cls(_cnn(12), num_epoch=4, **common).train(df)
        cls(_cnn(12), num_epoch=2, checkpoint_dir=ck, checkpoint_every=1,
            **common).train(df)
        t = cls(_cnn(12), num_epoch=4, checkpoint_dir=ck, checkpoint_every=1,
                resume=True, **common)
        resumed = t.train(df)
    assert len(t.get_history()) == 4  # the rounds run after the resume
    for k, v in full.params.items():
        assert torch.equal(resumed.params[k], v), k
    plain = cls(_cnn(12), num_epoch=4, **{
        k: v for k, v in common.items() if k != "device_transform"})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        unaugmented = plain.train(df)
    assert any(not torch.equal(unaugmented.params[k], v)
               for k, v in full.params.items())


def test_uint8_is_normalized_after_the_transform_and_before_the_split():
    """The transform sees each step's whole uint8 batch (before the
    ``grad_accum`` split) and the model sees its output divided by 255."""
    seen, fed = [], []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3, 2))

        def forward(self, x):
            fed.append(x.detach().clone())
            return x.reshape(len(x), -1)[:, :3] @ self.w

    def to_255(gen, x, y):
        seen.append((x.dtype, tuple(x.shape)))
        return torch.full_like(x, 255), y

    module = Probe()
    tx = get_optimizer("sgd", 0.1)
    loop = make_local_loop(module, get_loss("sparse_categorical_crossentropy"),
                           tx, grad_accum=2, input_transform=to_255)
    params = {k: v.detach() for k, v in module.named_parameters()}
    xs = torch.from_numpy(_images(12, 2, 2)).reshape(3, 4, 2, 2, 3)
    ys = torch.zeros(3, 4, dtype=torch.int64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loop(params, tx.init(params), xs, ys, rng=7)
    assert seen == [(torch.uint8, (4, 2, 2, 3))] * 3
    assert len(fed) == 6 and all(f.shape == (2, 2, 2, 3) for f in fed)
    assert all(f.dtype == torch.float32 and bool((f == 1.0).all())
               for f in fed)
