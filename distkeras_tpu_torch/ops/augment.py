"""Image augmentation on the device (the port's counterpart of
``distkeras_tpu/ops/augment.py``): the crop and flip of a training batch
run where the batch already is, so the host stages raw uint8 rows.

``Trainer(device_transform=flip_crop_transform())`` hands the local loop
(``workers.make_local_loop``) a ``fn(gen, x, y) -> (x, y)`` that runs on
each step's device batch before the uint8 ``/255`` cast.

Determinism: ``gen`` is a CPU ``torch.Generator`` the local loop seeds from
the step's seed chain (``derive_seed`` of the engine's round seed, the
worker and the step), so the same (seed, round, worker, step) augments
identically, on the CPU and on the card, across a checkpoint and resume.
The B flips and 2B offsets are drawn on the CPU and moved with the batch.
The JAX package draws its own bits from ``jax.random``; the two packages
agree given the same draws (:func:`flip_crop`).
"""

from __future__ import annotations

import torch


def _reflect(i: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's ``reflect`` padding as an index map: position ``i`` of an
    axis of length ``n`` extended on both sides (the edge not repeated)."""
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = torch.remainder(i, period)
    return torch.where(m > n - 1, period - m, m)


def flip_crop(images: torch.Tensor, flip: torch.Tensor, ys: torch.Tensor,
              xs: torch.Tensor, pad: int = 4) -> torch.Tensor:
    """The deterministic core: image ``b`` flipped horizontally where
    ``flip[b]``, then ``pad``-reflect-padded and cropped back to ``H x W``
    at row offset ``ys[b]`` and column offset ``xs[b]`` (each in ``[0,
    2*pad]``).

    ``images`` is ``[B, H, W, C]`` of any dtype (uint8 stays uint8). Bit
    for bit the JAX package's flip, ``pad(mode="reflect")`` and two
    ``take_along_axis``: the reflected and flipped source row and column of
    every output pixel are computed as indices and the batch is gathered
    once, so the padded batch is never materialized."""
    B, H, W, _ = images.shape
    dev = images.device
    flip, ys, xs = (t.to(dev, non_blocking=True) for t in (flip, ys, xs))
    rows = _reflect(ys.long()[:, None] + torch.arange(H, device=dev) - pad,
                    H)
    cols = _reflect(xs.long()[:, None] + torch.arange(W, device=dev) - pad,
                    W)
    cols = torch.where(flip.bool()[:, None], W - 1 - cols, cols)
    b = torch.arange(B, device=dev)[:, None, None]
    return images[b, rows[:, :, None], cols[:, None, :]]


def draw_flip_crop(gen: torch.Generator, batch: int,
                   pad: int = 4) -> tuple:
    """The draws of :func:`random_flip_crop` for ``batch`` images, on the
    CPU: B flips with probability 1/2, then B row and B column offsets
    uniform in ``[0, 2*pad]``, in that order from ``gen``."""
    flip = torch.rand(batch, generator=gen) < 0.5
    ys = torch.randint(0, 2 * pad + 1, (batch,), generator=gen)
    xs = torch.randint(0, 2 * pad + 1, (batch,), generator=gen)
    return flip, ys, xs


def random_flip_crop(gen: torch.Generator, images: torch.Tensor,
                     pad: int = 4) -> torch.Tensor:
    """Per-image random horizontal flip and random ``pad``-reflected crop
    of ``images`` (``[B, H, W, C]``): :func:`draw_flip_crop` from ``gen``
    (a CPU generator), then :func:`flip_crop`."""
    return flip_crop(images, *draw_flip_crop(gen, images.shape[0], pad), pad)


def flip_crop_transform(pad: int = 4):
    """A ``Trainer(device_transform=...)``: ``fn(gen, x, y) -> (x, y)``
    applying :func:`random_flip_crop` to the features and passing the
    labels through. Its halves, ``fn.draw(gen, x_shape)`` and
    ``fn.apply(draws, x, y)``, are the same work split at the draws, so a
    captured multi-round program stages the draws with its block
    (``workers.staged_draws``)."""

    def transform(gen, x, y):
        return random_flip_crop(gen, x, pad=pad), y

    transform.draw = lambda gen, shape: draw_flip_crop(gen, shape[0], pad)
    transform.apply = lambda draws, x, y: (flip_crop(x, *draws, pad), y)
    return transform
