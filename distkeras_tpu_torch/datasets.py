"""Dataset loaders of the port (copied from ``distkeras_tpu/datasets.py``;
numpy only): IMDB and CIFAR-10; MNIST comes with the CNN slice.

A loader returns a :class:`~distkeras_tpu_torch.data.dataframe.DataFrame`
with ``features``/``label`` columns, from a local file the user already has
(``data_dir``) or else a structured synthetic stand-in with the real
dataset's shapes, dtypes and cardinalities; ``df.synthetic`` says which.
Nothing is downloaded.
"""

from __future__ import annotations

import os

import numpy as np

from distkeras_tpu_torch.data.dataframe import DataFrame


def _synthetic_images(n, shape, num_classes, seed):
    """Class-conditional image blobs: each class lights up a distinct region."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = rng.uniform(0.0, 0.35, size=(n,) + shape).astype(np.float32)
    flat = x.reshape(n, -1)
    d = flat.shape[1]
    block = max(d // num_classes, 1)
    for c in range(num_classes):
        rows = y == c
        flat[rows, c * block : (c + 1) * block] += 0.6
    return flat.reshape((n,) + shape).clip(0.0, 1.0), y


def _mark(df: DataFrame, synthetic: bool) -> DataFrame:
    df.synthetic = synthetic
    return df


def cifar10(n: int = 50000, data_dir: str | None = None,
            seed: int = 0) -> DataFrame:
    """CIFAR-10: ``features`` [n, 32, 32, 3] in [0,1], ``label`` int32 in
    [0, 10). ``data_dir`` holding the Python-pickle batches
    (``data_batch_1`` .. ``data_batch_5``) reads the real images; otherwise
    a synthetic stand-in, the same frame as the JAX package's ``cifar10``
    for the same seed."""
    if data_dir:
        import pickle

        batches = [os.path.join(data_dir, f"data_batch_{i}")
                   for i in range(1, 6)]
        if all(os.path.exists(b) for b in batches):
            xs, ys = [], []
            for b in batches:
                with open(b, "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                xs.append(d[b"data"])
                ys.extend(d[b"labels"])
            x = (np.concatenate(xs).reshape(-1, 3, 32, 32)
                 .transpose(0, 2, 3, 1).astype(np.float32) / 255.0)[:n]
            y = np.asarray(ys, np.int32)[:n]
            return _mark(DataFrame({"features": x, "label": y}), False)
    x, y = _synthetic_images(n, (32, 32, 3), 10, seed)
    return _mark(DataFrame({"features": x, "label": y}), True)


def imdb(n: int = 25000, vocab_size: int = 20000, seq_len: int = 80,
         data_dir: str | None = None, seed: int = 0) -> DataFrame:
    """IMDB sentiment: ``features`` int32 token ids [n, seq_len], ``label`` {0,1}.

    ``data_dir`` holding ``imdb.npz`` (``x_train``/``y_train``, Keras's
    layout) reads the real reviews, truncated to ``seq_len`` and to ids
    below ``vocab_size``. Otherwise a synthetic stand-in: positive reviews
    oversample one token range, negative another, with a Zipf-ish id
    distribution — enough signal for an LSTM to learn. The same seed gives
    the same frame as the JAX package's ``imdb``.
    """
    if data_dir:
        npz = os.path.join(data_dir, "imdb.npz")
        if os.path.exists(npz):
            d = np.load(npz, allow_pickle=True)
            xs, ys = d["x_train"][:n], d["y_train"][:n].astype(np.int32)
            x = np.zeros((len(xs), seq_len), np.int32)
            for i, row in enumerate(xs):
                row = [t for t in row if t < vocab_size][:seq_len]
                x[i, : len(row)] = row
            return _mark(DataFrame({"features": x, "label": ys}), False)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n).astype(np.int32)
    base = rng.zipf(1.4, size=(n, seq_len)).clip(1, vocab_size - 1)
    sentiment_tok = np.where(
        (y[:, None] == 1), rng.integers(10, 60, size=(n, seq_len)),
        rng.integers(60, 110, size=(n, seq_len)),
    )
    use_sent = rng.random(size=(n, seq_len)) < 0.3
    x = np.where(use_sent, sentiment_tok, base).astype(np.int32)
    return _mark(DataFrame({"features": x, "label": y}), True)
