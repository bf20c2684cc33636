"""Dataset loaders of the port (copied from ``distkeras_tpu/datasets.py``;
numpy only): MNIST, CIFAR-10 and IMDB.

A loader returns a :class:`~distkeras_tpu_torch.data.dataframe.DataFrame`
with ``features``/``label`` columns, from a local file the user already has
(``data_dir``) or else a structured synthetic stand-in with the real
dataset's shapes, dtypes and cardinalities; ``df.synthetic`` says which.
Nothing is downloaded.
"""

from __future__ import annotations

import gzip
import os
import struct

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


def _load_idx_images(path):
    """An IDX file (optionally gzipped): images as float32 in [0, 1]
    ``[n, rows, cols]``, or labels as int32 ``[n]``."""
    with gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic == 2051:  # images
            rows, cols = struct.unpack(">II", f.read(8))
            data = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
            return data.astype(np.float32) / 255.0
        if magic == 2049:  # labels
            return np.frombuffer(f.read(), np.uint8).astype(np.int32)
        raise ValueError(f"unknown IDX magic {magic} in {path}")


def _mark(df: DataFrame, synthetic: bool) -> DataFrame:
    df.synthetic = synthetic
    return df


def mnist(n: int = 60000, data_dir: str | None = None, flat: bool = False,
          seed: int = 0) -> DataFrame:
    """MNIST digits: ``features`` [n, 28, 28, 1] in [0,1] (or [n, 784] if
    ``flat``), ``label`` int32 in [0, 10). ``data_dir`` holding the IDX
    files (``train-images-idx3-ubyte.gz``, ``train-labels-idx1-ubyte.gz``)
    reads the real digits; otherwise a synthetic stand-in, the same frame
    as the JAX package's ``mnist`` for the same ``n``, ``seed`` and
    ``flat``."""
    if data_dir:
        xi = os.path.join(data_dir, "train-images-idx3-ubyte.gz")
        yi = os.path.join(data_dir, "train-labels-idx1-ubyte.gz")
        if os.path.exists(xi) and os.path.exists(yi):
            x = _load_idx_images(xi)[:n, :, :, None]
            y = _load_idx_images(yi)[:n]
            if flat:
                x = x.reshape(len(x), -1)
            return _mark(DataFrame({"features": x, "label": y}), False)
    x, y = _synthetic_images(n, (28, 28, 1), 10, seed)
    if flat:
        x = x.reshape(len(x), -1)
    return _mark(DataFrame({"features": x, "label": y}), True)


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


def synthetic_lm(n: int = 4096, vocab_size: int = 1024, seq_len: int = 128,
                 seed: int = 0) -> DataFrame:
    """Next-token-predictable synthetic corpus for transformer benchmarks: a
    noisy order-1 Markov chain with Dirichlet(0.05) transition rows (so an
    LM can beat uniform loss); bit-equal to the JAX package's for the same
    arguments. ``features`` are tokens ``[:, :-1]``, ``label`` ``[:, 1:]``."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.full(vocab_size, 0.05), size=vocab_size)
    x = np.zeros((n, seq_len), np.int32)
    x[:, 0] = rng.integers(0, vocab_size, size=n)
    u = rng.random(size=(n, seq_len))
    cum = trans.cumsum(axis=1)
    for t in range(1, seq_len):
        x[:, t] = (cum[x[:, t - 1]] < u[:, t : t + 1]).sum(axis=1)
    df = DataFrame({"features": x[:, :-1], "label": x[:, 1:]})
    return _mark(df, True)
