"""The port's data plane (``distkeras_tpu_torch/data/``, ``datasets.py``,
``runtime/config.py``) against the JAX package's copies: ``make_batches``
array-equal with shuffle on and off and with a row transform, the same
synthetic IMDB frame, the RoundFeeder's ordering and failure paths, and
``RunConfig``."""

import threading

import numpy as np
import pytest
import torch

from distkeras_tpu.data.batching import make_batches as jax_make_batches
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu.datasets import imdb as jax_imdb
from distkeras_tpu_torch.data import DataFrame, make_batches
from distkeras_tpu_torch.data.prefetch import RoundFeeder
from distkeras_tpu_torch.datasets import imdb
from distkeras_tpu_torch.resilience.errors import FeederStalledError
from distkeras_tpu_torch.runtime.config import RunConfig


def _frames(n=70):
    rng = np.random.default_rng(0)
    cols = {"features": rng.integers(0, 50, (n, 6)).astype(np.int32),
            "label": rng.integers(0, 2, n).astype(np.int32)}
    return DataFrame(cols), JaxDataFrame(cols)


def _flip(x, y, rng):
    return np.where(rng.random(x.shape) < 0.5, x, 49 - x), y


@pytest.mark.parametrize("shuffle,transform", [(False, None), (True, None),
                                               (True, _flip)])
def test_make_batches_matches_jax(shuffle, transform):
    ours, theirs = _frames()
    kw = dict(batch_size=4, num_workers=3, window=2, num_epoch=2,
              shuffle=shuffle, seed=5, transform=transform)
    a = make_batches(ours, "features", "label", **kw)
    b = jax_make_batches(theirs, "features", "label", **kw)
    np.testing.assert_array_equal(a.index, b.index)
    assert (a.num_rounds, a.samples_per_round) == (b.num_rounds,
                                                   b.samples_per_round)
    for r in range(a.num_rounds):
        for x, y in zip(a.round(r), b.round(r)):
            np.testing.assert_array_equal(x, y)


def test_make_batches_refuses_too_little_data():
    ours, _ = _frames(10)
    with pytest.raises(ValueError, match="one fold round"):
        make_batches(ours, "features", "label", 4, num_workers=3, window=2)


def test_imdb_matches_jax():
    a = imdb(n=64, vocab_size=200, seq_len=12, seed=3)
    b = jax_imdb(n=64, vocab_size=200, seq_len=12, seed=3)
    assert a.synthetic and b.synthetic
    for col in ("features", "label"):
        np.testing.assert_array_equal(a[col], b[col])
        assert a[col].dtype == b[col].dtype


def test_imdb_reads_a_local_npz(tmp_path):
    x = np.array([[1, 5, 999, 7], [2, 3]], dtype=object)
    np.savez(tmp_path / "imdb.npz", x_train=x, y_train=np.array([1, 0]))
    df = imdb(n=2, vocab_size=100, seq_len=3, data_dir=str(tmp_path))
    assert not df.synthetic
    np.testing.assert_array_equal(df["features"], [[1, 5, 7], [2, 3, 0]])


def test_round_feeder_yields_in_order_and_propagates_errors():
    seen = [r for r, _ in RoundFeeder(5, lambda r: r * 10, start_round=1)]
    assert seen == [1, 2, 3, 4]

    def bad(r):
        if r == 2:
            raise KeyError("gather failed")
        return r

    got = []
    with pytest.raises(KeyError, match="gather failed"):
        for r, _ in RoundFeeder(4, bad):
            got.append(r)
    assert got == [0, 1]


def test_round_feeder_declares_a_dead_pipeline():
    gate = threading.Event()
    feeder = RoundFeeder(2, lambda r: gate.wait(0.8), stall_timeout=0.3,
                         stall_warn=0.1)
    with pytest.warns(UserWarning, match="stalled"):
        with pytest.raises(FeederStalledError):
            for _ in feeder:
                pass
    gate.set()


def test_run_config_maps_dtypes_to_torch():
    assert RunConfig().dtype is None
    assert RunConfig(compute_dtype="bfloat16").dtype is torch.bfloat16
    assert RunConfig(compute_dtype="float32").replace(
        batch_size=7).batch_size == 7
