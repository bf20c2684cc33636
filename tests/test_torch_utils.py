"""The port's ``utils.py`` and ``models/base.py uniform_weights`` held to
the JAX package's (``distkeras_tpu/utils.py``).

Every utility gives what the reference gives on the same input: the Keras
home it points at, the serialized bytes of the same weights (and their
round trip), the same row permutation for a seed, the same rows and
one-hot vectors. ``uniform_weights`` cannot draw ``jax.random``'s values
(its draws come from a ``torch.Generator`` on the model's device), so it is
held to its contract: every floating parameter inside ``[lo, hi)``, one
seed one draw, another seed another, non-floating parameters and the
buffers (mutable state) untouched, the input model unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import utils as jutils
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu_torch import utils
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.data import DataFrame
from distkeras_tpu_torch.models.base import uniform_weights


def _mlp_pair():
    from distkeras_tpu.models import Model as JaxModel
    from distkeras_tpu.models.mlp import MLP as JaxMLP
    from distkeras_tpu_torch.models import MLP, Model

    jm = JaxModel.build(JaxMLP(hidden=(8,), num_outputs=3),
                        jnp.zeros((1, 4), jnp.float32), seed=0)
    pm = Model.build(MLP(hidden=(8,), num_outputs=3, in_features=4),
                     np.zeros((1, 4), np.float32), device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return jm, pm


def _cols(n=10):
    rng = np.random.default_rng(0)
    return {"features": rng.normal(size=(n, 3)).astype(np.float32),
            "label": np.arange(n, dtype=np.int32)}


def test_set_keras_base_directory_points_keras_home(monkeypatch, tmp_path):
    got = {}
    for name, mod in (("jax", jutils), ("port", utils)):
        monkeypatch.delenv("KERAS_HOME", raising=False)
        mod.set_keras_base_directory(str(tmp_path))
        import os

        got[name] = os.environ["KERAS_HOME"]
    assert got["port"] == got["jax"] == str(tmp_path / ".keras")


def test_serialize_keras_model_is_the_jax_blob_and_round_trips():
    jm, pm = _mlp_pair()
    blob = utils.serialize_keras_model(pm)
    assert blob == jutils.serialize_keras_model(jm)
    back = utils.deserialize_keras_model(blob, device="cpu")
    for k, v in pm.params.items():
        assert torch.equal(back.params[k], v), k
    jback = jutils.deserialize_keras_model(blob)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jback.params),
                          pm.module)
    for k, v in ref.items():
        assert torch.equal(back.params[k], v), k


@pytest.mark.parametrize("seed", [0, 5])
def test_shuffle_is_the_reference_permutation(seed):
    cols = _cols()
    a = utils.shuffle(DataFrame(cols), seed=seed)
    b = jutils.shuffle(JaxDataFrame(cols), seed=seed)
    for c in cols:
        np.testing.assert_array_equal(a[c], b[c])
    assert not np.array_equal(a["label"], cols["label"])


def test_precache_keeps_every_row():
    cols = _cols()
    a = utils.precache(DataFrame(cols))
    b = jutils.precache(JaxDataFrame(cols))
    for c in cols:
        np.testing.assert_array_equal(a[c], b[c])
        np.testing.assert_array_equal(a[c], cols[c])


def test_new_dataframe_row_and_to_dense_vector():
    row = {"a": 1, "b": [2, 3]}
    out = utils.new_dataframe_row(row, "c", 4.5)
    assert out == jutils.new_dataframe_row(row, "c", 4.5)
    assert out == {"a": 1, "b": [2, 3], "c": 4.5} and "c" not in row
    for value, length in ((0, 3), (4, 5), (2.0, 7)):
        got = utils.to_dense_vector(value, length)
        want = jutils.to_dense_vector(value, length)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.float32


@pytest.mark.parametrize("bounds", [(-0.5, 0.5), (0.25, 0.75)])
def test_uniform_weights_bounds_and_determinism(bounds):
    lo, hi = bounds
    _jm, pm = _mlp_pair()
    before = {k: v.clone() for k, v in pm.params.items()}
    a = uniform_weights(pm, bounds, seed=3)
    b = uniform_weights(pm, bounds, seed=3)
    c = uniform_weights(pm, bounds, seed=4)
    for k, v in a.params.items():
        assert v.dtype == torch.float32 and v.shape == before[k].shape
        assert float(v.min()) >= lo and float(v.max()) < hi, k
        assert torch.equal(v, b.params[k]), "one seed, one draw"
        assert not torch.equal(v, c.params[k]), "another seed, another"
        assert torch.equal(pm.params[k], before[k]), "input unchanged"
    flat = torch.cat([v.ravel() for v in a.params.values()])
    # a uniform draw fills the interval (not a constant or a narrow band)
    assert float(flat.std()) > 0.2 * (hi - lo)
    assert utils.uniform_weights is uniform_weights


def test_uniform_weights_leaves_buffers_and_integer_params_alone():
    from distkeras_tpu_torch.models import Model
    from distkeras_tpu_torch.models.base import BatchNorm

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dense = torch.nn.Linear(3, 4)
            self.norm = BatchNorm(4)
            self.table = torch.nn.Parameter(
                torch.arange(6, dtype=torch.int64), requires_grad=False)

        def forward(self, x):
            return self.norm(self.dense(x))

    m = Model.build(Net(), np.zeros((1, 3), np.float32), device="cpu")
    with torch.no_grad():
        m.module.norm.mean.fill_(0.5)
    bufs = {k: v.clone() for k, v in m.module.named_buffers()}
    out = uniform_weights(m, (-0.1, 0.1), seed=1)
    assert torch.equal(out.params["table"], torch.arange(6))
    for k, v in out.module.named_buffers():
        assert torch.equal(v, bufs[k]), k
    assert float(out.params["dense.weight"].abs().max()) < 0.1
    assert float(out.params["norm.scale"].abs().max()) < 0.1
