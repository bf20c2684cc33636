"""The sharded predictor across ranks (``predictors.py
_shard_assignment``, ``_predict_sharded_multiprocess``) and the forward
split over several devices (``ModelPredictor(devices=)``).

Two gloo ranks (spawned, one thread each) predict a 4-shard store of the
small MLP's inputs into a new column: with disjoint residency (each rank's
disk holds two shards), with overlapping residency, and with full
residency (one shared directory). Every shard's predictions must equal the
single-process sharded predict's and the JAX package's predictor's in one
process (within 1e-5: XLA's and oneDNN's dense layers round apart), and
every rank must publish the same manifest. ``devices=[cpu, cpu]`` must
give the rows of one device, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import distkeras_tpu as dk
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.mlp import MLP as JaxMLP
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.data import DataFrame
from distkeras_tpu_torch.data.shards import ShardedDataFrame, write_shards
from distkeras_tpu_torch.predictors import ClassPredictor, ModelPredictor

import torch_rank_workers as RW

ROWS, PER_SHARD = 40, 10


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jm = JaxModel.build(JaxMLP(**RW.MLP_CFG),
                        jnp.zeros((1, 784), jnp.float32), seed=1)
    module = RW.build_model("mlp").module
    weights = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), module).items()}
    cols = RW.columns("mlp", ROWS, seed=7)
    tmp = tmp_path_factory.mktemp("predict")
    jax_out = np.asarray(dk.ModelPredictor(jm, output_col="pred").predict(
        JaxDataFrame(cols))["pred"])
    single_root = str(tmp / "single")
    write_shards(single_root, cols, PER_SHARD)
    model = RW.build_model("mlp", weights)
    out = ModelPredictor(model, output_col="pred", chunk_size=16).predict(
        ShardedDataFrame(single_root))
    single = np.concatenate([c["pred"] for c in
                             out.iter_column_chunks("pred")])
    return dict(weights=weights, cols=cols, tmp=tmp, jax=jax_out,
                single=single)


def _ranked(setup, name, holds):
    root = str(setup["tmp"] / name)
    write_shards(root, setup["cols"], PER_SHARD)
    case = dict(kind="mlp", weights=setup["weights"], root=root, col="pred",
                chunk=16, holds=holds, private=root + "-priv")
    return RW.spawn("predict_case", 2, (case,))


@pytest.mark.parametrize("name,holds", [
    ("disjoint", [[0, 1], [2, 3]]),
    ("overlap", [[0, 1, 2], [1, 2, 3]]),
    ("full", None),
])
def test_two_ranks_predict_as_one_process_and_as_jax(setup, name, holds):
    got = _ranked(setup, name, holds)
    if holds is None:  # one shared directory: both ranks read every file
        assert sorted(got[0]["shards"]) == sorted(got[1]["shards"])
        shards = got[0]["shards"]
    else:  # each rank's disk holds only what it predicted
        shards = {}
        for r in got:
            for s, arr in r["shards"].items():
                assert s not in shards  # every shard predicted once
                shards[s] = arr
    assert sorted(shards) == [0, 1, 2, 3]
    column = np.concatenate([shards[s] for s in range(4)])
    np.testing.assert_allclose(column, setup["single"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(column, setup["jax"], rtol=1e-5, atol=1e-5)
    m0, m1 = (r["manifest"] for r in got)
    assert m0 == m1 and "pred" in m0["columns"]
    if holds is not None:
        for r, held in zip(got, holds):
            assert set(r["shards"]) <= set(held)


def test_devices_split_a_chunk_and_keep_the_rows_in_order(setup):
    model = RW.build_model("mlp", setup["weights"])
    df = DataFrame(setup["cols"])
    # one forward of 8 rows a device either way: the same arithmetic
    one = ModelPredictor(model, output_col="p", chunk_size=8).predict(df)
    two = ModelPredictor(model, output_col="p", chunk_size=17,
                         devices=["cpu", "cpu"]).predict(df)
    assert two.count() == one.count() == ROWS
    np.testing.assert_array_equal(np.asarray(two["p"]), np.asarray(one["p"]))
    cls = ClassPredictor(model, output_col="c", num_workers=1).predict(df)
    np.testing.assert_array_equal(np.asarray(cls["c"]),
                                  np.asarray(one["p"]).argmax(-1))


def test_devices_and_num_workers_follow_the_reference_rules(setup):
    model = RW.build_model("mlp", setup["weights"])
    p = ModelPredictor(model, chunk_size=15, devices=["cpu", "cpu"])
    assert p.chunk_size == 14 and len(p.devices) == 2
    with pytest.raises(ValueError, match="exceeds available devices"):
        ModelPredictor(model, num_workers=2)
    with pytest.raises(ValueError, match="exceeds available devices"):
        ModelPredictor(model, num_workers=3, devices=["cpu", "cpu"])
    assert ModelPredictor(model).devices == [model.device]


def test_a_shard_no_rank_holds_is_a_contract_error(setup):
    with pytest.raises(RuntimeError, match="present on NO process"):
        _ranked(setup, "orphan", [[0, 1], [1, 2]])

