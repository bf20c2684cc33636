"""The rank grid and the collectives of the port (``runtime/mesh.py``,
``ops/collectives.py``): ``data_mesh``, ``hybrid_mesh`` and
``device_count`` held to the JAX package's mesh on the conftest's 8
virtual devices (``tests/test_runtime.py``'s cases, by shape and by
error) over 8 ranks; then a real 2-rank gloo group (spawned, one thread a
rank) for ``distributed_initialize``, its second call, and every
collective."""

import numpy as np
import pytest
import torch

import distkeras_tpu as dk
import distkeras_tpu_torch as dt
from distkeras_tpu_torch.ops import collectives as C
from distkeras_tpu_torch.runtime import mesh

import torch_rank_workers as RW

EIGHT = list(range(8))


def test_axis_names_are_the_reference_s():
    for name in ("DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "PIPE_AXIS",
                 "EXPERT_AXIS"):
        assert getattr(dt, name) == getattr(dk, name)
        assert name in dt.__all__
    for name in ("data_mesh", "hybrid_mesh", "device_count"):
        assert name in dt.__all__


@pytest.mark.parametrize("num_workers", [None, 1, 4, 8])
def test_data_mesh_shape_is_the_reference_s(num_workers):
    ref = dk.data_mesh(num_workers=num_workers)
    got = dt.data_mesh(num_workers=num_workers, devices=EIGHT)
    assert got.shape == dict(ref.shape)
    assert got.devices.shape == ref.devices.shape
    assert list(got.ranks) == EIGHT[:got.size]


def test_data_mesh_too_many_workers_raises_as_the_reference():
    with pytest.raises(ValueError) as ref:
        dk.data_mesh(num_workers=99)
    with pytest.raises(ValueError) as got:
        dt.data_mesh(num_workers=99, devices=EIGHT)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("sizes", [
    {"data": -1, "model": 2}, {"data": 2, "model": -1}, {"data": 8},
    {"data": 2, "model": 2, "seq": 2}, {"data": 4}])
def test_hybrid_mesh_inference_is_the_reference_s(sizes):
    ref = dk.hybrid_mesh(dict(sizes))
    got = dt.hybrid_mesh(dict(sizes), devices=EIGHT)
    assert got.shape == dict(ref.shape)
    assert got.axis_names == tuple(ref.axis_names)


@pytest.mark.parametrize("sizes", [
    {"data": -1, "model": -1}, {"data": -1, "model": 3},
    {"data": 4, "model": 4}])
def test_hybrid_mesh_errors_are_the_reference_s(sizes):
    with pytest.raises(ValueError) as ref:
        dk.hybrid_mesh(dict(sizes))
    with pytest.raises(ValueError) as got:
        dt.hybrid_mesh(dict(sizes), devices=EIGHT)
    assert str(got.value) == str(ref.value)


def test_without_a_group_the_world_is_one_rank():
    assert not mesh.group_active()
    assert mesh.world_size() == 1 and mesh.rank() == 0
    assert dt.device_count() == (torch.cuda.device_count()
                                 if torch.cuda.is_available() else 1)
    assert dt.data_mesh().shape == {"data": 1}
    assert mesh.workers_per_rank(3) == 3
    assert mesh.local_worker_ids(3) == [0, 1, 2]
    tree = {"a": torch.ones(2)}
    assert C.all_reduce(tree) is tree
    assert C.all_gather(torch.ones(2)).shape == (1, 2)
    assert C.all_gather_object(5) == [5] and C.broadcast_object(5) == 5
    assert C.axis_size() == 1
    C.barrier()
    with pytest.raises(ValueError, match="op must be"):
        C.all_reduce(tree, "max")


def test_put_global_moves_every_leaf_to_the_device():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = mesh.put_global({"x": x, "n": 3, "l": [x, torch.ones(1)]}, "cpu")
    assert isinstance(out["x"], torch.Tensor) and out["n"] == 3
    np.testing.assert_array_equal(out["l"][0].numpy(), x)


def test_initialize_refuses_a_missing_rendezvous(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        dt.distributed_initialize(device="cpu")
    with pytest.raises(ValueError, match="outside a world"):
        dt.distributed_initialize(device="cpu", master_addr="127.0.0.1",
                                  master_port=1, world_size=2, rank=2)
    assert not mesh.group_active()


@pytest.fixture(scope="module")
def probe():
    return RW.spawn("collectives_probe", 2)


def test_two_ranks_form_a_group_and_a_second_call_is_a_no_op(probe):
    for r, got in enumerate(probe):
        assert got["axis_size"] == 2 and got["device_count"] == 2
        assert got["again"] == "cpu"  # the device bound by the first call
        assert got["mesh"] == {"data": 2}
        assert got["hybrid"] == {"data": 2, "model": 1}
        assert got["local_workers"] == [2 * r, 2 * r + 1]


def test_all_reduce_sums_and_means_the_ranks_trees(probe):
    for got in probe:
        np.testing.assert_array_equal(got["sum"]["a"], np.full(3, 3.0))
        np.testing.assert_array_equal(got["sum"]["b"], [1.0, 2.0])
        assert got["sum"]["b"].dtype == np.float64
        np.testing.assert_array_equal(got["sum"]["c"],
                                      np.arange(4, dtype=np.float32) * 3)
        np.testing.assert_array_equal(got["mean"]["a"], np.full(3, 1.5))
        np.testing.assert_array_equal(got["mean"]["b"], [0.5, 1.0])
    # the input is left as it was
    np.testing.assert_array_equal(probe[1]["input_kept"]["a"],
                                  np.full(3, 2.0))


def test_gathers_and_broadcast_are_in_rank_order(probe):
    for got in probe:
        np.testing.assert_array_equal(got["gather"], [[0, 0], [1, 10]])
        assert got["objects"] == [{"rank": 0}, {"rank": 1}]
        assert got["bcast"] == "from0"
