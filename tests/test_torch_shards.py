"""The port's out-of-core data plane (``distkeras_tpu_torch/data/shards.py``,
the sharded predictor and evaluators) against the JAX package's.

* The on-disk layout is the interchange format: a store either package
  writes, the other reads; the manifests equal and the ``.npy`` bytes
  identical; ``merge_manifests`` resumed after a crash leaves the same files
  as the JAX package's merge.
* Planning: ``worker_major_index`` array-equal with the same warning text;
  ``ShardedBatchPlan.round``/``round_local`` bit-equal to the JAX plan's, a
  host ``transform=`` included.
* Training from the same uint8 store from the same weights: every trainer
  the port has, plain, with a host ``transform`` and with a deterministic
  ``device_transform`` (a fixed flip that ignores its generator, written
  once per package), held to the JAX trainer within rtol = atol = 1e-5 in
  the history and the center (the in-RAM parity tests' f32 tolerance);
  ``SynchronousDistributedTrainer(tiny_resnet)`` and ``ADAG`` on an MLP of
  ``mnist_mlp``'s widths the same way.
* The sharded predict column within 1e-5 of the JAX package's (the in-RAM
  predictors' tolerance), the evaluators equal (``LossEvaluator`` within
  1e-6), and ``vacuum`` removing the same files.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu import evaluators as JE
from distkeras_tpu import predictors as JP
from distkeras_tpu.data import shards as JS
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.mlp import MLP as JaxMLP
from distkeras_tpu.models.resnet import ResNet as JaxResNet
import distkeras_tpu_torch as dt
from distkeras_tpu_torch import evaluators as E
from distkeras_tpu_torch import predictors as P
from distkeras_tpu_torch import resilience, telemetry
from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.data import DataFrame, make_batches
from distkeras_tpu_torch.data import shards as S
from distkeras_tpu_torch.models import MLP, Model, resnet

LOSS = "sparse_categorical_crossentropy"
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    for var in ("DKTPU_FAULTS", "DKTPU_NO_NATIVE", "DKTPU_PS_ENDPOINT"):
        monkeypatch.delenv(var, raising=False)
    resilience.reset()
    dk.resilience.reset()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "uint8 features")
        warnings.filterwarnings("ignore", ".*num_workers > 1.*")
        yield
    resilience.reset()
    dk.resilience.reset()


def _cols(n=37, seed=0, shape=(6, 5, 3)):
    rng = np.random.default_rng(seed)
    return {"features": rng.integers(0, 256, (n,) + shape, dtype=np.uint8),
            "label": rng.integers(0, 10, n).astype(np.int32),
            "weight": rng.normal(size=(n, 2)).astype(np.float32)}


def _write(mod, root, cols, rows_per_shard=8, step=5):
    """Write ``cols`` through ``mod.ShardWriter`` in appends of ``step``
    rows (so shards cut across appends)."""
    n = len(next(iter(cols.values())))
    with mod.ShardWriter(str(root), rows_per_shard=rows_per_shard) as w:
        for lo in range(0, n, step):
            w.append(**{k: v[lo:lo + step] for k, v in cols.items()})


def _files(root) -> dict:
    return {f: open(os.path.join(root, f), "rb").read()
            for f in sorted(os.listdir(root))
            if not os.path.isdir(os.path.join(root, f))}


# ---------------------------------------------------------------------------
# The layout: write, read, merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_store_either_package_writes_the_other_reads(tmp_path, writer):
    cols = _cols()
    _write(S, tmp_path / "port", cols)
    _write(JS, tmp_path / "jax", cols)
    port, jax_ = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert port == jax_ and len(port) == 1 + 3 * 5  # manifest + 5 shards
    m = json.loads(port["manifest.json"])
    assert m["shard_rows"] == [8, 8, 8, 8, 5] and m["num_rows"] == 37
    root = str(tmp_path / writer)
    reader = (JS if writer == "port" else S).ShardedDataFrame(root)
    assert reader.count() == 37 and sorted(reader.columns) == sorted(cols)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 37, size=(3, 4))
    for k, v in cols.items():
        assert reader.store.gather(k, idx).tobytes() == v[idx].tobytes()
        got = np.concatenate([c[k] for c in reader.iter_column_chunks(k)])
        assert got.tobytes() == v.tobytes()
        assert reader.store.column_spec(k) == (v.shape[1:], v.dtype)


def test_write_shards_is_one_writer(tmp_path):
    cols = _cols(20)
    assert S.write_shards(str(tmp_path / "a"), cols, 6) == \
        JS.write_shards(str(tmp_path / "b"), cols, 6)
    assert _files(tmp_path / "a") == _files(tmp_path / "b")


def _write_parts(mod, root, cols, cuts):
    """One ``ShardWriter(part=k)`` a cut, in part order; an empty cut is a
    writer that saw no rows."""
    for k, (lo, hi) in enumerate(cuts):
        w = mod.ShardWriter(str(root), rows_per_shard=4, part=k)
        if hi > lo:
            w.append(**{c: v[lo:hi] for c, v in cols.items()})
        w.close()


def test_merge_manifests_resumes_after_a_crash_as_jax(tmp_path, monkeypatch):
    """A merge that dies after its journal and two renames resumes from the
    journal to the same store, file for file, as the JAX package's merge of
    the same parts."""
    cols = _cols(30)
    cuts = [(0, 11), (11, 11), (11, 30)]
    _write_parts(JS, tmp_path / "jax", cols, cuts)
    want = JS.merge_manifests(str(tmp_path / "jax"))
    root = tmp_path / "port"
    _write_parts(S, root, cols, cuts)
    real, calls = os.replace, [0]

    def crashing(src, dst):
        calls[0] += 1
        if calls[0] == 4:  # the journal, two shard files, then the crash
            raise OSError("crash")
        real(src, dst)

    monkeypatch.setattr(os, "replace", crashing)
    with pytest.raises(OSError, match="crash"):
        S.merge_manifests(str(root))
    monkeypatch.undo()
    assert os.path.exists(root / ".merge.journal.json")
    assert not os.path.exists(root / "manifest.json")
    assert S.merge_manifests(str(root)) == want
    assert _files(root) == _files(tmp_path / "jax")
    assert not any(d.startswith("part-") for d in os.listdir(root))
    sdf = S.ShardedDataFrame(str(root))
    for k, v in cols.items():
        got = sdf.store.gather(k, np.arange(30))
        assert got.tobytes() == v.tobytes()


@pytest.mark.parametrize("case", ["published", "schema", "no_parts",
                                  "all_empty"])
def test_merge_refusals_are_the_jax_packages(tmp_path, case):
    def setup(mod, root):
        os.makedirs(root)
        cols = _cols(9)
        if case == "published":
            _write(mod, root, cols)
            _write_parts(mod, root, cols, [(0, 9)])
        elif case == "schema":
            _write_parts(mod, root, cols, [(0, 4)])
            w = mod.ShardWriter(str(root), rows_per_shard=4, part=1)
            w.append(features=cols["features"][4:], label=cols["label"][4:])
            w.close()
        elif case == "all_empty":
            _write_parts(mod, root, cols, [(0, 0), (3, 3)])

    errs = []
    for mod, name in ((S, "port"), (JS, "jax")):
        root = str(tmp_path / name)
        setup(mod, root)
        with pytest.raises(Exception) as e:
            mod.merge_manifests(root)
        errs.append((type(e.value), str(e.value).replace(root, "ROOT")))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("bad", ["columns", "dtype", "shape", "length"])
def test_writer_schema_drift_is_refused_as_jax(tmp_path, bad):
    cols = _cols(8)
    second = {"columns": {"features": cols["features"][4:]},
              "dtype": dict(cols, label=cols["label"].astype(np.int64)),
              "shape": dict(cols, weight=np.zeros((8, 3), np.float32)),
              "length": dict(cols, label=cols["label"][:3])}[bad]
    errs = []
    for mod, name in ((S, "port"), (JS, "jax")):
        w = mod.ShardWriter(str(tmp_path / name), rows_per_shard=4)
        w.append(**{k: v[:4] for k, v in cols.items()})
        with pytest.raises(ValueError) as e:
            w.append(**second)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_store_reads_lazily_and_refuses_what_it_lacks(tmp_path):
    """The memmap cache stays within ``max_open_maps``; a row out of range
    and a missing shard file fail as in the JAX package; the in-RAM frame
    operations are blocked with the JAX package's words."""
    cols = _cols(40)
    _write(S, tmp_path, cols, rows_per_shard=4)
    store = S.ShardStore(str(tmp_path), max_open_maps=3)
    jstore = JS.ShardStore(str(tmp_path), max_open_maps=3)
    idx = np.arange(40)[::-1]
    assert store.gather("features", idx).tobytes() == \
        cols["features"][idx].tobytes()
    assert len(store._maps) == 3
    for lo, hi in ((0, 4), (3, 9), (39, 40), (0, 40), (8, 8)):
        assert store.shards_for_rows(lo, hi) == jstore.shards_for_rows(lo, hi)
    for s in (store, jstore):
        with pytest.raises(IndexError, match=r"out of range \[0, 40\)"):
            s.gather("label", np.array([40]))
    np.testing.assert_array_equal(store.read_shard(2, "label"),
                                  cols["label"][8:12])
    os.remove(tmp_path / S._shard_file(5, "label"))
    store.close()
    with pytest.raises(FileNotFoundError):
        store.gather("label", np.array([21]))
    assert store.gather("label", np.array([3, 30])).tolist() == \
        cols["label"][[3, 30]].tolist()
    sdf, jsdf = S.ShardedDataFrame(store), JS.ShardedDataFrame(jstore)
    for op in ("with_column", "shuffle", "take_rows"):
        with pytest.raises(AttributeError) as pe:
            getattr(sdf, op)
        with pytest.raises(AttributeError) as je:
            getattr(jsdf, op)
        assert str(pe.value) == str(je.value)
    assert "label" in sdf and len(sdf) == 40
    assert sdf.repartition(4).num_partitions == 4


def test_the_shard_store_names_are_top_level_exports():
    names = {"ShardStore", "ShardWriter", "ShardedDataFrame",
             "merge_manifests", "write_shards"}
    assert names <= set(dk.__all__) and names <= set(dt.__all__)
    assert all(getattr(dt, n) is getattr(S, n) for n in names)


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,W,K,B,epochs,shuffle,seed", [
    (48, 2, 3, 4, 1, False, 0),   # exact fit: no warning
    (53, 3, 2, 4, 2, True, 5),    # a remainder and truncation: a warning
    (100, 4, 1, 7, 3, True, 9),
    (40, 1, 2, 8, 1, False, 0),
])
def test_worker_major_index_is_the_jax_packages(n, W, K, B, epochs, shuffle,
                                                seed):
    out = []
    for mod in (S, JS):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            idx = mod.worker_major_index(n, W, K, B, num_epoch=epochs,
                                         shuffle=shuffle, seed=seed)
        out.append((idx, [str(w.message) for w in got]))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    assert bool(out[0][1]) == (n % (W * K * B) != 0)
    assert S.worker_partition(n, W) == JS.worker_partition(n, W)


def test_a_partition_smaller_than_a_round_is_refused_as_jax():
    msgs = []
    for mod in (S, JS):
        with pytest.raises(ValueError) as e:
            mod.worker_major_index(20, 2, 2, 8)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _host_transform(x, y, rng):
    """A host ``transform=`` both packages run: noise on the pixels and a
    label shift, from the (seed, round, worker) generator."""
    noise = rng.integers(-3, 4, size=x.shape)
    x = np.clip(x.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    return x, (y + rng.integers(0, 2, size=y.shape)).astype(np.int32) % 10


@pytest.mark.parametrize("transform", [None, _host_transform])
def test_sharded_plan_rounds_are_the_jax_plans(tmp_path, transform):
    cols = _cols(61, shape=(4, 4, 3))
    _write(S, tmp_path, cols, rows_per_shard=7)
    kw = dict(batch_size=4, num_workers=3, window=2, num_epoch=2,
              shuffle=True, seed=5, transform=transform)
    plan = make_batches(S.ShardedDataFrame(str(tmp_path)), "features",
                        "label", **kw)
    jplan = dk.data.make_batches(JS.ShardedDataFrame(str(tmp_path)),
                                 "features", "label", **kw)
    assert type(plan).__name__ == type(jplan).__name__ == "ShardedBatchPlan"
    for attr in ("num_rounds", "rows_used", "steps_per_worker",
                 "samples_per_round", "rows_total", "is_local"):
        assert getattr(plan, attr) == getattr(jplan, attr)
    np.testing.assert_array_equal(plan.index, jplan.index)
    for r in range(plan.num_rounds):
        for got, want in zip(plan.round(r), jplan.round(r)):
            assert got.tobytes() == want.tobytes() and got.shape == want.shape
        for ws in ([2, 0], [1]):
            for got, want in zip(plan.round_local(r, ws),
                                 jplan.round_local(r, ws)):
                assert got.tobytes() == want.tobytes()
            local = plan.round_local(r, ws)[0]
            assert local.tobytes() == plan.round(r)[0][ws].tobytes()
            assert plan.local_shards(ws) == jplan.local_shards(ws)


# ---------------------------------------------------------------------------
# Training from the store
# ---------------------------------------------------------------------------

DIM = 12
SMALL = dict(loss=LOSS, batch_size=4, learning_rate=0.05)
TRAINERS = {
    "SingleTrainer": dict(steps_per_program=2),
    "SynchronousDistributedTrainer": dict(num_workers=2, steps_per_program=2),
    "ADAG": dict(num_workers=2, communication_window=2),
    "DOWNPOUR": dict(num_workers=2, communication_window=2),
    "DynSGD": dict(num_workers=2, communication_window=2),
    "AEASGD": dict(num_workers=2, communication_window=2, rho=3.0),
    "EAMSGD": dict(num_workers=2, communication_window=2, rho=3.0),
}


def _flip_port(gen, x, y):
    """A deterministic device transform: the rows reversed along their
    first feature axis, the generator ignored."""
    return torch.flip(x, dims=[1]), y


def _flip_jax(rng, x, y):
    return x[:, ::-1], y


def _mlp_pair(hidden=(16,), dim=DIM, outputs=10):
    jm = JaxModel.build(JaxMLP(hidden=hidden, num_outputs=outputs),
                        jnp.zeros((1, dim), jnp.float32), seed=2)
    pm = Model.build(MLP(hidden=hidden, num_outputs=outputs, in_features=dim),
                     np.zeros((1, dim), np.float32), device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return jm, pm


def _resnet_pair():
    tiny = dict(stage_sizes=(1, 1), base_features=8, num_outputs=10,
                stem_kernel=3, groups=4)
    jm = JaxModel.build(JaxResNet(**tiny, norm_impl="pallas"),
                        jnp.zeros((1, 32, 32, 3), jnp.float32), seed=1)
    pm = resnet.tiny_resnet(norm_impl="pallas", device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return jm, pm


def _train_both(tmp_path, name, kw, jm, pm, cols, mode):
    """``name`` of each package trained from the same uint8 store, from the
    same weights, with ``mode`` (None, "transform" or "device"); returns
    ``((port trainer, model), (jax trainer, model))``."""
    root = str(tmp_path / "store")
    S.write_shards(root, cols, 9)
    extra = {"transform": {"transform": _host_transform},
             "device": {}}.get(mode, {})
    out = []
    for pkg, model, sdf, flip in (
            (T, pm, S.ShardedDataFrame(root), _flip_port),
            (dk, jm, JS.ShardedDataFrame(root), _flip_jax)):
        if mode == "device":
            extra = {"device_transform": flip}
        t = getattr(pkg, name)(model, **SMALL, **kw, **extra)
        out.append((t, t.train(sdf, shuffle=True)))
    return out


def _assert_trained_alike(pair, pm):
    (pt, pout), (jt, jout) = pair
    ph, jh = pt.get_worker_histories(), jt.get_worker_histories()
    if ph is None:
        ph, jh = pt.get_history(), jt.get_history()
    assert np.isfinite(ph).all()
    np.testing.assert_allclose(ph, np.asarray(jh), rtol=ATOL, atol=ATOL)
    models = jout if isinstance(jout, list) else [jout]
    ports = pout if isinstance(pout, list) else [pout]
    for p, j in zip(ports, models):
        ref = params_from_jax(jax.tree_util.tree_map(np.asarray, j.params),
                              pm.module)
        got = p.module.state_dict()
        for k, v in ref.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=ATOL,
                                       atol=ATOL, err_msg=k)
    assert any(not torch.equal(pout.params[k], v)
               for k, v in pm.params.items())


@pytest.mark.parametrize("mode", [None, "transform", "device"])
@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_every_trainer_trains_from_the_store_as_jax(tmp_path, name, mode):
    """Rows of 12 uint8 features, shards of 9 rows (rounds cut across
    shards), 2 rounds a worker; shuffled within the workers' partitions."""
    jm, pm = _mlp_pair()
    kw = TRAINERS[name]
    W = kw.get("num_workers", 1)
    K = kw.get("communication_window", kw.get("steps_per_program"))
    n = W * K * 4 * 2 + 3  # 3 rows over: the worker remainder, dropped
    rng = np.random.default_rng(4)
    cols = {"features": rng.integers(0, 256, (n, DIM), dtype=np.uint8),
            "label": rng.integers(0, 10, n).astype(np.int32)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pair = _train_both(tmp_path, name, kw, jm, pm, cols, mode)
    _assert_trained_alike(pair, pm)


@pytest.mark.parametrize("mode", [None, "device"])
@pytest.mark.parametrize("case", ["sync_tiny_resnet", "adag_mnist_mlp"])
def test_resnet_and_mnist_mlp_train_from_the_store_as_jax(tmp_path, case,
                                                          mode):
    """``SynchronousDistributedTrainer(tiny_resnet)`` (the JAX GroupNorm in
    Pallas interpret mode, 2 workers on 2 virtual devices) on 32x32x3
    uint8 images, and ``ADAG`` on an MLP of ``mnist_mlp``'s widths (784 ->
    500 -> 500 -> 10) on 784 uint8 pixels."""
    if case == "sync_tiny_resnet":
        jm, pm = _resnet_pair()
        name, kw, shape = ("SynchronousDistributedTrainer",
                           dict(num_workers=2, steps_per_program=2),
                           (32, 32, 3))
    else:
        jm, pm = _mlp_pair(hidden=(500, 500), dim=784)
        name, kw, shape = "ADAG", dict(num_workers=2,
                                       communication_window=2), (784,)
    n = 2 * 2 * 4 * 2
    rng = np.random.default_rng(8)
    cols = {"features": rng.integers(0, 256, (n,) + shape, dtype=np.uint8),
            "label": rng.integers(0, 10, n).astype(np.int32)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pair = _train_both(tmp_path, name, kw, jm, pm, cols, mode)
    _assert_trained_alike(pair, pm)


def test_a_poisoned_round_and_the_stall_counter_on_a_sharded_plan(
        tmp_path, monkeypatch):
    """``nan@1`` poisons round 1's staged batch from the store as from RAM:
    the round is skipped, the run matches the JAX package's under the same
    fault, and the feeder's ``input_stall_seconds`` is counted."""
    rng = np.random.default_rng(2)
    n = 2 * 2 * 4 * 3
    cols = {"features": rng.normal(size=(n, DIM)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}
    jm, pm = _mlp_pair()
    monkeypatch.setenv("DKTPU_FAULTS", "nan@1")
    telemetry.reset()
    pair = _train_both(tmp_path, "ADAG", TRAINERS["ADAG"], jm, pm, cols,
                       None)
    h = pair[0][0].get_history()
    assert not np.isfinite(h[1]) and np.isfinite(np.delete(h, 1)).all()
    np.testing.assert_allclose(h, pair[1][0].get_history(), rtol=ATOL,
                               atol=ATOL)
    snap = telemetry.get().snapshot()["counters"]
    assert snap["resilience.nonfinite_rounds"] == 1
    assert snap["input_stall_seconds"] >= 0
    assert snap["native.gather_calls"] > 0
    assert snap.get("native.gather_fallback_calls", 0) == 0


@pytest.mark.parametrize("via", ["kwarg", "env"])
def test_remote_training_from_a_sharded_store_is_refused_up_front(
        tmp_path, monkeypatch, via):
    """The remote worker loop gathers from an in-RAM plan's arrays; a
    sharded plan is refused before any worker dials (nothing listens at
    the endpoint)."""
    from distkeras_tpu_torch.netps import remote

    _jm, pm = _mlp_pair()
    rng = np.random.default_rng(0)
    S.write_shards(str(tmp_path), {
        "features": rng.normal(size=(32, DIM)).astype(np.float32),
        "label": rng.integers(0, 10, 32).astype(np.int32)}, 8)
    started = []
    monkeypatch.setattr(remote, "make_ps_client",
                        lambda *a, **k: started.append(a))
    kw = {}
    if via == "kwarg":
        kw["remote"] = "127.0.0.1:1"
    else:
        monkeypatch.setenv("DKTPU_PS_ENDPOINT", "127.0.0.1:1")
    t = T.ADAG(pm, **SMALL, **TRAINERS["ADAG"], **kw)
    with pytest.raises(ValueError, match="sharded store"):
        t.train(S.ShardedDataFrame(str(tmp_path)))
    assert not started


# ---------------------------------------------------------------------------
# The sharded predictor and evaluators
# ---------------------------------------------------------------------------

def test_sharded_predict_evaluate_and_vacuum_as_jax(tmp_path):
    """Shards of 7 rows under a chunk of 16 (rows buffer across shards);
    three predicts of one column (the second versions it and defers the
    first's files, the third reclaims them) and a ``vacuum``, in both
    packages on copies of one store."""
    jm, pm = _mlp_pair()
    rng = np.random.default_rng(3)
    n = 45
    cols = {"features": rng.integers(0, 256, (n, DIM), dtype=np.uint8),
            "label": rng.integers(0, 10, n).astype(np.int32)}
    roots = {k: str(tmp_path / k) for k in ("port", "jax")}
    S.write_shards(roots["port"], cols, 7)
    JS.write_shards(roots["jax"], cols, 7)
    kw = dict(features_col="features", output_col="p", chunk_size=16)
    port = P.ModelPredictor(pm, **kw)
    jpred = JP.ModelPredictor(jm, **kw)
    telemetry.reset()
    out = port.predict(S.ShardedDataFrame(roots["port"]))
    jout = jpred.predict(JS.ShardedDataFrame(roots["jax"]))
    snap = telemetry.get().snapshot()
    assert snap["spans"]["predict.shard_rows"]["count"] == 7
    assert isinstance(out, S.ShardedDataFrame) and "p" in out
    col = np.concatenate([c["p"] for c in out.iter_column_chunks("p")])
    ref = np.concatenate([c["p"] for c in jout.iter_column_chunks("p")])
    assert col.shape == ref.shape == (n, 10) and col.dtype == ref.dtype
    np.testing.assert_allclose(col, ref, rtol=0, atol=ATOL)
    assert out.store.manifest == jout.store.manifest
    ram = port.predict(DataFrame(cols))["p"]
    np.testing.assert_array_equal(col, ram)
    for ev, jev in ((E.AccuracyEvaluator("p"), JE.AccuracyEvaluator("p")),
                    (E.F1Evaluator("p"), JE.F1Evaluator("p"))):
        assert ev.evaluate(out) == jev.evaluate(jout)
        assert ev.evaluate(out) == ev.evaluate(
            DataFrame({"p": col, "label": cols["label"]}))
    np.testing.assert_allclose(
        E.LossEvaluator(LOSS, "p").evaluate(out),
        JE.LossEvaluator(LOSS, "p").evaluate(jout), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        E.LossEvaluator(LOSS, "p").evaluate(out),
        E.LossEvaluator(LOSS, "p").evaluate(
            DataFrame({"p": col, "label": cols["label"]})), rtol=0,
        atol=1e-6)

    def layout(root):
        """The store's files and its garbage list, each versioned column's
        random tag masked."""
        m = json.load(open(os.path.join(root, "manifest.json")))
        tags = {c["file"]: f"{k}.V" for k, c in m["columns"].items()
                if "file" in c}
        tags.update({g: "G" for g in m.get("garbage", []) if "." in g})

        def mask(name):
            for tag, masked in tags.items():
                name = name.replace(f".{tag}.", f".{masked}.")
            return name

        return (sorted(mask(f) for f in os.listdir(root)),
                [tags.get(g, g) for g in m.get("garbage", [])])

    port2 = port.predict(out)
    jport2 = jpred.predict(jout)
    spec = port2.store.columns["p"]
    assert spec["file"].startswith("p.") and port2.store.manifest[
        "garbage"] == ["p"]
    assert layout(roots["port"]) == layout(roots["jax"])
    again = np.concatenate([c["p"] for c in port2.iter_column_chunks("p")])
    np.testing.assert_array_equal(again, col)
    port.predict(port2)
    jpred.predict(jport2)
    assert layout(roots["port"]) == layout(roots["jax"])
    removed = P.vacuum(roots["port"])
    assert removed == JP.vacuum(roots["jax"]) == 7
    assert layout(roots["port"]) == layout(roots["jax"])
    assert P.vacuum(roots["port"]) == 0


def test_sharded_loss_evaluator_warns_for_a_custom_loss(tmp_path):
    rng = np.random.default_rng(0)
    S.write_shards(str(tmp_path), {
        "prediction": rng.normal(size=(20, 4)).astype(np.float32),
        "label": rng.integers(0, 4, 20).astype(np.int32)}, 6)
    from distkeras_tpu_torch.ops.losses import get_loss

    ev = E.LossEvaluator(get_loss(LOSS))
    with pytest.warns(UserWarning, match="mean-reduced"):
        got = ev.evaluate(S.ShardedDataFrame(str(tmp_path)))
    assert np.isfinite(got)


def test_an_empty_store_has_nothing_to_predict(tmp_path):
    _jm, pm = _mlp_pair()
    w = S.ShardWriter(str(tmp_path), rows_per_shard=4)
    w.close()
    with pytest.raises(ValueError, match="no rows to predict"):
        P.ModelPredictor(pm).predict(S.ShardedDataFrame(str(tmp_path)))
