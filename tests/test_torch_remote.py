"""The slice as a whole: ``DynSGD``/``ADAG``/``DOWNPOUR``/``AEASGD``/
``EAMSGD(..., remote=...)`` of the port against the port's own parameter
server, held to the same
trainers of the JAX package against the JAX server, from the same weights
on the same DataFrame. One worker, so commit order is fixed; the JAX model
runs ``cell_impl="pallas"`` (its Pallas LSTM kernels in interpret mode),
the port its plain twins on a CPU center.

Tolerances: codec ``none`` within rtol = atol = 1e-5 (f32 sums in another
order, as ``tests/test_torch_trainers.py``). ``int8``: a delta that differs
by ~1e-7 can round to a neighbouring int8 step, so the centers may differ
by up to the sum over commits of each commit's largest quantization step
(``spec["scale"] * commit_scale``), plus the 1e-5. At bf16
(``compute_dtype="bfloat16"``, codec ``none``) the center's mean
difference is held within 0.6 of the JAX trainer's own bf16-vs-f32
distance, as in process (``tests/test_torch_precision.py`` says why)."""

import time

import jax
import numpy as np
import pytest

import distkeras_tpu as dk
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
from distkeras_tpu.netps import PSServer as JaxPSServer
from distkeras_tpu_torch import imdb_lstm
from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.data import DataFrame
from distkeras_tpu_torch.netps import PSClient, PSServer
from distkeras_tpu_torch.netps import server as server_mod
from distkeras_tpu_torch.netps.fold import commit_scale
from distkeras_tpu_torch.ops.kernels import fold as F
from distkeras_tpu_torch.ops.kernels import lstm as K

SMALL = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)
K_STEPS, B, ROUNDS = 2, 5, 3


def _columns(W, rounds=ROUNDS, seed=0):
    rng = np.random.default_rng(seed)
    n = W * K_STEPS * B * rounds
    return {"features": rng.integers(0, 50, (n, 6)).astype(np.int32),
            "label": rng.integers(0, 2, n).astype(np.int32)}


def _kw(W):
    return dict(worker_optimizer="sgd",
                loss="sparse_categorical_crossentropy", num_workers=W,
                batch_size=B, communication_window=K_STEPS,
                learning_rate=0.1)


def _port_model(jm):
    pm = imdb_lstm(**SMALL, device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return pm


def _quant_steps(monkeypatch) -> list:
    """Record, for every commit the port server folds, its largest int8
    step ``spec["scale"] * commit_scale``."""
    steps = []
    real = server_mod.fold_delta

    def recording(center, delta, discipline, staleness):
        scale = commit_scale(discipline, staleness)
        rows = delta.rows  # the server passes its staged commit
        steps.append(max((float(f) * scale for f in
                          rows["factor"][rows["kind"] == F.KIND_INT8]),
                         default=0.0))
        return real(center, delta, discipline, staleness)

    monkeypatch.setattr(server_mod, "fold_delta", recording)
    return steps


@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("name,discipline", [("DynSGD", "dynsgd"),
                                             ("ADAG", "adag"),
                                             ("AEASGD", "aeasgd"),
                                             ("DOWNPOUR", "downpour"),
                                             ("EAMSGD", "eamsgd")])
def test_remote_trainer_matches_jax(monkeypatch, name, discipline, codec):
    monkeypatch.setenv("DKTPU_NET_COMPRESS", codec)
    steps = _quant_steps(monkeypatch)
    cols = _columns(1)
    jm = jax_imdb_lstm(**SMALL, cell_impl="pallas", seed=1)
    pm = _port_model(jm)
    jsrv = JaxPSServer(discipline=discipline).start()
    tsrv = PSServer(discipline=discipline, device="cpu").start()
    try:
        jt = getattr(dk, name)(jm, **_kw(1), remote=jsrv.endpoint)
        jout = jt.train(JaxDataFrame(cols))
        pt = getattr(T, name)(pm, **_kw(1), remote=tsrv.endpoint)
        before = (K.launch_counts(), F.launch_counts())
        pout = pt.train(DataFrame(cols))
        assert (K.launch_counts(), F.launch_counts()) == before  # CPU
        assert len(tsrv.commit_log) == len(jsrv.commit_log) == ROUNDS
    finally:
        jsrv.close()
        tsrv.close()
    assert pt.get_worker_histories().shape == (1, ROUNDS)
    assert pt.get_history().shape == (ROUNDS,)
    bound = 1e-5 + (sum(steps) if codec == "int8" else 0.0)
    assert (codec == "int8") == (len(steps) == ROUNDS and min(steps) > 0)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jout.params),
                          pm.module)
    got = pout.module.state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=bound)
    np.testing.assert_allclose(pt.get_worker_histories(),
                               np.asarray(jt.get_worker_histories()),
                               rtol=1e-5, atol=bound)
    for p, c in zip(pout.params.values(), tsrv.center()):
        np.testing.assert_array_equal(p.numpy(), c)


def test_remote_trainer_bf16_matches_jax(monkeypatch):
    """DynSGD at ``compute_dtype="bfloat16"`` against each package's own
    server, codec none: the model is the port server's center, whose mean
    difference from the JAX run at bf16 is within 0.6 of the JAX run's
    own bf16-vs-f32 distance."""
    monkeypatch.setenv("DKTPU_NET_COMPRESS", "none")
    cols = _columns(1)
    jouts = []
    for dtype in ("bfloat16", None):
        jm = jax_imdb_lstm(**SMALL, cell_impl="pallas", seed=1)
        jsrv = JaxPSServer(discipline="dynsgd").start()
        try:
            jouts.append(dk.DynSGD(jm, **_kw(1), remote=jsrv.endpoint,
                                   compute_dtype=dtype).train(
                JaxDataFrame(cols)))
        finally:
            jsrv.close()
    pm = _port_model(jm)
    tsrv = PSServer(discipline="dynsgd", device="cpu").start()
    try:
        pout = T.DynSGD(pm, **_kw(1), remote=tsrv.endpoint,
                        compute_dtype="bfloat16").train(DataFrame(cols))
        assert len(tsrv.commit_log) == ROUNDS
    finally:
        tsrv.close()
    for p, c in zip(pout.params.values(), tsrv.center()):
        np.testing.assert_array_equal(p.numpy(), c)
    ref16, ref32 = (params_from_jax(jax.tree_util.tree_map(
        np.asarray, o.params), pm.module) for o in jouts)
    got = pout.module.state_dict()

    def mean(a, b):
        d = [(a[k].double() - b[k].double()).abs() for k in b]
        return (sum(x.sum() for x in d) / sum(x.numel() for x in d)).item()

    err, design = mean(got, ref16), mean(ref16, ref32)
    assert 0 < err <= 0.6 * design, (err, design)


def test_two_workers_train_and_the_model_is_the_center(monkeypatch):
    monkeypatch.setenv("DKTPU_NET_COMPRESS", "int8")
    W, rounds = 2, 6
    cols = _columns(W, rounds=rounds, seed=3)
    cols["label"] = (cols["features"][:, 0] < 25).astype(np.int32)
    pm = imdb_lstm(**SMALL, device="cpu", seed=2)
    srv = PSServer(discipline="dynsgd", device="cpu").start()
    try:
        t = T.DynSGD(pm, **{**_kw(W), "learning_rate": 0.5},
                     remote=srv.endpoint)
        out = t.train(DataFrame(cols))
        assert len(srv.commit_log) == W * rounds
        assert sorted(w for w, _s, _st in srv.commit_log) == [0] * rounds \
            + [1] * rounds
        for (name, p), c in zip(out.params.items(), srv.center()):
            np.testing.assert_array_equal(p.numpy(), c, err_msg=name)
        with PSClient(srv.endpoint) as observer:
            assert observer.stats()["fold_backend"] == "torch-cpu"
    finally:
        srv.close()
    hist = t.get_worker_histories()
    assert hist.shape == (W, rounds) and np.isfinite(hist).all()
    assert t.get_history()[-1] < t.get_history()[0]


def test_remote_ignores_checkpoints_and_metrics_with_a_warning(tmp_path):
    """The parameter server owns the center on the remote path: the
    checkpoint and metrics harness is not driven, and the trainer says so,
    as the JAX package's does."""
    srv = PSServer(discipline="dynsgd", device="cpu").start()
    try:
        t = T.DynSGD(imdb_lstm(**SMALL, device="cpu"), **_kw(1),
                     remote=srv.endpoint,
                     checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
                     metrics_path=str(tmp_path / "m.jsonl"))
        with pytest.warns(UserWarning, match="are ignored on this path"):
            t.train(DataFrame(_columns(1)))
    finally:
        srv.close()
    assert not (tmp_path / "ck").exists()
    assert not (tmp_path / "m.jsonl").exists()


def test_remote_with_parallel_is_a_value_error(monkeypatch):
    pm = imdb_lstm(**SMALL, device="cpu")
    with pytest.raises(ValueError, match="cannot combine"):
        T.DynSGD(pm, **_kw(1), remote="127.0.0.1:1",
                 parallel={"model": 2})
    monkeypatch.setenv("DKTPU_PS_ENDPOINT", "127.0.0.1:1")
    with pytest.raises(ValueError, match="cannot combine"):
        T.ADAG(pm, **_kw(1), parallel={"model": 2})


def test_ps_endpoint_env_routes_to_the_server(monkeypatch):
    srv = PSServer(discipline="adag", device="cpu").start()
    try:
        monkeypatch.setenv("DKTPU_PS_ENDPOINT", srv.endpoint)
        pm = imdb_lstm(**SMALL, device="cpu")
        t = T.ADAG(pm, **_kw(1))
        t.train(DataFrame(_columns(1)))
        assert [w for w, _s, _st in srv.commit_log] == [0] * ROUNDS
    finally:
        srv.close()


@pytest.mark.parametrize("env,match", [
    ({"DKTPU_TRACE": "1"}, "item 10"),
])
def test_unported_remote_options_raise(monkeypatch, env, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pm = imdb_lstm(**SMALL, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        T.DynSGD(pm, **_kw(1), remote="127.0.0.1:1").train(
            DataFrame(_columns(1)))


@pytest.mark.parametrize("transport", ["tcp", "shm"])
def test_dynsgd_through_the_per_host_aggregator(monkeypatch, transport):
    """``DKTPU_NET_HIER=1``: the workers join a per-host aggregator seeded
    with the model, which pre-combines their commits (the plain twin on
    the CPU, one call a commit) and forwards combined commits to the root.
    Held by invariants (the flush timing decides which commits share a
    window): finite losses, the center moved, the model returned is the
    root's center, only the aggregator committed to the root, and every
    worker commit was absorbed exactly once."""
    from distkeras_tpu_torch.netps import hier

    monkeypatch.setenv("DKTPU_NET_HIER", "1")
    monkeypatch.setenv("DKTPU_NET_TRANSPORT", transport)
    made = []

    class Recorded(hier.AggregatorServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(hier, "AggregatorServer", Recorded)
    W = 2
    pm = imdb_lstm(**SMALL, device="cpu", seed=2)
    init = [v.detach().clone() for v in pm.params.values()]
    srv = PSServer(discipline="dynsgd", device="cpu",
                   transport=transport).start()
    calls = []
    real = F.fold_commit_plain_
    monkeypatch.setattr(F, "fold_commit_plain_",
                        lambda *a: (calls.append(1), real(*a))[1])
    try:
        t = T.DynSGD(pm, **_kw(W), remote=srv.endpoint)
        out = t.train(DataFrame(_columns(W)))
        center, log, members = srv.center(), srv.commit_log, srv.members()
    finally:
        srv.close()
    (agg,) = made
    assert agg.device.type == "cpu" and agg.transport == transport
    pairs = sorted((w, s) for w, s, _st in agg.commit_log)
    assert pairs == [(w, s) for w in range(W) for s in range(ROUNDS)]
    assert agg.absorbed == W * ROUNDS
    assert agg.forwarded_commits + agg.lost_commits == agg.absorbed
    assert agg.lost_windows == 0 and agg._acc_count == 0
    assert {w for w, _s, _st in log} == {agg._up.worker_id}
    assert len(log) == agg.forwarded and members == []
    assert len(calls) == agg.absorbed + agg.forwarded
    hist = t.get_worker_histories()
    assert hist.shape == (W, ROUNDS) and np.isfinite(hist).all()
    moved = max(float((p - i).abs().max())
                for p, i in zip(out.params.values(), init))
    assert moved > 0
    for p, c in zip(out.params.values(), center):
        np.testing.assert_array_equal(p.numpy(), c)


# ---------------------------------------------------------------------------
# Striping (DKTPU_NET_SHARDS) and the sharded center (a ``;`` endpoint
# matrix), held to the JAX package's trainers over the same plane. One
# worker, serial: the tolerances of test_remote_trainer_matches_jax (the
# int8 bound summed over every shard's commits).
# ---------------------------------------------------------------------------

def _held_to_jax(pm, pout, jout, pt, jt, steps, codec):
    bound = 1e-5 + (sum(steps) if codec == "int8" else 0.0)
    assert (codec == "int8") == (bool(steps) and min(steps) > 0)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jout.params),
                          pm.module)
    got = pout.module.state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=bound)
    np.testing.assert_allclose(pt.get_worker_histories(),
                               np.asarray(jt.get_worker_histories()),
                               rtol=1e-5, atol=bound)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_striped_remote_trainer_matches_jax(monkeypatch, codec):
    """``DKTPU_NET_SHARDS=2`` on both sides: each commit goes out as two
    stripes under one seq and is folded once; the port's run is bit-equal
    to its own unstriped run (stripes change nothing that is folded) and
    held to the JAX package's striped run."""
    monkeypatch.setenv("DKTPU_NET_COMPRESS", codec)
    steps = _quant_steps(monkeypatch)
    cols = _columns(1)
    jm = jax_imdb_lstm(**SMALL, cell_impl="pallas", seed=1)
    pm = _port_model(jm)
    outs = {}
    for shards in ("1", "2"):
        monkeypatch.setenv("DKTPU_NET_SHARDS", shards)
        tsrv = PSServer(discipline="dynsgd", device="cpu").start()
        try:
            pt = T.DynSGD(pm, **_kw(1), remote=tsrv.endpoint)
            outs[shards] = pt.train(DataFrame(cols))
            assert [s for _w, s, _st in tsrv.commit_log] == list(
                range(ROUNDS))
            center = tsrv.center()
        finally:
            tsrv.close()
    for a, b in zip(outs["1"].params.values(), outs["2"].params.values()):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    for p, c in zip(outs["2"].params.values(), center):
        np.testing.assert_array_equal(p.numpy(), c)
    jsrv = JaxPSServer(discipline="dynsgd").start()
    try:
        jt = dk.DynSGD(jm, **_kw(1), remote=jsrv.endpoint)
        jout = jt.train(JaxDataFrame(cols))
    finally:
        jsrv.close()
    _held_to_jax(pm, outs["2"], jout, pt, jt, steps[ROUNDS:], codec)


@pytest.mark.parametrize("via", ["remote", "env"])
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_sharded_remote_trainer_matches_jax(monkeypatch, codec, via):
    """A ``;`` endpoint matrix (``remote=`` or ``DKTPU_PS_ENDPOINT``) of a
    2-shard port :class:`ShardSet`: every shard folds each seq once, the
    model is the assembled center, and the run is held to the JAX trainer
    against a JAX 2-shard set."""
    from distkeras_tpu.netps.shards import ShardSet as JaxShardSet
    from distkeras_tpu_torch.netps import ShardSet

    monkeypatch.setenv("DKTPU_NET_COMPRESS", codec)
    steps = _quant_steps(monkeypatch)
    cols = _columns(1)
    jm = jax_imdb_lstm(**SMALL, cell_impl="pallas", seed=1)
    pm = _port_model(jm)
    with JaxShardSet(2, discipline="dynsgd") as jss:
        jt = dk.DynSGD(jm, **_kw(1), remote=jss.endpoint)
        jout = jt.train(JaxDataFrame(cols))
    with ShardSet(2, discipline="dynsgd", device="cpu") as ss:
        if via == "env":
            monkeypatch.setenv("DKTPU_PS_ENDPOINT", ss.endpoint)
        pt = T.DynSGD(pm, **_kw(1),
                      remote=ss.endpoint if via == "remote" else None)
        pout = pt.train(DataFrame(cols))
        for srv in ss.servers:
            assert [(w, s) for w, s, _st in srv.commit_log] == [
                (0, s) for s in range(ROUNDS)]
        center = ss.center()
        assert ss.plan.names == list(pm.params)  # the port's names
    for p, c in zip(pout.params.values(), center):
        np.testing.assert_array_equal(p.numpy(), c)
    _held_to_jax(pm, pout, jout, pt, jt, steps, codec)


def test_striped_overlapped_loop_is_exactly_once_and_replays_in_jax(
        monkeypatch, tmp_path):
    """``DKTPU_NET_INFLIGHT=2`` with ``DKTPU_NET_SHARDS=4``: both lanes
    stripe, every seq is folded once, and the JAX package's replay of the
    port server's journal is the port's center, bit for bit."""
    from distkeras_tpu.netps import state as jax_state

    monkeypatch.setenv("DKTPU_NET_INFLIGHT", "2")
    monkeypatch.setenv("DKTPU_NET_SHARDS", "4")
    monkeypatch.setenv("DKTPU_NET_COMPRESS", "int8")
    monkeypatch.setenv("DKTPU_NET_TIMEOUT", "5.0")
    W, rounds = 2, 4
    cols = _columns(W, rounds=rounds, seed=4)
    pm = imdb_lstm(**SMALL, device="cpu", seed=3)
    d = str(tmp_path / "state")
    srv = PSServer(discipline="dynsgd", device="cpu", state_dir=d,
                   snapshot_every=3).start()
    try:
        out = T.DynSGD(pm, **_kw(W), remote=srv.endpoint).train(
            DataFrame(cols))
        log = list(srv.commit_log)
        center = srv.center()
        assert not srv._pending
    finally:
        srv.close()
    assert len(log) == W * rounds
    _no_double_fold(log)
    for p, c in zip(out.params.values(), center):
        np.testing.assert_array_equal(p.numpy(), c)
    rec = jax_state.StateStore(d).recover("dynsgd")
    assert rec.updates == rec.commits_total == W * rounds
    for a, b in zip(center, rec.center):
        assert a.tobytes() == b.tobytes(), "JAX replay differs from the port"


def test_net_faults_evict_run_completes(monkeypatch):
    """``DKTPU_NET_FAULTS="evict@1:0"`` (served since the fault plan came
    to the port): the seeded worker goes silent for twice the lease before
    round 1, the server evicts it, its next RPC re-joins, and the run
    completes with every commit folded exactly once."""
    from distkeras_tpu_torch import resilience

    monkeypatch.setenv("DKTPU_NET_FAULTS", "evict@1:0")
    resilience.reset()
    srv = PSServer(discipline="dynsgd", device="cpu", lease_s=0.3).start()
    try:
        t = T.DynSGD(imdb_lstm(**SMALL, device="cpu"), **_kw(2),
                     remote=srv.endpoint)
        t.train(DataFrame(_columns(2)))
        plan = resilience.faults.active_net_plan()
        assert plan._fired == {("evict", 1)}
        assert srv.evictions >= 1 and srv.rejoins >= 1
        keys = [(w, s) for w, s, _st in srv.commit_log]
        assert len(keys) == len(set(keys))
        assert np.isfinite(t.get_history()).any()
    finally:
        srv.close()
        resilience.reset()


def test_unknown_transport_still_raises(monkeypatch):
    monkeypatch.setenv("DKTPU_NET_TRANSPORT", "bogus")
    pm = imdb_lstm(**SMALL, device="cpu")
    with pytest.raises(ValueError, match="DKTPU_NET_TRANSPORT='bogus'"):
        T.DynSGD(pm, **_kw(1), remote="127.0.0.1:1").train(
            DataFrame(_columns(1)))


@pytest.mark.parametrize("transport", ["shm", "mesh"])
@pytest.mark.parametrize("name,discipline", [("DynSGD", "dynsgd"),
                                             ("AEASGD", "aeasgd")])
def test_remote_trainer_over_each_transport_matches_jax(
        monkeypatch, name, discipline, transport):
    """``DKTPU_NET_TRANSPORT=shm|mesh`` trains config #4's small model in
    both packages, each against its own server of that transport: the
    port's center within 1e-5 of the JAX one, every commit folded once,
    and the port's clients on the dialect asked for (the ring; for mesh,
    the in-process dispatch: no ring frame and no TCP commit)."""
    from distkeras_tpu_torch import telemetry

    monkeypatch.setenv("DKTPU_NET_TRANSPORT", transport)
    cols = _columns(1)
    jm = jax_imdb_lstm(**SMALL, cell_impl="pallas", seed=1)
    pm = _port_model(jm)
    jsrv = JaxPSServer(discipline=discipline, transport=transport).start()
    tsrv = PSServer(discipline=discipline, device="cpu").start()
    assert tsrv.transport == transport  # the server reads the knob too
    telemetry.reset()
    try:
        jout = getattr(dk, name)(jm, **_kw(1),
                                 remote=jsrv.endpoint).train(
            JaxDataFrame(cols))
        pout = getattr(T, name)(pm, **_kw(1),
                                remote=tsrv.endpoint).train(DataFrame(cols))
        assert [s for _w, s, _t in tsrv.commit_log] == list(range(ROUNDS))
        assert len(jsrv.commit_log) == ROUNDS
    finally:
        jsrv.close()
        tsrv.close()
    spans = telemetry.get().snapshot()["spans"]
    assert spans[f"netps.rpc.commit.{transport}"]["count"] == ROUNDS
    assert "netps.rpc.commit" not in spans
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jout.params),
                          pm.module)
    got = pout.module.state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5)
    telemetry.reset()


# ---------------------------------------------------------------------------
# Compute/comms overlap (DKTPU_NET_INFLIGHT > 1), as the JAX package's
# tests/test_netps.py test_remote_overlap_inflight_trains_and_reports_
# hidden_fraction: the fold order depends on timing there, so the port's
# center is held to the JAX package's numpy replay of the port's own
# journal, bit for bit.
# ---------------------------------------------------------------------------

def _no_double_fold(log):
    seen = set()
    for wid, seq, _st in log:
        assert (wid, seq) not in seen, f"({wid},{seq}) folded twice"
        seen.add((wid, seq))


@pytest.mark.parametrize("name,discipline", [("ADAG", "adag"),
                                             ("DynSGD", "dynsgd")])
def test_overlapped_loop_trains_exactly_once_and_replays_in_jax(
        monkeypatch, tmp_path, name, discipline):
    from distkeras_tpu.netps import state as jax_state
    from distkeras_tpu_torch import telemetry

    monkeypatch.setenv("DKTPU_NET_INFLIGHT", "2")
    monkeypatch.setenv("DKTPU_NET_COMPRESS", "int8")
    monkeypatch.setenv("DKTPU_NET_TIMEOUT", "5.0")
    W, rounds = 2, 5
    cols = _columns(W, rounds=rounds, seed=4)
    pm = imdb_lstm(**SMALL, device="cpu", seed=3)
    d = str(tmp_path / "state")
    telemetry.reset()
    srv = PSServer(discipline=discipline, device="cpu", state_dir=d,
                   snapshot_every=3).start()
    try:
        t = getattr(T, name)(pm, **_kw(W), remote=srv.endpoint)
        out = t.train(DataFrame(cols))
        log = list(srv.commit_log)
        center = srv.center()
    finally:
        srv.close()
    assert len(log) == W * rounds
    _no_double_fold(log)
    for p, c in zip(out.params.values(), center):
        np.testing.assert_array_equal(p.numpy(), c)
    assert np.isfinite(t.get_worker_histories()).all()
    snap = telemetry.get().snapshot()
    assert 0.0 <= snap["gauges"]["netps.overlap.hidden_fraction"][
        "value"] <= 1.0
    assert snap["spans"]["netps.commit.staleness"]["count"] == W * rounds
    assert "discipline.staleness_mean" in snap["gauges"]
    rec = jax_state.StateStore(d).recover(discipline)
    assert rec.updates == rec.commits_total == W * rounds
    for a, b in zip(center, rec.center):
        assert a.tobytes() == b.tobytes(), "JAX replay differs from the port"


def test_serial_loop_does_not_export_the_overlap_gauge(monkeypatch):
    from distkeras_tpu_torch import telemetry

    monkeypatch.setenv("DKTPU_NET_INFLIGHT", "1")
    telemetry.reset()
    srv = PSServer(discipline="adag", device="cpu").start()
    try:
        T.ADAG(imdb_lstm(**SMALL, device="cpu"), **_kw(1),
               remote=srv.endpoint).train(DataFrame(_columns(1)))
    finally:
        srv.close()
    snap = telemetry.get().snapshot()
    assert "netps.overlap.hidden_fraction" not in snap["gauges"]
    assert snap["spans"]["netps.commit.staleness"]["count"] == ROUNDS


def test_commit_queued_before_an_eviction_rejoin_is_never_folded(
        monkeypatch):
    """Worker 0's first commit is held on the ordered lane while the
    worker computes ahead and queues its second; then the server revokes
    worker 0, so the first answers ``lease_expired`` (the client re-joins)
    and the second, queued before that rejoin, is answered ``evicted``
    without being sent: neither is folded, nothing is folded twice, and
    the worker goes on from the re-adopted center."""
    monkeypatch.setenv("DKTPU_NET_INFLIGHT", "2")
    monkeypatch.setenv("DKTPU_NET_TIMEOUT", "5.0")
    W, rounds = 2, 5
    srv = PSServer(discipline="adag", device="cpu").start()
    sent = {0: 0, 1: 0}
    real = PSClient.commit

    def commit(self, delta, pulled_counter):
        sent[self.worker_id] += 1
        if self.worker_id == 0 and sent[0] == 1:
            time.sleep(1.0)  # the worker computes ahead meanwhile
            srv.revoke(0)
        return real(self, delta, pulled_counter)

    monkeypatch.setattr(PSClient, "commit", commit)
    try:
        t = T.ADAG(imdb_lstm(**SMALL, device="cpu"), **_kw(W),
                   remote=srv.endpoint)
        t.train(DataFrame(_columns(W, rounds=rounds, seed=5)))
        log = list(srv.commit_log)
    finally:
        srv.close()
    _no_double_fold(log)
    assert sent == {0: rounds - 1, 1: rounds}  # the queued one never left
    assert sorted(w for w, _s, _st in log) == [0] * (rounds - 2) \
        + [1] * rounds
    assert srv.rejoins >= 1
    assert np.isfinite(t.get_worker_histories()).all()
