"""The port's streaming continual-training loop (``distkeras_tpu_torch/
streaming/``) and the engines' ``run_stream``, held to the JAX package's
(the counterpart of ``tests/test_streaming.py``).

Layers under test, smallest to largest: the offset journal (a journal
either package writes loads in the other, byte-equal files for the same
operations, ``.prev`` fallback, ``resolve``); the stream sources (each
package's writer feeds the other's file tail and each producer the other's
socket source, resume and skip set included); the ``feed_gap``/``drift``
fault kinds (one-shot, the shift permanent and equal in both); the claim
queue; the engines' epoch-free ``run_stream`` (losses and centers within
rtol = atol = 1e-5 of the JAX engines'); DriftWatch's transitions and the
regression gate on one loss sequence; and ``StreamingTraining`` end to end:
one worker against the JAX runtime within 1e-5, exactly-once against the
commit log and the journal, and the Supervisor's crash-and-resume
replaying zero committed records.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu.resilience.faults as jfaults
import distkeras_tpu.streaming as jst
import distkeras_tpu.telemetry as jtel
import distkeras_tpu_torch.resilience.faults as pfaults
import distkeras_tpu_torch.streaming as pst
import distkeras_tpu_torch.telemetry as ptel
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.streaming import (
    DriftWatch,
    FileTailSource,
    OffsetJournal,
    SocketSource,
    StreamFileWriter,
    StreamingSession,
    StreamingTraining,
    StreamProducer,
    WindowedEval,
    WorkQueue,
    decode_record,
    encode_record,
    replayed_offsets,
)

PKGS = {"jax": (jst, jfaults), "port": (pst, pfaults)}
PAIRS = [("jax", "port"), ("port", "jax")]
TOL = dict(rtol=1e-5, atol=1e-5)
LOSS = "sparse_categorical_crossentropy"


@pytest.fixture(autouse=True)
def _fresh_ambient():
    for tel in (jtel, ptel):
        tel.reset()
    for f in (jfaults, pfaults):
        f.reset()
    yield
    for f in (jfaults, pfaults):
        f.reset()
    for tel in (jtel, ptel):
        tel.reset()


# ---------------------------------------------------------------------------
# Offset journal
# ---------------------------------------------------------------------------

def test_journal_roundtrip_frontier_and_ahead(tmp_path):
    path = str(tmp_path / "offsets.json")
    j = OffsetJournal(path)
    j.intent(0, 1, 0)
    j.committed(0, 0, event_ts=100.0)
    # Out-of-order commit parks in `ahead`, absorbed when the gap closes.
    j.committed(1, 2, event_ts=102.0)
    assert j.frontier == 1 and j.skip_offsets() == frozenset({2})
    j.committed(0, 1, event_ts=101.0)
    assert j.frontier == 3 and j.skip_offsets() == frozenset()
    j.set_meta(drift_from=7)

    j2 = OffsetJournal(path)
    assert j2.load() is True
    assert j2.frontier == 3
    assert j2.items_committed == 3
    assert j2.last_event_ts == 102.0
    assert j2.meta == {"drift_from": 7}
    assert j2.committed_offsets_upto(10) == {0, 1, 2}
    assert os.path.exists(path + ".sha256")


def test_journal_corruption_falls_back_to_previous_generation(tmp_path):
    path = str(tmp_path / "offsets.json")
    j = OffsetJournal(path)
    j.committed(0, 0)
    j.committed(0, 1)  # generation 2; generation 1 (frontier=1) is .prev
    with open(path, "ab") as f:
        f.write(b"torn")
    j2 = OffsetJournal(path)
    assert j2.load() is True, "must fall back to .prev, not to zero"
    assert j2.frontier == 1, "the previous generation's frontier"


def test_journal_resolve_landed_vs_unlanded_intents(tmp_path):
    j = OffsetJournal(str(tmp_path / "offsets.json"))
    j.committed(0, 0)
    j.intent(0, 5, 1)   # will have landed (PS folded seq 5, ACK lost)
    j.intent(1, 9, 2)   # never reached the PS
    landed = j.resolve({0: 5, 1: 8})
    assert landed == [1], "seq<=last_seq means the fold landed"
    assert j.frontier == 2, "landed offset is committed, never re-read"
    assert j.skip_offsets() == frozenset()
    assert j.start_offset() == 2, "offset 2 will be re-read and re-sent"
    j2 = OffsetJournal(j.path)
    assert j2.load() and j2._intents == {}


def test_replayed_offsets_helper():
    assert replayed_offsets({0, 1, 2}, [3, 4]) == set()
    assert replayed_offsets({0, 1, 2}, [2, 3]) == {2}


def _journal_ops(pkg, path):
    j = PKGS[pkg][0].OffsetJournal(path)
    j.intent(0, 1, 0)
    j.committed(0, 0, event_ts=100.0)
    j.committed(1, 2, event_ts=102.5)
    j.intent(0, 4, 1)
    j.intent(1, 7, 5)
    j.set_meta(drift_from=3, note="x")
    return j


def test_journal_files_are_the_same_bytes(tmp_path):
    """The same operations write the same snapshot and sidecar, byte for
    byte, in both packages (current and previous generation)."""
    for pkg in PKGS:
        os.makedirs(tmp_path / pkg)
        _journal_ops(pkg, str(tmp_path / pkg / "offsets.json"))
    for suffix in ("", ".sha256", ".prev", ".prev.sha256"):
        a = (tmp_path / "jax" / f"offsets.json{suffix}").read_bytes()
        b = (tmp_path / "port" / f"offsets.json{suffix}").read_bytes()
        assert a == b, suffix


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_journal_loads_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "offsets.json")
    w = _journal_ops(writer, path)
    r = PKGS[reader][0].OffsetJournal(path)
    assert r.load() is True
    assert r.frontier == w.frontier == 1
    assert r.skip_offsets() == w.skip_offsets() == frozenset({2})
    assert r._intents == w._intents == {0: {"seq": 4, "offset": 1},
                                        1: {"seq": 7, "offset": 5}}
    assert r.meta == w.meta == {"drift_from": 3, "note": "x"}
    assert r.items_committed == 2 and r.last_event_ts == 102.5
    # resolve in the reader: worker 0's seq 4 landed, worker 1's seq 7 not
    assert r.resolve({0: 4, 1: 6}) == [1]
    assert r.frontier == 3 and r._intents == {}
    back = PKGS[writer][0].OffsetJournal(path)
    assert back.load() and back.frontier == 3 and back._intents == {}


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_journal_prev_fallback_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "offsets.json")
    j = PKGS[writer][0].OffsetJournal(path)
    j.committed(0, 0)
    j.committed(0, 1)
    with open(path, "r+b") as f:
        f.write(b"X")  # a flipped byte: the sidecar no longer matches
    r = PKGS[reader][0].OffsetJournal(path)
    assert r.load() is True and r.frontier == 1


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------

def _feed_arrays(i, k=1, b=4, feat=3):
    xs = np.full((k, b, feat), float(i), np.float32)
    ys = np.full((k, b), i % 3, np.int32)
    return xs, ys


def _varied(i):
    """Record i: distinct features, labels spanning 0..i % 3 + 1 (so the
    per-record inferred class count of the drift differs by record)."""
    rng = np.random.default_rng(100 + i)
    xs = rng.normal(size=(2, 4, 3)).astype(np.float32)
    ys = (np.arange(8).reshape(2, 4) % (i % 3 + 2)).astype(np.int32)
    return xs, ys


def test_record_codec_roundtrip():
    xs, ys = _feed_arrays(7)
    frame = encode_record(xs, ys, 123.5)
    rec = decode_record(frame[4:], index=7)
    assert rec.index == 7 and rec.ts == 123.5
    np.testing.assert_array_equal(rec.xs, xs)
    np.testing.assert_array_equal(rec.ys, ys)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_record_codec_across_packages(writer, reader):
    xs, ys = _varied(4)
    frame = PKGS[writer][0].encode_record(xs, ys, 77.25)
    assert frame[:4] == len(frame[4:]).to_bytes(4, "big")
    rec = PKGS[reader][0].decode_record(frame[4:], index=4)
    assert rec.index == 4 and rec.ts == 77.25 and not rec.drifted
    np.testing.assert_array_equal(rec.xs, xs)
    np.testing.assert_array_equal(rec.ys, ys)
    assert rec.xs.dtype == xs.dtype and rec.ys.dtype == ys.dtype
    assert PKGS[writer][0].source.EOS_FRAME == \
        PKGS[reader][0].source.EOS_FRAME == bytes(4)


def test_file_tail_source_reads_resumes_and_skips(tmp_path):
    path = str(tmp_path / "feed.bin")
    w = StreamFileWriter(path)
    for i in range(6):
        w.append(*_feed_arrays(i), ts=float(i))
    w.end()

    src = FileTailSource(path, poll_s=0.01)
    got = list(src.read())
    assert [r.index for r in got] == list(range(6))
    assert all(float(r.xs[0, 0, 0]) == r.index for r in got)

    # Resume: start at the frontier, skip the out-of-order-committed set.
    src2 = FileTailSource(path, poll_s=0.01)
    got2 = [r.index for r in src2.read(start_index=2, skip=frozenset({4}))]
    assert got2 == [2, 3, 5]


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_file_tail_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "feed.bin")
    w = PKGS[writer][0].StreamFileWriter(path)
    for i in range(6):
        w.append(*_varied(i), ts=10.0 + i)
    w.end()
    got = {}
    for pkg in (writer, reader):
        src = PKGS[pkg][0].FileTailSource(path, poll_s=0.01)
        got[pkg] = list(src.read(start_index=2, skip=frozenset({4})))
    assert [r.index for r in got[reader]] == [2, 3, 5]
    for a, b in zip(got[writer], got[reader]):
        assert a.index == b.index and a.ts == b.ts == 10.0 + a.index
        np.testing.assert_array_equal(a.xs, b.xs)
        np.testing.assert_array_equal(a.ys, b.ys)


def test_file_tail_follows_a_growing_file(tmp_path):
    """A live tail: records appended after the read started arrive."""
    path = str(tmp_path / "feed.bin")
    w = StreamFileWriter(path)
    w.append(*_feed_arrays(0))
    src = FileTailSource(path, poll_s=0.01)
    it = src.read()
    assert next(it).index == 0

    def late():
        time.sleep(0.1)
        w.append(*_feed_arrays(1))
        w.end()

    t = threading.Thread(target=late)
    t.start()
    assert [r.index for r in it] == [1]
    t.join()


def test_socket_source_survives_connection_kill():
    prod = StreamProducer()
    try:
        for i in range(10):
            prod.feed(*_feed_arrays(i))
        src = SocketSource(prod.endpoint, reconnect_s=5.0)
        seen = []
        it = src.read()
        for _ in range(4):
            seen.append(next(it).index)
        prod.kill_connections()  # the source-kill drill, mid-stream
        prod.end()
        seen.extend(r.index for r in it)
        assert seen == list(range(10)), "retransmits only: no loss, no dup"
        assert src.reconnects >= 1
    finally:
        prod.close()


@pytest.mark.parametrize("producer,reader", PAIRS)
def test_socket_producer_feeds_the_other_package(producer, reader):
    prod = PKGS[producer][0].StreamProducer()
    try:
        for i in range(8):
            prod.feed(*_varied(i), ts=float(i))
        src = PKGS[reader][0].SocketSource(prod.endpoint, reconnect_s=5.0)
        got = []
        it = src.read()
        for _ in range(3):
            got.append(next(it))
        prod.kill_connections()
        prod.end()
        got.extend(it)
        assert [r.index for r in got] == list(range(8))
        assert src.reconnects >= 1
        for r in got:
            xs, ys = _varied(r.index)
            np.testing.assert_array_equal(r.xs, xs)
            np.testing.assert_array_equal(r.ys, ys)
            assert r.ts == float(r.index)
        # A fresh connection resumes at `start` and honours the skip set.
        again = PKGS[reader][0].SocketSource(prod.endpoint, reconnect_s=5.0)
        assert [r.index for r in again.read(5, frozenset({6}))] == [5, 7]
    finally:
        prod.close()


# ---------------------------------------------------------------------------
# feed_gap / drift fault kinds
# ---------------------------------------------------------------------------

def test_feed_gap_and_drift_parse_and_one_shot():
    plan = pfaults.FaultPlan.parse("feed_gap@3:0.25;drift@5")
    assert plan.feed_gap(2) == 0.0
    assert plan.feed_gap(3) == 0.25
    assert plan.feed_gap(3) == 0.0, "one-shot"
    assert plan.drift(4) is False
    assert plan.drift(5) is True
    assert plan.drift(5) is False, "one-shot"


def test_drift_fault_shifts_labels_permanently(tmp_path):
    path = str(tmp_path / "feed.bin")
    w = StreamFileWriter(path)
    for i in range(6):
        xs = np.zeros((1, 4, 2), np.float32)
        ys = np.full((1, 4), 1, np.int32)
        w.append(xs, ys)
    w.end()
    pfaults.set_plan(pfaults.FaultPlan.parse("drift@3"))
    src = FileTailSource(path, poll_s=0.01, drift_classes=3)
    got = list(src.read())
    for r in got:
        if r.index < 3:
            assert not r.drifted and int(r.ys[0, 0]) == 1
        else:
            # (1 + 1) % 3 — the shift persists past the one-shot trigger.
            assert r.drifted and int(r.ys[0, 0]) == 2
    assert src.drift_from == 3
    snap = ptel.get().snapshot()
    assert snap["counters"]["stream.drift_injected"] == 1


def test_feed_gap_fault_delays_delivery(tmp_path):
    path = str(tmp_path / "feed.bin")
    w = StreamFileWriter(path)
    for i in range(3):
        w.append(*_feed_arrays(i))
    w.end()
    pfaults.set_plan(pfaults.FaultPlan.parse("feed_gap@1:0.3"))
    src = FileTailSource(path, poll_s=0.01)
    t0 = time.perf_counter()
    assert [r.index for r in src.read()] == [0, 1, 2]
    assert time.perf_counter() - t0 >= 0.3, "record 1 was held back"
    t0 = time.perf_counter()
    list(FileTailSource(path, poll_s=0.01).read())
    assert time.perf_counter() - t0 < 0.3, "the gap fires once"


@pytest.mark.parametrize("drift_classes", [None, 5])
def test_drift_is_the_same_in_both_packages(tmp_path, drift_classes):
    """``drift@3`` fires once in each package and rotates the same labels
    the same way from record 3 on — with ``drift_classes=None`` each
    record's class count inferred from its own label maximum — and a
    resumed source given ``drift_from`` re-enters the drifted world."""
    path = str(tmp_path / "feed.bin")
    w = StreamFileWriter(path)
    for i in range(7):
        w.append(*_varied(i))
    w.end()
    got = {}
    for pkg, (mod, flt) in PKGS.items():
        flt.set_plan(flt.FaultPlan.parse("feed_gap@1:0.05;drift@3"))
        src = mod.FileTailSource(path, poll_s=0.01,
                                 drift_classes=drift_classes)
        got[pkg] = list(src.read())
        assert src.drift_from == 3
        again = mod.FileTailSource(path, poll_s=0.01,
                                   drift_classes=drift_classes)
        assert not any(r.drifted for r in again.read()), "one-shot"
        resumed = mod.FileTailSource(path, poll_s=0.01, drift_from=3,
                                     drift_classes=drift_classes)
        assert [r.drifted for r in resumed.read(start_index=4)] == [True] * 3
    for a, b in zip(got["jax"], got["port"]):
        assert a.drifted == b.drifted == (a.index >= 3)
        np.testing.assert_array_equal(a.ys, b.ys)
        k = drift_classes or int(_varied(a.index)[1].max()) + 1
        want = _varied(a.index)[1]
        np.testing.assert_array_equal(
            b.ys, (want + 1) % k if a.index >= 3 else want)


# ---------------------------------------------------------------------------
# WorkQueue (shared claim discipline) and the feeder's item mode
# ---------------------------------------------------------------------------

def test_work_queue_bounded_mode_matches_elastic_semantics():
    q = WorkQueue(total=4)
    run = lambda: True  # noqa: E731
    assert q.claim(run) == 0 and q.claim(run) == 1
    q.requeue(0)
    assert q.claim(run) == 0, "retry queue wins over the frontier"
    for _ in range(2):
        q.commit_one()
    assert not q.done()
    assert q.claim(run) == 2 and q.claim(run) == 3
    q.commit_one()
    q.commit_one()
    assert q.done()
    assert q.claim(run) is None


def test_work_queue_bounded_claim_blocks_while_peers_in_flight():
    q = WorkQueue(total=2)
    a = q.claim(lambda: True)
    q.claim(lambda: True)
    got = []

    def late_claim():
        got.append(q.claim(lambda: True))

    t = threading.Thread(target=late_claim)
    t.start()
    time.sleep(0.05)
    q.requeue(a)  # eviction path: the requeued item must find the claimant
    t.join(timeout=5.0)
    assert got == [a]
    q.commit_one()
    q.commit_one()
    assert q.done()


def test_work_queue_open_mode_backpressure_and_done():
    q = WorkQueue(max_pending=2)
    assert q.put("a") and q.put("b")
    blocked = []

    def put_c():
        blocked.append(q.put("c"))

    t = threading.Thread(target=put_c)
    t.start()
    time.sleep(0.05)
    assert not blocked, "put blocks at max_pending (backpressure)"
    item = q.claim(lambda: True)
    t.join(timeout=5.0)
    assert blocked == [True] and item == "a"
    assert not q.done()
    q.commit_one()
    q.close_intake()
    assert not q.done(), "pending items remain"
    assert q.claim(lambda: True) == "b"
    q.commit_one()
    assert q.claim(lambda: True) == "c"
    q.commit_one()
    assert q.done()
    assert q.claim(lambda: True) is None
    assert q.put("d") is False, "intake closed"


def test_round_feeder_accepts_item_iterables():
    from distkeras_tpu_torch.data.prefetch import RoundFeeder

    feeder = RoundFeeder(iter(["a", "b", "c"]), stage=str.upper,
                         start_round=5)
    assert list(feeder) == [(5, "A"), (6, "B"), (7, "C")]


# ---------------------------------------------------------------------------
# Engine run_stream
# ---------------------------------------------------------------------------

def _mlp_pair(hidden=(16,), seed=0):
    """The same MLP weights in both packages (4 features, 3 classes)."""
    from distkeras_tpu.models import Model as JaxModel
    from distkeras_tpu.models.mlp import MLP as JaxMLP
    from distkeras_tpu_torch.models import MLP, Model

    jm = JaxModel.build(JaxMLP(hidden=hidden, num_outputs=3),
                        jnp.zeros((1, 4), jnp.float32), seed=seed)
    pm = Model.build(MLP(hidden=hidden, num_outputs=3, in_features=4),
                     np.zeros((1, 4), np.float32), device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return jm, pm


def _endless(seed=0, W=2, K=2, B=8):
    rng = np.random.default_rng(seed)
    while True:  # endless — max_items must bound it
        yield (rng.normal(size=(W, K, B, 4)).astype(np.float32),
               rng.integers(0, 3, size=(W, K, B)).astype(np.int32))


def _assert_params(pm, jax_params, got: dict):
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                          pm.module)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                   **TOL)


def test_run_stream_trains_sync_engine_without_epoch_schedule():
    from distkeras_tpu_torch.parallel.sync import SyncEngine

    _jm, pm = _mlp_pair(hidden=(8,))
    with pytest.warns(UserWarning, match="merged"):
        engine = SyncEngine(pm, "sgd", LOSS, num_workers=2,
                            learning_rate=0.05)
    seen = []
    state, losses = engine.run_stream(
        _endless(), on_item=lambda i, loss, st: seen.append(i),
        max_items=6)
    assert losses.size == 6, "one loss per consumed item"
    assert np.all(np.isfinite(losses))
    assert seen == list(range(6))
    assert engine.feed_wait_seconds >= 0.0


@pytest.mark.parametrize("kind", ["sync", "async"])
def test_run_stream_matches_the_jax_engines(kind):
    """6 items of an endless source through both packages' engines (2
    workers, MLP): the per-item losses and the trained params/center
    within rtol = atol = 1e-5, ``on_item`` seeing every index from
    ``start_index`` on."""
    from distkeras_tpu.parallel import ADAGFold as JaxADAG
    from distkeras_tpu.parallel import AsyncEngine as JaxAsync
    from distkeras_tpu.parallel import SyncEngine as JaxSync
    from distkeras_tpu.runtime.mesh import data_mesh
    from distkeras_tpu_torch.parallel import ADAGFold, AsyncEngine
    from distkeras_tpu_torch.parallel.sync import SyncEngine

    jm, pm = _mlp_pair()
    mesh = data_mesh(num_workers=2)
    if kind == "sync":
        jeng = JaxSync(jm, "sgd", LOSS, mesh, learning_rate=0.05)
        with pytest.warns(UserWarning, match="merged"):
            peng = SyncEngine(pm, "sgd", LOSS, num_workers=2,
                              learning_rate=0.05)
    else:
        jeng = JaxAsync(jm, "sgd", LOSS, JaxADAG(), mesh, window=2,
                        learning_rate=0.05)
        peng = AsyncEngine(pm, "sgd", LOSS, ADAGFold(), window=2,
                           num_workers=2, learning_rate=0.05)
    jseen, pseen = [], []
    jstate, jl = jeng.run_stream(
        _endless(), on_item=lambda i, loss, st: jseen.append(i),
        start_index=3, max_items=6)
    pstate, pl = peng.run_stream(
        _endless(), on_item=lambda i, loss, st: pseen.append(i),
        start_index=3, max_items=6)
    assert pseen == jseen == list(range(3, 9))
    assert pl.shape == ((6,) if kind == "sync" else (6, 2))
    np.testing.assert_allclose(pl.reshape(-1), np.asarray(jl).reshape(-1),
                               **TOL)
    if kind == "sync":
        _assert_params(pm, jstate.params, pstate.params)
    else:
        _assert_params(pm, jstate.center, pstate.center)


def test_run_stream_crash_fault_and_nonfinite_accounting():
    """``crash@i`` fires before item i through the run's RoundGuard, and
    the items already run are accounted on the way out (a NaN item from
    ``nan@``-free poisoned data counts in resilience.nonfinite_rounds)."""
    from distkeras_tpu_torch.parallel import ADAGFold, AsyncEngine
    from distkeras_tpu_torch.resilience.errors import InjectedFault

    _jm, pm = _mlp_pair()
    eng = AsyncEngine(pm, "sgd", LOSS, ADAGFold(), window=2, num_workers=2,
                      learning_rate=0.05)

    def items():
        for i, (xs, ys) in enumerate(_endless()):
            if i == 1:
                xs = xs * np.float32("nan")
            yield xs, ys

    pfaults.set_plan(pfaults.FaultPlan.parse("crash@3"))
    seen = []
    with pytest.raises(InjectedFault):
        eng.run_stream(items(), on_item=lambda i, loss, st: seen.append(i))
    assert seen == [0, 1, 2]
    snap = ptel.get().snapshot()
    assert snap["counters"]["resilience.nonfinite_rounds"] == 1


def test_run_stream_fetches_in_chunks():
    """A small ``fetch_every`` drains the device losses as it goes; the
    result is the same as one drain at the end."""
    from distkeras_tpu_torch.parallel import ADAGFold, AsyncEngine
    from distkeras_tpu_torch.parallel.engine import run_stream

    out = []
    for fetch_every in (2, 64):
        _jm, pm = _mlp_pair()
        eng = AsyncEngine(pm, "sgd", LOSS, ADAGFold(), window=2,
                          num_workers=2, learning_rate=0.05)
        out.append(run_stream(eng, _endless(), max_items=5,
                              fetch_every=fetch_every))
    np.testing.assert_array_equal(out[0][1], out[1][1])
    for k, v in out[0][0].center.items():
        assert torch.equal(v, out[1][0].center[k])


# ---------------------------------------------------------------------------
# Windowed eval, drift watch, regression gate
# ---------------------------------------------------------------------------

def test_drift_watch_pages_then_clears_with_recovery_time():
    watch = DriftWatch(window=WindowedEval(fast=4, slow=16),
                       drift_factor=2.0, floor=0.05)
    drifts, recoveries = [], []
    watch.on_drift = lambda fast, slow: drifts.append((fast, slow))
    watch.on_recover = lambda s: recoveries.append(s)
    for _ in range(16):
        assert watch.update(0.1) is None, "healthy baseline never pages"
    fired = [watch.update(10.0) for _ in range(4)]
    assert "fired" in fired
    assert watch.paging and watch.drift_events == 1 and len(drifts) == 1
    cleared = [watch.update(0.1) for _ in range(16)]
    assert "cleared" in cleared
    assert not watch.paging
    assert recoveries and watch.last_recovery_s is not None
    snap = ptel.get().snapshot()
    assert snap["counters"]["stream.drift_events"] == 1
    assert "stream.recovery_seconds" in snap["gauges"]


def test_drift_watch_warmup_never_pages():
    watch = DriftWatch(window=WindowedEval(fast=8, slow=64),
                       drift_factor=2.0, floor=0.05)
    for _ in range(8):
        assert watch.update(50.0) is None
    assert not watch.paging


def test_regression_gate_refuses_regressed_candidate():
    watch = DriftWatch(window=WindowedEval(fast=4, slow=8))
    losses = {"good": 1.0, "better": 0.8, "regressed": 1.5}
    gate = watch.regression_gate(lambda name: losses[name],
                                 regress_floor=0.25)
    assert gate("good", 1) is True
    assert gate("better", 2) is True
    assert gate("regressed", 3) is False, "1.5 > 0.8 * 1.25"
    assert gate("good", 4) is True, "1.0 <= 0.8 * 1.25"
    events = [e["kind"] for e in ptel.get().events()]
    assert "stream_swap_rolled_back" in events


def test_drift_watch_and_gate_equal_the_jax_ones():
    """One loss sequence (baseline, a shift, recovery, a second shift)
    through both packages' DriftWatch: the same transitions at the same
    items, the same drift_events, the same gauges; one candidate sequence
    through both regression gates: the same decisions."""
    rng = np.random.default_rng(3)
    seq = np.concatenate([rng.uniform(0.1, 0.2, 40), rng.uniform(2, 3, 6),
                          rng.uniform(0.1, 0.2, 40), rng.uniform(1, 4, 8),
                          rng.uniform(0.1, 0.2, 30)])
    out = {}
    for pkg, tel in (("jax", jtel), ("port", ptel)):
        watch = PKGS[pkg][0].DriftWatch(
            window=PKGS[pkg][0].WindowedEval(fast=6, slow=30),
            drift_factor=2.0)
        trans = [watch.update(float(v)) for v in seq]
        snap = tel.get().snapshot()
        gate = watch.regression_gate(lambda c: c, regress_floor=0.3)
        cands = [1.0, 0.9, 1.2, 1.16, 0.5, 0.66, 0.64, 2.0]
        out[pkg] = (trans, watch.drift_events, watch.paging,
                    {k: snap["gauges"][k]["value"] for k in
                     ("stream.eval.loss_fast", "stream.eval.loss_slow")},
                    snap["counters"]["stream.drift_events"],
                    [gate(c, i) for i, c in enumerate(cands)])
    assert out["port"] == out["jax"]
    assert out["port"][1] == 2 and "cleared" in out["port"][0]


# ---------------------------------------------------------------------------
# StreamingTraining end to end
# ---------------------------------------------------------------------------

def _stream_file(tmp_path, n, seed=0, k=2, b=8):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(3, 4))
    path = str(tmp_path / "feed.bin")
    w = StreamFileWriter(path)
    for i in range(n):
        y = rng.integers(0, 3, size=(k, b))
        x = (centers[y] + rng.normal(scale=0.5, size=(k, b, 4))).astype(
            np.float32)
        w.append(x, y.astype(np.int32), ts=float(i))
    w.end()
    return path


def _build_model():
    return _mlp_pair()[1]


def _make_runtime(tmp_path, path, **kw):
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer

    kw.setdefault("journal", str(tmp_path / "offsets.json"))
    kw.setdefault("checkpoint_dir", str(tmp_path / "ckpt"))
    kw.setdefault("checkpoint_every", 4)
    kw.setdefault("device", "cpu")
    return StreamingTraining(
        model=_build_model(), tx=get_optimizer("sgd", 0.1),
        loss_fn=get_loss(LOSS),
        source=FileTailSource(path, poll_s=0.01, drift_classes=3), **kw)


def test_streaming_training_exactly_once_in_process(tmp_path):
    n = 12
    path = _stream_file(tmp_path, n)
    rt = _make_runtime(tmp_path, path, num_workers=2)
    assert rt.worker_slots == 2
    sess = StreamingSession(lambda resume: rt, num_workers=2,
                            checkpoint_dir=rt.checkpoint_dir,
                            checkpoint_every=rt.checkpoint_every)
    model = sess.train()
    assert model is not None
    assert rt.progress() == n
    assert rt.done()
    assert len(rt._loops) == 2 and rt._loops[0] is not rt._loops[1]

    # Exactly-once against the PS commit log: one applied fold per record,
    # no (wid, seq) ever folded twice.
    log = rt.server.commit_log
    assert len(log) == n
    assert len({(wid, seq) for wid, seq, _ in log}) == n

    # The journal agrees, and agrees durably (reload from disk).
    j = OffsetJournal(str(tmp_path / "offsets.json"))
    assert j.load() is True
    assert j.frontier == n and j.items_committed == n
    assert j.committed_offsets_upto(n) == set(range(n))

    # Checkpoints landed with the freshness anchor in their meta.
    from distkeras_tpu_torch import checkpoint as ckpt_mod

    ckpt_dir = str(tmp_path / "ckpt")
    steps = ckpt_mod.scan_steps(ckpt_dir)
    assert steps, "interval checkpoints must exist"
    meta = ckpt_mod.read_meta(ckpt_dir, steps[0])
    assert meta["streaming"] is True and meta["event_ts"] is not None
    assert set(meta) >= {"items", "drift", "saved_at", "frontier"}
    snap = ptel.get().snapshot()
    assert snap["counters"]["stream.items_committed"] == n
    assert snap["counters"]["stream.items_read"] == n
    # The checkpoint span nests under the committing worker's item span.
    assert sum(v["count"] for k, v in snap["spans"].items()
               if k.endswith("stream.checkpoint")) >= len(steps)


def test_checkpoint_is_whole_when_the_save_returns(tmp_path):
    """The port's save is synchronous (the JAX package passes ``wait=True``
    to Orbax): the moment a streaming checkpoint returns, its step, meta
    sidecar and digest are on disk and a verified restore of it gives the
    center the PS held."""
    from distkeras_tpu_torch import checkpoint as ckpt_mod

    n = 6
    path = _stream_file(tmp_path, n)
    rt = _make_runtime(tmp_path, path, num_workers=1, checkpoint_every=2)
    ckpt_dir = str(tmp_path / "ckpt")
    checked = []
    inner = rt._maybe_checkpoint

    def save_then_look(client, force=False):
        before = ckpt_mod.scan_steps(ckpt_dir)
        inner(client, force=force)
        after = ckpt_mod.scan_steps(ckpt_dir)
        if after != before:
            step = after[0]
            meta = ckpt_mod.read_meta(ckpt_dir, step)
            restored = ckpt_mod.Checkpointer(ckpt_dir).restore(
                rt.model.params, step=step, verify=True)
            center, _ = client.pull()
            for (k, v), c in zip(restored.items(), center):
                assert np.array_equal(v.numpy(), c), k
            checked.append((step, meta["items"]))

    rt._maybe_checkpoint = save_then_look
    _drain(rt)
    assert checked == [(2, 2), (4, 4), (6, 6)]


def _jax_runtime(jm, path, journal, discipline, **kw):
    from distkeras_tpu.ops.losses import get_loss as jax_loss
    from distkeras_tpu.ops.optimizers import get_optimizer as jax_opt

    return jst.StreamingTraining(
        model=jm, tx=jax_opt("sgd", 0.1), loss_fn=jax_loss(LOSS),
        source=jst.FileTailSource(path, poll_s=0.01, drift_classes=3),
        num_workers=1, discipline=discipline, journal=journal,
        lease_s=30.0, **kw)


def _drain(rt):
    rt.ensure_started()
    rt.worker_main(0, lambda: True)
    rt.close()
    assert not rt.errors, rt.errors


@pytest.mark.parametrize("discipline", ["adag", "aeasgd"])
def test_one_worker_streaming_training_matches_jax(tmp_path, discipline):
    """The same 10 records through one worker of each package's runtime
    (the drift fault rotating labels from record 6 in both): the final
    centers and the per-item losses within rtol = atol = 1e-5, both
    journals exactly-once and equal."""
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer

    n = 10
    path = _stream_file(tmp_path, n, seed=4)
    jm, pm = _mlp_pair()
    jfaults.set_plan(jfaults.FaultPlan.parse("drift@6"))
    jrt = _jax_runtime(jm, path, str(tmp_path / "j.json"), discipline)
    _drain(jrt)
    pfaults.set_plan(pfaults.FaultPlan.parse("drift@6"))
    prt = StreamingTraining(
        model=pm, tx=get_optimizer("sgd", 0.1), loss_fn=get_loss(LOSS),
        source=FileTailSource(path, poll_s=0.01, drift_classes=3),
        num_workers=1, discipline=discipline,
        journal=str(tmp_path / "p.json"), lease_s=30.0, device="cpu")
    _drain(prt)
    assert prt.progress() == jrt.progress() == n
    _assert_params(pm, jrt.result().params, prt.result().params)
    np.testing.assert_allclose(prt.losses, jrt.losses, **TOL)
    assert [s for _w, s, _st in prt.server.commit_log] == list(range(n))
    for name in ("j.json", "p.json"):
        j = OffsetJournal(str(tmp_path / name))
        assert j.load() and j.committed_offsets_upto(n) == set(range(n))
        assert j.meta == {"drift_from": 6}


class _RecordingSource:
    """Wrap a source, logging every delivered index — the replay probe."""

    def __init__(self, inner, log):
        self._inner = inner
        self.log = log

    @property
    def drift_from(self):
        return self._inner.drift_from

    @drift_from.setter
    def drift_from(self, v):
        self._inner.drift_from = v

    def read(self, start_index=0, skip=frozenset()):
        for rec in self._inner.read(start_index, skip):
            self.log.append(rec.index)
            yield rec

    def close(self):
        self._inner.close()


def test_supervisor_resume_replays_zero_committed_items(tmp_path):
    """Crash mid-stream under the port's Supervisor (``crash@5``), resume
    from the offset journal + checkpoint, and prove the restarted run
    re-reads NOTHING the journal holds as committed, while the PS commit
    log shows every record folded exactly once across both attempts."""
    from distkeras_tpu_torch.netps.server import PSServer
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer
    from distkeras_tpu_torch.resilience.errors import InjectedFault
    from distkeras_tpu_torch.resilience.supervisor import Supervisor

    n = 10
    path = _stream_file(tmp_path, n)
    jpath = str(tmp_path / "offsets.json")
    ckpt_dir = str(tmp_path / "ckpt")
    # The PS outlives the crash (the in-process analogue of the durable
    # netps subprocess the card's streaming_kill phase uses).
    server = PSServer(discipline="adag", host="127.0.0.1", port=0,
                      device="cpu").start()
    pfaults.set_plan(pfaults.FaultPlan.parse("crash@5"))
    committed_before = {}
    delivered = {}
    attempt = [0]

    def factory(resume):
        attempt[0] += 1
        if resume:
            probe = OffsetJournal(jpath)
            assert probe.load() is True
            committed_before["set"] = probe.committed_offsets_upto(n)
        log = []
        delivered[attempt[0]] = log
        return StreamingTraining(
            model=_build_model(), tx=get_optimizer("sgd", 0.1),
            loss_fn=get_loss(LOSS),
            source=_RecordingSource(
                FileTailSource(path, poll_s=0.01, drift_classes=3), log),
            num_workers=1, journal=jpath, endpoint=server.endpoint,
            checkpoint_dir=ckpt_dir, checkpoint_every=2, resume=resume,
            device="cpu")

    sess = StreamingSession(factory, num_workers=1,
                            checkpoint_dir=ckpt_dir, checkpoint_every=2)
    sup = Supervisor(sess, max_retries=2, backoff_s=0.0,
                     retry_on=(InjectedFault,))
    try:
        with pytest.warns(UserWarning, match="supervised train attempt"):
            model = sup.train(None)
        assert model is not None
        assert sup.attempts == 2

        before = committed_before["set"]
        assert before == set(range(5)), "crash@5 landed after 5 commits"
        assert replayed_offsets(before, delivered[2]) == set()
        assert delivered[2] == list(range(5, n))
        j = OffsetJournal(jpath)
        assert j.load() and j.committed_offsets_upto(n) == set(range(n))
        log = server.commit_log
        assert len(log) == n, "one applied fold per record, both attempts"
        assert len({(wid, seq) for wid, seq, _ in log}) == n
    finally:
        server.close()


def test_resume_settles_a_landed_intent_against_the_ps(tmp_path):
    """A crash between the PS's fold and the journal's ``committed``: the
    restart asks the PS for the worker's last folded seq, marks the
    record committed without re-reading it, and folds the rest once."""
    from distkeras_tpu_torch.netps.server import PSServer

    n = 6
    path = _stream_file(tmp_path, n)
    jpath = str(tmp_path / "offsets.json")
    server = PSServer(discipline="adag", device="cpu").start()
    try:
        first = _make_runtime(tmp_path, path, num_workers=1, journal=jpath,
                              endpoint=server.endpoint, checkpoint_dir=None,
                              max_items=3)
        _drain(first)
        j = OffsetJournal(jpath)
        assert j.load() and j.frontier == 3
        # Record 3 was folded as worker 0's next seq, but its ACK was lost.
        from distkeras_tpu_torch.netps.shards import make_ps_client

        with make_ps_client(server.endpoint, worker_id=0) as c:
            c.join(init=first._init_leaves)
            _center, counter = c.pull()
            j.intent(0, c._seq + 1, 3)
            c.commit([np.zeros_like(a) for a in first._init_leaves], counter)
        log = []
        second = _make_runtime(
            tmp_path, path, num_workers=1, journal=jpath,
            endpoint=server.endpoint, checkpoint_dir=None, resume=True)
        second.source = _RecordingSource(second.source, log)
        _drain(second)
        assert log == [4, 5], "the landed record is not re-read"
        j = OffsetJournal(jpath)
        assert j.load() and j.committed_offsets_upto(n) == set(range(n))
        assert len(server.commit_log) == n
        events = [e["kind"] for e in ptel.get().events()]
        assert "stream_intents_resolved" in events
    finally:
        server.close()


def test_streaming_stall_surfaces_as_feeder_error(tmp_path, monkeypatch):
    """A dried-up feed must become the Supervisor-visible typed error,
    not a silent hang: the reader runs through RoundFeeder's watchdog."""
    from distkeras_tpu_torch.resilience.errors import FeederStalledError

    monkeypatch.setenv("DKTPU_FEEDER_TIMEOUT", "0.5")
    monkeypatch.setenv("DKTPU_FEEDER_WARN", "0.2")
    path = str(tmp_path / "feed.bin")
    w = StreamFileWriter(path)
    w.append(*_feed_arrays(0, k=2, b=8, feat=4))
    w.close()  # NO end(): the tail waits forever for a frame
    rt = _make_runtime(tmp_path, path, num_workers=1)
    sess = StreamingSession(lambda resume: rt, num_workers=1,
                            checkpoint_dir=rt.checkpoint_dir)
    with pytest.raises(FeederStalledError):
        sess.train()


def test_stream_config_keys_match_the_jax_package():
    from distkeras_tpu.runtime import config as jax_config
    from distkeras_tpu_torch.runtime import config

    keys = [k for k in jax_config.ENV_REGISTRY
            if k.startswith("DKTPU_STREAM_")]
    assert len(keys) == 8
    for k in keys:
        port, ref = config.ENV_REGISTRY[k], jax_config.ENV_REGISTRY[k]
        assert (port.kind, port.default, port.category) == \
            (ref.kind, ref.default, ref.category), k
