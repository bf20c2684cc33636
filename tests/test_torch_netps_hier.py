"""The port's per-host aggregator (``netps/hier.py``) held to the JAX
package's: the same seeded f32, bf16 and int8 commits absorbed in the same
order give root centers bit-equal to the numpy decode-then-add, with the
port aggregator in front of either package's root and the JAX aggregator
in front of the port's; then the counterparts of the JAX package's
aggregator cases (``tests/test_netps_shm.py``: flat-vs-hier, min-pulled
staleness, exactly-once at both levels, the idle stretch, lost windows, a
trainer over shm), the durable aggregator, and the trainer under
``DKTPU_NET_HIER=1``. On the CPU the pre-combine folds through the fold's
plain twin (``device="cpu"``), one call a commit."""

import time

import numpy as np
import pytest

from distkeras_tpu.netps import AggregatorServer as JaxAggregatorServer
from distkeras_tpu.netps import PSClient as JaxPSClient
from distkeras_tpu.netps import PSServer as JaxPSServer
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import (AggregatorServer, PSClient, PSServer,
                                       wire)
from distkeras_tpu_torch.ops.kernels import fold as F

FAST = dict(timeout=1.0, retries=3, backoff=0.01)
SHAPES = ((6,), (2, 3), (5,))
WORKERS, WINDOWS = 3, 2


def leaves(*shapes):
    rng = np.random.default_rng(0)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def root_server(pkg, **kw):
    kw.setdefault("discipline", "adag")
    if pkg == "port":
        return PSServer(device="cpu", **kw).start()
    return JaxPSServer(**kw).start()


def aggregator(pkg, upstream, **kw):
    kw.setdefault("discipline", "adag")
    if pkg == "port":
        return AggregatorServer(upstream=upstream, device="cpu", **kw,
                                **FAST).start()
    return JaxAggregatorServer(upstream=upstream, **kw, **FAST).start()


def client(pkg, endpoint, **kw):
    cls = PSClient if pkg == "port" else JaxPSClient
    return cls(endpoint, **dict(FAST, **kw))


def wait_for(cond, seconds=5.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


# ---------------------------------------------------------------------------
# The pre-combine, bit for bit, across packages
# ---------------------------------------------------------------------------

def init_center():
    """-0.0, random and +0.0 tensors: a root fold of a ``±0`` window
    element shows its sign only on a ``-0.0`` center."""
    return [np.full(SHAPES[0], -0.0, np.float32),
            leaves(SHAPES[1])[0], np.zeros(SHAPES[2], np.float32)]


def wire_commits(codec):
    """``[window][worker] -> entries``: seeded deltas with ``-0.0`` and
    ``+0.0`` elements, encoded per ``codec`` (``mixed`` cycles the codecs
    over tensors and workers). int8 adds the zero-scale corners: an
    all-zero tensor (scale 0, q = 0) and a scale-0 entry with negative q."""
    rng = np.random.default_rng(7)
    codecs = ("none", "bf16", "int8")
    out = []
    for win in range(WINDOWS):
        window = []
        for w in range(WORKERS):
            entries = []
            for i, shape in enumerate(SHAPES):
                d = (rng.normal(size=shape) * 1e-2).astype(np.float32)
                d.reshape(-1)[0] = -0.0
                d.reshape(-1)[-1] = 0.0
                c = (codecs[(w + i + win) % 3] if codec == "mixed"
                     else codec)
                if c == "int8" and i == 2 and w == 0:
                    d[:] = 0.0  # codec_encode: scale 0, q = 0
                q, spec = wire.codec_encode(d, c)
                if c == "int8" and i == 2 and w == 1 and win == 0:
                    q = -np.abs(q) - 1
                    spec = {"codec": "int8", "scale": 0.0}
                entries.append((q, spec) if spec else q)
            window.append(entries)
        out.append(window)
    return out


def numpy_chain(commits):
    """The reference's arithmetic: each window starts as a copy of the
    first decoded commit, the rest added in absorb order; the root adds
    the window at scale 1."""
    center = init_center()
    for window in commits:
        acc = None
        for entries in window:
            dec = [np.asarray(wire.codec_decode(*e) if isinstance(e, tuple)
                              else e, np.float32) for e in entries]
            if acc is None:
                acc = [a.copy() for a in dec]
            else:
                for a, d in zip(acc, dec):
                    a += d
        for c, a in zip(center, acc):
            c += a
    return center


def run_chain(agg_pkg, root_pkg, commits):
    root = root_server(root_pkg, center=init_center())
    try:
        agg = aggregator(agg_pkg, root.endpoint, fan_in=WORKERS,
                         flush_interval=3600.0)
        try:
            clients = [client(agg_pkg, agg.endpoint, worker_id=w)
                       for w in range(WORKERS)]
            try:
                for c in clients:
                    c.join()
                for k, window in enumerate(commits):
                    for c, entries in zip(clients, window):
                        _, u = c.pull()
                        hdr, _ = c._rpc("commit", {"seq": k, "pulled": u},
                                        entries)
                        assert hdr["applied"], hdr
                    assert wait_for(lambda: agg.forwarded == k + 1)
            finally:
                for c in clients:
                    c.close()
        finally:
            agg.close()
        assert agg.absorbed == WORKERS * WINDOWS
        assert agg.forwarded == WINDOWS and agg.lost_windows == 0
        assert len(root.commit_log) == WINDOWS
        return root.center()
    finally:
        root.close()


@pytest.mark.parametrize("codec", ["none", "bf16", "int8", "mixed"])
@pytest.mark.parametrize("agg_pkg,root_pkg", [
    ("port", "port"), ("jax", "jax"), ("port", "jax"), ("jax", "port")])
def test_aggregator_chain_is_bit_equal_to_the_reference(agg_pkg, root_pkg,
                                                        codec):
    commits = wire_commits(codec)
    want = numpy_chain(commits)
    got = run_chain(agg_pkg, root_pkg, commits)
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes(), (a, b)


def test_port_window_starts_at_negative_zero_and_folds_once_a_commit():
    """The device window between flushes is ``-0.0`` everywhere; an
    absorbed commit is one ``fold_commit_`` call (the plain twin here) and
    the take hands the window to host memory and resets it."""
    root = root_server("port", center=init_center())
    agg = aggregator("port", root.endpoint, fan_in=8, flush_interval=3600.0)
    calls = []
    real = F.fold_commit_plain_
    try:
        F.fold_commit_plain_ = lambda *a: (calls.append(1), real(*a))
        assert agg._flat.numpy().tobytes() == np.full(
            agg._flat.numel(), -0.0, np.float32).tobytes()
        with client("port", agg.endpoint, worker_id=0) as c:
            _, u = c.join()
            for k in range(3):
                assert c.commit([np.ones(s, np.float32) for s in SHAPES],
                                u).applied
        assert len(calls) == 3 and agg._acc_count == 3
        with agg._lock:
            acc, pulled, count, members, _traces, pairs = \
                agg._take_acc_locked(True)
        assert (pulled, count, members, pairs) == (0, 3, 1,
                                                   [(0, 0), (0, 1), (0, 2)])
        for a in acc:
            np.testing.assert_array_equal(a, 3.0)
        assert agg._flat.numpy().tobytes() == np.full(
            agg._flat.numel(), -0.0, np.float32).tobytes()
        # The served center is the root's, untouched by the absorbs.
        for a, b in zip(agg.center(), init_center()):
            assert a.tobytes() == b.tobytes()
    finally:
        F.fold_commit_plain_ = real
        agg.close()
        root.close()


def test_aggregator_without_a_card_raises_before_joining_upstream():
    root = root_server("port", center=init_center())
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AggregatorServer(upstream=root.endpoint, **FAST)
        assert root.members() == [] and not root._ever
    finally:
        root.close()


# ---------------------------------------------------------------------------
# The JAX package's aggregator cases (tests/test_netps_shm.py), ported
# ---------------------------------------------------------------------------

def test_hier_matches_flat_topology():
    """Scale-1 disciplines: folding the combined commit at the root gives
    the center folding each worker commit flat gives (the reference's rtol
    1e-6: f32 sums in another order)."""
    init = [np.zeros(6, np.float32), np.zeros((2, 2), np.float32)]
    deltas = [leaves((6,), (2, 2)) for _ in range(3)]
    flat = root_server("port")
    root = root_server("port")
    try:
        with client("port", flat.endpoint, worker_id=0) as fc:
            _, u = fc.join(init=[a.copy() for a in init])
            for d in deltas:
                fc.commit(d, u)
        agg = aggregator("port", root.endpoint,
                         init=[a.copy() for a in init], fan_in=3)
        clients = [client("port", agg.endpoint, worker_id=w)
                   for w in range(3)]
        try:
            pulls = [c.join()[1] for c in clients]
            for c, d, u in zip(clients, deltas, pulls):
                assert c.commit(d, u).applied
        finally:
            for c in clients:
                c.close()
            agg.close()
        for a, b in zip(flat.center(), root.center()):
            np.testing.assert_allclose(a, b, rtol=1e-6)
        assert len(root.commit_log) == 1 and agg.absorbed == 3
        assert len(flat.commit_log) == 3
    finally:
        flat.close()
        root.close()


def test_hier_combined_commit_staleness_is_min_pulled():
    root = root_server("port", discipline="dynsgd")
    try:
        with client("port", root.endpoint, worker_id=7) as direct:
            _, u = direct.join(init=[np.zeros(4, np.float32)])
            direct.commit([np.ones(4, np.float32)], u)
            _, u = direct.pull()
            direct.commit([np.ones(4, np.float32)], u)
        agg = aggregator("port", root.endpoint, discipline="dynsgd",
                         fan_in=2)
        a0 = client("port", agg.endpoint, worker_id=0)
        a1 = client("port", agg.endpoint, worker_id=1)
        try:
            _, u0 = a0.join()
            _, u1 = a1.join()
            assert u0 == u1 == 2  # root-lineage counters served locally
            a0.commit([np.ones(4, np.float32)], u0)
            a1.commit([np.ones(4, np.float32)], u1)
        finally:
            a0.close()
            a1.close()
            agg.close()
        agg_commits = [e for e in root.commit_log if e[0] != 7]
        assert len(agg_commits) == 1
        assert agg_commits[0][2] == 0
    finally:
        root.close()


def test_hier_exactly_once_at_both_levels():
    root = root_server("port")
    try:
        agg = aggregator("port", root.endpoint,
                         init=[np.zeros(3, np.float32)], fan_in=1)
        with client("port", agg.endpoint, worker_id=0) as c:
            _, u = c.join()
            assert c.commit([np.ones(3, np.float32)], u).applied
            hdr, _ = c._rpc("commit", {"seq": 0, "pulled": int(u)},
                            [np.ones(3, np.float32)])
            assert hdr["duplicate"] is True
        agg.close()
        assert agg.commit_log == [(0, 0, 0)]
        assert len(root.commit_log) == 1
        np.testing.assert_allclose(root.center()[0], 1.0)  # folded ONCE
    finally:
        root.close()


def test_hier_idle_stretch_keeps_root_lease():
    """The between-flush heartbeat fires even when flush_interval exceeds
    the root lease: an idle stretch must not let the aggregator's lease
    lapse and the next window land evicted."""
    root = root_server("port", lease_s=0.5)
    agg = aggregator("port", root.endpoint, init=[np.zeros(3, np.float32)],
                     fan_in=1, flush_interval=10.0)
    try:
        with client("port", agg.endpoint, worker_id=0) as c:
            _, u = c.join()
            assert c.commit([np.ones(3, np.float32)], u).applied
            time.sleep(1.6)  # > 3 lease periods of worker silence
            _, u = c.pull()
            assert c.commit([np.ones(3, np.float32)], u).applied
        wait_for(lambda: agg.forwarded + agg.lost_windows >= 2)
    finally:
        agg.close()
        root.close()
    assert agg.lost_windows == 0
    assert agg.forwarded == 2 and root.evictions == 0


def test_hier_lost_window_is_counted_not_swallowed():
    telemetry.reset()
    root = root_server("port")
    agg = AggregatorServer(upstream=root.endpoint, device="cpu",
                           init=[np.zeros(3, np.float32)], fan_in=8,
                           flush_interval=30.0, timeout=0.2, retries=1,
                           backoff=0.01).start()
    try:
        with client("port", agg.endpoint, worker_id=0) as c:
            _, u = c.join()
            assert c.commit([np.ones(3, np.float32)], u).applied
    finally:
        root.close()  # the root dies with the window still open
        agg.close()
    assert agg.lost_windows == 1 and agg.forwarded == 0
    assert agg.absorbed == 1 and agg.lost_commits == 1
    lost = [e for e in telemetry.get().events()
            if e["kind"] == "netps_lost_window"]
    assert [e["windows"] for e in lost] == [[[0, 0]]]
    telemetry.reset()


def test_set_fan_in_flushes_a_now_satisfied_window():
    root = root_server("port", center=[np.zeros(3, np.float32)])
    agg = aggregator("port", root.endpoint, fan_in=8, flush_interval=3600.0)
    try:
        with client("port", agg.endpoint, worker_id=0) as c:
            _, u = c.join()
            assert c.commit([np.ones(3, np.float32)], u).applied
            time.sleep(0.2)
            assert agg.forwarded == 0 and agg._acc_count == 1
            agg.set_fan_in(1)
            assert wait_for(lambda: agg.forwarded == 1)
    finally:
        agg.close()
        root.close()
    np.testing.assert_array_equal(root.center()[0], 1.0)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_durable_aggregator_keeps_dedup_and_readopts_the_root(tmp_path, pkg,
                                                              monkeypatch):
    """Journaling by the absorb cursor; a restarted aggregator resumes the
    cursor, dedups its children's retransmits, and serves the root's
    center (not the replayed journal). The same script in each package
    gives the same outcome; the port's restart folds no journal record."""
    from distkeras_tpu_torch.netps import fold as port_fold

    replay_folds = []
    real_fold_delta = port_fold.fold_delta
    monkeypatch.setattr(port_fold, "fold_delta", lambda *a, **kw: (
        replay_folds.append(1), real_fold_delta(*a, **kw))[1])
    root = root_server(pkg, center=[np.zeros(4, np.float32)])
    sdir = str(tmp_path / "agg")
    try:
        agg = aggregator(pkg, root.endpoint, fan_in=8,
                         flush_interval=3600.0, state_dir=sdir)
        with client(pkg, agg.endpoint, worker_id=0) as c:
            _, u = c.join()
            for _ in range(2):
                assert c.commit([np.full(4, 2.0, np.float32)], u).applied
        agg.close()  # the final flush lands both absorbs at the root
        agg2 = aggregator(pkg, root.endpoint, fan_in=8,
                          flush_interval=3600.0, state_dir=sdir)
        try:
            assert agg2._absorbs == 2 and agg2._last_seq == {0: 1}
            if pkg == "port":
                assert agg2.recovered_records == 0 and not replay_folds
            with client(pkg, agg2.endpoint, worker_id=0) as c:
                c.join()
                hdr, _ = c._rpc("commit", {"seq": 1, "pulled": 1},
                                [np.ones(4, np.float32)])
                assert hdr["duplicate"] is True
            got = agg2.center()
        finally:
            agg2.close()
        np.testing.assert_array_equal(got[0], 4.0)
        np.testing.assert_array_equal(root.center()[0], 4.0)
        assert len(root.commit_log) == 1
    finally:
        root.close()


# ---------------------------------------------------------------------------
# Trainers through the aggregator
# ---------------------------------------------------------------------------

def test_hier_trainer_over_shm_converges(monkeypatch):
    """ADAG over the networked PS with DKTPU_NET_HIER=1 and the shm ring:
    the worker loop joins the per-host aggregator, the root sees only its
    combined commits, training converges."""
    from distkeras_tpu_torch import ADAG
    from distkeras_tpu_torch.data import DataFrame
    from distkeras_tpu_torch.models.base import Model
    from distkeras_tpu_torch.models.mlp import MLP

    monkeypatch.setenv("DKTPU_NET_TIMEOUT", "2.0")
    monkeypatch.setenv("DKTPU_NET_HIER", "1")
    monkeypatch.setenv("DKTPU_NET_TRANSPORT", "shm")
    telemetry.reset()
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=4.0, size=(3, 4))
    y = rng.integers(0, 3, size=512)
    x = (centers[y] + rng.normal(scale=0.5, size=(512, 4))
         ).astype(np.float32)
    df = DataFrame({"features": x, "label": y.astype(np.int32)})
    model = Model.build(MLP(hidden=(16,), num_outputs=3, in_features=4),
                        np.zeros((1, 4), np.float32), device="cpu")
    srv = root_server("port", transport="shm")
    try:
        t = ADAG(model, loss="sparse_categorical_crossentropy",
                 num_workers=2, batch_size=16, num_epoch=2,
                 learning_rate=0.1, communication_window=4,
                 remote=srv.endpoint)
        trained = t.train(df, shuffle=True)
        acc = float((trained.predict(x).argmax(-1).numpy() == y).mean())
        assert acc > 0.85, acc
        assert srv.members() == []  # the aggregator left cleanly
        wids = {wid for wid, _s, _t in srv.commit_log}
        assert len(wids) == 1, wids
        snap = telemetry.get().snapshot()
        assert snap["counters"]["netps.hier.worker_commits"] >= \
            snap["counters"]["netps.hier.combined_commits"]
    finally:
        srv.close()
        telemetry.reset()
