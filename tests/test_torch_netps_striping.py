"""Striping (``DKTPU_NET_SHARDS``) in the port's client and server on the
CPU, held to the JAX package's: one logical pull or commit split by tensors
over several connections to ONE server, which assembles a striped commit
and folds it once.

* A striped pull and commit equal an unstriped one, bit-exact, in every
  codec, on TCP, on the ring (a ring a stripe connection) and through the
  mesh dispatch.
* Exactly-once: a stripe whose ACK is dropped is retransmitted under the
  same seq and answered as a duplicate; half-assembled stripe sets are
  dropped on eviction and re-join.
* A torn striped pull (stripes from either side of a fold) is re-read and,
  after ``_PULL_CONSISTENT_TRIES`` torn reads, answered by one unstriped
  pull, counted in ``netps.pull_torn_retries``.
* Either package's striped client against the other's server, bit-exact.
"""

import numpy as np
import pytest

from distkeras_tpu.netps import PSClient as JaxPSClient
from distkeras_tpu.netps import PSServer as JaxPSServer
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import ChaosProxy, PSClient, PSServer, wire
from distkeras_tpu_torch.netps import client as client_mod
from distkeras_tpu_torch.resilience.faults import FaultPlan

FAST = dict(timeout=2.0, retries=3, backoff=0.01)
SHAPES = [(16, 8), (7,), (5, 3, 2), (40,), (3, 3)]


def leaves():
    rng = np.random.default_rng(5)
    return [rng.normal(size=s).astype(np.float32) for s in SHAPES]


def server(**kw):
    kw.setdefault("discipline", "adag")
    kw.setdefault("device", "cpu")
    return PSServer(center=leaves(), **kw).start()


def drive(client, n=4):
    """Join, then ``n`` seeded commits, each followed by a pull; returns
    the last pulled center."""
    center, counter = client.join(init=leaves())
    rng = np.random.default_rng(11)
    for _ in range(n):
        delta = [rng.normal(scale=0.1, size=np.shape(a)).astype(np.float32)
                 for a in center]
        res = client.commit(delta, counter)
        assert res.applied and not res.duplicate, res
        center, counter = client.pull()
    return center


def same_bits(a_list, b_list):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


def unstriped_run(codec="none", **kw):
    srv = server(**kw)
    try:
        with PSClient(srv.endpoint, shards=1, compress=codec, **FAST) as c:
            return drive(c), srv.center()
    finally:
        srv.close()


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
@pytest.mark.parametrize("shards", [2, 3])
def test_striped_pull_and_commit_equal_unstriped(codec, shards):
    want, want_center = unstriped_run(codec)
    srv = server()
    try:
        telemetry.reset()
        with PSClient(srv.endpoint, shards=shards, compress=codec,
                      **FAST) as c:
            got = drive(c)
            assert c.active_shards == shards
            assert sorted(i for st in c._stripes for i in st) == list(
                range(len(SHAPES)))
        assert [s for _w, s, _st in srv.commit_log] == [0, 1, 2, 3]
        same_bits(want_center, srv.center())
        spans = telemetry.get().snapshot()["spans"]
        for k in range(shards):
            assert spans[f"netps.rpc.commit.s{k}"]["count"] == 4
        # One server span a stripe request; one fold a logical commit.
        assert spans["netps.server.commit"]["count"] == 4 * shards
    finally:
        srv.close()
    same_bits(want, got)


def test_stripes_are_byte_balanced_and_deterministic():
    c = PSClient("127.0.0.1:1", shards=2, **FAST)
    c.active_shards = 2
    c._compute_stripes(leaves())
    first = c._stripes
    c._compute_stripes(leaves())
    assert c._stripes == first == [[0], [1, 2, 3, 4]]
    j = JaxPSClient("127.0.0.1:1", shards=2, **FAST)
    j.active_shards = 2
    j._compute_stripes(leaves())
    assert j._stripes == first  # the JAX client's rule
    c.close()
    j.close()


def test_a_server_without_striping_gets_unstriped_commits(monkeypatch):
    monkeypatch.setattr(wire, "CAPS", {k: v for k, v in wire.CAPS.items()
                                       if k != "striping"})
    srv = server()
    try:
        with PSClient(srv.endpoint, shards=2, **FAST) as c:
            drive(c, 2)
            assert c.active_shards == 1 and not c._striped()
    finally:
        srv.close()


def test_striped_commit_with_a_dropped_ack_folds_exactly_once():
    """The chaos proxy drops the reply to the first stripe frame; that
    stripe retransmits under the same seq and the server answers it from
    the dedup table or the stash: one fold."""
    srv = server(discipline="downpour")
    px = ChaosProxy(srv.endpoint,
                    plan=FaultPlan.parse_net("drop_r@1")).start()
    c = PSClient(px.endpoint, worker_id=0, shards=2, timeout=0.3,
                 retries=4, backoff=0.01)
    try:
        center, upd = c.join(init=leaves())
        res = c.commit([np.ones_like(a) for a in center], upd)
        assert (res.applied or res.duplicate) and not res.evicted
        assert srv.commit_log == [(0, 0, 0)], srv.commit_log
        assert not srv._pending
        for a, b in zip(srv.center(), leaves()):
            same_bits([a], [(b + np.float32(1.0)).astype(np.float32)])
    finally:
        c.close()
        px.close()
        srv.close()


def test_retransmitted_stripe_set_is_a_duplicate():
    srv = server()
    try:
        with PSClient(srv.endpoint, shards=2, **FAST) as c:
            center, upd = c.join(init=leaves())
            items = c._compress_delta([np.ones_like(a) for a in center])
            base = c._stamped({"seq": 0, "pulled": upd})
            assert c._striped_commit(dict(base), items)["applied"]
            again = c._striped_commit(dict(base), items)
            assert again["duplicate"] and not again["applied"]
        assert len(srv.commit_log) == 1
    finally:
        srv.close()


@pytest.mark.parametrize("how", ["revoke", "rejoin"])
def test_half_assembled_stripes_are_dropped(how):
    srv = server(lease_s=30.0)
    try:
        with PSClient(srv.endpoint, shards=2, **FAST) as c:
            center, upd = c.join(init=leaves())
            idx = c._stripes[0]
            hdr, _ = c._rpc(wire.OP_COMMIT, {
                "seq": 0, "pulled": upd, "shard": 0, "num_shards": 2,
                "idx": idx}, [np.ones_like(center[i]) for i in idx], 0)
            assert hdr["pending"] and not hdr["applied"]
            assert list(srv._pending) == [(c.worker_id, 0)]
            if how == "revoke":
                assert srv.revoke(c.worker_id)
            else:
                c.join()
            assert not srv._pending
            assert srv.commit_log == []
    finally:
        srv.close()


def test_torn_striped_pull_retries_then_falls_back(monkeypatch):
    """Every striped read comes back torn (the stripes' counters differ),
    so the client re-reads ``_PULL_CONSISTENT_TRIES`` times, counting each,
    then answers with one unstriped pull."""
    srv = server()
    real = srv._op_pull
    seen = []

    def torn(header):
        hdr, out = real(header)
        seen.append(header.get("idx") is not None)
        if header.get("idx") is not None:
            hdr = dict(hdr, updates=hdr["updates"] + int(header["shard"]))
        return hdr, out

    monkeypatch.setattr(srv, "_op_pull", torn)
    try:
        telemetry.reset()
        with PSClient(srv.endpoint, shards=2, **FAST) as c:
            c.join(init=leaves())
            center, upd = c.pull()
        tries = client_mod._PULL_CONSISTENT_TRIES
        assert seen == [True] * (2 * tries) + [False]
        assert telemetry.get().snapshot()["counters"][
            "netps.pull_torn_retries"] == tries
        assert upd == 0
        same_bits(center, leaves())
    finally:
        srv.close()


def test_one_torn_read_is_re_read_striped(monkeypatch):
    srv = server()
    real = srv._op_pull
    torn_once = [True]

    def torn(header):
        hdr, out = real(header)
        if header.get("idx") is not None and header["shard"] == 1 \
                and torn_once[0]:
            torn_once[0] = False
            hdr = dict(hdr, updates=hdr["updates"] + 1)
        return hdr, out

    monkeypatch.setattr(srv, "_op_pull", torn)
    try:
        telemetry.reset()
        with PSClient(srv.endpoint, shards=2, **FAST) as c:
            c.join(init=leaves())
            center, _ = c.pull()
        assert telemetry.get().snapshot()["counters"][
            "netps.pull_torn_retries"] == 1
        same_bits(center, leaves())
    finally:
        srv.close()


def test_striping_over_the_ring_is_exactly_once(monkeypatch):
    """``transport="shm"`` with 2 stripes: each stripe connection attaches
    a ring of its own, every commit goes out on the ring and is folded
    once, bit-equal to the unstriped TCP run; the advisory knob warning
    fires once."""
    monkeypatch.setattr(client_mod, "_BAD_KNOB_COMBOS_WARNED", set())
    want, _ = unstriped_run()
    srv = server(transport="shm")
    try:
        telemetry.reset()
        with pytest.warns(RuntimeWarning, match="shards>1\\+shm"):
            c = PSClient(srv.endpoint, shards=2, transport="shm", **FAST)
        try:
            got = drive(c)
            assert c.active_transport == "shm"
            assert [conn.ring is not None for conn in c._conns] == [True,
                                                                    True]
        finally:
            c.close()
        assert [s for _w, s, _st in srv.commit_log] == [0, 1, 2, 3]
        spans = telemetry.get().snapshot()["spans"]
        assert spans["netps.rpc.commit.s0.shm"]["count"] == 4
        assert spans["netps.server.commit.shm"]["count"] == 8
    finally:
        srv.close()
    same_bits(want, got)


def test_striping_through_the_mesh_dispatch_folds_once(monkeypatch):
    monkeypatch.setattr(client_mod, "_BAD_KNOB_COMBOS_WARNED", set())
    want, _ = unstriped_run()
    srv = server(transport="mesh")
    try:
        telemetry.reset()
        with pytest.warns(RuntimeWarning, match="shards>1\\+mesh"):
            c = PSClient(srv.endpoint, shards=2, transport="mesh", **FAST)
        try:
            got = drive(c)
            assert c.active_transport == "mesh"
        finally:
            c.close()
        assert len(srv.commit_log) == 4
        assert telemetry.get().snapshot()["counters"]["netps.mesh.folds"] == 4
    finally:
        srv.close()
    same_bits(want, got)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_jax_striped_client_against_a_port_server(codec):
    want, want_center = unstriped_run(codec)
    srv = server()
    try:
        c = JaxPSClient(srv.endpoint, shards=2, compress=codec, **FAST)
        try:
            got = drive(c)
            assert c.active_shards == 2
        finally:
            c.close()
        same_bits(want_center, srv.center())
        assert len(srv.commit_log) == 4
    finally:
        srv.close()
    same_bits(want, got)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_port_striped_client_against_a_jax_server(codec):
    want, _ = unstriped_run(codec)
    srv = JaxPSServer(center=leaves(), discipline="adag").start()
    try:
        with PSClient(srv.endpoint, shards=2, compress=codec, **FAST) as c:
            got = drive(c)
            assert c.active_shards == 2
        assert len(srv.commit_log) == 4
    finally:
        srv.close()
    same_bits(want, got)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_run_remote_with_stripes_is_bit_equal_to_one(codec):
    """``run_remote(shards=2)`` against the same server as
    ``run_remote(shards=1)``, one worker: the same center, bit for bit."""
    import copy

    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch.data import DataFrame, make_batches
    from distkeras_tpu_torch.netps.remote import run_remote
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer

    rng = np.random.default_rng(0)
    n = 2 * 5 * 3
    df = DataFrame({"features": rng.integers(0, 50, (n, 6)).astype(np.int32),
                    "label": rng.integers(0, 2, n).astype(np.int32)})
    plan = make_batches(df, "features", "label", 5, num_workers=1, window=2)
    model = imdb_lstm(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6,
                      device="cpu", seed=2)
    outs = []
    for shards in (1, 2):
        srv = PSServer(discipline="dynsgd", device="cpu").start()
        try:
            params, losses = run_remote(
                endpoint=srv.endpoint, model=copy.deepcopy(model),
                tx=get_optimizer("sgd", 0.1),
                loss_fn=get_loss("sparse_categorical_crossentropy"),
                plan=plan, discipline="dynsgd", window=2, shards=shards,
                compress=codec, transport="tcp")
            assert len(srv.commit_log) == plan.num_rounds
        finally:
            srv.close()
        outs.append(([v.numpy() for v in params.values()], losses))
    same_bits(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
