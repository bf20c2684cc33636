"""The port's parameter server and client (``distkeras_tpu_torch/netps``)
on the CPU (``device="cpu"``: the fold's plain twin), adapted from the JAX
package's ``tests/test_netps.py`` happy-path and membership cases, and held
to the JAX package across the wire: a JAX client against a port server, a
port client against a JAX server, one fixed commit stream through both
servers (bit-identical centers, equal commit logs), and the exactly-once
case through the port's ``ChaosProxy``."""

import threading
import time

import numpy as np
import pytest

from distkeras_tpu.netps import PSClient as JaxPSClient
from distkeras_tpu.netps import PSServer as JaxPSServer
from distkeras_tpu_torch.netps import (
    ChaosProxy,
    PSClient,
    PSServer,
    ServerClosedError,
    ServerDrainingError,
    commit_scale,
    fold_delta,
)
from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.ops.kernels import fold as K
from distkeras_tpu_torch.resilience.faults import FaultPlan

FAST = dict(timeout=1.0, retries=3, backoff=0.01)


def make_server(**kw):
    kw.setdefault("discipline", "adag")
    kw.setdefault("device", "cpu")
    return PSServer(**kw).start()


def leaves(*shapes):
    rng = np.random.default_rng(0)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def wait_evicted(srv, timeout=5.0):
    deadline = time.monotonic() + timeout
    while srv.members() and time.monotonic() < deadline:
        time.sleep(0.05)  # the monitor evicts once the lease lapses


def test_join_pull_commit_heartbeat_leave_roundtrip():
    srv = make_server()
    try:
        with PSClient(srv.endpoint, worker_id=0, **FAST) as c:
            init = leaves((3, 2), (4,))
            center, upd = c.join(init=init)
            assert upd == 0
            for a, b in zip(center, init):
                np.testing.assert_array_equal(a, b)
            res = c.commit([np.ones_like(a) for a in init], upd)
            assert res.applied and not res.duplicate and not res.evicted
            assert res.staleness == 0
            center2, upd2 = c.pull()
            assert upd2 == 1
            np.testing.assert_allclose(center2[0], init[0] + 1.0)
            assert c.heartbeat() == 1
            assert c.stats()["fold_backend"] == "torch-cpu"
            c.leave()
        assert srv.commit_log == [(0, 0, 0)]
        assert srv.members() == []
    finally:
        srv.close()


def test_second_join_adopts_existing_center_and_assigns_ids():
    srv = make_server()
    try:
        with PSClient(srv.endpoint, worker_id=0, **FAST) as c0:
            init = leaves((4,))
            c0.join(init=init)
            with PSClient(srv.endpoint, **FAST) as c1:  # no worker_id
                other = [np.full(4, 9.0, np.float32)]
                center, _upd = c1.join(init=other)  # late init is ignored
                assert c1.worker_id == 1
                np.testing.assert_array_equal(center[0], init[0])
        assert srv.members() == [0, 1]
    finally:
        srv.close()


def test_join_without_init_on_empty_server_is_typed_error():
    srv = make_server()
    try:
        with PSClient(srv.endpoint, worker_id=0, **FAST) as c:
            with pytest.raises(Exception, match="uninitialized"):
                c.join()
    finally:
        srv.close()


def test_staleness_matches_counter_semantics():
    """DynSGD's staleness = server updates since the committer's pull;
    the commit folds at 1/(staleness+1)."""
    srv = make_server(discipline="dynsgd")
    try:
        with PSClient(srv.endpoint, worker_id=0, **FAST) as a, \
                PSClient(srv.endpoint, worker_id=1, **FAST) as b:
            _, upd_a = a.join(init=[np.zeros(2, np.float32)])
            _, upd_b = b.join()
            assert a.commit([np.ones(2, np.float32)], upd_a).staleness == 0
            assert b.commit([np.ones(2, np.float32)], upd_b).staleness == 1
            center, _ = a.pull()
            np.testing.assert_allclose(center[0], 1.0 + 0.5)
        assert [s for (_w, _q, s) in srv.commit_log] == [0, 1]
        assert commit_scale("dynsgd", 3) == pytest.approx(0.25)
    finally:
        srv.close()


def test_compressed_commits_fold_through_the_twin_on_a_cpu_center():
    srv = make_server(discipline="adag")
    try:
        with PSClient(srv.endpoint, worker_id=0, compress="int8",
                      **FAST) as c:
            _, upd = c.join(init=[np.zeros(5, np.float32)])
            assert c.codec == "int8"
            before = K.launch_counts()
            assert c.commit([np.full(5, 0.5, np.float32)], upd).applied
            assert K.launch_counts() == before  # CPU center: no kernel
            np.testing.assert_allclose(srv.center()[0], 0.5, rtol=1e-6)
    finally:
        srv.close()


def test_malformed_commits_answer_typed_and_fold_nothing():
    srv = make_server()
    try:
        with PSClient(srv.endpoint, worker_id=0, **FAST) as c:
            _, upd = c.join(init=[np.zeros(3, np.float32)])
            with pytest.raises(Exception, match="protocol"):
                c._rpc("commit", {"seq": 7, "pulled": upd},
                       [np.zeros(4, np.float32)])  # wrong size
            with pytest.raises(Exception, match="codec"):
                c._rpc("commit", {"seq": 8, "pulled": upd},
                       [(np.zeros(3, np.int8), {"codec": "zstd"})])
        assert srv.commit_log == [] and srv.updates == 0
    finally:
        srv.close()


def test_lease_eviction_and_mid_run_rejoin():
    srv = make_server(lease_s=0.3)
    try:
        c = PSClient(srv.endpoint, worker_id=0, **FAST)
        _, upd = c.join(init=[np.zeros(3, np.float32)])
        assert c.commit([np.ones(3, np.float32)], upd).applied
        wait_evicted(srv)
        assert srv.members() == [] and srv.evictions == 1
        center, _upd = c.pull()  # transparently re-joins
        assert c.rejoin_count == 1 and srv.rejoins == 1
        assert srv.members() == [0]
        np.testing.assert_allclose(center[0], 1.0)
        c.close()
    finally:
        srv.close()


def test_evicted_commit_is_discarded_and_reports_evicted():
    srv = make_server(lease_s=0.3)
    try:
        c = PSClient(srv.endpoint, worker_id=0, **FAST)
        _, upd = c.join(init=[np.zeros(3, np.float32)])
        wait_evicted(srv)
        res = c.commit([np.ones(3, np.float32)], upd)
        assert res.evicted and not res.applied
        assert srv.commit_log == []          # the stale window was discarded
        assert srv.members() == [0]          # ...and the client re-joined
        c.close()
    finally:
        srv.close()


def test_pre_eviction_retransmit_still_deduped_after_rejoin():
    srv = make_server(lease_s=0.3)
    try:
        c = PSClient(srv.endpoint, worker_id=0, **FAST)
        _, upd = c.join(init=[np.zeros(3, np.float32)])
        assert c.commit([np.ones(3, np.float32)], upd).applied
        wait_evicted(srv)
        c.pull()  # rejoin
        hdr, _ = c._rpc("commit", {"seq": 0, "pulled": 0},
                        [np.ones(3, np.float32)])
        assert hdr["duplicate"] is True
        assert srv.commit_log == [(0, 0, 0)]
        c.close()
    finally:
        srv.close()


def test_administrative_lease_revocation_evicts_now():
    srv = make_server(lease_s=60.0)
    try:
        c = PSClient(srv.endpoint, worker_id=0, **FAST)
        _, upd = c.join(init=[np.zeros(3, np.float32)])
        assert c.commit([np.ones(3, np.float32)], upd).applied
        assert srv.revoke(0) is True
        assert srv.members() == [] and srv.evictions == 1
        assert srv.revoke(0) is False
        res = c.commit([np.ones(3, np.float32)], upd)
        assert res.evicted and not res.applied
        _, upd = c.pull()
        assert c.commit([np.ones(3, np.float32)], upd).applied
        assert [seq for (_w, seq, _s) in srv.commit_log] == [0, 2]
        c.close()
    finally:
        srv.close()


def test_restarted_worker_resumes_commit_sequence():
    srv = make_server()
    try:
        with PSClient(srv.endpoint, worker_id=0, **FAST) as c1:
            _, upd = c1.join(init=[np.zeros(3, np.float32)])
            for _ in range(3):
                _, upd = c1.pull()
                assert c1.commit([np.ones(3, np.float32)], upd).applied
        with PSClient(srv.endpoint, worker_id=0, **FAST) as c2:
            _, upd = c2.join()
            res = c2.commit([np.ones(3, np.float32)], upd)
            assert res.applied and not res.duplicate, res
        assert [seq for (_w, seq, _s) in srv.commit_log] == [0, 1, 2, 3]
        np.testing.assert_allclose(srv.center()[0], 4.0)
    finally:
        srv.close()


def test_drain_rejects_commits_typed_but_serves_final_pull():
    srv = make_server()
    c = PSClient(srv.endpoint, worker_id=0, **FAST)
    try:
        _, upd = c.join(init=[np.zeros(3, np.float32)])
        c.commit([np.ones(3, np.float32)], upd)
        srv.drain()
        with pytest.raises(ServerDrainingError):
            c.commit([np.ones(3, np.float32)], upd)
        center, _ = c.pull()
        np.testing.assert_allclose(center[0], 1.0)
        with pytest.raises(ServerDrainingError):
            PSClient(srv.endpoint, worker_id=9, **FAST).join(
                init=[np.zeros(3, np.float32)])
    finally:
        c.close()
        srv.close()


def test_close_joins_every_server_thread():
    before = {t.name for t in threading.enumerate()}
    srv = make_server()
    with PSClient(srv.endpoint, worker_id=0, **FAST) as c:
        c.join(init=[np.zeros(2, np.float32)])
        assert any(t.name.startswith("netps-")
                   for t in threading.enumerate())
    srv.close()
    after = {t.name for t in threading.enumerate()}
    lingering = [n for n in after - before if n.startswith("netps-")]
    assert not lingering, lingering


def test_client_use_after_close_is_typed():
    srv = make_server()
    try:
        c = PSClient(srv.endpoint, worker_id=0, **FAST)
        c.join(init=[np.zeros(2, np.float32)])
        c.close()
        with pytest.raises(ServerClosedError):
            c.pull()
    finally:
        srv.close()


def test_server_without_a_card_raises_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PSServer(discipline="adag")


def test_telemetry_counters_recorded():
    from distkeras_tpu_torch import telemetry

    telemetry.reset()
    srv = make_server()
    try:
        with PSClient(srv.endpoint, worker_id=0, compress="bf16",
                      **FAST) as c:
            _, upd = c.join(init=[np.zeros(2, np.float32)])
            c.commit([np.ones(2, np.float32)], upd)
            c._rpc("commit", {"seq": 0, "pulled": upd},
                   [np.ones(2, np.float32)])  # a retransmit: deduped
            c.pull()
        snap = telemetry.get().snapshot()
        assert snap["counters"]["netps.commits"] == 1
        assert snap["counters"]["netps.commits_deduped"] == 1
        assert snap["counters"]["netps.bytes_sent"] > 0
        assert snap["counters"]["netps.bytes_received"] > 0
        assert snap["counters"]["netps.bytes_precompress"] == 8
        assert snap["gauges"]["netps.fold.tensors_per_sec"]["value"] > 0
        assert snap["spans"]["netps.server.commit"]["count"] == 2
    finally:
        srv.close()
        telemetry.reset()


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------

def test_jax_client_against_port_server():
    srv = make_server(discipline="dynsgd")
    try:
        with JaxPSClient(srv.endpoint, worker_id=0, compress="int8",
                         **FAST) as c:
            init = leaves((3, 2), (4,))
            _, upd = c.join(init=init)
            assert c.codec == "int8" and c.active_shards == 1
            assert c.shm_info is None and c.mesh_info is None
            res = c.commit([np.full_like(a, 0.25) for a in init], upd)
            assert res.applied and res.staleness == 0
            center, upd2 = c.pull()
            assert upd2 == 1
            np.testing.assert_allclose(center[0], init[0] + 0.25, atol=1e-2)
            assert c.stats()["fold_backend"] == "torch-cpu"
        assert srv.commit_log == [(0, 0, 0)]
    finally:
        srv.close()


def test_port_client_against_jax_server():
    srv = JaxPSServer(discipline="dynsgd").start()
    try:
        with PSClient(srv.endpoint, worker_id=0, compress="bf16",
                      **FAST) as c:
            init = leaves((3, 2), (4,))
            _, upd = c.join(init=init)
            assert c.codec == "bf16"
            assert c.commit([np.full_like(a, 0.5) for a in init],
                            upd).applied
            center, upd2 = c.pull()
            assert upd2 == 1
            np.testing.assert_allclose(center[1], init[1] + 0.5, rtol=1e-2)
            c.leave()
        assert srv.commit_log == [(0, 0, 0)]
    finally:
        srv.close()


def _fixed_stream(endpoint: str, codec: str) -> None:
    """Two workers, three rounds each, interleaved so DynSGD sees
    staleness 0 and 1; the same deltas (and so the same wire bytes,
    error-feedback residual included) whichever server listens."""
    rng = np.random.default_rng(7)
    shapes = [(33, 5), (70,), (4, 4)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    a = PSClient(endpoint, worker_id=0, compress=codec, **FAST)
    b = PSClient(endpoint, worker_id=1, compress=codec, **FAST)
    try:
        a.join(init=init)
        b.join()
        for _ in range(3):
            _, ua = a.pull()
            _, ub = b.pull()
            for c, u in ((a, ua), (b, ub)):
                delta = [(rng.normal(size=s) * 0.01).astype(np.float32)
                         for s in shapes]
                assert c.commit(delta, u).applied
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("codec", ["none", "int8", "bf16"])
@pytest.mark.parametrize("discipline", ["downpour", "adag", "dynsgd"])
def test_fixed_commit_stream_gives_bit_identical_centers(codec, discipline):
    jsrv = JaxPSServer(discipline=discipline).start()
    tsrv = make_server(discipline=discipline)
    try:
        _fixed_stream(jsrv.endpoint, codec)
        _fixed_stream(tsrv.endpoint, codec)
        assert tsrv.commit_log == jsrv.commit_log
        assert [s for (_w, _q, s) in tsrv.commit_log] == [0, 1] * 3
        for t, j in zip(tsrv.center(), jsrv.center()):
            np.testing.assert_array_equal(t, j)
    finally:
        jsrv.close()
        tsrv.close()


def test_retried_commit_after_dropped_ack_folds_exactly_once():
    """The server applies the commit, the ACK is lost (chaos ``drop_r``
    in the port's proxy), the port client retransmits the SAME seq and the
    port server answers duplicate — one fold."""
    srv = make_server(discipline="downpour")
    px = ChaosProxy(srv.endpoint, plan=FaultPlan.parse_net("drop_r@1")).start()
    c = PSClient(px.endpoint, worker_id=0, timeout=0.3, retries=4,
                 backoff=0.01)
    try:
        _, upd = c.join(init=[np.zeros(3, np.float32)])
        res = c.commit([np.ones(3, np.float32)], upd)
        assert res.duplicate and not res.applied  # answered by the dedup
        assert srv.commit_log == [(0, 0, 0)], srv.commit_log
        np.testing.assert_allclose(srv.center()[0], 1.0)  # folded ONCE
    finally:
        c.close()
        px.close()
        srv.close()


def test_port_fold_delta_is_the_server_fold():
    import torch

    center = [torch.zeros(4)]
    fold_delta(center, [np.full(4, 2.0, np.float32)], "dynsgd", staleness=1)
    np.testing.assert_allclose(center[0].numpy(), 1.0)
    assert wire.CAPS == {"codecs": ["none", "bf16", "int8"],
                         "striping": True, "replication": True,
                         "serving": True, "sharding": True,
                         "shm": True, "mesh": True, "tree": True,
                         "tuner": True, "tracing": True}
