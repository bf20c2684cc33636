"""The port's same-host shared-memory ring (``netps/shm.py``), mirrored from
the JAX package's ``tests/test_netps_shm.py`` where no unported item is
needed (no fault plan, no striping, no aggregator): dialect negotiation
and its fallback matrix, exactly-once and leases on the ring, the slot's
fd and close contracts; then both packages held to each other over the
ring, both ways, with centers bit-equal to the numpy oracle, and one run
against the port's CLI server in another process."""

import os
import socket as pysock
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from distkeras_tpu.netps import PSClient as JaxPSClient
from distkeras_tpu.netps import PSServer as JaxPSServer
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import PSClient, PSServer, shm, wire
from distkeras_tpu_torch.netps.errors import NetPSError
from distkeras_tpu_torch.netps.fold import fold_compressed_numpy

FAST = dict(timeout=1.0, retries=3, backoff=0.01)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def leaves(*shapes):
    rng = np.random.default_rng(0)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def server(**kw):
    kw.setdefault("discipline", "adag")
    kw.setdefault("transport", "shm")
    return PSServer(device="cpu", **kw).start()


def shm_pair(**kw):
    srv = server(discipline=kw.pop("discipline", "adag"),
                 lease_s=kw.pop("lease_s", None))
    return srv, PSClient(srv.endpoint, worker_id=0, transport="shm",
                         **dict(FAST, **kw))


def kill_ring(c, uds="/nonexistent-dknetps.sock"):
    """The ring's endpoint dies: the live ring is dropped and the
    negotiated doorbell points at a socket nobody serves."""
    c._disconnect()
    c.shm_info = dict(c.shm_info, uds=uds)


# ---------------------------------------------------------------------------
# Negotiation + roundtrip
# ---------------------------------------------------------------------------

def test_shm_join_pull_commit_roundtrip_and_transport_label():
    telemetry.reset()
    srv, c = shm_pair()
    try:
        init = leaves((3, 2), (4,))
        center, upd = c.join(init=init)
        assert c.active_transport == "shm"
        for a, b in zip(center, init):
            np.testing.assert_array_equal(a, b)
        res = c.commit([np.ones_like(a) for a in init], upd)
        assert res.applied and res.staleness == 0
        center2, upd2 = c.pull()
        assert upd2 == 1
        np.testing.assert_allclose(center2[0], init[0] + 1.0)
        assert c.heartbeat() == 1
        snap = telemetry.get().snapshot()
        # The join went over TCP (negotiation precedes the upgrade); the
        # rest carries the dialect, on both sides.
        assert snap["spans"]["netps.rpc.commit.shm"]["count"] == 1
        assert snap["spans"]["netps.server.commit.shm"]["count"] == 1
        assert snap["spans"]["netps.rpc.join"]["count"] == 1
        assert snap["gauges"]["netps.fold.tensors_per_sec"]["value"] > 0
        c.leave()
    finally:
        c.close()
        srv.close()
        telemetry.reset()


def test_shm_retransmit_is_deduped():
    srv, c = shm_pair()
    try:
        _, upd = c.join(init=[np.zeros(3, np.float32)])
        assert c.commit([np.ones(3, np.float32)], upd).applied
        hdr, _ = c._rpc("commit", {"seq": 0, "pulled": 0},
                        [np.ones(3, np.float32)])
        assert hdr["duplicate"] is True
        assert srv.commit_log == [(0, 0, 0)]
        np.testing.assert_allclose(srv.center()[0], 1.0)
    finally:
        c.close()
        srv.close()


# ---------------------------------------------------------------------------
# The fallback matrix: everything else lands on TCP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("peer", ["tcp_server", "old_caps"])
def test_new_client_old_server_falls_back_to_tcp(monkeypatch, peer):
    """A server that serves no ring (a tcp one, or one of a build whose
    caps have no shm endpoint): the shm client speaks TCP with every
    guarantee."""
    if peer == "old_caps":
        monkeypatch.setattr(wire, "CAPS",
                            {"codecs": list(wire.CODECS),
                             "replication": True})
    srv = server(transport="tcp")
    try:
        with PSClient(srv.endpoint, worker_id=0, transport="shm",
                      **FAST) as c:
            init = leaves((8,))
            _, upd = c.join(init=init)
            assert c.active_transport == "tcp" and c.shm_info is None
            assert c.commit([np.ones(8, np.float32)], upd).applied
            center, _ = c.pull()
            np.testing.assert_allclose(center[0], init[0] + 1.0)
    finally:
        srv.close()


def test_old_client_new_server_stays_on_tcp():
    srv = server()
    try:
        with PSClient(srv.endpoint, worker_id=0, transport="tcp",
                      **FAST) as c:
            _, upd = c.join(init=leaves((8,)))
            assert c.active_transport == "tcp"
            assert c.commit([np.ones(8, np.float32)], upd).applied
    finally:
        srv.close()


def test_cross_host_boot_id_mismatch_falls_back_to_tcp(monkeypatch):
    srv = server()
    # The server read its boot id at construction; this patches only what
    # the CLIENT computes for the check.
    monkeypatch.setattr(shm, "local_boot_id", lambda: "some-other-host")
    try:
        with PSClient(srv.endpoint, worker_id=0, transport="shm",
                      **FAST) as c:
            init = leaves((8,))
            _, upd = c.join(init=init)
            assert c.active_transport == "tcp" and c.shm_info is None
            assert c.commit([np.ones(8, np.float32)], upd).applied
            center, _ = c.pull()
            np.testing.assert_allclose(center[0], init[0] + 1.0)
    finally:
        srv.close()


def test_invisible_uds_path_falls_back_to_tcp(monkeypatch):
    """Colocated containers share a boot id, not a mount namespace."""
    srv = server()
    monkeypatch.setattr(shm, "endpoint_visible", lambda path: False)
    try:
        with PSClient(srv.endpoint, worker_id=0, transport="shm",
                      **FAST) as c:
            _, upd = c.join(init=leaves((8,)))
            assert c.active_transport == "tcp" and c.shm_info is None
            assert c.commit([np.ones(8, np.float32)], upd).applied
    finally:
        srv.close()


def test_dead_ring_endpoint_falls_back_to_tcp():
    """After two ring failures in a row the call falls back to TCP, which
    the server always serves, within the retry budget."""
    telemetry.reset()
    srv, c = shm_pair(timeout=0.3, retries=4)
    try:
        _, upd = c.join(init=[np.zeros(3, np.float32)])
        assert c.active_transport == "shm"
        kill_ring(c, c.shm_info["uds"] + ".gone")
        center, _ = c.pull()
        np.testing.assert_array_equal(center[0], np.zeros(3))
        assert c.active_transport == "tcp"
        assert telemetry.get().counter("netps.shm_fallbacks").value == 1
    finally:
        c.close()
        srv.close()
        telemetry.reset()


def test_dead_ring_with_zero_retries_falls_back_on_next_rpc():
    """A fail-fast client (retries=0) must not ride a dead ring forever:
    its only attempt engages the fallback, so THIS rpc fails and the next
    lands on TCP."""
    srv, c = shm_pair(retries=0, timeout=0.5)
    try:
        c.join(init=[np.zeros(3, np.float32)])
        c.pull()
        assert c.active_transport == "shm"
        kill_ring(c)
        with pytest.raises(NetPSError):
            c.pull()
        assert c.shm_info is None
        center, _ = c.pull()
        assert c.active_transport == "tcp"
        np.testing.assert_array_equal(center[0], np.zeros(3))
    finally:
        c.close()
        srv.close()


def test_unknown_transport_is_typed_error(monkeypatch):
    with pytest.raises(ValueError, match="transport"):
        PSClient("h:1", transport="carrier-pigeon")
    with pytest.raises(ValueError, match="transport"):
        PSServer(transport="carrier-pigeon", device="cpu")
    monkeypatch.setenv("DKTPU_NET_TRANSPORT", "carrier-pigeon")
    with pytest.raises(ValueError, match="DKTPU_NET_TRANSPORT"):
        shm.transport_mode()


# ---------------------------------------------------------------------------
# Leases, close, concurrency on the ring
# ---------------------------------------------------------------------------

def test_shm_lease_eviction_and_rejoin():
    srv, c = shm_pair(lease_s=0.3)
    try:
        _, upd = c.join(init=[np.zeros(3, np.float32)])
        assert c.commit([np.ones(3, np.float32)], upd).applied
        deadline = time.monotonic() + 5.0
        while srv.members() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert srv.members() == [] and srv.evictions == 1
        center, _ = c.pull()  # re-joins transparently, still on the ring
        assert c.rejoin_count == 1 and srv.rejoins == 1
        assert c.active_transport == "shm"
        np.testing.assert_allclose(center[0], 1.0)
    finally:
        c.close()
        srv.close()


def test_shm_close_joins_every_thread():
    before = {t.name for t in threading.enumerate()}
    srv, c = shm_pair()
    c.join(init=[np.zeros(2, np.float32)])
    c.pull()
    uds_dir = os.path.dirname(srv._uds_path)
    c.close()
    srv.close()
    after = {t.name for t in threading.enumerate()}
    lingering = [n for n in after - before if n.startswith("netps-")]
    assert not lingering, lingering
    assert not os.path.exists(uds_dir)  # the doorbell's directory is gone


def test_concurrent_shm_clients_isolated_and_one_ring_dies_mid_call():
    """Two clients on one server's ring: each owns its slot pair, so their
    concurrent commits never interleave inside a frame (the center is the
    exact sum of both streams); and when ONE client's ring dies mid-call,
    that client alone falls back to TCP."""
    srv = server(discipline="downpour")
    c0 = PSClient(srv.endpoint, worker_id=0, transport="shm", **FAST)
    c1 = PSClient(srv.endpoint, worker_id=1, transport="shm", **FAST)
    try:
        init = [np.zeros(5, np.float32)]
        _, upd0 = c0.join(init=init)
        _, upd1 = c1.join(init=init)
        assert c0.active_transport == c1.active_transport == "shm"
        commits_each = 8
        errs: list = []

        def pump(client, upd, delta):
            try:
                u = upd
                for _ in range(commits_each):
                    assert client.commit([np.full(5, delta, np.float32)],
                                         u).applied
                    _, u = client.pull()
            except Exception as e:  # noqa: BLE001 - surfaced below
                errs.append(e)

        threads = [threading.Thread(target=pump, args=(c0, upd0, 1.0)),
                   threading.Thread(target=pump, args=(c1, upd1, 10.0))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs
        center, _ = c0.pull()
        np.testing.assert_allclose(center[0], commits_each * 11.0)
        assert {wid for wid, _s, _t in srv.commit_log} == {0, 1}
        kill_ring(c0)
        center0, _ = c0.pull()  # retried onto TCP inside the budget
        assert c0.active_transport == "tcp"
        np.testing.assert_allclose(center0[0], 88.0)
        center1, _ = c1.pull()
        assert c1.active_transport == "shm"
        np.testing.assert_allclose(center1[0], 88.0)
    finally:
        c0.close()
        c1.close()
        srv.close()


def test_accept_attach_closes_fds_when_slot_ctor_raises(monkeypatch):
    """A Slot constructor failure mid-attach (mmap ENOMEM) closes BOTH
    received fds: each failed attach would otherwise leak 2 fds and a
    mapping until the server hits EMFILE."""
    a, b = pysock.socketpair(pysock.AF_UNIX, pysock.SOCK_STREAM)
    s1, s2 = shm.create_slot(), shm.create_slot()
    try:
        pysock.send_fds(a, [b"DKATTACH"], [s1.fd, s2.fd])
        real = shm.Slot
        calls = []

        def second_ctor_raises(fd, size=None):
            if calls:
                raise OSError("synthetic ENOMEM")
            calls.append(1)
            return real(fd, size)

        monkeypatch.setattr(shm, "Slot", second_ctor_raises)
        before = len(os.listdir("/proc/self/fd"))
        with pytest.raises(OSError):
            shm.accept_attach(b)
        assert len(os.listdir("/proc/self/fd")) == before
    finally:
        s1.close()
        s2.close()
        a.close()
        b.close()


def test_slot_ops_after_close_raise_retryable_taxonomy():
    """A fallback sweep closes a ring another thread may be using: ops on a
    closed slot raise ConnectionError (retried), never mmap's ValueError."""
    slot = shm.create_slot()
    slot.write_frame(wire.KIND_REQUEST, {"op": "x"})
    slot.close()
    slot.close()  # idempotent
    with pytest.raises(ConnectionError):
        slot.write_frame(wire.KIND_REQUEST, {"op": "x"})
    with pytest.raises(ConnectionError):
        slot.read_frame(wire.PREFIX_SIZE + 8)


def test_slot_round_trip_grows_and_rejects_a_torn_frame():
    """A frame larger than the initial segment grows it (writer ftruncate,
    reader remap); the payload is not checksummed but the header is, and
    an odd seqlock reads as torn."""
    from distkeras_tpu_torch.netps.errors import ProtocolError

    w = shm.create_slot()
    r = shm.Slot(os.dup(w.fd))
    try:
        big = np.arange(100_000, dtype=np.float32)
        n = w.write_frame(wire.KIND_REPLY, {"op": "pull"}, [big])
        kind, nbytes, hdr, arrays = r.read_frame(n)
        assert (kind, nbytes, hdr["op"]) == (wire.KIND_REPLY, n, "pull")
        np.testing.assert_array_equal(arrays[0], big)
        wire.U32.pack_into(w._mm, wire.SHM_SEQ_OFF, 3)
        with pytest.raises(ProtocolError, match="torn"):
            r.read_frame(n)
    finally:
        w.close()
        r.close()


def test_shm_upgrade_is_not_counted_as_reconnect():
    """The routine post-join TCP -> ring upgrade lands in
    ``netps.shm_upgrades``, not ``netps.reconnects`` (failure evidence);
    a ring re-attach after a dropped ring still counts as a reconnect."""
    telemetry.reset()
    srv, c = shm_pair()
    try:
        _, upd = c.join(init=[np.zeros(3, np.float32)])
        c.pull()  # the first ring attach is the upgrade
        snap = telemetry.get().snapshot()["counters"]
        assert snap.get("netps.reconnects", 0) == 0
        assert snap["netps.shm_upgrades"] == 1
        c._disconnect()  # the ring drops; the next RPC re-attaches
        assert c.commit([np.ones(3, np.float32)], upd).applied
        snap = telemetry.get().snapshot()["counters"]
        assert snap["netps.reconnects"] == 1
        assert snap["netps.shm_upgrades"] == 1
        assert c.active_transport == "shm"
    finally:
        c.close()
        srv.close()
        telemetry.reset()


# ---------------------------------------------------------------------------
# The two packages over one ring, both ways
# ---------------------------------------------------------------------------

CODEC_STREAM = ("none", "bf16", "int8", "int8", "none")


def _stream(n_commits=len(CODEC_STREAM)):
    rng = np.random.default_rng(5)
    init = [rng.normal(size=(7, 3)).astype(np.float32),
            rng.normal(size=(11,)).astype(np.float32)]
    deltas = [[rng.normal(scale=0.1, size=a.shape).astype(np.float32)
               for a in init] for _ in range(n_commits)]
    return init, deltas


def _oracle(init, deltas, scale=1.0):
    """Each commit encoded as the client sends it, folded by the numpy
    oracle (the plain f32 entries as ``c + f32(scale) * d``)."""
    center = [a.copy() for a in init]
    for codec, delta in zip(CODEC_STREAM, deltas):
        for c, d in zip(center, delta):
            q, spec = wire.codec_encode(d, codec)
            if spec:
                fold_compressed_numpy(c, q, spec, scale)
            else:
                c += np.float32(scale) * q
    return center


def _drive(client_cls, endpoint, init, deltas):
    """One client per codec (a client's codec is fixed at construction),
    worker 0 throughout, each on the ring."""
    upd = None
    for i, (codec, delta) in enumerate(zip(CODEC_STREAM, deltas)):
        c = client_cls(endpoint, worker_id=0, transport="shm",
                       compress=codec, **FAST)
        try:
            _, upd = c.join(init=init if i == 0 else None)
            assert c.active_transport == "shm"
            res = c.commit(delta, upd)
            assert res.applied and not res.duplicate
        finally:
            c.close()


@pytest.mark.filterwarnings("ignore:measured-bad knob combination")
def test_port_client_on_a_jax_ring_server_folds_exactly_once():
    init, deltas = _stream()
    srv = JaxPSServer(discipline="downpour", transport="shm").start()
    try:
        _drive(PSClient, srv.endpoint, init, deltas)
        assert [s for _w, s, _t in srv.commit_log] == list(
            range(len(deltas)))
        got = srv.center()
    finally:
        srv.close()
    for a, b in zip(got, _oracle(init, deltas)):
        assert a.tobytes() == b.tobytes()


@pytest.mark.filterwarnings("ignore:measured-bad knob combination")
def test_jax_client_on_a_port_ring_server_folds_exactly_once():
    init, deltas = _stream()
    srv = server(discipline="downpour")
    try:
        _drive(JaxPSClient, srv.endpoint, init, deltas)
        assert [s for _w, s, _t in srv.commit_log] == list(
            range(len(deltas)))
        got = srv.center()
    finally:
        srv.close()
    for a, b in zip(got, _oracle(init, deltas)):
        assert a.tobytes() == b.tobytes()


@pytest.mark.filterwarnings("ignore:measured-bad knob combination")
def test_ring_to_the_cli_server_in_another_process():
    """``python -m distkeras_tpu_torch.netps`` under
    ``DKTPU_NET_TRANSPORT=shm`` serves the ring to a client of another
    process on this host: the commits fold exactly once, bit-equal to the
    oracle."""
    probe = pysock.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    env = dict(os.environ, PYTHONPATH=REPO, DKTPU_NET_TRANSPORT="shm")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distkeras_tpu_torch.netps", "--host",
         "127.0.0.1", "--port", str(port), "--device", "cpu",
         "--discipline", "downpour"],
        stdout=subprocess.PIPE, env=env, text=True, cwd=REPO)
    try:
        ready = proc.stdout.readline().strip()
        assert ready.startswith("NETPS_READY "), ready
        ep = ready.split()[1]
        init, deltas = _stream()
        _drive(PSClient, ep, init, deltas)
        with PSClient(ep, transport="shm", **FAST) as observer:
            got, updates = observer.pull()
        assert updates == len(deltas)
        for a, b in zip(got, _oracle(init, deltas)):
            assert a.tobytes() == b.tobytes()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0
    assert f"commits={len(deltas)}" in out
