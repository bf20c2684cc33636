"""The port's epoch fence, warm standby and client failover
(``distkeras_tpu_torch/netps/standby.py``, ``PSServer._check_primary_locked``,
the endpoint walk) on the CPU (``device="cpu"``), adapted from the JAX
package's ``tests/test_netps_failover.py`` and held to the JAX package bit
for bit (``tobytes()`` equal): a port standby replicates a port primary
and a JAX primary, and a JAX standby replicates a port primary, at every
codec. Also the port's CLI: ``--state-dir`` across a SIGKILL, and the
second SIGTERM."""

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from distkeras_tpu.netps import PSServer as JaxPSServer
from distkeras_tpu.netps import StandbyServer as JaxStandbyServer
from distkeras_tpu_torch.netps import (
    EpochFencedError,
    NotPrimaryError,
    PSClient,
    PSServer,
    StandbyServer,
)
from distkeras_tpu_torch.netps import client as netps_client
from distkeras_tpu_torch.netps import state as netps_state
from distkeras_tpu_torch.netps import wire

FAST = dict(timeout=1.0, retries=3, backoff=0.01)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def leaves():
    rng = np.random.default_rng(7)
    return [rng.normal(size=(4, 3)).astype(np.float32),
            rng.normal(size=(8,)).astype(np.float32)]


def server(**kw):
    kw.setdefault("discipline", "adag")
    kw.setdefault("device", "cpu")
    return PSServer(**kw)


def standby(primary, **kw):
    kw.setdefault("discipline", "adag")
    kw.setdefault("device", "cpu")
    return StandbyServer(primary, **kw)


def drive_commits(endpoint, n, *, compress="none", worker_id=0, **kw):
    """Join + fold ``n`` deterministic commits; the client's final view."""
    rng = np.random.default_rng(worker_id + 1)
    c = PSClient(endpoint, worker_id=worker_id, compress=compress,
                 **dict(FAST, **kw))
    try:
        center, upd = c.join(init=leaves())
        for _ in range(n):
            delta = [rng.normal(scale=0.1, size=a.shape).astype(np.float32)
                     for a in center]
            c.commit(delta, upd)
            center, upd = c.pull()
        return center, upd
    finally:
        c.close()


def _wait(predicate, timeout=6.0, tick=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(tick)
    return False


def _raw(endpoint, header, arrays=()):
    """One request frame, sent raw; returns the reply header."""
    with socket.create_connection(wire.split_endpoint(endpoint),
                                  timeout=2.0) as s:
        wire.send_frame(s, wire.KIND_REQUEST, dict(header, req=1),
                        list(arrays))
        s.settimeout(2.0)
        _, hdr, _ = wire.read_frame(s)
    return hdr


def _fence(endpoint, epoch):
    return _raw(endpoint, {"op": "fence", "epoch": epoch})


def _same_bits(a_list, b_list):
    return len(a_list) == len(b_list) and all(
        np.asarray(a).tobytes() == np.asarray(b).tobytes()
        for a, b in zip(a_list, b_list))


def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


# ---------------------------------------------------------------------------
# The epoch fence
# ---------------------------------------------------------------------------

def test_stale_epoch_commit_is_fenced_never_folded():
    srv = server().start()
    try:
        c = PSClient(srv.endpoint, worker_id=0, **FAST)
        try:
            center, upd = c.join(init=leaves())
            assert c.epoch == 0
            with srv._lock:
                srv.epoch = 3  # a promotion happened somewhere
            before = srv.center()
            res = c.commit([np.ones_like(a) for a in center], upd)
            assert res.evicted and not res.applied and c.rejoin_count == 1
            assert _same_bits(before, srv.center()), "stale commit folded"
            assert srv.commit_log == []
            # The server itself answers a stale-epoch commit typed.
            hdr = _raw(srv.endpoint, {"op": wire.OP_COMMIT, "worker_id": 0,
                                      "seq": 99, "pulled": upd, "epoch": 0},
                       [np.ones_like(a) for a in center])
            assert hdr.get("error") == "epoch_fenced"
            assert netps_client._ERROR_TYPES["epoch_fenced"] \
                is EpochFencedError
            assert _same_bits(before, srv.center()), "stale commit folded"
        finally:
            c.close()
        # Fenced reads like evicted — discard the window, re-join, adopt
        # the new epoch, continue.
        c2 = PSClient(srv.endpoint, worker_id=1, **FAST)
        try:
            center, upd = c2.join()
            c2.epoch = 0  # stale lineage
            res = c2.commit([np.zeros_like(a) for a in center], upd)
            assert res.evicted and not res.applied
            assert c2.epoch == 3
            assert c2.commit([np.zeros_like(a) for a in center],
                             upd).applied
        finally:
            c2.close()
        assert [w for w, _s, _st in srv.commit_log] == [1]
    finally:
        srv.close()


def test_fence_op_and_higher_epoch_commit_both_fence_the_zombie():
    srv = server().start()
    try:
        c = PSClient(srv.endpoint, worker_id=0, **FAST)
        try:
            center, upd = c.join(init=leaves())
            # The passive fence: a commit carrying a HIGHER epoch is proof
            # of a promotion — the server fences itself on the spot.
            c.epoch = 5
            with pytest.raises(NotPrimaryError):
                c.commit([np.ones_like(a) for a in center], upd)
            assert srv._fenced and srv.commit_log == []
        finally:
            c.close()
    finally:
        srv.close()
    srv2 = server().start()
    try:
        assert _fence(srv2.endpoint, 2).get("fenced")
        assert srv2._fenced
        with pytest.raises(NotPrimaryError):
            PSClient(srv2.endpoint, worker_id=1,
                     **FAST).join(init=leaves())
        # A fence that does NOT outrank the server is refused typed — the
        # fencer is the zombie, not us.
        srv3 = server(epoch=9).start()
        try:
            assert _fence(srv3.endpoint, 2).get("error") == "epoch_fenced"
            assert not srv3._fenced
        finally:
            srv3.close()
    finally:
        srv2.close()


def test_fenced_ex_primary_with_state_dir_restarts_fenced(tmp_path):
    d = str(tmp_path / "state")
    srv = server(state_dir=d).start()
    try:
        drive_commits(srv.endpoint, 2)
        assert _fence(srv.endpoint, 3).get("fenced")
    finally:
        srv.close()
    back = server(state_dir=d).start()
    try:
        assert back._fenced, "the fence did not survive the restart"
        assert back.epoch == 3 and back.updates == 2
        with pytest.raises(NotPrimaryError):
            PSClient(back.endpoint, worker_id=7,
                     **FAST).join(init=leaves())
        with PSClient(back.endpoint) as observer:
            assert observer.stats()["ready"] is False
    finally:
        back.close()


# ---------------------------------------------------------------------------
# The op registry: every reply the server sends stays inside its row
# ---------------------------------------------------------------------------

#: keys any reply may carry, whatever its op (``arrays`` is the frame's
#: own array specs, which the framing writes into every header).
_REPLY_BASE = {"ok", "error", "message", "req", "arrays"}


def test_op_registry_rows_match_the_ops_caps_and_jax_registry():
    from distkeras_tpu.netps import wire as jax_wire

    ops = {v for k, v in vars(wire).items()
           if k.startswith("OP_") and isinstance(v, str)}
    assert ops == set(wire.OP_REGISTRY)
    for op, spec in wire.OP_REGISTRY.items():
        assert spec.cap is None or spec.cap in wire.CAPS, op
        theirs = jax_wire.OP_REGISTRY[op]
        assert spec.cap == theirs.cap, op
        assert set(spec.replies) <= set(theirs.replies), op


def _server_replies():
    """Every op the server dispatches, sent raw in each of its answered
    modes; returns ``[(op, reply header)]``."""
    srv = server(state_dir=None).start()
    try:
        ep, out = srv.endpoint, []

        def send(op, **hdr):
            arrays = hdr.pop("arrays", ())
            out.append((op, _raw(ep, dict(hdr, op=op), arrays)))
            return out[-1][1]

        joined = send(wire.OP_JOIN, caps=wire.CAPS, arrays=leaves())
        wid, upd = joined["worker_id"], joined["updates"]
        member = dict(worker_id=wid, epoch=0)
        assert send(wire.OP_REPLICATE, u=-1)["mode"] == "snapshot"
        send(wire.OP_PULL, **member)
        ones = [np.ones_like(a) for a in leaves()]
        assert send(wire.OP_COMMIT, seq=0, pulled=upd, arrays=ones,
                    **member)["applied"]
        assert send(wire.OP_COMMIT, seq=0, pulled=upd, arrays=ones,
                    **member)["duplicate"]
        assert send(wire.OP_REPLICATE, u=upd)["mode"] == "records"
        send(wire.OP_HEARTBEAT, **member)
        send(wire.OP_STATS, ring=0)
        assert send(wire.OP_PROBE, arrays=ones, **member)["probe_bytes"]
        send(wire.OP_LEAVE, worker_id=wid)
        assert send(wire.OP_FENCE, epoch=0)["error"] == "epoch_fenced"
        assert send(wire.OP_FENCE, epoch=4)["fenced"]
        return out
    finally:
        srv.close()


@pytest.mark.parametrize("op", [wire.OP_JOIN, wire.OP_PULL, wire.OP_COMMIT,
                                wire.OP_HEARTBEAT, wire.OP_LEAVE,
                                wire.OP_REPLICATE, wire.OP_FENCE,
                                wire.OP_STATS, wire.OP_PROBE])
def test_every_server_reply_stays_inside_its_registry_row(op):
    replies = [r for o, r in _server_replies() if o == op]
    assert replies
    allowed = _REPLY_BASE | set(wire.OP_REGISTRY[op].replies)
    for reply in replies:
        assert set(reply) <= allowed, (op, set(reply) - allowed)


# ---------------------------------------------------------------------------
# Warm standby: replication, promotion, failover
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", ["none", "int8", "bf16"])
def test_standby_replicates_bit_identically_and_serves_nothing(compress):
    srv = server(discipline="dynsgd", lease_s=1.0).start()
    sb = standby(srv.endpoint, discipline="dynsgd", lease_s=1.0,
                 promote_after=30.0).start()
    try:
        drive_commits(srv.endpoint, 6, compress=compress)
        assert _wait(lambda: sb.updates == srv.updates == 6)
        assert _same_bits(srv.center(), sb.center()), "replication drifted"
        assert sb._last_seq == srv._last_seq
        tail = sb.commit_log  # what it replicated after its full sync
        assert tail == srv.commit_log[len(srv.commit_log) - len(tail):]
        # Pre-promotion it serves nothing: the typed walk signal.
        with pytest.raises(NotPrimaryError):
            PSClient(sb.endpoint, worker_id=9,
                     **FAST).join(init=leaves())
        assert not sb.promoted
        with PSClient(sb.endpoint) as observer:
            stats = observer.stats()
        assert stats["ready"] is False and stats["epoch"] == 0
    finally:
        sb.close()
        srv.close()


def test_kill_primary_standby_promotes_client_walks_exactly_once():
    """The in-process kill-the-primary drill: a client on the endpoint
    list rides through the primary's death — the standby promotes on lease
    lapse, fences the epoch, the client walks, re-joins, and a pre-crash
    commit's retransmit dedups on the new primary."""
    srv = server(lease_s=0.5).start()
    sb = standby(srv.endpoint, lease_s=0.5, promote_after=0.6).start()
    c = PSClient(f"{srv.endpoint},{sb.endpoint}", worker_id=0, timeout=0.5,
                 retries=10, backoff=0.02)
    try:
        center, upd = c.join(init=leaves())
        rng = np.random.default_rng(3)
        for _ in range(5):
            delta = [rng.normal(scale=0.1, size=a.shape).astype(np.float32)
                     for a in center]
            c.commit(delta, upd)
            center, upd = c.pull()
        assert _wait(lambda: sb.updates == srv.updates)
        pre_crash = srv.center()
        srv.close()  # the primary dies mid-run
        assert _wait(lambda: sb.promoted)
        assert sb.epoch == 1
        assert _same_bits(pre_crash, sb.center())
        center, upd = c.pull()  # walks, re-joins, adopts epoch 1
        assert c.epoch == 1 and c.rejoin_count >= 1 and c.walk_count >= 1
        c._seq -= 1  # retransmit of a pre-crash seq
        res = c.commit([np.ones_like(a) for a in center], upd)
        assert res.duplicate and not res.applied
        assert c.commit([np.zeros_like(a) for a in center], upd).applied
        seen = set()
        for wid, seq, _st in sb.commit_log:
            assert (wid, seq) not in seen, f"({wid},{seq}) folded twice"
            seen.add((wid, seq))
    finally:
        c.close()
        sb.close()


def test_promoted_standby_with_state_dir_restarts_fenced_forward(tmp_path):
    srv = server(lease_s=0.5).start()
    d = str(tmp_path / "sb-state")
    sb = standby(srv.endpoint, lease_s=0.5, promote_after=0.6,
                 state_dir=d).start()
    try:
        drive_commits(srv.endpoint, 3)
        assert _wait(lambda: sb.updates == srv.updates)
        srv.close()
        assert _wait(lambda: sb.promoted)
        drive_commits(sb.endpoint, 2, worker_id=1)
        pre, pre_epoch, pre_updates = sb.center(), sb.epoch, sb.updates
    finally:
        sb.close()
    back = server(state_dir=d)
    try:
        assert back.epoch == pre_epoch == 1
        assert back.updates == pre_updates == 5
        assert _same_bits(pre, back.center())
    finally:
        back.close()


def test_client_endpoint_list_walks_past_dead_endpoints():
    dead = f"127.0.0.1:{_free_port()}"
    srv = server().start()
    try:
        c = PSClient(f"{dead},{srv.endpoint}", worker_id=0, timeout=0.3,
                     retries=4, backoff=0.01)
        try:
            center, upd = c.join(init=leaves())
            assert c.commit([np.zeros_like(a) for a in center], upd).applied
            assert c.walk_count == 1
        finally:
            c.close()
    finally:
        srv.close()


def test_standby_resyncs_when_restarted_primary_lost_its_tail(tmp_path):
    d = str(tmp_path / "state")
    srv = server(lease_s=1.0, state_dir=d, snapshot_every=0).start()
    port = int(srv.endpoint.rsplit(":", 1)[1])
    sb = standby(srv.endpoint, lease_s=1.0, promote_after=30.0).start()
    try:
        drive_commits(srv.endpoint, 5)
        assert _wait(lambda: sb.updates == srv.updates == 5)
        srv.close()
        # Drop the last 2 journal records: the writer tail that "died with
        # the process".
        journals = sorted(p for p in os.listdir(d) if p.endswith(".dkj"))
        path = os.path.join(d, journals[-1])
        nrec, clean = netps_state._scan_journal(path)
        assert clean and nrec == 5
        keep = bytearray()
        with open(path, "rb") as f:
            for _ in range(3):
                prefix = f.read(wire.PREFIX_SIZE)
                _k, _c, length = wire.parse_prefix(prefix)
                keep += prefix + f.read(length)
        open(path, "wb").write(bytes(keep))
        srv2 = server(lease_s=1.0, state_dir=d, host="127.0.0.1",
                      port=port).start()
        try:
            assert srv2.updates == 3
            assert _wait(lambda: sb.updates == 3 and sb._flat is not None)
            assert _same_bits(srv2.center(), sb.center())
            assert len(sb.commit_log) + sb._log_dropped == sb.commits_total
            drive_commits(srv2.endpoint, 2, worker_id=1)
            assert _wait(lambda: sb.updates == srv2.updates == 5)
            assert _same_bits(srv2.center(), sb.center())
        finally:
            srv2.close()
    finally:
        sb.close()


def test_failover_patience_bridges_promotion_beyond_retry_budget():
    dead = f"127.0.0.1:{_free_port()}"
    sb = standby(dead, lease_s=1.0, promote_after=1.0).start()
    try:
        t0 = time.monotonic()
        c = PSClient(f"{dead},{sb.endpoint}", worker_id=0, timeout=0.3,
                     retries=1, backoff=0.02)
        try:
            center, upd = c.join(init=leaves())
            took = time.monotonic() - t0
            assert sb.promoted
            assert c.commit([np.zeros_like(a) for a in center], upd).applied
            assert took > 0.9, took
        finally:
            c.close()
    finally:
        sb.close()


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", ["none", "int8", "bf16"])
def test_jax_standby_tails_a_port_primary(compress):
    srv = server(discipline="dynsgd", lease_s=1.0).start()
    sb = JaxStandbyServer(srv.endpoint, discipline="dynsgd", lease_s=1.0,
                          promote_after=30.0).start()
    try:
        drive_commits(srv.endpoint, 4, compress=compress)
        drive_commits(srv.endpoint, 3, compress=compress, worker_id=1)
        assert _wait(lambda: sb.updates == srv.updates == 7)
        assert _same_bits(srv.center(), sb.center())
        assert sb._last_seq == srv._last_seq
    finally:
        sb.close()
        srv.close()


@pytest.mark.parametrize("compress", ["none", "int8", "bf16"])
def test_port_standby_tails_a_jax_primary(compress):
    jsrv = JaxPSServer(discipline="dynsgd", lease_s=1.0).start()
    sb = standby(jsrv.endpoint, discipline="dynsgd", lease_s=1.0,
                 promote_after=30.0).start()
    try:
        drive_commits(jsrv.endpoint, 4, compress=compress)
        drive_commits(jsrv.endpoint, 3, compress=compress, worker_id=1)
        assert _wait(lambda: sb.updates == jsrv.updates == 7)
        assert _same_bits(jsrv.center(), sb.center())
        assert sb._last_seq == jsrv._last_seq
        assert sb.replicated + sb.snapshot_syncs >= 1
    finally:
        sb.close()
        jsrv.close()


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "distkeras_tpu_torch.netps", "--host",
         "127.0.0.1", "--device", "cpu", *args],
        stdout=subprocess.PIPE, env=env, text=True, cwd=REPO)


def test_cli_state_dir_survives_sigkill_and_second_sigterm_force_exits(
        tmp_path):
    """``--state-dir``: a SIGKILLed server relaunched on the same port and
    directory resumes the center bit for bit (its journal holds each
    commit once). The signal contract: the FIRST SIGTERM prints
    NETPS_DRAINING at signal time and drains; a SECOND one mid-drain (the
    drain wedged by a half-sent frame) force-exits with status 70."""
    d = str(tmp_path / "state")
    port = _free_port()
    proc = _cli("--port", str(port), "--state-dir", d,
                "--snapshot-every", "3")
    try:
        ready = proc.stdout.readline()
        assert ready.startswith("NETPS_READY "), ready
        endpoint = ready.split()[1]
        center, _ = drive_commits(endpoint, 5, timeout=5.0)
        # The ACKed records reach the file once the writer drains its
        # queue; kill only then, so the restart must recover all five.
        assert _wait(lambda: len(netps_state.read_journal(d)) == 5)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    records = netps_state.read_journal(d)
    seen = [(int(r["wid"]), int(r["seq"])) for r in records]
    assert len(seen) == len(set(seen)) == 5
    proc = _cli("--port", str(port), "--state-dir", d)
    try:
        ready = proc.stdout.readline()
        assert ready.startswith("NETPS_READY "), ready
        with PSClient(ready.split()[1], timeout=5.0) as observer:
            back, updates = observer.pull()
        assert updates == 5 and _same_bits(center, back)
        s = socket.create_connection(("127.0.0.1", port))
        frame = wire.encode_frame(wire.KIND_REQUEST, {"op": "pull"}, [])
        s.sendall(frame[:wire.PREFIX_SIZE])
        time.sleep(0.3)  # the handler has the prefix and waits for more
        proc.send_signal(signal.SIGTERM)
        assert proc.stdout.readline().strip() == "NETPS_DRAINING"
        assert proc.poll() is None
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 70
        s.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_cli_standby_promotes_and_prints_the_epoch():
    srv = server(lease_s=0.5).start()
    proc = _cli("--port", "0", "--standby", srv.endpoint, "--lease", "0.5",
                "--promote-after", "0.6")
    try:
        ready = proc.stdout.readline()
        assert ready.startswith("NETPS_READY "), ready
        drive_commits(srv.endpoint, 2)
        time.sleep(0.5)
        srv.close()
        assert proc.stdout.readline().strip() == "NETPS_PROMOTED epoch=1"
        with PSClient(ready.split()[1], timeout=5.0) as observer:
            center, updates = observer.pull()
        assert updates == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.stdout.readline().strip() == "NETPS_DRAINING"
        assert proc.wait(timeout=20) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
