"""The port's durable parameter server (``distkeras_tpu_torch/netps/
state.py``, ``PSServer(state_dir=...)``) on the CPU (``device="cpu"``: the
fold's plain twin), adapted from the JAX package's
``tests/test_netps_failover.py`` durability cases and held to the JAX
package bit for bit (``tobytes()`` equal, no tolerance): the port recovers
its own state directory, the JAX ``StateStore`` recovers the port's (its
numpy replay of the port's journal), and the port recovers the JAX
server's. Two workers commit from one pull each round, so every other
commit folds at staleness 1 and DynSGD's scale is exercised."""

import os

import numpy as np
import pytest

from distkeras_tpu.netps import PSClient as JaxPSClient
from distkeras_tpu.netps import PSServer as JaxPSServer
from distkeras_tpu.netps import state as jax_state
from distkeras_tpu_torch.netps import PSClient, PSServer
from distkeras_tpu_torch.netps import server as netps_server
from distkeras_tpu_torch.netps import state as netps_state
from distkeras_tpu_torch.netps import wire

FAST = dict(timeout=2.0, retries=3, backoff=0.01)


def leaves():
    rng = np.random.default_rng(7)
    return [rng.normal(size=(4, 3)).astype(np.float32),
            rng.normal(size=(8,)).astype(np.float32),
            rng.normal(size=(2, 5)).astype(np.float32)]


def drive_commits(endpoint, n, *, compress="none", first_worker=0,
                  client_cls=PSClient):
    """Two workers (ids ``first_worker`` and the next) join and, round by
    round, both pull and then both commit a seeded delta, until ``n``
    commits are folded; the second commit of a round folds one update
    after its pull."""
    rng = np.random.default_rng(first_worker + 1)
    clients = [client_cls(endpoint, worker_id=first_worker + i,
                          compress=compress, **FAST) for i in range(2)]
    try:
        for c in clients:
            c.join(init=leaves())
        done = 0
        while done < n:
            pulls = [c.pull() for c in clients]
            for c, (center, upd) in zip(clients, pulls):
                if done == n:
                    break
                delta = [rng.normal(scale=0.1, size=a.shape)
                         .astype(np.float32) for a in center]
                c.commit(delta, upd)
                done += 1
    finally:
        for c in clients:
            c.close()


def port_server(**kw):
    kw.setdefault("discipline", "dynsgd")
    kw.setdefault("device", "cpu")
    return PSServer(**kw)


def assert_same_bits(a_list, b_list):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), (
            "centers differ")


@pytest.mark.parametrize("compress", ["none", "int8", "bf16"])
def test_restart_replays_snapshot_plus_journal_bit_identically(
        tmp_path, compress):
    d = str(tmp_path / "state")
    srv = port_server(state_dir=d, snapshot_every=4).start()
    try:
        drive_commits(srv.endpoint, 10, compress=compress)
        pre = srv.center()
        pre_updates, pre_total = srv.updates, srv.commits_total
        pre_seq = dict(srv._last_seq)
        assert sorted({st for _w, _s, st in srv.commit_log}) == [0, 1]
    finally:
        srv.close()
    srv2 = port_server(state_dir=d)
    try:
        assert srv2.updates == pre_updates == 10
        assert srv2.commits_total == pre_total
        assert srv2._last_seq == pre_seq
        # Snapshots at 4 and 8: the journal from 8 replays two records.
        assert srv2.recovered_records == 2
        assert_same_bits(pre, srv2.center())
        assert len(srv2.commit_log) + srv2._log_dropped == srv2.commits_total
    finally:
        srv2.close()


def test_restarted_server_answers_join_with_last_seq_and_dedups(tmp_path):
    d = str(tmp_path / "state")
    srv = port_server(state_dir=d).start()
    try:
        drive_commits(srv.endpoint, 6)
    finally:
        srv.close()
    srv2 = port_server(state_dir=d).start()
    try:
        c = PSClient(srv2.endpoint, worker_id=0, **FAST)
        try:
            _, upd = c.join()
            assert c._seq == 2  # resumed past the server's folded history
            before = srv2.center()
            c._seq = 1  # retransmit of an ACKed pre-crash commit
            res = c.commit([np.ones_like(a) for a in before], upd)
            assert res.duplicate and not res.applied
            assert_same_bits(before, srv2.center())
            assert c.commit([np.zeros_like(a) for a in before],
                            upd).applied
        finally:
            c.close()
    finally:
        srv2.close()


@pytest.mark.parametrize("compress", ["none", "int8", "bf16"])
def test_jax_state_store_recovers_the_port_directory(tmp_path, compress):
    """The JAX package's ``StateStore(dir).recover`` (its numpy replay)
    and ``read_journal`` read a directory the port wrote, and land on the
    port's center bit for bit."""
    d = str(tmp_path / "state")
    srv = port_server(state_dir=d, snapshot_every=3).start()
    try:
        drive_commits(srv.endpoint, 8, compress=compress)
        pre, log = srv.center(), list(srv.commit_log)
    finally:
        srv.close()
    rec = jax_state.StateStore(d).recover("dynsgd")
    assert rec.updates == 8 and rec.commits_total == 8 and rec.replayed == 2
    assert_same_bits(pre, rec.center)
    # The port's store alone (its default seating) lands on the same bits.
    mine = netps_state.StateStore(d).recover("dynsgd", device="cpu")
    assert (mine.updates, mine.replayed) == (8, 2)
    assert_same_bits(pre, [t.numpy() for t in mine.center])
    headers = jax_state.read_journal(d)
    assert [(int(h["wid"]), int(h["seq"]), int(h["st"])) for h in headers] \
        == [tuple(e) for e in log[-len(headers):]]
    assert [h["u"] for h in netps_state.read_journal(d)] == \
        [h["u"] for h in headers]


@pytest.mark.parametrize("compress", ["none", "int8", "bf16"])
def test_port_recovers_the_jax_server_directory(tmp_path, compress):
    d = str(tmp_path / "state")
    jsrv = JaxPSServer(discipline="dynsgd", state_dir=d,
                       snapshot_every=4).start()
    try:
        drive_commits(jsrv.endpoint, 9, compress=compress,
                      client_cls=JaxPSClient)
        pre, pre_seq = jsrv.center(), dict(jsrv._last_seq)
    finally:
        jsrv.close()
    srv = port_server(state_dir=d)
    try:
        assert srv.updates == 9 and srv.recovered_records == 1
        assert srv._last_seq == pre_seq
        assert_same_bits(pre, srv.center())
    finally:
        srv.close()


def test_torn_journal_tail_is_dropped_not_replayed(tmp_path):
    d = str(tmp_path / "state")
    srv = port_server(state_dir=d, snapshot_every=0).start()
    try:
        drive_commits(srv.endpoint, 4)
    finally:
        srv.close()
    journals = sorted(p for p in os.listdir(d) if p.endswith(".dkj"))
    path = os.path.join(d, journals[-1])
    whole = open(path, "rb").read()
    open(path, "wb").write(whole[:-7])  # the crash-interrupted append
    srv2 = port_server(state_dir=d)
    try:
        # The base snapshot + 3 intact records; the torn 4th is caught by
        # the frame crc and dropped, never folded as garbage.
        assert srv2.updates == 3 and srv2.recovered_records == 3
    finally:
        srv2.close()


def test_torn_interior_journal_still_replays_the_anchored_chain(tmp_path):
    d = str(tmp_path / "state")
    srv = port_server(state_dir=d, snapshot_every=4).start()
    try:
        drive_commits(srv.endpoint, 6)  # snapshot at 4; journal-4: u=4,5
    finally:
        srv.close()
    path = os.path.join(d, "journal-" + "4".zfill(12) + ".dkj")
    with open(path, "rb") as f:  # crash #1's tear: keep only u=4
        prefix = f.read(wire.PREFIX_SIZE)
        _k, _c, length = wire.parse_prefix(prefix)
        first = prefix + f.read(length)
    open(path, "wb").write(first + b"\x13torn")
    srv2 = port_server(state_dir=d).start()
    try:
        assert srv2.updates == 5  # snapshot 4 + journal-4's valid prefix
        drive_commits(srv2.endpoint, 2, first_worker=2)  # journal-5
        assert srv2.updates == 7
        pre = srv2.center()
    finally:
        srv2.close()  # crash #2: journal-4 still carries its torn tail
    srv3 = port_server(state_dir=d)
    try:
        assert srv3.updates == 7
        assert_same_bits(pre, srv3.center())
    finally:
        srv3.close()


def test_corrupt_snapshot_falls_back_to_previous_generation(tmp_path):
    d = str(tmp_path / "state")
    srv = port_server(state_dir=d, snapshot_every=3).start()
    try:
        drive_commits(srv.endpoint, 7)
        pre = srv.center()
    finally:
        srv.close()
    snaps = sorted(p for p in os.listdir(d) if p.endswith(".dks"))
    assert len(snaps) == 2  # pruned to the newest two generations
    newest = os.path.join(d, snaps[-1])
    blob = bytearray(open(newest, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(newest, "wb").write(bytes(blob))
    srv2 = port_server(state_dir=d)
    try:
        # The digest sidecar rejects the newest; the previous snapshot and
        # a longer replay land on the same center.
        assert srv2.updates == 7 and srv2.recovered_records == 4
        assert_same_bits(pre, srv2.center())
    finally:
        srv2.close()


def test_snapshot_compaction_bounds_disk_and_commit_log(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(netps_server, "_COMMIT_LOG_KEEP", 6)
    d = str(tmp_path / "state")
    srv = port_server(state_dir=d, snapshot_every=5).start()
    try:
        drive_commits(srv.endpoint, 23)
        snaps = [p for p in os.listdir(d) if p.endswith(".dks")]
        journals = [p for p in os.listdir(d) if p.endswith(".dkj")]
        assert len(snaps) <= 2, snaps
        assert len(journals) <= 3, journals
        assert len(srv.commit_log) <= 2 * 6
        assert len(srv.commit_log) + srv._log_dropped == srv.commits_total
        assert srv.commits_total == 23 and srv.snapshots_written == 5
        assert srv.journal_bytes > 0
    finally:
        srv.close()


def test_read_journal_exposes_fold_order_evidence(tmp_path):
    d = str(tmp_path / "state")
    srv = port_server(state_dir=d, snapshot_every=4).start()
    try:
        drive_commits(srv.endpoint, 6)
    finally:
        srv.close()
    records = netps_state.read_journal(d)
    # Both kept generations: snapshots 0 and 4 and their journals.
    assert [int(r["u"]) for r in records] == list(range(6))
    seen = {(int(r["wid"]), int(r["seq"])) for r in records}
    assert len(seen) == len(records), "a commit was journaled twice"


def test_ctor_seeded_center_anchors_a_fresh_directory(tmp_path):
    """A server built with a center on a fresh directory snapshots it at
    once, so a crash before any join still recovers that center; a later
    server on the same directory ignores its own ctor center (the disk is
    authoritative)."""
    d = str(tmp_path / "state")
    srv = port_server(center=leaves(), state_dir=d)
    srv.close()
    other = [a + 1.0 for a in leaves()]
    srv2 = port_server(center=other, state_dir=d)
    try:
        assert srv2.updates == 0
        assert_same_bits(leaves(), srv2.center())
    finally:
        srv2.close()


def test_recover_seats_on_the_card_by_default(tmp_path):
    """``StateStore.recover`` with no device takes the card, as every entry
    point of the port does: with no card present it raises rather than
    replaying on the CPU."""
    import torch

    d = str(tmp_path / "state")
    srv = port_server(state_dir=d, snapshot_every=3).start()
    try:
        drive_commits(srv.endpoint, 4)
    finally:
        srv.close()
    store = netps_state.StateStore(d)
    if torch.cuda.is_available():
        rec = store.recover("dynsgd")
        assert rec.center[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            store.recover("dynsgd")
    assert store.recover("dynsgd", device="cpu").center[0].device.type \
        == "cpu"


def test_state_dir_knobs_are_registered():
    from distkeras_tpu_torch.runtime import config

    assert config.env_str("DKTPU_PS_STATE_DIR") == ""
    assert config.env_int("DKTPU_PS_SNAPSHOT_EVERY") == 500
    assert config.env_str("DKTPU_PS_STANDBY") == ""
