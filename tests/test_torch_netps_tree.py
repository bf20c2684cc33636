"""The port's aggregation trees (``netps/tree.py``) held to the JAX
package's: the spec grammar and topology math on the same strings,
partition ride-through with typed drops (the port's ledger equals the JAX
run of the same script), link faults, demotion and promotion, the warm
standby's promotion with exactly-once journals, ``build_tree``'s shape,
the ``tree`` advertisement and the ``root_u`` rider, and the CLI tree node
in another process. Every port node here folds on the CPU
(``device="cpu"``)."""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from distkeras_tpu import telemetry as jax_telemetry
from distkeras_tpu.netps import PSClient as JaxPSClient
from distkeras_tpu.netps import PSServer as JaxPSServer
from distkeras_tpu.netps import state as jax_state
from distkeras_tpu.netps import tree as jax_tree
from distkeras_tpu.resilience import faults as jax_faults
from distkeras_tpu.runtime import config as jax_config
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import PSClient, PSServer, wire
from distkeras_tpu_torch.netps import state as netps_state
from distkeras_tpu_torch.netps import tree
from distkeras_tpu_torch.resilience import faults
from distkeras_tpu_torch.runtime import config

FAST = dict(timeout=1.0, retries=3, backoff=0.01)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: each package's pieces, so one script runs against either.
PKGS = {
    "port": dict(server=lambda **kw: PSServer(device="cpu", **kw),
                 client=PSClient, tree=tree, faults=faults,
                 telemetry=telemetry, state=netps_state,
                 node_kw=dict(device="cpu", probe_links=False)),
    "jax": dict(server=JaxPSServer, client=JaxPSClient, tree=jax_tree,
                faults=jax_faults, telemetry=jax_telemetry, state=jax_state,
                node_kw=dict(probe_links=False)),
}


def root(pkg, n=4, **kw):
    kw.setdefault("discipline", "adag")
    return PKGS[pkg]["server"](center=[np.zeros(n, np.float32)],
                               **kw).start()


def node(pkg, upstream, **kw):
    p = PKGS[pkg]
    return p["tree"].TreeNode(upstream, **FAST, **p["node_kw"],
                              **kw).start()


def wait_for(cond, seconds=8.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.05)
    return cond()


# ---------------------------------------------------------------------------
# TreeSpec: grammar, topology math and link keys, against the JAX TreeSpec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "host:8,pool:4,region:2:int8", " host:2 ,, region:2 ", "host:2,region:3",
    "rack:1", "host:4,region:2:bf16", "a:3,b_2:2:none,c-3:5"])
def test_tree_spec_parse_render_and_topology_match_jax(spec):
    mine, theirs = tree.TreeSpec.parse(spec), jax_tree.TreeSpec.parse(spec)
    assert mine.render() == theirs.render()
    assert tree.TreeSpec.parse(mine.render()) == mine
    assert mine.depth == theirs.depth
    assert [(lv.name, lv.fanout, lv.codec) for lv in mine.levels] == \
        [(lv.name, lv.fanout, lv.codec) for lv in theirs.levels]
    for workers in (1, 6, 7, 33):
        for level in range(mine.depth):
            assert mine.nodes_at(level, workers) == \
                theirs.nodes_at(level, workers)
            assert [mine.group_of(r, level) for r in range(workers)] == \
                [theirs.group_of(r, level) for r in range(workers)]
            for g in range(mine.nodes_at(level, workers)):
                if level + 1 < mine.depth:
                    assert mine.parent_group(level, g) == \
                        theirs.parent_group(level, g)
                else:
                    with pytest.raises(ValueError):
                        mine.parent_group(level, g)


@pytest.mark.parametrize("bad", [
    "host", "host:xyz", "host:0", "host:2:zstd9", "host:2,host:4", "9bad:2",
    "host:2:int8:extra", ""])
def test_tree_spec_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        jax_tree.TreeSpec.parse(bad)
    with pytest.raises(ValueError):
        tree.TreeSpec.parse(bad)


@pytest.mark.parametrize("level,group", [(0, 0), (2, 7), (1, 999), (5, 0),
                                         (-1, 0), (0, -1), (0, 1000)])
def test_tree_link_keys_match_jax(level, group):
    try:
        want = jax_tree.TreeSpec.link_key(level, group)
    except ValueError:
        with pytest.raises(ValueError):
            tree.TreeSpec.link_key(level, group)
        return
    assert tree.TreeSpec.link_key(level, group) == want
    assert tree.TreeSpec.split_link_key(want) == \
        jax_tree.TreeSpec.split_link_key(want) == (level, group)


def test_tree_knobs_are_the_jax_registry_rows(monkeypatch):
    for name in ("DKTPU_TREE_SPEC", "DKTPU_TREE_BUFFER",
                 "DKTPU_TREE_DEMOTE_AFTER"):
        monkeypatch.delenv(name, raising=False)
    assert config.env_str("DKTPU_TREE_SPEC") == \
        jax_config.env_str("DKTPU_TREE_SPEC") == ""
    assert config.env_int("DKTPU_TREE_BUFFER") == \
        jax_config.env_int("DKTPU_TREE_BUFFER") == 32
    assert config.env_int("DKTPU_TREE_DEMOTE_AFTER") == \
        jax_config.env_int("DKTPU_TREE_DEMOTE_AFTER") == 3
    monkeypatch.setenv("DKTPU_TREE_SPEC", "host:2,region:2:int8")
    assert tree.TreeSpec.from_env().render() == "host:2,region:2:int8"


# ---------------------------------------------------------------------------
# Partition ride-through: bounded buffer, typed drops, zero silent loss
# ---------------------------------------------------------------------------

def partition_script(pkg):
    """A black-holed uplink buffers up to ``buffer_windows`` windows and
    drops the oldest past the bound, typed; on heal the survivors drain in
    order, exactly once. Returns the ledgers, the root's commits and the
    drop and link-down events."""
    p = PKGS[pkg]
    p["telemetry"].reset()
    r = root(pkg)
    n = None
    try:
        n = node(pkg, r.endpoint, level=0, group=0, spec="region:2",
                 fan_in=1, buffer_windows=3, flush_interval=3600.0)
        p["faults"].set_net_plan(
            p["faults"].FaultPlan.parse_net("link_down@0:2.5"))
        with p["client"](n.endpoint, **FAST) as c:
            c.join(init=[np.zeros(4, np.float32)])
            for _ in range(10):
                _, pulled = c.pull()
                c.commit([np.ones(4, np.float32)], pulled)
                n._flush_once(force=True)
            dark = c.stats()["tree"]  # the ledger rides the stats op
        wait_for(lambda: (n._flush_once(force=True),
                          n.tree_stats()["buffered_windows"] == 0)[1])
        healed = n.tree_stats()
        events = p["telemetry"].get().events()
        return (dark, healed, r.commits_total, r.center(),
                [e for e in events if e["kind"] == "netps_tree_window_drop"],
                [e for e in events if e["kind"] == "netps_tree_link_down"])
    finally:
        p["faults"].reset()
        if n is not None:
            n.close()
        r.close()
        p["telemetry"].reset()


def test_partition_buffers_then_drops_typed_as_jax_does():
    port, ref = partition_script("port"), partition_script("jax")
    dark, healed, commits, center, drops, downs = port
    assert dark == ref[0] and healed == ref[1]
    assert (dark["absorbed"], dark["buffered_windows"],
            dark["dropped_windows"], dark["dropped_commits"],
            dark["forwarded_commits"], dark["silent_loss"],
            dark["link_down"]) == (10, 3, 7, 7, 0, 0, True)
    assert (healed["buffered_windows"], healed["forwarded_commits"],
            healed["dropped_commits"], healed["silent_loss"]) == (0, 3, 7, 0)
    assert commits == ref[2] == 3
    assert center[0].tobytes() == ref[3][0].tobytes()
    assert [e["constituents"] for e in drops] == \
        [e["constituents"] for e in ref[4]]
    pairs = [tuple(q) for e in drops for q in e["constituents"]]
    assert len(pairs) == len(set(pairs)) == 7
    assert all(e["reason"] == "buffer_overflow" for e in drops)
    assert [e["seconds"] for e in downs] == [e["seconds"] for e in ref[5]] \
        == [2.5]


def test_link_flap_blackholes_twice_from_one_entry():
    r = root("port")
    n = node("port", r.endpoint, level=1, group=3, spec="host:2,region:4")
    try:
        assert n.link_key == 1003
        faults.set_net_plan(faults.FaultPlan.parse_net("link_flap@1003:1.0"))
        assert n._link_blackholed() is True  # down 1 s
        time.sleep(1.2)
        assert n._link_blackholed() is False  # up 1 s
        time.sleep(1.0)
        assert n._link_blackholed() is True  # down again
        assert n.tree_stats()["link_downs"] == 2
    finally:
        faults.reset()
        n.close()
        r.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_uplink_demotes_to_tcp_and_promotes_back(pkg):
    """An operator demotion redials the uplink over TCP keeping the worker
    id (dedup holds); eight healthy flushes promote it back."""
    p = PKGS[pkg]
    # A short root lease bounds the flusher's idle wait (lease / 3).
    r = root(pkg, lease_s=1.5)
    n = node(pkg, r.endpoint, fan_in=1, flush_interval=3600.0)
    try:
        wid = n._up.worker_id
        assert n.demote_uplink() is True and n.demote_uplink() is False
        assert n._up.worker_id == wid
        with p["client"](n.endpoint, **FAST) as c:
            c.join()
            for k in range(8):
                _, u = c.pull()
                assert c.commit([np.ones(4, np.float32)], u).applied
                assert wait_for(lambda: n.forwarded == k + 1)
        assert wait_for(lambda: n.link_promotions == 1)
        stats = n.tree_stats()
    finally:
        n.close()
        r.close()
    assert (stats["link_demotions"], stats["link_promotions"],
            stats["link_demoted"], stats["forwarded_commits"],
            stats["silent_loss"]) == (1, 1, False, 8, 0)
    assert {w for w, _s, _st in r.commit_log} == {wid}


# ---------------------------------------------------------------------------
# Standby promotion: fence, re-parent, exactly-once journals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_tree_standby_promotes_fences_and_dedups(tmp_path, pkg):
    """Killing a tree node promotes its warm standby: the epoch bumps past
    the dead lineage, the child re-parents through its endpoint walk, and
    no (wid, seq) lands twice in either lineage's journal or at the root.
    The same script in both packages holds the same invariants."""
    p = PKGS[pkg]
    p["telemetry"].reset()
    r = root(pkg, lease_s=30.0)
    n = sb = None
    try:
        n = node(pkg, r.endpoint, level=0, group=0, spec="region:2",
                 fan_in=1, flush_interval=0.05, lease_s=2.0,
                 state_dir=str(tmp_path / "node"))
        sb = p["tree"].TreeStandby(
            n.endpoint, upstream=r.endpoint, level=0, group=0,
            spec="region:2", fan_in=1, flush_interval=0.05,
            promote_after=0.6, state_dir=str(tmp_path / "standby"),
            **FAST, **p["node_kw"]).start()
        served = f"{n.endpoint},{sb.endpoint}"
        with p["client"](served, timeout=1.0, retries=10, backoff=0.05) as c:
            c.join(init=[np.zeros(4, np.float32)])
            assert c.peer_caps["tree"] == {"level": 0, "group": 0,
                                           "spec": "region:2"}
            for _ in range(4):
                _, pulled = c.pull()
                c.commit([np.ones(4, np.float32)], pulled)
            assert wait_for(lambda: n.forwarded >= 1, 5.0)
            # A hard stop: no goodbye, no final flush.
            n._stop.set()
            n._listener.close()
            assert wait_for(lambda: sb.promoted), "standby never promoted"
            assert sb.epoch >= 1
            for _ in range(4):  # the endpoint walk re-parents the child
                _, pulled = c.pull()
                c.commit([np.ones(4, np.float32)], pulled)
        assert wait_for(lambda: sb.forwarded >= 1, 5.0)
        assert sb.absorbed >= 4
        for label in ("node", "standby"):
            records = p["state"].read_journal(str(tmp_path / label))
            keys = [(int(x["wid"]), int(x["seq"])) for x in records]
            assert len(keys) == len(set(keys)), label
            epochs = [int(x["e"]) for x in records]
            assert epochs == sorted(epochs), label
        sb_records = p["state"].read_journal(str(tmp_path / "standby"))
        assert max(int(x["e"]) for x in sb_records) >= 1
        keys = [(w, s) for w, s, _st in r.commit_log]
        assert len(keys) == len(set(keys))
        assert sb.tree_stats()["silent_loss"] == 0
    finally:
        if sb is not None:
            sb.close()
        if n is not None:
            try:
                n.close()
            except Exception:  # noqa: BLE001 - the node was hard-stopped
                pass
        r.close()
        p["telemetry"].reset()


def test_partitioned_promotion_serves_on_root_u_and_buffers():
    """A standby promoted while its uplink is unreachable serves its
    children on the replicated root counter (``root_u``), buffers their
    windows, and drains them once the root answers."""
    r = root("port")
    n = node("port", r.endpoint, fan_in=1, flush_interval=0.05, lease_s=2.0)
    sb = tree.TreeStandby(n.endpoint, upstream="127.0.0.1:1", fan_in=1,
                          flush_interval=0.05, promote_after=0.6,
                          device="cpu", timeout=0.2,
                          retries=0, backoff=0.01).start()
    try:
        with PSClient(n.endpoint, **FAST) as c:
            _, u = c.join()
            assert c.commit([np.ones(4, np.float32)], u).applied
        assert wait_for(lambda: n.forwarded == 1 and sb._root_u == 1)
        n._stop.set()
        n._listener.close()
        assert wait_for(lambda: sb.promoted)
        assert sb.updates == 1 and sb._up is None
        with PSClient(sb.endpoint, **FAST) as c:
            _, u = c.join()
            assert u == 1
            assert c.commit([np.ones(4, np.float32)], u).applied
        assert wait_for(lambda: sb.tree_stats()["buffered_windows"] == 1)
        stats = sb.tree_stats()
        assert stats["absorbed"] == 1 and stats["silent_loss"] == 0
        sb.upstream = r.endpoint  # the partition heals
        assert wait_for(lambda: sb.forwarded == 1)
        np.testing.assert_array_equal(r.center()[0], 2.0)
    finally:
        sb.close()
        try:
            n.close()
        except Exception:  # noqa: BLE001 - the node was hard-stopped
            pass
        r.close()


# ---------------------------------------------------------------------------
# In-process assembly, the advertisement and the replicate rider
# ---------------------------------------------------------------------------

def test_build_tree_shape_and_leaf_routing():
    r = root("port")
    t = None
    try:
        t = tree.build_tree("host:2,region:2", r.endpoint, workers=4,
                            flush_interval=0.05, device="cpu", **FAST)
        assert set(t.nodes[0]) == {0, 1} and set(t.nodes[1]) == {0}
        assert t.leaf_endpoint(0) == t.node(0, 0).endpoint
        assert t.leaf_endpoint(1) == t.node(0, 0).endpoint
        assert t.leaf_endpoint(2) == t.node(0, 1).endpoint
        assert t.node(0, 0).upstream == t.node(1, 0).endpoint
        assert t.node(1, 0).upstream == r.endpoint
        with PSClient(t.leaf_endpoint(0), **FAST) as c:
            c.join(init=[np.zeros(4, np.float32)])
            hdr = c.stats()["tree"]
            assert (hdr["level"], hdr["group"]) == (0, 0)
            assert hdr["spec"] == "host:2,region:2"
        # Every leaf's commits reach the root through both levels.
        clients = [PSClient(t.leaf_endpoint(w), worker_id=w, **FAST)
                   for w in range(4)]
        try:
            for c in clients:
                _, u = c.join()
                assert c.commit([np.ones(4, np.float32)], u).applied
        finally:
            for c in clients:
                c.close()
        t.close()
        t = None
        np.testing.assert_array_equal(r.center()[0], 4.0)
    finally:
        if t is not None:
            t.close()
        r.close()


def test_tree_node_advertises_itself_and_rides_root_u():
    r = root("port")
    n = node("port", r.endpoint, level=1, group=2, spec="host:2,region:3",
             fan_in=1, flush_interval=0.05)
    try:
        with PSClient(n.endpoint, worker_id=0, **FAST) as c:
            _, u = c.join()
            assert c.peer_caps["tree"] == {"level": 1, "group": 2,
                                           "spec": "host:2,region:3"}
            assert c.commit([np.ones(4, np.float32)], u).applied
            assert wait_for(lambda: n.forwarded == 1 and n.updates == 1)
            with PSClient(n.endpoint, **FAST) as raw:
                # The first replicate arms the tail with a full sync.
                snap, _ = raw._rpc(wire.OP_REPLICATE, {"u": -1})
                _, u = c.pull()
                assert c.commit([np.ones(4, np.float32)], u).applied
                assert wait_for(lambda: n.forwarded == 2 and n.updates == 2)
                recs, deltas = raw._rpc(wire.OP_REPLICATE, {"u": 1})
        assert len(deltas) == 1
        assert (snap["mode"], snap["root_u"], snap["updates"]) == \
            ("snapshot", 1, 1)
        # The journal stream advances by the absorb cursor; root_u rides.
        assert (recs["mode"], recs["root_u"], recs["updates"]) == \
            ("records", 2, 2)
        assert [(x["u"], x["wid"], x["seq"]) for x in recs["records"]] == \
            [(1, 0, 1)]
        for hdr in (snap, recs):
            assert set(hdr) <= set(
                wire.OP_REGISTRY[wire.OP_REPLICATE].replies) | {"ok", "req", "arrays"}
        # A plain server keeps the static bit.
        with PSClient(r.endpoint, **FAST) as c:
            c.join()
            assert c.peer_caps["tree"] is True
    finally:
        n.close()
        r.close()


# ---------------------------------------------------------------------------
# The CLI tree node, in another process
# ---------------------------------------------------------------------------

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "distkeras_tpu_torch.netps", "--host",
         "127.0.0.1", "--device", "cpu", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        cwd=REPO)


def test_cli_tree_node_combines_and_drains():
    r = root("port")
    proc = _cli("--port", "0", "--upstream", r.endpoint, "--fan-in", "2",
                "--flush-interval", "30", "--tree-spec", "host:2",
                "--tree-buffer", "4")
    try:
        ready = proc.stdout.readline()
        assert ready.startswith("NETPS_READY "), ready
        ep = ready.split()[1]
        clients = [PSClient(ep, worker_id=w, **FAST) for w in range(2)]
        try:
            for c in clients:
                _, u = c.join()
                assert c.commit([np.ones(4, np.float32)], u).applied
            assert c.peer_caps["tree"]["spec"] == "host:2"
        finally:
            for c in clients:
                c.close()
        assert wait_for(lambda: len(r.commit_log) == 1)
        proc.send_signal(signal.SIGTERM)
        assert proc.stdout.readline().strip() == "NETPS_DRAINING"
        drained = proc.stdout.readline()
        assert drained.startswith("NETPS_DRAINED commits=2"), drained
        assert proc.wait(timeout=20) == 0
        np.testing.assert_array_equal(r.center()[0], 2.0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        r.close()


def test_cli_refuses_shard_with_upstream():
    proc = _cli("--port", "0", "--upstream", "127.0.0.1:1", "--shard", "0/2")
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 2
    assert "--shard and --upstream are mutually exclusive" in err
