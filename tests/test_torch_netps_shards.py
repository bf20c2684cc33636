"""The sharded center plane of the port (``distkeras_tpu_torch/netps/
shards/``) on the CPU, held to the JAX package's (``distkeras_tpu/netps/
shards/``), adapted from its ``tests/test_netps_shards.py``.

* **Plan parity** — for the same names, shapes, rules, cap and optimizer
  factor the port's :class:`PartitionPlan` has the JAX package's
  ``to_dict()`` and ``plan_hash`` exactly (compared with ``==``; a hash is
  all or nothing), and ``scatter``/``assemble`` round trips are
  bit-exact.
* **Parity of the center** — a 2-shard :class:`ShardSet` driven by the
  same commits as one :class:`PSServer` ends bit-identical (ADAG, codec
  none): sharding changes where tensors live, never what is folded.
* **Never a silent mis-fold** — every way two peers can disagree about the
  plan answers a typed ``ShardPlanError`` at join.
* **Exactly-once per shard** and **cross-package** — either package's
  sharded client against the other's shard set, and a JAX shard server
  restarted from a port shard's ``plan.json`` and journal, bit-exact.
"""

import json
import os
import threading

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from distkeras_tpu.netps import wire as jax_wire
from distkeras_tpu.netps.errors import ShardPlanError as JaxShardPlanError
from distkeras_tpu.netps.server import PSServer as JaxPSServer
from distkeras_tpu.netps.shards import PartitionPlan as JaxPlan
from distkeras_tpu.netps.shards import ShardedPSClient as JaxShardedClient
from distkeras_tpu.netps.shards import ShardSet as JaxShardSet
from distkeras_tpu.netps.shards import parse_rules as jax_parse_rules
from distkeras_tpu.netps.shards import plan_for_model as jax_plan_for_model
from distkeras_tpu_torch.netps import (
    PartitionPlan,
    PSClient,
    PSServer,
    ShardedPSClient,
    ShardPlanError,
    ShardSet,
    make_ps_client,
    wire,
)
from distkeras_tpu_torch.netps.errors import ProtocolError
from distkeras_tpu_torch.netps.shards import parse_rules, plan_for_model
from distkeras_tpu_torch.ops.kernels import fold as F
from distkeras_tpu_torch.resilience import faults
from distkeras_tpu_torch.resilience.faults import FaultPlan

FAST = dict(timeout=2.0, retries=3, backoff=0.01)


def leaves():
    rng = np.random.default_rng(7)
    return [rng.normal(size=(8, 3)).astype(np.float32),
            rng.normal(size=(4,)).astype(np.float32),
            rng.normal(size=(2, 2)).astype(np.float32)]


def shard_set(n, **kw):
    kw.setdefault("device", "cpu")
    return ShardSet(n, **kw)


def port_server(**kw):
    kw.setdefault("device", "cpu")
    return PSServer(**kw)


def drive(client, n, worker_seed=0):
    """``n`` deterministic commits (join, then commit + pull); returns the
    final pulled center."""
    center, counter = client.join(init=leaves())
    rng = np.random.default_rng(100 + worker_seed)
    for _ in range(n):
        delta = [rng.normal(scale=0.1, size=np.shape(a)).astype(np.float32)
                 for a in center]
        res = client.commit(delta, counter)
        assert res.applied, res
        center, counter = client.pull()
    return center


def same_bits(a_list, b_list):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# PartitionPlan, held to the JAX package's
# ---------------------------------------------------------------------------

#: (shapes, build kwargs) cases: balanced, pinned, split, cap-split,
#: scalars, the optimizer factor.
NAMES = ["tok_embed.weight", "blocks.0.attn.qkv.weight", "blocks.0.ln.bias",
         "head.weight", "step"]
SHAPES = [(64, 16), (16, 48), (16,), (16, 64), ()]
PLAN_CASES = {
    "balanced": dict(num_shards=3),
    "pinned": dict(num_shards=2, rules=[("ln", 1), ("head", 0)]),
    "split": dict(num_shards=2, rules=[("tok_embed", "split")]),
    "split_scalar_degrades": dict(num_shards=2, rules=[("step", "split"),
                                                       ("qkv", "split")]),
    "cap_split": dict(num_shards=4, cap_bytes=3000),
    "opt_factor": dict(num_shards=4, opt_factor=2.0000041, cap_bytes=9000),
    "one_shard": dict(num_shards=1, rules=[(".*", 0)]),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_dict_and_hash_match_jax(case):
    kw = PLAN_CASES[case]
    n = kw["num_shards"]
    rest = {k: v for k, v in kw.items() if k != "num_shards"}
    port = PartitionPlan.build(NAMES, SHAPES, n, **rest)
    ref = JaxPlan.build(NAMES, SHAPES, n, **rest)
    assert port.to_dict() == ref.to_dict()
    assert port.to_json() == ref.to_json()
    assert port.plan_hash == ref.plan_hash
    assert port.skew() == ref.skew()
    for k in range(n):
        assert port.shard_shapes(k) == ref.shard_shapes(k)
    if case in ("split", "cap_split", "opt_factor"):
        assert any(len(s) > 1 for s in port.segments)


@settings(max_examples=30, deadline=None)
@given(shapes=st.lists(st.lists(st.integers(1, 9), min_size=0, max_size=3),
                       min_size=1, max_size=7),
       num_shards=st.integers(1, 4), cap=st.sampled_from([0, 64, 200, 800]),
       factor=st.sampled_from([0.0, 1.0, 2.0, 0.37]))
def test_plan_matches_jax_over_random_shapes(shapes, num_shards, cap,
                                             factor):
    shapes = [tuple(s) for s in shapes]
    names = [f"t{i}" for i in range(len(shapes))]
    outs = []
    for cls, err in ((PartitionPlan, ShardPlanError),
                     (JaxPlan, JaxShardPlanError)):
        try:
            outs.append(cls.build(names, shapes, num_shards,
                                  cap_bytes=cap or None,
                                  opt_factor=factor).to_dict())
        except err as e:
            outs.append(("raised", str(e)))
    assert outs[0] == outs[1]


def test_scatter_assemble_roundtrip_is_bit_exact():
    rng = np.random.default_rng(3)
    arrays = [rng.normal(size=s).astype(np.float32) if s else
              np.float32(rng.normal()) for s in SHAPES]
    plan = PartitionPlan.build(NAMES, SHAPES, 3,
                               rules=[("tok_embed", "split")])
    ref = JaxPlan.build(NAMES, SHAPES, 3, rules=[("tok_embed", "split")])
    parts = plan.scatter(arrays)
    for mine, theirs in zip(parts, ref.scatter(arrays)):
        same_bits(mine, theirs)
    same_bits(plan.assemble(parts), arrays)
    with pytest.raises(ShardPlanError):
        plan.assemble(parts[:2])
    with pytest.raises(ShardPlanError):
        plan.assemble([parts[0][:-1]] + parts[1:])


@pytest.mark.parametrize("spec", ["bogus", "=1", "a=x", "(=1", "a=1.5"])
def test_parse_rules_raises_the_same_typed_errors(spec):
    with pytest.raises(JaxShardPlanError):
        jax_parse_rules(spec)
    with pytest.raises(ShardPlanError):
        parse_rules(spec)


def test_parse_rules_and_env_knobs_match_jax(monkeypatch):
    spec = "tok_embed=split; head=1 ;ln\\.bias=0"
    assert parse_rules(spec) == jax_parse_rules(spec)
    monkeypatch.setenv("DKTPU_PS_SHARD_RULES", "tok_embed=split")
    monkeypatch.setenv("DKTPU_PS_SHARD_CAP_BYTES", "100000")
    monkeypatch.setenv("DKTPU_PS_SHARD_OPT_FACTOR", "1.5")
    arrays = [np.zeros(s, np.float32) for s in SHAPES]
    port = plan_for_model(arrays, 2, names=NAMES, opt_factor=9.0)
    ref = jax_plan_for_model(arrays, 2, names=NAMES, opt_factor=9.0)
    assert port.to_dict() == ref.to_dict()
    assert len(port.segments[0]) == 2  # the env's split rule
    monkeypatch.setenv("DKTPU_PS_SHARD_OPT_FACTOR", "-1")
    assert (plan_for_model(arrays, 2, names=NAMES, opt_factor=2.0).loads
            == jax_plan_for_model(arrays, 2, names=NAMES,
                                  opt_factor=2.0).loads)


def test_plan_from_dict_rejects_malformed():
    good = plan_for_model(leaves(), 2).to_dict()
    for bad in ({}, dict(good, version=99), dict(good, loads=[1]),
                dict(good, names=["a"])):
        with pytest.raises(ShardPlanError):
            PartitionPlan.from_dict(bad)
    with pytest.raises(ShardPlanError):
        PartitionPlan.from_json("{not json")
    back = PartitionPlan.from_json(PartitionPlan.from_dict(good).to_json())
    assert back == PartitionPlan.from_dict(good)


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "adagrad"])
def test_measured_opt_factor_matches_jax(optimizer):
    """Config #4's model (``imdb_lstm()`` at its own widths): the port's
    factor, measured from its optimizer state (adam's step count a Python
    int, counted as optax's 4-byte scalar), equals the JAX package's
    measure of optax's state exactly."""
    import jax

    from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
    from distkeras_tpu.netps.remote import _measured_opt_factor as jax_factor
    from distkeras_tpu.ops.optimizers import get_optimizer as jax_opt
    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch.netps.remote import _measured_opt_factor
    from distkeras_tpu_torch.ops.optimizers import get_optimizer

    jm = jax_imdb_lstm(seed=0)
    pm = imdb_lstm(seed=0, device="cpu")
    assert (sum(v.numel() for v in pm.params.values())
            == sum(np.size(a) for a in jax.tree.leaves(jm.params)))
    got = _measured_opt_factor(get_optimizer(optimizer, 0.01), pm.params)
    want = jax_factor(jax_opt(optimizer, 0.01), jm.params)
    assert got == want
    assert want == {"sgd": 0.0, "adagrad": 1.0}.get(optimizer, want)


def test_wire_declares_the_sharding_vocabulary():
    assert wire.CAPS["striping"] and wire.CAPS["sharding"]
    assert {"plan_hash", "sharding"} <= set(
        wire.OP_REGISTRY[wire.OP_PULL].replies)
    assert set(wire.OP_REGISTRY[wire.OP_PULL].replies) == set(
        jax_wire.OP_REGISTRY[jax_wire.OP_PULL].replies)
    assert "shard_plan" in wire.ERROR_KINDS
    assert wire.ERROR_KINDS <= jax_wire.ERROR_KINDS
    assert wire.HEADER_KEYS <= jax_wire.HEADER_KEYS
    assert {"num_shards", "shard", "idx", "want_plan", "plan_hash",
            "sharding", "shard_index", "shard_plan"} <= wire.HEADER_KEYS
    ep = "p0:7077,s0:7078;p1:7177 ; p2:1"
    assert (wire.split_shard_endpoints(ep)
            == jax_wire.split_shard_endpoints(ep))
    with pytest.raises(ValueError):
        wire.split_shard_endpoints(";;")
    with pytest.raises(ValueError):
        wire.split_shard_endpoints("a:1;nope")


# ---------------------------------------------------------------------------
# ShardSet + ShardedPSClient
# ---------------------------------------------------------------------------

def test_factory_routes_by_endpoint_shape():
    with shard_set(2, center=leaves()) as ss:
        c = make_ps_client(ss.endpoint, **FAST)
        assert isinstance(c, ShardedPSClient)
        c.close()
    srv = port_server(center=leaves()).start()
    try:
        c = make_ps_client(srv.endpoint, **FAST)
        assert isinstance(c, PSClient)
        c.close()
    finally:
        srv.close()


def test_two_shard_center_is_bit_identical_to_a_single_server():
    srv = port_server(center=leaves(), discipline="adag").start()
    try:
        with PSClient(srv.endpoint, **FAST) as c:
            single = drive(c, 4)
    finally:
        srv.close()
    F.reset_launches()
    with shard_set(2, center=leaves(), discipline="adag") as ss:
        with ShardedPSClient(ss.endpoint, plan=ss.plan, **FAST) as c:
            sharded = drive(c, 4)
            c.leave()
        same_bits(single, sharded)
        same_bits(single, ss.center())
        assert [s.commits_total for s in ss.servers] == [4, 4]
    assert not any(F.launch_counts().values())  # the CPU's plain twin


def test_join_shares_worker_id_and_counters_are_per_shard():
    with shard_set(2, center=leaves()) as ss:
        with ShardedPSClient(ss.endpoint, plan=ss.plan, **FAST) as c:
            center, counters = c.join(init=leaves())
            assert isinstance(counters, tuple) and len(counters) == 2
            assert all(s.worker_id == c.worker_id for s in c._subs)
            # Fold into shard 1 alone: only its counter moves.
            slices = c.plan.scatter([np.ones_like(a) for a in center])
            assert c._subs[1].commit(slices[1], counters[1], seq=0).applied
            _, after = c.pull()
            assert after == (counters[0], counters[1] + 1)


def test_same_seq_retransmit_dedups_on_every_shard():
    with shard_set(2, center=leaves()) as ss:
        with ShardedPSClient(ss.endpoint, plan=ss.plan, **FAST) as c:
            center, counters = c.join(init=leaves())
            delta = [np.ones_like(a) for a in center]
            assert c.commit(delta, counters).applied
            slices = c.plan.scatter(delta)
            for k, sub in enumerate(c._subs):
                res = sub.commit(slices[k], counters[k], seq=c._seq)
                assert res.duplicate and not res.applied
            after, _ = c.pull()
            for a0, a1 in zip(leaves(), after):
                same_bits([a1], [(a0 + np.float32(1.0)).astype(np.float32)])
        assert [len(s.commit_log) for s in ss.servers] == [1, 1]


def test_evicted_shard_gets_one_same_seq_retransmit():
    """A shard that evicted the worker mid-commit is re-joined by its
    sub-client and the SAME seq retransmitted: it folds once, the other
    shard folded once too, and the commit is ACKed."""
    with shard_set(2, center=leaves(), lease_s=30.0) as ss:
        with ShardedPSClient(ss.endpoint, plan=ss.plan, **FAST) as c:
            center, counters = c.join(init=leaves())
            assert ss.servers[1].revoke(c.worker_id)
            res = c.commit([np.ones_like(a) for a in center], counters)
            assert res.applied and not res.evicted
            assert c.rejoin_count == 1
        for srv in ss.servers:
            assert [(w, s) for w, s, _ in srv.commit_log] == [(0, 0)]


def test_observer_adopts_plan_without_init():
    with shard_set(2, center=leaves()) as ss:
        with ShardedPSClient(ss.endpoint, **FAST) as c:
            center, _counters = c.pull()
            assert c.plan == ss.plan
            same_bits(center, leaves())


def test_rejoin_resumes_seq_high_water_mark():
    with shard_set(2, center=leaves()) as ss:
        c = ShardedPSClient(ss.endpoint, plan=ss.plan, **FAST)
        center, counters = c.join(init=leaves())
        for _ in range(3):
            c.commit([np.zeros_like(a) for a in center], counters)
        seq, wid = c._seq, c.worker_id
        c.close()
        with ShardedPSClient(ss.endpoint, worker_id=wid, plan=ss.plan,
                             **FAST) as c2:
            c2.join(init=leaves())
            assert c2._seq >= seq
            c2.leave()


def test_plan_less_shard_set_adopts_the_first_joiners_plan():
    plan = plan_for_model(leaves(), 2)
    with shard_set(2) as ss:  # no plan, no center: everything from the join
        with ShardedPSClient(ss.endpoint, plan=plan, **FAST) as c:
            drive(c, 2)
        assert ss.center() is not None and ss.plan == plan
        assert all(s.shard_plan == plan for s in ss.servers)


def test_concurrent_committers_fold_exactly_once():
    with shard_set(2, center=leaves(), discipline="adag") as ss:
        n_commits, errors = 3, []

        def work(seed):
            try:
                with ShardedPSClient(ss.endpoint, plan=ss.plan,
                                     **FAST) as c:
                    drive(c, n_commits, worker_seed=seed)
                    c.leave()
            except Exception as e:  # noqa: BLE001 - surfaced below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(s,)) for s in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        for srv in ss.servers:
            assert srv.commits_total == 2 * n_commits
            seqs = [(w, s) for w, s, _ in srv.commit_log]
            assert len(set(seqs)) == len(seqs)


# ---------------------------------------------------------------------------
# Typed rejections
# ---------------------------------------------------------------------------

def test_plan_hash_mismatch_is_typed():
    with shard_set(2, center=leaves()) as ss:
        other = PartitionPlan.from_arrays(leaves(), 2, rules=[(".*", 0)])
        assert other.plan_hash != ss.plan.plan_hash
        with ShardedPSClient(ss.endpoint, plan=other, **FAST) as c:
            with pytest.raises(ShardPlanError):
                c.join(init=leaves())


def test_plain_client_rejected_by_shard_server():
    with shard_set(2, center=leaves()) as ss:
        with PSClient(ss.endpoint.split(";")[0], **FAST) as c:
            with pytest.raises(ShardPlanError):
                c.join(init=None)


def test_shard_claim_rejected_by_plain_server():
    srv = port_server(center=leaves()).start()
    try:
        with ShardedPSClient(f"{srv.endpoint};{srv.endpoint}",
                             plan=plan_for_model(leaves(), 2), **FAST) as c:
            with pytest.raises(ShardPlanError):
                c.join(init=leaves())
    finally:
        srv.close()


def test_pre_sharding_peer_rejected(monkeypatch):
    old_caps = {k: v for k, v in wire.CAPS.items() if k != "sharding"}
    with shard_set(1, center=leaves()) as ss:
        monkeypatch.setattr(wire, "CAPS", old_caps)
        with PSClient(ss.endpoint, **FAST) as c:
            with pytest.raises(ProtocolError):
                c.join(init=None)


def test_plan_num_shards_must_match_matrix():
    with pytest.raises(ShardPlanError):
        ShardedPSClient("a:1;b:2;c:3", plan=plan_for_model(leaves(), 2),
                        **FAST)
    with pytest.raises(ValueError):
        shard_set(3, plan=plan_for_model(leaves(), 2))


# ---------------------------------------------------------------------------
# Server-side plan state, the CLI flag, the shard_crash fault
# ---------------------------------------------------------------------------

def test_plan_persisted_and_adopted_on_restart(tmp_path):
    plan = plan_for_model(leaves(), 2)
    state = str(tmp_path / "shard-1")
    port_server(shard_index=1, shard_count=2, shard_plan=plan,
                state_dir=state).start().close()
    saved = json.loads((tmp_path / "shard-1" / "plan.json").read_text())
    assert saved == {"shard_index": 1, "plan": plan.to_dict()}
    back = port_server(state_dir=state)
    try:
        assert back.shard_index == 1 and back.shard_count == 2
        assert back.shard_plan.plan_hash == plan.plan_hash
    finally:
        back.close()


def test_restarted_shard_refuses_a_drifted_plan(tmp_path):
    state = str(tmp_path / "shards")
    with shard_set(2, state_dir=state) as ss:
        with ShardedPSClient(ss.endpoint, **FAST) as c:
            drive(c, 2)
            c.leave()
        plan = ss.servers[0].shard_plan
    drifted = PartitionPlan.from_arrays(leaves(), 2, rules=[(".*", 1)])
    with shard_set(2, state_dir=state) as back:  # plans from plan.json
        assert all(s.shard_plan == plan for s in back.servers)
        assert [s.updates for s in back.servers] == [2, 2]
        with ShardedPSClient(back.endpoint, plan=drifted, **FAST) as c:
            with pytest.raises(ShardPlanError):
                c.join(init=leaves())
        with ShardedPSClient(back.endpoint, plan=plan, **FAST) as c:
            center, _ = c.join()
            same_bits(center, back.center())


def test_shard_index_range_checked():
    with pytest.raises(ValueError):
        port_server(shard_index=2, shard_count=2)


@pytest.mark.parametrize("bad", ["bogus", "3/2", "2/2", "-1/2"])
def test_cli_shard_arg_rejects_malformed(bad):
    from distkeras_tpu_torch.netps.__main__ import main

    with pytest.raises(SystemExit):
        main(["--shard", bad, "--port", "0", "--device", "cpu"])


def test_shard_crash_pending_is_a_non_consuming_peek():
    plan = FaultPlan.parse_net("shard_crash@1:12;seed=3")
    assert plan.pending("shard_crash", 1) == 12.0
    assert plan.pending("shard_crash", 1) == 12.0
    assert plan.pending("shard_crash", 0) is None
    assert plan.fire("shard_crash", 1) == 12.0
    assert plan.pending("shard_crash", 1) is None


def test_shard_crash_kills_only_its_shard_after_its_threshold(monkeypatch):
    """``shard_crash@1:2`` in the server's process: shard 0 never fires it
    (its peeks do not consume the one-shot), shard 1 kills itself on the
    commit request after its second fold, and only once."""
    from distkeras_tpu_torch.netps import server as server_mod

    kills = []
    monkeypatch.setattr(server_mod.os, "kill",
                        lambda pid, sig: kills.append((pid, sig)))
    faults.set_net_plan(FaultPlan.parse_net("shard_crash@1:2"))
    try:
        with shard_set(2, center=leaves()) as ss:
            with ShardedPSClient(ss.endpoint, plan=ss.plan, **FAST) as c:
                center, counters = c.join(init=leaves())
                for i in range(4):
                    c.commit([np.ones_like(a) for a in center], counters)
                    if i < 2:
                        assert not kills
                assert [s.commits_total for s in ss.servers] == [4, 4]
    finally:
        faults.set_net_plan(None)
    assert kills == [(os.getpid(), server_mod.signal.SIGKILL)]


# ---------------------------------------------------------------------------
# Cross-package, bit-exact
# ---------------------------------------------------------------------------

def test_jax_sharded_client_against_port_shard_set():
    srv = port_server(center=leaves(), discipline="adag").start()
    try:
        with PSClient(srv.endpoint, **FAST) as c:
            single = drive(c, 3)
    finally:
        srv.close()
    with shard_set(2, discipline="adag") as ss:
        c = JaxShardedClient(ss.endpoint, **FAST)
        try:
            got = drive(c, 3)
            c.leave()
        finally:
            c.close()
        same_bits(single, got)
        same_bits(single, ss.center())
        assert ss.plan.plan_hash == c.plan.plan_hash


def test_port_sharded_client_against_jax_shard_set():
    srv = port_server(center=leaves(), discipline="adag").start()
    try:
        with PSClient(srv.endpoint, **FAST) as c:
            single = drive(c, 3)
    finally:
        srv.close()
    with JaxShardSet(2, discipline="adag") as ss:
        with ShardedPSClient(ss.endpoint, **FAST) as c:
            got = drive(c, 3)
            c.leave()
        same_bits(single, got)
        same_bits(single, ss.center())


def test_jax_shard_server_restarts_from_a_port_shard_directory(tmp_path):
    """A port shard gang journals under ``<dir>/shard-<k>``; JAX shard
    servers built on those directories adopt each ``plan.json`` and
    replay each journal into the same center, bit for bit."""
    state = str(tmp_path / "gang")
    with shard_set(2, state_dir=state, discipline="adag",
                   snapshot_every=0) as ss:
        with ShardedPSClient(ss.endpoint, **FAST) as c:
            drive(c, 3)
            c.leave()
        want, plan = ss.center(), ss.plan
    back = [JaxPSServer(state_dir=f"{state}/shard-{k}", discipline="adag")
            for k in range(2)]
    try:
        assert [s.shard_index for s in back] == [0, 1]
        assert all(s.shard_plan.plan_hash == plan.plan_hash for s in back)
        same_bits(want, plan.assemble([s.center() for s in back]))
    finally:
        for s in back:
            s.close()
