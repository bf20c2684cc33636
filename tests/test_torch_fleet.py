"""The port's fleet control plane (``distkeras_tpu_torch/fleet/``) held to
the JAX package's (``distkeras_tpu/fleet/``).

The scheduler: both packages' :class:`FleetScheduler` are driven
``tick()`` by ``tick()`` on the same injected clock with the same scripted
stand-in runtimes (cooperative threads through ``thread_factory=``, one
commit per live worker per tick), and the whole decision record must be
EQUAL: every tick's grants and release flags, every revocation, every
fleet event (kind and fields) and every ``fleet.*`` counter. The cases
mirror ``tests/test_fleet.py``: gang placement, quotas, FIFO within
priority, shrink-to-floor then re-expand, full preemption with requeue,
``preempt@R[:N]``, restarts and their budget, plus the serving floor, the
expansion gate, the health hook and the grace window.

``ElasticTraining`` on the CPU: at one worker the port's final center is
held to the JAX package's within rtol = atol = 1e-5 (f32 sums in another
order, as ``tests/test_torch_remote.py``), and to the port's own
``run_remote`` bit for bit (the same window code on the same fold); under
a shrink/expand cycle every planned ``(round, slice)`` item is committed
exactly once.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu.fleet as jfleet
import distkeras_tpu.resilience.faults as jfaults
import distkeras_tpu.telemetry as jtel
import distkeras_tpu_torch.fleet as pfleet
import distkeras_tpu_torch.resilience.faults as pfaults
import distkeras_tpu_torch.telemetry as ptel
from distkeras_tpu_torch.convert import params_from_jax

PKGS = {"jax": (jfleet, jfaults, jtel), "port": (pfleet, pfaults, ptel)}


# ---------------------------------------------------------------------------
# The scripted harness: one clock, cooperative threads, a stand-in runtime
# ---------------------------------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class ScriptThread:
    """``thread_factory=`` stand-in: ``start()`` runs the scheduler's body
    at once; the thread stays alive while the runtime holds the worker."""

    current = None

    def __init__(self, target=None, name="", **_kw):
        self.target, self.name = target, name
        self.alive = False
        self.registered = False

    def start(self):
        self.alive = True
        prev, ScriptThread.current = ScriptThread.current, self
        try:
            self.target()
        finally:
            ScriptThread.current = prev
        if not self.registered:
            self.alive = False  # crashed in worker_main: a dead thread

    def is_alive(self):
        return self.alive

    def join(self, timeout=None):
        return None


class ScriptRuntime:
    """``total`` commits of work; each live, unreleased worker makes one
    commit per :meth:`step`. ``crash_first`` spawns raise at once. A
    released worker exits ``linger`` steps after its release (a straggler
    in a long RPC)."""

    def __init__(self, name, total, crash_first=0, endpoint=None,
                 slots=None, linger=0):
        self.name, self.total = name, int(total)
        self.linger = int(linger)
        self.lingered = {}
        self.n = 0
        self.crash_left = int(crash_first)
        self.workers = {}
        self.revoked = []
        self.started = 0
        self.closed = False
        if endpoint is not None:
            self.endpoint = endpoint
        if slots is not None:
            self.worker_slots = slots

    def ensure_started(self):
        self.started += 1

    def worker_main(self, wid, should_run):
        th = ScriptThread.current
        if self.crash_left > 0:
            self.crash_left -= 1
            raise RuntimeError("injected worker crash")
        th.registered = True
        self.workers[wid] = (th, should_run)

    def step(self):
        for wid in sorted(self.workers):
            th, should_run = self.workers[wid]
            if not th.alive:
                continue
            if not should_run():
                self.lingered[wid] = self.lingered.get(wid, 0) + 1
                if self.lingered[wid] > self.linger:
                    th.alive = False
                    self.lingered.pop(wid)
                continue
            if self.n >= self.total:
                th.alive = False
                continue
            self.n += 1

    def kill(self, wid):
        th, _ = self.workers[wid]
        th.alive = False

    def progress(self):
        return self.n

    def done(self):
        return self.n >= self.total

    def revoke(self, wid):
        self.revoked.append(wid)

    def close(self):
        self.closed = True


class ScriptPolicy:
    """Expansion gate: refuses growth past ``cap`` workers per label and
    records what the scheduler fed it."""

    def __init__(self, cap):
        self.cap = cap
        self.seen = []

    def observe(self, label, workers, progress):
        self.seen.append((label, workers, progress))

    def allow_expand(self, label, workers):
        return workers < self.cap


class ScriptHealth:
    def __init__(self, down):
        self.down = down  # clock -> set of down endpoints

    def is_down(self, ep):
        return ep in self.down(ClockRef.clock())


class ClockRef:
    clock = None


def _trace(sched, runtimes, clock):
    return {
        "t": clock(),
        "stats": sched.stats(),
        "granted": {j.job_id: sorted((w.wid, w.release.is_set(), w.revoked)
                                     for w in sched._granted[j].values())
                    for j in sched.jobs()},
        "revoked": {name: list(rt.revoked) for name, rt in runtimes.items()},
        "progress": {name: rt.n for name, rt in runtimes.items()},
    }


def _events(tel):
    out = []
    for e in tel.get().events():
        if not e["kind"].startswith("fleet") and e["kind"] != "fault_injected":
            continue
        out.append({k: v for k, v in e.items() if k != "ts"})
    return out


def _counters(tel):
    snap = tel.get().snapshot()
    return {k: v for k, v in snap["counters"].items()
            if k.startswith("fleet.")}


def run_script(pkg, script):
    """Drive one package's scheduler through ``script`` and return the
    full decision record."""
    fleet, faults, tel = PKGS[pkg]
    tel.reset()
    clock = Clock()
    ClockRef.clock = clock
    spec = script()
    if spec.get("faults"):
        faults.set_net_plan(faults.FaultPlan.parse_net(spec["faults"]))
    kw = dict(spec.get("sched", {}))
    if "policy" in spec:
        kw["expansion_policy"] = spec["policy"]()
    if "health" in spec:
        kw["health_hook"] = ScriptHealth(spec["health"])
    sched = fleet.FleetScheduler(clock=clock, thread_factory=ScriptThread,
                                 **kw)
    runtimes, jobs = {}, {}
    pending = list(spec["jobs"])
    trace = []
    try:
        for tick in range(spec.get("ticks", 400)):
            for j in [j for j in pending if j["at"](tick, runtimes)]:
                pending.remove(j)
                rt = ScriptRuntime(j["name"], **j.get("rt", {}))
                runtimes[j["name"]] = rt
                jobs[j["name"]] = sched.submit(fleet.FleetJob(
                    j["name"], j["tenant"], rt, **j.get("job", {})))
            for name, wid in spec.get("kills", {}).get(tick, ()):
                runtimes[name].kill(wid)
            sched.tick()
            trace.append(_trace(sched, runtimes, clock))
            for name in sorted(runtimes):
                runtimes[name].step()
            clock.t += spec.get("dt", 0.5)
            if not pending and sched.all_terminal():
                break
        sched.close()
    finally:
        faults.set_net_plan(None)
    policy_seen = kw["expansion_policy"].seen if "policy" in spec else None
    return {"trace": trace, "events": _events(tel),
            "counters": _counters(tel),
            "floor_violations": sched.floor_violations,
            "states": {n: j.state for n, j in jobs.items()},
            "errors": {n: repr(j.error) for n, j in jobs.items()},
            "closed": {n: rt.closed for n, rt in runtimes.items()},
            "policy": policy_seen}


def at(tick):
    return lambda t, _rts: t >= tick


def after_progress(name, n):
    return lambda _t, rts: name in rts and rts[name].n >= n


SCRIPTS = {
    # test_gang_placement_waits_for_min_gang
    "gang_placement": lambda: {"sched": dict(capacity=4), "jobs": [
        dict(name="big", tenant="a", at=at(0), rt=dict(total=40),
             job=dict(min_gang=4, max_workers=4)),
        dict(name="late", tenant="b", at=at(0), rt=dict(total=10),
             job=dict(min_gang=2, max_workers=2))]},
    # test_tenant_quota_caps_grants_and_expansion
    "quota_caps": lambda: {"sched": dict(capacity=6,
                                         quotas={"capped": 2}), "jobs": [
        dict(name="j", tenant="capped", at=at(0), rt=dict(total=60),
             job=dict(min_gang=1, max_workers=6)),
        dict(name="k", tenant="free", at=at(0), rt=dict(total=60),
             job=dict(min_gang=1, max_workers=6))]},
    # test_quota_blocked_head_does_not_starve_other_tenants
    "quota_blocked_head": lambda: {"sched": dict(capacity=6,
                                                 quotas={"acme": 2}),
                                   "jobs": [
        dict(name="j1", tenant="acme", at=at(0), rt=dict(total=200),
             job=dict(min_gang=2, max_workers=2)),
        dict(name="j2", tenant="acme", at=at(1), rt=dict(total=10),
             job=dict(min_gang=1, max_workers=1)),
        dict(name="j3", tenant="bidco", at=at(1), rt=dict(total=10),
             job=dict(min_gang=2, max_workers=2))]},
    # test_fifo_within_priority
    "fifo_within_priority": lambda: {"sched": dict(capacity=2), "jobs": [
        dict(name="first", tenant="a", at=at(0), rt=dict(total=25),
             job=dict(min_gang=2, max_workers=2)),
        dict(name="second", tenant="a", at=at(0), rt=dict(total=5),
             job=dict(min_gang=2, max_workers=2))]},
    # test_priority_preempts_by_shrinking_victims_to_floor_then_reexpands
    "shrink_to_floor_then_reexpand": lambda: {
        "sched": dict(capacity=4), "jobs": [
            dict(name="victim", tenant="lo", at=at(0), rt=dict(total=250),
                 job=dict(priority=0, min_gang=2, max_workers=4)),
            dict(name="hot", tenant="hi", at=at(3), rt=dict(total=30),
                 job=dict(priority=5, min_gang=2, max_workers=2))]},
    # test_full_preemption_drains_gracefully_and_requeues_with_progress
    "full_preemption_requeue": lambda: {
        "sched": dict(capacity=2), "jobs": [
            dict(name="victim", tenant="lo", at=at(0), rt=dict(total=120),
                 job=dict(priority=0, min_gang=2, max_workers=2)),
            dict(name="hot", tenant="hi", at=after_progress("victim", 10),
                 rt=dict(total=20),
                 job=dict(priority=5, min_gang=2, max_workers=2))]},
    # test_forced_preempt_fault_kind_fires_on_commit_crossing
    "preempt_fault_shrinks": lambda: {
        "sched": dict(capacity=4), "faults": "preempt@5:2", "jobs": [
            dict(name="j", tenant="t", at=at(0), rt=dict(total=150),
                 job=dict(min_gang=2, max_workers=4))]},
    # test_forced_preempt_at_floor_drains_and_requeues
    "preempt_fault_at_floor_drains": lambda: {
        "sched": dict(capacity=2), "faults": "preempt@5", "jobs": [
            dict(name="j", tenant="t", at=at(0), rt=dict(total=120),
                 job=dict(min_gang=2, max_workers=2))]},
    # test_crashed_worker_is_restarted_within_budget (spawn crashes and a
    # live worker killed mid-run)
    "restarts_within_budget": lambda: {
        "sched": dict(capacity=2, max_restarts=3), "jobs": [
            dict(name="j", tenant="t", at=at(0),
                 rt=dict(total=30, crash_first=2),
                 job=dict(min_gang=1, max_workers=1))],
        "kills": {8: [("j", 0)]}},
    # test_restart_budget_exhaustion_fails_the_job
    "restart_budget_exhausted": lambda: {
        "sched": dict(capacity=2, max_restarts=1), "jobs": [
            dict(name="j", tenant="t", at=at(0),
                 rt=dict(total=30, crash_first=10),
                 job=dict(min_gang=1, max_workers=1))]},
    # the serving floor: a serving tenant shrinks to min_gang and is never
    # drained for a higher-priority arrival (fleet.serving_drains_refused)
    "serving_floor": lambda: {
        "sched": dict(capacity=4), "jobs": [
            dict(name="serve", tenant="web", at=at(0), rt=dict(total=10**9),
                 job=dict(priority=0, min_gang=1, max_workers=2,
                          kind="serving")),
            dict(name="train", tenant="lo", at=at(0), rt=dict(total=80),
                 job=dict(priority=0, min_gang=2, max_workers=2)),
            dict(name="hot", tenant="hi", at=at(4), rt=dict(total=20),
                 job=dict(priority=5, min_gang=4, max_workers=4))],
        "ticks": 60},
    # the expansion gate: growth stops at the policy's cap
    "expansion_gate": lambda: {
        "sched": dict(capacity=6), "policy": lambda: ScriptPolicy(3),
        "jobs": [dict(name="j", tenant="t", at=at(0), rt=dict(total=90),
                      job=dict(min_gang=1, max_workers=6))]},
    # the health hook: a down PS endpoint requeues its job once an outage
    "health_requeue": lambda: {
        "sched": dict(capacity=2),
        "health": lambda t: {"sim://j"} if 3.0 <= t < 5.0 else set(),
        "jobs": [dict(name="j", tenant="t", at=at(0),
                      rt=dict(total=60, endpoint="sim://j"),
                      job=dict(min_gang=2, max_workers=2))]},
    # the grace window: revocation only after preempt_grace has passed
    "grace_window": lambda: {
        "sched": dict(capacity=4, preempt_grace=2.0), "dt": 0.25, "jobs": [
            dict(name="victim", tenant="lo", at=at(0),
                 rt=dict(total=400, linger=12),
                 job=dict(priority=0, min_gang=1, max_workers=4)),
            dict(name="hot", tenant="hi", at=at(3), rt=dict(total=20),
                 job=dict(priority=5, min_gang=3, max_workers=3))],
        "ticks": 200},
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scheduler_decisions_match_jax_tick_by_tick(name):
    """Exact: the same grants, releases, revocations, events, counters and
    end states, tick by tick."""
    ref = run_script("jax", SCRIPTS[name])
    got = run_script("port", SCRIPTS[name])
    assert len(got["trace"]) == len(ref["trace"])
    for i, (g, r) in enumerate(zip(got["trace"], ref["trace"])):
        assert g == r, f"tick {i}"
    assert got == ref
    assert got["floor_violations"] == 0
    # what each case is about actually happened
    states, counters = got["states"], got["counters"]
    if name == "serving_floor":
        assert counters.get("fleet.serving_drains_refused", 0) >= 1
        assert all(t["stats"]["web/serve"]["active"] >= 1
                   for t in got["trace"][1:])
    elif name == "restart_budget_exhausted":
        assert states == {"j": "failed"}
    elif name == "health_requeue":
        assert counters["fleet.liveness_requeues"] == 1
    elif name == "expansion_gate":
        assert max(t["stats"]["t/j"]["active"] for t in got["trace"]) == 3
        assert got["policy"]
    elif name == "grace_window":
        rev = [t["revoked"]["victim"] for t in got["trace"]]
        first = next(i for i, r in enumerate(rev) if r)
        assert first > 3  # flagged at tick 3, revoked only after the grace
    if name != "restart_budget_exhausted" and "serve" not in states:
        assert all(s == "done" for s in states.values()), states


def test_gang_placement_waits_for_min_gang():
    rec = run_script("port", SCRIPTS["gang_placement"])
    first = rec["trace"][0]["stats"]
    assert first["a/big"]["state"] == "running"
    assert first["b/late"]["state"] == "queued"
    starts = [e["job"] for e in rec["events"] if e["kind"] == "fleet_start"]
    assert starts == ["big", "late"]


def test_min_gang_that_can_never_fit_is_rejected_at_submit():
    for fleet, _faults, _tel in PKGS.values():
        sched = fleet.FleetScheduler(capacity=2, tick_s=0.01)
        with pytest.raises(ValueError, match="exceeds pool capacity"):
            sched.submit(fleet.FleetJob("x", "a", ScriptRuntime("x", 1),
                                        min_gang=3, max_workers=3))
        with pytest.raises(ValueError, match="exceeds tenant quota"):
            fleet.FleetScheduler(capacity=8, quotas={"a": 1}).submit(
                fleet.FleetJob("x", "a", ScriptRuntime("x", 1), min_gang=2,
                               max_workers=2))
        with pytest.raises(ValueError, match="kind must be"):
            fleet.FleetJob("x", "a", None, kind="batch")
        sched.close()


def test_tenant_quota_caps_grants_and_expansion():
    rec = run_script("port", SCRIPTS["quota_caps"])
    peak_capped = max(t["stats"]["capped/j"]["granted"] for t in rec["trace"])
    peak_free = max(t["stats"]["free/k"]["granted"] for t in rec["trace"])
    assert peak_capped == 2 and peak_free >= 4


def test_quota_blocked_head_does_not_starve_other_tenants():
    rec = run_script("port", SCRIPTS["quota_blocked_head"])
    t1 = rec["trace"][1]["stats"]
    assert t1["acme/j2"]["state"] == "queued"
    assert t1["bidco/j3"]["state"] == "running"


def test_priority_preempts_by_shrinking_then_reexpands():
    rec = run_script("port", SCRIPTS["shrink_to_floor_then_reexpand"])
    end = rec["trace"][-1]["stats"]["lo/victim"]
    assert end["shrinks"] == 2 and end["expands"] >= 2 and end["debt"] == 0
    placed = next(t for t in rec["trace"]
                  if t["stats"].get("hi/hot", {}).get("state") == "running")
    assert sorted(placed["revoked"]["victim"]) == [2, 3]
    assert placed["stats"]["lo/victim"]["active"] == 2


def test_full_preemption_drains_and_requeues():
    rec = run_script("port", SCRIPTS["full_preemption_requeue"])
    v = rec["trace"][-1]["stats"]["lo/victim"]
    assert v["requeues"] == 1 and v["preemptions"] == 2 and v["debt"] == 0


def test_preempt_fault_is_the_scheduler_consumer():
    rec = run_script("port", SCRIPTS["preempt_fault_shrinks"])
    j = rec["trace"][-1]["stats"]["t/j"]
    assert j["shrinks"] == 2 and j["preemptions"] == 2
    assert [e["fault"] for e in rec["events"]
            if e["kind"] == "fault_injected"] == ["preempt"]
    rec = run_script("port", SCRIPTS["preempt_fault_at_floor_drains"])
    assert rec["trace"][-1]["stats"]["t/j"]["requeues"] == 1


def test_restarts_and_the_budget():
    ok = run_script("port", SCRIPTS["restarts_within_budget"])
    assert ok["trace"][-1]["stats"]["t/j"]["restarts"] == 3
    assert ok["states"] == {"j": "done"}
    bad = run_script("port", SCRIPTS["restart_budget_exhausted"])
    assert bad["trace"][-1]["stats"]["t/j"]["restarts"] == 1
    assert "injected worker crash" in bad["errors"]["j"]
    assert bad["closed"] == {"j": True}


def test_scheduler_seam_defaults_and_expansion_default(monkeypatch):
    from distkeras_tpu_torch.netps.tuner.fleet import (
        MarginalThroughputPolicy)

    sched = pfleet.FleetScheduler(capacity=2)
    assert sched._clock is time.monotonic
    assert sched._thread_factory is threading.Thread
    assert sched.expansion_policy is None
    monkeypatch.setenv("DKTPU_NET_AUTOTUNE", "1")
    assert isinstance(pfleet.FleetScheduler(capacity=2).expansion_policy,
                      MarginalThroughputPolicy)
    monkeypatch.setenv("DKTPU_FLEET_CAPACITY", "7")
    monkeypatch.setenv("DKTPU_FLEET_QUOTA", "a=2;b=3")
    monkeypatch.setenv("DKTPU_FLEET_MAX_RESTARTS", "5")
    s = pfleet.FleetScheduler()
    assert (s.capacity, s.quotas, s.max_restarts) == (7, {"a": 2, "b": 3}, 5)


@pytest.mark.parametrize("name", ["DKTPU_FLEET_CAPACITY", "DKTPU_FLEET_TICK",
                                  "DKTPU_FLEET_PREEMPT_GRACE",
                                  "DKTPU_FLEET_QUOTA",
                                  "DKTPU_FLEET_MAX_RESTARTS",
                                  "DKTPU_SIM_SEED", "DKTPU_SIM_BAND_PCT"])
def test_fleet_and_sim_keys_match_the_jax_registry(name):
    from distkeras_tpu.runtime import config as jax_config
    from distkeras_tpu_torch.runtime import config

    port, ref = config.ENV_REGISTRY[name], jax_config.ENV_REGISTRY[name]
    assert (port.kind, port.default, port.doc, port.category) == (
        ref.kind, ref.default, ref.doc, ref.category)


def test_max_workers_beyond_runtime_slots_rejected_at_submit():
    for fleet, _faults, _tel in PKGS.values():
        sched = fleet.FleetScheduler(capacity=8, tick_s=0.01)
        with pytest.raises(ValueError, match="worker_slots"):
            sched.submit(fleet.FleetJob("x", "t",
                                        ScriptRuntime("x", 5, slots=4),
                                        min_gang=2, max_workers=8))
        sched.submit(fleet.FleetJob("ok", "t", ScriptRuntime("ok", 5,
                                                             slots=4),
                                    min_gang=1, max_workers=4))
        sched.close()


@pytest.mark.parametrize("spec", ["", "a=2; b=3", "acme=4;bidco=2;", "bogus"])
def test_parse_quotas_matches_jax(spec):
    if spec == "bogus":
        for fleet, _f, _t in PKGS.values():
            with pytest.raises(ValueError, match="tenant=N"):
                fleet.parse_quotas(spec)
        return
    assert pfleet.parse_quotas(spec) == jfleet.parse_quotas(spec)


# ---------------------------------------------------------------------------
# Telemetry attribution
# ---------------------------------------------------------------------------

def test_scoped_labels_qualify_names_and_events():
    tel = ptel
    tel.reset()
    assert tel.label_suffix() == ""
    with tel.scoped_labels(tenant="acme corp", job="j.0"):
        assert tel.label_suffix() == ".acme-corp.j-0"
        with tel.scoped_labels(job="inner"):
            assert tel.label_suffix() == ".acme-corp.inner"
        tel.event("labeled_probe", {"x": 1})
    with jtel.scoped_labels(tenant="acme corp", job="j.0"):
        assert jtel.label_suffix() == ".acme-corp.j-0"
    ev = [e for e in tel.get().events() if e["kind"] == "labeled_probe"]
    assert ev[-1]["tenant"] == "acme corp" and ev[-1]["job"] == "j.0"


def test_worker_events_carry_tenant_and_job_labels():
    """What the scheduler's worker thread fires is attributed: the body
    runs ``worker_main`` under ``scoped_labels(tenant=, job=)``."""
    ptel.reset()

    class Labeled(ScriptRuntime):
        def worker_main(self, wid, should_run):
            ptel.event("worker_probe", {"wid": wid})
            ptel.counter(f"fleet.commits{ptel.label_suffix()}").add(1)
            super().worker_main(wid, should_run)

    sched = pfleet.FleetScheduler(capacity=2, clock=Clock(),
                                  thread_factory=ScriptThread)
    rt = Labeled("lbl", 4)
    sched.submit(pfleet.FleetJob("lbl", "acme", rt, min_gang=2,
                                 max_workers=2))
    while not sched.all_terminal():
        sched.tick()
        rt.step()
    sched.close()
    ev = [e for e in ptel.get().events() if e["kind"] == "worker_probe"]
    assert len(ev) == 2 and all(e["tenant"] == "acme" and e["job"] == "lbl"
                                for e in ev)
    assert ptel.get().counter("fleet.commits.acme.lbl").value == 2


def test_report_fleet_attribution_matches_jax(tmp_path):
    from distkeras_tpu.telemetry.report import build_report as jax_report
    from distkeras_tpu_torch.telemetry.report import build_report

    rows = {}
    for name, tel in (("jax", jtel), ("port", ptel)):
        tel.reset()
        reg = tel.get()
        reg.counter("fleet.commits.tenA.job1").add(7)
        reg.counter("fleet.preemptions.tenA.job1").add(2)
        reg.counter("fleet.restarts.tenB.job2").add(1)
        reg.gauge("fleet.preempt_debt.tenA.job1").set(1.0)
        reg.gauge("fleet.staleness_mean.tenB.job2").set(0.5)
        path = tmp_path / f"{name}.jsonl"
        tel.write_jsonl(reg, str(path))
        rows[name] = (build_report if name == "port"
                      else jax_report)(str(path))["fleet"]
    assert rows["port"] == rows["jax"]
    by_key = {(r["tenant"], r["job"]): r for r in rows["port"]}
    assert by_key[("tenA", "job1")]["commits"] == 7
    assert by_key[("tenB", "job2")]["restarts"] == 1


# ---------------------------------------------------------------------------
# Ports and tree placement
# ---------------------------------------------------------------------------

def test_port_pool_reserves_distinct_probed_ports():
    import socket

    pool = pfleet.PortPool(lo=21200, hi=21300)
    ports = [pool.reserve() for _ in range(10)]
    assert len(set(ports)) == 10 and all(21200 <= p < 21300 for p in ports)
    squat = socket.socket()
    squat.bind(("127.0.0.1", 0))
    busy = squat.getsockname()[1]
    assert pfleet.PortPool(lo=busy, hi=busy + 50).reserve() != busy
    squat.close()
    pool.release(ports[0])
    assert ports[0] not in pool.reserved()


def test_reserve_port_is_process_unique_even_for_remote_hosts():
    assert pfleet.reserve_port("remote-host-a") != \
        pfleet.reserve_port("remote-host-a")


@pytest.mark.parametrize("spec,workers,hosts", [
    ("host:2", 4, ["h0", "h1"]),
    ("host:2,region:2", 8, ["h0", "h1", "h2", "h3"]),
    ("host:4", 4, ["solo"]),
])
def test_place_tree_matches_jax(spec, workers, hosts):
    """The rendered plan (reserve=False: port 0 everywhere), node for node:
    hosts, standbys, upstream failover lists, link keys, leaf endpoints
    and state labels."""
    from distkeras_tpu.fleet.placement import place_tree as jax_place

    root = "root:7000;root2:7001"
    ref = jax_place(spec, workers, hosts, root, reserve=False)
    got = pfleet.place_tree(spec, workers, hosts, root, reserve=False)

    def render(p):
        return ([vars(n) for n in p],
                [p.leaf_endpoint(r) for r in range(workers)],
                p.all_state_labels())

    assert render(got) == render(ref)


def test_place_tree_takes_distinct_ports_and_returns_them():
    """Pool-reserved ports are distinct; a caller's own ``reserve`` callable
    tracks them so a teardown can release every one."""
    taken = []

    def take(host):
        p = pfleet.reserve_port(host)
        taken.append(p)
        return p

    plan = pfleet.place_tree("host:2", 4, ["localhost", "localhost"],
                             "root:7000", reserve=take)
    ports = [n.port for n in plan] + [n.standby_port for n in plan]
    assert sorted(ports) == sorted(taken) and len(set(ports)) == len(ports)
    from distkeras_tpu_torch.fleet import ports as port_mod

    for p in taken:
        pfleet.release_port(p)
    assert not set(taken) & port_mod._POOL.reserved()


# ---------------------------------------------------------------------------
# ElasticTraining on the CPU
# ---------------------------------------------------------------------------

def _blobs(n=256, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(3, 4))
    y = rng.integers(0, 3, size=n)
    x = (centers[y] + rng.normal(scale=0.5, size=(n, 4))).astype(np.float32)
    return x, y.astype(np.int32)


def _tokens(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 50, (n, 6)).astype(np.int32),
            rng.integers(0, 2, n).astype(np.int32))


def _models(kind):
    """The same weights in both packages: an MLP on 4 features, or a
    small IMDB LSTM (the JAX one on its Pallas kernels in interpret
    mode)."""
    from distkeras_tpu.models import Model as JaxModel
    from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
    from distkeras_tpu.models.mlp import MLP as JaxMLP
    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch.models import MLP, Model

    if kind == "mlp":
        jm = JaxModel.build(JaxMLP(hidden=(16,), num_outputs=3),
                            jnp.zeros((1, 4), jnp.float32), seed=0)
        pm = Model.build(MLP(hidden=(16,), num_outputs=3, in_features=4),
                         np.zeros((1, 4), np.float32), device="cpu")
    else:
        small = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)
        jm = jax_imdb_lstm(**small, cell_impl="pallas", seed=1)
        pm = imdb_lstm(**small, device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return jm, pm


def _plans(x, y, W, window=2, batch=8, epochs=2):
    from distkeras_tpu.data.batching import make_batches as jax_batches
    from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
    from distkeras_tpu_torch.data import DataFrame
    from distkeras_tpu_torch.data.batching import make_batches

    cols = {"features": x, "label": y}
    kw = dict(batch_size=batch, num_workers=W, window=window,
              num_epoch=epochs, shuffle=True, seed=0)
    return (jax_batches(JaxDataFrame(cols), "features", "label", **kw),
            make_batches(DataFrame(cols), "features", "label", **kw))


def _run_fleet(fleet, rt, capacity, max_workers, min_gang=1):
    sched = fleet.FleetScheduler(capacity=capacity, tick_s=0.005)
    job = sched.submit(fleet.FleetJob("train", "acme", rt,
                                      min_gang=min_gang,
                                      max_workers=max_workers))
    stats = sched.run(timeout=120)["acme/train"]
    sched.close()
    return job, stats


@pytest.mark.parametrize("kind", ["mlp", "lstm"])
@pytest.mark.parametrize("discipline", ["adag", "dynsgd", "aeasgd"])
def test_elastic_training_one_worker_matches_jax(kind, discipline):
    from distkeras_tpu.ops.losses import get_loss as jax_loss
    from distkeras_tpu.ops.optimizers import get_optimizer as jax_opt
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer

    x, y = _blobs() if kind == "mlp" else _tokens()
    jm, pm = _models(kind)
    jplan, pplan = _plans(x, y, 1)
    loss = "sparse_categorical_crossentropy"
    common = dict(discipline=discipline, alpha=0.1, seed=0, lease_s=30.0)
    jrt = jfleet.ElasticTraining(model=jm, tx=jax_opt("sgd", 0.1),
                                 loss_fn=jax_loss(loss), plan=jplan, **common)
    prt = pfleet.ElasticTraining(model=pm, tx=get_optimizer("sgd", 0.1),
                                 loss_fn=get_loss(loss), plan=pplan,
                                 device="cpu", **common)
    jjob, _ = _run_fleet(jfleet, jrt, 1, 1)
    pjob, _ = _run_fleet(pfleet, prt, 1, 1)
    assert jjob.state == pjob.state == "done"
    assert prt.progress() == jrt.progress() == pplan.num_rounds
    assert [s for _w, s, _st in prt.server.commit_log] == \
        [s for _w, s, _st in jrt.server.commit_log]
    ref = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jrt.result().params), pm.module)
    got = prt.result().module.state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(prt.losses, jrt.losses, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_elastic_training_one_worker_is_run_remote_bit_for_bit(monkeypatch,
                                                               codec):
    """One slot claims the items in round-major order: run_remote's
    one-worker run, to the last bit, compressed commits included."""
    from distkeras_tpu_torch.netps import PSServer
    from distkeras_tpu_torch.netps.remote import run_remote
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer

    monkeypatch.setenv("DKTPU_NET_COMPRESS", codec)
    x, y = _tokens()
    _jm, pm = _models("lstm")
    _j, plan = _plans(x, y, 1)
    loss = get_loss("sparse_categorical_crossentropy")
    rt = pfleet.ElasticTraining(model=pm, tx=get_optimizer("sgd", 0.1),
                                loss_fn=loss, plan=plan,
                                discipline="dynsgd", seed=3, device="cpu")
    job, _ = _run_fleet(pfleet, rt, 1, 1)
    assert job.state == "done"
    srv = PSServer(discipline="dynsgd", device="cpu").start()
    try:
        params, losses = run_remote(
            endpoint=srv.endpoint, model=pm,
            tx=get_optimizer("sgd", 0.1), loss_fn=loss, plan=plan,
            discipline="dynsgd", window=plan.window, seed=3)
    finally:
        srv.close()
    for k, v in rt.result().params.items():
        assert torch.equal(v, params[k]), k
    np.testing.assert_array_equal(rt.losses, losses)


def test_jax_elastic_training_one_worker_is_its_run_remote_bit_for_bit():
    """The reference's own pair at one worker is bit-equal too: the card's
    ``elastic_parity`` holds the port's pair to the same."""
    from distkeras_tpu.netps import PSServer as JaxPSServer
    from distkeras_tpu.netps.remote import run_remote as jax_run_remote
    from distkeras_tpu.ops.losses import get_loss as jax_loss
    from distkeras_tpu.ops.optimizers import get_optimizer as jax_opt

    x, y = _blobs()
    jm, _pm = _models("mlp")
    plan, _p = _plans(x, y, 1)
    loss = jax_loss("sparse_categorical_crossentropy")
    rt = jfleet.ElasticTraining(model=jm, tx=jax_opt("sgd", 0.1),
                                loss_fn=loss, plan=plan, discipline="dynsgd")
    _run_fleet(jfleet, rt, 1, 1)
    srv = JaxPSServer(discipline="dynsgd").start()
    try:
        params, _losses = jax_run_remote(
            endpoint=srv.endpoint, model=jm, tx=jax_opt("sgd", 0.1),
            loss_fn=loss, plan=plan, discipline="dynsgd",
            window=plan.window)
    finally:
        srv.close()
    for a, b in zip(jax.tree_util.tree_leaves(rt.result().params),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_elastic_training_survives_shrink_expand_and_converges():
    """The scheduler shrinks the job to its floor (``preempt@2:2``) and
    re-expands it; every planned (round, slice) item is committed exactly
    once, each slot on its own loop, and the model converges."""
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer

    x, y = _blobs(512)
    _jm, pm = _models("mlp")
    _j, plan = _plans(x, y, 4, window=4, batch=16, epochs=4)
    rt = pfleet.ElasticTraining(
        model=pm, tx=get_optimizer("sgd", 0.1),
        loss_fn=get_loss("sparse_categorical_crossentropy"), plan=plan,
        discipline="adag", seed=0, lease_s=5.0, timeout=2.0, retries=5,
        backoff=0.02, device="cpu")
    pfaults.set_net_plan(pfaults.FaultPlan.parse_net("preempt@2:2"))
    try:
        job, stats = _run_fleet(pfleet, rt, 4, 4, min_gang=2)
    finally:
        pfaults.set_net_plan(None)
    assert job.state == "done"
    assert stats["preemptions"] >= 2 and job.shrinks >= 2
    assert job.expands >= 2, "the squeezed job must re-expand"
    # one loop a slot, each on its own copy of the module
    assert len(rt._loops) == 4
    seen = set()
    for wid, seq, _st in rt.server.commit_log:
        assert (wid, seq) not in seen
        seen.add((wid, seq))
    assert rt.done()
    assert rt.progress() == len(rt.server.commit_log) == \
        plan.num_rounds * plan.num_workers
    assert not np.isnan(rt.losses).any(), "a planned slice never trained"
    acc = float((rt.result().predict(x).argmax(-1).numpy() == y).mean())
    assert acc > 0.9, f"elastic run failed to converge: {acc}"


def test_elastic_training_slots_keep_their_own_loops():
    """Each slot's loop reparametrizes a module of its own: no two slots
    share one (the scheduler reuses a slot id only after its thread is
    joined)."""
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer

    x, y = _blobs()
    _jm, pm = _models("mlp")
    _j, plan = _plans(x, y, 3)
    rt = pfleet.ElasticTraining(
        model=pm, tx=get_optimizer("sgd", 0.1),
        loss_fn=get_loss("sparse_categorical_crossentropy"), plan=plan,
        device="cpu")
    try:
        rt.ensure_started()
        rt.ensure_started()  # idempotent
        assert len(rt._loops) == rt.worker_slots == 3
        assert rt.server is not None and rt.endpoint == rt.server.endpoint
        assert len({id(loop) for loop in rt._loops}) == 3
    finally:
        rt.close()
    assert rt.result() is pm  # nothing committed: the as-built model
