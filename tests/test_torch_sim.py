"""The port's fleet simulator (``distkeras_tpu_torch/sim/``) held to the
JAX package's (``distkeras_tpu/sim/``), case for case with
``tests/test_sim.py`` and as parity on the same inputs.

Tolerances: the simulator is host arithmetic over one seeded
``random.Random``, so the two packages agree EXACTLY where they compute
the same thing: every scenario's output dict at a small size is compared
as JSON after rounding floats to 9 significant digits (rel. 1e-9: no
difference is expected, the rounding only keeps the comparison blind to
the last digit of a printed float); ``SimCenter``'s center bits, commit
log and staleness are equal bit for bit on a seeded commit stream; the
timing model, ``predict_throughput``, ``sim_drift`` and ``hier_crossover``
give equal dicts on the same records and curves. The port's own traced
loopback run (its spans) must carry every segment the timing model reads.
"""

import json
import math
import os
import threading
import time

import numpy as np
import pytest

import distkeras_tpu.sim as jsim
import distkeras_tpu_torch.sim as psim
from distkeras_tpu.sim.__main__ import main as jax_sim_main
from distkeras_tpu.sim.calibrate import predict_throughput as jax_predict
from distkeras_tpu.sim.cluster import SimCenter as JaxSimCenter
from distkeras_tpu_torch.netps.fold import counter_staleness
from distkeras_tpu_torch.sim import (
    SimCenter,
    SimEngine,
    SimJobRuntime,
    SimThreadFactory,
    TimingModel,
    hier_crossover,
    run_scenario,
    sim_drift,
)
from distkeras_tpu_torch.sim.__main__ import main as sim_main
from distkeras_tpu_torch.sim.calibrate import predict_throughput
from distkeras_tpu_torch.sim.cluster import (
    LinkClass,
    SimAggregator,
    TreeTopology,
)

SUMMARY = os.path.join(os.path.dirname(__file__), os.pardir,
                       "BENCH_SUMMARY.json")


def _round(obj, sig=9):
    if isinstance(obj, float):
        return float(f"{obj:.{sig}g}") if math.isfinite(obj) else repr(obj)
    if isinstance(obj, dict):
        return {str(k): _round(v, sig) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_round(v, sig) for v in obj]
    return obj


def _canon(out: dict) -> str:
    return json.dumps(_round(out), sort_keys=True)


# -- the event engine -------------------------------------------------------

def test_engine_heap_orders_same_time_events_by_schedule_order():
    eng = SimEngine(0)
    seen = []
    for i in range(32):
        eng.at(1.0, seen.append, i)
    eng.run()
    assert seen == list(range(32))
    assert eng.now() == 1.0


def test_engine_past_is_clamped_and_until_advances_clock():
    eng = SimEngine(0)
    eng.at(5.0, lambda: eng.at(1.0, lambda: None))
    eng.run(until=9.0)
    assert eng.now() == 9.0
    assert eng.pending() == 0


def test_engine_rng_is_seed_deterministic_and_the_reference_draw():
    a, b, ref = SimEngine(7), SimEngine(7), jsim.SimEngine(7)
    draws = [a.lognormal(0.0, 0.5) for _ in range(64)]
    assert draws == [b.lognormal(0.0, 0.5) for _ in range(64)]
    assert draws == [ref.lognormal(0.0, 0.5) for _ in range(64)]
    assert SimEngine(8).lognormal(0.0, 0.5) != SimEngine(7).lognormal(0.0,
                                                                      0.5)


def test_engine_default_seed_is_the_registry_key(monkeypatch):
    monkeypatch.setenv("DKTPU_SIM_SEED", "11")
    assert SimEngine().seed == 11 == jsim.SimEngine().seed


def test_engine_runaway_backstop_raises():
    eng = SimEngine(0)

    def rearm():
        eng.after(0.1, rearm)

    eng.after(0.0, rearm)
    with pytest.raises(RuntimeError, match="runaway"):
        eng.run(max_events=100)


# -- counter-rule parity: SimCenter vs the netps fold functions -------------

def test_sim_center_staleness_matches_counter_staleness():
    c = SimCenter(discipline="downpour")
    pulled = c.pull()
    for i in range(5):
        c.commit(wid=0, seq=i, pulled=pulled)
    assert [st for _w, _s, st in c.commit_log] \
        == [counter_staleness(i, 0) for i in range(5)]
    assert c.max_staleness == 4


def test_sim_center_sharded_pull_uses_min_rule():
    c = SimCenter(discipline="downpour", shards=3)
    pulled = c.pull()
    assert pulled == (0, 0, 0)
    c.commit(0, 0, pulled)
    res = c.commit(0, 1, pulled)
    assert res["staleness"] == counter_staleness((1, 1, 1), pulled) == 1


def test_sim_center_dedup_and_value_witness():
    c = SimCenter(discipline="downpour")
    c.commit(0, 0, c.pull(), value=1.0)
    dup = c.commit(0, 0, c.pull(), value=1.0)
    assert dup == {"applied": False, "duplicate": True, "staleness": None}
    c.commit(1, 0, c.pull(), value=1.0)
    assert c.duplicates == 1
    assert c.exactly_once()
    assert c.center_value() == float(c.commits_total) == 2.0


def test_sim_center_promote_bumps_epoch_and_keeps_dedup():
    c = SimCenter()
    c.commit(0, 0, c.pull())
    assert c.promote() == 1
    assert c.epoch_history == [0, 1]
    assert c.commit(0, 0, c.pull())["duplicate"]


@pytest.mark.parametrize("discipline", ["downpour", "adag", "dynsgd",
                                        "aeasgd", "eamsgd"])
@pytest.mark.parametrize("shards", [1, 3])
def test_sim_center_matches_jax_on_a_seeded_commit_stream(discipline,
                                                          shards):
    """Bit for bit: 400 commits of 6 workers with seeded values, held
    pulls (staleness up to ~40) and retransmits; the center's f32 bits,
    the commit log and every result equal the JAX package's."""
    rng = np.random.default_rng(shards)
    got = SimCenter(discipline=discipline, shards=shards)
    ref = JaxSimCenter(discipline=discipline, shards=shards)
    seq = {w: 0 for w in range(6)}
    held = {w: got.pull() for w in range(6)}
    for i in range(400):
        w = int(rng.integers(6))
        if rng.random() < 0.3:
            held[w] = got.pull()
            assert held[w] == ref.pull()
        value = float(rng.normal(scale=10.0 ** rng.integers(-3, 2)))
        s = seq[w] - (1 if rng.random() < 0.05 and seq[w] else 0)
        a = got.commit(w, s, held[w], value)
        b = ref.commit(w, s, held[w], value)
        assert a == b, i
        seq[w] = max(seq[w], s + 1)
    assert got._center[0].tobytes() == ref._center[0].tobytes()
    assert got.commit_log == ref.commit_log
    assert (got.duplicates, got.max_staleness, got.commits_total) == (
        ref.duplicates, ref.max_staleness, ref.commits_total)


def test_aggregator_flush_policy_and_min_forwarding():
    agg = SimAggregator("a", fan_in=3, flush_s=10.0)
    assert agg.fold(0.0, 7, 1.0) is None
    assert agg.fold(0.1, 2, 1.0) is None
    out = agg.fold(0.2, 5, 1.0)
    assert out["count"] == 3 and out["value"] == 3.0
    assert out["pulled"] == 2
    assert agg.fold(20.0, 9, 1.0) is None
    assert agg.fold(31.0, 9, 1.0)["count"] == 2
    assert agg.take(31.0) is None


def test_tree_topology_paths_and_partitions():
    topo = TreeTopology(64, [("host", 8, LinkClass("h", 0.001)),
                             ("pool", 4, LinkClass("p", 0.002))])
    assert topo.group_of(63, 0) == 7 and topo.group_of(63, 1) == 1
    assert [a.name for a in topo.path(0)] == ["host-0", "pool-0"]
    topo.partition(1, 1, 2.0, 4.0)
    assert topo.link_down(1, 1, 3.0) and not topo.link_down(1, 0, 3.0)
    assert topo.heals_at(1, 1, 3.0) == 4.0
    assert topo.heals_at(1, 1, 5.0) == 5.0
    with pytest.raises(ValueError, match="unknown codec"):
        LinkClass("x", 0.001, codec="zstd")


# -- the seams --------------------------------------------------------------

def test_scheduler_seam_defaults_are_production():
    from distkeras_tpu_torch.fleet.scheduler import FleetScheduler

    sched = FleetScheduler(capacity=2)
    assert sched._clock is time.monotonic
    assert sched._thread_factory is threading.Thread


def _hub_series(pkg):
    """One scripted feed through a package's hub: gauges, counters and
    span samples on a virtual clock, with misses in between."""
    mod = __import__(f"{pkg}.telemetry.health.hub", fromlist=["MetricsHub"])
    eng = (SimEngine if pkg.endswith("torch") else jsim.SimEngine)(0)
    hub = mod.MetricsHub(targets={}, interval=1.0, ring=64, down_after=3,
                         use_registry=False, clock=eng.clock())
    out = []
    for i in range(12):
        eng._now = float(i)
        if 5 <= i < 9:
            hub.feed_miss("t0", role="serving")
        else:
            hub.feed("t0", "serving.latency", 0.1 * (i % 4), role="serving")
            hub.feed("t0", "fleet.commits", 3.0 * i, kind="counter")
            hub.feed("t0", "serve.request", 0.001 * (1 + i), kind="span")
        out.append((hub.is_down("t0"),
                    hub.measure("serving.latency", stat="mean",
                                window_s=4.0),
                    hub.measure("fleet.commits", stat="rate", window_s=4.0),
                    hub.measure("serve.request", stat="p99", window_s=4.0)))
    t = hub._targets["t0"]
    return out, (t.role, t.misses, t.down, t.ever_up, t.last_ok,
                 t.last_error)


def test_hub_feed_seam_series_and_liveness():
    from distkeras_tpu_torch.telemetry.health.hub import MetricsHub

    eng = SimEngine(0)
    hub = MetricsHub(targets={}, interval=1.0, ring=64, down_after=3,
                     use_registry=False, clock=eng.clock())
    hub.feed("t0", "serving.latency", 0.2, role="serving")
    eng._now = 1.0
    hub.feed("t0", "serving.latency", 0.4, role="serving")
    assert hub.measure("serving.latency", stat="mean",
                       window_s=10.0) == pytest.approx(0.3)
    assert not hub.is_down("t0")
    for _ in range(3):
        eng._now += 1.0
        hub.feed_miss("t0", role="serving")
    assert hub.is_down("t0")
    hub.feed("t0", "serving.latency", 0.2, role="serving")
    assert not hub.is_down("t0")
    assert hub._targets["t0"].last_ok == eng.now()  # the hub's clock
    with pytest.raises(ValueError, match="gauge/counter/span"):
        hub.feed("t0", "x", 1.0, kind="meter")


def test_hub_feed_matches_jax():
    """Exact: every kind's windowed measure and the liveness state, fed
    the same script on the same virtual clock."""
    assert _hub_series("distkeras_tpu_torch") == _hub_series("distkeras_tpu")


def test_collector_write_round_trips_and_matches_jax(tmp_path):
    from distkeras_tpu.telemetry.tracing.collector import (
        TelemetryCollector as JaxCollector)
    from distkeras_tpu_torch.telemetry.tracing.collector import (
        TelemetryCollector)

    src = tmp_path / "src"
    src.mkdir()
    recs = _synthetic_records(workers=2, commits=6, seed=3)
    (src / "trace-trainer-1.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))
    out, ref = tmp_path / "out", tmp_path / "ref"
    out.mkdir()
    ref.mkdir()
    n = TelemetryCollector.from_dir(str(src)).write(
        str(out / "trace-merged-1.jsonl"))
    m = JaxCollector.from_dir(str(src)).write(
        str(ref / "trace-merged-1.jsonl"))
    assert n == m == len(recs)
    assert (out / "trace-merged-1.jsonl").read_text() == \
        (ref / "trace-merged-1.jsonl").read_text()
    back = TelemetryCollector.from_dir(str(out)).records()
    assert [r["span"] for r in back] == \
        [r["span"] for r in TelemetryCollector.from_dir(str(src)).records()]
    import io

    buf = io.StringIO()
    assert TelemetryCollector.from_dir(str(src)).write(buf) == n


def test_sim_thread_runs_scheduler_worker_synchronously():
    from distkeras_tpu_torch.fleet.job import FleetJob
    from distkeras_tpu_torch.fleet.scheduler import FleetScheduler

    eng = SimEngine(3)
    factory = SimThreadFactory(eng)
    rt = SimJobRuntime(eng, "tiny", lambda e, w: 0.1, rounds_target=40)
    sched = FleetScheduler(capacity=8, tick_s=0.5,
                           clock=eng.clock(), thread_factory=factory)
    job = sched.submit(FleetJob("tiny", "acme", rt, min_gang=2,
                                max_workers=8))
    before = threading.active_count()

    def tick():
        sched.tick()
        if not sched.all_terminal():
            eng.after(0.5, tick)

    eng.after(0.0, tick)
    eng.run()
    sched.close()
    assert threading.active_count() == before  # no OS thread was built
    assert factory.created >= 8
    assert sched.stats()[job.job_id]["state"] == "done"
    assert rt.center.exactly_once()
    assert rt.rounds_done >= 40


def test_sim_runtime_crash_lose_ack_forces_deduped_retransmit():
    eng = SimEngine(1)
    rt = SimJobRuntime(eng, "j", lambda e, w: 0.2, rounds_target=10)
    th = SimThreadFactory(eng)(target=lambda: None)
    eng.current_thread = th
    rt.worker_main(0, lambda: True)
    eng.current_thread = None
    eng.run(until=1.05)
    applied = rt.center.commits_total
    assert rt.crash(0, lose_ack=True)
    eng.current_thread = SimThreadFactory(eng)(target=lambda: None)
    rt.worker_main(0, lambda: True)
    eng.current_thread = None
    eng.run()
    assert rt.center.duplicates == 1
    assert rt.center.exactly_once()
    assert rt.rounds_done == 10 == rt.center.commits_total
    assert rt.center.commits_total >= applied
    with pytest.raises(RuntimeError, match="outside a SimThread"):
        rt.worker_main(1, lambda: True)


# -- the timing model: synthetic records, then the port's own traced run ----

def _synthetic_records(workers=3, commits=20, seed=0):
    """A merged trace stream as the collector gives it: one ``commit``
    root a commit (with its worker id) and the lifecycle spans under it,
    durations lognormal from a seed."""
    rng = np.random.default_rng(seed)
    recs = []
    t = {w: 0.0 for w in range(workers)}
    for i in range(commits):
        for w in range(workers):
            segs = {name: float(rng.lognormal(math.log(mean), 0.3))
                    for name, mean in (("encode", 2e-4), ("wire", 5e-4),
                                       ("queue", 1e-4), ("fold", 8e-4),
                                       ("ack", 3e-4))}
            e2e = sum(segs.values()) * 1.1
            tid = f"{w:02d}{i:04d}"
            t[w] += float(rng.lognormal(math.log(0.02), 0.2))
            recs.append({"kind": "trace_span", "trace": tid,
                         "span": f"{tid}-r", "parent": None,
                         "name": "commit", "t0": t[w], "ts": t[w],
                         "dur": e2e, "wid": w})
            t0 = t[w]
            for j, (name, d) in enumerate(segs.items()):
                recs.append({"kind": "trace_span", "trace": tid,
                             "span": f"{tid}-{j}", "parent": f"{tid}-r",
                             "name": f"commit.{name}", "t0": t0, "ts": t0,
                             "dur": d, "wid": w})
                t0 += d
            t[w] += e2e
    return recs


@pytest.mark.parametrize("workers,commits,seed", [(1, 12, 0), (3, 20, 1),
                                                  (4, 3, 2)])
def test_timing_model_and_replays_match_jax_on_synthetic_records(
        workers, commits, seed):
    recs = _synthetic_records(workers, commits, seed)
    got, ref = TimingModel.from_records(recs), \
        jsim.TimingModel.from_records(recs)
    assert got.describe() == ref.describe()
    assert got.commits == workers * commits
    assert predict_throughput(recs, tokens_per_round=256.0, seed=seed) == \
        jax_predict(recs, tokens_per_round=256.0, seed=seed)
    for band in (None, 5.0):
        a = sim_drift(recs, 1234.5, tokens_per_round=256.0, band_pct=band)
        b = jsim.sim_drift(recs, 1234.5, tokens_per_round=256.0,
                           band_pct=band)
        assert a == b
    assert a["workers"] == workers and a["sim_commits"] == a["workers"] * \
        a["rounds"]


def test_sim_drift_without_records_reads_nothing():
    out = sim_drift([], 100.0, tokens_per_round=1.0)
    assert out["value"] is None and out["within_band"] is None
    assert out == jsim.sim_drift([], 100.0, tokens_per_round=1.0)


@pytest.fixture(scope="module")
def traced_records(tmp_path_factory):
    """One real port PSServer/PSClient loopback run on the CPU with
    tracing on: the stream the timing model fits (the shape config #8's
    ``sim_drift`` fits on the card). Returns (records,
    measured_commits_per_sec)."""
    from distkeras_tpu_torch.netps.client import PSClient
    from distkeras_tpu_torch.netps.server import PSServer
    from distkeras_tpu_torch.telemetry.tracing import context as trace_ctx
    from distkeras_tpu_torch.telemetry.tracing import recorder
    from distkeras_tpu_torch.telemetry.tracing.collector import (
        TelemetryCollector)

    td = str(tmp_path_factory.mktemp("sim-traces"))
    saved = {k: os.environ.get(k) for k in ("DKTPU_TRACE",
                                            "DKTPU_TRACE_DIR")}
    os.environ["DKTPU_TRACE"] = "1"
    os.environ["DKTPU_TRACE_DIR"] = td
    trace_ctx._reset_stream()
    rounds = 12
    try:
        srv = PSServer(discipline="adag", host="127.0.0.1", port=0,
                       device="cpu").start()
        try:
            tmpl = [np.zeros(64, np.float32)]
            cl = PSClient(srv.endpoint, worker_id=0)
            cl.join(init=tmpl)
            t0 = time.perf_counter()
            for i in range(rounds):
                cl.commit([np.ones_like(a) for a in tmpl], i)
            dt = time.perf_counter() - t0
            cl.leave()
            cl.close()
        finally:
            srv.close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        trace_ctx._reset_stream()
        recorder._reset()
    return TelemetryCollector.from_dir(td).records(), rounds / dt


def test_timing_model_fits_lifecycle_segments(traced_records):
    """The port's spans carry every segment the model reads."""
    records, _rate = traced_records
    model = TimingModel.from_records(records)
    assert model.commits >= 10
    assert {"encode", "wire", "queue", "fold", "ack"} <= set(model.segments)
    desc = model.describe()
    for info in desc["segments"].values():
        assert info["count"] > 0 and info["mean_s"] >= 0.0
    eng = SimEngine(0)
    assert model.sample_service(eng) >= 0.0
    assert model.sample_commit_client(eng) >= 0.0
    assert desc == jsim.TimingModel.from_records(records).describe()


def test_sim_drift_predicts_real_loopback_within_structure(traced_records):
    records, rate = traced_records
    out = sim_drift(records, measured_tokens_per_sec=rate,
                    tokens_per_round=1.0)
    assert out["metric"] == "sim_predicted_vs_measured_tokens_per_sec"
    assert out["workers"] == 1 and out["rounds"] >= 10
    assert out["predicted_tokens_per_sec"] > 0
    assert isinstance(out["within_band"], bool)
    assert out == sim_drift(records, measured_tokens_per_sec=rate,
                            tokens_per_round=1.0)
    assert out == jsim.sim_drift(records, measured_tokens_per_sec=rate,
                                 tokens_per_round=1.0)


def test_predict_throughput_infers_workers_and_rounds(traced_records):
    records, _rate = traced_records
    out = predict_throughput(records=records, tokens_per_round=128.0)
    assert out["workers"] == 1
    assert out["commits_per_sec"] > 0
    assert out["tokens_per_sec"] == pytest.approx(
        128.0 * out["commits_per_sec"])


# -- calibration gates ------------------------------------------------------

def _curve(seed=0, slope=0.9):
    """A flat/hier curve at W = 1, 2, 4 built here: flat throughput
    saturating on one serialized root, hier paying an aggregator hop but
    cutting the root's commits by the fan-in."""
    rng = np.random.default_rng(seed)
    rows, rounds, tpr = [], 6, 2048.0
    for w in (1, 2, 4):
        for topo in ("flat", "hier"):
            per = 0.05 * (1.0 + (w - 1) * slope) if topo == "flat" else \
                0.06 * (1.0 + (w - 1) * 0.35)
            cps = w / per * float(rng.uniform(0.97, 1.03))
            roots = rounds * w if topo == "flat" else \
                max(1, (rounds * w) // w + (w > 1))
            rows.append({"workers": w, "topology": topo,
                         "tokens_per_sec": cps * tpr,
                         "root_commits": roots,
                         "worker_commits_per_sec": cps})
    return {"configs": [{"metric": "netps_loopback_aeasgd", "hier_curve":
                         rows}]}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hier_crossover_matches_jax_on_a_built_curve(seed):
    curve = _curve(seed)
    for kw in ({}, {"band_pct": 5.0, "flush_s": 0.2, "seed": 4}):
        assert hier_crossover(summary=curve, **kw) == \
            jsim.hier_crossover(summary=curve, **kw)


def test_hier_crossover_gate_against_bench_summary():
    out = hier_crossover(summary=SUMMARY)
    assert out == jsim.hier_crossover(summary=SUMMARY)
    assert out["within_band"], out
    assert out["crossover_reproduced"], out
    assert out["predicted_crossover_workers"] \
        == out["measured_crossover_workers"] == 4
    held_out = [p for p in out["points"] if p["held_out"]]
    assert len(held_out) >= 2
    assert all(p["error_pct"] <= out["band_pct"] for p in held_out)
    assert out["measured_ingress_cut"] >= 2.5


def test_hier_crossover_is_seed_deterministic():
    a = hier_crossover(summary=SUMMARY, seed=5)
    b = hier_crossover(summary=SUMMARY, seed=5)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    with pytest.raises(ValueError, match="no hier_curve"):
        hier_crossover(summary={"configs": [{"metric": "m"}]})
    with pytest.raises(FileNotFoundError):
        hier_crossover(summary="/nonexistent/BENCH_SUMMARY.json")


def test_tree_parity_matches_jax():
    live = {"workers": 8, "fanouts": [2], "rounds": 6, "work_s": 0.05,
            "flush_s": 0.02, "partition": [0.1, 0.2], "ingress_cut": 2.0,
            "staleness_spike": 12.0}
    from distkeras_tpu.sim.calibrate import tree_parity as jax_tree_parity
    from distkeras_tpu_torch.sim.calibrate import tree_parity

    assert tree_parity(live) == jax_tree_parity(live)


def test_sentinel_picks_up_nested_sim_drift(tmp_path):
    from distkeras_tpu_torch.telemetry.health.sentinels import Sentinels

    p = tmp_path / "BENCH_SUMMARY.json"
    p.write_text(json.dumps({"configs": [{
        "metric": "netps_loopback_aeasgd_tokens_per_sec_per_chip",
        "value": 100.0, "within_band": True,
        "sim_drift": {"metric": "sim_predicted_vs_measured_tokens_per_sec",
                      "value": 1.9, "within_band": False}}]}))
    regs = Sentinels.bench_regressions(str(p))
    assert [r["metric"] for r in regs] \
        == ["sim_predicted_vs_measured_tokens_per_sec"]
    p.write_text(json.dumps({"configs": [{
        "metric": "m", "value": 1.0, "within_band": True,
        "sim_drift": {"metric": "s", "value": 1.0, "within_band": True}}]}))
    assert Sentinels.bench_regressions(str(p)) == []


# -- scenario determinism + invariants --------------------------------------

SMALL = {
    "preemption_storm": dict(workers=120),
    "failover_cascade": dict(workers=24, round_s=0.5),
    "region_partition": dict(workers=96),
    "alert_storm": dict(targets_per_region=6),
    "crossover": dict(summary=SUMMARY),
}


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("seed", [0, 5])
def test_every_scenario_matches_jax(name, seed):
    """The same output dict in both packages (JSON after rounding floats
    to 9 significant digits)."""
    assert sorted(psim.SCENARIOS) == sorted(jsim.SCENARIOS)
    got = run_scenario(name, seed=seed, **SMALL[name])
    ref = jsim.run_scenario(name, seed=seed, **SMALL[name])
    assert _canon(got) == _canon(ref)
    assert got["ok"], got["checks"]


def test_scenarios_are_bit_identical_per_seed():
    a = run_scenario("failover_cascade", workers=24, seed=3, round_s=0.5)
    b = run_scenario("failover_cascade", workers=24, seed=3, round_s=0.5)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    c = run_scenario("failover_cascade", workers=24, seed=4, round_s=0.5)
    assert _canon(a) != _canon(c)
    assert a["ok"] and c["ok"]


def test_alert_storm_determinism_and_invariants():
    a = run_scenario("alert_storm", seed=0)
    b = run_scenario("alert_storm", seed=0)
    assert _canon(a) == _canon(b) == _canon(jsim.run_scenario("alert_storm",
                                                              seed=0))
    assert a["ok"], a["checks"]
    assert a["alerts"]["fired"] == a["alerts"]["cleared"]
    assert any(k.startswith("target_down:") for k in a["alerts"]["keys"])


def test_preemption_storm_full_scale_1000_workers():
    t0 = time.perf_counter()
    out = run_scenario("preemption_storm", workers=1000, seed=0)
    wall = time.perf_counter() - t0
    assert out["ok"], out["checks"]
    assert out["workers"] == 1000 and out["regions"] == 3
    assert wall < 60.0
    assert out["checks"]["floors_never_violated"]
    assert out["checks"]["exactly_once"]
    assert out["alerts"]["fired"] >= 1
    assert _canon(out) == _canon(jsim.run_scenario(
        "preemption_storm", workers=1000, seed=0))


def test_failover_cascade_invariants():
    out = run_scenario("failover_cascade", seed=0)
    assert out["ok"], out["checks"]
    assert out["center"]["epochs"] == [0, 1, 2]
    assert out["center"]["value"] == float(out["center"]["commits"])
    assert out["center"]["duplicates"] >= 1


def test_region_partition_conserves_value_through_partition():
    out = run_scenario("region_partition", seed=0)
    assert out["ok"], out["checks"]
    st = out["staleness_by_region"]
    part = str(out["partitioned_region"])
    healthy = max(v for g, v in st.items() if g != part)
    assert st[part] > healthy


def test_unknown_scenario_is_a_typed_error():
    with pytest.raises(ValueError, match="unknown scenario"):
        run_scenario("nope")


# -- the CLI ----------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["run", "alert_storm", "--seed", "0"],
    ["run", "failover_cascade", "--seed", "2", "--workers", "24"],
    ["calibrate", "--summary", SUMMARY],
    ["calibrate", "--summary", SUMMARY, "--band", "1"],
])
def test_cli_exit_codes_and_output_match_jax(argv, capsys):
    rc = sim_main(list(argv))
    got = capsys.readouterr().out
    ref_rc = jax_sim_main(list(argv))
    ref = capsys.readouterr().out
    assert (rc, got) == (ref_rc, ref)
    if argv[0] == "run" and "--workers" not in argv:
        assert rc == 0 and got.rstrip().endswith("OK")


def test_cli_run_and_calibrate_exit_contract(capsys):
    assert sim_main(["run", "alert_storm", "--seed", "0"]) == 0
    assert "OK" in capsys.readouterr().out
    assert sim_main(["calibrate", "--summary", SUMMARY]) == 0
    out = capsys.readouterr().out
    assert "crossover" in out and "OK" in out
    # a band no held-out point meets: the gate fails, exit 1
    assert sim_main(["calibrate", "--summary", SUMMARY, "--band", "0"]) == 1
    assert "FAILED" in capsys.readouterr().out


def test_cli_run_json_is_parseable(capsys):
    assert sim_main(["run", "alert_storm", "--seed", "0", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] is True
    assert jax_sim_main(["run", "alert_storm", "--seed", "0",
                         "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == out


def test_cli_report_renders_fitted_model(tmp_path, traced_records, capsys):
    records, _rate = traced_records
    stream = tmp_path / "trace-test-1.jsonl"
    stream.write_text("\n".join(json.dumps(r) for r in records))
    assert sim_main(["report", "--trace-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "timing model" in out and "fold" in out
    assert sim_main(["report", "--trace-dir", str(tmp_path), "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_sim_main(["report", "--trace-dir", str(tmp_path),
                         "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == got
