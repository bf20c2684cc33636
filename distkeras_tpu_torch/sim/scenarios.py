"""What-if scenarios: the simulator driving the REAL control planes.

Every scenario here builds a :class:`~distkeras_tpu_torch.sim.core.SimEngine`
and wires the *production* subsystems onto its virtual clock through
their injection seams — the actual :class:`~distkeras_tpu_torch.fleet.
scheduler.FleetScheduler` (placement, quotas, gang floors, preemption,
restart budgets), the actual :class:`~distkeras_tpu_torch.telemetry.health.
slo.SloEngine` / :class:`~distkeras_tpu_torch.telemetry.health.sentinels.
Sentinels` over a fed :class:`~distkeras_tpu_torch.telemetry.health.hub.
MetricsHub`, and the real staleness-counter rules via
:class:`~distkeras_tpu_torch.sim.cluster.SimCenter`. Only transport and time
are simulated; the decisions under test are made by production code.

Each scenario returns a JSON-able dict with a ``checks`` map of named
invariants and ``ok = all(checks)``; the CLI (``python -m
distkeras_tpu_torch.sim run <name>``) exits non-zero when a check fails, which
is how a regression job consumes them. Runs are
deterministic per seed (pinned by ``tests/test_torch_sim.py``): results carry
no wall-clock values.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

from distkeras_tpu_torch.sim.cluster import LinkClass, SimCenter, TreeTopology
from distkeras_tpu_torch.sim.core import SimEngine
from distkeras_tpu_torch.sim.fleet_driver import (
    SimJobRuntime,
    SimThreadFactory,
)

#: sentinel file paths that never exist — scenario Sentinels must not
#: read whatever BENCH_SUMMARY.json happens to sit in the cwd.
_ABSENT = "__dktpu_sim_absent__.json"


def _direction_changes(series) -> int:
    """Shrink/expand thrash metric: sign flips of a granted-count
    series (one shrink-then-regrow episode costs 2)."""
    changes = 0
    last = 0
    for a, b in zip(series, series[1:]):
        d = (b > a) - (b < a)
        if d and last and d != last:
            changes += 1
        if d:
            last = d
    return changes


def _drive_scheduler(engine: SimEngine, sched, tick_s: float,
                     until: float,
                     on_tick: Optional[Callable[[], None]] = None) -> None:
    """Reschedule ``sched.tick()`` every virtual ``tick_s`` until every
    job is terminal (or the safety horizon passes)."""

    def tick() -> None:
        sched.tick()
        if on_tick is not None:
            on_tick()
        if sched.all_terminal() or engine.now() >= until:
            return
        engine.after(tick_s, tick)

    engine.after(0.0, tick)


def _round_time(mean_s: float, sigma: float = 0.3):
    mu = math.log(mean_s)
    cap = 5.0 * mean_s
    return lambda engine, _wid: engine.lognormal(mu, sigma, cap=cap)


# -- 1. preemption storm ----------------------------------------------------

def preemption_storm(workers: int = 1000, regions: int = 3,
                     seed: Optional[int] = None, tick_s: float = 0.5,
                     storm_at: float = 6.0, round_s: float = 0.4,
                     rounds_per_worker: int = 30) -> dict:
    """A high-priority gang lands per region mid-run: the real scheduler
    must shrink the running bases *to their gang floors and never below*,
    place the storm, then re-expand without thrashing — while the real
    SLO engine watches the per-region commit rate dip and recover.

    Invariants: zero floor violations, every job completes, bounded
    shrink/expand direction changes, exactly-once at every center, and
    the rate alert both fires during the storm and clears with
    hysteresis afterwards.
    """
    from distkeras_tpu_torch.fleet.job import FleetJob
    from distkeras_tpu_torch.fleet.scheduler import FleetScheduler
    from distkeras_tpu_torch.telemetry.health.hub import MetricsHub
    from distkeras_tpu_torch.telemetry.health.slo import (
        AlertManager, SloEngine, SloSpec)

    engine = SimEngine(seed)
    base_max = workers // regions           # 333 at the 1000/3 scale
    base_min = max(1, workers // 10)        # the gang floor: 100
    storm_gang = max(1, workers // 10)      # one storm gang per region
    quota = base_max + storm_gang + workers // 100
    healthy_rate = base_max / round_s

    sched = FleetScheduler(
        capacity=workers,
        quotas={f"region-{r}": quota for r in range(regions)},
        tick_s=tick_s, preempt_grace=1.0, max_restarts=3,
        clock=engine.clock(), thread_factory=SimThreadFactory(engine))
    hub = MetricsHub(targets={}, interval=tick_s, ring=4096, down_after=3,
                     use_registry=False, clock=engine.clock())
    slo = SloEngine(
        [SloSpec(name="fleet-rate", metric="fleet.commit_rate",
                 stat="value", min=0.84 * healthy_rate,
                 fast_s=2 * tick_s, slow_s=4 * tick_s,
                 severity="ticket")],
        alerts=AlertManager(clear_after=2))

    bases = []
    for r in range(regions):
        rt = SimJobRuntime(engine, f"base-{r}", _round_time(round_s),
                           rounds_target=base_max * rounds_per_worker,
                           center=SimCenter())
        job = sched.submit(FleetJob(
            f"base-{r}", f"region-{r}", rt, priority=0,
            min_gang=base_min, max_workers=base_max))
        bases.append((job, rt))
    storms = []

    def submit_storm() -> None:
        for r in range(regions):
            rt = SimJobRuntime(engine, f"storm-{r}",
                               _round_time(round_s),
                               rounds_target=storm_gang * 8,
                               center=SimCenter())
            job = sched.submit(FleetJob(
                f"storm-{r}", f"region-{r}", rt, priority=10,
                min_gang=storm_gang, max_workers=storm_gang))
            storms.append((job, rt))

    engine.after(storm_at, submit_storm)

    last_progress = {r: 0 for r in range(regions)}

    def on_tick() -> None:
        now = engine.now()
        stats = sched.stats()
        any_base_running = False
        for r, (job, rt) in enumerate(bases):
            rt.granted_series.append(stats[job.job_id]["granted"])
            done = rt.progress()
            rate = (done - last_progress[r]) / tick_s
            last_progress[r] = done
            if not rt.done() and not rt.closed:
                any_base_running = True
                hub.feed(f"region-{r}", "fleet.commit_rate", rate,
                         role="fleet")
        # evaluate only in steady state: after the ramp's slow window
        # fills, and not on the final drain (rate -> 0 is completion,
        # not a breach)
        if any_base_running and now >= 3.0:
            slo.evaluate(hub)

    _drive_scheduler(engine, sched, tick_s, until=120.0, on_tick=on_tick)
    engine.run()
    sched.close()

    stats = sched.stats()
    thrash = {job.job_id: _direction_changes(rt.granted_series)
              for job, rt in bases}
    alerts = slo.alerts
    fired_keys = [h["key"] for h in alerts.history if h["event"] == "fired"]
    # the storm's capacity shortfall: slots the bases must surrender
    # (victim choice is pool-wide priority order, not per-region)
    shortfall = max(0, regions * storm_gang
                    - (workers - regions * base_max))
    preempted = sum(stats[j.job_id]["preemptions"] for j, _rt in bases)
    checks = {
        "all_done": all(s["state"] == "done" for s in stats.values()),
        "floors_never_violated": sched.floor_violations == 0,
        "storm_preempted_bases": preempted >= max(1, shortfall),
        "bases_reexpanded": all(
            stats[j.job_id]["expands"] >= 1 for j, _rt in bases),
        "no_thrash": all(v <= 8 for v in thrash.values()),
        "exactly_once": all(rt.center.exactly_once()
                            for _j, rt in bases + storms),
        "alert_fired_during_storm": alerts.fired_total >= 1,
        "alerts_bounded": alerts.fired_total <= 2,
        "alerts_cleared": (alerts.cleared_total == alerts.fired_total
                           and not alerts.active()),
    }
    return {
        "scenario": "preemption_storm", "seed": engine.seed,
        "workers": workers, "regions": regions,
        "virtual_s": round(engine.now(), 3), "events": engine.events_run,
        "stats": stats, "thrash": thrash,
        "alerts": {"fired": alerts.fired_total,
                   "cleared": alerts.cleared_total,
                   "keys": sorted(set(fired_keys))},
        "checks": checks, "ok": all(checks.values()),
    }


# -- 2. failover cascade ----------------------------------------------------

def failover_cascade(workers: int = 120, seed: Optional[int] = None,
                     tick_s: float = 0.5, round_s: float = 0.3) -> dict:
    """Crash waves + two full PS outages: the hub's fed liveness flips
    the endpoint down, the real scheduler's health pass drains-to-requeue
    the job (once per outage), the center fails over (epoch bump, dedup
    carried), and crashed workers restart against the real budget — some
    crashes lose the ack of an applied commit, so the restarted worker
    retransmits and the center's dedup must absorb the duplicate.

    Invariants: epochs nondecreasing across promotions, exactly-once at
    the center (value conservation to the last bit), exactly one requeue
    per outage, and the job still completes.
    """
    from distkeras_tpu_torch.fleet.job import FleetJob
    from distkeras_tpu_torch.fleet.scheduler import FleetScheduler
    from distkeras_tpu_torch.telemetry.health.hub import (
        MetricsHub, unregister_target)

    engine = SimEngine(seed)
    center = SimCenter(discipline="downpour")
    rt = SimJobRuntime(engine, "train", _round_time(round_s),
                       rounds_target=workers * 65, center=center)
    hub = MetricsHub(targets={}, interval=tick_s, ring=4096, down_after=3,
                     use_registry=False, clock=engine.clock())
    sched = FleetScheduler(
        capacity=workers + workers // 4, quotas=None, tick_s=tick_s,
        preempt_grace=1.0, max_restarts=10 * workers, health_hook=hub,
        clock=engine.clock(), thread_factory=SimThreadFactory(engine))
    outages = [(12.0, 14.0), (20.0, 22.0)]

    def in_outage(t: float) -> bool:
        return any(a <= t < b for a, b in outages)

    def on_tick() -> None:
        if in_outage(engine.now()):
            hub.feed_miss(rt.endpoint, role="ps")
        else:
            hub.feed(rt.endpoint, "up", 1.0, role="ps")

    def crash_wave(frac: float) -> None:
        live = sorted(wid for wid, st in rt._workers.items()
                      if not st.finished)
        step = max(1, int(1 / frac))
        for i, wid in enumerate(live[::step]):
            rt.crash(wid, lose_ack=(i % 2 == 0))

    try:
        job = sched.submit(FleetJob(
            "train", "acme", rt, priority=0,
            min_gang=max(1, workers // 3), max_workers=workers))
        for t in (3.0, 6.0, 9.0):
            engine.after(t, crash_wave, 0.10)
        for _t0, t1 in outages:
            # the standby takes over just before the endpoint recovers
            engine.after(t1 - 0.1, center.promote)
        _drive_scheduler(engine, sched, tick_s, until=120.0,
                         on_tick=on_tick)
        engine.run()
        sched.close()
    finally:
        unregister_target(rt.endpoint)

    stats = sched.stats()[job.job_id]
    checks = {
        "job_done": stats["state"] == "done",
        "epochs_nondecreasing": (
            center.epoch_history
            == sorted(center.epoch_history)),
        "both_failovers_promoted": center.epoch == len(outages),
        "one_requeue_per_outage": stats["requeues"] == len(outages),
        "crashes_restarted": (rt.crashes > 0
                              and stats["restarts"] >= 1),
        "exactly_once": center.exactly_once(),
        "value_conserved": (center.center_value()
                            == float(center.commits_total)),
        "duplicates_absorbed": (rt.resends_expected >= 1
                                and 1 <= center.duplicates
                                <= rt.resends_expected),
    }
    return {
        "scenario": "failover_cascade", "seed": engine.seed,
        "workers": workers, "virtual_s": round(engine.now(), 3),
        "events": engine.events_run, "stats": stats,
        "center": {"epochs": center.epoch_history,
                   "commits": center.commits_total,
                   "duplicates": center.duplicates,
                   "value": center.center_value(),
                   "max_staleness": center.max_staleness},
        "crashes": rt.crashes, "resends_expected": rt.resends_expected,
        "checks": checks, "ok": all(checks.values()),
    }


# -- 3. region partition ----------------------------------------------------

def region_partition(workers: int = 960, seed: Optional[int] = None,
                     rounds: int = 40, work_s: float = 0.2,
                     partition=(3.0, 6.0), levels=None,
                     flush_s: float = 0.05) -> dict:
    """An N-level aggregation tree (host -> pool -> region, per-link
    codec/latency classes) with one region's uplink black-holed for a
    window. During the partition that region's workers run on a cached
    pull counter (the overlap window), its aggregators queue flushes,
    and on heal the queue drains plus ONE duplicate retransmit of the
    last flush — the root's dedup (real counter rules) must absorb it.

    Invariants: value conservation at the root (every worker commit
    accounted, none double-folded), exactly-once, and the partitioned
    region's staleness spiking above the healthy regions'.

    ``levels``/``flush_s`` re-shape the tree without forking the
    scenario: :func:`~distkeras_tpu_torch.sim.calibrate.tree_parity` re-fits
    this scenario to a LIVE traced tree's shape (its fanouts, flush
    cadence, and measured commit period) and asserts agreement. The
    defaults are the 1000-worker what-if unchanged.
    """
    engine = SimEngine(seed)
    center = SimCenter(discipline="downpour")
    if levels is None:
        levels = [
            ("host", 8,
             LinkClass("host", 0.0002, jitter=0.10, codec="int8")),
            ("pool", 4, LinkClass("pool", 0.001, jitter=0.10,
                                  codec="bf16")),
            ("region", 10, LinkClass("region", 0.005, jitter=0.10,
                                     codec="none")),
        ]
    topo = TreeTopology(workers, levels, flush_s=flush_s)
    region_level = len(levels) - 1
    regions = len(topo.aggregators[region_level])
    part_region = 1 if regions > 1 else 0
    t0, t1 = partition
    topo.partition(region_level, part_region, t0, t1)

    # per-region-aggregator commit identity at the root (the root's
    # clients ARE the region aggregators), + queued flushes per region
    agg_seq = {g: 0 for g in range(regions)}
    queued: Dict[int, list] = {g: [] for g in range(regions)}
    cached_pull = {g: center.pull() for g in range(regions)}
    region_staleness: Dict[int, int] = {}
    mu_work = math.log(work_s)

    def root_commit(g: int, seq: int, payload: dict) -> None:
        res = center.commit(10_000 + g, seq, payload["pulled"],
                            payload["value"])
        if res["applied"]:
            region_staleness[g] = max(region_staleness.get(g, 0),
                                      res["staleness"])

    last_deliver = {g: 0.0 for g in range(regions)}

    def send_root(g: int, seq: int, payload: dict) -> None:
        """One in-order uplink delivery (the wire is a FIFO stream per
        connection — jitter must not reorder an aggregator's seqs)."""
        link = topo.level_links(region_level)
        t = max(engine.now() + link.sample(engine), last_deliver[g])
        last_deliver[g] = t
        engine.at(t, root_commit, g, seq, payload)

    def uplink_send(g: int, payload: dict) -> None:
        """Region g's uplink: deliver, or queue under partition and
        drain (+ one duplicate retransmit) on heal."""
        if topo.link_down(region_level, g, engine.now()):
            if not queued[g]:
                heal = topo.heals_at(region_level, g, engine.now())
                engine.at(heal, drain_queue, g)
            queued[g].append(payload)
            return
        seq = agg_seq[g]
        agg_seq[g] += 1
        send_root(g, seq, payload)

    def drain_queue(g: int) -> None:
        backlog, queued[g] = queued[g], []
        for payload in backlog:
            seq = agg_seq[g]
            agg_seq[g] += 1
            send_root(g, seq, payload)
        if backlog:
            # the retransmit the sender could not distinguish from a
            # lost ack: same seq as the last flush -> root dedup absorbs
            send_root(g, agg_seq[g] - 1, backlog[-1])

    def hop(level: int, g: int, payload: dict) -> None:
        """One flush arriving at level ``level``'s aggregator ``g``."""
        agg = topo.aggregators[level][g]
        out = agg.fold(engine.now(), payload["pulled"], payload["value"])
        if out is None:
            return
        if level == region_level:
            uplink_send(g, out)
        else:
            nxt = level + 1
            link = topo.level_links(nxt)
            engine.after(link.sample(engine), hop, nxt,
                         g // topo.levels[nxt][1], out)

    done = {w: 0 for w in range(workers)}

    def worker_round(w: int) -> None:
        g = topo.group_of(w, region_level)
        if topo.link_down(region_level, g, engine.now()):
            pulled = cached_pull[g]   # the overlap window: stale counter
        else:
            pulled = cached_pull[g] = center.pull()
        engine.after(engine.lognormal(mu_work, 0.3, cap=5.0 * work_s),
                     commit_round, w, pulled)

    def commit_round(w: int, pulled) -> None:
        # the commit is fire-and-forget into the tree; the worker's next
        # round begins immediately (it does not wait for the root fold)
        engine.after(topo.level_links(0).sample(engine), hop, 0,
                     topo.group_of(w, 0), {"pulled": pulled, "value": 1.0})
        done[w] += 1
        if done[w] < rounds:
            worker_round(w)

    for w in range(workers):
        engine.after(engine.rng.uniform(0.0, work_s), worker_round, w)
    engine.run()

    # final drain: every partial accumulation flushes (conservation)
    for level in range(len(levels)):
        for g, agg in sorted(topo.aggregators[level].items()):
            out = agg.take(engine.now())
            if out is None:
                continue
            if level == region_level:
                uplink_send(g, out)
            else:
                nxt = level + 1
                engine.after(topo.level_links(nxt).sample(engine), hop,
                             nxt, g // topo.levels[nxt][1], out)
            engine.run()
    engine.run()

    expected = float(workers * rounds)
    healthy_max = max((s for g, s in region_staleness.items()
                       if g != part_region), default=0)
    checks = {
        "value_conserved": center.center_value() == expected,
        "exactly_once": center.exactly_once(),
        "retransmit_deduped": center.duplicates >= 1,
        "staleness_spiked_in_partition": (
            region_staleness.get(part_region, 0) > healthy_max),
    }
    return {
        "scenario": "region_partition", "seed": engine.seed,
        "workers": workers, "regions": regions,
        "partitioned_region": part_region,
        "virtual_s": round(engine.now(), 3), "events": engine.events_run,
        "root_commits": center.commits_total,
        "duplicates": center.duplicates,
        "center_value": center.center_value(),
        "staleness_by_region": {str(g): region_staleness.get(g, 0)
                                for g in range(regions)},
        "checks": checks, "ok": all(checks.values()),
    }


# -- 4. alert storm ---------------------------------------------------------

def alert_storm(seed: Optional[int] = None, regions: int = 3,
                targets_per_region: int = 20, sweep_s: float = 2.0,
                horizon_s: float = 150.0) -> dict:
    """60 fed targets through healthy -> breach -> recover phases under
    the real SLO engine, sentinels, and alert manager. Two regions
    breach their latency objective and five targets go silent (the
    ``target_down`` page sentinel); recovery must clear everything.

    Invariants: pages/tickets bounded (one alert per breaching
    condition, no flapping — each key fires exactly once), and every
    alert clears through hysteresis by the end.
    """
    from distkeras_tpu_torch.telemetry.health.hub import MetricsHub
    from distkeras_tpu_torch.telemetry.health.sentinels import Sentinels
    from distkeras_tpu_torch.telemetry.health.slo import (
        AlertManager, SloEngine, SloSpec)

    engine = SimEngine(seed)
    hub = MetricsHub(targets={}, interval=sweep_s, ring=4096, down_after=3,
                     use_registry=False, clock=engine.clock())
    alerts = AlertManager(clear_after=2)
    slo = SloEngine(
        [SloSpec(name=f"latency-region-{r}", metric="serving.latency",
                 stat="mean", max=0.25, fast_s=2 * sweep_s,
                 slow_s=6 * sweep_s, severity="ticket",
                 target=f"region-{r}-*") for r in range(regions)],
        alerts=alerts)
    sentinels = Sentinels(alerts=alerts, bench_summary=_ABSENT,
                          bench_pin=_ABSENT)
    names = [f"region-{r}-t{i}" for r in range(regions)
             for i in range(targets_per_region)]
    silent = names[:5]                      # go dark during the breach
    breach_regions = {f"region-{r}" for r in range(min(2, regions))}
    b0, b1 = 0.3 * horizon_s, 0.7 * horizon_s

    def sweep() -> None:
        now = engine.now()
        breaching = b0 <= now < b1
        for name in names:
            if breaching and name in silent:
                hub.feed_miss(name, role="serving")
                continue
            region = name.rsplit("-", 1)[0]
            lat = 0.10 + 0.02 * engine.rng.random()
            if breaching and region in breach_regions:
                lat = 0.40 + 0.05 * engine.rng.random()
            hub.feed(name, "serving.latency", lat, role="serving")
        slo.evaluate(hub)
        sentinels.evaluate(hub)
        if now + sweep_s <= horizon_s:
            engine.after(sweep_s, sweep)

    engine.after(0.0, sweep)
    engine.run()

    fired = [h for h in alerts.history if h["event"] == "fired"]
    fired_keys = [h["key"] for h in fired]
    expected = len(breach_regions) + len(silent)
    checks = {
        "alerts_fired": alerts.fired_total >= expected,
        "alerts_bounded": alerts.fired_total <= expected + 2,
        "no_flapping": len(fired_keys) == len(set(fired_keys)),
        "pages_are_target_down": all(
            h["key"].startswith("target_down:") for h in fired
            if h["severity"] == "page"),
        "all_cleared": (alerts.cleared_total == alerts.fired_total
                        and not alerts.active()),
    }
    return {
        "scenario": "alert_storm", "seed": engine.seed,
        "targets": len(names), "virtual_s": round(engine.now(), 3),
        "events": engine.events_run,
        "alerts": {"fired": alerts.fired_total,
                   "cleared": alerts.cleared_total,
                   "keys": sorted(set(fired_keys))},
        "attainment": slo.attainment(),
        "checks": checks, "ok": all(checks.values()),
    }


# -- 5. crossover (calibration gate as a scenario) --------------------------

def crossover(seed: Optional[int] = None, summary=None) -> dict:
    """The flat->hier crossover replay against the bench curve (see
    :func:`distkeras_tpu_torch.sim.calibrate.hier_crossover`)."""
    from distkeras_tpu_torch.sim.calibrate import hier_crossover

    out = hier_crossover(summary=summary,
                         seed=0 if seed is None else seed)
    out["scenario"] = "crossover"
    out["checks"] = {
        "held_out_within_band": bool(out["within_band"]),
        "crossover_reproduced": bool(out["crossover_reproduced"]),
    }
    out["ok"] = all(out["checks"].values())
    return out


SCENARIOS: Dict[str, Callable[..., dict]] = {
    "preemption_storm": preemption_storm,
    "failover_cascade": failover_cascade,
    "region_partition": region_partition,
    "alert_storm": alert_storm,
    "crossover": crossover,
}


def run_scenario(name: str, **kwargs) -> dict:
    fn = SCENARIOS.get(name)
    if fn is None:
        raise ValueError(
            f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}")
    return fn(**kwargs)
