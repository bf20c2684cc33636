"""Calibration gates: replaying measured deployments through the sim.

Three replays keep the simulator honest:

* :func:`predict_throughput` / :func:`sim_drift` — replay a *traced*
  loopback deployment (bench config #8's data plane): fit the timing
  model from its trace stream (:class:`~distkeras_tpu_torch.sim.model.
  TimingModel`), run the discrete-event replay (workers alternating
  fitted work gaps and commit paths against one serialized fold
  resource — queueing emerges from contention, it is never sampled),
  and compare predicted to measured throughput. ``chip_smoke.py``'s
  config #8 phase publishes the ratio as the ``sim_drift`` block of its
  ``netps_config8`` line (the JAX package's bench writes the same block
  into BENCH_SUMMARY.json, where the bench-regression sentinel watches
  calibration rot like any other regression).

* :func:`hier_crossover` — replay the bench ``hier_curve`` (flat vs
  hierarchical topology at W ∈ {1, 2, 4}): calibrate the serialized
  root-fold service from the **flat W ∈ {1, 2}** points (flat W=4 held
  out), and split the hier path into a per-commit aggregator cost plus a
  per-flush root cost from the hier curve's **endpoints** (W=1, where
  every commit flushes, and the max-W point, where fan-in batching
  amortizes the root visit — the root-commit counts in the summary pin
  the flush ratios). The middle hier point is then genuinely predicted:
  the DES runs the real :class:`~distkeras_tpu_torch.sim.cluster.
  SimAggregator` flush policy (fan-in OR age), so the batching
  amortization — and therefore the flat->hier crossover — *emerges*
  rather than being interpolated. The gate asserts every held-out
  prediction lands within the band AND that the predicted hier/flat
  throughput ratio crosses the flip threshold at the measured crossover
  (W=4, matching ``recommended_topology``'s ``DKTPU_TUNE_HIER_FANIN``
  default) with a root-ingress cut that justifies the topology.

* :func:`tree_parity` — re-fit the ``region_partition`` scenario from a
  LIVE traced aggregation-tree run (its fanouts, flush cadence, commit
  period, and partition window) and assert the sim reproduces the root
  ingress cut and the partitioned region's staleness spike within the
  band — the gate that licenses the tree what-ifs at 1000-worker scale.
  The JAX package's tree chaos smoke publishes it as the
  ``tree_parity`` block in BENCH_SUMMARY.json; ``sim calibrate
  --tree-live live.json`` replays one from a recorded live dict.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from distkeras_tpu_torch.runtime.config import env_float
from distkeras_tpu_torch.sim.cluster import SimAggregator
from distkeras_tpu_torch.sim.core import SimEngine
from distkeras_tpu_torch.sim.model import TimingModel

#: hier/flat throughput ratio at which the topology recommendation flips
#: (the tuner flips on fan-in ≥ DKTPU_TUNE_HIER_FANIN = 4; on the bench
#: curve that corresponds to the ratio entering this band while the
#: root-ingress cut pays for the residual gap).
RATIO_BAND = 0.85
#: minimum flat/hier root-commit-rate cut that justifies hier at the
#: crossover point (the whole point of the topology: root ingress).
INGRESS_CUT_MIN = 2.5


def _band_pct(band_pct: Optional[float]) -> float:
    return env_float("DKTPU_SIM_BAND_PCT") if band_pct is None \
        else float(band_pct)


def replay_serialized(model: TimingModel, workers: int, rounds: int,
                      seed: int = 0) -> dict:
    """The deployment replay: ``workers`` event-driven workers, each
    alternating a fitted work gap + client-side commit half (encode +
    wire) with a visit to ONE serialized server resource (service =
    fold + fsync samples); the ack closes the round. Returns the virtual
    wall time and commit count."""
    eng = SimEngine(seed)
    server_free = [0.0]
    counts = {w: 0 for w in range(workers)}
    last_done = [0.0]

    def begin(w: int) -> None:
        eng.after(model.sample_work(eng)
                  + model.sample_commit_client(eng), arrive, w)

    def arrive(w: int) -> None:
        start = max(eng.now(), server_free[0])
        server_free[0] = start + model.sample_service(eng)
        eng.at(server_free[0] + model.sample_ack(eng), finish, w)

    def finish(w: int) -> None:
        counts[w] += 1
        last_done[0] = max(last_done[0], eng.now())
        if counts[w] < rounds:
            begin(w)

    for w in range(workers):
        begin(w)
    eng.run()
    commits = sum(counts.values())
    wall = last_done[0]
    return {"wall_s": wall, "commits": commits,
            "commits_per_sec": (commits / wall) if wall > 0 else None}


def predict_throughput(records: Optional[list] = None,
                       model: Optional[TimingModel] = None,
                       workers: Optional[int] = None,
                       rounds: Optional[int] = None,
                       tokens_per_round: Optional[float] = None,
                       seed: int = 0) -> dict:
    """Predict a traced deployment's throughput by replaying it. Worker
    count and per-worker rounds default to what the trace itself shows
    (distinct commit-root wids / commits per wid)."""
    from distkeras_tpu_torch.telemetry.tracing import analysis

    if model is None:
        model = TimingModel.from_records(records or [])
    if workers is None or rounds is None:
        wids = {root.get("wid")
                for _t, root, _d, _e in analysis.commit_paths(records or [])
                if root.get("wid") is not None}
        if workers is None:
            workers = max(1, len(wids))
        if rounds is None:
            rounds = max(1, model.commits // max(1, workers))
    out = replay_serialized(model, workers, rounds, seed=seed)
    out.update({"workers": workers, "rounds": rounds,
                "model": model.describe()})
    if tokens_per_round is not None and out["wall_s"] > 0:
        out["tokens_per_sec"] = (tokens_per_round * out["commits"]
                                 / out["wall_s"])
    return out


def sim_drift(records: list, measured_tokens_per_sec: float,
              tokens_per_round: float, workers: Optional[int] = None,
              rounds: Optional[int] = None,
              band_pct: Optional[float] = None, seed: int = 0) -> dict:
    """The BENCH_SUMMARY ``sim_drift`` block: predicted/measured
    throughput ratio for the traced deployment, banded so the
    bench-regression sentinel can flag calibration rot."""
    band = _band_pct(band_pct)
    pred = predict_throughput(records, workers=workers, rounds=rounds,
                              tokens_per_round=tokens_per_round, seed=seed)
    predicted = pred.get("tokens_per_sec")
    ratio = (predicted / measured_tokens_per_sec
             if predicted and measured_tokens_per_sec else None)
    return {
        "metric": "sim_predicted_vs_measured_tokens_per_sec",
        "value": round(ratio, 4) if ratio is not None else None,
        "predicted_tokens_per_sec": (round(predicted, 1)
                                     if predicted else None),
        "measured_tokens_per_sec": round(measured_tokens_per_sec, 1),
        "band_pct": band,
        "within_band": (abs(ratio - 1.0) <= band / 100.0
                        if ratio is not None else None),
        "workers": pred["workers"], "rounds": pred["rounds"],
        "sim_commits": pred["commits"],
    }


# -- the live-tree region-partition replay ----------------------------------

def tree_parity(live: dict, band_pct: Optional[float] = None,
                seed: int = 0) -> dict:
    """The aggregation-tree calibration gate: re-fit the
    ``region_partition`` scenario from a LIVE traced tree run and assert
    the sim reproduces the two load-bearing shapes — the root ingress
    cut (absorbed worker commits per root fold) and the partitioned
    region's staleness spike — within the band.

    ``live`` is the measured run: ``workers``, ``fanouts`` (bottom-up
    interior fanouts, e.g. ``[2]`` for a 2-region/one-tier tree),
    ``rounds`` per worker, ``work_s`` (the fitted mean per-worker commit
    period — wall / rounds), ``flush_s`` (the tree nodes' flush
    interval), ``partition`` ``(t0, t1)`` in run-relative seconds, and
    the two measured shapes: ``ingress_cut`` (total absorbed / total
    root folds from the tree) and ``staleness_spike`` (the partitioned
    region's MAX root-fold staleness — both systems pin it to partition
    duration x healthy root update rate, so it transfers; the
    partitioned/healthy RATIO would instead ride the noisy tail question
    of whether some healthy flush happens to interleave the heal drain).
    The spike comparison is +1-regularized so a zero-staleness run still
    ratios. Optional: ``link_latency_s`` (default 1 ms), ``codec``
    (uplink codec class, default ``none``).

    Both systems run the SAME structure — fan-in-or-age windows, frozen
    pull counters under the partition, in-order heal drain — so
    agreement here is what licenses the 1000-worker what-ifs: the
    ``region_partition`` defaults extrapolate exactly the machinery
    this gate pinned to a live trace."""
    from distkeras_tpu_torch.sim.cluster import LinkClass
    from distkeras_tpu_torch.sim.scenarios import region_partition

    band = _band_pct(band_pct)
    fanouts = [int(f) for f in live["fanouts"]]
    lat = float(live.get("link_latency_s", 0.001))
    codec = str(live.get("codec", "none"))
    levels = []
    for i, fan in enumerate(fanouts):
        top = i == len(fanouts) - 1
        name = "region" if top else f"tier{i}"
        levels.append((name, fan,
                       LinkClass(name, lat, jitter=0.10,
                                 codec=codec if top else "none")))
    workers, rounds = int(live["workers"]), int(live["rounds"])
    sim = region_partition(workers=workers, seed=seed, rounds=rounds,
                           work_s=float(live["work_s"]),
                           partition=tuple(live["partition"]),
                           levels=levels,
                           flush_s=float(live["flush_s"]))
    sim_cut = (workers * rounds) / max(1, int(sim["root_commits"]))
    stale = {int(g): int(s)
             for g, s in sim["staleness_by_region"].items()}
    part = int(sim["partitioned_region"])
    sim_spike = float(stale.get(part, 0))
    live_cut = float(live["ingress_cut"])
    live_spike = float(live["staleness_spike"])
    cut_ratio = (sim_cut / live_cut) if live_cut else None
    spike_ratio = (sim_spike + 1.0) / (live_spike + 1.0)

    def _in_band(ratio: Optional[float]) -> bool:
        return ratio is not None and abs(ratio - 1.0) <= band / 100.0

    return {
        "metric": "sim_tree_vs_live_region_partition",
        "band_pct": band, "seed": seed,
        "live": {"workers": workers, "rounds": rounds,
                 "fanouts": fanouts,
                 "work_s": round(float(live["work_s"]), 4),
                 "flush_s": round(float(live["flush_s"]), 4),
                 "partition": [round(float(t), 3)
                               for t in live["partition"]],
                 "ingress_cut": round(live_cut, 3),
                 "staleness_spike": round(live_spike, 3)},
        "sim": {"ingress_cut": round(sim_cut, 3),
                "staleness_spike": round(sim_spike, 3),
                "root_commits": int(sim["root_commits"]),
                "checks_ok": bool(sim["ok"])},
        "ingress_cut_ratio": (round(cut_ratio, 4)
                              if cut_ratio is not None else None),
        "staleness_spike_ratio": (round(spike_ratio, 4)
                                  if spike_ratio is not None else None),
        "within_band": (_in_band(cut_ratio) and _in_band(spike_ratio)
                        and bool(sim["ok"])),
    }


# -- the flat->hier crossover replay ----------------------------------------

def _curve_rows(summary) -> Tuple[List[dict], str]:
    """The first config carrying a ``hier_curve``, resolved from a dict,
    a path, or the repo-root default."""
    if summary is None:
        summary = "BENCH_SUMMARY.json"
    if isinstance(summary, str):
        if not os.path.exists(summary):
            raise FileNotFoundError(f"no bench summary at {summary}")
        with open(summary, "r", encoding="utf-8") as f:
            summary = json.load(f)
    for cfg in summary.get("configs", []):
        if cfg.get("hier_curve"):
            return list(cfg["hier_curve"]), str(cfg.get("metric"))
    raise ValueError("bench summary carries no hier_curve block")


def _replay_point(workers: int, rounds: int, topology: str,
                  service_s: float, flush_cost_s: float, flush_s: float,
                  seed: int, sigma: float = 0.02) -> dict:
    """DES one curve point: ``workers`` zero-think workers against one
    serialized resource. Flat: every commit is a root visit costing
    ``service_s``. Hier: the resource is the aggregator — ``service_s``
    per commit, plus ``flush_cost_s`` whenever the real
    :class:`SimAggregator` flush policy (fan-in = W OR age > flush
    interval) trips, so root amortization emerges from the policy."""
    import math

    eng = SimEngine(seed)
    free = [0.0]
    counts = {w: 0 for w in range(workers)}
    last = [0.0]
    agg = SimAggregator("bench-agg", fan_in=workers,
                        flush_s=flush_s) if topology == "hier" else None
    root_commits = [0]
    mu = math.log(service_s)

    def arrive(w: int) -> None:
        start = max(eng.now(), free[0])
        busy = eng.lognormal(mu, sigma, cap=4.0 * service_s)
        if agg is not None:
            if agg.fold(start, 0, 1.0) is not None:
                root_commits[0] += 1
                busy += flush_cost_s
        else:
            root_commits[0] += 1
        free[0] = start + busy
        eng.at(free[0], finish, w)

    def finish(w: int) -> None:
        counts[w] += 1
        last[0] = max(last[0], eng.now())
        if counts[w] < rounds:
            arrive(w)

    for w in range(workers):
        arrive(w)
    eng.run()
    if agg is not None and agg.take(eng.now()) is not None:
        root_commits[0] += 1
    wall = last[0]
    commits = sum(counts.values())
    return {"wall_s": wall, "worker_commits": commits,
            "root_commits": root_commits[0],
            "worker_commits_per_sec": (commits / wall) if wall else None}


def hier_crossover(summary=None, band_pct: Optional[float] = None,
                   ratio_band: float = RATIO_BAND,
                   flush_s: float = 0.5, seed: int = 0) -> dict:
    """Replay the bench ``hier_curve`` through the DES; see the module
    docstring for the calibration/held-out split. Returns per-point
    predictions, held-out errors, the predicted and measured crossover
    worker counts, and the root-ingress cut at the crossover."""
    rows, metric = _curve_rows(summary)
    band = _band_pct(band_pct)
    by_key: Dict[Tuple[int, str], dict] = {
        (int(r["workers"]), str(r["topology"])): r for r in rows}

    def period(w: int, topo: str) -> float:
        # per-worker commit period; worker_commits_per_sec is fleet-total
        return w / float(by_key[(w, topo)]["worker_commits_per_sec"])

    flat1, flat2 = period(1, "flat"), period(2, "flat")
    # least squares through the origin over the calibration points for
    # the serialized-root model p(W) = W * S
    s_flat = (1 * flat1 + 2 * flat2) / (1 + 4)
    rounds = int(round(by_key[(1, "flat")]["root_commits"]))
    tokens_per_round = (float(by_key[(1, "flat")]["tokens_per_sec"])
                        / float(by_key[(1, "flat")]
                                ["worker_commits_per_sec"]))
    # hier split from the curve's endpoints: per-commit time is
    # s_agg + r * s_root where r is the flush/commit ratio the summary's
    # root-commit counts pin (r = 1 at W=1 — every commit flushes).
    hier_ws = sorted(w for (w, topo) in by_key if topo == "hier")
    w_lo, w_hi = hier_ws[0], hier_ws[-1]

    def flush_ratio(w: int) -> float:
        row = by_key[(w, "hier")]
        return float(row["root_commits"]) / max(1, rounds * w)

    p_lo = period(w_lo, "hier")
    p_hi = period(w_hi, "hier") / w_hi * 1.0  # per-commit at max W
    r_lo, r_hi = flush_ratio(w_lo), flush_ratio(w_hi)
    if w_hi > w_lo and r_lo > r_hi:
        s_root = max(0.0, (p_lo - p_hi) / (r_lo - r_hi))
    else:
        s_root = 0.0
    s_agg = p_lo - r_lo * s_root
    calibration_keys = {(1, "flat"), (2, "flat"),
                        (w_lo, "hier"), (w_hi, "hier")}

    points = []
    for (w, topo), row in sorted(by_key.items(), key=lambda kv: kv[0]):
        pred = _replay_point(w, rounds, topo,
                             s_agg if topo == "hier" else s_flat,
                             s_root, flush_s, seed)
        predicted_tps = (tokens_per_round * pred["worker_commits"]
                         / pred["wall_s"])
        measured_tps = float(row["tokens_per_sec"])
        err = abs(predicted_tps - measured_tps) / measured_tps
        points.append({
            "workers": w, "topology": topo,
            "measured_tokens_per_sec": measured_tps,
            "predicted_tokens_per_sec": round(predicted_tps, 1),
            "error_pct": round(100.0 * err, 1),
            "held_out": (w, topo) not in calibration_keys,
            "predicted_root_commits": pred["root_commits"],
            "measured_root_commits": row.get("root_commits"),
        })

    def ratios(key: str) -> Dict[int, float]:
        tps = {(p["workers"], p["topology"]): p[key] for p in points}
        return {w: tps[(w, "hier")] / tps[(w, "flat")]
                for w in sorted({p["workers"] for p in points})
                if (w, "hier") in tps and (w, "flat") in tps}

    def crossover(ratio_by_w: Dict[int, float]) -> Optional[int]:
        for w in sorted(ratio_by_w):
            if ratio_by_w[w] >= ratio_band:
                return w
        return None

    pred_ratio = ratios("predicted_tokens_per_sec")
    meas_ratio = ratios("measured_tokens_per_sec")
    pred_x, meas_x = crossover(pred_ratio), crossover(meas_ratio)

    def ingress_cut(w: Optional[int], key: str) -> Optional[float]:
        if w is None:
            return None
        by = {(p["workers"], p["topology"]): p[key] for p in points}
        hier = by.get((w, "hier"))
        return (by[(w, "flat")] / hier) if hier else None

    held_out = [p for p in points if p["held_out"]]
    return {
        "metric": metric,
        "calibration": {"service_flat_s": round(s_flat, 4),
                        "service_agg_s": round(s_agg, 4),
                        "flush_cost_s": round(s_root, 4),
                        "rounds": rounds,
                        "tokens_per_round": round(tokens_per_round, 1),
                        "flush_s": flush_s, "seed": seed},
        "points": points,
        "band_pct": band,
        "within_band": all(p["error_pct"] <= band for p in held_out),
        "max_held_out_error_pct": max(
            (p["error_pct"] for p in held_out), default=0.0),
        "ratio_band": ratio_band,
        "predicted_ratio": {str(w): round(r, 3)
                            for w, r in pred_ratio.items()},
        "measured_ratio": {str(w): round(r, 3)
                           for w, r in meas_ratio.items()},
        "predicted_crossover_workers": pred_x,
        "measured_crossover_workers": meas_x,
        "crossover_reproduced": (pred_x is not None and pred_x == meas_x),
        "predicted_ingress_cut": ingress_cut(
            pred_x, "predicted_root_commits"),
        "measured_ingress_cut": ingress_cut(
            meas_x, "measured_root_commits"),
    }
