"""Run-report renderer: ``python -m distkeras_tpu_torch.telemetry report run.jsonl``.

Reads a JSONL produced by ``MetricsLogger`` (per-round records + the
telemetry-summary record its ``close()`` appends) or by
``telemetry.exporters.write_jsonl`` directly, and renders:

* per-phase time breakdown (span totals, counts, means, share of the run);
* throughput segments (the same burst-grouping ``MetricsLogger`` uses, so
  blocked/auto runs report per-segment rates, not burst-tail garbage);
* staleness summary (per-worker staleness distribution, DynSGD scales,
  per-worker loss divergence) from discipline-aware round fields;
* a straggler table: rounds whose wall time exceeds ``k`` x the median (and
  any record-time ``straggler`` flags the live monitor set).
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np

from distkeras_tpu_torch.telemetry.core import BURST_EPS_S
from distkeras_tpu_torch.telemetry.exporters import SUMMARY_KIND, read_jsonl
from distkeras_tpu_torch.telemetry.training import STRAGGLER_K, flag_stragglers


def _round_records(records: list[dict]) -> list[dict]:
    return [r for r in records if "round" in r and "kind" not in r]


def _summaries(records: list[dict]) -> list[dict]:
    return [r for r in records if r.get("kind") == SUMMARY_KIND]


def _is_burst_tail(r: dict) -> bool:
    """Interior round of a compiled block — not a timing boundary. The
    explicit ``burst_tail`` marker (written by MetricsLogger from the
    engine's state=None contract) is authoritative; the dt threshold is the
    fallback for records that predate it."""
    return bool(r.get("burst_tail",
                      (r.get("round_seconds") or 0.0) < BURST_EPS_S))


def throughput_segments(rounds: list[dict]) -> list[dict]:
    """Burst-grouped throughput segments (rounds, seconds, samples/s)."""
    segments: list[dict] = []
    for r in rounds:
        dt = r.get("round_seconds")
        if dt is None:
            continue
        sps = r.get("samples_per_sec")
        spr = sps * dt if sps else 0.0
        if segments and _is_burst_tail(r):
            segments[-1]["rounds"] += 1
            segments[-1]["seconds"] += dt
            segments[-1]["samples"] += spr
        else:
            segments.append(
                {"rounds": 1, "seconds": dt, "samples": spr,
                 "first_round": r["round"]})
    for s in segments:
        s["samples_per_sec"] = (s["samples"] / s["seconds"]
                                if s["seconds"] > 0 else 0.0)
    return segments


def _hist_max(h: dict) -> float:
    """Exact max when present; otherwise the upper bound of the highest
    occupied bucket (windowed summaries from ``Telemetry.delta`` carry
    count/total/mean/buckets only — a window has no well-defined min/max)."""
    if "max" in h:
        return h["max"]
    from distkeras_tpu_torch.telemetry.core import BUCKET_BOUNDS

    buckets = h.get("buckets", [])
    for i in range(len(buckets) - 1, -1, -1):
        if buckets[i]:
            return (BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS)
                    else float("inf"))
    return 0.0


def phase_breakdown(summary: dict) -> list[dict]:
    """Span aggregates sorted by total time, with share of the longest
    top-level span (the closest thing a JSONL has to 'the run')."""
    spans = summary.get("spans", {})
    rows = []
    top_total = max(
        (h.get("total", 0.0) for n, h in spans.items() if "/" not in n),
        default=0.0)
    for name, h in spans.items():
        total = h.get("total", 0.0)
        rows.append({
            "span": name,
            "count": h.get("count", 0),
            "total_s": total,
            "mean_s": h.get("mean", 0.0),
            "max_s": _hist_max(h),
            "share": (total / top_total) if top_total > 0 else None,
        })
    rows.sort(key=lambda r: -r["total_s"])
    return rows


def staleness_summary(rounds: list[dict]) -> Optional[dict]:
    """Aggregate the discipline-aware per-round fields, if any."""
    stale_rows = [r["staleness"] for r in rounds if "staleness" in r]
    out: dict = {}
    if stale_rows:
        mat = np.asarray(stale_rows, dtype=np.float64)  # [rounds, W]
        out["num_workers"] = mat.shape[1]
        out["per_worker_mean"] = [round(float(v), 3) for v in mat.mean(0)]
        out["per_worker_max"] = [int(v) for v in mat.max(0)]
    scales = [r["dynsgd_scale"] for r in rounds if "dynsgd_scale" in r]
    if scales:
        mat = np.asarray(scales, dtype=np.float64)
        out["dynsgd_scale_mean"] = [round(float(v), 4) for v in mat.mean(0)]
    divs = [r["loss_divergence"] for r in rounds if "loss_divergence" in r]
    if divs:
        mat = np.asarray(divs, dtype=np.float64)
        out["loss_divergence_rms"] = [
            round(float(v), 6) for v in np.sqrt((mat ** 2).mean(0))]
        out["loss_divergence_max_abs"] = round(float(np.abs(mat).max()), 6)
    return out or None


#: metric names recognized inside ``fleet.<metric>.<tenant>.<job>``
#: counter/gauge/span names (the fleet scheduler's attribution
#: convention — tenant and job are sanitized to dot-free tokens, so a
#: 4-way split is unambiguous).
_FLEET_METRICS = frozenset({
    "commits", "preemptions", "shrinks", "expands", "restarts",
    "placements", "preempt_debt", "granted", "staleness_mean",
    "staleness_max", "round",
})


def fleet_attribution(summary: dict) -> list[dict]:
    """Per-(tenant, job) rollup of the fleet scheduler's labeled metrics:
    throughput (commits + round-span wall time), staleness, restarts, and
    preemption accounting — one row per job, tenants grouped."""
    jobs: dict = {}

    def row(tenant: str, job: str) -> dict:
        return jobs.setdefault((tenant, job), {"tenant": tenant, "job": job})

    for name, v in summary.get("counters", {}).items():
        parts = name.split(".")
        if (len(parts) == 4 and parts[0] == "fleet"
                and parts[1] in _FLEET_METRICS):
            row(parts[2], parts[3])[parts[1]] = v
    for name, g in summary.get("gauges", {}).items():
        parts = name.split(".")
        if (len(parts) == 4 and parts[0] == "fleet"
                and parts[1] in _FLEET_METRICS):
            row(parts[2], parts[3])[parts[1]] = g.get("value")
    for name, h in summary.get("spans", {}).items():
        parts = name.split(".")
        if (len(parts) == 4 and parts[0] == "fleet" and parts[1] == "round"):
            r = row(parts[2], parts[3])
            r["round_total_s"] = h.get("total", 0.0)
            r["round_mean_s"] = h.get("mean", 0.0)
            total = h.get("total", 0.0)
            if total > 0:
                # Throughput = COMMITTED rounds over round wall time; the
                # span count would also bill evicted/requeued attempts,
                # overstating c/s exactly when preemption churn occurs.
                commits = r.get("commits", h.get("count", 0))
                r["commits_per_sec"] = round(commits / total, 3)
    return [jobs[k] for k in sorted(jobs)]


def _hist_quantile(h: dict, q: float) -> float:
    """Bucket-resolution quantile from a histogram *snapshot* (the same
    walk as ``Histogram.quantile``, but over the serialized form a JSONL
    summary carries)."""
    from distkeras_tpu_torch.telemetry.core import BUCKET_BOUNDS

    buckets = h.get("buckets", [])
    count = h.get("count", 0)
    if not count:
        return 0.0
    target = q * count
    seen = 0
    for i, c in enumerate(buckets):
        seen += c
        if seen >= target and c:
            return (BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS)
                    else _hist_max(h))
    return _hist_max(h)


#: ``serving.*`` counter names surfaced in the Serving report section —
#: the request-accounting vocabulary from ``distkeras_tpu_torch/serving/``.
_SERVING_COUNTERS = (
    "accepted", "answered", "shed", "deadline_drops", "batches",
    "batched_rows", "padded_rows", "swaps", "swap_failures",
    "retrace_after_warmup", "client_failovers", "conn_errors",
)


def serving_summary(summary: dict) -> Optional[dict]:
    """Roll up the serving plane's metrics: request accounting (accepted /
    answered / shed — the shed-before-accept contract is checkable right
    here), latency quantiles from the ``serving.latency`` histogram, batch
    padding overhead, and hot-swap counts. None when the run served
    nothing."""
    out: dict = {}
    for name in _SERVING_COUNTERS:
        v = summary.get("counters", {}).get(f"serving.{name}")
        if v is not None:
            out[name] = v
    lat = summary.get("spans", {}).get("serving.latency")
    if lat and lat.get("count"):
        out["latency_count"] = lat["count"]
        out["latency_mean_s"] = lat.get("mean",
                                        lat.get("total", 0.0) / lat["count"])
        out["latency_p50_s"] = _hist_quantile(lat, 0.50)
        out["latency_p99_s"] = _hist_quantile(lat, 0.99)
        out["latency_max_s"] = _hist_max(lat)
    depth = summary.get("gauges", {}).get("serving.queue_depth")
    if depth is not None:
        out["queue_depth_last"] = depth.get("value")
        out["queue_depth_max"] = depth.get("max")
    return out or None


def _sum_prefixed(table: dict, base: str) -> Optional[float]:
    """Sum ``base`` plus every tenant-suffixed variant (``base.<tenant>.
    <job>``) — streaming metrics carry the fleet label suffix when the
    trainer runs as a tenant."""
    total, found = 0.0, False
    for name, v in table.items():
        if name == base or name.startswith(base + "."):
            total += float(v)
            found = True
    return total if found else None


#: ``stream.*`` counters surfaced in the Streaming report section.
_STREAMING_COUNTERS = (
    ("stream.items_read", "items_read"),
    ("stream.items_committed", "items_committed"),
    ("stream.requeued", "requeued"),
    ("stream.drift_events", "drift_events"),
    ("stream.drift_injected", "drift_injected"),
    ("stream.source_reconnects", "source_reconnects"),
)


def streaming_summary(summary: dict) -> Optional[dict]:
    """Roll up the streaming loop's metrics: ingest accounting (read /
    committed / requeued), offset lag, drift detections and recovery
    time, the windowed-eval means, and event-to-served-weight freshness
    quantiles from the ``serving.freshness`` histogram (recorded at each
    hot-swap). None when the run streamed nothing."""
    out: dict = {}
    counters = summary.get("counters", {})
    gauges = summary.get("gauges", {})
    for base, key in _STREAMING_COUNTERS:
        v = _sum_prefixed(counters, base)
        if v is not None:
            out[key] = v
    lag = gauges.get("stream.offset_lag")
    if lag is not None:
        out["offset_lag_last"] = lag.get("value")
        out["offset_lag_max"] = lag.get("max")
    for name, key in (("stream.recovery_seconds", "recovery_s"),
                      ("stream.eval.loss_fast", "eval_loss_fast"),
                      ("stream.eval.loss_slow", "eval_loss_slow"),
                      ("stream.candidate_loss", "candidate_loss")):
        g = gauges.get(name)
        if g is not None:
            out[key] = g.get("value")
    stale = [g.get("value") for n, g in gauges.items()
             if n == "stream.staleness_mean"
             or n.startswith("stream.staleness_mean.")]
    stale = [s for s in stale if s is not None]
    if stale:
        out["staleness_mean"] = max(stale)
    fresh = summary.get("spans", {}).get("serving.freshness")
    if fresh and fresh.get("count"):
        out["freshness_count"] = fresh["count"]
        out["freshness_p50_s"] = _hist_quantile(fresh, 0.50)
        out["freshness_p99_s"] = _hist_quantile(fresh, 0.99)
        out["freshness_max_s"] = _hist_max(fresh)
    rejected = counters.get("serving.swap_rejected_regression")
    if rejected is not None:
        out["swaps_rejected_regression"] = rejected
    return out or None


def shard_summary(summary: dict) -> Optional[dict]:
    """Roll up the sharded center plane's metrics: per-shard fold/byte
    counters (``netps.shard.folds.<k>`` / ``netps.shard.bytes.<k>``), the
    shard count and plan byte skew gauges, and the partial-commit count —
    the balance evidence for a partition plan lives right here (a skew
    near 1.0 and near-equal fold columns mean the byte-balancer did its
    job). None when the run had no sharded center."""
    counters = summary.get("counters", {})
    gauges = summary.get("gauges", {})
    folds: dict = {}
    nbytes: dict = {}
    for name, v in counters.items():
        parts = name.split(".")
        if len(parts) == 4 and parts[:2] == ["netps", "shard"]:
            try:
                k = int(parts[3])
            except ValueError:
                continue
            if parts[2] == "folds":
                folds[k] = v
            elif parts[2] == "bytes":
                nbytes[k] = v
    out: dict = {}
    if folds:
        out["per_shard_folds"] = [folds.get(k, 0.0)
                                  for k in range(max(folds) + 1)]
    if nbytes:
        out["per_shard_bytes"] = [nbytes.get(k, 0.0)
                                  for k in range(max(nbytes) + 1)]
    count = gauges.get("netps.shard.count")
    if count is not None:
        out["shard_count"] = count.get("value")
    skew = gauges.get("netps.shard.skew")
    if skew is not None:
        out["plan_skew"] = skew.get("value")
    partial = counters.get("netps.shard.partial_commits")
    if partial is not None:
        out["partial_commits"] = partial
    return out or None


def tuner_summary(records: list[dict], summary: dict) -> Optional[dict]:
    """Roll up the self-tuning data plane's evidence: the decision log
    (``tuner_decision`` events — knob, from→to, the gauge that triggered
    it, the round it landed in), the join-time probe sweep
    (``tuner_probe``), oscillation fallbacks (``tuner_fallback``), and
    the converged dialect (``tuner_run_summary``). None when the run
    never had the controller aboard (``DKTPU_NET_AUTOTUNE`` off)."""
    counters = summary.get("counters", {})
    decisions = [
        {"knob": e.get("knob"), "from": e.get("from"), "to": e.get("to"),
         "trigger": e.get("trigger"), "round": e.get("round")}
        for e in records if e.get("kind") == "tuner_decision"]
    probes = [
        {"codec": e.get("codec"), "probes": e.get("probes"),
         "seconds": e.get("seconds"), "score": e.get("score")}
        for e in records if e.get("kind") == "tuner_probe"]
    fallbacks = [
        {"knob": e.get("knob"), "restored": e.get("restored"),
         "round": e.get("round"), "reason": e.get("reason")}
        for e in records if e.get("kind") == "tuner_fallback"]
    converged = None
    for e in records:
        if e.get("kind") == "tuner_run_summary":
            converged = {k: e.get(k) for k in
                         ("inflight", "codec", "shards", "transport",
                          "retunes", "fallbacks", "deferred")}
    out: dict = {}
    if decisions:
        out["decisions"] = decisions
    if probes:
        out["probes"] = probes
    if fallbacks:
        out["fallbacks"] = fallbacks
    if converged is not None:
        out["converged"] = converged
    for key, name in (("deferred", "tuner.deferred"),
                      ("floor_violations", "tuner.floor_violations"),
                      ("knob_warnings", "tuner.knob_warnings"),
                      ("expand_blocked", "tuner.expand_blocked")):
        if counters.get(name):
            out[key] = counters[name]
    return out or None


def straggler_table(rounds: list[dict], k: float = STRAGGLER_K) -> list[dict]:
    """Rounds whose wall time exceeds ``k`` x the median round time (plus
    any rounds the live monitor already flagged). Burst-tail rounds
    (interior rounds of a compiled block) are real rounds but not timing
    boundaries — they are excluded from both the median anchor and the
    flagging, or every block-final round would flag against a tail-scale
    median."""
    timed = [(r["round"], r["round_seconds"], bool(r.get("straggler")))
             for r in rounds
             if r.get("round_seconds") and not _is_burst_tail(r)]
    if not timed:
        return []
    times = [t for _, t, _ in timed]
    med = float(np.median(times))
    flagged = set(flag_stragglers(times, k))
    return [
        {"round": rd, "seconds": t,
         "x_median": round(t / med, 2) if med > 0 else None,
         "flagged_live": live}
        for i, (rd, t, live) in enumerate(timed)
        if i in flagged or live
    ]


def build_report(path: str, k: float = STRAGGLER_K) -> dict:
    """The full structured report for one JSONL file."""
    records = read_jsonl(path)
    rounds = _round_records(records)
    summaries = _summaries(records)
    # Later summaries supersede earlier ones span-by-span (a re-used path
    # accumulates one summary per run; the last run's registry is current).
    merged: dict = {"spans": {}, "counters": {}, "gauges": {}}
    for s in summaries:
        for key in merged:
            merged[key].update(s.get(key, {}))
    segments = throughput_segments(rounds)
    total_s = sum(s["seconds"] for s in segments)
    return {
        "path": path,
        "rounds": len(rounds),
        "total_round_seconds": total_s,
        "phases": phase_breakdown(merged),
        "counters": merged["counters"],
        "gauges": merged["gauges"],
        "segments": segments,
        "staleness": staleness_summary(rounds),
        "stragglers": straggler_table(rounds, k),
        "fleet": fleet_attribution(merged),
        "serving": serving_summary(merged),
        "streaming": streaming_summary(merged),
        "shards": shard_summary(merged),
        "tuner": tuner_summary(records, merged),
        "losses": [r["loss"] for r in rounds if "loss" in r],
    }


def _fmt_seconds(s: float) -> str:
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f}ms"
    return f"{s * 1e6:.0f}us"


def render_report(report: dict) -> str:
    """Human-readable text rendering of :func:`build_report` output."""
    out = io.StringIO()
    w = out.write
    w(f"# Telemetry report — {report['path']}\n")
    w(f"rounds: {report['rounds']}   "
      f"round wall time: {_fmt_seconds(report['total_round_seconds'])}\n")
    if report["losses"]:
        w(f"loss: first {report['losses'][0]:.4f}  "
          f"last {report['losses'][-1]:.4f}\n")

    if report["phases"]:
        w("\n## Phase breakdown (spans)\n")
        w(f"{'span':<40} {'count':>7} {'total':>10} {'mean':>10} "
          f"{'share':>6}\n")
        for p in report["phases"]:
            share = f"{p['share'] * 100:.0f}%" if p["share"] is not None else "-"
            w(f"{p['span']:<40} {p['count']:>7} "
              f"{_fmt_seconds(p['total_s']):>10} "
              f"{_fmt_seconds(p['mean_s']):>10} {share:>6}\n")

    if report["segments"]:
        w("\n## Throughput segments\n")
        w(f"{'first_round':>11} {'rounds':>7} {'seconds':>10} "
          f"{'samples/s':>12}\n")
        for s in report["segments"]:
            sps = (f"{s['samples_per_sec']:,.0f}"
                   if s["samples_per_sec"] else "-")
            w(f"{s['first_round']:>11} {s['rounds']:>7} "
              f"{s['seconds']:>10.4f} {sps:>12}\n")

    stall = report["counters"].get("input_stall_seconds")
    if stall is not None and report["total_round_seconds"] > 0:
        frac = stall / report["total_round_seconds"]
        w(f"\ninput stall: {_fmt_seconds(stall)} "
          f"({frac * 100:.1f}% of round wall time)\n")

    if report["staleness"]:
        st = report["staleness"]
        w("\n## Staleness\n")
        if "per_worker_mean" in st:
            w(f"workers: {st['num_workers']}\n")
            w(f"per-worker mean staleness: {st['per_worker_mean']}\n")
            w(f"per-worker max staleness:  {st['per_worker_max']}\n")
        if "dynsgd_scale_mean" in st:
            w(f"DynSGD mean fold scale:    {st['dynsgd_scale_mean']}\n")
        if "loss_divergence_rms" in st:
            w(f"loss divergence rms:       {st['loss_divergence_rms']}\n")
            w(f"loss divergence max |.|:   "
              f"{st['loss_divergence_max_abs']}\n")

    if report.get("fleet"):
        w("\n## Fleet (per-tenant attribution)\n")
        w(f"{'tenant':<12} {'job':<14} {'commits':>8} {'c/s':>7} "
          f"{'stale':>6} {'preempt':>8} {'shrink':>7} {'expand':>7} "
          f"{'restart':>8} {'debt':>5}\n")
        for r in report["fleet"]:
            cps = r.get("commits_per_sec")
            w(f"{r['tenant']:<12} {r['job']:<14} "
              f"{r.get('commits', 0):>8.0f} "
              f"{(f'{cps:.1f}' if cps is not None else '-'):>7} "
              f"{r.get('staleness_mean', 0.0):>6.2f} "
              f"{r.get('preemptions', 0):>8.0f} "
              f"{r.get('shrinks', 0):>7.0f} {r.get('expands', 0):>7.0f} "
              f"{r.get('restarts', 0):>8.0f} "
              f"{r.get('preempt_debt', 0.0):>5.0f}\n")

    if report.get("serving"):
        sv = report["serving"]
        w("\n## Serving\n")
        w(f"accepted: {sv.get('accepted', 0):.0f}   "
          f"answered: {sv.get('answered', 0):.0f}   "
          f"shed: {sv.get('shed', 0):.0f}   "
          f"deadline drops: {sv.get('deadline_drops', 0):.0f}\n")
        if "latency_count" in sv:
            w(f"latency: p50 {_fmt_seconds(sv['latency_p50_s'])}   "
              f"p99 {_fmt_seconds(sv['latency_p99_s'])}   "
              f"mean {_fmt_seconds(sv['latency_mean_s'])}   "
              f"max {_fmt_seconds(sv['latency_max_s'])}\n")
        if sv.get("batches"):
            rows = sv.get("batched_rows", 0)
            pad = sv.get("padded_rows", 0)
            frac = pad / (rows + pad) if (rows + pad) else 0.0
            w(f"batches: {sv['batches']:.0f}   rows: {rows:.0f}   "
              f"padding overhead: {frac * 100:.1f}%\n")
        w(f"hot-swaps: {sv.get('swaps', 0):.0f} "
          f"({sv.get('swap_failures', 0):.0f} rejected)   "
          f"retraces after warmup: "
          f"{sv.get('retrace_after_warmup', 0):.0f}\n")

    if report.get("streaming"):
        st = report["streaming"]
        w("\n## Streaming\n")
        w(f"items: read {st.get('items_read', 0):.0f}   "
          f"committed {st.get('items_committed', 0):.0f}   "
          f"requeued {st.get('requeued', 0):.0f}\n")
        if "offset_lag_last" in st:
            w(f"offset lag: last {st['offset_lag_last']:.0f}   "
              f"max {st.get('offset_lag_max', 0):.0f}\n")
        if st.get("drift_events") is not None or \
                st.get("drift_injected") is not None:
            w(f"drift: detected {st.get('drift_events', 0):.0f}   "
              f"injected {st.get('drift_injected', 0):.0f}")
            if st.get("recovery_s") is not None:
                w(f"   last recovery {_fmt_seconds(st['recovery_s'])}")
            w("\n")
        if st.get("eval_loss_fast") is not None:
            w(f"windowed eval loss: fast {st['eval_loss_fast']:.4f}   "
              f"slow {st.get('eval_loss_slow', float('nan')):.4f}\n")
        if "freshness_count" in st:
            w(f"event-to-served-weight freshness: "
              f"p50 {_fmt_seconds(st['freshness_p50_s'])}   "
              f"p99 {_fmt_seconds(st['freshness_p99_s'])}   "
              f"max {_fmt_seconds(st['freshness_max_s'])} "
              f"({st['freshness_count']:.0f} swaps)\n")
        for key, label in (("source_reconnects", "source reconnects"),
                           ("swaps_rejected_regression",
                            "swaps rejected (regression)")):
            if st.get(key):
                w(f"{label}: {st[key]:.0f}\n")
        if st.get("staleness_mean") is not None:
            w(f"staleness mean: {st['staleness_mean']:.2f}\n")

    if report.get("shards"):
        sh = report["shards"]
        w("\n## Sharded center\n")
        if "shard_count" in sh:
            skew = sh.get("plan_skew")
            w(f"shards: {sh['shard_count']:.0f}   plan byte skew: "
              f"{(f'{skew:.3f}' if skew is not None else '-')}\n")
        if sh.get("per_shard_folds"):
            w(f"per-shard folds: "
              f"{[int(v) for v in sh['per_shard_folds']]}\n")
        if sh.get("per_shard_bytes"):
            w(f"per-shard bytes: "
              f"{[int(v) for v in sh['per_shard_bytes']]}\n")
        if sh.get("partial_commits"):
            w(f"partial commits (reconciled): "
              f"{sh['partial_commits']:.0f}\n")

    if report.get("tuner"):
        tu = report["tuner"]
        w("\n## Tuner\n")
        conv = tu.get("converged")
        if conv:
            w(f"converged: codec={conv.get('codec')} "
              f"inflight={conv.get('inflight')} "
              f"shards={conv.get('shards')} "
              f"transport={conv.get('transport')}   "
              f"retunes: {conv.get('retunes', 0)}   "
              f"fallbacks: {conv.get('fallbacks', 0)}   "
              f"deferred: {conv.get('deferred', 0)}\n")
        if tu.get("probes"):
            w(f"{'probe codec':<12} {'probes':>7} {'seconds':>10} "
              f"{'bytes/s':>14}\n")
            for p in tu["probes"]:
                w(f"{str(p['codec']):<12} {p['probes']:>7} "
                  f"{p['seconds']:>10.4f} {p['score']:>14,.0f}\n")
        if tu.get("decisions"):
            w(f"{'round':>7} {'knob':<12} {'from':>8} {'to':>8} "
              f"trigger\n")
            for d in tu["decisions"]:
                w(f"{d['round']:>7} {str(d['knob']):<12} "
                  f"{str(d['from']):>8} {str(d['to']):>8} "
                  f"{d['trigger']}\n")
        for fb in tu.get("fallbacks", ()):
            w(f"oscillation fallback: {fb['knob']} restored to "
              f"{fb['restored']} at round {fb['round']} ({fb['reason']})\n")
        for key, label in (("floor_violations", "floor violations"),
                           ("knob_warnings", "knob warnings"),
                           ("expand_blocked", "expansions blocked"),
                           ("deferred", "deferred applies")):
            if tu.get(key):
                w(f"{label}: {tu[key]:.0f}\n")

    w("\n## Stragglers\n")
    if report["stragglers"]:
        w(f"{'round':>7} {'seconds':>10} {'x median':>9} {'live flag':>10}\n")
        for s in report["stragglers"]:
            w(f"{s['round']:>7} {s['seconds']:>10.4f} "
              f"{s['x_median']:>9} {str(s['flagged_live']):>10}\n")
    else:
        w("none flagged\n")
    return out.getvalue()


def merged_records(path: str) -> list[dict]:
    """The clock-aligned, deduped record list for ``path``: a directory
    is collector-merged across every per-process stream (+ rotated
    generations) it holds; a single file goes through the same collector
    so one-stream and N-stream paths render identically."""
    import os

    from distkeras_tpu_torch.telemetry.tracing import TelemetryCollector

    if os.path.isdir(path):
        return TelemetryCollector.from_dir(path).records()
    return TelemetryCollector([path]).records()


def scrape_stats(endpoint: str, ring: int = 64,
                 timeout: float = 5.0) -> dict:
    """One live ``stats`` frame from a PS/serving process: counters,
    gauges, and the head of its flight-recorder ring — no join, no
    membership, works against a standby or a fenced ex-primary (the
    processes a postmortem most wants to ask)."""
    import socket

    from distkeras_tpu_torch.netps import wire

    host, port = wire.split_endpoint(endpoint)
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(timeout)
        wire.send_frame(sock, wire.KIND_REQUEST,
                        {"op": wire.OP_STATS, "req": 0,
                         "ring": int(ring)}, [])
        while True:
            kind, rhdr, _arrays = wire.read_frame(sock)
            if kind == wire.KIND_REPLY and rhdr.get("req") == 0:
                return rhdr


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(
        prog="python -m distkeras_tpu_torch.telemetry",
        description="Render a run report from a metrics/telemetry JSONL.")
    sub = parser.add_subparsers(dest="command", required=True)
    rep = sub.add_parser("report", help="render a per-run report")
    rep.add_argument("path", help="metrics/telemetry JSONL file (or, with "
                                  "--trace, a directory of per-process "
                                  "streams to collector-merge)")
    rep.add_argument("--straggler-k", type=float, default=STRAGGLER_K,
                     help="flag rounds slower than k x median "
                          f"(default {STRAGGLER_K})")
    rep.add_argument("--trace", action="store_true",
                     help="render the distributed-trace report (critical-"
                          "path breakdown, completeness, chaos "
                          "correlation) instead of the run report")
    rep.add_argument("--json", action="store_true",
                     help="emit the structured report as JSON instead of text")
    scr = sub.add_parser(
        "scrape", help="fetch a live telemetry snapshot from a running "
                       "PS/serving process over the wire")
    scr.add_argument("endpoint", help="host:port of the process to scrape")
    scr.add_argument("--ring", type=int, default=64,
                     help="flight-ring records to include (default 64)")
    scr.add_argument("--timeout", type=float, default=5.0)
    scr.add_argument("--json", action="store_true",
                     help="one compact JSON line (scripts/pipelines) "
                          "instead of the indented dump")
    from distkeras_tpu_torch.telemetry.health import cli as health_cli

    health_cli.add_subcommands(sub)
    args = parser.parse_args(argv)
    if args.command == "health":
        return health_cli.cmd_health(args)
    if args.command == "top":
        return health_cli.cmd_top(args)
    if args.command == "scrape":
        import socket
        import sys

        try:
            stats = scrape_stats(args.endpoint, ring=args.ring,
                                 timeout=args.timeout)
        except (ConnectionError, socket.timeout, OSError) as e:
            # Typed single-line error, not a traceback: an unreachable
            # process is a *finding* for an operator, not a crash.
            kind = ("timeout" if isinstance(e, socket.timeout)
                    else "connection_refused"
                    if isinstance(e, ConnectionRefusedError)
                    else "unreachable")
            print(f"scrape error: {kind}: {args.endpoint} "
                  f"({type(e).__name__}: {e})", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(stats, default=str))
        else:
            print(json.dumps(stats, default=str, indent=2))
        return 0
    if args.trace:
        import os
        import sys

        from distkeras_tpu_torch.telemetry.tracing import (render_trace_report,
                                                     trace_report)

        if not os.path.exists(args.path):
            # Contract (pinned by tests): a path that does not exist is an
            # operator error -> one line on stderr, exit 2. An EXISTING
            # dir with no records renders the empty report, exit 0 (a
            # fleet that traced nothing is a valid, boring answer).
            print(f"trace report: no such file or directory: {args.path}",
                  file=sys.stderr)
            return 2
        report = trace_report(merged_records(args.path))
        if args.json:
            print(json.dumps(report, default=float))
        else:
            print(render_trace_report(report), end="")
        return 0
    report = build_report(args.path, k=args.straggler_k)
    if args.json:
        print(json.dumps(report, default=float))
    else:
        print(render_report(report), end="")
    return 0
