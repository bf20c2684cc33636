"""Critical-path analysis over collector-merged trace streams.

Input is the flat record list :meth:`~distkeras_tpu_torch.telemetry.tracing.
collector.TelemetryCollector.records` produces (clock-aligned, deduped,
identity-stamped); output is the structured trace report ``python -m
distkeras_tpu_torch.telemetry report --trace`` renders:

* per-commit **critical-path breakdown** — every commit trace decomposed
  into the lifecycle segments (encode / wire / queue-behind-fold / fold /
  fsync / replicate / ACK), with exact p50/p99 per segment (computed from
  the full duration lists, not histogram buckets — the collector already
  holds every span);
* **completeness** — a commit trace is complete when it carries every
  segment the *deployment* produces: encode/wire/queue/fold/ack always,
  fsync only when the run journaled (any fsync span exists in the merged
  stream), replicate only when a standby tailed it. Config-awareness
  keeps a memory-only run from reporting 0% complete;
* **slowest-trace exemplars** — the top traces by end-to-end duration,
  each with its own segment split (the "what do I look at first" table);
* **chaos correlation** — fault/eviction/rejoin/promotion/flight-dump
  events that overlap the slow tail (> p99 end-to-end), so an injected
  ``ps_crash`` shows up next to the commits it stalled;
* **orphan + clock checks** — traces with server-side spans but no
  client root (a crashed client, or a propagation bug), and traces whose
  child spans start before their root even after alignment (a clock
  estimate that went wrong).

Pure stdlib over plain dicts — importable wherever the collector is.
"""

from __future__ import annotations

from typing import Iterable, Optional

from distkeras_tpu_torch.telemetry.tracing.context import SPAN_KIND

#: span-name -> segment label for the commit lifecycle, in path order.
COMMIT_SEGMENTS = {
    "commit.encode": "encode",
    "commit.wire": "wire",
    "commit.queue": "queue",
    "commit.fold": "fold",
    "commit.fsync": "fsync",
    "commit.replicate": "replicate",
    "commit.ack": "ack",
}
SEGMENT_ORDER = ("encode", "wire", "queue", "fold", "fsync",
                 "replicate", "ack")
#: segments every deployment produces; fsync/replicate join the required
#: set only when the merged stream shows the run actually had them.
BASE_REQUIRED = frozenset({"encode", "wire", "queue", "fold", "ack"})
#: span names that root a trace client-side — a trace containing none of
#: these but some server-side segment is an *orphan* (its origin process
#: never wrote its half, or propagation broke).
ROOT_NAMES = frozenset({"commit", "pull", "serve.request", "hier.flush",
                        "tuner.retune"})
#: event kinds correlated against the slow tail.
CHAOS_KINDS = frozenset({"fault_injected", "flight_dump", "netps_eviction",
                         "netps_rejoin", "netps_promotion",
                         "netps_fenced", "serving_revocation",
                         "netps_lost_window", "netps_tree_window_drop",
                         "netps_tree_link_down"})
#: alignment slack (seconds) before a child-before-root timestamp counts
#: as a clock violation — min-RTT offset estimates are good to ~rtt/2.
SKEW_SLACK_S = 0.005
#: sample floor below which a fitted segment distribution is flagged
#: unreliable (lognormal mu/sigma from < this many points is noise).
MIN_FIT_SAMPLES = 8


def spans_of(records: Iterable[dict]) -> list[dict]:
    """Just the span records of a merged stream."""
    return [r for r in records if r.get("kind") == SPAN_KIND
            and r.get("trace")]


def assemble_traces(records: Iterable[dict]) -> dict:
    """Group spans by trace id: ``{trace: {"spans": [...], "root": ...}}``.
    The root is the trace's parentless span (the client scope that minted
    the id); None for orphans."""
    traces: dict = {}
    for rec in spans_of(records):
        t = traces.setdefault(rec["trace"], {"spans": [], "root": None})
        t["spans"].append(rec)
        if not rec.get("parent") and rec.get("name") in ROOT_NAMES:
            # Two parentless spans can share a trace (a standby's
            # replicate span carries no parent by design) — the named
            # root wins; first one sticks if a stream was double-merged.
            if t["root"] is None:
                t["root"] = rec
    return traces


def _segment_durs(spans: list[dict]) -> dict:
    """Per-segment duration of one trace. Fan-out segments (a striped
    commit sends one ``commit.wire`` per shard, folded on N servers) take
    the MAX across their spans — stripes run in parallel and the slowest
    one gates the commit; summing would bill serial time the client never
    waited."""
    durs: dict = {}
    for s in spans:
        seg = COMMIT_SEGMENTS.get(s.get("name", ""))
        if seg is None:
            continue
        d = float(s.get("dur") or 0.0)
        durs[seg] = max(durs.get(seg, 0.0), d)
    return durs


def _quantile(sorted_vals: list, q: float) -> float:
    """Exact nearest-rank quantile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


def commit_paths(records: Iterable[dict]) -> list[tuple]:
    """Every commit trace's critical path: ``[(trace_id, root_span,
    segment_durs, end_to_end_s)]`` in trace-id order. A commit trace is
    one rooted by a ``commit`` span, or a ``hier.flush`` that carries a
    nested ``commit`` (the aggregator's upstream hop). This is the ONE
    commit-selection rule — :func:`trace_report` and
    :func:`segment_model` both read it, so the report and the simulator
    calibrate from the same population."""
    out = []
    for tid, t in sorted(assemble_traces(records).items()):
        root = t["root"]
        if root is None:
            continue
        name = root.get("name")
        if name == "commit" or (name == "hier.flush" and any(
                s.get("name") == "commit" for s in t["spans"])):
            out.append((tid, root, _segment_durs(t["spans"]),
                        float(root.get("dur") or 0.0)))
    return out


def _lognorm_fit(vals: list) -> Optional[dict]:
    """Method-of-moments-in-log-space lognormal fit over the positive
    samples (a zero-duration span carries no timing information)."""
    import math

    pos = [v for v in vals if v > 0.0]
    if not pos:
        return None
    logs = [math.log(v) for v in pos]
    mu = sum(logs) / len(logs)
    var = sum((x - mu) ** 2 for x in logs) / len(logs)
    return {"mu": mu, "sigma": math.sqrt(var), "samples": len(pos)}


def segment_model(records: Optional[list] = None, *,
                  commits: Optional[list] = None,
                  min_samples: int = MIN_FIT_SAMPLES) -> dict:
    """The per-segment quantile extraction + fitted latency model — the
    ONE implementation behind both the ``--trace`` report's segment table
    and the fleet simulator's calibration (the JAX package's ``sim``), so the
    two can never drift.

    Pass a collector-merged record list, or a precomputed
    :func:`commit_paths` list via ``commits=``. Returns::

        {"segments": {seg: {count, p50_s, p99_s, max_s, total_s, mean_s,
                            lognorm: {mu, sigma, samples} | None,
                            fit_ok: bool}},
         "e2e": {count, p50_s, p99_s, mean_s} | None,
         "commits": N, "min_samples": min_samples,
         "warnings": ["segment 'x' has 3 samples (< 8) ..."]}

    ``lognorm`` is a log-space moment fit (duration distributions are
    multiplicative: a segment is a product of per-byte / per-row costs),
    good enough to resample from; ``fit_ok`` is False when the segment
    has fewer than ``min_samples`` positive samples."""
    if commits is None:
        commits = commit_paths(records or [])
    seg_durs: dict = {seg: [] for seg in SEGMENT_ORDER}
    for _tid, _root, durs, _e2e in commits:
        for seg, d in durs.items():
            seg_durs[seg].append(d)

    segments: dict = {}
    warnings: list[str] = []
    for seg in SEGMENT_ORDER:
        vals = sorted(seg_durs[seg])
        if not vals:
            continue
        fit = _lognorm_fit(vals)
        ok = bool(fit and fit["samples"] >= min_samples)
        if not ok:
            n = fit["samples"] if fit else 0
            warnings.append(
                f"segment {seg!r} has {n} positive sample(s) "
                f"(< {min_samples}) — fit unreliable")
        segments[seg] = {
            "count": len(vals),
            "p50_s": _quantile(vals, 0.50),
            "p99_s": _quantile(vals, 0.99),
            "max_s": vals[-1],
            "total_s": sum(vals),
            "mean_s": sum(vals) / len(vals),
            "lognorm": fit,
            "fit_ok": ok,
        }

    e2e_sorted = sorted(e for _t, _r, _d, e in commits)
    e2e = None
    if e2e_sorted:
        e2e = {"count": len(e2e_sorted),
               "p50_s": _quantile(e2e_sorted, 0.50),
               "p99_s": _quantile(e2e_sorted, 0.99),
               "mean_s": sum(e2e_sorted) / len(e2e_sorted)}
    return {"segments": segments, "e2e": e2e, "commits": len(commits),
            "min_samples": min_samples, "warnings": warnings}


def required_segments(all_spans: list[dict]) -> frozenset:
    """The config-aware completeness bar for this stream."""
    names = {s.get("name") for s in all_spans}
    req = set(BASE_REQUIRED)
    if "commit.fsync" in names:
        req.add("fsync")
    if "commit.replicate" in names:
        req.add("replicate")
    return frozenset(req)


def _skew_violation(root: dict, spans: list[dict]) -> bool:
    """Whether any child starts before the root after alignment (beyond
    the slack an rtt/2-quality offset estimate legitimately leaves)."""
    r0 = float(root.get("t0") or 0.0)
    return any(float(s.get("t0") or 0.0) < r0 - SKEW_SLACK_S
               for s in spans if s is not root)


def trace_report(records: list[dict]) -> dict:
    """The structured ``--trace`` report over one merged record list."""
    all_spans = spans_of(records)
    traces = assemble_traces(records)
    required = required_segments(all_spans)

    orphans: list[str] = []
    skew_violations = 0
    kinds = {"pull": 0, "serve.request": 0, "hier.flush": 0,
             "tuner.retune": 0}
    for tid, t in sorted(traces.items()):
        root = t["root"]
        if root is None:
            # Server-side segments with no client half.
            if any(s.get("name") in COMMIT_SEGMENTS for s in t["spans"]):
                orphans.append(tid)
            continue
        if _skew_violation(root, t["spans"]):
            skew_violations += 1
        name = root.get("name")
        if name in kinds:
            kinds[name] += 1
    commits = commit_paths(records)

    complete = [c for c in commits if required <= set(c[2])]
    # The quantile extraction + fit — shared verbatim with the simulator's
    # calibration; the report's segment table is a projection of it.
    calibration = segment_model(commits=commits)
    segments = {seg: {k: info[k] for k in
                      ("count", "p50_s", "p99_s", "max_s", "total_s")}
                for seg, info in calibration["segments"].items()}

    e2e_sorted = sorted(e for _t, _r, _d, e in commits)
    p99_e2e = _quantile(e2e_sorted, 0.99)
    slowest = sorted(commits, key=lambda c: -c[3])[:3]
    exemplars = [{
        "trace": tid,
        "dur_s": e2e,
        "t0": float(root.get("t0") or 0.0),
        "role": root.get("role"),
        "wid": root.get("wid"),
        "seq": root.get("seq"),
        "segments": {seg: durs.get(seg) for seg in SEGMENT_ORDER
                     if seg in durs},
    } for tid, root, durs, e2e in slowest]

    # Chaos correlation: disruption events overlapping the slow tail.
    slow = [(tid, float(root.get("t0") or 0.0), e2e)
            for tid, root, _d, e2e in commits if e2e > p99_e2e > 0.0]
    chaos = []
    for rec in records:
        if rec.get("kind") not in CHAOS_KINDS:
            continue
        ts = float(rec.get("ts") or 0.0)
        hit = [tid for tid, t0, e2e in slow
               if t0 - 1.0 <= ts <= t0 + e2e + 1.0]
        chaos.append({
            "kind": rec.get("kind"),
            "ts": ts,
            "role": rec.get("role"),
            "detail": rec.get("fault") or rec.get("reason")
            or rec.get("wid"),
            "slow_traces": hit,
        })

    return {
        "traces": len(traces),
        "commits": len(commits),
        "complete": len(complete),
        "completeness": (len(complete) / len(commits)) if commits else None,
        "required": sorted(required),
        "segments": segments,
        "calibration": calibration,
        "e2e_p50_s": _quantile(e2e_sorted, 0.50),
        "e2e_p99_s": p99_e2e,
        "slowest": exemplars,
        "chaos": chaos,
        "orphans": orphans,
        "skew_violations": skew_violations,
        "pulls": kinds["pull"],
        "serves": kinds["serve.request"],
        "hier_flushes": kinds["hier.flush"],
        "retunes": kinds["tuner.retune"],
        "streams": sorted({r.get("stream") for r in records
                           if r.get("stream")}),
        "processes": sorted({f"{r.get('role')}:{r.get('pid')}"
                             for r in spans_of(records)}),
    }


def _fmt_s(s: Optional[float]) -> str:
    if s is None:
        return "-"
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f}ms"
    return f"{s * 1e6:.0f}us"


def render_trace_report(rep: dict) -> str:
    """Human-readable rendering of :func:`trace_report` output."""
    import io

    out = io.StringIO()
    w = out.write
    w("# Trace report\n")
    w(f"streams: {len(rep['streams'])}   "
      f"processes: {', '.join(rep['processes']) or '-'}\n")
    comp = rep["completeness"]
    w(f"traces: {rep['traces']}   commit traces: {rep['commits']}   "
      f"complete: {rep['complete']}"
      + (f" ({comp * 100:.1f}%)" if comp is not None else "") + "\n")
    w(f"required segments: {', '.join(rep['required'])}\n")
    if rep["commits"]:
        w(f"end-to-end: p50 {_fmt_s(rep['e2e_p50_s'])}   "
          f"p99 {_fmt_s(rep['e2e_p99_s'])}\n")

    if rep["segments"]:
        w("\n## Critical path (per-commit segments)\n")
        w(f"{'segment':<12} {'count':>7} {'p50':>10} {'p99':>10} "
          f"{'max':>10} {'total':>10}\n")
        for seg in SEGMENT_ORDER:
            h = rep["segments"].get(seg)
            if h is None:
                continue
            w(f"{seg:<12} {h['count']:>7} {_fmt_s(h['p50_s']):>10} "
              f"{_fmt_s(h['p99_s']):>10} {_fmt_s(h['max_s']):>10} "
              f"{_fmt_s(h['total_s']):>10}\n")

    cal = rep.get("calibration") or {}
    if cal.get("segments"):
        w("\n## Calibration (fitted segment model)\n")
        w(f"{'segment':<12} {'samples':>8} {'mean':>10} "
          f"{'lognorm mu':>11} {'sigma':>8}\n")
        for seg in SEGMENT_ORDER:
            info = cal["segments"].get(seg)
            if info is None:
                continue
            fit = info.get("lognorm")
            mu = f"{fit['mu']:.3f}" if fit else "-"
            sigma = f"{fit['sigma']:.3f}" if fit else "-"
            flag = "" if info.get("fit_ok") else "  (!)"
            w(f"{seg:<12} {info['count']:>8} "
              f"{_fmt_s(info['mean_s']):>10} {mu:>11} {sigma:>8}{flag}\n")
        for warning in cal.get("warnings", ()):
            w(f"WARNING: {warning}\n")

    if rep["slowest"]:
        w("\n## Slowest commits\n")
        for ex in rep["slowest"]:
            segs = "  ".join(f"{k}={_fmt_s(v)}"
                             for k, v in ex["segments"].items())
            who = f"wid={ex['wid']} seq={ex['seq']}" \
                if ex.get("wid") is not None else ex["trace"]
            w(f"{_fmt_s(ex['dur_s']):>10}  {who}  [{segs}]\n")

    chaos = [c for c in rep.get("chaos", []) or []]
    if chaos:
        w("\n## Chaos correlation\n")
        for c in chaos:
            hit = (f" -> slow traces {', '.join(c['slow_traces'])}"
                   if c["slow_traces"] else "")
            w(f"{c['kind']} ({c.get('detail')}) at {c['ts']:.3f} "
              f"on {c.get('role')}{hit}\n")

    extras = []
    if rep["pulls"]:
        extras.append(f"pulls: {rep['pulls']}")
    if rep["serves"]:
        extras.append(f"served requests: {rep['serves']}")
    if rep["hier_flushes"]:
        extras.append(f"hier flushes: {rep['hier_flushes']}")
    if rep["retunes"]:
        extras.append(f"retunes: {rep['retunes']}")
    if extras:
        w("\n" + "   ".join(extras) + "\n")
    if rep["orphans"]:
        w(f"\nWARNING: {len(rep['orphans'])} orphan trace(s) — server "
          f"spans with no client root: "
          f"{', '.join(rep['orphans'][:8])}\n")
    if rep["skew_violations"]:
        w(f"WARNING: {rep['skew_violations']} trace(s) with child spans "
          f"before their root after alignment (clock estimate suspect)\n")
    return out.getvalue()
