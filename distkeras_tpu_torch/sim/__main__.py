"""``python -m distkeras_tpu_torch.sim`` — run scenarios, calibrate, report.

Subcommands::

    run <scenario> [--seed N] [--workers N] [--json]
        Run one what-if scenario (see ``--list``); exits non-zero when
        any of the scenario's invariant checks fails.

    calibrate [--summary PATH] [--band PCT] [--seed N] [--json]
        The flat->hier crossover replay against the bench summary's
        ``hier_curve``: held-out predictions must land within the band
        and the predicted crossover must match the measured one.
        ``--tree-live live.json`` runs the aggregation-tree gate
        instead: re-fit ``region_partition`` from a recorded live tree
        run and assert the root ingress cut and partition staleness
        spike agree within the band (the ``tree_parity`` block the tree
        chaos smoke writes into BENCH_SUMMARY.json).

    report --trace-dir DIR [--json]
        Fit the timing model from a trace stream and print it (the same
        ``segment_model`` numbers the telemetry ``--trace`` report's
        Calibration section renders, plus the work pseudo-segment).
"""

from __future__ import annotations

import argparse
import json
import sys

from distkeras_tpu_torch.sim.scenarios import SCENARIOS, run_scenario


def _render_checks(out: dict) -> str:
    lines = [f"scenario: {out.get('scenario')}  seed={out.get('seed')}  "
             f"virtual={out.get('virtual_s', '-')}s  "
             f"events={out.get('events', '-')}"]
    for name, ok in (out.get("checks") or {}).items():
        lines.append(f"  [{'PASS' if ok else 'FAIL'}] {name}")
    lines.append("OK" if out.get("ok") else "FAILED")
    return "\n".join(lines)


def _cmd_run(args: argparse.Namespace) -> int:
    kwargs = {}
    if args.seed is not None:
        kwargs["seed"] = args.seed
    if args.workers is not None:
        kwargs["workers"] = args.workers
    out = run_scenario(args.scenario, **kwargs)
    print(json.dumps(out, indent=2, sort_keys=True) if args.json
          else _render_checks(out))
    return 0 if out.get("ok") else 1


def _cmd_calibrate(args: argparse.Namespace) -> int:
    from distkeras_tpu_torch.sim.calibrate import hier_crossover, tree_parity

    if args.tree_live:
        with open(args.tree_live, "r", encoding="utf-8") as f:
            live = json.load(f)
        out = tree_parity(live, band_pct=args.band, seed=args.seed or 0)
        if args.json:
            print(json.dumps(out, indent=2, sort_keys=True))
        else:
            print(f"tree parity: ingress cut live="
                  f"{out['live']['ingress_cut']} sim="
                  f"{out['sim']['ingress_cut']} "
                  f"(ratio {out['ingress_cut_ratio']})  staleness spike "
                  f"live={out['live']['staleness_spike']} sim="
                  f"{out['sim']['staleness_spike']} "
                  f"(ratio {out['staleness_spike_ratio']})  band "
                  f"{out['band_pct']:.0f}%")
        print("OK" if out["within_band"] else "FAILED")
        return 0 if out["within_band"] else 1
    out = hier_crossover(summary=args.summary, band_pct=args.band,
                         seed=args.seed or 0)
    if args.json:
        print(json.dumps(out, indent=2, sort_keys=True))
    else:
        print(f"calibration: S_flat="
              f"{out['calibration']['service_flat_s'] * 1e3:.1f}ms  "
              f"S_agg={out['calibration']['service_agg_s'] * 1e3:.1f}ms  "
              f"flush={out['calibration']['flush_cost_s'] * 1e3:.1f}ms")
        for p in out["points"]:
            tag = "held-out" if p["held_out"] else "calibrated"
            print(f"  W={p['workers']} {p['topology']:<4} "
                  f"measured={p['measured_tokens_per_sec']:9.1f} "
                  f"predicted={p['predicted_tokens_per_sec']:9.1f} "
                  f"err={p['error_pct']:4.1f}%  ({tag})")
        print(f"held-out max err {out['max_held_out_error_pct']:.1f}% "
              f"(band {out['band_pct']:.0f}%)  crossover: predicted "
              f"W={out['predicted_crossover_workers']} measured "
              f"W={out['measured_crossover_workers']}")
    ok = out["within_band"] and out["crossover_reproduced"]
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


def _cmd_report(args: argparse.Namespace) -> int:
    from distkeras_tpu_torch.sim.model import TimingModel

    model = TimingModel.from_dir(args.trace_dir)
    desc = model.describe()
    if args.json:
        print(json.dumps(desc, indent=2, sort_keys=True))
        return 0
    print(f"timing model: {desc['commits']} commit path(s)")
    rows = dict(desc["segments"])
    if "work" in desc:
        rows["work"] = desc["work"]
    for name, d in rows.items():
        fit = (f"lognorm(mu={d['lognorm_mu']:.3f}, "
               f"sigma={d['lognorm_sigma']:.3f})" if d["fit_ok"]
               else "mean replay (too few samples)")
        print(f"  {name:<10} n={d['count']:<6} "
              f"mean={d['mean_s'] * 1e3:8.3f}ms "
              f"p99={d['p99_s'] * 1e3:8.3f}ms  {fit}")
    for w in desc["warnings"]:
        print(f"  WARNING: {w}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distkeras_tpu_torch.sim",
        description="trace-calibrated fleet simulator")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run one what-if scenario")
    runp.add_argument("scenario", choices=sorted(SCENARIOS))
    runp.add_argument("--seed", type=int, default=None)
    runp.add_argument("--workers", type=int, default=None)
    runp.add_argument("--json", action="store_true")

    calp = sub.add_parser("calibrate",
                          help="bench hier_curve replay gate")
    calp.add_argument("--summary", default=None,
                      help="BENCH_SUMMARY.json path (default: repo root)")
    calp.add_argument("--band", type=float, default=None,
                      help="tolerance pct (default DKTPU_SIM_BAND_PCT)")
    calp.add_argument("--seed", type=int, default=None)
    calp.add_argument("--tree-live", default=None, metavar="PATH",
                      help="recorded live-tree run (JSON dict): run the "
                           "tree_parity gate instead of the hier replay")
    calp.add_argument("--json", action="store_true")

    repp = sub.add_parser("report", help="fitted timing model from traces")
    repp.add_argument("--trace-dir", required=True)
    repp.add_argument("--json", action="store_true")

    args = ap.parse_args(argv)
    if args.cmd == "run":
        return _cmd_run(args)
    if args.cmd == "calibrate":
        return _cmd_calibrate(args)
    return _cmd_report(args)


if __name__ == "__main__":
    sys.exit(main())
