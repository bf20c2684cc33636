"""The operator CLIs over the health plane.

``python -m distkeras_tpu_torch.telemetry health`` — one-shot fleet summary:
scrape every target a couple of times (rates and burn windows need two
points), evaluate the SLO engine + sentinels, and render per-target
liveness/readiness, active alerts, and per-spec SLO attainment.
``--json`` emits the same structure for scripts.

``python -m distkeras_tpu_torch.telemetry top`` — the same summary, live: a
refreshing terminal view driven by the hub's scrape loop until ^C.

Both take their targets from ``--targets``, the in-process registry,
and ``DKTPU_HEALTH_TARGETS``; SLO specs from ``--slo`` (inline JSON or
a file path) or ``DKTPU_HEALTH_SLO``.
"""

from __future__ import annotations

import io
import json
import time
from typing import Optional

from distkeras_tpu_torch.telemetry.health.hub import MetricsHub, parse_targets
from distkeras_tpu_torch.telemetry.health.sentinels import Sentinels
from distkeras_tpu_torch.telemetry.health.slo import (
    AlertManager,
    SloEngine,
    parse_slo_specs,
)


def build_health_plane(targets: Optional[str] = None,
                       slo: Optional[str] = None,
                       interval: Optional[float] = None,
                       timeout: float = 1.0):
    """(hub, engine, sentinels) wired to one shared AlertManager."""
    hub = MetricsHub(targets=parse_targets(targets) if targets else None,
                     interval=interval, timeout=timeout)
    alerts = AlertManager()
    engine = SloEngine(parse_slo_specs(slo), alerts=alerts)
    sentinels = Sentinels(alerts=alerts)
    hub.on_sweep(engine.evaluate)
    hub.on_sweep(sentinels.evaluate)
    return hub, engine, sentinels


def health_snapshot(hub: MetricsHub, engine: SloEngine,
                    sentinels: Sentinels) -> dict:
    """The structured summary both CLIs render (and ``--json`` emits)."""
    sentinels.evaluate(hub)
    slos = engine.evaluate(hub)
    attainment = engine.attainment()
    alerts = engine.alerts.active()
    return {
        "sweeps": hub.sweeps,
        "targets": [
            {"name": t.name, "endpoint": t.endpoint, "role": t.role,
             "status": t.status(), "ready": t.ready,
             "misses": t.misses,
             "clock_offset_ms": (None if t.clock_offset_s is None
                                 else round(t.clock_offset_s * 1e3, 3)),
             "last_error": t.last_error}
            for t in sorted(hub.targets(), key=lambda t: t.name)],
        "alerts": [
            {"key": a.key, "severity": a.severity, "message": a.message,
             "value": a.value, **a.labels}
            for a in sorted(alerts.values(), key=lambda a: a.key)],
        "slos": {
            name: {**slos.get(name, {}),
                   "attainment": attainment.get(name)}
            for name in set(slos) | set(attainment)},
        "alerts_fired_total": engine.alerts.fired_total,
        "alerts_cleared_total": engine.alerts.cleared_total,
    }


def render_health(snap: dict) -> str:
    out = io.StringIO()
    w = out.write
    targets = snap["targets"]
    up = sum(1 for t in targets if t["status"] == "UP")
    w(f"== fleet health: {up}/{len(targets)} targets up, "
      f"{len(snap['alerts'])} active alert(s) "
      f"(fired {snap['alerts_fired_total']}, "
      f"cleared {snap['alerts_cleared_total']}) ==\n")
    if targets:
        w(f"{'target':<24} {'endpoint':<22} {'role':<10} {'status':<10} "
          f"{'ready':<6} {'clock ms':>9}\n")
        for t in targets:
            ready = ("-" if t["ready"] is None
                     else ("yes" if t["ready"] else "NO"))
            off = ("-" if t["clock_offset_ms"] is None
                   else f"{t['clock_offset_ms']:+.2f}")
            w(f"{t['name']:<24} {t['endpoint']:<22} "
              f"{(t['role'] or '-'):<10} {t['status']:<10} {ready:<6} "
              f"{off:>9}\n")
            if t["last_error"] and t["status"] != "UP":
                w(f"{'':<24}   {t['last_error']}\n")
    else:
        w("no targets (register some, pass --targets, or set "
          "DKTPU_HEALTH_TARGETS)\n")
    w("\n-- active alerts --\n")
    if snap["alerts"]:
        for a in snap["alerts"]:
            labels = {k: v for k, v in a.items()
                      if k not in ("key", "severity", "message", "value")}
            suffix = (" " + " ".join(f"{k}={v}"
                                     for k, v in sorted(labels.items()))
                      if labels else "")
            w(f"[{a['severity']:<6}] {a['key']}: {a['message']}{suffix}\n")
    else:
        w("none\n")
    if snap["slos"]:
        w("\n-- SLO attainment --\n")
        w(f"{'slo':<24} {'attain':>7} {'burn fast':>10} {'burn slow':>10}\n")
        for name in sorted(snap["slos"]):
            s = snap["slos"][name]
            att = s.get("attainment")
            bf, bs = s.get("burn_fast"), s.get("burn_slow")
            w(f"{name:<24} "
              f"{('-' if att is None else f'{att:.1%}'):>7} "
              f"{('-' if bf is None else f'{bf:.2f}'):>10} "
              f"{('-' if bs is None else f'{bs:.2f}'):>10}\n")
    return out.getvalue()


def cmd_health(args) -> int:
    hub, engine, sentinels = build_health_plane(
        targets=args.targets, slo=args.slo, timeout=args.timeout)
    # The engine/sentinels run on the on_sweep hook; burn windows and
    # rates need at least two points per target, hence samples >= 2.
    for i in range(max(1, args.samples)):
        if i:
            time.sleep(args.gap)
        hub.scrape_once()
    snap = health_snapshot(hub, engine, sentinels)
    if args.json:
        print(json.dumps(snap, default=str))
    else:
        print(render_health(snap), end="")
    return 0 if not snap["alerts"] else 1


def cmd_top(args) -> int:
    hub, engine, sentinels = build_health_plane(
        targets=args.targets, slo=args.slo, interval=args.interval,
        timeout=args.timeout)
    hub.start()
    try:
        n = 0
        while args.iterations <= 0 or n < args.iterations:
            n += 1
            time.sleep(hub.interval)
            snap = health_snapshot(hub, engine, sentinels)
            body = render_health(snap)
            if args.no_clear:
                print(body, end="", flush=True)
            else:
                print("\x1b[2J\x1b[H" + body, end="", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        hub.close()
    return 0


def add_subcommands(sub) -> None:
    """Install ``health`` and ``top`` on the telemetry CLI's subparsers."""

    def common(p):
        p.add_argument("--targets", default=None,
                       help="scrape targets: `[name=]host:port` entries, "
                            "`;`-separated (default: the in-process "
                            "registry + DKTPU_HEALTH_TARGETS)")
        p.add_argument("--slo", default=None,
                       help="SLO specs: inline JSON or a file path "
                            "(default: DKTPU_HEALTH_SLO)")
        p.add_argument("--timeout", type=float, default=1.0,
                       help="per-target scrape timeout (default 1.0s)")

    h = sub.add_parser(
        "health", help="one-shot fleet health summary (per-target "
                       "liveness/readiness, active alerts, SLO "
                       "attainment); exit 1 when alerts are active")
    common(h)
    h.add_argument("--samples", type=int, default=2,
                   help="scrape sweeps before reporting (rates need two; "
                        "default 2)")
    h.add_argument("--gap", type=float, default=0.5,
                   help="seconds between sweeps (default 0.5)")
    h.add_argument("--json", action="store_true",
                   help="emit the structured summary as JSON")
    t = sub.add_parser(
        "top", help="live refreshing fleet health view (^C to exit)")
    common(t)
    t.add_argument("--interval", type=float, default=None,
                   help="refresh/scrape interval "
                        "(default DKTPU_HEALTH_INTERVAL)")
    t.add_argument("--iterations", type=int, default=0,
                   help="refresh this many times then exit (0 = forever; "
                        "tests)")
    t.add_argument("--no-clear", action="store_true",
                   help="append frames instead of clearing the screen "
                        "(non-ANSI terminals, logs)")
