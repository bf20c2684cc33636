"""The port's health plane (``telemetry/health/``) held to the JAX
package's case for case: every case below runs once against each package
with the same inputs and the same expectations (target parsing and the
in-process registry, SLO spec parsing and burn-rate math, the
multi-window rule over doctored hub rings, ``AlertManager`` hysteresis and
its page dump, the sentinels), the two packages' outputs are compared
where they are data (``SloEngine.evaluate``, the parsed specs), and a
``MetricsHub`` of either package scrapes a port parameter server and a
JAX one alike. The CLIs (``health``, ``top``, ``scrape``) run against a
port server; process vitals sample without initializing CUDA."""

import json
import socket
import time
import types
from collections import deque

import numpy as np
import pytest

import distkeras_tpu.telemetry as jax_telemetry
import distkeras_tpu.telemetry.health as jax_health
from distkeras_tpu.netps import PSClient as JaxPSClient
from distkeras_tpu.netps import PSServer as JaxPSServer
from distkeras_tpu.telemetry.health import hub as jax_hub_mod
from distkeras_tpu.telemetry.report import main as jax_report_main
from distkeras_tpu.telemetry.tracing import context as jax_trace_context
from distkeras_tpu.telemetry.tracing import recorder as jax_recorder
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import PSClient, PSServer
from distkeras_tpu_torch.telemetry import health, vitals
from distkeras_tpu_torch.telemetry.core import BUCKET_BOUNDS
from distkeras_tpu_torch.telemetry.health import hub as hub_mod
from distkeras_tpu_torch.telemetry.report import main as report_main
from distkeras_tpu_torch.telemetry.tracing import context as trace_context
from distkeras_tpu_torch.telemetry.tracing import recorder

PKGS = {
    "torch": types.SimpleNamespace(
        telemetry=telemetry, health=health, hub_mod=hub_mod,
        recorder=recorder, trace_context=trace_context,
        report_main=report_main),
    "jax": types.SimpleNamespace(
        telemetry=jax_telemetry, health=jax_health, hub_mod=jax_hub_mod,
        recorder=jax_recorder, trace_context=jax_trace_context,
        report_main=jax_report_main),
}


def _reset_all():
    for p in PKGS.values():
        p.telemetry.reset()
        with p.hub_mod._registry_lock:
            p.hub_mod._registry.clear()
        p.trace_context._reset_stream()
        p.recorder._reset()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("DKTPU_HEALTH_TARGETS", "DKTPU_HEALTH_SLO",
                "DKTPU_TRACE", "DKTPU_TRACE_DIR", "DKTPU_VITALS_S"):
        monkeypatch.delenv(var, raising=False)
    _reset_all()
    yield
    _reset_all()


@pytest.fixture(params=sorted(PKGS))
def P(request):
    """The package under test: each case runs against both."""
    return PKGS[request.param]


def _events(P, kind):
    return [e for e in P.telemetry.get().events() if e.get("kind") == kind]


def _bare_hub(P, **kw):
    kw.setdefault("targets", {})
    kw.setdefault("use_registry", False)
    return P.health.MetricsHub(**kw)


def _inject(P, hub, name="t0", role=None):
    t = P.health.TargetState(name=name, endpoint="127.0.0.1:1", role=role,
                             ever_up=True)
    hub._targets[name] = t
    return t


def _sentinels(P, tmp_path, **kw):
    kw.setdefault("bench_summary", str(tmp_path / "no-summary.json"))
    kw.setdefault("bench_pin", str(tmp_path / "no-pin.json"))
    return P.health.Sentinels(**kw)


def _port_ps(**kw):
    kw.setdefault("discipline", "adag")
    return PSServer(host="127.0.0.1", port=0, device="cpu", **kw).start()


def _jax_ps(**kw):
    kw.setdefault("discipline", "adag")
    return JaxPSServer(host="127.0.0.1", port=0, **kw).start()


# ---------------------------------------------------------------------------
# Targets, SLO specs, burn math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "ps=10.0.0.1:7077; serve0=10.0.0.2:9000 ,10.0.0.3:9001;;",
    "", "a=h:1,a=h:2", "h:5"])
def test_parse_targets_matches_the_reference(spec):
    assert health.parse_targets(spec) == jax_health.parse_targets(spec)


def test_registry_register_update_unregister(P):
    assert P.health.register_target("h:1", "a") == "a"
    assert P.health.register_target("h:2") == "h:2"
    P.health.register_target("h:9", "a")
    assert P.health.registered_targets() == {"a": "h:9", "h:2": "h:2"}
    P.health.unregister_target("a")
    P.health.unregister_target("h:2")
    assert P.health.registered_targets() == {}


def test_env_targets_feed_the_hub(P, monkeypatch):
    monkeypatch.setenv("DKTPU_HEALTH_TARGETS", "adhoc=127.0.0.1:1")
    hub = P.health.MetricsHub(targets={"static": "127.0.0.1:2"})
    P.health.register_target("127.0.0.1:3", "registered")
    assert hub._known_targets() == {
        "adhoc": "127.0.0.1:1", "static": "127.0.0.1:2",
        "registered": "127.0.0.1:3"}
    hermetic = P.health.MetricsHub(targets={"static": "127.0.0.1:2"},
                                   use_registry=False)
    assert hermetic._known_targets() == {"static": "127.0.0.1:2"}


_SLO_SOURCES = [
    '[{"name": "p99", "metric": "serving.latency", "stat": "p99", '
    '"max": 0.25, "severity": "page", "labels": {"tenant": "B"}}]',
    '{"name": "x", "metric": "m", "min": 1}',
    '[{"name": "a", "metric": "m", "stat": "rate", "min": 2.0, '
    '"fast_s": 10, "slow_s": 100, "target": "ps"}, '
    '{"name": "b", "metric": "n", "max": 3}]',
]


@pytest.mark.parametrize("source", _SLO_SOURCES)
def test_slo_specs_parse_as_the_reference(source, tmp_path):
    path = tmp_path / "slo.json"
    path.write_text(source)
    for src in (source, str(path)):
        port = [vars(s) for s in health.parse_slo_specs(src)]
        ref = [vars(s) for s in jax_health.parse_slo_specs(src)]
        assert port == ref


@pytest.mark.parametrize("source,match", [
    ('{"name": "x", "metric": "m", "max": 1, "min": 1}',
     "exactly one of max/min"),
    ('{"name": "x", "metric": "m"}', "exactly one of max/min"),
    ('{"name": "x", "metric": "m", "max": 1, "severity": "loud"}',
     "severity"),
    ('{"name": "x", "metric": "m", "max": 1, "fast_s": 60, "slow_s": 30}',
     "fast_s"),
    ('{"name": "x", "metric": "m", "max": 1, "oops": 2}', "unknown keys"),
    ('{"metric": "m", "max": 1}', "name\\+metric"),
])
def test_slo_parse_rejections(P, source, match):
    with pytest.raises(ValueError, match=match):
        P.health.parse_slo_specs(source)


def test_slo_parse_default_source_and_missing_file(P, tmp_path, monkeypatch):
    assert P.health.parse_slo_specs() == []
    monkeypatch.setenv("DKTPU_HEALTH_SLO", _SLO_SOURCES[1])
    assert P.health.parse_slo_specs()[0].name == "x"
    with pytest.raises(ValueError, match="not found"):
        P.health.parse_slo_specs(str(tmp_path / "missing.json"))


def test_burn_rate_math_and_zero_guards(P):
    cap = P.health.SloSpec(name="c", metric="m", max=2.0)
    assert cap.burn(None) is None
    assert cap.burn(1.0) == pytest.approx(0.5)
    assert cap.burn(4.0) == pytest.approx(2.0)
    degenerate = P.health.SloSpec(name="d", metric="m", max=0.0)
    assert degenerate.burn(0.0) == 0.0
    assert degenerate.burn(0.1) == float("inf")
    floor = P.health.SloSpec(name="f", metric="m", min=10.0)
    assert floor.burn(20.0) == pytest.approx(0.5)
    assert floor.burn(5.0) == pytest.approx(2.0)
    assert floor.burn(0.0) == float("inf")


# ---------------------------------------------------------------------------
# Doctored-ring hub math: the multi-window rule, spans, rates
# ---------------------------------------------------------------------------

def _stale_ring(P, hub, now, spike_points):
    t = _inject(P, hub)
    ring = t.gauges["stale"] = deque(maxlen=64)
    for i in range(10):
        ring.append((now - 250 + i * 20, 0.2))
    for dt in (10.0, 5.0):
        ring.append((now - dt, 5.0))
    for i in range(spike_points):
        ring.append((now - 2 - i * 0.1, 5.0))


def test_multiwindow_rule_fast_breach_needs_slow_confirmation(P):
    now = time.time()
    spec = P.health.SloSpec(name="stale", metric="stale", stat="mean",
                            max=1.0, fast_s=30.0, slow_s=300.0)
    engine = P.health.SloEngine([spec], alerts=P.health.AlertManager())
    hub = _bare_hub(P)
    _stale_ring(P, hub, now, 0)
    out = engine.evaluate(hub)["stale"]
    assert out["burn_fast"] > 1.0 and out["burn_slow"] <= 1.0
    assert not out["breaching"] and not engine.alerts.active()
    hub = _bare_hub(P)
    _stale_ring(P, hub, now, 10)
    out = engine.evaluate(hub)["stale"]
    assert out["burn_fast"] > 1.0 and out["burn_slow"] > 1.0
    assert out["breaching"] and engine.alerts.is_active("slo:stale")
    assert engine.attainment()["stale"] == 0.0


@pytest.mark.parametrize("spike_points", [0, 3, 10])
def test_slo_engine_evaluates_as_the_reference(spike_points):
    """The same doctored ring through both packages' engines: the same
    measures, burns and verdicts, number for number."""
    now = time.time()
    outs = {}
    for name, P in PKGS.items():
        spec = P.health.SloSpec(name="stale", metric="stale", stat="mean",
                                max=1.0, fast_s=30.0, slow_s=300.0)
        engine = P.health.SloEngine([spec], alerts=P.health.AlertManager())
        hub = _bare_hub(P, clock=lambda: now)
        _stale_ring(P, hub, now, spike_points)
        outs[name] = (engine.evaluate(hub), engine.attainment())
    assert outs["torch"] == outs["jax"]


def test_measure_stats_globs_roles_and_absence(P):
    hub = _bare_hub(P)
    a = _inject(P, hub, "serveA", role="serving")
    b = _inject(P, hub, "serveB", role="serving")
    now = time.time()
    for t, v in ((a, 2.0), (b, 4.0)):
        t.gauges["serving.queue_depth"] = deque([(now - 1, v)])
    assert hub.measure("serving.queue_depth",
                       stat="mean") == pytest.approx(3.0)
    assert hub.measure("serving.queue_depth",
                       stat="max") == pytest.approx(4.0)
    assert hub.measure("serving.*", stat="value",
                       target="serveB") == pytest.approx(4.0)
    assert hub.measure("serving.*", stat="value",
                       target="serving") == pytest.approx(3.0)
    assert hub.measure("serving.queue_depth", stat="value",
                       target="nomatch") is None
    assert hub.measure("absent.metric") is None
    assert "serving.queue_depth" in hub.metric_names()["gauges"]


def test_span_window_quantile_is_windowed_not_since_boot(P):
    hub = _bare_hub(P)
    t = _inject(P, hub)
    now = time.time()
    lo_i, hi_i = 2, 10
    base = [0] * (len(BUCKET_BOUNDS) + 1)
    base[lo_i] = 100
    head = list(base)
    head[hi_i] = 10
    t.spans["serving.latency"] = deque([
        (now - 100, 100, 10.0, tuple(base)),
        (now - 5, 110, 12.0, tuple(head)),
    ])
    assert hub.measure("serving.latency", stat="p99",
                       window_s=30) == pytest.approx(BUCKET_BOUNDS[hi_i])
    assert hub.measure("serving.latency", stat="p50",
                       window_s=300) == pytest.approx(BUCKET_BOUNDS[lo_i])
    assert hub.measure("serving.latency", stat="span_mean",
                       window_s=30) == pytest.approx(0.2)


def test_rate_points_are_reset_safe(P):
    hub = _bare_hub(P)
    t = _inject(P, hub)
    t0 = time.time()
    hub._rate_point(t, "c", t0, 10.0)
    hub._rate_point(t, "c", t0 + 1.0, 20.0)
    hub._rate_point(t, "c", t0 + 2.0, 5.0)
    hub._rate_point(t, "c", t0 + 3.0, 8.0)
    rates = [v for _, v in t.rates["c"]]
    assert rates == [pytest.approx(10.0), pytest.approx(3.0)]


# ---------------------------------------------------------------------------
# AlertManager and the sentinels
# ---------------------------------------------------------------------------

def test_alert_fire_and_clear_hysteresis(P):
    am = P.health.AlertManager(clear_after=2)
    assert am.update("k", True, message="hot",
                     labels={"tenant": "A"}) == "fired"
    assert am.update("k", True) is None
    assert am.is_active("k")
    assert am.update("k", False) is None
    assert am.is_active("k")
    assert am.update("k", False) == "cleared"
    assert not am.is_active("k")
    assert am.update("k", False) is None
    assert (am.fired_total, am.cleared_total) == (1, 1)
    (fired,) = _events(P, "health_alert")
    assert fired["alert"] == "k" and fired["tenant"] == "A"
    (cleared,) = _events(P, "health_clear")
    assert cleared["alert"] == "k"
    snap = P.telemetry.get().snapshot()["counters"]
    assert snap["health.alerts_fired"] == 1
    assert snap["health.alerts_cleared"] == 1
    am.update("j", True)
    am.update("j", False)
    am.update("j", True)
    assert am.update("j", False) is None
    assert am.is_active("j")


def test_alert_sequences_match_the_reference():
    """One breach sequence through both packages' managers: the same
    transitions, totals and event payloads (timestamps aside)."""
    seq = [True, True, False, True, False, False, False, True, False]
    got = {}
    for name, P in PKGS.items():
        am = P.health.AlertManager(clear_after=2)
        steps = [am.update("k", b, severity="ticket", message="m",
                           labels={"t": "x"}) for b in seq]
        events = [{k: v for k, v in e.items() if k != "ts"}
                  for e in P.telemetry.get().events()]
        got[name] = (steps, am.fired_total, am.cleared_total, events)
    assert got["torch"] == got["jax"]


def test_page_alert_drops_a_flight_dump(P, tmp_path, monkeypatch):
    monkeypatch.setenv("DKTPU_TRACE", "1")
    monkeypatch.setenv("DKTPU_TRACE_DIR", str(tmp_path))
    am = P.health.AlertManager()
    am.update("tick", True, severity="ticket")
    assert list(tmp_path.glob("flight-*")) == []
    am.update("slo:p99", True, severity="page")
    (dump,) = list(tmp_path.glob("flight-*"))
    recs = [json.loads(line) for line in open(dump)]
    assert any(r.get("reason") == "health:slo:p99" for r in recs)
    assert any(r.get("kind") == "health_alert" for r in recs)


def test_drift_sentinel_fires_on_staleness_creep(P, tmp_path):
    hub = _bare_hub(P)
    t = _inject(P, hub)
    now = time.time()
    ring = t.gauges["netps.staleness_mean"] = deque(maxlen=64)
    for i in range(10):
        ring.append((now - 280 + i * 25, 1.5))
    sn = _sentinels(P, tmp_path, alerts=P.health.AlertManager(clear_after=1))
    sn.evaluate(hub)
    assert not sn.alerts.is_active("staleness_creep")
    for i in range(5):
        ring.append((now - 10 + i * 2, 9.0))
    sn.evaluate(hub)
    assert sn.alerts.is_active("staleness_creep")


def test_shed_spike_fires_against_a_calm_baseline(P, tmp_path):
    hub = _bare_hub(P)
    t = _inject(P, hub)
    now = time.time()
    ring = t.rates["serving.shed"] = deque(maxlen=64)
    for i in range(6):
        ring.append((now - 280 + i * 40, 0.0))
    sn = _sentinels(P, tmp_path, alerts=P.health.AlertManager(clear_after=1))
    sn.evaluate(hub)
    assert not sn.alerts.is_active("shed_spike")
    ring.append((now - 1, 2.0))
    sn.evaluate(hub)
    assert sn.alerts.is_active("shed_spike")


def test_bench_regression_sentinel_vs_doctored_summary(P, tmp_path):
    summary = tmp_path / "BENCH_SUMMARY.json"
    summary.write_text(json.dumps({"configs": [
        {"metric": "tok_per_sec", "value": 70.0, "pin": 100.0,
         "within_band": False, "vs_baseline": 0.7},
        {"metric": "fine", "value": 99.0, "pin": 100.0,
         "within_band": True},
    ]}))
    hub = _bare_hub(P)
    sn = _sentinels(P, tmp_path, alerts=P.health.AlertManager(clear_after=1),
                    bench_summary=str(summary))
    sn.evaluate(hub)
    assert sn.alerts.is_active("bench_regression:tok_per_sec")
    assert not sn.alerts.is_active("bench_regression:fine")
    summary.write_text(json.dumps({"configs": [
        {"metric": "tok_per_sec", "value": 99.0, "pin": 100.0,
         "within_band": True}]}))
    sn.evaluate(hub)
    assert not sn.alerts.is_active("bench_regression:tok_per_sec")


def test_bench_regression_sentinel_vs_live_pins(P, tmp_path):
    pin = tmp_path / "BENCH_PIN.json"
    pin.write_text(json.dumps({"weather_band_pct": 10,
                               "configs": {"tp": {"pin": 100.0}}}))
    hub = _bare_hub(P)
    t = _inject(P, hub)
    t.gauges["bench.tp"] = deque([(time.time() - 1, 80.0)])
    sn = _sentinels(P, tmp_path, alerts=P.health.AlertManager(clear_after=1),
                    bench_pin=str(pin))
    sn.evaluate(hub)
    assert sn.alerts.is_active("bench_regression:live:tp")
    t.gauges["bench.tp"].append((time.time(), 95.0))
    sn.evaluate(hub)
    assert not sn.alerts.is_active("bench_regression:live:tp")


# ---------------------------------------------------------------------------
# A live hub against a port PS and a JAX PS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("server", ["port", "jax"])
def test_hub_scrapes_a_ps_gauges_rates_and_clock(P, server):
    srv = _port_ps() if server == "port" else _jax_ps()
    client = (PSClient if server == "port" else JaxPSClient)(
        srv.endpoint, worker_id=0)
    hub = _bare_hub(P, targets={"ps": srv.endpoint}, interval=30)
    sweeps = []
    hub.on_sweep(lambda h: sweeps.append(h.sweeps))
    try:
        tmpl = [np.zeros((2,), np.float32)]
        client.join(init=tmpl)
        assert hub.scrape_once() == 1
        for _ in range(3):
            client.commit([np.ones_like(a) for a in tmpl], 0)
        time.sleep(0.05)
        assert hub.scrape_once() == 1
        client.leave()
    finally:
        srv.close()
        hub.close()
    assert sweeps == [1, 2]
    t = hub.target("ps")
    assert t.status() == "UP" and t.ready is True and t.ever_up
    assert t.clock_offset_s is not None and abs(t.clock_offset_s) < 5.0
    assert hub.measure("stats.commits_total", stat="value") == 3.0
    assert hub.measure("stats.commits_total", stat="rate",
                       window_s=60) > 0.0
    assert not hub.is_down("ps")


def test_target_down_fires_for_a_silent_port_ps_and_clears(P, tmp_path):
    srv = _port_ps()
    hub = _bare_hub(P, targets={"ps": srv.endpoint}, down_after=2,
                    timeout=0.5, interval=30)
    sn = _sentinels(P, tmp_path, alerts=P.health.AlertManager(clear_after=1))
    try:
        hub.scrape_once()
        sn.evaluate(hub)
        assert not sn.alerts.active()
        srv.close()
        hub.scrape_once()
        sn.evaluate(hub)
        assert not hub.is_down("ps")
        hub.scrape_once()
        sn.evaluate(hub)
        assert hub.is_down("ps") and hub.target("ps").status() == "DOWN"
        alert = sn.alerts.active()["target_down:ps"]
        assert alert.severity == "page" and alert.labels == {"target": "ps"}
        srv = _port_ps()
        hub.add_target(srv.endpoint, "ps")
        hub.scrape_once()
        sn.evaluate(hub)
        assert not sn.alerts.active() and not hub.is_down("ps")
        (cleared,) = _events(P, "health_clear")
        assert cleared["alert"] == "target_down:ps"
    finally:
        srv.close()
        hub.close()


def test_port_standby_is_scraped_as_not_ready(P, tmp_path):
    from distkeras_tpu_torch.netps import StandbyServer

    srv = _port_ps(state_dir=str(tmp_path / "state"))
    stb = StandbyServer(srv.endpoint, promote_after=30.0, host="127.0.0.1",
                        port=0, device="cpu",
                        state_dir=str(tmp_path / "sb")).start()
    hub = _bare_hub(P, targets={"primary": srv.endpoint,
                                "standby": stb.endpoint}, interval=30)
    client = PSClient(srv.endpoint, worker_id=0)
    try:
        client.join(init=[np.zeros((2,), np.float32)])
        assert hub.scrape_once() == 2
        assert hub.target("primary").ready is True
        assert hub.target("standby").ready is False
        assert hub.target("standby").status() == "NOT-READY"
        assert not hub.is_down("standby")
    finally:
        client.close()
        stb.close()
        srv.close()
        hub.close()


def test_hubs_of_both_packages_read_a_port_ps_alike():
    """One port PS, one sweep from each package's hub at the same state:
    the same targets, statuses and metric tables."""
    srv = _port_ps()
    client = PSClient(srv.endpoint, worker_id=0)
    hubs = {n: _bare_hub(P, targets={"ps": srv.endpoint}, interval=30)
            for n, P in PKGS.items()}
    try:
        client.join(init=[np.zeros((3,), np.float32)])
        client.commit([np.ones((3,), np.float32)], 0)
        for _sweep in range(2):  # the second sees the first's stats spans
            for hub in hubs.values():
                assert hub.scrape_once() == 1
    finally:
        client.close()
        srv.close()
    views = {}
    for n, hub in hubs.items():
        t = hub.target("ps")
        views[n] = (t.status(), t.ready, t.role, hub.metric_names(),
                    hub.measure("stats.commits_total"),
                    hub.measure("netps.commits"))
        hub.close()
    assert views["torch"] == views["jax"]
    assert views["torch"][2] == "proc"


# ---------------------------------------------------------------------------
# CLIs against a port PS
# ---------------------------------------------------------------------------

def test_health_cli_one_shot_text_json_and_exit_codes(
        tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    srv = _port_ps()
    try:
        rc = report_main(["health", "--targets", f"ps={srv.endpoint}",
                          "--samples", "2", "--gap", "0.05"])
        text = capsys.readouterr().out
        assert rc == 0
        assert "fleet health: 1/1 targets up" in text
        rc = report_main(["health", "--targets", f"ps={srv.endpoint}",
                          "--samples", "1", "--json"])
        snap = json.loads(capsys.readouterr().out)
        assert rc == 0
        (target,) = snap["targets"]
        assert target["name"] == "ps" and target["status"] == "UP"
        assert target["ready"] is True
        slo = json.dumps({"name": "commits", "metric": "stats.commits_total",
                          "stat": "value", "min": 1e9,
                          "labels": {"tenant": "acme"}})
        rc = report_main(["health", "--targets", f"ps={srv.endpoint}",
                          "--samples", "2", "--gap", "0.05",
                          "--slo", slo, "--json"])
        snap = json.loads(capsys.readouterr().out)
        assert rc == 1
        (alert,) = snap["alerts"]
        assert alert["key"] == "slo:commits" and alert["tenant"] == "acme"
        assert snap["slos"]["commits"]["attainment"] == 0.0
    finally:
        srv.close()


def test_top_cli_bounded_iterations(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    srv = _port_ps()
    try:
        rc = report_main(["top", "--targets", f"ps={srv.endpoint}",
                          "--interval", "0.05", "--iterations", "2",
                          "--no-clear"])
    finally:
        srv.close()
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("fleet health:") == 2
    assert "\x1b[2J" not in out


def test_scrape_cli_json_is_one_line(capsys):
    srv = _port_ps()
    client = PSClient(srv.endpoint, worker_id=0)
    try:
        client.join(init=[np.zeros((2,), np.float32)])
        assert report_main(["scrape", srv.endpoint, "--json"]) == 0
    finally:
        client.close()
        srv.close()
    out = capsys.readouterr().out
    assert out.count("\n") == 1
    rep = json.loads(out)
    assert rep["ok"] is True and rep["fold_backend"] == "torch-cpu"


def test_scrape_cli_typed_connection_refused(capsys):
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    rc = report_main(["scrape", f"127.0.0.1:{port}"])
    captured = capsys.readouterr()
    assert rc == 2 and captured.out == ""
    assert captured.err.count("\n") == 1
    assert captured.err.startswith(
        f"scrape error: connection_refused: 127.0.0.1:{port}")


def test_scrape_cli_typed_timeout(capsys):
    silent = socket.socket()
    silent.bind(("127.0.0.1", 0))
    silent.listen(1)
    port = silent.getsockname()[1]
    try:
        rc = report_main(["scrape", f"127.0.0.1:{port}",
                          "--timeout", "0.2"])
    finally:
        silent.close()
    captured = capsys.readouterr()
    assert rc == 2
    assert captured.err.startswith(
        f"scrape error: timeout: 127.0.0.1:{port}")


# ---------------------------------------------------------------------------
# Process vitals
# ---------------------------------------------------------------------------

def test_vitals_sample_and_lifecycle(monkeypatch):
    out = vitals.sample_vitals()
    assert out["runtime.rss_mb"] > 1.0
    assert out["runtime.open_fds"] >= 3
    gauges = telemetry.get().snapshot()["gauges"]
    assert gauges["runtime.rss_mb"]["value"] == out["runtime.rss_mb"]
    assert vitals.start_vitals(0) is False
    assert vitals.start_vitals() is False
    monkeypatch.setattr(telemetry, "enabled", lambda: False)
    assert vitals.start_vitals(0.01) is False
    monkeypatch.undo()
    try:
        assert vitals.start_vitals(0.01) is True
        assert vitals.start_vitals(0.01) is True
    finally:
        vitals.stop_vitals()
    vitals.stop_vitals()


def test_vitals_on_the_cpu_never_initialize_cuda():
    """No device gauge without the card, and sampling never starts CUDA:
    ``torch.cuda.is_initialized()`` stays False and no CPU number is
    reported as ``device.bytes_in_use``."""
    import torch

    assert not torch.cuda.is_initialized()
    for _ in range(3):
        out = vitals.sample_vitals()
    assert "device.bytes_in_use" not in out
    assert "device.bytes_in_use" not in telemetry.get().snapshot()["gauges"]
    assert not torch.cuda.is_initialized()


def test_vitals_read_the_card_only_once_cuda_is_initialized(monkeypatch):
    import sys

    import torch

    calls = []
    fake_cuda = types.SimpleNamespace(
        is_initialized=lambda: True,
        memory_allocated=lambda: calls.append(1) or 4096)
    monkeypatch.setattr(torch, "cuda", fake_cuda)
    assert vitals.sample_vitals()["device.bytes_in_use"] == 4096.0
    assert calls == [1]
    monkeypatch.delitem(sys.modules, "torch")
    assert "device.bytes_in_use" not in vitals.sample_vitals()
