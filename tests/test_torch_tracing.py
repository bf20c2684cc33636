"""The port's distributed tracing (``telemetry/tracing/``) and its call
sites on the wire, held to the JAX package's: the context, clock,
recorder, collector and critical-path analysis case for case (the same
records through both packages' ``trace_report``/``render_trace_report``
give equal dicts and equal text); a port client against a JAX server and
a JAX client against a port server, traced, over TCP and shm, give every
commit a complete trace, and the trace directory each pairing writes
reports the same in both packages; tracing off adds no header key; a
traced and an untraced one-worker ``DynSGD(remote=...)`` fold bit-equal
centers; the stats op answers the role and the ring; the standby's
replicate span, striped and sharded fan-outs, served requests and fault
dumps all land where the reference puts them."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from distkeras_tpu import telemetry as jax_telemetry
from distkeras_tpu.netps import PSClient as JaxPSClient
from distkeras_tpu.netps import PSServer as JaxPSServer
from distkeras_tpu.serving import ServeClient as JaxServeClient
from distkeras_tpu.telemetry import tracing as jax_tracing
from distkeras_tpu.telemetry.report import scrape_stats as jax_scrape_stats
from distkeras_tpu.telemetry.tracing import clock as jax_clock
from distkeras_tpu.telemetry.tracing import context as jax_context
from distkeras_tpu.telemetry.tracing import recorder as jax_recorder
from distkeras_tpu_torch import DataFrame, imdb_lstm
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.netps import PSClient, PSServer, StandbyServer, wire
from distkeras_tpu_torch.resilience.faults import FaultPlan
from distkeras_tpu_torch.serving import (ModelRegistry, ServeClient,
                                         ServingFrontend)
from distkeras_tpu_torch.telemetry import tracing
from distkeras_tpu_torch.telemetry.tracing import analysis, clock, recorder
from distkeras_tpu_torch.telemetry.tracing import context as trace_context
from distkeras_tpu_torch.telemetry.tracing.context import SPAN_KIND

FAST = dict(timeout=5.0, retries=3, backoff=0.01)
SMALL = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)


def _reset_all():
    for tel, ctx, rec, clk, trc in (
            (telemetry, trace_context, recorder, clock, tracing),
            (jax_telemetry, jax_context, jax_recorder, jax_clock,
             jax_tracing)):
        tel.reset()
        ctx._reset_stream()
        rec._reset()
        clk.reset()
        trc.set_role("")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("DKTPU_TRACE", "DKTPU_TRACE_DIR", "DKTPU_TRACE_ROLE",
                "DKTPU_TELEMETRY_ROTATE_MB", "DKTPU_PS_STATE_DIR"):
        monkeypatch.delenv(var, raising=False)
    _reset_all()
    yield
    _reset_all()


def _on(monkeypatch, trace_dir=None):
    monkeypatch.setenv("DKTPU_TRACE", "1")
    if trace_dir is not None:
        monkeypatch.setenv("DKTPU_TRACE_DIR", str(trace_dir))


def _spans(tel=telemetry):
    return [e for e in tel.get().events() if e.get("kind") == SPAN_KIND]


def _report(d):
    """The trace report of a directory, checked equal in both packages."""
    port = analysis.trace_report(
        tracing.TelemetryCollector.from_dir(str(d)).records())
    ref = jax_tracing.trace_report(
        jax_tracing.TelemetryCollector.from_dir(str(d)).records())
    assert json.dumps(port, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)
    assert analysis.render_trace_report(port) == \
        jax_tracing.render_trace_report(ref)
    return port


# -- context ----------------------------------------------------------------

def test_trace_scope_roots_and_nests(monkeypatch):
    _on(monkeypatch)
    with tracing.trace_scope("commit", wid=3) as root:
        assert tracing.current() == root
        with tracing.trace_scope("commit.encode") as child:
            assert child.trace == root.trace and child.span != root.span
    spans = {s["name"]: s for s in _spans()}
    assert set(spans) == {"commit", "commit.encode"}
    assert spans["commit.encode"]["parent"] == root.span
    assert "parent" not in spans["commit"]
    assert spans["commit"]["wid"] == 3


def test_tracing_off_is_a_noop(tmp_path, monkeypatch):
    monkeypatch.setenv("DKTPU_TRACE_DIR", str(tmp_path))
    with tracing.trace_scope("commit") as ctx:
        assert ctx is None and tracing.wire_fields() == {}
        with tracing.child_scope("commit.fold") as c:
            assert c is None
    tracing.emit("commit.queue", tracing.TraceContext("t", "p"), 0.0, 1.0)
    assert _spans() == [] and tracing.ring_head(8) == []
    assert tracing.header_ctx({"trace": "abc"}) is None
    assert list(tmp_path.iterdir()) == [], "no stream, no dump"


def test_child_scope_never_roots_an_orphan(monkeypatch):
    _on(monkeypatch)
    with tracing.child_scope("commit.fold") as ctx:
        assert ctx is None
    assert _spans() == []
    with tracing.trace_scope("commit"):
        with tracing.child_scope("commit.fold") as ctx:
            assert ctx is not None
    assert {s["name"] for s in _spans()} == {"commit", "commit.fold"}


def test_adopt_crosses_threads(monkeypatch):
    _on(monkeypatch)
    seen = {}

    def stripe(ctx):
        with tracing.adopt(ctx):
            with tracing.child_scope("commit.wire", shard=1) as c:
                seen["ctx"] = c

    with tracing.trace_scope("commit") as root:
        t = threading.Thread(target=stripe, args=(tracing.current(),))
        t.start()
        t.join()
    assert seen["ctx"].trace == root.trace
    wire_span = next(s for s in _spans() if s["name"] == "commit.wire")
    assert (wire_span["trace"], wire_span["parent"]) == (root.trace,
                                                         root.span)


def test_wire_fields_header_ctx_and_emit(monkeypatch):
    _on(monkeypatch)
    with tracing.trace_scope("commit") as root:
        header = dict({"op": "commit"}, **tracing.wire_fields())
    assert tracing.header_ctx(header) == tracing.TraceContext(root.trace,
                                                              root.span)
    assert jax_tracing.header_ctx(header) == (root.trace, root.span)
    assert tracing.header_ctx({"op": "commit"}) is None
    ctx = tracing.TraceContext("t" * 16, "p" * 16)
    tracing.emit("commit.queue", ctx, 123.0, 0.25, wid=1)
    queue = next(s for s in _spans() if s["name"] == "commit.queue")
    assert (queue["trace"], queue["parent"], queue["t0"], queue["dur"]) == (
        ctx.trace, ctx.span, 123.0, 0.25)


@pytest.mark.parametrize("samples", [
    [(0.0, 10.0, 10.0, 1.0), (0.0, 50.0, 50.0, 4.0),
     (0.0, 20.0, 20.0, 0.5)],
    [(5.0, 4.0, 4.5, 6.0), (1.0, 0.5, 0.5, 1.2)],
    [(0.0, 1.0, 1.2, 0.1)],
])
def test_clock_estimates_as_the_reference(samples):
    for ct0, st1, st2, ct3 in samples:
        clock.observe(ct0, st1, st2, ct3)
        jax_clock.observe(ct0, st1, st2, ct3)
        assert (clock.offset(), clock.rtt()) == (jax_clock.offset(),
                                                 jax_clock.rtt())
    clock.reset()
    clock.observe_reply(0.0, {"ok": True}, 1.0)
    assert clock.offset() == 0.0 and clock.rtt() is None
    clock.observe_reply(0.0, {"st1": 5.0, "st2": 5.0}, 1.0)
    assert clock.offset() == pytest.approx(4.5)


# -- flight recorder and stream ---------------------------------------------

def test_ring_feeds_from_events_and_dump_dedups(monkeypatch, tmp_path):
    _on(monkeypatch, tmp_path)
    tracing.set_role("ps")
    with tracing.trace_scope("commit"):
        pass
    telemetry.event("fault_injected", {"fault": "ps_crash", "at": 3})
    assert tracing.ring_head(8)[-1]["kind"] == "fault_injected"
    assert tracing.ring_head(0) == [], "a scrape that asks for none"
    path = tracing.flight_dump("fault:ps_crash")
    assert os.path.basename(path) == f"flight-ps-{os.getpid()}.jsonl"
    assert tracing.flight_dump("fault:ps_crash") is None, "per-reason dedup"
    recs = [json.loads(line) for line in open(path)]
    assert [r.get("kind") for r in recs[:2]] == [tracing.PROCESS_INFO_KIND,
                                                 "flight_dump"]
    assert recs[0]["role"] == "ps" and recs[1]["reason"] == "fault:ps_crash"
    assert any(r.get("kind") == "fault_injected" for r in recs)


def test_ring_is_bounded_and_sized_by_env(monkeypatch):
    _on(monkeypatch)
    r = tracing.FlightRecorder(size=4)
    for i in range(10):
        r.record({"i": i})
    assert [x["i"] for x in r.head(99)] == [6, 7, 8, 9]
    monkeypatch.setenv("DKTPU_TRACE_RING", "12")
    assert tracing.FlightRecorder()._ring.maxlen == 12


def test_fired_fault_dumps_the_ring_before_its_effect(monkeypatch, tmp_path):
    _on(monkeypatch, tmp_path)
    tracing.set_role("ps")
    plan = FaultPlan.parse_net("ps_hang@2:0.01")
    assert plan.fire("ps_hang", 2) == pytest.approx(0.01)
    (dump,) = tmp_path.glob("flight-ps-*.jsonl")
    recs = [json.loads(line) for line in open(dump)]
    assert recs[1]["reason"] == "fault:ps_hang"
    assert any(r.get("kind") == "fault_injected" for r in recs)


def test_crash_hooks_dump_and_chain(monkeypatch, tmp_path):
    _on(monkeypatch, tmp_path)
    tracing.set_role("ps")
    seen = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a[0]))
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: seen.append(args.exc_type))
    monkeypatch.setitem(recorder._HOOKS, "installed", False)
    tracing.install_crash_hooks()
    tracing.install_crash_hooks()  # idempotent: one wrap
    sys.excepthook(KeyError, KeyError("k"), None)
    t = threading.Thread(target=lambda: 1 / 0)
    t.start()
    t.join()
    assert seen == [KeyError, ZeroDivisionError], "the old hooks still run"
    (dump,) = tmp_path.glob("flight-ps-*.jsonl")
    reasons = [json.loads(line).get("reason") for line in open(dump)]
    assert "crash:KeyError" in reasons and "crash:ZeroDivisionError" in \
        reasons


def test_trace_stream_rotates_into_generations(monkeypatch, tmp_path):
    _on(monkeypatch, tmp_path)
    tracing.set_role("ps")
    monkeypatch.setenv("DKTPU_TELEMETRY_ROTATE_MB", "0.0002")
    for _ in range(12):
        with tracing.trace_scope("commit"):
            pass
    base = os.path.join(str(tmp_path), f"trace-ps-{os.getpid()}.jsonl")
    gens = tracing.generations(base)
    assert len(gens) > 1 and gens[-1] == base and gens[0] == base + ".1"
    recs = tracing.TelemetryCollector([base]).records()
    assert recs == jax_tracing.TelemetryCollector([base]).records()
    assert len([r for r in recs if r.get("name") == "commit"]) == 12


# -- collector and analysis vs the reference --------------------------------

def _write_stream(path, role, offset, spans, rtt=0.001, torn=False):
    with open(path, "w") as f:
        f.write(json.dumps({
            "kind": tracing.PROCESS_INFO_KIND, "ts": 0.0, "host": "h",
            "pid": 1 if role == "worker" else 2, "role": role,
            "boot_id": "b", "clock_offset_s": offset,
            "clock_rtt_s": rtt}) + "\n")
        for rec in spans:
            f.write(json.dumps(rec) + "\n")
        if torn:
            f.write('{"kind": "trace_span", "trunc')


def test_collector_aligns_dedups_and_tolerates_a_torn_tail(tmp_path):
    span = {"kind": SPAN_KIND, "name": "commit", "trace": "t1",
            "span": "s1", "t0": 100.0, "dur": 0.5, "ts": 100.0}
    srv = {"kind": SPAN_KIND, "name": "commit.fold", "trace": "t1",
           "span": "s2", "parent": "s1", "t0": 95.2, "dur": 0.1,
           "ts": 95.2}
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    _write_stream(a, "worker", 0.0, [span])
    _write_stream(b, "ps", 5.0, [srv, dict(span)], torn=True)
    recs = tracing.TelemetryCollector([a, b]).records()
    assert recs == jax_tracing.TelemetryCollector([a, b]).records()
    spans = [r for r in recs if r.get("kind") == SPAN_KIND]
    assert [s["name"] for s in spans] == ["commit", "commit.fold"]
    fold = spans[1]
    assert fold["t0"] == pytest.approx(100.2) and fold["role"] == "ps"


def _commit_trace(tid, t0, segs, wid=0, seq=0, root="commit"):
    root_dur = max(0.001, sum(d for _n, d in segs) + 0.001)
    out = [{"kind": SPAN_KIND, "name": root, "trace": tid,
            "span": f"{tid}-r", "t0": t0, "dur": root_dur, "ts": t0,
            "wid": wid, "seq": seq}]
    for i, (name, dur) in enumerate(segs):
        out.append({"kind": SPAN_KIND, "name": name, "trace": tid,
                    "span": f"{tid}-{i}", "parent": f"{tid}-r",
                    "t0": t0 + 0.0001 * i, "dur": dur, "ts": t0})
    return out


_FULL = [("commit.encode", 0.001), ("commit.wire", 0.004),
         ("commit.queue", 0.0005), ("commit.fold", 0.002),
         ("commit.ack", 0.0002)]


def _case_config_aware():
    return (_commit_trace("aa", 1.0, _FULL + [("commit.fsync", 0.003)])
            + _commit_trace("bb", 2.0, _FULL))


def _case_stripes():
    recs = _commit_trace("aa", 1.0, _FULL)
    recs.append({"kind": SPAN_KIND, "name": "commit.wire", "trace": "aa",
                 "span": "aa-w2", "parent": "aa-r", "t0": 1.0,
                 "dur": 0.010, "ts": 1.0})
    return recs


def _case_orphans_and_skew():
    skewed = _commit_trace("sk", 10.0, _FULL)
    skewed[1]["t0"] = 9.0
    return [{"kind": SPAN_KIND, "name": "commit.fold", "trace": "dead",
             "span": "x", "parent": "gone", "t0": 5.0, "dur": 0.1,
             "ts": 5.0}] + skewed


def _case_chaos():
    recs = []
    for i in range(60):
        recs.extend(_commit_trace(f"t{i:02d}", float(i), _FULL, seq=i))
    recs.extend(_commit_trace("slow", 100.0, [
        ("commit.encode", 0.001), ("commit.wire", 3.0),
        ("commit.queue", 0.0005), ("commit.fold", 0.002),
        ("commit.ack", 0.0002)]))
    recs.append({"kind": "fault_injected", "ts": 100.5, "fault": "ps_crash",
                 "at": 20, "role": "ps"})
    recs.append({"kind": "netps_eviction", "ts": 500.0, "wid": 3,
                 "role": "ps"})
    return recs


def _case_other_roots():
    recs = _commit_trace("h1", 1.0, [("commit", 0.004)], root="hier.flush")
    recs += _commit_trace("p1", 2.0, [("pull.wire", 0.001)], root="pull")
    recs += _commit_trace("s1", 3.0, [("serve.wire", 0.002),
                                      ("serve.queue", 0.001),
                                      ("serve.batch", 0.001)],
                          root="serve.request")
    recs += _commit_trace("r1", 4.0, [], root="tuner.retune")
    recs += _commit_trace("rp", 5.0, _FULL + [("commit.replicate", 0.002)])
    return recs


@pytest.mark.parametrize("case", [
    _case_config_aware, _case_stripes, _case_orphans_and_skew, _case_chaos,
    _case_other_roots])
def test_trace_report_matches_the_reference(case):
    recs = case()
    port = analysis.trace_report(recs)
    ref = jax_tracing.trace_report(recs)
    assert json.dumps(port, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)
    assert analysis.render_trace_report(port) == \
        jax_tracing.render_trace_report(ref)
    assert analysis.segment_model(recs) == \
        jax_tracing.analysis.segment_model(recs)


def test_trace_report_reads_its_cases():
    rep = analysis.trace_report(_case_config_aware())
    assert "fsync" in rep["required"] and (rep["commits"],
                                           rep["complete"]) == (2, 1)
    rep = analysis.trace_report(_case_stripes())
    assert rep["segments"]["wire"]["max_s"] == pytest.approx(0.010)
    rep = analysis.trace_report(_case_orphans_and_skew())
    assert rep["orphans"] == ["dead"] and rep["skew_violations"] == 1
    rep = analysis.trace_report(_case_chaos())
    by_detail = {c["detail"]: c for c in rep["chaos"]}
    assert by_detail["ps_crash"]["slow_traces"] == ["slow"]
    rep = analysis.trace_report(_case_other_roots())
    assert (rep["hier_flushes"], rep["pulls"], rep["serves"],
            rep["retunes"]) == (1, 1, 1, 1)
    assert "replicate" in rep["required"]


# -- the wire: both packages, both transports -------------------------------

def _servers(which, transport, **kw):
    if which == "port":
        return PSServer(discipline="adag", host="127.0.0.1", port=0,
                        device="cpu", transport=transport, **kw).start()
    return JaxPSServer(discipline="adag", host="127.0.0.1", port=0,
                       transport=transport, **kw).start()


def _client(which, endpoint, transport, **kw):
    cls = PSClient if which == "port" else JaxPSClient
    return cls(endpoint, worker_id=0, transport=transport, **FAST, **kw)


@pytest.mark.parametrize("transport", ["tcp", "shm"])
@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "jax"),
                                                    ("jax", "port")])
def test_mixed_package_commits_trace_completely(
        tmp_path, monkeypatch, client_pkg, server_pkg, transport):
    """A traced client of one package against a traced server of the
    other: every commit is one complete trace (the client's encode, wire
    and ack, the server's queue and fold), nothing orphaned, and the
    directory reports the same in both packages."""
    _on(monkeypatch, tmp_path)
    (tracing if client_pkg == "port" else jax_tracing).set_role("trainer")
    (tracing if server_pkg == "port" else jax_tracing).set_role("ps")
    srv = _servers(server_pkg, transport)
    c = _client(client_pkg, srv.endpoint, transport)
    tmpl = [np.zeros((4, 3), np.float32), np.zeros((5,), np.float32)]
    try:
        _center, u = c.join(init=tmpl)
        for _ in range(4):
            assert c.commit([np.ones_like(a) for a in tmpl], u).applied
            _center, u = c.pull()
        c.heartbeat()
        assert c.active_transport == transport
        c.leave()
    finally:
        c.close()
        srv.close()
    rep = _report(tmp_path)
    assert (rep["commits"], rep["complete"]) == (4, 4)
    assert rep["completeness"] == 1.0 and rep["pulls"] == 4
    assert rep["orphans"] == [] and rep["skew_violations"] == 0
    assert {p.split(":")[0] for p in rep["processes"]} == {"trainer", "ps"}


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_tracing_off_headers_hold_no_trace_or_clock_key(
        tmp_path, monkeypatch, client_pkg):
    """With ``DKTPU_TRACE`` unset no request header carries a trace or
    clock key and no span is written; traced but against a peer that
    never advertised the bit, the same."""
    import distkeras_tpu.netps.wire as jax_wire

    sent = []
    for mod in (wire, jax_wire):
        real = mod.send_frame

        def spy(sock, kind, header, arrays, _real=real):
            if kind == mod.KIND_REQUEST:
                sent.append(dict(header))
            return _real(sock, kind, header, arrays)

        monkeypatch.setattr(mod, "send_frame", spy)
    monkeypatch.setenv("DKTPU_TRACE_DIR", str(tmp_path))
    srv = _servers("port", "tcp")
    c = _client(client_pkg, srv.endpoint, "tcp")
    tmpl = [np.zeros((2, 2), np.float32)]
    try:
        _center, u = c.join(init=tmpl)
        c.commit([np.ones_like(a) for a in tmpl], u)
        c.heartbeat()
        c.pull()
        _on(monkeypatch)
        c.peer_caps = {k: v for k, v in c.peer_caps.items()
                       if k != "tracing"}
        c.commit([np.ones_like(a) for a in tmpl], u)
        c.heartbeat()
        c.pull()
        c.join()
    finally:
        c.close()
        srv.close()
    assert len(sent) >= 8
    for header in sent:
        for key in ("trace", "parent", "ct0", "st1", "st2"):
            assert key not in header, key
    names = {s["name"] for s in _spans() + _spans(jax_telemetry)}
    assert not names & {"commit.queue", "commit.fold"}, "no server spans"


def test_clock_estimate_rides_rejoin_and_heartbeat(tmp_path, monkeypatch):
    _on(monkeypatch, tmp_path)
    srv = _servers("port", "tcp")
    c = _client("port", srv.endpoint, "tcp")
    try:
        c.join(init=[np.zeros((2,), np.float32)])
        assert clock.rtt() is None, "a first join sends no clock stamp"
        c.heartbeat()
    finally:
        c.close()
        srv.close()
    assert clock.rtt() is not None and clock.rtt() < 5.0
    assert abs(clock.offset()) < 5.0


@pytest.mark.parametrize("scraper", ["port", "jax"])
def test_stats_op_answers_role_snapshot_and_ring(tmp_path, monkeypatch,
                                                 scraper):
    from distkeras_tpu_torch.telemetry.report import scrape_stats

    _on(monkeypatch, tmp_path)
    tracing.set_role("ps")
    srv = _servers("port", "tcp")
    c = _client("port", srv.endpoint, "tcp")
    try:
        c.join(init=[np.zeros((2,), np.float32)])
        c.commit([np.ones((2,), np.float32)], 0)
        scrape = scrape_stats if scraper == "port" else jax_scrape_stats
        hdr = scrape(srv.endpoint, ring=16)
        assert c.stats()["ring"] == [], "the port client asks for none"
    finally:
        c.close()
        srv.close()
    assert hdr["ok"] is True and hdr["role"] == "ps"
    assert hdr["caps"]["tracing"] is True and hdr["commits_total"] == 1
    assert hdr["fold_backend"] == "torch-cpu"
    assert 0 < len(hdr["ring"]) <= 16
    assert any(r.get("name") == "commit.fold" for r in hdr["ring"])


def test_standby_replicate_span_joins_the_commit_trace(tmp_path,
                                                       monkeypatch):
    _on(monkeypatch, tmp_path)
    srv = _servers("port", "tcp", state_dir=str(tmp_path / "state"))
    stb = StandbyServer(srv.endpoint, promote_after=30.0, host="127.0.0.1",
                        port=0, device="cpu",
                        state_dir=str(tmp_path / "sb")).start()
    c = _client("port", srv.endpoint, "tcp")
    tmpl = [np.zeros((3,), np.float32)]
    try:
        c.join(init=tmpl)
        deadline = time.monotonic() + 10.0
        while stb.snapshot_syncs < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert stb.snapshot_syncs >= 1
        for i in range(4):
            c.commit([np.ones_like(a) for a in tmpl], i)
        deadline = time.monotonic() + 10.0
        while stb.replicated < 4 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert stb.replicated >= 4
    finally:
        stb.close()
        srv.close()
        c.close()
    rep = _report(tmp_path)
    assert {"fsync", "replicate"} <= set(rep["required"])
    assert (rep["commits"], rep["complete"]) == (4, 4)


def test_striped_commit_stripes_join_their_trace(tmp_path, monkeypatch):
    """Stripe sub-RPCs run on pool threads: each adopts the commit's
    context, so every stripe's ``commit.wire`` has its root."""
    _on(monkeypatch, tmp_path)
    srv = _servers("port", "tcp")
    c = _client("port", srv.endpoint, "tcp", shards=2)
    tmpl = [np.zeros((64,), np.float32), np.zeros((32,), np.float32),
            np.zeros((16,), np.float32)]
    try:
        _center, u = c.join(init=tmpl)
        assert c.active_shards == 2
        for _ in range(3):
            c.commit([np.ones_like(a) for a in tmpl], u)
            _center, u = c.pull()
    finally:
        c.close()
        srv.close()
    rep = _report(tmp_path)
    assert (rep["commits"], rep["complete"]) == (3, 3)
    assert rep["orphans"] == [] and rep["pulls"] == 3
    wires = [s for s in _spans() if s["name"] == "commit.wire"]
    assert len(wires) == 6 and {s["shard"] for s in wires} == {0, 1}


def test_sharded_center_commits_are_one_trace_each(tmp_path, monkeypatch):
    from distkeras_tpu_torch.netps.shards import ShardSet, make_ps_client

    _on(monkeypatch, tmp_path)
    tmpl = [np.zeros((8, 4), np.float32), np.zeros((6,), np.float32)]
    with ShardSet(2, discipline="adag", device="cpu") as ss:
        c = make_ps_client(ss.endpoint, worker_id=0, **FAST)
        try:
            _center, u = c.join(init=tmpl)
            for _ in range(2):
                c.commit([np.ones_like(a) for a in tmpl], u)
                _center, u = c.pull()
        finally:
            c.close()
    rep = _report(tmp_path)
    assert rep["orphans"] == [] and rep["pulls"] == 2
    commits = [s for s in _spans() if s["name"] == "commit"]
    roots = [s for s in commits if "parent" not in s]
    assert len(roots) == 2 and len(commits) == 6, "one root, two shards"
    folds = [s for s in _spans() if s["name"] == "commit.fold"]
    assert {s["trace"] for s in folds} == {s["trace"] for s in roots}


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_served_requests_trace_end_to_end(tmp_path, monkeypatch,
                                          client_pkg):
    _on(monkeypatch, tmp_path)
    registry = ModelRegistry(imdb_lstm(**SMALL, device="cpu"), (1, 4),
                             device="cpu")
    frontend = ServingFrontend(registry, max_wait_s=0.002).start()
    cls = ServeClient if client_pkg == "port" else JaxServeClient
    sc = cls(frontend.endpoint, **FAST)
    x = np.random.default_rng(0).integers(0, 50, (2, 6)).astype(np.int32)
    try:
        for _ in range(3):
            out, _version = sc.infer(x)
            assert out.shape == (2, 2)
        ring = sc.stats(ring=8)["ring"]
    finally:
        sc.close()
        frontend.close()
        registry.close()
    assert ring and len(ring) <= 8
    server = {}
    for s in _spans():
        server.setdefault(s["name"], []).append(s)
    client_tel = telemetry if client_pkg == "port" else jax_telemetry
    client = {}
    for s in _spans(client_tel):
        client.setdefault(s["name"], []).append(s)
    roots = {s["trace"] for s in client["serve.request"]}
    assert len(roots) == 3 and len(client["serve.wire"]) == 3
    assert {s["trace"] for s in server["serve.queue"]} == roots
    assert {s["trace"] for s in server["serve.batch"]} == roots
    rep = _report(tmp_path)
    assert rep["serves"] == 3 and rep["orphans"] == []


# -- the whole slice ----------------------------------------------------------

def _columns(rounds=3, seed=0):
    rng = np.random.default_rng(seed)
    n = 2 * 5 * rounds
    return {"features": rng.integers(0, 50, (n, 6)).astype(np.int32),
            "label": rng.integers(0, 2, n).astype(np.int32)}


def _remote_run(monkeypatch, tmp_path, traced):
    if traced:
        _on(monkeypatch, tmp_path)
    else:
        monkeypatch.delenv("DKTPU_TRACE", raising=False)
    srv = PSServer(discipline="dynsgd", device="cpu").start()
    try:
        pm = imdb_lstm(**SMALL, device="cpu", seed=3)
        T.DynSGD(pm, worker_optimizer="sgd",
                 loss="sparse_categorical_crossentropy", num_workers=1,
                 batch_size=5, communication_window=2, learning_rate=0.1,
                 remote=srv.endpoint).train(DataFrame(_columns()))
        return srv.center(), list(srv.commit_log)
    finally:
        srv.close()


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_traced_and_untraced_runs_fold_bit_equal_centers(
        tmp_path, monkeypatch, compress):
    monkeypatch.setenv("DKTPU_NET_COMPRESS", compress)
    plain, plain_log = _remote_run(monkeypatch, tmp_path, traced=False)
    assert _spans() == []
    traced, traced_log = _remote_run(monkeypatch, tmp_path, traced=True)
    assert traced_log == plain_log
    for a, b in zip(plain, traced):
        assert a.tobytes() == b.tobytes()
    rep = _report(tmp_path)
    assert rep["commits"] == len(traced_log) == 3
    assert rep["completeness"] == 1.0
