"""The port's run report and exporters (``telemetry/report.py``,
``telemetry/exporters.py``) held to the JAX package's: the same JSONL
through both packages' ``build_report``/``render_report`` gives equal
dicts and equal text (a port trainer's metrics file, a JAX trainer's, and
synthetic records that fill every section), ``python -m ...telemetry
report`` prints the same bytes, ``report --trace`` over one directory
prints the same report, and ``prometheus_text`` of one snapshot is
byte-equal in both packages and parses back."""

import json
import time
import types

import numpy as np
import pytest

import distkeras_tpu as dk
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
from distkeras_tpu.telemetry import exporters as jax_exporters
from distkeras_tpu.telemetry import report as jax_report
from distkeras_tpu.telemetry.core import Telemetry as JaxTelemetry
from distkeras_tpu_torch import DataFrame, imdb_lstm
from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.telemetry import exporters, report
from distkeras_tpu_torch.telemetry.core import Telemetry

SMALL = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)
W, K_STEPS, B, ROUNDS = 2, 2, 5, 3


def _columns(seed=0):
    rng = np.random.default_rng(seed)
    n = W * K_STEPS * B * ROUNDS
    return {"features": rng.integers(0, 50, (n, 6)).astype(np.int32),
            "label": rng.integers(0, 2, n).astype(np.int32)}


def _kw(path):
    return dict(worker_optimizer="sgd",
                loss="sparse_categorical_crossentropy", num_workers=W,
                batch_size=B, communication_window=K_STEPS,
                learning_rate=0.1, metrics_path=path)


def _same_report(path, k=None):
    """Both packages' structured and rendered reports of one file."""
    kw = {} if k is None else {"k": k}
    port, ref = report.build_report(path, **kw), jax_report.build_report(
        path, **kw)
    assert json.dumps(port, sort_keys=True, default=float) == json.dumps(
        ref, sort_keys=True, default=float)
    text = report.render_report(port)
    assert text == jax_report.render_report(ref)
    return port, text


@pytest.fixture(scope="module")
def run_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("runs")
    port = str(d / "port.jsonl")
    T.DynSGD(imdb_lstm(**SMALL, device="cpu"), **_kw(port)).train(
        DataFrame(_columns()))
    jax = str(d / "jax.jsonl")
    dk.DynSGD(jax_imdb_lstm(**SMALL), **_kw(jax)).train(
        JaxDataFrame(_columns()))
    return {"port": port, "jax": jax}


@pytest.mark.parametrize("which", ["port", "jax"])
def test_trainer_metrics_file_reports_as_the_reference(run_files, which):
    rep, text = _same_report(run_files[which])
    assert rep["rounds"] == ROUNDS
    assert rep["staleness"]["num_workers"] == W
    assert "## Staleness" in text and "## Stragglers" in text


@pytest.mark.parametrize("which", ["port", "jax"])
def test_report_cli_prints_the_reference_bytes(run_files, which, capsys):
    for argv in (["report", run_files[which]],
                 ["report", run_files[which], "--json"],
                 ["report", run_files[which], "--straggler-k", "1.01"]):
        assert report.main(argv) == 0
        port = capsys.readouterr().out
        assert jax_report.main(argv) == 0
        assert port == capsys.readouterr().out


def _filled_file(path):
    """Synthetic records for every report section: rounds (with a burst,
    a straggler and staleness fields), spans, fleet attribution, serving,
    streaming, shards and the tuner's events."""
    t = Telemetry()
    rounds = []
    for r in range(12):
        dt = 0.5 if r == 7 else (0.0 if r % 4 == 2 else 0.1)
        rounds.append({"round": r, "loss": 2.0 - 0.1 * r,
                       "round_seconds": dt, "samples_per_sec": 640.0,
                       "staleness": [r % 3, (r + 1) % 3],
                       "dynsgd_scale": [1.0 / (1 + r % 3), 0.5],
                       "loss_divergence": [0.01 * r, -0.01 * r],
                       **({"straggler": True} if r == 7 else {})})
    t.counter("fleet.commits.acme.train").add(40)
    t.counter("fleet.preemptions.acme.train").add(2)
    t.gauge("fleet.staleness_mean.acme.train").set(1.5)
    t.histogram("fleet.round.acme.train").observe(0.25)
    t.histogram("fleet.round.acme.train").observe(0.5)
    for name, v in (("serving.accepted", 9), ("serving.answered", 9),
                    ("serving.shed", 1), ("serving.batches", 3),
                    ("serving.batched_rows", 20),
                    ("serving.padded_rows", 4), ("serving.swaps", 1)):
        t.counter(name).add(v)
    for v in (0.004, 0.006, 0.05):
        t.histogram("serving.latency").observe(v)
    t.gauge("serving.queue_depth").set(3)
    t.counter("stream.items_read").add(100)
    t.counter("stream.items_committed.acme.train").add(90)
    t.gauge("stream.offset_lag").set(10)
    t.gauge("stream.eval.loss_fast").set(0.4)
    t.histogram("serving.freshness").observe(1.5)
    for k in range(2):
        t.counter(f"netps.shard.folds.{k}").add(10 + k)
        t.counter(f"netps.shard.bytes.{k}").add(1000 * (k + 1))
    t.gauge("netps.shard.count").set(2.0)
    t.gauge("netps.shard.skew").set(1.01)
    t.counter("netps.shard.partial_commits").add(1)
    t.counter("input_stall_seconds").add(0.05)
    t.histogram("engine_run").observe(1.25)
    t.histogram("engine_run/dispatch").observe(0.75)
    t.event("tuner_probe", {"codec": "int8", "probes": 3, "seconds": 0.01,
                            "score": 1e9})
    t.event("tuner_decision", {"knob": "codec", "from": "none",
                               "to": "int8", "trigger": "wire_share",
                               "round": 12})
    t.event("tuner_fallback", {"knob": "shards", "restored": 1,
                               "round": 20, "reason": "oscillation"})
    t.event("tuner_run_summary", {"inflight": 2, "codec": "int8",
                                  "shards": 2, "transport": "tcp",
                                  "retunes": 1, "fallbacks": 1,
                                  "deferred": 0})
    t.counter("tuner.deferred").add(2)
    with open(path, "w") as f:
        for rec in rounds:
            f.write(json.dumps(rec) + "\n")
    exporters.write_jsonl(t, path)


@pytest.mark.parametrize("k", [None, 1.5, 3.0])
def test_every_section_reports_as_the_reference(tmp_path, k):
    path = str(tmp_path / "filled.jsonl")
    _filled_file(path)
    rep, text = _same_report(path, k)
    for section in ("Phase breakdown", "Throughput segments", "Staleness",
                    "Fleet", "Serving", "Streaming", "Sharded center",
                    "Tuner", "Stragglers"):
        assert f"## {section}" in text, section
    assert rep["fleet"][0]["tenant"] == "acme"
    assert rep["shards"]["per_shard_folds"] == [10.0, 11.0]
    assert rep["tuner"]["converged"]["codec"] == "int8"


def test_empty_and_torn_files_report_as_the_reference(tmp_path):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    _same_report(str(empty))
    torn = tmp_path / "torn.jsonl"
    torn.write_text(json.dumps({"round": 0, "loss": 1.0,
                                "round_seconds": 0.1}) + '\n{"round": 1, "lo')
    rep, _ = _same_report(str(torn))
    assert rep["rounds"] == 1


def test_trace_report_cli_over_one_dir_matches_the_reference(
        tmp_path, capsys):
    path = str(tmp_path / "filled.jsonl")
    _filled_file(path)
    spans = []
    for i in range(10):
        tid = f"t{i}"
        spans.append({"kind": "trace_span", "name": "commit", "trace": tid,
                      "span": f"{tid}r", "t0": float(i), "dur": 0.01,
                      "ts": float(i), "wid": 0, "seq": i})
        for j, seg in enumerate(("encode", "wire", "queue", "fold", "ack")):
            spans.append({"kind": "trace_span", "name": f"commit.{seg}",
                          "trace": tid, "span": f"{tid}{j}",
                          "parent": f"{tid}r", "t0": i + 0.001 * j,
                          "dur": 0.001 * (j + 1), "ts": i + 0.001 * j})
    with open(tmp_path / "trace-ps-1.jsonl", "w") as f:
        f.write(json.dumps({"kind": "process_info", "ts": 0.0, "host": "h",
                            "pid": 1, "role": "ps", "boot_id": "b",
                            "clock_offset_s": 0.25,
                            "clock_rtt_s": 0.001}) + "\n")
        for s in spans:
            f.write(json.dumps(s) + "\n")
    assert report.merged_records(str(tmp_path)) == jax_report.merged_records(
        str(tmp_path))
    for argv in (["report", str(tmp_path), "--trace"],
                 ["report", str(tmp_path), "--trace", "--json"]):
        assert report.main(argv) == 0
        port = capsys.readouterr().out
        assert jax_report.main(argv) == 0
        assert port == capsys.readouterr().out
    assert "commit traces: 10   complete: 10 (100.0%)" in port or \
        '"complete": 10' in port


def test_report_trace_exit_contract_on_missing_and_empty(tmp_path, capsys):
    missing = tmp_path / "never-made"
    assert report.main(["report", str(missing), "--trace"]) == 2
    assert capsys.readouterr().err.strip() == (
        f"trace report: no such file or directory: {missing}")
    empty = tmp_path / "empty"
    empty.mkdir()
    assert report.main(["report", str(empty), "--trace", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["commits"] == 0


# ---------------------------------------------------------------------------
# Prometheus
# ---------------------------------------------------------------------------

def _drive(t):
    """One fixed sequence of registry calls (no timed spans: their
    durations differ run to run)."""
    t.counter("netps.commits").add(3)
    t.counter("weird name/with-chars").add(1.5)
    t.gauge("runtime.rss_mb").set(123.25)
    t.gauge("device.bytes_in_use").set(4096.0)
    for v in (1e-6, 0.003, 0.003, 0.25, 7.0, 1e4):
        t.histogram("netps.server.commit").observe(v)
    t.histogram("serving.latency").observe(0.01)


def test_prometheus_text_is_byte_equal_in_both_packages():
    port_t, jax_t = Telemetry(), JaxTelemetry()
    _drive(port_t)
    _drive(jax_t)
    text = exporters.prometheus_text(port_t)
    assert text == jax_exporters.prometheus_text(jax_t)
    # The same snapshot through both functions, spans with real timings
    # included.
    with port_t.span("engine_run"):
        time.sleep(0.001)
    snap = port_t.snapshot()
    stub = types.SimpleNamespace(snapshot=lambda: snap)
    assert exporters.prometheus_text(stub) == \
        jax_exporters.prometheus_text(stub)


def test_prometheus_text_parses_back_in_both_packages():
    t = Telemetry()
    _drive(t)
    text = exporters.prometheus_text(t)
    parsed = exporters.parse_prometheus(text)
    assert parsed == jax_exporters.parse_prometheus(text)
    assert parsed["dktpu_counter_total"][(("name", "netps_commits"),)] == 3
    assert parsed["dktpu_gauge"][(("name", "device_bytes_in_use"),)] == 4096
    count = parsed["dktpu_span_seconds_count"]
    assert count[(("span", "netps_server_commit"),)] == 6
    buckets = parsed["dktpu_span_seconds_bucket"]
    assert buckets[(("span", "netps_server_commit"), ("le", "+Inf"))] == 6
