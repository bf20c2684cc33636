"""The per-round metrics log of the port (``metrics.py``,
``telemetry/training.py``, ``telemetry/exporters.py``,
``telemetry/report.py``) against the JAX package's: the same records and
fields for the same calls, the burst-tail rule, the per-run close-time
summary, and a port-written file read by the JAX package's ``read_jsonl``
and its ``python -m distkeras_tpu.telemetry report``."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from distkeras_tpu.metrics import MetricsLogger as JaxMetricsLogger
from distkeras_tpu.telemetry.core import Telemetry as JaxTelemetry
from distkeras_tpu.telemetry.exporters import read_jsonl as jax_read_jsonl
from distkeras_tpu.telemetry.report import (
    throughput_segments as jax_throughput_segments,
)
from distkeras_tpu.telemetry.training import (
    DisciplineMonitor as JaxDisciplineMonitor,
)
from distkeras_tpu_torch import DataFrame, imdb_lstm
from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.metrics import (
    MetricsLogger,
    profile_trace,
    scaling_efficiency,
)
from distkeras_tpu_torch.parallel.disciplines import (
    ADAGFold,
    DynSGDFold,
    EnsembleFold,
)
from distkeras_tpu_torch.telemetry.core import Telemetry
from distkeras_tpu_torch.telemetry.exporters import (
    read_jsonl,
    rotate_jsonl,
    write_jsonl,
)
from distkeras_tpu_torch.telemetry.report import throughput_segments
from distkeras_tpu_torch.telemetry.training import (
    DisciplineMonitor,
    dynsgd_scales,
    flag_stragglers,
    staleness_schedule,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_metrics_logger_writes_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    logger = MetricsLogger(path, samples_per_round=128, num_chips=4)
    logger(0, 1.5)
    time.sleep(0.002)  # distinct timing segments
    logger(1, 1.2)
    logger.close()
    lines = [json.loads(ln) for ln in open(path)]
    assert lines[0]["loss"] == 1.5 and lines[1]["round"] == 1
    assert "samples_per_sec_per_chip" in lines[1]
    assert logger.mean_throughput() > 0


def test_scaling_efficiency():
    assert scaling_efficiency(800, 100, 8) == pytest.approx(1.0)
    assert scaling_efficiency(400, 100, 8) == pytest.approx(0.5)
    assert scaling_efficiency(400, 0, 8) == 0.0


def test_metrics_logger_context_manager_and_idempotent_close(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with MetricsLogger(path, samples_per_round=8) as logger:
        logger(0, np.float32(1.0))
        logger(1, torch.tensor([0.5, 0.5]))
        assert logger._file is not None
    assert logger._file is None
    logger.close()
    logger.close()
    recs = read_jsonl(path)
    rounds = [r for r in recs if "round" in r and "kind" not in r]
    assert [r["round"] for r in rounds] == [0, 1]
    assert rounds[1]["worker_loss"] == [0.5, 0.5]
    assert any(r.get("kind") == "telemetry_summary" for r in recs)
    assert recs[2]["kind"] == "process_info"


def test_metrics_logger_feeds_telemetry(tmp_path):
    t = Telemetry()
    with MetricsLogger(str(tmp_path / "m.jsonl"), telemetry=t) as logger:
        logger(0, np.float32(2.0))
    snap = t.snapshot()
    assert snap["counters"]["rounds"] == 1
    assert snap["gauges"]["loss"]["value"] == 2.0
    assert snap["spans"]["round_seconds"]["count"] == 1


def _records(cls, tel_cls, mon_cls, disc, path):
    """One burst-shaped call sequence through a logger; the records with
    the timing fields dropped."""
    t = tel_cls()
    mon = mon_cls(disc, num_workers=4, telemetry=t)
    state = object()
    loss = np.array([1.0, 1.5, 0.5, 1.0], np.float32)
    with cls(path, samples_per_round=64, num_chips=1, extra={"trainer": "x"},
             telemetry=t, monitor=mon) as logger:
        for r in range(8):
            logger(r, loss + r, state if r % 4 == 3 else None)
    keep = ("ts", "round_seconds", "samples_per_sec",
            "samples_per_sec_per_chip", "straggler")
    return [{k: v for k, v in rec.items() if k not in keep}
            for rec in logger.records], t.snapshot()


@pytest.mark.parametrize("disc", ["dynsgd", "adag", "none"])
def test_records_match_the_jax_logger(tmp_path, disc):
    """The same calls give the same records (fields, burst_tail, the
    discipline fields) and the same registry aggregates as the JAX
    package's logger, up to the clocks."""
    from distkeras_tpu.parallel import disciplines as JD

    port_disc = {"dynsgd": DynSGDFold(), "adag": ADAGFold(),
                 "none": None}[disc]
    jax_disc = {"dynsgd": JD.DynSGDFold(), "adag": JD.ADAGFold(),
                "none": None}[disc]
    got, snap = _records(MetricsLogger, Telemetry, DisciplineMonitor,
                         port_disc, str(tmp_path / "p.jsonl"))
    want, jsnap = _records(JaxMetricsLogger, JaxTelemetry,
                           JaxDisciplineMonitor, jax_disc,
                           str(tmp_path / "j.jsonl"))
    assert got == want
    assert [r["burst_tail"] for r in got] == [False, True, True, True,
                                              False, True, True, True]
    assert snap["counters"] == jsnap["counters"]
    assert sorted(snap["gauges"]) == sorted(jsnap["gauges"])


def test_metrics_logger_burst_attribution_blocked_contract(tmp_path):
    """The FIRST call of a burst absorbs the block's wall time, the LAST
    carries the state: a boundary is a call after a state-bearing one, and
    a genuinely slow block still flags as a straggler."""
    t = Telemetry()
    mon = DisciplineMonitor(None, num_workers=1, telemetry=t)
    with MetricsLogger(str(tmp_path / "b.jsonl"), telemetry=t,
                       monitor=mon) as logger:
        state = object()
        R = 4
        for block in range(5):
            time.sleep(0.05 if block == 4 else 0.01)
            for j in range(R):
                logger(block * R + j, np.float32(1.0),
                       state if j == R - 1 else None)
    recs = logger.records
    assert [r["burst_tail"] for r in recs[:R]] == [False, True, True, True]
    assert recs[16].get("straggler") is True
    assert not any(r.get("straggler") for r in recs[:16])
    assert t.snapshot()["spans"]["round_seconds"]["count"] == 5


def test_metrics_logger_summary_is_per_run(tmp_path):
    t = Telemetry()
    p1, p2 = str(tmp_path / "r1.jsonl"), str(tmp_path / "r2.jsonl")
    with MetricsLogger(p1, telemetry=t) as l1:
        for r in range(4):
            l1(r, np.float32(1.0))
    with MetricsLogger(p2, telemetry=t) as l2:
        l2(0, np.float32(1.0))
    s2 = [r for r in read_jsonl(p2) if r.get("kind") == "telemetry_summary"]
    assert s2[0]["counters"]["rounds"] == 1  # not 5
    assert s2[0]["spans"]["round_seconds"]["count"] == 1


def test_throughput_segments_match_the_jax_report():
    rows = [{"round": 0, "round_seconds": 0.4, "samples_per_sec": 160.0},
            {"round": 1, "round_seconds": 0.0, "samples_per_sec": 1e9,
             "burst_tail": True},
            {"round": 2, "round_seconds": 0.2, "samples_per_sec": 320.0,
             "burst_tail": False},
            {"round": 3, "round_seconds": 0.00001},
            {"round": 4}]
    assert throughput_segments(rows) == jax_throughput_segments(rows)


def test_training_monitor_helpers_match_the_jax_package():
    from distkeras_tpu.parallel import disciplines as JD
    from distkeras_tpu.telemetry import training as JT

    times = [1.0, 1.1, 0.9, 5.0, 1.0]
    assert flag_stragglers(times) == JT.flag_stragglers(times) == [3]
    assert flag_stragglers([1.0, 9.0]) == []
    for r in range(5):
        np.testing.assert_array_equal(
            staleness_schedule(DynSGDFold(), r, 4),
            JT.staleness_schedule(JD.DynSGDFold(), r, 4))
    assert staleness_schedule(EnsembleFold(), 0, 4) is None
    s = staleness_schedule(DynSGDFold(), 1, 4)
    np.testing.assert_array_equal(dynsgd_scales(s), JT.dynsgd_scales(s))


def _train_with_metrics(path, **extra):
    rng = np.random.default_rng(0)
    n = 4 * 2 * 5 * 3
    cols = {"features": rng.integers(0, 50, (n, 6)).astype(np.int32),
            "label": rng.integers(0, 2, n).astype(np.int32)}
    t = T.DynSGD(imdb_lstm(vocab_size=50, embed_dim=8, hidden_size=8,
                           seq_len=6, device="cpu"),
                 worker_optimizer="sgd",
                 loss="sparse_categorical_crossentropy", num_workers=4,
                 batch_size=5, communication_window=2, learning_rate=0.1,
                 metrics_path=path, **extra)
    t.train(DataFrame(cols))
    return t


def test_trainer_metrics_file_is_read_by_the_jax_report(tmp_path):
    """A port trainer's metrics file: one record a round with the
    discipline fields and samples/s, then the summary; the JAX package's
    reader and report CLI take it."""
    path = str(tmp_path / "run.jsonl")
    _train_with_metrics(path)
    recs = jax_read_jsonl(path, strict=True)
    rounds = [r for r in recs if "round" in r and "kind" not in r]
    assert [r["round"] for r in rounds] == [0, 1, 2]
    for r in rounds:
        assert r["trainer"] == "DynSGD" and r["samples_per_sec"] > 0
        assert len(r["worker_loss"]) == 4 and len(r["staleness"]) == 4
        assert r["dynsgd_scale"] == [round(1 / (s + 1), 6)
                                     for s in r["staleness"]]
    assert recs[-1]["kind"] == "telemetry_summary"
    assert recs[-1]["counters"]["rounds"] == 3
    out = subprocess.run(
        [sys.executable, "-m", "distkeras_tpu.telemetry", "report", path],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    for section in ("Throughput segments", "Staleness"):
        assert section in out.stdout


def test_trainer_closes_metrics_file_on_failure(tmp_path):
    path = str(tmp_path / "fail.jsonl")

    def boom(r, loss):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        _train_with_metrics(path, on_round=boom)
    assert any(r.get("kind") == "telemetry_summary"
               for r in read_jsonl(path))


def test_write_read_and_rotate_jsonl(tmp_path, monkeypatch):
    t = Telemetry()
    t.counter("x").add(2)
    t.event("hello", {"n": 1})
    path = str(tmp_path / "t.jsonl")
    write_jsonl(t, path, extra={"run": 7})
    recs = read_jsonl(path)
    assert [r.get("kind") for r in recs] == ["process_info", "hello",
                                             "telemetry_summary"]
    assert recs[-1]["counters"] == {"x": 2.0} and recs[-1]["run"] == 7
    mark = t.mark()
    t.counter("x").add(1)
    write_jsonl(t, path, since=mark)
    assert read_jsonl(path)[-1]["counters"] == {"x": 1.0}
    with open(path, "a") as f:
        f.write('{"torn": ')
    assert len(read_jsonl(path)) == 5  # a torn tail is skipped silently
    assert rotate_jsonl(path) is None  # rotation off by default
    monkeypatch.setenv("DKTPU_TELEMETRY_ROTATE_MB", "0.000001")
    assert rotate_jsonl(path) == path + ".1"
    assert not os.path.exists(path)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path)):
        torch.ones(8).sum()
    traces = [n for n in os.listdir(tmp_path) if n.endswith(".json")]
    assert len(traces) == 1
    assert "traceEvents" in json.load(open(tmp_path / traces[0]))
