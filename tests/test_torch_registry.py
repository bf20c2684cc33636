"""The port's hot-swapping ``ModelRegistry(directory=...)`` on the CPU, as
the JAX package's registry tests hold its own: a verified step is
restored, warmup-probed and swapped in between batches; a corrupt, broken
or refused step is skipped and the incumbent keeps answering; freshness
is recorded from the step's meta; the poll thread swaps on its own. The
swapped-in answers match the JAX model's ``predict`` on the same
parameters (f32, within 1e-5)."""

import os
import time

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.checkpoint import Checkpointer
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.models import imdb_lstm
from distkeras_tpu_torch.resilience import integrity
from distkeras_tpu_torch.serving import (
    ModelRegistry,
    ServeClient,
    ServingFrontend,
)

SMALL = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)
BUCKETS = (1, 4)
FAST = dict(timeout=5.0, retries=3, backoff=0.01)


@pytest.fixture(scope="module")
def jax_model():
    return jax_imdb_lstm(**SMALL, cell_impl="pallas", seed=2)


def port_model(jm):
    pm = imdb_lstm(**SMALL, device="cpu", cell_impl="pallas")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return pm


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


def _counters():
    return telemetry.get().snapshot()["counters"]


def _save_step(directory, model, step, scale, meta=None):
    params = {k: v * 0.0 + scale for k, v in model.params.items()}
    ckpt = Checkpointer(directory)
    assert ckpt.save(step, params,
                     meta=meta if meta is not None else {"step": step})
    return params


def _tokens(rows, seed=0):
    return np.random.default_rng(seed).integers(0, 50, (rows, 6)).astype(
        np.int32)


def test_registry_hot_swaps_verified_checkpoint(tmp_path, jax_model):
    directory = str(tmp_path)
    model = port_model(jax_model)
    registry = ModelRegistry(model, BUCKETS, directory=directory,
                             poll_s=30.0, device="cpu")
    frontend = ServingFrontend(registry, max_wait_s=0.002).start()
    client = ServeClient(frontend.endpoint, **FAST)
    try:
        _, v0 = client.infer(_tokens(1))
        assert v0 == -1
        _save_step(directory, model, 5, scale=0.0)
        assert registry.poll_once() is True
        out, v1 = client.infer(_tokens(2))
        assert v1 == 5, "replies must carry the swapped version"
        np.testing.assert_allclose(out, 0.0, atol=1e-6)
        assert registry.poll_once() is False, "same step: no re-swap"
        assert _counters()["serving.swaps"] == 1
        assert _counters().get("serving.retrace_after_warmup", 0) == 0
    finally:
        client.close()
        frontend.close()
        registry.close()


def test_swapped_answers_match_jax_predict(tmp_path, jax_model):
    """A step holding other weights (the JAX model's, scaled) answers as
    the JAX model does with those weights."""
    directory = str(tmp_path)
    registry = ModelRegistry(port_model(jax_model), BUCKETS,
                             directory=directory, poll_s=30.0, device="cpu")
    trained = jax.tree_util.tree_map(lambda a: np.asarray(a) * 1.5,
                                     jax_model.params)
    pm = port_model(jax_model)
    ckpt = Checkpointer(directory)
    ckpt.save(11, params_from_jax(trained, pm.module), meta={"round": 3})
    assert registry.poll_once() and registry.version == 11
    model, version = registry.current()
    x = _tokens(3, seed=4)
    want = np.asarray(jax_model.with_params(trained).predict(x))
    np.testing.assert_allclose(model.infer([x]), want, rtol=1e-5, atol=1e-5)
    registry.close()


def test_registry_rejects_corrupt_candidate_and_keeps_serving(
        tmp_path, jax_model, monkeypatch):
    monkeypatch.setenv("DKTPU_CKPT_DIGEST", "1")
    directory = str(tmp_path)
    model = port_model(jax_model)
    _save_step(directory, model, 3, scale=0.5)
    registry = ModelRegistry(model, BUCKETS, directory=directory,
                             poll_s=30.0, device="cpu")
    assert registry.poll_once() is True and registry.version == 3
    _save_step(directory, model, 8, scale=0.25)
    integrity.corrupt_step_dir(os.path.join(directory, "8"))
    with pytest.warns(UserWarning, match="hot-swap candidate step 8"):
        assert registry.poll_once() is False
    assert registry.version == 3, "incumbent keeps serving"
    assert _counters()["serving.swap_failures"] == 1
    # the bad step is remembered: no retry storm on the next poll
    assert registry.poll_once() is False
    assert _counters()["serving.swap_failures"] == 1
    out = registry.current()[0].infer([_tokens(2)])
    assert np.all(np.isfinite(out))
    registry.close()


def test_registry_falls_back_past_a_broken_newest_step(tmp_path, jax_model):
    """A newest step of the wrong shape and one whose probe is not finite
    are both refused in one poll; the next-newest intact step swaps in."""
    directory = str(tmp_path)
    model = port_model(jax_model)
    _save_step(directory, model, 2, scale=0.1)
    nan = {k: torch.full_like(v, float("nan")) for k, v in
           model.params.items()}
    Checkpointer(directory).save(4, nan, meta={"step": 4})
    Checkpointer(directory).save(6, {"embed.weight": torch.zeros(3)},
                                 meta={"step": 6})
    registry = ModelRegistry(model, BUCKETS, directory=directory,
                             poll_s=30.0, device="cpu")
    with pytest.warns(UserWarning, match="hot-swap candidate step"):
        assert registry.poll_once() is True
    assert registry.version == 2
    assert _counters()["serving.swap_failures"] == 2
    registry.close()


def test_registry_quality_gate_and_freshness(tmp_path, jax_model):
    directory = str(tmp_path)
    model = port_model(jax_model)
    verdicts = iter([True, False])
    registry = ModelRegistry(model, BUCKETS, directory=directory,
                             poll_s=30.0, device="cpu",
                             quality_gate=lambda cand, step: next(verdicts))
    try:
        _save_step(directory, model, 1, 0.2,
                   meta={"streaming": True, "event_ts": time.time() - 5.0})
        assert registry.poll_once() is True and registry.version == 1
        snap = telemetry.get().snapshot()
        assert snap["gauges"]["serving.freshness_s"]["value"] >= 4.0
        assert snap["spans"]["serving.freshness"]["count"] == 1
        _save_step(directory, model, 2, 0.3,
                   meta={"streaming": True, "event_ts": time.time()})
        assert registry.poll_once() is False, "gate refused the candidate"
        assert registry.version == 1, "incumbent keeps serving"
        assert _counters()["serving.swap_rejected_regression"] == 1
        assert registry.poll_once() is False, "refusal is remembered"
    finally:
        registry.close()


def test_poll_thread_swaps_and_close_stops_it(tmp_path, jax_model):
    directory = str(tmp_path)
    model = port_model(jax_model)
    registry = ModelRegistry(model, BUCKETS, directory=directory,
                             poll_s=0.02, device="cpu")
    registry.start()
    registry.start()  # idempotent
    try:
        _save_step(directory, model, 9, scale=0.0)
        deadline = time.time() + 10.0
        while registry.version != 9 and time.time() < deadline:
            time.sleep(0.01)
        assert registry.version == 9
    finally:
        registry.close()
    assert registry._thread is None


def test_registry_without_directory_never_swaps(jax_model):
    registry = ModelRegistry(port_model(jax_model), BUCKETS, device="cpu")
    assert registry.poll_once() is False and registry.version == -1
    registry.start()
    registry.close()
