"""The JAX package's last public names in the port, each against its JAX
counterpart: ``Model.num_params`` and ``Model.summary()`` for every model
class both packages register, ``BucketedModel.set_params`` while a batch
is served (no bucket warmed again), ``netps.serve`` round-tripping a
commit, ``Checkpointer.close`` twice, ``tracing.stream_path`` before and
after a write, and ``register_model_class`` / ``get_model_class`` with a
custom class and an unknown name."""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.checkpoint import Checkpointer as JaxCheckpointer
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.cnn import SimpleCNN as JaxSimpleCNN
from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
from distkeras_tpu.models.mlp import mnist_mlp as jax_mnist_mlp
from distkeras_tpu.models.moe import small_moe_lm
from distkeras_tpu.models.resnet import tiny_resnet as jax_tiny_resnet
from distkeras_tpu.models.transformer import small_transformer_lm
from distkeras_tpu.netps import PSClient as JaxPSClient
from distkeras_tpu.netps import serve as jax_serve
from distkeras_tpu.runtime import serialization as jax_serialization
from distkeras_tpu.serving.model import BucketedModel as JaxBucketedModel
from distkeras_tpu import telemetry as jax_telemetry
from distkeras_tpu.telemetry.tracing import clock as jax_clock
from distkeras_tpu.telemetry.tracing import context as jax_context
from distkeras_tpu.telemetry.tracing import recorder as jax_recorder
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.checkpoint import Checkpointer
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.models.base import MODEL_CLASSES
from distkeras_tpu_torch.netps import PSClient, serve
from distkeras_tpu_torch.runtime import serialization
from distkeras_tpu_torch.serving.model import BucketedModel
from distkeras_tpu_torch.telemetry.tracing import clock, context, recorder

FAST = dict(timeout=2.0, retries=3, backoff=0.01)


def _jax_models():
    lm = dict(vocab_size=64, num_layers=2, d_model=16, num_heads=2, d_ff=32,
              max_seq_len=16, seq_len=8)
    lstm = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)
    return {
        "lstm": lambda: jax_imdb_lstm(**lstm, seed=3),
        "mlp": lambda: jax_mnist_mlp(hidden=(16, 12), seed=5),
        "cnn": lambda: JaxModel.build(
            JaxSimpleCNN(conv_features=(4, 8), dense=(16,), num_outputs=10),
            jnp.zeros((1, 28, 28, 1), jnp.float32), seed=6),
        "resnet": lambda: jax_tiny_resnet(seed=7),
        "transformer": lambda: small_transformer_lm(**lm, seed=8),
        "moe": lambda: small_moe_lm(**lm, num_experts=4, seed=9),
    }


def _port_of(jm) -> Model:
    spec = jm.spec()
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    module = MODEL_CLASSES[spec["class"]].from_config(spec["kwargs"],
                                                      params=tree)
    module.load_state_dict(params_from_jax(tree, module))
    return Model(module=module.eval(), device=torch.device("cpu"),
                 sample_spec=None)


def test_every_registered_class_has_a_family():
    """Every class the JAX package registers itself (other tests register
    their own in the same process), but the Keras adapter's, which needs
    keras: the port's is held to it in ``tests/test_torch_keras_adapter.py``."""
    names = {_jax_models()[f]().spec()["class"] for f in _jax_models()}
    assert names >= {n for n, c in jax_serialization.MODEL_REGISTRY.items()
                     if c.__module__.startswith("distkeras_tpu.")
                     and n != "KerasModuleAdapter"}


@pytest.mark.parametrize("family", list(_jax_models()))
def test_num_params_and_summary_match_jax(family):
    jm = _jax_models()[family]()
    pm = _port_of(jm)
    assert pm.num_params == jm.num_params
    got, want = pm.summary().splitlines(), jm.summary().splitlines()
    assert got[0] == want[0]  # "Model: <class>  (<n> params)"
    assert len(got) == 1 + len(pm.params)
    for line, (name, v) in zip(got[1:], pm.params.items()):
        assert line == f"  {name}: {tuple(v.shape)} float32"


def test_set_params_swaps_a_served_model_without_a_rewarm():
    """Each answer of a model being swapped is the old model's or the
    new one's, whole; after the swap the JAX package's ``set_params`` on
    the same new weights answers the same; no shape runs again."""
    old, new = jax_mnist_mlp(hidden=(16,), seed=1), jax_mnist_mlp(
        hidden=(16,), seed=2)
    pm = _port_of(old)
    x = np.random.default_rng(0).normal(size=(3, 784)).astype(np.float32)
    want_old = np.asarray(old.predict(jnp.asarray(x)))
    want_new = np.asarray(new.predict(jnp.asarray(x)))
    bm = BucketedModel(pm, (4,))
    bm.infer([x])  # the bucket's one shape
    compiles = bm.compiles()
    telemetry.reset()
    answers, stop = [], threading.Event()

    def serve_loop():
        while not stop.is_set():
            answers.append(bm.infer([x]))

    t = threading.Thread(target=serve_loop)
    t.start()
    try:
        new_params = _port_of(new).params
        n = len(answers)
        bm.set_params({k: v.numpy() for k, v in new_params.items()})
        deadline = time.monotonic() + 30
        while len(answers) < n + 3 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        t.join()
    for a in answers:
        assert (np.allclose(a, want_old, atol=1e-5)
                or np.allclose(a, want_new, atol=1e-5))
    np.testing.assert_allclose(bm.infer([x]), want_new, atol=1e-5)
    assert bm.compiles() == compiles
    assert telemetry.get().snapshot()["counters"].get(
        "serving.retrace_after_warmup", 0) == 0
    jbm = JaxBucketedModel(old, (4,))
    jbm.set_params(new.params)
    np.testing.assert_allclose(bm.infer([x]), jbm.infer([x]), atol=1e-5)


def test_serve_round_trips_a_commit_as_the_jax_serve_does():
    rng = np.random.default_rng(0)
    init = [rng.normal(size=(3, 2)).astype(np.float32),
            rng.normal(size=(4,)).astype(np.float32)]
    delta = [np.full_like(a, 0.25) for a in init]
    centers = []
    for make, client in ((lambda: serve(init, "adag", device="cpu"),
                          PSClient),
                         (lambda: jax_serve(init, "adag"), JaxPSClient)):
        srv = make()
        try:
            with client(srv.endpoint, worker_id=0, **FAST) as c:
                _, upd = c.join()
                assert c.commit(delta, upd).applied
                centers.append(c.pull()[0])
        finally:
            srv.close()
    for a, b, i in zip(*centers, init):
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, i)


def test_checkpointer_close_twice(tmp_path):
    for cls, sub in ((Checkpointer, "port"), (JaxCheckpointer, "jax")):
        ck = cls(str(tmp_path / sub))
        ck.close()
        ck.close()


def _reset_tracing():
    """The tracing state a span leaves in the process (the stream, the
    flight ring, the clock, the events), in both packages."""
    for tel, ctx, rec, clk in ((telemetry, context, recorder, clock),
                               (jax_telemetry, jax_context, jax_recorder,
                                jax_clock)):
        tel.reset()
        ctx._reset_stream()
        rec._reset()
        clk.reset()


def test_stream_path_before_and_after_a_write(monkeypatch, tmp_path):
    monkeypatch.setenv("DKTPU_TRACE", "1")
    for ctx, sub in ((context, "port"), (jax_context, "jax")):
        monkeypatch.setenv("DKTPU_TRACE_DIR", str(tmp_path / sub))
        _reset_tracing()
        try:
            assert ctx.stream_path() is None
            with ctx.trace_scope("commit"):
                pass
            path = ctx.stream_path()
            assert path is not None and os.path.exists(path)
            assert os.path.dirname(path) == str(tmp_path / sub)
            assert os.path.basename(path).endswith(f"-{os.getpid()}.jsonl")
        finally:
            _reset_tracing()


def test_register_model_class_and_the_unknown_class_error():
    class Custom(torch.nn.Module):
        pass

    serialization.register_model_class("CustomForTest", Custom)
    try:
        assert serialization.get_model_class("CustomForTest") is Custom
        assert MODEL_CLASSES["CustomForTest"] is Custom
        assert serialization.get_model_class("MLP") is MODEL_CLASSES["MLP"]
    finally:
        MODEL_CLASSES.pop("CustomForTest")
    for get in (serialization.get_model_class,
                jax_serialization.get_model_class):
        with pytest.raises(KeyError, match="register_model"):
            get("NoSuchModel")
