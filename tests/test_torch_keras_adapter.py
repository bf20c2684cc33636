"""The port's Keras adapter (``models/keras_adapter.py``, keras 3 on its
torch backend) against the JAX package's (keras on the JAX backend).

``tests/conftest.py`` pins ``KERAS_BACKEND=jax`` for the test process, and
keras picks its backend once per process, so the port's side runs in a
subprocess with ``KERAS_BACKEND=torch``: it rebuilds the same keras model
from its JSON, sets the same weights, trains it through the port's
trainer on the same rows and writes what came out. The JAX adapter trains
in process. Compared within rtol = atol = 1e-5 (keras's own layers on two
backends: the same formulas, sums in another order): the trained
weights, the carried BatchNorm statistics and the loss history; the
predictions within 1e-5 of the logits' largest magnitude (the reason is at
the assertion); the frozen mode carries no state."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

keras = pytest.importorskip("keras")

import distkeras_tpu as dk  # noqa: E402
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame  # noqa: E402
from distkeras_tpu.models.keras_adapter import from_keras  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
COMMON = dict(loss="sparse_categorical_crossentropy", batch_size=16,
              num_epoch=2, learning_rate=0.05)

#: the port's side: rebuild, load the weights, train, write the results
PORT_SIDE = r'''
import json, sys
import numpy as np
from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.data import DataFrame
from distkeras_tpu_torch.models.keras_adapter import _keras, from_keras
from distkeras_tpu_torch.runtime.serialization import (
    deserialize_model, serialize_model)

keras = _keras()
cfg = json.load(open(sys.argv[1]))
arrays = np.load(sys.argv[2])
km = keras.models.model_from_json(cfg["model_json"])
km.set_weights([arrays[f"w{i}"] for i in range(cfg["num_weights"])])
model = from_keras(km, sample_input=arrays["x"][:1],
                   batchnorm=cfg["batchnorm"], device="cpu")
df = DataFrame({"features": arrays["x"], "label": arrays["y"]})
trainer = getattr(T, cfg["trainer"])(model, **cfg["kw"])
out = trainer.train(df)
back = deserialize_model(serialize_model(out), device="cpu")
res = {f"p{i}": v.numpy() for i, v in enumerate(out.params.values())}
state = out.state
for i, v in enumerate((state or {}).get("keras_state", [])):
    res[f"s{i}"] = v.numpy()
res["history"] = np.asarray(trainer.get_history())
res["pred"] = out.predict(arrays["x"][:16]).numpy()
res["pred_back"] = back.predict(arrays["x"][:16]).numpy()
res["collections"] = np.asarray(list(model.state_collections), dtype=str)
np.savez(sys.argv[3], **res)
'''


def _keras_model():
    return keras.Sequential([
        keras.layers.Input((4,)),
        keras.layers.Dense(16),
        keras.layers.BatchNormalization(momentum=0.8),
        keras.layers.Activation("relu"),
        keras.layers.Dense(3),
    ])


def _rows(n=320, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(3, 4))
    y = rng.integers(0, 3, size=n)
    x = (centers[y] + rng.normal(scale=0.5, size=(n, 4))) * 10.0 + 5.0
    return x.astype(np.float32), y.astype(np.int32)


def _port_run(tmp_path, km, x, y, batchnorm, trainer, kw):
    weights = km.get_weights()
    cfg = {"model_json": km.to_json(), "num_weights": len(weights),
           "batchnorm": batchnorm, "trainer": trainer, "kw": kw}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    np.savez(tmp_path / "in.npz", x=x, y=y,
             **{f"w{i}": w for i, w in enumerate(weights)})
    env = dict(os.environ, KERAS_BACKEND="torch",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-c", PORT_SIDE, str(tmp_path / "cfg.json"),
         str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(tmp_path / "out.npz"))


@pytest.mark.parametrize("batchnorm,trainer,extra", [
    ("freeze", "SingleTrainer", {}),
    ("carry", "SingleTrainer", {}),
    ("carry", "ADAG", {"num_workers": 4, "communication_window": 2}),
])
def test_keras_adapter_matches_jax(tmp_path, batchnorm, trainer, extra):
    x, y = _rows()
    km = _keras_model()
    km(np.zeros((1, 4), np.float32))
    kw = dict(COMMON, **extra)
    got = _port_run(tmp_path, km, x, y, batchnorm, trainer, kw)
    # the JAX side last: "freeze" flips the keras model's BN layers
    model = from_keras(km, sample_input=np.zeros((1, 4), np.float32),
                       batchnorm=batchnorm)
    jt = getattr(dk, trainer)(model, **kw)
    jout = jt.train(JaxDataFrame({"features": x, "label": y}))
    want_cols = ["keras_state"] if batchnorm == "carry" else []
    assert list(got["collections"]) == want_cols
    assert list(model.state_collections) == want_cols
    for i, v in enumerate(jout.params):
        np.testing.assert_allclose(got[f"p{i}"], np.asarray(v),
                                   err_msg=f"param {i}", **TOL)
    if batchnorm == "carry":
        state = jout.state["keras_state"]
        for i, v in enumerate(state):
            np.testing.assert_allclose(got[f"s{i}"], np.asarray(v),
                                       err_msg=f"state {i}", **TOL)
        init = [np.asarray(v) for v in model.state["keras_state"]]
        assert max(np.abs(got[f"s{i}"] - a).max()
                   for i, a in enumerate(init)) > 0.1
    else:
        assert not any(k.startswith("s") for k in got)
    np.testing.assert_allclose(got["history"], np.asarray(jt.get_history()),
                               **TOL)
    # Predictions within 1e-5 of the logits' scale: keras's two backends
    # evaluate the BatchNorm formula in different orders (torch: (x - mean)
    # * inv + offset; jax: x * inv + (offset - mean * inv), fused by XLA),
    # which at these shifted inputs rounds the logits apart by ~1e-6 of
    # their largest magnitude.
    want = np.asarray(jout.predict(x[:16]))
    np.testing.assert_allclose(got["pred"], want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(got["pred_back"], got["pred"])


def test_carry_rejects_stateful_seeds_and_error_mode_rejects_bn(tmp_path):
    """The port refuses what the JAX adapter refuses: a Dropout's integer
    seed under ``carry``, and BatchNorm's updating statistics under the
    default ``error``."""
    code = r'''
import numpy as np
from distkeras_tpu_torch.models.keras_adapter import _keras, from_keras
keras = _keras()
km = keras.Sequential([keras.layers.Input((4,)), keras.layers.Dense(8),
                       keras.layers.BatchNormalization(),
                       keras.layers.Dropout(0.5), keras.layers.Dense(3)])
try:
    from_keras(km, sample_input=np.zeros((1, 4), np.float32),
               batchnorm="carry", device="cpu")
except ValueError as e:
    assert "carry" in str(e), e
else:
    raise SystemExit("carry accepted a seed")
km = keras.Sequential([keras.layers.Input((4,)), keras.layers.Dense(8),
                       keras.layers.BatchNormalization(),
                       keras.layers.Dense(3)])
try:
    from_keras(km, sample_input=np.ones((4, 4), np.float32), device="cpu")
except ValueError as e:
    assert "freeze" in str(e), e
else:
    raise SystemExit("error mode accepted BatchNorm")
print("ok")
'''
    env = dict(os.environ, KERAS_BACKEND="torch",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-3000:]
