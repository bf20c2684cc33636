"""The reference workflow in the port — transformers, predictors and
evaluators (``distkeras_tpu_torch/data/transformers.py``,
``predictors.py``, ``evaluators.py``) — against the JAX package's, and
``examples/mnist_workflow.py``'s chain as a whole (transform -> train the
MNIST CNN -> predict -> evaluate) on both packages.

Tolerances: ``OneHot``, ``Reshape``, ``LabelIndex`` (with ``classes_``)
and ``Dense`` exact; ``MinMax`` within one float32 ulp (both packages run
the same C++ loop, ``native/loader.cc``, bit-equal on one machine, held
so in ``tests/test_torch_native_loader.py``; the ulp leaves room for a
compiler that contracts it into a fused multiply-add or for
``DKTPU_NO_NATIVE=1`` on one side). On the same converted weights ``ModelPredictor``
within 1e-5 and ``ProbabilityPredictor`` within 1e-6 of the JAX
predictors; ``ClassPredictor`` equal but for rows whose top two JAX logits
lie within 1e-5. ``Accuracy`` and ``F1`` equal to the JAX evaluators;
``Loss`` within 1e-6. The workflow at the CNN's real widths: accuracy and
F1 equal, the loss history and the test loss within 1e-5, under the
example's DOWNPOUR and AEASGD (sgd) and under ADAG with sgd.

ADAG with adam, the example's own trainer, is held on the same chain at
the example's learning rate (0.002) twice. At adam's default ``eps``
(1e-8) accuracy and F1 are equal and the history is held within 1e-4:
adam's update ``m / (sqrt(v) + eps)`` turns the f32 rounding of a gradient
that nearly cancels (both packages take the loss and its gradient from
f32 logits, even under float64, at ``workers.py``'s ``loss_fn`` call) into
a step of up to the learning rate, in a direction set by that rounding.
With ``eps`` 1e-7 the same chain agrees within 1e-5 in history and test
loss (measured 3e-7), as with sgd: the default-eps gap is that amplified
rounding, not a difference in what the two chains compute. The narrow CNN
holds ADAG with adam at 1e-5 in ``tests/test_torch_cnn_trainers.py``.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu import datasets as jax_datasets
from distkeras_tpu import evaluators as JE
from distkeras_tpu import predictors as JP
from distkeras_tpu.data import transformers as JT
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu.models.cnn import mnist_cnn as jax_mnist_cnn
from distkeras_tpu_torch import datasets, evaluators as E, predictors as P
from distkeras_tpu_torch import telemetry, trainers as T
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.data import DataFrame
from distkeras_tpu_torch.data import transformers as TT
from distkeras_tpu_torch.models import mnist_cnn
from distkeras_tpu_torch.ops import optimizers as PO


def _both(cols):
    return JaxDataFrame(dict(cols)), DataFrame(dict(cols))


def _image_cols(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return {"features": rng.uniform(-3, 5, size=(n, 784)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32),
            "name": rng.choice(np.array(["cat", "dog", "ant", "emu"]), n)}


@pytest.mark.parametrize("kw", [
    dict(),
    dict(o_min=-1.0, o_max=2.0),
    dict(i_min=-4.0, i_max=6.0, o_min=0.5, o_max=0.75),
    dict(o_min=0.3, o_max=0.3),            # scale == 0: every row o_min
    dict(i_min=1.0, i_max=1.0),            # a zero input range
], ids=["data-range", "out-range", "given-range", "zero-scale", "zero-range"])
def test_minmax_within_one_ulp_of_jax(kw):
    jdf, pdf = _both(_image_cols())
    ref = JT.MinMaxTransformer(**kw, input_col="features",
                               output_col="x").transform(jdf)["x"]
    got = TT.MinMaxTransformer(**kw, input_col="features",
                               output_col="x").transform(pdf)["x"]
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)


def test_onehot_reshape_labelindex_dense_equal_jax():
    cols = _image_cols()
    cols["ragged"] = np.empty(len(cols["label"]), object)
    for i in range(len(cols["label"])):
        cols["ragged"][i] = [float(i), i / 3.0, -i]
    jdf, pdf = _both(cols)
    pairs = [
        (JT.OneHotTransformer(10, "label", "oh"),
         TT.OneHotTransformer(10, "label", "oh"), "oh"),
        (JT.ReshapeTransformer("features", "img", (28, 28, 1)),
         TT.ReshapeTransformer("features", "img", (28, 28, 1)), "img"),
        (JT.DenseTransformer("ragged", "dense"),
         TT.DenseTransformer("ragged", "dense"), "dense"),
        (JT.DenseTransformer("label", "dense"),
         TT.DenseTransformer("label", "dense"), "dense"),
    ]
    for j, p, col in pairs:
        ref, got = j.transform(jdf)[col], p.transform(pdf)[col]
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    j, p = (JT.LabelIndexTransformer("name", "idx"),
            TT.LabelIndexTransformer("name", "idx"))
    np.testing.assert_array_equal(p.transform(pdf)["idx"],
                                  j.transform(jdf)["idx"])
    np.testing.assert_array_equal(p.classes_, j.classes_)
    with pytest.raises(ValueError, match="out of range"):
        TT.OneHotTransformer(5, "label", "oh").transform(pdf)


@pytest.fixture(scope="module")
def models():
    """The MNIST CNN at its real widths in both packages, on the same
    weights."""
    jm = jax_mnist_cnn(seed=3)
    pm = mnist_cnn(device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return jm, pm


def _images(n, seed=1):
    df = jax_datasets.mnist(n=n, seed=seed)
    return {"img": df["features"], "label": df["label"]}


#: 203 rows: three chunks of 64 and a last one of 11, padded to 64
ROWS, CHUNK = 203, 64


@pytest.mark.filterwarnings("ignore:uint8 features detected")
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_predictors_match_jax(models, dtype):
    """Float images, and uint8 ones, which both packages' predictors
    divide by 255 (``normalize_uint8`` from the model)."""
    jm, pm = models
    cols = _images(ROWS)
    if dtype == "uint8":
        cols["img"] = np.round(cols["img"] * 255).astype(np.uint8)
    jdf, pdf = _both(cols)
    kw = dict(features_col="img", output_col="p", chunk_size=CHUNK)
    telemetry.reset()
    logits = P.ModelPredictor(pm, **kw).predict(pdf)["p"]
    snap = telemetry.get().snapshot()
    assert snap["counters"]["predict.rows"] == ROWS
    assert snap["counters"]["predict.padded_rows"] == -ROWS % CHUNK
    assert snap["spans"]["predict.chunk"]["count"] == -(-ROWS // CHUNK)
    ref = JP.ModelPredictor(jm, **kw).predict(jdf)["p"]
    assert logits.shape == ref.shape == (ROWS, 10)
    assert logits.dtype == ref.dtype
    np.testing.assert_allclose(logits, ref, rtol=0, atol=1e-5)
    probs = P.ProbabilityPredictor(pm, **kw).predict(pdf)["p"]
    np.testing.assert_allclose(
        probs, JP.ProbabilityPredictor(jm, **kw).predict(jdf)["p"], rtol=0,
        atol=1e-6)
    classes = P.ClassPredictor(pm, **kw).predict(pdf)["p"]
    ref_cls = JP.ClassPredictor(jm, **kw).predict(jdf)["p"]
    assert classes.dtype == ref_cls.dtype == np.int32
    top2 = np.sort(ref, axis=-1)[:, -2:]
    close = (top2[:, 1] - top2[:, 0]) <= 1e-5
    np.testing.assert_array_equal(classes[~close], ref_cls[~close])


@pytest.mark.parametrize("cls", ["StreamingPredictor",
                                 "StreamingClassPredictor"])
def test_predict_stream_over_uneven_microbatches_equals_predict(models, cls):
    """Microbatches of 0, 1, 70, 0, 5 and 127 rows (an empty poll first and
    in the middle): one output block per microbatch, in order, equal to
    ``predict`` on the whole frame; the empty polls' blocks have the
    output's tail shape and dtype, as the JAX predictor's do."""
    jm, pm = models
    x = _images(ROWS)["img"]
    sizes = [0, 1, 70, 0, 5, 127]
    cuts = np.cumsum([0] + sizes)
    kw = dict(features_col="img", output_col="p", chunk_size=CHUNK)
    port = getattr(P, cls)(pm, **kw)
    blocks = list(port.predict_stream(x[a:b] for a, b in
                                      zip(cuts[:-1], cuts[1:])))
    whole = port.predict(DataFrame({"img": x}))["p"]
    assert [len(b) for b in blocks] == sizes
    np.testing.assert_array_equal(np.concatenate(blocks), whole)
    ref_empty = getattr(JP, cls)(jm, **kw)._empty_block()
    for b in (blocks[0], blocks[3], getattr(P, cls)(pm, **kw)._empty_block()):
        assert b.shape == ref_empty.shape and b.dtype == ref_empty.dtype


def test_sharded_frames_and_devices_are_refused(models, tmp_path,
                                                monkeypatch):
    """Sharded frames are ported (tests/test_torch_shards.py holds them to
    the JAX package): the predictors and evaluators take a store and give
    its in-RAM values, ``vacuum`` reclaims a superseded column. A forward
    across several devices is ported too
    (tests/test_torch_predict_ranks.py): it is refused only for devices
    that are not there, as every entry point refuses a missing card."""
    from distkeras_tpu_torch.data import ShardedDataFrame, write_shards

    _, pm = models
    cols = _images(ROWS)
    cols["label"] = np.arange(ROWS, dtype=np.int32) % 10
    write_shards(str(tmp_path), cols, 50)
    kw = dict(features_col="img", output_col="p", chunk_size=CHUNK)
    out = P.ModelPredictor(pm, **kw).predict(ShardedDataFrame(str(tmp_path)))
    col = np.concatenate([c["p"] for c in out.iter_column_chunks("p")])
    ram = DataFrame(dict(cols, p=P.ModelPredictor(pm, **kw).predict(
        DataFrame(cols))["p"]))
    np.testing.assert_array_equal(col, ram["p"])
    for ev in (E.AccuracyEvaluator("p"), E.F1Evaluator("p"),
               E.LossEvaluator(prediction_col="p")):
        assert ev.evaluate(out) == pytest.approx(ev.evaluate(ram), abs=1e-6)
    assert P.vacuum(str(tmp_path)) == 0
    P.ModelPredictor(pm, **kw).predict(out)
    assert P.vacuum(str(tmp_path)) == out.store.num_shards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.ModelPredictor(pm, devices=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="num_workers=2 exceeds"):
        P.ModelPredictor(pm, num_workers=2)
    assert P.ModelPredictor(pm, num_workers=1, chunk_size=7).chunk_size == 7


def _eval_cols(seed=0):
    """Labels over classes 0-4, predictions that never say class 3 (and
    say class 5, which no label has)."""
    rng = np.random.default_rng(seed)
    n = 97
    label = rng.integers(0, 5, n).astype(np.int32)
    pred = label.copy()
    flip = rng.random(n) < 0.4
    pred[flip] = rng.integers(0, 6, int(flip.sum()))
    pred[pred == 3] = 5
    logits = rng.normal(size=(n, 6)).astype(np.float32)
    logits[np.arange(n), pred] += 4.0
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {"logits": logits, "probs": probs.astype(np.float32),
            "onehot": np.eye(6, dtype=np.float32)[pred], "int": pred,
            "label": label, "label_onehot": np.eye(6, dtype=np.float32)[label]}


@pytest.mark.parametrize("col", ["logits", "probs", "onehot", "int"])
@pytest.mark.parametrize("label_col", ["label", "label_onehot"])
def test_accuracy_and_f1_equal_jax(col, label_col):
    jdf, pdf = _both(_eval_cols())
    for name in ("AccuracyEvaluator", "F1Evaluator"):
        ref = getattr(JE, name)(col, label_col).evaluate(jdf)
        got = getattr(E, name)(col, label_col).evaluate(pdf)
        assert got == ref, (name, got, ref)
    assert 0 < E.F1Evaluator(col, label_col).evaluate(pdf) < 1


@pytest.mark.parametrize("loss,label_col", [
    ("sparse_categorical_crossentropy", "label"),
    ("categorical_crossentropy", "label_onehot")])
def test_loss_within_1e6_of_jax(loss, label_col):
    jdf, pdf = _both(_eval_cols())
    ref = JE.LossEvaluator(loss, "logits", label_col).evaluate(jdf)
    got = E.LossEvaluator(loss, "logits", label_col).evaluate(pdf)
    assert isinstance(got, float)
    assert abs(got - ref) <= 1e-6, (got, ref)


def _workflow(pkg, n, name, **kw):
    """``examples/mnist_workflow.py``'s chain in one package: mnist ->
    MinMax -> Reshape -> OneHot -> split -> the trainer ``name`` on
    mnist_cnn on "img", shuffled -> ClassPredictor and ModelPredictor ->
    the evaluators. Returns (accuracy, F1, loss, history)."""
    if pkg == "jax":
        ds, tr, pr, ev, build, trainer = (jax_datasets, JT, JP, JE,
                                          lambda: jax_mnist_cnn(seed=4),
                                          getattr(dk, name))
    else:
        ds, tr, pr, ev, trainer = datasets, TT, P, E, getattr(T, name)
        jm = jax_mnist_cnn(seed=4)

        def build():
            pm = mnist_cnn(device="cpu")
            pm.module.load_state_dict(params_from_jax(
                jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
            return pm
    df = ds.mnist(n=n, seed=2)
    df = tr.MinMaxTransformer(0.0, 1.0, input_col="features",
                              output_col="features_norm").transform(df)
    df = tr.ReshapeTransformer("features_norm", "img",
                               (28, 28, 1)).transform(df)
    df = tr.OneHotTransformer(10, input_col="label",
                              output_col="label_one_hot").transform(df)
    train_df, test_df = df.split(0.9, seed=1)
    t = trainer(build(), loss="sparse_categorical_crossentropy",
                features_col="img", label_col="label", batch_size=32,
                num_workers=8, communication_window=2, **kw)
    trained = t.train(train_df, shuffle=True)
    pred = pr.ClassPredictor(trained, features_col="img",
                             output_col="prediction",
                             chunk_size=100).predict(test_df)
    logits = pr.ModelPredictor(trained, features_col="img",
                               output_col="logits",
                               chunk_size=100).predict(test_df)
    return (ev.AccuracyEvaluator("prediction", "label").evaluate(pred),
            ev.F1Evaluator("prediction", "label").evaluate(pred),
            ev.LossEvaluator("sparse_categorical_crossentropy", "logits",
                             "label").evaluate(logits),
            np.asarray(t.get_history()))


WORKFLOW = {
    "AEASGD": dict(worker_optimizer="sgd", learning_rate=0.05, rho=3.0),
    "DOWNPOUR": dict(worker_optimizer="sgd", learning_rate=0.05),
    "ADAG": dict(worker_optimizer="sgd", learning_rate=0.05),
}


@pytest.mark.parametrize("name", sorted(WORKFLOW))
def test_mnist_workflow_matches_jax(name):
    """1,600 rows (1,440 to train: 2 rounds of 8 workers x window 2 x batch
    32, the rest dropped; 160 to test) at the CNN's real widths."""
    acc, f1, loss, hist = _workflow("torch", 1600, name, **WORKFLOW[name])
    ref_acc, ref_f1, ref_loss, ref_hist = _workflow("jax", 1600, name,
                                                    **WORKFLOW[name])
    assert hist.shape == ref_hist.shape == (2,)
    np.testing.assert_allclose(hist, ref_hist, rtol=1e-5, atol=1e-5)
    assert acc == ref_acc and f1 == ref_f1, (acc, ref_acc, f1, ref_f1)
    assert abs(loss - ref_loss) <= 1e-5, (loss, ref_loss)
    assert acc > 0.5  # chance is 0.1; the synthetic classes separate



#: adam's eps -> the limit on the loss history (and on the test loss, where
#: not None). The default eps is the example's own setting; 1e-7 damps the
#: amplifier the module docstring describes.
ADAM_EPS = {1e-8: (1e-4, None), 1e-7: (1e-5, 1e-5)}


@pytest.mark.parametrize("eps", sorted(ADAM_EPS), ids=["eps1e-8", "eps1e-7"])
def test_mnist_workflow_adag_adam_matches_jax(eps):
    """The example's own trainer and learning rate, ADAG with adam at
    0.002, on the same chain at the CNN's real widths. Accuracy and F1
    equal in both cases. At adam's default eps the loss history is held
    within 1e-4 (measured 3.6e-5; the test loss differs by 4.0e-4); with
    eps 1e-7 the history and the test loss within 1e-5 (measured 3.0e-7 and
    1.9e-7), which shows the chains compute the same function and that the
    default-eps gap is rounding, amplified."""
    hist_tol, loss_tol = ADAM_EPS[eps]
    acc, f1, loss, hist = _workflow(
        "torch", 1600, "ADAG", worker_optimizer=PO.adam(0.002, eps=eps))
    ref_acc, ref_f1, ref_loss, ref_hist = _workflow(
        "jax", 1600, "ADAG", worker_optimizer=optax.adam(0.002, eps=eps))
    assert hist.shape == ref_hist.shape == (2,)
    np.testing.assert_allclose(hist, ref_hist, rtol=hist_tol, atol=hist_tol)
    assert acc == ref_acc and f1 == ref_f1, (acc, ref_acc, f1, ref_f1)
    if loss_tol is not None:
        assert abs(loss - ref_loss) <= loss_tol, (loss, ref_loss)
