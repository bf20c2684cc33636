"""Mixed precision (``compute_dtype="bfloat16"``) in the port against the JAX
package: ``ops/precision.py cast_floats``, the local loop's recipe (f32
master parameters, gradients and optimizer state; parameters and float
inputs cast inside the loss) and the trainers of the three ported model
slices at bf16 against the JAX trainers at bf16, on the CPU (the kernels'
plain twins; the JAX models run their Pallas kernels in interpret mode).

Trainer tolerances, and why. The kernels' bf16 arithmetic matches the
Pallas kernels' within one bf16 ulp (``tests/test_torch_lstm_grad.py``,
``tests/test_torch_groupnorm.py``), and a first step's LSTM gradients are
equal bit for bit. But bf16 training is chaotic in a way f32 training is
not: the master weights are f32 and are rounded to bf16 again every step,
so an f32-level difference in one update (a bias gradient summed in
another order by torch than by XLA) flips the bf16 rounding of some
weights, and every later step differs by bf16 rounding noise. Torch and
XLA also round some non-kernel bf16 ops at other points (flax's Dense
rounds the product and then the bias add, torch once; XLA evaluates gelu
and softmax op by op in bf16). So each run is held to the JAX trainer at
bf16 within a stated fraction of the JAX trainer's own bf16-vs-f32
distance, the size of bf16's rounding effect on that run:

* the IMDB LSTM (in process and remote): the center's mean difference
  within 0.6 of it (measured 0.14-0.27), the histories within 1.5;
* the tiny ResNet (sync): the center's mean difference within 0.85
  (measured 0.57-0.63), the history within 2;
* the 2-layer flash transformer (AEASGD): within 1.5 of it for both (measured
  0.85-0.98; the transformer's non-kernel ops round apart in the forward
  already, ``tests/test_torch_transformer.py``), and the port's own
  bf16-vs-f32 distance within 0.5x-2x of the JAX one, so the step is shown
  to have run in bf16.

An f32 step would sit at about 1.0 of the distance on the center: the
LSTM and ResNet limits tell the two apart; for the transformer the dtype
checks below and the 0.5x-2x check do.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
from distkeras_tpu.models.resnet import ResNet as JaxResNet
from distkeras_tpu.models.transformer import TransformerLM as JaxLM
from distkeras_tpu.ops.precision import cast_floats as jax_cast_floats
from distkeras_tpu_torch import imdb_lstm, small_transformer_lm
from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.data import DataFrame
from distkeras_tpu_torch.models import resnet
from distkeras_tpu_torch.ops import cast_floats
from distkeras_tpu_torch.ops.kernels import flash_attention as FA
from distkeras_tpu_torch.ops.kernels import groupnorm as G
from distkeras_tpu_torch.ops.kernels import lstm as K
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.optimizers import get_optimizer
from distkeras_tpu_torch.workers import make_local_loop

LSTM = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)
TINY = dict(stage_sizes=(1, 1), base_features=8, num_outputs=10,
            stem_kernel=3, groups=4)
LM = dict(vocab_size=256, num_layers=2, d_model=64, num_heads=2, d_ff=128,
          max_seq_len=64)
LOSS = "sparse_categorical_crossentropy"


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "nested": [rng.normal(size=5).astype(np.float16),
                       (rng.integers(0, 9, 4).astype(np.int32),
                        np.array([True, False]))]}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", None])
def test_cast_floats_matches_jax(dtype):
    """Every float leaf cast, int and bool leaves untouched, the tree's
    shape kept; ``None`` returns the tree itself."""
    tree = _tree()
    jdt = None if dtype is None else getattr(jnp, dtype)
    tdt = None if dtype is None else getattr(torch, dtype)
    ref = jax_cast_floats(jax.tree_util.tree_map(jnp.asarray, tree), jdt)
    ours = {"w": torch.from_numpy(tree["w"]),
            "nested": [torch.from_numpy(tree["nested"][0]),
                       (torch.from_numpy(tree["nested"][1][0]),
                        torch.from_numpy(tree["nested"][1][1]))]}
    got = cast_floats(ours, tdt)
    if dtype is None:
        assert got is ours
    assert isinstance(got["nested"], list)
    assert isinstance(got["nested"][1], tuple)
    for g, r in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        assert str(g.dtype).split(".")[1] == str(r.dtype)
        np.testing.assert_array_equal(
            g.float().numpy() if g.is_floating_point() else g.numpy(),
            np.asarray(r, np.float32 if g.is_floating_point() else None))


def test_local_loop_keeps_master_state_in_float32(monkeypatch):
    """With ``compute_dtype=torch.bfloat16`` the module sees bf16
    parameters and the LSTM kernels' twins bf16 activations, while the
    gradients handed to the optimizer, its state and the updated master
    parameters are all f32; the step's losses are f32."""
    pm = imdb_lstm(**LSTM, device="cpu")
    tx = get_optimizer("adam", 1e-3)
    seen = {"grads": [], "stash": [], "bwd": []}
    real_update = tx.update

    def update(grads, state, params):
        seen["grads"].extend(g.dtype for g in grads.values())
        return real_update(grads, state, params)

    tx = tx._replace(update=update)
    for name, key in (("lstm_fwd_stash_plain", "stash"),
                      ("lstm_bwd_plain", "bwd")):
        real = getattr(K, name)

        def recording(*args, _real=real, _key=key):
            seen[_key].append({a.dtype for a in args})
            return _real(*args)

        monkeypatch.setattr(K, name, recording)
    loop = make_local_loop(pm.module, get_loss(LOSS), tx,
                           compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.integers(0, 50, (2, 4, 6)).astype(np.int32))
    ys = torch.from_numpy(rng.integers(0, 2, (2, 4)).astype(np.int32))
    params = pm.params
    opt = tx.init(params)
    new, opt, _, losses = loop(params, opt, xs, ys)
    assert seen["grads"] and set(seen["grads"]) == {torch.float32}
    assert seen["stash"] == [{torch.bfloat16}] * 2
    assert seen["bwd"] == [{torch.bfloat16}] * 2
    assert all(v.dtype == torch.float32 for v in new.values())
    leaves = [t for t in jax.tree_util.tree_leaves(opt)
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    assert leaves and all(t.dtype == torch.float32 for t in leaves)
    assert losses.dtype == torch.float32
    assert any(not torch.equal(new[k], v) for k, v in params.items())


def test_uint8_inputs_are_divided_in_the_compute_dtype(monkeypatch):
    """uint8 images become ``x / 255`` in bf16 (the JAX loop's
    ``x.astype(compute_dtype) / 255.0``), and f32 images are cast to
    bf16."""
    pm = resnet.tiny_resnet(device="cpu")
    seen = []
    real = pm.module.forward

    def forward(x):
        seen.append(x)
        return real(x)

    monkeypatch.setattr(pm.module, "forward", forward)
    tx = get_optimizer("sgd", 0.1)
    loop = make_local_loop(pm.module, get_loss(LOSS), tx,
                           compute_dtype=torch.bfloat16)
    raw = np.random.default_rng(0).integers(0, 256, (1, 2, 32, 32, 3))
    ys = torch.zeros((1, 2), dtype=torch.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loop(pm.params, tx.init(pm.params),
             torch.from_numpy(raw.astype(np.uint8)), ys)
    loop(pm.params, tx.init(pm.params),
         torch.from_numpy(raw.astype(np.float32)), ys)
    ref = np.asarray(jnp.asarray(raw[0], jnp.uint8).astype(jnp.bfloat16)
                     / 255.0)
    assert seen[0].dtype == torch.bfloat16 and seen[1].dtype == torch.bfloat16
    np.testing.assert_array_equal(seen[0].float().numpy(),
                                  ref.astype(np.float32))


@pytest.mark.parametrize("value,expected", [
    ("bfloat16", torch.bfloat16), (torch.bfloat16, torch.bfloat16),
    ("float32", torch.float32), (None, None)])
def test_trainers_take_compute_dtype(value, expected):
    pm = imdb_lstm(**LSTM, device="cpu")
    for cls in (T.DynSGD, T.ADAG, T.DOWNPOUR, T.AEASGD, T.EAMSGD,
                T.SingleTrainer, T.SynchronousDistributedTrainer):
        assert cls(pm, compute_dtype=value).compute_dtype == expected


def test_trainers_refuse_what_is_not_a_float_dtype():
    pm = imdb_lstm(**LSTM, device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        T.DynSGD(pm, compute_dtype="bf16")
    with pytest.raises(TypeError, match="compute_dtype"):
        T.SingleTrainer(pm, compute_dtype=torch.int8)


def _center_mean(a: dict, b: dict) -> float:
    """The mean elementwise distance between two state dicts."""
    d = [(a[k].double() - b[k].double()).abs() for k in b]
    return (sum(x.sum() for x in d) / sum(x.numel() for x in d)).item()


def _distances(port_out, jax_outs, pm, port_hist, jax_hists):
    """(center mean, history max) of port-vs-JAX at bf16, and the same of
    the JAX run at bf16 vs f32."""
    ref16, ref32 = (params_from_jax(
        jax.tree_util.tree_map(np.asarray, o.params), pm.module)
        for o in jax_outs)
    got = port_out.module.state_dict()
    h16, h32 = (np.asarray(h, np.float64) for h in jax_hists)
    return ((_center_mean(got, ref16), _center_mean(ref16, ref32)),
            (np.abs(np.asarray(port_hist) - h16).max(),
             np.abs(h16 - h32).max()))


def _run_jax(make_model, cls, cols, **kw):
    """The JAX trainer at bf16 and at f32 from the same weights."""
    outs, hists = [], []
    for dtype in ("bfloat16", None):
        jm = make_model()
        t = cls(jm, **kw, compute_dtype=dtype)
        outs.append(t.train(JaxDataFrame(cols)))
        hists.append(t.get_history())
    return jm, outs, hists


def _lstm_columns(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"features": rng.integers(0, 50, (n, 6)).astype(np.int32),
            "label": rng.integers(0, 2, n).astype(np.int32)}


@pytest.mark.parametrize("name", ["DynSGD", "ADAG", "AEASGD"])
def test_lstm_trainer_bf16_matches_jax(name):
    """4 workers, window 2, batch 5, 3 rounds of the IMDB LSTM (the JAX
    model's ``cell_impl="pallas"``): 0.6 (center mean) and 1.5 (history)
    of the JAX bf16-vs-f32 distance."""
    kw = dict(worker_optimizer="sgd", loss=LOSS, num_workers=4,
              batch_size=5, communication_window=2, learning_rate=0.1)
    cols = _lstm_columns(4 * 2 * 5 * 3)
    jm, jouts, jhists = _run_jax(
        lambda: jax_imdb_lstm(**LSTM, cell_impl="pallas", seed=1),
        getattr(dk, name), cols, **kw)
    pm = imdb_lstm(**LSTM, device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    pt = getattr(T, name)(pm, **kw, compute_dtype="bfloat16")
    pout = pt.train(DataFrame(cols))
    assert all(v.dtype == torch.float32 for v in pout.params.values())
    (c, c_ref), (h, h_ref) = _distances(pout, jouts, pm, pt.get_history(),
                                        jhists)
    assert 0 < c <= 0.6 * c_ref, (c, c_ref)
    assert h <= 1.5 * h_ref, (h, h_ref)


def test_sync_resnet_bf16_matches_jax():
    """``SynchronousDistributedTrainer`` on the tiny ResNet (the JAX
    model's ``norm_impl="pallas"``), 2 workers, 2 steps a round, 2
    rounds: 0.85 (center mean) and 2 (history) of the JAX bf16-vs-f32
    distance."""
    kw = dict(worker_optimizer="sgd", loss=LOSS, batch_size=4,
              steps_per_program=2, learning_rate=0.1, num_workers=2)
    rng = np.random.default_rng(0)
    n = 2 * 2 * 4 * 2
    cols = {"features": rng.uniform(size=(n, 32, 32, 3)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}
    jm, jouts, jhists = _run_jax(
        lambda: JaxModel.build(JaxResNet(**TINY, norm_impl="pallas"),
                               jnp.zeros((1, 32, 32, 3), jnp.float32),
                               seed=1),
        dk.SynchronousDistributedTrainer, cols, **kw)
    pm = resnet.tiny_resnet(norm_impl="pallas", device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    pt = T.SynchronousDistributedTrainer(pm, **kw, compute_dtype="bfloat16")
    before = G.launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # W > 1 merges the batches
        pout = pt.train(DataFrame(cols))
    assert G.launch_counts() == before  # CPU: the plain twins
    (c, c_ref), (h, h_ref) = _distances(pout, jouts, pm, pt.get_history(),
                                        jhists)
    assert 0 < c <= 0.85 * c_ref, (c, c_ref)
    assert h <= 2.0 * h_ref, (h, h_ref)


@pytest.mark.parametrize("optimizer,lr", [("adam", 1e-4), ("sgd", 0.05)])
def test_aeasgd_transformer_bf16_matches_jax(optimizer, lr):
    """One AEASGD worker on the 2-layer flash transformer (L = 64, window
    2, batch 2, 2 rounds): within 1.5 of the JAX bf16-vs-f32 distance,
    and the port's own bf16-vs-f32 distance on the center within 0.5x-2x
    of the JAX one."""
    kw = dict(num_workers=1, batch_size=2, communication_window=2,
              learning_rate=lr, rho=500.0 if optimizer == "adam" else 1.0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, LM["vocab_size"], (8, 64))
    cols = {"features": toks.astype(np.int32),
            "label": np.roll(toks, -1, 1).astype(np.int32)}
    jm, jouts, jhists = _run_jax(
        lambda: JaxModel.build(JaxLM(**LM, attn_impl="flash", remat=True),
                               jnp.zeros((1, 1), jnp.int32), seed=2),
        dk.AEASGD, cols, worker_optimizer=optimizer, loss=LOSS, **kw)
    pouts = {}
    for dtype in ("bfloat16", None):
        pm = small_transformer_lm(**LM, attn_impl="flash", remat=True,
                                  seq_len=64, device="cpu")
        pm.module.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
        pt = T.AEASGD(pm, optimizer, LOSS, **kw, compute_dtype=dtype)
        before = FA.launch_counts()
        pouts[dtype] = (pt.train(DataFrame(cols)), pt.get_history())
        assert FA.launch_counts() == before  # CPU: the plain twins
    (c, c_ref), (h, h_ref) = _distances(pouts["bfloat16"][0], jouts, pm,
                                        pouts["bfloat16"][1], jhists)
    assert 0 < c <= 1.5 * c_ref, (c, c_ref)
    assert h <= 1.5 * h_ref, (h, h_ref)
    port_design = _center_mean(pouts["bfloat16"][0].module.state_dict(),
                               pouts[None][0].module.state_dict())
    assert 0.5 * c_ref <= port_design <= 2.0 * c_ref, (port_design, c_ref)
