"""The port's transformer LM (``distkeras_tpu_torch/models/transformer.py``)
against the JAX package's, on parameters carried across by
``convert.params_from_jax`` (``DenseGeneral`` head projections flattened
into ``nn.Linear``), on the CPU: 2 layers, d_model 64, 2 heads of 32,
d_ff 128, vocab 256.

Tolerances, and why:

* the dense path: f32 arithmetic in another order through two blocks and
  a 256-wide head, logits within rtol 1e-4, atol 2e-5;
* flash at L = 40 and 64 (the JAX kernel's tile is then the port's 64
  keys or the whole sequence, so both round p against the same running
  max): f32 level where no bf16 rounding flips, so the mean error within
  1e-5 of the mean magnitude, and the largest within 2e-3 (an f32 sum
  order that flips one p's bf16 rounding moves it by 2^-8 of itself);
* flash at L = 128: the JAX kernel's 128-key tile rounds p to bf16
  against another running max than the port's 64-key tile (see
  ``tests/test_torch_flash.py``), so the logits differ at bf16 level:
  within 2e-2;
* the gradients of the LM loss, dense: each within 1e-4 of its largest
  magnitude plus 1e-6 of the largest gradient of the model (the key
  bias's gradient is 0 in exact arithmetic, since a softmax ignores a
  constant added to a row of scores; in f32 it is 1e-9 noise), their mean
  error within 1e-5 of the mean magnitude plus the same floor;
* the gradients, flash: ``ds = bf16(p * (dp - delta))`` rounds a
  difference that cancels at random init (small scores, near-uniform p),
  so an f32 sum order that flips one ds's rounding moves the q and k
  gradients, and through the residual stream every gradient below them,
  at bf16 level. The port is held to the JAX flash gradients within the
  JAX package's own flash-vs-dense distance (the rounding the design puts
  in): the largest error within that distance's largest, the mean within
  half its mean, each plus 1e-3 of the model's largest gradient (the key
  bias's gradient, 0 in exact arithmetic, is all rounding);
* ``remat=True`` recomputes the same CPU arithmetic: the same bits.

At 2 heads of 256 (d_model 512, the CUDA kernels' widest tile), under
flash:

* each layer's attention, the JAX kernel (interpret mode) on the port's own
  q, k, v against the port's output: f32 level, as above (mean within 1e-5
  of the mean magnitude, largest within 2e-3);
* the logits and the loss against the JAX model's: the two models' q, k and
  v projections agree at f32 level (9e-7 of their largest in layer 0), but
  over 40 x 512 elements that moves some bf16 roundings of q, k and v (42
  of 122,880 in layer 0 at L = 40, against 0 to 4 a projection at d_model
  64), and
  each moves scores at bf16 level; layer 1's inputs then differ by 1e-3
  and 4 % of its roundings move. So they are held to a share of the JAX
  model's own flash-vs-dense distance, the rounding the design puts in:
  the logits' mean error within 1/4 of that distance's mean (read 0.14)
  and the largest within 1/2 of its largest (read 0.25-0.31), the loss
  within 1/4 of its loss distance (read 0.064);
* the gradients as at heads of 32 (read at most 0.43 of the limit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.transformer import TransformerLM as JaxLM
from distkeras_tpu.ops.losses import get_loss as jax_get_loss
from distkeras_tpu_torch import small_transformer_lm
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.models import resnet, transformer
from distkeras_tpu_torch.ops.kernels import flash_attention as FA
from distkeras_tpu_torch.ops.losses import get_loss

SMALL = dict(vocab_size=256, num_layers=2, d_model=64, num_heads=2,
             d_ff=128, max_seq_len=256)
#: the same model with 2 heads of 256
HD256 = dict(SMALL, d_model=512)


def _pair(attn_impl, seed=0, cfg=SMALL, **kwargs):
    """The JAX model and the port's, with the JAX weights."""
    jm = JaxModel.build(JaxLM(**cfg, attn_impl=attn_impl, **kwargs),
                        jnp.zeros((1, 1), jnp.int32), seed=seed)
    pm = small_transformer_lm(**cfg, attn_impl=attn_impl, device="cpu",
                              **kwargs)
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return jm, pm


def _tokens(B, L, seed=0):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], (B, L)).astype(np.int32)


@pytest.fixture
def flash_calls(monkeypatch):
    """How many times the flash forward ran (its CPU twin)."""
    calls = []
    real = FA.flash_fwd_plain

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(FA, "flash_fwd_plain", counting)
    return calls


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("L", [40, 128, 200])
def test_logits_match_jax(attn_impl, L, flash_calls):
    jm, pm = _pair(attn_impl)
    x = _tokens(2, L)
    ref = np.asarray(jm.apply(jm.params, jnp.asarray(x)))
    before = FA.launch_counts()
    got = pm.predict(x).numpy()
    assert FA.launch_counts() == before  # CPU: the plain twins
    assert got.shape == (2, L, SMALL["vocab_size"])
    # the JAX model's routing: flash where L % 128 == 0 or L < 128
    routed = attn_impl == "flash" and L != 200
    assert len(flash_calls) == (SMALL["num_layers"] if routed else 0)
    if not routed:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5)
    elif L == 128:
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)
    else:
        err = np.abs(got - ref)
        assert err.mean() <= 1e-5 * np.abs(ref).mean()
        assert err.max() <= 2e-3 * np.abs(ref).max()


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("L", [40, 128])
def test_bf16_logits_match_jax(attn_impl, L, monkeypatch):
    """Parameters cast to bf16 as the mixed-precision step casts them: the
    flash twin gets bf16 q, k, v and the logits come out bf16. The
    kernels' own bf16 arithmetic is held bit-tight in their tests; here
    torch and XLA round the model's other bf16 ops at other points (flax's
    Dense rounds the product and then the bias add, torch's once; XLA
    evaluates gelu and softmax op by op in bf16, torch in f32 inside and
    rounds once), so the two bf16 runs may differ by about as much as
    either differs from f32. Held: port vs JAX at bf16 within 1.5x the
    JAX model's own bf16-vs-f32 distance, and the port's bf16-vs-f32
    distance within 0.5x-2x of the JAX one (the step really ran in
    bf16)."""
    from torch.func import functional_call

    from distkeras_tpu.ops.precision import cast_floats as jax_cast_floats
    from distkeras_tpu_torch.ops.precision import cast_floats

    seen = []
    real = FA.flash_fwd_plain

    def recording(q, k, v, *args, **kwargs):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, *args, **kwargs)

    monkeypatch.setattr(FA, "flash_fwd_plain", recording)
    jm, pm = _pair(attn_impl)
    x = _tokens(2, L)
    out = {}
    for name, jdt, tdt in (("bf16", jnp.bfloat16, torch.bfloat16),
                           ("f32", None, None)):
        ref = jm.module.apply({"params": jax_cast_floats(jm.params, jdt)},
                              jnp.asarray(x))
        with torch.no_grad():
            got = functional_call(pm.module, cast_floats(pm.params, tdt),
                                  (torch.from_numpy(x),))
        out[name] = (np.asarray(ref.astype(jnp.float32)),
                     got.float().numpy(), got.dtype)
    assert out["bf16"][2] == torch.bfloat16
    bf = (torch.bfloat16,) * 3
    assert seen == ([bf] * SMALL["num_layers"] + [(torch.float32,) * 3]
                    * SMALL["num_layers"] if attn_impl == "flash" else [])
    jax_design = np.abs(out["bf16"][0] - out["f32"][0]).max()
    port_design = np.abs(out["bf16"][1] - out["f32"][1]).max()
    err = np.abs(out["bf16"][1] - out["bf16"][0]).max()
    assert err <= 1.5 * jax_design, (err, jax_design)
    assert 0.5 * jax_design <= port_design <= 2.0 * jax_design, (
        port_design, jax_design)


def _port_grads(pm, x, y, params=None):
    module = pm.module
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in (params or pm.params).items()}
    module.train()
    out = functional_call(module, leaves, (torch.from_numpy(x),))
    loss = get_loss("sparse_categorical_crossentropy")(out,
                                                       torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    module.eval()
    return loss.item(), dict(zip(leaves, grads))


def _jax_grads(jm, pm, x, y):
    """The JAX model's LM loss and its gradients as the port's state dict."""
    loss_fn = jax_get_loss("sparse_categorical_crossentropy")

    def jax_loss(params):
        return loss_fn(jm.apply(params, jnp.asarray(x)), jnp.asarray(y))

    loss, tree = jax.value_and_grad(jax_loss)(jm.params)
    return float(loss), params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), pm.module)


def _lm_batch(L, seed=1):
    x = _tokens(2, L, seed=seed)
    return x, np.roll(x, -1, axis=1)


def test_dense_lm_loss_gradients_match_jax():
    jm, pm = _pair("dense", seed=1)
    x, y = _lm_batch(40)
    ref_loss, ref = _jax_grads(jm, pm, x, y)
    loss, grads = _port_grads(pm, x, y)
    assert abs(loss - ref_loss) <= 1e-5
    assert set(grads) == set(ref)
    floor = 1e-6 * max(r.abs().max().item() for r in ref.values())
    for k, g in grads.items():
        r = ref[k]
        d = (g - r).abs()
        assert d.max() <= 1e-4 * r.abs().max() + floor, k
        assert d.mean() <= 1e-5 * r.abs().mean() + floor, k


def test_flash_lm_loss_gradients_match_jax():
    """At L = 64, where the JAX kernel's tile is the port's."""
    _check_flash_lm_loss_gradients(SMALL)


def _check_flash_lm_loss_gradients(cfg, loss_share=None):
    """The LM loss within 1e-5 of the JAX flash model's or, with
    ``loss_share``, within that share of the JAX flash-vs-dense loss
    distance; the gradients within the flash-vs-dense distance."""
    jm, pm = _pair("flash", seed=1, cfg=cfg)
    jm_dense, _ = _pair("dense", seed=1, cfg=cfg)
    x, y = _lm_batch(64)
    ref_loss, ref = _jax_grads(jm, pm, x, y)
    dense_loss, ref_dense = _jax_grads(jm_dense, pm, x, y)
    loss, grads = _port_grads(pm, x, y)
    if loss_share is None:
        assert abs(loss - ref_loss) <= 1e-5
    else:
        assert abs(loss - ref_loss) <= loss_share * abs(dense_loss - ref_loss)
    floor = 1e-3 * max(r.abs().max().item() for r in ref.values())
    for k, g in grads.items():
        d, design = (g - ref[k]).abs(), (ref_dense[k] - ref[k]).abs()
        assert d.max() <= design.max() + floor, k
        assert d.mean() <= 0.5 * design.mean() + floor, k


@pytest.mark.parametrize("L", [40, 64])
def test_flash_logits_match_jax_at_heads_of_256(L, monkeypatch):
    """2 heads of 256 under flash, the weights carried across by
    ``convert.params_from_jax``: every layer takes flash at head dim 256,
    its attention is the JAX kernel's on the same q, k, v at f32 level,
    and the logits are within the shares of the module doc of the JAX
    model's flash-vs-dense distance."""
    from distkeras_tpu.ops.pallas.flash_attention import (
        flash_attention as jax_flash)

    seen = []
    real = FA.flash_fwd_plain

    def recording(q, k, v, *args, **kwargs):
        out = real(q, k, v, *args, **kwargs)
        seen.append((q, k, v, out[0]))
        return out

    monkeypatch.setattr(FA, "flash_fwd_plain", recording)
    jm, pm = _pair("flash", cfg=HD256)
    jm_dense, _ = _pair("dense", cfg=HD256)
    x = _tokens(2, L)
    ref = np.asarray(jm.apply(jm.params, jnp.asarray(x)))
    dense = np.asarray(jm_dense.apply(jm_dense.params, jnp.asarray(x)))
    got = pm.predict(x).numpy()
    assert got.shape == (2, L, HD256["vocab_size"])
    assert [tuple(s[0].shape) for s in seen] == \
        [(2, L, 2, 256)] * HD256["num_layers"]
    for q, k, v, out in seen:
        want = np.asarray(jax_flash(*(jnp.asarray(t.numpy()) for t in
                                      (q, k, v)), block_size=L,
                                    interpret=True))
        err = np.abs(out.numpy() - want)
        assert err.mean() <= 1e-5 * np.abs(want).mean()
        assert err.max() <= 2e-3 * np.abs(want).max()
    err, design = np.abs(got - ref), np.abs(dense - ref)
    assert err.mean() <= 0.25 * design.mean()
    assert err.max() <= 0.5 * design.max()


def test_flash_lm_loss_gradients_match_jax_at_heads_of_256():
    """The LM loss and its gradients at 2 heads of 256, L = 64: the loss
    within 1/4 of the JAX flash-vs-dense loss distance (module doc), the
    gradients as at heads of 32 (``test_flash_lm_loss_gradients_match_jax``):
    within the JAX package's own flash-vs-dense distance."""
    _check_flash_lm_loss_gradients(HD256, loss_share=0.25)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_remat_gives_the_same_gradients_through_functional_call(attn_impl):
    """The training loop's way in: ``functional_call`` with parameters
    that are not the module's own. The checkpointed blocks recompute
    their forward on the parameters they were called with."""
    x = _tokens(2, 64, seed=2)
    y = np.roll(x, -1, axis=1)
    out = []
    for remat in (False, True):
        pm = small_transformer_lm(**SMALL, attn_impl=attn_impl, remat=remat,
                                  seed=3, device="cpu")
        shifted = {k: v + 0.01 for k, v in pm.params.items()}
        out.append(_port_grads(pm, x, y, shifted))
    assert out[0][0] == out[1][0]
    for k, g in out[0][1].items():
        assert torch.equal(g, out[1][1][k]), k


def test_resnet_remat_gives_the_same_gradients_through_functional_call():
    """The same for the ResNet's checkpointed blocks."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(2, 32, 32, 3)).astype(np.float32))
    grads = []
    for remat in (False, True):
        m = resnet.ResNet(stage_sizes=(1, 1), base_features=8,
                          num_outputs=10, stem_kernel=3, groups=4,
                          norm_impl="pallas", remat=remat, seed=3)
        leaves = {k: (v.detach() + 0.01).requires_grad_()
                  for k, v in m.named_parameters()}
        out = functional_call(m, leaves, (x,))
        grads.append(torch.autograd.grad(out.square().sum(),
                                         list(leaves.values())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_state_dict_names_follow_the_flax_tree():
    pm = small_transformer_lm(**SMALL, device="cpu")
    names = set(pm.module.state_dict())
    want = {"tok_embed.weight", "pos_embed.weight", "ln_final.weight",
            "ln_final.bias", "lm_head.weight", "lm_head.bias"}
    for i in range(SMALL["num_layers"]):
        for sub in ("ln_attn", "ln_mlp", "mlp_up", "mlp_down", "attn.query",
                    "attn.key", "attn.value", "attn.out"):
            want |= {f"block_{i}.{sub}.weight", f"block_{i}.{sub}.bias"}
    assert names == want
    jm = JaxModel.build(JaxLM(**SMALL, remat=True),
                        jnp.zeros((1, 1), jnp.int32))
    assert set(params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                               pm.module)) == want
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jm.params))
    assert sum(p.numel() for p in pm.module.parameters()) == n_jax


@pytest.mark.parametrize("attn_impl", ["gather", "ring", "dense", "flash"])
def test_sequence_parallelism_is_refused(attn_impl):
    """A sequence-parallel module builds (``seq_axis``, every attention)
    and, with no ``seq`` axis set, computes the dense logits; the GSPMD
    engine refuses it with the JAX engine's message, as it refuses flash;
    an unknown attention raises."""
    from distkeras_tpu_torch.models.base import Model
    from distkeras_tpu_torch.parallel.gspmd import GSPMDEngine
    from distkeras_tpu_torch.runtime.mesh import hybrid_mesh

    sp = transformer.TransformerLM(**SMALL, seq_axis="seq",
                                   attn_impl=attn_impl)
    dense = transformer.TransformerLM(**SMALL)
    x = torch.from_numpy(_tokens(2, 16, seed=3))
    with torch.no_grad():
        np.testing.assert_allclose(sp(x).numpy(), dense(x).numpy(),
                                   rtol=1e-5, atol=1e-5)
    model = Model.build(sp, np.zeros((1, 16), np.int32), device="cpu")
    with pytest.raises(ValueError, match="SPMDEngine"):
        GSPMDEngine(model, "sgd", "sparse_categorical_crossentropy",
                    hybrid_mesh({"data": 1}))
    with pytest.raises(ValueError, match="attn_impl"):
        transformer.TransformerLM(**SMALL, attn_impl="paged")


def test_dropout_masks_follow_the_generator_and_survive_remat():
    """Train-mode dropout draws from the ``rng=`` generator: the same seed
    gives the same logits and gradients with and without remat, another
    seed other logits; eval mode never drops."""
    x = torch.from_numpy(_tokens(2, 40, seed=4))
    res = []
    for remat, seed in ((False, 7), (True, 7), (False, 8)):
        pm = small_transformer_lm(**SMALL, dropout_rate=0.3, remat=remat,
                                  attn_impl="flash", seed=5, device="cpu")
        pm.module.train()
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in pm.params.items()}
        out = functional_call(pm.module, leaves, (x,),
                              {"rng": torch.Generator().manual_seed(seed)})
        res.append((out.detach(), torch.autograd.grad(
            out.square().mean(), list(leaves.values()))))
    assert torch.equal(res[0][0], res[1][0])
    for a, b in zip(res[0][1], res[1][1]):
        assert torch.equal(a, b)
    assert not torch.equal(res[0][0], res[2][0])
    pm.module.eval()
    assert torch.equal(pm.predict(x.numpy()), pm.predict(x.numpy()))
