"""The port's MoE transformer (``models/moe.py``) against the JAX
package's on the same weights (converted from the JAX draw with
``convert.params_from_jax``), f32 on the CPU.

Compared within rtol = atol = 1e-5 unless a case says otherwise: each
``MoEMLP``'s output and its sown ``aux_loss``, ``expert_fraction`` and
``combine_mass`` for Switch (K = 1) and GShard top-2 (K = 2), the capacity
drop, the LM's logits (dense attention, and flash through the port's
plain twins against the JAX flash kernel in interpret mode) and a
``SingleTrainer`` run.

**Near-ties.** A token whose deciding gap (the smallest difference
between neighbours among its K + 1 largest router probabilities: its
picks and their order hold while none closes) is below ``TIE = 1e-5`` in
the JAX run can
be routed either way by f32 rounding of the router's logits, and one flip
moves whole tokens and every later queue position. The rule: away from
near-ties the port's own picks must equal JAX's; at a near-tie the port
takes JAX's pick (:func:`pin_near_ties`, reading the JAX router's logits
through flax's ``capture_intermediates``), so the rest of the comparison
stays at f32 level. The training run cannot read JAX's logits step by
step, so it asserts that no deciding gap below ``TIE`` occurs in the
port's forwards and fails, naming this rule, if one does. The all-ties
router is held without pinning: there the tie-break itself is tested.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu.models.moe import MoEMLP as JaxMoEMLP
from distkeras_tpu.models.moe import small_moe_lm as jax_small_moe_lm
from distkeras_tpu.ops.losses import collect_aux_loss as jax_collect
from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.convert import params_from_jax, params_to_jax
from distkeras_tpu_torch.data import DataFrame
from distkeras_tpu_torch.models.moe import MoEMLP, small_moe_lm, top_k
from distkeras_tpu_torch.ops.kernels import flash_attention as FA
from distkeras_tpu_torch.ops.losses import collect_aux_loss

TOL = dict(rtol=1e-5, atol=1e-5)
TIE = 1e-5
SMALL = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=2, d_ff=48,
             num_experts=4, max_seq_len=64, seq_len=32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_probs(logits) -> np.ndarray:
    return np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))


def _gaps(probs: np.ndarray, k: int) -> np.ndarray:
    """A token's deciding gap: the smallest difference between neighbours
    among its K + 1 largest probabilities (its picks and their order hold
    while none closes)."""
    s = -np.sort(-probs, axis=-1)
    k1 = min(k + 1, probs.shape[-1])
    return (s[:, :k1 - 1] - s[:, 1:k1]).min(-1) if k1 > 1 else np.full(
        len(probs), np.inf)


def pin_near_ties(moe: MoEMLP, jax_logits) -> dict:
    """Wrap ``moe.route``: the port routes on its own probabilities, its
    picks must equal JAX's wherever the JAX deciding gap is at least
    ``TIE``, and at a near-tie it takes JAX's pick. Returns a dict that
    counts the pinned tokens."""
    probs = _jax_probs(np.asarray(jax_logits).reshape(
        -1, moe.num_experts))
    K = moe.num_selected
    jidx = torch.as_tensor(np.array(jax.lax.top_k(jnp.asarray(probs),
                                                  K)[1]))
    near = torch.as_tensor(_gaps(probs, K) < TIE)
    seen = {"pinned": int(near.sum())}
    own = moe.route

    def route(p):
        _, idx = own(p)
        off = (idx != jidx).any(-1)
        assert not bool((off & ~near).any()), (
            "the port routes a token away from a near-tie differently")
        idx = torch.where(near[:, None], jidx, idx)
        gates = p.gather(-1, idx)
        if K > 1:
            gates = gates / gates.sum(-1, keepdim=True)
        return gates, idx

    moe.route = route
    return seen


def _mlp_pair(K, cf=2.0, seed=0, x=None):
    jmod = JaxMoEMLP(num_experts=4, d_model=8, d_ff=16, capacity_factor=cf,
                     num_selected=K)
    variables = jmod.init(jax.random.key(seed), jnp.asarray(x))
    pmod = MoEMLP(4, 8, 16, capacity_factor=cf, num_selected=K)
    pmod.load_state_dict(params_from_jax(_np(variables["params"]), pmod))
    return jmod, variables, pmod


def _jax_run(jmod, variables, x):
    out, mut = jmod.apply(variables, jnp.asarray(x),
                          mutable=["intermediates"],
                          capture_intermediates=True)
    return np.asarray(out), mut["intermediates"]


def _assert_sown(inter, jinter):
    for k in ("aux_loss", "expert_fraction", "combine_mass"):
        np.testing.assert_allclose(inter[k][0].detach().numpy(),
                                   np.asarray(jinter[k][0]), err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("cf", [2.0, 1.0])
def test_moe_mlp_matches_jax(K, cf):
    """Outputs and the sown values for Switch and top-2, at a capacity
    that holds every token (2.0) and one that drops some (1.0)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 8)).astype(np.float32)
    jmod, variables, pmod = _mlp_pair(K, cf, x=x)
    jout, jinter = _jax_run(jmod, variables, x)
    pin_near_ties(pmod, jinter["router"]["__call__"][0])
    out, inter = pmod(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    _assert_sown(inter, jinter)
    assert variables["params"]["experts"]["up"]["kernel"].shape == (4, 8, 16)
    assert tuple(pmod.experts.up.kernel.shape) == (4, 8, 16)
    assert tuple(pmod.experts.down.kernel.shape) == (4, 16, 8)
    assert pmod.capacity(32) == max(1, int(np.ceil(cf * K * 32 / 4)))
    if cf == 1.0 and K == 2:  # overflow: something was dropped
        assert float(inter["combine_mass"][0].detach()) < 1.0


def test_moe_capacity_drops_overflow():
    """``tests/test_moe.py``'s case: capacity C = 1 per expert, so at most
    2 of 32 token outputs are nonzero, and the same ones as in JAX."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 32, 8)).astype(np.float32)
    jmod = JaxMoEMLP(num_experts=2, d_model=8, d_ff=16, capacity_factor=0.04)
    variables = jmod.init(jax.random.key(0), jnp.asarray(x))
    pmod = MoEMLP(2, 8, 16, capacity_factor=0.04)
    pmod.load_state_dict(params_from_jax(_np(variables["params"]), pmod))
    jout, jinter = _jax_run(jmod, variables, x)
    pin_near_ties(pmod, jinter["router"]["__call__"][0])
    out, _ = pmod(torch.from_numpy(x))
    nonzero = np.abs(out.detach().numpy()).reshape(32, 8).sum(-1) > 1e-6
    assert nonzero.sum() <= 2
    np.testing.assert_array_equal(
        nonzero, np.abs(jout).reshape(32, 8).sum(-1) > 1e-6)
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)


@pytest.mark.parametrize("K", [1, 2])
def test_all_ties_router_picks_the_lower_expert_first(K):
    """A router with zero weights: every probability is 1/E, and
    ``jax.lax.top_k`` picks expert 0 (then 1) for every token. The port's
    own tie-break must do the same (no pinning here); with capacity 1.0
    the queues of experts 0 and 1 overflow the same way."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8)).astype(np.float32)
    jmod, variables, pmod = _mlp_pair(K, cf=1.0, x=x)
    params = jax.tree_util.tree_map(lambda a: a, variables["params"])
    params["router"] = jax.tree_util.tree_map(jnp.zeros_like,
                                              params["router"])
    variables = {"params": params}
    with torch.no_grad():
        pmod.router.weight.zero_()
        pmod.router.bias.zero_()
    jout, jinter = _jax_run(jmod, variables, x)
    out, inter = pmod(torch.from_numpy(x))
    probs = torch.full((16, 4), 0.25)
    assert top_k(probs, K)[1].tolist() == [list(range(K))] * 16
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    _assert_sown(inter, jinter)
    frac = inter["expert_fraction"][0].numpy()
    np.testing.assert_allclose(frac, [1.0 / K] * K + [0.0] * (4 - K))


def test_moe_mlp_bf16_runs_its_experts_in_f32():
    """bf16 parameters and input: the router and the combine's output are
    bf16, the experts f32 (flax's Dense promotes to its float32 input),
    and the output is within two bf16 ulps of the JAX module's."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 8)).astype(np.float32)
    jmod, variables, pmod = _mlp_pair(1, x=x)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                variables["params"])
    out_j, jinter = jmod.apply({"params": jp},
                               jnp.asarray(x, jnp.bfloat16),
                               mutable=["intermediates"],
                               capture_intermediates=True)
    pmod = pmod.to(torch.bfloat16)
    pin_near_ties(pmod, np.asarray(
        jinter["intermediates"]["router"]["__call__"][0], np.float32))
    seen = []
    pmod.experts.up.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    out, _ = pmod(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and seen == [torch.float32]
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(out_j, np.float32), rtol=2 ** -7,
                               atol=2 ** -7)


def _lm_pair(attn_impl, K=1, seed=0):
    jm = jax_small_moe_lm(**SMALL, num_selected=K, attn_impl=attn_impl,
                          seed=seed)
    pm = small_moe_lm(**SMALL, num_selected=K, attn_impl=attn_impl,
                      device="cpu")
    pm.module.load_state_dict(params_from_jax(_np(jm.params), pm.module))
    return jm, pm


def _pin_lm(pm, jinter):
    for name in pm.module.blocks:
        pin_near_ties(getattr(pm.module, name).moe,
                      jinter[name]["moe"]["router"]["__call__"][0])


@pytest.mark.parametrize("K", [1, 2])
def test_moe_lm_forward_matches_jax(K):
    """Dense attention: logits and every layer's sown values; the param
    tree round-trips through ``params_to_jax`` bit for bit."""
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 64, (2, 32)).astype(np.int32)
    jm, pm = _lm_pair("dense", K)
    jout, mut = jm.module.apply({"params": jm.params}, jnp.asarray(tokens),
                                mutable=["intermediates"],
                                capture_intermediates=True)
    _pin_lm(pm, mut["intermediates"])
    out, inter = pm.module(torch.from_numpy(tokens),
                           return_intermediates=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for name in pm.module.blocks:
        _assert_sown(inter["intermediates"][name]["moe"],
                     mut["intermediates"][name]["moe"])
    np.testing.assert_allclose(float(collect_aux_loss(inter).detach()),
                               float(jax_collect(mut)), **TOL)
    assert float(collect_aux_loss({})) == 0.0
    back = params_to_jax(pm.params, pm.module)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_np(jm.params))):
        np.testing.assert_array_equal(a, b)


def test_moe_lm_flash_twin_matches_the_jax_flash_kernel():
    """``attn_impl="flash"``: the port's plain twins (on the CPU) against
    the JAX flash kernel in interpret mode, within a quarter of the JAX
    run's own flash-vs-dense distance (both round q, k, v to bf16 inside
    the kernel) or 1e-5, whichever is larger. The CPU counts no launch."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 64, (2, 32)).astype(np.int32)
    jm, pm = _lm_pair("flash", K=2)
    jdense = jax_small_moe_lm(**SMALL, num_selected=2, seed=0)
    jout, mut = jm.module.apply({"params": jm.params}, jnp.asarray(tokens),
                                mutable=["intermediates"],
                                capture_intermediates=True)
    ref_dense = np.asarray(jdense.predict(jnp.asarray(tokens)))
    _pin_lm(pm, mut["intermediates"])
    before = FA.launch_counts()
    out = pm.module(torch.from_numpy(tokens)).detach().numpy()
    assert FA.launch_counts() == before
    dist = np.abs(np.asarray(jout) - ref_dense).max()
    assert np.abs(out - np.asarray(jout)).max() <= max(dist / 4, 1e-5)


@pytest.mark.parametrize("K,optimizer", [(1, "sgd"), (2, "adam")])
def test_single_trainer_matches_jax(K, optimizer):
    """Four steps under a warmup-cosine schedule on the LM loss: history
    and params within 1e-5, with no near-tie met (the rule in the module
    docstring). Under adam the attention key biases are the exception:
    their gradient is 0 in exact arithmetic (a key bias shifts every score
    of a query alike), so it is rounding noise that adam's normalised step
    turns into moves up to the rate; they are held within twice the
    schedule's summed rates (``tests/test_torch_transformer_train.py``'s
    rule)."""
    from distkeras_tpu_torch.ops.schedules import warmup_cosine_decay_schedule

    import optax

    rng = np.random.default_rng(6)
    feats = rng.integers(0, 64, (16, 32)).astype(np.int32)
    cols = {"features": feats, "label": np.roll(feats, -1, 1)}
    jm, pm = _lm_pair("dense", K)
    peak = 3e-3 if optimizer == "adam" else 0.5
    kw = dict(loss="sparse_categorical_crossentropy", batch_size=4,
              num_epoch=1, steps_per_program=2)
    jt = dk.SingleTrainer(jm, optimizer, learning_rate=optax.
                          warmup_cosine_decay_schedule(0.0, peak, 2, 8),
                          **kw)
    jout = jt.train(JaxDataFrame(cols))
    gaps = []
    for name in pm.module.blocks:
        moe = getattr(pm.module, name).moe
        own = moe.route

        def route(p, own=own, moe=moe):
            gaps.append(float(_gaps(p.detach().numpy(),
                                    moe.num_selected).min()))
            return own(p)

        moe.route = route
    sched = warmup_cosine_decay_schedule(0.0, peak, 2, 8)
    pt = T.SingleTrainer(pm, optimizer, learning_rate=sched, **kw)
    pout = pt.train(DataFrame(cols))
    assert min(gaps) >= TIE, (
        f"a router near-tie (gap {min(gaps):.2e} < {TIE}) was met in "
        "training: the f32 comparison is not defined there (module "
        "docstring)")
    np.testing.assert_allclose(pt.get_history(), jt.get_history(), **TOL)
    noise_bound = 2 * sum(float(sched(n)) for n in range(4))
    ref = params_from_jax(_np(jout.params), pm.module)
    for k, v in ref.items():
        if optimizer == "adam" and k.endswith("attn.key.bias"):
            assert np.abs(pout.params[k].numpy() - v.numpy()).max() \
                <= noise_bound, k
            continue
        np.testing.assert_allclose(pout.params[k].numpy(), v.numpy(),
                                   err_msg=k, **TOL)


def test_model_parallel_options_stay_refused():
    """``seq_axis`` builds, and ``parallel=`` / ``aux_loss_weight`` belong
    to ``ParallelTrainer``: the single trainer refuses the first with the
    JAX package's guidance and does not take the second, as there."""
    from distkeras_tpu_torch.models.moe import MoETransformerLM

    sp = MoETransformerLM(**{k: v for k, v in SMALL.items()
                             if k != "seq_len"}, seq_axis="seq")
    assert sp.seq_axis == "seq"
    pm = small_moe_lm(**SMALL, device="cpu")
    with pytest.raises(ValueError, match="ParallelTrainer"):
        T.SingleTrainer(pm, parallel={"expert": 2})
    with pytest.raises(TypeError, match="aux_loss_weight"):
        T.SingleTrainer(pm, aux_loss_weight=0.01)
    T.ParallelTrainer(pm, parallel={"data": 1}, aux_loss_weight=0.01)


def test_moe_lm_blob_is_the_jax_packages_bytes():
    """The built LM serializes to the JAX package's bytes (spec and
    weights through the generic converter), and a JAX blob loads in the
    port with the same logits."""
    from distkeras_tpu.runtime.serialization import serialize_model as jser
    from distkeras_tpu_torch.runtime.serialization import (
        deserialize_model,
        serialize_model,
    )

    jm, pm = _lm_pair("dense", K=2)
    assert serialize_model(pm) == jser(jm)
    back = deserialize_model(jser(jm), device="cpu")
    tokens = np.random.default_rng(7).integers(0, 64, (1, 32)).astype(
        np.int32)
    torch.testing.assert_close(back.predict(tokens), pm.predict(tokens),
                               rtol=0, atol=0)
