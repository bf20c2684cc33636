"""Sequence and tensor parallelism in the port (``parallel/sharding.py``,
``ops/ring_attention.py``, the transformer's ``seq_axis`` and its
tensor-parallel shards, ``ops/collectives.py``'s operators) on a 2-rank
gloo group (``tests/torch_rank_workers.py``), against the JAX package on
the conftest's 8 virtual devices and against the port in one process.

Tolerances, each f32 on the CPU: ring and gather attention and the
sequence-parallel forward within 2e-5 of the JAX ring attention and the
JAX dense model (the JAX test's own bar for ring vs dense is 2e-5, for
the sequence-parallel LM 3e-4); the tensor-parallel forward, gradients
and one training step within 1e-5 of the JAX model and ``GSPMDEngine``;
flash under tensor parallelism, against the port's flash in one process
and the JAX ``SPMDEngine`` with its flash kernel in interpret mode,
within the share of the parameters' move that the flash twin's bf16
rounding flips take (see the test). The JAX ``SPMDEngine`` with a
``model`` axis of more than one device cannot run on this jaxlib (its
key-array sharding fails, ``tests/envcaps.py``), so that run has one
``model`` device: the JAX result is the same function. Exact where the
reference is exact: the shard and gather round trip, and a replicated
parameter's gradient on the two ``model`` ranks (bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from distkeras_tpu.data.batching import make_batches as jax_make_batches
from distkeras_tpu.datasets import synthetic_lm as jax_synthetic_lm
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.moe import MoETransformerLM as JaxMoE
from distkeras_tpu.models.transformer import TransformerLM as JaxLM
from distkeras_tpu.ops.collectives import shard_map
from distkeras_tpu.ops.losses import get_loss as jax_get_loss
from distkeras_tpu.ops.ring_attention import ring_attention as jax_ring
from distkeras_tpu.parallel.gspmd import GSPMDEngine as JaxGSPMD
from distkeras_tpu.parallel.sharding import (
    TRANSFORMER_TP_RULES as JAX_TP_RULES,
    param_path_specs as jax_path_specs,
    param_shardings as jax_shardings,
)
from distkeras_tpu.parallel.spmd import SPMDEngine as JaxSPMD
from distkeras_tpu.runtime.mesh import hybrid_mesh as jax_hybrid
from distkeras_tpu_torch.convert import params_from_jax, params_to_jax
from distkeras_tpu_torch.models.base import Model
from distkeras_tpu_torch.parallel import sharding
from distkeras_tpu_torch.parallel.gspmd import GSPMDEngine
from distkeras_tpu_torch.parallel.spmd import spmd_mesh_for
from distkeras_tpu_torch.runtime.mesh import RankMesh, hybrid_mesh

import torch_rank_workers as RW

L = RW.LM_CFG["max_seq_len"]
TOL = dict(rtol=1e-5, atol=1e-5)
B, H, D = 2, 2, 8  # ring attention blocks: [B, L/2, H, D] a rank


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_lm(**kw):
    return JaxModel.build(JaxLM(**RW.LM_CFG, **kw),
                          jnp.zeros((1, L), jnp.int32), seed=1)


def _weights(jm, kind="lm"):
    module = RW.build_lm(kind).module
    return {k: v.numpy() for k, v in
            params_from_jax(_np(jm.params), module).items()}


def _tokens(n, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, RW.LM_CFG["vocab_size"], (n, L)).astype(np.int64)
    return tok, np.roll(tok, -1, 1)


@pytest.fixture(scope="module")
def ref():
    """The JAX model, its weights in the port's names, and the inputs."""
    jm = _jax_lm()
    jmoe = JaxModel.build(JaxMoE(**RW.MOE_CFG), jnp.zeros((1, L), jnp.int32),
                          seed=1)
    rng = np.random.default_rng(7)
    qkv = {c: rng.normal(size=(B, L, H, D)).astype(np.float32)
           for c in ("q", "k", "v", "dout")}
    tok, tgt = _tokens(4, 2)
    return {"jm": jm, "w": _weights(jm), "wmoe": _weights(jmoe, "moe"),
            "jmoe": jmoe, "qkv": qkv, "tok": tok, "tgt": tgt,
            "frame": jax_synthetic_lm(n=8, vocab_size=64, seq_len=L + 1,
                                      seed=3),
            "logits": rng.normal(size=(6, 64)).astype(np.float32),
            "labels": rng.integers(0, 64, 6).astype(np.int64)}


TRAIN_KW = dict(worker_optimizer="sgd", learning_rate=0.1, batch_size=4,
                steps_per_program=2)


@pytest.fixture(scope="module")
def runs(ref):
    """Every 2-rank case, in one spawn."""
    w, tok, tgt = ref["w"], ref["tok"], ref["tgt"]
    tp = {"data": 1, "model": 2}
    calls = [
        ("shard_roundtrip", dict(parallel=tp, weights=w,
                                 rules=sharding.TRANSFORMER_TP_RULES)),
        ("shard_roundtrip", dict(kind="moe", weights=ref["wmoe"],
                                 parallel={"data": 1, "expert": 2},
                                 rules=sharding.MOE_RULES)),
        ("ring_probe", ref["qkv"]),
        ("lm_forward", dict(parallel={"data": 1, "seq": 2}, tokens=tok,
                            weights=w, model=dict(seq_axis="seq",
                                                  attn_impl="gather"))),
        ("lm_forward", dict(parallel={"data": 1, "seq": 2}, tokens=tok,
                            weights=w, model=dict(seq_axis="seq",
                                                  attn_impl="ring"))),
        ("lm_forward", dict(parallel=tp, tokens=tok, weights=w)),
        ("tp_grads", dict(parallel=tp, tokens=tok, targets=tgt, weights=w)),
        ("parallel_train", dict(parallel=tp, weights=w, rows=8, seed=3,
                                kw=dict(TRAIN_KW, strategy="gspmd"))),
        ("parallel_train", dict(parallel=tp, weights=w, rows=8, seed=3,
                                model=dict(attn_impl="flash"),
                                kw=TRAIN_KW)),
        ("vp_ce", dict(logits=ref["logits"], targets=ref["labels"])),
    ]
    res = RW.spawn("run_calls", 2, (calls,), timeout=200)
    names = ["tp_roundtrip", "moe_roundtrip", "ring", "seq_gather",
             "seq_ring", "tp_forward", "tp_grads", "tp_train", "flash_train",
             "vp_ce"]
    return {n: [r[i] for r in res] for i, n in enumerate(names)}


# -- the rules ----------------------------------------------------------------

def test_tp_rules_cover_transformer_params(ref):
    """Every parameter the JAX rules split, the port's split along the
    same features (``[out, in]`` weights: the JAX kernel's axis moved),
    and nothing else; norms replicated."""
    module = RW.build_lm().module
    specs = sharding.param_path_specs(dict(module.named_parameters()),
                                      sharding.TRANSFORMER_TP_RULES)
    jspecs = jax_path_specs(ref["jm"].params, JAX_TP_RULES)
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, P))[0]
    split = {"/".join(str(getattr(p, "key", p)) for p in path)
             for path, spec in flat if any(a is not None for a in spec)}
    port_split = {k for k, s in specs.items() if any(s)}

    def jax_path(name):
        path = name.replace(".", "/")
        if path.endswith("_embed/weight"):
            return path[:-len("weight")] + "embedding"
        return path[:-len("weight")] + "kernel" if path.endswith(
            "/weight") else path

    assert {jax_path(k) for k in port_split} == split
    assert len(split) == 2 * 10 + 4
    assert specs["block_0.attn.query.weight"] == sharding.Spec("model", None)
    assert specs["block_0.attn.out.weight"] == sharding.Spec(None, "model")
    assert specs["block_0.mlp_down.weight"] == sharding.Spec(None, "model")
    assert specs["tok_embed.weight"] == sharding.Spec(None, "model")
    assert specs["lm_head.weight"] == sharding.Spec("model", None)
    assert specs["block_0.ln_attn.weight"] == sharding.Spec()
    assert specs["block_0.attn.out.bias"] == sharding.Spec()


def test_restrict_spec_degrades_like_the_reference():
    """Axes the grid lacks and ragged dimensions replicate; the attention
    projections split whole heads only."""
    grid = RankMesh(("data", "model"), (1, 4), (0, 1, 2, 3))
    s = sharding.Spec("model", None)
    assert sharding.restrict_spec(s, grid, (8, 3)) == s
    assert sharding.restrict_spec(s, grid, (6, 3)) == sharding.Spec(None, None)
    assert sharding.restrict_spec(sharding.Spec("expert"), grid, (8,)) \
        == sharding.Spec(None)
    # 12 features in 3 heads of 4: 3 heads do not split over 4 ranks
    assert sharding.restrict_spec(s, grid, (12, 3), {0: 4}) == \
        sharding.Spec(None, None)
    assert sharding.restrict_spec(s, grid, (16, 3), {0: 4}) == s
    assert sharding.is_sharded(s, grid)
    assert not sharding.is_sharded(s, RankMesh(("model",), (1,), (0,)))


def test_mirror_tree_specs_follow_the_moments():
    """adam's moments (dicts mirroring the parameters) take the
    parameters' specs, its count the default, as the JAX helper lays out
    an optax state."""
    from distkeras_tpu_torch.ops.optimizers import get_optimizer

    params = dict(RW.build_lm().module.named_parameters())
    like = sharding.param_path_specs(params, sharding.TRANSFORMER_TP_RULES)
    state = get_optimizer("adam", 1e-3).init(
        {k: v.detach() for k, v in params.items()})
    specs = sharding.mirror_tree_specs(state, params, like, "replicated")
    flat = []

    def walk(node):
        if node is like:
            flat.append("like")
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        else:
            flat.append(node)

    walk(specs)
    assert flat.count("like") == 2 and "replicated" in flat


def test_spmd_mesh_for_factors_like_the_reference():
    for n, want in ((8, (2, 2, 2)), (4, (2, 1, 2)), (6, (6, 1, 1)),
                    (1, (1, 1, 1))):
        grid = spmd_mesh_for(n, devices=list(range(n)))
        assert grid.axis_names == ("data", "seq", "model")
        assert grid.sizes == want


def test_layouts_short_of_ranks_raise():
    """A layout whose axes need more ranks than the group has raises the
    reference's message; it does not shrink to one rank."""
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        hybrid_mesh({"data": 1, "model": 2})


def test_shard_gather_roundtrip(runs, ref):
    """``gather_params(shard_params(w))`` is ``w`` bit for bit, and
    ``params_to_jax`` of it the JAX tree; each rank holds half of every
    split tensor."""
    module = RW.build_lm().module
    for r in runs["tp_roundtrip"]:
        for k, v in ref["w"].items():
            np.testing.assert_array_equal(r["back"][k], v, err_msg=k)
        assert r["shapes"]["block_0.attn.query.weight"] == (16, 32)
        assert r["shapes"]["lm_head.weight"] == (32, 32)
        assert r["shapes"]["tok_embed.weight"] == (64, 16)
        back = params_to_jax({k: torch.as_tensor(v)
                              for k, v in r["back"].items()}, module)
        for a, b in zip(jax.tree.leaves(back),
                        jax.tree.leaves(_np(ref["jm"].params))):
            np.testing.assert_array_equal(a, b)


def test_expert_bank_shards_over_the_expert_axis(runs, ref):
    for r in runs["moe_roundtrip"]:
        for k, v in ref["wmoe"].items():
            np.testing.assert_array_equal(r["back"][k], v, err_msg=k)
        assert r["shapes"]["block_0.moe.experts.up.kernel"] == (2, 32, 64)
        assert r["shapes"]["block_0.moe.router.weight"] == (4, 32)


# -- sequence parallelism -----------------------------------------------------

def _jax_ring(qkv):
    mesh = jax_hybrid({"seq": 2})
    spec = P(None, "seq")
    fn = shard_map(lambda q, k, v: jax_ring(q, k, v, axis_name="seq"),
                   mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
                   check_vma=False)
    q, k, v = (jnp.asarray(qkv[c]) for c in "qkv")
    out, vjp = jax.vjp(fn, q, k, v)
    return np.asarray(out), [np.asarray(g) for g in
                             vjp(jnp.asarray(qkv["dout"]))]


@pytest.mark.parametrize("how", ["ring", "gather"])
def test_ring_and_gather_attention_match_jax_ring(runs, ref, how):
    """The blocks of the output and of dq, dk, dv against the JAX
    ``ring_attention`` on a ``seq`` mesh of 2 (``jax.vjp`` through its
    ``ppermute``\\ s)."""
    out, grads = _jax_ring(ref["qkv"])
    n = L // 2
    for r in runs["ring"]:
        sl = slice(r["index"] * n, (r["index"] + 1) * n)
        got = r[how]
        np.testing.assert_allclose(got["out"], out[:, sl], rtol=2e-5,
                                   atol=2e-5)
        for name, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(got[name], g[:, sl], rtol=2e-5,
                                       atol=2e-5, err_msg=name)


@pytest.mark.parametrize("impl", ["gather", "ring"])
def test_seq_parallel_forward_matches_dense(runs, ref, impl):
    """The sequence-parallel LM's blocks of logits against the JAX dense
    model's on the whole sequence."""
    expect = np.asarray(ref["jm"].predict(jnp.asarray(ref["tok"])))
    n = L // 2
    for r in runs[f"seq_{impl}"]:
        s = int(r["coords"]["seq"])
        np.testing.assert_allclose(r["logits"], expect[:, s * n:(s + 1) * n],
                                   rtol=2e-5, atol=2e-5)


# -- tensor parallelism -------------------------------------------------------

def test_tp_forward_matches_gspmd(runs, ref):
    """The logits of the model split over ``model`` (gathered along the
    vocabulary) against the JAX model's under GSPMD on a ``model`` axis of
    2 (``param_shardings``, jit)."""
    jm = ref["jm"]
    mesh = jax_hybrid({"data": 4, "model": 2})
    sharded = jax.device_put(jm.params,
                             jax_shardings(jm.params, mesh, JAX_TP_RULES))
    tok = jax.device_put(jnp.asarray(ref["tok"]),
                         NamedSharding(mesh, P("data")))
    expect = np.asarray(jax.jit(lambda p, t: jm.module.apply(
        {"params": p}, t, train=False))(sharded, tok))
    for r in runs["tp_forward"]:
        np.testing.assert_allclose(r["logits"], expect, **TOL)


def test_tp_gradients_match_one_process_and_replicas_agree(runs, ref):
    """The gradients of the split model, gathered, against ``jax.grad`` of
    the JAX model and against the port in one process, within 1e-5; a
    replicated parameter's gradient is bit-equal on both ``model`` ranks
    (the conjugate operators give each the whole gradient, not tp times
    it)."""
    jm = ref["jm"]
    loss_fn = jax_get_loss("sparse_categorical_crossentropy")

    def loss_of(p):
        out = jm.module.apply({"params": p}, jnp.asarray(ref["tok"]),
                              train=True)
        return loss_fn(out.astype(jnp.float32), jnp.asarray(ref["tgt"]))

    jloss, jg = jax.value_and_grad(loss_of)(jm.params)
    module = RW.build_lm().module
    expect = {k: v.numpy() for k, v in
              params_from_jax(_np(jg), module).items()}
    one = RW.tp_grads(dict(parallel={"data": 1}, tokens=ref["tok"],
                           targets=ref["tgt"], weights=ref["w"]))
    r0, r1 = runs["tp_grads"]
    for r in (r0, r1):
        assert abs(r["loss"] - float(jloss)) < 1e-5
        assert abs(r["loss"] - one["loss"]) < 1e-5
        for k in expect:
            np.testing.assert_allclose(r["whole"][k], expect[k], err_msg=k,
                                       **TOL)
            np.testing.assert_allclose(r["whole"][k], one["whole"][k],
                                       err_msg=k, **TOL)
    replicated = [k for k, s in r0["specs"].items() if not any(s)]
    assert len(replicated) == 2 * 6 + 2
    for k in replicated:
        assert np.array_equal(r0["grads"][k], r1["grads"][k]), k


def _jax_steps(engine, frame):
    plan = jax_make_batches(frame, "features", "label", batch_size=4,
                            num_workers=1, window=2)
    xs, ys = plan.round(0)
    state = engine.init_state()
    losses = []
    for k in range(xs.shape[1]):
        state, loss = engine.step(state, jnp.asarray(xs[0, k]),
                                  jnp.asarray(ys[0, k]))
        losses.append(float(loss))
    return jax.device_get(state.params), np.mean(losses)


def test_tp_training_step_matches_gspmd_engine(runs, ref):
    """Two SGD steps of ``ParallelTrainer({"data": 1, "model": 2},
    strategy="gspmd")`` against the JAX ``GSPMDEngine`` on the same mesh
    and batches: the round's loss and every parameter within 1e-5."""
    eng = JaxGSPMD(ref["jm"], "sgd", "sparse_categorical_crossentropy",
                   jax_hybrid({"data": 1, "model": 2}), JAX_TP_RULES,
                   learning_rate=0.1)
    params, loss = _jax_steps(eng, ref["frame"])
    expect = params_from_jax(_np(params), RW.build_lm().module)
    for r in runs["tp_train"]:
        assert r["strategy"] == "gspmd"
        np.testing.assert_allclose(r["history"], [loss], **TOL)
        for k, v in expect.items():
            np.testing.assert_allclose(r["params"][k], v.numpy(), err_msg=k,
                                       **TOL)


def test_flash_under_tp_matches_spmd_engine(runs, ref):
    """``attn_impl="flash"`` routes to the SPMD engine and runs the flash
    kernels on each rank's 2 of the 4 heads (the plain twins on the CPU).
    Two steps against the port's flash in one process and against the JAX
    ``SPMDEngine`` with its flash kernel in interpret mode, each within
    3e-3 of the parameters' largest move and the loss within 1e-4: the
    twin rounds p and ds to bf16, so an f32 difference in its inputs (the
    split projections sum in another order; the JAX kernel is another
    kernel) can flip a rounding, the limit
    ``tests/test_torch_transformer_train.py`` sets for such flips. The
    replicated parameters are bit-equal on both ranks."""
    from distkeras_tpu_torch import ParallelTrainer

    jm = ref["jm"]
    model = JaxModel(module=JaxLM(**RW.LM_CFG, attn_impl="flash"),
                     params=jm.params)
    eng = JaxSPMD(model, "sgd", "sparse_categorical_crossentropy",
                  jax_hybrid({"data": 1, "seq": 1}), JAX_TP_RULES,
                  learning_rate=0.1)
    params, loss = _jax_steps(eng, ref["frame"])
    expect = params_from_jax(_np(params), RW.build_lm().module)
    one = ParallelTrainer(
        RW.build_lm(weights=ref["w"], attn_impl="flash"),
        parallel={"data": 1}, loss="sparse_categorical_crossentropy",
        **TRAIN_KW)
    one_params = one.train(RW.lm_frame(8, 3)).params
    move = max(float(np.abs(v.numpy() - ref["w"][k]).max())
               for k, v in expect.items())
    r0, r1 = runs["flash_train"]
    for r in (r0, r1):
        assert r["strategy"] == "spmd"
        np.testing.assert_allclose(r["history"], one.get_history(),
                                   rtol=1e-4)
        np.testing.assert_allclose(r["history"], [loss], rtol=1e-4)
        for k, v in expect.items():
            for want in (one_params[k].numpy(), v.numpy()):
                np.testing.assert_allclose(r["params"][k], want, rtol=0,
                                           atol=3e-3 * move, err_msg=k)
    for k in ("block_0.ln_attn.weight", "block_1.attn.out.bias",
              "ln_final.bias"):
        assert np.array_equal(r0["params"][k], r1["params"][k]), k


def test_vocab_parallel_cross_entropy_matches_the_plain_loss(runs, ref):
    """The loss over vocabulary-split logits against the plain sparse
    cross-entropy of the whole logits, and each rank's columns of the
    gradient against the plain gradient's."""
    from distkeras_tpu_torch.ops.losses import sparse_categorical_crossentropy

    x = torch.as_tensor(ref["logits"]).requires_grad_(True)
    loss = sparse_categorical_crossentropy(x, torch.as_tensor(ref["labels"]))
    (grad,) = torch.autograd.grad(loss, x)
    n = 32
    for r in runs["vp_ce"]:
        assert abs(r["loss"] - loss.item()) < 1e-6
        np.testing.assert_allclose(
            r["grad"], grad.numpy()[:, r["index"] * n:(r["index"] + 1) * n],
            rtol=1e-6, atol=1e-7)


def test_remat_recomputes_under_the_forward_axes():
    """A checkpointed block whose attention holds half the heads runs its
    recompute under the axes its forward saw, wherever the backward runs
    (on the card, autograd's device thread, where the engine's thread-local
    axes are unset): here the backward runs after the engine's context
    has closed, and gives the gradient of the plain run."""
    from torch.func import functional_call

    from distkeras_tpu_torch.runtime import mesh

    whole = RW.build_lm(remat=True)
    half = {k: (v[:16] if ".attn.query." in k or ".attn.key." in k
                or ".attn.value." in k else
                v[:, :16] if k.endswith("attn.out.weight") else v)
            for k, v in whole.params.items()}
    leaves = {k: v.clone().requires_grad_(True) for k, v in half.items()}
    x = torch.as_tensor(_tokens(2, 5)[0])
    one = mesh.AxisGroup("model", (0,), 0, None)
    whole.module.train()
    with mesh.axis_context({"model": one}):
        out = functional_call(whole.module, leaves, (x,))
    grads = torch.autograd.grad(out.square().mean(), list(leaves.values()))
    plain = RW.build_lm()
    plain.module.train()
    leaves2 = {k: v.clone().requires_grad_(True) for k, v in half.items()}
    with mesh.axis_context({"model": one}):
        out2 = functional_call(plain.module, leaves2, (x,))
        grads2 = torch.autograd.grad(out2.square().mean(),
                                     list(leaves2.values()))
    for a, b in zip(grads, grads2):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_gspmd_engine_rejects_flash_and_seq_axis_at_init():
    """The JAX engine's construction-time refusals, with its pointer to
    SPMDEngine (the port runs both under its SPMD engine)."""
    grid = hybrid_mesh({"data": 1})
    flash = RW.build_lm(attn_impl="flash")
    with pytest.raises(ValueError, match="SPMDEngine"):
        GSPMDEngine(flash, "sgd", "sparse_categorical_crossentropy", grid,
                    sharding.TRANSFORMER_TP_RULES)
    ringy = RW.build_lm(seq_axis="seq", attn_impl="ring")
    with pytest.raises(ValueError, match="SPMDEngine"):
        GSPMDEngine(ringy, "sgd", "sparse_categorical_crossentropy", grid,
                    sharding.TRANSFORMER_TP_RULES)
    assert isinstance(flash, Model)
