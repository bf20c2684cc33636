"""Pipeline parallelism in the port (``parallel/pipeline.py``,
``parallel/pipeline_engine.py``) on gloo groups of spawned ranks
(``tests/torch_rank_workers.py``): the GPipe schedule on 2 stages, the
stage split of the parameters, and ``PipelineEngine`` on a
``{"data": 2, "pipe": 2}`` grid (4 ranks) against the JAX
``PipelineEngine`` on the conftest's virtual devices.

Tolerances, f32 on the CPU: the schedule's outputs and gradients within
1e-6 of the sequential composition; the split and merge exact, as the
JAX test holds them; the pipelined forward within 2e-5 of the JAX
engine's (the JAX test's own bar against its dense model is 2e-4); two
adam steps within 1e-5, except where adam's normalised step turns a
rounding-noise gradient into a step of about ``lr`` of either sign: the
attention key's bias, whose gradient is zero in exact arithmetic (the
rule of ``tests/test_torch_moe.py``), within ``2 * lr`` a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.transformer import TransformerLM as JaxLM
from distkeras_tpu.parallel.pipeline_engine import (
    PipelineEngine as JaxPipelineEngine,
    merge_transformer_params as jax_merge,
    split_transformer_params as jax_split,
)
from distkeras_tpu.runtime.mesh import hybrid_mesh as jax_hybrid
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.parallel.pipeline_engine import (
    PipelineEngine,
    merge_transformer_params,
    split_transformer_params,
)
from distkeras_tpu_torch.runtime.mesh import hybrid_mesh

import torch_rank_workers as RW

L = RW.LM_CFG["max_seq_len"]
LR = 3e-3
S, M, Dg = 2, 4, 8  # the affine schedule: stages, microbatches, width


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    jm = JaxModel.build(JaxLM(**RW.LM_CFG), jnp.zeros((1, L), jnp.int32),
                        seed=1)
    module = RW.build_lm().module
    w = {k: v.numpy() for k, v in
         params_from_jax(_np(jm.params), module).items()}
    rng = np.random.default_rng(4)
    tok = rng.integers(0, 64, (4, L)).astype(np.int64)
    batches = []
    for _ in range(2):
        x = rng.integers(0, 64, (4, L)).astype(np.int64)
        batches.append((x, np.roll(x, -1, 1)))
    affine = {"w": rng.uniform(0.5, 1.5, (S, Dg)).astype(np.float32),
              "b": rng.normal(size=(S, Dg)).astype(np.float32),
              "x": rng.normal(size=(M, 3, Dg)).astype(np.float32),
              "dout": rng.normal(size=(M, 3, Dg)).astype(np.float32)}
    return {"jm": jm, "w": w, "tok": tok, "batches": batches,
            "affine": affine}


@pytest.fixture(scope="module")
def gpipe_runs(ref):
    return RW.spawn("gpipe_probe", S, (ref["affine"],), timeout=120)


@pytest.fixture(scope="module")
def pipe_runs(ref):
    case = dict(parallel={"data": 2, "pipe": 2}, weights=ref["w"],
                tokens=ref["tok"], batches=ref["batches"], micro=2,
                optimizer="adam", lr=LR)
    return RW.spawn("pipe_steps", 4, (case,), timeout=200)


def test_gpipe_matches_sequential(gpipe_runs, ref):
    """Two affine stages, 4 microbatches: the last stage's outputs (on
    every stage after the broadcast) are the sequential composition."""
    a = ref["affine"]
    expect = a["x"]
    for s in range(S):
        expect = expect * a["w"][s] + a["b"][s]
    for r in gpipe_runs:
        np.testing.assert_allclose(r["y"], expect, rtol=1e-6, atol=1e-6)


def test_gpipe_gradients_match_sequential(gpipe_runs, ref):
    """Each stage's parameter gradients, and stage 0's input gradient,
    through the reverse shifts, against autograd of the sequential
    composition in one process."""
    a = ref["affine"]
    w = torch.as_tensor(a["w"]).requires_grad_(True)
    b = torch.as_tensor(a["b"]).requires_grad_(True)
    x = torch.as_tensor(a["x"]).requires_grad_(True)
    y = x
    for s in range(S):
        y = y * w[s] + b[s]
    gw, gb, gx = torch.autograd.grad((y * torch.as_tensor(a["dout"])).sum(),
                                     (w, b, x))
    for r in gpipe_runs:
        s = r["stage"]
        np.testing.assert_allclose(r["gw"], gw[s].numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(r["gb"], gb[s].numpy(), rtol=1e-6,
                                   atol=1e-6)
        if s == 0:
            np.testing.assert_allclose(r["gx"], gx.numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_split_merge_roundtrip(ref):
    """``merge(split(p))`` is ``p`` bit for bit (4 layers over 2 stages);
    each stacked tensor is ``[S, N/S, ...]`` in block order, as the JAX
    split stacks its blocks."""
    jm = JaxModel.build(JaxLM(**dict(RW.LM_CFG, num_layers=4)),
                        jnp.zeros((1, L), jnp.int32), seed=2)
    module = RW.build_lm(num_layers=4).module
    p = params_from_jax(_np(jm.params), module)
    rep, stacked = split_transformer_params(p, 2)
    assert stacked["attn.query.weight"].shape == (2, 2, 32, 32)
    assert set(rep) == {"tok_embed.weight", "pos_embed.weight",
                        "ln_final.weight", "ln_final.bias", "lm_head.weight",
                        "lm_head.bias"}
    merged = merge_transformer_params(rep, stacked)
    assert list(sorted(merged)) == list(sorted(p))
    for k, v in p.items():
        assert torch.equal(merged[k], v), k
    jrep, jstacked = jax_split(jm.params, 2)
    np.testing.assert_array_equal(
        np.asarray(jstacked["mlp_up"]["kernel"][1, 0]),
        stacked["mlp_up.weight"][1, 0].numpy().T)
    back = params_from_jax(_np(jax_merge(jrep, jstacked)), module)
    for k, v in back.items():
        assert torch.equal(merged[k], v), k
    with pytest.raises(ValueError, match="not divisible"):
        split_transformer_params(p, 3)


def _jax_engine(ref):
    return JaxPipelineEngine(ref["jm"], "adam",
                             "sparse_categorical_crossentropy",
                             jax_hybrid({"data": 2, "pipe": 2}),
                             num_microbatches=2, learning_rate=LR)


def test_pipeline_forward_matches_jax_engine(pipe_runs, ref):
    """The pipelined logits of 4 sequences on ``{"data": 2, "pipe": 2}``
    (each data rank its 2 rows, 2 microbatches) against the JAX engine's
    ``_forward`` and its dense model."""
    from distkeras_tpu.ops.collectives import shard_map
    from distkeras_tpu.parallel.pipeline import last_stage_broadcast
    from jax.sharding import PartitionSpec as P

    eng = _jax_engine(ref)
    rep, stage = jax_split(ref["jm"].params, eng.num_stages)
    logits = shard_map(
        lambda r, s, t: last_stage_broadcast(
            eng._forward(r, s, t, jax.random.key(0)), "pipe"),
        mesh=eng.mesh, in_specs=(P(), P("pipe"), P("data")),
        out_specs=P("data"), check_vma=False)(rep, stage,
                                              jnp.asarray(ref["tok"]))
    logits = np.asarray(logits)
    dense = np.asarray(ref["jm"].predict(jnp.asarray(ref["tok"])))
    for r in pipe_runs:
        d = int(r["coords"]["data"])
        np.testing.assert_allclose(r["logits"], logits[2 * d:2 * d + 2],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["logits"], dense[2 * d:2 * d + 2],
                                   rtol=2e-4, atol=2e-4)


def test_pipeline_training_matches_jax_engine(pipe_runs, ref):
    """Two adam steps of the port's ``PipelineEngine`` on the 2 x 2 grid
    against the JAX engine's on the same batches: the losses and every
    merged parameter (the stage-sharded adam moments updated on their own
    stage), on every rank."""
    eng = _jax_engine(ref)
    state = eng.init_state()
    losses = []
    for x, y in ref["batches"]:
        state, loss = eng.step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    expect = params_from_jax(_np(eng.export_params(state)),
                             RW.build_lm().module)
    for r in pipe_runs:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        for k, v in expect.items():
            atol = 2 * LR * 2 if k.endswith("attn.key.bias") else 1e-5
            np.testing.assert_allclose(r["params"][k], v.numpy(), rtol=1e-5,
                                       atol=atol, err_msg=k)


def test_pipeline_engine_refusals():
    """A non-transformer model raises, as in the JAX engine, and so does
    a batch the microbatches do not divide."""
    from distkeras_tpu_torch.models import MLP, Model

    mlp = Model.build(MLP(hidden=(8,), num_outputs=2),
                      np.zeros((1, 4), np.float32), device="cpu")
    grid = hybrid_mesh({"data": 1, "pipe": 1})
    with pytest.raises(TypeError, match="TransformerLM"):
        PipelineEngine(mlp, "sgd", "sparse_categorical_crossentropy", grid)
    eng = PipelineEngine(RW.build_lm(), "sgd",
                         "sparse_categorical_crossentropy", grid,
                         num_microbatches=4)
    x = torch.zeros((3, L), dtype=torch.long)
    with pytest.raises(ValueError, match="num_microbatches"):
        eng.step(eng.init_state(), x, x)
