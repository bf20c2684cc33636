"""``ParallelTrainer`` (alias ``TransformerTrainer``) in the port on gloo
groups of spawned ranks (``tests/torch_rank_workers.py``), mirroring
``tests/test_parallel_trainer.py``: strategy resolution, the ``seq_axis``
rebind, the three routes with the run harness (metrics, checkpoint and
resume, ``rounds_per_program``), the MoE LM with its router loss under
expert parallelism, the rank-major plan merge and a sharded store read
per ``data`` rank.

Tolerances, f32 on the CPU: a resumed run equals the uninterrupted one
within rtol 1e-6 / atol 1e-7 (the JAX test's bar) on the layout it was
written under, and within 1e-5 on another (the rounds before the save ran
on other shards, which sum in another order); the routes against the JAX
trainer and engines within 1e-5 (sgd, so no adam step turns rounding
noise into a step). The MoE runs hold the JAX engines' semantics: under
``GSPMDEngine`` the capacity, the queue positions and the router loss
are over the global batch, under ``SPMDEngine`` over each ``data``
rank's rows, and the two differ.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distkeras_tpu import ParallelTrainer as JaxParallelTrainer
from distkeras_tpu.data.batching import make_batches as jax_make_batches
from distkeras_tpu.datasets import synthetic_lm as jax_synthetic_lm
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.moe import MoETransformerLM as JaxMoE
from distkeras_tpu.models.transformer import TransformerLM as JaxLM
from distkeras_tpu.parallel.gspmd import GSPMDEngine as JaxGSPMD
from distkeras_tpu.parallel.sharding import MOE_RULES as JAX_MOE_RULES
from distkeras_tpu.parallel.spmd import SPMDEngine as JaxSPMD
from distkeras_tpu.runtime.mesh import hybrid_mesh as jax_hybrid
from distkeras_tpu_torch import ParallelTrainer, TransformerTrainer
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.data.shards import write_shards
from distkeras_tpu_torch.parallel.runner import merge_rank_major

import torch_rank_workers as RW

L = RW.LM_CFG["max_seq_len"]
ROWS = 128
SGD = dict(worker_optimizer="sgd", learning_rate=0.1, batch_size=16,
           steps_per_program=2)
ADAM = dict(worker_optimizer="adam", learning_rate=3e-3, batch_size=16,
            steps_per_program=2)
MOE_KW = dict(worker_optimizer="sgd", learning_rate=0.1, batch_size=8,
              steps_per_program=2, aux_loss_weight=0.01)
TOL = dict(rtol=1e-5, atol=1e-5)
EXACT = dict(rtol=1e-6, atol=1e-7)
LAYOUTS = {"gspmd": {"data": 1, "model": 2},
           "pipeline": {"data": 1, "pipe": 2},
           "spmd": {"data": 1, "seq": 2}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _weights(jm, kind="lm"):
    module = RW.build_lm(kind).module
    return {k: v.numpy() for k, v in
            params_from_jax(_np(jm.params), module).items()}


@pytest.fixture(scope="module")
def ref():
    jm = JaxModel.build(JaxLM(**RW.LM_CFG), jnp.zeros((1, L), jnp.int32),
                        seed=1)
    jmoe = JaxModel.build(JaxMoE(**RW.MOE_CFG), jnp.zeros((1, L), jnp.int32),
                          seed=1)
    return {"jm": jm, "jmoe": jmoe, "w": _weights(jm),
            "wmoe": _weights(jmoe, "moe")}


def _case(parallel, w, kw=SGD, **extra):
    return dict(parallel=parallel, weights=w, rows=ROWS, kw=dict(kw),
                **extra)


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """Every 2-rank case, in one spawn."""
    tmp = tmp_path_factory.mktemp("ptrainer")
    w = ref["w"]
    calls, names = [], []

    def add(name, fn, case):
        names.append(name)
        calls.append((fn, case))

    add("metrics", "parallel_train", _case(
        {"data": -1, "model": 2}, w,
        dict(ADAM, metrics_path=str(tmp / "m.jsonl"))))
    add("probe_seq", "engine_probe", dict(parallel={"data": 1, "seq": 2}))
    add("probe_seq_inferred", "engine_probe",
        dict(parallel={"data": 1, "model": 1, "seq": -1}))
    add("probe_unit_seq", "engine_probe", dict(
        parallel={"data": -1, "model": 2}, kw={"strategy": "spmd"}))
    add("seq_train", "parallel_train", _case({"data": 1, "seq": 2}, w))
    add("pipe_train", "parallel_train", _case(
        {"data": 1, "pipe": 2}, w, dict(SGD, num_microbatches=2)))
    for lay, par in LAYOUTS.items():
        ck = str(tmp / f"ck_{lay}")
        add(f"clean_{lay}", "parallel_train", _case(par, w))
        add(f"died_{lay}", "parallel_train", _case(
            par, w, dict(SGD, checkpoint_dir=ck, checkpoint_every=2),
            die_at=3))
        add(f"resumed_{lay}", "parallel_train", _case(
            par, w, dict(SGD, checkpoint_dir=ck, checkpoint_every=2,
                         resume=True)))
    ck = str(tmp / "ck_other")
    add("clean_dp", "parallel_train", _case({"data": 2}, w))
    add("died_other", "parallel_train", _case(
        {"data": 1, "model": 2}, w,
        dict(SGD, checkpoint_dir=ck, checkpoint_every=2), die_at=3))
    add("resumed_other", "parallel_train", _case(
        {"data": 2}, w, dict(SGD, checkpoint_dir=ck, checkpoint_every=2,
                             resume=True)))
    add("rpp1", "parallel_train", _case({"data": 1, "model": 2}, w))
    add("rpp4", "parallel_train", _case(
        {"data": 1, "model": 2}, w, dict(SGD, rounds_per_program=4)))
    add("moe_ep", "parallel_train", dict(
        kind="moe", parallel={"data": 1, "expert": 2}, weights=ref["wmoe"],
        rows=16, kw=MOE_KW))
    rng = np.random.default_rng(5)
    xs1 = rng.integers(0, 64, (1, 2, 8, L)).astype(np.int64)
    ys1 = np.roll(xs1, -1, 3)
    xs2 = np.stack([xs1[0, :, 4 * i:4 * i + 4] for i in range(2)])
    ys2 = np.stack([ys1[0, :, 4 * i:4 * i + 4] for i in range(2)])
    add("rank_major", "rank_major_probe", dict(
        parallel={"data": 2}, weights=w,
        plans={"global": (xs1, ys1), "rank_major": (xs2, ys2)}))
    df = RW.lm_frame(ROWS, 0)
    root = tmp / "store"
    write_shards(str(root), {"features": np.asarray(df["features"]),
                             "label": np.asarray(df["label"])},
                 rows_per_shard=32)
    add("store", "parallel_train", _case({"data": 2}, w,
                                         shards=str(root)))
    res = RW.spawn("run_calls", 2, (calls,), timeout=400)
    out = {n: [r[i] for r in res] for i, n in enumerate(names)}
    out["metrics_path"] = tmp / "m.jsonl"
    out["store_root"] = str(root)
    return out


@pytest.fixture(scope="module")
def moe_runs(ref):
    """The 2 x 2 MoE grids, one 4-rank spawn: GSPMD then SPMD."""
    calls = [("parallel_train", dict(
        kind="moe", parallel={"data": 2, "expert": 2}, weights=ref["wmoe"],
        rows=16, kw=dict(MOE_KW, strategy=s))) for s in ("gspmd", "spmd")]
    res = RW.spawn("run_calls", 4, (calls,), timeout=300)
    return {"gspmd": [r[0] for r in res], "spmd": [r[1] for r in res]}


def _trainer(parallel, **kw):
    return ParallelTrainer(RW.build_lm(), parallel=parallel,
                           loss="sparse_categorical_crossentropy",
                           **dict(ADAM, **kw))


def _same(a, b, tol):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


# -- the surface --------------------------------------------------------------

def test_strategy_resolution():
    t = _trainer({"data": 2, "pipe": 4})
    assert t._resolve_strategy() == "pipeline"
    t = _trainer({"data": 2, "seq": 2, "model": 2})
    assert t._resolve_strategy() == "spmd"
    t = _trainer({"data": -1, "model": 2})
    assert t._resolve_strategy() == "gspmd"
    t = _trainer({"data": 2, "expert": 4})
    assert t._resolve_strategy() == "gspmd"
    flash = ParallelTrainer(RW.build_lm(attn_impl="flash"),
                            parallel={"model": 2})
    assert flash._resolve_strategy() == "spmd"
    assert flash.parallel == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="strategy"):
        _trainer({"data": -1}, strategy="nope")
    with pytest.raises(ValueError, match="grad_accum"):
        _trainer({"data": -1}, grad_accum=4)


def test_transformer_trainer_alias():
    assert TransformerTrainer is ParallelTrainer


def test_a_layout_short_of_ranks_raises():
    """In one process a ``model`` axis of 2 has no second rank: the
    reference's error, not a quiet shrink."""
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        _trainer({"data": 1, "model": 2}).train(RW.lm_frame(32))


def test_gspmd_tp_trains_and_logs_metrics(runs):
    """``{"data": -1, "model": 2}`` (data inferred: 1): adam trains, the
    returned model is whole, and rank 0 logs one metrics record a round
    with samples/s per card over the 2 ranks."""
    r0, r1 = runs["metrics"]
    h = r0["history"]
    assert h[-1] < h[0]
    np.testing.assert_array_equal(r0["history"], r1["history"])
    assert r0["params"]["lm_head.weight"].shape == (64, 32)
    lines = [json.loads(l) for l in
             runs["metrics_path"].read_text().splitlines()]
    recs = [l for l in lines if l.get("round") is not None]
    assert len(recs) == len(h)
    assert any(r.get("samples_per_sec_per_chip") for r in recs)


def test_spmd_seq_axis_autobind(runs):
    """A ``seq`` axis rebinds the module with ``seq_axis="seq"`` (global
    positions and causality); the user's model is untouched; the
    sequence-parallel run trains."""
    for r in runs["probe_seq"]:
        assert r["strategy"] == "spmd"
        assert r["seq_axis"] == "seq" and r["user_seq_axis"] is None
    for r in runs["seq_train"]:
        assert r["history"][-1] < r["history"][0]


def test_spmd_inferred_seq_size_still_rebinds(runs):
    """``seq: -1`` resolves against the rank count; the rebind sees the
    resolved size."""
    for r in runs["probe_seq_inferred"]:
        assert r["shape"]["seq"] == 2 and r["seq_axis"] == "seq"


def test_spmd_route_without_seq_axis_gets_unit_seq(runs):
    for r in runs["probe_unit_seq"]:
        assert r["shape"] == {"data": 1, "model": 2, "seq": 1}
        assert r["seq_axis"] is None and r["num_chips"] == 2


@pytest.mark.parametrize("route", ["seq_train", "pipe_train"])
def test_routes_match_the_one_process_run(runs, ref, route):
    """The sequence-parallel and pipelined runs against the port in one
    process (dense attention; the pipeline's own stage blocks) on the same
    frame and schedule, every parameter within 1e-5."""
    kw = dict(SGD, num_microbatches=2) if route == "pipe_train" else SGD
    par = {"data": 1, "pipe": 1} if route == "pipe_train" else {"data": 1}
    one = ParallelTrainer(RW.build_lm(weights=ref["w"]), parallel=par,
                          loss="sparse_categorical_crossentropy", **kw)
    params = {k: v.numpy() for k, v in
              one.train(RW.lm_frame(ROWS, 0)).params.items()}
    for r in runs[route]:
        np.testing.assert_allclose(r["history"], one.get_history(), **TOL)
        _same(r["params"], params, TOL)


def test_pipeline_trainer_matches_jax_trainer(runs, ref):
    """``ParallelTrainer({"data": 1, "pipe": 2}, num_microbatches=2)``
    against the JAX trainer on the same layout and frame."""
    df = jax_synthetic_lm(n=ROWS, vocab_size=64, seq_len=L + 1, seed=0)
    t = JaxParallelTrainer(ref["jm"], parallel={"data": 1, "pipe": 2},
                           loss="sparse_categorical_crossentropy",
                           num_microbatches=2, **SGD)
    trained = t.train(df)
    expect = {k: v.numpy() for k, v in params_from_jax(
        _np(trained.params), RW.build_lm().module).items()}
    for r in runs["pipe_train"]:
        np.testing.assert_allclose(r["history"], t.get_history(), **TOL)
        _same(r["params"], expect, TOL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_checkpoint_resume_equals_uninterrupted(runs, layout):
    """Stopped in round 3 (saves every 2 rounds), resumed: the final model
    equals the uninterrupted run's, and the resumed history is the tail of
    the uninterrupted one."""
    for died in runs[f"died_{layout}"]:
        assert died.get("stopped")
    for clean, resumed in zip(runs[f"clean_{layout}"],
                              runs[f"resumed_{layout}"]):
        _same(resumed["params"], clean["params"], EXACT)
        tail = clean["history"][-len(resumed["history"]):]
        np.testing.assert_allclose(resumed["history"], tail, rtol=1e-5)
        assert len(resumed["history"]) == 2


def test_resume_under_another_layout(runs):
    """A checkpoint written under ``{"data": 1, "model": 2}`` (the shards
    gathered to whole tensors) resumes under ``{"data": 2}``."""
    for clean, resumed in zip(runs["clean_dp"], runs["resumed_other"]):
        _same(resumed["params"], clean["params"], TOL)
        assert len(resumed["history"]) == 2


def test_rounds_per_program_equivalence(runs):
    for a, b in zip(runs["rpp1"], runs["rpp4"]):
        np.testing.assert_array_equal(a["history"], b["history"])
        _same(a["params"], b["params"], dict(rtol=0, atol=0))


def test_rank_major_plan_merges_to_global_batch(runs):
    """A ``[dp, K, B/dp]`` rank-major plan stages each ``data`` rank the
    same rows as the ``[1, K, B]`` global plan, and the round is the
    same."""
    xs = np.arange(2 * 3 * 4).reshape(2, 3, 4)
    np.testing.assert_array_equal(
        merge_rank_major(xs), np.concatenate([xs[0], xs[1]], axis=1))
    for r in runs["rank_major"]:
        g, m = r["global"], r["rank_major"]
        np.testing.assert_array_equal(g["x"], m["x"])
        assert g["x"].shape == (2, 4, L)
        assert g["loss"] == m["loss"]
        _same(g["params"], m["params"], dict(rtol=0, atol=0))


def test_parallel_trainer_from_sharded_store(runs, ref):
    """Two ``data`` ranks train from a sharded store, each staging only
    its rows (one plan worker a rank, merged rank-major): the same run as
    the port in one process on those global batches in order."""
    from distkeras_tpu_torch.data import DataFrame
    from distkeras_tpu_torch.data.batching import make_batches
    from distkeras_tpu_torch.data.shards import ShardedDataFrame

    plan = make_batches(ShardedDataFrame(runs["store_root"]), "features",
                        "label", SGD["batch_size"] // 2, num_workers=2,
                        window=SGD["steps_per_program"])
    cols = {"features": [], "label": []}
    for r in range(plan.num_rounds):
        xs, ys = plan.round(r)
        cols["features"].append(merge_rank_major(xs).reshape(-1, L))
        cols["label"].append(merge_rank_major(ys).reshape(-1, L))
    frame = DataFrame({k: np.concatenate(v) for k, v in cols.items()})
    mem = ParallelTrainer(RW.build_lm(weights=ref["w"]),
                          parallel={"data": 1},
                          loss="sparse_categorical_crossentropy", **SGD)
    params = {k: v.numpy() for k, v in mem.train(frame).params.items()}
    for r in runs["store"]:
        np.testing.assert_allclose(r["history"], mem.get_history(), **TOL)
        _same(r["params"], params, TOL)
        assert r["history"][-1] < r["history"][0]


# -- the MoE LM ---------------------------------------------------------------

def _jax_moe_steps(ref, engine):
    df = jax_synthetic_lm(n=16, vocab_size=64, seq_len=L + 1, seed=0)
    plan = jax_make_batches(df, "features", "label", batch_size=8,
                            num_workers=1, window=2)
    xs, ys = plan.round(0)
    state = engine.init_state()
    losses = []
    for k in range(xs.shape[1]):
        state, loss = engine.step(state, jnp.asarray(xs[0, k]),
                                  jnp.asarray(ys[0, k]))
        losses.append(float(loss))
    params = params_from_jax(_np(jax.device_get(state.params)),
                             RW.build_lm("moe").module)
    return {k: v.numpy() for k, v in params.items()}, np.mean(losses)


def _jax_moe(ref, layout, strategy):
    cls = JaxGSPMD if strategy == "gspmd" else JaxSPMD
    if strategy == "spmd":
        layout = dict(layout, seq=1)
    eng = cls(ref["jmoe"], "sgd", "sparse_categorical_crossentropy",
              jax_hybrid(layout), JAX_MOE_RULES, learning_rate=0.1,
              aux_loss_weight=0.01)
    return _jax_moe_steps(ref, eng)


def test_moe_expert_parallel_with_aux_loss(runs, ref):
    """The MoE LM on ``{"data": 1, "expert": 2}`` (each rank 2 of the 4
    experts) with the router loss at weight 0.01, two sgd steps, against
    the JAX ``GSPMDEngine`` on the same layout."""
    params, loss = _jax_moe(ref, {"data": 1, "expert": 2}, "gspmd")
    r0, r1 = runs["moe_ep"]
    for r in (r0, r1):
        assert r["strategy"] == "gspmd"
        np.testing.assert_allclose(r["history"], [loss], **TOL)
        _same(r["params"], params, TOL)
    assert np.array_equal(r0["params"]["block_0.moe.router.weight"],
                          r1["params"]["block_0.moe.router.weight"])


@pytest.mark.parametrize("strategy", ["gspmd", "spmd"])
def test_moe_capacity_and_router_loss_follow_the_engine(moe_runs, ref,
                                                        strategy):
    """``{"data": 2, "expert": 2}``: under GSPMD the capacity, the queue
    positions and the router loss are the global batch's, under SPMD each
    data rank's; each run against its JAX engine within 1e-5, and the two
    apart."""
    params, loss = _jax_moe(ref, {"data": 2, "expert": 2}, strategy)
    for r in moe_runs[strategy]:
        assert r["strategy"] == strategy
        np.testing.assert_allclose(r["history"], [loss], **TOL)
        _same(r["params"], params, TOL)
    other = moe_runs["spmd" if strategy == "gspmd" else "gspmd"][0]
    assert not np.allclose(other["history"], moe_runs[strategy][0]["history"],
                           rtol=1e-6, atol=0)
