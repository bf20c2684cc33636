"""Multi-round programs on the step engines: ``ParallelTrainer``'s
``WindowedStepEngine`` (``parallel/runner.py``) under
``rounds_per_program`` > 1 and ``"auto"`` on the CPU, held bit for bit to
its per-round run and to the JAX package's ``ParallelTrainer`` at the
same R within rtol = atol = 1e-5 (the per-round parities' tolerance), on
the tests' small transformer LM (``tests/torch_rank_workers.py``) with
the JAX model's weights: under sgd; under adam only against its own
per-round run (the attention's key bias has an exactly zero gradient,
which adam turns into steps of the learning rate's size from either
package's rounding). Then every step engine and the async x TP
engine in one process, each blocked run equal to its per-round run and
emitting the JAX package's ``dispatch[blocked]`` and ``retire[blocked]``
spans. The layouts across two gloo ranks are
``tests/test_torch_parallel_trainer.py``'s ``rpp1``/``rpp4`` cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import ParallelTrainer as JaxParallelTrainer
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.transformer import TransformerLM as JaxLM
from distkeras_tpu_torch import AEASGD, ParallelTrainer, telemetry
from distkeras_tpu_torch.convert import params_from_jax

import torch_rank_workers as RW

L = RW.LM_CFG["max_seq_len"]
LOSS = "sparse_categorical_crossentropy"
ROWS = 80  # 5 rounds of 2 steps of 8: partial blocks at R = 2 and 4
ADAM = dict(worker_optimizer="adam", learning_rate=3e-3, batch_size=8,
            steps_per_program=2)
SGD = dict(ADAM, worker_optimizer="sgd", learning_rate=0.1)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ref():
    jm = JaxModel.build(JaxLM(**RW.LM_CFG), jnp.zeros((1, L), jnp.int32),
                        seed=1)
    w = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params),
        RW.build_lm().module).items()}
    df = RW.lm_frame(ROWS, 0)
    per = {opt: _port(w, df, 1, kw) for opt, kw in (("sgd", SGD),
                                                     ("adam", ADAM))}
    return {"jm": jm, "w": w, "df": df, "per_round": per}


def _port(w, df, rpp, kw):
    t = ParallelTrainer(RW.build_lm(weights=w), parallel={"data": 1},
                        loss=LOSS, rounds_per_program=rpp, **kw)
    out = t.train(df)
    return t.get_history(), {k: v.detach().clone()
                             for k, v in out.params.items()}


@pytest.mark.parametrize("rpp", [2, 4, "auto"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_parallel_trainer_blocked_matches_jax(ref, opt, rpp):
    kw = SGD if opt == "sgd" else ADAM
    hist, params = _port(ref["w"], ref["df"], rpp, kw)
    per_hist, per_params = ref["per_round"][opt]
    np.testing.assert_array_equal(hist, per_hist)
    for k, v in per_params.items():
        assert torch.equal(params[k], v), k
    if opt == "adam":
        return
    jt = JaxParallelTrainer(ref["jm"], parallel={"data": 1}, loss=LOSS,
                            rounds_per_program=rpp, **SGD)
    jout = jt.train(JaxDataFrame({k: np.asarray(ref["df"][k])
                                  for k in ref["df"].columns}))
    np.testing.assert_allclose(hist, np.asarray(jt.get_history()), **TOL)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jout.params),
                           RW.build_lm().module)
    for k, v in want.items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), err_msg=k,
                                   **TOL)


def _async_tp(w, rpp):
    return AEASGD(RW.build_lm(weights=w), "sgd", LOSS,
                  parallel={"model": 1}, batch_size=8,
                  communication_window=2, learning_rate=0.1,
                  rounds_per_program=rpp)


@pytest.mark.parametrize("engine", ["spmd", "gspmd", "pipeline", "async_tp"])
def test_step_engines_block_and_emit_the_spans(ref, engine):
    runs = []
    for rpp in (1, 2):
        telemetry.reset()
        if engine == "async_tp":
            t = _async_tp(ref["w"], rpp)
        else:
            t = ParallelTrainer(RW.build_lm(weights=ref["w"]),
                                parallel={"data": 1}, strategy=engine,
                                loss=LOSS, rounds_per_program=rpp, **ADAM)
        out = t.train(ref["df"])
        spans = set(telemetry.get().snapshot()["spans"])
        runs.append((t.get_history(), out.params, spans))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    for k, v in runs[0][1].items():
        assert torch.equal(runs[1][1][k], v), k
    assert {"engine_run/dispatch[per-round]",
            "engine_run/retire[per-round]"} <= runs[0][2]
    assert {"engine_run/dispatch[blocked]",
            "engine_run/retire[blocked]"} <= runs[1][2]
