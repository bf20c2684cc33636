"""The port's resilience plane (``distkeras_tpu_torch/resilience``) against
the JAX package's: the ``FaultPlan`` grammars, repr, one-shot firing,
``poison_worker`` and the fired-fault journal (a file either package
writes, the other reads); the NaN/Inf round skip, the guard turned off and
the divergent-worker reset on ``ADAG`` (centers within rtol = atol = 1e-5
of the JAX trainer's, counters equal); ``reset_workers``' edge masks; the
feeder's stall watchdog and ``feeder_error`` retry; the ``ckpt_corrupt``
fallback; the ``Supervisor`` after ``crash@R`` (resumed bit-equal to the
port's uninterrupted run, within 1e-5 of the JAX supervised run); and
``kill@R`` in a child process, which the fault journal keeps from firing
again after the restart."""

import os
import signal
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models.mlp import MLP as JaxMLP
from distkeras_tpu.resilience import FaultPlan as JaxFaultPlan
from distkeras_tpu_torch import DataFrame, Supervisor, imdb_lstm, \
    resilience, telemetry
from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.data.prefetch import RoundFeeder
from distkeras_tpu_torch.models import MLP, Model
from distkeras_tpu_torch.parallel.disciplines import ADAGFold
from distkeras_tpu_torch.parallel.engine import AsyncEngine
from distkeras_tpu_torch.resilience import FaultPlan
from distkeras_tpu_torch.resilience.errors import InjectedFault

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIM, C = 1024, 4, 3
#: the JAX package's resilience tests' ADAG config: 4 workers x window 4 x
#: batch 16 over 1024 rows x 3 epochs = 12 fold rounds.
COMMON = dict(loss="sparse_categorical_crossentropy", batch_size=16,
              num_epoch=3, learning_rate=0.1, num_workers=4,
              communication_window=4)
NUM_ROUNDS = 12
ENV = ("DKTPU_FAULTS", "DKTPU_FAULTS_STATE", "DKTPU_NAN_GUARD",
       "DKTPU_FEEDER_TIMEOUT", "DKTPU_FEEDER_WARN", "DKTPU_FEEDER_RETRIES",
       "DKTPU_DIVERGENCE_RESET", "DKTPU_NET_FAULTS")


@pytest.fixture(autouse=True)
def _fault_hygiene(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    resilience.reset()
    dk.resilience.reset()
    yield
    resilience.reset()
    dk.resilience.reset()


def _columns():
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=4.0, size=(C, DIM))
    y = rng.integers(0, C, size=N)
    x = centers[y] + rng.normal(scale=0.5, size=(N, DIM))
    return {"features": x.astype(np.float32), "label": y.astype(np.int32)}


def _jax_model():
    return JaxModel.build(JaxMLP(hidden=(16,), num_outputs=C),
                          jnp.zeros((1, DIM), jnp.float32), seed=0)


def _port_model():
    jm = _jax_model()
    module = MLP(hidden=(16,), num_outputs=C, in_features=DIM)
    module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), module))
    return Model.build(module, np.zeros((1, DIM), np.float32), device="cpu")


def _counter(name):
    return telemetry.get().counter(name).value


def _jax_counter(name):
    return dk.telemetry.get().counter(name).value


def _assert_close(port_model, jax_model):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                  jax_model.params),
                           port_model.module)
    for k, v in want.items():
        np.testing.assert_allclose(port_model.params[k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def _both(monkeypatch, spec=None, **extra):
    """The port's and the JAX package's ADAG on the same data under the
    same ``DKTPU_FAULTS`` (each package's ambient plan fresh)."""
    cols = _columns()
    out = []
    for pkg, model, frame in ((T, _port_model(), DataFrame(cols)),
                              (dk, _jax_model(), dk.DataFrame(cols))):
        if spec is not None:
            monkeypatch.setenv("DKTPU_FAULTS", spec)
        resilience.reset()
        dk.resilience.reset()
        t = pkg.ADAG(model, **COMMON, **extra)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out.append((t, t.train(frame, shuffle=True)))
    return out


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

COMPUTE_SPECS = ["nan@3;stall@5:0.25;crash@7;kill@9;seed=11",
                 "inf@0;feeder_error@2;ckpt_corrupt@4",
                 "feed_gap@1:0.5;drift@3;seed=2"]
NET_SPECS = ["delay@3:0.2;drop@5;dup@6;truncate@8;partition@7:2;seed=3",
             "evict@2:1;shm_delay@3:0.2;shm_corrupt@6;mesh_down@4",
             "ps_crash@8;ps_hang@1:0.3;preempt@2:1;serve_slow@1:0.3;"
             "serve_drop@2;shard_crash@1:5;link_down@1000:2;"
             "link_flap@1001:1;drop_r@1;dup_r@2;delay_r@3:0.1;truncate_r@4"]


@pytest.mark.parametrize("spec,net", [(s, False) for s in COMPUTE_SPECS]
                         + [(s, True) for s in NET_SPECS])
def test_fault_plan_parses_fires_and_prints_as_jax(spec, net):
    plan = (FaultPlan.parse_net if net else FaultPlan.parse)(spec)
    jplan = (JaxFaultPlan.parse_net if net else JaxFaultPlan.parse)(spec)
    assert repr(plan) == repr(jplan)
    assert plan.faults == jplan.faults and plan.seed == jplan.seed
    assert bool(plan) and not FaultPlan.parse("seed=4")
    for r in range(12):
        for w in (1, 3, 4, 8):
            assert plan.poison_worker(r, w) == jplan.poison_worker(r, w)
    for kind, at in sorted(plan.faults):
        assert plan.pending(kind, at) == jplan.pending(kind, at)
        assert plan.fire(kind, at) == jplan.fire(kind, at)
        assert plan.fire(kind, at) is None  # one-shot
        assert plan.pending(kind, at) is None
    assert plan.fire("nan", 99) is None


def test_fault_plan_queries_are_one_shot():
    plan = FaultPlan.parse("nan@3;stall@5:0.25;crash@7;kill@9;"
                           "ckpt_corrupt@2;feeder_error@1;seed=11")
    assert plan.batch_fault(2) is None
    assert plan.batch_fault(3) == "nan" and plan.batch_fault(3) is None
    assert plan.feeder_stall(5) == 0.25 and plan.feeder_stall(5) == 0.0
    assert plan.crash(7) and not plan.crash(7)
    assert plan.kill(9) and not plan.kill(9)
    assert plan.ckpt_corrupt(2) and not plan.ckpt_corrupt(2)
    assert plan.feeder_error(1) and not plan.feeder_error(1)


@pytest.mark.parametrize("bad,net", [("frobnicate@3", False),
                                     ("nan3", False), ("delay@3", False),
                                     ("nan@2", True), ("ps_reboot@3", True)])
def test_fault_plan_rejects_bad_specs_as_jax(bad, net):
    parse = FaultPlan.parse_net if net else FaultPlan.parse
    jparse = JaxFaultPlan.parse_net if net else JaxFaultPlan.parse
    with pytest.raises(ValueError) as port_err:
        parse(bad)
    with pytest.raises(ValueError) as jax_err:
        jparse(bad)
    assert str(port_err.value) == str(jax_err.value)


def test_fault_state_file_is_read_by_either_package(tmp_path):
    state = str(tmp_path / "fired")
    assert FaultPlan.parse("kill@7;crash@2", state_file=state).kill(7)
    jplan = JaxFaultPlan.parse("kill@7;crash@2", state_file=state)
    assert not jplan.kill(7)       # the port journaled it
    assert jplan.crash(2)          # journaled by the JAX package now
    plan = FaultPlan.parse("kill@7;crash@2", state_file=state)
    assert not plan.crash(2) and not plan.kill(7)
    net = FaultPlan.parse_net("ps_crash@8", state_file=state)
    assert net.fire("ps_crash", 8) == 0.0
    assert JaxFaultPlan.parse_net("ps_crash@8",
                                  state_file=state).fire("ps_crash", 8) \
        is None


def test_ambient_plans_follow_the_environment(monkeypatch):
    from distkeras_tpu_torch.resilience import faults

    assert resilience.active_plan() is None
    monkeypatch.setenv("DKTPU_FAULTS", "crash@1")
    plan = resilience.active_plan()
    assert plan.faults == {("crash", 1): None}
    assert resilience.active_plan() is plan  # cached: one-shot holds
    monkeypatch.setenv("DKTPU_FAULTS", "crash@2")
    assert resilience.active_plan() is not plan  # a new spec re-parses
    resilience.set_plan(None)
    assert resilience.active_plan() is None  # explicit None wins
    monkeypatch.setenv("DKTPU_NET_FAULTS", "drop@1")
    assert faults.active_net_plan().faults == {("drop", 1): None}
    resilience.reset()
    assert resilience.active_plan().faults == {("crash", 2): None}


# ---------------------------------------------------------------------------
# NaN/Inf round skip, divergent-worker reset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_poisoned_round_is_skipped_as_jax(monkeypatch, kind):
    before = (_counter("resilience.nonfinite_rounds"),
              _counter("resilience.faults_injected"))
    jbefore = _jax_counter("resilience.nonfinite_rounds")
    (pt, pm), (jt, jm) = _both(monkeypatch, f"{kind}@2")
    h = pt.get_history()
    assert not np.isfinite(h[2]) and np.isfinite(np.delete(h, 2)).all(), h
    np.testing.assert_allclose(h, jt.get_history(), rtol=1e-5, atol=1e-5)
    _assert_close(pm, jm)
    assert _counter("resilience.nonfinite_rounds") - before[0] == 1
    assert _counter("resilience.faults_injected") - before[1] == 1
    assert _jax_counter("resilience.nonfinite_rounds") - jbefore == 1


def test_nan_guard_disabled_poisons_the_run_as_jax(monkeypatch):
    monkeypatch.setenv("DKTPU_NAN_GUARD", "0")
    (pt, pm), (jt, _jm) = _both(monkeypatch, "nan@1")
    h, jh = pt.get_history(), jt.get_history()
    assert np.isfinite(h[0]) and not np.isfinite(h[1:]).any(), h
    np.testing.assert_allclose(h[0], jh[0], rtol=1e-5, atol=1e-5)
    assert not np.isfinite(jh[1:]).any()
    assert not all(torch.isfinite(v).all() for v in pm.params.values())


def test_batch_fault_on_token_ids_warns_and_is_consumed(monkeypatch):
    monkeypatch.setenv("DKTPU_FAULTS", "nan@1")
    rng = np.random.default_rng(0)
    cols = {"features": rng.integers(0, 50, (64, 6)).astype(np.int32),
            "label": rng.integers(0, 2, 64).astype(np.int32)}
    t = T.DynSGD(imdb_lstm(vocab_size=50, embed_dim=8, hidden_size=8,
                           seq_len=6, device="cpu"),
                 loss="sparse_categorical_crossentropy", num_workers=2,
                 batch_size=4, communication_window=2)
    with pytest.warns(UserWarning, match="cannot poison token ids"):
        t.train(DataFrame(cols))
    assert resilience.active_plan()._fired == {("nan", 1)}
    assert np.isfinite(t.get_history()).all()


def test_reset_workers_edge_masks():
    """All-False is an exact no-op, all-True re-adopts every worker with a
    fresh optimizer; the center, fold state and rng never move; a
    wrong-shaped mask is a loud error. On 4 workers and on 1."""
    for W in (4, 1):
        eng = AsyncEngine(_port_model(), "adam",
                          "sparse_categorical_crossentropy", ADAGFold(),
                          window=4, num_workers=W)
        st = eng.init_state()
        drifted = st._replace(
            locals_=[{k: v + 1.0 for k, v in p.items()} for p in st.locals_],
            opt_state=[eng.tx.init({k: v + 3.0 for k, v in st.center.items()})
                       for _ in range(W)])
        noop = eng.reset_workers(drifted, np.zeros(W, bool))
        assert noop.locals_ == drifted.locals_
        assert noop.opt_state == drifted.opt_state
        fresh = eng.reset_workers(drifted, np.ones(W, bool))
        init = eng.tx.init(st.center)
        for w in range(W):
            assert fresh.locals_[w] is drifted.center
            for a, b in zip(jax.tree_util.tree_leaves(fresh.opt_state[w]),
                            jax.tree_util.tree_leaves(init)):
                assert (torch.equal(a, b) if torch.is_tensor(a)
                        else a == b)
        assert fresh.center is drifted.center
        assert (fresh.fold_state, fresh.rng) == (drifted.fold_state,
                                                 drifted.rng)
        if W > 1:
            one = eng.reset_workers(drifted, np.eye(W, dtype=bool)[1])
            assert one.locals_[1] is drifted.center
            assert one.locals_[0] is drifted.locals_[0]
        with pytest.raises(ValueError, match="worker_mask"):
            eng.reset_workers(drifted, np.ones(W + 1, bool))


def test_divergent_worker_reset_matches_jax(monkeypatch):
    """One worker's loss goes non-finite at round 2 (the round itself is
    skipped); the reset re-adopts the center for exactly that worker, the
    one ``poison_worker(2, 4)`` names, in both packages."""
    before = _counter("resilience.worker_resets")
    jbefore = _jax_counter("resilience.worker_resets")
    mark = telemetry.get().mark()
    (pt, pm), (jt, jm) = _both(monkeypatch, "nan@2",
                               divergence_reset=1000.0)
    assert _counter("resilience.worker_resets") - before == 1
    assert _jax_counter("resilience.worker_resets") - jbefore == 1
    _, events = telemetry.get().delta(mark)
    resets = [e for e in events if e["kind"] == "worker_reset"]
    assert [e["workers"] for e in resets] == [
        [FaultPlan.parse("nan@2").poison_worker(2, 4)]]
    np.testing.assert_allclose(pt.get_history(), jt.get_history(),
                               rtol=1e-5, atol=1e-5)
    _assert_close(pm, jm)


def test_divergence_reset_from_the_environment(monkeypatch):
    monkeypatch.setenv("DKTPU_DIVERGENCE_RESET", "1000")
    monkeypatch.setenv("DKTPU_FAULTS", "nan@2")
    before = _counter("resilience.worker_resets")
    T.ADAG(_port_model(), **COMMON).train(DataFrame(_columns()),
                                          shuffle=True)
    assert _counter("resilience.worker_resets") - before == 1


# ---------------------------------------------------------------------------
# Feeder: stall watchdog + stage retry
# ---------------------------------------------------------------------------

def test_feeder_stall_watchdog_warns(monkeypatch):
    monkeypatch.setenv("DKTPU_FAULTS", "stall@1:0.4")
    before = _counter("resilience.feeder_stall_warnings")
    feeder = RoundFeeder(3, lambda r: r, stall_warn=0.05, stall_timeout=10.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = [r for r, _ in feeder]
    assert got == [0, 1, 2]
    assert _counter("resilience.feeder_stall_warnings") - before >= 1


def test_feeder_error_retry_recovers(monkeypatch):
    monkeypatch.setenv("DKTPU_FAULTS", "feeder_error@1")
    before = _counter("resilience.feeder_retries")
    feeder = RoundFeeder(3, lambda r: r, stage_retries=1)
    assert [r for r, _ in feeder] == [0, 1, 2]
    assert _counter("resilience.feeder_retries") - before == 1


def test_feeder_error_without_retries_propagates(monkeypatch):
    monkeypatch.setenv("DKTPU_FAULTS", "feeder_error@1")
    feeder = RoundFeeder(3, lambda r: r)
    with pytest.raises(InjectedFault, match="feeder error"):
        list(feeder)


# ---------------------------------------------------------------------------
# Checkpoint fallback, Supervisor
# ---------------------------------------------------------------------------

def test_ckpt_corrupt_falls_back_to_the_previous_step_as_jax(tmp_path,
                                                             monkeypatch):
    pytest.importorskip("orbax.checkpoint")
    cols = _columns()
    out = []
    for pkg, mk, frame, d in ((T, _port_model, DataFrame,
                               str(tmp_path / "ck")),
                              (dk, _jax_model, dk.DataFrame,
                               str(tmp_path / "jck"))):
        monkeypatch.setenv("DKTPU_FAULTS", f"ckpt_corrupt@{NUM_ROUNDS - 1}")
        resilience.reset()
        dk.resilience.reset()
        pkg.ADAG(mk(), checkpoint_dir=d, checkpoint_every=1,
                 **COMMON).train(frame(cols), shuffle=True)
        monkeypatch.delenv("DKTPU_FAULTS")
        resilience.reset()
        dk.resilience.reset()
        t2 = pkg.ADAG(mk(), checkpoint_dir=d, checkpoint_every=1,
                      resume=True, **COMMON)
        with pytest.warns(UserWarning, match="falling back to the previous"):
            m = t2.train(frame(cols), shuffle=True)
        # resumed from step 10 (round 10): exactly one round left to run
        assert len(t2.get_history()) == 1
        out.append(m)
    assert _counter("resilience.ckpt_corrupt_detected") >= 1
    _assert_close(*out)


def test_supervisor_resumes_after_crash_as_jax(tmp_path, monkeypatch):
    """``crash@7`` under a Supervisor: two attempts, the second resumed
    from the round-6 checkpoint; the result is bit-equal to the port's
    uninterrupted run and within 1e-5 of the JAX supervised run."""
    pytest.importorskip("orbax.checkpoint")
    cols = _columns()
    clean = T.ADAG(_port_model(), **COMMON).train(DataFrame(cols),
                                                  shuffle=True)
    out = []
    for pkg, mk, frame, d in ((T, _port_model, DataFrame,
                               str(tmp_path / "ck")),
                              (dk, _jax_model, dk.DataFrame,
                               str(tmp_path / "jck"))):
        monkeypatch.setenv("DKTPU_FAULTS", "crash@7")
        resilience.reset()
        dk.resilience.reset()
        before = _counter("resilience.supervisor_retries")
        t = pkg.ADAG(mk(), checkpoint_dir=d, checkpoint_every=1, **COMMON)
        sup = (Supervisor if pkg is T else dk.Supervisor)(
            t, max_retries=2, backoff_s=0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out.append(sup.train(frame(cols), shuffle=True))
        assert sup.attempts == 2
        assert len(t.get_history()) == NUM_ROUNDS - 7
        if pkg is T:
            assert _counter("resilience.supervisor_retries") - before == 1
    for k, v in clean.params.items():
        assert torch.equal(out[0].params[k], v), k
    _assert_close(*out)


def test_supervisor_budget_is_bounded(monkeypatch):
    monkeypatch.setenv("DKTPU_FAULTS", "crash@0;crash@1")
    t = T.ADAG(_port_model(), **COMMON)  # no checkpoint_dir: from scratch
    before = _counter("resilience.supervisor_exhausted")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sup = Supervisor(t, max_retries=1, backoff_s=0)
        with pytest.raises(InjectedFault):
            sup.train(DataFrame(_columns()), shuffle=True)
    assert sup.attempts == 2
    assert _counter("resilience.supervisor_exhausted") - before == 1


def test_supervised_fault_matrix_counts_every_fault(tmp_path, monkeypatch):
    """The JAX package's acceptance schedule: a NaN round at r=3, a feeder
    stall at r=5 and a crash at r=7, each fired once, one retry."""
    monkeypatch.setenv("DKTPU_FAULTS", "nan@3;stall@5:0.2;crash@7")
    c0 = {k: _counter(k) for k in ("resilience.nonfinite_rounds",
                                   "resilience.faults_injected")}
    t = T.ADAG(_port_model(), checkpoint_dir=str(tmp_path / "ck"),
               checkpoint_every=1, **COMMON)
    sup = Supervisor(t, max_retries=3, backoff_s=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trained = sup.train(DataFrame(_columns()), shuffle=True)
    assert sup.attempts == 2
    assert _counter("resilience.faults_injected") - c0[
        "resilience.faults_injected"] == 3
    assert _counter("resilience.nonfinite_rounds") - c0[
        "resilience.nonfinite_rounds"] == 1
    assert all(torch.isfinite(v).all() for v in trained.params.values())


_KILL_CHILD = """
import numpy as np
from distkeras_tpu_torch import ADAG, DataFrame, mnist_mlp
rng = np.random.default_rng(0)
cols = {"features": rng.normal(size=(256, 784)).astype(np.float32),
        "label": rng.integers(0, 10, 256).astype(np.int32)}
t = ADAG(mnist_mlp(hidden=(8,), device="cpu"),
         loss="sparse_categorical_crossentropy", num_workers=2,
         batch_size=16, communication_window=2, checkpoint_dir=CKPT,
         checkpoint_every=1, resume=True)
t.train(DataFrame(cols))
print("ROUNDS", len(t.get_history()))
"""


def test_kill_in_a_child_does_not_fire_again_after_restart(tmp_path):
    """``kill@2`` SIGKILLs the training process before round 2; restarted
    with the same ``DKTPU_FAULTS_STATE`` it resumes from the round-1
    checkpoint and runs to the end (the journal keeps the kill from
    firing again)."""
    state = str(tmp_path / "fired")
    code = _KILL_CHILD.replace("CKPT", repr(str(tmp_path / "ck")))
    env = dict(os.environ, PYTHONPATH=REPO, DKTPU_FAULTS="kill@2",
               DKTPU_FAULTS_STATE=state)
    first = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                           capture_output=True, text=True, timeout=120)
    assert first.returncode == -signal.SIGKILL, first.stderr
    with open(state) as f:
        assert f.read().split() == ["kill@2"]
    second = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert second.returncode == 0, second.stderr
    assert "ROUNDS 2" in second.stdout  # rounds 2 and 3 of 4
