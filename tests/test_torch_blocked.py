"""Multi-round programs (``rounds_per_program`` > 1 and ``"auto"``): the
port's ``run_rounds`` / ``run_blocked`` / ``run_auto`` and
``multi_round_fn`` (``parallel/engine.py``, ``parallel/program.py``) on
the CPU, where a program is a host loop of rounds with the same counters,
host-number tables (``ops/host_numbers.py``) and in-program NaN guard as
the card's captured graph.

Every blocked or auto run is held bit for bit to the port's own
per-round run, and to the JAX package's run at the same R within rtol =
atol = 1e-5 (the per-round parities' tolerance,
``tests/test_torch_trainers.py``): ADAG (adam: the bias corrections'
table), DynSGD with W=4 and R=3 (the staleness scale's table, R not a
multiple of W), AEASGD, an adam run under a learning-rate schedule (the
schedule's table) and ``SynchronousDistributedTrainer``, on a small MLP
whose JAX weights the port loads. Then the behaviour the JAX tests pin:
auto past its 16-round head and resumed past its end, a partial final
block, checkpoints under blocks, ``on_round``'s interior ``None`` states
and the metrics log's ``burst_tail``, ``nan@2`` and ``crash@3`` inside
blocks, blocked staging from a shard store, the feed waits, the spans,
``_auto_size_r`` and two gloo ranks agreeing on auto's R.
``ParallelTrainer``'s cases are in ``tests/test_torch_blocked_parallel.py``.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.mlp import MLP as JaxMLP
from distkeras_tpu.parallel import engine as jax_engine
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.data import DataFrame, make_batches
from distkeras_tpu_torch.models import MLP, Model
from distkeras_tpu_torch.ops import schedules as S
from distkeras_tpu_torch.parallel import engine as E
from distkeras_tpu_torch.parallel import program
from distkeras_tpu_torch.parallel.sync import SyncEngine
from distkeras_tpu_torch.resilience import InjectedFault

import torch_rank_workers as RW

LOSS = "sparse_categorical_crossentropy"
FEATURES, CLASSES, B = 8, 3, 16
TOL = dict(rtol=1e-5, atol=1e-5)
ROUNDS = 7
#: (trainer, kwargs, workers, window): the parity families
FAMILIES = {
    "ADAG": ("ADAG", dict(worker_optimizer="adam", learning_rate=0.05,
                          communication_window=2), 4),
    "DynSGD": ("DynSGD", dict(worker_optimizer="sgd", learning_rate=0.1,
                              communication_window=2), 4),
    "AEASGD": ("AEASGD", dict(worker_optimizer="sgd", learning_rate=0.05,
                              communication_window=2, rho=3.0), 2),
    "schedule": ("SingleTrainer", dict(worker_optimizer="adam",
                                       steps_per_program=2), 1),
    "sync": ("SynchronousDistributedTrainer", dict(
        worker_optimizer="sgd", learning_rate=0.1, steps_per_program=2), 2),
}


def _jax_model():
    return JaxModel.build(JaxMLP(hidden=(8,), num_outputs=CLASSES),
                          jnp.zeros((1, FEATURES), jnp.float32), seed=1)


JM = _jax_model()


def _port_model():
    pm = Model.build(MLP(hidden=(8,), num_outputs=CLASSES,
                         in_features=FEATURES),
                     np.zeros((1, FEATURES), np.float32), device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, JM.params), pm.module))
    return pm


def _columns(rounds, workers, window=2, seed=0):
    rng = np.random.default_rng(seed)
    n = rounds * workers * window * B
    centers = rng.normal(size=(CLASSES, FEATURES)) * 2
    y = rng.integers(0, CLASSES, n).astype(np.int32)
    x = (centers[y] + rng.normal(size=(n, FEATURES))).astype(np.float32)
    return {"features": x, "label": y}


def _kwargs(family, rpp, jax_side=False):
    name, kw, workers = FAMILIES[family]
    kw = dict(kw, batch_size=B, rounds_per_program=rpp)
    if workers > 1:
        kw["num_workers"] = workers
    if family == "schedule":
        kw["learning_rate"] = (optax if jax_side else S).linear_schedule(
            0.1, 0.01, 10)
    return name, kw


def _port_run(family, rpp, rounds=ROUNDS, **extra):
    name, kw = _kwargs(family, rpp)
    t = getattr(T, name)(_port_model(), loss=LOSS, **kw, **extra)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the sync merge warning
        out = t.train(DataFrame(_columns(rounds, FAMILIES[family][2])))
    return t, {k: v.detach().clone() for k, v in out.params.items()}


def _jax_run(family, rpp, rounds=ROUNDS):
    name, kw = _kwargs(family, rpp, jax_side=True)
    t = getattr(dk, name)(JM, loss=LOSS, **kw)
    out = t.train(JaxDataFrame(_columns(rounds, FAMILIES[family][2])))
    return t, params_from_jax(jax.tree_util.tree_map(np.asarray, out.params),
                              _port_model().module)


_PER_ROUND: dict = {}


def _per_round(family):
    if family not in _PER_ROUND:
        _PER_ROUND[family] = _port_run(family, 1)
    return _PER_ROUND[family]


def _history(t):
    w = t.get_worker_histories()
    return np.asarray(t.get_history() if w is None else w)


def _bit_equal(a, b):
    ta, pa = a
    tb, pb = b
    np.testing.assert_array_equal(_history(ta), _history(tb))
    assert set(pa) == set(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


@pytest.mark.parametrize("rpp", [2, 3, 4, "auto"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_blocked_is_per_round_and_matches_jax(family, rpp):
    """R rounds a program: the port's run equals its per-round run bit for
    bit, and the JAX package's at the same R within 1e-5."""
    got = _port_run(family, rpp)
    _bit_equal(got, _per_round(family))
    jt, jparams = _jax_run(family, rpp)
    np.testing.assert_allclose(_history(got[0]), _history(jt), **TOL)
    for k, v in jparams.items():
        np.testing.assert_allclose(got[1][k].numpy(), v.numpy(), err_msg=k,
                                   **TOL)


def test_programs_read_their_host_numbers_from_tables():
    """Inside a program the counters are tensors and the host numbers come
    from tables: DynSGD's scale from the W stalenesses', adam's bias
    corrections and a schedule's step from the counts'. The per-round run
    of the same engine reads Python floats; both give the same losses."""
    from distkeras_tpu_torch.ops import optimizers as O
    from distkeras_tpu_torch.parallel.disciplines import get_discipline

    plan = make_batches(DataFrame(_columns(6, 4)), "features", "label",
                        batch_size=B, num_workers=4, window=2, num_epoch=1)
    cases = (("dynsgd", lambda: "sgd", {"dynsgd"}),
             ("adag", lambda: O.adam(S.linear_schedule(0.1, 0.01, 10)),
              {"bias_correction", "schedule"}))
    for disc, tx, keys in cases:
        runs = []
        for rpp in (1, 3):
            eng = E.AsyncEngine(_port_model(), tx(), LOSS,
                                get_discipline(disc), window=2,
                                num_workers=4, learning_rate=0.05)
            runs.append(eng.run(plan, rounds_per_program=rpp)[1])
        np.testing.assert_array_equal(runs[0], runs[1])
        seat = eng._program_seat
        assert {k[0][0] for k in seat.tables._tables} == keys
        assert seat.mode == program.EAGER
        assert eng.multi_round_fn(3) is eng.multi_round_fn(3)


def test_auto_past_its_head_and_resumed_past_its_end(tmp_path):
    """30 rounds under "auto": the 16-round head, then blocks of auto's R,
    equal to the per-round run; a resumed run already past its end
    returns an empty history (the JAX package's behaviour)."""
    rounds = 30
    per = _port_run("ADAG", 1, rounds=rounds)
    auto = _port_run("ADAG", "auto", rounds=rounds)
    _bit_equal(per, auto)
    assert _history(auto[0]).shape == (4, rounds)
    jt, _ = _jax_run("ADAG", "auto", rounds=rounds)
    np.testing.assert_allclose(_history(auto[0]), _history(jt), **TOL)
    ck = str(tmp_path / "ck")
    kw = dict(checkpoint_dir=ck, checkpoint_every=1,
              metrics_path=str(tmp_path / "m.jsonl"))
    _port_run("ADAG", "auto", rounds=8, **kw)
    again, _ = _port_run("ADAG", "auto", rounds=8, resume=True, **kw)
    assert len(again.get_history()) == 0


@pytest.mark.parametrize("rpp", [2, 4])
def test_partial_final_block(rpp):
    """15 rounds: a 1-round tail at R=2, a 3-round tail at R=4."""
    _bit_equal(_port_run("ADAG", rpp, rounds=15),
               _port_run("ADAG", 1, rounds=15))


def test_checkpoint_resume_under_blocks(tmp_path):
    """Checkpoints under R=2 land on block-final states; resuming from one
    gives the uninterrupted run's parameters."""
    full = _port_run("ADAG", 2, rounds=15)
    ck = str(tmp_path / "ck")
    kw = dict(checkpoint_dir=ck, checkpoint_every=3)
    stop = {}

    def die(r, loss):
        if r == 8:
            stop["at"] = r
            raise KeyboardInterrupt  # not an Exception: nothing retries

    name, tkw = _kwargs("ADAG", 2)
    t = getattr(T, name)(_port_model(), loss=LOSS, **tkw, on_round=die,
                         **kw)
    with pytest.raises(KeyboardInterrupt):
        t.train(DataFrame(_columns(15, 4)))
    assert stop == {"at": 8}
    _, resumed = _port_run("ADAG", 2, rounds=15, resume=True, **kw)
    for k, v in full[1].items():
        assert torch.equal(v, resumed[k]), k


def _engine_run(rpp, on_round, rounds=7, disc="adag"):
    from distkeras_tpu_torch.parallel.disciplines import get_discipline

    cols = _columns(rounds, 4)
    plan = make_batches(DataFrame(cols), "features", "label", batch_size=B,
                        num_workers=4, window=2, num_epoch=1)
    eng = E.AsyncEngine(_port_model(), "adam", LOSS, get_discipline(disc),
                        window=2, num_workers=4, learning_rate=0.05)
    return eng, eng.run(plan, on_round=on_round, rounds_per_program=rpp)


def test_on_round_interior_states_and_burst_tail(tmp_path):
    """``on_round`` fires once a round, the state only on each block's
    last round; the metrics log's ``burst_tail`` column is the JAX
    package's for the same run."""
    seen = []
    _engine_run(3, lambda r, loss, st: seen.append((r, st is not None)))
    assert seen == [(r, r in (2, 5, 6)) for r in range(7)]
    logs = {}
    for side in ("port", "jax"):
        path = str(tmp_path / f"{side}.jsonl")
        name, kw = _kwargs("ADAG", 3, jax_side=side == "jax")
        cols = _columns(ROUNDS, 4)
        if side == "port":
            getattr(T, name)(_port_model(), loss=LOSS, metrics_path=path,
                             **kw).train(DataFrame(cols))
        else:
            getattr(dk, name)(JM, loss=LOSS, metrics_path=path,
                              **kw).train(JaxDataFrame(cols))
        with open(path) as f:
            logs[side] = [json.loads(line) for line in f
                          if '"round"' in line and "burst_tail" in line]
    tails = {k: [rec["burst_tail"] for rec in v] for k, v in logs.items()}
    assert tails["port"] == tails["jax"]
    # a record is a burst's tail when the call before it carried no state
    assert tails["port"] == [False, True, True, False, True, True, False]


def test_nan_round_inside_a_block_is_skipped(monkeypatch):
    """``nan@2`` poisons row 2 of the first block of 4: the in-program
    guard skips exactly that round, as the per-round run does."""
    monkeypatch.setenv("DKTPU_FAULTS", "nan@2")
    from distkeras_tpu_torch import resilience

    resilience.reset()
    blocked = _port_run("ADAG", 4, rounds=8)
    resilience.reset()
    per = _port_run("ADAG", 1, rounds=8)
    resilience.reset()
    h = _history(blocked[0]).mean(axis=0)
    assert not np.isfinite(h[2]) and np.isfinite(h[3:]).all(), h
    _bit_equal(blocked, per)


def test_crash_lands_at_the_block_boundary(monkeypatch):
    """``crash@3`` under R=2 raises before the block of rounds 2-3 runs:
    the rounds of the blocks before it ran, none of its own."""
    monkeypatch.setenv("DKTPU_FAULTS", "crash@3")
    from distkeras_tpu_torch import resilience

    resilience.reset()
    seen = []
    with pytest.raises(InjectedFault, match="round 3"):
        _engine_run(2, lambda r, loss, st: seen.append(r))
    resilience.reset()
    assert seen == [0, 1]


def test_blocked_staging_from_a_shard_store(tmp_path):
    """A sync run from a shard store stages its blocks as the per-round
    run stages its rounds."""
    from distkeras_tpu_torch.data.shards import ShardedDataFrame, write_shards

    cols = _columns(8, 2)
    write_shards(str(tmp_path), cols, rows_per_shard=64)
    hist = []
    for rpp in (1, 4):
        name, kw = _kwargs("sync", rpp)
        t = getattr(T, name)(_port_model(), loss=LOSS, **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t.train(ShardedDataFrame(str(tmp_path)))
        hist.append(t.get_history())
    np.testing.assert_array_equal(hist[0], hist[1])
    assert len(hist[0]) == 8


def test_feed_waits_and_spans():
    """The blocked and auto loops record their feed waits and their
    ``dispatch[...]`` / ``retire[...]`` spans."""
    cols = _columns(20, 2)
    plan = make_batches(DataFrame(cols), "features", "label", batch_size=B,
                        num_workers=2, window=2, num_epoch=1)
    eng = SyncEngine(_port_model(), "sgd", LOSS, num_workers=2,
                     learning_rate=0.05)
    for rpp, spans in ((2, ("dispatch[blocked]", "retire[blocked]")),
                       ("auto", ("dispatch[auto]", "retire[auto]"))):
        telemetry.reset()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng.run(plan, rounds_per_program=rpp)
        assert np.isfinite(eng.feed_wait_seconds)
        assert len(eng.feed_waits) >= 1
        assert all(w >= 0 for w in eng.feed_waits)
        names = set(telemetry.get().snapshot()["spans"])
        for span in spans:
            assert any(n.endswith(span) for n in names), (span, names)
        assert "engine_run" in names


@pytest.mark.parametrize("steady", [1e-7, 1e-4, 3e-3, 0.02, 0.064, 0.2])
@pytest.mark.parametrize("round_bytes", [0, 1, 4096, 9e6, 3e8])
def test_auto_size_r_is_the_jax_package_s(steady, round_bytes):
    assert E._auto_size_r(steady, int(round_bytes)) == \
        jax_engine._auto_size_r(steady, int(round_bytes))
    assert (E._AUTO_MAX_R, E._AUTO_BLOCK_BYTES, E._AUTO_PROBE_ROUNDS,
            E._AUTO_TARGET_S) == (
        jax_engine._AUTO_MAX_R, jax_engine._AUTO_BLOCK_BYTES,
        jax_engine._AUTO_PROBE_ROUNDS, jax_engine._AUTO_TARGET_S)


def test_probe_steady_counts_its_rounds():
    calls = []
    s = E.probe_steady(lambda: calls.append(1) or torch.zeros(()), n=5)
    assert len(calls) == 5 and s > 0


def test_two_gloo_ranks_agree_on_auto_r():
    """Two gloo ranks under "auto": rank 0's R is every rank's, and the
    run equals the per-round run on both."""
    res = RW.spawn("blocked_auto", 2, (), timeout=200)
    assert res[0]["R"] == res[1]["R"] >= 1
    for r in res:
        assert r["blocked"] == r["per_round"]
        assert r["mode"] == program.EAGER


# -- what a capture relies on, checked on the CPU ------------------------------
class _Stream:
    """A stand-in for a ``torch.cuda.Stream``: its handle only."""

    def __init__(self, handle):
        self.cuda_stream = handle


def test_launch_tapes_count_warmups_and_replays_by_stream():
    """A warm-up round's launches count, and count again as warm-up
    launches; a capture's launches count at each replay, not as they are
    recorded; launches on another stream count as they are made."""
    from distkeras_tpu_torch.ops.kernels import build

    lib = build.KernelLib({}, ["k"])
    with build.launch_tape("warmup", _Stream(11)):
        lib._tally("kernel", "k", 11)
        lib._tally("kernel", "k", 12)
    assert lib.counts() == {"k": 2} and lib.warmup_counts() == {"k": 1}
    with build.launch_tape("record", _Stream(11)) as tape:
        lib._tally("kernel", "k", 11)
        lib._tally("kernel", "k", 12)
        with pytest.raises(RuntimeError, match="already open"):
            with build.launch_tape("record", _Stream(11)):
                pass
        with build.launch_tape("record", _Stream(13)) as other:
            lib._tally("kernel", "k", 13)
    assert lib.counts() == {"k": 3} and sum(other.values()) == 1
    build.replay_launches(tape)
    build.replay_launches(tape)
    assert lib.counts() == {"k": 5} and lib.warmup_counts() == {"k": 1}
    assert not build._TAPES
    lib.reset()
    assert lib.counts() == {"k": 0} and lib.warmup_counts() == {"k": 0}


def test_flip_crop_transform_halves_are_the_transform():
    """``draw`` then ``apply`` (what a captured program stages and runs) is
    the transform's one call from the same generator."""
    from distkeras_tpu_torch.ops.augment import flip_crop_transform

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 255, (6, 10, 10, 3)).astype(
        np.uint8))
    y = torch.arange(6)
    t = flip_crop_transform(pad=2)
    want = t(torch.Generator().manual_seed(7), x, y)
    got = t.apply(t.draw(torch.Generator().manual_seed(7), tuple(x.shape)),
                  x, y)
    assert torch.equal(got[0], want[0]) and got[1] is y


def test_program_mode_with_a_device_transform():
    """On the card a transform in halves is captured; an opaque one makes
    the engine's programs host loops, decided before the run."""
    from distkeras_tpu_torch.ops.augment import flip_crop_transform

    class Engine:
        def __init__(self, transform):
            self.device_transform = transform

        def _program_device(self):
            return torch.device("cuda")

    assert program.program_mode(Engine(None)) == program.GRAPH
    assert program.program_mode(
        Engine(flip_crop_transform())) == program.GRAPH
    assert program.program_mode(
        Engine(lambda gen, x, y: (x, y))) == program.EAGER


def test_a_round_of_seed_refs_is_the_per_round_round():
    """What a capture records, run on the CPU: the round with its rng a
    ``SeedRef`` and its counters tensors, its dropout generators and its
    transform's draws taken from the program's hooks (resolved at once,
    as the warm-up round resolves them), equals the per-round round bit
    for bit, and its rng resolves to the per-round round's."""
    from distkeras_tpu_torch.models import SimpleCNN
    from distkeras_tpu_torch.ops import host_numbers
    from distkeras_tpu_torch.ops.augment import flip_crop_transform
    from distkeras_tpu_torch.parallel.disciplines import get_discipline
    from distkeras_tpu_torch.workers import SeedRef

    module = SimpleCNN(conv_features=(4,), dense=(8,), num_outputs=3,
                       dropout_rate=0.3, input_shape=(8, 8, 3))
    model = Model.build(module, np.zeros((1, 8, 8, 3), np.float32),
                        device="cpu")
    rng = np.random.default_rng(0)
    n = 2 * 2 * B
    df = DataFrame({"features": rng.integers(0, 255, (n, 8, 8, 3)).astype(
        np.uint8), "label": rng.integers(0, 3, n).astype(np.int32)})
    plan = make_batches(df, "features", "label", batch_size=B,
                        num_workers=2, window=2, num_epoch=1)
    eng = E.AsyncEngine(model, "adam", LOSS, get_discipline("adag"),
                        window=2, num_workers=2, learning_rate=0.05,
                        device_transform=flip_crop_transform(pad=2))
    state = eng.init_state()
    seed = 987654321
    xs, ys = E.stage_round(eng, plan, 0)
    want, want_loss = eng._round_fn(state._replace(rng=seed), xs, ys)

    asked = []

    def generator(device, ref):
        asked.append("generator")
        return torch.Generator(device=device).manual_seed(ref.resolve(seed))

    def draws(transform, ref, x):
        asked.append("draws")
        gen = torch.Generator().manual_seed(ref.resolve(seed))
        return transform.draw(gen, tuple(x.shape))

    body, _ = program._split_rng(state)
    leaves, spec = program.flatten(body)
    st = program.unflatten(spec, [
        torch.tensor(v) if program._is_counter(v) else v
        for v in leaves])._replace(rng=SeedRef())
    with host_numbers.program(host_numbers.Tables("cpu", 16)), \
            program._hooks(generator, draws):
        got, got_loss = eng._round_fn(st, xs, ys)
    assert asked.count("generator") == 4 and asked.count("draws") == 4
    assert torch.equal(got_loss, want_loss)
    assert got.rng.resolve(seed) == want.rng
    got_leaves, got_spec = program.flatten(program._split_rng(got)[0])
    want_leaves, want_spec = program.flatten(program._split_rng(want)[0])
    assert got_spec == want_spec
    for a, b in zip(got_leaves, want_leaves):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, torch.as_tensor(b))
        else:
            assert a == b


def test_count_tables_cover_the_run_from_its_optimizer_counts():
    """The tables are sized from the optimizer counts and the rounds the
    run has left (``rounds_left``), once for the run; a schedule's table is
    keyed by the schedule itself."""
    from distkeras_tpu_torch.ops import optimizers as O
    from distkeras_tpu_torch.parallel.disciplines import get_discipline

    sched = S.linear_schedule(0.1, 0.01, 10)
    eng = E.AsyncEngine(_port_model(), O.adam(sched), LOSS,
                        get_discipline("adag"), window=2, num_workers=2,
                        learning_rate=0.05)
    state = eng.init_state()
    # adam's count and the schedule's, a worker
    assert program._table_counts(program._split_rng(state)[0]) == [0] * 4
    plan = make_batches(DataFrame(_columns(7, 2)), "features", "label",
                        batch_size=B, num_workers=2, window=2, num_epoch=1)
    eng.run(plan, state, rounds_per_program=3)
    seat = eng._program_seat
    assert seat.tables.count_size == 7 * 2 + 2
    keys = {k[0] for k in seat.tables._tables}
    assert any(key[0] == "schedule" and callable(key[1]) for key in keys)
    # a state 9 updates on with 4 rounds left needs counts up to 9 + 8:
    # larger tables (smaller needs keep the run's)
    fn = eng.multi_round_fn(2)
    xs, ys = E.stage_block(eng, plan, [0, 1])
    later = state._replace(opt_state=[
        tuple(dict(part, count=9) for part in s) for s in state.opt_state])
    fn(later, xs, ys, 4)
    assert seat.tables.count_size == 9 + 4 * 2 + 2
