"""The port's raced parameter server (``distkeras_tpu_torch/racelab.py``)
held to the JAX package's (``distkeras_tpu/racelab.py``).

A scripted serial pull/commit sequence (two workers interleaved, so
staleness is nonzero) gives centers bit-equal to the JAX server's, and the
same ``commit_log``, for every discipline: the port folds through the plain
twin of ``fold_commit`` on the CPU, bit-equal to the JAX package's numpy
fold. ``run_raced`` at one worker is deterministic: with the same numpy
window both packages' centers are bit-equal, and with each package's own
local loop (the port's ``make_local_loop``, the JAX one jitted) within
rtol = atol = 1e-5. With W workers and ``overlap_first_round`` the first W
commits realize staleness 0..W-1; ``close()`` makes workers exit through
the typed error.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import racelab as jrace
from distkeras_tpu.netps.errors import ServerClosedError as JaxClosed
from distkeras_tpu_torch import racelab as prace
from distkeras_tpu_torch.netps.errors import ServerClosedError

DISCIPLINES = ["downpour", "adag", "dynsgd", "aeasgd", "eamsgd"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _center(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(4, 3)).astype(np.float32),
            rng.normal(size=(7,)).astype(np.float32),
            rng.normal(size=(2, 5, 2)).astype(np.float32)]


def _delta(seed):
    rng = np.random.default_rng(1000 + seed)
    return [(0.01 * rng.normal(size=a.shape)).astype(np.float32)
            for a in _center()]


@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_scripted_sequence_is_bit_equal_to_the_jax_server(discipline):
    """Two workers, interleaved by hand: A and B pull at counter 0, A
    commits (staleness 0), B commits (staleness 1), A pulls and commits
    twice more while B's next pull goes stale by two."""
    servers = {"jax": jrace.RacedParameterServer(_center(), discipline),
               "port": prace.RacedParameterServer(_center(), discipline,
                                                  device="cpu")}
    pulls = {}
    for name, ps in servers.items():
        seen = []
        _a, ca = ps.pull()
        _b, cb = ps.pull()
        ps.commit(_delta(0), ca)
        ps.commit(_delta(1), cb)
        pb, cb = ps.pull()
        seen.append(pb)
        for i in range(2):
            pa, ca = ps.pull()
            seen.append(pa)
            ps.commit(_delta(2 + i), ca)
        ps.commit(_delta(4), cb)
        pulls[name] = seen
    j, p = servers["jax"], servers["port"]
    assert p.commit_log == j.commit_log == [0, 1, 0, 0, 2]
    for a, b in zip(j.center(), p.center()):
        np.testing.assert_array_equal(a, b)
        assert b.dtype == np.float32 and b.flags.writeable
    for sa, sb in zip(pulls["jax"], pulls["port"]):
        for a, b in zip(sa, sb):
            np.testing.assert_array_equal(a, b)
    assert p.device.type == "cpu"
    assert p._center[0].device.type == "cpu"


def _numpy_window(flat, batch, aux=None):
    """A deterministic numpy 'local window' (the lock-protocol harness):
    each tensor moves against its sign, scaled by the batch's value."""
    out = [a - np.float32(0.01 * batch) * np.sign(a) for a in flat]
    if aux is None:
        return out
    return out, aux


@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_run_raced_one_worker_numpy_window_bit_equal(discipline):
    batches = [[1.0, 2.0, 0.5, 3.0]]
    if discipline == "eamsgd":
        steps = lambda flat, b, aux: (_numpy_window(flat, b), aux)  # noqa: E731
    else:
        steps = _numpy_window
    jc, jps = jrace.run_raced(center=_center(), local_steps=steps,
                              worker_batches=batches, window=4,
                              discipline=discipline, alpha=0.1)
    pc, pps = prace.run_raced(center=_center(), local_steps=steps,
                              worker_batches=batches, window=4,
                              discipline=discipline, alpha=0.1,
                              device="cpu")
    assert pps.commit_log == jps.commit_log == [0, 0, 0, 0]
    for a, b in zip(jc, pc):
        np.testing.assert_array_equal(a, b)


def _mlp_pair():
    from distkeras_tpu.models import Model as JaxModel
    from distkeras_tpu.models.mlp import MLP as JaxMLP
    from distkeras_tpu_torch.convert import params_from_jax
    from distkeras_tpu_torch.models import MLP, Model

    jm = JaxModel.build(JaxMLP(hidden=(16,), num_outputs=3),
                        jnp.zeros((1, 4), jnp.float32), seed=0)
    pm = Model.build(MLP(hidden=(16,), num_outputs=3, in_features=4),
                     np.zeros((1, 4), np.float32), device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return jm, pm


def _blob_batches(workers, rounds, K=4, B=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(3, 4))
    out = []
    for _w in range(workers):
        per = []
        for _r in range(rounds):
            y = rng.integers(0, 3, size=(K, B))
            x = (centers[y] + rng.normal(scale=0.5, size=(K, B, 4))).astype(
                np.float32)
            per.append((x, y.astype(np.int32)))
        out.append(per)
    return out


def _port_steps(pm, lr=0.1, workers=1):
    """``local_steps`` from the port's ``make_local_loop``: one loop per
    calling thread (a loop reparametrizes its module during a call). A
    thread's second window waits until all ``workers`` threads entered
    theirs, i.e. made their first commits: the first W commits are then
    the W first-round ones."""
    import copy

    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer
    from distkeras_tpu_torch.workers import make_local_loop

    tx = get_optimizer("sgd", lr)
    names = list(pm.params)
    loops, calls = {}, {}
    second = threading.Barrier(workers)

    def steps(flat, batch):
        me = threading.get_ident()
        if me not in loops:
            loops[me] = make_local_loop(copy.deepcopy(pm.module),
                                        get_loss("sparse_categorical_"
                                                 "crossentropy"), tx)
        calls[me] = calls.get(me, 0) + 1
        if calls[me] == 2:
            second.wait(timeout=60)
        params = {k: torch.as_tensor(a) for k, a in zip(names, flat)}
        xs, ys = batch
        new, _opt, _st, _losses = loops[me](
            params, tx.init(params), torch.as_tensor(xs),
            torch.as_tensor(ys), rng=0, state=None)
        return [new[k] for k in names]

    return steps, loops


def _jax_steps(jm, lr=0.1):
    from distkeras_tpu.ops.losses import get_loss
    from distkeras_tpu.ops.optimizers import get_optimizer
    from distkeras_tpu.workers import make_local_loop

    tx = get_optimizer("sgd", lr)
    treedef = jax.tree_util.tree_structure(jm.params)
    loop = jax.jit(make_local_loop(
        jm.module, get_loss("sparse_categorical_crossentropy"), tx))

    def steps(flat, batch):
        params = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(a) for a in flat])
        xs, ys = batch
        new, _opt, _st, _losses = loop(params, tx.init(params),
                                       jnp.asarray(xs), jnp.asarray(ys),
                                       jax.random.key(0), None)
        return [np.asarray(a) for a in jax.tree_util.tree_leaves(new)]

    return steps


@pytest.mark.parametrize("discipline", ["adag", "dynsgd", "aeasgd"])
def test_run_raced_one_worker_matches_jax(discipline):
    """One worker, each package's own local loop on the same MLP weights
    and batches: the final centers within rtol = atol = 1e-5."""
    from distkeras_tpu_torch.convert import params_from_jax

    jm, pm = _mlp_pair()
    batches = _blob_batches(1, 4)
    jleaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jm.params)]
    pleaves = [v.numpy() for v in pm.params.values()]
    jc, _ = jrace.run_raced(center=jleaves, local_steps=_jax_steps(jm),
                            worker_batches=batches, window=4,
                            discipline=discipline)
    pc, pps = prace.run_raced(center=pleaves, local_steps=_port_steps(pm)[0],
                              worker_batches=batches, window=4,
                              discipline=discipline, device="cpu")
    assert pps.commit_log == [0] * 4
    treedef = jax.tree_util.tree_structure(jm.params)
    ref = params_from_jax(jax.tree_util.tree_unflatten(treedef, jc),
                          pm.module)
    for (k, v), got in zip(ref.items(), pc):
        np.testing.assert_allclose(got, v.numpy(), err_msg=k, **TOL)
    assert not np.array_equal(pc[0], pleaves[0]), "the center moved"


@pytest.mark.parametrize("discipline", ["dynsgd", "aeasgd"])
def test_run_raced_realizes_staleness_and_converges(discipline):
    """W = 4 threads on the port's local loops (one per thread), the
    first round held at a barrier after the pulls and the second windows
    after the first commits: the first W commits realize staleness 0..W-1
    in commit order, every window commits once, later commits race, and
    the model learns the blobs."""
    W, rounds = 4, 6
    _jm, pm = _mlp_pair()
    steps, loops = _port_steps(pm, workers=W)
    batches = _blob_batches(W, rounds, seed=1)
    center, ps = prace.run_raced(
        center=[v.numpy() for v in pm.params.values()], local_steps=steps,
        worker_batches=batches, window=4, discipline=discipline,
        overlap_first_round=True, device="cpu")
    assert ps.commit_log[:W] == list(range(W))
    assert len(ps.commit_log) == W * rounds
    assert len(loops) == W, "one loop per worker thread"
    trained = pm.with_params({k: torch.as_tensor(a)
                              for k, a in zip(pm.params, center)})
    x = np.concatenate([b[0].reshape(-1, 4) for per in batches
                        for b in per])
    y = np.concatenate([b[1].reshape(-1) for per in batches for b in per])
    acc = float((trained.predict(x).argmax(-1).numpy() == y).mean())
    assert acc > 0.8, acc


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_raced_ps_close_makes_workers_exit_cleanly(pkg):
    """A closed server is typed-fatal, not silently absorbing: worker
    threads in a commit/pull loop exit with ``ServerClosedError`` instead
    of folding into a dead center forever; the center stays readable."""
    rng = np.random.default_rng(0)
    init = [rng.normal(size=(4, 3)).astype(np.float32)]
    if pkg == "jax":
        ps, closed = jrace.RacedParameterServer(init, "downpour"), JaxClosed
    else:
        ps = prace.RacedParameterServer(init, "downpour", device="cpu")
        closed = ServerClosedError
    started = threading.Barrier(3)
    errors: list = []
    done: list = []

    def worker():
        try:
            started.wait()
            while True:  # the forever-committing leaked worker
                pulled, counter = ps.pull()
                ps.commit([0.01 * np.sign(a) for a in pulled], counter)
        except closed:
            done.append(True)
        except Exception as e:  # pragma: no cover - would fail the test
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    started.wait()
    time.sleep(0.05)  # let commits genuinely race first
    ps.close()
    for t in threads:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in threads), "worker thread leaked"
    assert not errors, errors
    assert len(done) == 2
    assert len(ps.commit_log) > 0
    with pytest.raises(closed):
        ps.commit([np.zeros((4, 3), np.float32)], 0)
    with pytest.raises(closed):
        ps.pull()
    ps.center()


def test_local_steps_may_return_tensors():
    """A window that returns tensors (a port loop's output on any device)
    folds the same bits as one that returns their numpy copies."""
    steps_np = _numpy_window

    def steps_t(flat, b):
        return [torch.as_tensor(a) for a in _numpy_window(flat, b)]

    out = [prace.run_raced(center=_center(), local_steps=s,
                           worker_batches=[[1.0, 2.0]], window=2,
                           discipline="adag", device="cpu")[0]
           for s in (steps_np, steps_t)]
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
