"""The port's discipline folds (``distkeras_tpu_torch/parallel/
disciplines.py``) against the JAX package's ``Discipline`` classes on the
same numpy params: each commit, the round's fold (the JAX ``psum`` of
commits becomes an in-order sum) and DynSGD's rotation with global worker
ids. f32; rtol 1e-6 (the same operations; sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.parallel import disciplines as JD
from distkeras_tpu_torch.parallel import disciplines as TD

NAMES = ["downpour", "adag", "dynsgd", "aeasgd", "eamsgd"]
W, WINDOW = 4, 3


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    center = {"w": rng.normal(size=(3, 2)).astype(np.float32),
              "b": rng.normal(size=(2,)).astype(np.float32)}
    locals_ = [{k: (v + rng.normal(size=v.shape) / 10).astype(np.float32)
                for k, v in center.items()} for _ in range(W)]
    return center, locals_


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(port, ref):
    for k in ref:
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", NAMES)
def test_commit_matches_jax(name):
    center, locals_ = _trees()
    jd, td = JD.get_discipline(name), TD.get_discipline(name)
    for fold_state in (0, 1, 5):
        for w in range(W):
            jc, jl = jd.commit(_j(center), _j(locals_[w]),
                               jnp.int32(fold_state), worker_id=jnp.int32(w),
                               window=WINDOW, num_workers=W)
            tc, tl = td.commit(_t(center), _t(locals_[w]), fold_state,
                               worker_id=w, window=WINDOW, num_workers=W)
            _close(tc, jc)
            _close(tl, jl)


@pytest.mark.parametrize("name", NAMES + ["ensemble"])
def test_round_fold_matches_jax_commit_sum(name):
    """Three rounds: center += sum of the JAX commits in worker order, the
    locals the discipline hands back, and the fold state advancing (DynSGD's
    staleness rotates by one each round)."""
    center, locals_ = _trees(1)
    jd, td = JD.get_discipline(name), TD.get_discipline(name)
    jstate, tstate = jd.init_state(center), td.init_state(center)
    jcenter, tcenter = _j(center), _t(center)
    for r in range(3):
        _, new = _trees(10 + r)
        res = td.fold(tcenter, [_t(n) for n in new], tstate, window=WINDOW,
                      num_workers=W)
        if jd.communicates:
            commits, jlocals = zip(*[
                jd.commit(jcenter, _j(new[w]), jstate, worker_id=jnp.int32(w),
                          window=WINDOW, num_workers=W) for w in range(W)])
            total = {k: sum(c[k] for c in commits) for k in center}
            jcenter = {k: jcenter[k] + total[k] for k in center}
            if jd.pulls_center:
                jlocals = [jcenter] * W
        else:
            jlocals = [_j(n) for n in new]
        _close(res.center, jcenter)
        for tl, jl in zip(res.locals_, jlocals):
            _close(tl, jl)
        jstate = jd.advance(jstate)
        if name == "dynsgd":
            assert res.fold_state == int(jstate) == r + 1
        tcenter, tstate = res.center, res.fold_state


def test_dynsgd_staleness_rotates_with_global_worker_ids():
    """Worker i's scale at round r is 1/(((i + r) mod W) + 1)."""
    td = TD.DynSGDFold()
    c = {"w": torch.zeros(1)}
    loc = {"w": torch.ones(1)}
    for r in range(W + 1):
        for i in range(W):
            commit, _ = td.commit(c, loc, r, worker_id=i, window=1,
                                  num_workers=W)
            assert commit["w"].item() == pytest.approx(
                1.0 / (((i + r) % W) + 1.0))


def test_elastic_rate_is_checked_and_names_are_known():
    with pytest.raises(ValueError, match="alpha"):
        TD.AEASGDFold(alpha=1.5)
    with pytest.raises(KeyError, match="unknown discipline"):
        TD.get_discipline("hogwild")
