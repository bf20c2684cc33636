"""Optimization-discipline folds (the port's counterpart of
``distkeras_tpu/parallel/disciplines.py``), over dicts of named tensors.

The reference implements each discipline twice — a worker half
(``distkeras/workers.py``: what to *commit*) and a server half
(``distkeras/parameter_servers.py``: how to *fold* a commit into the center
variable). Here :meth:`Discipline.commit` is the worker half for ONE worker
and :meth:`Discipline.fold` the server half for one round: every worker's
commit, summed in worker order, added to the center. Where the JAX package
sums across chips with a ``psum``, the port's workers share one device and
the sum is a plain ordered loop.

Commits within a round are modeled as serialized in worker order, which
makes staleness explicit (worker ``i``'s commit lands after ``i`` fresher
commits): the reference's nondeterministic race becomes a reproducible
schedule with the same aggregate semantics.

=========  ====================================================================
DOWNPOUR   commit Δ = w_local − w_pulled; server: center += Δ
ADAG       commit Δ/K (accumulated-gradient normalization); server: center += Δ/K
DynSGD     commit Δ; server: center += Δ · 1/(staleness+1)
AEASGD     commit e = α·(w_local − center); worker: w −= e; server: center += e
EAMSGD     AEASGD fold + momentum in the worker's local optimizer
Ensemble   no communication: workers train independently
=========  ====================================================================
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

Params = dict  # name -> tensor


class FoldResult(NamedTuple):
    center: Any
    locals_: list
    fold_state: Any


def _sub(a: Params, b: Params) -> Params:
    return {k: v - b[k] for k, v in a.items()}


def _scale(tree: Params, s: float) -> Params:
    return {k: v * s for k, v in tree.items()}


class Discipline:
    """Base fold rule: :meth:`commit` per worker, :meth:`fold` per round."""

    #: pull-based disciplines start every round from the center variable;
    #: elastic ones keep a persistent local replica.
    pulls_center: bool = True
    #: whether the fold communicates at all (EnsembleFold does not).
    communicates: bool = True

    def init_state(self, params) -> Any:
        return ()

    def commit(self, center, local, fold_state, *, worker_id, window,
               num_workers):
        """(commit, new_local) for ONE worker. ``worker_id`` is the global
        logical worker index."""
        raise NotImplementedError

    def advance(self, fold_state):
        """Fold-state transition, once per round (not per worker)."""
        return fold_state

    def fold(self, center: Params, locals_: Sequence[Params], fold_state, *,
             window: int, num_workers: int) -> FoldResult:
        """One round's server half: ``center += sum of every worker's
        commit``, summed in worker order (``locals_[w]`` is worker ``w``'s
        params after its K local steps). Pull-based disciplines hand every
        worker the new center."""
        if not self.communicates:
            return FoldResult(center, list(locals_), self.advance(fold_state))
        total, new_locals = None, []
        for w, local in enumerate(locals_):
            c, new_local = self.commit(center, local, fold_state, worker_id=w,
                                       window=window, num_workers=num_workers)
            total = c if total is None else {k: v + c[k]
                                             for k, v in total.items()}
            new_locals.append(new_local)
        new_center = {k: v + total[k] for k, v in center.items()}
        if self.pulls_center:
            new_locals = [new_center] * len(locals_)
        return FoldResult(new_center, new_locals, self.advance(fold_state))


class DownpourFold(Discipline):
    """DOWNPOUR (Dean et al.; reference ``DOWNPOURWorker`` +
    ``DeltaParameterServer.handle_commit: center += delta``)."""

    def commit(self, center, local, fold_state, *, worker_id, window,
               num_workers):
        return _sub(local, center), local


class ADAGFold(Discipline):
    """ADAG (Hermans; reference ``ADAGWorker`` + ``ADAGParameterServer``):
    the window-accumulated update normalized by the number of local
    steps."""

    def commit(self, center, local, fold_state, *, worker_id, window,
               num_workers):
        return _scale(_sub(local, center), 1.0 / float(window)), local


class DynSGDFold(Discipline):
    """DynSGD (reference ``DynSGDWorker`` + ``DynSGDParameterServer``):
    each commit scaled by ``1/(staleness+1)``. Commits serialize within a
    round and the order rotates by one each round: worker ``i``'s staleness
    at round ``r`` is ``(i + r) mod W`` with the global worker id, so every
    worker's data shard gets the same weight over any W consecutive rounds.
    ``fold_state`` is the round counter (an int)."""

    def init_state(self, params):
        return 0

    def commit(self, center, local, fold_state, *, worker_id, window,
               num_workers):
        staleness = float((int(worker_id) + int(fold_state)) % num_workers)
        return _scale(_sub(local, center), 1.0 / (staleness + 1.0)), local

    def advance(self, fold_state):
        return fold_state + 1


class AEASGDFold(Discipline):
    """Asynchronous elastic averaging SGD (Zhang et al.; reference
    ``AEASGDWorker`` + ``DeltaParameterServer``): ``e = α·(w − center)``,
    the worker moves ``w −= e`` and the center ``center += e``, with
    ``α = ρ·learning_rate``. Locals persist across rounds."""

    pulls_center = False

    def __init__(self, alpha: float = 0.05):
        if not (0.0 < alpha < 1.0):
            raise ValueError(
                f"elastic rate alpha={alpha} must be in (0, 1); alpha = rho * "
                "learning_rate (alpha >= 1 makes |local - center| grow every "
                "round)")
        self.alpha = alpha

    def commit(self, center, local, fold_state, *, worker_id, window,
               num_workers):
        elastic = _scale(_sub(local, center), self.alpha)
        return elastic, _sub(local, elastic)


class EAMSGDFold(AEASGDFold):
    """EAMSGD (reference ``EAMSGDWorker``): the AEASGD fold; the momentum
    lives in the worker's local optimizer, which the trainer configures."""


class EnsembleFold(Discipline):
    """No communication at all: workers train independently (reference
    ``EnsembleTrainer`` / the per-worker phase of ``AveragingTrainer``)."""

    pulls_center = False
    communicates = False


_DISCIPLINES = {
    "downpour": DownpourFold,
    "adag": ADAGFold,
    "dynsgd": DynSGDFold,
    "aeasgd": AEASGDFold,
    "eamsgd": EAMSGDFold,
    "ensemble": EnsembleFold,
}


def get_discipline(name: str, **kwargs) -> Discipline:
    try:
        return _DISCIPLINES[name.lower()](**kwargs)
    except KeyError:
        raise KeyError(f"unknown discipline {name!r}; known: "
                       f"{sorted(_DISCIPLINES)}") from None
