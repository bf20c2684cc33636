"""The async-discipline engine: K local steps per worker + one fold per
round (the port's counterpart of ``distkeras_tpu/parallel/engine.py``
``AsyncEngine``)::

    round(center, locals, opt_state, batch[W, K, B, ...]):
        per worker: K minibatch steps              (workers.py)
        fold: the commits, summed in worker order  (disciplines.py)

State (:class:`EngineState`):

* ``center``    — the parameter server's center variable, a dict of tensors;
* ``locals_``   — ``[W]`` per-worker params (pull-based disciplines hand
  every worker the center at each fold; elastic ones keep their own);
* ``opt_state`` — ``[W]`` per-worker optimizer states (each reference worker
  compiled its own optimizer);
* ``fold_state`` and ``rng``: the discipline's round state and an int seed;
* ``model_state`` — ``[W]`` per-worker flat buffer dicts (BatchNorm
  running statistics; None for a stateless model): each worker threads
  its own through its window, and a discipline that ``syncs_state``
  replaces every worker's by their mean after the round.

Resilience (``resilience/``): a scheduled ``nan@R``/``inf@R`` batch fault
poisons one worker's rows of round R's staged batch (:func:`stage_round`),
the NaN guard skips the round, and the run loop's
:class:`~distkeras_tpu_torch.resilience.guard.RoundGuard` fires ``crash@R``
and ``kill@R`` before a round and the divergent-worker reset after it
(:meth:`AsyncEngine.reset_workers`). :meth:`AsyncEngine.host_state` and
:meth:`AsyncEngine.adopt_state` are the elastic re-topology: a checkpoint
written at one worker count resumed at another.

Across ranks (a ``torch.distributed`` group, ``runtime/mesh.py``) each
rank carries the global logical workers ``[rank*m, (rank+1)*m)``, as the
JAX package's ``local_worker_ids`` does: it runs them one after the other
on its device, sums their commits in worker order, and folds with ONE
all-reduce of that sum (``ops/collectives.py``), the JAX package's
``_multiplexed`` round and its single ``psum`` over the ``data`` axis. The
center becomes ``center + total``; the center itself is never
all-reduced. The ``[W]`` losses are all-gathered worker-major, so the NaN
guard and the :class:`RoundGuard` take the same branch on every rank.
:meth:`AsyncEngine.global_state` gathers every rank's ``[m]`` slices into
the ``[W]`` state a checkpoint holds, and :meth:`AsyncEngine.local_state`
keeps a rank's own. Without a group the world is one rank and all W
workers run on the model's device.

:class:`RoundEngine` is what this engine shares with
``parallel/sync.py SyncEngine``: the host copy of a round's batches, the
run loop (:func:`run_per_round`) and the open-ended one
(:meth:`RoundEngine.run_stream`, :func:`run_stream`: the JAX package's
``AsyncEngine.run_stream`` and ``SyncEngine.run_stream``).
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.data.batching import BatchPlan
from distkeras_tpu_torch.data.prefetch import RoundFeeder
from distkeras_tpu_torch.models.base import mean_buffers, state_buffers
from distkeras_tpu_torch.ops import collectives
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.optimizers import get_optimizer
from distkeras_tpu_torch.parallel import program
from distkeras_tpu_torch.parallel.disciplines import Discipline
from distkeras_tpu_torch.resilience import faults
from distkeras_tpu_torch.resilience.guard import (
    RoundGuard,
    nan_guard_enabled,
    note_losses,
)
from distkeras_tpu_torch.runtime import mesh
from distkeras_tpu_torch.workers import derive_seed, make_local_loop


class EngineState(NamedTuple):
    center: Any
    locals_: list
    opt_state: list
    fold_state: Any
    rng: int
    model_state: Any = None


def initial_buffers(model) -> Optional[dict]:
    """A copy of ``model``'s flat buffer dict (None when stateless): the
    state every worker starts from."""
    bufs = state_buffers(model.module, model.state)
    return {k: v.clone() for k, v in bufs.items()} or None


class RoundEngine:
    """The round loop both engines share. A subclass sets ``model`` and
    ``num_workers``, and defines ``init_state()``, ``_round_fn(state, xs,
    ys) -> (state, loss)`` on ``[m, K, B, ...]`` device batches (this
    rank's workers; all W without a group), and ``round_loss_shape``, the
    shape of one round's loss.

    ``local_workers`` are the global worker ids this rank carries
    (:func:`~distkeras_tpu_torch.runtime.mesh.local_worker_ids`)."""

    round_loss_shape: tuple = ()

    def _bind_ranks(self) -> None:
        """Place the W logical workers on the group's ranks: ``m`` a rank,
        this rank's ``local_workers`` (the reference's ``_mesh`` rule)."""
        self.workers_per_rank = mesh.workers_per_rank(self.num_workers)
        self.local_workers = mesh.local_worker_ids(self.num_workers)
        #: ranks of the group (1 without one); ``num_chips`` for the
        #: per-card metrics, as the JAX engines count chips
        self.num_chips = mesh.world_size()

    def _local_rows(self, xs, ys):
        """This rank's workers' rows of a ``[W, ...]`` host round."""
        if len(self.local_workers) == self.num_workers:
            return xs, ys
        lo, hi = self.local_workers[0], self.local_workers[-1] + 1
        return xs[lo:hi], ys[lo:hi]

    def _put_batch(self, xs: np.ndarray, ys: np.ndarray):
        return mesh.put_global((xs, ys), self.model.device)

    def global_state(self, state):
        """The state a checkpoint holds, the same on every rank (the
        rank's own state where nothing is per worker)."""
        return state

    def local_state(self, state):
        """This rank's part of a :meth:`global_state`."""
        return state

    def restore_target(self):
        """The structure a checkpoint of this engine restores into."""
        return self.init_state()

    # -- multi-round programs ------------------------------------------------
    def _program_device(self) -> torch.device:
        """The device this rank's rounds run on."""
        return self.model.device

    def _round_steps(self, xs: torch.Tensor) -> int:
        """Optimizer steps a round of the ``[n, m, K, B, ...]`` block
        ``xs`` takes: K."""
        return int(xs.shape[2])

    def _put_block(self, xs: np.ndarray, ys: np.ndarray):
        """A ``[n, m, K, B, ...]`` host block on this rank's device."""
        return mesh.put_global((xs, ys), self.model.device)

    def multi_round_fn(self, rounds: int):
        """The program of ``rounds`` consecutive rounds
        (:func:`make_multi_round_fn`): ``fn(state, xs, ys, rounds_left)
        -> (state, losses)`` over ``[rounds, m, K, B, ...]`` blocks,
        ``losses`` ``[rounds, *round_loss_shape]``, ``rounds_left`` the
        run's rounds from this block on. The same rounds as calling
        ``_round_fn`` ``rounds`` times, bit for bit; on the card one
        captured CUDA graph (``parallel/program.py``)."""
        return make_multi_round_fn(self, rounds)

    def run(
        self,
        plan: BatchPlan,
        state=None,
        start_round: int = 0,
        on_round: Optional[Callable] = None,
        rounds_per_program: "int | str" = 1,
    ):
        """Execute rounds ``start_round..num_rounds``; returns ``(state,
        losses)`` with ``losses`` a numpy array of the rounds' losses,
        ``[rounds, *round_loss_shape]``. ``on_round(r, loss, state)`` fires
        after each round.

        ``rounds_per_program`` (an int >= 1 or ``"auto"``, checked by the
        trainer that takes it from the user) runs that many rounds as one
        program (:func:`run_rounds`): one captured CUDA graph on the card,
        a host loop on the CPU. The losses and the final state are the
        per-round run's, bit for bit; only the block-final ``on_round``
        call of a block carries a state (interior calls get ``None``)."""
        if plan.num_workers != self.num_workers:
            raise ValueError(
                f"plan built for {plan.num_workers} workers, the engine has "
                f"{self.num_workers}")
        if state is None:
            state = self.init_state()
        return run_rounds(self, plan, state, start_round, on_round,
                          rounds_per_program)

    def run_stream(self, items, state=None, on_item=None, start_index=0,
                   max_items=None):
        """Train on an open-ended batch source (``(xs, ys)`` host batches
        shaped ``[W, K, B, ...]`` like one BatchPlan round) — no epoch
        schedule, no round count; see :func:`run_stream`."""
        return run_stream(self, items, state=state, on_item=on_item,
                          start_index=start_index, max_items=max_items)


class AsyncEngine(RoundEngine):
    """Runs a :class:`Discipline` over ``num_workers`` logical workers: all
    of them on the model's device, or ``m`` a rank across the group's
    ranks."""

    #: the process group a round's fold, losses and model-state mean run
    #: over (None: every rank of the world; the async x TP engine's
    #: ``data`` axis, ``parallel/async_tp.py``)
    _fold_pg = None

    def __init__(
        self,
        model,
        optimizer,
        loss,
        discipline: Discipline,
        window: int,
        num_workers: int = 1,
        learning_rate: float = 0.01,
        compute_dtype=None,
        seed: int = 0,
        per_worker_init: bool = False,
        grad_accum: int = 1,
        device_transform=None,
        nan_guard: Optional[bool] = None,
        divergence_reset: Optional[float] = None,
    ):
        if int(num_workers) < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.model = model
        self.discipline = discipline
        self.window = int(window)
        self.num_workers = int(num_workers)
        self._bind_ranks()
        self.seed = seed
        #: each replica starts from its own init draw (the Ensemble
        #: trainer's diversity) instead of a copy of the model's params.
        self.per_worker_init = bool(per_worker_init)
        #: NaN/Inf round skip: when any worker's round loss is non-finite
        #: the round keeps the previous state (one host read of the [W]
        #: loss vector per round). Default from DKTPU_NAN_GUARD.
        self.nan_guard = (nan_guard_enabled() if nan_guard is None
                          else bool(nan_guard))
        #: opt-in divergent-worker reset threshold (RoundGuard): a worker
        #: whose round loss strays further than this from the worker mean
        #: re-adopts the center. None = off (DKTPU_DIVERGENCE_RESET).
        self.divergence_reset = divergence_reset
        self.round_loss_shape = (self.num_workers,)
        #: the per-step on-device augmentation (``workers.py``)
        self.device_transform = device_transform
        self.tx = get_optimizer(optimizer, learning_rate)
        self.loss_fn = get_loss(loss)
        self._local_loop = make_local_loop(
            model.module, self.loss_fn, self.tx, compute_dtype=compute_dtype,
            state_collections=model.state_collections, grad_accum=grad_accum,
            input_transform=device_transform,
            normalize_uint8=getattr(model, "normalize_uint8", True),
        )

    def init_state(self) -> EngineState:
        """This rank's workers start from a copy of the model's parameters
        (with ``per_worker_init``, worker ``i`` from its own draw
        ``model.reinit_params(seed * 1009 + 1 + i)``, ``i`` global), with a
        fresh optimizer state."""
        center = {k: v.clone() for k, v in self.model.params.items()}
        W = len(self.local_workers)
        if self.per_worker_init:
            # Ensemble semantics: init diversity is the point (reference:
            # per-executor deserialization + uniform_weights).
            locals_ = [self.model.reinit_params(self.seed * 1009 + 1 + i)
                       for i in self.local_workers]
        else:
            locals_ = [center] * W
        bufs = initial_buffers(self.model)
        return EngineState(
            center=center,
            locals_=locals_,
            opt_state=[self.tx.init(center) for _ in range(W)],
            fold_state=self.discipline.init_state(center),
            rng=int(self.seed),
            model_state=None if bufs is None else [
                {k: v.clone() for k, v in bufs.items()} for _ in range(W)],
        )

    def host_state(self, num_workers: int) -> EngineState:
        """The restore target for a checkpoint written at ``num_workers``:
        this engine's state structure with ``num_workers`` per-worker
        entries, its tensors on the ``meta`` device (shapes and dtypes
        only; nothing is allocated until the restore reads the file)."""
        center = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in self.model.params.items()}
        W = int(num_workers)
        bufs = state_buffers(self.model.module, self.model.state)
        return EngineState(
            center=center,
            locals_=[dict(center) for _ in range(W)],
            opt_state=[self.tx.init(center) for _ in range(W)],
            fold_state=self.discipline.init_state(center),
            rng=int(self.seed),
            model_state=[{k: torch.empty(v.shape, dtype=v.dtype,
                                         device="meta")
                          for k, v in bufs.items()}
                         for _ in range(W)] if bufs else None,
        )

    def adopt_state(self, host: EngineState) -> EngineState:
        """Re-topologize a restored host state (:meth:`host_state`'s
        structure, any worker count) onto this rank's workers: the
        elastic resume after a resize (of the workers or of the ranks).
        Reference semantics: a (re)joining worker pulls the center
        variable, so every replica restarts from the restored center with
        a fresh optimizer state. The center, the fold state and the rng
        carry over exactly; the model state (BatchNorm statistics) is the
        mean of every saved worker's, on every worker."""
        dev = self.model.device
        center = {k: v.to(dev) for k, v in host.center.items()}
        W = len(self.local_workers)
        mean = (None if not host.model_state else
                {k: v.to(dev) for k, v in
                 mean_buffers(host.model_state).items()})
        return EngineState(
            center=center,
            locals_=[center] * W,
            opt_state=[self.tx.init(center) for _ in range(W)],
            fold_state=host.fold_state,
            rng=int(host.rng),
            model_state=None if mean is None else [
                {k: v.clone() for k, v in mean.items()} for _ in range(W)],
        )

    def reset_workers(self, state: EngineState, worker_mask) -> EngineState:
        """Re-join the masked workers from the center (the divergent-worker
        reset). Reference semantics are the rejoining-worker PS pull:
        masked replicas take the center's params and a fresh optimizer
        state; unmasked workers, the center, the fold state and the rng are
        untouched. ``worker_mask`` is a host ``[W]`` bool array over the
        global workers (every rank reads the same gathered losses); a rank
        applies its own workers' entries."""
        mask = np.asarray(worker_mask, dtype=bool)
        if mask.shape != (self.num_workers,):
            raise ValueError(
                f"worker_mask must be [{self.num_workers}], got {mask.shape}")
        mask = mask[self.local_workers]
        return state._replace(
            locals_=[state.center if m else p
                     for m, p in zip(mask, state.locals_)],
            opt_state=[self.tx.init(state.center) if m else o
                       for m, o in zip(mask, state.opt_state)])

    def global_state(self, state: EngineState) -> EngineState:
        """The ``[W]`` state of every rank, on every rank: each rank's
        ``[m]`` locals, optimizer states and model states gathered in rank
        order (the center, the fold state and the rng are the same on
        every rank). A pull discipline's locals are the center. Without a
        group, the state itself."""
        if not mesh.group_active():
            return state
        dev = self.model.device

        def gather(xs):
            host = [_to(x, "cpu") for x in xs]
            return [_to(x, dev) for part in collectives.all_gather_object(host)
                    for x in part]

        locals_ = ([state.center] * self.num_workers
                   if self.discipline.pulls_center
                   else gather(state.locals_))
        return state._replace(
            locals_=locals_, opt_state=gather(state.opt_state),
            model_state=(None if state.model_state is None
                         else gather(state.model_state)))

    def local_state(self, state: EngineState) -> EngineState:
        """This rank's ``[m]`` slices of a ``[W]`` :meth:`global_state`."""
        if len(state.locals_) == len(self.local_workers):
            return state
        lo, hi = self.local_workers[0], self.local_workers[-1] + 1
        return state._replace(
            locals_=list(state.locals_[lo:hi]),
            opt_state=list(state.opt_state[lo:hi]),
            model_state=(None if state.model_state is None
                         else list(state.model_state[lo:hi])))

    def restore_target(self) -> EngineState:
        """:meth:`init_state` with ``[W]`` per-worker entries (the structure
        :meth:`global_state` writes)."""
        init = self.init_state()
        W = self.num_workers
        if len(init.locals_) == W:
            return init
        return init._replace(
            locals_=[init.locals_[0]] * W,
            opt_state=[init.opt_state[0]] * W,
            model_state=(None if init.model_state is None
                         else [init.model_state[0]] * W))

    def _worker_seed(self, rng: int, worker: int) -> int:
        """The seed of ``worker``'s window this round."""
        return derive_seed(rng, worker)

    def _worker_context(self):
        """What the workers' local steps run inside (the model-parallel
        axes of ``parallel/async_tp.py``; nothing here)."""
        return contextlib.nullcontext()

    @program.captured
    def _round_fn(self, state: EngineState, xs: torch.Tensor,
                  ys: torch.Tensor):
        """One fold round on this rank's ``[m, K, B, ...]`` batches: returns
        the new state and the ``[W]`` per-worker window-mean losses of every
        rank, worker-major."""
        disc = self.discipline
        pg = self._fold_pg
        new_locals, new_opts, new_bufs, losses = [], [], [], []
        with self._worker_context():
            for j, w in enumerate(self.local_workers):
                start = (state.center if disc.pulls_center
                         else state.locals_[j])
                params, opt, bufs, step_losses = self._local_loop(
                    start, state.opt_state[j], xs[j], ys[j],
                    rng=self._worker_seed(state.rng, w),
                    state=(None if state.model_state is None
                           else state.model_state[j]))
                new_locals.append(params)
                new_opts.append(opt)
                new_bufs.append(bufs)
                losses.append(step_losses.mean())
        # all_gather gives [ranks, m]; worker-major reshape -> [W]
        loss = collectives.all_gather(torch.stack(losses),
                                      group=pg).reshape(-1)
        next_rng = derive_seed(state.rng)
        if self.nan_guard and not program.in_program():
            # The round's one host read of the [W] losses; the divergence
            # reset reads this same host copy. Never inside a capture: a
            # program's round takes the select below.
            loss = loss.cpu()  # dk: disable=DK102
            if not bool(torch.isfinite(loss).all()):
                # One worker's non-finite commit would poison the center for
                # every worker: the whole round is discarded, the previous
                # state carries forward, and the loss keeps the NaN for
                # accounting.
                return state._replace(rng=next_rng), loss
        new_state = self._fold_round(state, new_locals, new_opts, new_bufs,
                                     next_rng)
        if self.nan_guard and program.in_program():
            # Inside a program the same skip is a select on the device.
            new_state = program.select(torch.isfinite(loss).all(), new_state,
                                       state._replace(rng=next_rng))
        return new_state, loss

    def _fold_round(self, state: EngineState, new_locals, new_opts, new_bufs,
                    next_rng) -> EngineState:
        """The round's server half: the fold and the model-state mean."""
        disc = self.discipline
        pg = self._fold_pg
        fold = disc.fold(state.center, new_locals, state.fold_state,
                         window=self.window, num_workers=self.num_workers,
                         worker_ids=self.local_workers,
                         reduce=lambda t: collectives.all_reduce(
                             t, "sum", group=pg))
        model_state = None
        if state.model_state is not None:
            model_state = new_bufs
            if disc.syncs_state:
                # Running statistics average over the workers (they are
                # not gradient-like deltas): the rank's m workers, then the
                # ranks. Ensemble members keep their own.
                mean = collectives.all_reduce(mean_buffers(new_bufs), "mean",
                                              group=pg)
                model_state = [mean] * len(self.local_workers)
        return EngineState(fold.center, fold.locals_, new_opts,
                           fold.fold_state, next_rng, model_state)


def _to(tree, device):
    """``tree`` (dicts, lists, tuples and NamedTuples over tensors and
    scalars) with every tensor on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def _poison_rows(x: torch.Tensor, kind: str, idx: int) -> torch.Tensor:
    """A copy of the staged batch ``x`` with worker slice ``idx`` (leading
    axis) multiplied by NaN/Inf, so the values, and everything backprop
    touches, go non-finite. Non-float batches (token ids) cannot carry a
    NaN: that misfire warns instead of silently consuming the one-shot
    fault."""
    if not x.is_floating_point():
        warnings.warn(
            f"{kind}@ batch fault scheduled on a non-float batch "
            f"(dtype {x.dtype}): cannot poison token ids — the fault is "
            "consumed with no effect", stacklevel=2)
        return x
    x = x.clone()  # the staged tensor may share the plan's host memory
    x[idx] *= float("nan") if kind == "nan" else float("inf")
    return x


def _maybe_poison_round(r: int, xs: torch.Tensor,
                        local_workers=None, num_workers=None) -> torch.Tensor:
    """Apply any scheduled nan/inf batch fault for round ``r`` (one-shot).
    The poisoned worker is drawn over the ``num_workers`` global workers;
    ``xs`` holds ``local_workers``' rows (all of them by default), and a
    rank that does not carry the poisoned worker consumes the fault with
    nothing to poison: the gathered losses still skip the round on every
    rank."""
    fp = faults.active_plan()
    if fp is None:
        return xs
    kind = fp.batch_fault(r)
    if kind is None:
        return xs
    W = int(xs.shape[0]) if num_workers is None else int(num_workers)
    w = fp.poison_worker(r, W)
    if local_workers is None:
        return _poison_rows(xs, kind, w)
    if w not in local_workers:
        return xs
    return _poison_rows(xs, kind, local_workers.index(w))


def stage_round(engine, plan, r: int):
    """Gather and device-stage round ``r``'s batch for this rank's
    workers; any scheduled ``nan@r``/``inf@r`` fault poisons the staged
    features here, the one choke point every engine's staging passes
    through. An in-RAM plan is sliced from ``plan.round(r)``; a sharded
    plan (``is_local``) across ranks gathers only this rank's workers'
    rows from disk (``round_local``), as the JAX package's
    ``_stage_round_raw`` does on a multi-process mesh."""
    lw = engine.local_workers
    if len(lw) == engine.num_workers:
        xs, ys = plan.round(r)
    elif getattr(plan, "is_local", False):
        xs, ys = plan.round_local(r, lw)
    else:
        xs, ys = engine._local_rows(*plan.round(r))
    xs, ys = engine._put_batch(xs, ys)
    return _maybe_poison_round(r, xs, lw, engine.num_workers), ys


def _maybe_poison_block(rs, xs: torch.Tensor, local_workers=None,
                        num_workers=None) -> torch.Tensor:
    """The block twin of :func:`_maybe_poison_round` over ``[n, m, ...]``:
    round ``rs[j]``'s fault poisons row ``j`` of the block, as it would
    have poisoned that round staged alone."""
    fp = faults.active_plan()
    if fp is None:
        return xs
    for j, r in enumerate(rs):
        row = xs[j]
        poisoned = _maybe_poison_round(r, row, local_workers, num_workers)
        if poisoned is not row:
            xs = xs.clone()
            xs[j] = poisoned
    return xs


def stage_block(engine, plan, rs) -> tuple:
    """Gather and device-stage the rounds ``rs`` as one ``[n, m, K, B,
    ...]`` block (this rank's workers at dim 1), with any ``nan@r`` /
    ``inf@r`` fault of those rounds in its row. A step engine stages the
    block in its own layout (``_stage_block``, ``parallel/runner.py``)."""
    hook = getattr(engine, "_stage_block", None)
    if hook is not None:
        return hook(plan, rs)
    lw = engine.local_workers
    rounds = []
    for r in rs:
        if len(lw) == engine.num_workers:
            rounds.append(plan.round(r))
        elif getattr(plan, "is_local", False):
            rounds.append(plan.round_local(r, lw))
        else:
            rounds.append(engine._local_rows(*plan.round(r)))
    xs, ys = engine._put_block(np.stack([b[0] for b in rounds]),
                               np.stack([b[1] for b in rounds]))
    return _maybe_poison_block(list(rs), xs, lw, engine.num_workers), ys


def run_rounds(engine, plan, state, start_round, on_round, rounds_per_program,
               stage=None):
    """Dispatch to the per-round, blocked or auto-sized run loop (shared by
    every engine). ``rounds_per_program`` is an int (R rounds a program)
    or ``"auto"``: probe the per-round wall time and pick R to fill
    ``_AUTO_TARGET_S`` of device work a program. The result is the same
    either way (see :func:`make_multi_round_fn`). ``stage(r)`` stages one
    round for the per-round loop (default :func:`stage_round`)."""
    with telemetry.get().span("engine_run"):
        if rounds_per_program == "auto":
            state, losses = run_auto(engine, plan, state, start_round,
                                     on_round, stage=stage)
        elif int(rounds_per_program) > 1:
            state, losses = run_blocked(engine, plan, state, start_round,
                                        on_round, int(rounds_per_program))
        else:
            state, losses = run_per_round(engine, plan, state, start_round,
                                          on_round, stage=stage)
    # The rounds the NaN guard skipped show up here as non-finite rows.
    note_losses(losses)
    return state, losses


def run_per_round(engine, plan, state, start_round, on_round, stage=None):
    """One round per host iteration, with the next rounds' batches gathered
    and copied to the device by a :class:`RoundFeeder`: ``stage(r)``, by
    default :func:`stage_round` (the step engines give their own rows and
    sequence blocks, ``parallel/runner.py``). The run's
    :class:`RoundGuard` fires any ``crash@R``/``kill@R`` before round R and
    may replace the state after it (the divergent-worker reset). Returns
    ``(state, losses)``, ``losses`` the ``[rounds,
    *engine.round_loss_shape]`` host array."""
    tele = telemetry.get()
    guard = RoundGuard(engine)
    losses = []
    if stage is None:
        def stage(r):
            return stage_round(engine, plan, r)
    feeder = RoundFeeder(plan.num_rounds, stage, start_round=start_round)
    try:
        for r, (xs, ys) in feeder:
            guard.pre_round(r)  # crash/kill fault injection, if scheduled
            with tele.span("dispatch[per-round]"):
                new_state, loss = engine._round_fn(state, xs, ys)
            losses.append(loss)
            if on_round is not None:
                on_round(r, loss, new_state)
            # Divergent-worker reset (a no-op unless enabled).
            state = guard.post_round(r, loss, new_state)
    except BaseException:
        # A crash mid-run still accounts the rounds already run (the
        # supervised recovery reads resilience.nonfinite_rounds for faults
        # that landed before the crash).
        with contextlib.suppress(Exception):
            note_losses(torch.stack(losses).cpu().numpy())
        raise
    finally:
        feeder.close()
        _record_feed_waits(engine, feeder)
    with tele.span("retire[per-round]"):
        host = (torch.stack(losses).cpu().numpy() if losses
                else np.zeros((0, *engine.round_loss_shape), np.float32))
    return state, host


def _record_feed_waits(engine, *feeders) -> None:
    """input_stall: the time the run loop sat blocked on the data plane,
    the compute-vs-data split. ``engine.feed_waits`` are the per-round
    (per-block) waits, ``engine.feed_wait_seconds`` the feeders' running
    sum, which keeps counting the waits an open-ended stream evicts from
    the bounded ``feeder.waits``."""
    engine.feed_waits = [w for f in feeders for w in f.waits]
    engine.feed_wait_seconds = float(sum(f.wait_seconds for f in feeders))
    tele = telemetry.get()
    stall = tele.histogram("input_stall")
    for w in engine.feed_waits:
        stall.observe(w)
    tele.counter("input_stall_seconds").add(engine.feed_wait_seconds)


#: auto-R sizing (the JAX package's constants). The probe measures the
#: steady per-round cost over a run of rounds with one fence at its end;
#: R then targets ~64 ms of device work a program, at most 64 rounds and
#: at most 256 MB of staged block.
_AUTO_MAX_R = 64
_AUTO_BLOCK_BYTES = 256e6
_AUTO_PROBE_ROUNDS = 15
_AUTO_TARGET_S = 0.064


def _auto_size_r(steady_s: float, round_bytes: int) -> int:
    """Rounds a program from a measured steady per-round time and the
    bytes one round stages. In a group every rank must run the same
    programs (a different R is a different sequence of collectives), but
    the clocks differ: rank 0's R is broadcast to every rank."""
    R = max(1, min(_AUTO_MAX_R,
                   max(1, int(_AUTO_BLOCK_BYTES / max(round_bytes, 1))),
                   int(np.ceil(_AUTO_TARGET_S / max(steady_s, 1e-6)))))
    if mesh.group_active():
        R = int(collectives.broadcast_object(int(R), src=0))
    return R


def _fence(x) -> None:
    """Wait for the device work behind ``x`` (a tensor, or a tuple whose
    last item is one)."""
    if isinstance(x, tuple):
        x = x[-1]
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def probe_steady(dispatch_round, n: int = _AUTO_PROBE_ROUNDS) -> float:
    """Steady per-round seconds: ``n`` calls of ``dispatch_round()`` and
    one fence at the end (on the value of the last)."""
    t0 = time.perf_counter()
    fence = None
    for _ in range(n):
        fence = dispatch_round()
    _fence(fence)
    return max((time.perf_counter() - t0) / n, 1e-6)


def run_auto(engine, plan, state, start_round, on_round, stage=None):
    """``rounds_per_program="auto"``: round ``start_round`` alone (its
    first calls), then ``_AUTO_PROBE_ROUNDS`` probe rounds per round with
    one fence, then the rest in blocks of ``R = _auto_size_r(steady,
    round_bytes)`` rounds. The losses and the final state are any fixed-R
    run's. ``on_round`` sees the probe rounds after the probe, only the
    last of them with a state; a run resumed past its end returns an
    empty history."""
    shape = (0, *engine.round_loss_shape)
    if start_round >= plan.num_rounds:
        return state, np.zeros(shape, np.float32)
    if stage is None:
        def stage(r):
            return stage_round(engine, plan, r)
    tele = telemetry.get()
    guard = RoundGuard(engine)
    losses = []
    r = start_round
    xs, ys = stage(r)
    guard.pre_round(r)
    with tele.span("dispatch[auto]"):
        state, loss = engine._round_fn(state, xs, ys)
    losses.append(loss)
    if on_round is not None:
        on_round(r, loss, state)
    state = guard.post_round(r, loss, state)
    r += 1
    _fence(loss)
    # The probe: rounds with one fence at the end; callbacks wait until
    # after it (a callback that reads the loss would fence every round).
    pending = []
    n = 0
    round_bytes = 1
    t0 = time.perf_counter()
    while r < plan.num_rounds and n < _AUTO_PROBE_ROUNDS:
        xs, ys = stage(r)
        round_bytes = int(xs.nbytes + ys.nbytes)
        guard.pre_round(r)
        with tele.span("dispatch[auto]"):
            state, loss = engine._round_fn(state, xs, ys)
        state = guard.post_round(r, loss, state)
        losses.append(loss)
        pending.append(r)
        r += 1
        n += 1
    steady = 1e-6
    if n:
        _fence(loss)
        steady = max((time.perf_counter() - t0) / n, 1e-6)
    head = torch.stack([x.cpu() for x in losses]).numpy()
    if on_round is not None:
        for i, rr in enumerate(pending):
            on_round(rr, head[1 + i], state if i == len(pending) - 1 else None)
    if r >= plan.num_rounds:
        return state, head
    # rounds left is the same on every rank, so the clamp keeps the
    # broadcast R agreed
    R = min(_auto_size_r(steady, round_bytes), plan.num_rounds - r)
    engine.auto_rounds_per_program = R
    state, rest = run_blocked(engine, plan, state, r, on_round, R,
                              mode="auto")
    return state, np.concatenate([head, rest], axis=0)


def run_blocked(engine, plan, state, start_round, on_round, R,
                mode="blocked"):
    """The run loop with ``R`` rounds a program (one call of
    ``engine.multi_round_fn(n)`` a block; the last block may be shorter).
    The losses are the per-round path's; ``on_round`` fires once a round,
    but only the block-final call carries a state (interior rounds'
    states never exist outside the program). Crash and kill faults land at
    the boundary of the block holding their round; the divergence reset
    runs once a block, on its last round's losses. ``mode`` names the
    spans, ``dispatch[<mode>]`` and ``retire[<mode>]`` ("blocked", or
    "auto" when :func:`run_auto` sized R). The first block is staged
    before the rest's feeder starts, so a program's capture never runs
    beside the feeder's staging."""
    tele = telemetry.get()
    guard = RoundGuard(engine)
    auto = mode == "auto"
    tele.gauge("program.rounds_per_program").set(R)
    starts = list(range(start_round, plan.num_rounds, R))
    shape = (0, *engine.round_loss_shape)
    if not starts:
        return state, np.zeros(shape, np.float32)

    def stage(i):
        rs = range(starts[i], min(starts[i] + R, plan.num_rounds))
        return stage_block(engine, plan, rs)

    losses: list = []
    # Two feeders: the first block's, done before its program runs (and is
    # captured), and the rest's, which starts once the first block ran.
    feeders = (RoundFeeder(1, stage),
               RoundFeeder(len(starts), stage, start_round=1))

    def blocks():
        for feeder in feeders:
            yield from feeder

    try:
        for i, (xs, ys) in blocks():
            n = int(xs.shape[0])
            for rr in range(starts[i], starts[i] + n):
                guard.pre_round(rr)
            with (tele.span("dispatch[auto]") if auto
                  else tele.span("dispatch[blocked]")):
                new_state, block_losses = engine.multi_round_fn(n)(
                    state, xs, ys, plan.num_rounds - starts[i])
            with (tele.span("retire[auto]") if auto
                  else tele.span("retire[blocked]")):
                host = block_losses.cpu().numpy()
            losses.append(host)
            if on_round is not None:
                for j in range(n):
                    on_round(starts[i] + j, host[j],
                             new_state if j == n - 1 else None)
            state = guard.post_round(starts[i] + n - 1, block_losses[-1],
                                     new_state, host_loss=host[-1])
    except BaseException:
        with contextlib.suppress(Exception):
            if losses:
                note_losses(np.concatenate(losses, axis=0))
        raise
    finally:
        for feeder in feeders:
            feeder.close()
        _record_feed_waits(engine, *feeders)
    return state, np.concatenate(losses, axis=0)


def make_multi_round_fn(engine, rounds: int):
    """The engine's cached program of ``rounds`` rounds
    (``parallel/program.py Program``; ``engine._multi_fns``, as the JAX
    package caches its jitted scans)."""
    fns = getattr(engine, "_multi_fns", None)
    if fns is None:
        fns = engine._multi_fns = {}
    fn = fns.get(rounds)
    if fn is None:
        fn = fns[rounds] = program.Program(engine, rounds)
    return fn


def run_stream(engine, items, state=None, on_item=None, start_index=0,
               max_items=None, fetch_every=64):
    """Run an **open-ended** item source through an engine's round function.

    Where :func:`run_per_round` walks a BatchPlan's fixed epoch schedule,
    this loop has no epoch bookkeeping at all: ``items`` is any iterable of
    host batches ``(xs, ys)`` — including an unbounded live stream — staged
    through the same :class:`RoundFeeder` lookahead (so stream stalls hit
    the stall watchdog and surface as ``FeederStalledError``, exactly like
    a dried-up BatchPlan gather), and each item runs between the run's
    :class:`RoundGuard` ``pre_round`` (``crash@i``/``kill@i``) and
    ``post_round`` (the divergent-worker reset). Both engines run through
    here unchanged: each only needs its ``_round_fn(state, xs, ys)``.

    ``on_item(i, loss, state)`` sees the round's loss as the round returns
    it (on the device unless the engine's NaN guard read it to the host).
    ``max_items`` bounds consumption of an endless source (tests, bounded
    sessions); losses are fetched to the host in chunks of
    ``fetch_every``, so an unbounded run holds O(fetch_every) device
    scalars, not O(items), and :func:`note_losses` counts the non-finite
    items on the way out, also when the run raises. Returns ``(state,
    host_losses)`` for the items actually consumed, ``[items,
    *engine.round_loss_shape]`` (the JAX package's flattens the async
    engine's ``[W]`` per-item losses into one axis; here an item stays a
    row, so :func:`note_losses` counts items, not workers)."""
    import itertools

    tele = telemetry.get()
    guard = RoundGuard(engine)
    if state is None:
        state = engine.init_state()
    if max_items is not None:
        items = itertools.islice(items, max_items)
    host: list = []
    pending: list = []

    def drain() -> None:
        if pending:
            host.extend(torch.stack(pending).cpu().numpy())
            pending.clear()

    feeder = RoundFeeder(
        items, lambda batch: engine._put_batch(*engine._local_rows(*batch)),
        start_round=start_index)
    with tele.span("engine_run"):
        try:
            for i, (xs, ys) in feeder:
                guard.pre_round(i)  # crash/kill fault injection
                with tele.span("dispatch[stream]"):
                    new_state, loss = engine._round_fn(state, xs, ys)
                pending.append(loss)
                if on_item is not None:
                    on_item(i, loss, new_state)
                state = guard.post_round(i, loss, new_state)
                if len(pending) >= fetch_every:
                    # The incremental fetch bounds the live device losses
                    # an endless run holds.
                    with tele.span("retire[stream]"):
                        drain()
        except BaseException:
            with contextlib.suppress(Exception):
                drain()
                note_losses(np.asarray(host))
            raise
        finally:
            feeder.close()
            _record_feed_waits(engine, feeder)
    with tele.span("retire[stream]"):
        drain()
    losses = (np.asarray(host, np.float32) if host
              else np.zeros((0, *engine.round_loss_shape), np.float32))
    note_losses(losses)
    return state, losses
