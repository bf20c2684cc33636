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
* ``fold_state`` and ``rng``: the discipline's round state and an int seed.

Resilience (``resilience/``): a scheduled ``nan@R``/``inf@R`` batch fault
poisons one worker's rows of round R's staged batch (:func:`stage_round`),
the NaN guard skips the round, and the run loop's
:class:`~distkeras_tpu_torch.resilience.guard.RoundGuard` fires ``crash@R``
and ``kill@R`` before a round and the divergent-worker reset after it
(:meth:`AsyncEngine.reset_workers`). :meth:`AsyncEngine.host_state` and
:meth:`AsyncEngine.adopt_state` are the elastic re-topology: a checkpoint
written at one worker count resumed at another.

All W logical workers are multiplexed on the model's one device, one after
the other, as the JAX package's ``_multiplexed`` round runs the workers a
chip carries; the all-reduce over chips (multi-card NCCL) is a later slice.

:class:`RoundEngine` is what this engine shares with
``parallel/sync.py SyncEngine``: the host copy of a round's batches and the
run loop (:func:`run_per_round`).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.data.batching import BatchPlan
from distkeras_tpu_torch.data.prefetch import RoundFeeder
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.optimizers import get_optimizer
from distkeras_tpu_torch.parallel.disciplines import Discipline
from distkeras_tpu_torch.resilience import faults
from distkeras_tpu_torch.resilience.guard import (
    RoundGuard,
    nan_guard_enabled,
    note_losses,
)
from distkeras_tpu_torch.workers import derive_seed, make_local_loop


class EngineState(NamedTuple):
    center: Any
    locals_: list
    opt_state: list
    fold_state: Any
    rng: int


class RoundEngine:
    """The round loop both engines share. A subclass sets ``model`` and
    ``num_workers``, and defines ``init_state()``, ``_round_fn(state, xs,
    ys) -> (state, loss)`` on ``[W, K, B, ...]`` device batches, and
    ``round_loss_shape``, the shape of one round's loss."""

    round_loss_shape: tuple = ()

    def _put_batch(self, xs: np.ndarray, ys: np.ndarray):
        dev = self.model.device
        return torch.as_tensor(xs).to(dev), torch.as_tensor(ys).to(dev)

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
        trainer that takes it from the user) is accepted as in the JAX
        package and, as there, does not change the result. It has nothing
        to block here: eager PyTorch compiles no program, so every round is
        one host iteration whatever its value."""
        if plan.num_workers != self.num_workers:
            raise ValueError(
                f"plan built for {plan.num_workers} workers, the engine has "
                f"{self.num_workers}")
        if state is None:
            state = self.init_state()
        with telemetry.get().span("engine_run"):
            state, losses = run_per_round(self, plan, state, start_round,
                                          on_round)
        note_losses(losses)
        return state, losses


class AsyncEngine(RoundEngine):
    """Runs a :class:`Discipline` over ``num_workers`` logical workers on
    the model's device."""

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
        self.tx = get_optimizer(optimizer, learning_rate)
        self.loss_fn = get_loss(loss)
        self._local_loop = make_local_loop(
            model.module, self.loss_fn, self.tx, compute_dtype=compute_dtype,
            state_collections=model.state_collections, grad_accum=grad_accum,
            input_transform=device_transform,
            normalize_uint8=getattr(model, "normalize_uint8", True),
        )

    def init_state(self) -> EngineState:
        """Every worker starts from a copy of the model's parameters (with
        ``per_worker_init``, worker ``i`` from its own draw
        ``model.reinit_params(seed * 1009 + 1 + i)``), with a fresh
        optimizer state."""
        center = {k: v.clone() for k, v in self.model.params.items()}
        W = self.num_workers
        if self.per_worker_init:
            # Ensemble semantics: init diversity is the point (reference:
            # per-executor deserialization + uniform_weights).
            locals_ = [self.model.reinit_params(self.seed * 1009 + 1 + i)
                       for i in range(W)]
        else:
            locals_ = [center] * W
        return EngineState(
            center=center,
            locals_=locals_,
            opt_state=[self.tx.init(center) for _ in range(W)],
            fold_state=self.discipline.init_state(center),
            rng=int(self.seed),
        )

    def host_state(self, num_workers: int) -> EngineState:
        """The restore target for a checkpoint written at ``num_workers``:
        this engine's state structure with ``num_workers`` per-worker
        entries, its tensors on the ``meta`` device (shapes and dtypes
        only; nothing is allocated until the restore reads the file)."""
        center = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in self.model.params.items()}
        W = int(num_workers)
        return EngineState(
            center=center,
            locals_=[dict(center) for _ in range(W)],
            opt_state=[self.tx.init(center) for _ in range(W)],
            fold_state=self.discipline.init_state(center),
            rng=int(self.seed),
        )

    def adopt_state(self, host: EngineState) -> EngineState:
        """Re-topologize a restored host state (:meth:`host_state`'s
        structure, any worker count) onto this engine's workers: the
        elastic resume after a resize. Reference semantics: a (re)joining
        worker pulls the center variable, so every replica restarts from
        the restored center with a fresh optimizer state. The center, the
        fold state and the rng carry over exactly. (The JAX package also
        averages the replicas' model state, BatchNorm statistics; no model
        of the port has such state collections, so there is nothing to
        average here.)"""
        dev = self.model.device
        center = {k: v.to(dev) for k, v in host.center.items()}
        W = self.num_workers
        return EngineState(
            center=center,
            locals_=[center] * W,
            opt_state=[self.tx.init(center) for _ in range(W)],
            fold_state=host.fold_state,
            rng=int(host.rng),
        )

    def reset_workers(self, state: EngineState, worker_mask) -> EngineState:
        """Re-join the masked workers from the center (the divergent-worker
        reset). Reference semantics are the rejoining-worker PS pull:
        masked replicas take the center's params and a fresh optimizer
        state; unmasked workers, the center, the fold state and the rng are
        untouched. ``worker_mask`` is a host ``[W]`` bool array."""
        mask = np.asarray(worker_mask, dtype=bool)
        if mask.shape != (self.num_workers,):
            raise ValueError(
                f"worker_mask must be [{self.num_workers}], got {mask.shape}")
        return state._replace(
            locals_=[state.center if m else p
                     for m, p in zip(mask, state.locals_)],
            opt_state=[self.tx.init(state.center) if m else o
                       for m, o in zip(mask, state.opt_state)])

    def _round_fn(self, state: EngineState, xs: torch.Tensor,
                  ys: torch.Tensor):
        """One fold round on ``[W, K, B, ...]`` batches: returns the new
        state and the ``[W]`` per-worker window-mean losses."""
        disc = self.discipline
        new_locals, new_opts, losses = [], [], []
        for w in range(self.num_workers):
            start = state.center if disc.pulls_center else state.locals_[w]
            params, opt, _, step_losses = self._local_loop(
                start, state.opt_state[w], xs[w], ys[w],
                rng=derive_seed(state.rng, w))
            new_locals.append(params)
            new_opts.append(opt)
            losses.append(step_losses.mean())
        loss = torch.stack(losses)
        next_rng = derive_seed(state.rng)
        if self.nan_guard:
            # The round's one host read of the [W] losses; the divergence
            # reset reads this same host copy.
            loss = loss.cpu()
            if not bool(torch.isfinite(loss).all()):
                # One worker's non-finite commit would poison the center for
                # every worker: the whole round is discarded, the previous
                # state carries forward, and the loss keeps the NaN for
                # accounting.
                return state._replace(rng=next_rng), loss
        fold = disc.fold(state.center, new_locals, state.fold_state,
                         window=self.window, num_workers=self.num_workers)
        return EngineState(fold.center, fold.locals_, new_opts,
                           fold.fold_state, next_rng), loss


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


def _maybe_poison_round(r: int, xs: torch.Tensor) -> torch.Tensor:
    """Apply any scheduled nan/inf batch fault for round ``r`` (one-shot)."""
    fp = faults.active_plan()
    if fp is None:
        return xs
    kind = fp.batch_fault(r)
    if kind is None:
        return xs
    return _poison_rows(xs, kind, fp.poison_worker(r, int(xs.shape[0])))


def stage_round(engine, plan, r: int):
    """Gather and device-stage round ``r``'s batch; any scheduled
    ``nan@r``/``inf@r`` fault poisons the staged features here, the one
    choke point every engine's staging passes through."""
    xs, ys = engine._put_batch(*plan.round(r))
    return _maybe_poison_round(r, xs), ys


def run_per_round(engine, plan, state, start_round, on_round):
    """One round per host iteration, with the next rounds' batches gathered
    and copied to the device by a :class:`RoundFeeder`. The run's
    :class:`RoundGuard` fires any ``crash@R``/``kill@R`` before round R and
    may replace the state after it (the divergent-worker reset). Returns
    ``(state, losses)``, ``losses`` the ``[rounds,
    *engine.round_loss_shape]`` host array."""
    tele = telemetry.get()
    guard = RoundGuard(engine)
    losses = []
    feeder = RoundFeeder(plan.num_rounds,
                         lambda r: stage_round(engine, plan, r),
                         start_round=start_round)
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
        # input_stall: the time the run loop sat blocked on the data plane,
        # the compute-vs-data split.
        stall = tele.histogram("input_stall")
        for w in feeder.waits:
            stall.observe(w)
        tele.counter("input_stall_seconds").add(float(feeder.wait_seconds))
    host = (torch.stack(losses).cpu().numpy() if losses
            else np.zeros((0, *engine.round_loss_shape), np.float32))
    return state, host
