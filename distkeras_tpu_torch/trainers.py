"""Trainer taxonomy — the port's counterpart of ``distkeras_tpu/trainers.py``.

Same names, same constructor kwargs, same ``train(dataframe) -> model``
entry point. Underneath, ``num_workers`` logical workers run on the model's
device, on the card unless the model was built with ``device="cpu"``; in a
``torch.distributed`` group (``runtime/mesh.py distributed_initialize``)
each rank carries ``num_workers / ranks`` of them, under the reference's
``_mesh`` rule with ranks for chips (``runtime/mesh.py
workers_per_rank``), and a checkpoint holds every rank's workers; all
through :class:`~distkeras_tpu_torch.parallel.engine.AsyncEngine`
(``parallel/disciplines.py`` folds, ``workers.py`` local steps) for the
discipline trainers, and through
:class:`~distkeras_tpu_torch.parallel.sync.SyncEngine` (one merged batch
per step) for the single and synchronous ones.

Ported: ``Trainer``, ``DistributedTrainer``,
``AsynchronousDistributedTrainer``, the discipline trainers DOWNPOUR, ADAG,
DynSGD, AEASGD and EAMSGD, ``SingleTrainer``,
``SynchronousDistributedTrainer``, ``AveragingTrainer`` and
``EnsembleTrainer``. With ``remote="host:port"`` (or
``DKTPU_PS_ENDPOINT``) the discipline trainers train against a networked
parameter server instead (``netps/remote.py``: W worker threads, each
pull -> K local steps -> commit); a ``,`` list is a primary and its
standbys, and a ``;`` matrix (``"h:p0;h:p1"``) a sharded center, dialed
through the sharded client under one partition plan. ``compute_dtype="bfloat16"`` (or a
``torch.dtype``) trains in mixed precision on every one of them
(``workers.make_local_loop``: f32 master state, the step in bf16).
``checkpoint_dir=`` (with ``checkpoint_every`` and ``resume``) saves and
resumes the engine state through :class:`~distkeras_tpu_torch.checkpoint.
Checkpointer`, falling back past a corrupt step; ``metrics_path=`` writes
the per-round JSONL of :class:`~distkeras_tpu_torch.metrics.MetricsLogger`;
an async trainer's checkpoint resumes at another ``num_workers`` through
the engine's elastic re-topology (``host_state``/``adopt_state``), and
``divergence_reset=`` re-adopts the center for a worker whose loss strays.
``train`` takes an in-RAM ``DataFrame`` or a ``ShardedDataFrame`` (the
rounds gathered from disk, ``data/shards.py``), with a host ``transform=``
and an on-device ``device_transform=`` (``ops/augment.py``) in process.

Model parallelism: :class:`ParallelTrainer` (alias
:class:`TransformerTrainer`) trains over a grid of the group's ranks,
``parallel={axis: size}``, through the step engines
(``parallel/gspmd.py``, ``spmd.py``, ``pipeline_engine.py`` behind
``runner.py WindowedStepEngine``); the communicating async trainers take
``parallel={"model": tp[, "seq": sp]}``, each worker a row of ranks
(``parallel/async_tp.py``).
"""

from __future__ import annotations

import time
import warnings
from typing import Optional, Union

import numpy as np
import torch

from distkeras_tpu_torch.data.batching import make_batches
from distkeras_tpu_torch.data.dataframe import DataFrame
from distkeras_tpu_torch.models.base import Model, mean_buffers, pack_buffers
from distkeras_tpu_torch.ops import collectives
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.optimizers import get_optimizer, sgd
from distkeras_tpu_torch.parallel.disciplines import (
    ADAGFold,
    AEASGDFold,
    Discipline,
    DownpourFold,
    DynSGDFold,
    EAMSGDFold,
    EnsembleFold,
)
from distkeras_tpu_torch.parallel.engine import AsyncEngine
from distkeras_tpu_torch.parallel.sync import SyncEngine
from distkeras_tpu_torch.runtime import config as runtime_config
from distkeras_tpu_torch.runtime.config import RunConfig

#: Socket-era reference kwargs with no meaning here (no master address or
#: port to bind): accepted and ignored, with a warning, as in the JAX package.
_LEGACY_SOCKET_KWARGS = frozenset({"master_port", "master_host", "master", "port"})

#: Discipline-fold class -> the wire name the parameter server folds under
#: (subclass before base: EAMSGDFold is an AEASGDFold).
_FOLD_WIRE_NAMES = (
    (EAMSGDFold, "eamsgd"),
    (AEASGDFold, "aeasgd"),
    (DynSGDFold, "dynsgd"),
    (ADAGFold, "adag"),
    (DownpourFold, "downpour"),
)


def _fold_wire_name(disc: Discipline) -> str:
    for cls, name in _FOLD_WIRE_NAMES:
        if isinstance(disc, cls):
            return name
    raise ValueError(
        f"{type(disc).__name__} has no networked parameter-server "
        "equivalent (only the communicating PS disciplines do)")


def _config_prop(name: str) -> property:
    """Trainer attribute backed by the :class:`RunConfig` (kwargs-first surface
    preserved; assignment rebuilds the frozen config)."""

    def _get(self):
        return getattr(self.config, name)

    def _set(self, value):
        self.config = self.config.replace(**{name: value})

    return property(_get, _set)


class Trainer:
    """Base trainer (reference ``Trainer``): owns model, optimizer, loss,
    timing. Hyperparameters normalize into ``self.config``
    (:class:`RunConfig`); the reference's kwarg names stay readable and
    assignable as properties over it.

    ``rounds_per_program`` (an int >= 1, or ``"auto"``: 16 rounds one at
    a time, then R sized from their wall time) runs R rounds as one
    program: one captured CUDA graph on the card, a host loop on the CPU
    (``parallel/program.py``). The history and the trained model are the
    per-round run's bit for bit; ``on_round`` still fires once a round,
    and a checkpoint waits for the block's last round, the one whose state
    exists outside the program."""

    batch_size = _config_prop("batch_size")
    num_epoch = _config_prop("num_epoch")
    learning_rate = _config_prop("learning_rate")
    seed = _config_prop("seed")

    def __init__(
        self,
        model: Model,
        worker_optimizer="sgd",
        loss="categorical_crossentropy",
        features_col: str = "features",
        label_col: str = "label",
        batch_size: int = 32,
        num_epoch: int = 1,
        learning_rate: float = 0.01,
        compute_dtype: Union[str, torch.dtype, None] = None,
        seed: int = 0,
        metrics_path: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        rounds_per_program: Union[int, str] = 1,
        on_round=None,
        grad_accum: int = 1,
        transform=None,
        device_transform=None,
        normalize_uint8: bool = True,
        **kwargs,
    ):
        legacy = {k: kwargs.pop(k) for k in list(kwargs)
                  if k in _LEGACY_SOCKET_KWARGS}
        if "parallel" in kwargs:
            # Targeted, not a bare TypeError: a user who learned parallel=
            # on ADAG will try it on the ensemble/averaging/sync trainers.
            raise ValueError(
                f"{type(self).__name__} does not host model-parallel "
                "submeshes. parallel={'model': tp, 'seq': sp} is supported "
                "by the communicating async trainers (DOWNPOUR/ADAG/DynSGD/"
                "AEASGD/EAMSGD — each worker becomes a tp[ x sp] submesh); "
                "for model-parallel synchronous training use "
                "ParallelTrainer(parallel={'data': ..., 'model': ...}). "
                "Averaging/Ensemble fold non-communicating replicas and "
                "have no submesh variant.")
        if kwargs:
            raise TypeError(
                f"{type(self).__name__} got unexpected kwargs: {sorted(kwargs)}")
        if legacy:
            warnings.warn(
                f"ignoring socket-era kwargs {sorted(legacy)}: there is no "
                "master address/port (kept for reference-notebook "
                "compatibility)", DeprecationWarning, stacklevel=2)
        if not normalize_uint8 and getattr(model, "normalize_uint8", True):
            import dataclasses as _dc

            model = _dc.replace(model, normalize_uint8=False)
        self.model = model
        self.worker_optimizer = worker_optimizer
        self.loss = loss
        self.features_col = features_col
        self.label_col = label_col
        if isinstance(compute_dtype, (str, type(None))):
            dtype_str, self._dtype_override = compute_dtype, None
        else:  # a concrete torch dtype: bypasses the string-keyed config
            dtype_str, self._dtype_override = None, compute_dtype
        self.config = RunConfig(
            batch_size=batch_size, num_epoch=num_epoch,
            learning_rate=learning_rate, compute_dtype=dtype_str, seed=seed)
        dtype = self.compute_dtype  # an unknown name raises ValueError here
        if dtype is not None and not (isinstance(dtype, torch.dtype)
                                      and dtype.is_floating_point):
            raise TypeError(f"compute_dtype must be a float dtype, got "
                            f"{compute_dtype!r}")
        self.metrics_path = metrics_path
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.resume = resume
        if rounds_per_program == "auto":
            self.rounds_per_program: Union[int, str] = "auto"
        elif (isinstance(rounds_per_program, str)
              or int(rounds_per_program) < 1):
            raise ValueError(
                f"rounds_per_program must be an int >= 1 or 'auto', got "
                f"{rounds_per_program!r}")
        else:
            self.rounds_per_program = int(rounds_per_program)
        #: optional ``f(round, loss)`` fired after every fold round.
        self.on_round = on_round
        self.grad_accum = int(grad_accum)
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        #: optional training-time row transform ``fn(features, labels, rng)
        #: -> (features, labels)`` applied to every staged round on the host
        #: (see ``data.batching.apply_round_transform``).
        self.transform = transform
        #: optional on-device ``fn(gen, x, y) -> (x, y)`` run on each
        #: step's batch before the uint8 /255 cast (``ops/augment.py``;
        #: ``workers.make_local_loop``'s ``input_transform``).
        self.device_transform = device_transform
        self.history: np.ndarray | None = None
        self.worker_histories: np.ndarray | None = None
        self.training_time: float = 0.0
        self._t_start: float | None = None

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        """The step's dtype (``None``: float32 throughout)."""
        if self._dtype_override is not None:
            return self._dtype_override
        return self.config.dtype

    def _restore_candidate(self, engine, plan, ckpt, step, meta):
        """Restore checkpoint ``step`` (whose sidecar ``meta`` was already
        read) onto ``engine``, integrity-verified against the digest
        sidecar. Returns ``(state, start_round)``; raises on a missing or
        corrupt payload so :meth:`_resume_from_checkpoint` can fall back."""
        if not meta:
            # Steps are offset from rounds across resumes; with the sidecar
            # gone the raw step is only an upper bound on the true round.
            # Resume conservatively from it, loudly.
            warnings.warn(
                f"checkpoint step {step} has no meta sidecar; "
                "treating the step as the round index — if this run "
                "chain was ever resumed or resized, data progress "
                "may be overestimated", stacklevel=2)
        true_round = int(meta.get("round", step))
        saved_w = meta.get("num_workers")
        cur_w = getattr(engine, "num_workers", None)
        saved_spr = meta.get("samples_per_round")
        resized = (saved_w is not None and cur_w is not None
                   and saved_w != cur_w)
        # Round indices mean nothing across schedules whose per-round
        # sample count changed.
        spr_changed = (saved_spr is not None
                       and saved_spr != plan.samples_per_round)
        start = 0
        if resized or spr_changed:
            # Carry over DATA progress (samples consumed), not the raw
            # counter. Old checkpoints without samples_per_round meta fall
            # back to the worker-count ratio.
            num = saved_spr if saved_spr else saved_w
            den = plan.samples_per_round if saved_spr else cur_w
            start = min(((true_round + 1) * num) // den, plan.num_rounds)
        if resized and hasattr(engine, "host_state"):
            # Elastic resume: the checkpoint was written at another worker
            # count. Restore on the host at the saved topology, then re-join
            # every worker from the center (the reference's PS pull).
            host = ckpt.restore_host(engine.host_state(saved_w), step=step,
                                     verify=True)
            return engine.adopt_state(host), start
        # Every rank restores the whole state and keeps its own slice.
        state = engine.local_state(ckpt.restore(
            engine.restore_target(), step=step, verify=True))
        if resized:
            # W-independent state (SyncEngine) restores exactly under a
            # resize; data progress still rescales so the resumed run
            # neither replays nor skips a topology-dependent slice of the
            # data.
            warnings.warn(
                f"resuming a checkpoint saved with num_workers={saved_w} "
                f"on num_workers={cur_w}: state restored exactly; data "
                "progress rescaled", stacklevel=2)
        elif spr_changed:
            warnings.warn(
                "resuming under a schedule whose samples/round changed "
                f"({saved_spr} -> {plan.samples_per_round}): state "
                "restored exactly; data progress rescaled", stacklevel=2)
        else:
            start = min(true_round + 1, plan.num_rounds)
        return state, start

    def _resume_from_checkpoint(self, engine, plan, ckpt):
        """Resolve the resume point over ALL retained steps, newest first:
        steps with an intact meta sidecar are preferred (a missing or
        corrupt sidecar falls back to the most recent step that has one),
        and a step whose payload fails to restore or fails its integrity
        check falls back to the previous step. Returns ``(state, start,
        step_offset)``; ``state`` is None when nothing was restorable
        (fresh start)."""
        from distkeras_tpu_torch import telemetry
        from distkeras_tpu_torch.checkpoint import resume_candidates

        steps = ckpt.steps_desc()
        candidates = resume_candidates(
            steps, lambda s: ckpt.meta(s) is not None)
        if steps and candidates[0] != steps[0]:
            telemetry.counter("resilience.ckpt_fallback_steps").add(1)
            warnings.warn(
                f"latest checkpoint step {steps[0]} has a missing/corrupt "
                f"meta sidecar; falling back to step {candidates[0]}, the "
                "most recent step with an intact sidecar", stacklevel=2)
        last_err = None
        for step in candidates:
            meta = ckpt.meta(step) or {}
            saved_w = meta.get("num_workers")
            cur_w = getattr(engine, "num_workers", None)
            disc = getattr(engine, "discipline", None)
            if (saved_w is not None and cur_w is not None
                    and saved_w != cur_w and disc is not None
                    and not disc.center_is_trained):
                # A configuration error, not corruption: falling back to an
                # older step cannot fix a topology mismatch.
                raise ValueError(
                    f"cannot elastically resume {type(disc).__name__}"
                    " (worker count changed): its training progress"
                    " lives in the per-worker replicas, not the"
                    " center. Resume with the original num_workers="
                    f"{saved_w}.")
            try:
                state, start = self._restore_candidate(
                    engine, plan, ckpt, step, meta)
            except Exception as e:  # corrupt/unreadable: try the next step
                last_err = e
                telemetry.counter("resilience.ckpt_fallback_steps").add(1)
                telemetry.event("ckpt_fallback", {
                    "step": step, "error": repr(e)})
                warnings.warn(
                    f"checkpoint step {step} failed to restore "
                    f"({type(e).__name__}: {e}); falling back to the "
                    "previous step", stacklevel=2)
                continue
            # Offset past the NEWEST retained step, not the restored one:
            # after a fallback the skipped newer steps are still on disk,
            # and a save at a step <= latest_step() is declined.
            return state, start, (steps[0] + 1) - start
        warnings.warn(
            f"no restorable checkpoint in {self.checkpoint_dir} "
            f"(last error: {last_err!r}); starting fresh", stacklevel=2)
        return None, 0, (steps[0] + 1) if steps else 0

    def _execute(self, engine, plan):
        """Shared run harness: resume from a checkpoint, run every round
        with the per-round metrics and saves, and keep the histories (per
        worker for the async engines' ``[rounds, W]`` losses; none for the
        sync engine's ``[rounds]``, whose workers never diverge)."""
        state = None
        start = 0
        # Checkpoint step = round + step_offset. A save at any step <=
        # latest_step is declined, and a resume may map the resume round
        # below the saved step (a sync resize rescales data progress) —
        # the offset keeps the step sequence strictly increasing across
        # any chain of resumes while meta["round"] records the true round.
        step_offset = 0
        ckpt = logger = None
        if self.checkpoint_dir:
            from distkeras_tpu_torch.checkpoint import Checkpointer

            ckpt = Checkpointer(self.checkpoint_dir)
            latest = ckpt.latest_step()
            if self.resume and latest is not None:
                state, start, step_offset = self._resume_from_checkpoint(
                    engine, plan, ckpt)
            elif latest is not None:
                # Fresh run (resume=False) into a dir with prior
                # checkpoints: rounds restart at 0, so without an offset
                # every save would land on a step already taken.
                step_offset = latest + 1
        if state is None:
            state = engine.init_state()
        if self.metrics_path and collectives.is_main_process():
            # One log a run: rank 0's (every rank sees the same [W] losses).
            from distkeras_tpu_torch.metrics import MetricsLogger
            from distkeras_tpu_torch.telemetry.training import (
                DisciplineMonitor,
            )

            logger = MetricsLogger(
                self.metrics_path,
                samples_per_round=plan.samples_per_round,
                # every logical worker runs on the model's one device
                num_chips=getattr(engine, "num_chips", 1),
                extra={"trainer": type(self).__name__},
                monitor=DisciplineMonitor(
                    discipline=getattr(engine, "discipline", None),
                    num_workers=getattr(engine, "num_workers", 1)),
            )

        save_due = [False]  # a scheduled save passed while no state was out

        def _meta(r):
            return {"num_workers": getattr(engine, "num_workers", 1),
                    "round": r,
                    "samples_per_round": plan.samples_per_round}

        def on_round(r, loss, st):
            if logger is not None:
                logger(r, loss, st)
            if self.on_round is not None:
                self.on_round(r, loss)
            if ckpt is None or not self.checkpoint_every:
                return
            if (r + 1) % self.checkpoint_every == 0 or r == plan.num_rounds - 1:
                save_due[0] = True
            # A declined save (another writer advanced latest_step) keeps
            # the save due, to retry at the next round instead of silently
            # dropping it.
            if save_due[0] and st is not None:
                # Every rank takes part: the gather, then rank 0 writes.
                if ckpt.save(r + step_offset, engine.global_state(st),
                             meta=_meta(r)):
                    save_due[0] = False

        import contextlib

        done = False
        try:
            state, losses = engine.run(
                plan, state=state, start_round=start, on_round=on_round,
                rounds_per_program=self.rounds_per_program)
            if ckpt is not None and save_due[0] and plan.num_rounds > start:
                # The final scheduled save was declined and there was no
                # later round to retry at — persist the terminal state at
                # the next step the directory accepts.
                final_r = plan.num_rounds - 1
                latest_now = ckpt.latest_step()
                step = max(final_r + step_offset,
                           (-1 if latest_now is None else latest_now) + 1)
                ckpt.save(step, engine.global_state(state),
                          meta=_meta(final_r))
            # Happy path closes UNsuppressed: a failed close must surface.
            # (Checkpoint saves are synchronous: nothing of theirs is open.)
            if logger is not None:
                logger.close()
            done = True
        finally:
            # Failure path (including a close that itself raised): close
            # with errors suppressed so the root-cause exception
            # propagates; MetricsLogger.close is idempotent.
            if not done and logger is not None:
                with contextlib.suppress(Exception):
                    logger.close()
        # Every worker's state, on every rank (the ensemble trainers read
        # all the locals).
        state = engine.global_state(state)
        losses = np.asarray(losses)
        if losses.ndim == 2:
            self.worker_histories = losses.T
            self.history = losses.mean(axis=1)
        else:
            self.worker_histories = None
            self.history = losses
        return state

    def _train_sync(self, dataframe: DataFrame, shuffle: bool,
                    num_workers: int, steps_per_program: int) -> Model:
        """Train through :class:`SyncEngine`; returns the trained params as
        a :class:`Model` on the model's device."""
        self.record_training_start()
        engine = SyncEngine(
            self.model, self.worker_optimizer, self.loss,
            num_workers=num_workers, learning_rate=self.learning_rate,
            compute_dtype=self.compute_dtype, seed=self.seed,
            grad_accum=self.grad_accum,
            device_transform=self.device_transform,
        )
        plan = make_batches(
            dataframe, self.features_col, self.label_col, self.batch_size,
            num_workers=num_workers, window=steps_per_program,
            num_epoch=self.num_epoch, shuffle=shuffle, seed=self.seed,
            transform=self.transform,
        )
        state = self._execute(engine, plan)
        self.record_training_stop()
        return self._finish_model(state.params, state)

    def _finish_model(self, params: dict, engine_state,
                      worker: Optional[int] = None,
                      state_reduce: bool = False) -> Model:
        """The model with the trained ``params`` and, for a stateful model,
        the engine's trained model state (BatchNorm running statistics):
        the sync engine's one copy, worker ``worker``'s of the async
        engine's ``[W]`` (synced disciplines keep every copy equal, so 0 is
        canonical), or with ``state_reduce`` their mean (the
        ``AveragingTrainer``)."""
        m = self.model.with_params(params)
        bufs = getattr(engine_state, "model_state", None)
        if bufs is None:
            return m
        if state_reduce:
            bufs = mean_buffers(bufs)
        elif worker is not None:
            bufs = bufs[worker]
        return m.with_state(pack_buffers(m.module, bufs))

    # -- timing parity (reference Trainer.record_training_start/stop) -------
    def record_training_start(self):
        self._t_start = time.perf_counter()

    def record_training_stop(self):
        self.training_time = time.perf_counter() - self._t_start

    def get_training_time(self) -> float:
        return self.training_time

    def get_history(self) -> np.ndarray:
        """The mean loss over workers per round, ``[rounds]``."""
        return self.history

    def get_worker_histories(self) -> Optional[np.ndarray]:
        """Per-worker loss curves, ``[num_workers, rounds]``; ``None`` for
        the sync engine, whose workers never diverge."""
        return self.worker_histories

    def train(self, dataframe: DataFrame, shuffle: bool = False) -> Model:
        raise NotImplementedError


class SingleTrainer(Trainer):
    """One-replica baseline (reference ``SingleTrainer``): one worker,
    plain minibatch SGD, no communication; ``steps_per_program`` steps a
    round."""

    def __init__(self, *args, steps_per_program: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        self.steps_per_program = steps_per_program

    def train(self, dataframe: DataFrame, shuffle: bool = False) -> Model:
        """Train on ``dataframe``; returns the trained model on the model's
        device."""
        return self._train_sync(dataframe, shuffle, 1, self.steps_per_program)


class DistributedTrainer(Trainer):
    """Base for multi-worker trainers (reference ``DistributedTrainer``).
    ``num_workers`` is a logical worker count (``None`` means one worker),
    ``num_workers / ranks`` of them on each rank's device."""

    num_workers = _config_prop("num_workers")

    def __init__(self, *args, num_workers: Optional[int] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.config = self.config.replace(num_workers=num_workers)

    def _run_async(self, dataframe: DataFrame, shuffle: bool,
                   discipline: Discipline, engine=None, **engine_kw):
        """Run ``discipline`` through :class:`AsyncEngine` (or ``engine``,
        already built) over the harness, ``communication_window`` local
        steps a round (the subclasses that run it define that window;
        ``engine_kw``: ``per_worker_init``, ``divergence_reset``); returns
        the final engine state."""
        if engine is None:
            engine = AsyncEngine(
                self.model, self.worker_optimizer, self.loss, discipline,
                window=self.communication_window,
                num_workers=self.num_workers or 1,
                learning_rate=self.learning_rate,
                compute_dtype=self.compute_dtype, seed=self.seed,
                grad_accum=self.grad_accum,
                device_transform=self.device_transform, **engine_kw,
            )
        plan = make_batches(
            dataframe, self.features_col, self.label_col, self.batch_size,
            num_workers=engine.num_workers, window=self.communication_window,
            num_epoch=self.num_epoch, shuffle=shuffle, seed=self.seed,
            transform=self.transform,
        )
        return self._execute(engine, plan)


class SynchronousDistributedTrainer(DistributedTrainer):
    """Per-step gradient mean over all workers (reference
    ``SynchronousDistributedTrainer``; BASELINE config #5's "synchronous
    DOWNPOUR"): the ``num_workers`` logical workers' batches merge into one
    batch a step; ``steps_per_program`` steps a round."""

    def __init__(self, *args, steps_per_program: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        self.steps_per_program = steps_per_program

    def train(self, dataframe: DataFrame, shuffle: bool = False) -> Model:
        """Train on ``dataframe``; returns the trained model on the model's
        device."""
        return self._train_sync(dataframe, shuffle, self.num_workers or 1,
                                self.steps_per_program)


class AsynchronousDistributedTrainer(DistributedTrainer):
    """Base for the discipline trainers (reference
    ``AsynchronousDistributedTrainer``): K local steps per worker per fold
    round."""

    communication_window = _config_prop("communication_window")

    def __init__(self, *args, communication_window: int = 5,
                 parallel: Optional[dict] = None, rules=None,
                 divergence_reset: Optional[float] = None,
                 remote: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.config = self.config.replace(
            communication_window=communication_window)
        if parallel and (remote
                         or runtime_config.env_str("DKTPU_PS_ENDPOINT")):
            raise ValueError(
                "remote= or DKTPU_PS_ENDPOINT (networked parameter server) "
                "and parallel= (model-parallel submeshes) cannot combine: "
                "the remote worker loop runs whole-model replicas")
        #: ``"host:port"`` of a networked parameter server (a ``,``
        #: failover list, or a ``;`` shard matrix): the worker loop becomes
        #: pull -> K local steps -> commit through the hardened client
        #: instead of the in-process fold. Defaults from DKTPU_PS_ENDPOINT.
        self.remote = remote
        self.divergence_reset = divergence_reset
        #: each async worker as a model-parallel row of ranks:
        #: ``parallel={"model": 2}`` makes every logical worker a tp=2
        #: tensor-parallel replica (AsyncTPEngine over a (data, model)
        #: grid); ``rules`` overrides the partition rules (default
        #: TRANSFORMER_TP_RULES).
        self.parallel = dict(parallel) if parallel else None
        self.rules = rules

    def _discipline(self) -> Discipline:
        raise NotImplementedError

    def _tp_engine(self):
        """The async x TP engine for ``parallel={"model": tp[, "seq":
        sp]}``: ``num_workers`` workers (default: the ranks over tp*sp),
        each a ``model`` (x ``seq``) row of the group's ranks."""
        from distkeras_tpu_torch.models.transformer import seq_sharded
        from distkeras_tpu_torch.parallel.async_tp import (
            AsyncTPEngine,
            tp_layout,
        )
        from distkeras_tpu_torch.parallel.sharding import TRANSFORMER_TP_RULES
        from distkeras_tpu_torch.runtime.mesh import (
            device_count,
            hybrid_mesh,
        )

        axes = dict(self.parallel)
        tp = int(axes.pop("model", 1))
        sp = int(axes.pop("seq", 1))
        if axes:
            raise ValueError(
                f"async parallel supports only {{'model': n}} and "
                f"{{'seq': s}}, got extra axes {sorted(axes)}; pipeline/"
                "expert parallel compose via ParallelTrainer instead")
        model = self.model
        layout = tp_layout(self.num_workers, tp, sp,
                           getattr(model.module, "seq_axis", None),
                           device_count())
        if sp > 1:
            model = seq_sharded(model, self.parallel)
        rules = self.rules if self.rules is not None else TRANSFORMER_TP_RULES
        return AsyncTPEngine(
            model, self.worker_optimizer, self.loss, self._discipline(),
            hybrid_mesh(layout), window=self.communication_window,
            rules=rules, learning_rate=self.learning_rate,
            compute_dtype=self.compute_dtype, seed=self.seed,
            grad_accum=self.grad_accum,
            device_transform=self.device_transform,
            divergence_reset=self.divergence_reset)

    def _remote_endpoint(self) -> Optional[str]:
        return (self.remote or runtime_config.env_str("DKTPU_PS_ENDPOINT")
                or None)

    def _train_remote(self, dataframe: DataFrame, shuffle: bool,
                      endpoint: str) -> Model:
        """The networked-PS path: W worker threads, each pull -> K local
        steps -> commit over TCP through the hardened client
        (``netps/remote.py``); returns the server's final center. It has
        no divergent-worker reset (``divergence_reset`` raises here), as
        the reference's remote loop has none, and takes neither a
        ``device_transform`` (the reference's loop drops it) nor a
        ``ShardedDataFrame`` (``run_remote`` raises before any worker
        starts; the reference's loop dies of an ``AttributeError``)."""
        from distkeras_tpu_torch.netps.remote import run_remote

        if self.device_transform is not None:
            # The JAX package's remote worker loop builds its local loop
            # without the hook and drops the transform without a word.
            raise NotImplementedError(
                "device_transform= (the local loop's input_transform) on "
                "the remote= path: the JAX package's remote worker loop "
                "drops it, so the port refuses it rather than train "
                "unaugmented; train in process, or augment on the host "
                "with transform=")
        if self.checkpoint_dir or self.metrics_path:
            warnings.warn(
                "remote= training does not drive the checkpoint/metrics "
                "harness: the parameter-server process owns the center; "
                "checkpoint_dir/metrics_path are ignored on this path",
                stacklevel=2)
        if (self.divergence_reset is not None or runtime_config.env_float(
                "DKTPU_DIVERGENCE_RESET") is not None):
            # The reference's remote loop has no reset either: the server
            # owns the center and no worker sees another's loss.
            raise NotImplementedError(
                "divergence_reset (DKTPU_DIVERGENCE_RESET) acts on the "
                "in-process engine's workers; the remote worker loop has no "
                "divergent-worker reset (nor has the JAX package's)")
        W = self.num_workers or 1
        plan = make_batches(
            dataframe, self.features_col, self.label_col, self.batch_size,
            num_workers=W, window=self.communication_window,
            num_epoch=self.num_epoch, shuffle=shuffle, seed=self.seed,
            transform=self.transform,
        )
        disc = self._discipline()
        params, losses = run_remote(
            endpoint=endpoint, model=self.model,
            tx=get_optimizer(self.worker_optimizer, self.learning_rate),
            loss_fn=get_loss(self.loss), plan=plan,
            discipline=_fold_wire_name(disc),
            window=self.communication_window,
            alpha=getattr(disc, "alpha", 0.05), seed=self.seed,
            compute_dtype=self.compute_dtype, grad_accum=self.grad_accum,
        )
        self.worker_histories = losses.T
        self.history = np.nanmean(losses, axis=1)
        return self.model.with_params(params)

    def train(self, dataframe: DataFrame, shuffle: bool = False) -> Model:
        """Train on ``dataframe``; returns the trained center as a
        :class:`Model` on the model's device."""
        self.record_training_start()
        endpoint = self._remote_endpoint()
        if endpoint:
            # Re-checked here: the endpoint may come from DKTPU_PS_ENDPOINT
            # after construction, and dropping a requested layout silently
            # would be worse than refusing.
            if self.parallel:
                raise ValueError(
                    f"parameter-server endpoint {endpoint!r} (remote= or "
                    "DKTPU_PS_ENDPOINT) cannot combine with parallel=: the "
                    "remote worker loop runs whole-model replicas")
            model = self._train_remote(dataframe, shuffle, endpoint)
            self.record_training_stop()
            return model
        engine = self._tp_engine() if self.parallel else None
        state = self._run_async(dataframe, shuffle, self._discipline(),
                                engine=engine,
                                divergence_reset=self.divergence_reset)
        self.record_training_stop()
        return self._finish_model(state.center, state, worker=0)


class DOWNPOUR(AsynchronousDistributedTrainer):
    """DOWNPOUR (reference ``DOWNPOUR`` trainer + ``DeltaParameterServer``)."""

    def _discipline(self):
        return DownpourFold()


class ADAG(AsynchronousDistributedTrainer):
    """ADAG (reference ``ADAG`` trainer + ``ADAGParameterServer``):
    window-normalized accumulated-gradient commits."""

    def _discipline(self):
        return ADAGFold()


class DynSGD(AsynchronousDistributedTrainer):
    """DynSGD (reference ``DynSGD`` trainer + ``DynSGDParameterServer``):
    staleness-scaled folds."""

    def _discipline(self):
        return DynSGDFold()


class AEASGD(AsynchronousDistributedTrainer):
    """Elastic averaging (reference ``AEASGD``): exploration via persistent
    local replicas tethered to the center with elastic rate
    ``α = ρ·learning_rate``."""

    def __init__(self, *args, rho: float = 5.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.rho = rho

    def _discipline(self):
        return AEASGDFold(alpha=self.rho * self.learning_rate)


class EAMSGD(AsynchronousDistributedTrainer):
    """EAMSGD (reference ``EAMSGD``): AEASGD with momentum local workers."""

    def __init__(self, *args, rho: float = 5.0, momentum: float = 0.9,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.rho = rho
        self.momentum = momentum
        # Momentum lives in the *local* optimizer (reference EAMSGDWorker).
        if self.worker_optimizer in ("sgd", "momentum", "nesterov"):
            self.worker_optimizer = sgd(
                self.learning_rate, momentum=self.momentum,
                nesterov=self.worker_optimizer == "nesterov")
        else:
            warnings.warn(
                "EAMSGD: momentum kwarg is embedded in the local optimizer; "
                f"the provided worker_optimizer={self.worker_optimizer!r} is "
                "used as-is and the momentum argument is ignored",
                stacklevel=2)

    def _discipline(self):
        return EAMSGDFold(alpha=self.rho * self.learning_rate)


class ParallelTrainer(Trainer):
    """One trainer for the model-parallel engines (tensor, sequence,
    expert and pipeline parallelism) with the reference's
    ``train(dataframe)`` and the whole run harness (checkpoint and resume,
    metrics JSONL, ``rounds_per_program``) the data-parallel trainers get
    from :meth:`Trainer._execute`.

    ``parallel`` is the grid of the group's ranks, ``{axis: size}`` with at
    most one ``-1`` (inferred): ``{'data': -1, 'model': 2}`` (dp x tp),
    ``{'data': 2, 'pipe': 4}`` (dp x pp), ``{'data': 2, 'expert': 4}``
    (dp x ep MoE), ``{'data': -1, 'seq': 2, 'model': 2}`` (dp x sp x tp).
    Without a ``data`` axis one of size 1 leads the grid.

    ``strategy`` picks the engine; ``"auto"`` resolves from the grid and
    the model: a ``pipe`` axis -> ``PipelineEngine`` (GPipe microbatches),
    a ``seq`` axis or a ring-sharded or flash-attention module ->
    ``SPMDEngine`` (each rank its own block), anything else ->
    ``GSPMDEngine`` (the module sees the global batch).

    ``batch_size`` is the **global** per-step batch (the grid is one
    logical worker), unlike the data-parallel trainers' per-worker batch;
    it must divide by the ``data`` axis (and ``num_microbatches`` for the
    pipeline)."""

    def __init__(self, model: Model, parallel: Optional[dict] = None,
                 strategy: str = "auto", tp_rules=None,
                 steps_per_program: int = 4, num_microbatches: int = 4,
                 aux_loss_weight: float = 0.0, **kwargs):
        super().__init__(model, **kwargs)
        if self.grad_accum != 1:
            raise ValueError(
                "ParallelTrainer does not support grad_accum: the step "
                "engines have no accumulation path, so the kwarg would be "
                "silently ignored. Raise batch_size (the engines shard it "
                "over the data axis) or use a data-parallel trainer.")
        self.parallel = dict(parallel) if parallel else {"data": -1}
        if "data" not in self.parallel:
            self.parallel = {"data": 1, **self.parallel}
        if strategy not in ("auto", "spmd", "gspmd", "pipeline"):
            raise ValueError(
                f"strategy must be auto|spmd|gspmd|pipeline, got {strategy!r}")
        self.strategy = strategy
        self.tp_rules = tp_rules
        self.steps_per_program = int(steps_per_program)
        self.num_microbatches = int(num_microbatches)
        self.aux_loss_weight = float(aux_loss_weight)

    def _resolve_strategy(self) -> str:
        if self.strategy != "auto":
            return self.strategy
        if self.parallel.get("pipe", 1) != 1:
            return "pipeline"
        mod = self.model.module
        if (self.parallel.get("seq", 1) != 1
                or getattr(mod, "seq_axis", None) is not None
                or getattr(mod, "attn_impl", None) == "flash"):
            # flash and ring/gather run under SPMDEngine (GSPMDEngine
            # refuses them at construction, as the JAX one does)
            return "spmd"
        return "gspmd"

    def _default_rules(self):
        from distkeras_tpu_torch.parallel.sharding import (
            MOE_RULES,
            TRANSFORMER_TP_RULES,
        )

        if self.parallel.get("expert", 1) != 1:
            return MOE_RULES
        return TRANSFORMER_TP_RULES

    def _build_engine(self):
        from distkeras_tpu_torch.models.transformer import seq_sharded
        from distkeras_tpu_torch.parallel.runner import WindowedStepEngine
        from distkeras_tpu_torch.runtime.mesh import hybrid_mesh

        strat = self._resolve_strategy()
        layout = dict(self.parallel)
        if strat == "spmd":
            layout.setdefault("seq", 1)
        mesh = hybrid_mesh(layout)
        model = self.model
        if mesh.shape.get("seq", 1) > 1:  # resolved: -1 is inferred here
            model = seq_sharded(model, self.parallel)
        rules = (self.tp_rules if self.tp_rules is not None
                 else self._default_rules())
        common = dict(learning_rate=self.learning_rate, seed=self.seed,
                      compute_dtype=self.compute_dtype)
        if strat == "pipeline":
            from distkeras_tpu_torch.parallel.pipeline_engine import (
                PipelineEngine,
            )

            inner = PipelineEngine(
                model, self.worker_optimizer, self.loss, mesh,
                num_microbatches=self.num_microbatches, **common)
        elif strat == "spmd":
            from distkeras_tpu_torch.parallel.spmd import SPMDEngine

            inner = SPMDEngine(
                model, self.worker_optimizer, self.loss, mesh, rules,
                aux_loss_weight=self.aux_loss_weight, **common)
        else:
            from distkeras_tpu_torch.parallel.gspmd import GSPMDEngine

            inner = GSPMDEngine(
                model, self.worker_optimizer, self.loss, mesh, rules,
                aux_loss_weight=self.aux_loss_weight, **common)
        return WindowedStepEngine(inner, self.steps_per_program)

    def train(self, dataframe: DataFrame, shuffle: bool = False) -> Model:
        """Train on ``dataframe``; returns the trained (whole) parameters
        as a :class:`Model` on the model's device, on every rank."""
        from distkeras_tpu_torch.runtime.mesh import world_size

        self.record_training_start()
        engine = self._build_engine()
        # A sharded store across ranks plans one worker a data rank, so
        # each rank stages only its own rows (the engine merges the
        # rank-major stack back into the global batch).
        plan_workers, per_worker_batch = 1, self.batch_size
        if getattr(dataframe, "is_sharded", False) and world_size() > 1:
            plan_workers = engine.dp_size
            if self.batch_size % plan_workers:
                raise ValueError(
                    f"batch_size={self.batch_size} must divide by the data-"
                    f"parallel size {plan_workers} for multi-process sharded "
                    "stores (rows are staged per dp rank)")
            per_worker_batch = self.batch_size // plan_workers
        plan = make_batches(
            dataframe, self.features_col, self.label_col, per_worker_batch,
            num_workers=plan_workers, window=self.steps_per_program,
            num_epoch=self.num_epoch, shuffle=shuffle, seed=self.seed,
            transform=self.transform,
        )
        state = self._execute(engine, plan)
        self.record_training_stop()
        return self.model.with_params(state.params)


#: The flagship model's spelling of the same trainer.
TransformerTrainer = ParallelTrainer


class AveragingTrainer(DistributedTrainer):
    """Train independent replicas, average their weights (reference
    ``AveragingTrainer``): every worker trains alone (the no-communication
    :class:`~distkeras_tpu_torch.parallel.disciplines.EnsembleFold`), and
    the model returned is the mean of the replicas' parameters."""

    communication_window = _config_prop("communication_window")

    def __init__(self, *args, communication_window: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        # steps per round only (no semantic effect: the fold is a no-op)
        self.config = self.config.replace(
            communication_window=communication_window)

    def train(self, dataframe: DataFrame, shuffle: bool = False) -> Model:
        """Train on ``dataframe``; returns the replicas' mean as a
        :class:`Model` on the model's device."""
        self.record_training_start()
        # The replicas deliberately share one init: post-hoc weight
        # averaging is only meaningful when every replica descends within
        # one loss basin (the reference likewise broadcast one serialized
        # model to its executors).
        state = self._run_async(dataframe, shuffle, EnsembleFold())
        averaged = {k: torch.stack([p[k] for p in state.locals_]).mean(0)
                    for k in state.center}
        self.record_training_stop()
        return self._finish_model(averaged, state, state_reduce=True)


class EnsembleTrainer(AveragingTrainer):
    """Train ``num_workers`` independent models, each from its own init
    draw, and return all of them (reference ``EnsembleTrainer``)."""

    def train(self, dataframe: DataFrame,
              shuffle: bool = False) -> list[Model]:
        """Train on ``dataframe``; returns one :class:`Model` per worker,
        on the model's device."""
        self.record_training_start()
        state = self._run_async(dataframe, shuffle, EnsembleFold(),
                                per_worker_init=True)
        self.record_training_stop()
        return [self._finish_model(p, state, worker=i)
                for i, p in enumerate(state.locals_)]
