"""Trainer taxonomy — the port's counterpart of ``distkeras_tpu/trainers.py``.

Same names, same constructor kwargs, same ``train(dataframe) -> model``
entry point. Underneath, ``num_workers`` logical workers run on the model's
one device, on the card unless the model was built with ``device="cpu"``:
through :class:`~distkeras_tpu_torch.parallel.engine.AsyncEngine`
(``parallel/disciplines.py`` folds, ``workers.py`` local steps) for the
discipline trainers, and through
:class:`~distkeras_tpu_torch.parallel.sync.SyncEngine` (one merged batch
per step) for the single and synchronous ones.

Ported: ``Trainer``, ``DistributedTrainer``,
``AsynchronousDistributedTrainer``, the discipline trainers DOWNPOUR, ADAG,
DynSGD, AEASGD and EAMSGD, ``SingleTrainer`` and
``SynchronousDistributedTrainer``. With ``remote="host:port"`` (or
``DKTPU_PS_ENDPOINT``) the discipline trainers train against a networked
parameter server instead (``netps/remote.py``: W worker threads, each
pull -> K local steps -> commit). ``compute_dtype="bfloat16"`` (or a
``torch.dtype``) trains in mixed precision on every one of them
(``workers.make_local_loop``: f32 master state, the step in bf16).
Refused with ``NotImplementedError`` until their slices: checkpoints
(``checkpoint_dir``), the metrics log (``metrics_path``) and
model-parallel submeshes (``parallel``). The averaging and ensemble
trainers come with a later slice.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional, Union

import numpy as np
import torch

from distkeras_tpu_torch.data.batching import make_batches
from distkeras_tpu_torch.data.dataframe import DataFrame
from distkeras_tpu_torch.models.base import Model
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.optimizers import get_optimizer, sgd
from distkeras_tpu_torch.parallel.disciplines import (
    ADAGFold,
    AEASGDFold,
    Discipline,
    DownpourFold,
    DynSGDFold,
    EAMSGDFold,
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


def _not_ported(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to distkeras_tpu_torch yet; it comes with "
        f"the {slice_} slice")


class Trainer:
    """Base trainer (reference ``Trainer``): owns model, optimizer, loss,
    timing. Hyperparameters normalize into ``self.config``
    (:class:`RunConfig`); the reference's kwarg names stay readable and
    assignable as properties over it."""

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
            raise _not_ported("parallel= (model-parallel submeshes)",
                              "model-parallel engines")
        if kwargs:
            raise TypeError(
                f"{type(self).__name__} got unexpected kwargs: {sorted(kwargs)}")
        if legacy:
            warnings.warn(
                f"ignoring socket-era kwargs {sorted(legacy)}: there is no "
                "master address/port (kept for reference-notebook "
                "compatibility)", DeprecationWarning, stacklevel=2)
        if checkpoint_dir:
            raise _not_ported("checkpoint_dir= (checkpoint/resume)",
                              "checkpoint")
        if metrics_path:
            raise _not_ported("metrics_path= (the per-round metrics log)",
                              "checkpoint and metrics")
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

    def _execute(self, engine, plan):
        """Shared run harness: run every round and keep the histories (per
        worker for the async engines' ``[rounds, W]`` losses; none for the
        sync engine's ``[rounds]``, whose workers never diverge)."""
        on_round = None
        if self.on_round is not None:
            def on_round(r, loss, st):
                self.on_round(r, loss)
        state, losses = engine.run(
            plan, on_round=on_round,
            rounds_per_program=self.rounds_per_program)
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
        return self.model.with_params(state.params)

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
    ``num_workers`` is a logical worker count; every worker runs on the
    model's device (``None`` means one worker)."""

    num_workers = _config_prop("num_workers")

    def __init__(self, *args, num_workers: Optional[int] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.config = self.config.replace(num_workers=num_workers)


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
        if parallel:
            raise _not_ported("parallel= (model-parallel submeshes)",
                              "model-parallel engines")
        #: ``"host:port"`` of a networked parameter server: the worker loop
        #: becomes pull -> K local steps -> commit through the hardened TCP
        #: client instead of the in-process fold. Defaults from
        #: DKTPU_PS_ENDPOINT.
        self.remote = remote
        self.divergence_reset = divergence_reset

    def _discipline(self) -> Discipline:
        raise NotImplementedError

    def _run(self, dataframe: DataFrame, shuffle: bool):
        engine = AsyncEngine(
            self.model, self.worker_optimizer, self.loss, self._discipline(),
            window=self.communication_window,
            num_workers=self.num_workers or 1,
            learning_rate=self.learning_rate,
            compute_dtype=self.compute_dtype, seed=self.seed,
            grad_accum=self.grad_accum,
            device_transform=self.device_transform,
            divergence_reset=self.divergence_reset,
        )
        plan = make_batches(
            dataframe, self.features_col, self.label_col, self.batch_size,
            num_workers=engine.num_workers, window=self.communication_window,
            num_epoch=self.num_epoch, shuffle=shuffle, seed=self.seed,
            transform=self.transform,
        )
        return self._execute(engine, plan)

    def _remote_endpoint(self) -> Optional[str]:
        return (self.remote or runtime_config.env_str("DKTPU_PS_ENDPOINT")
                or None)

    def _train_remote(self, dataframe: DataFrame, shuffle: bool,
                      endpoint: str) -> Model:
        """The networked-PS path: W worker threads, each pull -> K local
        steps -> commit over TCP through the hardened client
        (``netps/remote.py``); returns the server's final center."""
        from distkeras_tpu_torch.netps.remote import run_remote

        if self.device_transform is not None:
            raise NotImplementedError(
                "device_transform= (input_transform, on-device "
                "augmentation) is not ported yet")
        if (self.divergence_reset is not None or runtime_config.env_float(
                "DKTPU_DIVERGENCE_RESET") is not None):
            raise _not_ported("divergence_reset (DKTPU_DIVERGENCE_RESET)",
                              "resilience")
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
            model = self._train_remote(dataframe, shuffle, endpoint)
            self.record_training_stop()
            return model
        state = self._run(dataframe, shuffle)
        self.record_training_stop()
        return self.model.with_params(state.center)


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
