"""Synchronous data parallelism: the port's counterpart of
``distkeras_tpu/parallel/sync.py`` (``SyncState``, ``SyncEngine``).

The reference's ``SynchronousDistributedTrainer`` path, and the
"synchronous DOWNPOUR" of BASELINE config #5: one set of params, every
step's gradient the mean over all workers' batches, no center variable.
The JAX engine shards the batch over chips and ``pmean``\\ s each step's
gradient. Here the W logical workers live on the model's one device and
merge into one ``[W*B]`` batch per step, as the JAX engine multiplexes
the workers one chip carries: the mean gradient over ``W*B`` rows is the
mean of the W workers' ``B``-row means, so the merge is gradient-exact
against the per-step ``pmean`` (up to summation order). The all-reduce
over cards (multi-card NCCL) is a later slice.

``window`` means steps per round (the JAX engine's scan length): it has no
semantic effect.
"""

from __future__ import annotations

import warnings
from typing import Any, NamedTuple, Optional

import torch

from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.optimizers import get_optimizer
from distkeras_tpu_torch.parallel.engine import RoundEngine
from distkeras_tpu_torch.resilience.guard import nan_guard_enabled
from distkeras_tpu_torch.workers import derive_seed, make_local_loop


class SyncState(NamedTuple):
    params: Any
    opt_state: Any
    rng: int


class SyncEngine(RoundEngine):
    """Per-step synchronous SGD over ``num_workers`` logical workers merged
    into one batch on the model's device."""

    def __init__(
        self,
        model,
        optimizer,
        loss,
        num_workers: int = 1,
        learning_rate: float = 0.01,
        compute_dtype=None,
        seed: int = 0,
        grad_accum: int = 1,
        device_transform=None,
        nan_guard: Optional[bool] = None,
    ):
        if int(num_workers) < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.num_workers = int(num_workers)
        if self.num_workers > 1:
            warnings.warn(
                "SyncEngine with num_workers > 1 folds the logical workers "
                "into one merged W*B batch on the device: gradient-exact for "
                "deterministic stateless models, but batch statistics "
                "(BatchNorm) and stochastic-layer streams (dropout) see the "
                "merged batch — a slightly different trajectory than the "
                "same num_workers spread across cards",
                stacklevel=2)
        self.model = model
        self.seed = seed
        #: NaN/Inf round skip: a round with a non-finite step loss keeps the
        #: previous params and optimizer state (one host read of the [K]
        #: step losses per round). Default from DKTPU_NAN_GUARD.
        self.nan_guard = (nan_guard_enabled() if nan_guard is None
                          else bool(nan_guard))
        self.tx = get_optimizer(optimizer, learning_rate)
        self.loss_fn = get_loss(loss)
        self._local_loop = make_local_loop(
            model.module, self.loss_fn, self.tx, compute_dtype=compute_dtype,
            state_collections=model.state_collections, grad_accum=grad_accum,
            input_transform=device_transform,
            normalize_uint8=getattr(model, "normalize_uint8", True),
        )

    def init_state(self) -> SyncState:
        """The model's parameters, copied, with a fresh optimizer state."""
        params = {k: v.clone() for k, v in self.model.params.items()}
        return SyncState(params, self.tx.init(params), int(self.seed))

    def _merge(self, a: torch.Tensor) -> torch.Tensor:
        """``[W, K, B, ...]`` -> ``[K, W*B, ...]``, worker-major within a
        step (the JAX engine's multiplex)."""
        if self.num_workers == 1:
            return a[0]
        moved = a.transpose(0, 1)
        return moved.reshape((moved.shape[0], -1) + tuple(moved.shape[3:]))

    def _round_fn(self, state: SyncState, xs: torch.Tensor,
                  ys: torch.Tensor):
        """K synchronous steps on ``[W, K, B, ...]`` batches: returns the new
        state and the round loss, the mean of the K step losses."""
        params, opt, _, losses = self._local_loop(
            state.params, state.opt_state, self._merge(xs), self._merge(ys),
            rng=derive_seed(state.rng, 0))
        next_rng = derive_seed(state.rng)
        if self.nan_guard and not bool(torch.isfinite(losses).all()):
            # A non-finite step poisons the params: the whole round is
            # discarded and the loss keeps the NaN for accounting.
            return state._replace(rng=next_rng), losses.mean()
        return SyncState(params, opt, next_rng), losses.mean()
