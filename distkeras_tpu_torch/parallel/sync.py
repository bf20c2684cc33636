"""Synchronous data parallelism: the port's counterpart of
``distkeras_tpu/parallel/sync.py`` (``SyncState``, ``SyncEngine``).

The reference's ``SynchronousDistributedTrainer`` path, and the
"synchronous DOWNPOUR" of BASELINE config #5: one set of params, every
step's gradient the mean over all workers' batches, no center variable.
The JAX engine shards the batch over chips and ``pmean``\\ s each step's
gradient. Here each rank of the process group (``runtime/mesh.py``)
carries ``m`` of the W logical workers, merged into one ``[m*B]`` batch a
step, as the JAX engine multiplexes the workers one chip carries, and
every step's gradient and loss are averaged over the ranks with one
all-reduce (``workers.make_local_loop``'s ``grad_transform``). The mean
gradient over ``m*B`` rows is the mean of the m workers' ``B``-row means,
so the merge is gradient-exact against the per-step mean (up to
summation order). Without a group the world is one rank: all W workers
merge on the model's device and no collective runs.

``window`` means steps per round (the JAX engine's scan length): it has no
semantic effect.

Mutable model state (BatchNorm running statistics) threads through the
steps in ``SyncState.model_state``. The JAX engine averages each chip's
copy over the chips after the window (``pmean``); each rank here keeps
one copy, updated from its merged batch's statistics, and the ranks'
copies are averaged after the window the same way. With m workers on a
rank that is the JAX engine's multiplex (``workers_per_chip=m``) step for
step, and what the warning below says.
"""

from __future__ import annotations

import warnings
from typing import Any, NamedTuple, Optional

import torch

from distkeras_tpu_torch.ops import collectives
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.optimizers import get_optimizer
from distkeras_tpu_torch.parallel import program
from distkeras_tpu_torch.parallel.engine import RoundEngine, initial_buffers
from distkeras_tpu_torch.resilience.guard import nan_guard_enabled
from distkeras_tpu_torch.runtime import mesh
from distkeras_tpu_torch.workers import derive_seed, make_local_loop


#: the step loss's key beside the gradients (parameter names are strings)
_LOSS_KEY = ("loss",)


class SyncState(NamedTuple):
    params: Any
    opt_state: Any
    rng: int
    model_state: Any = None


class SyncEngine(RoundEngine):
    """Per-step synchronous SGD over ``num_workers`` logical workers: a
    rank's ``m`` merged into one batch on its device, the gradient averaged
    over the ranks every step."""

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
        self._bind_ranks()
        if self.workers_per_rank > 1:
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
        #: step losses per round; a select on the device inside a
        #: multi-round program). Default from DKTPU_NAN_GUARD.
        self.nan_guard = (nan_guard_enabled() if nan_guard is None
                          else bool(nan_guard))
        #: the per-step on-device augmentation (``workers.py``)
        self.device_transform = device_transform
        self.tx = get_optimizer(optimizer, learning_rate)
        self.loss_fn = get_loss(loss)
        self._local_loop = make_local_loop(
            model.module, self.loss_fn, self.tx, compute_dtype=compute_dtype,
            state_collections=model.state_collections, grad_accum=grad_accum,
            input_transform=device_transform,
            normalize_uint8=getattr(model, "normalize_uint8", True),
            grad_transform=(self._sync_grads if mesh.group_active()
                            else None),
        )

    @staticmethod
    def _sync_grads(grads: dict, loss: torch.Tensor):
        """The one collective a step: the gradient and the loss averaged
        over the ranks (the reference's ``pmean``)."""
        out = collectives.all_reduce({**grads, _LOSS_KEY: loss}, "mean")
        loss = out.pop(_LOSS_KEY)
        return out, loss

    def init_state(self) -> SyncState:
        """The model's parameters and state, copied, with a fresh optimizer
        state."""
        params = {k: v.clone() for k, v in self.model.params.items()}
        return SyncState(params, self.tx.init(params), int(self.seed),
                         initial_buffers(self.model))

    def _merge(self, a: torch.Tensor) -> torch.Tensor:
        """``[m, K, B, ...]`` -> ``[K, m*B, ...]``, worker-major within a
        step (the JAX engine's multiplex)."""
        if a.shape[0] == 1:
            return a[0]
        moved = a.transpose(0, 1)
        return moved.reshape((moved.shape[0], -1) + tuple(moved.shape[3:]))

    @program.captured
    def _round_fn(self, state: SyncState, xs: torch.Tensor,
                  ys: torch.Tensor):
        """K synchronous steps on this rank's ``[m, K, B, ...]`` batches:
        returns the new state and the round loss, the mean of the K step
        losses (each the mean over the ranks)."""
        params, opt, bufs, losses = self._local_loop(
            state.params, state.opt_state, self._merge(xs), self._merge(ys),
            rng=derive_seed(state.rng, mesh.rank()), state=state.model_state)
        if bufs is not None and mesh.group_active():
            # Running statistics re-sync: each rank saw its own rows.
            bufs = collectives.all_reduce(bufs, "mean")
        next_rng = derive_seed(state.rng)
        new_state = SyncState(params, opt, next_rng, bufs)
        if not self.nan_guard:
            return new_state, losses.mean()
        kept = state._replace(rng=next_rng)
        if program.in_program():
            # Inside a multi-round program the skip is a select on the
            # device (no host read).
            return (program.select(torch.isfinite(losses).all(), new_state,
                                   kept), losses.mean())
        if not bool(torch.isfinite(losses).all()):
            # A non-finite step poisons the params: the whole round is
            # discarded and the loss keeps the NaN for accounting. The
            # losses are the ranks' mean, so every rank skips together.
            return kept, losses.mean()
        return new_state, losses.mean()
