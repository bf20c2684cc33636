"""The round contract over the step engines (the port's counterpart of
``distkeras_tpu/parallel/runner.py``).

The data-parallel engines speak rounds (``_round_fn(state, xs, ys)`` over
``[W, K, B, ...]`` batches), which is what gives their trainers
checkpoint and resume, metrics and ``rounds_per_program`` (R rounds as
one program, ``parallel/program.py``) through ``Trainer._execute``. :class:`WindowedStepEngine` gives the step engines
(``spmd.py``, ``gspmd.py``, ``pipeline_engine.py``) the same: one round
is ``window`` steps, the round's loss their mean, and the plan has one
logical worker (the whole grid), so a checkpoint's meta never sees a
layout-dependent worker count and a run resumes under another layout.

A plan may also have one worker a ``data`` rank (a sharded store read
across processes): the ``[Wp, K, b, ...]`` stack merges rank-major into
the ``[K, Wp*b, ...]`` global batch, whose block ``w`` is exactly the rows
``data`` rank ``w`` holds, and each rank stages only its own rows
(``round_local``; its ``model`` and ``seq`` peers stage the same rows).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from distkeras_tpu_torch.parallel import program
from distkeras_tpu_torch.runtime.mesh import DATA_AXIS


def local_dp_ranks(mesh) -> list:
    """The ``data`` indices this process covers: its one grid slot's
    (each rank runs one slot; its model, seq and pipe peers share the
    rows)."""
    return [mesh.index(DATA_AXIS)]


def merge_rank_major(a: np.ndarray) -> np.ndarray:
    """``[Wp, K, b, ...]`` -> ``[K, Wp*b, ...]``: worker ``w``'s rows are
    block ``w`` of each step's batch."""
    if a.shape[0] == 1:
        return a[0]
    moved = np.swapaxes(a, 0, 1)
    return moved.reshape((moved.shape[0], a.shape[0] * moved.shape[2])
                         + moved.shape[3:])


class WindowedStepEngine:
    """Round-contract adapter over a step engine: running it for R rounds
    is calling ``inner.step`` R x ``window`` times on the same chain of
    states."""

    def __init__(self, inner, window: int):
        self.inner = inner
        self.window = int(window)
        self.mesh = inner.mesh
        self.model = inner.model
        #: one logical worker: the whole grid
        self.num_workers = 1
        self.local_workers = [0]
        #: ranks of the grid, for samples/s a card
        self.num_chips = int(self.mesh.size)
        self.dp_size = int(self.mesh.shape.get(DATA_AXIS, 1))
        self.round_loss_shape = ()

    # -- state ----------------------------------------------------------------
    def init_state(self):
        return self.inner.init_state()

    def global_state(self, state):
        return self.inner.global_state(state)

    def local_state(self, state):
        return self.inner.local_state(state)

    def restore_target(self):
        return self.inner.restore_target()

    # -- staging --------------------------------------------------------------
    @property
    def _local_ranks(self) -> list:
        return local_dp_ranks(self.mesh)

    def _host_round(self, plan, r: int) -> tuple:
        """This rank's block of round ``r`` as host tensors: the plan's
        whole round (or, from a sharded store with one worker a ``data``
        rank, only this rank's rows), merged rank-major, then cut to the
        rank's rows and sequence block, with any ``nan@r`` fault in it."""
        from distkeras_tpu_torch.parallel.engine import _maybe_poison_round

        if plan.num_workers > 1 and getattr(plan, "is_local", False):
            xs, ys = plan.round_local(r, self._local_ranks)
            xs, ys = xs[0], ys[0]
            xs, ys = self.inner.seq_block(xs), self.inner.seq_block(ys)
        else:
            xs, ys = plan.round(r)
            xs = self.inner.local_block(merge_rank_major(xs))
            ys = self.inner.local_block(merge_rank_major(ys))
        xs = torch.as_tensor(np.ascontiguousarray(xs))
        xs = _maybe_poison_round(r, xs[None])[0]  # one worker: the grid
        return xs, torch.as_tensor(np.ascontiguousarray(ys))

    def _stage_round(self, plan, r: int):
        """Round ``r``'s ``[K, b, ...]`` block on this rank's device."""
        dev = self.inner.device
        xs, ys = self._host_round(plan, r)
        return xs.to(dev), ys.to(dev)

    def _stage_block(self, plan, rs):
        """Rounds ``rs`` as one ``[n, K, b, ...]`` block in the engine's
        own layout (the JAX adapter's ``_put_block`` /
        ``_stage_local_block``): each round staged as
        :meth:`_stage_round` stages it, stacked."""
        dev = self.inner.device
        rounds = [self._host_round(plan, r) for r in rs]
        return (torch.stack([x for x, _ in rounds]).to(dev),
                torch.stack([y for _, y in rounds]).to(dev))

    @program.captured
    def _round_fn(self, state, xs: torch.Tensor, ys: torch.Tensor):
        losses = []
        for k in range(xs.shape[0]):
            state, loss = self.inner.step(state, xs[k], ys[k])
            losses.append(loss)
        return state, torch.stack(losses).mean()

    # -- multi-round programs -------------------------------------------------
    def _program_device(self) -> torch.device:
        return self.inner.device

    def _round_steps(self, xs: torch.Tensor) -> int:
        """Steps a round of the ``[n, K, b, ...]`` block takes: K."""
        return int(xs.shape[1])

    def multi_round_fn(self, rounds: int):
        """``rounds`` rounds as one program (``parallel/engine.py
        make_multi_round_fn``): one captured CUDA graph on the card."""
        from distkeras_tpu_torch.parallel.engine import make_multi_round_fn

        return make_multi_round_fn(self, rounds)

    # -- the run --------------------------------------------------------------
    def run(self, plan, state=None, start_round: int = 0,
            on_round: Optional[Callable] = None,
            rounds_per_program: "int | str" = 1):
        """Rounds ``start_round..num_rounds``, ``rounds_per_program`` of
        them a program (``parallel/engine.py run_rounds``: blocks of R
        rounds, or ``"auto"``); returns ``(state, losses)``, ``losses``
        ``[rounds]``, the same for every R."""
        from distkeras_tpu_torch.parallel.engine import run_rounds

        sharded = getattr(plan, "is_local", False) and self.mesh.size > 1
        allowed = {self.dp_size} if sharded else {1, self.dp_size}
        if plan.num_workers not in allowed:
            raise ValueError(
                f"step-engine plan num_workers must be in {sorted(allowed)} "
                f"(1 = whole-mesh batch; {self.dp_size} = one per dp rank, "
                f"required for multi-process sharded stores); got "
                f"{plan.num_workers}")
        if state is None:
            state = self.init_state()
        return run_rounds(self, plan, state, start_round, on_round,
                          rounds_per_program,
                          stage=lambda r: self._stage_round(plan, r))
