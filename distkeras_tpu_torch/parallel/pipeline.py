"""Pipeline parallelism: the GPipe schedule over a ``pipe`` axis (the
port's counterpart of ``distkeras_tpu/parallel/pipeline.py``).

The layers are split into S contiguous stages, one a rank of the ``pipe``
axis; M microbatches stream through, the activations moving stage to
stage with ``ops/collectives.py shift`` (the ``ppermute``). The schedule
is the GPipe ramp: ``M + S - 1`` ticks, stage ``s`` on microbatch ``t -
s`` at tick ``t``, a bubble of ``(S-1)/(M+S-1)``. Every rank runs every
tick, computing where it holds zeros too, as the JAX schedule does, so
that each rank makes the same shifts in the same order; autograd then
runs their reverse shifts in the reverse order on every rank, which is
the schedule ``jax.grad`` derives from the ``lax.scan`` of ``ppermute``\\ s.
"""

from __future__ import annotations

from typing import Callable

import torch

from distkeras_tpu_torch.ops import collectives


def gpipe(stage_fn: Callable, stage_params, microbatches: torch.Tensor,
          group) -> torch.Tensor:
    """Run ``microbatches`` (``[M, ...]``) through the stages.

    ``stage_fn(stage_params, x) -> y`` is this rank's chunk of the network
    (activations to activations of the same shape); only stage 0 reads the
    queue, the others what the ring delivered. ``group`` is the ``pipe``
    axis's ``AxisGroup`` (None: one stage). Returns the ``[M, ...]``
    outputs, valid on the **last** stage (zeros elsewhere), with every
    shift tied into their graph, so that a loss taken on them on every
    rank runs every shift's backward."""
    S = 1 if group is None else group.size
    idx = 0 if group is None else group.index
    M = microbatches.shape[0]
    held = torch.zeros_like(microbatches[0])
    outputs: list = [None] * M
    sent = []
    for t in range(M + S - 1):
        x = microbatches[min(t, M - 1)] if idx == 0 else held
        y = stage_fn(stage_params, x)
        slot = t - (S - 1)
        if idx == S - 1 and slot >= 0:
            outputs[slot] = y
        if S > 1:
            # the last stage's send wraps to stage 0, which reads its queue
            held = collectives.shift(y, group)
            sent.append(held)
    out = (torch.stack(outputs) if idx == S - 1
           else torch.zeros_like(microbatches))
    return collectives.sink(out, sent)


def last_stage_broadcast(y: torch.Tensor, group) -> torch.Tensor:
    """The last stage's ``y`` on every stage (a masked sum over ``group``;
    no gradient)."""
    if group is None or group.trivial:
        return y
    last = group.index == group.size - 1
    return collectives.reduce_sum(y if last else torch.zeros_like(y), group)
