"""Worker local-step loops (the port's counterpart of
``distkeras_tpu/workers.py``).

Parity with ``distkeras/workers.py``: the reference ships a ``Worker.train``
closure to each Spark executor, which compiles the model with the worker
optimizer and calls ``model.train_on_batch`` per minibatch. Here the worker
is :func:`make_local_loop`'s ``local_steps``: ``communication_window``
minibatch steps, each a forward and backward through
``torch.func.functional_call`` on a dict of named parameters (the JAX
package's pure ``module.apply``), the optimizer update, and the step's
loss. JAX runs the window as one ``lax.scan``; eager PyTorch runs it as a
Python loop whose heavy parts are the model's own kernels.
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from distkeras_tpu_torch.models.base import _warn_uint8_rescale
from distkeras_tpu_torch.ops.optimizers import (
    GradientTransformation,
    apply_updates,
)
from distkeras_tpu_torch.ops.precision import cast_floats


def derive_seed(*parts: int) -> int:
    """A 64-bit seed mixed from non-negative integer parts
    (``numpy.SeedSequence``): the port's counterpart of ``jax.random``'s
    ``fold_in`` / ``split`` chains, used for per-round, per-worker,
    per-step and per-micro-batch dropout generators."""
    return int(np.random.SeedSequence([int(p) for p in parts])
               .generate_state(1, np.uint64)[0])


def make_local_loop(
    module: torch.nn.Module,
    loss_fn: Callable,
    tx: GradientTransformation,
    compute_dtype=None,
    state_collections: Sequence[str] = (),
    grad_accum: int = 1,
    input_transform: Optional[Callable] = None,
    normalize_uint8: bool = True,
):
    """Build ``local_steps(params, opt_state, xs, ys, rng, state) ->
    (params, opt_state, state, losses)``.

    ``params`` is a dict of named tensors (``Model.params``); ``xs``/``ys``
    are ``[window, batch, ...]`` tensors on the params' device; ``losses``
    is the ``[window]`` tensor of per-step losses. The module runs in train
    mode for the window (the JAX loop's ``train=True``) and goes back to its
    previous mode after.

    ``grad_accum=A`` splits every step's batch into A sequential
    micro-batches and applies ONE optimizer update on their mean gradient
    (and reports their mean loss).

    ``rng`` (an int, default 0) seeds the dropout masks: step ``k`` draws
    from a generator seeded with ``derive_seed(rng, k)`` (micro-batch ``i``
    with ``derive_seed(rng, k, i)``), handed to the module's ``forward`` as
    ``rng=`` when it takes one. The masks cannot match JAX's bits.

    ``compute_dtype`` (``torch.bfloat16``; ``None`` or ``torch.float32``
    is the plain f32 step) is mixed precision, the JAX loop's recipe:
    inside the loss the parameters and the float inputs are cast to it
    (uint8 inputs are divided by 255 in it), the model's output is cast to
    f32 before the loss, and autograd carries the cast back, so the master
    parameters, their gradients and the optimizer state stay f32.

    Not ported yet, and refused rather than ignored: ``state_collections``
    (the BatchNorm slice) and ``input_transform`` (on-device augmentation).
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if compute_dtype is not None and not (
            isinstance(compute_dtype, torch.dtype)
            and compute_dtype.is_floating_point):
        raise TypeError(f"compute_dtype must be a float torch.dtype or None, "
                        f"got {compute_dtype!r}")
    if tuple(state_collections or ()):
        raise NotImplementedError(
            f"state_collections={tuple(state_collections)} (mutable model "
            "state such as BatchNorm statistics) is not ported yet; it comes "
            "with the BatchNorm slice")
    if input_transform is not None:
        raise NotImplementedError(
            "input_transform (on-device augmentation) is not ported yet")
    takes_rng = "rng" in inspect.signature(module.forward).parameters

    def cast_input(x):
        if x.dtype == torch.uint8 and normalize_uint8:
            _warn_uint8_rescale()
            return x.to(compute_dtype or torch.float32) / 255.0
        return cast_floats(x, compute_dtype)

    def loss_and_grads(params, x, y, seed):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        kwargs = {}
        if takes_rng:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed)
            kwargs["rng"] = gen
        out = functional_call(module, cast_floats(leaves, compute_dtype),
                              (cast_input(x),), kwargs)
        loss = loss_fn(out.to(torch.float32), y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def grad_of_step(p, x, y, rng, k):
        if grad_accum == 1:
            return loss_and_grads(p, x, y, derive_seed(rng, k))
        B = x.shape[0]
        if B % grad_accum:
            raise ValueError(
                f"batch size {B} not divisible by grad_accum={grad_accum}")
        xm = x.reshape((grad_accum, B // grad_accum) + tuple(x.shape[1:]))
        ym = y.reshape((grad_accum, B // grad_accum) + tuple(y.shape[1:]))
        l_sum, g_sum = None, None
        for i in range(grad_accum):
            loss, g = loss_and_grads(p, xm[i], ym[i], derive_seed(rng, k, i))
            if g_sum is None:
                l_sum, g_sum = loss, g
            else:
                l_sum = l_sum + loss
                g_sum = {n: v + g[n] for n, v in g_sum.items()}
        inv = 1.0 / grad_accum
        return l_sum * inv, {n: v * inv for n, v in g_sum.items()}

    def local_steps(params, opt_state, xs, ys, rng: Optional[int] = None,
                    state=None):
        rng = 0 if rng is None else int(rng)
        was_training = module.training
        module.train()
        losses = []
        try:
            for k in range(xs.shape[0]):
                loss, grads = grad_of_step(params, xs[k], ys[k], rng, k)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = apply_updates(params, updates)
                losses.append(loss)
        finally:
            module.train(was_training)
        return params, opt_state, state, torch.stack(losses)

    return local_steps
