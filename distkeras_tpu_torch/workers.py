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
import threading
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


#: the last part of the augmentation seeds, ``derive_seed(rng, k, 0,
#: AUGMENT_STREAM)``. ``SeedSequence`` reads missing trailing parts as
#: zeros, so only a non-zero fourth part keeps these seeds apart from the
#: dropout seeds ``(rng, k)`` and ``(rng, k, i)``.
AUGMENT_STREAM = 1


def derive_seed(*parts):
    """A 64-bit seed mixed from non-negative integer parts
    (``numpy.SeedSequence``): the port's counterpart of ``jax.random``'s
    ``fold_in`` / ``split`` chains, used for per-round, per-worker,
    per-step and per-micro-batch dropout generators. When the first part
    is a :class:`SeedRef` (a round being captured into a CUDA graph), the
    seed is one too, derived when the graph replays."""
    if parts and isinstance(parts[0], SeedRef):
        return SeedRef(parts[0], tuple(int(p) for p in parts[1:]))
    return int(np.random.SeedSequence([int(p) for p in parts])
               .generate_state(1, np.uint64)[0])


class SeedRef:
    """A seed of a round captured into a CUDA graph (``parallel/
    program.py``): ``derive_seed(parent, *parts)`` of the block's first
    rng, which the host knows only at each replay. The root (no parent) is
    that rng; :meth:`resolve` computes the seed from it, as the per-round
    path's chain of :func:`derive_seed` calls does."""

    __slots__ = ("parent", "parts")

    def __init__(self, parent: "Optional[SeedRef]" = None,
                 parts: tuple = ()):
        self.parent = parent
        self.parts = parts

    def resolve(self, root: int, memo: Optional[dict] = None) -> int:
        if self.parent is None:
            return int(root)
        memo = {} if memo is None else memo
        got = memo.get(id(self))
        if got is None:
            got = memo[id(self)] = derive_seed(
                self.parent.resolve(root, memo), *self.parts)
        return got


#: where a captured round's generators and a transform's draws come from
#: (``parallel/program.py`` sets them for the capture): ``generator(device,
#: SeedRef) -> torch.Generator`` and ``draws(transform, SeedRef, x) ->
#: tuple of device tensors``.
_CAPTURE_HOOKS = threading.local()


def seeded_generator(device, seed) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``; for a
    :class:`SeedRef` (inside a capture) the capturing program's generator,
    which it seeds before every replay."""
    if isinstance(seed, SeedRef):
        make = getattr(_CAPTURE_HOOKS, "generator", None)
        if make is None:
            raise RuntimeError("a SeedRef outside a captured program")
        return make(torch.device(device), seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def staged_draws(transform, seed: SeedRef, x: torch.Tensor) -> tuple:
    """``transform.draw(gen, x.shape)`` for a step of a captured round:
    the capturing program's device buffers, which it fills before every
    replay with the draws of a CPU generator seeded from ``seed``."""
    if not (hasattr(transform, "draw") and hasattr(transform, "apply")):
        raise RuntimeError("a device_transform inside a captured program "
                           "must have draw and apply halves")
    make = getattr(_CAPTURE_HOOKS, "draws", None)
    if make is None:
        raise RuntimeError("a SeedRef outside a captured program")
    return make(transform, seed, x)


def make_local_loop(
    module: torch.nn.Module,
    loss_fn: Callable,
    tx: GradientTransformation,
    compute_dtype=None,
    state_collections: Sequence[str] = (),
    grad_accum: int = 1,
    input_transform: Optional[Callable] = None,
    normalize_uint8: bool = True,
    grad_transform: Optional[Callable] = None,
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

    ``input_transform(gen, x, y) -> (x, y)`` runs on each step's device
    batch before the uint8 ``/255`` cast and before the ``grad_accum``
    split, the JAX loop's order (``ops/augment.py``: the crop and flip on
    the card). ``gen`` is a CPU ``torch.Generator`` seeded with
    ``derive_seed(rng, k, 0, AUGMENT_STREAM)`` at step ``k``: the
    augmentation is deterministic in (seed, round, worker, step), survives
    a checkpoint and resume exactly, and leaves the dropout seeds the same
    with or without it. A transform may come in halves as well,
    ``draw(gen, x_shape)`` (its CPU draws) and ``apply(draws, x, y)``
    (the same work on the device given them): a captured multi-round
    program then stages the draws with its block (:func:`staged_draws`).

    ``grad_transform(grads, loss) -> (grads, loss)`` runs after each
    step's backward (after the ``grad_accum`` mean), before the optimizer
    update: the sync engine's gradient all-reduce hook across ranks.

    ``state_collections`` names the model's mutable collections
    (``Model.state_collections``: BatchNorm running statistics); ``state``
    is then the flat ``{buffer name: tensor}`` dict
    (``models.base.state_buffers``; None: the module's own buffers). Each
    forward runs on a copy of it through ``functional_call``, the train-mode
    BatchNorm updates that copy in place, and the copy goes on to the next
    micro-batch and the next step, so the state threads through the
    window in order and comes back as the third result. It is never cast
    to ``compute_dtype``: running statistics stay in their stored
    precision. Stateless models pass ``state`` through untouched.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if compute_dtype is not None and not (
            isinstance(compute_dtype, torch.dtype)
            and compute_dtype.is_floating_point):
        raise TypeError(f"compute_dtype must be a float torch.dtype or None, "
                        f"got {compute_dtype!r}")
    stateful = bool(tuple(state_collections or ()))
    takes_rng = "rng" in inspect.signature(module.forward).parameters

    def cast_input(x):
        if x.dtype == torch.uint8 and normalize_uint8:
            _warn_uint8_rescale()
            return x.to(compute_dtype or torch.float32) / 255.0
        return cast_floats(x, compute_dtype)

    def loss_and_grads(params, st, x, y, seed):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        kwargs = {}
        if takes_rng:
            kwargs["rng"] = seeded_generator(x.device, seed)
        # The forward updates the copy in place (models/base.py BatchNorm).
        st = {k: v.clone() for k, v in st.items()} if stateful else st
        tensors = cast_floats(leaves, compute_dtype)
        if stateful:
            tensors = {**tensors, **st}
        out = functional_call(module, tensors, (cast_input(x),), kwargs)
        loss = loss_fn(out.to(torch.float32), y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), st, dict(zip(leaves, grads))

    def grad_of_step(p, st, x, y, rng, k):
        if grad_accum == 1:
            return loss_and_grads(p, st, x, y, derive_seed(rng, k))
        B = x.shape[0]
        if B % grad_accum:
            raise ValueError(
                f"batch size {B} not divisible by grad_accum={grad_accum}")
        xm = x.reshape((grad_accum, B // grad_accum) + tuple(x.shape[1:]))
        ym = y.reshape((grad_accum, B // grad_accum) + tuple(y.shape[1:]))
        l_sum, g_sum = None, None
        for i in range(grad_accum):
            loss, st, g = loss_and_grads(p, st, xm[i], ym[i],
                                         derive_seed(rng, k, i))
            if g_sum is None:
                l_sum, g_sum = loss, g
            else:
                l_sum = l_sum + loss
                g_sum = {n: v + g[n] for n, v in g_sum.items()}
        inv = 1.0 / grad_accum
        return l_sum * inv, st, {n: v * inv for n, v in g_sum.items()}

    def local_steps(params, opt_state, xs, ys, rng: Optional[int] = None,
                    state=None):
        rng = 0 if rng is None else (
            rng if isinstance(rng, SeedRef) else int(rng))
        if stateful and state is None:
            state = {k: v.detach() for k, v in module.named_buffers()}
        was_training = module.training
        module.train()
        losses = []
        try:
            for k in range(xs.shape[0]):
                x, y = xs[k], ys[k]
                if input_transform is not None:
                    aug = derive_seed(rng, k, 0, AUGMENT_STREAM)
                    if isinstance(aug, SeedRef):
                        # a captured round: the draws are staged with the
                        # block (parallel/program.py)
                        x, y = input_transform.apply(
                            staged_draws(input_transform, aug, x), x, y)
                    else:
                        gen = torch.Generator()
                        gen.manual_seed(aug)
                        x, y = input_transform(gen, x, y)
                loss, state, grads = grad_of_step(params, state, x, y, rng, k)
                if grad_transform is not None:
                    grads, loss = grad_transform(grads, loss)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = apply_updates(params, updates)
                losses.append(loss)
        finally:
            module.train(was_training)
        return params, opt_state, state, torch.stack(losses)

    return local_steps
