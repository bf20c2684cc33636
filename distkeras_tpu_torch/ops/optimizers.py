"""Optimizer registry (the port's counterpart of
``distkeras_tpu/ops/optimizers.py``).

``get_optimizer`` resolves the reference's Keras-string surface (``'sgd'``,
``'adagrad'``, ``'adam'``...) to a :class:`GradientTransformation`: a pair of
pure functions over dicts of named tensors, ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, applied with
:func:`apply_updates`. Each rule is optax's, written out with optax's
defaults and arithmetic (its order of operations, its epsilons, adagrad's
accumulator starting at 0.1, rmsprop's eps inside the square root), so the
port's updates follow the JAX package's step for step; ``torch.optim``
differs in several of these. A :class:`GradientTransformation` passes
through untouched.

``learning_rate`` is a float or a schedule, any callable from the update
count to a rate (``ops/schedules.py`` holds optax's): update ``n`` (from
0) scales by ``-schedule(n)`` and the count, kept in the optimizer state,
steps after it, as in optax's ``scale_by_schedule``. So a checkpoint
resume continues the count and a fresh ``init`` restarts it. The dtype
options keep the jitted optax update's rounding: adam's step uses the
float32 first moment and stores it cast to ``mu_dtype`` afterwards; the
sgd trace stores its accumulator in ``accumulator_dtype``; a decay times
a stored low-precision moment is the decay rounded to that dtype times
the moment, in float32 (:func:`_decayed`). ``mask`` / ``weight_decay_mask``
(a ``{name: bool}`` dict, or a callable from the params to one) pick the
parameters that take weight decay.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from distkeras_tpu_torch.ops import host_numbers

Params = dict  # name -> tensor


class GradientTransformation(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Optional[Params]], tuple]


def _zeros(params: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _full(params: Params, value: float) -> Params:
    return {k: torch.full_like(v, value) for k, v in params.items()}


def _bias_correction(decay: float, count):
    """``1 - decay**count`` in float32, as optax computes it: a float, or
    inside a multi-round program (``count`` a tensor) the table entry of
    that count (``ops/host_numbers.py``). Divide by it with
    :func:`host_numbers.divide`."""
    if isinstance(count, torch.Tensor):
        return host_numbers.divisor(("bias_correction", float(decay)),
                                    lambda c: _bias_correction(decay, c),
                                    count)
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def apply_updates(params: Params, updates: Params) -> Params:
    """``params + updates``, leaf by leaf (optax.apply_updates)."""
    return {k: p + updates[k] for k, p in params.items()}


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def scale(step: float) -> GradientTransformation:
    return GradientTransformation(
        lambda params: (),
        lambda g, state, params=None: ({k: v * step for k, v in g.items()},
                                       state))


def _dtype(dtype) -> Optional[torch.dtype]:
    """A ``torch.dtype`` from a dtype or its name (``"bfloat16"``)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "__name__", None) or str(dtype)
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return out


def _cast(tree: Params, dtype: Optional[torch.dtype]) -> Params:
    return tree if dtype is None else {k: v.to(dtype)
                                       for k, v in tree.items()}


def _decayed(decay: float, t: torch.Tensor) -> torch.Tensor:
    """``decay * t`` for a moment stored in ``t.dtype``, as the jitted optax
    update computes it: the Python constant rounds to the moment's dtype
    (a weak-typed JAX scalar), the product stays float32 (XLA keeps the
    bf16 product unrounded inside the fused update)."""
    if t.dtype == torch.float32:
        return decay * t
    return float(torch.tensor(decay, dtype=t.dtype)) * t.to(torch.float32)


def _zeros_in(params: Params, dtype: Optional[torch.dtype]) -> Params:
    return {k: torch.zeros_like(v, dtype=dtype) for k, v in params.items()}


def trace(decay: float, nesterov: bool = False,
          accumulator_dtype=None) -> GradientTransformation:
    """Momentum: ``t = g + decay * t``; the update is ``t`` (or
    ``g + decay * t`` with Nesterov); ``t`` is stored in
    ``accumulator_dtype`` (None: the params')."""
    acc = _dtype(accumulator_dtype)

    def update(g, state, params=None):
        new = {k: v + _decayed(decay, state[k]) for k, v in g.items()}
        out = ({k: v + decay * new[k] for k, v in g.items()} if nesterov
               else new)
        return out, _cast(new, acc)

    return GradientTransformation(lambda params: _zeros_in(params, acc),
                                  update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0, mu_dtype=None,
                  nesterov: bool = False) -> GradientTransformation:
    mu_dtype = _dtype(mu_dtype)

    def init(params):
        return {"count": 0, "mu": _zeros_in(params, mu_dtype),
                "nu": _zeros(params)}

    def update(g, state, params=None):
        count = state["count"] + 1
        mu = {k: (1 - b1) * v + _decayed(b1, state["mu"][k])
              for k, v in g.items()}
        nu = {k: (1 - b2) * (v ** 2) + b2 * state["nu"][k]
              for k, v in g.items()}
        bc1 = _bias_correction(b1, count)
        div = host_numbers.divide
        if nesterov:
            bc1_next = _bias_correction(b1, count + 1)
            mu_hat = {k: b1 * div(mu[k], bc1_next) + (1 - b1) * div(v, bc1)
                      for k, v in g.items()}
        else:
            mu_hat = {k: div(m, bc1) for k, m in mu.items()}
        bc2 = _bias_correction(b2, count)
        out = {k: mu_hat[k] / (torch.sqrt(div(nu[k], bc2) + eps_root) + eps)
               for k in g}
        return out, {"count": count, "mu": _cast(mu, mu_dtype), "nu": nu}

    return GradientTransformation(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> GradientTransformation:
    """Adagrad's scaling: ``g / sqrt(sum of g^2 + eps)``, the sum starting
    at ``initial_accumulator_value``."""
    def update(g, state, params=None):
        sos = {k: v * v + state[k] for k, v in g.items()}
        out = {k: torch.where(sos[k] > 0, torch.rsqrt(sos[k] + eps),
                              torch.zeros_like(sos[k])) * v
               for k, v in g.items()}
        return out, sos

    return GradientTransformation(
        lambda params: _full(params, initial_accumulator_value), update)


def _rms_like(decay: float, eps: float, initial_scale: float,
              eps_in_sqrt: bool, bias_correction: bool,
              centered: bool) -> GradientTransformation:
    """optax's ``scale_by_rms`` (``centered=False``) and
    ``scale_by_stddev`` (``centered=True``)."""
    def init(params):
        state = {"nu": _full(params, initial_scale)}
        if centered:
            state["mu"] = _zeros(params)
        if bias_correction:
            state["count"] = 0
        return state

    def update(g, state, params=None):
        new = {"nu": {k: (1 - decay) * (v ** 2) + decay * state["nu"][k]
                      for k, v in g.items()}}
        if centered:
            new["mu"] = {k: (1 - decay) * v + decay * state["mu"][k]
                         for k, v in g.items()}
        nu_hat, mu_hat = new["nu"], new.get("mu")
        if bias_correction:
            new["count"] = state["count"] + 1
            bc = _bias_correction(decay, new["count"])
            div = host_numbers.divide
            nu_hat = {k: div(n, bc) for k, n in nu_hat.items()}
            if centered:
                mu_hat = {k: div(m, bc) for k, m in mu_hat.items()}
        out = {}
        for k, v in g.items():
            n = nu_hat[k] - mu_hat[k] * mu_hat[k] if centered else nu_hat[k]
            s = torch.rsqrt(n + eps) if eps_in_sqrt else 1 / (
                torch.sqrt(n) + eps)
            out[k] = s * v
        return out, new

    return GradientTransformation(init, update)


def scale_by_adadelta(rho: float = 0.9,
                      eps: float = 1e-6) -> GradientTransformation:
    def init(params):
        return {"e_g": _zeros(params), "e_x": _zeros(params)}

    def update(g, state, params=None):
        e_g = {k: (1 - rho) * (v ** 2) + rho * state["e_g"][k]
               for k, v in g.items()}
        out = {k: (torch.sqrt(state["e_x"][k] + eps)
                   / torch.sqrt(e_g[k] + eps)) * v for k, v in g.items()}
        e_x = {k: (1 - rho) * (u ** 2) + rho * state["e_x"][k]
               for k, u in out.items()}
        return out, {"e_g": e_g, "e_x": e_x}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float,
                        mask=None) -> GradientTransformation:
    """``g + weight_decay * p``, on the parameters ``mask`` selects
    (optax's ``masked`` wrapper: a ``{name: bool}`` dict or a callable
    from the params to one; None: every parameter); the others pass
    through."""
    def update(g, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        on = mask(params) if callable(mask) else mask
        return {k: v + weight_decay * params[k]
                if on is None or on[k] else v for k, v in g.items()}, state

    return GradientTransformation(lambda params: (), update)


def scale_by_schedule(step_size_fn) -> GradientTransformation:
    """``step_size_fn(count) * g``, the count (from 0) stepping after each
    update (optax ``scale_by_schedule``). Inside a multi-round program the
    step is read from a table of ``step_size_fn`` over the counts
    (``ops/host_numbers.py``)."""
    def step_of(count: int) -> float:
        return float(np.float32(step_size_fn(count)))

    def update(g, state, params=None):
        count = state["count"]
        step = (host_numbers.factor(("schedule", step_size_fn), step_of,
                                    count)
                if isinstance(count, torch.Tensor) else step_of(count))
        return ({k: v * step for k, v in g.items()},
                {"count": state["count"] + 1})

    return GradientTransformation(lambda params: {"count": 0}, update)


def _lr(learning_rate) -> GradientTransformation:
    if callable(learning_rate):
        return scale_by_schedule(lambda count: -learning_rate(count))
    return scale(-learning_rate)


def sgd(learning_rate, momentum: Optional[float] = None,
        nesterov: bool = False, accumulator_dtype=None):
    parts = [] if momentum is None else [
        trace(momentum, nesterov, accumulator_dtype)]
    return chain(*parts, _lr(learning_rate))


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
         mu_dtype=None, *, nesterov: bool = False):
    return chain(scale_by_adam(b1, b2, eps, eps_root, mu_dtype, nesterov),
                 _lr(learning_rate))


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
          mu_dtype=None, weight_decay: float = 1e-4, mask=None, *,
          nesterov: bool = False):
    return chain(scale_by_adam(b1, b2, eps, eps_root, mu_dtype, nesterov),
                 add_decayed_weights(weight_decay, mask), _lr(learning_rate))


def adagrad(learning_rate, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7):
    return chain(scale_by_rss(initial_accumulator_value, eps),
                 _lr(learning_rate))


def rmsprop(learning_rate, decay: float = 0.9, eps: float = 1e-8,
            initial_scale: float = 0.0, eps_in_sqrt: bool = True,
            centered: bool = False, momentum: Optional[float] = None,
            nesterov: bool = False, bias_correction: bool = False):
    parts = [_rms_like(decay, eps, initial_scale, eps_in_sqrt,
                       bias_correction, centered), _lr(learning_rate)]
    if momentum is not None:
        parts.append(trace(momentum, nesterov))
    return chain(*parts)


def adadelta(learning_rate=None, rho: float = 0.9, eps: float = 1e-6,
             weight_decay: float = 0.0, weight_decay_mask=None):
    parts = [add_decayed_weights(weight_decay, weight_decay_mask),
             scale_by_adadelta(rho, eps)]
    if learning_rate is not None:
        parts.append(_lr(learning_rate))
    return chain(*parts)


def get_optimizer(
    optimizer: Union[str, GradientTransformation],
    learning_rate: float = 0.01,
    **kwargs,
) -> GradientTransformation:
    if isinstance(optimizer, GradientTransformation):
        return optimizer
    name = optimizer.lower()
    if name == "sgd":
        return sgd(learning_rate, **kwargs)
    if name == "momentum":
        return sgd(learning_rate, momentum=kwargs.pop("momentum", 0.9),
                   **kwargs)
    if name == "nesterov":
        return sgd(learning_rate, momentum=kwargs.pop("momentum", 0.9),
                   nesterov=True, **kwargs)
    if name == "adam":
        return adam(learning_rate, **kwargs)
    if name == "adamw":
        return adamw(learning_rate, **kwargs)
    if name == "adagrad":
        return adagrad(learning_rate, **kwargs)
    if name == "rmsprop":
        return rmsprop(learning_rate, **kwargs)
    if name == "adadelta":
        return adadelta(learning_rate, **kwargs)
    raise KeyError(f"unknown optimizer {optimizer!r}")
