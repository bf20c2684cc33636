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
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

Params = dict  # name -> tensor


class GradientTransformation(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Optional[Params]], tuple]


def _zeros(params: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _full(params: Params, value: float) -> Params:
    return {k: torch.full_like(v, value) for k, v in params.items()}


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
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


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """Momentum: ``t = g + decay * t``; the update is ``t`` (or
    ``g + decay * t`` with Nesterov)."""
    def update(g, state, params=None):
        new = {k: v + decay * state[k] for k, v in g.items()}
        if nesterov:
            return {k: v + decay * new[k] for k, v in g.items()}, new
        return new, new

    return GradientTransformation(_zeros, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0,
                  nesterov: bool = False) -> GradientTransformation:
    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(g, state, params=None):
        count = state["count"] + 1
        mu = {k: (1 - b1) * v + b1 * state["mu"][k] for k, v in g.items()}
        nu = {k: (1 - b2) * (v ** 2) + b2 * state["nu"][k]
              for k, v in g.items()}
        bc1 = _bias_correction(b1, count)
        if nesterov:
            bc1_next = _bias_correction(b1, count + 1)
            mu_hat = {k: b1 * (mu[k] / bc1_next) + (1 - b1) * (v / bc1)
                      for k, v in g.items()}
        else:
            mu_hat = {k: m / bc1 for k, m in mu.items()}
        bc2 = _bias_correction(b2, count)
        out = {k: mu_hat[k] / (torch.sqrt(nu[k] / bc2 + eps_root) + eps)
               for k in g}
        return out, {"count": count, "mu": mu, "nu": nu}

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
            nu_hat = {k: n / bc for k, n in nu_hat.items()}
            if centered:
                mu_hat = {k: m / bc for k, m in mu_hat.items()}
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


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(g, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return {k: v + weight_decay * params[k] for k, v in g.items()}, state

    return GradientTransformation(lambda params: (), update)


def _lr(learning_rate) -> GradientTransformation:
    if callable(learning_rate):
        raise NotImplementedError(
            "learning-rate schedules are not ported yet; pass a float")
    return scale(-learning_rate)


def _no(name: str, value) -> None:
    if value is not None:
        raise NotImplementedError(f"{name}= is not ported yet")


def sgd(learning_rate, momentum: Optional[float] = None,
        nesterov: bool = False, accumulator_dtype=None):
    _no("accumulator_dtype", accumulator_dtype)
    parts = [] if momentum is None else [trace(momentum, nesterov)]
    return chain(*parts, _lr(learning_rate))


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
         mu_dtype=None, *, nesterov: bool = False):
    _no("mu_dtype", mu_dtype)
    return chain(scale_by_adam(b1, b2, eps, eps_root, nesterov),
                 _lr(learning_rate))


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
          mu_dtype=None, weight_decay: float = 1e-4, mask=None, *,
          nesterov: bool = False):
    _no("mu_dtype", mu_dtype)
    _no("mask", mask)
    return chain(scale_by_adam(b1, b2, eps, eps_root, nesterov),
                 add_decayed_weights(weight_decay), _lr(learning_rate))


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
    _no("weight_decay_mask", weight_decay_mask)
    parts = [add_decayed_weights(weight_decay), scale_by_adadelta(rho, eps)]
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
