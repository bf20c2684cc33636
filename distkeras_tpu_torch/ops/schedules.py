"""Learning-rate schedules: the port's copies of the optax schedules a
JAX-package user passes through ``learning_rate=``.

A schedule is a plain callable ``schedule(count) -> rate`` on the update
count (an int, from 0). Each one here repeats optax's arithmetic in
float32 (the count an int, every product and quotient rounded to float32
as ``jnp`` rounds it), so the port's rates follow optax's step for step;
the transcendental ones (``cos``, ``pow``) may sit one float32 ulp from
XLA's. Any other callable works too: the optimizers only call it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np

Schedule = Callable[[int], float]

_f32 = np.float32


def constant_schedule(value: float) -> Schedule:
    """``value`` at every count (optax ``constant_schedule``)."""
    return lambda count: value


def polynomial_schedule(init_value: float, end_value: float, power,
                        transition_steps: int,
                        transition_begin: int = 0) -> Schedule:
    """From ``init_value`` to ``end_value`` along ``(1 - t)**power`` over
    ``transition_steps`` updates after ``transition_begin`` (optax
    ``polynomial_schedule``)."""
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(0, transition_begin)

    def schedule(count):
        c = min(max(int(count) - transition_begin, 0), transition_steps)
        frac = _f32(1) - _f32(c) / _f32(transition_steps)
        return (_f32(init_value - end_value) * frac ** power
                + _f32(end_value))

    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    """optax ``linear_schedule``: a polynomial schedule of power 1."""
    return polynomial_schedule(init_value, end_value, 1, transition_steps,
                               transition_begin)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    """``init_value * ((1 - alpha) * c**exponent + alpha)`` with ``c`` the
    half cosine from 1 to 0 over ``decay_steps`` (optax
    ``cosine_decay_schedule``)."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        c = np.minimum(_f32(count), _f32(decay_steps))
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c
                                               / _f32(decay_steps)))
        decayed = _f32(1 - alpha) * cosine ** _f32(exponent) + _f32(alpha)
        return _f32(init_value) * decayed

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """``schedules[i]`` from ``boundaries[i-1]`` on, each fed the count
    less its boundary (optax ``join_schedules``)."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if not int(count) < boundary:
                out = sched(int(count) - boundary)
        return _f32(out)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """A linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine decay to ``end_value`` at
    ``decay_steps`` (optax ``warmup_cosine_decay_schedule``)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                               alpha=alpha, exponent=exponent)],
        [warmup_steps])


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, transition_begin: int = 0,
                      staircase: bool = False,
                      end_value: Optional[float] = None) -> Schedule:
    """``init_value * decay_rate ** ((count - begin) / transition_steps)``
    (floored with ``staircase``), clipped at ``end_value`` (optax
    ``exponential_decay``)."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value
    transition_begin = max(0, transition_begin)
    clip = np.maximum if decay_rate < 1.0 else np.minimum

    def schedule(count):
        dec = int(count) - transition_begin
        p = _f32(dec) / _f32(transition_steps)
        if staircase:
            p = np.floor(p)
        value = (_f32(init_value) if dec <= 0
                 else _f32(init_value) * np.power(_f32(decay_rate), p))
        if end_value is not None:
            value = clip(value, _f32(end_value))
        return _f32(value)

    return schedule


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: Optional[dict] = None
                                ) -> Schedule:
    """``init_value`` times every scale whose boundary the count has
    reached (optax ``piecewise_constant_schedule``)."""
    if boundaries_and_scales is not None and not all(
            s >= 0.0 for s in boundaries_and_scales.values()):
        raise ValueError("`piecewise_constant_schedule` expects non-negative "
                         "scale factors")

    def schedule(count):
        v = _f32(init_value)
        for threshold, s in sorted((boundaries_and_scales or {}).items()):
            ind = _f32(max(0, int(np.sign(threshold - int(count)))))
            v = v * ind + (_f32(1) - ind) * _f32(s) * v
        return v

    return schedule
