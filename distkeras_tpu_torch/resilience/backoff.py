"""Exponential backoff with full jitter — the one shared retry-delay rule
(the port's copy of the JAX package's ``resilience/backoff.py``).

Full jitter (uniform over ``[0, cap]`` rather than ``cap`` itself) matters
when many actors fail *together*: clients cut off by one partition would
otherwise all sleep the identical delay and retry in lockstep. Jitter
decorrelates the herd; the exponential envelope still bounds total
pressure.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def backoff_cap(base_s: float, attempt: int, max_s: float = 30.0) -> float:
    """The deterministic exponential envelope: ``min(max_s, base * 2**n)``.
    Exposed separately so tests can assert the jittered draw stays inside."""
    if base_s <= 0:
        return 0.0
    return float(min(max_s, base_s * (2.0 ** max(0, int(attempt)))))


def full_jitter(base_s: float, attempt: int, max_s: float = 30.0,
                rng: Optional[np.random.Generator] = None) -> float:
    """A delay drawn uniformly from ``[0, backoff_cap(base, attempt, max))``
    (AWS full-jitter). ``attempt`` counts from 0 (first retry). A dedicated
    ``rng`` makes tests deterministic; production callers share the module
    default, which is deliberately unseeded — decorrelation is the point."""
    cap = backoff_cap(base_s, attempt, max_s)
    if cap <= 0:
        return 0.0
    gen = rng if rng is not None else _DEFAULT_RNG
    return float(gen.uniform(0.0, cap))


_DEFAULT_RNG = np.random.default_rng()
