"""Per-run resilience hooks of the engine run loop (the port's part of
``distkeras_tpu/resilience/guard.py``).

* The NaN/Inf round skip (on unless ``DKTPU_NAN_GUARD=0``): the engine's
  round keeps the *previous* state when any worker's round loss went
  non-finite. :func:`nan_guard_enabled` is the policy switch; the skip
  itself lives in ``parallel/engine.py``.
* :func:`note_losses`: the post-hoc accounting of the rounds the guard
  skipped, over a run's loss history.

The divergent-worker reset and fault injection (the JAX package's
``RoundGuard``) come with a later slice; the engine refuses
``divergence_reset`` until then.
"""

from __future__ import annotations

import numpy as np

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.runtime import config


def nan_guard_enabled() -> bool:
    """Default for the engine's NaN/Inf round skip."""
    return config.env_bool("DKTPU_NAN_GUARD")


def note_losses(losses) -> None:
    """Count the rounds in which any worker reported a non-finite loss (the
    rounds the guard skipped) into ``resilience.nonfinite_rounds``."""
    arr = np.asarray(losses, dtype=np.float64)
    if arr.size == 0:
        return
    rows = arr.reshape(arr.shape[0], -1)
    bad = int((~np.isfinite(rows)).any(axis=1).sum())
    if bad:
        telemetry.counter("resilience.nonfinite_rounds").add(bad)
