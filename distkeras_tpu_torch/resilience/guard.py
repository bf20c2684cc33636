"""Per-run resilience hooks of the engine run loop (the port's copy of
``distkeras_tpu/resilience/guard.py``).

Two layers of defense, split by cost:

* **In the round** (on unless ``DKTPU_NAN_GUARD=0``): the engine's round
  keeps the *previous* state when any worker's round loss went non-finite
  (one host read of the ``[W]`` loss vector a round, which the round makes
  anyway; inside a multi-round program a select on the device, with no
  host read, ``parallel/program.py``). :func:`nan_guard_enabled` is the policy switch; the skip itself
  lives in ``parallel/engine.py``; :func:`note_losses` is the post-hoc
  accounting of the rounds it skipped.
* **Host-side** (:class:`RoundGuard`): fault injection (``crash@R`` /
  ``kill@R``) and the divergent-worker reset. The reset is opt-in
  (``divergence_reset=thr`` on the async trainers, or
  ``DKTPU_DIVERGENCE_RESET``); it reads the host copy of the round's
  losses the NaN guard already made, so it adds no sync of its own.
"""

from __future__ import annotations

import os
import signal
from typing import Optional

import numpy as np

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.resilience import faults
from distkeras_tpu_torch.resilience.errors import InjectedFault
from distkeras_tpu_torch.runtime import config


def nan_guard_enabled() -> bool:
    """Default for the engine's NaN/Inf round skip."""
    return config.env_bool("DKTPU_NAN_GUARD")


class RoundGuard:
    """Per-run host-side guard, constructed by the engine run loop.

    Inactive (the common case: no faults configured, no divergence reset)
    every method is a branch-and-return — the run loop pays nothing.
    """

    def __init__(self, engine):
        self.engine = engine
        self.plan = faults.active_plan()
        thr = getattr(engine, "divergence_reset", None)
        if thr is None:
            thr = config.env_float("DKTPU_DIVERGENCE_RESET")
        disc = getattr(engine, "discipline", None)
        self.divergence_reset: Optional[float] = (
            float(thr)
            if thr is not None and disc is not None
            and getattr(disc, "communicates", False)
            and hasattr(engine, "reset_workers")
            else None)
        self._inject = self.plan is not None and bool(self.plan)

    def pre_round(self, round_idx: int) -> None:
        """Crash/kill injection, fired before the round runs (a blocked run
        fires it for every round of a block before the block runs: the
        fault lands at the block's boundary)."""
        if not self._inject:
            return
        if self.plan.kill(round_idx):
            # The mid-run host kill: unmaskable, no cleanup — what a
            # preempted or OOM-killed host looks like to its supervisor.
            os.kill(os.getpid(), signal.SIGKILL)
        if self.plan.crash(round_idx):
            raise InjectedFault(
                f"crash injected at round {round_idx} (DKTPU_FAULTS)")

    def post_round(self, round_idx: int, loss, state, host_loss=None):
        """Divergent-worker reset: when a worker's loss strays more than
        ``divergence_reset`` from the (finite) worker mean — or went
        non-finite while the round as a whole survived — re-adopt the
        center for that worker (the reference's rejoining-worker PS pull).
        ``loss`` is the round's ``[W]`` losses, on the host already when
        the NaN guard read them (then ``.cpu()`` copies nothing);
        ``host_loss``, when given, is their host copy (a block's last round,
        which the blocked run loop already fetched). A blocked run calls
        this once a block, with the block's last round. Returns the
        (possibly replaced) state."""
        if self.divergence_reset is None:
            return state
        host = np.asarray(host_loss if host_loss is not None
                          else loss.detach().cpu().numpy())
        host = host.reshape(-1).astype(np.float64)
        if host.size < 2:
            return state
        finite = host[np.isfinite(host)]
        if finite.size == 0:
            return state  # whole round poisoned — the NaN skip handles it
        mask = (~np.isfinite(host)
                | (np.abs(host - finite.mean()) > self.divergence_reset))
        if not mask.any() or mask.all():
            # All-divergent has no healthy center estimate to re-adopt
            # against; leave it to the NaN skip / supervisor.
            return state
        telemetry.counter("resilience.worker_resets").add(int(mask.sum()))
        telemetry.event("worker_reset", {
            "round": round_idx,
            "workers": [int(i) for i in np.flatnonzero(mask)]})
        return self.engine.reset_workers(state, mask)


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
