"""The Supervisor: bounded retry-with-resume around ``Trainer.train`` (the
port's copy of ``distkeras_tpu/resilience/supervisor.py``).

``Checkpointer`` has existed since v0.5 but nothing *restarted* from it —
a crashed run left a perfectly good checkpoint on disk and a dead process.
The Supervisor closes the loop::

    trainer = ADAG(model, checkpoint_dir="ckpt", checkpoint_every=1, ...)
    model = Supervisor(trainer, max_retries=3).train(df, shuffle=True)

On an exception from ``train`` it flips the trainer to ``resume=True``
(so the rebuilt engine restores the latest intact checkpoint — integrity
verified against the hash sidecar, falling back to the previous step when
corrupt — and continues from the recorded round), waits an exponentially
backed-off delay, and retries, up to ``max_retries`` times. The retry
budget is bounded: a deterministic crash re-raises after the budget, it
does not loop forever. ``Trainer.train`` rebuilds its engine and plan per
call, so re-entry is safe by construction.

This is the in-process half of recovery; the cross-process half (a host
hard-killed mid-run, ``kill@R``) is a restart of the process by whatever
runs it, which lands in the same resume path via ``resume=True`` (the JAX
package's ``Job.supervise``; the port has no job launcher yet).
"""

from __future__ import annotations

import time
import warnings
from typing import Tuple, Type

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.resilience.backoff import full_jitter


class Supervisor:
    """Wrap a trainer's ``train`` in a bounded retry-with-resume loop.

    Parameters
    ----------
    trainer:
        Any :class:`~distkeras_tpu_torch.trainers.Trainer`. For resume (rather
        than retry-from-scratch) it must have ``checkpoint_dir`` and a
        nonzero ``checkpoint_every``.
    max_retries:
        Retries *after* the first attempt (3 → up to 4 attempts total).
    backoff_s / max_backoff_s:
        Exponential retry envelope: each retry sleeps a **full-jitter**
        draw from ``[0, min(max_backoff_s, backoff_s * 2**(attempt-1)))``
        (:func:`~distkeras_tpu_torch.resilience.backoff.full_jitter` — the same
        rule the netps client uses), so simultaneously-crashed trainers
        don't retry in lockstep. Pass ``backoff_s=0`` for immediate
        retries (tests).
    retry_on:
        Exception types worth retrying. Defaults to ``Exception`` —
        ``KeyboardInterrupt``/``SystemExit`` always propagate.
    """

    def __init__(self, trainer, max_retries: int = 3, backoff_s: float = 1.0,
                 max_backoff_s: float = 60.0,
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,)):
        self.trainer = trainer
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.retry_on = tuple(retry_on)
        #: attempts made by the most recent :meth:`train` call.
        self.attempts = 0
        if not getattr(trainer, "checkpoint_dir", None):
            warnings.warn(
                "Supervisor: trainer has no checkpoint_dir — retries will "
                "restart training from scratch instead of resuming",
                stacklevel=2)
        elif not getattr(trainer, "checkpoint_every", 0):
            warnings.warn(
                "Supervisor: trainer has checkpoint_every=0 — only the "
                "end-of-run checkpoint exists, so a mid-run crash resumes "
                "from round 0; set checkpoint_every for real resume points",
                stacklevel=2)

    def train(self, dataframe, shuffle: bool = False):
        self.attempts = 0
        with telemetry.span("resilience.supervised_train"):
            while True:
                self.attempts += 1
                try:
                    return self.trainer.train(dataframe, shuffle=shuffle)
                except self.retry_on as e:
                    retries = self.attempts - 1
                    if retries >= self.max_retries:
                        telemetry.counter(
                            "resilience.supervisor_exhausted").add(1)
                        raise
                    telemetry.counter("resilience.supervisor_retries").add(1)
                    # The event records HOW the retry recovers (resume vs
                    # scratch) and, fired under any ambient
                    # label scope (``telemetry.core.scoped_labels``), carries
                    # its labels.
                    telemetry.event("supervisor_retry", {
                        "attempt": self.attempts, "error": repr(e),
                        "resume": bool(self.trainer.checkpoint_dir)})
                    how = ("resuming from checkpoint"
                           if self.trainer.checkpoint_dir
                           else "restarting from scratch")
                    warnings.warn(
                        f"supervised train attempt {self.attempts} failed "
                        f"({type(e).__name__}: {e}); {how} "
                        f"({self.max_retries - retries} retries left)",
                        stacklevel=2)
                    if self.trainer.checkpoint_dir:
                        self.trainer.resume = True
                    delay = full_jitter(self.backoff_s, retries,
                                        self.max_backoff_s)
                    if delay > 0:
                        time.sleep(delay)


def supervise(trainer, dataframe, shuffle: bool = False, **kwargs):
    """One-call sugar: ``supervise(trainer, df)`` ==
    ``Supervisor(trainer, **kwargs).train(df)``."""
    return Supervisor(trainer, **kwargs).train(dataframe, shuffle=shuffle)
