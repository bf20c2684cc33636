"""Resilience of the port (the counterpart of
``distkeras_tpu/resilience/``): fault injection, failure detection and
auto-recovery.

* **Injection** (:mod:`~distkeras_tpu_torch.resilience.faults`): a seeded,
  env-driven :class:`FaultPlan` (``DKTPU_FAULTS="nan@3;stall@5:0.5;
  crash@7"``, and ``DKTPU_NET_FAULTS`` for the network kinds) that
  deterministically poisons batches to NaN/Inf, stalls or errors the
  feeder, crashes or kills the process mid-run, corrupts checkpoints, and
  drops, delays, duplicates or partitions parameter-server traffic.
* **Detection & policy**: the NaN/Inf round skip in the engine round
  (``DKTPU_NAN_GUARD=0`` disables), the feeder-stall watchdog and stage
  retry in :class:`~distkeras_tpu_torch.data.prefetch.RoundFeeder`, the
  divergent-worker reset (:class:`~distkeras_tpu_torch.resilience.guard.
  RoundGuard`, ``divergence_reset=thr``) and the checkpoint digest
  sidecars (:mod:`~distkeras_tpu_torch.resilience.integrity`).
* **Recovery** (:mod:`~distkeras_tpu_torch.resilience.supervisor`): the
  :class:`Supervisor` retry-with-resume loop around ``Trainer.train``.

Everything reports through ``resilience.*`` telemetry counters and events.
"""

from __future__ import annotations

from distkeras_tpu_torch.resilience import faults as _faults
from distkeras_tpu_torch.resilience.backoff import (  # noqa: F401
    backoff_cap,
    full_jitter,
)
from distkeras_tpu_torch.resilience.errors import (  # noqa: F401
    CheckpointCorruptError,
    FeederStalledError,
    InjectedFault,
    ResilienceError,
)
from distkeras_tpu_torch.resilience.faults import (  # noqa: F401
    FaultPlan,
    active_plan,
    set_plan,
)
from distkeras_tpu_torch.resilience.guard import (  # noqa: F401
    RoundGuard,
    nan_guard_enabled,
    note_losses,
)
from distkeras_tpu_torch.resilience.supervisor import (  # noqa: F401
    Supervisor,
    supervise,
)


def reset() -> None:
    """Clear ambient fault-plan state (tests)."""
    _faults.reset()


__all__ = [
    "ResilienceError", "InjectedFault", "FeederStalledError",
    "CheckpointCorruptError",
    "FaultPlan", "active_plan", "set_plan",
    "RoundGuard", "nan_guard_enabled", "note_losses",
    "Supervisor", "supervise",
    "backoff_cap", "full_jitter",
    "reset",
]
