"""Fleet jobs: what a tenant submits to the :class:`FleetScheduler` (the
port's copy of the JAX package's ``fleet/job.py``).

A :class:`FleetJob` pairs the *placement contract* (tenant, priority, gang
bounds) with a *runtime* — any object implementing the small duck-typed
protocol below. The scheduler owns placement, preemption, and worker
threads; the runtime owns the actual work. The real training runtime is
:class:`~distkeras_tpu_torch.fleet.run.ElasticTraining` (netps workers over a
per-job parameter server); tests drive the scheduler with synthetic
runtimes, so every placement/preemption edge is exercised without a
model or a card.

Runtime protocol (duck-typed, no base class to inherit)::

    ensure_started()                 # idempotent; launch servers, build plans
    worker_main(worker_id, should_run)   # one worker's loop; return when
                                         # should_run() goes False or work ends
    progress() -> int                # cumulative applied commits (preempt@R)
    done() -> bool                   # all work committed
    revoke(worker_id)                # lease revocation on the job's PS
    close()                          # finalize (pull params, drain servers)

``worker_main`` runs on a scheduler-owned thread under a telemetry label
scope (``tenant=``/``job=``), so any metric it writes with
``telemetry.label_suffix()`` and any event it fires is attributed.
"""

from __future__ import annotations

import itertools
from typing import Optional

#: terminal + live job states (strings, not an enum: they print well in
#: events and the report).
QUEUED = "queued"
RUNNING = "running"
DRAINING = "draining"   # fully preempted: workers exiting, then re-queued
DONE = "done"
FAILED = "failed"

_IDS = itertools.count()


class FleetJob:
    """One tenant's job: placement contract + runtime.

    ``min_gang`` is the gang floor — the job starts only when that many
    slots can be granted at once, and a running job is never shrunk below
    it (full preemption drains it entirely and re-queues it instead).
    ``max_workers`` bounds elastic expansion. ``priority``: higher wins;
    placement within a priority level is FIFO by submission.

    ``kind`` marks what the job serves the cluster as: ``"training"``
    (default) jobs are ordinary preemption victims; ``"serving"`` jobs are
    latency-bound — the scheduler may shrink them down to ``min_gang`` (the
    preemption floor protecting tail latency) but never fully drains them
    for a higher-priority arrival.
    """

    def __init__(self, name: str, tenant: str, runtime,
                 priority: int = 0, min_gang: int = 1,
                 max_workers: Optional[int] = None,
                 kind: str = "training"):
        if kind not in ("training", "serving"):
            raise ValueError(
                f"kind must be 'training' or 'serving', got {kind!r}")
        self.name = str(name)
        self.tenant = str(tenant)
        self.runtime = runtime
        self.kind = kind
        self.priority = int(priority)
        self.min_gang = int(min_gang)
        self.max_workers = int(max_workers if max_workers is not None
                               else self.min_gang)
        if self.min_gang < 1:
            raise ValueError(f"min_gang must be >= 1, got {self.min_gang}")
        if self.max_workers < self.min_gang:
            raise ValueError(
                f"max_workers {self.max_workers} < min_gang {self.min_gang}")
        #: scheduler-owned state (read via FleetScheduler.stats()).
        self.state = QUEUED
        self.submit_idx: Optional[int] = None
        self.preemptions = 0    # workers taken by preemption (shrink + drain)
        self.shrinks = 0        # shrink operations against this job
        self.expands = 0        # elastic re-expansions granted
        self.restarts = 0       # crashed workers restarted
        self.requeues = 0       # full preemptions -> back to the queue
        #: preemption debt: workers taken and not yet re-granted (drives
        #: the per-job `fleet.preempt_debt` gauge).
        self.debt = 0
        self.error: Optional[BaseException] = None

    @property
    def job_id(self) -> str:
        return f"{self.tenant}/{self.name}"

    def _stamp_submitted(self) -> None:
        if self.submit_idx is None:
            self.submit_idx = next(_IDS)

    def __repr__(self) -> str:
        return (f"FleetJob({self.job_id!r}, prio={self.priority}, "
                f"gang=[{self.min_gang}, {self.max_workers}], "
                f"state={self.state})")
