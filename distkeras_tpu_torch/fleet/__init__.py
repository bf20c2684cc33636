"""fleet — the multi-job elastic control plane (the port's counterpart of
the JAX package's ``fleet/``).

One worker pool, many tenants' training jobs, scheduled like a cluster
manager (the Spark resource-manager role the reference delegated and
never implemented):

* :mod:`~distkeras_tpu_torch.fleet.scheduler` — :class:`FleetScheduler`:
  per-tenant quotas, priority/FIFO queueing, gang placement (a job
  starts only when its minimum gang fits), preemption-driven elastic
  shrink/expand mid-run via PS lease revocation with a hard shrink
  floor at each job's min gang, graceful full-preemption drain +
  requeue, and the ``preempt@R`` chaos drill;
* :mod:`~distkeras_tpu_torch.fleet.job` — :class:`FleetJob`: the placement
  contract (tenant, priority, gang bounds) + the duck-typed runtime
  protocol the scheduler drives;
* :mod:`~distkeras_tpu_torch.fleet.run` — :class:`ElasticTraining`: the real
  training runtime — a claim-queue round schedule over a per-job netps
  parameter server on the card, so worker counts change mid-run without
  losing progress or exactly-once commit semantics;
* :mod:`~distkeras_tpu_torch.fleet.ports` — the per-host bind-probed port
  pool (:func:`reserve_port`) that lets two jobs' servers coexist on
  one host;
* :mod:`~distkeras_tpu_torch.fleet.placement` — aggregation-tree gang
  placement (:func:`place_tree`): every interior ``TreeSpec`` node on
  the first host of its own subtree, its warm standby region-local on
  the next, ports from the pool, endpoints failover-complete.

Per-tenant telemetry attribution rides on metric names
(``fleet.<metric>.<tenant>.<job>``) and ambient
:func:`~distkeras_tpu_torch.telemetry.scoped_labels`; ``python -m
distkeras_tpu_torch.telemetry report`` renders the per-tenant table. The
serving tenant is :class:`~distkeras_tpu_torch.serving.replica.
ServingService`.
"""

from __future__ import annotations

from distkeras_tpu_torch.fleet.job import (  # noqa: F401
    DONE,
    DRAINING,
    FAILED,
    QUEUED,
    RUNNING,
    FleetJob,
)
from distkeras_tpu_torch.fleet.placement import (  # noqa: F401
    NodePlacement,
    TreePlacement,
    place_tree,
)
from distkeras_tpu_torch.fleet.ports import (  # noqa: F401
    PortPool,
    release_port,
    reserve_port,
)
from distkeras_tpu_torch.fleet.run import ElasticTraining  # noqa: F401
from distkeras_tpu_torch.fleet.scheduler import (  # noqa: F401
    FleetScheduler,
    parse_quotas,
)

__all__ = [
    "FleetScheduler", "FleetJob", "ElasticTraining",
    "PortPool", "reserve_port", "release_port", "parse_quotas",
    "NodePlacement", "TreePlacement", "place_tree",
    "QUEUED", "RUNNING", "DRAINING", "DONE", "FAILED",
]
