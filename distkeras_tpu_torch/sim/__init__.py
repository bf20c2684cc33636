"""Trace-calibrated fleet simulation: the what-if plane.

No test machine runs a thousand-worker fleet live, but the
planet-scale question does not need the hardware — it needs the
*control logic* exercised at that scale. The collector-merged
critical-path segments (encode/wire/queue/fold/fsync/replicate/ack
p50/p99 per deployment) ARE a timing model; this package builds the
deterministic discrete-event simulator they calibrate, and points it at
the REAL code wherever behavior could regress:

* the actual :class:`~distkeras_tpu_torch.fleet.scheduler.FleetScheduler`,
  ticked on a virtual clock with cooperative stand-in threads — real
  quota/gang/preemption/floor/restart logic, simulated job runtimes;
* the actual SLO engine, alert manager, and sentinels, fed synthesized
  :class:`~distkeras_tpu_torch.telemetry.health.hub.MetricsHub` series through
  its ``feed()`` seam — real burn-rate and hysteresis math;
* the real staleness-counter rules (``netps.fold.counter_staleness``,
  the hier MIN reduction, per-wid dedup, ``fold_delta`` arithmetic on a
  one-float center) inside :class:`~distkeras_tpu_torch.sim.cluster.SimCenter`.

Layout: :mod:`~distkeras_tpu_torch.sim.core` (the seedable event engine),
:mod:`~distkeras_tpu_torch.sim.model` (trace-fitted latency model over
``tracing.analysis.segment_model``), :mod:`~distkeras_tpu_torch.sim.cluster`
(centers, aggregation trees, link classes),
:mod:`~distkeras_tpu_torch.sim.fleet_driver` (the scheduler seams),
:mod:`~distkeras_tpu_torch.sim.calibrate` (bench replay + the flat→hier
crossover gate), :mod:`~distkeras_tpu_torch.sim.scenarios` (preemption storms,
failover cascades, region partitions, alert storms), and the
``python -m distkeras_tpu_torch.sim`` CLI (``run`` / ``calibrate`` /
``report``). The port's copy of the JAX package's ``sim/``: the
simulator runs on the host, as the reference's does; nothing in it
touches a device.
"""

from distkeras_tpu_torch.sim.calibrate import hier_crossover, sim_drift
from distkeras_tpu_torch.sim.cluster import (
    LinkClass,
    SimAggregator,
    SimCenter,
    TreeTopology,
)
from distkeras_tpu_torch.sim.core import SimEngine
from distkeras_tpu_torch.sim.fleet_driver import (
    SimJobRuntime,
    SimThreadFactory,
)
from distkeras_tpu_torch.sim.model import TimingModel
from distkeras_tpu_torch.sim.scenarios import SCENARIOS, run_scenario

__all__ = [
    "LinkClass",
    "SCENARIOS",
    "SimAggregator",
    "SimCenter",
    "SimEngine",
    "SimJobRuntime",
    "SimThreadFactory",
    "TimingModel",
    "TreeTopology",
    "hier_crossover",
    "run_scenario",
    "sim_drift",
]
