"""Self-tuning data plane: the controller that closes the loop from
telemetry to knobs (the port's copy of the JAX package's
``netps/tuner/``).

The data plane's knob space (``DKTPU_NET_INFLIGHT`` / ``COMPRESS`` /
``SHARDS`` / ``TRANSPORT`` / ``HIER``) is context-dependent: int8 wins on
cross-host TCP but loses on the shm ring (the quantize passes cost more
than the bytes they save at memcpy speed), and hierarchical aggregation
only beats flat topology above a fan-in crossover. Gated by
``DKTPU_NET_AUTOTUNE=1`` (off by default), this package:

* runs **join-time micro A/B probes** (:mod:`~distkeras_tpu_torch.netps.
  tuner.probe`): a few timed probe ops per candidate codec over the
  negotiated connection; the server decodes each payload as it decodes a
  commit (on the card, one ``fold_commit`` launch into a scratch window)
  and touches nothing else. A peer without the ``tuner`` caps bit is
  never probed and the static knobs stand;
* runs an **online control loop** (:class:`~distkeras_tpu_torch.netps.
  tuner.controller.Tuner`) over the gauges the run already exports
  (``netps.overlap.hidden_fraction``, ``discipline.staleness_mean``,
  ``netps.hier.fan_in``) and retunes compression / inflight / striping
  mid-run through the existing renegotiation paths
  (:meth:`~distkeras_tpu_torch.netps.client.PSClient.retune` +
  ``adopt_dialect``), picks the hierarchical topology by the fan-in
  crossover, and — with hysteresis, per-knob cooldowns and an
  oscillation fallback to the static knobs — never violates a floor and
  keeps every exactly-once and fencing guarantee;
* gates **elastic expansion on measured marginal throughput**
  (:class:`~distkeras_tpu_torch.netps.tuner.fleet.MarginalThroughputPolicy`):
  an expansion whose last granted worker did not move the job's commit
  rate is not repeated.

Every decision is a telemetry event (``tuner_decision`` / ``tuner_probe``
/ ``tuner_fallback`` / ``tuner_run_summary``) plus counters, under the JAX
package's names.
"""

from distkeras_tpu_torch.netps.tuner.controller import (
    Decision,
    Tuner,
    TunerConfig,
    TunerState,
    autotune_enabled,
    recommended_topology,
)
from distkeras_tpu_torch.netps.tuner.fleet import MarginalThroughputPolicy
from distkeras_tpu_torch.netps.tuner.probe import ProbeResult, best_codec, probe_codecs

__all__ = [
    "Decision",
    "MarginalThroughputPolicy",
    "ProbeResult",
    "Tuner",
    "TunerConfig",
    "TunerState",
    "autotune_enabled",
    "best_codec",
    "probe_codecs",
    "recommended_topology",
]
