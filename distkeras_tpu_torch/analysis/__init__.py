"""dk-check for the port: repo-aware static analysis of
``distkeras_tpu_torch`` (the JAX package's ``analysis/``, aimed at the
port's own code and registries).

Six rule families over a plain-AST pass (no imports of the analyzed
code), run as ``python -m distkeras_tpu_torch.analysis [paths]``:

* **DK1xx** (``rules_torch``) — captured-code hazards: env/time/random
  reads, host I/O and device-to-host reads, telemetry calls, or mutation
  of enclosing state inside code that a CUDA graph captures.
* **DK2xx** (``rules_concurrency``) — host-thread hazards: lock-order
  cycles, unlocked writes to lock-guarded attributes, leaked non-daemon
  threads, KeyboardInterrupt-swallowing except handlers. The static lock
  graph is cross-checked at runtime by :mod:`.witness`.
* **DK3xx** (``rules_config``) — env discipline: ``os.environ`` confined to
  ``runtime/config.py``, every ``DKTPU_*`` name declared in the port's
  ``ENV_REGISTRY``, the port's docs tables generated from it.
* **DK4xx** / **DK5xx** / **DK6xx** — wire-protocol registry, durability
  ordering, and telemetry/fault-kind contract drift.

Suppress a finding with ``# dk: disable=DK204`` on its line (justify in the
comment); catalog and how-to in ``distkeras_tpu_torch/docs/ANALYSIS.md``.
:mod:`.interleave` model-checks the port's netps, journal and aggregator
machines across every schedule of small scenarios.
"""

from distkeras_tpu_torch.analysis.core import (  # noqa: F401
    Finding, RULE_CATALOG, render, run)
from distkeras_tpu_torch.analysis.witness import (  # noqa: F401
    LockOrderWitness, witness)
