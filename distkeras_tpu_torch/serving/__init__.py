"""Online serving plane of the port: continuous micro-batching over the
wire, answered on the card (counterpart of ``distkeras_tpu/serving/``).

* **continuous micro-batching** — concurrent requests coalesce up to a
  latency budget and pad to bucketed shapes, all run at warmup
  (``serving/batcher.py``, ``serving/model.py``);
* **admission control** — bounded queue, shed-before-accept, typed
  overload/deadline replies; an accepted request is never silently
  dropped (``serving/errors.py``);
* **the wire** — the JAX package's frames, so either package's client
  talks to either package's frontend (``serving/frontend.py``);
* **checkpoint hot-swap** — ``ModelRegistry(directory=...)`` restores
  newer verified steps, warmup-probes them and swaps them in between
  batches (``serving/registry.py``);
* **replica sets** — ``ServingReplicaSet`` runs N frontends a client walks
  on failure, and ``ServingService`` runs them as a fleet tenant the
  scheduler never drains below its floor (``serving/replica.py``).
"""

from distkeras_tpu_torch.serving.batcher import (
    MicroBatcher,
    bucket_for,
    parse_buckets,
)
from distkeras_tpu_torch.serving.errors import (
    DeadlineExceededError,
    ModelUnavailableError,
    OverloadedError,
    ServingError,
)
from distkeras_tpu_torch.serving.frontend import ServeClient, ServingFrontend
from distkeras_tpu_torch.serving.model import BucketedModel
from distkeras_tpu_torch.serving.registry import ModelRegistry
from distkeras_tpu_torch.serving.replica import (
    ServingReplicaSet,
    ServingService,
)

__all__ = [
    "BucketedModel",
    "DeadlineExceededError",
    "MicroBatcher",
    "ModelRegistry",
    "ModelUnavailableError",
    "OverloadedError",
    "ServeClient",
    "ServingError",
    "ServingFrontend",
    "ServingReplicaSet",
    "ServingService",
    "bucket_for",
    "parse_buckets",
]
