"""Online serving plane of the port: continuous micro-batching over the
wire, answered on the card (counterpart of ``distkeras_tpu/serving/``).

* **continuous micro-batching** — concurrent requests coalesce up to a
  latency budget and pad to bucketed shapes, all run at warmup
  (``serving/batcher.py``, ``serving/model.py``);
* **admission control** — bounded queue, shed-before-accept, typed
  overload/deadline replies; an accepted request is never silently
  dropped (``serving/errors.py``);
* **the wire** — the JAX package's frames, so either package's client
  talks to either package's frontend (``serving/frontend.py``).

Checkpoint hot-swap and replica sets (``serving/replica.py``) come with
later slices.
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
    "bucket_for",
    "parse_buckets",
]
