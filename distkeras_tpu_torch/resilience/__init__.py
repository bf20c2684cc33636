"""Resilience surface of the port: the typed error taxonomy and the shared
full-jitter backoff rule."""

from distkeras_tpu_torch.resilience.backoff import backoff_cap, full_jitter
from distkeras_tpu_torch.resilience.errors import ResilienceError

__all__ = ["ResilienceError", "backoff_cap", "full_jitter"]
