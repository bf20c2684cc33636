"""Data plane of the port: the columnar DataFrame, batch planning and the
round prefetcher (numpy and threads, copied from the JAX package's
``data/``). Feature transformers and sharded stores come with later
slices."""

from distkeras_tpu_torch.data.batching import BatchPlan, make_batches
from distkeras_tpu_torch.data.dataframe import DataFrame

__all__ = ["BatchPlan", "DataFrame", "make_batches"]
