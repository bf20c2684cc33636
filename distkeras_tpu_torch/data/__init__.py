"""Data plane of the port: the columnar DataFrame, the feature
transformers, batch planning and the round prefetcher (numpy and threads,
copied from the JAX package's ``data/``). Sharded stores come with a later
slice."""

from distkeras_tpu_torch.data.batching import BatchPlan, make_batches
from distkeras_tpu_torch.data.dataframe import DataFrame
from distkeras_tpu_torch.data.transformers import (
    DenseTransformer,
    LabelIndexTransformer,
    MinMaxTransformer,
    OneHotTransformer,
    ReshapeTransformer,
    Transformer,
)

__all__ = ["BatchPlan", "DataFrame", "DenseTransformer",
           "LabelIndexTransformer", "MinMaxTransformer", "OneHotTransformer",
           "ReshapeTransformer", "Transformer", "make_batches"]
