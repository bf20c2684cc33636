"""Data plane of the port: the columnar DataFrame, the feature
transformers, batch planning, the round prefetcher, the out-of-core shard
store and the native gather (numpy, threads and a host C++ loop, copied
from the JAX package's ``data/`` and ``native/``)."""

from distkeras_tpu_torch.data.batching import BatchPlan, make_batches
from distkeras_tpu_torch.data.dataframe import DataFrame
from distkeras_tpu_torch.data.shards import (
    ShardedBatchPlan,
    ShardedDataFrame,
    ShardStore,
    ShardWriter,
    merge_manifests,
    write_shards,
)
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
           "ReshapeTransformer", "ShardStore", "ShardWriter",
           "ShardedBatchPlan", "ShardedDataFrame", "Transformer",
           "make_batches", "merge_manifests", "write_shards"]
