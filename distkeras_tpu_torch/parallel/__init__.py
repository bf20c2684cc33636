"""Training engines of the port: the discipline folds, the async engine
that multiplexes logical workers on one device, the synchronous engine
that merges them into one batch, and the model-parallel engines over a
grid of ranks (``sharding``, ``spmd``, ``gspmd``, ``pipeline``,
``pipeline_engine``, ``async_tp``, ``runner``), imported from their
modules."""

from distkeras_tpu_torch.parallel.disciplines import (
    ADAGFold,
    AEASGDFold,
    Discipline,
    DownpourFold,
    DynSGDFold,
    EAMSGDFold,
    EnsembleFold,
    get_discipline,
)
from distkeras_tpu_torch.parallel.engine import AsyncEngine, EngineState
from distkeras_tpu_torch.parallel.sync import SyncEngine, SyncState

__all__ = [
    "ADAGFold", "AEASGDFold", "AsyncEngine", "Discipline", "DownpourFold",
    "DynSGDFold", "EAMSGDFold", "EngineState", "EnsembleFold",
    "SyncEngine", "SyncState", "get_discipline",
]
