"""Training engines of the port: the discipline folds and the async engine
that multiplexes logical workers on one device."""

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

__all__ = [
    "ADAGFold", "AEASGDFold", "AsyncEngine", "Discipline", "DownpourFold",
    "DynSGDFold", "EAMSGDFold", "EngineState", "EnsembleFold",
    "get_discipline",
]
