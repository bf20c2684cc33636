"""Utility parity layer — the reference's ``distkeras/utils.py`` surface
(the port's counterpart of ``distkeras_tpu/utils.py``).

Functions keep their reference names where behavior maps 1:1 so ported
notebooks can do ``from distkeras_tpu_torch.utils import ...`` and run.
"""

from __future__ import annotations

import os

import numpy as np

from distkeras_tpu_torch.data.dataframe import DataFrame
from distkeras_tpu_torch.models.base import Model, uniform_weights  # noqa: F401 (re-export)
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.runtime.serialization import (
    deserialize_model,
    serialize_model,
)


def set_keras_base_directory(path: str = ".") -> None:
    """Reference parity (``distkeras/utils.py -> set_keras_base_directory``):
    pointed 2016-era Keras at a writable ``~/.keras`` on Spark executors.
    Nothing in the port touches a Keras home directory, but ported
    notebooks may still call it, so it accepts the call and points Keras
    3's home (``KERAS_HOME``) at ``<path>/.keras``."""
    config.env_set("KERAS_HOME", os.path.join(path, ".keras"))


def serialize_keras_model(model: Model) -> bytes:
    """Reference ``utils.serialize_keras_model``: model -> portable bytes
    (the JAX package's blob for the same weights)."""
    return serialize_model(model)


def deserialize_keras_model(data: bytes, device=None) -> Model:
    """Reference ``utils.deserialize_keras_model``: bytes -> model, on
    ``device`` (default: the first CUDA device; raises where there is
    none)."""
    return deserialize_model(data, device=device)


def shuffle(dataframe: DataFrame, seed: int = 0) -> DataFrame:
    """Reference ``utils.shuffle(dataframe)``: random row permutation."""
    return dataframe.shuffle(seed=seed)


def precache(dataframe: DataFrame) -> DataFrame:
    """Reference ``utils.precache``: force materialization (no-op here —
    numpy columns are always materialized)."""
    return dataframe.precache()


def new_dataframe_row(row: dict, name: str, value) -> dict:
    """Reference ``utils.new_dataframe_row``: row dict + one new column
    value."""
    out = dict(row)
    out[name] = value
    return out


def to_dense_vector(value, length: int) -> np.ndarray:
    """Reference ``utils.to_dense_vector``-style helper: one-hot of
    ``value``."""
    v = np.zeros((length,), np.float32)
    v[int(value)] = 1.0
    return v
