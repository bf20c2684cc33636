"""The model registry the serving frontend reads (counterpart of
``distkeras_tpu/serving/registry.py``).

The :class:`ModelRegistry` owns the live warmed
:class:`~distkeras_tpu_torch.serving.model.BucketedModel` and its version
(-1: the build-time parameters). The frontend's dispatch thread reads the
``(model, version)`` pair once per batch through :meth:`current`.

Watching a checkpoint directory and hot-swapping newer verified steps
needs the port's own checkpoint format, which a later slice brings:
passing ``directory`` raises ``NotImplementedError`` until then.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.runtime.device import resolve_device
from distkeras_tpu_torch.serving.model import BucketedModel


class ModelRegistry:
    """Owns the live :class:`BucketedModel` + its version. The model is
    moved to ``device`` first (default: the first CUDA device; raises where
    there is none — pass ``device="cpu"`` for the CPU)."""

    def __init__(self, model, buckets, directory: Optional[str] = None,
                 poll_s: Optional[float] = None, warmup: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        if directory is not None:
            raise NotImplementedError(
                "ModelRegistry(directory=...) hot-swaps checkpoints, which "
                "needs the port's checkpoint format (checkpoint.py); it is "
                "not ported yet — serve the build-time parameters with "
                "directory=None")
        dev = resolve_device(device)
        model.module.to(dev)
        model.device = dev
        self.directory = directory
        self.poll_s = float(config.env_float("DKTPU_SERVE_POLL_S")
                            if poll_s is None else poll_s)
        self.buckets = tuple(buckets)
        self._lock = threading.Lock()
        #: True while warmup runs — the not-ready window the frontend's
        #: stats op reports to health-aware clients.
        self.warming = True
        self._bucketed = BucketedModel(model, self.buckets)
        try:
            if warmup:
                self._bucketed.warmup()
        finally:
            self.warming = False
        self._version = -1

    def current(self) -> tuple[BucketedModel, int]:
        """The live (model, version) pair — one atomic read per batch."""
        with self._lock:
            return self._bucketed, self._version

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def compiles(self) -> int:
        with self._lock:
            return self._bucketed.compiles()

    def start(self) -> None:
        """Nothing to watch without a checkpoint directory (kept so callers
        written for the JAX registry run unchanged)."""

    def close(self) -> None:
        """Nothing to stop without a checkpoint directory."""
