"""Bucketed-shape inference: one forward shape per batch bucket, none new
after warmup (counterpart of ``distkeras_tpu/serving/model.py``).

A live request stream produces ragged batch sizes — 3 rows now, 17 rows
next. Every micro-batch is padded up to the smallest bucket from
``DKTPU_SERVE_BUCKETS`` that fits it, so the model only ever sees
``len(buckets)`` input shapes, all run once at warmup. PyTorch runs
eagerly and builds no program per shape, but the contract is kept: the
first forward at an input shape counts as that shape's "compile", and one
observed *after* warmup is a contract violation that fires the
``serving.retrace_after_warmup`` counter.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.serving.batcher import bucket_for


class BucketedModel:
    """A :class:`~distkeras_tpu_torch.models.base.Model` wrapped for
    serving: padded-bucket forward under ``torch.inference_mode()``, warmup
    over every bucket, and per-shape "compile" accounting."""

    def __init__(self, model, buckets: Sequence[int]):
        self.model = model
        self.buckets = tuple(buckets)
        self._shapes: set = set()
        self._compiles = 0
        self._warmed = False
        self._lock = threading.Lock()

    def _forward(self, arrays: tuple) -> np.ndarray:
        key = tuple((a.shape, a.dtype.str) for a in arrays)
        with self._lock:
            new = key not in self._shapes
            if new:
                self._shapes.add(key)
                self._compiles += 1
        if new and self._warmed:
            telemetry.counter("serving.retrace_after_warmup").add(1)
            telemetry.event("serve_retrace", {"compiles": self._compiles})
        with torch.inference_mode():
            out = self.model.apply(*arrays)
        return out.cpu().numpy()

    # -- lifecycle ----------------------------------------------------------

    def warmup(self) -> int:
        """Run every bucket's forward on zeros shaped from the model's
        ``sample_spec`` (its build-time input signature). Returns the
        number of new shapes run; after this, any further new shape is a
        counted retrace. Outputs that are not finite raise: those
        parameters are refused."""
        spec = self.model.sample_spec
        if spec is None:
            raise ValueError(
                "BucketedModel.warmup needs model.sample_spec (models from "
                "Model.build carry one) to know the per-row input shapes")
        before = self._compiles
        for b in self.buckets:
            inputs = tuple(np.zeros((b,) + tuple(s.shape[1:]), s.dtype)
                           for s in spec)
            out = self._forward(inputs)
            if not np.all(np.isfinite(out)):
                raise ValueError(
                    f"warmup probe produced non-finite outputs at bucket "
                    f"{b}: refusing to serve these parameters")
        self._warmed = True
        return self._compiles - before

    @property
    def warmed(self) -> bool:
        return self._warmed

    def compiles(self) -> int:
        """Input shapes run so far (warmup included)."""
        return self._compiles

    # -- inference ----------------------------------------------------------

    def infer(self, arrays: Sequence[np.ndarray],
              rows: Optional[int] = None) -> np.ndarray:
        """Forward ``arrays`` (leading axis = rows) padded up to the
        smallest fitting bucket; the padding rows are sliced back off the
        output, so callers only ever see their own rows."""
        arrays = tuple(np.asarray(a) for a in arrays)
        n = int(arrays[0].shape[0]) if rows is None else int(rows)
        bucket = bucket_for(n, self.buckets)
        if bucket is None:
            raise ValueError(
                f"batch of {n} rows exceeds the largest bucket "
                f"{self.buckets[-1]} (the batcher caps batches below this)")
        if bucket != n:
            arrays = tuple(
                np.concatenate(
                    [a, np.zeros((bucket - n,) + a.shape[1:], a.dtype)])
                for a in arrays)
        return self._forward(arrays)[:n]
