"""Host numbers inside a multi-round program (``parallel/program.py``).

A round reads a few numbers that the host computes from counters it keeps
in the state: adam's bias corrections and a schedule's step from the
optimizer's update count (``ops/optimizers.py``), DynSGD's commit scale
from the round counter (``parallel/disciplines.py``). Per round they are
Python floats, and PyTorch hands them to its kernels as scalars. A CUDA
graph would bake such a float in at capture time and reuse it on every
replay, so inside a program the counters are 0-dim int64 tensors on the
state's device and each number is read from a table indexed by them:

* the table is computed on the host, once, with the same ``np.float32``
  code as the per-round path, over every value the counter can take in
  the run (:class:`Tables`, ``count_size``), and copied to the device
  before any capture;
* the device gathers ``table[counter]``: a round that the in-program NaN
  guard skips keeps its counters, so the next round reads the entry the
  per-round path would read, without the host knowing which rounds were
  skipped.

The tables hold what reproduces the per-round arithmetic bit for bit on
the device at hand. A factor is a multiplication by the float either way.
A divisor is where the devices differ: PyTorch's CUDA division by a host
scalar is a multiplication by its float32 reciprocal, its CPU division a
true division, so on CUDA the table holds ``float32(1) / float32(d)``
and :func:`divide` multiplies, on the CPU it holds ``d`` and divides.

Outside a program (:func:`active` is None) nothing here is used: the
counters are Python ints and the numbers Python floats.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Hashable, Optional

import numpy as np
import torch

_LOCAL = threading.local()


class Tables:
    """The host-number tables of one program, on ``device``.

    ``count_size`` bounds the update counters the run reaches (a table
    indexed by a count has that many entries). A table is built at its
    first lookup, which must come before the capture (a warm-up round):
    once :meth:`freeze` ran, a new table raises, since building one copies
    from the host."""

    def __init__(self, device, count_size: int):
        self.device = torch.device(device)
        self.count_size = int(count_size)
        self._tables: dict = {}
        self._frozen = False

    def freeze(self) -> None:
        self._frozen = True

    def table(self, key: Hashable, fn: Callable[[int], float],
              size: Optional[int], divisor: bool) -> torch.Tensor:
        size = self.count_size if size is None else int(size)
        full = (key, size, divisor)
        t = self._tables.get(full)
        if t is None:
            if self._frozen:
                raise RuntimeError(
                    f"host-number table {key!r} first asked for inside a "
                    "capture: every table is built by the warm-up round")
            vals = np.array([np.float32(fn(i)) for i in range(size)],
                            np.float32)
            if divisor and self.device.type == "cuda":
                with np.errstate(divide="ignore"):  # count 0 is never read
                    vals = np.float32(1) / vals
            t = torch.from_numpy(vals).to(self.device)
            self._tables[full] = t
        return t


class Divisor:
    """A host divisor read from a table: :func:`divide` applies it as the
    per-round path's ``t / d`` does on this device."""

    __slots__ = ("value", "reciprocal")

    def __init__(self, value: torch.Tensor, reciprocal: bool):
        self.value = value
        self.reciprocal = reciprocal


def active() -> Optional[Tables]:
    """The tables of the program running on this thread, or None."""
    return getattr(_LOCAL, "tables", None)


@contextlib.contextmanager
def program(tables: Tables):
    """Run the body as a program's round: counters are tensors and their
    numbers come from ``tables``."""
    prev = active()
    _LOCAL.tables = tables
    try:
        yield tables
    finally:
        _LOCAL.tables = prev


def _gather(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return torch.index_select(table, 0, index.reshape(1).long()).reshape(())


def factor(key: Hashable, fn: Callable[[int], float], index: torch.Tensor,
           size: Optional[int] = None) -> torch.Tensor:
    """``float32(fn(index))`` as a 0-dim float32 tensor (multiply by it)."""
    tables = active()
    if tables is None:
        raise RuntimeError("a counter tensor outside a multi-round program")
    return _gather(tables.table(key, fn, size, False), index)


def divisor(key: Hashable, fn: Callable[[int], float], index: torch.Tensor,
            size: Optional[int] = None) -> Divisor:
    """``fn(index)`` as a :class:`Divisor` (divide by it with
    :func:`divide`)."""
    tables = active()
    if tables is None:
        raise RuntimeError("a counter tensor outside a multi-round program")
    t = tables.table(key, fn, size, True)
    return Divisor(_gather(t, index), tables.device.type == "cuda")


def divide(t: torch.Tensor, d) -> torch.Tensor:
    """``t / d`` for a host float ``d`` or a :class:`Divisor`."""
    if isinstance(d, Divisor):
        return t * d.value if d.reciprocal else t / d.value
    return t / d
