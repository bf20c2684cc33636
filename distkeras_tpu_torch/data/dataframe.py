"""A minimal columnar DataFrame (the port's copy of
``distkeras_tpu/data/dataframe.py``; numpy only).

The reference leans on Spark DataFrames for everything row-shaped: training input
(``Trainer.train(dataframe)``), transformer pipelines, prediction output columns.
This is the accelerator-side stand-in: named numpy columns, immutable ops, no JVM. It is a
*data-plane* object — trainers convert it to device arrays once, at batch-plan time;
nothing here is traced.

API parity notes (SURVEY.md §2, ``utils.py``):
* ``with_column`` ~ ``new_dataframe_row`` / Spark ``withColumn``
* ``repartition(n)`` ~ Spark repartition — here a metadata hint consumed by trainers
* ``shuffle()`` ~ ``utils.shuffle(dataframe)``
* ``precache()`` ~ ``utils.precache`` (force materialization) — numpy is always
  materialized, so it only validates column alignment.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Optional, Sequence

import numpy as np


class DataFrame:
    def __init__(self, columns: Mapping[str, np.ndarray], num_partitions: Optional[int] = None):
        if not columns:
            raise ValueError("DataFrame needs at least one column")
        cols = {k: np.asarray(v) for k, v in columns.items()}
        n = {len(v) for v in cols.values()}
        if len(n) != 1:
            raise ValueError(f"column length mismatch: { {k: len(v) for k, v in cols.items()} }")
        self._cols = cols
        self._num_rows = n.pop()
        self.num_partitions = num_partitions

    # -- construction ------------------------------------------------------
    @classmethod
    def from_arrays(cls, **columns) -> "DataFrame":
        return cls(columns)

    # -- inspection --------------------------------------------------------
    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    def count(self) -> int:
        return self._num_rows

    def __len__(self) -> int:
        return self._num_rows

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def head(self, n: int = 5) -> dict[str, np.ndarray]:
        return {k: v[:n] for k, v in self._cols.items()}

    # -- transformation (all return new frames) ----------------------------
    def with_column(self, name: str, values: np.ndarray) -> "DataFrame":
        cols = dict(self._cols)
        cols[name] = np.asarray(values)
        return DataFrame(cols, self.num_partitions)

    def select(self, *names: str) -> "DataFrame":
        return DataFrame({n: self._cols[n] for n in names}, self.num_partitions)

    def drop(self, *names: str) -> "DataFrame":
        return DataFrame(
            {k: v for k, v in self._cols.items() if k not in names}, self.num_partitions
        )

    def take_rows(self, idx: np.ndarray) -> "DataFrame":
        return DataFrame({k: v[idx] for k, v in self._cols.items()}, self.num_partitions)

    def repartition(self, n: int) -> "DataFrame":
        return DataFrame(self._cols, num_partitions=n)

    def shuffle(self, seed: int = 0) -> "DataFrame":
        rng = np.random.default_rng(seed)
        return self.take_rows(rng.permutation(self._num_rows))

    def precache(self) -> "DataFrame":
        return self

    def split(self, fraction: float, seed: int = 0) -> tuple["DataFrame", "DataFrame"]:
        """Random train/test split (two-way shorthand for :meth:`random_split`)."""
        a, b = self.random_split([fraction, 1.0 - fraction], seed=seed)
        return a, b

    def random_split(self, weights: Sequence[float], seed: int = 0) -> list["DataFrame"]:
        """N-way random split by relative ``weights`` — Spark's
        ``DataFrame.randomSplit([0.8, 0.2])``, so reference notebooks port
        without rewriting their split calls."""
        w = np.asarray(weights, dtype=np.float64)
        if len(w) < 1 or (w <= 0).any():
            raise ValueError(f"weights must be positive, got {list(weights)}")
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self._num_rows)
        cuts = np.floor(np.cumsum(w / w.sum()) * self._num_rows).astype(int)
        return [self.take_rows(part) for part in np.split(idx, cuts[:-1])]

    #: Spark-spelled alias (the notebooks call ``df.randomSplit``).
    randomSplit = random_split

    def iter_rows(self) -> Iterator[dict]:
        for i in range(self._num_rows):
            yield {k: v[i] for k, v in self._cols.items()}
