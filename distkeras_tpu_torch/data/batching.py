"""Batch planning: DataFrame -> device-shaped minibatch arrays (the port's
copy of ``distkeras_tpu/data/batching.py``; numpy only).

This is where the Spark semantics become array semantics. The reference pipeline is
``df.repartition(num_workers)`` then each executor iterates its partition in
``batch_size`` minibatches and syncs with the parameter server every
``communication_window`` steps (``workers.py`` hot loop, SURVEY.md §3.1).

Here the same schedule is planned up front as an **index matrix** — one int32 row id
per (round, worker, step, sample) — and gathered round-by-round::

    plan.round(r) -> features [num_workers, window, batch_size, ...], labels [...]

One copy of the data lives in host RAM regardless of ``num_epoch`` (the plan stores
permutations, not copies), so 90-epoch ImageNet plans cost 90 index rows, not 90
datasets. Round ``r`` = one fold round: every worker runs ``window`` local steps on its
``[window, batch_size]`` slice, then the fold fires. Worker-major layout keeps
each worker's rows contiguous (the moral equivalent of a Spark partition).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from distkeras_tpu_torch.data.dataframe import DataFrame
from distkeras_tpu_torch.data.native_loader import gather_rows


def apply_round_transform(transform, seed: int, r: int, workers, xs, ys):
    """Training-time row transform, deterministic in ``(seed, round, worker)``.

    ``transform(features[n, ...], labels[n, ...], rng) -> (features, labels)``
    is called once per worker slice with the slice flattened to rows and an
    independent ``np.random.Generator`` seeded from the triple — so
    ``round_local(r, ws)`` equals ``round(r)[ws]`` by construction, and
    disjoint multi-host staging sees exactly the rows replicated staging
    would (the property the 2-proc equality tests pin). This is the lazy
    half of the Spark pipeline the reference chained over its distributed
    DataFrame: per-epoch randomized augmentation (crop/flip) that ingest-time
    transforms cannot express. Row count must be preserved; dtype/shape of
    the rows may change (e.g. uint8 pixels -> normalized float32)."""
    out_x, out_y = [], []
    for i, w in enumerate(workers):
        rng = np.random.default_rng(
            np.random.SeedSequence((int(seed), int(r), int(w))))
        lead = xs[i].shape[:2]  # [K, B]
        n = lead[0] * lead[1]
        fx, fy = transform(xs[i].reshape((n,) + xs[i].shape[2:]),
                           ys[i].reshape((n,) + ys[i].shape[2:]), rng)
        fx, fy = np.asarray(fx), np.asarray(fy)
        if len(fx) != n or len(fy) != n:
            raise ValueError(
                f"transform must preserve row count: got {len(fx)}/{len(fy)} "
                f"rows for {n} in")
        out_x.append(fx.reshape(lead + fx.shape[1:]))
        out_y.append(fy.reshape(lead + fy.shape[1:]))
    return np.stack(out_x), np.stack(out_y)


@dataclasses.dataclass
class BatchPlan:
    x: np.ndarray  # [n, ...feature dims] — single materialized copy
    y: np.ndarray  # [n, ...label dims]
    index: np.ndarray  # [rounds, W, K, B] int64 row ids
    num_workers: int
    window: int
    batch_size: int
    rows_total: int
    #: optional training-time ``fn(features, labels, rng)`` applied to every
    #: staged round (see :func:`apply_round_transform`); seeded per
    #: (transform_seed, round, worker).
    transform: object = None
    transform_seed: int = 0

    @property
    def num_rounds(self) -> int:
        return self.index.shape[0]

    @property
    def rows_used(self) -> int:
        return int(self.index.size)

    @property
    def steps_per_worker(self) -> int:
        return self.num_rounds * self.window

    @property
    def samples_per_round(self) -> int:
        return self.num_workers * self.window * self.batch_size

    def round(self, r: int) -> tuple[np.ndarray, np.ndarray]:
        """Materialize round ``r``: ``[W, K, B, ...]`` feature + label arrays
        through the native threaded gather (``data/native_loader.py``),
        bit-identical to numpy's fancy indexing."""
        idx = self.index[r]
        xs, ys = gather_rows(self.x, idx), gather_rows(self.y, idx)
        if self.transform is not None:
            xs, ys = apply_round_transform(
                self.transform, self.transform_seed, r,
                range(self.num_workers), xs, ys)
        return xs, ys


def make_batches(
    df: DataFrame,
    features_col: str,
    label_col: str,
    batch_size: int,
    num_workers: int,
    window: int = 1,
    num_epoch: int = 1,
    shuffle: bool = False,
    seed: int = 0,
    transform=None,
) -> BatchPlan:
    """Lay out ``num_epoch`` passes over ``df`` as fold-round index matrices.

    Rows that don't fill a complete round are dropped (the reference likewise
    truncates trailing partial minibatches per partition). With ``shuffle`` each
    epoch gets an independent permutation, so dropped rows differ per epoch.

    ``transform``: optional training-time ``fn(features, labels, rng)`` row
    transform applied to every staged round, deterministically seeded per
    (seed, round, worker) — see :func:`apply_round_transform`.

    A :class:`~.shards.ShardedDataFrame` routes to the disk-backed planner
    (``shards.make_sharded_batches``): the same trainer call, with the rows
    left on disk and gathered round by round. Memmap-backed columns in a
    plain DataFrame also stay on disk (``np.asarray`` of a memmap is a
    view).
    """
    if getattr(df, "is_sharded", False):
        from distkeras_tpu_torch.data.shards import make_sharded_batches

        return make_sharded_batches(
            df, features_col, label_col, batch_size, num_workers,
            window=window, num_epoch=num_epoch, shuffle=shuffle, seed=seed,
            transform=transform)
    x = np.asarray(df[features_col])
    y = np.asarray(df[label_col])
    n = len(x)
    per_round = num_workers * window * batch_size
    if n < per_round:
        raise ValueError(
            f"dataset has {n} rows but one fold round needs "
            f"num_workers*window*batch_size = {per_round}; "
            "shrink batch_size/communication_window or add data"
        )

    rng = np.random.default_rng(seed)
    rounds_per_epoch = n // per_round
    epochs = []
    for _ in range(num_epoch):
        idx = rng.permutation(n) if shuffle else np.arange(n)
        epochs.append(
            idx[: rounds_per_epoch * per_round].reshape(
                rounds_per_epoch, num_workers, window, batch_size
            )
        )
    index = np.concatenate(epochs, axis=0)
    return BatchPlan(
        x=x,
        y=y,
        index=index,
        num_workers=num_workers,
        window=window,
        batch_size=batch_size,
        rows_total=n * num_epoch,
        transform=transform,
        transform_seed=seed,
    )
