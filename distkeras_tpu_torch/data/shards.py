"""Sharded, out-of-core columnar store (the port's copy of
``distkeras_tpu/data/shards.py``; numpy and the standard library only).

The reference's data plane was a Spark DataFrame: partitioned across
executors and spillable to disk, so no single host ever had to hold the
full dataset. The in-RAM :class:`~.dataframe.DataFrame` covers the
notebook case; this module covers ImageNet-shaped data (BASELINE config
#5) that does not fit in a host's RAM.

* **On-disk layout** — plain ``.npy`` shard files per column plus a JSON
  manifest, byte for byte the JAX package's: a store either package
  writes, the other reads. Every reader is ``np.load(mmap_mode='r')``:
  gathers touch only the pages they index, so a 100 GB column costs RAM
  proportional to the rows read this round, not the dataset.
* **Worker-contiguous partitioning** — worker ``w`` of ``W`` owns global
  rows ``[w·(n//W), (w+1)·(n//W))``, as Spark's ``repartition`` gave each
  executor one contiguous partition. Shuffling permutes within a worker's
  partition each epoch.
* **Per-host shard residency** — a process needs only the shard files
  overlapping its own workers' row ranges (``ShardedBatchPlan.
  local_shards``). ``ShardStore`` memmaps shards lazily and never opens a
  file it is not asked to read.
* **Per-round gather** — ``ShardedBatchPlan.round(r)`` gathers the rows
  round ``r`` consumes through the native threaded gather
  (``data/native_loader.py``); the engine stages it as it stages an
  in-RAM round (``parallel/engine.py stage_round``), inside the
  ``RoundFeeder``'s lookahead. ``round_local(r, workers)`` gathers only
  the given workers' rows, transformed exactly as ``round`` would.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import OrderedDict
from typing import Mapping, Optional, Sequence

import numpy as np

from distkeras_tpu_torch.data.batching import apply_round_transform
from distkeras_tpu_torch.data.native_loader import gather_rows

_MANIFEST = "manifest.json"
_PART_MANIFEST = "manifest.part.json"


def _shard_file(shard: int, col: str) -> str:
    return f"shard-{shard:05d}.{col}.npy"


_MERGE_JOURNAL = ".merge.journal.json"


def merge_manifests(path: str) -> dict:
    """Splice ``part-*/`` writer outputs into one readable store.

    Run after every :class:`ShardWriter` with ``part=k`` closed (e.g. by
    process 0 behind a barrier): renames each part's shard files into the
    global shard sequence in part-id order (same-filesystem renames — no data
    is copied), validates that every part wrote the same column schema, and
    publishes the root manifest atomically. Reads from the merged store are
    byte-identical to a single writer fed the concatenated row stream with
    per-part shard boundaries.

    Crash-safe and idempotent: the full rename plan is journaled
    (``.merge.journal.json``, atomic write) BEFORE any file moves, each move
    is skip-if-already-done on replay, and the journal is removed only after
    the root manifest publishes — so re-running after a crash at ANY point
    resumes the same merge instead of restarting the shard counter over
    already-spliced files (which would silently clobber them)."""
    journal_path = os.path.join(path, _MERGE_JOURNAL)
    if os.path.exists(journal_path):
        with open(journal_path) as f:
            plan = json.load(f)  # resume an interrupted merge
    else:
        # A FRESH merge must target a fresh directory: the rename plan starts
        # at global shard 0, so a root that already holds a published store
        # (earlier merge / direct ShardWriter run) would have its shard files
        # silently clobbered. The journal only protects the CURRENT merge
        # against crashes, not against this misuse.
        existing = [f for f in os.listdir(path)
                    if f == _MANIFEST
                    or (f.startswith("shard-") and f.endswith(".npy"))]
        if existing:
            raise FileExistsError(
                f"{path} already contains a published store "
                f"({existing[0]}{' ...' if len(existing) > 1 else ''}): "
                "merging part-*/ directories here would overwrite its "
                "shard files from global id 0. Ingest parts into a fresh "
                "directory, or remove the existing store first.")
        parts = sorted(d for d in os.listdir(path)
                       if d.startswith("part-")
                       and os.path.isdir(os.path.join(path, d)))
        if not parts:
            raise FileNotFoundError(
                f"no part-*/ writer directories under {path}")
        columns: Optional[dict] = None
        shard_rows: list[int] = []
        moves: list[list] = []  # [part_dir, local_shard, global_shard]
        g = 0
        for d in parts:
            with open(os.path.join(path, d, _PART_MANIFEST)) as f:
                pm = json.load(f)
            if not pm["shard_rows"]:
                continue  # a writer that saw zero rows contributes nothing
            if columns is None:
                columns = pm["columns"]
            elif pm["columns"] != columns:
                raise ValueError(
                    f"part {d} wrote a different column schema: "
                    f"{pm['columns']} vs {columns}")
            for i, rows in enumerate(pm["shard_rows"]):
                moves.append([d, i, g])
                shard_rows.append(int(rows))
                g += 1
        if columns is None:
            raise ValueError(f"every part under {path} was empty")
        plan = {"parts": parts, "columns": columns,
                "shard_rows": shard_rows, "moves": moves}
        tmp = journal_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(plan, f)
        os.replace(tmp, journal_path)

    for d, i, g in plan["moves"]:
        for col in plan["columns"]:
            src = os.path.join(path, d, _shard_file(i, col))
            dst = os.path.join(path, _shard_file(g, col))
            if os.path.exists(src):
                os.replace(src, dst)
            elif not os.path.exists(dst):
                raise FileNotFoundError(
                    f"merge cannot resume: neither {src} nor {dst} exists")
    for d in plan["parts"]:
        pdir = os.path.join(path, d)
        try:
            os.remove(os.path.join(pdir, _PART_MANIFEST))
        except OSError:
            pass
        try:
            os.rmdir(pdir)
        except OSError:
            pass

    shard_rows = [int(r) for r in plan["shard_rows"]]
    offsets = np.concatenate([[0], np.cumsum(shard_rows)]).tolist()
    manifest = {
        "version": 1,
        "num_rows": int(offsets[-1]),
        "columns": plan["columns"],
        "shard_rows": shard_rows,
        "shard_offsets": [int(o) for o in offsets[:-1]],
    }
    tmp = os.path.join(path, ".manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, _MANIFEST))
    os.remove(journal_path)
    return manifest


class ShardWriter:
    """Streaming writer: append row chunks, emit ``rows_per_shard``-row shard
    files. Nothing is ever held beyond one shard's buffer, so a 100 GB dataset
    can be written from a generator with bounded RAM (the ingest-side half of
    the out-of-core contract).

    **Distributed ingest** (the Spark-executor-parallel write): pass
    ``part=k`` on writer ``k`` of N — each writer streams its own row range
    into an isolated ``part-000NN/`` subdirectory (no cross-writer
    coordination, any filesystem), then ONE caller runs
    :func:`merge_manifests` after every writer closed, which splices the
    parts into the global shard sequence (cheap same-filesystem renames)
    and publishes the root manifest. Part order = part id, so the merged
    row order is writer 0's rows, then writer 1's, ...
    """

    def __init__(self, path: str, rows_per_shard: int,
                 part: Optional[int] = None):
        if rows_per_shard < 1:
            raise ValueError(f"rows_per_shard must be >= 1, got {rows_per_shard}")
        self.path = path
        self.part = part
        self._dir = (path if part is None
                     else os.path.join(path, f"part-{int(part):05d}"))
        self.rows_per_shard = int(rows_per_shard)
        os.makedirs(self._dir, exist_ok=True)
        self._buf: dict[str, list[np.ndarray]] = {}
        self._buffered = 0
        self._shards: list[int] = []  # rows per emitted shard
        self._meta: Optional[dict] = None
        self._closed = False

    def append(self, **columns: np.ndarray) -> None:
        cols = {k: np.asarray(v) for k, v in columns.items()}
        n = {len(v) for v in cols.values()}
        if len(n) != 1:
            raise ValueError(
                f"column length mismatch: { {k: len(v) for k, v in cols.items()} }")
        n = n.pop()
        if self._meta is None:
            self._meta = {
                k: {"dtype": str(v.dtype), "shape": list(v.shape[1:])}
                for k, v in cols.items()
            }
            self._buf = {k: [] for k in cols}
        elif set(cols) != set(self._meta):
            raise ValueError(
                f"columns changed mid-stream: {sorted(cols)} vs {sorted(self._meta)}")
        for k, v in cols.items():
            m = self._meta[k]
            if list(v.shape[1:]) != m["shape"] or str(v.dtype) != m["dtype"]:
                raise ValueError(
                    f"column {k!r}: got {v.dtype}{list(v.shape[1:])}, "
                    f"expected {m['dtype']}{m['shape']}")
            self._buf[k].append(v)
        self._buffered += n
        while self._buffered >= self.rows_per_shard:
            self._flush(self.rows_per_shard)

    def _flush(self, rows: int) -> None:
        shard = len(self._shards)
        for k, chunks in self._buf.items():
            cat = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
            np.save(os.path.join(self._dir, _shard_file(shard, k)), cat[:rows])
            self._buf[k] = [cat[rows:]] if rows < len(cat) else []
        self._shards.append(rows)
        self._buffered -= rows

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # Only publish the manifest on clean exit: a partially-written store
        # without a manifest is unreadable (fails loudly) rather than
        # silently truncated. Tolerates an explicit close() inside the block
        # (the way to get the returned manifest).
        if exc_type is None and not self._closed:
            self.close()

    def close(self) -> dict:
        """Flush the tail shard and write the manifest; returns the manifest.

        A ``part=k`` writer publishes a PART manifest inside its own
        subdirectory instead of the root one — the store only becomes
        readable once :func:`merge_manifests` splices every part."""
        if self._closed:
            raise RuntimeError("ShardWriter already closed")
        if self._buffered:
            self._flush(self._buffered)
        self._closed = True
        offsets = np.concatenate([[0], np.cumsum(self._shards)]).tolist()
        manifest = {
            "version": 1,
            "num_rows": int(offsets[-1]),
            "columns": self._meta or {},
            "shard_rows": [int(r) for r in self._shards],
            "shard_offsets": [int(o) for o in offsets[:-1]],
        }
        name = _MANIFEST if self.part is None else _PART_MANIFEST
        with open(os.path.join(self._dir, name), "w") as f:
            json.dump(manifest, f)
        return manifest


def write_shards(path: str, columns: Mapping[str, np.ndarray],
                 rows_per_shard: int) -> dict:
    """One-shot convenience: shard in-RAM columns to ``path``."""
    w = ShardWriter(path, rows_per_shard)
    w.append(**dict(columns))
    return w.close()


class ShardStore:
    """Reader over a shard directory: lazily memmapped, locality-honest.

    ``gather(col, row_ids)`` opens only the shard files the ids land in — a
    host holding a disjoint subset of the shards can serve every row it owns
    and fails loudly (FileNotFoundError) on rows it does not, which is the
    property the per-host data plane relies on (and tests assert)."""

    #: open-memmap cap. Each memmap holds a file descriptor for its lifetime;
    #: a ~150 GB store can span thousands of shard files, and an unbounded
    #: cache would blow the default 1024-fd ulimit mid-epoch. LRU keeps the
    #: hot working set (a round touches few shards) while bounding fds.
    MAX_OPEN_MAPS = 128

    def __init__(self, path: str, max_open_maps: Optional[int] = None):
        self.path = path
        with open(os.path.join(path, _MANIFEST)) as f:
            m = json.load(f)
        self.manifest = m
        self.num_rows: int = m["num_rows"]
        self.columns: dict = m["columns"]
        self._offsets = np.asarray(m["shard_offsets"] + [m["num_rows"]], np.int64)
        self._max_open = max_open_maps or self.MAX_OPEN_MAPS
        self._maps: "OrderedDict[tuple[int, str], np.ndarray]" = OrderedDict()

    @classmethod
    def open(cls, path: str) -> "ShardStore":
        return cls(path)

    def count(self) -> int:
        return self.num_rows

    def column_spec(self, col: str) -> tuple[tuple, np.dtype]:
        c = self.columns[col]
        return tuple(c["shape"]), np.dtype(c["dtype"])

    def shard_range(self, shard: int) -> tuple[int, int]:
        return int(self._offsets[shard]), int(self._offsets[shard + 1])

    @property
    def num_shards(self) -> int:
        return len(self._offsets) - 1

    def shards_for_rows(self, lo: int, hi: int) -> list[int]:
        """Shard ids overlapping global row range ``[lo, hi)``."""
        s0 = int(np.searchsorted(self._offsets, lo, side="right")) - 1
        s1 = int(np.searchsorted(self._offsets, hi, side="left"))
        return list(range(max(s0, 0), max(s1, 0)))

    def _map(self, shard: int, col: str) -> np.ndarray:
        # Columns may be stored under a versioned physical name ("file"):
        # re-predicting an existing output column writes fresh files and
        # swaps the manifest atomically instead of renaming over live ones.
        phys = self.columns.get(col, {}).get("file", col)
        key = (shard, col)
        mm = self._maps.get(key)
        if mm is None:
            fp = os.path.join(self.path, _shard_file(shard, phys))
            mm = np.load(fp, mmap_mode="r")
            while len(self._maps) >= self._max_open:
                # Dropping the reference closes the underlying mmap + fd
                # (gathers copy out of the map, so no views outlive it).
                self._maps.popitem(last=False)
            self._maps[key] = mm
        else:
            self._maps.move_to_end(key)
        return mm

    def close(self) -> None:
        """Release every cached memmap (and its file descriptor)."""
        self._maps.clear()

    def read_shard(self, shard: int, col: str) -> np.ndarray:
        """One whole shard of a column (a single sequential read — the fast
        path for full scans). Returns a writable COPY: handing out the
        cached memmap would let consumers pin evicted maps' file
        descriptors past the LRU bound."""
        return np.array(self._map(shard, col))

    def gather(self, col: str, row_ids: np.ndarray) -> np.ndarray:
        """``rows[row_ids]`` across shard files; result shape
        ``row_ids.shape + row_shape``. Order-preserving."""
        ids = np.asarray(row_ids)
        flat = ids.reshape(-1).astype(np.int64)
        if flat.size and (flat.min() < 0 or flat.max() >= self.num_rows):
            raise IndexError(
                f"row ids out of range [0, {self.num_rows}) for column {col!r}")
        shape, dtype = self.column_spec(col)
        out = np.empty((flat.size,) + shape, dtype)
        shard_of = np.searchsorted(self._offsets, flat, side="right") - 1
        for s in np.unique(shard_of):
            sel = np.nonzero(shard_of == s)[0]
            base = self._offsets[s]
            # memmap-backed: the gather faults in only the touched pages.
            out[sel] = gather_rows(self._map(int(s), col), flat[sel] - base)
        return out.reshape(ids.shape + shape)


class ShardedDataFrame:
    """Trainer-facing handle over a :class:`ShardStore` — the drop-in for
    ``Trainer.train(dataframe)`` at out-of-core scale. Row data stays on disk;
    only per-round gathers materialize. Column transforms belong at ingest
    time (``ShardWriter``), like Spark pipelines ran before ``repartition``."""

    is_sharded = True

    def __init__(self, store_or_path, num_partitions: Optional[int] = None):
        self.store = (store_or_path if isinstance(store_or_path, ShardStore)
                      else ShardStore.open(store_or_path))
        self.num_partitions = num_partitions

    @property
    def columns(self) -> list[str]:
        return list(self.store.columns)

    def count(self) -> int:
        return self.store.count()

    def __len__(self) -> int:
        return self.store.count()

    def __contains__(self, name: str) -> bool:
        return name in self.store.columns

    def repartition(self, n: int) -> "ShardedDataFrame":
        return ShardedDataFrame(self.store, num_partitions=n)

    def iter_column_chunks(self, *cols: str):
        """Yield ``{col: rows}`` one shard at a time — the bounded-memory
        row stream that out-of-core predictors/evaluators consume (the
        Spark-partition-iterator analogue). Whole-shard reads go straight to
        the memmap (one sequential read; no per-row index math)."""
        for s in range(self.store.num_shards):
            yield {c: self.store.read_shard(s, c) for c in cols}

    def __getattr__(self, name):
        if name in {"with_column", "select", "drop", "take_rows", "shuffle",
                    "split", "random_split", "randomSplit", "iter_rows"}:
            raise AttributeError(
                f"ShardedDataFrame does not materialize rows; {name!r} is an "
                "in-RAM DataFrame op. Apply one-shot transforms at ingest "
                "time (ShardWriter), per-round transforms at training time "
                "(Trainer(transform=fn) / make_batches(transform=fn)) — "
                "shuffling is the planner's job (make_batches(..., "
                "shuffle=True) permutes within partitions).")
        raise AttributeError(name)


def worker_partition(num_rows: int, num_workers: int) -> list[tuple[int, int]]:
    """Worker ``w``'s contiguous global row range (Spark repartition analogue).

    Equal-sized ``n // W`` partitions; the remainder tail is dropped, matching
    the in-RAM planner's drop of rows that don't fill a complete round."""
    rpw = num_rows // num_workers
    return [(w * rpw, (w + 1) * rpw) for w in range(num_workers)]


def worker_major_index(
    num_rows: int,
    num_workers: int,
    window: int,
    batch_size: int,
    num_epoch: int = 1,
    shuffle: bool = False,
    seed: int = 0,
) -> np.ndarray:
    """The sharded schedule: ``[rounds, W, K, B]`` global row ids where row
    ``index[r, w]`` ⊂ worker ``w``'s contiguous partition for every round.

    Deterministic in ``seed`` — every process computes the identical matrix,
    which is what lets hosts stage disjoint data without coordination. With
    ``shuffle``, each (epoch, worker) gets an independent permutation *within
    the worker's partition* (per-partition shuffling, the Spark-era
    semantics); rows beyond ``rounds_per_epoch·K·B`` differ per epoch."""
    per_worker_round = window * batch_size
    rpw = num_rows // num_workers
    if rpw < per_worker_round:
        raise ValueError(
            f"each worker's partition has {rpw} rows but one round consumes "
            f"window*batch_size = {per_worker_round}; shrink "
            "batch_size/communication_window or add data")
    rounds_per_epoch = rpw // per_worker_round
    used = num_workers * rounds_per_epoch * per_worker_round
    if used < num_rows:
        import warnings

        remainder = num_rows - rpw * num_workers
        truncated = num_rows - remainder - used
        warnings.warn(
            f"sharded plan uses {used} of {num_rows} rows per epoch "
            f"({num_rows - used} dropped: {remainder} to the worker "
            f"remainder num_rows % num_workers, {truncated} to round "
            f"truncation — each worker's {rpw}-row partition fits "
            f"{rounds_per_epoch} full rounds of window*batch_size="
            f"{per_worker_round}). With shuffle=True different rows are "
            "dropped each epoch; resize batch_size/communication_window to "
            "change the fit.",
            stacklevel=2,
        )
    rng = np.random.default_rng(seed)
    epochs = []
    for _ in range(num_epoch):
        per_w = []
        for w in range(num_workers):
            local = rng.permutation(rpw) if shuffle else np.arange(rpw)
            per_w.append(
                w * rpw
                + local[: rounds_per_epoch * per_worker_round].reshape(
                    rounds_per_epoch, window, batch_size))
        epochs.append(np.stack(per_w, axis=1))  # [rounds, W, K, B]
    return np.concatenate(epochs, axis=0)


@dataclasses.dataclass
class ShardedBatchPlan:
    """A :class:`~.batching.BatchPlan`-shaped schedule whose rows live on disk.

    Same engine-facing surface (``num_rounds``/``samples_per_round``/
    ``round``), plus the locality contract: ``is_local=True`` marks a plan
    whose rows a process may stage per worker (:meth:`round_local`). The
    one-process engines of the port stage the full ``round``
    (``parallel/engine.py stage_round``); the remote worker loop, which
    gathers from an in-RAM plan's arrays, refuses it."""

    store: ShardStore
    features_col: str
    label_col: str
    index: np.ndarray  # [rounds, W, K, B] global row ids
    num_workers: int
    window: int
    batch_size: int
    rows_total: int
    #: optional training-time ``fn(features, labels, rng)`` (see
    #: ``batching.apply_round_transform``): applied per worker slice with a
    #: (transform_seed, round, worker)-seeded rng, so disjoint per-host
    #: staging (round_local) and full staging (round) transform identically —
    #: the lazy Spark-pipeline half the store's ingest-time-only transforms
    #: could not express (per-epoch randomized augmentation).
    transform: object = None
    transform_seed: int = 0

    is_local = True

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
        """Full ``[W, K, B, ...]`` gather — valid only where every shard is
        present (single host, or a shared filesystem)."""
        return self.round_local(r, range(self.num_workers))

    def round_local(self, r: int, workers: Sequence[int]
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Rows for the given workers only: ``[len(workers), K, B, ...]``.
        Touches only the shards overlapping those workers' partitions."""
        workers = list(workers)
        idx = self.index[r][np.asarray(workers, np.int64)]
        xs = self.store.gather(self.features_col, idx)
        ys = self.store.gather(self.label_col, idx)
        if self.transform is not None:
            # Seeded by GLOBAL worker id: a host staging workers [2, 3]
            # transforms them exactly as a full-store host would.
            xs, ys = apply_round_transform(
                self.transform, self.transform_seed, r, workers, xs, ys)
        return xs, ys

    def local_shards(self, workers: Sequence[int]) -> list[int]:
        """Shard ids a process hosting ``workers`` needs on local disk."""
        parts = worker_partition(self.store.count(), self.num_workers)
        shards: set[int] = set()
        for w in workers:
            lo, hi = parts[w]
            shards.update(self.store.shards_for_rows(lo, hi))
        return sorted(shards)


def make_sharded_batches(
    df,
    features_col: str,
    label_col: str,
    batch_size: int,
    num_workers: int,
    window: int = 1,
    num_epoch: int = 1,
    shuffle: bool = False,
    seed: int = 0,
    transform=None,
) -> ShardedBatchPlan:
    """Plan ``num_epoch`` passes over a :class:`ShardedDataFrame` /
    :class:`ShardStore` (the disk-backed twin of ``batching.make_batches``)."""
    store = df.store if isinstance(df, ShardedDataFrame) else df
    for col in (features_col, label_col):
        if col not in store.columns:
            raise KeyError(f"column {col!r} not in store ({list(store.columns)})")
    index = worker_major_index(
        store.count(), num_workers, window, batch_size,
        num_epoch=num_epoch, shuffle=shuffle, seed=seed)
    return ShardedBatchPlan(
        store=store,
        features_col=features_col,
        label_col=label_col,
        index=index,
        num_workers=num_workers,
        window=window,
        batch_size=batch_size,
        rows_total=store.count() * num_epoch,
        transform=transform,
        transform_seed=seed,
    )
