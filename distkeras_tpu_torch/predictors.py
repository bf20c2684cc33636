"""Inference over DataFrames — the port's counterpart of
``distkeras_tpu/predictors.py`` (parity with ``distkeras/predictors.py``).

The reference maps a deserialized model's ``predict`` over Spark partitions
and appends a prediction column (``ModelPredictor.predict(df)``). Here the
forward runs on the model's one device under ``torch.inference_mode()``,
in fixed ``chunk_size`` chunks: the last chunk is padded with repeats of
its final row and the padding trimmed, so every chunk has one shape, as in
the JAX package (where each shape is a compiled program). The module runs
in eval mode, so a stateful model predicts with its running statistics
(its BatchNorm buffers, ``Model.state``), as the JAX package's predictors
apply ``model.state``. A sharded store
(``ShardedDataFrame``) is predicted shard by shard into a new, versioned
column of the same store (``_predict_sharded``; :func:`vacuum` reclaims
superseded columns); across the ranks of a process group each rank
predicts the shards its own disk holds
(``_predict_sharded_multiprocess``). ``devices=`` (or ``num_workers=``)
splits each chunk over several devices, the rows kept in order.
"""

from __future__ import annotations

import copy
import json
import os
import time
import uuid
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.data.dataframe import DataFrame
from distkeras_tpu_torch.data.shards import (
    ShardedDataFrame,
    ShardStore,
    _shard_file,
)
from distkeras_tpu_torch.models.base import Model, normalize_features
from distkeras_tpu_torch.ops import collectives
from distkeras_tpu_torch.runtime import mesh
from distkeras_tpu_torch.runtime.device import resolve_device


class Predictor:
    """Base: ``predict(df) -> df`` with a new output column."""

    def predict(self, dataframe: DataFrame) -> DataFrame:
        raise NotImplementedError


def _observe_shards(stream):
    """Pass-through over a per-shard prediction stream that records per-shard
    rows and wall time (histograms ``predict.shard_rows`` and
    ``predict.shard_seconds``): the skew between shards.

    Timed around the generator resume only: the consumer's work after each
    yield (the per-shard ``np.save``) must not bleed into the next shard's
    observation."""
    tele = telemetry.get()
    rows = tele.histogram("predict.shard_rows")
    secs = tele.histogram("predict.shard_seconds")
    it = iter(stream)
    while True:
        t0 = time.perf_counter()
        try:
            out = next(it)
        except StopIteration:
            return
        secs.observe(time.perf_counter() - t0)
        rows.observe(float(len(out)))
        yield out


def _unlink_column_files(path: str, physical: str, num_shards: int) -> int:
    """Best-effort removal of a superseded physical column's shard files;
    returns how many files were removed. Missing files are fine (already
    cleaned); memmapped readers holding the old manifest survive the
    unlink (POSIX)."""
    removed = 0
    for s in range(num_shards):
        try:
            os.remove(os.path.join(path, _shard_file(s, physical)))
            removed += 1
        except OSError:
            pass
    return removed


def _publish_manifest(path: str, manifest: dict, tag: str = "") -> None:
    """Atomic manifest publish (tmp + rename), the one write path of both
    the predict publish and :func:`vacuum`; ``tag`` disambiguates the tmp
    name."""
    tmp = os.path.join(path, f".manifest.json{tag}.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, "manifest.json"))


def _rotate_garbage(manifest: dict, old_physical: Optional[str]) -> None:
    """Install this publish's superseded physical column as the manifest's
    ``garbage`` list (replacing the previous publish's, which the caller
    reclaims): the deferred-deletion rotation."""
    if old_physical is not None:
        manifest["garbage"] = [old_physical]
    else:
        manifest.pop("garbage", None)


def vacuum(path: str) -> int:
    """Reclaim superseded prediction columns' shard files now; returns the
    number of files removed.

    Re-predicting an existing column writes a fresh versioned physical
    column and records the old one under the manifest's ``garbage`` list
    instead of deleting it: a reader that opened the store before the
    re-predict may keep reading its column files for as long as it holds
    that manifest. Garbage is reclaimed by the next predict run over the
    same store, or by this call."""
    store = ShardStore.open(path)
    garbage = list(store.manifest.get("garbage", []))
    removed = 0
    for physical in garbage:
        removed += _unlink_column_files(path, physical, store.num_shards)
    if garbage:
        manifest = dict(store.manifest)
        _rotate_garbage(manifest, None)
        _publish_manifest(path, manifest)
    return removed


def _forward_devices(model: Model, num_workers: Optional[int],
                     devices: Optional[Sequence]) -> list:
    """The devices one chunk is split over (the JAX package's forward mesh,
    ``data_mesh(num_workers, devices)``): ``devices`` (torch devices or
    their names), or the first ``num_workers`` cards visible to this
    process for a model on the card (the model's device when one), or the
    model's one device."""
    if devices is not None:
        # a card that is not there raises, as every entry point does
        devs = [resolve_device(d) for d in devices]
    elif num_workers is None:
        devs = [model.device]
    elif model.device.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [model.device]
    if num_workers is not None:
        if num_workers > len(devs):
            raise ValueError(
                f"num_workers={num_workers} exceeds available devices "
                f"({len(devs)})")
        devs = devs[:num_workers]
    if not devs:
        raise ValueError("devices= is empty")
    return devs


class ModelPredictor(Predictor):
    """Append ``output_col`` with the model's raw outputs (logits).

    Parity: reference ``ModelPredictor(keras_model, features_col, output_col)``.
    ``chunk_size`` is the rows of one forward; rows are padded up then
    trimmed. ``devices`` (torch devices; or ``num_workers``, the first N
    cards) splits every chunk into equal contiguous parts, one a device,
    and joins the outputs in row order: the JAX package's forward over a
    ``data`` mesh, ``chunk_size`` rounded down to a multiple of the device
    count. By default the chunk runs whole on the model's device.
    """

    def __init__(
        self,
        model: Model,
        features_col: str = "features",
        output_col: str = "prediction",
        chunk_size: int = 1024,
        num_workers: Optional[int] = None,
        devices=None,
        normalize_uint8: Optional[bool] = None,
    ):
        self.model = model
        self.features_col = features_col
        self.output_col = output_col
        self.devices = _forward_devices(model, num_workers, devices)
        W = len(self.devices)
        # one module a device: the model's own where it lives, a copy
        # elsewhere (the JAX package replicates its params over the mesh)
        self._modules = [model.module if d == model.device
                         else copy.deepcopy(model.module).to(d)
                         for d in self.devices]
        #: uint8 /255 rule: default from the model (training and inference
        #: must agree on a store's normalization); the kwarg overrides.
        self.normalize_uint8 = (getattr(model, "normalize_uint8", True)
                                if normalize_uint8 is None
                                else bool(normalize_uint8))
        self.chunk_size = max(int(chunk_size) // W, 1) * W
        self._empty_block_cache: Optional[np.ndarray] = None

    def _forward(self, x: np.ndarray) -> np.ndarray:
        """The model's outputs for one chunk, in eval mode (no dropout), as
        host numpy: split into one contiguous part a device, every part
        launched before any is read back, joined in row order."""
        parts = (np.array_split(x, len(self.devices))
                 if len(self.devices) > 1 else [x])
        modes = [m.training for m in self._modules]
        for m in self._modules:
            m.eval()
        try:
            with torch.inference_mode():
                outs = [m(normalize_features(torch.as_tensor(p, device=d),
                                             self.normalize_uint8))
                        for m, d, p in zip(self._modules, self.devices,
                                           parts) if len(p)]
                return np.concatenate([o.cpu().numpy() for o in outs])
        finally:
            for m, mode in zip(self._modules, modes):
                m.train(mode)

    def _empty_block(self, feature_hint: Optional[np.ndarray] = None) -> np.ndarray:
        """Zero-row block with this predictor's exact output tail shape and
        dtype, so empty stream polls concatenate cleanly with real
        prediction blocks. Derived from one forward of a zero row shaped by
        the model's build-time ``sample_spec`` (or, without one, by a seen
        feature microbatch), then the subclass ``_postprocess``."""
        if self._empty_block_cache is None:
            spec = (self.model.sample_spec or (None,))[0]
            if spec is not None:
                tail, dtype = tuple(spec.shape[1:]), spec.dtype
            elif feature_hint is not None:
                hint = np.asarray(feature_hint)
                tail, dtype = hint.shape[1:], hint.dtype
            else:
                return np.empty((0,), np.float32)  # nothing to infer from yet
            out = self._forward(np.zeros((1,) + tuple(tail), dtype))
            self._empty_block_cache = self._postprocess(out[:0])
        return self._empty_block_cache

    def _postprocess(self, out: np.ndarray) -> np.ndarray:
        """Row-wise output transform hook (identity here; softmax/argmax in
        subclasses). Row-wise so batch and streaming paths agree exactly."""
        return out

    def _predict_array(self, x: np.ndarray) -> np.ndarray:
        """Model outputs for an arbitrary-length feature array, in
        fixed-shape padded chunks."""
        tele = telemetry.get()
        n = len(x)
        outs = []
        for start in range(0, n, self.chunk_size):
            chunk = x[start : start + self.chunk_size]
            pad = self.chunk_size - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
            # Per-chunk batch latency: staging, the forward and the copy
            # back (which waits for the card), so the span is the whole cost.
            with tele.span("predict.chunk"):
                out = self._forward(np.asarray(chunk))
            outs.append(out[: len(out) - pad] if pad else out)
        tele.counter("predict.rows").add(float(n))
        if n:
            tele.counter("predict.padded_rows").add(
                float(-n % self.chunk_size))
        return self._postprocess(np.concatenate(outs, axis=0))

    def predict(self, dataframe) -> "DataFrame":
        if getattr(dataframe, "is_sharded", False):
            return self._predict_sharded(dataframe)
        x = np.asarray(dataframe[self.features_col])
        return dataframe.with_column(self.output_col, self._predict_array(x))

    def predict_stream(self, source):
        """Yield ``predictions`` (one array per source microbatch, in order).

        ``source`` yields feature arrays shaped ``[n, ...]`` (n may vary per
        item; wrap single records as length-1 batches). Rows accumulate into
        ``chunk_size`` compute chunks across microbatch boundaries; only the
        final partial chunk is padded. This is the streaming-inference
        surface (:class:`StreamingPredictor`)."""
        sizes: deque[int] = deque()  # rows per emitted-pending microbatch
        pending: list[np.ndarray] = []  # rows awaiting a forward pass
        ready: list[np.ndarray] = []  # predicted rows, FIFO
        feat_hint: list = [None]  # last seen microbatch WITH feature dims

        def compute(flush: bool) -> None:
            x = np.concatenate(pending, axis=0) if pending else None
            if x is None or not len(x):
                return
            take = (len(x) // self.chunk_size) * self.chunk_size
            if flush:
                take = len(x)  # pad out the final partial chunk
            if take == 0:
                return
            ready.append(self._predict_array(x[:take]))
            pending.clear()
            if take < len(x):
                pending.append(x[take:])

        def drain():
            while sizes:
                need = sizes[0]
                if need == 0:
                    # Empty microbatch (e.g. an empty poll on a stream):
                    # emit an empty row block with the output tail shape.
                    sizes.popleft()
                    yield (ready[0][:0] if ready
                           else self._empty_block(feat_hint[0]))
                    continue
                if sum(len(r) for r in ready) < need:
                    return
                parts = []
                while need:
                    r = ready[0]
                    if len(r) <= need:
                        parts.append(ready.pop(0))
                        need -= len(parts[-1])
                    else:
                        parts.append(r[:need])
                        ready[0] = r[need:]
                        need = 0
                sizes.popleft()
                yield np.concatenate(parts, axis=0)

        for microbatch in source:
            mb = np.asarray(microbatch)
            sizes.append(len(mb))
            if mb.ndim > 1:
                # Even a zero-row block carries the feature tail: keep it as
                # the spec hint for empty output blocks on spec-less models.
                feat_hint[0] = mb
            if len(mb):  # an empty poll from a raw stream has no rows
                pending.append(mb)
            if sum(len(r) for r in pending) >= self.chunk_size:
                compute(flush=False)
            yield from drain()
        compute(flush=True)
        yield from drain()


    def _predict_sharded(self, sdf) -> ShardedDataFrame:
        """Out-of-core inference: predictions stream to disk as a new column
        of the same store (bounded RAM: a shard's rows plus one compute
        chunk); returns a ShardedDataFrame that includes it.

        Rows buffer across shard boundaries (``predict_stream``, one shard a
        microbatch), so only the final partial chunk is padded. The column
        is written under a fresh physical name when it exists already, and
        the manifest swaps atomically at the end: a crash mid-stream leaves
        the existing column intact. The superseded version goes on the
        manifest's ``garbage`` list (see :func:`vacuum`), and the previous
        publish's garbage is reclaimed here. In a process group of more
        than one rank, :meth:`_predict_sharded_multiprocess` runs instead."""
        if mesh.world_size() > 1:
            return self._predict_sharded_multiprocess(sdf)
        store = sdf.store
        if store.count() == 0:
            raise ValueError(f"store {store.path} has no rows to predict")
        prior_garbage = list(store.manifest.get("garbage", []))
        physical = self.output_col
        old_physical = None
        if self.output_col in store.columns:
            old = store.columns[self.output_col]
            old_physical = (old.get("file", self.output_col)
                            if isinstance(old, dict) else self.output_col)
            physical = f"{self.output_col}.{uuid.uuid4().hex[:8]}"
        meta: dict = {}
        source = (chunk[self.features_col]
                  for chunk in sdf.iter_column_chunks(self.features_col))
        for s, out in enumerate(
                _observe_shards(self.predict_stream(source))):
            meta.update(dtype=str(out.dtype), shape=list(out.shape[1:]))
            np.save(os.path.join(store.path, _shard_file(s, physical)), out)

        manifest = dict(store.manifest)
        manifest["columns"] = dict(manifest["columns"])
        colspec = {"dtype": meta["dtype"], "shape": meta["shape"]}
        if physical != self.output_col:
            colspec["file"] = physical
        manifest["columns"][self.output_col] = colspec
        _rotate_garbage(manifest, old_physical)
        _publish_manifest(store.path, manifest)
        for stale in prior_garbage:
            _unlink_column_files(store.path, stale, store.num_shards)
        return ShardedDataFrame(ShardStore.open(store.path),
                                num_partitions=sdf.num_partitions)


    def _shard_assignment(self, store, nproc: int, pid: int) -> list:
        """Which global shards this rank predicts, by residency.

        A host may hold only the shard files its own workers read
        (``data/shards.py``), so a contiguous split could ask a rank for
        shards it does not hold. Each rank reports which feature shards are
        on its disk, the bitmaps are all-gathered, and:

        * every rank holds everything (a shared filesystem): balanced
          contiguous ranges;
        * partial residency: shard ``s`` goes to its ``s % n_holders``-th
          holder (deterministic from the gathered bitmap);
        * a shard nobody holds: a contract error naming it.
        """
        S = store.num_shards
        fcol = store.columns.get(self.features_col, {})
        physical_feat = (fcol.get("file", self.features_col)
                         if isinstance(fcol, dict) else self.features_col)
        present = np.array(
            [os.path.exists(os.path.join(
                store.path, _shard_file(s, physical_feat)))
             for s in range(S)], dtype=np.int32)
        held = np.stack(collectives.all_gather_object(present))
        held = held.reshape(nproc, S)
        if held.all():  # shared filesystem: balanced contiguous split
            return list(range(pid * S // nproc, (pid + 1) * S // nproc))
        orphans = np.flatnonzero(held.sum(axis=0) == 0)
        if orphans.size:
            raise ValueError(
                f"sharded predict residency contract violated: feature "
                f"shards {orphans.tolist()} of column "
                f"{self.features_col!r} are present on NO process's disk. "
                "Multi-process predict runs where the data lives: every "
                "shard must be held by at least one process (or use a "
                "shared filesystem).")
        mine = []
        for s in range(S):
            holders = np.flatnonzero(held[:, s])
            if holders[s % len(holders)] == pid:
                mine.append(s)
        return mine

    def _predict_sharded_multiprocess(self, sdf) -> ShardedDataFrame:
        """Out-of-core inference across the ranks of a process group.

        Each rank takes the shards its own disk holds
        (:meth:`_shard_assignment`) and runs its own forward: no collective
        per chunk, so ranks with different chunk counts cannot deadlock.
        Output files keep the global shard ids (beside their features). The
        column spec is derived from one zero-row forward, so every rank,
        one that owned no shard included, computes the same manifest and
        publishes it after a barrier (its own tmp file, then a rename).
        Re-predicting a column writes a fresh versioned physical name,
        agreed across ranks (rank 0's draw, broadcast); the superseded one
        joins ``garbage``, and what the previous publish deferred is
        reclaimed after this publish's barrier, each rank cleaning what its
        disk holds."""
        store = sdf.store
        if store.count() == 0:
            raise ValueError(f"store {store.path} has no rows to predict")
        nproc, pid = mesh.world_size(), mesh.rank()
        my_shards = self._shard_assignment(store, nproc, pid)

        physical = self.output_col
        old_physical = None
        if self.output_col in store.columns:
            old = store.columns[self.output_col]
            old_physical = (old.get("file", self.output_col)
                            if isinstance(old, dict) else self.output_col)
            tag = collectives.broadcast_object(uuid.uuid4().hex[:8])
            physical = f"{self.output_col}.{tag}"

        prior_garbage = list(store.manifest.get("garbage", []))
        source = (store.read_shard(s, self.features_col) for s in my_shards)
        for s, out in zip(my_shards,
                          _observe_shards(self.predict_stream(source))):
            np.save(os.path.join(store.path, _shard_file(s, physical)), out)

        # The column spec, whatever shards this rank owned.
        fshape, fdtype = store.column_spec(self.features_col)
        empty = self._empty_block(np.zeros((0,) + fshape, fdtype))
        colspec: dict = {"dtype": str(empty.dtype),
                         "shape": list(empty.shape[1:])}
        if physical != self.output_col:
            colspec["file"] = physical
        collectives.barrier()
        manifest = dict(store.manifest)
        manifest["columns"] = dict(manifest["columns"])
        manifest["columns"][self.output_col] = colspec
        _rotate_garbage(manifest, old_physical)
        _publish_manifest(store.path, manifest, tag=f".p{pid}")
        collectives.barrier()
        for stale in prior_garbage:
            _unlink_column_files(store.path, stale, store.num_shards)
        return ShardedDataFrame(ShardStore.open(store.path),
                                num_partitions=sdf.num_partitions)


class ProbabilityPredictor(ModelPredictor):
    """Like ModelPredictor but appends softmax probabilities."""

    def _postprocess(self, out: np.ndarray) -> np.ndarray:
        return torch.softmax(torch.from_numpy(out), dim=-1).numpy()


class ClassPredictor(ModelPredictor):
    """Appends the argmax class index (the notebooks' common final step)."""

    def _postprocess(self, out: np.ndarray) -> np.ndarray:
        return out.argmax(axis=-1).astype(np.int32)


class StreamingPredictor(ModelPredictor):
    """Continuous inference over an unbounded record stream.

    Parity: the reference ships a Kafka streaming-inference example (a
    producer pushes feature records onto a topic, a consumer maps
    ``model.predict`` over microbatches and re-emits them with
    predictions). This takes any iterator of feature microbatches — a
    generator over a socket, a queue drained by a consumer thread, a file
    tail — and yields one prediction array per input microbatch, in order
    (``predict_stream``, on :class:`ModelPredictor`).

    Records accumulate into ``chunk_size`` rows before a forward pass runs;
    the final partial chunk is padded and flushed when the source ends.
    ``postprocess`` follows the subclass hook, so
    ``StreamingClassPredictor`` below emits class ids exactly like
    :class:`ClassPredictor` does for dataframes.
    """


class StreamingClassPredictor(StreamingPredictor, ClassPredictor):
    """Streaming inference emitting argmax class ids."""
