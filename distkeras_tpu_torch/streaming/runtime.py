"""StreamingTraining: the fleet-schedulable online-learning runtime (the
port's counterpart of ``distkeras_tpu/streaming/runtime.py``).

:class:`~distkeras_tpu_torch.fleet.run.ElasticTraining`'s claim-queue
loop, re-based on an **unbounded** work-item stream: records arrive from a
:mod:`~distkeras_tpu_torch.streaming.source` (through RoundFeeder staging,
so lookahead, stage retries and the stall watchdog all apply), elastic
workers claim/train/commit them against the job's netps PS, and every
ACKed fold is journaled to the durable
:class:`~distkeras_tpu_torch.streaming.journal.OffsetJournal` — SIGKILL
the process and the restart resumes at the last committed-to-PS offset
with zero replayed and zero lost records.

Around the train loop, the rest of the online loop:

* per-commit windowed eval through :class:`DriftWatch` — loss
  divergence pages (``AlertManager``, page severity), fires
  **checkpoint-on-drift**, and times recovery;
* periodic center checkpoints (every ``checkpoint_every`` committed
  items, env ``DKTPU_STREAM_CKPT_EVERY``) whose meta carries the newest
  committed event timestamp — the serving registry turns that into the
  event-to-served-weight **freshness** measurement at hot-swap;
* the fleet runtime protocol (``ensure_started``/``worker_main``/
  ``progress``/``done``/``revoke``/``close``), so a streaming trainer is
  just another tenant a :class:`FleetScheduler` can colocate, shrink,
  and preempt.

The window body is :func:`~distkeras_tpu_torch.netps.remote.local_window`
(``run_remote``'s and ``ElasticTraining``'s), on the model's device, with
``window`` the record's own K (ADAG divides the delta by it). The job's
in-process parameter server sits on the same device, so on the card every
streamed commit folds in one CUDA ``fold_commit`` launch, and a config #4
record's window runs the LSTM stash forward and BPTT kernels.

Departures from the JAX package, each forced by the port:

* **One loop per worker slot.** A local loop reparametrizes its module for
  the length of a call, so :meth:`StreamingTraining.ensure_started` builds
  one loop per ``worker_slots`` slot, each on its own copy of the module
  (the JAX package shares one jitted loop across its worker threads).
* **A synchronous checkpoint.** The port's ``Checkpointer.save`` is done
  when it returns (the JAX package passes ``wait=True`` to Orbax for the
  same effect: a SIGKILL right after a save still finds the step whole).
* **The window's dropout seed** is ``derive_seed(seed, worker, record)``,
  the port's counterpart of the JAX package's ``fold_in`` chain.

:class:`StreamingSession` wraps a runtime in the Supervisor-compatible
trainer surface (``train()``/``checkpoint_dir``/``checkpoint_every``/
``resume``) so ``Supervisor`` retry-with-resume drives crash recovery
exactly as it does for batch trainers.
"""

from __future__ import annotations

import collections
import copy
import os
import signal
import threading
import time
import warnings
from typing import Callable, Optional, Union

import numpy as np
import torch

from distkeras_tpu_torch import checkpoint as ckpt_mod
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.data.prefetch import RoundFeeder
from distkeras_tpu_torch.models.base import state_buffers
from distkeras_tpu_torch.netps.fold import check_discipline
from distkeras_tpu_torch.netps.remote import local_window
from distkeras_tpu_torch.netps.shards import make_ps_client
from distkeras_tpu_torch.ops.kernels import build
from distkeras_tpu_torch.resilience import faults as _faults
from distkeras_tpu_torch.resilience.errors import InjectedFault
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.runtime.device import resolve_device
from distkeras_tpu_torch.streaming.evaluate import DriftWatch
from distkeras_tpu_torch.streaming.items import WorkQueue
from distkeras_tpu_torch.streaming.journal import OffsetJournal
from distkeras_tpu_torch.workers import derive_seed, make_local_loop


class StreamingTraining:
    """One job's continual training off a live stream. See module
    docstring; constructor args mirror ElasticTraining's where shared.

    ``source`` is any object with ``read(start_index, skip)`` yielding
    :class:`StreamRecord`-shaped items and a ``close()``. ``journal``
    is an :class:`OffsetJournal`, a path, or None (no durability — tests
    only). ``max_items`` bounds the session (bench/tests): intake closes
    once that many records have been admitted *beyond* what the journal
    already holds committed. ``device`` (default: the first CUDA device;
    raises where there is none — pass ``device="cpu"`` for the CPU) is
    where the model, its local loops and the in-process server live; the
    model is moved there.
    """

    def __init__(self, *, model, tx, loss_fn, source,
                 num_workers: int = 1,
                 discipline: str = "adag", alpha: float = 0.05,
                 seed: int = 0, compute_dtype=None, grad_accum: int = 1,
                 endpoint: Optional[str] = None, server=None,
                 lease_s: Optional[float] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 timeout: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff: Optional[float] = None,
                 journal=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 drift_watch: Optional[DriftWatch] = None,
                 max_items: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 resume: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        model.module.to(self.device)
        model.device = self.device
        self.model = model
        self.tx = tx
        self.loss_fn = loss_fn
        self.source = source
        self.num_workers = int(num_workers)
        self.discipline = check_discipline(discipline)
        self.alpha = float(alpha)
        self.seed = int(seed)
        self.compute_dtype = compute_dtype
        self.grad_accum = int(grad_accum)
        self._endpoint = endpoint
        self._lease_s = lease_s
        self._host, self._port = host, int(port)
        self._client_kw = dict(timeout=timeout, retries=retries,
                               backoff=backoff)
        self.server = server
        if server is not None and endpoint is None:
            self._endpoint = server.endpoint
        self.journal = (OffsetJournal(journal) if isinstance(journal, str)
                        else journal)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(config.env_int("DKTPU_STREAM_CKPT_EVERY")
                                    if checkpoint_every is None
                                    else checkpoint_every)
        self.drift = drift_watch or DriftWatch()
        self.drift.on_drift = self._on_drift
        self.max_items = max_items
        self.queue = WorkQueue(max_pending=int(
            config.env_int("DKTPU_STREAM_MAX_PENDING")
            if max_pending is None else max_pending))
        self.resume = bool(resume)
        self.errors: list = []
        self.losses: list[float] = []
        self._lock = threading.Lock()
        self._applied = 0
        self._stale = collections.deque(maxlen=256)
        self._started = False
        self._closed = False
        self._loops: list = []
        self._names = list(model.params)
        self._init_leaves: Optional[list] = None
        self._init_bufs: dict = {}
        self._final_params = None
        self._reader_thread: Optional[threading.Thread] = None
        self._ckpt = None
        self._ckpt_lock = threading.Lock()
        self._ckpt_due = False
        self._last_ckpt_items = 0
        self.items_read = 0

    # -- runtime protocol ----------------------------------------------------

    def ensure_started(self) -> None:
        """Idempotent: resume state (journal + newest intact checkpoint),
        build one local loop per worker slot (and, on the card, every
        kernel before any worker joins), launch the PS if owned, reconcile
        surviving commit intents against the PS, start the reader."""
        if self._started:
            return
        if self.journal is not None and self.resume:
            if self.journal.load():
                # The drifted world survives the restart even though the
                # fault one-shot does not.
                drift_from = self.journal.meta.get("drift_from")
                if drift_from is not None and getattr(
                        self.source, "drift_from", None) is None:
                    self.source.drift_from = int(drift_from)
        if self.checkpoint_dir and self.resume:
            self._restore_params()
        if self.device.type == "cuda":
            build.build(build.all_sources())
        self._init_leaves = [
            v.detach().to("cpu", torch.float32).numpy().copy()
            for v in self.model.params.values()]
        self._init_bufs = state_buffers(self.model.module, self.model.state)
        self._loops = [make_local_loop(
            copy.deepcopy(self.model.module), self.loss_fn, self.tx,
            compute_dtype=self.compute_dtype,
            state_collections=self.model.state_collections,
            grad_accum=self.grad_accum,
            normalize_uint8=getattr(self.model, "normalize_uint8", True))
            for _ in range(self.worker_slots)]
        if self._endpoint is None:
            from distkeras_tpu_torch.netps.server import PSServer

            self.server = PSServer(
                discipline=self.discipline, host=self._host,
                port=self._port, lease_s=self._lease_s,
                device=self.device).start()
            self._endpoint = self.server.endpoint
        self._resolve_intents()
        self._reader_thread = threading.Thread(
            target=self._reader, name="stream-reader", daemon=True)
        self._reader_thread.start()
        self._started = True

    def _restore_params(self) -> None:
        """Warm-start the model from the newest INTACT checkpoint —
        ``Trainer._resume_from_checkpoint``'s newest-first corruption
        fallback, for the params-only streaming state."""
        steps = ckpt_mod.scan_steps(self.checkpoint_dir)
        if not steps:
            return
        cands = ckpt_mod.resume_candidates(
            steps, lambda s: ckpt_mod.read_meta(self.checkpoint_dir, s)
            is not None)
        ckpt = ckpt_mod.Checkpointer(self.checkpoint_dir)
        for step in cands:
            try:
                params = ckpt.restore(self.model.params, step=step,
                                      verify=True)
            except Exception as e:  # noqa: BLE001 - walk to older step
                warnings.warn(
                    f"streaming resume: checkpoint step {step} "
                    f"unusable ({type(e).__name__}: {e}); falling back",
                    stacklevel=2)
                continue
            self.model = self.model.with_params(params)
            with self._ckpt_lock:
                self._last_ckpt_items = (self.journal.items_committed
                                         if self.journal else 0)
            return

    def _resolve_intents(self) -> None:
        """Close the ACK gap: for every worker that crashed with a commit
        in flight, ask the PS (a scoped rejoin as that worker id) for its
        last folded seq and settle the intent — landed folds are marked
        committed (never re-read), unlanded ones are dropped (re-read and
        re-committed under a fresh seq). Must complete before the reader
        computes its start/skip set."""
        if self.journal is None:
            return
        with self.journal._lock:
            wids = list(self.journal._intents)
        if not wids:
            return
        last: dict = {}
        for wid in wids:
            try:
                client = make_ps_client(self._endpoint, worker_id=wid,
                                        **self._client_kw)
                try:
                    client.join(init=self._init_leaves)
                    last[wid] = int(getattr(client, "_seq", -1))
                finally:
                    client.close()
            except Exception as e:  # noqa: BLE001 - PS down: drop intents
                self.errors.append(e)
        landed = self.journal.resolve(last)
        if landed:
            telemetry.event("stream_intents_resolved",
                            {"landed": sorted(landed)})

    @property
    def endpoint(self) -> Optional[str]:
        return self._endpoint

    @property
    def worker_slots(self) -> int:
        """Highest worker id + 1 this runtime serves (one local loop
        each): the bound ``FleetScheduler.submit`` checks a job's
        ``max_workers`` against."""
        return self.num_workers

    def progress(self) -> int:
        return self._applied

    def done(self) -> bool:
        return self.queue.done()

    def revoke(self, worker_id: int) -> None:
        if self.server is not None:
            self.server.revoke(worker_id)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if getattr(self.source, "close", None) is not None:
            self.source.close()
        self.queue.close_intake()
        if self._reader_thread is not None:
            self._reader_thread.join(timeout=10.0)
        committed = (self.journal.items_committed if self.journal
                     else self.queue.committed)
        if self._endpoint is not None and committed > 0:
            try:
                with make_ps_client(self._endpoint,
                                    **self._client_kw) as obs:
                    leaves, _updates = obs.pull()
                self._final_params = self._to_params(leaves)
            except Exception as e:  # noqa: BLE001 - surfaced via errors
                self.errors.append(e)
        if self.server is not None:
            self.server.close()

    def result(self):
        if self._final_params is None:
            return self.model
        return self.model.with_params(self._final_params)

    # -- the reader ----------------------------------------------------------

    def _reader(self) -> None:
        """Source -> RoundFeeder staging -> claim queue. Runs the feeder's
        consumer loop, so the stall watchdog (and stage retry/injection)
        protect the stream path exactly as they do a BatchPlan's."""
        read_counter = telemetry.counter("stream.items_read")
        lag_gauge = telemetry.gauge("stream.offset_lag")
        start = self.journal.start_offset() if self.journal else 0
        skip = self.journal.skip_offsets() if self.journal else frozenset()
        budget = None
        if self.max_items is not None:
            done_already = (self.journal.items_committed if self.journal
                            else 0)
            budget = max(0, self.max_items - done_already)
        feeder = RoundFeeder(self.source.read(start, skip),
                             stage=lambda rec: rec, start_round=start)
        admitted = 0
        try:
            if budget == 0:
                return
            for _i, rec in feeder:
                self.items_read += 1
                read_counter.add(1)
                if not self.queue.put(rec, should_stop=lambda: self._closed):
                    return
                lag_gauge.set(self.queue.pending_count())
                admitted += 1
                if budget is not None and admitted >= budget:
                    return
        except BaseException as e:  # noqa: BLE001 - surfaced to the session
            self.errors.append(e)
        finally:
            feeder.close()
            self.queue.close_intake()
            if self.journal is not None and getattr(
                    self.source, "drift_from", None) is not None:
                # Persist the drifted-world marker for post-kill restarts.
                try:
                    self.journal.set_meta(drift_from=self.source.drift_from)
                except OSError:
                    pass

    # -- the worker loop -----------------------------------------------------

    def _to_params(self, leaves, device=None) -> dict:
        # np.require copies a read-only array: the mesh dialect's pull is
        # the server's host mirror itself.
        return {k: torch.as_tensor(np.require(a, np.float32, "W"),
                                   device=device or self.device)
                for k, a in zip(self._names, leaves)}

    def _on_drift(self, fast, slow) -> None:
        """Checkpoint-on-drift: flag an immediate save — the pre-adaptation
        snapshot is the rollback anchor (taken by the next committing
        worker, which holds a live client). The flag is set without the
        lock: blocking the commit path on an in-flight checkpoint save
        just to set a sticky bool would serialize drift detection behind
        the checkpoint's I/O."""
        self._ckpt_due = True  # dk: disable=DK202 - sticky flag, cleared under _ckpt_lock

    def _commit_done(self, rec, loss: float, staleness: int, client) -> None:
        suffix = telemetry.label_suffix()
        if self.journal is not None:
            self.journal.committed(client.worker_id, rec.index,
                                   event_ts=rec.ts)
            if getattr(self.source, "drift_from", None) is not None and \
                    "drift_from" not in self.journal.meta:
                self.journal.set_meta(drift_from=self.source.drift_from)
        self.queue.commit_one()
        with self._lock:
            self._applied += 1
            self.losses.append(loss)
            if staleness >= 0:
                self._stale.append(int(staleness))
            vals = list(self._stale)
        telemetry.counter(f"stream.items_committed{suffix}").add(1)
        telemetry.counter(f"fleet.commits{suffix}").add(1)
        if vals:
            telemetry.gauge(f"stream.staleness_mean{suffix}").set(
                round(float(np.mean(vals)), 3))
        self.drift.update(loss)
        self._maybe_checkpoint(client, force=self._ckpt_due)

    def _maybe_checkpoint(self, client, force: bool = False) -> None:
        if not self.checkpoint_dir:
            self._ckpt_due = False  # dk: disable=DK202 - no checkpointing: flag is inert
            return
        n = (self.journal.items_committed if self.journal
             else self.queue.committed)
        if not force and (self.checkpoint_every <= 0
                          or n < self._last_ckpt_items
                          + self.checkpoint_every):
            return
        with self._ckpt_lock:
            n = (self.journal.items_committed if self.journal
                 else self.queue.committed)
            if not force and n < self._last_ckpt_items + self.checkpoint_every:
                return
            self._ckpt_due = False
            if self._ckpt is None:
                self._ckpt = ckpt_mod.Checkpointer(self.checkpoint_dir,
                                                   max_to_keep=5)
            with telemetry.span("stream.checkpoint"):
                leaves, _ = client.pull()
                params = self._to_params(leaves, device="cpu")
                step = int(n)
                latest = self._ckpt.latest_step()
                if latest is not None and step <= latest:
                    step = latest + 1  # monotonicity across resumes
                event_ts = (self.journal.last_event_ts if self.journal
                            else None)
                meta = {"streaming": True, "items": int(n),
                        "event_ts": event_ts,
                        "drift": self.drift.detected_at is not None,
                        "saved_at": time.time()}
                if self.journal is not None:
                    meta["frontier"] = self.journal.frontier
                # Synchronous: the step is whole on disk when this
                # returns, so the next save never races this one and a
                # SIGKILL right after still finds a complete step.
                self._ckpt.save(step, params, meta=meta)
            self._last_ckpt_items = n
            telemetry.event("stream_checkpoint",
                            {"step": step, "items": int(n),
                             "event_ts": event_ts})

    def worker_main(self, worker_id: int, should_run) -> None:
        """One granted slot's loop: join -> (claim record; pull; K local
        steps; journal intent; commit; journal committed) until released
        or the stream drains — ElasticTraining's body with the claim
        queue open-ended and the offset journal in the commit path."""
        w = int(worker_id)
        suffix = telemetry.label_suffix()
        elastic = self.discipline in ("aeasgd", "eamsgd")
        tx = self.tx
        loop = self._loops[w]
        client = make_ps_client(self._endpoint, worker_id=w,
                                **self._client_kw)
        try:
            center, _counter = client.join(init=self._init_leaves)
            opt_state = tx.init(self._to_params(center))
            # The local replica persists across items (elastic
            # disciplines) and is re-adopted after a rejoin or eviction.
            local = self._to_params(center) if elastic else None
            mstate = {k: v.clone() for k, v in self._init_bufs.items()} \
                or None
            rejoins_seen = client.rejoin_count
            readopt = False
            while True:
                rec = self.queue.claim(should_run)
                if rec is None:
                    break
                committed = False
                try:
                    plan = _faults.active_plan()
                    if plan is not None:
                        if plan.kill(rec.index):
                            # The mid-stream host kill: unmaskable, no
                            # cleanup — what the offset journal exists for.
                            os.kill(os.getpid(), signal.SIGKILL)
                        if plan.crash(rec.index):
                            raise InjectedFault(
                                f"crash injected at stream item "
                                f"{rec.index} (DKTPU_FAULTS)")
                    with telemetry.span(f"stream.item{suffix}"):
                        net = _faults.active_net_plan()
                        if net is not None:
                            arg = net.fire("evict", rec.index)
                            if arg is not None:
                                lease = client.lease_s or 1.0
                                time.sleep(arg if arg > 0 else 2.0 * lease)
                        pulled_leaves, counter = client.pull()
                        pulled = self._to_params(pulled_leaves)
                        if client.rejoin_count > rejoins_seen or readopt:
                            rejoins_seen = client.rejoin_count
                            readopt = False
                            if elastic:
                                local = self._to_params(pulled_leaves)
                                opt_state = tx.init(local)
                        start = local if elastic else pulled
                        xs, ys = np.asarray(rec.xs), np.asarray(rec.ys)
                        host_delta, new_local, opt_state, mstate, \
                            window_losses = local_window(
                                loop, start, pulled, opt_state, xs, ys,
                                rng=derive_seed(self.seed, w, rec.index),
                                state=mstate, discipline=self.discipline,
                                alpha=self.alpha,
                                window=max(xs.shape[0], 1))
                        if elastic:
                            local = new_local
                        if self.journal is not None:
                            # Intent BEFORE the RPC: no fold outruns the
                            # journal's knowledge of it (see journal.py).
                            seq = int(getattr(client, "_seq", -1)) + 1
                            self.journal.intent(client.worker_id, seq,
                                                rec.index)
                        res = client.commit(host_delta, counter)
                        if res.evicted:
                            readopt = True
                        elif res.applied or res.duplicate:
                            committed = True
                            self._commit_done(
                                rec, float(window_losses.mean()),
                                res.staleness, client)
                finally:
                    if not committed:
                        self.queue.requeue(rec)
                        telemetry.counter(f"stream.requeued{suffix}").add(1)
            client.leave()
        except BaseException as e:  # noqa: BLE001 - surfaced to the reaper
            self.errors.append(e)
            raise
        finally:
            client.close()


class StreamingSession:
    """Supervisor-compatible wrapper: ``factory(resume) -> a fresh
    StreamingTraining`` per attempt (re-entry safe by construction, like
    ``Trainer.train``'s per-call engine rebuild). ``checkpoint_dir`` /
    ``checkpoint_every`` / ``resume`` mirror the Trainer attributes the
    Supervisor consults; a crash mid-stream retries with ``resume=True``
    and the rebuilt runtime restores the newest intact checkpoint AND
    re-enters the stream at the journal's committed frontier."""

    def __init__(self, factory: Callable[[bool], StreamingTraining],
                 num_workers: int = 1,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1):
        self.factory = factory
        self.num_workers = int(num_workers)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.resume = False
        self.runtime: Optional[StreamingTraining] = None

    def train(self, dataframe=None, shuffle: bool = False):
        """Run the stream to exhaustion (or ``max_items``); returns the
        trained model. ``dataframe``/``shuffle`` exist for Trainer-surface
        compatibility (the Supervisor passes them) and are ignored — the
        source IS the data."""
        rt = self.factory(self.resume)
        self.runtime = rt
        rt.ensure_started()
        abort = threading.Event()
        threads = [threading.Thread(
            target=self._drive, args=(rt, w, abort),
            name=f"stream-worker-{w}", daemon=True)
            for w in range(self.num_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        rt.close()
        if rt.errors:
            raise rt.errors[0]
        return rt.result()

    @staticmethod
    def _drive(rt: StreamingTraining, w: int, abort: threading.Event):
        try:
            rt.worker_main(w, lambda: not abort.is_set())
        except BaseException as e:  # noqa: BLE001 - recorded in rt.errors
            abort.set()
            if not isinstance(e, Exception):
                raise  # KeyboardInterrupt/SystemExit still propagate
