"""Elastic training runtime: one fleet job's workers over its own netps PS
(the port's counterpart of the JAX package's ``fleet/run.py``).

:class:`ElasticTraining` adapts the port's training pieces (a built
:class:`~distkeras_tpu_torch.models.base.Model`, an optimizer, a loss, a
:class:`~distkeras_tpu_torch.data.batching.BatchPlan`) to the scheduler's
runtime protocol (:mod:`distkeras_tpu_torch.fleet.job`). Where
:func:`~distkeras_tpu_torch.netps.remote.run_remote` runs a *fixed* W
threads for exactly ``plan.num_rounds`` rounds, this runtime must survive
the scheduler changing its worker count mid-run, so the schedule is a
**claim queue** of ``num_rounds x num_workers`` work items — one
``(round, data slice)`` pair per planned worker-window, claimed in
round-major order. The WORK SET is therefore exactly the plan's (every
slice of every round trains once, whatever the worker count did mid-run),
and it is deterministic: the window computed for item ``(r, s)`` depends
only on the plan and the seed (its rows are ``plan.index[r, s]``, its
dropout seed ``derive_seed(seed, s, r)``, as ``run_remote``'s worker ``s``
draws in round ``r``), never on which slot claimed it; only the fold
*order* varies, as it does for any async PS. An item whose commit was lost
to preemption/eviction (the discarded-window path) is returned to the
queue for whichever worker claims it next. The job is done when every item
has been *committed*.

The body of a window is ``run_remote``'s serial path: the same local loop
(:func:`~distkeras_tpu_torch.workers.make_local_loop`, on the model's
device, so on the card through the LSTM kernels) and the same window
function (:func:`~distkeras_tpu_torch.netps.remote.local_window`: the
worker-side discipline normalization on the device, the commit sent as
host numpy).
With one slot, one claimant takes the items in round-major order, which is
``run_remote``'s one-worker run: the two give the same center, bit for bit.

**One loop per worker slot.** A local loop reparametrizes its module for
the length of a call, so two threads must not share one (the JAX package
shares one jitted loop across its workers). :meth:`ensure_started` builds
one loop per ``worker_slots`` slot, each on its own copy of the module,
and a worker thread uses its slot's. The scheduler reuses a slot id only
after that slot's old thread has been joined (``FleetScheduler._reap``
deletes a granted worker only once its thread is dead; ``_expand`` and a
restart spawn onto an id that is not granted), so no two live threads ever
hold one slot's loop.

The parameter server is per-job: in-process by default, seated on the
model's device (on the card its folds are the CUDA ``fold_commit`` kernel),
or an external ``endpoint=``. Progress lives on the PS, so a
fully-preempted job resumes exactly where it stopped when the scheduler
re-grants its gang.
"""

from __future__ import annotations

import collections
import copy
import threading
import time
from typing import Optional, Union

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.data.batching import BatchPlan
from distkeras_tpu_torch.models.base import state_buffers
from distkeras_tpu_torch.netps.fold import check_discipline
from distkeras_tpu_torch.netps.remote import _worker_round, local_window
from distkeras_tpu_torch.netps.shards import make_ps_client
from distkeras_tpu_torch.ops.kernels import build
from distkeras_tpu_torch.resilience import faults as _faults
from distkeras_tpu_torch.runtime.device import resolve_device
from distkeras_tpu_torch.streaming.items import WorkQueue
from distkeras_tpu_torch.workers import derive_seed, make_local_loop


class ElasticTraining:
    """One job's training work, elastically workered. See module docstring.

    ``plan`` is laid out for ``plan.num_workers`` = the job's
    ``max_workers`` (slice ``s`` is always ``plan.index[r, s]``, however
    many peers are active). ``endpoint=None`` launches an in-process
    :class:`~distkeras_tpu_torch.netps.server.PSServer` on
    :meth:`ensure_started`. ``device`` (default: the first CUDA device;
    raises where there is none — pass ``device="cpu"`` for the CPU) is
    where the model, its local loops and the in-process server live; the
    model is moved there."""

    def __init__(self, *, model, tx, loss_fn, plan: BatchPlan,
                 discipline: str = "adag", alpha: float = 0.05,
                 seed: int = 0, compute_dtype=None, grad_accum: int = 1,
                 endpoint: Optional[str] = None,
                 server=None,
                 lease_s: Optional[float] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 timeout: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff: Optional[float] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        model.module.to(self.device)
        model.device = self.device
        self.model = model
        self.tx = tx
        self.loss_fn = loss_fn
        self.plan = plan
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
        #: the in-process PS (None when endpoint= is external). A caller-
        #: built ``server=`` is adopted — revocation lands on it even when
        #: the data path runs through something else (a chaos proxy) — and
        #: closed by :meth:`close` like an owned one.
        self.server = server
        if server is not None and endpoint is None:
            self._endpoint = server.endpoint
        #: one loss cell per planned worker-window, like run_remote's.
        self.losses = np.full((plan.num_rounds, plan.num_workers), np.nan,
                              np.float32)
        self.errors: list = []
        self._lock = threading.Lock()
        #: work items are (round, slice) pairs flattened round-major:
        #: item i = (i // W, i % W) — the plan's full schedule, as a
        #: bounded WorkQueue.
        self._total_items = plan.num_rounds * plan.num_workers
        self._queue = WorkQueue(total=self._total_items)
        self._applied = 0
        self._stale = collections.deque(maxlen=256)
        self._started = False
        self._closed = False
        self._loops: list = []
        self._names = list(model.params)
        self._init_leaves: Optional[list] = None
        self._init_bufs: dict = {}
        self._final_params = None

    # -- runtime protocol --------------------------------------------------
    def ensure_started(self) -> None:
        """Idempotent: build one local loop per worker slot (and, on the
        card, every kernel, before any worker joins: a first-use build in
        a worker's first window can outlast its lease) and (first call
        only) launch the in-process PS. A re-placement after a full
        preemption lands here again and finds everything warm."""
        if self._started:
            return
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
        self._started = True

    @property
    def endpoint(self) -> Optional[str]:
        return self._endpoint

    @property
    def worker_slots(self) -> int:
        """Highest worker id + 1 this runtime's data layout supports
        (``plan.index[r, w]`` is laid out for exactly this many workers).
        The scheduler validates a job's ``max_workers`` against it at
        submit."""
        return self.plan.num_workers

    def progress(self) -> int:
        """Cumulative applied commits (the ``preempt@R`` clock)."""
        return self._applied

    def done(self) -> bool:
        return self._queue.done()

    def revoke(self, worker_id: int) -> None:
        """Lease revocation — the preemption primitive. In-process
        servers revoke directly; against an external PS the released
        worker simply goes silent and the server's own lease monitor
        evicts it (same observable churn, one lease later)."""
        if self.server is not None:
            self.server.revoke(worker_id)

    def close(self) -> None:
        """Finalize: pull the final center, then drain and close the
        in-process PS. Idempotent; safe on a never-started or failed
        job."""
        if self._closed:
            return
        self._closed = True
        if self._endpoint is not None and self._queue.committed > 0:
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
        """The trained model (final center) after :meth:`close`; the
        as-built model when nothing was ever committed."""
        if self._final_params is None:
            return self.model
        return self.model.with_params(self._final_params)

    # -- the worker loop ---------------------------------------------------
    def _to_params(self, leaves) -> dict:
        # np.require copies a read-only array: the mesh dialect's pull is
        # the server's host mirror itself.
        return {k: torch.as_tensor(np.require(a, np.float32, "W"),
                                   device=self.device)
                for k, a in zip(self._names, leaves)}

    def _claim(self, should_run) -> Optional[int]:
        """The next work item: the retry queue first, then the frontier
        (:class:`WorkQueue` in bounded mode). Blocks (politely) while
        other workers' claims are still in flight — exiting early would
        strand a requeued item."""
        return self._queue.claim(should_run)

    def _requeue(self, item: int) -> None:
        self._queue.requeue(item)

    def _commit_done(self, r: int, s: int, loss: float,
                     staleness: int) -> None:
        suffix = telemetry.label_suffix()
        self._queue.commit_one()
        with self._lock:
            self._applied += 1
            self.losses[r, s] = loss
            if staleness >= 0:
                self._stale.append(int(staleness))
            vals = list(self._stale)
        telemetry.counter(f"fleet.commits{suffix}").add(1)
        if vals:
            telemetry.gauge(f"fleet.staleness_mean{suffix}").set(
                round(float(np.mean(vals)), 3))
            telemetry.gauge(f"fleet.staleness_max{suffix}").set(
                float(max(vals)))

    def worker_main(self, worker_id: int, should_run) -> None:
        """One granted slot's loop: join -> (claim an item; pull; K local
        steps; commit) until released or every item committed. The body is
        ``run_remote``'s serial path re-based on the claim queue;
        eviction/rejoin/readopt semantics are identical."""
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
            local = self._to_params(center) if elastic else None
            # Each slot threads its own model state (BatchNorm running
            # statistics), never synced, as run_remote's workers do.
            mstate = {k: v.clone() for k, v in self._init_bufs.items()} \
                or None
            rejoins_seen = client.rejoin_count
            readopt = False
            while True:
                item = self._claim(should_run)
                if item is None:
                    break
                r, s = divmod(item, self.plan.num_workers)
                committed = False
                try:
                    with telemetry.span(f"fleet.round{suffix}"):
                        net = _faults.active_net_plan()
                        if net is not None and s == 0:
                            # Under the claim queue, round R's slice-0
                            # item belongs to exactly one worker — so
                            # `evict@R` silences WHOEVER claimed it.
                            arg = net.fire("evict", r)
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
                        # The DATA slice and the seed come from the
                        # claimed item (s), not the claiming slot (w).
                        xs, ys = _worker_round(self.plan, r, s)
                        host_delta, new_local, opt_state, mstate, \
                            window_losses = local_window(
                                loop, start, pulled, opt_state, xs, ys,
                                rng=derive_seed(self.seed, s, r),
                                state=mstate, discipline=self.discipline,
                                alpha=self.alpha, window=self.plan.window)
                        if elastic:
                            local = new_local
                        res = client.commit(host_delta, counter)
                        if res.evicted:
                            # Preempted or lease-lapsed with this window in
                            # flight: the commit was discarded; the client
                            # already rejoined. Requeue the item and start
                            # over from a fresh pull.
                            readopt = True
                        elif res.applied or res.duplicate:
                            committed = True
                            self._commit_done(
                                r, s, float(window_losses.mean()),
                                res.staleness)
                finally:
                    if not committed:
                        self._requeue(item)
            client.leave()
        except BaseException as e:  # noqa: BLE001 - surfaced to the reaper
            self.errors.append(e)
            raise
        finally:
            client.close()
