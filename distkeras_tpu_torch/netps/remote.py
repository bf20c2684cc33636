"""The remote worker loop: the reference's executor loop over the real wire
(the port's counterpart of the JAX package's ``netps/remote.py``).

Each logical worker is a host thread running ``pull -> K local steps ->
commit`` against a parameter server through the hardened
:class:`~distkeras_tpu_torch.netps.client.PSClient`: the same local window
the in-process engine runs (:func:`distkeras_tpu_torch.workers.
make_local_loop`, on the model's device, so on the card through the LSTM
kernels), the same worker-side discipline normalization, and the server's
fold. Commit order is whatever the network and the OS deliver — the
reference's architecture, end to end.

**Compute/communication overlap** (``DKTPU_NET_INFLIGHT``): with the
default of 1 the loop is serial — round *r*'s commit is ACKed before round
*r+1* begins. Raising it double-buffers the loop: round *r*'s commit (and
the next round's pull prefetch) run on two comms lanes per worker while
round *r+1*'s K local steps execute, with at most ``DKTPU_NET_INFLIGHT``
commits un-ACKed at any time. The commit lane is ONE ordered thread, so
commits still leave in seq order and the exactly-once dedup is untouched;
the pull lane has a client of its own that adopts the first one's dialect.
The lanes never touch the card: the commit lane takes the delta as host
numpy (its int8 error-feedback residual stays in that lane's order) and a
prefetched pull reaches the card on the worker thread, so a lane never
waits on the device's queue. The price is staleness: a prefetched pull
cannot contain the still-in-flight commits, so the server's counter rule
charges the realized delay (DynSGD's ``1/(staleness+1)`` and the
``netps.commit.staleness`` histogram see it). The overlap's effect is the
``netps.overlap.hidden_fraction`` gauge (1 − the comms wait the compute
threads saw / the comms lanes' busy time), exported when the window is
above 1.

Each worker trains its own copy of the module, because
``torch.func.functional_call`` swaps a module's parameters for the length
of a call and threads must not share that.

Elastic membership in the loop: a worker that went silent past its lease
(or whose commit was fenced by a promoted standby) finds itself evicted at
its next RPC; the client re-joins, the worker discards its stale window
(in-flight commits queued before the rejoin included: the lineage rule of
the ordered lane answers them ``evicted`` without sending them),
re-adopts the freshly pulled center (the reference's rejoining-worker
semantics), and training continues.

**Transports** (``DKTPU_NET_TRANSPORT`` or ``transport=``): every client
of the run asks for the same dialect. Against a server of this process a
``mesh`` worker hands its commits to the server's in-process dispatch, and
against one on this host a ``shm`` worker rides the shared-memory ring;
with ``DKTPU_NET_INFLIGHT>1`` the commit lane and the pull-prefetch client
each attach a ring (or a dispatch) of their own. A pulled center may be the
server's own read-only host mirror (the mesh dialect hands it over as is),
so the worker copies what it keeps.

Striping (``DKTPU_NET_SHARDS``) and sharded endpoints (ROADMAP Queue 1
item 4c), the per-host aggregator (``DKTPU_NET_HIER``, item 4d), the
self-tuning data plane (``DKTPU_NET_AUTOTUNE``, item 4e), the fault plan
(``DKTPU_NET_FAULTS``, item 6) and tracing (``DKTPU_TRACE``, item 10) come
with later slices: set, they raise here rather than train on the flat
loop.
"""

from __future__ import annotations

import collections
import copy
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.data.batching import BatchPlan, apply_round_transform
from distkeras_tpu_torch.netps import shm
from distkeras_tpu_torch.netps.client import CommitResult, PSClient
from distkeras_tpu_torch.netps.fold import check_discipline
from distkeras_tpu_torch.ops.kernels import build
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.workers import derive_seed, make_local_loop


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to distkeras_tpu_torch yet (ROADMAP Queue 1 "
        f"item {item}); the remote worker loop runs over TCP, the shm ring "
        f"or the mesh dispatch against one parameter server or a "
        f"primary/standby endpoint list")


def _refuse_unported(endpoint: str) -> None:
    """Raise for every data-plane option the reference's remote loop reads
    that the port does not serve."""
    shards = config.env_int("DKTPU_NET_SHARDS")
    if shards > 1:
        raise _not_ported(f"DKTPU_NET_SHARDS={shards} (striping)", "4c")
    if config.env_bool("DKTPU_NET_HIER"):
        raise _not_ported("DKTPU_NET_HIER (the per-host aggregator)", "4d")
    if config.env_bool("DKTPU_NET_AUTOTUNE"):
        raise _not_ported("DKTPU_NET_AUTOTUNE (the self-tuning data plane)",
                          "4e")
    if ";" in endpoint:
        raise _not_ported(f"the sharded endpoint {endpoint!r} (remote= or "
                          f"DKTPU_PS_ENDPOINT)", "4c")
    faults = config.env_str("DKTPU_NET_FAULTS")
    if faults:
        raise _not_ported(f"DKTPU_NET_FAULTS={faults!r} (the fault plan's "
                          f"poison_worker and chaos kinds)", "6")
    if config.env_bool("DKTPU_TRACE"):
        raise _not_ported("DKTPU_TRACE (tracing's child_scope spans)", "10")


class _CommsMeter:
    """Run-wide comms accounting shared by the worker threads: the comms
    lanes' RPC busy time against the wait the compute threads actually
    saw, plus the realized staleness of applied commits — the overlap
    evidence."""

    def __init__(self):
        self.lock = threading.Lock()
        self.busy = 0.0
        self.wait = 0.0
        self.stale = collections.deque(maxlen=256)

    def timed(self, fn, *args):
        """Run one RPC, charging its duration to ``busy`` (on a lane)."""
        t0 = time.monotonic()
        try:
            return fn(*args)
        finally:
            with self.lock:
                self.busy += time.monotonic() - t0

    def blocking(self, fn, *args):
        """An RPC the compute thread itself waits through (round 0's pull,
        the serial loop): busy AND wait — nothing of it was hidden."""
        t0 = time.monotonic()
        try:
            return self.timed(fn, *args)
        finally:
            self.waited(time.monotonic() - t0)

    def waited(self, seconds: float) -> None:
        with self.lock:
            self.wait += seconds

    def commit_staleness(self, staleness: int) -> None:
        telemetry.histogram("netps.commit.staleness").observe(
            float(staleness))
        with self.lock:
            self.stale.append(int(staleness))
            vals = list(self.stale)
        # The gauges the in-process engines export, fed the REALIZED
        # staleness the server charged (in-flight delay included).
        telemetry.gauge("discipline.staleness_mean").set(
            float(np.mean(vals)))
        telemetry.gauge("discipline.staleness_max").set(float(max(vals)))

    def hidden_fraction(self) -> float:
        with self.lock:
            busy, wait = self.busy, self.wait
        return max(0.0, min(1.0, 1.0 - wait / busy)) if busy > 0 else 0.0

    def export(self) -> None:
        with self.lock:
            busy = self.busy
        if busy > 0:
            telemetry.gauge("netps.overlap.hidden_fraction").set(
                round(self.hidden_fraction(), 4))


def _worker_round(plan: BatchPlan, r: int, w: int):
    """Worker ``w``'s ``[K, B, ...]`` slice of round ``r`` (each thread
    gathers only its own rows — the per-executor partition)."""
    idx = plan.index[r, w]
    xs, ys = plan.x[idx], plan.y[idx]
    if plan.transform is not None:
        xs4, ys4 = apply_round_transform(
            plan.transform, plan.transform_seed, r, [w], xs[None], ys[None])
        xs, ys = xs4[0], ys4[0]
    return xs, ys


def run_remote(
    *,
    endpoint: str,
    model,
    tx,
    loss_fn,
    plan: BatchPlan,
    discipline: str = "adag",
    window: int,
    alpha: float = 0.05,
    seed: int = 0,
    compute_dtype=None,
    grad_accum: int = 1,
    inflight: Optional[int] = None,
    compress: Optional[str] = None,
    transport: Optional[str] = None,
    loop_fn=None,
) -> tuple[dict, np.ndarray]:
    """Train ``plan.num_workers`` threads against the server at
    ``endpoint``.

    Returns ``(params, losses[rounds, W])``: ``params`` is the server's
    final center as a :attr:`Model.params`-shaped dict of tensors on the
    model's device. A round whose commit was discarded (eviction) still
    carries that worker's local loss; NaN marks rounds a worker never ran.
    The first joiner seeds an uninitialized server with this model's
    parameters. Round ``r`` of worker ``w`` draws its dropout seeds from
    ``derive_seed(seed, w, r)``.

    ``compress`` and ``transport`` go to every :class:`PSClient` of the
    run and ``inflight`` sets the loop's window; each defaults from the
    registry (``DKTPU_NET_COMPRESS``/``TRANSPORT``/``INFLIGHT``), and each
    client reads its deadline, retries and backoff there
    (``DKTPU_NET_TIMEOUT``/``RETRIES``/``BACKOFF``). ``loop_fn`` is a prebuilt local loop (what
    :func:`~distkeras_tpu_torch.workers.make_local_loop` returns) for a
    run of one worker: a loop reparametrizes its module for the length of a
    call, which two worker threads must not share.
    """
    check_discipline(discipline)
    _refuse_unported(endpoint)
    inflight = max(1, int(inflight if inflight is not None
                          else config.env_int("DKTPU_NET_INFLIGHT")))
    transport = transport if transport is not None else shm.transport_mode()
    if transport not in shm.TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; "
                         f"known: {list(shm.TRANSPORTS)}")
    client_kw = dict(compress=compress, transport=transport)
    W = plan.num_workers
    dev = model.device
    if dev.type == "cuda":
        # Every kernel built before any worker joins: a first-use build
        # inside a worker's first window can outlast its lease, and the
        # evicted worker's window is (rightly) discarded.
        build.build(build.all_sources())
    elastic = discipline in ("aeasgd", "eamsgd")
    names = list(model.params)
    init_leaves = [v.detach().to("cpu", torch.float32).numpy().copy()
                   for v in model.params.values()]
    if loop_fn is None:
        # One module per worker: functional_call reparametrizes its module
        # for the length of a call, which concurrent threads must not share.
        loops = [make_local_loop(
            copy.deepcopy(model.module), loss_fn, tx,
            compute_dtype=compute_dtype,
            state_collections=model.state_collections, grad_accum=grad_accum,
            normalize_uint8=getattr(model, "normalize_uint8", True))
            for _ in range(W)]
    elif W == 1:
        loops = [loop_fn]
    else:
        raise ValueError(f"loop_fn serves one worker, not {W}: worker "
                         f"threads must not share a loop's module")
    losses = np.full((plan.num_rounds, W), np.nan, np.float32)
    errors: list = []
    meter = _CommsMeter()

    def to_params(leaves) -> dict:
        # np.require copies a read-only array: the mesh dialect's pull is
        # the server's host mirror itself, which a CPU tensor made by
        # as_tensor would alias and a worker might write into.
        return {k: torch.as_tensor(np.require(a, np.float32, "W"),
                                   device=dev)
                for k, a in zip(names, leaves)}

    def work(w: int) -> None:
        client = PSClient(endpoint, worker_id=w, **client_kw)
        pull_client = commit_lane = pull_lane = None
        if inflight > 1:
            # Two comms lanes per worker: an ORDERED commit lane (seq order
            # is the exactly-once contract) and a pull-prefetch lane on its
            # own client, so a slow commit cannot serialize the next
            # round's pull behind it.
            commit_lane = ThreadPoolExecutor(
                1, thread_name_prefix=f"netps-commit-{w}")
            pull_lane = ThreadPoolExecutor(
                1, thread_name_prefix=f"netps-pull-{w}")
        try:
            center, _counter = meter.blocking(client.join, init_leaves)
            if pull_lane is not None:
                pull_client = PSClient(endpoint, worker_id=client.worker_id,
                                       **client_kw)
                pull_client.adopt_dialect(client, center)
            opt_state = tx.init(to_params(center))
            local = to_params(center) if elastic else None
            readopt = False
            rejoins_seen = 0
            pending: collections.deque = collections.deque()
            next_pull = None

            def rejoins() -> int:
                n = client.rejoin_count
                if pull_client is not None:
                    n += pull_client.rejoin_count
                return n

            def guarded_commit(delta, counter, lineage):
                # The ordered lane's lineage rule: a commit queued BEFORE a
                # rejoin (its delta came from the pre-eviction pull) is
                # discarded, never folded into the fresh center. The lane
                # is ordered, so any rejoin an earlier commit caused is
                # already counted when this runs.
                if rejoins() != lineage:
                    return CommitResult(applied=False, duplicate=False,
                                        evicted=True, updates=-1,
                                        staleness=-1)
                return client.commit(delta, counter)

            def settle(res) -> None:
                nonlocal readopt
                if res.evicted:
                    # Evicted (or fenced) with this commit in flight: it
                    # was discarded and the client re-joined. Start over
                    # from the fresh center at the next pull.
                    readopt = True
                elif res.applied:
                    meter.commit_staleness(res.staleness)

            def drain_one() -> None:
                fut = pending.popleft()
                t0 = time.monotonic()
                res = fut.result()
                meter.waited(time.monotonic() - t0)
                settle(res)

            for r in range(plan.num_rounds):
                if next_pull is not None:
                    t0 = time.monotonic()
                    pulled_leaves, counter = next_pull.result()
                    meter.waited(time.monotonic() - t0)
                    next_pull = None
                else:
                    pulled_leaves, counter = meter.blocking(client.pull)
                pulled = to_params(pulled_leaves)
                if rejoins() > rejoins_seen or readopt:
                    # Evicted while away: the rejoining worker re-adopts
                    # the center (fresh replica + optimizer — the
                    # reference's PS-pull join semantics).
                    rejoins_seen = rejoins()
                    readopt = False
                    if elastic:
                        local = to_params(pulled_leaves)
                        opt_state = tx.init(local)
                start = local if elastic else pulled
                xs, ys = _worker_round(plan, r, w)
                with telemetry.span("netps.remote.local_window"):
                    new, opt_state, _state, window_losses = loops[w](
                        start, opt_state, torch.as_tensor(xs).to(dev),
                        torch.as_tensor(ys).to(dev),
                        rng=derive_seed(seed, w, r))
                    if elastic:
                        delta = {k: alpha * (new[k] - pulled[k])
                                 for k in names}
                        local = {k: new[k] - delta[k] for k in names}
                    else:
                        delta = {k: new[k] - pulled[k] for k in names}
                        if discipline == "adag":
                            delta = {k: d / float(window)
                                     for k, d in delta.items()}
                    host_delta = [delta[k].cpu().numpy() for k in names]
                    losses[r, w] = float(window_losses.mean())
                if commit_lane is None:
                    settle(meter.blocking(client.commit, host_delta,
                                          counter))
                    continue
                while len(pending) >= inflight:
                    drain_one()
                pending.append(commit_lane.submit(
                    meter.timed, guarded_commit, host_delta, counter,
                    rejoins()))
                if r + 1 < plan.num_rounds:
                    next_pull = pull_lane.submit(meter.timed,
                                                 pull_client.pull)
            while pending:
                drain_one()
            client.leave()
        except BaseException as e:  # noqa: BLE001 - surfaced on the caller
            errors.append(e)
        finally:
            for lane in (commit_lane, pull_lane):
                if lane is not None:
                    lane.shutdown(wait=True)
            if pull_client is not None:
                pull_client.close()
            client.close()

    with telemetry.span("netps.remote_train"):
        threads = [threading.Thread(target=work, args=(w,),
                                    name=f"netps-worker-{w}")
                   for w in range(W)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if inflight > 1:
        # The gauge is OVERLAP evidence; the serial loop hides nothing by
        # construction.
        meter.export()
    if errors:
        raise errors[0]
    with PSClient(endpoint, **client_kw) as observer:
        final_leaves, _updates = observer.pull()
    return to_params(final_leaves), losses
