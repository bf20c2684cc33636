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

**Striping** (``DKTPU_NET_SHARDS`` or ``shards=``): every client of the
run splits each pull and commit by tensors over that many connections to
the server, one seq a commit, folded once. **Sharded endpoints** (``;``
between shards, ``,`` between each shard's failover endpoints, through
``remote=`` or ``DKTPU_PS_ENDPOINT``): the run builds THE
:class:`~distkeras_tpu_torch.netps.shards.plan.PartitionPlan` once, from
the model's parameter names (``model.params`` keys, which
``DKTPU_PS_SHARD_RULES`` matches) and shapes and the optimizer-state
factor measured from the optimizer's own state, emits the
``netps_shard_plan`` event, and every worker dials the shards through a
:class:`~distkeras_tpu_torch.netps.shards.client.ShardedPSClient`
(:func:`~distkeras_tpu_torch.netps.shards.client.make_ps_client` picks the
client from the endpoint's shape).

**Chaos**: ``evict@R:S`` in ``DKTPU_NET_FAULTS`` silences the seeded
worker (``FaultPlan.poison_worker(R, W)``) for S seconds (twice the lease
when S is 0) before round R, so its lease lapses, the server evicts it and
its next RPC re-joins.

**Hierarchical folds** (``DKTPU_NET_HIER`` or ``hier=``): a per-host
:class:`~distkeras_tpu_torch.netps.hier.AggregatorServer` on the model's
device is interposed, seeded with the model's parameters, on the run's
transport; the worker threads join IT through its plain endpoint, it
pre-combines their commits (one fold-kernel launch a commit) and forwards
one combined commit a flush (``hier_flush`` seconds at most) to the root at
``endpoint``, which may be a ``;`` shard matrix. It is closed after the
workers, so every absorbed commit reaches the root before the final center
is pulled from the root.

**Self-tuning** (``DKTPU_NET_AUTOTUNE`` or ``autotune=``): a
:class:`~distkeras_tpu_torch.netps.tuner.controller.Tuner` closes the loop
from the live gauges to the knobs. Knobs the caller or the environment
pinned are its starting point; an unpinned window starts at 2, an unpinned
transport asks for the top of the ladder (``mesh``) and an unpinned stripe
count on TCP opens 2 connections, so the controller can widen into them.
An unpinned ``hier`` is chosen by the fan-in crossover. Worker 0 runs the
join-time codec probes (on TCP) or applies the ring's rule (f32, one
stripe) and evaluates the control loop at round boundaries; every worker
drains its ordered commit lane before it adopts a retuned dialect, so one
commit finishes under one codec and striping. With the tuner aboard both
comms lanes always exist. Autotune against a ``;`` shard matrix that the
workers would dial directly is refused before any worker starts: the
sharded client has no probe or retune (nor has the JAX package's, whose
run fails there).

Tracing (``DKTPU_TRACE``, ROADMAP Queue 1 item 10) comes with a later
slice: set, it raises here rather than train without it.
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
from distkeras_tpu_torch.netps import shm, wire
from distkeras_tpu_torch.netps.client import CommitResult
from distkeras_tpu_torch.netps.fold import check_discipline
from distkeras_tpu_torch.netps.shards import (is_sharded_endpoint,
                                              make_ps_client,
                                              plan_for_model)
from distkeras_tpu_torch.netps.tuner import (Tuner, TunerState,
                                             autotune_enabled)
from distkeras_tpu_torch.ops.kernels import build
from distkeras_tpu_torch.resilience import faults as _faults
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.workers import derive_seed, make_local_loop


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to distkeras_tpu_torch yet (ROADMAP Queue 1 "
        f"item {item}); the remote worker loop runs over TCP, the shm ring "
        f"or the mesh dispatch, striped or not, against one parameter "
        f"server, a primary/standby endpoint list or a sharded center, "
        f"flat or through a per-host aggregator, tuned by hand or by "
        f"DKTPU_NET_AUTOTUNE")


def _refuse_unported() -> None:
    """Raise for every data-plane option the reference's remote loop reads
    that the port does not serve."""
    if config.env_bool("DKTPU_TRACE"):
        raise _not_ported("DKTPU_TRACE (tracing's child_scope spans)", "10")


def _state_nbytes(state) -> int:
    """Bytes of an optimizer state as optax would hold it: every tensor's
    bytes, and 4 for each integer step count (optax's ``count`` is an
    int32 scalar; the port keeps a Python int)."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, bool) or state is None:
        return 0
    if isinstance(state, int):
        return 4
    if isinstance(state, dict):
        return sum(_state_nbytes(v) for v in state.values())
    if isinstance(state, (tuple, list)):
        return sum(_state_nbytes(v) for v in state)
    return 0


def _measured_opt_factor(tx, params: dict) -> float:
    """Optimizer-state bytes per parameter byte, measured from the
    optimizer's actual state (adagrad's accumulators 1.0, adam's moments
    2.0 and its step count): what makes the shard plan budget center AND
    optimizer memory. The JAX package's measure of optax's state, exactly
    (``netps/remote.py _measured_opt_factor``)."""
    center = sum(v.numel() * 4 for v in params.values())
    if center <= 0:
        return 0.0
    return float(_state_nbytes(tx.init(params))) / float(center)


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
    shards: Optional[int] = None,
    compress: Optional[str] = None,
    transport: Optional[str] = None,
    hier: Optional[bool] = None,
    hier_flush: Optional[float] = None,
    autotune: Optional[bool] = None,
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

    ``shards`` (stripes), ``compress`` and ``transport`` go to every
    client of the run and ``inflight`` sets the loop's window; each
    defaults from the registry (``DKTPU_NET_SHARDS``/``COMPRESS``/
    ``TRANSPORT``/``INFLIGHT``), and each client reads its deadline,
    retries and backoff there (``DKTPU_NET_TIMEOUT``/``RETRIES``/
    ``BACKOFF``). A ``;`` shard matrix ``endpoint`` trains against a
    sharded center under one plan built here. ``hier`` (default
    ``DKTPU_NET_HIER``) interposes the per-host aggregator, which flushes
    at most ``hier_flush`` seconds after a window opens (default: the
    aggregator's). ``autotune`` (default ``DKTPU_NET_AUTOTUNE``) puts the
    self-tuning controller aboard (see the module docstring); what it
    converged to is the run's ``tuner_run_summary`` event. ``loop_fn`` is
    a prebuilt local loop (what
    :func:`~distkeras_tpu_torch.workers.make_local_loop` returns) for a
    run of one worker: a loop reparametrizes its module for the length of a
    call, which two worker threads must not share.
    """
    check_discipline(discipline)
    _refuse_unported()
    W = plan.num_workers
    explicit_inflight = (inflight is not None
                         or config.env_is_set("DKTPU_NET_INFLIGHT"))
    inflight = max(1, int(inflight if inflight is not None
                          else config.env_int("DKTPU_NET_INFLIGHT")))
    autotune = autotune_enabled() if autotune is None else bool(autotune)
    tuner = None
    if autotune:
        # Explicit knobs win where set; the controller fills the rest. An
        # unpinned window starts at 2 (the overlap must exist before
        # hidden_fraction can be measured); an unpinned transport asks for
        # the top of the ladder, which the join negotiates down.
        tuner = Tuner(W, inflight=inflight if explicit_inflight
                      else max(inflight, 2))
        inflight = tuner.inflight
        if transport is None and not config.env_is_set(
                "DKTPU_NET_TRANSPORT"):
            transport = "mesh"
        if (shards is None and not config.env_is_set("DKTPU_NET_SHARDS")
                and transport not in ("shm", "mesh")):
            # Striping headroom on TCP: connections are made at
            # construction, so a client that may be retuned up to 2
            # stripes needs 2 now (the active stripes still start at what
            # the join negotiates). An unpinned transport read from the
            # environment counts as TCP here, as in the JAX package.
            shards = 2
    transport = transport if transport is not None else shm.transport_mode()
    if transport not in shm.TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; "
                         f"known: {list(shm.TRANSPORTS)}")
    client_kw = dict(shards=shards, compress=compress, transport=transport)
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
    shard_plan = None
    if is_sharded_endpoint(endpoint):
        # The sharded center: THE partition plan, built once here from the
        # parameter names and shapes and the measured optimizer factor;
        # every client carries it and every shard checks its hash at join.
        shard_plan = plan_for_model(
            init_leaves, len(wire.split_shard_endpoints(endpoint)),
            names=names, opt_factor=_measured_opt_factor(tx, model.params))
        telemetry.event("netps_shard_plan", {
            "shards": shard_plan.num_shards,
            "hash": shard_plan.plan_hash[:12],
            "skew": round(shard_plan.skew(), 4)})
        client_kw["plan"] = shard_plan
    hier = config.env_bool("DKTPU_NET_HIER") if hier is None else bool(hier)
    if (tuner is not None and not hier
            and not config.env_is_set("DKTPU_NET_HIER")):
        # Nobody pinned the topology: the fan-in crossover picks it.
        hier = tuner.choose_topology() == "hier"
    if tuner is not None and not hier and shard_plan is not None:
        raise ValueError(
            "DKTPU_NET_AUTOTUNE against a sharded endpoint (a ';' shard "
            "matrix the workers dial directly) is not supported: the "
            "sharded client has no probe or retune; pin the data-plane "
            "knobs by hand, or put a per-host aggregator in front "
            "(DKTPU_NET_HIER=1)")
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
        # The hier path hands workers the aggregator's plain endpoint (the
        # aggregator's own upstream client is the sharded one).
        client = make_ps_client(worker_endpoint, worker_id=w, **client_kw)
        pull_client = commit_lane = pull_lane = None
        if inflight > 1 or tuner is not None:
            # Two comms lanes per worker: an ORDERED commit lane (seq order
            # is the exactly-once contract) and a pull-prefetch lane on its
            # own client, so a slow commit cannot serialize the next
            # round's pull behind it. With the tuner aboard they always
            # exist: it may widen a serial start mid-run.
            commit_lane = ThreadPoolExecutor(
                1, thread_name_prefix=f"netps-commit-{w}")
            pull_lane = ThreadPoolExecutor(
                1, thread_name_prefix=f"netps-pull-{w}")
        try:
            center, _counter = meter.blocking(client.join, init_leaves)
            if tuner is not None and w == 0:
                # The join-time micro A/B: one worker probes, the winner
                # reaches everyone through the target generation.
                tuner.startup(client, center)
            tstate = TunerState()
            if pull_lane is not None:
                pull_client = make_ps_client(
                    worker_endpoint, worker_id=client.worker_id,
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
                net = _faults.active_net_plan()
                if net is not None and net.poison_worker(r, W) == w:
                    arg = net.fire("evict", r)
                    if arg is not None:
                        # Go silent past the lease: the server evicts us;
                        # the next RPC re-joins and we continue.
                        lease = client.lease_s or 1.0
                        time.sleep(arg if arg > 0 else 2.0 * lease)
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
                if tuner is not None:
                    if w == 0:
                        # The overlap gauge live, so the control loop reads
                        # this run's evidence.
                        meter.export()
                        tuner.maybe_decide(r, client.active_transport)
                    if tuner.generation != tstate.generation:
                        # Quiesce the ordered lane first: one logical
                        # commit finishes under ONE codec and striping (a
                        # retransmit keeps its seq either way).
                        while pending:
                            drain_one()
                        changed = tuner.apply_to(client, pulled_leaves,
                                                 tstate)
                        if changed and pull_client is not None:
                            pull_client.adopt_dialect(client, pulled_leaves)
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
                # The tuner retargets the window mid-run; a narrowed one
                # drains deeper before the next submit.
                bound = tuner.inflight if tuner is not None else inflight
                while len(pending) >= max(1, bound):
                    drain_one()
                pending.append(commit_lane.submit(
                    meter.timed, guarded_commit, host_delta, counter,
                    rejoins()))
                if r + 1 < plan.num_rounds:
                    next_pull = pull_lane.submit(meter.timed,
                                                 pull_client.pull)
            while pending:
                drain_one()
            if tuner is not None and w == 0:
                # The converged dialect and the decision counts, as the
                # ``tuner_run_summary`` event.
                tuner.export_summary(client)
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

    agg = None
    worker_endpoint = endpoint
    if hier:
        from distkeras_tpu_torch.netps.hier import AggregatorServer

        # The aggregator seeds the root with this model's parameters and
        # serves the local workers, on the run's transport and device.
        agg_kw = {} if hier_flush is None else {"flush_interval": hier_flush}
        agg = AggregatorServer(upstream=endpoint, init=init_leaves,
                               discipline=discipline, transport=transport,
                               device=dev, plan=shard_plan,
                               **agg_kw).start()
        worker_endpoint = agg.endpoint
        if tuner is not None:
            tuner.attach_aggregator(agg)
    try:
        with telemetry.span("netps.remote_train"):
            threads = [threading.Thread(target=work, args=(w,),
                                        name=f"netps-worker-{w}")
                       for w in range(W)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
    finally:
        if agg is not None:
            # Flushes the open window upstream before the final pull below
            # reads the root's center.
            agg.close()
    if inflight > 1 or tuner is not None:
        # The gauge is OVERLAP evidence; the serial loop hides nothing by
        # construction.
        meter.export()
    if errors:
        raise errors[0]
    with make_ps_client(endpoint, plan=shard_plan,
                        transport=transport) as observer:
        final_leaves, _updates = observer.pull()
    return to_params(final_leaves), losses
