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

This is the serial loop (``DKTPU_NET_INFLIGHT=1``, the default): round
*r*'s commit is ACKed before round *r+1* begins. Each worker trains its own
copy of the module, because ``torch.func.functional_call`` swaps a
module's parameters for the length of a call and threads must not share
that.

Elastic membership in the loop: a worker that went silent past its lease
finds itself evicted at its next RPC; the client re-joins, the worker
discards its stale window, re-adopts the freshly pulled center (the
reference's rejoining-worker semantics), and training continues.

Compute/comms overlap (``DKTPU_NET_INFLIGHT>1``), the per-host
aggregator (``DKTPU_NET_HIER``), the self-tuning data plane
(``DKTPU_NET_AUTOTUNE``), the shm and mesh transports
(``DKTPU_NET_TRANSPORT``), striping (``DKTPU_NET_SHARDS``) and sharded
endpoints come with later slices: set, they raise here rather than train
on the flat TCP loop.
"""

from __future__ import annotations

import copy
import threading

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.data.batching import BatchPlan, apply_round_transform
from distkeras_tpu_torch.netps.client import PSClient
from distkeras_tpu_torch.netps.fold import check_discipline
from distkeras_tpu_torch.ops.kernels import build
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.workers import derive_seed, make_local_loop


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to distkeras_tpu_torch yet; the remote "
        f"worker loop runs serially (DKTPU_NET_INFLIGHT=1) against one "
        f"parameter server")


def _refuse_unported(endpoint: str) -> None:
    """Raise for every data-plane option the reference's remote loop reads
    that the port does not serve."""
    inflight = config.env_int("DKTPU_NET_INFLIGHT")
    if inflight > 1:
        raise _not_ported(f"DKTPU_NET_INFLIGHT={inflight} (compute/comms "
                          f"overlap)")
    shards = config.env_int("DKTPU_NET_SHARDS")
    if shards > 1:
        raise _not_ported(f"DKTPU_NET_SHARDS={shards} (striping)")
    if config.env_bool("DKTPU_NET_HIER"):
        raise _not_ported("DKTPU_NET_HIER (the per-host aggregator)")
    if config.env_bool("DKTPU_NET_AUTOTUNE"):
        raise _not_ported("DKTPU_NET_AUTOTUNE (the self-tuning data plane)")
    transport = config.env_str("DKTPU_NET_TRANSPORT")
    if transport != "tcp":
        raise _not_ported(f"DKTPU_NET_TRANSPORT={transport!r} (the shm and "
                          f"mesh transports)")
    if ";" in endpoint:
        raise _not_ported(f"the sharded endpoint {endpoint!r} (remote= or "
                          f"DKTPU_PS_ENDPOINT)")


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

    Each :class:`PSClient` reads its deadline, retries, backoff and codec
    from the registry (``DKTPU_NET_TIMEOUT``/``RETRIES``/``BACKOFF``/
    ``COMPRESS``).
    """
    check_discipline(discipline)
    _refuse_unported(endpoint)
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
    # One module per worker: functional_call reparametrizes its module for
    # the length of a call, which concurrent threads must not share.
    loops = [make_local_loop(
        copy.deepcopy(model.module), loss_fn, tx, compute_dtype=compute_dtype,
        state_collections=model.state_collections, grad_accum=grad_accum,
        normalize_uint8=getattr(model, "normalize_uint8", True))
        for _ in range(W)]
    losses = np.full((plan.num_rounds, W), np.nan, np.float32)
    errors: list = []

    def to_params(leaves) -> dict:
        return {k: torch.as_tensor(a, dtype=torch.float32, device=dev)
                for k, a in zip(names, leaves)}

    def work(w: int) -> None:
        client = PSClient(endpoint, worker_id=w)
        try:
            center, _counter = client.join(init=init_leaves)
            opt_state = tx.init(to_params(center))
            local = to_params(center) if elastic else None
            readopt = False
            rejoins_seen = 0
            for r in range(plan.num_rounds):
                pulled_leaves, counter = client.pull()
                pulled = to_params(pulled_leaves)
                if client.rejoin_count > rejoins_seen or readopt:
                    # Evicted while away: the rejoining worker re-adopts
                    # the center (fresh replica + optimizer — the
                    # reference's PS-pull join semantics).
                    rejoins_seen = client.rejoin_count
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
                res = client.commit(host_delta, counter)
                if res.evicted:
                    readopt = True
                elif res.applied:
                    telemetry.histogram("netps.commit.staleness").observe(
                        float(res.staleness))
            client.leave()
        except BaseException as e:  # noqa: BLE001 - surfaced on the caller
            errors.append(e)
        finally:
            client.close()

    with telemetry.span("netps.remote_train"):
        threads = [threading.Thread(target=work, args=(w,),
                                    name=f"netps-worker-{w}")
                   for w in range(W)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    with PSClient(endpoint) as observer:
        final_leaves, _updates = observer.pull()
    return to_params(final_leaves), losses
