""":class:`ShardedPSClient` — one logical PS client over N shard servers
(the port's copy of the JAX package's ``netps/shards/client.py``; the
frames are the same, so it dials either package's shard servers).

Each shard is an ordinary :class:`~distkeras_tpu_torch.netps.server.
PSServer` holding its :class:`~distkeras_tpu_torch.netps.shards.plan.
PartitionPlan` slice of the center, so every layer underneath —
compression, striping, the shm ring, endpoint failover, per-shard warm
standby — composes unchanged: this client is a fan-out of N full
:class:`~distkeras_tpu_torch.netps.client.PSClient` instances (one per
shard, each with its own comma-separated failover list), nothing more.

The contracts the fan-out adds:

* **One logical seq per commit.** The outer client assigns the seq and
  every shard folds under it (per-shard ``(worker_id, seq)`` dedup as
  always). A commit is ACKed (``applied``) only when EVERY shard folded.
* **Partial-fold reconciliation.** A shard that evicted us mid-commit is
  re-joined (same worker_id, same plan) and the SAME seq retransmitted:
  shards that already folded dedup it, the evicted shard folds it once.
  The port's :class:`PSClient` always re-joins after an eviction or a
  fence (it has no ``auto_rejoin`` switch), so this client always makes
  that one retransmit. If a shard still cannot fold, the outer result is
  ``evicted``: the worker loop discards the window, the lost-window
  semantics a single-PS eviction has — some shards carry the window, some
  do not, which asynchronous disciplines tolerate by construction and
  dedup guarantees is never a double fold.
* **Plan validation everywhere.** The join carries the plan hash (typed
  :class:`~distkeras_tpu_torch.netps.errors.ShardPlanError` on a mismatch,
  on a plan-unaware peer and on a non-shard server), and every pull
  cross-checks the hash the shard echoed: assembly from two different
  plans is impossible, never silent.

Per-shard counters: the server's update counter is per shard, so ``pull``
returns a TUPLE of counters (opaque to the worker loop, which hands it
back to ``commit``) and staleness is charged per shard from its own
counter — DynSGD's scaling sees each shard's true local staleness.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.netps.client import CommitResult, PSClient
from distkeras_tpu_torch.netps.errors import ShardPlanError
from distkeras_tpu_torch.netps.shards.plan import (PartitionPlan,
                                                   plan_for_model)


def is_sharded_endpoint(endpoint: str) -> bool:
    """Whether ``endpoint`` is a shard x failover matrix (``;`` present)
    rather than a single failover list."""
    return ";" in endpoint


def make_ps_client(endpoint: str, plan: Optional[PartitionPlan] = None,
                   **kw):
    """The ONE client factory: a :class:`ShardedPSClient` for a shard
    matrix endpoint, a plain :class:`PSClient` otherwise, so callers
    (``run_remote``, the trainers) stay endpoint-shape agnostic. ``plan``
    is ignored for plain endpoints."""
    if is_sharded_endpoint(endpoint):
        return ShardedPSClient(endpoint, plan=plan, **kw)
    return PSClient(endpoint, **kw)


class ShardedPSClient:
    """One worker's client to an N-shard center. Constructor knobs mirror
    :class:`PSClient` and are applied to every per-shard sub-client."""

    def __init__(self, endpoint: str, worker_id: Optional[int] = None,
                 plan: Optional[PartitionPlan] = None,
                 timeout: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff: Optional[float] = None,
                 shards: Optional[int] = None,
                 compress: Optional[str] = None,
                 transport: Optional[str] = None):
        self.endpoint = endpoint
        #: one failover-list string per shard, ";"-split matrix order.
        self.groups = wire.split_shard_endpoints(endpoint)
        self.plan = plan
        if plan is not None and plan.num_shards != len(self.groups):
            raise ShardPlanError(
                f"plan has {plan.num_shards} shards but the endpoint "
                f"matrix has {len(self.groups)}")
        self.worker_id = worker_id
        self._subs = [PSClient(g, worker_id=worker_id, timeout=timeout,
                               retries=retries, backoff=backoff,
                               shards=shards, compress=compress,
                               transport=transport)
                      for g in self.groups]
        self._pool = ThreadPoolExecutor(
            max_workers=len(self._subs), thread_name_prefix="netps-shard")
        self._lock = threading.Lock()
        self._seq = -1
        self._closed = False

    # -- lifecycle -----------------------------------------------------
    @property
    def num_shards(self) -> int:
        return len(self._subs)

    @property
    def rejoin_count(self) -> int:
        """Total sub-client rejoins — the worker loop's re-adopt trigger,
        the same contract as :attr:`PSClient.rejoin_count`."""
        return sum(s.rejoin_count for s in self._subs)

    @property
    def lease_s(self) -> Optional[float]:
        leases = [s.lease_s for s in self._subs if s.lease_s]
        return min(leases) if leases else None

    @property
    def epoch(self):
        return self._subs[0].epoch

    def close(self) -> None:
        self._closed = True
        for s in self._subs:
            s.close()
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "ShardedPSClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- fan-out plumbing ----------------------------------------------
    def _fan(self, fns) -> list:
        """Run one callable per shard concurrently; wait for ALL, then
        re-raise the first failure (everything drained: no sub-client is
        left with an in-flight reply)."""
        futures = [self._pool.submit(fn) for fn in fns]
        results, errors = [], []
        for f in futures:
            try:
                results.append(f.result())
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
        if errors:
            raise errors[0]
        return results

    def _extra(self, k: int) -> dict:
        """The sharded join header shard ``k``'s sub-client rides on every
        (re)join: our index claim + the plan identity. ``"adopt"`` asks a
        plan-bearing server to hand its plan over (the observer path)."""
        if self.plan is None:
            return {"shard_index": k, "plan_hash": "adopt"}
        return {"shard_index": k, "plan_hash": self.plan.plan_hash,
                "shard_plan": self.plan.to_dict()}

    def _check_reply_caps(self, k: int, sub: PSClient) -> dict:
        info = (sub.peer_caps or {}).get("sharding")
        if not isinstance(info, dict):
            raise ShardPlanError(
                f"endpoint {self.groups[k]!r} is not a shard server "
                f"(no sharding advertisement in its join reply)")
        if int(info.get("index", -1)) != k:
            raise ShardPlanError(
                f"endpoint {self.groups[k]!r} serves shard "
                f"{info.get('index')}, expected {k}: the endpoint matrix "
                f"and the deployment disagree")
        if self.plan is not None and info.get("plan_hash") != \
                self.plan.plan_hash:
            raise ShardPlanError(
                f"shard {k} plan hash {str(info.get('plan_hash'))[:12]}... "
                f"!= ours {self.plan.plan_hash[:12]}...")
        return info

    def _adopt_plan(self, info: dict) -> None:
        plan = PartitionPlan.from_dict(info.get("plan") or {})
        if plan.num_shards != len(self.groups):
            raise ShardPlanError(
                f"adopted plan has {plan.num_shards} shards but the "
                f"endpoint matrix has {len(self.groups)}")
        self.plan = plan

    def _export_plan_telemetry(self) -> None:
        telemetry.gauge("netps.shard.count").set(float(self.plan.num_shards))
        telemetry.gauge("netps.shard.skew").set(round(self.plan.skew(), 4))

    # -- RPC surface ---------------------------------------------------
    def join(self, init: Optional[Sequence[np.ndarray]] = None,
             ) -> tuple[list, tuple]:
        """Become a member of every shard; returns ``(center, counters)``
        with ``counters`` one per-shard update counter (opaque — hand it
        back to :meth:`commit`). ``init`` seeds uninitialized shards with
        their plan slices; with no plan configured one is built from
        ``init`` (env rules/cap), or adopted from shard 0 when ``init``
        is absent (the observer path)."""
        if self.plan is None and init is not None:
            self.plan = plan_for_model(list(init), len(self.groups))
        # Shard 0 joins first: it assigns the worker_id the other shards
        # must share, and is the plan donor when we carry none.
        sub0 = self._subs[0]
        sub0._join_extra = self._extra(0)
        init0 = (self.plan.shard_slice(list(init), 0)
                 if init is not None else None)
        center0, counter0 = sub0.join(init=init0)
        info0 = self._check_reply_caps(0, sub0)
        if self.plan is None:
            self._adopt_plan(info0)
            self._check_reply_caps(0, sub0)  # now hash-checked too
        self.worker_id = sub0.worker_id

        def join_one(k: int):
            sub = self._subs[k]
            sub.worker_id = self.worker_id
            sub._join_extra = self._extra(k)
            slice_k = (self.plan.shard_slice(list(init), k)
                       if init is not None else None)
            center_k, counter_k = sub.join(init=slice_k)
            self._check_reply_caps(k, sub)
            return center_k, counter_k

        rest = self._fan([lambda k=k: join_one(k)
                          for k in range(1, len(self._subs))])
        per_shard = [center0] + [c for c, _ in rest]
        counters = (counter0,) + tuple(c for _, c in rest)
        # Resume the logical seq past every shard's high-water mark: after
        # a partial commit and a worker restart the shards disagree, and
        # the max is the only seq no shard has folded past.
        with self._lock:
            self._seq = max([self._seq] + [s._seq for s in self._subs])
        self._export_plan_telemetry()
        return self.plan.assemble(per_shard), counters

    def _fetch_plan(self) -> None:
        """Observer bootstrap: pull shard 0's plan advertisement without
        joining (membership-free, like the anonymous observer pull)."""
        hdr, _ = self._subs[0]._rpc(wire.OP_PULL, {"want_plan": True})
        info = hdr.get("sharding")
        if not isinstance(info, dict):
            raise ShardPlanError(
                f"endpoint {self.groups[0]!r} is not a shard server (no "
                f"plan advertisement on pull)")
        self._adopt_plan(info)
        self._export_plan_telemetry()

    def pull(self) -> tuple[list, tuple]:
        """Assembled center + per-shard counters; renews every lease. Each
        shard's slice is internally fold-consistent (the striped-pull torn
        read check runs per shard); cross-shard versions may differ by
        in-flight folds — inherent to an asynchronous sharded center and
        exactly what per-shard staleness accounting charges."""
        if self.plan is None:
            self._fetch_plan()

        def pull_one(k: int):
            sub = self._subs[k]
            out = sub.pull()
            got = sub.peer_plan_hash
            if got is not None and got != self.plan.plan_hash:
                raise ShardPlanError(
                    f"shard {k} now serves plan {str(got)[:12]}..., ours "
                    f"is {self.plan.plan_hash[:12]}...: re-plan required")
            return out

        results = self._fan([lambda k=k: pull_one(k)
                             for k in range(len(self._subs))])
        counters = tuple(int(c) for _, c in results)
        return self.plan.assemble([c for c, _ in results]), counters

    def commit(self, delta: Sequence[np.ndarray], pulled_counter,
               ) -> CommitResult:
        """Fold ``delta`` into every shard under ONE logical seq.
        ``pulled_counter`` is the tuple :meth:`pull`/:meth:`join` returned
        (an int is broadcast). ACKed (``applied``) only when every shard
        folded; a shard that evicted us gets one same-seq retransmit after
        its re-join, and an unreconciled shard surfaces the whole commit as
        ``evicted`` (discard the window, pull fresh)."""
        if self.plan is None:
            raise ShardPlanError("commit before join: no plan")
        with self._lock:
            self._seq += 1
            seq = self._seq
        if isinstance(pulled_counter, (tuple, list)):
            pulled = [int(c) for c in pulled_counter]
            if len(pulled) != len(self._subs):
                raise ShardPlanError(
                    f"{len(pulled)} pull counters for {len(self._subs)} "
                    f"shards")
        else:
            pulled = [int(pulled_counter)] * len(self._subs)
        slices = self.plan.scatter(list(delta))

        def commit_one(k: int) -> CommitResult:
            sub = self._subs[k]
            res = sub.commit(slices[k], pulled[k], seq=seq)
            if res.evicted:
                # The sub-client already re-joined (same worker_id, same
                # plan via its join extra); retransmitting the SAME seq is
                # exactly-once safe — this shard folds it once, any shard
                # that already folded it dedups.
                res = sub.commit(slices[k], pulled[k], seq=seq)
            if res.applied:
                telemetry.counter(f"netps.shard.folds.{k}").add(1)
                telemetry.counter(f"netps.shard.bytes.{k}").add(
                    int(sum(np.asarray(a).nbytes for a in slices[k])))
            return res

        results = self._fan([lambda k=k: commit_one(k)
                             for k in range(len(self._subs))])
        if any(r.evicted for r in results):
            telemetry.counter("netps.shard.partial_commits").add(1)
            return CommitResult(applied=False, duplicate=False,
                                evicted=True, updates=-1, staleness=-1)
        return CommitResult(
            applied=all(r.applied or r.duplicate for r in results)
            and any(r.applied for r in results),
            duplicate=all(r.duplicate for r in results),
            evicted=False,
            updates=max(r.updates for r in results),
            staleness=max(r.staleness for r in results))

    def heartbeat(self) -> int:
        """Renew every shard's lease; returns the max update counter."""
        results = self._fan([s.heartbeat for s in self._subs])
        return max(int(u) for u in results)

    def leave(self) -> None:
        for s in self._subs:
            s.leave()

    def adopt_dialect(self, other: "ShardedPSClient",
                      template: Sequence[np.ndarray]) -> None:
        """Adopt another sharded client's negotiated state (plan, member
        identity, every sub-client's codec/striping/transport) without a
        join — the overlap loop's pull-prefetch lane."""
        self.plan = other.plan
        self.worker_id = other.worker_id
        with self._lock:
            self._seq = other._seq
        for k, (mine, theirs) in enumerate(zip(self._subs, other._subs)):
            mine.worker_id = other.worker_id
            mine._join_extra = dict(theirs._join_extra)
            mine.adopt_dialect(
                theirs, self.plan.shard_slice(list(template), k))
