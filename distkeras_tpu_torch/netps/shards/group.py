""":class:`ShardSet` — an in-process gang of shard servers (the port's copy
of the JAX package's ``netps/shards/group.py``).

A deployment launches one process per shard (``python -m
distkeras_tpu_torch.netps --shard k/N``). Tests and ``chip_smoke.py`` want
the same topology without process management, so this helper starts N
:class:`~distkeras_tpu_torch.netps.server.PSServer` instances in one
process, each configured with its :class:`~distkeras_tpu_torch.netps.
shards.plan.PartitionPlan` slice identity, and exposes the ``;``-joined
endpoint matrix a :class:`~distkeras_tpu_torch.netps.shards.client.
ShardedPSClient` dials. Each server seats its slice on its own ``device``
(the card unless the caller names the CPU) and folds every commit into it
with one ``fold_commit`` launch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from distkeras_tpu_torch.netps.server import PSServer
from distkeras_tpu_torch.netps.shards.plan import (PartitionPlan,
                                                   plan_for_model)


class ShardSet:
    """N shard servers sharing one partition plan. Either pass a ``plan``
    (servers start empty, the first join seeds each slice) or a ``center``
    (a plan is built for it and every shard is pre-seeded). Extra kwargs
    flow to every :class:`PSServer` (discipline, lease_s, snapshot_every,
    transport, device...); ``state_dir`` becomes per-shard
    ``<dir>/shard-<k>`` so each shard keeps its own journal and snapshot
    lineage."""

    def __init__(self, num_shards: int,
                 plan: Optional[PartitionPlan] = None,
                 center: Optional[Sequence[np.ndarray]] = None,
                 state_dir: Optional[str] = None, **kw):
        if plan is None and center is not None:
            plan = plan_for_model(list(center), num_shards)
        if plan is not None and plan.num_shards != num_shards:
            raise ValueError(f"plan has {plan.num_shards} shards, "
                             f"asked for {num_shards}")
        self.plan = plan
        self.servers: list[PSServer] = []
        try:
            for k in range(num_shards):
                seed = (plan.shard_slice(list(center), k)
                        if center is not None and plan is not None
                        else None)
                sdir = f"{state_dir}/shard-{k}" if state_dir else None
                self.servers.append(PSServer(
                    center=seed, shard_index=k, shard_count=num_shards,
                    shard_plan=plan, state_dir=sdir, **kw))
        except BaseException:
            self.close()
            raise

    @property
    def num_shards(self) -> int:
        return len(self.servers)

    @property
    def endpoint(self) -> str:
        """The shard x failover matrix (no standbys here: one entry per
        shard); dial it with ``ShardedPSClient``/``make_ps_client``."""
        return ";".join(s.endpoint for s in self.servers)

    def start(self) -> "ShardSet":
        for s in self.servers:
            s.start()
        return self

    def drain(self) -> None:
        for s in self.servers:
            s.drain()

    def close(self) -> None:
        for s in self.servers:
            s.close()

    def revoke(self, worker_id: int) -> bool:
        """Evict a worker from EVERY shard. True if any shard held the
        membership."""
        return any([s.revoke(worker_id) for s in self.servers])

    def center(self) -> list:
        """The assembled logical center, as host numpy arrays."""
        if self.plan is None:
            # Servers that started empty adopt the plan from their first
            # client join: surface it here so a plan-less ShardSet can
            # still assemble after training ran against it.
            self.plan = next(
                (s.shard_plan for s in self.servers
                 if s.shard_plan is not None), None)
        if self.plan is None:
            raise ValueError("no plan adopted yet")
        return self.plan.assemble([s.center() for s in self.servers])

    def __enter__(self) -> "ShardSet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
