"""Sharded center plane: the center (and its optimizer-state byte budget)
partitioned across N independent parameter servers (the port's copy of the
JAX package's ``netps/shards/``).

A :class:`PartitionPlan` — regex rules over parameter names with a
byte-balanced default, row-splitting tensors too big for one shard —
assigns every tensor slice to a shard. Each shard is a full
:class:`~distkeras_tpu_torch.netps.server.PSServer` (its own journal and
snapshot lineage, its own warm standby, its own epoch fence, its slice of
the center on the card, folded by one ``fold_commit`` launch a commit) and
a :class:`ShardedPSClient` fans pulls and commits out under one logical
seq, ACKing only when every shard folded. Plan identity is hash-checked at
join and on every pull, so a mismatched plan is a typed
:class:`~distkeras_tpu_torch.netps.errors.ShardPlanError`, never a silent
mis-fold.
"""

from distkeras_tpu_torch.netps.shards.client import (ShardedPSClient,
                                                     is_sharded_endpoint,
                                                     make_ps_client)
from distkeras_tpu_torch.netps.shards.group import ShardSet
from distkeras_tpu_torch.netps.shards.plan import (PartitionPlan,
                                                   parse_rules,
                                                   plan_for_model)

__all__ = [
    "PartitionPlan",
    "ShardSet",
    "ShardedPSClient",
    "is_sharded_endpoint",
    "make_ps_client",
    "parse_rules",
    "plan_for_model",
]
