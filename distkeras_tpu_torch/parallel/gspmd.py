"""Data, tensor and expert parallelism with the module seeing the whole
batch (the port's counterpart of ``distkeras_tpu/parallel/gspmd.py``).

The JAX ``GSPMDEngine`` lays the parameters out by ``PartitionSpec``
rules, splits the batch over ``data`` and lets XLA insert every
collective. The port runs the same step as ``parallel/spmd.py``
(:class:`~distkeras_tpu_torch.parallel.spmd.ShardedStep`, explicit
collectives over the grid's subgroups) with the one semantic the JAX
engine has and ``SPMDEngine`` has not: the module sees the **global**
batch. For a dense model that changes nothing (equal shards, means); for
the MoE LM the capacity, the queue positions and the router loss are over
every ``data`` rank's tokens (``models/moe.py``).

The construction-time refusals are the JAX engine's, with its messages:
it cannot host ``attn_impl='flash'`` nor a ``seq_axis`` module. The port
has no such limit (``SPMDEngine`` runs both), but a user's code behaves
the same in both packages.
"""

from __future__ import annotations

from typing import Sequence

from distkeras_tpu_torch.parallel.spmd import ShardedStep
from distkeras_tpu_torch.runtime.mesh import RankMesh


class GSPMDEngine(ShardedStep):
    def __init__(self, model, optimizer, loss, mesh: RankMesh,
                 rules: Sequence = (), learning_rate: float = 0.01,
                 seed: int = 0, aux_loss_weight: float = 0.0,
                 compute_dtype=None):
        impl = getattr(model.module, "attn_impl", None)
        if impl == "flash":
            raise ValueError(
                "GSPMDEngine cannot host attn_impl='flash': the Mosaic "
                "flash-attention kernel is not GSPMD-auto-partitionable and "
                "plain jit binds no mesh axes for the kernel's manual "
                "region. Use SPMDEngine (shard_map-based — it hosts the "
                "flash kernel via a nested manual region), or "
                "attn_impl='dense' with GSPMDEngine.")
        if getattr(model.module, "seq_axis", None) is not None:
            raise ValueError(
                "GSPMDEngine cannot host seq_axis="
                f"{model.module.seq_axis!r}: ring/gather sequence "
                "parallelism uses named-axis collectives (ppermute/"
                "all_gather), which need a shard_map-bound axis. Use "
                "SPMDEngine for sequence parallelism.")
        super().__init__(model, optimizer, loss, mesh, rules,
                         learning_rate=learning_rate, seed=seed,
                         aux_loss_weight=aux_loss_weight,
                         compute_dtype=compute_dtype, global_batch=True)
