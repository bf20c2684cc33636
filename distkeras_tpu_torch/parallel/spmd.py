"""Multi-axis training steps: data, sequence, tensor and expert
parallelism over the ranks of a grid (the port's counterpart of
``distkeras_tpu/parallel/spmd.py``; :class:`ShardedStep` is also the body
of ``parallel/gspmd.py GSPMDEngine``).

The JAX ``SPMDEngine`` ``shard_map``\\ s ``data`` and ``seq`` by hand and
leaves ``model`` to GSPMD. The port has one process a rank, so every axis
is explicit code over a ``runtime/mesh.py`` subgroup:

* ``data`` — the batch's rows split over the axis; the step's gradient
  and loss averaged over it (one all-reduce a step).
* ``seq`` — each rank holds a ``[B, L/S]`` block of the tokens; the
  module (built with ``seq_axis="seq"``) computes global positions and
  ring or gather attention; the gradient and loss averaged over the axis
  too. Each sequence shard draws its own dropout masks.
* ``model`` — parameters split by the rules (``parallel/sharding.py``);
  the modules run their shards between the conjugate operators of
  ``ops/collectives.py``; the logits come out split along the vocabulary
  and the loss is ``collectives.vocab_parallel_cross_entropy`` (any other
  loss sees the logits gathered). The ``model`` peers of a rank hold the
  same rows and draw the same dropout masks.
* ``expert`` — the MoE expert bank split by ``MOE_RULES``
  (``models/moe.py``).

A module's gradient on a rank is, as under ``jax.grad`` inside
``shard_map``, the gradient of the sum of every rank's loss with respect
to that rank's copy: the collectives' backward carries the other ranks'
parts in. The ``data`` and ``seq`` means then give the gradient of the
mean loss; a replicated parameter's gradient comes out the same, bit for
bit, on every rank of the ``model`` and ``expert`` axes.
"""

from __future__ import annotations

import inspect
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from distkeras_tpu_torch.models.base import _warn_uint8_rescale
from distkeras_tpu_torch.ops import collectives
from distkeras_tpu_torch.ops.losses import (
    collect_aux_loss,
    get_loss,
    sparse_categorical_crossentropy,
)
from distkeras_tpu_torch.ops.optimizers import apply_updates, get_optimizer
from distkeras_tpu_torch.ops.precision import cast_floats
from distkeras_tpu_torch.parallel import sharding
from distkeras_tpu_torch.parallel.engine import _to
from distkeras_tpu_torch.runtime import mesh as rmesh
from distkeras_tpu_torch.runtime.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    RankMesh,
)
from distkeras_tpu_torch.workers import derive_seed, seeded_generator


class SPMDState(NamedTuple):
    params: Any     # this rank's shards, {name: tensor}
    opt_state: Any  # the optimizer state over those shards
    rng: int


def spmd_mesh_for(n_devices: int, devices: Optional[Sequence[int]] = None
                  ) -> RankMesh:
    """Factor ``n_devices`` ranks into a (data, seq, model) grid: the
    reference's greedy powers-of-two split (data first, then model, then
    seq; an odd remainder to data), ``model`` innermost."""
    devs = (list(devices) if devices is not None
            else list(range(rmesh.world_size()))[:n_devices])
    n = len(devs)
    sizes = {DATA_AXIS: 1, SEQ_AXIS: 1, MODEL_AXIS: 1}
    order = [DATA_AXIS, MODEL_AXIS, SEQ_AXIS]
    i = 0
    while n % 2 == 0 and n > 1:
        sizes[order[i % len(order)]] *= 2
        n //= 2
        i += 1
    sizes[DATA_AXIS] *= n
    return RankMesh((DATA_AXIS, SEQ_AXIS, MODEL_AXIS),
                    (sizes[DATA_AXIS], sizes[SEQ_AXIS], sizes[MODEL_AXIS]),
                    tuple(devs))


def shardable_by_rules(module: torch.nn.Module) -> bool:
    """Whether ``module`` runs tensor- and expert-parallel shards: the
    transformer family does (its layers read their shards' shapes)."""
    return hasattr(module, "seq_axis") and hasattr(module, "lm_head")


def split_vocab_loss(task, tp):
    """``task(logits, labels)`` for logits split along the vocabulary over
    ``tp``: the vocabulary-parallel cross-entropy for the sparse one, the
    gathered logits for any other loss."""

    def loss(out, y):
        if task is sparse_categorical_crossentropy:
            return collectives.vocab_parallel_cross_entropy(out, y, tp)
        return task(collectives.gather_replicated(out, tp, -1), y)

    return loss


def model_device(model) -> torch.device:
    """The device a grid rank trains on: the rank's own when a process
    group bound one, else the model's."""
    dev = rmesh.rank_device()
    return dev if dev is not None else model.device


class ShardedStep:
    """One training step of a model laid over ``mesh`` under ``rules``:
    the body both :class:`SPMDEngine` and ``GSPMDEngine`` run.

    ``seq_sharded``: the batch's sequence axis is split over ``seq`` (the
    SPMD route). ``global_batch``: the module's batch statistics (the MoE
    capacity, queue positions and router loss) are over the whole batch,
    not this rank's rows (the GSPMD route)."""

    def __init__(self, model, optimizer, loss, mesh: RankMesh, rules=(),
                 learning_rate: float = 0.01, seed: int = 0,
                 aux_loss_weight: float = 0.0, compute_dtype=None,
                 seq_sharded: bool = False, global_batch: bool = False):
        self.model = model
        self.mesh = mesh.bind()
        self.groups = mesh.groups()
        self.rules = tuple(rules)
        self.tx = get_optimizer(optimizer, learning_rate)
        self.loss_fn = get_loss(loss)
        self.seed = int(seed)
        self.aux_loss_weight = float(aux_loss_weight)
        self.compute_dtype = compute_dtype
        self.seq_sharded = bool(seq_sharded)
        self.global_batch = bool(global_batch)
        self.device = model_device(model)
        module = model.module
        self.specs = sharding.param_specs(model.params, mesh, self.rules,
                                          module)
        split = [k for k, s in self.specs.items()
                 if sharding.is_sharded(s, mesh)]
        if split and not shardable_by_rules(module):
            raise ValueError(
                f"rules split {split[:3]} of {type(module).__name__}, which "
                "runs no tensor- or expert-parallel shard: only the "
                "transformer family (TransformerLM, MoETransformerLM) "
                "carries the collectives its shards need")
        self.vocab_split = sharding.is_sharded(
            self.specs.get("lm_head.weight", ()), mesh)
        self._task_loss = (split_vocab_loss(self.loss_fn,
                                            self.groups[MODEL_AXIS])
                           if self.vocab_split else self.loss_fn)
        self.data = self.groups.get(DATA_AXIS)
        self.seq = self.groups.get(SEQ_AXIS)
        self.dp_size = int(mesh.shape.get(DATA_AXIS, 1))
        self.sp_size = int(mesh.shape.get(SEQ_AXIS, 1))
        fwd = inspect.signature(module.forward).parameters
        self._takes_rng = "rng" in fwd
        self._takes_inter = "return_intermediates" in fwd

    # -- state ---------------------------------------------------------------
    def init_state(self) -> SPMDState:
        whole = {k: v.detach().to(self.device).clone()
                 for k, v in self.model.params.items()}
        params = sharding.shard_params(whole, self.mesh, specs=self.specs)
        return SPMDState(params, self.tx.init(params), self.seed)

    def global_state(self, state: SPMDState) -> SPMDState:
        """Every shard gathered to whole tensors, on every rank."""
        whole = sharding.gather_params(state.params, self.mesh, self.specs)
        opt = sharding.map_mirrors(
            state.opt_state, state.params,
            lambda t: sharding.gather_params(t, self.mesh, self.specs))
        return SPMDState(whole, opt, state.rng)

    def local_state(self, state: SPMDState) -> SPMDState:
        """This rank's shards of a :meth:`global_state` (any layout wrote
        it)."""
        dev = self.device
        whole = {k: v.to(dev) for k, v in state.params.items()}
        params = sharding.shard_params(whole, self.mesh, specs=self.specs)
        opt = sharding.map_mirrors(
            _to(state.opt_state, dev), whole,
            lambda t: sharding.shard_params(t, self.mesh, specs=self.specs))
        return SPMDState(params, opt, int(state.rng))

    def restore_target(self) -> SPMDState:
        whole = {k: v.detach().to(self.device).clone()
                 for k, v in self.model.params.items()}
        return SPMDState(whole, self.tx.init(whole), self.seed)

    # -- the batch ---------------------------------------------------------
    def local_block(self, x: np.ndarray) -> np.ndarray:
        """This rank's block of a global ``[K, B, ...]`` batch stack: rows
        by its ``data`` index, and the sequence by its ``seq`` index where
        the route splits it."""
        if self.dp_size > 1:
            b = x.shape[1] // self.dp_size
            d = self.mesh.index(DATA_AXIS)
            x = x[:, d * b:(d + 1) * b]
        return self.seq_block(x)

    def seq_block(self, x: np.ndarray) -> np.ndarray:
        if self.seq_sharded and self.sp_size > 1:
            n = x.shape[2] // self.sp_size
            s = self.mesh.index(SEQ_AXIS)
            x = x[:, :, s * n:(s + 1) * n]
        return x

    # -- the step ------------------------------------------------------------
    def _input(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8 and getattr(self.model, "normalize_uint8",
                                              True):
            _warn_uint8_rescale()
            return x.to(self.compute_dtype or torch.float32) / 255.0
        return cast_floats(x, self.compute_dtype)

    def loss_and_grads(self, params: dict, x: torch.Tensor, y: torch.Tensor,
                       seed: int):
        """This rank's loss and its gradients (before any mean), with the
        grid's axes set for the module."""
        module = self.model.module
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        kwargs = {}
        if self._takes_rng:
            kwargs["rng"] = seeded_generator(x.device, seed)
        aux_w = self.aux_loss_weight
        if aux_w and self._takes_inter:
            kwargs["return_intermediates"] = True
        was_training = module.training
        module.train()
        gb = self.data if self.global_batch else None
        try:
            with rmesh.axis_context(self.groups, global_batch=gb):
                tensors = cast_floats(leaves, self.compute_dtype)
                out = functional_call(module, tensors, (self._input(x),),
                                      kwargs)
                inter = None
                if isinstance(out, tuple):
                    out, inter = out
                loss = self._task_loss(out.to(torch.float32), y)
                if aux_w:
                    aux = collect_aux_loss(inter or {}).to(loss.device)
                    loss = loss + aux_w * aux
                grads = torch.autograd.grad(loss, list(leaves.values()))
        finally:
            module.train(was_training)
        return loss.detach(), dict(zip(leaves, grads))

    def _mean(self, tree: dict, g) -> dict:
        if g is None or g.trivial:  # one rank: the mean is the identity
            return tree
        return collectives.all_reduce(tree, "mean", group=g.pg)

    def step(self, state: SPMDState, x: torch.Tensor, y: torch.Tensor):
        """One optimizer step on this rank's block ``x``/``y``: returns the
        new state and the loss (the mean over the ``data`` and ``seq``
        ranks)."""
        seed = derive_seed(state.rng, self.mesh.index(DATA_AXIS),
                           self.mesh.index(SEQ_AXIS))
        loss, grads = self.loss_and_grads(state.params, x, y, seed)
        key = ("loss",)
        out = self._mean({**grads, key: loss}, self.data)
        if self.seq_sharded:
            out = self._mean(out, self.seq)
        loss = out.pop(key)
        updates, opt_state = self.tx.update(out, state.opt_state,
                                            state.params)
        params = apply_updates(state.params, updates)
        return SPMDState(params, opt_state, derive_seed(state.rng)), loss


class SPMDEngine(ShardedStep):
    """dp x sp x tp (x ep) training for sequence models: each ``(data,
    seq)`` rank sees its own ``[B/dp, L/S]`` block (and every batch
    statistic is its own). ``module`` must be built with
    ``seq_axis='seq'`` when the grid has a ``seq`` axis of more than one
    rank (``ParallelTrainer`` rebinds it)."""

    def __init__(self, model, optimizer, loss, mesh: RankMesh, tp_rules=(),
                 learning_rate: float = 0.01, seed: int = 0,
                 aux_loss_weight: float = 0.0, compute_dtype=None):
        super().__init__(model, optimizer, loss, mesh, tp_rules,
                         learning_rate=learning_rate, seed=seed,
                         aux_loss_weight=aux_loss_weight,
                         compute_dtype=compute_dtype, seq_sharded=True)
