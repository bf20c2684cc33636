"""Async disciplines x tensor/sequence parallelism: each worker spans a row
of ranks (the port's counterpart of ``distkeras_tpu/parallel/async_tp.py``).

The grid is ``(data[, seq], model)``: the ``data`` index is the logical
worker, and the ranks of its ``model`` (x ``seq``) row hold its replica,
tensor-split by the rules (``parallel/sharding.py``) and, for sequence
models, sequence-split. The round is :class:`~distkeras_tpu_torch.
parallel.engine.AsyncEngine`'s, unchanged: the same worker ids, seeds,
staleness rotation and fold, with

* the discipline's fold all-reduced over the ``data`` subgroup (the
  ranks that hold the same shard), each rank folding its shard of the
  center, and the ``[W]`` losses all-gathered over it;
* each worker's local steps run inside the grid's axes
  (``runtime/mesh.py axis_context``), so the transformer runs its shards
  and, under ``attn_impl="flash"``, the flash kernels on the rank's
  ``H/tp`` heads, with the vocabulary-split loss
  (``ops/collectives.py vocab_parallel_cross_entropy``);
* with ``seq``, each step's gradient and loss averaged over the ``seq``
  ranks before the update (``_grad_transform``), every sequence shard
  drawing its own dropout masks.

Flat and tensor-parallel runs of one model therefore agree to float
tolerance, and bit for bit on a model the rules do not split.
"""

from __future__ import annotations

from typing import Optional

from distkeras_tpu_torch.ops import collectives
from distkeras_tpu_torch.parallel import sharding
from distkeras_tpu_torch.parallel.engine import AsyncEngine, EngineState, _to
from distkeras_tpu_torch.parallel.spmd import (
    model_device,
    shardable_by_rules,
    split_vocab_loss,
)
from distkeras_tpu_torch.runtime import mesh as rmesh
from distkeras_tpu_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS
from distkeras_tpu_torch.workers import derive_seed, make_local_loop


class AsyncTPEngine(AsyncEngine):
    """A :class:`Discipline` over a ``(data[, seq], model)`` grid: ``data``
    indexes workers, ``model`` tensor-splits every worker's replica under
    ``rules``, ``seq`` (optional) splits the sequence."""

    def __init__(self, model, optimizer, loss, discipline, mesh, window,
                 rules=(), workers_per_chip: int = 1, **kwargs):
        if workers_per_chip != 1:
            raise ValueError(
                "AsyncTPEngine does not multiplex workers per chip: a "
                "worker already spans a tp submesh. Drop workers_per_chip "
                "or use the flat AsyncEngine.")
        if MODEL_AXIS not in mesh.axis_names:
            raise ValueError(
                f"AsyncTPEngine needs a '{MODEL_AXIS}' mesh axis, got "
                f"{mesh.axis_names}; use hybrid_mesh({{'data': W, "
                "'model': tp}})")
        seq_axis = getattr(model.module, "seq_axis", None)
        has_seq = SEQ_AXIS in mesh.axis_names
        if seq_axis is not None and not has_seq:
            raise ValueError(
                f"model was built with seq_axis={seq_axis!r} but the mesh "
                f"has no '{SEQ_AXIS}' axis; pass parallel={{'model': tp, "
                "'seq': s}} (or rebuild the model with seq_axis=None)")
        if has_seq and mesh.shape[SEQ_AXIS] > 1 and seq_axis != SEQ_AXIS:
            raise ValueError(
                f"mesh has a '{SEQ_AXIS}' axis of size "
                f"{mesh.shape[SEQ_AXIS]} but the model was not built with "
                f"seq_axis='{SEQ_AXIS}' — it would silently ignore the "
                "sequence sharding. Build the model with seq_axis='seq' "
                "and attn_impl='ring' or 'gather'.")
        if (has_seq and mesh.shape[SEQ_AXIS] > 1 and model.state_collections
                and not discipline.syncs_state):
            raise ValueError(
                "sequence parallelism with a stateful model (collections "
                f"{model.state_collections}) requires a state-syncing "
                "discipline; the non-syncing "
                f"{type(discipline).__name__} would let per-shard running "
                "statistics diverge across seq shards.")
        self.mesh = mesh.bind()
        self.groups = mesh.groups()
        self.rules = tuple(rules)
        self.specs = sharding.param_specs(model.params, mesh, self.rules,
                                          model.module)
        split = [k for k, s in self.specs.items()
                 if sharding.is_sharded(s, mesh)]
        if split and not shardable_by_rules(model.module):
            raise ValueError(
                f"rules split {split[:3]} of {type(model.module).__name__}, "
                "which runs no tensor-parallel shard: only the transformer "
                "family carries the collectives its shards need")
        self.seq_size = int(mesh.shape.get(SEQ_AXIS, 1))
        super().__init__(model, optimizer, loss, discipline, window,
                         num_workers=int(mesh.shape[DATA_AXIS]), **kwargs)
        self._fold_pg = self.groups[DATA_AXIS].pg
        self.device = model_device(model)
        loss_fn = self.loss_fn
        if sharding.is_sharded(self.specs.get("lm_head.weight", ()), mesh):
            loss_fn = split_vocab_loss(loss_fn, self.groups[MODEL_AXIS])
        self._local_loop = make_local_loop(
            model.module, loss_fn, self.tx,
            compute_dtype=kwargs.get("compute_dtype"),
            state_collections=model.state_collections,
            grad_accum=kwargs.get("grad_accum", 1),
            input_transform=kwargs.get("device_transform"),
            normalize_uint8=getattr(model, "normalize_uint8", True),
            grad_transform=self._grad_transform())

    # -- the round's hooks ----------------------------------------------------
    def _bind_ranks(self) -> None:
        """One worker a ``data`` index; its ``model`` and ``seq`` peers
        carry the same worker."""
        self.workers_per_rank = 1
        self.local_workers = [self.mesh.index(DATA_AXIS)]
        self.num_chips = int(self.mesh.size)

    def _grad_transform(self):
        g = self.groups.get(SEQ_AXIS)
        if g is None or g.pg is None or self.seq_size == 1:
            return None

        def seq_mean(grads, loss):
            # Each seq shard back-propagates its own L/S positions; the
            # step's gradient and loss are their mean, so every shard
            # applies the same update.
            out = collectives.all_reduce({**grads, ("loss",): loss}, "mean",
                                         group=g.pg)
            return out, out.pop(("loss",))

        return seq_mean

    def _worker_seed(self, rng: int, worker: int) -> int:
        seed = derive_seed(rng, worker)
        if self.seq_size > 1:
            # independent dropout masks per sequence shard
            seed = derive_seed(seed, self.mesh.index(SEQ_AXIS))
        return seed

    def _worker_context(self):
        return rmesh.axis_context(self.groups)

    def _put_batch(self, xs, ys):
        """This worker's rows, cut to the rank's sequence block where the
        grid splits the sequence (LM batches ``[m, K, B, L]``)."""
        if self.seq_size > 1:
            n = xs.shape[3] // self.seq_size
            s = self.mesh.index(SEQ_AXIS)
            xs = xs[:, :, :, s * n:(s + 1) * n]
            ys = ys[:, :, :, s * n:(s + 1) * n]
        return rmesh.put_global((xs, ys), self.model.device)

    # -- state layout ---------------------------------------------------------
    def _shard(self, tree: dict) -> dict:
        return sharding.shard_params(tree, self.mesh, specs=self.specs)

    def _gather(self, tree: dict) -> dict:
        return sharding.gather_params(tree, self.mesh, self.specs)

    def _shard_state(self, st: EngineState) -> EngineState:
        whole = st.center
        center = self._shard(whole)
        locals_ = [center if l is whole else self._shard(l)
                   for l in st.locals_]
        opt = [sharding.map_mirrors(o, whole, self._shard)
               for o in st.opt_state]
        return st._replace(center=center, locals_=locals_, opt_state=opt)

    def init_state(self) -> EngineState:
        return self._shard_state(super().init_state())

    def adopt_state(self, host: EngineState) -> EngineState:
        return self._shard_state(super().adopt_state(host))

    def restore_target(self) -> EngineState:
        init = super().init_state()
        W = self.num_workers
        return init._replace(
            locals_=[init.locals_[0]] * W, opt_state=[init.opt_state[0]] * W,
            model_state=(None if init.model_state is None
                         else [init.model_state[0]] * W))

    def global_state(self, state: EngineState) -> EngineState:
        """Every worker's whole state on every rank: each tensor gathered
        over ``model`` to whole, then the ``[W]`` entries over ``data``."""
        center = self._gather(state.center)
        pulls = self.discipline.pulls_center
        mine_locals = [] if pulls else [self._gather(l)
                                         for l in state.locals_]
        mine_opts = [sharding.map_mirrors(o, state.center, self._gather)
                     for o in state.opt_state]
        mine_bufs = state.model_state
        if self.groups[DATA_AXIS].size == 1:  # one worker: nothing to gather
            parts = [(mine_locals, mine_opts, mine_bufs)]
        else:
            parts = collectives.all_gather_object(
                (_host(mine_locals), _host(mine_opts), _host(mine_bufs)),
                group=self._fold_pg)
        dev = self.model.device
        locals_ = ([center] * self.num_workers if pulls else
                   [_to(x, dev) for p in parts for x in p[0]])
        opts = [_to(x, dev) for p in parts for x in p[1]]
        bufs = (None if state.model_state is None else
                [_to(x, dev) for p in parts for x in p[2]])
        return state._replace(center=center, locals_=locals_,
                              opt_state=opts, model_state=bufs)

    def local_state(self, state: EngineState) -> EngineState:
        """This rank's shards of its worker's entries of a
        :meth:`global_state`."""
        j = self.local_workers[0]
        whole = {k: v.to(self.model.device) for k, v in state.center.items()}
        sub = state._replace(
            center=whole,
            locals_=[whole if self.discipline.pulls_center
                     else state.locals_[j]],
            opt_state=[state.opt_state[j]],
            model_state=(None if state.model_state is None
                         else [state.model_state[j]]))
        return self._shard_state(sub)


def _host(tree):
    return _to(tree, "cpu")


def tp_layout(num_workers: Optional[int], tp: int, sp: int,
              seq_axis: Optional[str], devices: int) -> dict:
    """The async trainers' grid for ``parallel={"model": tp, "seq": sp}``
    (seq between data and model, as the JAX package orders it)."""
    W = num_workers or devices // (tp * sp)
    if W < 1 or W * tp * sp > devices:
        raise ValueError(
            f"parallel={{'model': {tp}, 'seq': {sp}}} with "
            f"num_workers={num_workers} needs num_workers*{tp * sp} "
            f"<= {devices} available devices (and at least one worker); "
            f"got W={W}")
    if sp > 1 or seq_axis is not None:
        return {DATA_AXIS: W, SEQ_AXIS: sp, MODEL_AXIS: tp}
    return {DATA_AXIS: W, MODEL_AXIS: tp}
