"""Collectives over the process group, tree-shaped: the port's counterpart
of ``distkeras_tpu/ops/collectives.py``.

The reference's transport was ``distkeras/networking.py`` (length-prefixed
pickle over TCP, one driver thread a worker); the JAX package's is XLA's
collectives over ICI and DCN (``lax.psum``, ``lax.all_gather``). Here it
is ``torch.distributed``: NCCL between cards, gloo on the CPU. A tree
(a dict of tensors, or one tensor) goes out as one flat buffer per dtype,
so a fold is ONE all-reduce, as XLA fuses the JAX package's ``psum``.

Without a process group every helper is the one-rank identity. In a group
of one rank the collective still runs (an all-reduce over one rank is an
identity, bit for bit).

A CUDA tensor in a gloo group (several ranks on one card, which NCCL
refuses) is staged through the host: copied to the CPU, reduced there by
gloo, and copied back. Each staged collective is counted in
:data:`HOST_STAGED`, so a caller can say that it happened.

The JAX package's ``shard_map`` shim smooths that API across jax
versions; it has no torch meaning (each rank runs its own program), so it
is not ported. ``axis_size`` is the group's size.

**The model-parallel operators.** Where the JAX package lets GSPMD insert
the tensor-parallel collectives and differentiates ``psum``,
``all_gather`` and ``ppermute`` through their transposes, the port writes
each as a ``torch.autograd.Function`` over one axis's subgroup
(``runtime/mesh.py AxisGroup``), with the backward that the Megatron
pairing needs (``torch.distributed.nn``'s all-reduce and all-gather
reduce again in their backward, which would scale gradients by the
group's size):

==========================  ===========================  =====================
operator                    forward                      backward
==========================  ===========================  =====================
:func:`enter_parallel`      identity                     all-reduce (sum)
:func:`exit_parallel`       all-reduce (sum)             identity
:func:`gather_replicated`   all-gather (concatenate)     this rank's slice
:func:`gather_shards`       all-gather (concatenate)     all-reduce, own slice
:func:`shift`               to ``i+1``, from ``i-1``     the reverse shift
:func:`psum_mean`           all-reduce (mean)            all-reduce (mean)
==========================  ===========================  =====================

``enter_parallel`` opens a column-parallel region (its input is
replicated, its consumers hold shards), ``exit_parallel`` closes a
row-parallel one (the shards' partial sums), ``gather_replicated``
assembles a sharded activation that every rank then consumes whole
(each rank already holds the whole gradient), ``gather_shards`` assembles
blocks that each rank consumes only in part (the sequence shards' keys
and values), ``shift`` is ``ppermute`` around the ring, and ``psum_mean``
is ``lax.pmean``. :func:`vocab_parallel_cross_entropy` is the sparse
cross-entropy over logits sharded along the vocabulary (three
all-reduces, no gather of the logits). On a trivial group each is the
identity (the loss the plain one).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from distkeras_tpu_torch.runtime import mesh

#: collectives staged through the host (gloo over CUDA tensors), this
#: process; ``reset_host_staged()`` zeroes it
HOST_STAGED = {"calls": 0, "bytes": 0}


def reset_host_staged() -> None:
    HOST_STAGED.update(calls=0, bytes=0)


def axis_size(group=None) -> int:
    """Ranks in ``group`` (the default group when None; 1 without one)."""
    if not mesh.group_active():
        return 1
    return dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _flat(tensors: list) -> list:
    """``[(flat buffer, [(index, shape, numel)])]``: one buffer per dtype
    (and device), the tensors in their order."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    out = []
    for (dtype, _dev), idx in groups.items():
        buf = torch.cat([tensors[i].reshape(-1) for i in idx])
        out.append((buf, [(i, tensors[i].shape, tensors[i].numel())
                          for i in idx]))
    return out


def _leaves(tree):
    """``(leaves, rebuild)`` of a tensor or a dict of tensors."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda vals: vals[0]
    keys = list(tree)
    return [tree[k] for k in keys], lambda vals: dict(zip(keys, vals))


def _all_reduce_buffer(buf: torch.Tensor, group) -> torch.Tensor:
    if _staged(buf, group):
        host = buf.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        HOST_STAGED["calls"] += 1
        HOST_STAGED["bytes"] += host.numel() * host.element_size()
        return host.to(buf.device)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def all_reduce(tree, op: str = "sum", group=None):
    """The sum (``op="sum"``) or mean (``"mean"``: the sum divided by the
    rank count) of ``tree`` over the ranks: a tensor or a dict of tensors,
    returned as new tensors of the same structure. One collective per
    dtype. The input is not modified."""
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    if not mesh.group_active():
        return tree
    leaves, rebuild = _leaves(tree)
    vals: list = [None] * len(leaves)
    n = dist.get_world_size(group)
    for buf, parts in _flat(leaves):
        buf = _all_reduce_buffer(buf, group)
        if op == "mean":
            buf = buf / n
        for (i, shape, numel), piece in zip(
                parts, torch.split(buf, [p[2] for p in parts])):
            vals[i] = piece.reshape(shape)
    return rebuild(vals)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked on a new leading axis, ``[ranks, ...]``,
    in rank order (the reference's ``lax.all_gather``). Every rank's ``t``
    must have one shape and dtype."""
    if not mesh.group_active():
        return t[None]
    n = dist.get_world_size(group)
    src = t.contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
        HOST_STAGED["calls"] += 1
        HOST_STAGED["bytes"] += src.numel() * src.element_size() * n
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    got = torch.stack(out)
    return got.to(t.device) if staged else got


def all_gather_object(obj: Any, group=None) -> list:
    """Every rank's picklable ``obj``, in rank order (``[obj]`` without a
    group). Tensors inside should be on the CPU."""
    if not mesh.group_active():
        return [obj]
    out: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj: Any, src: int = 0, group=None) -> Any:
    """Rank ``src``'s ``obj`` on every rank (``obj`` without a group)."""
    if not mesh.group_active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def barrier(group=None) -> None:
    """Wait for every rank (a no-op without a group)."""
    if mesh.group_active():
        if dist.get_backend(group) == "nccl":
            dev = mesh.rank_device()
            dist.barrier(group=group,
                         device_ids=None if dev is None else [dev.index])
        else:
            dist.barrier(group=group)


def is_main_process() -> bool:
    """Rank 0, or the one process without a group."""
    return mesh.rank() == 0



# -- the model-parallel operators ---------------------------------------------

def _trivial(g) -> bool:
    return g is None or g.trivial


def _count(t: torch.Tensor, factor: int = 1) -> None:
    HOST_STAGED["calls"] += 1
    HOST_STAGED["bytes"] += t.numel() * t.element_size() * factor


def _reduce(t: torch.Tensor, g, op=None) -> torch.Tensor:
    """``t`` all-reduced over ``g`` (sum unless ``op``), as a new tensor;
    staged through the host where gloo carries a CUDA tensor."""
    op = dist.ReduceOp.SUM if op is None else op
    buf = t.contiguous().clone()
    if _staged(buf, g.pg):
        host = buf.cpu()
        dist.all_reduce(host, op=op, group=g.pg)
        _count(host)
        return host.to(t.device)
    dist.all_reduce(buf, op=op, group=g.pg)
    return buf


def _gather_cat(t: torch.Tensor, g, dim: int) -> torch.Tensor:
    """Every rank of ``g``'s ``t`` concatenated along ``dim``, in axis
    order."""
    src = t.contiguous()
    staged = _staged(src, g.pg)
    if staged:
        src = src.cpu()
        _count(src, g.size)
    out = [torch.empty_like(src) for _ in range(g.size)]
    dist.all_gather(out, src, group=g.pg)
    got = torch.cat(out, dim=dim)
    return got.to(t.device) if staged else got


def _own(t: torch.Tensor, g, dim: int) -> torch.Tensor:
    n = t.shape[dim] // g.size
    return t.narrow(dim, g.index * n, n).contiguous()


def _exchange(t: torch.Tensor, g, step: int) -> torch.Tensor:
    """Send ``t`` to the rank ``step`` places on along ``g`` and receive
    from the one ``step`` places back, both in one ``all_to_all_single``
    whose splits are empty but for those two peers."""
    S, i = g.size, g.index
    src = t.contiguous().reshape(-1)
    staged = _staged(src, g.pg)
    if staged:
        src = src.cpu()
        _count(src, 2)
    n = src.numel()
    send = [0] * S
    take = [0] * S
    send[(i + step) % S] = n
    take[(i - step) % S] = n
    recv = torch.empty_like(src)
    dist.all_to_all_single(recv, src, output_split_sizes=take,
                           input_split_sizes=send, group=g.pg)
    recv = recv.reshape(t.shape)
    return recv.to(t.device) if staged else recv


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.g), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return _reduce(x, g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _gather_cat(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return _own(grad, ctx.g, ctx.dim), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _gather_cat(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return _own(_reduce(grad, ctx.g), ctx.g, ctx.dim), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _exchange(x, g, 1)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.g, -1), None


class _PsumMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _reduce(x, g) / g.size

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.g) / ctx.g.size, None


class _Sink(torch.autograd.Function):
    """``value`` unchanged; every tensor in ``extras`` joins its graph with
    a zero gradient, so their backward runs on every rank."""

    @staticmethod
    def forward(ctx, value, *extras):
        ctx.shapes = [(e.shape, e.dtype, e.device) for e in extras]
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return (grad, *(torch.zeros(s, dtype=d, device=v)
                        for s, d, v in ctx.shapes))


def enter_parallel(x: torch.Tensor, g) -> torch.Tensor:
    """Identity forward, all-reduce backward: the entry of a column-parallel
    region over ``g``."""
    return x if _trivial(g) else _Enter.apply(x, g)


def exit_parallel(x: torch.Tensor, g) -> torch.Tensor:
    """All-reduce forward, identity backward: the exit of a row-parallel
    region over ``g``."""
    return x if _trivial(g) else _Exit.apply(x, g)


def gather_replicated(x: torch.Tensor, g, dim: int = -1) -> torch.Tensor:
    """All-gather along ``dim`` forward; backward, this rank's slice of the
    gradient (every consumer downstream is replicated over ``g``)."""
    if _trivial(g):
        return x
    return _GatherReplicated.apply(x, g, dim % x.dim())


def gather_shards(x: torch.Tensor, g, dim: int = 1) -> torch.Tensor:
    """All-gather along ``dim`` forward; backward, the gradient summed over
    ``g`` and this rank's slice of it (the transpose of a tiled
    ``lax.all_gather``)."""
    if _trivial(g):
        return x
    return _GatherShards.apply(x, g, dim % x.dim())


def shift(x: torch.Tensor, g) -> torch.Tensor:
    """``ppermute`` one place around ``g``'s ring: rank ``i`` sends ``x``
    to ``i+1`` and receives from ``i-1``; the backward shifts the gradient
    back. Every rank of ``g`` must make the same shifts in the same order,
    forward and backward."""
    if _trivial(g):
        return x
    return _Shift.apply(x, g)


def psum_mean(x: torch.Tensor, g) -> torch.Tensor:
    """``lax.pmean`` over ``g``: the mean forward, the mean of the
    gradients backward."""
    return x if _trivial(g) else _PsumMean.apply(x, g)


def sink(value: torch.Tensor, extras) -> torch.Tensor:
    """``value``, with ``extras`` tied into its graph at zero gradient: a
    rank whose result does not depend on some of its collectives still
    runs their backward, so the ranks' backward collectives pair up."""
    extras = [e for e in extras if e.requires_grad]
    return _Sink.apply(value, *extras) if extras else value


def reduce_sum(t: torch.Tensor, g) -> torch.Tensor:
    """The sum over ``g`` (no gradient)."""
    return t if _trivial(g) else _reduce(t.detach(), g)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, g):
        N, Vl = logits.shape
        start = g.index * Vl
        m = _reduce(logits.max(dim=-1).values, g, dist.ReduceOp.MAX)
        shifted = logits - m[:, None]
        e = shifted.exp()
        local_t = targets - start
        inside = (local_t >= 0) & (local_t < Vl)
        idx = local_t.clamp(0, Vl - 1)
        picked = shifted.gather(-1, idx[:, None])[:, 0] * inside
        sums = _reduce(torch.stack([e.sum(dim=-1), picked]), g)
        ctx.save_for_backward(e, sums[0], idx, inside)
        ctx.n = N
        return (sums[0].log() - sums[1]).mean()

    @staticmethod
    def backward(ctx, grad):
        e, total, idx, inside = ctx.saved_tensors
        d = e / total[:, None]
        d.scatter_add_(-1, idx[:, None], -inside.to(d.dtype)[:, None])
        return d * (grad / ctx.n), None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 g) -> torch.Tensor:
    """``sparse_categorical_crossentropy`` of logits sharded along their
    last (vocabulary) axis over ``g``: rank ``i`` holds columns ``[i*Vl,
    (i+1)*Vl)``. The global max, the sum of exponentials and the target's
    logit are each all-reduced; the logits are never gathered. The
    backward is each rank's own columns of ``softmax - onehot``. Returns
    the mean over every target, the same value on every rank."""
    from distkeras_tpu_torch.ops.losses import sparse_categorical_crossentropy

    if _trivial(g):
        return sparse_categorical_crossentropy(logits, targets)
    Vl = logits.shape[-1]
    return _VocabParallelCE.apply(logits.reshape(-1, Vl),
                                  targets.reshape(-1).long(), g)
