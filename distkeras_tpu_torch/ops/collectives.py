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

