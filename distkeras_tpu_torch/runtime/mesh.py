"""The rank grid: the port's counterpart of ``distkeras_tpu/runtime/mesh.py``.

The JAX package lays its workers over a :class:`jax.sharding.Mesh` of
chips and bootstraps several hosts with ``jax.distributed``. The port's
unit is the rank of a ``torch.distributed`` process group, one card a
rank: :func:`distributed_initialize` forms the group (NCCL between cards,
gloo on the CPU), :func:`data_mesh` and :func:`hybrid_mesh` describe grids
of its ranks with the reference's size inference and errors, and the
engines carry the logical workers ``[rank*m, (rank+1)*m)`` on each rank
(:func:`workers_per_rank`, :func:`local_worker_ids`).

* ``distkeras/job_deployment.py`` maps to the port's ``job_deployment.Job``,
  which renders ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``
  and ``LOCAL_RANK`` on every host; each process then calls
  :func:`distributed_initialize`.
* ``Trainer(num_workers=...)`` (the Spark partition count) maps to the
  logical workers, ``m`` a rank.

Without a group the world is one rank and every logical worker is
multiplexed on the model's device, as before the group existed.

Axis names (fixed so layouts compose across the package): ``data`` (one
dist-keras worker a slice), ``model`` (tensor parallel), ``seq``
(sequence parallel), ``pipe`` (pipeline stages), ``expert`` (MoE experts).
A grid may name any of them.

The JAX package turns each axis into collectives XLA inserts (GSPMD) or a
``shard_map`` binds; here each rank runs its own program, so an axis is a
``torch.distributed`` subgroup: :meth:`RankMesh.bind` creates every
subgroup of every axis, in one order on every rank (gloo and NCCL need
each ``new_group`` made by all ranks), and :meth:`RankMesh.group` gives
this rank's :class:`AxisGroup` along an axis (its ranks, its size, this
rank's index on it). An engine binds its mesh and sets the groups as the
ambient axes (:func:`axis_context`, the counterpart of the ambient mesh
a ``shard_map`` body sees); a module reads them with :func:`ambient`.
With one rank on an axis (or no process group) the group is trivial and
every collective on it is the identity.

The reference's ``replicated`` and ``batch_sharding`` are sharding
objects for XLA; the port's engines place every tensor on the rank's one
device, so no caller needs them and they are not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import math
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.runtime.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"

#: the device :func:`distributed_initialize` bound this process's rank to
_RANK_DEVICE: list = [None]


def group_active() -> bool:
    """Whether this process belongs to an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the group (1 without one)."""
    return dist.get_world_size() if group_active() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if group_active() else 0


def rank_device() -> Optional[torch.device]:
    """The device :func:`distributed_initialize` bound this rank to (None
    without a group)."""
    return _RANK_DEVICE[0] if group_active() else None


def device_count() -> int:
    """Cards in the group, one a rank (the Spark ``num_workers``
    analogue). Without a group, the cards visible to this process, or 1
    on the CPU."""
    if group_active():
        return world_size()
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def distributed_initialize(*, backend: Optional[str] = None,
                           device: Union[str, torch.device, None] = None,
                           master_addr: Optional[str] = None,
                           master_port: Optional[int] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           local_rank: Optional[int] = None,
                           timeout: Optional[float] = None) -> torch.device:
    """Join the process group (the reference's ``jax.distributed``
    bootstrap). Every argument left out is read from the environment that
    ``job_deployment.Job`` renders: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``.

    The rank's device is ``cuda:LOCAL_RANK`` unless ``device`` says
    otherwise (``device="cpu"`` for a CPU group); where there is no card
    and none was asked for, this raises. The backend is NCCL on a CUDA
    device and gloo on the CPU; ``backend="gloo"`` on a CUDA device is
    allowed (several ranks on one card, which NCCL refuses), and
    ``backend="nccl"`` on the CPU raises. A group that cannot form raises
    (``timeout`` seconds, torch's default when None); nothing carries on
    as one rank. Calling it again in a process that has a group is a
    no-op, as in the reference. Returns the rank's device."""
    if group_active():
        return _RANK_DEVICE[0]
    addr = master_addr or config.env_str("MASTER_ADDR")
    port = int(master_port or config.env_int("MASTER_PORT"))
    world = int(world_size or config.env_int("WORLD_SIZE"))
    r = int(config.env_int("RANK") if rank is None else rank)
    local = int(config.env_int("LOCAL_RANK") if local_rank is None
                else local_rank)
    if not addr or not port or world < 1:
        raise ValueError(
            "distributed_initialize needs MASTER_ADDR, MASTER_PORT and "
            f"WORLD_SIZE (got {addr!r}, {port}, {world}): pass them or "
            "launch through job_deployment.Job")
    if not 0 <= r < world:
        raise ValueError(f"rank {r} is outside a world of {world}")
    dev = resolve_device(f"cuda:{local}" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(
                f"the NCCL backend needs a CUDA device; this rank's is {dev}"
                " (pass device='cpu' with backend='gloo', or None)")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL backend")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=r, world_size=world, **kw)
    _RANK_DEVICE[0] = dev
    return dev


def distributed_shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if group_active():
        dist.destroy_process_group()
    _RANK_DEVICE[0] = None
    _BOUND.clear()


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A grid of the group's ranks: ``axis_names`` with their ``sizes``,
    ``ranks`` listed row-major. ``shape`` is ``{axis: size}``, as a
    :class:`jax.sharding.Mesh`'s."""

    axis_names: tuple
    sizes: tuple
    ranks: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def devices(self) -> np.ndarray:
        """The ranks as an array shaped like the grid (the reference's
        ``Mesh.devices``)."""
        return np.asarray(self.ranks).reshape(self.sizes)

    def coords(self, r: Optional[int] = None) -> dict:
        """``{axis: index}`` of rank ``r`` (default: this process's) on
        the grid."""
        r = rank() if r is None else int(r)
        if r not in self.ranks:
            raise ValueError(f"rank {r} is not on the grid {self.shape}")
        flat = self.ranks.index(r)
        return dict(zip(self.axis_names,
                        np.unravel_index(flat, self.sizes)))

    def index(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an axis the grid
        lacks, as the reference's ``axis_index`` of a unit axis)."""
        if axis not in self.axis_names:
            return 0
        return int(self.coords()[axis])

    def axis_ranks(self, axis: str, r: Optional[int] = None) -> tuple:
        """The ranks that share every coordinate of rank ``r`` (default:
        this process's) but ``axis``, in ``axis`` order: its group along
        ``axis``."""
        r = rank() if r is None else int(r)
        if axis not in self.axis_names:
            return (r,)
        grid = self.devices
        c = self.coords(r)
        idx = tuple(slice(None) if a == axis else int(c[a])
                    for a in self.axis_names)
        return tuple(int(x) for x in grid[idx].reshape(-1))

    def bind(self) -> "RankMesh":
        """Create the subgroups of every axis (once a grid; every rank of
        the group must call it, in the same order as its other
        collectives). Without a process group, or on a grid of one rank,
        there is nothing to create. A grid over fewer ranks than the group
        holds raises: each rank runs one slot of the grid."""
        key = (self.axis_names, self.sizes, self.ranks)
        with _BIND_LOCK:
            if key in _BOUND:
                return self
            if group_active():
                if self.size != world_size():
                    raise ValueError(
                        f"mesh {self.shape} covers {self.size} of the "
                        f"group's {world_size()} ranks; each rank runs one "
                        "slot of the grid, so its axes' sizes must multiply "
                        "to the rank count")
                groups = {}
                for axis in self.axis_names:
                    others = [a for a in self.axis_names if a != axis]
                    sizes = [self.shape[a] for a in others]
                    for combo in itertools.product(*map(range, sizes)):
                        fixed = dict(zip(others, combo))
                        idx = tuple(slice(None) if a == axis
                                    else fixed[a] for a in self.axis_names)
                        members = tuple(int(x) for x in
                                        self.devices[idx].reshape(-1))
                        pg = dist.new_group(list(members))
                        if rank() in members:
                            groups[axis] = pg
                _BOUND[key] = groups
            else:
                _BOUND[key] = {}
        return self

    def group(self, axis: str) -> "AxisGroup":
        """This rank's :class:`AxisGroup` along ``axis`` (binds the grid
        on first use; a trivial group for an axis the grid lacks)."""
        self.bind()
        members = self.axis_ranks(axis)
        pg = _BOUND[(self.axis_names, self.sizes, self.ranks)].get(axis)
        return AxisGroup(axis, members, self.index(axis), pg)

    def groups(self) -> dict:
        """``{axis: AxisGroup}`` for every axis of the grid."""
        return {a: self.group(a) for a in self.axis_names}


_BIND_LOCK = threading.Lock()
#: (axis_names, sizes, ranks) -> {axis: this rank's process group}
_BOUND: dict = {}


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """This rank's subgroup along one axis of a :class:`RankMesh`:
    ``ranks`` in axis order, ``index`` this rank's place in them, ``pg``
    the ``torch.distributed`` group (None without a process group)."""

    name: str
    ranks: tuple
    index: int
    pg: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def trivial(self) -> bool:
        """One rank on the axis: every collective on it is the
        identity."""
        return self.size == 1 or self.pg is None


_AMBIENT = threading.local()


def ambient() -> dict:
    """The axes an engine set for the code it runs (:func:`axis_context`):
    ``{axis: AxisGroup}``, empty outside any engine."""
    return getattr(_AMBIENT, "axes", {})


def ambient_group(axis: str) -> Optional[AxisGroup]:
    """The ambient :class:`AxisGroup` along ``axis`` (None when unset)."""
    return ambient().get(axis)


def global_batch_group() -> Optional[AxisGroup]:
    """The ambient ``data`` group over which a module's batch-wide
    statistics are global (``axis_context(global_batch=...)``): set by the
    GSPMD engine, whose JAX counterpart runs the module on the whole
    batch. None: every batch statistic is this rank's own."""
    return getattr(_AMBIENT, "global_batch", None)


@contextlib.contextmanager
def axis_context(groups: dict, global_batch: Optional[AxisGroup] = None):
    """Set ``groups`` (``{axis: AxisGroup}``) as the ambient axes for the
    code inside (this thread), and ``global_batch`` as the
    :func:`global_batch_group`, restoring the previous ones after."""
    prev = (getattr(_AMBIENT, "axes", {}),
            getattr(_AMBIENT, "global_batch", None))
    _AMBIENT.axes = dict(groups)
    _AMBIENT.global_batch = global_batch
    try:
        yield
    finally:
        _AMBIENT.axes, _AMBIENT.global_batch = prev


def _ranks(devices: Optional[Sequence[int]]) -> list:
    return list(devices) if devices is not None else list(range(world_size()))


def data_mesh(num_workers: Optional[int] = None,
              devices: Optional[Sequence[int]] = None) -> RankMesh:
    """A 1-D grid over the ``data`` axis, the default for every trainer.
    ``num_workers`` takes the first N ranks (of ``devices``, a list of
    ranks; default every rank of the group)."""
    devs = _ranks(devices)
    if num_workers is not None:
        if num_workers > len(devs):
            raise ValueError(
                f"num_workers={num_workers} exceeds available devices "
                f"({len(devs)})")
        devs = devs[:num_workers]
    return RankMesh((DATA_AXIS,), (len(devs),), tuple(devs))


def hybrid_mesh(axis_sizes: dict,
                devices: Optional[Sequence[int]] = None) -> RankMesh:
    """An N-D grid from ``{axis_name: size}``; one size may be -1
    (inferred). ``hybrid_mesh({'data': -1, 'model': 2})`` over 8 ranks is
    4x2. Axis order follows dict order."""
    devs = _ranks(devices)
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if len(devs) % known != 0:
            raise ValueError(f"{len(devs)} devices not divisible by {known}")
        sizes[sizes.index(-1)] = len(devs) // known
    total = math.prod(sizes)
    if total > len(devs):
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {len(devs)}")
    return RankMesh(tuple(names), tuple(sizes), tuple(devs[:total]))


def workers_per_rank(num_workers: int) -> int:
    """``m``, the logical workers each rank carries: the reference
    trainers' ``_mesh`` rule with ranks for chips. W equal to the rank
    count is one a rank; a multiple of it is W / ranks a rank; any other W
    raises. Without a group every worker is on the one rank."""
    w, ranks = int(num_workers), world_size()
    if w < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    if w < ranks:
        raise ValueError(
            f"num_workers={w} is fewer than the {ranks} ranks of the process "
            "group: a rank would carry no worker, yet every rank joins each "
            f"fold's all-reduce; use a multiple of {ranks}")
    if w % ranks:
        raise ValueError(
            f"num_workers={w} exceeds the {ranks} available ranks and does "
            f"not divide evenly onto them; use a multiple of {ranks} (m "
            "workers per rank) or the rank count")
    return w // ranks


def local_worker_ids(num_workers: int) -> list:
    """Global logical worker ids this rank carries: ``[rank*m,
    (rank+1)*m)``, the unit of the sharded data plane's locality."""
    m = workers_per_rank(num_workers)
    r = rank()
    return list(range(r * m, (r + 1) * m))


def put_global(tree, device: Union[str, torch.device, None] = None):
    """Every rank holds the same host value (the data plane's contract: a
    deterministic plan, init or batch); each moves it to its own device,
    ``device`` or the rank's (:func:`rank_device`; the card without a
    group). Leaves that are arrays or tensors become tensors there; other
    leaves pass through. Dicts, lists and tuples keep their structure."""
    dev = resolve_device(device if device is not None else rank_device())

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
            return type(x)(one(v) for v in x)
        if isinstance(x, (np.ndarray, torch.Tensor)):
            return torch.as_tensor(x).to(dev)
        return x

    return one(tree)
