"""The ``mesh`` transport dialect: same-process peers fold straight into the
server's device center (the port's counterpart of the JAX package's
``netps/mesh.py``).

The port's center lives on the card in every dialect (``PSServer(device=)``
seats it as f32 views of one flat tensor and folds each commit with one
launch of the fold kernel). What this dialect removes is the wire between
a worker and a server in ONE process:

* **Dispatch is a direct in-process call.** A mesh server registers its
  serve function under an opaque token (:func:`register`) and advertises
  ``caps["mesh"] = {"proc", "token", "devices", "backend"}`` in its join
  reply. A client asking for ``DKTPU_NET_TRANSPORT=mesh`` upgrades only
  when ``proc`` equals :func:`local_mesh_id` (same host, same process),
  then hands its wire-form commit (the ``(array, spec)`` pairs a frame
  would carry) straight to :func:`dispatch`: no frame, no socket, no crc.
  The request still crosses the server's op dispatch (dedup, lease, epoch
  fence, journal), under its lock.
* **The fold is the server's.** A mesh server seats its center and folds
  every commit, whatever its dialect, as every server does: ``fold_delta``
  on the device center, one ``fold_commit`` launch a commit after the
  element-count conservation check. What the dialect adds is the counter
  ``netps.mesh.folds``: the commits folded that came through the dispatch.
  :class:`MeshFolder` is the same fold as a standalone entry (a center of
  its own on the card, what the bit tests and ``chip_smoke.py`` hold to the
  numpy oracle): the counterpart of the reference's traced fold
  (``ops/pallas/fold.py fold_traced``, which runs the fold kernel inside a
  collective over the device mesh); with one card the collective is the
  single launch.
* **The proc token tells the runtimes apart.** A torch runtime and a JAX
  runtime in one process share no device buffers, so the port's token is
  prefixed ``torch:``: a JAX client never upgrades against a port server,
  nor a port client against a JAX one, and both land on the ring the
  same join negotiated.
* **Demotion, not failure.** A token that is gone (server closed) raises
  ``ConnectionError`` from :func:`dispatch`; the client demotes to the
  shm ring or TCP (a mesh server serves both) and retransmits under the
  same seq, which the server's dedup keeps exactly-once. The ladder moves
  the transport only: the center stays on the card and a fold that fails
  there raises, in every dialect.

A center over several devices: ``MeshFolder(center, devices=[...])``
splits each tensor along axis 0 over the devices where their count
divides it, and replicates it elsewhere (``parallel/sharding.py
restrict_spec``, as the JAX folder's ``_tensor_specs``); a partition plan
(``PartitionPlan.to_partition_specs``) gives the layout instead, one
declaration for the sharded center and the device-resident one. Each
device folds its shard of every commit with one ``fold_commit`` launch
on its own stream. A shard server of the sharded center
(``netps/shards/``) serves the mesh dialect like any server: its slice is
its center.
"""

from __future__ import annotations

import contextlib
import os
import threading
import uuid
from typing import Optional, Sequence, Union

import numpy as np
import torch

from distkeras_tpu_torch.netps import shm, wire
from distkeras_tpu_torch.netps.fold import (STREAM_PRIORITY, PinnedPool,
                                            fold_staged, host_mirror,
                                            seat_center, stage_commit)
from distkeras_tpu_torch.resilience import faults as _faults
from distkeras_tpu_torch.runtime.device import resolve_device


def local_mesh_id() -> str:
    """The same-runtime identity for mesh negotiation: device tensors are
    shareable only within one torch runtime, one process on one kernel.
    The ``torch:`` prefix keeps it apart from the JAX package's token."""
    return f"torch:{shm.local_boot_id()}:{os.getpid()}"


def mesh_available(device: Optional[Union[str, torch.device]] = None
                   ) -> bool:
    """Whether this process can seat a mesh center on ``device`` (None:
    the card). Never raises."""
    try:
        resolve_device(device)
        return True
    except (RuntimeError, ValueError):
        return False


# ---------------------------------------------------------------------------
# The in-process dispatch registry
# ---------------------------------------------------------------------------
#
# A mesh server registers its serve function under an opaque token and
# advertises the token in its join reply. Dispatch is the whole data path:
# the client's thread calls the server's transport-independent dispatch
# directly (the server's center lock serializes folds exactly as it does
# for socket handler threads). A token that is gone raises
# ConnectionError, which is what the client's demotion catches.

_REG_LOCK = threading.Lock()
_SERVERS: dict = {}


def register(serve_fn) -> str:
    """Register a mesh server's serve function; returns its token."""
    token = uuid.uuid4().hex
    with _REG_LOCK:
        _SERVERS[token] = serve_fn
    return token


def unregister(token: Optional[str]) -> None:
    with _REG_LOCK:
        _SERVERS.pop(token, None)


def dispatch(token: str, header: dict, arrays: list):
    """One direct request against a registered mesh server: returns the
    ``(reply_header, reply_arrays)`` pair a wire frame would have carried.
    Raises ``ConnectionError`` when the peer is gone or refused the
    request, or when the ``mesh_down@R`` fault drill fires for commit seq
    R: each looks like device loss to the caller, which demotes and does
    not read an error reply."""
    with _REG_LOCK:
        fn = _SERVERS.get(token)
    if fn is None:
        raise ConnectionError("mesh peer is gone (server closed)")
    plan = _faults.active_net_plan()
    if plan is not None and header.get("op") == wire.OP_COMMIT:
        if plan.fire("mesh_down", int(header.get("seq", 0))) is not None:
            raise ConnectionError("injected mesh_down: device mesh lost")
    served = fn(dict(header), list(arrays))
    if served is None:
        raise ConnectionError("mesh peer refused the request")
    return served


# ---------------------------------------------------------------------------
# The device center's fold entry
# ---------------------------------------------------------------------------

#: the folder's one device axis (the JAX folder's ``MESH_AXIS``)
MESH_AXIS = "fold"


class _Seat:
    """One device's part of a :class:`MeshFolder`: its shards of the
    center, seated as f32 views of one flat tensor on its own stream."""

    def __init__(self, arrays: list, device: torch.device):
        self.device = device
        self.stream = self.pool = None
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device, priority=STREAM_PRIORITY)
            self.pool = PinnedPool()
        with self.on_stream():
            self.flat, self.offsets, self.views = seat_center(arrays, device)

    def on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def host(self) -> list:
        return host_mirror(self.flat, self.offsets, self.views, self.stream)


class MeshFolder:
    """A center of its own on ``device`` (None: the card; raises without
    one) as f32 views of one flat tensor, folded one ``fold_commit`` launch
    a commit: the fold a server runs, as a standalone entry.

    With ``devices=[...]`` the center spans several devices: each tensor
    is split along axis 0 over them where their count divides it (or as
    ``plan``, a :class:`~distkeras_tpu_torch.netps.shards.plan.
    PartitionPlan`, lays it out) and replicated elsewhere; each device
    folds its shards, one launch a device. The same device may appear
    more than once (two shards on one card).

    Construction seats ``center`` (host f32 arrays) on the device, on a
    stream of its own at the highest priority, with commits staged through
    a pinned pool of its own. :meth:`fold` consumes a wire-form commit
    (plain arrays or ``(array, spec)`` codec pairs) or, on one device, a
    commit already staged; :meth:`center_host` is the lazily synced host
    mirror. Not thread-safe.
    """

    def __init__(self, center: Sequence, *,
                 device: Optional[Union[str, torch.device]] = None,
                 devices: Optional[Sequence] = None, plan=None):
        devs = ([resolve_device(d) for d in devices] if devices
                else [resolve_device(device)])
        self.devices = devs
        self.num_devices = len(devs)
        self.device = devs[0]
        #: ``"cuda"`` (the fold kernel) or ``"cpu"`` (its plain twin).
        self.backend = self.device.type
        arrays = [np.asarray(a, np.float32) for a in center]
        self._shapes = [tuple(a.shape) for a in arrays]
        self._specs = self._tensor_specs(plan)
        self._seats = [
            _Seat([self._part(a, sp, k)
                   for a, sp in zip(arrays, self._specs)], dev)
            for k, dev in enumerate(devs)]
        first = self._seats[0]
        self._stream, self._pool = first.stream, first.pool
        self.flat, self.offsets, self.views = (first.flat, first.offsets,
                                               first.views)
        self._host: Optional[list] = None
        self.folds = 0

    # -- layout --------------------------------------------------------------
    def _tensor_specs(self, plan) -> list:
        """Per-tensor specs over the one ``fold`` axis: the plan's rules
        when given, else axis 0 split where the device count is at most
        its length; either way clamped by ``restrict_spec``, so a ragged
        dimension replicates."""
        from distkeras_tpu_torch.parallel.sharding import Spec, restrict_spec
        from distkeras_tpu_torch.runtime.mesh import RankMesh

        n = self.num_devices
        if plan is not None and len(plan.names) == len(self._shapes):
            base = [spec for _pat, spec in plan.to_partition_specs(MESH_AXIS)]
        else:
            base = [Spec(MESH_AXIS) if s and int(s[0]) >= n else Spec()
                    for s in self._shapes]
        grid = RankMesh((MESH_AXIS,), (n,), tuple(range(n)))
        return [restrict_spec(sp, grid, shape=s)
                for sp, s in zip(base, self._shapes)]

    def _split(self, spec) -> bool:
        return self.num_devices > 1 and any(a is not None for a in spec)

    def _part(self, a: np.ndarray, spec, k: int) -> np.ndarray:
        """Device ``k``'s part of a tensor (or of a commit's entry)."""
        if not self._split(spec):
            return a
        rows = a.shape[0] // self.num_devices
        return a[k * rows:(k + 1) * rows]

    def _entry_part(self, entry, shape, spec, k: int):
        if isinstance(entry, tuple):
            q, extras = entry
            q = np.asarray(q).reshape(shape)
            return (np.ascontiguousarray(self._part(q, spec, k)), extras)
        a = np.asarray(entry).reshape(shape)
        return np.ascontiguousarray(self._part(a, spec, k))

    def _on_stream(self):
        return self._seats[0].on_stream()

    # -- the fold ------------------------------------------------------------
    def fold(self, delta, scale: float) -> None:
        """Fold one wire-form commit into the device center in place
        (:func:`~distkeras_tpu_torch.netps.fold.fold_staged`): ``scale`` is
        the discipline's commit scale, the conservation check runs before
        the launch. Staging (one packed buffer, one copy to the device) and
        the launch run on the folder's stream; over several devices every
        device's shards are staged (and checked) before any folds."""
        if self.num_devices == 1:
            with self._on_stream():
                fold_staged(self.views,
                            stage_commit(delta, self.device, self._pool),
                            scale)
        else:
            self._fold_split(delta, scale)
        self._host = None
        self.folds += 1

    def _fold_split(self, delta, scale: float) -> None:
        if len(delta) != len(self._shapes):
            raise ValueError(f"delta has {len(delta)} tensors, the center "
                             f"{len(self._shapes)}")
        for entry, shape in zip(delta, self._shapes):
            q = entry[0] if isinstance(entry, tuple) else entry
            if int(np.asarray(q).size) != int(np.prod(shape, dtype=np.int64)):
                raise RuntimeError(
                    f"mesh fold conservation check: a tensor of shape "
                    f"{shape} got {np.asarray(q).size} elements")
        staged = []
        for k, seat in enumerate(self._seats):
            parts = [self._entry_part(e, shape, sp, k) for e, shape, sp in
                     zip(delta, self._shapes, self._specs)]
            with seat.on_stream():
                staged.append(stage_commit(parts, seat.device, seat.pool))
        for seat, st in zip(self._seats, staged):
            with seat.on_stream():
                fold_staged(seat.views, st, scale)

    def center_host(self) -> list:
        """The host f32 mirror, synced lazily: one device-to-host copy a
        device after any number of folds, read-only arrays (a split
        tensor's shards joined along axis 0)."""
        if self._host is None:
            hosts = [seat.host() for seat in self._seats]
            out = []
            for i, spec in enumerate(self._specs):
                if self._split(spec):
                    a = np.concatenate([h[i] for h in hosts], axis=0)
                    a.setflags(write=False)
                else:
                    a = hosts[0][i]
                out.append(a)
            self._host = out
        return self._host

    def close(self) -> None:
        self._seats = []
        self.views = []
        self.flat = None
        self._host = None
