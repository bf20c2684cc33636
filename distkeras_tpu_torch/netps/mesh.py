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

A center over more than one card, and with it the partition plan as a
device layout (the JAX package's ``PartitionPlan.to_partition_specs``
feeding its multi-device folder), is not ported (ROADMAP Queue 1 item
5). A shard server of the sharded center (``netps/shards/``) serves the
mesh dialect like any server: its slice is its center.
"""

from __future__ import annotations

import contextlib
import os
import threading
import uuid
from typing import Optional, Sequence, Union

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

class MeshFolder:
    """A center of its own on ``device`` (None: the card; raises without
    one) as f32 views of one flat tensor, folded one ``fold_commit`` launch
    a commit: the fold a server runs, as a standalone entry.

    Construction seats ``center`` (host f32 arrays) on the device, on a
    stream of its own at the highest priority, with commits staged through
    a pinned pool of its own. :meth:`fold` consumes a wire-form commit
    (plain arrays or ``(array, spec)`` codec pairs) or a commit already
    staged; :meth:`center_host` is the lazily synced host mirror. Not
    thread-safe.
    """

    def __init__(self, center: Sequence, *,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        #: ``"cuda"`` (the fold kernel) or ``"cpu"`` (its plain twin).
        self.backend = self.device.type
        self._stream = self._pool = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device,
                                             priority=STREAM_PRIORITY)
            self._pool = PinnedPool()
        with self._on_stream():
            self.flat, self.offsets, self.views = seat_center(center,
                                                              self.device)
        self._host: Optional[list] = None
        self.folds = 0

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def fold(self, delta, scale: float) -> None:
        """Fold one wire-form commit into the device center in place
        (:func:`~distkeras_tpu_torch.netps.fold.fold_staged`): ``scale`` is
        the discipline's commit scale, the conservation check runs before
        the launch. Staging (one packed buffer, one copy to the device) and
        the launch run on the folder's stream."""
        with self._on_stream():
            fold_staged(self.views,
                        stage_commit(delta, self.device, self._pool), scale)
        self._host = None
        self.folds += 1

    def center_host(self) -> list:
        """The host f32 mirror, synced lazily: one device-to-host copy
        after any number of folds, read-only arrays."""
        if self._host is None:
            self._host = host_mirror(self.flat, self.offsets, self.views,
                                     self._stream)
        return self._host

    def close(self) -> None:
        self.views = []
        self.flat = None
        self._host = None
