"""netps — the networked parameter server of the port, with its center on
the card (the JAX package's ``netps``; frames byte-compatible both ways).

* :mod:`~distkeras_tpu_torch.netps.wire` — length-prefixed,
  crc-checksummed binary frames with magic/version/size checks, request-id
  echo and the per-tensor delta codecs (``DKTPU_NET_COMPRESS=bf16|int8``);
* :mod:`~distkeras_tpu_torch.netps.server` — :class:`PSServer`: one
  handler thread per connection, idempotent ``(worker_id, seq)`` commits,
  lease-based elastic membership, graceful drain; the center is f32
  tensors on ``device`` and each commit folds into it in one launch of the
  CUDA fold kernel (``ops/kernels/fold.py``), on the server's own stream;
* :mod:`~distkeras_tpu_torch.netps.client` — :class:`PSClient`: deadline
  per RPC, bounded retries with full-jitter backoff, reconnect on failure,
  automatic rejoin after eviction, codec negotiation and the int8
  error-feedback residual;
* :mod:`~distkeras_tpu_torch.netps.fold` — the fold's discipline
  semantics, the commit's staging (one packed, pinned buffer) and the
  numpy oracle;
* :mod:`~distkeras_tpu_torch.netps.remote` — the worker loop the async
  trainers run under ``remote="host:port"``;
* :mod:`~distkeras_tpu_torch.netps.endpoints` — the failover walk every
  wire client rides;
* :mod:`~distkeras_tpu_torch.netps.state` — the durable center: journal,
  snapshots, recovery folded on the card (``state_dir=``);
* :mod:`~distkeras_tpu_torch.netps.standby` — :class:`StandbyServer`: a
  warm standby tailing the primary, promotion and the epoch fence;
* :mod:`~distkeras_tpu_torch.netps.shm` — the same-host shared-memory ring
  (``DKTPU_NET_TRANSPORT=shm``): payloads in memory segments, a doorbell
  on a Unix-domain socket;
* :mod:`~distkeras_tpu_torch.netps.mesh` — the same-process dialect
  (``DKTPU_NET_TRANSPORT=mesh``): an in-process dispatch into the server's
  device center; :class:`MeshFolder` is the center's fold as a standalone
  entry.

``python -m distkeras_tpu_torch.netps`` runs a standalone server.
"""

from distkeras_tpu_torch.netps.client import CommitResult, PSClient
from distkeras_tpu_torch.netps.errors import (
    EpochFencedError,
    LeaseExpiredError,
    NetPSError,
    NotPrimaryError,
    ProtocolError,
    RPCTimeoutError,
    ServerClosedError,
    ServerDrainingError,
)
from distkeras_tpu_torch.netps.fold import commit_scale, fold_delta
from distkeras_tpu_torch.netps.mesh import (MeshFolder, local_mesh_id,
                                            mesh_available)
from distkeras_tpu_torch.netps.server import PSServer
from distkeras_tpu_torch.netps.shm import (TRANSPORTS, ShmConnection,
                                           local_boot_id, transport_mode)
from distkeras_tpu_torch.netps.standby import StandbyServer

__all__ = [
    "CommitResult", "EpochFencedError", "LeaseExpiredError", "MeshFolder",
    "NetPSError", "NotPrimaryError", "PSClient", "PSServer", "ProtocolError",
    "RPCTimeoutError", "ServerClosedError", "ServerDrainingError",
    "ShmConnection", "StandbyServer", "TRANSPORTS", "commit_scale",
    "fold_delta", "local_boot_id", "local_mesh_id", "mesh_available",
    "transport_mode",
]
