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
  entry;
* :mod:`~distkeras_tpu_torch.netps.chaos` — :class:`ChaosProxy`: a
  frame-aware TCP proxy that delays, drops, duplicates, truncates and
  partitions frames on the ``DKTPU_NET_FAULTS`` schedule;
* :mod:`~distkeras_tpu_torch.netps.hier` — :class:`AggregatorServer`: the
  per-host aggregator (``DKTPU_NET_HIER``) that pre-combines its workers'
  commits on its device (one fold launch a commit) and forwards one
  combined commit upstream a flush;
* :mod:`~distkeras_tpu_torch.netps.tree` — N-level aggregation trees
  (:class:`TreeSpec`, :class:`TreeNode`, :class:`TreeStandby`,
  :func:`build_tree`): partition ride-through, typed drops, link faults
  and demotion, and the window-conservation ledger;
* :mod:`~distkeras_tpu_torch.netps.shards` — the sharded center: a
  :class:`PartitionPlan` over N shard servers (:class:`ShardSet` in one
  process, ``--shard K/N`` one a process), dialed through
  :class:`ShardedPSClient` (:func:`make_ps_client` picks the client from
  the endpoint's shape);
* :mod:`~distkeras_tpu_torch.netps.tuner` — the self-tuning data plane
  (``DKTPU_NET_AUTOTUNE=1``): join-time codec probes over the negotiated
  connection (the server decodes each probe as a commit, on the card, into
  a scratch window) and an online :class:`Tuner` that retunes
  compression, the overlap window, striping and the aggregator's fan-in
  mid-run through the renegotiation paths a rejoin uses, guardrailed
  (floors, a bounded retune rate, an oscillation fallback, failover
  deferral); :class:`MarginalThroughputPolicy` gates elastic expansion.

``python -m distkeras_tpu_torch.netps`` runs a standalone server.
"""

from distkeras_tpu_torch.netps.chaos import ChaosProxy
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
    ShardPlanError,
)
from distkeras_tpu_torch.netps.fold import commit_scale, fold_delta
from distkeras_tpu_torch.netps.hier import AggregatorServer
from distkeras_tpu_torch.netps.mesh import (MeshFolder, local_mesh_id,
                                            mesh_available)
from distkeras_tpu_torch.netps.server import PSServer
from distkeras_tpu_torch.netps.shards import (PartitionPlan, ShardedPSClient,
                                              ShardSet, make_ps_client)
from distkeras_tpu_torch.netps.shm import (TRANSPORTS, ShmConnection,
                                           local_boot_id, transport_mode)
from distkeras_tpu_torch.netps.standby import StandbyServer
from distkeras_tpu_torch.netps.tree import (TreeDeployment, TreeNode,
                                            TreeSpec, TreeStandby,
                                            build_tree)
from distkeras_tpu_torch.netps.tuner import (MarginalThroughputPolicy,
                                             Tuner, TunerConfig,
                                             probe_codecs,
                                             recommended_topology)

__all__ = [
    "AggregatorServer", "ChaosProxy", "CommitResult", "EpochFencedError",
    "LeaseExpiredError", "MarginalThroughputPolicy", "MeshFolder",
    "NetPSError", "NotPrimaryError", "PSClient", "PSServer",
    "PartitionPlan", "ProtocolError", "RPCTimeoutError", "ServerClosedError",
    "ServerDrainingError", "ShardPlanError", "ShardSet", "ShardedPSClient",
    "ShmConnection", "StandbyServer", "TRANSPORTS", "TreeDeployment",
    "TreeNode", "TreeSpec", "TreeStandby", "Tuner", "TunerConfig",
    "build_tree", "commit_scale", "fold_delta", "local_boot_id",
    "local_mesh_id", "make_ps_client", "mesh_available", "probe_codecs",
    "recommended_topology", "transport_mode",
]
