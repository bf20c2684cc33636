"""Analytic all-reduce scaling model for the fold and sync engines: the
port's counterpart of ``distkeras_tpu/roofline.py``.

A fold round (and a sync step) does its compute on each card, then one
all-reduce of the model-sized delta (or gradient) over the ranks
(``parallel/engine.py``, ``parallel/sync.py``). A ring all-reduce moves
``2 x S x (N-1)/N`` bytes through each card's link pair, so the round's
communication follows from the bytes and the link's rate, and the
scaling efficiency from the measured single-card round time beside it.
Efficiency is modeled with zero compute/communication overlap (the
conservative bound).

The link figures below are the vendor's specification, not measurements:
the card's machine has one H100 and no link, so none of them can be
measured there.

* NVLink 4: 900 GB/s a GPU over both directions, 450 GB/s a direction.
* NDR InfiniBand: 400 Gb/s a port, 50 GB/s a direction.
* An NVLink domain is the 8 GPUs of one HGX H100 board; past it the
  reduction crosses InfiniBand. A DGX H100 gives each GPU its own NDR
  port (8 ports for 8 GPUs), so one port carries one card's share.

The field names are the reference's (``ici_*`` is the fast link inside a
domain, ``dcn_*`` the hop between domains, ``chips_*`` cards), so a
caller written against one package reads the other.
"""

from __future__ import annotations

import dataclasses

#: NVLink 4 (H100 SXM): 450 GB/s a direction per GPU (vendor spec).
NVLINK_BYTES_PER_S = 450e9
#: NDR InfiniBand: 50 GB/s a port and direction (vendor spec). Pass as
#: ``link_bytes_per_s`` to model a fold whose slowest hop leaves the
#: NVLink domain.
IB_BYTES_PER_S = 50e9
#: GPUs in one NVLink domain (an HGX H100 board).
NVLINK_DOMAIN = 8


def allreduce_seconds(model_bytes: float, n_chips: int,
                      link_bytes_per_s: float = NVLINK_BYTES_PER_S) -> float:
    """Ring all-reduce wall time: each card sends and receives
    ``2 * S * (N-1)/N`` bytes over one link direction."""
    if n_chips <= 1:
        return 0.0
    return 2.0 * model_bytes * (n_chips - 1) / n_chips / link_bytes_per_s


@dataclasses.dataclass
class SyncStepScalingModel:
    """Per-step sync-DP scaling (BASELINE config #5: ResNet-50 under
    ``SynchronousDistributedTrainer``).

    Synchronous DP all-reduces the whole f32 gradient every optimizer step,
    with no window to amortize it. Past ``chips_per_slice`` (an NVLink
    domain) the reduction goes hierarchical: a reduce-scatter inside the
    domain leaves each card ``grad_bytes/intra`` of reduced shards, the
    exchange between domains rides the InfiniBand ports (each carrying
    ``chips_per_host`` cards' shares), then the all-gather inside the
    domain completes it; no compute/comm overlap is assumed.

    Levers: ``grad_bytes`` (bf16 gradients halve it) and ``grad_accum``
    (A micro-batches a step multiply the compute one all-reduce
    amortizes)."""

    step_seconds: float  # measured single-card optimizer-step time
    grad_bytes: float  # bytes all-reduced per step (f32 grads = 4 x params)
    ici_bytes_per_s: float = NVLINK_BYTES_PER_S
    dcn_bytes_per_s: float = IB_BYTES_PER_S
    chips_per_slice: int = NVLINK_DOMAIN  # beyond it the hop crosses IB
    chips_per_host: int = 1  # cards sharing one NDR port (DGX H100: 1)
    grad_accum: int = 1

    def comm_seconds(self, n_chips: int) -> float:
        intra = min(n_chips, self.chips_per_slice)
        t = allreduce_seconds(self.grad_bytes, intra, self.ici_bytes_per_s)
        if n_chips > self.chips_per_slice:
            slices = -(-n_chips // self.chips_per_slice)  # ceil
            per_host = self.grad_bytes / intra * self.chips_per_host
            t += (2.0 * per_host * (slices - 1) / slices
                  / self.dcn_bytes_per_s)
        return t

    def efficiency(self, n_chips: int) -> float:
        compute = self.step_seconds * self.grad_accum
        return compute / (compute + self.comm_seconds(n_chips))

    def curve(self, chips=(1, 2, 4, 8, 16, 32, 64, 128, 256)) -> list[dict]:
        return [{"num_chips": n,
                 "comm_ms": round(self.comm_seconds(n) * 1e3, 4),
                 "efficiency": round(self.efficiency(n), 4)}
                for n in chips]


@dataclasses.dataclass
class FoldScalingModel:
    """Scaling of a window-K fold discipline (AEASGD, ADAG, ...).

    ``round_seconds``: measured single-card fold-round time (compute).
    ``model_bytes``: bytes all-reduced per round (f32 delta = 4 x params).
    """

    round_seconds: float
    model_bytes: float
    link_bytes_per_s: float = NVLINK_BYTES_PER_S

    def comm_seconds(self, n_chips: int) -> float:
        return allreduce_seconds(self.model_bytes, n_chips,
                                 self.link_bytes_per_s)

    def efficiency(self, n_chips: int) -> float:
        """Predicted scaling efficiency: throughput(N) / (N x throughput(1)),
        assuming zero overlap of fold and local window."""
        return self.round_seconds / (self.round_seconds
                                     + self.comm_seconds(n_chips))

    def curve(self, chips=(1, 2, 4, 8, 16, 32, 64, 128, 256)) -> list[dict]:
        return [{"num_chips": n,
                 "comm_ms": round(self.comm_seconds(n) * 1e3, 4),
                 "efficiency": round(self.efficiency(n), 4)}
                for n in chips]
