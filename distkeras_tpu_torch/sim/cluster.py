"""Simulated data plane built on the REAL counter rules.

:class:`SimCenter` is the simulator's parameter-server stand-in. "Stand-
in" covers the transport only — the semantics are the production ones,
imported, not imitated:

* staleness comes from :func:`distkeras_tpu_torch.netps.fold.counter_staleness`
  (the server's update counter minus the committer's pull-time counter,
  per-shard tuples reduced by the MIN rule) — the exact function
  ``PSServer._fold_locked`` calls;
* every applied commit is folded into a one-float host center with the
  production scale (:func:`~distkeras_tpu_torch.netps.fold.commit_scale`,
  DynSGD's ``1/(staleness+1)``) in the reference fold's f32 arithmetic
  (the JAX package's numpy ``fold_delta``: ``c += scale * d``), so the
  center value doubles as an exactly-once witness:
  for downpour, ``center == applied_commits * delta`` to the last bit —
  a duplicate that slipped past dedup would show up as a fold;
* per-wid ``last_seq`` dedup and the ``commit_log`` mirror the server's
  exactly-once bookkeeping; :meth:`SimCenter.promote` is a failover
  (epoch bump, dedup state carried — the standby's guarantee).

:class:`SimAggregator` mirrors the hier aggregator's fold-side rules
(``netps.hier.AggregatorServer._fold_locked``): accumulate deltas,
forward the MIN of the folded commits' pull counters (staleness can only
be overstated), flush upstream on fan-in or age. :class:`TreeTopology`
wires N levels of them (host -> pool -> region -> root) with per-link
latency/codec classes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from distkeras_tpu_torch.netps.fold import (
    check_discipline,
    commit_scale,
    counter_scalar,
    counter_staleness,
)


def fold_host(center: np.ndarray, delta: np.ndarray, discipline: str,
              staleness: int) -> None:
    """Fold one plain f32 commit into a host ``center`` in place: the
    reference fold's arithmetic for an uncompressed entry (``c += scale *
    d``, the product rounded to f32 before the add). The simulator's
    centers stay on the host: one float, thousands of commits a scenario,
    where staging each commit for the port's device fold would cost more
    than the scenario itself."""
    center += commit_scale(discipline, staleness) * delta


class SimCenter:
    """One (possibly sharded) center; see the module docstring."""

    def __init__(self, discipline: str = "downpour", shards: int = 1):
        self.discipline = check_discipline(discipline)
        self.shards = max(1, int(shards))
        self._center = [np.zeros(1, np.float32)]
        self._updates = [0] * self.shards
        self._last_seq: Dict[int, int] = {}
        self.epoch = 0
        self.epoch_history: List[int] = [0]
        self.commit_log: List[Tuple[int, int, int]] = []
        self.commits_total = 0
        self.duplicates = 0
        self.max_staleness = 0

    def pull(self):
        """The pull-time counter a committer carries: per-shard tuple for
        a sharded center (the MIN rule reduces it at fold time), plain
        int otherwise."""
        if self.shards > 1:
            return tuple(self._updates)
        return self._updates[0]

    def updates(self):
        return self.pull()

    def commit(self, wid: int, seq: int, pulled, value: float = 1.0) -> dict:
        """One commit: real dedup, real staleness rule, real fold."""
        if seq <= self._last_seq.get(wid, -1):
            self.duplicates += 1
            return {"applied": False, "duplicate": True, "staleness": None}
        staleness = counter_staleness(
            self._updates if self.shards > 1 else self._updates[0], pulled)
        fold_host(self._center[0], np.full(1, value, np.float32),
                  self.discipline, staleness)
        self._last_seq[wid] = seq
        for i in range(self.shards):
            self._updates[i] += 1
        self.commit_log.append((wid, seq, staleness))
        self.commits_total += 1
        self.max_staleness = max(self.max_staleness, staleness)
        return {"applied": True, "duplicate": False, "staleness": staleness}

    def promote(self) -> int:
        """Failover: the standby takes over — epoch bumps (fencing), the
        dedup map and counters carry (replication keeps them warm)."""
        self.epoch += 1
        self.epoch_history.append(self.epoch)
        return self.epoch

    def center_value(self) -> float:
        return float(self._center[0][0])

    def distinct_commits(self) -> int:
        return len({(w, s) for w, s, _st in self.commit_log})

    def exactly_once(self) -> bool:
        """The invariant every scenario asserts: applied == distinct
        (wid, seq) — nothing double-folded, nothing silently dropped."""
        return self.commits_total == self.distinct_commits()


class LinkClass:
    """One link tier of the aggregation tree: a base one-way latency, a
    lognormal jitter (sigma in log space), and a codec class whose
    per-hop encode/decode cost rides the latency. Sampled from the
    engine RNG — deterministic under a seed."""

    #: codec -> per-hop transform cost factor over the base latency
    #: (none: raw f32; bf16: truncate-only; int8: quantize + scale).
    CODEC_COST = {"none": 0.0, "bf16": 0.10, "int8": 0.25}

    def __init__(self, name: str, latency_s: float, jitter: float = 0.10,
                 codec: str = "none"):
        if codec not in self.CODEC_COST:
            raise ValueError(f"unknown codec {codec!r} for link {name!r}")
        self.name = name
        self.latency_s = float(latency_s)
        self.jitter = float(jitter)
        self.codec = codec
        #: partition windows: (t0, t1) intervals during which the link
        #: blackholes traffic (scenario-controlled).
        self.partitions: List[Tuple[float, float]] = []

    def sample(self, engine) -> float:
        import math

        base = self.latency_s * (1.0 + self.CODEC_COST[self.codec])
        if self.jitter <= 0.0 or base <= 0.0:
            return base
        return engine.lognormal(math.log(base), self.jitter,
                                cap=10.0 * base)

    def partition(self, t0: float, t1: float) -> None:
        self.partitions.append((float(t0), float(t1)))

    def is_down(self, t: float) -> bool:
        return any(a <= t < b for a, b in self.partitions)

    def heals_at(self, t: float) -> float:
        """The end of the partition window covering ``t`` (or ``t``)."""
        for a, b in self.partitions:
            if a <= t < b:
                return b
        return t


class SimAggregator:
    """One aggregation-tree node: the hier fold-side rules."""

    def __init__(self, name: str, fan_in: int, flush_s: float,
                 uplink: Optional[LinkClass] = None):
        self.name = name
        self.fan_in = max(1, int(fan_in))
        self.flush_s = float(flush_s)
        self.uplink = uplink
        self._acc_value = 0.0
        self._acc_pulled: Optional[int] = None
        self._acc_count = 0
        self._acc_t0: Optional[float] = None
        self.flushes = 0

    def fold(self, t: float, pulled, value: float) -> Optional[dict]:
        """Absorb one downstream commit; returns a flush payload when the
        flush policy (fan-in reached OR age > flush interval — the real
        ``_take_acc_locked`` policy) trips at this arrival."""
        pulled = counter_scalar(pulled)
        self._acc_value += value
        self._acc_count += 1
        # The hier MIN rule: the forwarded pull counter is the MIN over
        # the folded commits' counters — overstating staleness is safe,
        # understating would let DynSGD under-discount.
        self._acc_pulled = (pulled if self._acc_pulled is None
                            else min(self._acc_pulled, pulled))
        if self._acc_t0 is None:
            self._acc_t0 = t
        if (self._acc_count >= self.fan_in
                or t - self._acc_t0 >= self.flush_s):
            return self.take(t)
        return None

    def take(self, t: float) -> Optional[dict]:
        """Drain the accumulation as one upstream commit payload."""
        if self._acc_count == 0:
            return None
        out = {"value": self._acc_value, "pulled": self._acc_pulled,
               "count": self._acc_count, "t": t}
        self._acc_value, self._acc_pulled = 0.0, None
        self._acc_count, self._acc_t0 = 0, None
        self.flushes += 1
        return out

    def pending(self) -> int:
        return self._acc_count


class TreeTopology:
    """An N-level aggregation tree over ``workers`` leaves.

    ``levels`` is a bottom-up spec ``[(name, fanout, LinkClass), ...]``
    — e.g. host (fanout 8) -> pool (fanout 4) -> region (fanout N) —
    with the last level's uplink feeding the root center. Workers are
    assigned to leaf groups contiguously, so worker w's path is derived,
    not stored: level-k group index is ``w // prod(fanouts[:k+1])``."""

    def __init__(self, workers: int,
                 levels: Sequence[Tuple[str, int, LinkClass]],
                 flush_s: float = 0.02):
        self.workers = int(workers)
        self.levels = list(levels)
        self.flush_s = float(flush_s)
        self.aggregators: List[Dict[int, SimAggregator]] = []
        self._partitions: Dict[Tuple[int, int],
                               List[Tuple[float, float]]] = {}
        group = self.workers
        stride = 1
        for name, fanout, link in self.levels:
            stride *= int(fanout)
            group = (self.workers + stride - 1) // stride
            tier = {}
            for g in range(group):
                tier[g] = SimAggregator(
                    f"{name}-{g}", fan_in=int(fanout),
                    flush_s=self.flush_s, uplink=link)
            self.aggregators.append(tier)

    def partition(self, level: int, group: int, t0: float,
                  t1: float) -> None:
        """Black-hole one group's uplink at ``level`` for ``[t0, t1)``.

        LinkClass objects are shared per level (they model the link
        *tier*), so partitions are keyed here per (level, group)."""
        self._partitions.setdefault((int(level), int(group)), []).append(
            (float(t0), float(t1)))

    def link_down(self, level: int, group: int, t: float) -> bool:
        return any(a <= t < b for a, b in
                   self._partitions.get((int(level), int(group)), ()))

    def heals_at(self, level: int, group: int, t: float) -> float:
        """End of the partition window covering ``t`` (or ``t``)."""
        for a, b in self._partitions.get((int(level), int(group)), ()):
            if a <= t < b:
                return b
        return t

    def group_of(self, worker: int, level: int) -> int:
        stride = 1
        for _name, fanout, _link in self.levels[:level + 1]:
            stride *= int(fanout)
        return worker // stride

    def path(self, worker: int) -> List[SimAggregator]:
        """The worker's aggregator chain, leaf-most first."""
        return [self.aggregators[lvl][self.group_of(worker, lvl)]
                for lvl in range(len(self.levels))]

    def level_links(self, level: int) -> LinkClass:
        return self.levels[level][2]
