"""Gang placement for N-level aggregation trees (the port's copy of the
JAX package's ``fleet/placement.py``).

Maps a :class:`~distkeras_tpu_torch.netps.tree.TreeSpec` onto a job's worker
hosts: every interior (level, group) node lands on the FIRST host of its
own subtree (the traffic it aggregates is already local there), its warm
standby on the NEXT host of the same subtree — region-local by
construction, so a host loss takes at most one of the pair. Ports come
from the per-host bind-probed pool (:mod:`distkeras_tpu_torch.fleet.ports`),
so a tree gang coexists with every other job on its hosts.

The placement is endpoint-complete: each node's ``upstream`` is its
parent's ``primary,standby`` failover list (the top level's is the root
endpoint the caller passes, matrix and all), and
:meth:`TreePlacement.leaf_endpoint` is what a worker's
``DKTPU_PS_ENDPOINT`` should carry. A launcher renders these into
``python -m distkeras_tpu_torch.netps --upstream ...`` launch lines
(``job_deployment.Job.render_tree_commands``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from distkeras_tpu_torch.netps.tree import TreeSpec


@dataclasses.dataclass
class NodePlacement:
    """One interior tree node's assignment: where it runs, where its warm
    standby runs, and the upstream failover list it flushes into."""

    level: int
    group: int
    host: str
    port: int
    standby_host: Optional[str]
    standby_port: Optional[int]
    #: ``primary[,standby]`` list of the PARENT (or the root endpoint for
    #: the top level) — exactly what the node's uplink client walks.
    upstream: str
    link_key: int

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def standby_endpoint(self) -> Optional[str]:
        if self.standby_host is None:
            return None
        return f"{self.standby_host}:{self.standby_port}"

    @property
    def served_endpoint(self) -> str:
        """What a CHILD of this node dials: the node first, then its
        standby — the order the EndpointWalker tries on failure."""
        sb = self.standby_endpoint
        return f"{self.endpoint},{sb}" if sb else self.endpoint


class TreePlacement:
    """The full gang: ``nodes[level][group] -> NodePlacement``."""

    def __init__(self, spec: TreeSpec, nodes: List[List[NodePlacement]]):
        self.spec = spec
        self.nodes = nodes

    def __iter__(self):
        for tier in self.nodes:
            yield from tier

    def node(self, level: int, group: int) -> NodePlacement:
        return self.nodes[level][group]

    def leaf_endpoint(self, rank: int) -> str:
        """The ``primary[,standby]`` list worker ``rank`` dials
        (``DKTPU_PS_ENDPOINT``)."""
        return self.nodes[0][self.spec.group_of(rank, 0)].served_endpoint

    def all_state_labels(self) -> List[str]:
        """Stable per-node labels (``tree-L<level>-g<group>`` plus the
        ``.standby`` twin) — the per-node state-dir suffixes a launcher
        should use, mirrored by the chaos smoke's journal sweep."""
        labels = []
        for node in self:
            labels.append(f"tree-L{node.level}-g{node.group}")
            if node.standby_host is not None:
                labels.append(f"tree-L{node.level}-g{node.group}.standby")
        return labels


def place_tree(spec, workers: int, hosts: Sequence[str],
               root_endpoint: str, standbys: bool = True,
               reserve=True) -> TreePlacement:
    """Assign every interior node of ``spec`` (and, with ``standbys``,
    its warm twin) onto ``hosts``.

    ``workers`` is the leaf count; worker ``rank`` is assumed to run on
    ``hosts[rank % len(hosts)]`` (the Job model: one process per host,
    ranks wrap). A (level, group) node goes to its subtree's first
    worker's host; the standby to the subtree's second distinct host,
    falling back to the next host in the ring when the subtree has only
    one (a 1-host subtree cannot be host-fault-tolerant — the ring
    neighbor is the closest thing). With ``reserve`` each placement takes
    a real port from the per-host pool; ``reserve=False`` renders a
    port-0 plan (tests, dry runs that must not consume the pool), and a
    callable reserves through the caller instead (``Punchcard`` passes
    its own tracker so ``release_ports`` can return the gang's ports).
    """
    from distkeras_tpu_torch.fleet.ports import reserve_port

    if callable(reserve):
        take = reserve
    elif reserve:
        take = reserve_port
    else:
        take = None
    spec = TreeSpec.parse(spec) if isinstance(spec, str) else spec
    if not hosts:
        raise ValueError("place_tree needs at least one host")
    workers = int(workers)

    def host_of(rank: int) -> str:
        return hosts[rank % len(hosts)]

    nodes: List[List[NodePlacement]] = []
    for level in range(spec.depth):
        tier: List[NodePlacement] = []
        stride = spec._stride(level)
        for group in range(spec.nodes_at(level, workers)):
            first = group * stride
            host = host_of(first)
            sb_host: Optional[str] = None
            if standbys:
                # Second distinct host inside the subtree, else the ring
                # neighbor.
                end = min(first + stride, workers)
                sb_host = next(
                    (host_of(r) for r in range(first + 1, end)
                     if host_of(r) != host),
                    hosts[(hosts.index(host) + 1) % len(hosts)])
            tier.append(NodePlacement(
                level=level, group=group, host=host,
                port=take(host) if take else 0,
                standby_host=sb_host,
                standby_port=(take(sb_host) if take and sb_host
                              else (0 if sb_host else None)),
                upstream="",  # filled below, parents first need ports
                link_key=TreeSpec.link_key(level, group)))
        nodes.append(tier)
    for level in range(spec.depth):
        for node in nodes[level]:
            if level == spec.depth - 1:
                node.upstream = root_endpoint
            else:
                parent = spec.parent_group(level, node.group)
                node.upstream = nodes[level + 1][parent].served_endpoint
    return TreePlacement(spec, nodes)
