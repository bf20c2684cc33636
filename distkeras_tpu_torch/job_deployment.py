"""Multi-host job deployment: the port's counterpart of
``distkeras_tpu/job_deployment.py`` (parity with
``distkeras/job_deployment.py``).

The reference's ``Job``/``Punchcard`` wrap "ssh to a gateway, spark-submit a
script with a JSON job description". The JAX package launches the same
script on every host with the ``jax.distributed`` coordinator environment
set. The port renders ``torch.distributed``'s rendezvous instead:
``MASTER_ADDR`` (the first host), ``MASTER_PORT`` (the card's coordinator
port), ``WORLD_SIZE`` (one rank a host line), ``RANK`` and ``LOCAL_RANK=0``
(one card a rank); each process then joins the group with
``runtime.mesh.distributed_initialize``. The parameter-server plane (the
primary, its standby, a shard gang, an aggregation tree) runs the port's
``python -m distkeras_tpu_torch.netps``.

Launching is via ssh or, for ``localhost``, a plain ``Popen``; ``dry_run``
renders the exact per-host command lines without executing.
"""

from __future__ import annotations

import dataclasses
import json
import shlex
import subprocess
import time
from typing import Optional, Sequence

from distkeras_tpu_torch.resilience.backoff import full_jitter
from distkeras_tpu_torch.telemetry import tracing


@dataclasses.dataclass
class Punchcard:
    """Portable job description (reference ``Punchcard``: the JSON job card).

    ``ps`` opts the job into a networked parameter server
    (``distkeras_tpu_torch/netps``): ``{"host": ..., "port": ...,
    "discipline": ..., "lease": ..., "device": ...}`` — ``host`` defaults
    to the first job host, ``device`` (rendered as ``--device``; the
    server's own default, the card, when unset) says where its center
    lives, and only ``ps={}`` is needed for the defaults. :class:`Job` then
    launches ``python -m distkeras_tpu_torch.netps`` on that host first and
    hands every worker the endpoint via ``DKTPU_PS_ENDPOINT``, so trainers
    constructed without an explicit ``remote=`` pick it up automatically.

    Ports: a missing ``port`` (and ``coordinator_port``, the rendezvous's
    ``MASTER_PORT``, and ``standby_port``) is allocated from the per-host
    bind-probed pool (``distkeras_tpu_torch/fleet/ports``) and pinned into the card on first
    resolution — two punchcards launched from one driver can never
    collide on a host, which fixed defaults (8476/7077/primary+1) could
    not guarantee. Explicit ports are always honored untouched.

    Durability/failover keys (all optional): ``state_dir`` gives the
    primary a durable journal+snapshot directory (``--state-dir``) so
    :meth:`Job.supervise` can cold-restart a dead PS with its center,
    counter, and dedup state intact; ``standby_host``/``standby_port``
    (port pool-allocated when unset) additionally launch a warm
    standby (``--standby``) that tails the primary's journal and promotes
    when its lease lapses — the workers' ``DKTPU_PS_ENDPOINT`` then
    carries the comma-separated ``primary,standby`` list their hardened
    clients walk on failure.

    Aggregation tree (``tree: "host:8,region:2"`` — the
    ``DKTPU_TREE_SPEC`` grammar): the job additionally gets a gang of
    interior tree nodes, placed by ``fleet.placement.place_tree`` (each
    node on the first host of its own subtree, its warm ``TreeStandby``
    region-local on the next, ports pool-allocated and released with the
    card's). Workers then dial their OWN level-0 node's
    ``primary,standby`` list instead of the root — :meth:`tree_plan` /
    ``Job.render_tree_commands`` carry the whole shape, and every
    worker's env also mirrors ``DKTPU_TREE_SPEC``. ``tree_buffer``
    (optional) sets each node's partition ride-through bound.

    Sharded center (``shards: N`` with N > 1): the job gets a GANG of N
    shard servers instead of one — each launched ``--shard k/N`` with its
    own pool-allocated port, per-shard state dir (``<state_dir>/shard-k``)
    and, when ``standby_host`` is set, its own warm standby. The workers'
    ``DKTPU_PS_ENDPOINT`` becomes the ``;``-separated shard x failover
    matrix (``p0,s0;p1,s1;...``) their sharded clients dial; every shard's
    durability/failover/supervision story is the single-PS one, N times.
    """

    job_name: str
    script: str
    hosts: Sequence[str]
    #: ``MASTER_PORT``. None = allocate from the per-host port pool on
    #: first render (two punchcards launched from one driver can then never
    #: collide on it); pass an int to pin it (reference parity: 8476).
    coordinator_port: Optional[int] = None
    env: dict = dataclasses.field(default_factory=dict)
    args: Sequence[str] = ()
    ps: Optional[dict] = None
    #: tenant this job bills to — stamped on every supervision telemetry
    #: event (restarts, straggler kills, PS revivals) so the report CLI
    #: can attribute churn per tenant in a multi-job fleet.
    tenant: Optional[str] = None

    def _reserve(self, host: str) -> int:
        """Pool-allocate one port and remember it for
        :meth:`release_ports` (explicit ports are never tracked — only
        what this card took from the pool is returned to it)."""
        from distkeras_tpu_torch.fleet.ports import reserve_port

        port = reserve_port(host)
        # Not a dataclass field on purpose: to_json()/asdict must not
        # carry it, and from_json round-trips without it.
        self.__dict__.setdefault("_allocated_ports", []).append(port)
        return port

    def release_ports(self) -> None:
        """Return every pool-allocated port to the per-host pool AND
        clear its pin from the card — a relaunch of the same card must
        re-reserve, not render endpoints on ports the pool already
        considers free. Called by :class:`Job` teardown (kill / wait /
        clean supervise exit) so a long-lived driver launching many jobs
        cannot exhaust the pool; idempotent, and a no-op for cards with
        explicit ports (those are never tracked, never cleared)."""
        from distkeras_tpu_torch.fleet.ports import release_port

        allocated = set(self.__dict__.pop("_allocated_ports", []))
        self.__dict__.pop("_tree_plan", None)  # its ports are in the set
        for port in allocated:
            release_port(port)
        if self.coordinator_port in allocated:
            self.coordinator_port = None
        if self.ps:
            if self.ps.get("port") in allocated:
                del self.ps["port"]
            if self.ps.get("standby_port") in allocated:
                del self.ps["standby_port"]
            for key in ("shard_ports", "standby_ports"):
                ports = self.ps.get(key)
                # Pool pins are only ever written as the whole list, so a
                # fully-allocated list is ours to clear; an explicit list
                # was never tracked and stays untouched.
                if ports and all(p in allocated for p in ports):
                    del self.ps[key]

    def resolved_coordinator_port(self) -> int:
        """The coordinator port, allocating (and pinning) one from the
        bind-probed per-host pool when none was given — the allocation is
        sticky, so every later render agrees with the first."""
        if not self.coordinator_port:
            self.coordinator_port = self._reserve(self.hosts[0])
        return int(self.coordinator_port)

    def ps_shard_count(self) -> int:
        """How many center shards the card asks for (1 = the classic
        single PS; the ``shards`` key is only meaningful with ``ps``)."""
        if self.ps is None:
            return 1
        return max(1, int(self.ps.get("shards") or 1))

    def ps_endpoint(self) -> Optional[str]:
        """Endpoint(s) of the parameter server, None when ``ps`` unset:
        ``host:port``, or the ``primary,standby`` failover list when a
        standby is configured (the order the clients walk). A missing
        ``port`` is allocated from the per-host pool (bind-probed, sticky
        — stored back into ``ps`` so the launch command, the workers'
        ``DKTPU_PS_ENDPOINT``, and every later call agree); the old fixed
        7077 default broke the second job on a host.

        With ``shards: N`` (N > 1) this is the ``;``-separated shard x
        failover MATRIX — ``p0,s0;p1,s1;...`` — each shard its own
        pool-allocated port (pinned into ``shard_ports``, and
        ``standby_ports`` when a ``standby_host`` is set): the exact
        string a :class:`~distkeras_tpu_torch.netps.shards.ShardedPSClient`
        dials, one failover group per shard."""
        if self.ps is None:
            return None
        host = self.ps.get("host") or self.hosts[0]
        n = self.ps_shard_count()
        if n > 1:
            ports = self.ps.get("shard_ports")
            if ports is None:
                ports = self.ps["shard_ports"] = [
                    self._reserve(host) for _ in range(n)]
            elif len(ports) != n:
                raise ValueError(
                    f"ps['shard_ports'] has {len(ports)} entries for "
                    f"shards={n}")
            standby_ports = None
            if self.ps.get("standby_host"):
                standby_ports = self.ps.get("standby_ports")
                if standby_ports is None:
                    standby_ports = self.ps["standby_ports"] = [
                        self._reserve(self.ps["standby_host"])
                        for _ in range(n)]
                elif len(standby_ports) != n:
                    raise ValueError(
                        f"ps['standby_ports'] has {len(standby_ports)} "
                        f"entries for shards={n}")
            groups = []
            for k in range(n):
                group = f"{host}:{int(ports[k])}"
                if standby_ports is not None:
                    group += (f",{self.ps['standby_host']}:"
                              f"{int(standby_ports[k])}")
                groups.append(group)
            return ";".join(groups)
        port = self.ps.get("port")
        if not port:
            port = self.ps["port"] = self._reserve(host)
        primary = f"{host}:{int(port)}"
        standby = self.ps_standby_endpoint()
        return f"{primary},{standby}" if standby else primary

    def tree_spec(self) -> Optional[str]:
        """The card's aggregation-tree grammar (``ps["tree"]``), None when
        the job runs the flat star."""
        if self.ps is None:
            return None
        return self.ps.get("tree") or None

    def tree_plan(self):
        """The resolved :class:`~distkeras_tpu_torch.fleet.placement.
        TreePlacement` for a ``tree`` card (None otherwise) — sticky like
        every port pin: the first call reserves the gang's ports through
        this card (so :meth:`release_ports` returns them) and every later
        call, launch line, and worker env agrees with it."""
        spec = self.tree_spec()
        if not spec:
            return None
        plan = self.__dict__.get("_tree_plan")
        if plan is None:
            from distkeras_tpu_torch.fleet.placement import place_tree

            plan = place_tree(spec, workers=len(self.hosts),
                              hosts=list(self.hosts),
                              root_endpoint=self.ps_endpoint(),
                              reserve=self._reserve)
            self.__dict__["_tree_plan"] = plan
        return plan

    def ps_standby_endpoint(self) -> Optional[str]:
        """``host:port`` of the warm standby, None when not configured.
        Like the primary's, a missing ``standby_port`` is pool-allocated
        and pinned (the old ``primary + 1`` rule collided as soon as a
        second job's primary landed on that port). Sharded cards have no
        single standby — their per-shard standbys live in the
        :meth:`ps_endpoint` matrix — so this returns None for them."""
        if self.ps is None or not self.ps.get("standby_host"):
            return None
        if self.ps_shard_count() > 1:
            return None
        port = self.ps.get("standby_port")
        if not port:
            port = self.ps["standby_port"] = self._reserve(
                self.ps["standby_host"])
        return f"{self.ps['standby_host']}:{int(port)}"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Punchcard":
        return cls(**json.loads(text))


class Job:
    """Render + launch a multi-host training job (reference ``Job``).

    Beyond the reference's launch-and-pray: :meth:`supervise` restarts
    failed hosts with exponential backoff and kills stragglers on a
    timeout, :meth:`kill` escalates SIGTERM → SIGKILL, and :meth:`wait`
    tears down stragglers when its timeout expires — the cluster-manager
    duties the reference delegated to Spark task retry.
    """

    def __init__(self, punchcard: Punchcard, ssh_user: Optional[str] = None,
                 python: str = "python"):
        self.punchcard = punchcard
        self.ssh_user = ssh_user
        #: the interpreter every launch line starts (each host's own
        #: ``python`` by default; ``sys.executable`` for a localhost job
        #: whose hosts share this process's interpreter)
        self.python = python
        self._procs: list[subprocess.Popen] = []
        self._cmds: list[str] = []
        #: the parameter-server process (punchcards with ``ps``), launched
        #: before the workers and torn down with them.
        self._ps_proc: Optional[subprocess.Popen] = None
        #: the warm-standby process (punchcards with a ``standby_host``).
        self._standby_proc: Optional[subprocess.Popen] = None
        #: the shard-server gang (punchcards with ``shards: N``, N > 1) —
        #: one primary per shard, and one standby per shard when a
        #: ``standby_host`` is set. Unsharded cards keep using the two
        #: attributes above.
        self._shard_procs: list = []
        self._shard_standby_procs: list = []
        #: the interior tree-node gang (punchcards with ``ps["tree"]``):
        #: one TreeNode per (level, group) plus its warm TreeStandby,
        #: launched parents-first, torn down with the PS plane.
        self._tree_procs: list = []
        #: restarts performed per host by :meth:`supervise`.
        self.restarts: list[int] = []
        #: PS-pair restarts performed by :meth:`supervise` (cold restarts
        #: from the state dir — the reason ``ps["state_dir"]`` exists);
        #: the per-role budgets live in :attr:`_ps_role_restarts` so a
        #: flapping standby cannot drain the primary's budget.
        self.ps_restarts = 0
        self._ps_role_restarts: dict = {}

    def render_commands(self) -> list[str]:
        """One command line per host, with the process group's rendezvous
        env (plus ``DKTPU_PS_ENDPOINT`` when the punchcard carries a
        ``ps``)."""
        pc = self.punchcard
        master_port = pc.resolved_coordinator_port()
        endpoint = pc.ps_endpoint()
        tree = pc.tree_plan()
        cmds = []
        for i, _host in enumerate(pc.hosts):
            # A tree card's worker dials its OWN level-0 node (its host's
            # subtree), not the root — the node's standby rides along in
            # the failover list.
            ep = tree.leaf_endpoint(i) if tree else endpoint
            env = {
                "MASTER_ADDR": pc.hosts[0],
                "MASTER_PORT": str(master_port),
                "WORLD_SIZE": str(len(pc.hosts)),
                "RANK": str(i),
                "LOCAL_RANK": "0",
                **({"DKTPU_PS_ENDPOINT": ep} if ep else {}),
                **({"DKTPU_TREE_SPEC": pc.tree_spec()} if tree else {}),
                # With tracing on, every child's spans and flight dumps
                # carry a fleet-unique role label (workers here; the netps
                # CLI labels itself ps/shardK/standby). Before ``pc.env`` so
                # an operator's explicit label still wins.
                **({"DKTPU_TRACE_ROLE": f"worker{i}"}
                   if tracing.enabled() else {}),
                **pc.env,
            }
            env_str = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
            arg_str = " ".join(shlex.quote(a) for a in pc.args)
            cmds.append(f"env {env_str} {shlex.quote(self.python)} "
                        f"{shlex.quote(pc.script)} {arg_str}".strip())
        return cmds

    def _server_flags(self) -> str:
        """``--discipline`` (and ``--device`` where the card's ``ps`` names
        one) of every parameter-server-plane launch line."""
        ps = self.punchcard.ps
        flags = shlex.quote(ps.get("discipline", "adag"))
        if ps.get("device"):
            flags += f" --device {shlex.quote(str(ps['device']))}"
        return flags

    def render_ps_commands(self) -> list[str]:
        """One launch line per shard server — a single-element list for the
        classic unsharded card, N lines (each ``--shard k/N`` with its own
        port and ``<state_dir>/shard-k``) for ``shards: N``; empty when
        ``ps`` is unset."""
        pc = self.punchcard
        if pc.ps is None:
            return []
        # ps_endpoint() pins the pool-allocated port(s) into the card, so
        # the launch lines and the workers' env agree.
        pc.ps_endpoint()
        n = pc.ps_shard_count()
        disc = self._server_flags()
        cmds = []
        for k in range(n):
            port = int(pc.ps["shard_ports"][k] if n > 1 else pc.ps["port"])
            cmd = (f"{shlex.quote(self.python)} -m distkeras_tpu_torch.netps "
                   f"--host 0.0.0.0 "
                   f"--port {port} "
                   f"--discipline {disc}")
            if pc.ps.get("lease") is not None:
                cmd += f" --lease {float(pc.ps['lease'])}"
            if pc.ps.get("state_dir"):
                state_dir = pc.ps["state_dir"]
                if n > 1:
                    state_dir = f"{state_dir}/shard-{k}"
                cmd += f" --state-dir {shlex.quote(state_dir)}"
            if pc.ps.get("snapshot_every") is not None:
                cmd += f" --snapshot-every {int(pc.ps['snapshot_every'])}"
            if n > 1:
                cmd += f" --shard {k}/{n}"
            cmds.append(cmd)
        return cmds

    def render_ps_command(self) -> Optional[str]:
        """The parameter-server launch line (None when ``ps`` is unset) —
        the first of :meth:`render_ps_commands`, which for the unsharded
        card is the whole story."""
        cmds = self.render_ps_commands()
        return cmds[0] if cmds else None

    def render_standby_commands(self) -> list[str]:
        """One warm-standby launch line per shard (a single-element list
        for the unsharded card; empty when no ``standby_host``). Each
        standby journals into its own ``.standby``-suffixed directory
        (``<state_dir>.standby``, or ``<state_dir>/shard-k.standby`` per
        shard) so a promoted-then-restarted standby recovers
        fenced-forward without ever sharing a directory with its
        primary."""
        pc = self.punchcard
        if pc.ps is None or not pc.ps.get("standby_host"):
            return []
        n = pc.ps_shard_count()
        disc = self._server_flags()
        groups = pc.ps_endpoint().split(";")
        cmds = []
        for k, group in enumerate(groups):
            primary, standby = group.split(",", 1)
            port = int(standby.rsplit(":", 1)[1])
            cmd = (f"{shlex.quote(self.python)} -m distkeras_tpu_torch.netps "
                   f"--host 0.0.0.0 "
                   f"--port {port} --standby {shlex.quote(primary)} "
                   f"--discipline {disc}")
            if pc.ps.get("lease") is not None:
                cmd += f" --lease {float(pc.ps['lease'])}"
            if pc.ps.get("state_dir"):
                state_dir = pc.ps["state_dir"]
                state_dir = (f"{state_dir}/shard-{k}.standby" if n > 1
                             else state_dir + ".standby")
                cmd += f" --state-dir {shlex.quote(state_dir)}"
            if pc.ps.get("snapshot_every") is not None:
                cmd += f" --snapshot-every {int(pc.ps['snapshot_every'])}"
            if n > 1:
                cmd += f" --shard {k}/{n}"
            cmds.append(cmd)
        return cmds

    def render_standby_command(self) -> Optional[str]:
        """The warm-standby launch line (None when no standby configured)
        — the first of :meth:`render_standby_commands`."""
        cmds = self.render_standby_commands()
        return cmds[0] if cmds else None

    def render_tree_commands(self) -> list[str]:
        """One launch line per interior tree node AND its warm standby
        (``ps["tree"]`` cards; empty otherwise), bottom level first with
        each node's standby right after it. Launch order matters top-down
        — parents must listen before children dial — so a launcher runs
        this list REVERSED; per-node state dirs are
        ``<state_dir>/tree-L<level>-g<group>`` (standby: ``.standby``
        suffix), the same labels the placement's ``all_state_labels``
        exports."""
        pc = self.punchcard
        plan = pc.tree_plan()
        if plan is None:
            return []
        disc = self._server_flags()
        spec = shlex.quote(pc.tree_spec())
        cmds = []
        for node in plan:
            base = (f"--discipline {disc} --tree-spec {spec} "
                    f"--tree-level {node.level} --tree-group {node.group} "
                    f"--upstream {shlex.quote(node.upstream)}")
            if pc.ps.get("lease") is not None:
                base += f" --lease {float(pc.ps['lease'])}"
            if pc.ps.get("tree_buffer") is not None:
                base += f" --tree-buffer {int(pc.ps['tree_buffer'])}"
            if pc.ps.get("snapshot_every") is not None:
                base += f" --snapshot-every {int(pc.ps['snapshot_every'])}"
            label = f"tree-L{node.level}-g{node.group}"
            state = pc.ps.get("state_dir")
            cmd = (f"{shlex.quote(self.python)} -m distkeras_tpu_torch.netps "
                   f"--host 0.0.0.0 "
                   f"--port {node.port} {base}")
            if state:
                cmd += f" --state-dir {shlex.quote(f'{state}/{label}')}"
            cmds.append(cmd)
            if node.standby_host is not None:
                cmd = (f"{shlex.quote(self.python)} -m distkeras_tpu_torch.netps "
                   f"--host 0.0.0.0 "
                       f"--port {node.standby_port} "
                       f"--standby {shlex.quote(node.endpoint)} {base}")
                if state:
                    cmd += (" --state-dir "
                            f"{shlex.quote(f'{state}/{label}.standby')}")
                cmds.append(cmd)
        return cmds

    def _labels(self) -> dict:
        """Attribution fields for supervision telemetry events: the
        punchcard's job name plus, when set, the tenant it bills to — the
        report CLI groups restart/straggler/PS-revival churn by these."""
        labels = {"job": self.punchcard.job_name}
        if self.punchcard.tenant:
            labels["tenant"] = self.punchcard.tenant
        return labels

    def _spawn(self, i: int) -> subprocess.Popen:
        """(Re)launch host ``i``'s command."""
        return self._spawn_cmd(self.punchcard.hosts[i], self._cmds[i])

    def _spawn_cmd(self, host: str, cmd: str) -> subprocess.Popen:
        """Launch one command line on ``host`` (workers and the PS)."""
        target = f"{self.ssh_user}@{host}" if self.ssh_user else host
        if host in ("localhost", "127.0.0.1"):
            # No shell wrapper: signals from kill()/terminate() must reach
            # the actual python process, not an intermediate sh (whose
            # death would orphan the trainer). The rendered command is
            # shlex-quoted, so splitting reverses it exactly.
            return subprocess.Popen(shlex.split(cmd))
        # -tt forces a remote pty: killing the local ssh client then
        # HUPs the remote job too, so kill() tears down the whole
        # launch rather than orphaning trainers on the remote hosts.
        return subprocess.Popen(["ssh", "-tt", target, cmd])

    def launch(self, dry_run: bool = True) -> list[str]:
        """Start the job on every host; with ``dry_run`` just return the
        worker commands (the PS line, if any, is ``render_ps_command()``).
        A punchcard with ``ps`` launches the parameter server first — the
        workers' hardened clients retry with backoff, so no readiness
        handshake is needed before starting them."""
        cmds = self.render_commands()
        if dry_run:
            return cmds
        pc = self.punchcard
        if pc.ps is not None and pc.ps_shard_count() > 1:
            # The shard gang: N primaries (and N standbys when configured)
            # launched before the workers, exactly like the single PS.
            ps_host = pc.ps.get("host") or pc.hosts[0]
            if not self._shard_procs:
                self._shard_procs = [self._spawn_cmd(ps_host, c)
                                     for c in self.render_ps_commands()]
            if not self._shard_standby_procs:
                self._shard_standby_procs = [
                    self._spawn_cmd(pc.ps["standby_host"], c)
                    for c in self.render_standby_commands()]
        else:
            ps_cmd = self.render_ps_command()
            if ps_cmd is not None and self._ps_proc is None:
                ps_host = pc.ps.get("host") or pc.hosts[0]
                self._ps_proc = self._spawn_cmd(ps_host, ps_cmd)
            standby_cmd = self.render_standby_command()
            if standby_cmd is not None and self._standby_proc is None:
                self._standby_proc = self._spawn_cmd(
                    pc.ps["standby_host"], standby_cmd)
        if pc.tree_spec() and not self._tree_procs:
            # Interior tree gang, top level first (render order is bottom
            # level first): a node's parent must be listening before the
            # node's ctor dials it. Standby lines dial their primary
            # lazily, so interleaved order is fine for them.
            plan = pc.tree_plan()
            tree_cmds = self.render_tree_commands()
            hosts = [h for node in plan
                     for h in ([node.host] + ([node.standby_host]
                                              if node.standby_host else []))]
            self._tree_procs = [self._spawn_cmd(h, c)
                                for h, c in reversed(list(zip(hosts,
                                                              tree_cmds)))]
        self._cmds = cmds
        self.restarts = [0] * len(cmds)
        for i in range(len(cmds)):
            self._procs.append(self._spawn(i))
        return cmds

    def wait(self, timeout: Optional[float] = None) -> list[int]:
        """Block until every launched process exits; returns their exit codes.

        ``timeout`` bounds the *total* wait (seconds); on expiry the
        stragglers are torn down (SIGTERM → SIGKILL via :meth:`kill`) before
        the pending ``subprocess.TimeoutExpired`` propagates — an expired
        wait never leaves half a job running behind the caller's back.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        rcs = []
        try:
            for p in self._procs:
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                rcs.append(p.wait(timeout=remaining))
        except subprocess.TimeoutExpired:
            self.kill()
            raise
        self._stop_ps()
        self.punchcard.release_ports()
        return rcs

    def _all_ps_procs(self) -> list:
        """Every PS-plane process handle this job holds — the unsharded
        pair plus the shard gang (Nones included; callers skip them)."""
        return ([self._ps_proc, self._standby_proc]
                + list(self._shard_procs) + list(self._shard_standby_procs)
                + list(self._tree_procs))

    def _stop_ps(self, grace: float = 5.0) -> None:
        """Drain the parameter-server plane once the workers are done:
        SIGTERM triggers the graceful drain; SIGKILL only if it won't."""
        for p in self._all_ps_procs():
            if p is None or p.poll() is not None:
                continue
            try:
                p.terminate()
            except OSError:
                continue
            try:
                p.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                try:
                    p.kill()
                except OSError:
                    pass

    def poll(self) -> list:
        """Exit codes so far: one entry per host, ``None`` while running."""
        return [p.poll() for p in self._procs]

    def supervise(self, timeout: float, grace: float = 5.0,
                  max_restarts: int = 0, restart_backoff: float = 1.0,
                  straggler_timeout: Optional[float] = None,
                  health=None) -> list[int]:
        """Babysit the job like a cluster manager. Polls until every process
        exits. A host that exits nonzero is **restarted** (same command, up
        to ``max_restarts`` times per host, after a full-jitter delay drawn
        from the ``restart_backoff * 2**n`` envelope); once a host exhausts its restart
        budget the survivors get ``grace`` seconds and the job is torn down
        (the original first-failure semantics — the default
        ``max_restarts=0`` behaves exactly as before). With
        ``straggler_timeout`` set, hosts still running that long after the
        first host finished cleanly are declared stragglers and killed.
        Returns final exit codes (negative signal numbers for processes the
        teardown killed). This is the host-failure detection AND recovery
        the reference delegated to Spark's task retry.

        ``health`` is the optional health-plane hook — anything with a
        ``MetricsHub``-shaped ``is_down(endpoint)``. A PS-plane process
        whose endpoint has failed liveness (stopped answering scrapes
        while the OS process is still alive — wedged, not dead) is killed
        here so :meth:`_revive_ps` restarts it within the ordinary budget
        on the next sweep, instead of every client waiting for the lease
        to lapse and the standby to promote."""
        from distkeras_tpu_torch import telemetry

        if health is not None:
            self.register_health_targets()
        deadline = time.monotonic() + timeout
        first_done_ok: Optional[float] = None
        while time.monotonic() < deadline:
            if health is not None:
                self._liveness_kill(health)
            self._revive_ps(max_restarts, restart_backoff)
            rcs = self.poll()
            failed = [i for i, rc in enumerate(rcs) if rc not in (None, 0)]
            if any(self.restarts[i] >= max_restarts for i in failed):
                # Restart budget exhausted: first-failure teardown.
                time.sleep(grace)
                self.kill()
                return [p.returncode for p in self._procs]
            if not failed and all(rc is not None for rc in rcs):
                # Clean completion: drain the parameter server too, or it
                # outlives the job holding its port (kill() covers every
                # teardown path; this is the one return that skips kill).
                self._stop_ps()
                self.punchcard.release_ports()
                return rcs
            for i in failed:
                # Full jitter (same rule as the netps client's RPC retries):
                # hosts killed by one sweep must not restart in lockstep —
                # a synchronized restart storm re-creates the overload that
                # killed them.
                delay = full_jitter(restart_backoff, self.restarts[i])
                self.restarts[i] += 1
                telemetry.counter("resilience.host_restarts").add(1)
                telemetry.event("host_restart", {
                    **self._labels(),
                    "host": self.punchcard.hosts[i], "index": i,
                    "exit_code": rcs[i], "restart": self.restarts[i]})
                time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
                self._procs[i] = self._spawn(i)
            if straggler_timeout is not None:
                if first_done_ok is None and 0 in rcs:
                    first_done_ok = time.monotonic()
                if (first_done_ok is not None
                        and time.monotonic() - first_done_ok
                        > straggler_timeout):
                    stragglers = [i for i, rc in enumerate(self.poll())
                                  if rc is None]
                    telemetry.counter("resilience.straggler_kills").add(
                        len(stragglers))
                    telemetry.event("straggler_kill", {
                        **self._labels(),
                        "hosts": [self.punchcard.hosts[i]
                                  for i in stragglers]})
                    self.kill()
                    return [p.returncode for p in self._procs]
            time.sleep(0.1)
        self.kill()
        return [p.returncode for p in self._procs]

    def _revive_ps(self, max_restarts: int,
                   restart_backoff: float = 0.0) -> None:
        """Restart a dead parameter-server process (primary or standby)
        mid-supervision — the cold-restart half of the failover story: a
        primary relaunched on its ``state_dir`` resumes center/counter/
        dedup state and the workers' retransmits dedup exactly-once. A
        primary revived AFTER a standby promoted simply comes back fenced
        (the promotion's epoch outranks it). Mirrors the worker-restart
        policy: ``max_restarts`` budget *per role* (a flapping standby
        must not drain the primary's budget; default 0 = off) and a
        full-jitter delay per restart (a PS crashing on startup must not
        burn its whole budget in one polling second)."""
        from distkeras_tpu_torch import telemetry

        for role, get, put, cmd_fn, host in self._ps_plane():
            p = get()
            # rc 0 is a deliberate drain (operator SIGTERM), not a crash —
            # same exemption the worker-restart policy applies.
            if p is None or p.poll() is None or p.returncode == 0:
                continue
            n = self._ps_role_restarts.get(role, 0)
            if n >= max_restarts:
                continue
            time.sleep(full_jitter(restart_backoff, n))
            self._ps_role_restarts[role] = n + 1
            self.ps_restarts += 1
            telemetry.counter("resilience.ps_restarts").add(1)
            telemetry.event("ps_restart", {
                **self._labels(),
                "role": role, "exit_code": p.returncode,
                "restart": self.ps_restarts})
            put(self._spawn_cmd(host, cmd_fn()))

    def _ps_endpoint_for_role(self, role: str) -> Optional[str]:
        """The scrape endpoint behind a :meth:`_ps_plane` role name, None
        when the card doesn't configure one (e.g. ``standby`` with no
        ``standby_host``)."""
        pc = self.punchcard
        if pc.ps is None:
            return None
        matrix = pc.ps_endpoint() or ""
        if pc.ps_shard_count() > 1:
            groups = [g.split(",") for g in matrix.split(";")]
            if not role.startswith("shard-"):
                return None
            k = int(role.split("-")[1])
            if k >= len(groups):
                return None
            if role.endswith("-standby"):
                return groups[k][1] if len(groups[k]) > 1 else None
            return groups[k][0]
        if role == "primary":
            return matrix.split(",")[0]
        if role == "standby":
            return pc.ps_standby_endpoint()
        return None

    def register_health_targets(self) -> dict:
        """File every live PS-plane endpoint with the health plane's
        in-process target registry (``<job>.<role>``, tenant-prefixed
        when the card bills one) so a ``MetricsHub`` on this driver
        scrapes them without configuration. Returns ``{name: endpoint}``
        for what was registered."""
        from distkeras_tpu_torch.telemetry.health import register_target

        labels = self._labels()
        prefix = (f"{labels['tenant']}." if "tenant" in labels else "")
        out = {}
        for role, get, _put, _cmd_fn, _host in self._ps_plane():
            if get() is None:
                continue
            ep = self._ps_endpoint_for_role(role)
            if ep:
                name = f"{prefix}{labels['job']}.{role}"
                register_target(ep, name)
                out[name] = ep
        return out

    def _liveness_kill(self, health) -> None:
        """Kill (SIGKILL — it is wedged, SIGTERM assumes cooperation) any
        live PS process whose endpoint the health hook reports down; the
        next :meth:`_revive_ps` sweep restarts it under its role budget."""
        from distkeras_tpu_torch import telemetry

        for role, get, _put, _cmd_fn, _host in self._ps_plane():
            p = get()
            if p is None or p.poll() is not None:
                continue
            ep = self._ps_endpoint_for_role(role)
            if not ep or not health.is_down(ep):
                continue
            telemetry.counter("resilience.liveness_kills").add(1)
            telemetry.event("liveness_kill", {
                **self._labels(), "role": role, "endpoint": ep})
            try:
                p.kill()
            except OSError:
                pass

    def _ps_plane(self) -> list:
        """The PS-plane roster ``(role, get, put, cmd_fn, host)`` that
        :meth:`_revive_ps` walks — the primary/standby pair for the
        unsharded card, or one entry per shard primary AND per shard
        standby for ``shards: N`` (roles ``shard-k`` / ``shard-k-standby``,
        so every shard gets its own restart budget and a flapping shard
        cannot drain its siblings')."""
        pc = self.punchcard
        ps = pc.ps or {}
        ps_host = ps.get("host") or pc.hosts[0]
        if pc.ps is not None and pc.ps_shard_count() > 1:
            entries = []
            for k in range(len(self._shard_procs)):
                entries.append((
                    f"shard-{k}",
                    lambda k=k: self._shard_procs[k],
                    lambda p, k=k: self._shard_procs.__setitem__(k, p),
                    lambda k=k: self.render_ps_commands()[k],
                    ps_host))
            for k in range(len(self._shard_standby_procs)):
                entries.append((
                    f"shard-{k}-standby",
                    lambda k=k: self._shard_standby_procs[k],
                    lambda p, k=k: self._shard_standby_procs.__setitem__(
                        k, p),
                    lambda k=k: self.render_standby_commands()[k],
                    ps["standby_host"]))
            return entries
        return [
            ("primary",
             lambda: self._ps_proc,
             lambda p: setattr(self, "_ps_proc", p),
             self.render_ps_command, ps_host),
            ("standby",
             lambda: self._standby_proc,
             lambda p: setattr(self, "_standby_proc", p),
             self.render_standby_command, ps.get("standby_host")),
        ]

    def kill(self, grace: float = 5.0) -> None:
        """Tear down every launched process that is still running:
        SIGTERM first, then — for anything still alive after ``grace``
        seconds — SIGKILL. The old single-SIGKILL-then-``wait()`` could
        block forever on a process stuck unreapable; the escalation is
        bounded at ~``2 * grace`` seconds worst-case, after which an
        unreapable (D-state) process is abandoned rather than hanging the
        caller."""
        live = [p for p in self._procs if p.poll() is None]
        for ps in self._all_ps_procs():
            if ps is not None and ps.poll() is None:
                live.append(ps)
        for p in live:
            try:
                p.terminate()
            except OSError:
                pass
        deadline = time.monotonic() + grace
        for p in live:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    p.kill()
                except OSError:
                    pass
        for p in live:
            if p.poll() is None:
                try:
                    p.wait(timeout=grace)
                except subprocess.TimeoutExpired:
                    pass  # unreapable: do not hang the caller's teardown
        # Every process is down (or abandoned): the card's pool-allocated
        # ports go back to the per-host pool for the next job.
        self.punchcard.release_ports()
