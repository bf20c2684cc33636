"""Deterministic fault injection: the :class:`FaultPlan` (the port's copy
of ``distkeras_tpu/resilience/faults.py``, both grammars whole).

The reference delegated all fault handling to Spark task retry and never
tested it (``job_deployment.py`` docstring); here every recovery path is
driven by *injected* faults so it is exercised, not asserted. A plan is a
set of ``kind@at[:arg]`` entries, parsed from the ``DKTPU_FAULTS`` env var
(or built programmatically), and each fault fires **exactly once** per
process — a resumed run re-executing the poisoned round must not be
re-poisoned, or no recovery loop could ever converge.

Syntax (``;``-separated entries)::

    DKTPU_FAULTS="nan@3;stall@5:0.5;crash@7;seed=11"

=================  ==========================================================
``nan@R``          poison round R's staged batch to NaN — the loss AND the
                   gradients of that round go non-finite through backprop
``inf@R``          same, with Inf
``stall@R:S``      the feeder thread sleeps S seconds while staging item R
                   (exercises the consumer-side stall watchdog)
``feeder_error@R`` the feeder's stage call raises :class:`InjectedFault`
                   once at item R (exercises the stage retry/backoff path)
``crash@R``        raise :class:`InjectedFault` in the run loop before
                   dispatching round R (exercises Supervisor retry-resume)
``kill@R``         SIGKILL this process before dispatching round R (the
                   mid-run host kill; exercises ``Job.supervise`` restart)
``ckpt_corrupt@S`` scribble over the checkpoint payload of step S right
                   after it is written (exercises the hash-sidecar
                   fallback restore)
``feed_gap@R:S``   the stream source goes silent for S seconds before
                   delivering item R (``streaming/source.py``)
``drift@R``        distribution shift injected at stream item R: every
                   label from R on rotated one class forward
                   (``streaming/source.py``)
``seed=N``         seeds deterministic choices (which worker's batch rows
                   get poisoned)
=================  ==========================================================

Cross-process one-shot state: ``kill@R`` restarts the process, which would
re-fire the kill forever. Set ``DKTPU_FAULTS_STATE=/path/file`` and fired
faults are journaled there, surviving the restart.

Scheduling caveat: batch faults (``nan``/``inf``) fire at *staging* time,
and the RoundFeeder stages ``depth`` (default 2) rounds ahead of execution
— a crash/kill scheduled within that lookahead of a batch fault can
discard the already-poisoned staged batch, consuming the one-shot with no
observable effect. Keep batch faults at least ``depth + 1`` rounds away
from crash/kill faults (the shipped schedules use a gap of 4).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.telemetry import tracing

#: fault kinds and whether they take an argument.
_KINDS = frozenset({
    "nan", "inf", "stall", "feeder_error", "crash", "kill", "ckpt_corrupt",
    "feed_gap", "drift",
})

#: network fault kinds (``DKTPU_NET_FAULTS``), consumed by the netps chaos
#: proxy (``netps/chaos.py``), the shared-memory ring transport
#: (``netps/shm.py``), the netps server itself, and the remote worker
#: loop. ``at`` indexes
#: client->server *frames* for the wire kinds (TCP frames through the
#: proxy; ring frames for the ``shm_*`` kinds — no proxy can sit on a
#: memory ring, so the transport injects its own faults) and commit
#: *rounds* for ``evict``. The ``_r`` variants hit the reply
#: (server->client) direction of the same frame index — "per direction"
#: fault injection. ``shm_delay@F:S`` holds ring frame F for S seconds;
#: ``shm_corrupt@F`` flips frame F's slot crc so the server rejects it and
#: the connection dies (the ring's ``truncate``). ``ps_crash@R`` SIGKILLs
#: the netps SERVER process just before folding its R-th commit (the
#: kill-the-primary drill — recovery is the state-dir cold restart or the
#: warm standby's promotion); ``ps_hang@R:S`` wedges the server for S
#: seconds *holding its center lock* before commit R, so every member's
#: lease renewal queues behind a genuinely hung PS (what ``Job.supervise``
#: must tell apart from a draining one). Both are consumed by the server
#: process, never by the proxy — schedule them only in the PS process's
#: environment. ``preempt@R[:N]`` is the control-plane drill: when the
#: fleet's cumulative commit count crosses R, the ``FleetScheduler``
#: forcibly preempts N workers (default 1) from its lowest-priority
#: running job exactly as a capacity squeeze would — lease revocation,
#: shrink floor at the victim's min gang, full drain + requeue when the
#: floor is already reached (the JAX package's ``fleet/scheduler.py``).
#: ``serve_slow@F:S`` and ``serve_drop@F`` are consumed by the serving
#: frontend (``serving/frontend.py``), indexing accepted
#: inference requests process-wide: ``serve_slow`` holds request F's
#: reply for S seconds (a wedged replica — clients must ride it out or
#: walk the replica list), ``serve_drop`` kills request F's connection
#: without a reply (the client sees a transport failure and fails over;
#: the shed-before-accept contract still answers every ACCEPTED request
#: whose connection survives). ``shard_crash@N:R`` is the sharded-center
#: drill: SIGKILL SHARD N of a sharded PS deployment once it has folded R
#: commits — the ``at`` slot selects the shard index (every shard process
#: consults its own plan instance, so the index is the only coordinate
#: they share), and the arg is the commit threshold. Consumed by the shard
#: server via the non-consuming :meth:`FaultPlan.pending` peek (shard
#: k != N must not burn the one-shot), fired in the killed shard's own
#: process. ``link_down@K:S`` black-holes ONE aggregation-tree uplink for
#: S seconds: the ``at`` slot carries the link key
#: ``TreeSpec.link_key(level, group) = level*1000 + group`` — the
#: (level, group) uplink packed into the one integer the grammar allows —
#: and is consumed by that tree node's own uplink transport
#: (``netps/tree.py``), because no chaos proxy can sit on every interior
#: hop. Commits keep flowing INTO the node; its flushes buffer (bounded by
#: ``DKTPU_TREE_BUFFER``, then counted typed drops) and its upstream
#: heartbeats stop, so the uplink lease genuinely lapses — the heal path
#: must re-prove membership before draining. ``link_flap@K:S`` is the
#: flappy variant: down S, up S, down S again — two outages from one
#: entry, exercising the drain->re-black-hole path. Schedule both in the
#: tree NODE's process environment.
#: ``mesh_down@R`` is the device-loss drill for the mesh transport
#: dialect (``DKTPU_NET_TRANSPORT=mesh``): the in-process mesh dispatch
#: raises ``ConnectionError`` when commit seq R crosses it, as a lost
#: device mesh would — the client must demote to its negotiated shm/TCP
#: dialect and retransmit the SAME seq, exactly-once riding through.
#:
#: The port parses every kind as the JAX package does. ``preempt@R[:N]``
#: is read by the fleet scheduler (``FleetScheduler._consult_chaos``: N
#: workers forcibly preempted once the fleet's cumulative commits cross R).
#: The compute kinds ``feed_gap`` and ``drift`` are consumed by the stream
#: sources (``streaming/source.py _SourceBase._apply_faults``): the gap
#: holds record R back before delivery, the drift rotates every label
#: from record R on, for good.
_NET_KINDS = frozenset({
    "delay", "drop", "dup", "truncate", "partition", "evict",
    "delay_r", "drop_r", "dup_r", "truncate_r",
    "shm_delay", "shm_corrupt",
    "ps_crash", "ps_hang", "preempt",
    "serve_slow", "serve_drop",
    "shard_crash", "link_down", "link_flap", "mesh_down",
})


class FaultPlan:
    """A seeded, deterministic schedule of injected faults.

    Thread-safe: the feeder thread (stall/feeder_error), the run loop
    (nan/crash/kill), and the checkpointer (ckpt_corrupt) all consult one
    plan concurrently.
    """

    def __init__(self, faults: Optional[dict] = None, seed: int = 0,
                 state_file: Optional[str] = None):
        #: {(kind, at): arg} — arg is None for argless kinds.
        self.faults: dict = dict(faults or {})
        self.seed = int(seed)
        self.state_file = state_file
        self._fired: set = set()
        self._lock = threading.Lock()
        if state_file and os.path.exists(state_file):
            with open(state_file) as f:
                self._fired = {tuple(line.strip().rsplit("@", 1))
                               for line in f if "@" in line}
            self._fired = {(k, int(at)) for k, at in self._fired}

    @classmethod
    def parse(cls, spec: str, state_file: Optional[str] = None,
              kinds: Optional[frozenset] = None) -> "FaultPlan":
        """Parse a ``kind@at[:arg]`` plan. ``kinds`` selects the grammar:
        the compute kinds (default, ``DKTPU_FAULTS``) or the network kinds
        (``_NET_KINDS``, ``DKTPU_NET_FAULTS`` via :meth:`parse_net`)."""
        kinds = _KINDS if kinds is None else kinds
        faults: dict = {}
        seed = 0
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            if entry.startswith("seed="):
                seed = int(entry[5:])
                continue
            if "@" not in entry:
                raise ValueError(
                    f"bad fault entry {entry!r}: expected "
                    "kind@round[:arg] or seed=N")
            kind, at = entry.split("@", 1)
            kind = kind.strip()
            if kind not in kinds:
                raise ValueError(
                    f"unknown fault kind {kind!r}; known: {sorted(kinds)}")
            arg: Optional[float] = None
            if ":" in at:
                at, args = at.split(":", 1)
                arg = float(args)
            faults[(kind, int(at))] = arg
        return cls(faults, seed=seed, state_file=state_file)

    @classmethod
    def parse_net(cls, spec: str,
                  state_file: Optional[str] = None) -> "FaultPlan":
        """Parse a network-fault plan (``DKTPU_NET_FAULTS`` grammar).
        ``state_file`` journals fired faults across a process restart —
        ``ps_crash@R`` restarts the very process consulting the plan, so
        without it the restarted server would re-crash at R forever (the
        ``kill@R`` problem, one subsystem over). The net and compute plans
        may share one file: their kind names never collide."""
        return cls.parse(spec, kinds=_NET_KINDS, state_file=state_file)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        spec = config.env_str("DKTPU_FAULTS")
        if not spec:
            return None
        return cls.parse(spec,
                         state_file=config.env_str("DKTPU_FAULTS_STATE")
                         or None)

    # ------------------------------------------------------------------
    def _fire(self, kind: str, at: int) -> Optional[float]:
        """The fault's arg if (kind, at) is scheduled and not yet fired;
        marks it fired (and journals it) as a side effect, and counts it
        (``resilience.faults_injected``, event ``fault_injected``), and
        dumps the tracing flight ring (a no-op with tracing off)."""
        key = (kind, at)
        with self._lock:
            if key not in self.faults or key in self._fired:
                return None
            self._fired.add(key)
            arg = self.faults[key]
        if self.state_file:
            # Journal BEFORE the fault takes effect: kill@R must not re-fire
            # after the restart it causes.
            with open(self.state_file, "a") as f:
                f.write(f"{kind}@{at}\n")
        telemetry.counter("resilience.faults_injected").add(1)
        telemetry.event("fault_injected", {"fault": kind, "at": at})
        # Dump the flight ring BEFORE the fault takes effect: a kind like
        # ``ps_crash`` SIGKILLs this very process, and the ring is the only
        # record of what it was doing in its final seconds.
        tracing.flight_dump(f"fault:{kind}")
        return arg if arg is not None else 0.0

    def pending(self, kind: str, at: int) -> Optional[float]:
        """Non-consuming peek: the arg (0.0 when argless) if ``(kind, at)``
        is scheduled and NOT yet fired, else None. For conditional faults
        whose trigger is checked repeatedly before it holds (the shard
        server polls ``shard_crash`` every commit until the threshold) —
        :meth:`fire` there would burn the one-shot on the first look."""
        key = (kind, at)
        with self._lock:
            if key not in self.faults or key in self._fired:
                return None
            arg = self.faults[key]
        return arg if arg is not None else 0.0

    # -- queries (all one-shot) ----------------------------------------
    def fire(self, kind: str, at: int) -> Optional[float]:
        """Generic one-shot query: the fault's arg (0.0 when argless) if
        ``(kind, at)`` is scheduled and unfired, else None. The network
        kinds go through this — the chaos proxy and the remote worker loop
        ask by (kind, frame/round index) directly."""
        return self._fire(kind, at)

    def batch_fault(self, round_idx: int) -> Optional[str]:
        """``"nan"``/``"inf"`` if this round's batch should be poisoned."""
        for kind in ("nan", "inf"):
            if self._fire(kind, round_idx) is not None:
                return kind
        return None

    def feeder_stall(self, item: int) -> float:
        """Seconds the feeder should sleep staging ``item`` (0 = no fault)."""
        arg = self._fire("stall", item)
        return float(arg) if arg else 0.0

    def feeder_error(self, item: int) -> bool:
        return self._fire("feeder_error", item) is not None

    def crash(self, round_idx: int) -> bool:
        return self._fire("crash", round_idx) is not None

    def kill(self, round_idx: int) -> bool:
        return self._fire("kill", round_idx) is not None

    def ckpt_corrupt(self, step: int) -> bool:
        return self._fire("ckpt_corrupt", step) is not None

    def feed_gap(self, item: int) -> float:
        """Seconds the stream source should go silent before delivering
        ``item`` (0 = no fault) — the dried-up-feed drill, consumed by the
        source layer so the gap propagates through staging into the
        RoundFeeder stall watchdog."""
        arg = self._fire("feed_gap", item)
        return float(arg) if arg else 0.0

    def drift(self, item: int) -> bool:
        """Whether a distribution shift is scheduled to begin at stream
        ``item``. One-shot like every fault, but the *shift* is permanent:
        the source remembers the trigger and keeps transforming every
        subsequent record (a drifted world does not un-drift by itself)."""
        return self._fire("drift", item) is not None

    def poison_worker(self, round_idx: int, num_workers: int) -> int:
        """Deterministic (seeded) choice of which worker's rows to poison —
        one worker suffices: its non-finite commit contaminates the psum'd
        center for everyone, which is exactly the failure mode to test."""
        if num_workers <= 1:
            return 0
        return (self.seed * 1009 + round_idx) % num_workers

    def __bool__(self) -> bool:
        return bool(self.faults)

    def __repr__(self) -> str:
        items = ";".join(
            f"{k}@{at}" + (f":{arg}" if arg is not None else "")
            for (k, at), arg in sorted(self.faults.items()))
        return f"FaultPlan({items!r}, seed={self.seed})"


# -- ambient plan (env-driven, cached by spec) -----------------------------
_LOCK = threading.Lock()
_CACHED_SPEC: Optional[str] = None
_CACHED_PLAN: Optional[FaultPlan] = None
_EXPLICIT: Optional[FaultPlan] = None
_EXPLICIT_SET = False
_NET_CACHED_SPEC: Optional[str] = None
_NET_CACHED_PLAN: Optional[FaultPlan] = None
_NET_EXPLICIT: Optional[FaultPlan] = None
_NET_EXPLICIT_SET = False


def active_plan() -> Optional[FaultPlan]:
    """The process-ambient FaultPlan (None when no faults are configured).

    Re-parses when ``DKTPU_FAULTS`` changes (fresh fired-state), otherwise
    returns the cached plan so one-shot semantics hold across the run. An
    explicit :func:`set_plan` overrides the environment entirely."""
    global _CACHED_SPEC, _CACHED_PLAN
    if _EXPLICIT_SET:
        return _EXPLICIT
    spec = config.env_str("DKTPU_FAULTS")
    if not spec:
        return None
    with _LOCK:
        if spec != _CACHED_SPEC:
            _CACHED_PLAN = FaultPlan.parse(
                spec, state_file=config.env_str("DKTPU_FAULTS_STATE") or None)
            _CACHED_SPEC = spec
        return _CACHED_PLAN


def set_plan(plan: Optional[FaultPlan]) -> None:
    """Install ``plan`` as the ambient plan (tests; programmatic use).
    ``set_plan(None)`` forces no-faults regardless of the environment."""
    global _EXPLICIT, _EXPLICIT_SET
    with _LOCK:
        _EXPLICIT = plan
        _EXPLICIT_SET = True


def active_net_plan() -> Optional[FaultPlan]:
    """The process-ambient *network* FaultPlan (``DKTPU_NET_FAULTS``), with
    the same cache-by-spec one-shot semantics as :func:`active_plan`. The
    chaos proxy and the netps remote worker loop consult this."""
    global _NET_CACHED_SPEC, _NET_CACHED_PLAN
    if _NET_EXPLICIT_SET:
        return _NET_EXPLICIT
    spec = config.env_str("DKTPU_NET_FAULTS")
    if not spec:
        return None
    with _LOCK:
        if spec != _NET_CACHED_SPEC:
            # The same fired-state journal as the compute plan: `ps_crash`
            # restarts the process that consults this plan, exactly like
            # `kill@R` does — without the journal the restarted server
            # would re-crash at the same commit forever.
            _NET_CACHED_PLAN = FaultPlan.parse_net(
                spec, state_file=config.env_str("DKTPU_FAULTS_STATE")
                or None)
            _NET_CACHED_SPEC = spec
        return _NET_CACHED_PLAN


def set_net_plan(plan: Optional[FaultPlan]) -> None:
    """Install ``plan`` as the ambient network plan (tests)."""
    global _NET_EXPLICIT, _NET_EXPLICIT_SET
    with _LOCK:
        _NET_EXPLICIT = plan
        _NET_EXPLICIT_SET = True


def reset() -> None:
    """Clear the explicit plans and the env caches (the next
    :func:`active_plan` / :func:`active_net_plan` re-reads its env var with
    fresh fired-state)."""
    global _EXPLICIT, _EXPLICIT_SET, _CACHED_SPEC, _CACHED_PLAN
    global _NET_EXPLICIT, _NET_EXPLICIT_SET
    global _NET_CACHED_SPEC, _NET_CACHED_PLAN
    with _LOCK:
        _EXPLICIT = None
        _EXPLICIT_SET = False
        _CACHED_SPEC = None
        _CACHED_PLAN = None
        _NET_EXPLICIT = None
        _NET_EXPLICIT_SET = False
        _NET_CACHED_SPEC = None
        _NET_CACHED_PLAN = None
