"""The fleet scheduler: many tenants' jobs on one worker pool.

The reference launched exactly one training run per cluster
(``Trainer.train`` over a fixed Spark executor set); the ROADMAP's north
star is heavy traffic from many tenants on one pool. The PS layer already
supports everything elasticity needs — lease-based eviction + mid-run
rejoin, commit-seq resume across reconnects, durable failover — but
nothing above a single job could exploit it. This module is that
control plane (the port's copy of the JAX package's
``fleet/scheduler.py``; only its imports differ):

* **Gang placement.** A job starts only when its ``min_gang`` slots can
  be granted at once (partial gangs would deadlock two half-placed jobs
  against each other — the classic reason gang schedulers exist).
  Placement is priority-then-FIFO and head-blocking: the queue's head
  reserves capacity rather than being starved by smaller jobs slipping
  past it.
* **Per-tenant quotas.** A tenant's jobs can never hold more slots than
  its quota (``quotas={tenant: N}`` / ``DKTPU_FLEET_QUOTA``), so one
  tenant's burst cannot crowd the pool.
* **Preemption-driven shrink/expand.** When a higher-priority job cannot
  fit, lower-priority victims are *shrunk* — workers above their gang
  floor are released and their leases revoked on the victim's parameter
  server (:meth:`~distkeras_tpu_torch.netps.server.PSServer.revoke`), so the
  worker sees a normal eviction and the discipline's staleness rule
  absorbs the churn. A victim is NEVER shrunk below ``min_gang``; if the
  floor is reached and capacity is still short, the lowest-priority
  victim is fully preempted: gracefully drained (flag first, lease
  revocation after ``DKTPU_FLEET_PREEMPT_GRACE``) and re-queued at its
  original FIFO position, its parameter server — and therefore all its
  progress — kept warm for the re-grant. When capacity frees, running
  jobs re-expand elastically up to ``max_workers`` (round-robin in
  priority order), re-granted workers rejoining their PS mid-run with
  their commit sequences intact.
* **Chaos.** ``preempt@R[:N]`` in ``DKTPU_NET_FAULTS`` forcibly preempts
  N workers when the fleet's cumulative commit count crosses R — the
  capacity-squeeze drill the 3-jobs chaos smoke drives alongside worker
  kills, partitions, and a PS crash.

Telemetry: every per-job metric is labeled ``fleet.<metric>.<tenant>.
<job>`` (see :func:`distkeras_tpu_torch.telemetry.label_suffix`) and every
worker thread runs under a ``scoped_labels(tenant=..., job=...)`` scope,
so events fired anywhere below (evictions, supervisor retries, fault
injections) carry the attribution. ``python -m distkeras_tpu_torch.telemetry
report`` renders the per-tenant table from these names.

Threading model: ``tick()`` (one scheduling pass) and ``submit()`` are
serialized by one lock; worker threads never take it — they only read
their release flag and drive the job's runtime. ``run()`` loops tick on
the caller's thread; ``start()``/``wait()``/``close()`` run it on a
background thread for drivers that submit mid-run.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from distkeras_tpu_torch.fleet.job import (
    DONE,
    DRAINING,
    FAILED,
    QUEUED,
    RUNNING,
    FleetJob,
)
from distkeras_tpu_torch.resilience import faults as _faults
from distkeras_tpu_torch.runtime import config


def parse_quotas(spec: str) -> dict:
    """``"acme=4;bidco=2"`` -> ``{"acme": 4, "bidco": 2}``."""
    quotas: dict = {}
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(
                f"bad quota entry {entry!r}: expected tenant=N")
        tenant, n = entry.split("=", 1)
        quotas[tenant.strip()] = int(n)
    return quotas


class _Worker:
    """One granted slot: the thread running ``runtime.worker_main`` plus
    its release protocol state."""

    __slots__ = ("wid", "thread", "release", "released_at", "revoked")

    def __init__(self, wid: int, thread: threading.Thread):
        self.wid = wid
        self.thread = thread
        self.release = threading.Event()
        self.released_at: Optional[float] = None
        self.revoked = False


class FleetScheduler:
    """Run many :class:`~distkeras_tpu_torch.fleet.job.FleetJob`\\ s on one
    pool of ``capacity`` worker slots. See the module docstring for the
    placement/preemption rules."""

    def __init__(self, capacity: Optional[int] = None,
                 quotas: Optional[dict] = None,
                 tick_s: Optional[float] = None,
                 preempt_grace: Optional[float] = None,
                 max_restarts: Optional[int] = None,
                 preemption: bool = True,
                 expansion_policy=None,
                 health_hook=None,
                 clock=None,
                 thread_factory=None):
        if capacity is None:
            capacity = config.env_int("DKTPU_FLEET_CAPACITY")
        if capacity < 1:
            raise ValueError(
                "FleetScheduler needs a positive capacity (pass capacity= "
                "or set DKTPU_FLEET_CAPACITY)")
        self.capacity = int(capacity)
        self.quotas = dict(quotas) if quotas is not None else parse_quotas(
            config.env_str("DKTPU_FLEET_QUOTA"))
        self.tick_s = float(tick_s if tick_s is not None
                            else config.env_float("DKTPU_FLEET_TICK"))
        self.preempt_grace = float(
            preempt_grace if preempt_grace is not None
            else config.env_float("DKTPU_FLEET_PREEMPT_GRACE"))
        self.max_restarts = int(
            max_restarts if max_restarts is not None
            else config.env_int("DKTPU_FLEET_MAX_RESTARTS"))
        self.preemption = bool(preemption)
        #: optional expansion gate (duck-typed: ``observe(label, workers,
        #: progress)`` fed each tick, ``allow_expand(label, workers)``
        #: consulted before each elastic grant) — the tuner's
        #: :class:`~distkeras_tpu_torch.netps.tuner.fleet.
        #: MarginalThroughputPolicy` grows a job only while the last
        #: granted worker measurably moved its commit rate. Gates
        #: EXPANSION only; placement, gang minimums, and every shrink
        #: floor are untouched. None (default, or autotune off) keeps the
        #: static quota behavior bit-for-bit.
        if expansion_policy is None and config.env_bool("DKTPU_NET_AUTOTUNE"):
            from distkeras_tpu_torch.netps.tuner.fleet import (
                MarginalThroughputPolicy)
            expansion_policy = MarginalThroughputPolicy()
        self.expansion_policy = expansion_policy
        #: optional health-plane hook (duck-typed: ``is_down(endpoint)``,
        #: a ``MetricsHub`` fits) — consulted each tick for RUNNING jobs.
        #: A job whose PS endpoint fails liveness is drained-to-requeue
        #: immediately (progress lives on the PS, so the re-placed gang
        #: resumes) instead of its workers burning the restart budget one
        #: lease lapse at a time. The scheduler also registers each
        #: RUNNING job's endpoint with the health target registry, so a
        #: hub on this driver discovers the fleet without configuration.
        self.health_hook = health_hook
        #: the scheduler's timeline (grace windows, run/wait deadlines)
        #: and its worker-thread constructor. Both injectable so the
        #: fleet simulator (``distkeras_tpu_torch.sim``) ticks the REAL
        #: placement/preemption/reap logic on a virtual clock with
        #: cooperative stand-in threads; the defaults are bit-for-bit
        #: the previous behavior.
        self._clock = clock if clock is not None else time.monotonic
        self._thread_factory = (thread_factory if thread_factory
                                is not None else threading.Thread)
        #: endpoints already acted on while down — one requeue per
        #: outage, not one per tick (cleared when the target recovers).
        self._health_acted: set = set()
        self._jobs: list = []
        #: job -> {wid: _Worker} for every slot currently occupied (a
        #: released worker occupies its slot until its thread is reaped).
        self._granted: dict = {}
        self._lock = threading.RLock()
        #: shrink-floor violations — the invariant the cycle tests assert
        #: stays zero: the scheduler never *releases* a worker that would
        #: take a RUNNING job below its min gang.
        self.floor_violations = 0
        #: next cumulative-commit index the preempt@R fault scan resumes
        #: from, and forced preemptions still owed to the chaos plan.
        self._fault_seen = 0
        self._forced = 0
        self._loop_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        #: slots the blocked queue head is waiting on (set by _place each
        #: tick): _expand must leave them idle, or every slot a preemption
        #: frees is re-granted to the victim and the head never places —
        #: a shrink/expand thrash loop.
        self._reserve = 0
        #: jobs whose runtime.close() is owed but must NOT run under the
        #: scheduler lock: ElasticTraining.close pulls the final center
        #: with the full client retry envelope, and one tenant's dead PS
        #: must not stall every other tenant's scheduling. tick() drains
        #: this after releasing the lock; close() drains leftovers.
        self._pending_close: list = []

    # -- submission --------------------------------------------------------
    def submit(self, job: FleetJob) -> FleetJob:
        from distkeras_tpu_torch import telemetry

        if job.min_gang > self.capacity:
            raise ValueError(
                f"{job.job_id}: min_gang {job.min_gang} exceeds pool "
                f"capacity {self.capacity} — it could never be placed")
        quota = self.quotas.get(job.tenant)
        if quota is not None and job.min_gang > quota:
            raise ValueError(
                f"{job.job_id}: min_gang {job.min_gang} exceeds tenant "
                f"quota {quota} — it could never be placed")
        slots = getattr(job.runtime, "worker_slots", None)
        if slots is not None and job.max_workers > int(slots):
            raise ValueError(
                f"{job.job_id}: max_workers {job.max_workers} exceeds the "
                f"runtime's worker_slots {int(slots)} — expansion past the "
                "data layout would crash every granted worker")
        with self._lock:
            job._stamp_submitted()
            job.state = QUEUED
            self._jobs.append(job)
            self._granted.setdefault(job, {})
        telemetry.counter("fleet.submitted").add(1)
        telemetry.event("fleet_submit", {
            "tenant": job.tenant, "job": job.name,
            "priority": job.priority, "min_gang": job.min_gang,
            "max_workers": job.max_workers})
        return job

    # -- introspection -----------------------------------------------------
    def _active(self, job: FleetJob) -> int:
        """Workers granted to ``job`` and not flagged for release."""
        return sum(1 for w in self._granted[job].values()
                   if not w.release.is_set())

    def _slots_used(self) -> int:
        return sum(len(ws) for ws in self._granted.values())

    def _slots_releasing(self) -> int:
        """Slots flagged for release whose threads have not exited yet —
        capacity already on its way back to the pool. The placement
        shortfall must credit these, or the head job re-preempts fresh
        victims every tick while the first wave's threads wind down."""
        return sum(1 for ws in self._granted.values()
                   for w in ws.values() if w.release.is_set())

    def _tenant_used(self, tenant: str) -> int:
        return sum(len(ws) for j, ws in self._granted.items()
                   if j.tenant == tenant)

    def _quota_headroom(self, tenant: str) -> int:
        quota = self.quotas.get(tenant)
        if quota is None:
            return self.capacity
        return max(0, int(quota) - self._tenant_used(tenant))

    def stats(self) -> dict:
        """Point-in-time snapshot per job (tests and operators)."""
        with self._lock:
            return {
                job.job_id: {
                    "state": job.state, "tenant": job.tenant,
                    "priority": job.priority,
                    "granted": len(self._granted[job]),
                    "active": self._active(job),
                    "min_gang": job.min_gang,
                    "max_workers": job.max_workers,
                    "preemptions": job.preemptions,
                    "shrinks": job.shrinks, "expands": job.expands,
                    "restarts": job.restarts, "requeues": job.requeues,
                    "debt": job.debt,
                }
                for job in self._jobs
            }

    def jobs(self) -> list:
        with self._lock:
            return list(self._jobs)

    def all_terminal(self) -> bool:
        with self._lock:
            return all(j.state in (DONE, FAILED) for j in self._jobs)

    # -- the scheduling pass ----------------------------------------------
    def tick(self) -> None:
        """One pass: reap finished/crashed workers, honor the chaos plan,
        place queued gangs, expand elastically, then finalize completed
        jobs (runtime close + terminal event) OUTSIDE the lock."""
        with self._lock:
            self._reap()
            self._consult_health()
            self._consult_chaos()
            if self._forced:
                # A full drain can take more than asked; never owe negative.
                self._forced = max(
                    0, self._forced - self._preempt(self._forced, None,
                                                    forced=True))
            self._place()
            self._expand()
            self._export_gauges()
            pending, self._pending_close = self._pending_close, []
        for job in pending:
            self._close_runtime(job)

    def _close_runtime(self, job: FleetJob) -> None:
        """Finalize one completed/failed job's runtime (no lock held) and
        emit its terminal event; a close failure downgrades DONE to
        FAILED."""
        from distkeras_tpu_torch import telemetry

        err: Optional[BaseException] = None
        try:
            job.runtime.close()
        except Exception as e:  # noqa: BLE001 - close failure -> job failure
            err = e
        if err is not None:
            with self._lock:
                if job.state == DONE:
                    job.state = FAILED
                    job.error = err
        telemetry.event(
            "fleet_done" if job.state == DONE else "fleet_failed",
            {"tenant": job.tenant, "job": job.name})

    def run(self, timeout: Optional[float] = None) -> dict:
        """Tick until every submitted job is terminal (or ``timeout``
        seconds elapse — remaining jobs are then torn down and reported
        in whatever state teardown left them). Returns :meth:`stats`."""
        deadline = None if timeout is None else self._clock() + timeout
        while not self.all_terminal():
            if deadline is not None and self._clock() > deadline:
                self.close()
                break
            self.tick()
            time.sleep(self.tick_s)
        return self.stats()

    def start(self) -> "FleetScheduler":
        """Run the tick loop on a background thread (idempotent); drivers
        submit concurrently and :meth:`wait` for completion."""
        if self._loop_thread is None:
            self._stop.clear()
            # Joined in close() through the _loop_thread attribute — an
            # indirection the static join-tracking cannot follow.
            t = threading.Thread(target=self._loop,  # dk: disable=DK203
                                 name="fleet-scheduler")
            t.start()
            self._loop_thread = t
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(self.tick_s)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted job is terminal; False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.all_terminal():
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(min(self.tick_s, 0.05))
        return True

    def close(self) -> None:
        """Shut down: stop the loop thread, release every worker, join
        every thread, close every runtime. This is teardown, not graceful
        completion — non-terminal jobs stay in whatever state they held."""
        self._stop.set()
        if self._loop_thread is not None:
            self._loop_thread.join()
            self._loop_thread = None
        with self._lock:
            for job in self._jobs:
                for w in self._granted[job].values():
                    self._flag_release(job, w)
            workers = [w for ws in self._granted.values()
                       for w in ws.values()]
        for w in workers:
            w.thread.join()
        with self._lock:
            to_close = []
            for job in self._jobs:
                self._granted[job].clear()
                if job.state not in (DONE, FAILED):
                    to_close.append(job)
            pending, self._pending_close = self._pending_close, []
        for job in pending:
            self._close_runtime(job)
        for job in to_close:
            # Outside the lock for the same reason as _pending_close —
            # and best-effort: this is teardown, not completion.
            try:
                job.runtime.close()
            except Exception:  # noqa: BLE001 - teardown best effort
                pass

    # -- internals (lock held) --------------------------------------------
    def _label(self, job: FleetJob) -> str:
        from distkeras_tpu_torch import telemetry

        return (f"{telemetry.sanitize_label(job.tenant)}."
                f"{telemetry.sanitize_label(job.name)}")

    def _spawn(self, job: FleetJob, wid: int) -> None:
        from distkeras_tpu_torch import telemetry

        def body() -> None:
            with telemetry.scoped_labels(tenant=job.tenant, job=job.name):
                try:
                    job.runtime.worker_main(
                        wid, lambda: not worker.release.is_set())
                except BaseException as e:  # noqa: BLE001 - surfaced below
                    # Surfaced on the job (the reaper's restart budget
                    # decides what happens); the thread itself must die
                    # quietly or the slot would leak.
                    job.error = e

        thread = self._thread_factory(
            target=body, name=f"fleet-{self._label(job)}-w{wid}")
        worker = _Worker(wid, thread)
        self._granted[job][wid] = worker
        thread.start()

    def _flag_release(self, job: FleetJob, w: _Worker) -> None:
        """Begin releasing one worker: cooperative flag now, lease
        revocation after the grace window (immediately when grace=0)."""
        if w.release.is_set():
            return
        w.release.set()
        w.released_at = self._clock()
        if self.preempt_grace <= 0:
            self._revoke(job, w)

    def _revoke(self, job: FleetJob, w: _Worker) -> None:
        if w.revoked:
            return
        w.revoked = True
        try:
            job.runtime.revoke(w.wid)
        except Exception:  # noqa: BLE001 - revocation is best-effort
            pass  # the lease will lapse on its own; eviction still lands

    def _reap(self) -> None:
        from distkeras_tpu_torch import telemetry

        now = self._clock()
        for job in self._jobs:
            workers = self._granted[job]
            for wid, w in list(workers.items()):
                if w.thread.is_alive():
                    # Grace expired on a released straggler: revoke the
                    # lease so a worker wedged in a long RPC is evicted
                    # rather than squatting on the slot's membership.
                    if (w.release.is_set() and not w.revoked
                            and now - w.released_at >= self.preempt_grace):
                        self._revoke(job, w)
                    continue
                w.thread.join()
                del workers[wid]
                if (job.state == RUNNING and not w.release.is_set()
                        and not job.runtime.done()):
                    # A worker died without being asked to: crash. Restart
                    # it on the same wid (the PS rejoin path resumes its
                    # commit sequence) until the budget runs out.
                    if job.restarts < self.max_restarts:
                        job.restarts += 1
                        telemetry.counter(
                            f"fleet.restarts.{self._label(job)}").add(1)
                        telemetry.event("fleet_worker_restart", {
                            "tenant": job.tenant, "job": job.name,
                            "worker": wid, "restart": job.restarts,
                            "error": repr(job.error)})
                        self._spawn(job, wid)
                    else:
                        telemetry.event("fleet_job_failed", {
                            "tenant": job.tenant, "job": job.name,
                            "error": repr(job.error)})
                        self._drain(job, to_state=FAILED)
            if job.state == RUNNING and job.runtime.done():
                self._drain(job, to_state=DONE)
            if job.state == DRAINING and not workers:
                self._finish_drain(job)

    def _drain(self, job: FleetJob, to_state: str) -> None:
        """Flag every worker for release and park the job in DRAINING;
        :meth:`_finish_drain` lands it in ``to_state`` once the last
        thread exits."""
        job.state = DRAINING
        job._drain_to = to_state
        for w in self._granted[job].values():
            self._flag_release(job, w)
        if not self._granted[job]:
            self._finish_drain(job)

    def _finish_drain(self, job: FleetJob) -> None:
        """Land a fully-drained job (lock held): requeue, or mark terminal
        and queue its runtime close for after the lock is released."""
        from distkeras_tpu_torch import telemetry

        to_state = getattr(job, "_drain_to", QUEUED)
        if to_state == QUEUED:
            job.state = QUEUED
            job.requeues += 1
            telemetry.event("fleet_requeue", {
                "tenant": job.tenant, "job": job.name})
            return
        job.state = to_state
        self._pending_close.append(job)

    def _consult_health(self) -> None:
        """Health-plane pass (lock held): keep RUNNING jobs' endpoints
        registered for scraping and, when the hook reports one down,
        requeue that job once per outage (see ``health_hook``)."""
        if self.health_hook is None:
            return
        from distkeras_tpu_torch import telemetry
        from distkeras_tpu_torch.telemetry.health import register_target

        for job in self._jobs:
            if job.state != RUNNING:
                continue
            ep = getattr(job.runtime, "endpoint", None)
            if not ep:
                continue
            register_target(ep, f"fleet.{self._label(job)}")
            if not self.health_hook.is_down(ep):
                continue
            if ep in self._health_acted:
                continue  # already requeued for this outage
            self._health_acted.add(ep)
            telemetry.counter("fleet.liveness_requeues").add(1)
            telemetry.event("fleet_liveness_requeue", {
                "tenant": job.tenant, "job": job.name, "endpoint": ep})
            self._drain(job, to_state=QUEUED)
        # Forget an outage once the target answers again, so the NEXT
        # outage of the same endpoint gets its own requeue.
        self._health_acted = {ep for ep in self._health_acted
                              if self.health_hook.is_down(ep)}

    def _consult_chaos(self) -> None:
        """Scan the ``preempt@R`` schedule over every cumulative-commit
        index crossed since the last tick (commit counts jump by whole
        windows, so exact-match firing alone would skip entries)."""
        plan = _faults.active_net_plan()
        if plan is None:
            return
        total = 0
        for job in self._jobs:
            try:
                total += int(job.runtime.progress())
            except Exception:  # noqa: BLE001 - a closed runtime still counts 0
                pass
        for at in range(self._fault_seen, total + 1):
            arg = plan.fire("preempt", at)
            if arg is not None:
                # tick() holds the scheduler lock around this call —
                # lexically outside the `with`, hence the suppression.
                self._forced += max(1, int(arg))  # dk: disable=DK202
        self._fault_seen = max(self._fault_seen, total + 1)

    def _victims(self, req_priority: Optional[int]) -> list:
        """RUNNING jobs preemptible for a requester at ``req_priority``
        (None = the chaos drill: anyone), lowest priority first, youngest
        first within a priority."""
        out = [j for j in self._jobs if j.state == RUNNING
               and (req_priority is None or j.priority < req_priority)]
        out.sort(key=lambda j: (j.priority, -(j.submit_idx or 0)))
        return out

    def _preempt(self, n: int, req_priority: Optional[int],
                 forced: bool = False) -> int:
        """Free up to ``n`` slots by preemption; returns how many were
        actually taken. Shrinks above-floor victims first; full-drains
        the lowest-priority victim only when every floor is reached."""
        from distkeras_tpu_torch import telemetry

        taken = 0
        for job in self._victims(req_priority):
            while taken < n and self._active(job) > job.min_gang:
                self._shrink_one(job)
                taken += 1
            if taken >= n:
                break
        if taken < n:
            for job in self._victims(req_priority):
                if taken >= n:
                    break
                if getattr(job, "kind", "training") == "serving":
                    # Serving jobs shrink to their floor (above) but are
                    # never fully drained: a drain would take the replica
                    # set offline, and tail latency is the whole contract.
                    telemetry.counter(
                        "fleet.serving_drains_refused").add(1)
                    continue
                active = self._active(job)
                if active == 0:
                    continue
                job.preemptions += active
                job.debt += active
                taken += active
                telemetry.counter(
                    f"fleet.preemptions.{self._label(job)}").add(active)
                telemetry.event("fleet_preempt_drain", {
                    "tenant": job.tenant, "job": job.name,
                    "workers": active, "forced": forced})
                self._drain(job, to_state=QUEUED)
        return taken

    def _shrink_one(self, job: FleetJob) -> None:
        """Release the highest-wid active worker of ``job`` (floor already
        checked by the caller — re-checked here as the invariant)."""
        from distkeras_tpu_torch import telemetry

        active = [w for w in self._granted[job].values()
                  if not w.release.is_set()]
        if len(active) - 1 < job.min_gang and job.state == RUNNING:
            self.floor_violations += 1
            return
        w = max(active, key=lambda w: w.wid)
        self._flag_release(job, w)
        job.shrinks += 1
        job.preemptions += 1
        job.debt += 1
        telemetry.counter(f"fleet.preemptions.{self._label(job)}").add(1)
        telemetry.counter(f"fleet.shrinks.{self._label(job)}").add(1)
        telemetry.event("fleet_shrink", {
            "tenant": job.tenant, "job": job.name, "worker": w.wid})

    def _place(self) -> None:
        """Gang placement: priority-then-FIFO, head-blocking. The head
        that cannot fit issues preemption requests (capacity frees on a
        later tick once victims' threads exit) and blocks the queue."""
        from distkeras_tpu_torch import telemetry

        self._reserve = 0
        queued = [j for j in self._jobs if j.state == QUEUED]
        queued.sort(key=lambda j: (-j.priority, j.submit_idx or 0))
        for job in queued:
            free = self.capacity - self._slots_used()
            if self._quota_headroom(job.tenant) < job.min_gang:
                # Quota-blocked: skip, don't head-block. Waiting pools
                # nothing for this job (only its OWN tenant finishing
                # frees headroom), so letting it block the queue would
                # starve every other tenant behind it for no gain.
                continue
            if free < job.min_gang:
                shortfall = job.min_gang - free - self._slots_releasing()
                if self.preemption and shortfall > 0:
                    self._preempt(shortfall, job.priority)
                # Earmark the head's whole gang: slots freed by the
                # victims' exiting threads must pool up for it, not leak
                # into elastic expansion.
                self._reserve = job.min_gang
                break  # head-blocking: capacity frees on a later tick
            job.state = RUNNING
            job.error = None
            job.runtime.ensure_started()
            grant = min(job.min_gang + job.debt,
                        job.max_workers, free,
                        self._quota_headroom(job.tenant))
            for wid in range(grant):
                self._spawn(job, wid)
            job.debt = max(0, job.debt - grant)
            telemetry.counter(f"fleet.placements.{self._label(job)}").add(1)
            telemetry.event("fleet_start", {
                "tenant": job.tenant, "job": job.name, "workers": grant,
                "requeues": job.requeues})

    def _expand(self) -> None:
        """Distribute leftover slots round-robin over running jobs below
        their max (priority order) — the re-expansion half of elasticity."""
        from distkeras_tpu_torch import telemetry

        while True:
            free = self.capacity - self._slots_used() - self._reserve
            if free <= 0:
                return
            candidates = [
                j for j in self._jobs
                if j.state == RUNNING and self._active(j) < j.max_workers
                and len(self._granted[j]) < j.max_workers
                and self._quota_headroom(j.tenant) > 0
            ]
            if not candidates:
                return
            candidates.sort(key=lambda j: (-j.priority, j.submit_idx or 0))
            granted_any = False
            for job in candidates:
                if (self.capacity - self._slots_used()
                        - self._reserve) <= 0:
                    return
                if (len(self._granted[job]) >= job.max_workers
                        or self._quota_headroom(job.tenant) <= 0):
                    continue
                if (self.expansion_policy is not None
                        and not self.expansion_policy.allow_expand(
                            self._label(job), self._active(job))):
                    # Measured marginal throughput flattened at the
                    # current grant: leave the slot for a tenant that can
                    # still use it. Re-evaluated every tick — a later
                    # rate change (straggler recovered, co-tenant left)
                    # re-opens expansion.
                    continue
                wid = next(i for i in range(job.max_workers)
                           if i not in self._granted[job])
                self._spawn(job, wid)
                job.expands += 1
                job.debt = max(0, job.debt - 1)
                granted_any = True
                telemetry.counter(
                    f"fleet.expands.{self._label(job)}").add(1)
                telemetry.event("fleet_expand", {
                    "tenant": job.tenant, "job": job.name, "worker": wid})
            if not granted_any:
                return

    def _export_gauges(self) -> None:
        from distkeras_tpu_torch import telemetry

        for job in self._jobs:
            label = self._label(job)
            telemetry.gauge(f"fleet.granted.{label}").set(
                float(self._active(job)))
            telemetry.gauge(f"fleet.preempt_debt.{label}").set(
                float(job.debt))
            if self.expansion_policy is not None and job.state == RUNNING:
                try:
                    progress = int(job.runtime.progress())
                except Exception:  # noqa: BLE001 - a dead runtime is reaped
                    continue      # by _reap; the policy just skips a sample
                self.expansion_policy.observe(
                    label, self._active(job), progress)
