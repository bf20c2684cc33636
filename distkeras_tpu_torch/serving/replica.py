"""HA replica sets + the fleet-tenant face of the serving plane (the
port's copy of the JAX package's ``serving/replica.py``).

:class:`ServingReplicaSet` runs N :class:`~distkeras_tpu_torch.serving.
frontend.ServingFrontend` replicas, each with its own registry watching the
same checkpoint directory (so a hot-swap rolls across the set as each poller
notices the new step) and its own bind-probed pool port. ``endpoints()``
renders the comma-separated form ``ServeClient``/``wire.split_endpoints``
walks — kill one replica and the client fails over to the survivors;
that is the whole HA story, exercised by ``tests/test_torch_replica.py``.
Replicas answer on the card unless the set is built with ``device="cpu"``;
the replicas of one set share its model (inference only, so concurrent
forwards never reparametrize it).

:class:`ServingService` adapts a replica set to the fleet runtime duck
protocol (``fleet/job.py``), so serving registers as a first-class tenant
beside training jobs: submit it with ``FleetJob(kind="serving",
min_gang=R)`` and the scheduler's preemption floor keeps at least R
replicas alive — a serving job may be shrunk to its floor but never fully
drained (``FleetScheduler._preempt``), because tail latency is the
tenant's contract.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Union

import torch

from distkeras_tpu_torch.runtime.device import resolve_device
from distkeras_tpu_torch.serving.batcher import parse_buckets
from distkeras_tpu_torch.serving.frontend import ServingFrontend
from distkeras_tpu_torch.serving.registry import ModelRegistry


class ServingReplicaSet:
    """N frontends over one model / one checkpoint directory, on
    ``device`` (default: the first CUDA device; raises where there is
    none — pass ``device="cpu"`` for the CPU)."""

    def __init__(self, model, n: int = 2, buckets=None,
                 directory: Optional[str] = None, host: str = "127.0.0.1",
                 poll_s: Optional[float] = None,
                 max_wait_s: Optional[float] = None,
                 max_queue_rows: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 watch: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.model = model
        self.buckets = parse_buckets() if buckets is None else tuple(buckets)
        self.directory = directory
        self._kw = dict(max_wait_s=max_wait_s,
                        max_queue_rows=max_queue_rows,
                        deadline_s=deadline_s)
        self.host = host
        self.poll_s = poll_s
        self.watch = watch
        self.replicas: list[Optional[ServingFrontend]] = [None] * int(n)
        #: requests answered by replicas already killed or stopped.
        self._served_gone = 0
        self._lock = threading.Lock()

    def start(self) -> "ServingReplicaSet":
        for i in range(len(self.replicas)):
            self.start_replica(i)
        return self

    def start_replica(self, i: int) -> ServingFrontend:
        """(Re)start replica ``i``: fresh registry, fresh pool port —
        exactly what a crashed replica's supervisor would do. The new
        endpoint is filed with the health target registry (``serve<i>``)
        so a MetricsHub on this process scrapes the set automatically."""
        from distkeras_tpu_torch.telemetry.health import register_target

        with self._lock:
            if self.replicas[i] is not None:
                return self.replicas[i]
            registry = ModelRegistry(self.model, self.buckets,
                                     directory=self.directory,
                                     poll_s=self.poll_s,
                                     device=self.device)
            if self.watch and self.directory is not None:
                registry.start()
            front = ServingFrontend(registry, host=self.host,
                                    **self._kw).start()
            self.replicas[i] = front
        register_target(front.endpoint, f"serve{i}")
        return front

    def kill(self, i: int) -> None:
        """Chaos: crash replica ``i`` (no drain, no typed replies). The
        health registration is left in place on purpose: a crash is
        exactly what the ``target_down`` sentinel exists to catch, and
        ``start_replica(i)`` re-files the name with the new endpoint."""
        with self._lock:
            front, self.replicas[i] = self.replicas[i], None
        if front is not None:
            front.kill()
            front.registry.close()
            with self._lock:
                self._served_gone += front.served

    def stop_replica(self, i: int) -> None:
        """Graceful: drain replica ``i``'s queue with typed replies (and
        un-file it from the health registry — a deliberate stop must not
        page as an outage)."""
        from distkeras_tpu_torch.telemetry.health import unregister_target

        with self._lock:
            front, self.replicas[i] = self.replicas[i], None
        if front is not None:
            unregister_target(f"serve{i}")
            front.close()
            front.registry.close()
            with self._lock:
                self._served_gone += front.served

    def endpoints(self) -> str:
        """Comma-separated live endpoints — the ``ServeClient`` /
        ``wire.split_endpoints`` failover form."""
        live = [f.endpoint for f in self.replicas if f is not None]
        return ",".join(live)

    def served(self) -> int:
        """Requests answered by every replica this set ever ran (the JAX
        package's counts only the live ones, so a shrink there takes its
        replica's requests off the fleet's ``preempt@R`` clock)."""
        with self._lock:
            return self._served_gone + sum(
                f.served for f in self.replicas if f is not None)

    def close(self) -> None:
        for i in range(len(self.replicas)):
            self.stop_replica(i)


class ServingService:
    """Fleet-runtime adapter: each granted worker runs one replica.

    Duck protocol (``fleet/job.py``): ``ensure_started`` builds the
    replica set (no replicas yet); ``worker_main(i, should_run)`` starts
    replica ``i`` and parks until released, then drains it gracefully —
    a scheduler shrink removes a replica, the client walk covers the gap;
    ``progress()`` is cumulative requests served (so chaos ``preempt@R``
    indices advance with real load); ``done()`` is False until ``close``
    — serving has no natural end, the floor + never-drain rule is what
    keeps it running.
    """

    def __init__(self, model, buckets=None,
                 directory: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None, **kw):
        self.device = resolve_device(device)
        self._model = model
        self._buckets = buckets
        self._directory = directory
        self._kw = kw
        self.replica_set: Optional[ServingReplicaSet] = None
        self._closed = False
        self._lock = threading.Lock()

    def ensure_started(self) -> None:
        with self._lock:
            if self.replica_set is None:
                self.replica_set = ServingReplicaSet(
                    self._model, n=0, buckets=self._buckets,
                    directory=self._directory, device=self.device,
                    **self._kw)

    def grow_slots(self, n: int) -> None:
        """Grow the replica slot table to ``n``. (The JAX package names
        this hook ``worker_slots``, the name the scheduler reads as a
        runtime's integer slot bound at submit, so its own scheduler
        refuses the service with a ``TypeError``; the service has no slot
        bound — any granted worker id gets a replica.)"""
        with self._lock:
            rs = self.replica_set
            while rs is not None and len(rs.replicas) < n:
                rs.replicas.append(None)

    def worker_main(self, worker_id: int, should_run) -> None:
        self.grow_slots(worker_id + 1)
        self.replica_set.start_replica(worker_id)
        try:
            while should_run() and not self._closed:
                time.sleep(0.02)
        finally:
            self.replica_set.stop_replica(worker_id)

    def endpoints(self) -> str:
        return self.replica_set.endpoints() if self.replica_set else ""

    def progress(self) -> int:
        rs = self.replica_set
        return rs.served() if rs else 0

    def done(self) -> bool:
        return self._closed

    def revoke(self, worker_id: int) -> None:
        rs = self.replica_set
        if rs is not None and worker_id < len(rs.replicas):
            rs.kill(worker_id)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self.replica_set is not None:
            self.replica_set.close()
