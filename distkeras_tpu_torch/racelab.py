"""A genuinely raced parameter server, for validating the async mapping
(the port's counterpart of ``distkeras_tpu/racelab.py``).

The framework maps the reference's asynchronous disciplines onto
deterministic window-K folds (``parallel/disciplines.py``). This module
re-creates the reference's actual architecture on host threads, so that
claim can be measured rather than asserted:

* a **parameter-server object guarding the center variable with a plain
  lock** (the reference's ``SocketParameterServer.handle_commit``: one
  handler thread per worker, ``with lock: fold(delta)``);
* **N worker threads** that each loop ``pull -> K local steps -> commit``
  with NO barriers — commits land in whatever order the OS schedules, and
  staleness is real (DynSGD's counter semantics: server update counter
  minus the worker's pull-time counter), not simulated.

The center lives on the server's device (the card by default) as f32
tensors, seated as one flat buffer (``netps/fold.py seat_center``), and
every commit folds under the lock through
:func:`~distkeras_tpu_torch.netps.fold.fold_delta`, the function the
port's ``PSServer`` applies: on the card one CUDA ``fold_commit`` launch a
commit, on the CPU its plain twin (bit-equal to the JAX package's numpy
fold, which this server's reference folds with).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from distkeras_tpu_torch.netps.errors import ServerClosedError
from distkeras_tpu_torch.netps.fold import (
    PinnedPool,
    check_discipline,
    fold_delta,
    host_mirror,
    seat_center,
    stage_commit,
)
from distkeras_tpu_torch.runtime.device import resolve_device


def _host32(a) -> np.ndarray:
    """``a`` (a tensor on any device, or an array) as host f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


class RacedParameterServer:
    """The reference's server half: lock + fold, commit order = thread race.

    ``discipline``: 'downpour' (center += delta), 'adag' (center +=
    delta/K, the worker pre-normalizes), 'dynsgd' (center +=
    delta/(staleness+1)), or 'aeasgd'/'eamsgd' (center += elastic
    difference — the reference routed both elastic trainers through the
    plain ``DeltaParameterServer``; all elasticity lives on the worker
    side).

    ``device`` (default: the first CUDA device; raises where there is none
    — pass ``device="cpu"`` for the CPU) holds the center. :meth:`pull`
    and :meth:`center` return host numpy copies.
    """

    def __init__(self, center: Sequence, discipline: str = "adag",
                 device: Optional[Union[str, torch.device]] = None):
        check_discipline(discipline)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._flat, self._offsets, self._center = seat_center(
            [_host32(a) for a in center], self.device)
        self._pool = PinnedPool() if self.device.type == "cuda" else None
        self._updates = 0  # server update counter (DynSGD staleness basis)
        self._closed = False
        self.discipline = discipline
        #: realized staleness of each commit, in commit order (recorded for
        #: EVERY discipline — the race-happened evidence; only dynsgd also
        #: *scales* by it).
        self.commit_log: list[int] = []

    def close(self) -> None:
        """Shut the server: every subsequent ``pull``/``commit`` raises a
        typed :class:`ServerClosedError`, so a leaked worker thread exits
        its loop instead of committing into a dead center forever."""
        with self._lock:
            self._closed = True

    def _check_open(self) -> None:
        if self._closed:
            raise ServerClosedError("RacedParameterServer is closed")

    def _host_copy(self) -> list[np.ndarray]:
        return [np.array(a) for a in host_mirror(self._flat, self._offsets,
                                                 self._center)]

    def pull(self) -> tuple[list[np.ndarray], int]:
        with self._lock:
            self._check_open()
            return self._host_copy(), self._updates

    def commit(self, delta: Sequence, pulled_counter: int) -> None:
        with self._lock:
            self._check_open()
            staleness = self._updates - pulled_counter
            self.commit_log.append(staleness)
            staged = stage_commit([_host32(d) for d in delta], self.device,
                                  self._pool)
            fold_delta(self._center, staged, self.discipline, staleness)
            self._updates += 1

    def center(self) -> list[np.ndarray]:
        with self._lock:
            return self._host_copy()


def run_raced(
    *,
    center: Sequence,
    local_steps: Callable,
    worker_batches: Sequence[Sequence],
    window: int,
    discipline: str = "adag",
    overlap_first_round: bool = False,
    alpha: float = 0.05,
    device: Optional[Union[str, torch.device]] = None,
) -> tuple[list[np.ndarray], RacedParameterServer]:
    """Race ``len(worker_batches)`` threads against one server on
    ``device``.

    ``local_steps(params_list, batch) -> params_list`` runs the K-step
    local window (thread-safe: with the port's local loops, one loop per
    thread, since a loop reparametrizes its module for the length of a
    call); it may return host arrays or tensors on any device. For
    'eamsgd' the callable may carry per-worker auxiliary state (momentum
    velocities): ``local_steps(params_list, batch, aux) -> (params_list,
    aux)`` with ``aux=None`` on the first round. ``worker_batches[w]`` is
    worker w's sequence of per-round batches — its Spark-partition
    analogue; one commit per batch.

    Elastic disciplines ('aeasgd'/'eamsgd') run the reference's worker
    loop: the local replica PERSISTS across rounds; each round the worker
    pulls the center, runs K local steps from its own replica, computes
    ``e = alpha*(w_local − center_pulled)``, moves itself ``w_local −= e``,
    and commits ``e`` (server: center += e).

    ``overlap_first_round`` holds every worker at a barrier after its first
    pull, guaranteeing the first W commits race (staleness 0..W-1 realized
    deterministically) even on hosts whose scheduler would otherwise
    serialize the threads. Later rounds race freely either way.

    Returns the final center (host numpy) and the server (whose
    ``commit_log`` shows the realized staleness distribution).
    """
    ps = RacedParameterServer(center, discipline, device=device)
    errors: list[BaseException] = []
    elastic = discipline in ("aeasgd", "eamsgd")
    stateful = discipline == "eamsgd"
    gate = (threading.Barrier(len(worker_batches))
            if overlap_first_round else None)

    def work(w: int) -> None:
        try:
            local = [_host32(a) for a in center] if elastic else None
            aux = None
            for r, batch in enumerate(worker_batches[w]):
                pulled, counter = ps.pull()
                if gate is not None and r == 0:
                    gate.wait()
                start = local if elastic else pulled
                if stateful:
                    new, aux = local_steps(start, batch, aux)
                else:
                    new = local_steps(start, batch)
                new = [_host32(n) for n in new]
                if elastic:
                    e = [alpha * (n - p) for n, p in zip(new, pulled)]
                    local = [n - d for n, d in zip(new, e)]
                    ps.commit(e, counter)
                else:
                    delta = [n - p for n, p in zip(new, pulled)]
                    if discipline == "adag":
                        delta = [d / float(window) for d in delta]
                    ps.commit(delta, counter)
        except BaseException as e:  # noqa: BLE001 - surface on the main thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(w,))
               for w in range(len(worker_batches))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return ps.center(), ps
