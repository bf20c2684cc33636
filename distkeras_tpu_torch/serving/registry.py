"""Multi-model hot-swap: serve version N while version N+1 proves itself
(the port's counterpart of ``distkeras_tpu/serving/registry.py``).

The :class:`ModelRegistry` owns the live warmed
:class:`~distkeras_tpu_torch.serving.model.BucketedModel` and its version
(-1: the build-time parameters); the frontend's dispatch thread reads the
``(model, version)`` pair once per batch through :meth:`current`.

With ``directory=`` it watches a checkpoint directory (the one the trainer
saves into) with the cheap manager-less scan of ``checkpoint.py`` — the
same newest-intact-first walk the trainer's resume uses, so the two planes
agree on which step is "the latest good one". Each newer candidate step is
restored through ``Checkpointer.restore(verify=True)`` (the sha256 digest
sidecar vets the payload) onto the registry's device, wrapped in a fresh
``BucketedModel``, and **warmup-probed** — every bucket run, outputs
finite — before it is swapped in. The swap itself is an atomic reference
replacement under the registry lock, taken by the frontend's dispatch
thread *between* batches: no batch ever sees half-old half-new weights,
and the old version keeps answering until the instant the new one is
proven. The steps it reads are params-shaped: ``Checkpointer.save(step,
model.params)``, as the JAX registry reads them. A stateful model's
running statistics are the module's buffers: they move onto the
registry's device with the module, and a restored candidate
(``with_params``, a copy of the module) carries them, so every version
serves with the statistics it was built with.

A candidate that fails restore or probe is remembered and skipped
(``serving.swap_failures``); the registry falls back to the next-newest
candidate, mirroring ``Trainer._resume_from_checkpoint``'s corruption
fallback, and keeps serving the incumbent either way.

* ``quality_gate`` — an optional ``gate(candidate, step) -> bool`` called
  after the probe and before the swap. A refusal is
  **rollback-on-regression**: the step joins ``_failed``
  (``serving.swap_rejected_regression``) and the incumbent keeps serving.
* **Freshness at swap**: when the candidate's checkpoint meta carries
  ``event_ts`` (the newest stream-event timestamp folded into those
  weights), the registry records event-to-served-weight freshness
  (``serving.freshness`` histogram, ``serving.freshness_s`` gauge).
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Union

import torch

from distkeras_tpu_torch import checkpoint as ckpt_mod
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.runtime.device import resolve_device
from distkeras_tpu_torch.serving.model import BucketedModel


class ModelRegistry:
    """Owns the live :class:`BucketedModel` + its version (checkpoint
    step; -1 = the build-time params, nothing restored yet) and the
    polling thread that hot-swaps newer verified checkpoints in. The model
    is moved to ``device`` first (default: the first CUDA device; raises
    where there is none — pass ``device="cpu"`` for the CPU); candidates
    are restored onto it."""

    def __init__(self, model, buckets, directory: Optional[str] = None,
                 poll_s: Optional[float] = None, warmup: bool = True,
                 quality_gate=None,
                 device: Optional[Union[str, torch.device]] = None):
        dev = resolve_device(device)
        model.module.to(dev)
        model.device = dev
        self.directory = directory
        #: optional ``gate(candidate: BucketedModel, step) -> bool`` run
        #: after the warmup probe; False refuses the swap permanently.
        self.quality_gate = quality_gate
        self.poll_s = float(config.env_float("DKTPU_SERVE_POLL_S")
                            if poll_s is None else poll_s)
        self._model = model
        self.buckets = tuple(buckets)
        self._lock = threading.Lock()
        #: True while a warmup/swap probe runs — the not-ready window the
        #: frontend's stats op reports to health-aware clients.
        self.warming = True
        self._bucketed = BucketedModel(model, self.buckets)
        try:
            if warmup:
                self._bucketed.warmup()
        finally:
            self.warming = False
        self._version = -1
        self._failed: set[int] = set()
        self._ckpt = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- serving side -------------------------------------------------------

    def current(self) -> tuple[BucketedModel, int]:
        """The live (model, version) pair — one atomic read; the dispatch
        thread calls this per batch, so a swap lands cleanly between two
        batches and never inside one."""
        with self._lock:
            return self._bucketed, self._version

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def compiles(self) -> int:
        with self._lock:
            return self._bucketed.compiles()

    # -- watch side ---------------------------------------------------------

    def poll_once(self) -> bool:
        """One scan of the checkpoint directory; restores + probes + swaps
        the newest intact candidate newer than the live version. Returns
        whether a swap happened."""
        if self.directory is None:
            return False
        steps = ckpt_mod.scan_steps(self.directory)
        candidates = ckpt_mod.resume_candidates(
            steps, lambda s: ckpt_mod.read_meta(self.directory, s)
            is not None)
        for step in candidates:
            if step <= self._version or step in self._failed:
                continue
            try:
                self.warming = True
                try:
                    candidate = self._load_and_probe(step)
                finally:
                    self.warming = False
            except Exception as e:  # noqa: BLE001 - fall back to next step
                self._failed.add(step)
                telemetry.counter("serving.swap_failures").add(1)
                telemetry.event("serve_swap_failed", {
                    "step": step, "error": repr(e)})
                import warnings

                warnings.warn(
                    f"serving hot-swap candidate step {step} rejected "
                    f"({type(e).__name__}: {e}); still serving version "
                    f"{self._version}", stacklevel=2)
                continue
            if self.quality_gate is not None:
                try:
                    ok = bool(self.quality_gate(candidate, step))
                except Exception:  # noqa: BLE001 - a broken gate rejects
                    ok = False
                if not ok:
                    self._failed.add(step)
                    telemetry.counter(
                        "serving.swap_rejected_regression").add(1)
                    telemetry.event("serve_swap_rejected", {"step": step})
                    continue
            with self._lock:
                self._bucketed = candidate
                self._version = step
            telemetry.counter("serving.swaps").add(1)
            telemetry.event("serve_swap", {"step": step})
            self._note_freshness(step)
            return True
        return False

    def _note_freshness(self, step: int) -> None:
        """Event-to-served-weight freshness: now minus the newest stream
        event folded into the just-swapped weights (meta ``event_ts``,
        written by the streaming trainer; absent for batch checkpoints)."""
        meta = ckpt_mod.read_meta(self.directory, step) or {}
        event_ts = meta.get("event_ts")
        if event_ts is None:
            return
        fresh = max(0.0, time.time() - float(event_ts))
        telemetry.gauge("serving.freshness_s").set(round(fresh, 3))
        telemetry.histogram("serving.freshness").observe(fresh)
        telemetry.event("serve_freshness", {
            "step": step, "seconds": round(fresh, 3)})

    def _load_and_probe(self, step: int) -> BucketedModel:
        """Restore ``step`` (digest-verified) into the model's parameter
        structure on the registry's device and warmup-probe a fresh
        bucketed wrapper; any failure raises and the caller keeps the
        incumbent."""
        if self._ckpt is None:
            self._ckpt = ckpt_mod.Checkpointer(self.directory)
        params = self._ckpt.restore(
            self._model.params, step=step, verify=True)
        candidate = BucketedModel(
            self._model.with_params(params), self.buckets)
        candidate.warmup()  # the probe: every bucket, finite, or raises
        return candidate

    def start(self) -> None:
        """Launch the polling thread (idempotent)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except Exception:  # noqa: BLE001 - poller must survive
                    pass
                self._stop.wait(self.poll_s)

        self._thread = threading.Thread(
            target=_loop, name="serve-registry", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
