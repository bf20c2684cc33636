"""Checkpoint / resume without Orbax — the port's counterpart of
``distkeras_tpu/checkpoint.py``.

The full engine state (center, per-worker locals, optimizer state, fold
state, rng) checkpoints every K fold rounds, and ``restore`` resumes it in
a fresh process. The card's machine has no Orbax, so the format is the
port's own, in torch's:

* a step is the directory ``<dir>/<step>/`` holding one ``state.pt``: the
  state flattened to ``{path: tensor | int | float | bool | str}``
  (``path`` joins dict keys, list/tuple indices and NamedTuple fields with
  ``/``), read back with ``torch.load(weights_only=True)`` so nothing
  executes on load. Tensors that one state holds twice (the pull
  disciplines' locals are the center) are written once and restored
  shared;
* the step is written into ``<dir>/.<step>.tmp-<pid>/`` and renamed into
  place (``os.replace``), so a reader never sees half a step;
  :func:`scan_steps` skips the tmp directories;
* the ``meta`` and integrity-digest sidecars live under ``<dir>/meta/`` as
  in the JAX package (``<step>.json``, ``<step>.digest.json``).

Saves are synchronous: every tensor is on the host, and the file written,
before :meth:`Checkpointer.save` returns, so a save never aliases the live
state the engine reuses next round.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import warnings
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


def read_meta(directory: str, step: int) -> Optional[dict]:
    """The ``meta`` sidecar saved with ``step`` under ``directory``
    (None when absent or unparsable) — shared by :meth:`Checkpointer.meta`
    and the manager-less scans below."""
    path = os.path.join(directory, "meta", f"{step}.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def scan_steps(directory: str) -> list[int]:
    """Integer-named step directories under ``directory``, newest first,
    from a plain listdir (cheap enough for the serving registry to poll
    every few seconds). In-progress ``.<step>.tmp-<pid>`` directories are
    skipped."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    steps = [int(n) for n in names
             if n.isdigit() and os.path.isdir(os.path.join(directory, n))]
    return sorted(steps, reverse=True)


def resume_candidates(steps_desc, has_meta) -> list[int]:
    """The newest-intact-first candidate order shared by
    ``Trainer._resume_from_checkpoint`` and the serving registry: steps
    whose meta sidecar is present and parsable, newest first; when NO step
    has one (metaless save paths) every step stays a candidate rather than
    refusing to resume at all."""
    with_meta = [s for s in steps_desc if has_meta(s)]
    return with_meta or list(steps_desc)


def latest_step(directory: str) -> Optional[int]:
    """Newest intact-looking step in ``directory`` (None when empty): the
    first entry of the sidecar-preferred candidate walk over a cheap
    directory scan. Callers still ``restore(verify=True)`` the winner —
    this picks the candidate, the digest check vets the payload."""
    cands = resume_candidates(scan_steps(directory),
                              lambda s: read_meta(directory, s) is not None)
    return cands[0] if cands else None


# -- the state as {path: leaf} -----------------------------------------------

_SCALARS = (bool, int, float, str)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> list:
    """``(key, child)`` pairs of a container node, None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _host_flat(state: Any) -> dict:
    """``{path: leaf}`` of ``state`` with every tensor copied to the host
    (a tensor object met twice is copied once, so the file shares it)."""
    flat: dict = {}
    memo: dict = {}

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is not None:
            for k, v in kids:
                walk(v, f"{path}/{k}" if path else k)
            return
        if isinstance(node, torch.Tensor):
            host = memo.get(id(node))
            if host is None:
                host = node.detach().to("cpu", copy=True)
                memo[id(node)] = host
            flat[path] = host
        elif isinstance(node, _SCALARS):
            flat[path] = node
        else:
            raise TypeError(f"checkpoint leaf {path!r} has unsupported type "
                            f"{type(node).__name__}")

    walk(state, "")
    return flat


def _storage_key(t: torch.Tensor) -> tuple:
    return (t.untyped_storage().data_ptr(), t.storage_offset(),
            tuple(t.shape), t.stride(), t.dtype)


def _rebuild(target: Any, flat: dict) -> Any:
    """``target``'s structure with its leaves taken from ``flat`` (host
    tensors and scalars). A missing or extra path, or a shape, dtype or
    type mismatch raises ``ValueError``. Tensors that share storage in
    ``flat`` come back as one tensor object."""
    used: set = set()
    shared: dict = {}

    def walk(node, path):
        if node is None:
            return None
        kids = _children(node)
        if kids is not None:
            vals = [walk(v, f"{path}/{k}" if path else k) for k, v in kids]
            if isinstance(node, dict):
                return dict(zip(node.keys(), vals))
            if _is_namedtuple(node):
                return type(node)(*vals)
            return type(node)(vals)
        if path not in flat:
            raise ValueError(f"checkpoint has no entry {path!r}")
        used.add(path)
        got = flat[path]
        if isinstance(node, torch.Tensor):
            if not isinstance(got, torch.Tensor):
                raise ValueError(f"{path!r}: expected a tensor, the "
                                 f"checkpoint holds {type(got).__name__}")
            if (tuple(got.shape) != tuple(node.shape)
                    or got.dtype != node.dtype):
                raise ValueError(
                    f"{path!r}: checkpoint holds {tuple(got.shape)} "
                    f"{got.dtype}, the target {tuple(node.shape)} "
                    f"{node.dtype}")
            return shared.setdefault(_storage_key(got), got)
        if isinstance(node, _SCALARS):
            if type(got) is not type(node):
                raise ValueError(f"{path!r}: expected a "
                                 f"{type(node).__name__}, the checkpoint "
                                 f"holds {type(got).__name__}")
            return got
        raise TypeError(f"restore target leaf {path!r} has unsupported type "
                        f"{type(node).__name__}")

    out = walk(target, "")
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(f"checkpoint entries {extra[:5]} are not in the "
                         f"target ({len(extra)} extra)")
    return out


def _to_devices(target: Any, host: Any) -> Any:
    """``host`` (``target``'s structure) with each tensor moved to its
    target leaf's device; one host tensor met twice moves once."""
    moved: dict = {}

    def walk(t, h):
        kids = _children(t) if t is not None else None
        if kids is not None:
            vals = [walk(tv, hv) for (_, tv), (_, hv) in zip(kids,
                                                             _children(h))]
            if isinstance(t, dict):
                return dict(zip(t.keys(), vals))
            if _is_namedtuple(t):
                return type(t)(*vals)
            return type(t)(vals)
        if isinstance(t, torch.Tensor) and t.device.type != "cpu":
            key = (id(h), t.device)
            if key not in moved:
                moved[key] = h.to(t.device)
            return moved[key]
        return h

    return walk(target, host)


class Checkpointer:
    """Rolling checkpoints of training state keyed by step number (the
    trainer's fold round plus its offset), the newest ``max_to_keep``
    kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _meta_dir(self) -> str:
        return os.path.join(self.directory, "meta")

    def save(self, step: int, state: Any,
             meta: Optional[dict] = None) -> bool:
        """Save ``state`` (a tree of dicts, lists, tuples and NamedTuples
        over tensors and Python scalars) at ``step``; ``meta`` (JSON-able;
        e.g. ``{"num_workers": W}``) lands next to it. The write is done
        when this returns.

        A scheduled ``ckpt_corrupt@step`` fault (``DKTPU_FAULTS``)
        corrupts the step's payload right after it is written.

        Returns whether the step was written. A ``step <= latest_step()``
        is declined, as Orbax's manager declines it: it warns, writes
        nothing and returns False (``Trainer._execute`` offsets resumed
        step counters for exactly this reason)."""
        from distkeras_tpu_torch import telemetry
        from distkeras_tpu_torch.resilience import integrity
        from distkeras_tpu_torch.runtime import config

        latest = self.latest_step()
        if latest is not None and step <= latest:
            warnings.warn(
                f"checkpoint save at step {step} was declined "
                f"(latest_step={latest}); state was NOT persisted. Step "
                "numbers must be strictly increasing.", stacklevel=2)
            return False
        # spans: checkpoint.save (the whole call) holds copy (the state to
        # the host), digest (the sha256 sidecar's hash) and write
        # (state.pt, the rename, the sidecars, the retention sweep)
        tele = telemetry.get()
        with tele.span("checkpoint.save"):
            with tele.span("copy"):
                flat = _host_flat(state)
            with tele.span("digest"):
                digest = (integrity.tree_digest(_rebuild(state, flat))
                          if config.env_bool("DKTPU_CKPT_DIGEST") else None)
            with tele.span("write"):
                tmp = os.path.join(self.directory,
                                   f".{step}.tmp-{os.getpid()}")
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                torch.save(flat, os.path.join(tmp, STATE_FILE))
                os.replace(tmp, self._step_dir(step))
                os.makedirs(self._meta_dir(), exist_ok=True)
                if meta is not None:
                    self._write_json(f"{step}.json", meta)
                if digest is not None:
                    integrity.write_digest(os.path.join(
                        self._meta_dir(), f"{step}.digest.json"), digest)
                self._gc(step)
        from distkeras_tpu_torch.resilience import faults

        plan = faults.active_plan()
        if plan is not None and plan.ckpt_corrupt(step):
            # ckpt_corrupt@step injection: scribble over the payload once
            # the write has landed. The digest above was computed from the
            # live state, so a verified restore must detect this.
            integrity.corrupt_step_dir(self._step_dir(step))
        return True

    def _write_json(self, name: str, obj: dict) -> None:
        tmp = os.path.join(self._meta_dir(), f".{name}.p0.tmp")
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, os.path.join(self._meta_dir(), name))

    def _gc(self, step: int) -> None:
        """Keep the newest ``max_to_keep`` steps; drop the sidecars of
        steps no longer kept, so a stale topology can never be read for a
        re-used step number; reap tmp files and directories orphaned by a
        crash between write and rename: this process's own at once, a
        peer's only once an hour old (a live peer may still rename it)."""
        steps = scan_steps(self.directory)
        for old in steps[self.max_to_keep:]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        live_steps = steps[:self.max_to_keep]
        live = {f"{s}.json" for s in live_steps} | {
            f"{s}.digest.json" for s in live_steps}
        own = f"-{os.getpid()}"
        for base in (self._meta_dir(), self.directory):
            for name in os.listdir(base):
                path = os.path.join(base, name)
                if base == self._meta_dir() and name.endswith(".json"):
                    stale = name not in live
                elif ".tmp" not in name:
                    continue
                elif name.endswith(own) or name.endswith(".p0.tmp"):
                    stale = not name.startswith(f".{step}.")
                else:
                    try:
                        stale = time.time() - os.path.getmtime(path) > 3600
                    except OSError:
                        stale = False
                if stale:
                    if os.path.isdir(path):
                        shutil.rmtree(path, ignore_errors=True)
                    else:
                        try:
                            os.remove(path)
                        except OSError:
                            pass

    def meta(self, step: int) -> Optional[dict]:
        """The ``meta`` dict saved with ``step`` (None if absent)."""
        return read_meta(self.directory, step)

    def latest_step(self) -> Optional[int]:
        steps = scan_steps(self.directory)
        return steps[0] if steps else None

    def all_steps(self) -> list[int]:
        """Every retained step, ascending."""
        return sorted(scan_steps(self.directory))

    def steps_desc(self) -> list[int]:
        """Every retained step, newest first — the integrity-fallback
        candidate order."""
        return scan_steps(self.directory)

    def digest(self, step: int) -> Optional[dict]:
        """The integrity sidecar saved with ``step`` (None if absent)."""
        from distkeras_tpu_torch.resilience import integrity

        return integrity.read_digest(
            os.path.join(self._meta_dir(), f"{step}.digest.json"))

    def _verify(self, step: int, restored: Any) -> None:
        """Raise CheckpointCorruptError when ``step``'s digest sidecar
        exists and the restored tree does not hash to it."""
        digest = self.digest(step)
        if digest is None:
            return
        from distkeras_tpu_torch import telemetry
        from distkeras_tpu_torch.resilience import integrity
        from distkeras_tpu_torch.resilience.errors import (
            CheckpointCorruptError,
        )

        if not integrity.matches(restored, digest):
            telemetry.counter("resilience.ckpt_corrupt_detected").add(1)
            raise CheckpointCorruptError(
                f"checkpoint step {step} in {self.directory} failed its "
                "integrity check (content hash != digest sidecar)")

    def _load(self, target: Any, step: Optional[int], verify: bool):
        """The step's tree in ``target``'s structure, on the host (spans
        ``load`` and ``verify``, inside the caller's)."""
        from distkeras_tpu_torch import telemetry

        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        tele = telemetry.get()
        with tele.span("load"):
            flat = torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                              map_location="cpu", weights_only=True)
            host = _rebuild(target, flat)
        if verify:
            with tele.span("verify"):
                self._verify(step, host)
        return host

    def restore(self, target: Any, step: Optional[int] = None,
                verify: bool = False) -> Any:
        """Restore into the structure of ``target`` (a matching tree, e.g.
        ``engine.init_state()``), each tensor on its target leaf's device.
        A missing or extra entry, or a shape or dtype mismatch, raises
        ``ValueError``. ``verify=True`` re-hashes the restored tree against
        the step's digest sidecar and raises
        :class:`~distkeras_tpu_torch.resilience.errors.CheckpointCorruptError`
        on mismatch."""
        from distkeras_tpu_torch import telemetry

        with telemetry.get().span("checkpoint.restore"):
            return _to_devices(target, self._load(target, step, verify))

    def restore_host(self, target: Any, step: Optional[int] = None,
                     verify: bool = False) -> Any:
        """As :meth:`restore`, with every tensor on the host (the raw
        material for a re-topology)."""
        from distkeras_tpu_torch import telemetry

        with telemetry.get().span("checkpoint.restore_host"):
            return self._load(target, step, verify)
