"""Durable center state: a write-ahead journal + periodic snapshots (the
port's copy of the JAX package's ``netps/state.py``; the files are the
same, so either package recovers the other's state directory).

This module makes the port's :class:`~distkeras_tpu_torch.netps.server.
PSServer` survive its own death (``--state-dir`` on ``python -m
distkeras_tpu_torch.netps`` / ``DKTPU_PS_STATE_DIR``):

* **Journal.** Every folded commit is appended to ``journal-<base>.dkj``
  as ONE wire frame (``netps/wire.py`` framing — magic/version/crc/length,
  so a record self-validates on read) carrying the commit's identity
  (``wid``, ``seq``), the staleness the fold charged (``st``), the fold
  index ``u`` (the pre-fold update counter), the server epoch ``e``, the
  commit total ``n``, and the delta in its **wire dtype** (int8/bf16 specs
  included). Records drain through ONE ordered background writer behind a
  bounded queue (``_WRITE_QUEUE``): the fold path pays an enqueue, not a
  disk write, and blocks once the queue fills, so a SIGKILL loses at most
  ``_WRITE_QUEUE`` folded-but-unwritten records — ACKed commits whose
  workers never retransmit, so their contribution vanishes like a commit
  in flight at the crash, never a double fold. A :meth:`StateStore.
  barrier` runs before every snapshot, every rotation and at close, so a
  graceful drain loses nothing. fsync happens at snapshot time only: the
  threat model is process death, not host power loss.

* **Snapshots.** Every ``snapshot_every`` folds
  (``DKTPU_PS_SNAPSHOT_EVERY``) the full center, update counter,
  per-worker dedup table and epoch are written as one frame to
  ``snapshot-<updates>.dks`` (tmp + fsync + rename, a sha256 sidecar
  through ``resilience/integrity.py``), the journal rotates to a fresh
  ``journal-<updates>.dkj``, and generations older than the previous
  snapshot are pruned.

* **Recovery** (newest intact first): walk the snapshots newest first,
  take the first whose sidecar digest matches; replay journal records with
  fold index ``>=`` the snapshot's counter, in order, keeping the valid
  prefix of a torn journal and stopping at a gap. **Replay folds on the
  center's device**: each record is staged through
  :func:`~distkeras_tpu_torch.netps.fold.stage_commit` and folded by
  :func:`~distkeras_tpu_torch.netps.fold.fold_delta` — one launch of the
  CUDA fold kernel a record on the card, the plain twin on the CPU — with
  the recorded staleness, in the recorded order and dtype, so the
  recovered center is bit-identical to the pre-crash one (and to the JAX
  package's numpy recovery of the same directory).

A brand-new server seeds ``snapshot-000….dks`` the moment its center is
first set (the first worker's join), so a journal is never orphaned
without a base to replay onto.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.netps.errors import ProtocolError
from distkeras_tpu_torch.resilience import integrity
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.runtime.device import resolve_device

_SNAP_PREFIX, _SNAP_SUFFIX = "snapshot-", ".dks"
_JOUR_PREFIX, _JOUR_SUFFIX = "journal-", ".dkj"
_EPOCH_FILE = "epoch.json"
#: bounded writer queue: folded-but-unwritten journal records. The fold
#: path blocks (backpressure) beyond this, so both the crash-loss window
#: and the memory held by queued deltas stay bounded.
_WRITE_QUEUE = 8


def _name(prefix: str, base: int, suffix: str) -> str:
    return f"{prefix}{base:012d}{suffix}"


class Recovered(NamedTuple):
    """What a restarted server resumes from: the replayed center (f32
    tensors on the device recovery folded on), the update counter, the
    per-worker dedup table, the epoch, the total-commit count, how many
    journal records the replay folded, whether this incarnation was FENCED
    before it died, and the replay's wall seconds (the device synchronized
    at its end)."""

    center: list
    updates: int
    last_seq: dict
    epoch: int
    commits_total: int
    replayed: int
    fenced: bool = False
    replay_seconds: float = 0.0


class StateStore:
    """The durable half of one PSServer. The server calls :meth:`append`/
    :meth:`snapshot` under its center lock — enqueue order IS fold order —
    and ONE background writer drains the queue to disk in that order."""

    def __init__(self, state_dir: str,
                 snapshot_every: Optional[int] = None):
        self.state_dir = state_dir
        self.snapshot_every = int(
            snapshot_every if snapshot_every is not None
            else config.env_int("DKTPU_PS_SNAPSHOT_EVERY"))
        os.makedirs(state_dir, exist_ok=True)
        self._journal = None
        self._journal_base: Optional[int] = None
        #: ordered writer state: queue of (header, delta) records, drained
        #: by the one `_writer` thread; `_busy` marks a record popped but
        #: not yet on disk (barrier must wait for it too).
        self._cv = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._busy = False
        self._writer: Optional[threading.Thread] = None
        self._writer_stop = False
        #: journal records dropped by a failed disk write (the journal is
        #: best-effort past a dead disk; the server keeps serving).
        self.write_errors = 0
        #: bytes of journal records written so far (the writer's count).
        self.journal_bytes = 0

    # -- listing -----------------------------------------------------------
    def _list(self, prefix: str, suffix: str) -> list:
        """``[(base, path)]`` ascending by base."""
        out = []
        for name in os.listdir(self.state_dir):
            if not (name.startswith(prefix) and name.endswith(suffix)):
                continue
            digits = name[len(prefix):-len(suffix)]
            if digits.isdigit():
                out.append((int(digits), os.path.join(self.state_dir, name)))
        return sorted(out)

    # -- recovery ----------------------------------------------------------
    def recover(self, discipline: str, device=None, pool=None,
                seat: Optional[Callable[[list], list]] = None,
                replay: bool = True) -> Optional[Recovered]:
        """Load the newest intact snapshot, seat it on ``device`` (the card
        when None, as :func:`~distkeras_tpu_torch.runtime.device.
        resolve_device` decides; through
        ``seat(arrays) -> tensors`` when given — the server seats its own
        center — else as views of one flat tensor in ``center_layout``,
        which the staged commits address) and replay the journal onto it,
        one ``fold_delta`` a record on the current stream, staging through
        ``pool``'s pinned buffers. ``replay=False`` reads the records for
        the dedup table, epoch, cursor and commit count alone and folds
        none (``replayed`` stays 0). Returns None when the directory holds
        no restorable state."""
        from distkeras_tpu_torch.netps.fold import (fold_delta, seat_center,
                                                    stage_commit)

        chosen = None
        for _base, path in reversed(self._list(_SNAP_PREFIX, _SNAP_SUFFIX)):
            digest = integrity.read_digest(path + ".digest.json")
            try:
                intact = (digest and "hexdigest" in digest
                          and integrity.file_sha256(path)
                          == digest["hexdigest"])
                if not intact:
                    raise ProtocolError("snapshot digest mismatch")
                with open(path, "rb") as f:
                    _kind, hdr, arrays = wire.decode_frame(f.read())
            except (OSError, ProtocolError, ValueError):
                telemetry.counter("netps.recovery.snapshots_rejected").add(1)
                continue
            chosen = (hdr, arrays)
            break
        if chosen is None:
            return None
        hdr, arrays = chosen
        telemetry.counter("netps.recovery.snapshot_loads").add(1)
        device = resolve_device(device)
        center = (seat or (lambda a: seat_center(a, device)[2]))(
            [np.asarray(a, np.float32) for a in arrays])
        counter = int(hdr["updates"])
        last_seq = {int(k): int(v)
                    for k, v in (hdr.get("last_seq") or {}).items()}
        epoch = int(hdr.get("epoch", 0))
        commits_total = int(hdr.get("commits_total", counter))
        replayed = 0
        t0 = time.perf_counter()
        for _base, path in self._list(_JOUR_PREFIX, _JOUR_SUFFIX):
            nrec, clean = _scan_journal(path)
            if not clean:
                # A torn record: the crash-interrupted append of THIS
                # journal's last life. Its valid prefix still replays; the
                # fold-index check below decides what can anchor after it.
                telemetry.counter("netps.recovery.journals_truncated").add(1)
            stop = False
            for rhdr, delta in _iter_records(path, nrec):
                u = int(rhdr["u"])
                if u < counter:
                    continue  # already inside the snapshot
                if u > counter:
                    # A record is missing between the snapshot and here —
                    # only reachable through external file damage.
                    telemetry.counter("netps.recovery.journal_gaps").add(1)
                    stop = True
                    break
                if replay:
                    fold_delta(center, stage_commit(delta, device, pool),
                               discipline, int(rhdr["st"]))
                    replayed += 1
                last_seq[int(rhdr["wid"])] = int(rhdr["seq"])
                epoch = max(epoch, int(rhdr.get("e", 0)))
                commits_total = int(rhdr.get("n", commits_total + 1))
                counter += 1
            if stop:
                break
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        seconds = time.perf_counter() - t0
        file_epoch, fenced = self._read_epoch_file()
        epoch = max(epoch, file_epoch)
        telemetry.counter("netps.recovery.replayed_commits").add(replayed)
        return Recovered(center=center, updates=counter, last_seq=last_seq,
                         epoch=epoch, commits_total=commits_total,
                         replayed=replayed, fenced=fenced,
                         replay_seconds=seconds)

    # -- journal -----------------------------------------------------------
    def open_journal(self, base: int) -> None:
        """Start (or restart) the active journal at fold index ``base``.
        Truncating is safe: a pre-existing ``journal-<base>`` can hold zero
        *valid* records — any valid record at index ``base`` would have
        advanced the recovered counter past ``base``."""
        self.barrier()  # queued records belong to the OLD journal
        self._close_journal()
        path = os.path.join(self.state_dir,
                            _name(_JOUR_PREFIX, base, _JOUR_SUFFIX))
        self._journal = open(path, "wb")
        self._journal_base = base

    def _close_journal(self) -> None:
        if self._journal is not None:
            try:
                self._journal.close()
            except OSError:
                pass
            self._journal = None

    def append(self, *, epoch: int, wid: int, seq: int, staleness: int,
               updates: int, commits_total: int, delta: Sequence) -> None:
        """Journal one folded commit (caller holds the center lock —
        enqueue order IS fold order). ``delta`` entries are the commit
        frame's own wire entries (``(array, spec)`` pairs over the frame's
        buffer, which nobody mutates and the queue keeps alive), written in
        their wire dtype so replay is the same arithmetic. Blocks only when
        the writer is ``_WRITE_QUEUE`` records behind."""
        hdr = {"op": "journal", "u": int(updates), "wid": int(wid),
               "seq": int(seq), "st": int(staleness), "e": int(epoch),
               "n": int(commits_total)}
        if self._writer is None:
            self._writer = threading.Thread(target=self._writer_loop,
                                            name="netps-journal-writer")
            self._writer.start()
        with self._cv:
            while len(self._queue) >= _WRITE_QUEUE:
                self._cv.wait()
            self._queue.append((hdr, list(delta)))
            self._cv.notify_all()

    def _writer_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._writer_stop:
                    self._cv.wait()
                if not self._queue and self._writer_stop:
                    return
                hdr, delta = self._queue.popleft()
                self._busy = True
                self._cv.notify_all()
            try:
                n = wire.write_frame(self._journal, wire.KIND_REQUEST, hdr,
                                     delta)
                # flush, not fsync: survives process death; a host power
                # cut falls back to the last snapshot + the page-cache-
                # flushed prefix.
                self._journal.flush()
                self.journal_bytes += n
            except (OSError, ValueError, AttributeError):
                self.write_errors += 1
            with self._cv:
                self._busy = False
                self._cv.notify_all()

    def barrier(self) -> None:
        """Block until every queued journal record is on disk — taken
        before snapshots and rotations (on-disk order must match fold
        order across file boundaries) and at close."""
        if self._writer is None:
            return
        with self._cv:
            while self._queue or self._busy:
                self._cv.wait()

    # -- snapshots ---------------------------------------------------------
    def due(self, updates: int) -> bool:
        return (self.snapshot_every > 0 and updates > 0
                and updates % self.snapshot_every == 0)

    def snapshot(self, *, center: Sequence[np.ndarray], updates: int,
                 last_seq: dict, epoch: int, commits_total: int) -> str:
        """Write one intact-or-absent snapshot (tmp + fsync + rename +
        sha256 sidecar), rotate the journal to a fresh file at ``updates``,
        and prune generations older than the previous snapshot. Barriers
        first. Telemetry-free: the server snapshots under its center lock
        and exports ``netps.recovery.snapshots`` after release."""
        self.barrier()
        path = os.path.join(self.state_dir,
                            _name(_SNAP_PREFIX, updates, _SNAP_SUFFIX))
        hdr = {"op": "snapshot", "updates": int(updates),
               "last_seq": {str(k): int(v) for k, v in last_seq.items()},
               "epoch": int(epoch), "commits_total": int(commits_total)}
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            wire.write_frame(f, wire.KIND_REQUEST, hdr, list(center))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        integrity.write_digest(
            path + ".digest.json",
            {"algo": "sha256", "hexdigest": integrity.file_sha256(path)})
        self.open_journal(updates)
        self._prune()
        return path

    def _prune(self) -> None:
        """Keep the newest two snapshot generations (the fresh one plus
        its predecessor as the fallback) and every journal that can still
        anchor to a kept snapshot."""
        snaps = [b for b, _ in self._list(_SNAP_PREFIX, _SNAP_SUFFIX)]
        keep = set(sorted(snaps)[-2:])
        floor = min(keep) if keep else 0
        for base, path in self._list(_SNAP_PREFIX, _SNAP_SUFFIX):
            if base not in keep:
                for p in (path, path + ".digest.json"):
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
        for base, path in self._list(_JOUR_PREFIX, _JOUR_SUFFIX):
            if base < floor and base != self._journal_base:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    # -- epoch marker ------------------------------------------------------
    def write_epoch(self, epoch: int, fenced: bool = False) -> None:
        """Persist an epoch transition without a full snapshot: a
        promotion (``fenced=False`` — a promoted-then-restarted standby
        comes back at its promoted epoch, serving) or a fence landing on
        this server (``fenced=True`` — a zombie ex-primary restarted from
        its state dir comes back refusing to fold)."""
        path = os.path.join(self.state_dir, _EPOCH_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"epoch": int(epoch), "fenced": bool(fenced)}, f)
        os.replace(tmp, path)

    def _read_epoch_file(self) -> tuple[int, bool]:
        try:
            with open(os.path.join(self.state_dir, _EPOCH_FILE)) as f:
                data = json.load(f)
            return int(data.get("epoch", 0)), bool(data.get("fenced"))
        except (OSError, ValueError):
            return 0, False

    def close(self) -> None:
        if self._writer is not None:
            self.barrier()
            with self._cv:
                self._writer_stop = True
                self._cv.notify_all()
            self._writer.join()
            self._writer = None
            self._writer_stop = False
        self._close_journal()


def _scan_journal(path: str) -> tuple[int, bool]:
    """Streaming validation pass: ``(leading_valid_records, clean)`` —
    ``clean`` is False when the file ends in a torn/corrupt record. One
    frame in memory at a time."""
    n, clean = 0, True
    try:
        with open(path, "rb") as f:
            while True:
                prefix = f.read(wire.PREFIX_SIZE)
                if not prefix:
                    break
                if len(prefix) < wire.PREFIX_SIZE:
                    clean = False
                    break
                try:
                    _kind, _crc, length = wire.parse_prefix(prefix)
                    body = f.read(length)
                    if len(body) != length:
                        clean = False
                        break
                    wire.decode_frame(prefix + body, decode=False)
                except ProtocolError:
                    clean = False
                    break
                n += 1
    except OSError:
        return n, False
    return n, clean


def _iter_records(path: str, limit: int):
    """Yield the first ``limit`` journal records of one file as
    ``(header, wire-pair delta)``, one frame in memory at a time (``limit``
    comes from a :func:`_scan_journal` pass, so every frame is valid)."""
    with open(path, "rb") as f:
        for _ in range(limit):
            prefix = f.read(wire.PREFIX_SIZE)
            _kind, _crc, length = wire.parse_prefix(prefix)
            body = f.read(length)
            _kind, hdr, delta = wire.decode_frame(prefix + body,
                                                  decode=False)
            yield hdr, delta


def read_journal(state_dir: str) -> list:
    """Every valid journal record header across a state dir, in fold order
    — the exactly-once evidence for a server observed only as a
    subprocess. Headers only; the deltas are streamed past."""
    out: list = []
    store = StateStore(state_dir, snapshot_every=0)
    for _base, path in store._list(_JOUR_PREFIX, _JOUR_SUFFIX):
        nrec, _clean = _scan_journal(path)
        out.extend(h for h, _d in _iter_records(path, nrec))
    return out
