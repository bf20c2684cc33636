"""The durable offset journal: exactly-once ingest across SIGKILL (the
port's copy of ``distkeras_tpu/streaming/journal.py``: the same JSON
snapshot, ``.prev`` and ``.sha256`` generations, so a journal either
package writes loads in the other).

One JSON file (tmp + fsync + rename, sha256 sidecar — the checkpoint
meta idiom) records how far into the stream training has *provably*
gotten:

* ``frontier`` — every record with index < frontier has been folded into
  the PS center. Restart resumes the source here.
* ``ahead`` — records committed out of order past the frontier (elastic
  workers commit concurrently). Restart *skips* these.
* ``intents`` — per-worker in-flight commits: ``(seq, offset)`` journaled
  **before** the commit RPC is sent. This is what closes the ACK gap: a
  crash between the PS folding a commit and this journal recording it
  would otherwise replay the record. On restart, :meth:`resolve` compares
  each surviving intent's ``seq`` against the seq the PS reports as last
  folded for that worker (``join`` replies carry it, and the on-disk PS
  journal is the same evidence) — ``seq <= last_seq`` means the fold
  LANDED and only the ACK was lost, so the offset is marked committed
  without retraining; otherwise the intent is dropped and the record is
  re-read and re-sent **with a fresh seq the server has never folded**,
  so it folds exactly once either way.

The exactly-once argument, end to end: a record is folded iff one
``(wid, seq)`` commit carrying it was applied (PS dedup by per-worker
monotone seq rejects retransmits as ``duplicate``); the journal maps
offsets to seqs via intents and never advances the frontier past an
offset whose fold is unproven. What a crash can cost is bounded by the
un-ACKed window: at most one in-flight record per worker is *re-trained
into a fresh commit* — and only when the crash lands before the PS
folded it, so no record is ever folded twice and no ACKed record is
lost.

Corruption: the previous generation is kept (``.prev`` + its sidecar);
a torn or bit-flipped current file falls back to it — losing at most
the commits since the previous write, which restart then re-proves
against the PS journal via :meth:`resolve`.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterable, Optional

from distkeras_tpu_torch.resilience.integrity import file_sha256


class OffsetJournal:
    """Durable record of stream ingest progress. Thread-safe: elastic
    workers journal intents/commits concurrently."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        # Reentrant: _mark_committed takes it itself so it is safe from
        # both the locked protocol methods and any future direct caller.
        self._lock = threading.RLock()
        self.frontier = 0
        self._ahead: set[int] = set()
        #: wid -> {"seq": int, "offset": int} — one in-flight commit per
        #: worker (the worker loop is serial per slot).
        self._intents: Dict[int, dict] = {}
        self.items_committed = 0
        #: newest event timestamp among committed records — the freshness
        #: anchor the checkpoint meta carries to the serving plane.
        self.last_event_ts: Optional[float] = None
        #: free-form runtime state that must survive restarts with the
        #: offsets (e.g. the index an injected drift began at — the fault
        #: one-shot is consumed pre-kill, the drifted world is not).
        self.meta: dict = {}

    # -- persistence --------------------------------------------------------

    def _snapshot(self) -> dict:
        return {
            "frontier": self.frontier,
            "ahead": sorted(self._ahead),
            "intents": {str(w): dict(v) for w, v in self._intents.items()},
            "items_committed": self.items_committed,
            "last_event_ts": self.last_event_ts,
            "meta": self.meta,
        }

    def _persist_locked(self) -> None:
        payload = json.dumps(self._snapshot()).encode()
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        # Keep the last good generation before replacing: a crash mid-write
        # (or a later bit flip) falls back to .prev instead of to zero.
        if os.path.exists(self.path):
            os.replace(self.path, self.path + ".prev")
            if os.path.exists(self.path + ".sha256"):
                os.replace(self.path + ".sha256", self.path + ".prev.sha256")
        os.replace(tmp, self.path)
        stmp = self.path + ".sha256.tmp"
        with open(stmp, "w") as f:
            f.write(file_sha256(self.path))
            f.flush()
            os.fsync(f.fileno())
        os.replace(stmp, self.path + ".sha256")

    def _load_one(self, path: str) -> Optional[dict]:
        try:
            with open(path + ".sha256") as f:
                want = f.read().strip()
            if file_sha256(path) != want:
                return None
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def load(self) -> bool:
        """Populate from disk (sha-verified; falls back to the previous
        generation on corruption). Returns whether a state was loaded."""
        with self._lock:
            state = self._load_one(self.path)
            if state is None:
                state = self._load_one(self.path + ".prev")
            if state is None:
                return False
            self.frontier = int(state.get("frontier", 0))
            self._ahead = {int(o) for o in state.get("ahead", ())}
            self._intents = {int(w): v
                             for w, v in (state.get("intents") or {}).items()}
            self.items_committed = int(state.get("items_committed", 0))
            self.last_event_ts = state.get("last_event_ts")
            self.meta = dict(state.get("meta") or {})
            return True

    # -- the two-phase commit protocol --------------------------------------

    def intent(self, wid: int, seq: int, offset: int) -> None:
        """Journal that worker ``wid`` is ABOUT to send commit ``seq``
        carrying record ``offset`` — written (and fsynced) before the RPC,
        so no fold can ever outrun the journal's knowledge of it."""
        with self._lock:
            self._intents[int(wid)] = {"seq": int(seq), "offset": int(offset)}
            self._persist_locked()

    def committed(self, wid: int, offset: int,
                  event_ts: Optional[float] = None) -> None:
        """Record that ``offset``'s fold was ACKed (applied or duplicate):
        clear the intent, advance the contiguous frontier."""
        with self._lock:
            self._intents.pop(int(wid), None)
            self._mark_committed(int(offset), event_ts)
            self._persist_locked()

    def _mark_committed(self, offset: int,
                        event_ts: Optional[float]) -> None:
        with self._lock:
            self.items_committed += 1
            if event_ts is not None and (self.last_event_ts is None
                                         or event_ts > self.last_event_ts):
                self.last_event_ts = float(event_ts)
            if offset == self.frontier:
                self.frontier += 1
                while self.frontier in self._ahead:
                    self._ahead.discard(self.frontier)
                    self.frontier += 1
            elif offset > self.frontier:
                self._ahead.add(offset)
            # offset < frontier: already counted before a crash-replay — the
            # resolve path never produces this, but stay idempotent.

    def resolve(self, last_seq_by_wid: Dict[int, int]) -> list[int]:
        """Reconcile surviving intents against what the PS provably folded
        (its per-worker last seq). Returns the offsets whose fold landed
        but whose ACK was lost — they are marked committed here and must
        NOT be re-read. Remaining intents are dropped: their records were
        never folded and will be re-read and re-sent under fresh seqs."""
        landed: list[int] = []
        with self._lock:
            for wid, rec in list(self._intents.items()):
                if int(last_seq_by_wid.get(wid, -1)) >= int(rec["seq"]):
                    self._mark_committed(int(rec["offset"]), None)
                    landed.append(int(rec["offset"]))
                del self._intents[wid]
            self._persist_locked()  # intents were dropped either way
        return landed

    # -- resume queries ------------------------------------------------------

    def start_offset(self) -> int:
        with self._lock:
            return self.frontier

    def skip_offsets(self) -> frozenset:
        """Offsets >= frontier already committed (out-of-order) — the
        source must not re-deliver them."""
        with self._lock:
            return frozenset(self._ahead)

    def committed_offsets_upto(self, n: int) -> set[int]:
        """Every offset < n this journal holds as committed — the
        cross-check set the resume tests compare against the PS journal."""
        with self._lock:
            return {o for o in range(min(self.frontier, n))} | {
                o for o in self._ahead if o < n}

    def set_meta(self, **kv) -> None:
        with self._lock:
            self.meta.update(kv)
            self._persist_locked()

    def offset_lag(self, items_read: int) -> int:
        with self._lock:
            return max(0, int(items_read) - self.items_committed)


def replayed_offsets(journal_before: Iterable[int],
                     delivered_after: Iterable[int]) -> set[int]:
    """Offsets a restarted run re-delivered despite the journal already
    holding them as committed — the exactly-once violation set (must be
    empty). A helper for the resume tests/smoke."""
    return set(journal_before) & set(delivered_after)
