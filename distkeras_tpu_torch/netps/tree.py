"""N-level aggregation trees that survive the WAN (the port's counterpart
of the JAX package's ``netps/tree.py``).

:class:`~distkeras_tpu_torch.netps.hier.AggregatorServer` is one level:
host aggregators in front of the root. This module generalizes it into a
tree declared bottom-up by a :class:`TreeSpec` —
``DKTPU_TREE_SPEC="host:8,pool:4,region:2"`` — where every interior node is
a failure domain of its own:

* **Its own durable lineage.** A :class:`TreeNode` with a ``state_dir``
  journals every absorbed worker window (in absorb order, by its absorb
  cursor, since its update counter mirrors the ROOT lineage), snapshots,
  fences by epoch and cold-restarts deduping its children's retransmits. A
  warm :class:`TreeStandby` tails that journal over the ``replicate``
  stream, promotes when the node's lease lapses (bumping the epoch,
  fencing the dead node and **joining the root itself**), and the children
  re-parent through their endpoint list.

* **Per-link codecs.** A level may pin its uplinks' codec in the spec
  (``region:2:int8``); the pinned codec reaches the uplink through the
  dial's ``compress`` and a retune. Otherwise, with ``probe_links`` (the
  default), the node runs the tuner's timed probe sweep of the codecs
  over its uplink (:func:`~distkeras_tpu_torch.netps.tuner.probe.
  probe_codecs`, the center as the payload) and retunes to the winner;
  against a peer without the ``tuner`` bit, or when the sweep fails, the
  link keeps its join-negotiated codec.

* **Partition ride-through.** A black-holed uplink buffers up to
  ``DKTPU_TREE_BUFFER`` combined windows in host memory; on heal the buffer
  drains *in order* behind one membership re-proof, so exactly-once holds
  end to end. Past the bound the OLDEST windows degrade to **counted,
  typed drops** (``netps_tree_window_drop`` events naming the constituent
  (wid, seq) pairs) — never a silent divergence, never a deadlock on a
  dead uplink.

* **Link demotion and promotion.** ``link_down@K:S`` / ``link_flap@K:S``
  (``K = TreeSpec.link_key(level, group)``) in ``DKTPU_NET_FAULTS`` are
  consumed by the node's own uplink, since no chaos proxy can sit on every
  interior hop; a streak of ``demote_after`` transport failures redials
  the link over plain TCP (keeping the worker id, so upstream dedup
  holds), and ``_PROMOTE_AFTER_OKS`` healthy flushes redial it back.

The pre-combine is the aggregator's: one ``fold_commit`` launch an
absorbed commit into the device window. Window conservation is the
no-silent-loss contract, in every ``stats`` reply's ``tree`` block and the
``netps.tree.silent_loss`` gauge::

    absorbed == forwarded_commits + lost_commits + dropped_commits
                + buffered_commits + open_commits
"""

from __future__ import annotations

import collections
import re
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.netps.errors import NetPSError
from distkeras_tpu_torch.netps.fold import counter_scalar
from distkeras_tpu_torch.netps.hier import (_FLUSH_INTERVAL_S,
                                            AggregatorServer, _AbsorbWindow)
from distkeras_tpu_torch.netps.shards import make_ps_client
from distkeras_tpu_torch.netps.standby import StandbyServer
from distkeras_tpu_torch.netps.tuner.probe import best_codec, probe_codecs
from distkeras_tpu_torch.resilience import faults as _faults
from distkeras_tpu_torch.runtime import config

#: link-key stride: ``link_key = level * _LINK_STRIDE + group`` (the
#: fault-plan grammar forces the key into one integer; a level holds at
#: most 1000 groups).
_LINK_STRIDE = 1000

#: consecutive successful flushes on a demoted uplink before it is
#: redialed back up.
_PROMOTE_AFTER_OKS = 8

_LEVEL_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_-]*$")


@dataclass(frozen=True)
class TreeLevel:
    """One interior level, bottom-up: its name, the fan-in of each node at
    this level, and an optional pinned uplink codec."""

    name: str
    fanout: int
    codec: Optional[str] = None


@dataclass(frozen=True)
class TreeSpec:
    """The tree's shape, bottom-up (leaf-most level first).

    Grammar (``DKTPU_TREE_SPEC``)::

        level[,level...]     level := name:fanout[:codec]

    e.g. ``host:8,pool:4,region:2`` or ``host:4,region:2:int8``. Worker
    ``rank``'s level-k group is ``rank // prod(fanouts[:k+1])`` (contiguous
    assignment).
    """

    levels: Tuple[TreeLevel, ...]

    def __post_init__(self):
        if not self.levels:
            raise ValueError("a TreeSpec needs at least one level")
        seen = set()
        for lvl in self.levels:
            if not _LEVEL_NAME.match(lvl.name):
                raise ValueError(f"bad tree level name {lvl.name!r}")
            if lvl.name in seen:
                raise ValueError(f"duplicate tree level {lvl.name!r}")
            seen.add(lvl.name)
            if int(lvl.fanout) < 1:
                raise ValueError(
                    f"level {lvl.name!r}: fanout must be >= 1, "
                    f"got {lvl.fanout}")
            if lvl.codec is not None and lvl.codec not in wire.CODECS:
                raise ValueError(
                    f"level {lvl.name!r}: unknown codec {lvl.codec!r}; "
                    f"known: {list(wire.CODECS)}")

    @classmethod
    def parse(cls, spec: str) -> "TreeSpec":
        levels = []
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            if len(bits) not in (2, 3):
                raise ValueError(
                    f"bad tree level {part!r}: expected name:fanout[:codec]")
            try:
                fanout = int(bits[1])
            except ValueError:
                raise ValueError(
                    f"bad tree level {part!r}: fanout must be an integer")
            levels.append(TreeLevel(bits[0], fanout,
                                    bits[2] if len(bits) == 3 else None))
        return cls(tuple(levels))

    @classmethod
    def from_env(cls) -> Optional["TreeSpec"]:
        spec = config.env_str("DKTPU_TREE_SPEC")
        return cls.parse(spec) if spec else None

    def render(self) -> str:
        return ",".join(
            f"{lvl.name}:{lvl.fanout}" + (f":{lvl.codec}" if lvl.codec
                                          else "")
            for lvl in self.levels)

    @property
    def depth(self) -> int:
        return len(self.levels)

    def _stride(self, level: int) -> int:
        stride = 1
        for lvl in self.levels[:int(level) + 1]:
            stride *= int(lvl.fanout)
        return stride

    def group_of(self, rank: int, level: int) -> int:
        """Worker ``rank``'s group index at ``level`` (contiguous)."""
        return int(rank) // self._stride(level)

    def nodes_at(self, level: int, workers: int) -> int:
        """Interior node count at ``level`` for a ``workers``-wide tree."""
        stride = self._stride(level)
        return (int(workers) + stride - 1) // stride

    def parent_group(self, level: int, group: int) -> int:
        """The level+1 group a level-``level`` node flushes into."""
        if level + 1 >= self.depth:
            raise ValueError(f"level {level} is the top interior level")
        return int(group) // int(self.levels[level + 1].fanout)

    @staticmethod
    def link_key(level: int, group: int) -> int:
        """The (level, group) uplink packed into the one integer the
        fault-plan grammar allows (``link_down@K:S``)."""
        level, group = int(level), int(group)
        if level < 0 or group < 0 or group >= _LINK_STRIDE:
            raise ValueError(
                f"tree link (level={level}, group={group}) outside the "
                f"key encoding (0 <= group < {_LINK_STRIDE})")
        return level * _LINK_STRIDE + group

    @staticmethod
    def split_link_key(key: int) -> Tuple[int, int]:
        key = int(key)
        return key // _LINK_STRIDE, key % _LINK_STRIDE


class _Window(NamedTuple):
    """One taken combined window, in flight or buffered: the f32 sum (host
    arrays), its MIN pull counter and the constituent evidence."""

    acc: list
    pulled: int
    count: int
    members: int
    pairs: list


def _parse_spec(spec):
    return TreeSpec.parse(spec) if isinstance(spec, str) else spec


def _pinned_codec(spec, level: int, link_codec):
    if link_codec is None and spec is not None and level < spec.depth:
        return spec.levels[int(level)].codec
    return link_codec


class _TreeUplink:
    """The buffered, fault-aware uplink half of a tree node, mixed into
    :class:`TreeNode` (always) and :class:`TreeStandby` (armed at
    promotion), ahead of the host's
    :class:`~distkeras_tpu_torch.netps.hier._AbsorbWindow`."""

    def _init_tree_state(self, *, level, group, spec, buffer_windows,
                         link_codec, probe_links, demote_after, timeout,
                         retries, backoff) -> None:
        self.level = int(level)
        self.group = int(group)
        self.spec: Optional[TreeSpec] = _parse_spec(spec)
        self.link_key = TreeSpec.link_key(self.level, self.group)
        self.buffer_windows = int(
            buffer_windows if buffer_windows is not None
            else config.env_int("DKTPU_TREE_BUFFER"))
        if self.buffer_windows < 0:
            raise ValueError("buffer_windows must be >= 0")
        #: ride-through queue of taken-but-unlanded windows, oldest first
        #: (drain order IS absorb order).
        self._buffer: collections.deque = collections.deque()
        #: one drain at a time: the drain sends the buffer's head before it
        #: pops it, so two concurrent flushes (the flusher and a caller)
        #: would send one window twice under two seqs.
        self._drain_lock = threading.Lock()
        self._requested_link_codec = link_codec
        self._probe_links = bool(probe_links)
        #: the codec this uplink runs (pinned, probed, or the client's
        #: join-negotiated default).
        self.link_codec: Optional[str] = None
        self.dropped_windows = 0
        self.dropped_commits = 0
        self.demote_after = int(
            demote_after if demote_after is not None
            else config.env_int("DKTPU_TREE_DEMOTE_AFTER"))
        self._uplink_kw = dict(timeout=timeout, retries=retries,
                               backoff=backoff)
        self._uplink_fails = 0
        self._uplink_oks = 0
        self._uplink_demoted = False
        self.link_demotions = 0
        self.link_promotions = 0
        self.link_downs = 0
        #: monotonic deadline an injected link fault black-holes until.
        self._link_until = 0.0
        self._flap_at: Optional[float] = None
        self._flap_s = 0.0
        #: the uplink went dark since the last successful drain: heal
        #: re-proves membership before draining buffered windows.
        self._was_dark = False

    def _tree_caps(self, caps: dict) -> dict:
        caps["tree"] = {"level": self.level, "group": self.group,
                        "spec": self.spec.render() if self.spec else None}
        return caps

    # -- link fault consumption ----------------------------------------
    def _set_link_down(self, now: float, seconds: float) -> None:
        self._link_until = max(self._link_until, now + float(seconds))
        self.link_downs += 1
        telemetry.counter("netps.tree.link_downs").add(1)
        telemetry.event("netps_tree_link_down", {
            "level": self.level, "group": self.group,
            "seconds": float(seconds)})

    def _link_blackholed(self, consume: bool = True) -> bool:
        """Whether this node's uplink is black-holed right now. With
        ``consume`` (the flush path), also fires the ``link_down`` /
        ``link_flap`` faults keyed to this link."""
        now = time.monotonic()
        if consume:
            plan = _faults.active_net_plan()
            if plan is not None:
                arg = plan.fire("link_down", self.link_key)
                if arg is not None:
                    self._set_link_down(now, arg)
                arg = plan.fire("link_flap", self.link_key)
                if arg is not None:
                    # down S, up S, down S: the second outage arms here and
                    # fires when its time comes.
                    self._set_link_down(now, arg)
                    self._flap_s = float(arg)
                    self._flap_at = now + 2.0 * float(arg)
            if self._flap_at is not None and now >= self._flap_at:
                self._flap_at = None
                self._set_link_down(now, self._flap_s)
        down = now < self._link_until
        if down:
            self._was_dark = True
        return down

    # -- per-link codec ------------------------------------------------
    def _negotiate_link_codec(self) -> None:
        """Pick THIS link's codec: the spec's pinned codec if any
        (``how="pinned"``), else the tuner's timed probe sweep with the
        center as the payload, retuned to the winner (``how="probed"``;
        skipped with ``probe_links=False``, and empty against a peer
        without the ``tuner`` bit). Best-effort: with no evidence, or when
        the sweep fails, the join-negotiated default stands
        (``how="default"``); a failed probe leaves a working link."""
        up = self._up
        if up is None:
            return
        picked, how = None, "default"
        try:
            if self._requested_link_codec and hasattr(up, "retune"):
                up.retune(codec=self._requested_link_codec)
                picked, how = self._requested_link_codec, "pinned"
            elif self._probe_links and hasattr(up, "probe"):
                with self._lock:
                    # The served center: read-only arrays, replaced
                    # wholesale, so the sweep may hold them unlocked.
                    template = list(self._host or ())
                if template:
                    results = probe_codecs(up, template)
                    picked = best_codec(results)
                    if results:
                        how = "probed"
                    if picked is not None and picked != up.codec:
                        up.retune(codec=picked)
        except (NetPSError, OSError, ValueError):
            picked = None
        self.link_codec = (picked if picked is not None
                           else getattr(up, "codec", None))
        telemetry.counter("netps.tree.codec_negotiations").add(1)
        telemetry.event("netps_tree_link_codec", {
            "level": self.level, "group": self.group,
            "codec": self.link_codec, "how": how})

    # -- uplink lifecycle ----------------------------------------------
    def _uplink_client_kw(self) -> dict:
        kw = dict(self._uplink_kw)
        if self._requested_link_codec:
            kw["compress"] = self._requested_link_codec
        return kw

    def _ensure_uplink(self) -> bool:
        """Dial the upstream if this node has no live client (a standby
        promoted inside the partition that killed its primary). Failure is
        not an error: windows keep buffering, bounded and typed."""
        if self._up is not None:
            return True
        up = None
        try:
            with self._lock:
                init = (list(self._host_center_locked())
                        if self._flat is not None else [])
            up = make_ps_client(self.upstream, **self._uplink_client_kw())
            center, updates = up.join(init=init)
        except (NetPSError, OSError):
            if up is not None:
                up.close()
            return False
        with self._lock:
            self._up = up
            self._adopt_locked(center)
            self._updates = counter_scalar(updates)
        self._negotiate_link_codec()
        return True

    def _redial_uplink(self, transport: Optional[str]) -> bool:
        """Tear the uplink down and redial under ``transport`` (``None`` =
        renegotiate everything), KEEPING the worker id: the join's
        ``last_seq`` resume preserves upstream dedup, so a window sent
        before the swap cannot double-fold after it."""
        old = self._up
        if old is None:
            return self._ensure_uplink()
        kw = self._uplink_client_kw()
        if self.link_codec:
            kw["compress"] = self.link_codec
        up = None
        try:
            up = make_ps_client(self.upstream, transport=transport,
                                worker_id=getattr(old, "worker_id", None),
                                **kw)
            center, updates = up.join()
        except (NetPSError, OSError, ValueError):
            if up is not None:
                up.close()
            return False
        with self._lock:
            self._up = up
            self._adopt_locked(center)
            self._updates = counter_scalar(updates)
        try:
            old.close()
        except (NetPSError, OSError):
            pass
        return True

    def demote_uplink(self) -> bool:
        """Per-link demotion to plain TCP: automatic after
        ``demote_after`` consecutive transport failures, or by hand. No-op
        when already demoted."""
        if self._uplink_demoted or not self._redial_uplink("tcp"):
            return False
        self._uplink_demoted = True
        self._uplink_oks = 0
        self.link_demotions += 1
        telemetry.counter("netps.tree.link_demotions").add(1)
        telemetry.event("netps_tree_link_demoted", {
            "level": self.level, "group": self.group})
        return True

    def promote_uplink(self) -> bool:
        """Undo a demotion: redial with full negotiation. Automatic after a
        healthy streak on the demoted link."""
        if not self._uplink_demoted or not self._redial_uplink(None):
            return False
        self._uplink_demoted = False
        self.link_promotions += 1
        telemetry.counter("netps.tree.link_promotions").add(1)
        telemetry.event("netps_tree_link_promoted", {
            "level": self.level, "group": self.group})
        self._negotiate_link_codec()
        return True

    # -- the buffered flush --------------------------------------------
    def _send_window(self, win: _Window) -> str:
        """One upstream commit attempt: ``ok``, ``evicted`` (landed but
        discarded), or ``down`` (died in transport inside the client's
        bounded retry budget; the window stays buffered)."""
        try:
            res = self._up.commit(win.acc, win.pulled)
        except (NetPSError, OSError):
            return "down"
        return "evicted" if res.evicted else "ok"

    def _drop_windows(self, windows: Sequence[_Window]) -> None:
        """Typed, counted degradation past the buffer bound: name the
        constituents, bump the counters, move on."""
        count = sum(w.count for w in windows)
        self.dropped_windows += len(windows)
        self.dropped_commits += count
        telemetry.counter("netps.tree.dropped_windows").add(len(windows))
        telemetry.counter("netps.tree.dropped_commits").add(count)
        pairs = [p for w in windows for p in w.pairs][:512]
        telemetry.event("netps_tree_window_drop", {
            "reason": "buffer_overflow", "level": self.level,
            "group": self.group, "windows": len(windows), "count": count,
            "constituents": [[int(a), int(b)] for a, b in pairs]})

    def _flush_once(self, force: bool) -> bool:
        """The aggregator flush, with ride-through: take the due window
        into the bounded buffer, then drain the buffer in order while the
        uplink cooperates. Every window ends in exactly one ledger column —
        forwarded, lost, dropped, or still buffered."""
        with self._drain_lock:
            return self._drain(force)

    def _drain(self, force: bool) -> bool:
        dropped: list = []
        with self._lock:
            taken = self._take_acc_locked(force)
            if taken is not None:
                self._buffer.append(_Window(*taken))
            while len(self._buffer) > self.buffer_windows:
                dropped.append(self._buffer.popleft())
            pending = len(self._buffer)
        if dropped:
            self._drop_windows(dropped)
        if not pending:
            return taken is not None
        if self._up is None and not self._ensure_uplink():
            return True  # redial attempted; the bounded buffer holds
        if self._link_blackholed():
            telemetry.gauge("netps.tree.buffered_windows").set(
                float(pending))
            return True
        dark, self._was_dark = self._was_dark, False
        if dark:
            self._resync()
        sent = 0
        while True:
            with self._lock:
                win = self._buffer[0] if self._buffer else None
            if win is None:
                break
            outcome = self._send_window(win)
            if outcome == "down":
                self._was_dark = True
                self._uplink_fails += 1
                if (self.demote_after > 0
                        and self._uplink_fails >= self.demote_after
                        and not self._uplink_demoted):
                    self.demote_uplink()
                break
            self._uplink_fails = 0
            with self._lock:
                if self._buffer and self._buffer[0] is win:
                    self._buffer.popleft()
            if outcome == "evicted":
                self._lose_window(win.pairs, win.count)
            else:
                sent += 1
                self._count_forwarded(win.count, win.members)
        if dark and sent:
            telemetry.counter("netps.tree.drained_windows").add(sent)
        with self._lock:
            telemetry.gauge("netps.tree.buffered_windows").set(
                float(len(self._buffer)))
        if sent:
            self._uplink_oks += sent
            if self._uplink_demoted and self._uplink_oks >= _PROMOTE_AFTER_OKS:
                self.promote_uplink()
            self._resync()
        return True

    def _heartbeat_upstream(self) -> None:
        # A black-holed link loses heartbeats too: the upstream lease MAY
        # lapse during a partition; the heal path re-proves membership.
        if self._up is not None and not self._link_blackholed():
            try:
                self._up.heartbeat()
            except (NetPSError, OSError):
                pass

    def _lose_leftovers(self) -> None:
        """Windows still buffered when the node closes died with its
        uplink: typed losses, the ledger column a flat worker's dead commit
        lands in."""
        with self._lock:
            leftovers = list(self._buffer)
            self._buffer.clear()
        for win in leftovers:
            self._lose_window(win.pairs, win.count)

    # -- observability -------------------------------------------------
    def tree_stats(self) -> dict:
        """The window-conservation ledger and the link's state, served in
        every ``stats`` reply and exported as ``netps.tree.silent_loss``."""
        with self._lock:
            buffered_w = len(self._buffer)
            buffered_c = sum(w.count for w in self._buffer)
            open_c = self._acc_count
            silent = self.absorbed - (self.forwarded_commits
                                      + self.lost_commits
                                      + self.dropped_commits
                                      + buffered_c + open_c)
            out = {
                "level": self.level, "group": self.group,
                "link_key": self.link_key,
                "spec": self.spec.render() if self.spec else None,
                "absorbed": self.absorbed, "forwarded": self.forwarded,
                "forwarded_commits": self.forwarded_commits,
                "lost_windows": self.lost_windows,
                "lost_commits": self.lost_commits,
                "dropped_windows": self.dropped_windows,
                "dropped_commits": self.dropped_commits,
                "buffered_windows": buffered_w,
                "buffered_commits": buffered_c,
                "open_commits": open_c,
                "silent_loss": silent,
                "link_codec": self.link_codec,
                "link_down": time.monotonic() < self._link_until,
                "link_demoted": self._uplink_demoted,
                "link_demotions": self.link_demotions,
                "link_promotions": self.link_promotions,
                "link_downs": self.link_downs,
            }
        telemetry.gauge("netps.tree.silent_loss").set(float(silent))
        return out

    def _op_stats(self, header: dict) -> tuple:
        hdr, arrays = super()._op_stats(header)
        hdr["tree"] = self.tree_stats()
        return hdr, arrays

    def _op_replicate(self, header: dict) -> tuple:
        """Replicate replies carry the node's ROOT-lineage counter
        (``root_u``): the journal stream advances by the absorb cursor, but
        a standby promoting inside a partition needs the last known root
        counter to serve its children on."""
        hdr, arrays = super()._op_replicate(header)
        with self._lock:
            hdr["root_u"] = int(self._updates)
        return hdr, arrays


class TreeNode(_TreeUplink, AggregatorServer):
    """One interior aggregator of an N-level tree (see module docstring).

    Everything an :class:`~distkeras_tpu_torch.netps.hier.AggregatorServer`
    accepts applies (``device`` included: the card by default); on top,
    ``level``/``group`` locate the node in ``spec`` (and key its uplink for
    ``link_down``/``link_flap``), ``state_dir`` arms the node's own
    lineage, ``buffer_windows`` bounds partition ride-through,
    ``link_codec`` pins the uplink's codec (default: the spec level's) and
    ``probe_links`` runs the codec probe sweep on an unpinned uplink.
    """

    def __init__(self, upstream: str, *, level: int = 0, group: int = 0,
                 spec=None, buffer_windows: Optional[int] = None,
                 link_codec: Optional[str] = None, probe_links: bool = True,
                 demote_after: Optional[int] = None,
                 timeout: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff: Optional[float] = None, **agg_kw):
        spec = _parse_spec(spec)
        link_codec = _pinned_codec(spec, level, link_codec)
        self._init_tree_state(level=level, group=group, spec=spec,
                              buffer_windows=buffer_windows,
                              link_codec=link_codec,
                              probe_links=probe_links,
                              demote_after=demote_after, timeout=timeout,
                              retries=retries, backoff=backoff)
        super().__init__(upstream, timeout=timeout, retries=retries,
                         backoff=backoff, compress=link_codec, **agg_kw)
        self._negotiate_link_codec()

    def _caps(self) -> dict:
        return self._tree_caps(super()._caps())

    def close(self) -> None:
        super().close()  # drain, stop, final (buffered) flush, leave
        self._lose_leftovers()


class TreeStandby(_TreeUplink, _AbsorbWindow, StandbyServer):
    """The warm standby of one :class:`TreeNode`.

    Until promotion it is a :class:`~distkeras_tpu_torch.netps.standby.
    StandbyServer` tailing the node's absorb journal, except that a
    replicated record updates ONLY the dedup table, the evidence and the
    journal, never the center: records are absorbed worker deltas, and
    folding them into the adopted root center would double-count once the
    primary's flush lands upstream.

    Promotion takes over the failure domain: bump and persist the epoch,
    fence the dead node, join the ROOT as a fresh member (the dead node's
    unflushed windows died with it), adopt the root center and counter,
    turn the seated center into the device window, and absorb and flush as
    the node did. Children re-parent through their endpoint walk; their
    retransmits dedup against the replicated table. If the same partition
    severs the uplink, promotion completes on the last replicated root
    counter (``root_u``) and the flusher redials while windows buffer.
    ``link_codec`` and ``probe_links`` are :class:`TreeNode`'s, applied to
    the uplink promotion dials.
    """

    def __init__(self, primary_endpoint: str, *, upstream: str,
                 level: int = 0, group: int = 0, spec=None,
                 buffer_windows: Optional[int] = None,
                 link_codec: Optional[str] = None, probe_links: bool = True,
                 demote_after: Optional[int] = None,
                 fan_in: Optional[int] = None,
                 flush_interval: float = _FLUSH_INTERVAL_S,
                 timeout: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff: Optional[float] = None, **kw):
        spec = _parse_spec(spec)
        link_codec = _pinned_codec(spec, level, link_codec)
        self._init_tree_state(level=level, group=group, spec=spec,
                              buffer_windows=buffer_windows,
                              link_codec=link_codec,
                              probe_links=probe_links,
                              demote_after=demote_after, timeout=timeout,
                              retries=retries, backoff=backoff)
        super().__init__(primary_endpoint, **kw)
        self.upstream = upstream
        self.flush_interval = float(flush_interval)
        self.fan_in = fan_in
        self._up = None
        #: last root-lineage counter replicated from the primary (the
        #: ``root_u`` rider): the promotion seed when the uplink is dark.
        self._root_u = 0
        self._init_absorb_state()
        #: pre-promotion the replication cursor mirrors the update counter
        #: (one slot a record); promotion freezes it and repoints the
        #: counter at the root lineage.
        self._absorbs = int(self._updates)
        self._flush_cv = threading.Condition(self._lock)
        self._flusher_thread: Optional[threading.Thread] = None

    def _caps(self) -> dict:
        return self._tree_caps(super()._caps())

    # -- replication: dedup-table tail, never a center fold ------------
    def _apply(self, rhdr: dict, rarrays: list) -> bool:
        ru = rhdr.get("root_u")
        if ru is not None:
            self._root_u = int(ru)
        caught_up = super()._apply(rhdr, rarrays)
        with self._lock:
            if not self.promoted:
                self._absorbs = int(self._updates)
        return caught_up

    def _apply_record_locked(self, rec: dict, delta: list) -> None:
        """One replicated absorb record (lock held): the dedup table, the
        evidence log and this standby's own journal — NOT the center. The
        cursor (``_updates`` until promotion) advances as the primary's
        absorb cursor did."""
        wid, seq, st = int(rec["wid"]), int(rec["seq"]), int(rec["st"])
        self.commit_log.append((wid, seq, st))
        self._last_seq[wid] = seq
        self._ever.add(wid)
        self._updates += 1
        self.commits_total = int(rec.get("n", self.commits_total + 1))
        self.epoch = max(self.epoch, int(rec.get("e", 0)))
        if self._store is not None:
            self._store.append(epoch=self.epoch, wid=wid, seq=seq,
                               staleness=st, updates=self._updates - 1,
                               commits_total=self.commits_total,
                               delta=list(delta))
            if self._store.due(self._updates):
                self._snapshot_locked()
        self._trim_log_locked(2 * self._log_keep)

    def _snapshot_locked(self) -> None:
        """The snapshot cursor indexes this standby's OWN journal: the
        replication tail (``_updates``) until promotion, the absorb cursor
        after it (promotion repoints ``_updates`` at the root lineage)."""
        cursor = self._absorbs if self.promoted else self._updates
        t0 = time.perf_counter()
        self._store.snapshot(center=self._host_center_locked(),
                             updates=cursor, last_seq=self._last_seq,
                             epoch=self.epoch,
                             commits_total=self.commits_total)
        self.snapshot_seconds += time.perf_counter() - t0
        self.snapshots_written += 1
        self._trim_log_locked(self._log_keep + 1)

    # -- promotion: take over the failure domain AND its uplink --------
    def _arm_window_locked(self) -> None:
        """Turn the seated (replicated root) center into the device window
        (lock held): its host mirror becomes the served center, the seated
        tensor the empty accumulator."""
        if self._flat is None:
            return
        self._host = list(self._host_center_locked())
        self._reset_window_locked()

    def _promote(self) -> None:
        up = None
        center = updates = None
        try:
            with self._lock:
                init = (list(self._host_center_locked())
                        if self._flat is not None else [])
            up = make_ps_client(self.upstream, **self._uplink_client_kw())
            center, updates = up.join(init=init)
        except (NetPSError, OSError):
            if up is not None:
                up.close()
            up = None
        with self._lock:
            self._absorbs = int(self._updates)  # freeze the repl cursor
            self.epoch += 1
            self._arm_window_locked()
            if up is not None:
                self._up = up
                self._adopt_locked(center)
                self._updates = counter_scalar(updates)
            else:
                # Partitioned promotion: serve children on the last
                # replicated root counter; the flusher redials.
                self._updates = int(self._root_u)
            self._not_primary = False
            if self._store is not None:
                self._store.write_epoch(self.epoch)
            epoch = self.epoch
            cold = self._flat is None
            # Inside the lock: the first child commit this node accepts
            # must already see promoted=True (the snapshot-cursor switch).
            self.promoted = True
        self.promoted_at = time.monotonic()
        telemetry.counter("netps.failover.promotions").add(1)
        telemetry.event("netps_promotion", {
            "epoch": epoch, "updates": self._updates,
            "replicated": self.replicated, "cold": cold,
            "tree": {"level": self.level, "group": self.group,
                     "uplink": up is not None}})
        if up is not None:
            self._negotiate_link_codec()
        t = threading.Thread(target=self._fence_loop, args=(epoch,),
                             name="netps-standby-fence")
        t.start()
        self._fence_thread = t
        t2 = threading.Thread(target=self._flusher_loop,
                              name="netps-tree-flush")
        t2.start()
        self._flusher_thread = t2

    def close(self) -> None:
        super().close()  # drains, stops replicate/fence, joins handlers
        if self._flusher_thread is not None:
            self._stop_flusher()
            self._flush_once(force=True)
        if self._up is not None:
            try:
                self._up.leave()
            except (NetPSError, OSError):
                pass
            self._up.close()
        self._lose_leftovers()


# ---------------------------------------------------------------------------
# In-process assembly (tests, the loopback drills)
# ---------------------------------------------------------------------------

class TreeDeployment:
    """An in-process tree: every interior node live on loopback, leaf
    endpoints ready for workers. Built by :func:`build_tree`; ``close()``
    tears the tree down bottom-up (children drain into parents)."""

    def __init__(self, spec: TreeSpec, nodes):
        self.spec = spec
        #: ``nodes[level][group] -> TreeNode`` (interior levels only).
        self.nodes = nodes

    def leaf_endpoint(self, rank: int) -> str:
        return self.nodes[0][self.spec.group_of(rank, 0)].endpoint

    def node(self, level: int, group: int) -> TreeNode:
        return self.nodes[level][group]

    def close(self) -> None:
        for level in range(len(self.nodes)):
            for node in self.nodes[level].values():
                node.close()


def build_tree(spec, root_endpoint: str, workers: int,
               host: str = "127.0.0.1",
               init: Optional[Sequence[np.ndarray]] = None,
               **node_kw) -> TreeDeployment:
    """Stand up every interior node of ``spec`` on loopback, top level
    first (each node's upstream must listen before the node joins it).
    ``node_kw`` (discipline, lease_s, flush_interval, fan_in,
    buffer_windows, device, ...) applies to every node; per-node state
    directories are a launcher's concern and are not threaded."""
    spec = _parse_spec(spec)
    nodes: dict = {}
    try:
        for level in range(spec.depth - 1, -1, -1):
            nodes[level] = {}
            for group in range(spec.nodes_at(level, workers)):
                if level == spec.depth - 1:
                    upstream = root_endpoint
                else:
                    parent = spec.parent_group(level, group)
                    upstream = nodes[level + 1][parent].endpoint
                node = TreeNode(upstream, level=level, group=group,
                                spec=spec, host=host, port=0,
                                init=init if level == spec.depth - 1
                                else None,
                                **node_kw)
                node.start()
                nodes[level][group] = node
    except BaseException:
        for tier in nodes.values():
            for node in tier.values():
                node.close()
        raise
    return TreeDeployment(spec, {lvl: nodes[lvl] for lvl in sorted(nodes)})
