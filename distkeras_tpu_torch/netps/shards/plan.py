"""The :class:`PartitionPlan`: which shard server owns which tensor rows
(the port's copy of the JAX package's ``netps/shards/plan.py``, numpy only;
the canonical JSON, and so :attr:`PartitionPlan.plan_hash`, is
byte-identical to the JAX package's for the same names, shapes, rules, cap
and optimizer factor, so either package's shard servers and clients agree
on one plan).

The plan is the sharded center plane's single source of truth. It is
computed ONCE at job launch (deterministically, from the model's parameter
names/shapes plus the env knobs), carried by the first joiner to each
shard server, persisted in every shard's state dir, advertised back in
every join reply, and validated by hash on every later join — two peers
that disagree about the plan get a typed
:class:`~distkeras_tpu_torch.netps.errors.ShardPlanError`, never a silent
mis-fold.

Assignment has three layers, in order:

1. **Regex rules** (``DKTPU_PS_SHARD_RULES`` / ``rules=``): ordered
   ``pattern=target`` entries matched (``re.search``) against the
   parameter name — the ``match_partition_rules`` idiom, with the target
   a shard index (pin) or ``split`` (force a row-split across all
   shards). First match wins; unmatched tensors fall through.
2. **The per-shard byte cap** (``DKTPU_PS_SHARD_CAP_BYTES`` /
   ``cap_bytes=``): a tensor whose f32 bytes *plus its share of optimizer
   state* exceed the cap is row-split into contiguous range chunks, one
   per shard — this is what lets a model whose center + optimizer state
   exceeds one host train across N. Scalars never split.
3. **Byte-balanced greedy default**: everything else goes largest-first
   to the least-loaded shard — the same planner the client stripes
   tensors over *connections* with, extended to *servers*.

The byte model charges each tensor its f32 center bytes times
``(1 + opt_factor)``: the optimizer state (Adam's m/v, momentum, ...)
shadows the parameters one-for-one in structure, so a measured or
declared bytes-per-center-byte factor budgets it without the planner ever
touching an optimizer state. After planning, a configured cap is enforced:
a shard over it raises :class:`~distkeras_tpu_torch.netps.errors.
ShardPlanError` listing every load — the operator adds shards, never
silently OOMs.

:meth:`PartitionPlan.to_partition_specs` is the plan as partition rules
(``parallel/sharding.py Spec``) for the multi-device
``netps.mesh.MeshFolder``: the rows the shard servers own become the rows
each device owns.
"""

from __future__ import annotations

import hashlib
import json
import re
from typing import Optional, Sequence

import numpy as np

from distkeras_tpu_torch.netps.errors import ShardPlanError
from distkeras_tpu_torch.runtime import config

#: rule target forcing a row-split across every shard.
SPLIT = "split"

#: serialized-plan schema version (bumped only on layout changes — the
#: hash covers the content, this covers the shape of the content).
_PLAN_VERSION = 1


def parse_rules(spec: str) -> list:
    """``DKTPU_PS_SHARD_RULES`` grammar: ``;``-separated ``regex=target``
    entries, target a shard index or ``split``. Typed error on anything
    malformed — a typo'd rule silently balancing is exactly the kind of
    drift the plan hash exists to prevent."""
    rules = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        pattern, sep, target = entry.rpartition("=")
        if not sep or not pattern:
            raise ShardPlanError(
                f"bad shard rule {entry!r}: expected regex=shard|split")
        target = target.strip()
        if target != SPLIT:
            try:
                target = int(target)
            except ValueError:
                raise ShardPlanError(
                    f"bad shard rule target {target!r}: expected a shard "
                    f"index or {SPLIT!r}") from None
        try:
            re.compile(pattern)
        except re.error as e:
            raise ShardPlanError(
                f"bad shard rule regex {pattern!r}: {e}") from None
        rules.append((pattern, target))
    return rules


def default_names(n: int) -> list:
    return [f"param_{i:04d}" for i in range(n)]


class PartitionPlan:
    """Immutable tensor->shard assignment. ``segments[i]`` is tensor
    ``i``'s ordered row-range list ``[(shard, start, stop), ...]`` over
    axis 0 (one entry = unsplit; scalars are always one entry spanning
    their single logical row). ``loads[k]`` is shard ``k``'s budgeted
    bytes (center + optimizer share) — the skew gauge and the cap check
    both read it."""

    def __init__(self, num_shards: int, names: Sequence[str],
                 shapes: Sequence, segments: Sequence, loads: Sequence):
        self.num_shards = int(num_shards)
        self.names = [str(n) for n in names]
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.segments = [[(int(k), int(a), int(b)) for k, a, b in segs]
                         for segs in segments]
        self.loads = [int(b) for b in loads]
        if not (len(self.names) == len(self.shapes) == len(self.segments)):
            raise ShardPlanError("plan names/shapes/segments length skew")
        if len(self.loads) != self.num_shards:
            raise ShardPlanError("plan loads/num_shards length skew")

    # -- construction --------------------------------------------------
    @classmethod
    def build(cls, names: Sequence[str], shapes: Sequence,
              num_shards: int, *, rules=None,
              cap_bytes: Optional[int] = None,
              opt_factor: float = 0.0) -> "PartitionPlan":
        """Deterministic plan from names/shapes: rules, then cap-driven
        row-splits, then the byte-balanced greedy default. Every input is
        part of the hashed outcome — two processes building from the same
        inputs always agree."""
        num_shards = int(num_shards)
        if num_shards < 1:
            raise ShardPlanError(f"num_shards must be >= 1, got {num_shards}")
        names = [str(n) for n in names]
        shapes = [tuple(int(d) for d in s) for s in shapes]
        if len(names) != len(shapes):
            raise ShardPlanError(
                f"{len(names)} names vs {len(shapes)} shapes")
        rules = list(rules or ())
        opt_factor = max(0.0, float(opt_factor))
        # Budgeted bytes per tensor: f32 center + its optimizer shadow.
        nbytes = [int(4 * int(np.prod(s, dtype=np.int64)) if s else 4)
                  for s in shapes]
        nbytes = [int(round(b * (1.0 + opt_factor))) for b in nbytes]
        pinned: dict = {}
        forced_split: set = set()
        for i, name in enumerate(names):
            for pattern, target in rules:
                if re.search(pattern, name) is None:
                    continue
                if target == SPLIT:
                    if len(shapes[i]) > 0 and shapes[i][0] >= 2:
                        forced_split.add(i)
                    # A scalar (or single-row) "split" target degrades to
                    # the balanced default — there is nothing to split.
                elif not 0 <= int(target) < num_shards:
                    raise ShardPlanError(
                        f"rule {pattern!r} pins {name!r} to shard {target}, "
                        f"but the plan has {num_shards} shard(s)")
                else:
                    pinned[i] = int(target)
                break
        if cap_bytes:
            for i, b in enumerate(nbytes):
                if (b > int(cap_bytes) and i not in pinned
                        and len(shapes[i]) > 0 and shapes[i][0] >= 2):
                    forced_split.add(i)
        loads = [0] * num_shards
        segments: list = [None] * len(names)
        rows_of = [int(s[0]) if s else 1 for s in shapes]
        for i in sorted(forced_split):
            # Contiguous, near-equal row chunks, chunk j -> shard j: the
            # deterministic layout every client can re-derive from the
            # plan alone. Row cost is proportional (optimizer state is
            # per-parameter), so loads stay byte-accurate.
            rows = rows_of[i]
            chunks = min(num_shards, rows)
            bounds = [round(j * rows / chunks) for j in range(chunks + 1)]
            segs = []
            for j in range(chunks):
                a, b = bounds[j], bounds[j + 1]
                if a == b:
                    continue
                segs.append((j, a, b))
                loads[j] += int(round(nbytes[i] * (b - a) / rows))
            segments[i] = segs
        for i, k in pinned.items():
            segments[i] = [(k, 0, rows_of[i])]
            loads[k] += nbytes[i]
        free = [i for i in range(len(names)) if segments[i] is None]
        for i in sorted(free, key=lambda i: (-nbytes[i], i)):
            k = loads.index(min(loads))
            segments[i] = [(k, 0, rows_of[i])]
            loads[k] += nbytes[i]
        plan = cls(num_shards, names, shapes, segments, loads)
        if cap_bytes:
            over = [(k, b) for k, b in enumerate(loads) if b > int(cap_bytes)]
            if over:
                raise ShardPlanError(
                    f"plan exceeds the per-shard cap of {int(cap_bytes)} "
                    f"bytes on shard(s) {over}; all loads: {loads} — add "
                    f"shards or raise DKTPU_PS_SHARD_CAP_BYTES")
        return plan

    @classmethod
    def from_arrays(cls, arrays: Sequence, num_shards: int, *,
                    names: Optional[Sequence[str]] = None,
                    rules=None, cap_bytes: Optional[int] = None,
                    opt_factor: Optional[float] = None) -> "PartitionPlan":
        """Plan over concrete tensors, with every knob defaulting from the
        registry (``DKTPU_PS_SHARD_RULES`` / ``DKTPU_PS_SHARD_CAP_BYTES``
        / ``DKTPU_PS_SHARD_OPT_FACTOR``) — the one-call form the sharded
        client and the in-process shard set use."""
        shapes = [tuple(np.asarray(a).shape) for a in arrays]
        if names is None:
            names = default_names(len(shapes))
        if rules is None:
            rules = parse_rules(config.env_str("DKTPU_PS_SHARD_RULES"))
        if cap_bytes is None:
            cap_bytes = config.env_int("DKTPU_PS_SHARD_CAP_BYTES") or None
        if opt_factor is None:
            opt_factor = config.env_float("DKTPU_PS_SHARD_OPT_FACTOR")
            if opt_factor < 0.0:
                opt_factor = 0.0
        return cls.build(names, shapes, num_shards, rules=rules,
                         cap_bytes=cap_bytes, opt_factor=opt_factor)

    # -- identity ------------------------------------------------------
    def to_dict(self) -> dict:
        return {"version": _PLAN_VERSION, "num_shards": self.num_shards,
                "names": list(self.names),
                "shapes": [list(s) for s in self.shapes],
                "segments": [[list(seg) for seg in segs]
                             for segs in self.segments],
                "loads": list(self.loads)}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    def to_partition_specs(self, axis: str = "fold") -> list:
        """The wire plan as a device plan: ``(pattern, Spec)`` rules, one
        exact-match rule a tensor. A row-split tensor splits axis 0 over
        the ``axis`` devices; pinned and balanced tensors replicate. The
        result feeds ``parallel.sharding.param_path_specs`` unchanged."""
        from distkeras_tpu_torch.parallel.sharding import Spec

        return [(f"^{re.escape(name)}$",
                 Spec(axis) if len(segs) > 1 else Spec())
                for name, segs in zip(self.names, self.segments)]

    @classmethod
    def from_dict(cls, d: dict) -> "PartitionPlan":
        try:
            if int(d.get("version", -1)) != _PLAN_VERSION:
                raise ShardPlanError(
                    f"unsupported plan version {d.get('version')!r}")
            return cls(d["num_shards"], d["names"], d["shapes"],
                       d["segments"], d["loads"])
        except (KeyError, TypeError, ValueError) as e:
            raise ShardPlanError(f"malformed partition plan: {e}") from None

    @classmethod
    def from_json(cls, text: str) -> "PartitionPlan":
        try:
            d = json.loads(text)
        except ValueError as e:
            raise ShardPlanError(f"malformed partition plan: {e}") from None
        return cls.from_dict(d)

    @property
    def plan_hash(self) -> str:
        """sha256 over the canonical JSON — the join-time identity two
        peers must agree on before any tensor moves."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()

    def skew(self) -> float:
        """max/mean shard load — 1.0 is perfectly balanced; the telemetry
        gauge the report surfaces."""
        mean = sum(self.loads) / max(1, self.num_shards)
        return (max(self.loads) / mean) if mean > 0 else 1.0

    # -- slicing -------------------------------------------------------
    def _shard_segs(self, shard: int) -> list:
        """``(tensor_index, start, stop)`` owned by ``shard``, in the ONE
        canonical order (tensor index, then row start) both ends derive
        independently — the per-shard slice list IS this order."""
        out = []
        for i, segs in enumerate(self.segments):
            for k, a, b in segs:
                if k == shard:
                    out.append((i, a, b))
        return out

    def shard_shapes(self, shard: int) -> list:
        """Expected slice shapes on ``shard`` (join-init validation)."""
        out = []
        for i, a, b in self._shard_segs(shard):
            shape = self.shapes[i]
            out.append(shape if len(self.segments[i]) == 1
                       else (b - a,) + shape[1:])
        return out

    def shard_slice(self, tensors: Sequence, shard: int) -> list:
        """``shard``'s slice list of a full tensor list (commit scatter,
        join-init scatter). Unsplit tensors pass through un-copied."""
        if len(tensors) != len(self.segments):
            raise ShardPlanError(
                f"plan covers {len(self.segments)} tensors, got "
                f"{len(tensors)}")
        out = []
        for i, a, b in self._shard_segs(shard):
            t = np.asarray(tensors[i])
            out.append(t if len(self.segments[i]) == 1
                       else np.ascontiguousarray(t[a:b]))
        return out

    def scatter(self, tensors: Sequence) -> list:
        """All shards' slice lists at once: ``[shard_slice(t, k) for k]``."""
        return [self.shard_slice(tensors, k) for k in range(self.num_shards)]

    def assemble(self, per_shard: Sequence) -> list:
        """Inverse of :meth:`scatter`: per-shard slice lists back into the
        full tensor list (pull reassembly). Typed error on any skew —
        a torn plan must never assemble into a silently-wrong center."""
        if len(per_shard) != self.num_shards:
            raise ShardPlanError(
                f"assemble got {len(per_shard)} shard lists for "
                f"{self.num_shards} shards")
        out: list = [None] * len(self.segments)
        for k, slices in enumerate(per_shard):
            segs = self._shard_segs(k)
            if len(segs) != len(slices):
                raise ShardPlanError(
                    f"shard {k} returned {len(slices)} tensors, plan "
                    f"expects {len(segs)}")
            for (i, a, b), arr in zip(segs, slices):
                arr = np.asarray(arr)
                if len(self.segments[i]) == 1:
                    out[i] = arr
                else:
                    if out[i] is None:
                        out[i] = np.empty(self.shapes[i], np.float32)
                    out[i][a:b] = arr
        if any(t is None for t in out):
            raise ShardPlanError("assemble left holes: shard lists do not "
                                 "cover the plan")
        return out

    def __eq__(self, other) -> bool:
        return (isinstance(other, PartitionPlan)
                and self.to_dict() == other.to_dict())

    def __repr__(self) -> str:
        split = sum(1 for s in self.segments if len(s) > 1)
        return (f"PartitionPlan(shards={self.num_shards}, "
                f"tensors={len(self.segments)}, split={split}, "
                f"loads={self.loads}, hash={self.plan_hash[:12]})")


def plan_for_model(leaves: Sequence, num_shards: int, *,
                   names: Optional[Sequence[str]] = None,
                   opt_factor: Optional[float] = None) -> PartitionPlan:
    """The job-launch entry point: plan ``leaves`` (a flattened parameter
    tree) over ``num_shards`` servers, env-ruled and env-capped.
    ``opt_factor`` is the measured optimizer-bytes-per-center-byte (e.g.
    ~2.0 for Adam's m+v); callers that can cheaply measure it (the remote
    loop has the optimizer in hand) pass it so the cap covers center +
    optimizer state, not center alone; ``DKTPU_PS_SHARD_OPT_FACTOR >= 0``
    overrides any measurement."""
    env_factor = config.env_float("DKTPU_PS_SHARD_OPT_FACTOR")
    if env_factor >= 0.0:
        opt_factor = env_factor
    return PartitionPlan.from_arrays(
        leaves, num_shards, names=names,
        opt_factor=opt_factor if opt_factor is not None else 0.0)
