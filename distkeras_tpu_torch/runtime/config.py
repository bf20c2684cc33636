"""Run-level configuration and the typed ``DKTPU_*`` environment-variable
registry (the port's copy of ``distkeras_tpu/runtime/config.py``).

:class:`RunConfig` is the frozen dataclass the trainers normalize their
hyperparameter kwargs into; its ``dtype`` maps ``compute_dtype`` to a torch
dtype.

Each variable the port reads is declared once as an :class:`EnvVar`
(name, type, default, doc, category) and read through the typed ``env_*``
accessors below; this is the only module of the port that touches
``os.environ``. Names, kinds and defaults are the same as in the JAX
package's ``runtime/config.py``, so one environment configures both
packages alike. Only the keys the port reads are declared here; a later
slice adds its own rows when it ports the code that reads them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    batch_size: int = 32
    num_epoch: int = 1
    communication_window: int = 5
    learning_rate: float = 0.01
    num_workers: Optional[int] = None  # None -> one worker per device
    compute_dtype: Optional[str] = None  # params and master state stay f32
    seed: int = 0
    shuffle: bool = False
    drop_remainder: bool = True

    @property
    def dtype(self) -> Optional[torch.dtype]:
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{sorted(k for k in _DTYPES if k)} or None, "
                             f"got {self.compute_dtype!r}")
        return _DTYPES[self.compute_dtype]

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class EnvVar:
    """One declared environment variable: the registry row.

    ``kind`` is the accessor family (``bool``/``int``/``float``/``str``);
    ``default`` is what an unset or empty variable reads as (``None`` means
    "no value configured"). ``doc`` is one self-contained sentence.
    """

    name: str
    kind: str
    default: object
    doc: str
    # "observability" | "resilience" | "network" | "serving"
    category: str


def _declare(*vars_: EnvVar) -> dict:
    reg: dict = {}
    for v in vars_:
        if v.name in reg:
            raise ValueError(f"duplicate EnvVar {v.name!r}")
        reg[v.name] = v
    return reg


ENV_REGISTRY: dict = _declare(
    EnvVar("DKTPU_TELEMETRY", "bool", True,
           "Master switch for the telemetry registry; `0` swaps every "
           "span/counter/gauge/histogram for a no-op singleton.",
           "observability"),
    EnvVar("DKTPU_TRACE", "bool", False,
           "Fleet-wide distributed tracing (the JAX package's "
           "`telemetry/tracing/`). Not ported: the port's remote worker "
           "loop raises when it is set.",
           "observability"),
    EnvVar("DKTPU_TELEMETRY_ROTATE_MB", "float", 0.0,
           "Size bound (MiB) for telemetry/trace JSONL files: a file at or "
           "over the bound is rotated (atomic rename to `<path>.<n>`, "
           "generations numbered from 1) before the next append; the "
           "collector reads generations in order. 0 = no rotation "
           "(unbounded growth under streaming workloads).",
           "observability"),
    EnvVar("DKTPU_NAN_GUARD", "bool", True,
           "On-device NaN/Inf round skip in the engine round bodies; `0` "
           "disables (poisoned rounds then propagate into the center).",
           "resilience"),
    EnvVar("DKTPU_FEEDER_WARN", "float", 1.0,
           "Seconds of input-pipeline silence before the first stall "
           "warning; later warnings back off exponentially (2x, 4x, ...).",
           "resilience"),
    EnvVar("DKTPU_FEEDER_TIMEOUT", "float", 300.0,
           "Seconds of input-pipeline silence after which the RoundFeeder "
           "declares the data plane dead with `FeederStalledError`.",
           "resilience"),
    EnvVar("DKTPU_FEEDER_RETRIES", "int", 0,
           "Retries (exponential backoff) for a *failed* feeder stage call "
           "before the error propagates; 0 = off.",
           "resilience"),
    EnvVar("DKTPU_FAULTS", "str", "",
           "Fault-injection plan, `kind@round[:arg]` entries separated by "
           "`;` (e.g. `nan@3;stall@5:0.5;crash@7;seed=11`). Empty = no "
           "injection. See docs/RESILIENCE.md for the fault taxonomy.",
           "resilience"),
    EnvVar("DKTPU_FAULTS_STATE", "str", "",
           "Path to the fired-faults journal so one-shot faults (notably "
           "`kill@R`) survive the process restart they cause. Empty = "
           "in-memory only.",
           "resilience"),
    EnvVar("DKTPU_CKPT_DIGEST", "bool", True,
           "sha256 integrity sidecars next to each checkpoint step; `0` "
           "disables writing (and therefore verified restore).",
           "resilience"),
    EnvVar("DKTPU_DIVERGENCE_RESET", "float", None,
           "Divergent-worker reset threshold: a worker whose round loss "
           "strays further than this from the worker mean re-adopts the "
           "center. Unset = off.",
           "resilience"),
    EnvVar("DKTPU_NET_TIMEOUT", "float", 30.0,
           "Per-attempt RPC deadline (seconds) for every network "
           "operation: connect, send, and the full reply all fit inside it.",
           "network"),
    EnvVar("DKTPU_NET_RETRIES", "int", 5,
           "Retries after the first attempt for a retryable RPC failure "
           "(timeout, connection loss, framing error); typed rejections "
           "never retry.",
           "network"),
    EnvVar("DKTPU_NET_BACKOFF", "float", 0.05,
           "Base of the retry backoff: each retry sleeps a full-jitter "
           "draw from [0, base * 2^attempt), capped.",
           "network"),
    EnvVar("DKTPU_NET_MAX_FRAME", "int", 1 << 30,
           "Largest wire frame (bytes) either side will accept; oversized "
           "frames are rejected before any allocation.",
           "network"),
    EnvVar("DKTPU_NET_INFLIGHT", "int", 1,
           "Max un-ACKed netps commits a remote worker may have in flight "
           "while it computes ahead (compute/comms overlap); 1 = the serial "
           "pull -> compute -> commit loop. Staleness accounting always "
           "reflects the realized in-flight delay.",
           "network"),
    EnvVar("DKTPU_NET_SHARDS", "int", 1,
           "Connections a netps client stripes each pull/commit's tensors "
           "across (byte-balanced, one seq for the whole commit, which the "
           "server assembles and folds once); 1 = one socket. Applies only "
           "against a server whose join reply advertises `striping`.",
           "network"),
    EnvVar("DKTPU_NET_TRANSPORT", "str", "tcp",
           "netps wire dialect: `tcp` (default), `shm` (colocated peers, "
           "a boot-id match negotiated in the join reply, move payloads "
           "through a shared-memory ring with a UDS doorbell) or `mesh` "
           "(same-process peers hand requests to the server's in-process "
           "dispatch, folded into its device center; the ring is "
           "negotiated beside it as the demotion target, mesh -> shm -> "
           "tcp). Other pairs stay on the lower dialects.",
           "network"),
    EnvVar("DKTPU_NET_HIER", "bool", False,
           "Hierarchical two-level folds: each `run_remote` host "
           "interposes a per-host aggregator that pre-combines its "
           "workers' commits on its device (one fold-kernel launch a "
           "commit) and forwards one combined commit upstream, cutting "
           "root ingress by the worker fan-in (combined commit's pull "
           "counter = min of constituents).",
           "network"),
    EnvVar("DKTPU_NET_AUTOTUNE", "bool", False,
           "Self-tuning data plane (`netps/tuner/`): join-time micro A/B "
           "probes pick the codec per connection, and an online control "
           "loop over the live gauges retunes compression/inflight/"
           "striping mid-run through the existing renegotiation paths, "
           "with hysteresis and an oscillation fallback to the static "
           "knobs. Explicit `DKTPU_NET_*` knobs still win where set. "
           "Off by default.",
           "network"),
    EnvVar("DKTPU_TUNE_INTERVAL", "int", 8,
           "Rounds between online-controller evaluations when "
           "`DKTPU_NET_AUTOTUNE=1` — the control loop's clock; larger "
           "values react slower but measure cleaner windows.",
           "network"),
    EnvVar("DKTPU_TUNE_COOLDOWN", "int", 16,
           "Rounds a knob rests after the controller retunes it "
           "(per-knob hysteresis) — a knob can never be retuned faster "
           "than this regardless of what the gauges say.",
           "network"),
    EnvVar("DKTPU_TUNE_PROBES", "int", 3,
           "Timed probe round trips per candidate codec in the join-time "
           "micro A/B (each carries the full center payload; the score "
           "is logical f32 bytes per second of round trip).",
           "network"),
    EnvVar("DKTPU_TUNE_MAX_RETUNES", "int", 8,
           "Total mid-run retunes the controller may take before it "
           "freezes at whatever it converged to (bounded retune rate).",
           "network"),
    EnvVar("DKTPU_TUNE_OSC_LIMIT", "int", 3,
           "Consecutive back-to-previous flips of one knob before the "
           "controller declares oscillation, restores that knob's static "
           "initial value, and freezes it for the rest of the run.",
           "network"),
    EnvVar("DKTPU_TUNE_HIER_FANIN", "int", 4,
           "Per-host worker fan-in at/above which the controller picks "
           "hierarchical aggregation over flat topology (the bench "
           "`hier_curve` crossover; below it the aggregator's combining "
           "window costs more than it saves).",
           "network"),
    EnvVar("DKTPU_TUNE_MIN_GAIN", "float", 0.1,
           "Fractional commit-rate improvement a grown worker count must "
           "show over the best smaller count for the marginal-throughput "
           "expansion policy to keep expanding that job "
           "(`netps/tuner/fleet.py`).",
           "network"),
    EnvVar("DKTPU_TUNE_HIDDEN_FLOOR", "float", 0.5,
           "Target floor for `netps.overlap.hidden_fraction`: measured "
           "overlap below it means comms the compute loop still sees, "
           "and the controller widens inflight / shrinks the wire.",
           "network"),
    EnvVar("DKTPU_TUNE_STALE_CEIL", "float", 4.0,
           "Ceiling for `discipline.staleness_mean` (rounds): measured "
           "staleness above it means the overlap window outran the "
           "center, and the controller narrows inflight.",
           "network"),
    EnvVar("DKTPU_NET_FAULTS", "str", "",
           "Network-fault chaos plan (`kind@frame[:arg]`, e.g. "
           "`delay@3:0.2;drop@5;evict@2:1`), read by the chaos proxy, the "
           "server, the remote worker loop, the shm ring, the mesh "
           "dispatch and the serving frontend. Empty = no injection.",
           "network"),
    EnvVar("DKTPU_NET_COMPRESS", "str", "none",
           "Delta codec for commits: `none` (f32), `bf16` (truncate), or "
           "`int8` (per-tensor scale).",
           "network"),
    EnvVar("DKTPU_PS_ENDPOINT", "str", "",
           "Endpoint(s) of a running netps parameter server: `host:port`, "
           "or a comma-separated `primary:port,standby:port` list the "
           "client walks on failure/`not_primary` (failover); async "
           "trainers use it when `remote=` is not passed explicitly "
           "(`Job` sets it for every launched worker).",
           "network"),
    EnvVar("DKTPU_PS_STATE_DIR", "str", "",
           "Directory for the netps server's durable state (write-ahead "
           "commit journal + periodic center snapshots + sha256 sidecars); "
           "a restarted server recovers center/counter/dedup state from it "
           "and in-flight commits retransmit exactly-once. Empty = "
           "in-memory only (a PS crash loses every fold).",
           "network"),
    EnvVar("DKTPU_PS_SNAPSHOT_EVERY", "int", 500,
           "Folds between netps center snapshots when a state dir is set; "
           "each snapshot rotates + compacts the journal, so on-disk state "
           "stays bounded at ~2 snapshots plus the commits between them. "
           "0 disables snapshots (journal-only, unbounded).",
           "network"),
    EnvVar("DKTPU_PS_STANDBY", "str", "",
           "`host:port` of the PRIMARY a `python -m distkeras_tpu_torch."
           "netps` process should run as a warm standby of: it tails the "
           "primary's journal stream over the wire (`replicate` frames), "
           "promotes itself when the primary's lease lapses, and fences "
           "the old epoch. Empty = run as a primary.",
           "network"),
    EnvVar("DKTPU_TREE_SPEC", "str", "",
           "Aggregation-tree shape, bottom-up: `name:fanout[:codec]` "
           "levels separated by `,`, e.g. `host:8,pool:4,region:2` — "
           "workers flush into level-0 nodes, each level folds `fanout` "
           "children into one combined commit, the top level flushes into "
           "the root PS. A level's optional codec pins its uplinks "
           "(`region:2:int8`); otherwise each link keeps its "
           "join-negotiated codec. Empty = flat star (or the single "
           "`DKTPU_NET_HIER` level).",
           "network"),
    EnvVar("DKTPU_TREE_BUFFER", "int", 32,
           "Partition ride-through bound: combined windows a tree node "
           "buffers while its uplink is black-holed. The buffer drains "
           "in-order on heal (exactly-once end-to-end); past the bound "
           "the OLDEST windows degrade to counted, typed drops "
           "(`netps_tree_window_drop`) the staleness rule absorbs.",
           "network"),
    EnvVar("DKTPU_TREE_DEMOTE_AFTER", "int", 3,
           "Consecutive uplink transport failures before a tree node "
           "demotes that one link to plain TCP (per-link shm->TCP "
           "fallback, dedup-preserving redial); a healthy streak "
           "renegotiates back up. 0 disables auto-demotion.",
           "network"),
    EnvVar("DKTPU_PS_LEASE", "float", 10.0,
           "Membership lease (seconds); the endpoint walker's patience "
           "window for a multi-endpoint list is twice this plus one RPC "
           "deadline.",
           "network"),
    EnvVar("DKTPU_PS_SHARD_RULES", "str", "",
           "Partition rules for the sharded center plane: `regex=target` "
           "entries separated by `;`, first match wins, where target is a "
           "shard index (pin) or `split` (row-split across all shards); "
           "parameters matching no rule are byte-balanced greedily. Empty "
           "= fully rule-free balancing. The regexes match the port's "
           "parameter names (`model.params` keys, e.g. `tok_embed.weight`).",
           "sharding"),
    EnvVar("DKTPU_PS_SHARD_CAP_BYTES", "int", 0,
           "Per-shard byte budget (center + optimizer-state factor) the "
           "PartitionPlan must fit: tensors over the cap row-split, and a "
           "plan whose fattest shard still exceeds it is a typed "
           "`ShardPlanError` at build time, never an OOM at fold time. "
           "0 = unlimited.",
           "sharding"),
    EnvVar("DKTPU_PS_SHARD_OPT_FACTOR", "float", -1.0,
           "Optimizer-state byte multiplier the plan budgets per parameter "
           "byte (adagrad accumulators ~= 1.0): shard load = center bytes "
           "x (1 + factor). Negative = measure it from the optimizer's "
           "actual state at launch (`plan_for_model`).",
           "sharding"),
    EnvVar("DKTPU_SERVE_MAX_WAIT_MS", "float", 5.0,
           "Latency budget (milliseconds) the serving micro-batcher waits "
           "to coalesce concurrent requests into one batch before "
           "dispatching whatever it holds; 0 = dispatch immediately.",
           "serving"),
    EnvVar("DKTPU_SERVE_BUCKETS", "str", "1,4,16,64,256",
           "Comma-separated ascending batch-size buckets the serving "
           "frontend pads every micro-batch up to; each bucket's forward "
           "runs once at warmup, so ragged request batches never meet an "
           "unseen shape. The largest bucket is also the per-batch row cap.",
           "serving"),
    EnvVar("DKTPU_SERVE_QUEUE", "int", 256,
           "Admission-control bound on rows queued in the serving "
           "frontend; a request that would overflow it is shed with a "
           "typed `overloaded` reply BEFORE being accepted.",
           "serving"),
    EnvVar("DKTPU_SERVE_DEADLINE_MS", "float", None,
           "Optional per-request serving deadline (milliseconds, measured "
           "from admission): a queued request older than this is answered "
           "with a typed `deadline` reply instead of being computed. "
           "Unset = no deadline.",
           "serving"),
    EnvVar("DKTPU_SERVE_POLL_S", "float", 2.0,
           "Seconds between ModelRegistry checkpoint-directory polls for "
           "hot-swap candidates.",
           "serving"),
)

_FALSE_STRINGS = frozenset({"0", "false", "no", "off"})


def _registered(name: str) -> EnvVar:
    var = ENV_REGISTRY.get(name)
    if var is None:
        raise KeyError(
            f"{name!r} is not a registered environment variable; declare it "
            "in distkeras_tpu_torch.runtime.config.ENV_REGISTRY")
    return var


def _entry(name: str, kind: str) -> EnvVar:
    var = _registered(name)
    if var.kind != kind:
        raise TypeError(
            f"{name} is registered as kind={var.kind!r}; read it with "
            f"env_{var.kind}()")
    return var


def _raw(name: str) -> str:
    return os.environ.get(name, "").strip()


def env_bool(name: str) -> bool:
    """Registered boolean: unset/empty reads the declared default; any other
    value is truthy unless it is one of ``0/false/no/off``."""
    var = _entry(name, "bool")
    raw = _raw(name)
    if not raw:
        return bool(var.default)
    return raw.lower() not in _FALSE_STRINGS


def env_int(name: str) -> int:
    var = _entry(name, "int")
    raw = _raw(name)
    return int(raw) if raw else int(var.default)


def env_float(name: str) -> Optional[float]:
    """Registered float; a ``None`` default means "unset reads as None"."""
    var = _entry(name, "float")
    raw = _raw(name)
    if raw:
        return float(raw)
    return None if var.default is None else float(var.default)


def env_str(name: str) -> str:
    var = _entry(name, "str")
    return os.environ.get(name, "").strip() or str(var.default)


def env_is_set(name: str) -> bool:
    """Whether a registered variable was EXPLICITLY set (even to its
    default value): for callers whose own defaulting must yield to an
    operator's explicit choice (the autotuner never overrides a hand-set
    knob)."""
    _registered(name)
    return name in os.environ
