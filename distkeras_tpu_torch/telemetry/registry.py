"""The metric-name registry of the port: every telemetry name it emits,
declared once (the JAX package's ``telemetry/registry.py``, copied).

Every ``counter``/``gauge``/``histogram``/``span`` name the port emits is
declared here with its kind and one-line doc. A row for a name both
packages emit is the JAX package's row (same kind, category and doc);
the rows for names only the port emits (the checkpoint spans,
``native.scale_*``, ``netps.remote.local_window``,
``serving.dispatch_errors``) carry their own docs.
``tests/test_torch_telemetry_registry.py`` walks the port's source for
every name literal and f-string lead and holds each to this table, and
every shared row to the JAX package's kind (the JAX package's dk-check
DK601 keys on its own registry, so it cannot clear the port's names).

``dynamic=True`` rows are *prefixes*: the runtime appends a computed
suffix (the fleet plane's ``.tenant.job`` attribution, the sharded
center's ``.<k>`` shard index, the server span's op + transport dialect).
A static literal is declared iff it equals a static row's name or extends
a dynamic row's prefix; an f-string is declared iff its leading constant
is compatible with a dynamic row.

The registry is aggregation-free metadata — importing it never touches
the live :mod:`distkeras_tpu_torch.telemetry` registry object.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

#: metric kinds, matching the four name-taking telemetry accessors.
KINDS = ("counter", "gauge", "histogram", "span")


@dataclasses.dataclass(frozen=True)
class Metric:
    """One declared telemetry name (or name prefix when ``dynamic``)."""

    name: str
    kind: str
    category: str
    doc: str
    dynamic: bool = False


def _m(name: str, kind: str, category: str, doc: str,
       dynamic: bool = False) -> Metric:
    if kind not in KINDS:
        raise ValueError(f"unknown metric kind {kind!r} for {name!r}")
    return Metric(name, kind, category, doc, dynamic)


#: THE declaration list (grouped by category; order is the docs order).
_METRICS = [
    # -- training loop (MetricsLogger core) ------------------------------
    _m("rounds", "counter", "training",
       "Training rounds recorded by MetricsLogger."),
    _m("round_seconds", "histogram", "training",
       "Wall-clock seconds per recorded round."),
    _m("loss", "gauge", "training",
       "Most recent per-round loss (min/max/mean tracked)."),
    # -- engine run loops -------------------------------------------------
    _m("engine_run", "span", "engine",
       "Anchor span for one engine run loop; phase spans nest under it."),
    _m("dispatch[per-round]", "span", "engine",
       "Host enqueue latency, per-round blocking dispatch."),
    _m("dispatch[auto]", "span", "engine",
       "Host enqueue latency under auto-blocked (bursty) dispatch."),
    _m("dispatch[stream]", "span", "engine",
       "Host enqueue latency on the streaming dispatch path."),
    _m("retire[per-round]", "span", "engine",
       "Per-round retire fence: the blocking loss fetch."),
    _m("retire[stream]", "span", "engine",
       "Streaming retire fence: end-of-run drain."),
    _m("dispatch[blocked]", "span", "engine",
       "Host call of one multi-round program (a block of R rounds): the "
       "state and batch copies and the graph replay (or the host loop)."),
    _m("retire[blocked]", "span", "engine",
       "Per-block retire fence: the blocking fetch of the block's losses."),
    _m("retire[auto]", "span", "engine",
       "Per-block retire fence of the blocks auto sizing chose."),
    _m("program.capture", "span", "engine",
       "Warm-up round and CUDA graph capture of one multi-round program."),
    _m("program.blocks.graph", "counter", "engine",
       "Blocks a multi-round program ran as a replayed CUDA graph."),
    _m("program.blocks.eager", "counter", "engine",
       "Blocks a multi-round program ran as a host loop of rounds."),
    _m("program.rounds_per_program", "gauge", "engine",
       "Rounds a program of the current blocked run (auto's choice)."),
    _m("input_stall", "histogram", "engine",
       "Consumer time blocked on the data plane, per round."),
    _m("input_stall_seconds", "counter", "engine",
       "Total consumer seconds blocked on the data plane."),
    _m("pipeline.dispatch", "span", "engine",
       "Pipeline engine step dispatch latency."),
    _m("stage[tp-local]", "span", "engine",
       "AsyncTP local parameter staging per round."),
    # -- data plane -------------------------------------------------------
    _m("feeder.stage", "histogram", "data",
       "Producer-side gather+transform+device_put seconds per round."),
    _m("feeder.queue_depth", "gauge", "data",
       "Prefetch queue depth at each pop (0 = stalls imminent)."),
    _m("feeder.fill_ratio", "gauge", "data",
       "Prefetch fill ratio at each pop (1.0 = staging fully hidden)."),
    _m("native.gather", "span", "data",
       "Native loader gather latency."),
    _m("native.gather_calls", "counter", "data",
       "Native gather invocations."),
    _m("native.gather_bytes", "counter", "data",
       "Bytes moved by the native gather path."),
    _m("native.gather_fallback_calls", "counter", "data",
       "Silent numpy fallbacks (a data-plane regression signal)."),
    _m("native.scale_calls", "counter", "data",
       "Native float32 scale invocations (the port's MinMax and uint8 "
       "rescale path)."),
    _m("native.scale_fallback_calls", "counter", "data",
       "Scale calls that took numpy instead (no library, another dtype, "
       "a strided array, or DKTPU_NO_NATIVE=1)."),
    # -- inference --------------------------------------------------------
    _m("predict.chunk", "span", "inference",
       "Per-chunk end-to-end predict latency."),
    _m("predict.rows", "counter", "inference",
       "Rows predicted."),
    _m("predict.padded_rows", "counter", "inference",
       "Rows of batch padding added by the predictor."),
    _m("predict.pending_rows", "gauge", "inference",
       "Streaming-predict backlog in rows."),
    _m("predict.shard_rows", "histogram", "inference",
       "Rows per predict shard (skew = max/mean)."),
    _m("predict.shard_seconds", "histogram", "inference",
       "Seconds per predict shard."),
    _m("predict.stream_microbatch", "span", "inference",
       "Streaming-inference micro-batch (ingest+compute only)."),
    _m("predict.stream_rows", "counter", "inference",
       "Rows answered by streaming inference."),
    # -- disciplines ------------------------------------------------------
    _m("discipline.staleness_mean", "gauge", "disciplines",
       "Mean realized staleness charged by the discipline."),
    _m("discipline.staleness_max", "gauge", "disciplines",
       "Max realized staleness charged by the discipline."),
    _m("discipline.dynsgd_scale_min", "gauge", "disciplines",
       "Smallest DynSGD scale (1/(staleness+1)) applied."),
    _m("discipline.loss_divergence_max", "gauge", "disciplines",
       "Largest per-worker loss divergence from the mean."),
    _m("discipline.straggler_rounds", "counter", "disciplines",
       "Rounds flagged as stragglers (time > k x running median)."),
    # -- resilience -------------------------------------------------------
    _m("resilience.nonfinite_rounds", "counter", "resilience",
       "Rounds the NaN/Inf guard skipped."),
    _m("resilience.feeder_stall_warnings", "counter", "resilience",
       "Feeder stall watchdog warnings."),
    _m("resilience.feeder_stall_deaths", "counter", "resilience",
       "Feeders declared dead by the stall watchdog."),
    _m("resilience.feeder_retries", "counter", "resilience",
       "Feeder stage retries after an injected/real error."),
    _m("resilience.worker_resets", "counter", "resilience",
       "Divergent workers re-adopted from the center."),
    _m("resilience.ckpt_corrupt_detected", "counter", "resilience",
       "Checkpoint integrity failures detected by digest sidecars."),
    _m("resilience.ckpt_fallback_steps", "counter", "resilience",
       "Restores that fell back to a previous checkpoint step."),
    _m("resilience.supervisor_retries", "counter", "resilience",
       "Supervisor retry-with-resume attempts."),
    _m("resilience.supervisor_exhausted", "counter", "resilience",
       "Supervisor retry budgets exhausted."),
    _m("resilience.host_restarts", "counter", "resilience",
       "Per-host restarts by Job.supervise."),
    _m("resilience.straggler_kills", "counter", "resilience",
       "Straggler hosts killed by Job.supervise."),
    _m("resilience.ps_restarts", "counter", "resilience",
       "Parameter-server restarts by Job.supervise."),
    _m("resilience.liveness_kills", "counter", "resilience",
       "Hosts killed for failing the liveness contract."),
    _m("resilience.faults_injected", "counter", "resilience",
       "Faults fired from the active DKTPU_FAULTS plan."),
    _m("resilience.supervised_train", "span", "resilience",
       "One supervised training attempt (retries nest as new spans)."),
    # -- checkpoints (the port's Checkpointer) ----------------------------
    _m("checkpoint.save", "span", "checkpoint",
       "One Checkpointer.save call, end to end (holds copy, digest, "
       "write)."),
    _m("copy", "span", "checkpoint",
       "Inside checkpoint.save: the state copied to the host."),
    _m("digest", "span", "checkpoint",
       "Inside checkpoint.save: the sha256 sidecar's hash."),
    _m("write", "span", "checkpoint",
       "Inside checkpoint.save: state.pt, the rename, the sidecars and "
       "the retention sweep."),
    _m("load", "span", "checkpoint",
       "Inside checkpoint.restore: state.pt read back to the host."),
    _m("verify", "span", "checkpoint",
       "Inside checkpoint.restore: the digest sidecar checked."),
    # -- networked PS -----------------------------------------------------
    _m("netps.commits", "counter", "netps",
       "Commits folded into the center (exactly-once evidence)."),
    _m("netps.commits_deduped", "counter", "netps",
       "Retransmitted commits answered from the dedup table."),
    _m("netps.bytes_sent", "counter", "netps",
       "Wire bytes sent (both sides count their own)."),
    _m("netps.bytes_received", "counter", "netps",
       "Wire bytes received."),
    _m("netps.bytes_precompress", "counter", "netps",
       "Commit bytes before the DKTPU_NET_COMPRESS codec."),
    _m("netps.protocol_errors", "counter", "netps",
       "Frames rejected by magic/crc/size/spec checks."),
    _m("netps.retries", "counter", "netps",
       "RPC retries after a retryable failure."),
    _m("netps.reconnects", "counter", "netps",
       "Client reconnects after a dead connection."),
    _m("netps.rejoins", "counter", "netps",
       "Evicted workers re-admitted mid-run."),
    _m("netps.evictions", "counter", "netps",
       "Workers evicted on lease expiry."),
    _m("netps.revocations", "counter", "netps",
       "Administrative lease revocations (the preemption primitive)."),
    _m("netps.probes", "counter", "netps",
       "Tuner probe round trips answered."),
    _m("netps.rpc_failures", "counter", "netps",
       "RPC attempts that failed (timeout, connection loss, framing)."),
    _m("netps.stale_replies", "counter", "netps",
       "Duplicate replies discarded by the request-id echo."),
    _m("netps.shm_upgrades", "counter", "netps",
       "Routine post-join TCP-to-ring transport upgrades."),
    _m("netps.shm_fallbacks", "counter", "netps",
       "Mid-run ring-to-TCP downgrades after ring failures."),
    _m("netps.mesh.upgrades", "counter", "netps",
       "Post-join upgrades onto the same-runtime device-mesh dispatch."),
    _m("netps.mesh.folds", "counter", "netps",
       "Commits folded by the device-resident center's collective."),
    _m("netps.mesh.demotions", "counter", "netps",
       "Mesh-to-shm/TCP demotions (device loss, mesh_down, gone peer)."),
    _m("netps.endpoint_walks", "counter", "netps",
       "Endpoint-list failover steps taken by clients."),
    _m("netps.pull_torn_retries", "counter", "netps",
       "Striped pulls re-read across a concurrent fold."),
    _m("netps.fold.tensors_per_sec", "gauge", "netps",
       "Fold throughput of the most recent commit."),
    _m("netps.overlap.hidden_fraction", "gauge", "netps",
       "1 - visible comms wait / total comms time (overlap win)."),
    _m("netps.commit.staleness", "histogram", "netps",
       "Realized staleness the server charged per commit."),
    _m("netps.remote_train", "span", "netps",
       "The remote worker loop, end to end."),
    _m("netps.remote.local_window", "span", "netps",
       "One worker's local window of the remote loop (the steps between "
       "a pull and its commit)."),
    _m("netps.server.", "span", "netps",
       "Server-side per-op handler latency; suffix = op + transport "
       "dialect.", dynamic=True),
    _m("netps.rpc.", "span", "netps",
       "Client-side per-op RPC latency; suffix = op, stripe, dialect.",
       dynamic=True),
    _m("netps.hier.fan_in", "gauge", "netps",
       "Per-host aggregator worker fan-in."),
    _m("netps.hier.worker_commits", "counter", "netps",
       "Worker commits absorbed by per-host aggregators."),
    _m("netps.hier.combined_commits", "counter", "netps",
       "Combined commits forwarded upstream (ratio = ingress cut)."),
    _m("netps.hier.lost_windows", "counter", "netps",
       "Combined windows lost to an upstream eviction."),
    _m("netps.tree.buffered_windows", "gauge", "netps",
       "Combined windows riding out a dark uplink in a tree node."),
    _m("netps.tree.drained_windows", "counter", "netps",
       "Buffered windows drained in-order after an uplink heal."),
    _m("netps.tree.dropped_windows", "counter", "netps",
       "Windows dropped (typed) past the tree ride-through bound."),
    _m("netps.tree.dropped_commits", "counter", "netps",
       "Constituent worker commits inside dropped tree windows."),
    _m("netps.tree.silent_loss", "gauge", "netps",
       "Tree window-conservation residual; nonzero = a silent loss."),
    _m("netps.tree.link_downs", "counter", "netps",
       "Injected link_down/link_flap outages consumed by tree uplinks."),
    _m("netps.tree.link_demotions", "counter", "netps",
       "Tree uplinks demoted to plain TCP after failure streaks."),
    _m("netps.tree.link_promotions", "counter", "netps",
       "Demoted tree uplinks renegotiated back up."),
    _m("netps.tree.codec_negotiations", "counter", "netps",
       "Per-link codec picks (pinned, probed, or default)."),
    _m("netps.recovery.snapshots", "gauge", "netps",
       "Snapshots written by the live server."),
    _m("netps.recovery.snapshot_loads", "counter", "netps",
       "Snapshots loaded on recovery (newest-intact-first)."),
    _m("netps.recovery.snapshots_rejected", "counter", "netps",
       "Corrupt snapshots rejected during the recovery walk."),
    _m("netps.recovery.replayed_commits", "counter", "netps",
       "Journal records replayed onto the recovered snapshot."),
    _m("netps.recovery.journals_truncated", "counter", "netps",
       "Crash-torn journal tails dropped on recovery."),
    _m("netps.recovery.journal_gaps", "counter", "netps",
       "Interior journal damage detected on recovery."),
    _m("netps.failover.promotions", "counter", "netps",
       "Warm standbys promoted to primary."),
    _m("netps.failover.replicated_commits", "counter", "netps",
       "Journal records applied by tailing standbys."),
    _m("netps.failover.replicate_rejected", "counter", "netps",
       "Replication records a standby refused (lineage change)."),
    _m("netps.failover.snapshot_syncs", "counter", "netps",
       "Full state syncs answered to fresh/behind standbys."),
    _m("netps.failover.fenced_commits", "counter", "netps",
       "Stale-epoch commits rejected (zero-stale-epoch-folds proof)."),
    _m("netps.failover.fences_accepted", "counter", "netps",
       "Fence ops accepted (a zombie ex-primary stopped folding)."),
    _m("netps.shard.count", "gauge", "netps",
       "Shards in the deployed partition plan."),
    _m("netps.shard.skew", "gauge", "netps",
       "Planned byte skew across shards."),
    _m("netps.shard.partial_commits", "counter", "netps",
       "Commits reconciled by same-seq retransmit after shard failure."),
    _m("netps.shard.folds.", "counter", "netps",
       "Per-shard fold count; suffix = shard index.", dynamic=True),
    _m("netps.shard.bytes.", "counter", "netps",
       "Per-shard fold bytes; suffix = shard index.", dynamic=True),
    # -- fleet control plane (suffix = .tenant.job attribution) -----------
    _m("fleet.submitted", "counter", "fleet",
       "Jobs submitted to the scheduler."),
    _m("fleet.liveness_requeues", "counter", "fleet",
       "Jobs requeued by the liveness sentinel."),
    _m("fleet.serving_drains_refused", "counter", "fleet",
       "Full-drain preemptions refused by the serving floor."),
    _m("fleet.commits", "counter", "fleet",
       "Per-job applied commits; suffix = tenant.job.", dynamic=True),
    _m("fleet.round", "span", "fleet",
       "Per-job worker round; suffix = tenant.job.", dynamic=True),
    _m("fleet.preemptions.", "counter", "fleet",
       "Per-tenant preemptions.", dynamic=True),
    _m("fleet.shrinks.", "counter", "fleet",
       "Per-tenant gang shrinks.", dynamic=True),
    _m("fleet.expands.", "counter", "fleet",
       "Per-tenant gang re-expansions.", dynamic=True),
    _m("fleet.restarts.", "counter", "fleet",
       "Per-tenant crashed-worker restarts.", dynamic=True),
    _m("fleet.placements.", "counter", "fleet",
       "Per-tenant gang placements.", dynamic=True),
    _m("fleet.granted.", "gauge", "fleet",
       "Per-tenant slots currently granted.", dynamic=True),
    _m("fleet.preempt_debt.", "gauge", "fleet",
       "Per-tenant outstanding preemption debt.", dynamic=True),
    _m("fleet.staleness_mean", "gauge", "fleet",
       "Per-job mean staleness; suffix = tenant.job.", dynamic=True),
    _m("fleet.staleness_max", "gauge", "fleet",
       "Per-job max staleness; suffix = tenant.job.", dynamic=True),
    # -- serving plane ----------------------------------------------------
    _m("serving.accepted", "counter", "serving",
       "Requests admitted past the queue bound."),
    _m("serving.answered", "counter", "serving",
       "Accepted requests answered (result or typed error)."),
    _m("serving.shed", "counter", "serving",
       "Requests shed before admission (typed overloaded reply)."),
    _m("serving.deadline_drops", "counter", "serving",
       "Accepted requests answered with the typed deadline error."),
    _m("serving.queue_depth", "gauge", "serving",
       "Admission queue depth."),
    _m("serving.latency", "histogram", "serving",
       "Admission-to-reply latency (report CLI derives p50/p99)."),
    _m("serving.batches", "counter", "serving",
       "Micro-batches dispatched."),
    _m("serving.batched_rows", "counter", "serving",
       "Rows dispatched inside micro-batches."),
    _m("serving.padded_rows", "counter", "serving",
       "Bucket-padding rows (overhead = padded/batched)."),
    _m("serving.dispatch", "span", "serving",
       "Micro-batch dispatch latency."),
    _m("serving.dispatch_errors", "counter", "serving",
       "Micro-batches whose dispatch raised (every request in the batch "
       "answered with a typed serving error)."),
    _m("serving.retrace_after_warmup", "counter", "serving",
       "Post-warmup retraces (must stay 0)."),
    _m("serving.swaps", "counter", "serving",
       "Hot-swaps to a newer verified checkpoint."),
    _m("serving.swap_failures", "counter", "serving",
       "Candidate checkpoints rejected by verify/warmup."),
    _m("serving.swap_rejected_regression", "counter", "serving",
       "Candidates rejected by the regression gate."),
    _m("serving.freshness", "histogram", "serving",
       "Served-model staleness at swap time."),
    _m("serving.freshness_s", "gauge", "serving",
       "Seconds between served model's data and now."),
    _m("serving.client_failovers", "counter", "serving",
       "Client endpoint walks to a surviving replica."),
    _m("serving.conn_errors", "counter", "serving",
       "Serving client transport errors."),
    # -- streaming continual training -------------------------------------
    _m("stream.items_read", "counter", "streaming",
       "Records read from the stream source."),
    _m("stream.items_committed", "counter", "streaming",
       "Records provably folded (journal-committed); may carry a "
       "per-job suffix.", dynamic=True),
    _m("stream.requeued", "counter", "streaming",
       "Records re-queued after a failed commit attempt.", dynamic=True),
    _m("stream.source_reconnects", "counter", "streaming",
       "Stream source reconnects after a gap/error."),
    _m("stream.drift_injected", "counter", "streaming",
       "Injected concept-drift triggers consumed."),
    _m("stream.drift_events", "counter", "streaming",
       "Drift divergence pages fired by windowed eval."),
    _m("stream.offset_lag", "gauge", "streaming",
       "Records read but not yet journal-committed."),
    _m("stream.eval.loss_fast", "gauge", "streaming",
       "Fast-window eval loss (drift detector input)."),
    _m("stream.eval.loss_slow", "gauge", "streaming",
       "Slow-window eval loss (drift detector baseline)."),
    _m("stream.candidate_loss", "gauge", "streaming",
       "Candidate checkpoint eval loss at the regression gate."),
    _m("stream.recovery_seconds", "gauge", "streaming",
       "Post-drift recovery time to the pre-drift loss band."),
    _m("stream.staleness_mean", "gauge", "streaming",
       "Mean staleness of streaming commits.", dynamic=True),
    _m("stream.checkpoint", "span", "streaming",
       "Streaming checkpoint write (journal + meta + arrays)."),
    _m("stream.item", "span", "streaming",
       "One record's train+commit; suffix = worker slot.", dynamic=True),
    # -- self-tuning data plane -------------------------------------------
    _m("tuner.probes", "counter", "tuner",
       "Join-time micro-A/B probes sent."),
    _m("tuner.decisions", "counter", "tuner",
       "Knob decisions adopted."),
    _m("tuner.decision.", "counter", "tuner",
       "Adopted decisions; suffix = knob name.", dynamic=True),
    _m("tuner.deferred", "counter", "tuner",
       "Decisions deferred by the hysteresis window."),
    _m("tuner.floor_violations", "counter", "tuner",
       "Throughput floor violations observed."),
    _m("tuner.oscillation_fallbacks", "counter", "tuner",
       "Knobs frozen after oscillating decisions."),
    _m("tuner.expand_blocked", "counter", "tuner",
       "Fleet expansions blocked by marginal-throughput evidence."),
    _m("tuner.knob_warnings", "counter", "tuner",
       "Client-side warnings for rejected knob applications."),
    _m("tuner.knob.codec", "gauge", "tuner",
       "Active codec knob (index into the codec list)."),
    _m("tuner.knob.inflight", "gauge", "tuner",
       "Active in-flight window knob."),
    _m("tuner.knob.shards", "gauge", "tuner",
       "Active stripe-count knob."),
    _m("tuner.knob.", "gauge", "tuner",
       "Active value per tuned knob.", dynamic=True),
    _m("tuner.marginal_tput.", "gauge", "tuner",
       "Marginal throughput per added worker; suffix = job.",
       dynamic=True),
    # -- health / vitals --------------------------------------------------
    _m("health.alerts_fired", "counter", "health",
       "SLO burn-rate alerts fired."),
    _m("health.alerts_cleared", "counter", "health",
       "SLO alerts cleared after recovery."),
    _m("runtime.rss_mb", "gauge", "runtime",
       "Process resident set size, MB."),
    _m("runtime.open_fds", "gauge", "runtime",
       "Open file descriptors."),
    _m("device.bytes_in_use", "gauge", "runtime",
       "Accelerator bytes in use (when the backend reports it)."),
]

#: name -> Metric; the declaration above is the single source of truth.
METRIC_REGISTRY: Dict[str, Metric] = {}
for _entry in _METRICS:
    if _entry.name in METRIC_REGISTRY:
        raise ValueError(f"duplicate metric declaration {_entry.name!r}")
    METRIC_REGISTRY[_entry.name] = _entry
del _entry

#: category names in declaration order (the docs table order).
CATEGORIES = tuple(dict.fromkeys(m.category for m in _METRICS))


def iter_metrics(category: Optional[str] = None) -> Iterable[Metric]:
    if category is not None and category not in CATEGORIES:
        raise ValueError(f"unknown metric category {category!r}; "
                         f"known: {list(CATEGORIES)}")
    for m in _METRICS:
        if category is None or m.category == category:
            yield m


def declared(kind: str, name: str) -> bool:
    """Is the exact literal ``name`` a declared ``kind`` metric?"""
    m = METRIC_REGISTRY.get(name)
    if m is not None and m.kind == kind:
        return True
    return any(m.dynamic and m.kind == kind and name.startswith(m.name)
               for m in _METRICS)


def declared_prefix(kind: str, leading: str) -> bool:
    """Is an f-string with constant prefix ``leading`` compatible with a
    declared dynamic metric of ``kind``? (The suffix is computed at
    runtime, so the check is prefix-compatibility both ways.)"""
    return any(m.dynamic and m.kind == kind
               and (leading.startswith(m.name)
                    or m.name.startswith(leading))
               for m in _METRICS)


def render_metric_table(category: Optional[str] = None) -> str:
    """The markdown metric table for ``category`` (None = all, with a
    category column). Injected between ``<!-- dk-metric:begin ... -->`` /
    ``<!-- dk-metric:end -->`` markers by ``python -m
    distkeras_tpu_torch.analysis --write-metric-docs``; DK602 reports a
    table in ``distkeras_tpu_torch/docs/`` that no longer matches this
    rendering."""
    rows = list(iter_metrics(category))
    with_cat = category is None
    head = "| Name | Kind | Description |"
    sep = "|---|---|---|"
    if with_cat:
        head = "| Name | Kind | Category | Description |"
        sep = "|---|---|---|---|"
    out = [head, sep]
    for m in rows:
        name = f"`{m.name}*`" if m.dynamic else f"`{m.name}`"
        cells = [name, m.kind]
        if with_cat:
            cells.append(m.category)
        cells.append(m.doc)
        out.append("| " + " | ".join(cells) + " |")
    return "\n".join(out)


def splice_metric_docs(text: str, path_hint: str = "") -> str:
    """Replace every ``<!-- dk-metric:begin [category=X] -->`` ...
    ``<!-- dk-metric:end -->`` block in ``text`` with the freshly
    rendered table for that category."""
    import re

    def sub(m) -> str:
        category = m.group("cat") or None
        return (m.group("open") + "\n" + render_metric_table(category)
                + "\n" + m.group("close"))

    pat = re.compile(
        r"(?P<open><!-- dk-metric:begin(?: category=(?P<cat>[\w-]+))? -->)"
        r".*?(?P<close><!-- dk-metric:end -->)",
        re.DOTALL)
    out, n = pat.subn(sub, text)
    if n == 0 and path_hint:
        raise ValueError(f"no dk-metric marker block found in {path_hint}")
    return out
