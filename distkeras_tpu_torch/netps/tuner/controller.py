"""The online controller: gauges in, knob retunes out, guardrails always
(the port's copy of the JAX package's ``netps/tuner/controller.py``).

One :class:`Tuner` is shared by a run's worker threads. Worker 0 drives
the control loop (:meth:`Tuner.startup` at join, :meth:`Tuner.
maybe_decide` at round boundaries); every worker applies the current
target dialect through :meth:`Tuner.apply_to`, which routes the change
through the existing renegotiation paths (:meth:`~distkeras_tpu_torch.netps.
client.PSClient.retune` + ``adopt_dialect``) — never a new wire surface,
so every exactly-once/fencing guarantee holds unchanged under a mid-run
retune.

Hysteresis and guardrails, in order of authority:

* **Floors are never violated.** Every target is clamped to its floor
  (inflight/shards >= 1, codec within the peer's advertised set) before
  it is published; a proposal that WOULD have crossed a floor counts in
  ``tuner.floor_violations`` (asserted zero by the chaos smoke) and is
  dropped.
* **Bounded retune rate.** One evaluation per ``DKTPU_TUNE_INTERVAL``
  rounds, one retune per knob per ``DKTPU_TUNE_COOLDOWN`` rounds, and at
  most ``DKTPU_TUNE_MAX_RETUNES`` mid-run retunes total — after which
  the controller holds whatever it converged to.
* **Oscillation falls back to static.** A knob that flips back to its
  previous value ``DKTPU_TUNE_OSC_LIMIT`` times in a row is frozen at
  its initial (static) value for the rest of the run
  (``tuner.oscillation_fallbacks`` + a ``tuner_fallback`` event).
* **Failover defers, never loses.** :meth:`apply_to` refuses to touch a
  client whose endpoint walker moved since the last check — the rejoin
  renegotiates the dialect anyway — and the undelivered generation is
  retried at the next round (``tuner.deferred``).

The JAX package wraps :meth:`Tuner.apply_to`'s retune in a
``tuner.retune`` trace scope; the port has no tracing yet (ROADMAP item
10), so the retune is counted and logged but not traced.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.netps.tuner.probe import best_codec, probe_codecs
from distkeras_tpu_torch.runtime import config

#: codec -> numeric gauge value (``tuner.knob.codec``): report-friendly
#: ordering by wire size (none > bf16 > int8).
_CODEC_GAUGE = {wire.CODEC_NONE: 0.0, wire.CODEC_BF16: 1.0,
                wire.CODEC_INT8: 2.0}


def autotune_enabled() -> bool:
    """The master switch (``DKTPU_NET_AUTOTUNE``), off by default."""
    return config.env_bool("DKTPU_NET_AUTOTUNE")


def recommended_topology(num_workers: int,
                         crossover: Optional[int] = None) -> str:
    """``"hier"`` at/above the measured fan-in crossover
    (``DKTPU_TUNE_HIER_FANIN``), ``"flat"`` below it — the bench
    ``hier_curve``'s break-even, as a one-liner the controller and the
    bench both consult."""
    if crossover is None:
        crossover = config.env_int("DKTPU_TUNE_HIER_FANIN")
    return "hier" if int(num_workers) >= int(crossover) else "flat"


class TunerConfig(NamedTuple):
    """The controller's knobs-about-knobs (the ``DKTPU_TUNE_*`` variables
    of ``runtime/config.py`` — see :meth:`from_env`)."""

    interval: int
    cooldown: int
    probes: int
    max_retunes: int
    osc_limit: int
    hier_fanin: int
    min_gain: float
    hidden_floor: float
    stale_ceiling: float
    max_inflight: int = 4
    max_shards: int = 2

    @classmethod
    def from_env(cls) -> "TunerConfig":
        return cls(
            interval=max(1, config.env_int("DKTPU_TUNE_INTERVAL")),
            cooldown=max(1, config.env_int("DKTPU_TUNE_COOLDOWN")),
            probes=max(1, config.env_int("DKTPU_TUNE_PROBES")),
            max_retunes=max(0, config.env_int("DKTPU_TUNE_MAX_RETUNES")),
            osc_limit=max(1, config.env_int("DKTPU_TUNE_OSC_LIMIT")),
            hier_fanin=max(1, config.env_int("DKTPU_TUNE_HIER_FANIN")),
            min_gain=float(config.env_float("DKTPU_TUNE_MIN_GAIN")),
            hidden_floor=float(config.env_float("DKTPU_TUNE_HIDDEN_FLOOR")),
            stale_ceiling=float(config.env_float("DKTPU_TUNE_STALE_CEIL")),
        )


class Decision(NamedTuple):
    """One retune the controller took: which knob, from what to what, the
    gauge (or rule) that triggered it, and the round it landed in."""

    knob: str
    old: object
    new: object
    trigger: str
    round: int


class TunerState:
    """Per-worker apply-side cursor: the last target generation this
    worker's client adopted, and the endpoint-walk count seen at that
    adoption (the failover-deferral witness)."""

    __slots__ = ("generation", "walks")

    def __init__(self):
        self.generation = 0
        self.walks = 0


class Tuner:
    """One run's adaptive controller (see module docstring). ``inflight``
    is read directly by the worker loop every round (plain int read —
    safe under the GIL); codec/shards targets travel through the
    generation counter + :meth:`apply_to`."""

    def __init__(self, num_workers: int, inflight: int = 1,
                 cfg: Optional[TunerConfig] = None):
        self.cfg = cfg if cfg is not None else TunerConfig.from_env()
        self.num_workers = int(num_workers)
        self._lock = threading.Lock()
        #: bumped on every published target change; workers adopt via
        #: :meth:`apply_to` when their seen generation lags.
        self.generation = 0
        #: the overlap window target, clamped to [1, cfg.max_inflight].
        self.inflight = max(1, min(int(inflight), self.cfg.max_inflight))
        #: codec / striping targets; None = leave whatever the join
        #: negotiated (nothing published yet).
        self.codec: Optional[str] = None
        self.shards: Optional[int] = None
        #: the static values the run started with — the oscillation
        #: fallback restores these.
        self._initial: dict = {"inflight": self.inflight}
        #: first control-loop eval lands at r == interval, not r == 0: the
        #: gauges need a measured window before they are evidence (round
        #: 0's "overlap" is one blocking pull — always unhidden, always
        #: junk); the cold start is the probes' job, not the loop's.
        self._last_eval = 0
        #: connections the applying clients actually hold (set at
        #: startup); a shards-up proposal beyond it would be clamped at
        #: apply time into a phantom decision, so the loop never makes it.
        self.stripe_ceiling = 1
        self._last_retune: dict = {}
        self._prev_value: dict = {}
        self._flips: dict = {}
        self._frozen: set = set()
        self._agg = None
        self.decisions: list = []
        self.retunes = 0
        self.fallbacks = 0
        self.deferred = 0
        self.peer_codecs: tuple = wire.CODECS

    # -- startup: topology + join-time probes ---------------------------
    def choose_topology(self) -> str:
        """The start-of-run HIER decision, by the measured fan-in
        crossover (recorded as a decision like any retune)."""
        topo = recommended_topology(self.num_workers, self.cfg.hier_fanin)
        self._record(Decision("topology", None, topo,
                              "fan_in_crossover", -1), publish=False)
        return topo

    def attach_aggregator(self, agg) -> None:
        """Hand the controller the run's AggregatorServer so the control
        loop can retune its flush fan-in mid-run."""
        with self._lock:
            self._agg = agg

    def startup(self, client, template: Sequence) -> None:
        """The join-time micro A/B (worker 0, once): probe the candidate
        codecs over the actual negotiated connection and publish the
        winner — except on the shm ring, where the measured rule is
        unconditional (f32 over one ring wins; the codec is a TCP
        lever)."""
        with self._lock:
            self._initial.setdefault("codec", client.codec)
            self._initial.setdefault("shards", client.active_shards)
            self.peer_codecs = tuple(
                (client.peer_caps or {}).get("codecs", ()))
            self.stripe_ceiling = len(getattr(client, "_conns", ()) or (1,))
        if client.active_transport in ("shm", "mesh"):
            # The ring's measured rule, applied rather than re-measured:
            # quantize passes cost more than the bytes they save at memcpy
            # speed, and a ring per stripe pays a doorbell per stripe. The
            # mesh dispatch is the limit case (zero wire bytes), so the
            # same rule applies a fortiori (its own trigger name, so the
            # decision log tells the dialects apart).
            rule = ("mesh_rule" if client.active_transport == "mesh"
                    else "shm_ring_rule")
            self.propose("codec", client.codec, wire.CODEC_NONE, rule, 0)
            self.propose("shards", client.active_shards, 1, rule, 0)
            return
        results = probe_codecs(client, template, probes=self.cfg.probes)
        winner = best_codec(results)
        if winner is not None and winner != client.codec:
            self.propose("codec", client.codec, winner, "probe", 0)

    # -- the control loop (worker 0, round boundaries) -------------------
    def maybe_decide(self, r: int, active_transport: str = "tcp") -> bool:
        """One control-loop evaluation, rate-limited to every
        ``cfg.interval`` rounds. Reads the live gauges and proposes at
        most one retune per knob; returns whether anything was
        published."""
        with self._lock:
            if r - self._last_eval < self.cfg.interval:
                return False
            self._last_eval = r
        tele = telemetry.get()

        def gauge(name):
            g = tele.gauge(name)
            return g.value if g.snapshot().get("count") else None

        hidden = gauge("netps.overlap.hidden_fraction")
        stale = gauge("discipline.staleness_mean")
        before = self.retunes + self.fallbacks
        # Overlap window: comms the compute loop still SEES means the
        # window is too small — widen it while staleness stays healthy;
        # staleness past the ceiling means the window outran the center —
        # narrow it (DynSGD-style pressure relief, but on the knob).
        if (hidden is not None and hidden < self.cfg.hidden_floor
                and (stale is None or stale <= self.cfg.stale_ceiling)
                and self.inflight < self.cfg.max_inflight):
            self.propose("inflight", self.inflight, self.inflight + 1,
                         "netps.overlap.hidden_fraction", r)
        elif (stale is not None and stale > self.cfg.stale_ceiling
                and self.inflight > 1):
            self.propose("inflight", self.inflight, self.inflight - 1,
                         "discipline.staleness_mean", r)
        # Codec: on the ring the rule is unconditional; on TCP, unhidden
        # comms with an f32 wire means bytes are the bottleneck — shrink
        # them (the probe usually already decided this at join).
        cur_codec = self.codec
        rule = "mesh_rule" if active_transport == "mesh" else "shm_ring_rule"
        if active_transport in ("shm", "mesh"):
            if cur_codec not in (None, wire.CODEC_NONE):
                self.propose("codec", cur_codec, wire.CODEC_NONE, rule, r)
        elif (cur_codec == wire.CODEC_NONE and hidden is not None
                and hidden < self.cfg.hidden_floor
                and wire.CODEC_INT8 in self.peer_codecs):
            self.propose("codec", cur_codec, wire.CODEC_INT8,
                         "netps.overlap.hidden_fraction", r)
        # Striping: concurrent stripe RPCs only help where the wire is
        # the serial resource (TCP); on the ring one stripe wins.
        cur_shards = self.shards
        if active_transport in ("shm", "mesh"):
            if cur_shards is not None and cur_shards > 1:
                self.propose("shards", cur_shards, 1, rule, r)
        elif (cur_shards in (None, 1) and hidden is not None
                and hidden < self.cfg.hidden_floor
                and min(self.cfg.max_shards, self.stripe_ceiling) > 1):
            self.propose("shards", cur_shards or 1,
                         min(2, self.cfg.max_shards, self.stripe_ceiling),
                         "netps.overlap.hidden_fraction", r)
        # Hierarchical combining: below the crossover the aggregator's
        # accumulation window buys nothing — flush per commit (a
        # pass-through forwarder); at/above it, combine the full fan-in.
        agg = self._agg
        if agg is not None:
            fan = gauge("netps.hier.fan_in")
            if fan is not None:
                want = None if fan >= self.cfg.hier_fanin else 1
                if agg.fan_in != want:
                    self.propose("hier_fan_in", agg.fan_in, want,
                                 "netps.hier.fan_in", r, apply=lambda:
                                 agg.set_fan_in(want))
        return (self.retunes + self.fallbacks) > before

    # -- proposals: hysteresis, floors, oscillation ----------------------
    def propose(self, knob: str, old, new, trigger: str, r: int,
                apply=None) -> bool:
        """One retune proposal through every guardrail; publishes (bumps
        the generation) and returns True only if it survives. ``apply``
        is an optional side-effecting closure for knobs that do not
        travel through the client dialect (the aggregator fan-in)."""
        with self._lock:
            if new == old or knob in self._frozen:
                return False
            if knob != "topology" and self.retunes >= self.cfg.max_retunes:
                return False
            last = self._last_retune.get(knob)
            if last is not None and r - last < self.cfg.cooldown:
                return False
            if not self._floor_ok_locked(knob, new):
                self.retunes += 1  # a dropped proposal still spends budget
                telemetry.counter("tuner.floor_violations").add(1)
                return False
            # Oscillation: flipping back to the previous value counts a
            # flip; enough consecutive flips freezes the knob at its
            # static initial value for the rest of the run.
            if self._prev_value.get(knob) == new:
                self._flips[knob] = self._flips.get(knob, 0) + 1
            else:
                self._flips[knob] = 0
            if self._flips[knob] >= self.cfg.osc_limit:
                self._frozen.add(knob)
                self.fallbacks += 1
                fallback = self._initial.get(knob, old)
                self._publish_locked(knob, fallback)
                telemetry.counter("tuner.oscillation_fallbacks").add(1)
                telemetry.event("tuner_fallback", {
                    "knob": knob, "restored": fallback, "round": r,
                    "reason": f"oscillated {self._flips[knob]}x"})
                return True
            self._prev_value[knob] = old
            self._last_retune[knob] = r
            self.retunes += 1
            self._publish_locked(knob, new)
        if apply is not None:
            apply()
        self._record(Decision(knob, old, new, trigger, r), publish=False)
        return True

    def _floor_ok_locked(self, knob: str, new) -> bool:
        if knob == "inflight":
            return 1 <= int(new) <= self.cfg.max_inflight
        if knob == "shards":
            return 1 <= int(new) <= self.cfg.max_shards
        if knob == "codec":
            return new == wire.CODEC_NONE or new in self.peer_codecs
        return True

    def _publish_locked(self, knob: str, value) -> None:
        if knob == "inflight":
            self.inflight = int(value)
        elif knob == "codec":
            self.codec = value
        elif knob == "shards":
            self.shards = int(value)
        if knob in ("codec", "shards"):
            self.generation += 1

    def _record(self, d: Decision, publish: bool) -> None:
        with self._lock:
            self.decisions.append(d)
            if publish:
                self._publish_locked(d.knob, d.new)
        telemetry.counter("tuner.decisions").add(1)
        telemetry.counter(f"tuner.decision.{d.knob}").add(1)
        telemetry.event("tuner_decision", {
            "knob": d.knob, "from": d.old, "to": d.new,
            "trigger": d.trigger, "round": d.round})
        gauge_val = (_CODEC_GAUGE.get(d.new) if d.knob == "codec"
                     else d.new if isinstance(d.new, (int, float))
                     else None)
        if gauge_val is not None:
            telemetry.gauge(f"tuner.knob.{d.knob}").set(float(gauge_val))

    # -- the apply side (every worker) -----------------------------------
    def apply_to(self, client, template: Sequence,
                 state: TunerState) -> Optional[dict]:
        """Adopt the current target dialect onto one worker's client.
        Returns the change dict from :meth:`PSClient.retune` when a new
        generation was applied, None when there was nothing to do — or
        when the adoption was DEFERRED because a failover walk moved the
        client's endpoint since the last check (the rejoin renegotiates
        the dialect; the unseen generation is retried next round, never
        lost). The caller must have quiesced its in-flight commits first
        (remote.py drains its ordered lane before calling)."""
        with self._lock:
            gen, codec, shards = self.generation, self.codec, self.shards
        if gen == state.generation:
            return None
        walks = getattr(client, "walk_count", 0)
        if walks != state.walks:
            state.walks = walks
            with self._lock:
                self.deferred += 1
            telemetry.counter("tuner.deferred").add(1)
            return None
        changed = client.retune(codec=codec, shards=shards,
                                template=template)
        state.generation = gen
        return changed

    # -- end-of-run summary ----------------------------------------------
    def export_summary(self, client=None) -> dict:
        """The converged dialect + decision counts, as gauges and one
        ``tuner_run_summary`` event (what the bench's auto arm reads)."""
        with self._lock:
            summary = {
                "inflight": self.inflight,
                "codec": self.codec,
                "shards": self.shards,
                "decisions": len(self.decisions),
                "retunes": self.retunes,
                "fallbacks": self.fallbacks,
                "deferred": self.deferred,
            }
        if client is not None:
            summary["codec"] = client.codec
            summary["shards"] = client.active_shards
            summary["transport"] = client.active_transport
        telemetry.gauge("tuner.knob.inflight").set(float(summary["inflight"]))
        if summary["codec"] is not None:
            telemetry.gauge("tuner.knob.codec").set(
                float(_CODEC_GAUGE.get(summary["codec"], -1.0)))
        if summary["shards"] is not None:
            telemetry.gauge("tuner.knob.shards").set(float(summary["shards"]))
        telemetry.event("tuner_run_summary", dict(summary))
        return summary

