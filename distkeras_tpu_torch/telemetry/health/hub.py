"""MetricsHub: the fleet-wide aggregation loop behind the health plane.

One lightweight thread periodically scrapes every registered process —
PS shards, standbys, serving replicas, fleet workers — over the same
membership-free ``stats`` op the ``telemetry scrape`` CLI uses: a raw
socket, no join, no lease, works against a fenced ex-primary or a
mid-warmup replica. Each sweep folds the reply into bounded in-memory
time-series rings:

* telemetry **gauges** → ``(ts, value)`` points;
* telemetry **counters** → derived **rates** (delta / dt between
  consecutive scrapes, reset-safe across process restarts);
* telemetry **spans** → cumulative histogram snapshots, so a windowed
  p99 is the bucket-quantile of the *difference* between the window's
  edges — quantiles over exactly the window, not since-boot;
* scalar reply fields (``commits_total``, ``queue_rows``, ``members``,
  ...) → ``stats.<field>`` gauges (and rates for the cumulative ones).

Scrapes piggyback the PR 14 clock exchange: every request stamps
``ct0`` and the server echoes ``st1``/``st2``, so the hub keeps a
min-RTT NTP-style offset estimate *per target* (the tracing-collector
math, but one estimator per process instead of the module-global one a
worker keeps toward its PS). Ring timestamps stay on the hub's clock —
the one timeline every target shares — and the per-target offsets are
surfaced for drift display and for aligning any server-side timestamps.

A registered target that stops answering flips to ``down`` after
``DKTPU_HEALTH_DOWN_AFTER`` consecutive misses; the sentinel layer turns
that into a typed ``target_down`` alert and ``Job.supervise`` /
``FleetScheduler`` can consult :meth:`MetricsHub.is_down` to restart on
failed liveness instead of waiting for a lease to lapse.

Fleet components self-register via :func:`register_target`; ad-hoc
processes are added with ``DKTPU_HEALTH_TARGETS`` (``[name=]host:port``
entries, ``;``- or ``,``-separated). Both are re-read every sweep, so a
replica that comes up after the hub starts is scraped on the next tick.
"""

from __future__ import annotations

import fnmatch
import socket
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from distkeras_tpu_torch.runtime.config import env_float, env_int, env_str

#: Reply fields (outside the telemetry snapshot) that grow monotonically —
#: the hub derives a rate ring for these on top of the ``stats.<k>`` gauge.
_CUMULATIVE_FIELDS = ("commits_total", "served", "updates", "compiles")

#: Scalar reply fields mirrored into ``stats.<k>`` gauges each sweep.
_SCALAR_FIELDS = _CUMULATIVE_FIELDS + (
    "epoch", "members", "queue_rows", "version", "draining")


def parse_targets(spec: str) -> Dict[str, str]:
    """``[name=]host:port`` entries (``;`` or ``,`` separated) → ``{name:
    endpoint}``. A bare endpoint names itself."""
    out: Dict[str, str] = {}
    for part in spec.replace(",", ";").split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, endpoint = part.split("=", 1)
            out[name.strip()] = endpoint.strip()
        else:
            out[part] = part
    return out


def env_targets() -> Dict[str, str]:
    """Ad-hoc targets from ``DKTPU_HEALTH_TARGETS``."""
    return parse_targets(env_str("DKTPU_HEALTH_TARGETS"))


_registry_lock = threading.Lock()
_registry: Dict[str, str] = {}


def register_target(endpoint: str, name: Optional[str] = None) -> str:
    """Register a scrape target with the in-process hub registry (fleet
    components call this when they bind an endpoint). Returns the name
    under which the target was filed. Idempotent; a re-register with the
    same name just updates the endpoint (restarts move ports)."""
    name = name or endpoint
    with _registry_lock:
        _registry[name] = endpoint
    return name


def unregister_target(name_or_endpoint: str) -> None:
    with _registry_lock:
        if name_or_endpoint in _registry:
            del _registry[name_or_endpoint]
            return
        for k, v in list(_registry.items()):
            if v == name_or_endpoint:
                del _registry[k]


def registered_targets() -> Dict[str, str]:
    with _registry_lock:
        return dict(_registry)


class _OffsetEstimator:
    """Per-target min-RTT clock offset (the tracing ``clock`` math, local
    to one target instead of module-global)."""

    def __init__(self) -> None:
        self.offset = 0.0
        self.rtt = float("inf")
        self.samples = 0

    def observe(self, ct0: float, st1: float, st2: float,
                ct3: float) -> None:
        rtt = (ct3 - ct0) - (st2 - st1)
        self.samples += 1
        if rtt < self.rtt:
            self.rtt = rtt
            self.offset = ((st1 - ct0) + (st2 - ct3)) / 2.0


@dataclass
class TargetState:
    """Everything the hub knows about one scrape target. Rings are
    bounded deques of hub-clock points; ``spans`` entries are cumulative
    ``(ts, count, total, buckets)`` snapshots (window math diffs them)."""

    name: str
    endpoint: str
    role: Optional[str] = None
    ready: Optional[bool] = None
    caps: Optional[dict] = None
    misses: int = 0
    down: bool = False
    ever_up: bool = False
    last_ok: Optional[float] = None
    last_error: Optional[str] = None
    clock_offset_s: Optional[float] = None
    clock_rtt_s: Optional[float] = None
    gauges: Dict[str, deque] = field(default_factory=dict)
    rates: Dict[str, deque] = field(default_factory=dict)
    spans: Dict[str, deque] = field(default_factory=dict)
    _last_counters: Dict[str, Tuple[float, float]] = field(
        default_factory=dict)
    _clock: _OffsetEstimator = field(default_factory=_OffsetEstimator)

    def status(self) -> str:
        if self.down:
            return "DOWN"
        if not self.ever_up:
            return "PENDING"
        if self.ready is False:
            return "NOT-READY"
        return "UP"


class MetricsHub:
    """Bounded time-series store + scrape loop over the fleet's stats op.

    ``interval``/``ring``/``down_after`` default from the
    ``DKTPU_HEALTH_INTERVAL``/``DKTPU_HEALTH_RING``/
    ``DKTPU_HEALTH_DOWN_AFTER`` EnvVars; explicit ctor targets are merged
    with the in-process registry and ``DKTPU_HEALTH_TARGETS`` on every
    sweep.
    """

    def __init__(self, targets: Optional[Dict[str, str]] = None,
                 interval: Optional[float] = None,
                 ring: Optional[int] = None,
                 down_after: Optional[int] = None,
                 timeout: float = 1.0,
                 use_registry: bool = True,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self._static = dict(targets or {})
        #: the hub's timeline. Injectable so the simulator
        #: (``distkeras_tpu_torch.sim``) can run the real windowed-measure /
        #: burn-rate math on a virtual clock; None = wall clock.
        self._clock: Callable[[], float] = clock or time.time
        self.interval = (env_float("DKTPU_HEALTH_INTERVAL")
                         if interval is None else float(interval))
        self.ring = max(2, env_int("DKTPU_HEALTH_RING")
                        if ring is None else int(ring))
        self.down_after = max(1, env_int("DKTPU_HEALTH_DOWN_AFTER")
                              if down_after is None else int(down_after))
        self.timeout = float(timeout)
        self.use_registry = use_registry
        self._lock = threading.Lock()
        self._targets: Dict[str, TargetState] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._on_sweep: List[Callable[["MetricsHub"], None]] = []
        self.sweeps = 0
        #: cumulative histogram state behind :meth:`feed`'s span kind,
        #: keyed (target, metric).
        self._fed_spans: Dict[Tuple[str, str], list] = {}

    # -- target management -------------------------------------------------

    def _known_targets(self) -> Dict[str, str]:
        merged = dict(self._static)
        if self.use_registry:
            merged.update(registered_targets())
            merged.update(env_targets())
        return merged

    def add_target(self, endpoint: str, name: Optional[str] = None) -> str:
        name = name or endpoint
        self._static[name] = endpoint
        return name

    def remove_target(self, name: str) -> None:
        self._static.pop(name, None)
        with self._lock:
            self._targets.pop(name, None)

    def targets(self) -> List[TargetState]:
        with self._lock:
            return list(self._targets.values())

    def target(self, name: str) -> Optional[TargetState]:
        with self._lock:
            return self._targets.get(name)

    def is_down(self, name_or_endpoint: str) -> bool:
        """Liveness answer for supervisors: True only for a target that
        was scraped successfully at least once and has now missed
        ``down_after`` consecutive sweeps (a target we never reached is
        PENDING, not down — don't shoot a process that is still
        binding its socket)."""
        with self._lock:
            for t in self._targets.values():
                if name_or_endpoint in (t.name, t.endpoint):
                    return t.down and t.ever_up
        return False

    def down_targets(self) -> List[TargetState]:
        return [t for t in self.targets() if t.down and t.ever_up]

    def on_sweep(self, fn: Callable[["MetricsHub"], None]) -> None:
        """Run ``fn(hub)`` after every sweep (SLO engine / sentinels hook
        in here so evaluation happens on fresh data, on the hub thread)."""
        self._on_sweep.append(fn)

    # -- scraping ----------------------------------------------------------

    def _scrape(self, endpoint: str) -> Tuple[dict, float, float]:
        from distkeras_tpu_torch.netps import wire

        host, port = wire.split_endpoint(endpoint)
        ct0 = time.time()
        with socket.create_connection((host, port),
                                      timeout=self.timeout) as sock:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(self.timeout)
            wire.send_frame(sock, wire.KIND_REQUEST,
                            {"op": wire.OP_STATS, "req": 0, "ring": 0,
                             "ct0": ct0}, [])
            while True:
                kind, rhdr, _arrays = wire.read_frame(sock)
                if kind == wire.KIND_REPLY and rhdr.get("req") == 0:
                    return rhdr, ct0, time.time()

    def scrape_once(self) -> int:
        """One sweep over every known target. Returns how many answered."""
        known = self._known_targets()
        ok = 0
        for name, endpoint in known.items():
            with self._lock:
                t = self._targets.get(name)
                if t is None or t.endpoint != endpoint:
                    t = TargetState(name=name, endpoint=endpoint)
                    self._targets[name] = t
            try:
                reply, ct0, ct3 = self._scrape(endpoint)
            except (OSError, socket.timeout) as exc:
                with self._lock:
                    t.misses += 1
                    t.last_error = f"{type(exc).__name__}: {exc}"
                    if t.misses >= self.down_after:
                        t.down = True
                continue
            with self._lock:
                self._ingest(t, reply, ct0, ct3)
            ok += 1
        # Drop state for targets no longer known anywhere (unregistered).
        with self._lock:
            for name in list(self._targets):
                if name not in known:
                    del self._targets[name]
        self.sweeps += 1
        for fn in list(self._on_sweep):
            fn(self)
        return ok

    def _ring(self, store: Dict[str, deque], name: str) -> deque:
        ring = store.get(name)
        if ring is None:
            ring = store[name] = deque(maxlen=self.ring)
        return ring

    def _ingest(self, t: TargetState, reply: dict, ct0: float,
                ct3: float) -> None:
        now = (ct0 + ct3) / 2.0  # hub clock; midpoint kills send/recv skew
        t.misses = 0
        t.down = False
        t.ever_up = True
        t.last_ok = now
        t.last_error = None
        t.role = reply.get("role", t.role)
        if "ready" in reply:
            t.ready = bool(reply["ready"])
        if reply.get("caps") is not None:
            t.caps = reply.get("caps")
        st1, st2 = reply.get("st1"), reply.get("st2")
        if st1 is not None and st2 is not None:
            t._clock.observe(ct0, st1, st2, ct3)
            t.clock_offset_s = t._clock.offset
            t.clock_rtt_s = t._clock.rtt
        for k in _SCALAR_FIELDS:
            v = reply.get(k)
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, (int, float)):
                self._ring(t.gauges, f"stats.{k}").append((now, float(v)))
                if k in _CUMULATIVE_FIELDS:
                    self._rate_point(t, f"stats.{k}", now, float(v))
        snapshot = reply.get("snapshot") or {}
        for name, v in (snapshot.get("counters") or {}).items():
            self._rate_point(t, name, now, float(v))
        for name, g in (snapshot.get("gauges") or {}).items():
            value = g.get("value") if isinstance(g, dict) else g
            if isinstance(value, (int, float)):
                self._ring(t.gauges, name).append((now, float(value)))
        for name, h in (snapshot.get("spans") or {}).items():
            if not isinstance(h, dict):
                continue
            self._ring(t.spans, name).append(
                (now, int(h.get("count", 0)), float(h.get("total", 0.0)),
                 tuple(h.get("buckets", ()))))

    def _rate_point(self, t: TargetState, name: str, now: float,
                    cum: float) -> None:
        last = t._last_counters.get(name)
        t._last_counters[name] = (now, cum)
        if last is None:
            return
        ts0, c0 = last
        dt = now - ts0
        if dt <= 0:
            return
        if cum < c0:  # process restarted: counter reset — re-base, no point
            return
        self._ring(t.rates, name).append((now, (cum - c0) / dt))

    # -- the metric-feed seam ----------------------------------------------

    def _feed_target(self, name: str, role: Optional[str]) -> TargetState:
        """Lock held. Fed targets join ``_static`` so a stray
        ``scrape_once`` does not garbage-collect their rings."""
        t = self._targets.get(name)
        if t is None:
            t = TargetState(name=name, endpoint=name)
            self._targets[name] = t
            self._static.setdefault(name, name)
        if role is not None:
            t.role = role
        return t

    def feed(self, target: str, metric: str, value: float, *,
             kind: str = "gauge", ts: Optional[float] = None,
             role: Optional[str] = None) -> None:
        """Inject one synthesized observation as if a scrape returned it
        — the seam the fleet simulator (and any replay tool) uses to run
        the REAL ring/window/burn-rate/hysteresis machinery against
        series that never crossed a socket. The point is stamped by the
        hub's own clock (``clock=``) unless ``ts`` is given.

        ``kind``: ``"gauge"`` appends a point; ``"counter"`` takes the
        cumulative total and derives the same reset-safe rate a scrape
        would; ``"span"`` takes one duration sample and accumulates it
        into a cumulative histogram snapshot (so windowed p99s diff
        exactly like scraped ones). A fed point also counts as liveness:
        misses reset, ``ever_up`` latches — pair with :meth:`feed_miss`
        to simulate a target going dark."""
        ts = self._clock() if ts is None else float(ts)
        with self._lock:
            t = self._feed_target(target, role)
            t.misses = 0
            t.down = False
            t.ever_up = True
            t.last_ok = ts
            t.last_error = None
            if kind == "gauge":
                self._ring(t.gauges, metric).append((ts, float(value)))
            elif kind == "counter":
                self._rate_point(t, metric, ts, float(value))
            elif kind == "span":
                self._feed_span(t, metric, ts, float(value))
            else:
                raise ValueError(
                    f"feed kind must be gauge/counter/span, got {kind!r}")

    def feed_miss(self, target: str, role: Optional[str] = None) -> None:
        """The feed-side mirror of a failed scrape: one more consecutive
        miss; ``down`` flips after ``down_after`` of them (real
        :meth:`is_down` semantics — a never-up target stays PENDING)."""
        with self._lock:
            t = self._feed_target(target, role)
            t.misses += 1
            t.last_error = "fed miss"
            if t.misses >= self.down_after:
                t.down = True

    def _feed_span(self, t: TargetState, metric: str, ts: float,
                   dur_s: float) -> None:
        """Accumulate one duration sample into the target's cumulative
        histogram for ``metric`` (same bucket walk as
        ``telemetry.core``) and snapshot it into the span ring."""
        import bisect

        from distkeras_tpu_torch.telemetry.core import BUCKET_BOUNDS

        key = (t.name, metric)
        count, total, buckets = self._fed_spans.setdefault(
            key, [0, 0.0, [0] * (len(BUCKET_BOUNDS) + 1)])
        count += 1
        total += dur_s
        buckets[bisect.bisect_left(BUCKET_BOUNDS, dur_s)] += 1
        self._fed_spans[key] = [count, total, buckets]
        self._ring(t.spans, metric).append(
            (ts, count, total, tuple(buckets)))

    # -- the loop ----------------------------------------------------------

    def start(self) -> "MetricsHub":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="dktpu-health-hub", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:  # a sweep must never kill the hub
                pass
            self._stop.wait(self.interval)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "MetricsHub":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- windowed measurement ----------------------------------------------

    def _matching(self, target_glob: Optional[str]) -> List[TargetState]:
        """Lock held by the caller (``measure``) — reads ``_targets``
        directly; ``self._lock`` is not reentrant."""
        out = []
        for t in self._targets.values():
            if target_glob is None or fnmatch.fnmatch(
                    t.name, target_glob) or (
                    t.role and fnmatch.fnmatch(t.role, target_glob)):
                out.append(t)
        return out

    @staticmethod
    def _window_points(ring: deque, lo: float) -> List[float]:
        return [v for ts, v in ring if ts >= lo]

    @staticmethod
    def _span_window(ring: deque, lo: float):
        """Cumulative-histogram diff across the window: (count, total,
        buckets) accrued since the last snapshot at-or-before ``lo``."""
        base = None
        head = None
        for entry in ring:
            if entry[0] < lo:
                base = entry
            else:
                head = entry
        if head is None:
            return None
        _, c1, tot1, b1 = head
        if base is None:
            return c1, tot1, list(b1)
        _, c0, tot0, b0 = base
        buckets = [max(0, a - b) for a, b in
                   zip(b1, list(b0) + [0] * (len(b1) - len(b0)))]
        return max(0, c1 - c0), max(0.0, tot1 - tot0), buckets

    def measure(self, metric: str, stat: str = "value",
                window_s: float = 60.0,
                target: Optional[str] = None) -> Optional[float]:
        """One number for ``metric`` over the trailing window, aggregated
        across matching targets. ``metric`` may be a glob (label-suffixed
        families like ``fleet.examples_per_sec.tenantA.*`` aggregate).

        stats: ``value`` (latest gauge), ``mean`` (gauge mean), ``max``,
        ``rate`` (summed counter rates), ``p50``/``p90``/``p99`` (bucket
        quantile of the windowed span diff, merged across targets),
        ``span_mean`` (windowed mean span duration). None when no data
        landed in the window — absence of evidence is not a breach.
        """
        lo = self._clock() - window_s
        if stat == "rate":
            per_target = []
            with self._lock:
                for t in self._matching(target):
                    vals: List[float] = []
                    for name, ring in t.rates.items():
                        if fnmatch.fnmatch(name, metric):
                            vals.extend(self._window_points(ring, lo))
                    if vals:
                        per_target.append(sum(vals) / len(vals))
            return sum(per_target) if per_target else None
        if stat in ("value", "mean", "max"):
            vals = []
            with self._lock:
                for t in self._matching(target):
                    for name, ring in t.gauges.items():
                        if not fnmatch.fnmatch(name, metric):
                            continue
                        pts = self._window_points(ring, lo)
                        if not pts:
                            continue
                        if stat == "value":
                            vals.append(pts[-1])
                        elif stat == "max":
                            vals.append(max(pts))
                        else:
                            vals.append(sum(pts) / len(pts))
            if not vals:
                return None
            return max(vals) if stat == "max" else sum(vals) / len(vals)
        # span stats: merge windowed histogram diffs across targets
        count = 0
        total = 0.0
        buckets: List[int] = []
        with self._lock:
            for t in self._matching(target):
                for name, ring in t.spans.items():
                    if not fnmatch.fnmatch(name, metric):
                        continue
                    diff = self._span_window(ring, lo)
                    if diff is None:
                        continue
                    c, tot, b = diff
                    count += c
                    total += tot
                    if len(b) > len(buckets):
                        buckets.extend([0] * (len(b) - len(buckets)))
                    for i, x in enumerate(b):
                        buckets[i] += x
        if not count:
            return None
        if stat == "span_mean":
            return total / count
        if stat.startswith("p"):
            q = float(stat[1:]) / (100.0 if len(stat) <= 3 else 1000.0)
            return _bucket_quantile(buckets, count, q)
        return None

    def metric_names(self) -> Dict[str, List[str]]:
        """Every metric the hub has seen, by kind (CLI discovery aid)."""
        g, r, s = set(), set(), set()
        with self._lock:
            for t in self._targets.values():
                g.update(t.gauges)
                r.update(t.rates)
                s.update(t.spans)
        return {"gauges": sorted(g), "rates": sorted(r), "spans": sorted(s)}


def _bucket_quantile(buckets: List[int], count: int, q: float) -> float:
    """Same walk as ``report._hist_quantile`` over a windowed diff."""
    from distkeras_tpu_torch.telemetry.core import BUCKET_BOUNDS

    def bound(i: int) -> float:
        return BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS) else BUCKET_BOUNDS[-1]

    target = q * count
    seen = 0
    top = 0.0
    for i, c in enumerate(buckets):
        if c:
            top = bound(i)
        seen += c
        if seen >= target and c:
            return bound(i)
    return top
