"""Closed-loop SLO engine: error budgets, burn rates, health verdicts.

Counterpart of ``repro/obs/slo.py``, the same code over the port's
registry (whose histogram bucket edges are the reference's, so a
latency ledger counts the same requests late). The metrics, quality
series and flight events say what happened; this module is the
decision layer: declarative per-endpoint ``SloSpec``s,
rolling multi-window error-budget accounting, Google-SRE-style
multi-window multi-burn-rate alerting, and a machine-readable
``health()`` verdict — the admission-control input the ROADMAP's async
serving tier consumes.

Health here is inherently two-dimensional. The paper's claim is that a
few coded bits preserve similarity, so a served index can fail on
*latency* (the classic SLO) or on *estimation quality* (recall/margin
drift that every latency gauge is blind to). An ``SloSpec`` therefore
names up to three objectives over one endpoint:

* **latency** — fraction of requests finishing within
  ``latency_target_s`` (the serving layer passes ``cfg.deadline_s``).
  Lateness counts are derived from the *existing* registry histogram's
  bucket counts (everything in buckets above the target's bucket is
  late) — no per-request state, no stored samples; resolution is one
  histogram bucket (~19% with the default spec).
* **availability** — fraction of requests that did not raise, from the
  endpoint's error counter against the same histogram's total.
* **quality** — fraction of quality observations (shadow recall from
  ``obs.shadow``, canary-probe verdicts from ``obs.probe``) at or above
  ``quality_min``. These are *push* events (``observe_quality`` /
  ``observe_probe``) because quality truth only exists when a sampled
  shadow check or probe ran.

Error budgets follow the SRE book: an objective of 0.99 grants a 1%
budget of bad events; the **burn rate** over a window is
``bad_fraction / (1 - objective)`` — 1.0 consumes exactly the budget
over that window, 14.4 exhausts a 30-day budget in 2 days. Windowed
fractions come from a ring of periodic cumulative-counter snapshots
(one ``(t, total, bad)`` tuple per ``resolution`` seconds, O(window /
resolution) memory — the "sliding counters, no stored samples"
invariant). An alert fires only when BOTH windows of a ``BurnPolicy``
pair exceed its threshold — the long window supplies significance, the
short window confirms the problem is still happening (so a fixed
regression stops paging without waiting out the long window).

Alert callbacks use the ``DriftMonitor`` contract ``callback(series,
value, detector)`` with ``series = "slo.<ledger>"`` and a detector-like
``AlertState`` (``side``/``alarms``/``stat``) — so the serving layer's
existing drift wiring (flag the in-flight trace, dump an
``IncidentManager`` bundle) works on SLO alarms unchanged.

``health()`` returns the machine verdict: overall ``status`` ("ok" |
"degraded"), the active alert series, per-ledger burn rates and budget
remaining, and an advisory ``shed_fraction`` (how much traffic
admission control would need to reject for the worst fast-window burn
to drop back to its threshold) — deliberately shaped as the input for
the upcoming async admission controller.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass

from repro_torch.obs.registry import MetricsRegistry, default_registry

__all__ = ["SloSpec", "BurnPolicy", "AlertState", "SloEngine",
           "DEFAULT_POLICIES"]


@dataclass(frozen=True)
class BurnPolicy:
    """One multi-window burn-rate alert rule: fire when the budget burn
    rate exceeds ``threshold`` over BOTH the ``long_s`` and ``short_s``
    windows (SRE book ch. 5: the long window is significance, the short
    window is "still happening"). ``min_events`` additionally requires
    that many events inside the long window — two bad requests during a
    cold start must not page."""
    long_s: float = 60.0
    short_s: float = 5.0
    threshold: float = 14.4
    severity: str = "page"
    min_events: int = 20


#: default pair: a fast page (budget gone in ~4% of the long horizon)
#: and a slow ticket (sustained 6x burn). Horizons are scaled to an
#: in-process server's lifetime, not a 30-day fleet — override per
#: deployment.
DEFAULT_POLICIES = (BurnPolicy(60.0, 5.0, 14.4, "page"),
                    BurnPolicy(600.0, 60.0, 6.0, "ticket"))


@dataclass(frozen=True)
class SloSpec:
    """Declarative objectives for one endpoint (see module docstring).

    ``latency_hist`` / ``error_counter`` name *existing* registry
    metrics (the serving layer's ``serve.flush_s`` etc.) — the spec
    never creates its own per-request instrumentation. Empty names
    disable that dimension. ``quality_min`` is the floor under which a
    quality observation (shadow recall, probe verdict) counts against
    the quality budget; NaN disables the dimension until the first
    ``observe_quality`` call with an explicit floor.
    """
    name: str                            # "search", "classify", ...
    latency_hist: str = ""               # registry histogram of request s
    latency_target_s: float = 0.050      # objective threshold (deadline)
    latency_objective: float = 0.99      # fraction within target
    error_counter: str = ""              # registry counter of errors
    availability_objective: float = 0.999
    quality_min: float = math.nan        # floor for quality observations
    quality_objective: float = 0.95      # fraction of obs >= floor


class AlertState:
    """Detector-shaped state of one ledger's burn alert (the object
    passed as ``detector`` to subscribed callbacks — same attribute
    surface as ``obs.drift``'s detectors: ``side``/``alarms``/``stat``).
    """

    __slots__ = ("series", "active", "alarms", "side", "stat", "policy",
                 "since")

    def __init__(self, series: str):
        self.series = series
        self.active = False
        self.alarms = 0          # rising edges so far
        self.side = ""           # always "up" once fired (budget burn)
        self.stat = 0.0          # worst burn/threshold ratio last eval
        self.policy = None       # the BurnPolicy that fired
        self.since = math.nan    # clock time the alert went active


class _Ledger:
    """One error-budget stream: cumulative (total, bad) counters plus a
    ring of timestamped snapshots for windowed rates.

    Pull ledgers (latency/availability) read their cumulative totals
    from the registry at tick time; push ledgers (quality/probe/
    recompile) accumulate via ``push``. Memory is O(max_window /
    resolution) snapshot tuples — never samples.
    """

    __slots__ = ("name", "objective", "pull", "total", "bad", "ring",
                 "spark", "alert")

    def __init__(self, name: str, objective: float, pull=None,
                 spark_len: int = 64):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0,1), got {objective}")
        self.name = name
        self.objective = float(objective)
        self.pull = pull                 # () -> (total, bad) cumulative
        self.total = 0
        self.bad = 0
        self.ring: deque = deque()       # (t, total, bad) snapshots
        self.spark: deque = deque(maxlen=spark_len)  # fast-burn series
        self.alert = AlertState(f"slo.{name}")

    def push(self, ok: bool, n: int = 1):
        """Record ``n`` events (push ledgers only)."""
        self.total += n
        if not ok:
            self.bad += n

    def totals(self):
        """Current cumulative (total, bad)."""
        return self.pull() if self.pull is not None else (self.total,
                                                          self.bad)

    def snap(self, now: float, max_window: float):
        """Append one (t, total, bad) snapshot; evict beyond the
        longest window (+1 entry kept as the baseline just outside)."""
        t, b = self.totals()
        self.ring.append((now, t, b))
        while len(self.ring) > 2 and self.ring[1][0] <= now - max_window:
            self.ring.popleft()

    def window_rate(self, now: float, window: float):
        """(bad_fraction, n_events) over the trailing ``window``
        seconds: the delta between now and the newest snapshot at or
        before ``now - window`` (the oldest snapshot when the ring is
        still younger than the window)."""
        t, b = self.totals()
        base_t, base_b = 0, 0
        for st, stot, sbad in reversed(self.ring):
            base_t, base_b = stot, sbad
            if st <= now - window:
                break
        n = t - base_t
        if n <= 0:
            return 0.0, 0
        return (b - base_b) / n, n

    def burn(self, now: float, window: float) -> float:
        """Budget burn rate over ``window``: bad_fraction / budget."""
        frac, _ = self.window_rate(now, window)
        return frac / (1.0 - self.objective)


def _latency_pull(registry: MetricsRegistry, hist: str, target: float):
    """Cumulative (total, late) derived from an existing histogram's
    bucket counts: everything in buckets strictly above the bucket
    holding ``target`` is late (bucket-resolution conservative — values
    sharing the target's bucket count as on-time)."""
    def pull():
        h = registry.histograms.get(hist)
        if h is None:
            return 0, 0
        i = h.spec.bucket_index(target)
        counts = h.counts
        return sum(counts), sum(counts[i + 1:])
    return pull


def _availability_pull(registry: MetricsRegistry, hist: str, errs: str):
    """Cumulative (total, errors): the error counter against the
    latency histogram's count (errors never observe the histogram, so
    total requests = observed + errored)."""
    def pull():
        h = registry.histograms.get(hist)
        c = registry.counters.get(errs)
        e = c.value if c is not None else 0
        n = (h.count if h is not None else 0) + e
        return n, e
    return pull


class SloEngine:
    """Error budgets, burn-rate alerts, and the ``health()`` verdict.

    ``add(spec)`` registers an endpoint's objectives; ``tick()`` (call
    it once per request batch, or on any cadence — it self-limits to
    ``resolution`` seconds) snapshots every ledger, evaluates the burn
    policies, mirrors gauges, and fires callbacks on rising edges.
    ``clock`` is injectable (tests/drills drive a fake clock; serving
    uses the default monotonic clock).

    Gauges per ledger: ``slo.<name>.burn_fast`` / ``.burn_slow``
    (burn over the fastest policy's long/short windows),
    ``slo.<name>.budget_remaining`` (fraction of the longest-window
    budget left), and an ``slo.<name>.alerts`` counter.
    """

    def __init__(self, registry: MetricsRegistry = None,
                 policies=DEFAULT_POLICIES, resolution: float = 1.0,
                 clock=time.monotonic, spark_len: int = 64):
        self.registry = registry if registry is not None \
            else default_registry()
        self.policies = tuple(policies)
        if not self.policies:
            raise ValueError("need at least one BurnPolicy")
        self.resolution = float(resolution)
        self.clock = clock
        self.spark_len = int(spark_len)
        self.specs: dict[str, SloSpec] = {}
        self.ledgers: dict[str, _Ledger] = {}
        self._callbacks: list = []
        self._resources = None
        self._compile_mark = None
        self._last_tick = -math.inf
        self._max_window = max(p.long_s for p in self.policies)
        self._fast = min(self.policies, key=lambda p: p.short_s)

    # -- registration --------------------------------------------------------
    def ledger(self, name: str, objective: float, pull=None) -> _Ledger:
        """Get-or-create the ledger ``name`` (objective fixed at
        birth); ``pull`` makes it read cumulative totals instead of
        accepting pushes."""
        led = self.ledgers.get(name)
        if led is None:
            led = self.ledgers[name] = _Ledger(
                name, objective, pull, spark_len=self.spark_len)
        return led

    def add(self, spec: SloSpec) -> "SloEngine":
        """Register one endpoint's objectives; returns self."""
        self.specs[spec.name] = spec
        reg = self.registry
        if spec.latency_hist:
            self.ledger(f"{spec.name}.latency", spec.latency_objective,
                        _latency_pull(reg, spec.latency_hist,
                                      spec.latency_target_s))
            if spec.error_counter:
                self.ledger(f"{spec.name}.availability",
                            spec.availability_objective,
                            _availability_pull(reg, spec.latency_hist,
                                               spec.error_counter))
        if spec.quality_min == spec.quality_min:    # not NaN
            self.ledger(f"{spec.name}.quality", spec.quality_objective)
        return self

    def attach_resources(self, resources,
                         objective: float = 0.99) -> "SloEngine":
        """Watch a ``ResourceMonitor``'s compile counter (in the port,
        the kernel sources ``nvcc`` compiled): after ``mark_steady()``,
        every tick contributes one trial to the ``runtime.recompile``
        ledger — bad when any compile happened since the previous tick.
        This turns the "never-recompile" invariant into a budgeted
        runtime gauge: a hot path that compiles burns the budget every
        tick and trips the fast-window alert."""
        self._resources = resources
        self.ledger("runtime.recompile", objective)
        return self

    def mark_steady(self):
        """Arm the recompile ledger: compiles before this call (warmup,
        autotune) are free; compiles after it burn budget."""
        if self._resources is not None:
            self._compile_mark = self._resources.jit_compiles()

    def subscribe(self, callback) -> "SloEngine":
        """Add an alert callback ``callback(series, value, detector)``
        (the ``DriftMonitor`` contract); returns self."""
        self._callbacks.append(callback)
        return self

    # -- event pushes --------------------------------------------------------
    def observe_quality(self, slo_name: str, value: float,
                        floor: float = None):
        """Feed one quality observation (shadow recall, probe recall)
        for ``slo_name``; bad when below the spec's ``quality_min``
        (or an explicit ``floor``). No-op without a floor."""
        spec = self.specs.get(slo_name)
        if floor is None:
            floor = spec.quality_min if spec is not None else math.nan
        if floor != floor or value != value:
            return
        obj = spec.quality_objective if spec is not None else 0.95
        self.ledger(f"{slo_name}.quality", obj).push(value >= floor)

    def observe_probe(self, slo_name: str, ok: bool):
        """Feed one canary-probe verdict into ``<slo>.quality`` — a
        failed known-answer probe is a quality budget event exactly
        like a bad shadow-recall sample."""
        spec = self.specs.get(slo_name)
        obj = spec.quality_objective if spec is not None else 0.95
        self.ledger(f"{slo_name}.quality", obj).push(bool(ok))

    # -- the closed loop -----------------------------------------------------
    def tick(self, force: bool = False) -> bool:
        """One engine step: snapshot ledgers, evaluate burn policies,
        mirror gauges, fire callbacks on rising edges. Self-limits to
        one evaluation per ``resolution`` seconds unless ``force``;
        returns whether an evaluation ran."""
        now = self.clock()
        if not force and now - self._last_tick < self.resolution:
            return False
        self._last_tick = now
        if self._resources is not None and self._compile_mark is not None:
            cur = self._resources.jit_compiles()
            delta = cur - self._compile_mark
            self._compile_mark = cur
            led = self.ledgers["runtime.recompile"]
            led.push(delta == 0)
            if delta > 1:                # each compile burns separately
                led.push(False, n=delta - 1)
        reg = self.registry
        for led in self.ledgers.values():
            led.snap(now, self._max_window)
            burn_fast = led.burn(now, self._fast.long_s)
            burn_short = led.burn(now, self._fast.short_s)
            led.spark.append(burn_fast)
            worst = 0.0
            fired_policy = None
            active = False
            for pol in self.policies:
                fl, nl = led.window_rate(now, pol.long_s)
                fs, _ = led.window_rate(now, pol.short_s)
                budget = 1.0 - led.objective
                bl, bs = fl / budget, fs / budget
                ratio = min(bl, bs) / pol.threshold
                if ratio > worst:
                    worst = ratio
                if (bl >= pol.threshold and bs >= pol.threshold
                        and nl >= pol.min_events):
                    active = True
                    if fired_policy is None:
                        fired_policy = pol
            st = led.alert
            st.stat = worst
            frac, _ = led.window_rate(now, self._max_window)
            budget_left = max(0.0, 1.0 - frac / (1.0 - led.objective))
            name = led.name
            reg.gauge(f"slo.{name}.burn_fast").set(burn_fast)
            reg.gauge(f"slo.{name}.burn_short").set(burn_short)
            reg.gauge(f"slo.{name}.budget_remaining").set(budget_left)
            if active and not st.active:
                st.active = True
                st.alarms += 1
                st.side = "up"
                st.policy = fired_policy
                st.since = now
                reg.counter(f"slo.{name}.alerts").inc()
                for cb in self._callbacks:
                    cb(st.series, burn_fast, st)
            elif not active and st.active:
                st.active = False
        return True

    # -- verdicts ------------------------------------------------------------
    def budgets(self) -> dict:
        """Per-ledger budget view: {name: {objective, burn_fast,
        burn_short, budget_remaining, alerting, alarms, spark}}."""
        now = self.clock()
        out = {}
        for name, led in self.ledgers.items():
            frac, n = led.window_rate(now, self._max_window)
            out[name] = {
                "objective": led.objective,
                "events": n,
                "burn_fast": led.burn(now, self._fast.long_s),
                "burn_short": led.burn(now, self._fast.short_s),
                "budget_remaining": max(
                    0.0, 1.0 - frac / (1.0 - led.objective)),
                "alerting": led.alert.active,
                "alarms": led.alert.alarms,
                "spark": list(led.spark),
            }
        return out

    def health(self) -> dict:
        """The machine-readable verdict (admission-control input).

        ``status`` is "degraded" while any alert is active, else "ok".
        ``shed_fraction`` is advisory: the traffic fraction admission
        control would need to reject for the worst active fast burn to
        fall back to its policy threshold (`1 - threshold/burn`,
        clamped to [0, 1]); 0.0 when healthy.
        """
        alerts = [led.alert.series for led in self.ledgers.values()
                  if led.alert.active]
        now = self.clock()
        shed = 0.0
        for led in self.ledgers.values():
            if not led.alert.active:
                continue
            pol = led.alert.policy or self._fast
            b = led.burn(now, pol.long_s)
            if b > pol.threshold:
                shed = max(shed, 1.0 - pol.threshold / b)
        return {
            "status": "degraded" if alerts else "ok",
            "alerts": alerts,
            "shed_fraction": min(1.0, shed),
            "slos": self.budgets(),
        }
