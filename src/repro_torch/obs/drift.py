"""Online drift detectors: Page-Hinkley / CUSUM over monitored series.

Counterpart of ``repro/obs/drift.py``, a copy in pure Python: the same
series give the same statistics, alarms and sides bit for bit.

The quality monitors (``obs.quality``, ``obs.shadow``) turn the paper's
statistical contracts into live series — collision-cell divergence,
shadow recall, classifier margin moments. This module watches those
series for *change*: a detector accumulates evidence that the stream's
mean has moved and fires once the evidence crosses a threshold, with a
bounded false-alarm rate on a stationary stream.

Two classic sequential tests, both O(1) state and O(1) per update:

``PageHinkley``
    Tracks ``m_t = sum(x_i - mean_i - delta)`` against its running
    minimum: ``m_t - min_t > threshold`` means the mean rose by more
    than ``delta`` for long enough to accumulate ``threshold`` worth of
    excess. Two-sided, the mirrored accumulator
    ``sum(x_i - mean_i + delta)`` is held against its running maximum —
    the two sides need *separate* sums because each one's ``delta``
    slack deliberately drifts it away from its own firing boundary; a
    shared sum would drift the other side's statistic into a false
    alarm at rate ``delta`` per step on a perfectly stationary stream.
    The standard choice for drift in averaged performance series.

``Cusum``
    Tabular CUSUM against a frozen baseline: the first ``warmup``
    samples fix ``mu0``, then ``s+ = max(0, s+ + (x - mu0 - slack))``
    (and the mirrored ``s-``) fire at ``threshold``. Use when the
    healthy level is known or should be pinned at deployment time.

``DriftMonitor`` names a set of series, owns one detector per series,
mirrors every update into ``repro_torch.obs`` registry gauges
(``drift.<series>.stat`` / ``.value``) and counters
(``drift.<series>.alarms``), and fires registered callbacks on alarm —
the hook a warm-start refit subscribes to.

Callback contract: ``callback(series: str, value: float, detector)`` is
invoked synchronously inside ``update`` *after* the detector reset, so
a refit triggered by the callback observes a detector that is already
re-armed; exceptions propagate to the caller of ``update`` (a monitor
must never swallow a failing trigger silently). Detectors reset on
fire, so consecutive alarms require fresh evidence.
"""
from __future__ import annotations

import math

from repro_torch.obs.registry import MetricsRegistry, default_registry

__all__ = ["PageHinkley", "Cusum", "DriftMonitor"]


class PageHinkley:
    """Page-Hinkley test for a shift in the mean of a stream.

    ``delta`` is the magnitude of mean drift considered negligible (the
    test's slack), ``threshold`` the accumulated evidence needed to
    fire, ``min_samples`` a floor below which the test never fires
    (protects the running mean while it is still noisy). Two-sided by
    default: fires on drift in either direction.
    """

    __slots__ = ("delta", "threshold", "min_samples", "two_sided",
                 "n", "mean", "_m_up", "_m_up_min", "_m_dn", "_m_dn_max",
                 "alarms", "side")

    def __init__(self, delta: float = 0.005, threshold: float = 0.1,
                 min_samples: int = 10, two_sided: bool = True):
        if threshold <= 0:
            raise ValueError(f"threshold must be positive, got {threshold}")
        self.delta = float(delta)
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.two_sided = two_sided
        self.alarms = 0
        self.side = ""        # direction of the last alarm: "up"/"down"
        self.reset()

    def reset(self):
        """Re-arm: drop all accumulated state (called on every alarm)."""
        self.n = 0
        self.mean = 0.0
        self._m_up = 0.0
        self._m_up_min = 0.0
        self._m_dn = 0.0
        self._m_dn_max = 0.0

    @property
    def stat(self) -> float:
        """Current test statistic: max of the up/down evidence (the
        value compared against ``threshold``)."""
        up = self._m_up - self._m_up_min
        down = (self._m_dn_max - self._m_dn) if self.two_sided else 0.0
        return max(up, down)

    def update(self, x: float) -> bool:
        """Feed one observation; returns True iff the test fires (the
        detector resets itself before returning True)."""
        x = float(x)
        self.n += 1
        self.mean += (x - self.mean) / self.n
        dev = x - self.mean
        self._m_up += dev - self.delta
        self._m_up_min = min(self._m_up_min, self._m_up)
        self._m_dn += dev + self.delta
        self._m_dn_max = max(self._m_dn_max, self._m_dn)
        if self.n >= self.min_samples and self.stat > self.threshold:
            up = self._m_up - self._m_up_min
            down = (self._m_dn_max - self._m_dn) if self.two_sided \
                else 0.0
            self.side = "up" if up >= down else "down"
            self.alarms += 1
            self.reset()
            return True
        return False


class Cusum:
    """Two-sided tabular CUSUM against a warmup-frozen baseline.

    The first ``warmup`` samples only update the baseline mean ``mu0``
    (pass ``mu0`` explicitly to skip warmup); afterwards the classic
    one-sided sums accumulate deviations beyond ``slack`` and fire at
    ``threshold``.
    """

    __slots__ = ("slack", "threshold", "warmup", "mu0", "n",
                 "_s_pos", "_s_neg", "alarms", "side")

    def __init__(self, slack: float = 0.005, threshold: float = 0.1,
                 warmup: int = 10, mu0: float = None):
        if threshold <= 0:
            raise ValueError(f"threshold must be positive, got {threshold}")
        self.slack = float(slack)
        self.threshold = float(threshold)
        self.warmup = 0 if mu0 is not None else int(warmup)
        self.mu0 = float(mu0) if mu0 is not None else 0.0
        self.alarms = 0
        self.side = ""        # direction of the last alarm: "up"/"down"
        self.n = 0
        self._s_pos = 0.0
        self._s_neg = 0.0

    def reset(self):
        """Re-arm the sums; the frozen baseline ``mu0`` is kept."""
        self._s_pos = 0.0
        self._s_neg = 0.0

    @property
    def stat(self) -> float:
        """Current test statistic: max of the two one-sided sums."""
        return max(self._s_pos, self._s_neg)

    def update(self, x: float) -> bool:
        """Feed one observation; returns True iff either sum fires
        (sums reset, baseline kept)."""
        x = float(x)
        self.n += 1
        if self.n <= self.warmup:
            self.mu0 += (x - self.mu0) / self.n
            return False
        self._s_pos = max(0.0, self._s_pos + (x - self.mu0 - self.slack))
        self._s_neg = max(0.0, self._s_neg + (self.mu0 - x - self.slack))
        if self.stat > self.threshold:
            self.side = "up" if self._s_pos >= self._s_neg else "down"
            self.alarms += 1
            self.reset()
            return True
        return False


class DriftMonitor:
    """Named drift series -> detector, gauges, and alarm callbacks.

    ``watch(name, detector)`` registers a series (unwatched series get a
    default two-sided ``PageHinkley`` on first update); ``update(name,
    value)`` feeds it, mirrors ``drift.<name>.value`` / ``.stat`` gauges
    and the ``drift.<name>.alarms`` counter into the registry, and on
    alarm invokes every subscribed callback (see module docstring for
    the contract). With a disabled registry the gauges are no-ops but
    detection and callbacks still run — drift triggers must survive
    metrics being turned off.
    """

    def __init__(self, registry: MetricsRegistry = None,
                 detector_factory=None):
        self.registry = registry if registry is not None \
            else default_registry()
        self._factory = detector_factory or (lambda: PageHinkley())
        self._detectors: dict[str, object] = {}
        self._callbacks: list = []

    def watch(self, series: str, detector=None):
        """Register ``series`` with ``detector`` (default: the monitor's
        factory, a two-sided Page-Hinkley); returns the detector."""
        if detector is None:
            detector = self._factory()
        self._detectors[series] = detector
        return detector

    def detector(self, series: str):
        """The detector watching ``series`` (auto-registered if new)."""
        d = self._detectors.get(series)
        if d is None:
            d = self.watch(series)
        return d

    def subscribe(self, callback) -> "DriftMonitor":
        """Add an alarm callback ``callback(series, value, detector)``;
        returns self for chaining."""
        self._callbacks.append(callback)
        return self

    def update(self, series: str, value: float) -> bool:
        """Feed one observation of ``series``; returns True iff its
        detector fired (callbacks already invoked)."""
        value = float(value)
        if math.isnan(value):
            return False
        det = self.detector(series)
        fired = det.update(value)
        reg = self.registry
        reg.gauge(f"drift.{series}.value").set(value)
        reg.gauge(f"drift.{series}.stat").set(det.stat)
        reg.gauge(f"drift.{series}.samples").set(det.n)
        if fired:
            reg.counter(f"drift.{series}.alarms").inc()
            for cb in self._callbacks:
                cb(series, value, det)
        return fired

    def alarms(self, series: str) -> int:
        """Total alarms fired by ``series`` so far (0 if unwatched)."""
        d = self._detectors.get(series)
        return d.alarms if d is not None else 0
