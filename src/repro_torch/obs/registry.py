"""Low-overhead metrics registry: counters, gauges, log-bucket histograms.

Counterpart of ``repro/obs/registry.py``, the same code: the substrate
every subsystem of the port reports through (``repro_torch.obs``). Three
metric kinds, all host-side and allocation-free on the hot path:

* ``Counter`` — monotone int/float accumulator (``inc``).
* ``Gauge``   — last-write-wins float (``set``).
* ``Histogram`` — fixed log-spaced buckets: ``observe(v)`` is one
  C-level bisect over precomputed bucket edges + one list increment
  (no ``math.log`` on the hot path), and p50/p95/p99 are derivable from
  the bucket counts alone — no samples are ever stored, so memory is
  O(buckets) whatever the traffic. ``exemplar(v, trace_id)`` pins a
  retained flight-recorder trace to the bucket holding ``v``.

A ``MetricsRegistry`` owns one namespace of metrics. There is a
process-global default (``default_registry``) for code that doesn't
thread a registry through, and any component can take an injected
instance instead (the serving layer does). A registry built with
``enabled=False`` hands out shared null metrics whose methods are empty
— the disabled mode costs one method call per site and nothing else
(``tests/test_torch_serve.py`` holds it to the reference's).
"""
from __future__ import annotations

import math
from bisect import bisect_left

__all__ = ["Counter", "Gauge", "Histogram", "HistogramSpec",
           "MetricsRegistry", "NULL_COUNTER", "NULL_GAUGE",
           "NULL_HISTOGRAM", "default_registry", "set_default_registry"]


class Counter:
    """Monotone accumulator; read ``value`` directly."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        """Add ``n`` (default 1) to the counter."""
        self.value += n


class Gauge:
    """Last-write-wins scalar; read ``value`` directly."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v):
        """Overwrite the gauge with ``v``."""
        self.value = float(v)


class HistogramSpec:
    """Fixed log-bucket layout: ``n_buckets`` edges at ``lo * growth^i``.

    Values below ``lo`` land in bucket 0, values at or above ``hi`` in
    the last bucket — the range is clamped, never resized, so two
    histograms with the same spec are always mergeable bucket-by-bucket.
    The default (1 us .. 1000 s, growth 2^1/4) brackets any latency this
    system produces within a ~19% relative error per bucket.
    """

    __slots__ = ("lo", "hi", "growth", "n_buckets", "_log_lo", "_log_g",
                 "_edges")

    def __init__(self, lo: float = 1e-6, hi: float = 1e3,
                 growth: float = 2.0 ** 0.25):
        if not (lo > 0 and hi > lo and growth > 1.0):
            raise ValueError(f"bad histogram spec lo={lo} hi={hi} "
                             f"growth={growth}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.growth = float(growth)
        self._log_lo = math.log(lo)
        self._log_g = math.log(growth)
        self.n_buckets = int(math.ceil(
            (math.log(hi) - self._log_lo) / self._log_g)) + 1
        # precomputed upper edges of buckets 0..n-2: the hot-path lookup
        # is a C-level bisect instead of a math.log per observe. The
        # edge list is one short of n_buckets so any v past the last
        # edge clamps into the final bucket for free.
        self._edges = [math.exp(self._log_lo + self._log_g * (i + 1))
                       for i in range(self.n_buckets - 1)]

    def bucket_index(self, v: float) -> int:
        """Bucket holding ``v`` (clamped to [0, n_buckets))."""
        return bisect_left(self._edges, v)

    def bucket_bounds(self, i: int):
        """(lower, upper) value edges of bucket ``i``; bucket 0's lower
        edge is 0 (it absorbs every underflow)."""
        lower = 0.0 if i == 0 else self.lo * self.growth ** i
        return lower, self.lo * self.growth ** (i + 1)


DEFAULT_SPEC = HistogramSpec()


class Histogram:
    """Log-bucket histogram: O(1) observe, percentiles from counts.

    ``percentile(q)`` returns the upper edge of the bucket where the
    cumulative count first reaches ``q`` — an upper bound on the true
    quantile that is tight to one bucket (a ``growth`` factor);
    ``percentile_bounds(q)`` returns both edges.
    """

    __slots__ = ("name", "spec", "counts", "total", "vmin",
                 "vmax", "_edges", "exemplars")

    def __init__(self, name: str, spec: HistogramSpec = DEFAULT_SPEC):
        self.name = name
        self.spec = spec
        self.counts = [0] * spec.n_buckets
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._edges = spec._edges         # skip one attr hop per observe
        self.exemplars: dict = {}         # bucket index -> (value, trace_id)

    def observe(self, v: float, _bisect=bisect_left):
        """Record one value: one C-level bisect, one list increment,
        one float add — the whole hot path. The total observation count
        is derived from the buckets at read time (``count``), not
        tracked per observe."""
        self.counts[_bisect(self._edges, v)] += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    @property
    def count(self) -> int:
        """Total observations (bucket sum; O(buckets), read-time only)."""
        return sum(self.counts)

    def exemplar(self, v: float, trace_id):
        """Attach an exemplar: remember ``trace_id`` as *the* retained
        trace for the bucket holding ``v`` (last writer wins). Exported
        as an OpenMetrics ``# {trace_id="..."}`` bucket annotation —
        the link from a histogram tail to a concrete flight-recorder
        trace. Call after ``observe(v)``; off the hot path (only
        tail-retained requests pay it)."""
        self.exemplars[bisect_left(self._edges, v)] = (v, trace_id)

    def percentile_bounds(self, q: float):
        """(lower, upper) edges of the bucket containing quantile ``q``
        in (0, 1]; (nan, nan) when empty."""
        if self.count == 0:
            return math.nan, math.nan
        need = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= need:
                return self.spec.bucket_bounds(i)
        return self.spec.bucket_bounds(self.spec.n_buckets - 1)

    def percentile(self, q: float) -> float:
        """Upper-bound estimate of quantile ``q`` (see class docstring)."""
        return self.percentile_bounds(q)[1]

    @property
    def mean(self) -> float:
        """Exact mean of every observed value (sum is tracked exactly)."""
        return self.total / self.count if self.count else math.nan

    def summary(self) -> dict:
        """count / sum / min / max / mean / p50 / p95 / p99 as a dict."""
        return {"count": self.count, "sum": self.total,
                "min": self.vmin if self.count else math.nan,
                "max": self.vmax if self.count else math.nan,
                "mean": self.mean,
                "p50": self.percentile(0.50),
                "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}


class _NullCounter(Counter):
    """Shared no-op counter handed out by disabled registries."""

    __slots__ = ()

    def inc(self, n=1):
        """No-op."""


class _NullGauge(Gauge):
    """Shared no-op gauge handed out by disabled registries."""

    __slots__ = ()

    def set(self, v):
        """No-op."""


class _NullHistogram(Histogram):
    """Shared no-op histogram handed out by disabled registries."""

    __slots__ = ()

    def observe(self, v):
        """No-op."""

    def exemplar(self, v, trace_id):
        """No-op."""


NULL_COUNTER = _NullCounter("null")
NULL_GAUGE = _NullGauge("null")
NULL_HISTOGRAM = _NullHistogram("null")


class MetricsRegistry:
    """One namespace of metrics; get-or-create by dotted name.

    ``enabled=False`` makes every accessor return the shared null
    metrics (their mutators are empty methods), so an instrumented
    call site costs one attribute lookup + one no-op call — cheap
    enough to leave in the hottest host loops.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        """Get-or-create the counter ``name``."""
        if not self.enabled:
            return NULL_COUNTER
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        """Get-or-create the gauge ``name``."""
        if not self.enabled:
            return NULL_GAUGE
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  spec: HistogramSpec = DEFAULT_SPEC) -> Histogram:
        """Get-or-create the histogram ``name`` (spec fixed at birth)."""
        if not self.enabled:
            return NULL_HISTOGRAM
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, spec)
        return h

    def reset(self):
        """Drop every metric (counts and registrations)."""
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()

    def snapshot(self) -> dict:
        """Plain-dict view: {counters, gauges, histograms(summaries)}."""
        return {
            "counters": {n: c.value for n, c in self.counters.items()},
            "gauges": {n: g.value for n, g in self.gauges.items()},
            "histograms": {n: h.summary()
                           for n, h in self.histograms.items()},
        }


_DEFAULT = MetricsRegistry(enabled=True)


def default_registry() -> MetricsRegistry:
    """The process-global registry (enabled by default)."""
    return _DEFAULT


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry; returns the previous one."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = reg
    return prev
