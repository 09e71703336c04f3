"""One-call exporters: obs state -> JSON snapshot / Prometheus text.

Counterpart of ``repro/obs/export.py``, the same code; the roofline
table folds against the port's H100 model (``obs.kernelstats.HW``).

``snapshot()`` folds the metrics registry (counters, gauges, histogram
summaries with derived p50/p95/p99) and the kernel dispatch stats into
one plain dict; ``dump_json`` writes it. ``to_prometheus`` renders the
registry in the Prometheus text exposition format (counters as
``_total``, histograms as cumulative ``_bucket{le=...}`` series plus
``_sum``/``_count``), so a scrape endpoint is one ``web.Response`` away.
Metric names are sanitized (dots -> underscores) for Prometheus only;
the JSON snapshot keeps the dotted names the code uses.
"""
from __future__ import annotations

import json

from repro_torch.obs import kernelstats as _kstats
from repro_torch.obs.registry import MetricsRegistry, default_registry

__all__ = ["snapshot", "dump_json", "to_prometheus"]


def snapshot(registry: MetricsRegistry = None, kernels=None,
             hw=None) -> dict:
    """Everything observable as one dict: registry metrics + kernel
    dispatch totals + the modeled roofline table. ``registry`` defaults
    to the process-global one, ``kernels`` to the global accumulator."""
    reg = registry if registry is not None else default_registry()
    ks = kernels if kernels is not None else _kstats.get_kernel_stats()
    out = reg.snapshot()
    out["kernels"] = ks.snapshot()
    out["roofline"] = ks.roofline_table(hw)
    return out


def dump_json(path: str, registry: MetricsRegistry = None,
              kernels=None) -> str:
    """Write ``snapshot()`` as JSON to ``path``; returns ``path``."""
    with open(path, "w") as f:
        json.dump(snapshot(registry, kernels), f, indent=1)
    return path


def _sanitize(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _escape_label(value) -> str:
    """Escape one label value per the OpenMetrics/Prometheus text
    exposition spec: backslash, double-quote, and newline must be
    escaped inside quoted label values (a hostile trace id must not be
    able to forge extra labels or break the exposition line)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def to_prometheus(registry: MetricsRegistry = None) -> str:
    """Render the registry in Prometheus text exposition format.

    Conventional series shapes: every finite bucket bound is emitted —
    empty ones included — so the cumulative ``_bucket{le=...}`` series
    is complete and monotone and keeps the *same* label set across
    scrapes (rate()/histogram_quantile() break on appearing/disappearing
    ``le`` labels); each metric carries a ``# HELP`` line (the dotted
    registry name, which is how the code refers to it) ahead of its
    ``# TYPE``. Histogram buckets holding an exemplar (a retained
    flight-recorder trace pinned via ``Histogram.exemplar``) carry an
    OpenMetrics-style annotation ``# {trace_id="..."} <value>`` — the
    link from a latency bucket back to the concrete trace that landed
    there. Label values are escaped per the OpenMetrics spec
    (backslash, double-quote, newline), so a hostile trace id cannot
    forge labels or split the exposition line.
    """
    reg = registry if registry is not None else default_registry()
    lines = []
    for name, c in sorted(reg.counters.items()):
        n = _sanitize(name)
        lines.append(f"# HELP {n}_total counter '{name}'")
        lines.append(f"# TYPE {n}_total counter")
        lines.append(f"{n}_total {c.value}")
    for name, g in sorted(reg.gauges.items()):
        n = _sanitize(name)
        lines.append(f"# HELP {n} gauge '{name}'")
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {g.value}")
    for name, h in sorted(reg.histograms.items()):
        n = _sanitize(name)
        lines.append(f"# HELP {n} histogram '{name}'")
        lines.append(f"# TYPE {n} histogram")
        cum = 0
        for i, cnt in enumerate(h.counts):
            cum += cnt
            le = h.spec.bucket_bounds(i)[1]
            ex = h.exemplars.get(i)
            tail = (f' # {{trace_id="{_escape_label(ex[1])}"}} '
                    f'{ex[0]:.6g}' if ex is not None else "")
            lines.append(f'{n}_bucket{{le="{le:.6g}"}} {cum}{tail}')
        lines.append(f'{n}_bucket{{le="+Inf"}} {h.count}')
        lines.append(f"{n}_sum {h.total}")
        lines.append(f"{n}_count {h.count}")
    return "\n".join(lines) + "\n"
