"""Device/host resource accounting: live bytes, watermarks, recompiles.

Counterpart of ``repro/obs/resources.py``. The serving tier's capacity
questions — "does the next shard fit?", "is something leaking device
memory?", "did the hot path silently start compiling?" — need numbers.
This module is the accounting layer:

* **tracked live bytes** — ``track(name, obj)`` registers anything with
  an ``nbytes`` attribute/property (``CodeStore``, ``SegmentLogStore``,
  a ``PackedLinearModel``'s tables) or a zero-arg callable; ``collect``
  mirrors each into a ``resources.bytes.<name>`` gauge. These are the
  *modeled* byte counts the stores already maintain, aggregated in one
  place.
* **device memory** — the CUDA caching allocator's figures for each
  card (``torch.cuda.memory_stats(i)``: ``allocated_bytes.all.current``
  and ``.peak``) under ``resources.device.cuda<i>.bytes_in_use`` and
  ``.peak_bytes``, with ``live_bytes`` their sum. They are read only
  once this process has initialised CUDA (a process that never touched
  the card holds no device bytes): without a card, or before the first
  CUDA call, the section stays empty and nothing raises, as the
  reference's CPU backend reports none.
* **host RSS** — current resident set from ``/proc/self/status`` (NaN
  on platforms without procfs) and the peak RSS from
  ``resource.getrusage``.
* **compiles** — the port runs eagerly and has no JIT; what it compiles
  is its CUDA kernels, one ``nvcc`` call a source, in
  ``kernels._build.build_all``. ``jit_compiles()`` reads that
  process-wide count (``_build.COMPILES``), so the "never-recompile"
  invariant (serving traffic reuses the kernels built before warm-up)
  is a runtime number: ``mark()`` pins a baseline after warm-up,
  ``compiles_since_mark`` must stay 0, and
  ``SloEngine.attach_resources`` turns any excursion into a budget burn
  and an alert. The names are the reference's, so the SLO engine and
  the dashboard read one truth whichever package runs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.obs.registry import MetricsRegistry, default_registry

__all__ = ["ResourceMonitor", "install_compile_counter", "jit_compiles"]


def install_compile_counter() -> bool:
    """Kept for the reference's interface: the port's counter lives in
    ``kernels._build`` and always counts, so there is nothing to
    install. Returns True."""
    return True


def jit_compiles() -> int:
    """Process-wide kernel compiles: the ``nvcc`` calls ``build_all``
    made in this process."""
    return _build.COMPILES


def _host_rss_bytes() -> float:
    """Current resident set size from procfs; NaN when unavailable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024.0
    except OSError:
        pass
    return math.nan


def _host_peak_rss_bytes() -> float:
    """Peak RSS via getrusage (ru_maxrss is KiB on linux)."""
    try:
        import resource
        return float(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss) * 1024.0
    except Exception:
        return math.nan


def _device_memory() -> dict:
    """{"cuda<i>": (bytes in use, peak bytes)} from the caching
    allocator; empty until this process has initialised CUDA (never
    initialises it)."""
    if not torch.cuda.is_initialized():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda{i}"] = (stats.get("allocated_bytes.all.current", 0),
                           stats.get("allocated_bytes.all.peak", 0))
    return out


class ResourceMonitor:
    """One scope of resource gauges (see module docstring).

    ``collect()`` is the slow-path refresh (dashboard render, SLO tick
    at resolution, incident capture) — it walks tracked objects, the
    allocator's statistics, and procfs; nothing here belongs on a
    per-request path. Every gauge lands in the registry under
    ``resources.*`` and the same values come back as the return dict.
    """

    def __init__(self, registry: MetricsRegistry = None):
        self.registry = registry if registry is not None \
            else default_registry()
        self._tracked: dict = {}
        self._mark = 0

    def track(self, name: str, obj) -> "ResourceMonitor":
        """Register ``obj`` under ``name``: anything with an ``nbytes``
        attribute (stores, models) or a zero-arg callable returning
        bytes; returns self for chaining."""
        self._tracked[str(name)] = obj
        return self

    def untrack(self, name: str):
        """Forget a tracked object (missing name is a no-op)."""
        self._tracked.pop(str(name), None)

    @staticmethod
    def _bytes_of(obj) -> float:
        if callable(obj) and not hasattr(obj, "nbytes"):
            return float(obj())
        v = getattr(obj, "nbytes", math.nan)
        return float(v() if callable(v) else v)

    # -- recompile accounting ------------------------------------------------
    def jit_compiles(self) -> int:
        """Process-wide compile count (module-global truth)."""
        return jit_compiles()

    def mark(self) -> int:
        """Pin the compile baseline (call after warmup/autotune);
        returns the baseline count."""
        self._mark = jit_compiles()
        return self._mark

    @property
    def compiles_since_mark(self) -> int:
        """Compiles since ``mark()`` — the never-recompile invariant
        says this stays 0 on a warmed serving path."""
        return jit_compiles() - self._mark

    # -- the one-call refresh ------------------------------------------------
    def collect(self) -> dict:
        """Refresh every gauge; returns the resource dict."""
        reg = self.registry
        out = {"tracked": {}, "device": {}, "host": {}}
        total_tracked = 0.0
        for name, obj in self._tracked.items():
            try:
                b = self._bytes_of(obj)
            except Exception:
                b = math.nan
            out["tracked"][name] = b
            if b == b:
                total_tracked += b
                reg.gauge(f"resources.bytes.{name}").set(b)
        out["tracked_total"] = total_tracked
        reg.gauge("resources.bytes.tracked_total").set(total_tracked)

        mem = _device_memory()
        if mem:
            live = sum(used for used, _ in mem.values())
            out["device"]["live_bytes"] = int(live)
            reg.gauge("resources.device.live_bytes").set(live)
        for did, (used, peak) in mem.items():
            out["device"][f"{did}.bytes_in_use"] = int(used)
            reg.gauge(f"resources.device.{did}.bytes_in_use").set(used)
            out["device"][f"{did}.peak_bytes"] = int(peak)
            reg.gauge(f"resources.device.{did}.peak_bytes").set(peak)

        rss = _host_rss_bytes()
        peak = _host_peak_rss_bytes()
        out["host"]["rss_bytes"] = rss
        out["host"]["peak_rss_bytes"] = peak
        if rss == rss:
            reg.gauge("resources.host.rss_bytes").set(rss)
        if peak == peak:
            reg.gauge("resources.host.peak_rss_bytes").set(peak)

        out["jit_compiles"] = jit_compiles()
        out["compiles_since_mark"] = self.compiles_since_mark
        reg.gauge("resources.jit_compiles").set(out["jit_compiles"])
        reg.gauge("resources.compiles_since_mark").set(
            out["compiles_since_mark"])
        return out
