"""Nestable tracing spans with device-sync-correct timing.

Counterpart of ``repro/obs/trace.py``. The timing trap this module
exists to close: PyTorch's CUDA calls return before the card finishes,
so ``t1 - t0`` around a device call measures *submission*, not
execution. A span therefore closes in one of two explicitly-labelled
states:

* **device-synced** — the code inside called ``sp.sync(value)`` under a
  deep tracer (a ``torch.cuda.synchronize`` of every CUDA device that
  holds a tensor of ``value``; CPU tensors are computed eagerly and are
  ready), so the span's duration covers the device work that produced
  ``value``;
* **async** — no sync happened before close (either ``sync=False`` was
  requested, or the caller simply never synced). The span is marked
  ``"sync": "async"`` in the trace.

That labelling is the sync-boundary invariant: a span that closes
without a device sync is *always* marked async — there is no state in
which an unsynced duration masquerades as an execution time.

Tracing is globally opt-in: ``with Tracer() as tr`` installs the tracer,
and while none is installed ``span(...)`` returns a shared no-op context
manager (near-zero cost — the hot path keeps its spans). Finished traces
export to Chrome-trace / Perfetto JSON (``Tracer.dump``).

Two tracer depths exist. A plain ``Tracer`` is **deep**: ``sp.sync``
really blocks, so durations are execution-true. A ``RequestTrace``
(installed per request by ``TailSampler``) is **shallow**: spans are
recorded with submission timings and ``sp.sync`` never blocks, so the
always-on request span chains add no device barriers to the serving
pipeline. Shallow spans are honestly labelled ``"sync": "async"``.
Code that must behave differently under real profiling checks
``deep_tracing_active()``, not ``tracing_active()``.

``TailSampler`` implements the retain-on-tail policy: every request is
*recorded* (cheap shallow chain), but the full trace is *retained* only
when the request lands in the slowest-quantile tail of past requests,
raises, or is flagged. Retention decisions use only (a) past
observations and (b) one seeded RNG, so a replayed workload retains the
same trace ids.
"""
from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.obs.registry import Histogram, HistogramSpec, default_registry

__all__ = ["Span", "Tracer", "RequestTrace", "TailSampler", "span",
           "tracing_active", "deep_tracing_active", "active_tracer",
           "no_tracing"]

_ACTIVE: "Tracer | None" = None


def tracing_active() -> bool:
    """Whether a tracer is currently installed (spans are recording)."""
    return _ACTIVE is not None


def deep_tracing_active() -> bool:
    """Whether a *deep* tracer is installed — one whose ``sp.sync``
    really blocks. Engines use this to pick their device-synced
    per-chunk paths; a shallow ``RequestTrace`` never triggers them."""
    return _ACTIVE is not None and _ACTIVE.deep


def active_tracer() -> "Tracer | None":
    """The installed tracer, or None."""
    return _ACTIVE


class Span:
    """One live span; use via ``with span("name") as sp``.

    Call ``sp.sync(value)`` on the device results produced inside the
    span — it blocks until they are ready (so the closing timestamp is
    execution-true) and returns them. Extra attributes land in the
    Chrome-trace ``args`` via ``sp.set(key=...)`` or the ``span(...)``
    kwargs.
    """

    __slots__ = ("tracer", "name", "args", "sync_wanted", "t0", "_synced")

    def __init__(self, tracer: "Tracer", name: str, sync_wanted: bool,
                 args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.sync_wanted = sync_wanted
        self.t0 = 0.0
        self._synced = False

    def sync(self, value):
        """Block until ``value`` (a tensor, or tuples, lists and dicts of
        them) is ready; marks the span device-synced and returns
        ``value``. Under a shallow tracer (``RequestTrace``) this is a
        passthrough — no block, no synced mark — so always-on request
        tracing never serialises the pipeline; the span stays labelled
        async, which is the truth."""
        if self.tracer.deep:
            for dev in _cuda_devices(value, set()):
                torch.cuda.synchronize(dev)
            self._synced = True
        return value

    def set(self, **attrs):
        """Attach attributes to the span's trace ``args``."""
        self.args.update(attrs)

    def __enter__(self) -> "Span":
        self.tracer._push(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        self.args["sync"] = "device" if self._synced else "async"
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self.tracer._pop(self, t1)
        return False                      # never swallow exceptions


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices holding a tensor of ``value`` (nested tuples,
    lists and dict values)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    return out


class _NullSpan:
    """Shared no-op span returned while no tracer is installed; its
    ``sync`` is a passthrough (no block), so disabled-mode tracing adds
    neither time nor device barriers."""

    __slots__ = ()

    def sync(self, value):
        """Passthrough: no block, no recording."""
        return value

    def set(self, **attrs):
        """No-op."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, sync: bool = True, **attrs):
    """Open a span on the installed tracer (no-op when none is active).

    ``sync=True`` declares the span *should* close device-synced — the
    body is expected to route its device results through ``sp.sync``;
    if it never does, the span is recorded but labelled async.
    ``sync=False`` declares an async span up front (e.g. enqueue-only
    work). Returns a context manager either way.
    """
    tr = _ACTIVE
    if tr is None:
        return _NULL_SPAN
    return Span(tr, name, sync, dict(attrs))


class _NoTracing:
    """Suspends the installed tracer for the duration of a block."""

    __slots__ = ("_prev",)

    def __enter__(self):
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = None
        return self

    def __exit__(self, exc_type, exc, tb):
        global _ACTIVE
        _ACTIVE = self._prev
        return False


def no_tracing() -> _NoTracing:
    """Context manager suspending span recording inside its block —
    for sections too hot to trace, or for measuring the no-tracer span
    cost itself while a tracer happens to be installed."""
    return _NoTracing()


class Tracer:
    """Span collector + Chrome-trace exporter; ``with Tracer() as tr``
    installs it globally for the duration of the block.

    Spans nest per-thread (a stack keyed on thread id); nesting in the
    exported trace is carried by timestamp containment on one track,
    which is exactly how chrome://tracing / Perfetto build flames.
    """

    #: deep tracers make ``sp.sync`` really block (execution-true
    #: durations); ``RequestTrace`` overrides this to False per instance.
    deep = True

    def __init__(self):
        self.events: list[dict] = []      # finished spans, close order
        self._stacks: dict[int, list] = {}
        self._tids: dict[int, int] = {}
        self._t0 = time.perf_counter()
        self._prev = None

    # -- span bookkeeping (called by Span) -----------------------------------
    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
        return tid

    def _push(self, sp: Span):
        self._stacks.setdefault(threading.get_ident(), []).append(sp)

    def _pop(self, sp: Span, t1: float):
        stack = self._stacks[threading.get_ident()]
        # exception-safe: unwind past any inner spans abandoned by a raise
        while stack and stack[-1] is not sp:
            stack.pop()
        if stack:
            stack.pop()
        self.events.append({
            "name": sp.name, "ts": sp.t0 - self._t0,
            "dur": t1 - sp.t0, "tid": self._tid(), "depth": len(stack),
            "args": sp.args})

    def depth(self) -> int:
        """Current nesting depth on the calling thread."""
        return len(self._stacks.get(threading.get_ident(), ()))

    # -- install / uninstall -------------------------------------------------
    def __enter__(self) -> "Tracer":
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self
        return self

    def __exit__(self, exc_type, exc, tb):
        global _ACTIVE
        _ACTIVE = self._prev
        return False

    # -- queries -------------------------------------------------------------
    def durations(self, name: str) -> list:
        """Seconds of every finished span called ``name``."""
        return [e["dur"] for e in self.events if e["name"] == name]

    def total(self, name: str) -> float:
        """Summed seconds across every finished span called ``name``."""
        return sum(self.durations(name))

    # -- export --------------------------------------------------------------
    def to_chrome(self) -> dict:
        """Chrome-trace JSON object (``traceEvents`` complete events,
        timestamps in microseconds) — loadable by chrome://tracing and
        Perfetto."""
        events = [{
            "name": e["name"], "ph": "X", "pid": 0, "tid": e["tid"],
            "ts": round(e["ts"] * 1e6, 3),
            "dur": round(e["dur"] * 1e6, 3),
            "args": e["args"],
        } for e in self.events]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        """Write the Chrome-trace JSON to ``path``; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


class RequestTrace(Tracer):
    """Lightweight per-request span chain — the always-on tracer.

    Shallow by default: spans record submission timings, ``sp.sync``
    never blocks, and every span's ``args`` carry the request's
    ``trace_id`` (the id exported as an exemplar link and stamped on
    flight-recorder events). When an *outer deep* tracer is already
    installed (profiling), the request trace inherits
    ``deep=True`` and forwards its finished spans — rebased onto the
    outer clock — so profiling sees everything and loses nothing.
    """

    def __init__(self, trace_id: int, outer: "Tracer | None" = None):
        super().__init__()
        self.trace_id = trace_id
        self._outer = outer
        self.deep = outer.deep if outer is not None else False

    def _pop(self, sp: Span, t1: float):
        sp.args["trace_id"] = self.trace_id
        super()._pop(sp, t1)
        if self._outer is not None:
            e = dict(self.events[-1])
            e["ts"] += self._t0 - self._outer._t0
            self._outer.events.append(e)


class _Request:
    """Handle for one sampled request (yielded by ``TailSampler.request``).

    Inside the block a ``RequestTrace`` is installed, so every
    ``span(...)`` down the call stack joins this request's chain. Call
    ``set_key`` to choose the tail-ranking key (e.g. deadline-relative
    lateness; defaults to wall duration), ``flag(reason)`` to force
    retention (quality monitors do). After the block, ``retained`` /
    ``reason`` say what the sampler decided.
    """

    __slots__ = ("sampler", "op", "attrs", "trace", "trace_id", "key",
                 "_flags", "_t0", "retained", "reason")

    def __init__(self, sampler: "TailSampler", op: str, attrs: dict):
        self.sampler = sampler
        self.op = op
        self.attrs = attrs
        self.trace_id = sampler._next_id()
        self.key = None
        self._flags = []
        self.retained = False
        self.reason = ""

    def set_key(self, key: float):
        """Set the tail-ranking key (higher = more worth retaining)."""
        self.key = float(key)

    def flag(self, reason: str):
        """Force retention of this request's trace (e.g. a quality
        monitor fired mid-request)."""
        self._flags.append(str(reason))

    def __enter__(self) -> "_Request":
        outer = _ACTIVE
        self.trace = RequestTrace(
            self.trace_id, outer if outer is not None and outer.deep
            else None)
        self.trace.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        self.trace.__exit__(exc_type, exc, tb)
        self.sampler._finish(self, dur, exc_type)
        return False                      # never swallow exceptions


class _NullRequest:
    """Shared no-op request handle (disabled ``TailSampler``)."""

    __slots__ = ()
    trace_id = 0
    retained = False
    reason = ""

    def set_key(self, key):
        """No-op."""

    def flag(self, reason):
        """No-op."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_REQUEST = _NullRequest()


class TailSampler:
    """Tail-based trace retention: record everything, keep the tail.

    Every ``request(...)`` gets a shallow ``RequestTrace`` (cheap, no
    device barriers). On close, the trace is **retained** only when:

    * ``slow`` — its key lands above the ``quantile`` of all *past*
      request keys (a reservoir of the slowest tail; keys default to
      wall duration, the serving layer uses deadline-relative lateness);
    * ``error`` — the block raised;
    * ``flagged`` — something called ``handle.flag(...)`` (quality
      monitors wire their drift callbacks here);
    * ``sampled`` — a seeded coin (``sample_rate``) kept it as a
      baseline exemplar of normal traffic.

    Determinism: the slow threshold is computed from past observations
    *before* the new key is recorded, trace ids are a per-sampler
    monotone counter, and the coin is a seeded ``default_rng`` — a
    replayed workload makes identical retention decisions
    (``tests/test_torch_serve.py`` holds it). Retained traces live in an
    LRU capped at ``max_retained``; ``flight.requests`` /
    ``flight.retained`` counters land in the registry.
    """

    def __init__(self, quantile: float = 0.95, max_retained: int = 32,
                 min_count: int = 20, sample_rate: float = 0.0,
                 seed: int = 0, registry=None, enabled: bool = True):
        if not 0.0 < quantile < 1.0:
            raise ValueError(f"quantile must be in (0,1), got {quantile}")
        self.enabled = enabled
        self.quantile = float(quantile)
        self.max_retained = int(max_retained)
        self.min_count = int(min_count)
        self.sample_rate = float(sample_rate)
        self._rng = np.random.default_rng(seed)
        # past request keys; keys can be negative (early vs deadline) —
        # those clamp into bucket 0, which only sharpens the tail.
        self._keys = Histogram("flight.request_key",
                               HistogramSpec(lo=1e-6, hi=1e4))
        self.retained: "OrderedDict[int, dict]" = OrderedDict()
        self._id = 0
        reg = registry if registry is not None else default_registry()
        self._c_requests = reg.counter("flight.requests")
        self._c_retained = reg.counter("flight.retained")

    def _next_id(self) -> int:
        self._id += 1
        return self._id

    def request(self, op: str, **attrs):
        """Open a sampled request block: ``with sampler.request("search")
        as rq:``. See ``_Request`` for the handle API. A sampler built
        with ``enabled=False`` returns a shared no-op handle (no
        request trace, no retention, no counters) — the off switch the
        service measures its overhead against."""
        if not self.enabled:
            return _NULL_REQUEST
        return _Request(self, op, dict(attrs))

    def threshold(self) -> float:
        """Current slow-tail key threshold (inf during warmup)."""
        if self._keys.count < self.min_count:
            return float("inf")
        return self._keys.percentile(self.quantile)

    def _finish(self, rq: _Request, dur: float, exc_type):
        key = rq.key if rq.key is not None else dur
        if exc_type is not None:
            reason = "error"
            rq.attrs["error"] = exc_type.__name__
        elif rq._flags:
            reason = "flagged:" + ",".join(rq._flags)
        elif key >= self.threshold():
            reason = "slow"
        elif self.sample_rate > 0.0 and \
                self._rng.random() < self.sample_rate:
            reason = "sampled"
        else:
            reason = ""
        self._keys.observe(key)           # after the decision: past-only
        self._c_requests.inc()
        if reason:
            self._retain(rq, reason, key, dur)
        rq.retained = bool(reason)
        rq.reason = reason

    def _retain(self, rq: _Request, reason: str, key: float, dur: float):
        self.retained[rq.trace_id] = {
            "trace_id": rq.trace_id, "op": rq.op, "reason": reason,
            "key": key, "dur": dur, "attrs": rq.attrs,
            "events": rq.trace.events}
        self._c_retained.inc()
        while len(self.retained) > self.max_retained:
            self.retained.popitem(last=False)

    def retained_traces(self) -> list:
        """Retained trace records, oldest first — what an incident
        bundle captures and ``obs.export`` links exemplars against."""
        return list(self.retained.values())
