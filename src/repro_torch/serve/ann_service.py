"""Microbatching front end for the ANN engines (the serving layer).

Counterpart of ``repro/serve/ann_service.py``. Single queries arrive by
``submit`` (a ticket comes back); ``flush`` pads the pending queue up to
the next bucket size and runs ONE batched engine search per bucket-shaped
batch, so the kernels only ever see a handful of batch shapes; ``warmup``
runs every bucket once, and with ``autotune_warmup=True`` first tunes the
search kernels' launch knobs on the card at the corpus's shape
(``kernels.autotune.tune_search_ops``).

Two engine flavours plug in unchanged: the immutable ``ann.AnnEngine``
and the mutable ``index.MutableAnnEngine``; over a mutable engine the
service also exposes ``add``/``bulk_load``/``delete``/``upsert``/
``compact``, which interleave with queries.

Result cache: an LRU keyed on the query's packed code words (vectors
that code identically share an entry) plus every search knob. Entries
are valid for one engine ``generation``: any mutation bumps it, and the
next flush drops the whole cache (``serve.cache_invalidations``), so a
hit is always bit-identical to a fresh search.

Classification: ``set_classifier`` attaches a trained
``learn.PackedLinearModel``; ``classify`` codes the rows through the
engine's query coder, packs them and runs the packed-linear forward
kernel, padded to the same buckets.

Observability (``repro_torch.obs``): every endpoint reports through a
``MetricsRegistry`` (the service's own unless one is injected) under the
reference's names — latency histograms ``serve.flush_s``,
``serve.search_batch_s``, ``serve.classify_s``, ticket age
``serve.ticket_age_s``, the cache, padding, warm-up and error counters,
the ``serve.pending`` and ``serve.padding_waste`` gauges — appends one
flight event per endpoint call to a ``FlightRecorder``, and runs
``flush``/``classify`` as ``TailSampler`` requests keyed by
deadline-relative lateness (oldest ticket age minus ``cfg.deadline_s``).
Retained requests pin exemplars onto ``serve.flush_s``.
``probe_search``/``probe_classify`` run the real path with telemetry
under ``serve.probe.*``, a disabled sampler and the quality samplers
suspended.

Quality (``obs.quality``): ``quality=True | QualityConfig |
QualityMonitors`` attaches one bundle to the engine (the budgeted
collision audit of every search; a mutable engine's deletes keep the
shadow reservoir tombstone-aware) and to the service: ``add``,
``bulk_load`` and ``upsert`` offer their rows to the reservoir, a
sampled flush runs one shadow recall check of a real query, a sampled
``classify`` feeds the margin series, and a drift alarm flags the
in-flight request's trace for retention and, when an
``IncidentManager`` is attached (``incidents``: a directory string or a
manager), dumps an incident bundle; endpoint errors in ``flush`` and
``classify`` are captured as bundles too.

Closed-loop health: ``slo=True`` (or an injected ``obs.SloEngine``)
registers the default ``SloSpec``s per endpoint — latency against
``cfg.deadline_s`` over ``serve.flush_s``/``serve.classify_s``,
availability from the ``serve.*_errors`` counters, and a search quality
SLO fed by each shadow recall check and by canary verdicts — and ticks
the engine after every flush and classify (self-limited to its
resolution). Burn-rate alarms ride the drift wiring (flag the in-flight
trace, dump an incident bundle carrying the SLO state);
``service.slo.health()`` is the admission-control verdict.
``resources=True`` attaches an ``obs.ResourceMonitor`` that tracks the
engine's store bytes; ``warmup`` ends by pinning its compile baseline
and arming the SLO's recompile ledger (``mark_steady``), so a kernel
built after warm-up burns the never-recompile budget.
``obs.CanaryProber`` replays known-answer rows through
``probe_search``/``probe_classify``.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
from types import MappingProxyType

import numpy as np
import torch

from repro_torch.ann.engine import SearchConfig
from repro_torch.core import packing as _packing
from repro_torch.kernels import ops as _ops
from repro_torch.obs import (IncidentManager, MetricsRegistry,
                             ResourceMonitor, SloEngine, SloSpec,
                             TailSampler, default_flight_recorder, span)

__all__ = ["AnnServiceConfig", "AnnService"]

#: shared no-op sampler for probe traffic: probes never occupy the
#: retained-trace budget nor move the slow-tail threshold
_PROBE_SAMPLER = TailSampler(enabled=False)


@dataclass(frozen=True)
class AnnServiceConfig:
    """Static service knobs."""
    top_k: int = 10
    mode: str = "exact"            # exact | lsh
    min_bands: int = 1
    n_probes: int = 0
    buckets: tuple = (1, 8, 64, 256)   # padded batch shapes (ascending)
    cache_size: int = 256          # LRU result entries (0 disables)
    impl: str = "auto"
    scored: bool = False           # LUT-scored ranking (repro_torch.rank)
    rerank_m: int = 0              # scored: coarse candidates (0 = auto)
    fused: bool = True             # single-pass fused scored kernel
    table_dtype: str = "auto"      # auto | f32 | bf16 | int8 (fused only)
    autotune_warmup: bool = False  # warmup also tunes the kernels' knobs
    deadline_s: float = 0.050      # per-flush SLO; lateness keys the tail


@dataclass
class AnnService:
    """Queue + pad-to-bucket batching + result LRU over a shared engine;
    optionally also a classification endpoint over the same codes."""
    engine: object
    cfg: AnnServiceConfig = field(default_factory=AnnServiceConfig)
    classifier: object = None     # learn.PackedLinearModel (optional)
    registry: object = None       # obs.MetricsRegistry (own one if None)
    quality: object = None        # True | QualityConfig | QualityMonitors
    flight: object = None         # obs.FlightRecorder (global if None)
    sampler: object = None        # obs.TailSampler (own one if None)
    incidents: object = None      # obs.IncidentManager | directory str
    slo: object = None            # True | obs.SloEngine
    resources: object = None      # True | obs.ResourceMonitor

    def __post_init__(self):
        self._device = self.engine.sketcher.device
        self._queue = []          # [(ticket, vector [D])]
        self._results = {}        # ticket -> (ids [top_k], rho [top_k])
        self._next_ticket = 0
        self._submit_ts = {}      # ticket -> submit time (ticket age)
        self._cache = OrderedDict()   # key -> (ids np, rho np)
        self._cache_gen = None
        if self.registry is None:
            self.registry = MetricsRegistry(enabled=True)
        reg = self.registry
        self._c_queries = reg.counter("serve.queries")
        self._c_batches = reg.counter("serve.batches")
        self._c_padded = reg.counter("serve.padded_rows")
        self._c_hits = reg.counter("serve.cache_hits")
        self._c_misses = reg.counter("serve.cache_misses")
        self._c_evict = reg.counter("serve.cache_evictions")
        self._c_inval = reg.counter("serve.cache_invalidations")
        self._c_warm = reg.counter("serve.warmup_compiles")
        self._c_classified = reg.counter("serve.classified_rows")
        self._c_flush_err = reg.counter("serve.flush_errors")
        self._c_classify_err = reg.counter("serve.classify_errors")
        self._h_flush = reg.histogram("serve.flush_s")
        self._h_batch = reg.histogram("serve.search_batch_s")
        self._h_age = reg.histogram("serve.ticket_age_s")
        self._h_classify = reg.histogram("serve.classify_s")
        self._g_pending = reg.gauge("serve.pending")
        self._g_waste = reg.gauge("serve.padding_waste")
        if self.flight is None:
            self.flight = default_flight_recorder()
        if self.sampler is None:
            self.sampler = TailSampler(registry=reg)
        if isinstance(self.incidents, str):
            self.incidents = IncidentManager(
                self.incidents, flight=self.flight, sampler=self.sampler,
                registry=reg, generation_fn=lambda: getattr(
                    self.engine, "generation", 0))
        self._drift_flags = []    # series that alarmed since last request
        if self.quality is not None:
            from repro_torch.obs.quality import QualityConfig, QualityMonitors
            if self.quality is True:
                self.quality = QualityConfig()
            if isinstance(self.quality, QualityConfig):
                self.quality = QualityMonitors(
                    self.engine.sketcher, self.quality, registry=reg)
            # the engine hook samples searches; mutable engines also
            # subscribe the shadow reservoir to store delete events
            if getattr(self.engine, "quality", None) is not self.quality:
                self.engine.attach_quality(self.quality)
            # drift alarms flag the in-flight request for trace
            # retention and (when wired) dump an incident bundle
            self.quality.on_drift(self._on_drift)
            if self.incidents is not None and \
                    getattr(self.incidents, "quality", None) is None:
                self.incidents.quality = self.quality
        if self.resources is True:
            self.resources = ResourceMonitor(registry=reg)
        if self.resources is not None:
            store = getattr(self.engine, "store", None)
            if store is not None and hasattr(store, "nbytes"):
                self.resources.track("engine.store", store)
        if self.slo is True:
            self.slo = SloEngine(registry=reg)
        if self.slo is not None:
            # default endpoint objectives: latency against the flush
            # deadline, availability from the error counters, quality
            # fed by shadow recall (floor 0.8) and probe verdicts
            if "search" not in self.slo.specs:
                self.slo.add(SloSpec(
                    "search", latency_hist="serve.flush_s",
                    latency_target_s=self.cfg.deadline_s,
                    error_counter="serve.flush_errors",
                    quality_min=0.8))
            if "classify" not in self.slo.specs:
                self.slo.add(SloSpec(
                    "classify", latency_hist="serve.classify_s",
                    latency_target_s=self.cfg.deadline_s,
                    error_counter="serve.classify_errors"))
            if self.resources is not None:
                self.slo.attach_resources(self.resources)
            # burn-rate alarms ride the drift wiring: flag the in-flight
            # trace for retention and dump an incident bundle
            self.slo.subscribe(self._on_drift)
            if self.incidents is not None and \
                    getattr(self.incidents, "slo", None) is None:
                self.incidents.slo = self.slo

    def _on_drift(self, series: str, value: float, detector):
        self._drift_flags.append(series)
        if self.incidents is not None:
            self.incidents.on_drift(series, value, detector)

    @property
    def stats(self):
        """Read-only view of the endpoint counters."""
        return MappingProxyType({
            "queries": self._c_queries.value,
            "batches": self._c_batches.value,
            "padded_rows": self._c_padded.value,
            "cache_hits": self._c_hits.value,
            "cache_misses": self._c_misses.value,
            "cache_evictions": self._c_evict.value,
            "cache_invalidations": self._c_inval.value,
            "warmup_compiles": self._c_warm.value,
        })

    # -- request path --------------------------------------------------------
    def submit(self, x) -> int:
        """Enqueue one query vector [D] (a tensor or an array, sent to the
        engine's device); returns a ticket for ``result``."""
        x = torch.as_tensor(x, device=self._device).to(torch.float32)
        if x.dim() != 1:
            raise ValueError(f"submit takes a single vector, got "
                             f"{tuple(x.shape)}")
        t = self._next_ticket
        self._next_ticket += 1
        self._queue.append((t, x))
        self._submit_ts[t] = time.perf_counter()
        self._g_pending.set(len(self._queue))
        return t

    def result(self, ticket: int):
        """(ids, rho) numpy rows for a flushed ticket; KeyError if not
        flushed yet."""
        return self._results[ticket]

    def pending(self) -> int:
        return len(self._queue)

    # -- mutation endpoints (mutable engines only) ---------------------------
    def _mutable(self):
        if not getattr(self.engine, "mutable", False):
            raise TypeError("engine is immutable (ann.AnnEngine); build "
                            "the service over index.MutableAnnEngine for "
                            "add/delete/upsert")
        return self.engine

    def _mut_event(self, op: str, t0: float, batch: int = 0,
                   outcome: str = "ok"):
        """One flight event for a mutation endpoint (generation read
        after the mutation, so the event carries the new one)."""
        self.flight.record(op, t0, time.perf_counter(), batch=batch,
                           generation=getattr(self.engine,
                                              "generation", 0),
                           outcome=outcome)

    def add(self, x, ids=None):
        """Ingest vectors [m, D]; returns their external ids. The result
        cache invalidates on the next flush (generation bump)."""
        t0 = time.perf_counter()
        out = self._mutable().add(x, ids=ids)
        if self.quality is not None:
            self.quality.offer_rows(out, x)
        self._mut_event("serve.add", t0, batch=len(np.asarray(out)))
        return out

    def bulk_load(self, x, ids=None, chunk_rows: int = 2048):
        """Stream a whole corpus (dense [m, D] or ``encode.CsrMatrix``)
        into the index through the ingest pipeline (chunked encode to
        packed words, tail appends). Returns the external ids int64 [m];
        the result cache invalidates on the next flush."""
        t0 = time.perf_counter()
        out = self._mutable().ingest(x, ids=ids, chunk_rows=chunk_rows,
                                     impl=self.cfg.impl)
        if self.quality is not None:
            self.quality.offer_rows(out, x)
        self._mut_event("serve.bulk_load", t0, batch=len(np.asarray(out)))
        return out

    def delete(self, ids, strict: bool = True) -> int:
        """Tombstone external ids; returns the rows killed. The quality
        bundle's shadow reservoir (if attached) drops them through the
        store's delete listener."""
        t0 = time.perf_counter()
        n = self._mutable().delete(ids, strict=strict)
        self._mut_event("serve.delete", t0, batch=int(n))
        return n

    def upsert(self, ids, x):
        """Replace or insert vectors under stable external ids."""
        t0 = time.perf_counter()
        out = self._mutable().upsert(ids, x)
        if self.quality is not None:
            self.quality.offer_rows(out, x)
        self._mut_event("serve.upsert", t0, batch=len(np.asarray(out)))
        return out

    def compact(self, *args, **kwargs) -> dict:
        """Compact the segment log; returns the compaction report."""
        t0 = time.perf_counter()
        out = self._mutable().compact(*args, **kwargs)
        self._mut_event("serve.compact", t0,
                        batch=int(out.get("rows_dropped", 0)))
        return out

    # -- classification endpoint ---------------------------------------------
    def set_classifier(self, model) -> "AnnService":
        """Attach a trained ``learn.PackedLinearModel`` (k/bits must match
        the engine's store); returns self for chaining."""
        store = self.engine.store
        if (model.fspec.k, model.fspec.bits) != (store.k, store.bits):
            raise ValueError(
                f"classifier k/bits {(model.fspec.k, model.fspec.bits)} "
                f"!= store {(store.k, store.bits)}")
        self.classifier = model
        return self

    def _pad_rows(self, x: torch.Tensor, b: int) -> torch.Tensor:
        n = x.shape[0]
        return x if b <= n else torch.nn.functional.pad(x, (0, 0, 0, b - n))

    def classify(self, x):
        """Classify vectors x [m, D] -> (labels int numpy [m], margins
        float32 numpy [C, m]) through the engine's query coder, the
        packing kernel and the packed-linear forward kernel; requires
        ``set_classifier``. Rows go in slices of at most the largest
        bucket, each padded up to a bucket shape."""
        if self.classifier is None:
            raise TypeError("no classifier attached; call "
                            "set_classifier(model) first")
        x = torch.as_tensor(x, device=self._device).to(torch.float32)
        if x.dim() != 2:
            raise ValueError(f"classify takes a batch [m, D], got "
                             f"{tuple(x.shape)}")
        t0 = time.perf_counter()
        with self.sampler.request("classify", rows=int(x.shape[0])) as rq:
            with span("serve.classify", rows=int(x.shape[0])) as sp:
                try:
                    preds, margs = [], []
                    max_b = self.cfg.buckets[-1]
                    for lo in range(0, x.shape[0], max_b):
                        sub = x[lo:lo + max_b]
                        n = sub.shape[0]
                        sub = self._pad_rows(sub, self._bucket_for(n))
                        codes = self.engine.encode_queries(
                            sub, impl=self.cfg.impl)
                        words = _ops.pack_codes(
                            codes, self.engine.store.bits,
                            impl=self.cfg.impl)
                        m = self.classifier.margins(
                            words, impl=self.cfg.impl)
                        preds.append(self.classifier.predict_from_margins(
                            m).cpu().numpy()[:n])
                        margs.append(sp.sync(m).cpu().numpy()[:, :n])
                    self._c_classified.inc(int(x.shape[0]))
                except Exception as e:
                    self._c_classify_err.inc()
                    if self.incidents is not None:
                        self.incidents.capture(
                            "error", f"classify: {type(e).__name__}: {e}")
                    raise
        t1 = time.perf_counter()
        self._h_classify.observe(t1 - t0)
        self.flight.record("serve.classify", t0, t1,
                           batch=int(x.shape[0]),
                           generation=self._cache_gen or 0,
                           trace_id=rq.trace_id, synced=True)
        if rq.retained:
            self._h_classify.exemplar(t1 - t0, rq.trace_id)
        labels, margins = np.concatenate(preds), np.concatenate(margs, axis=1)
        qm = self.quality
        if qm is not None and qm.sample():
            qm.observe_margins(margins)     # calibration drift series
        if self.slo is not None:
            self.slo.tick()
        return labels, margins

    # -- batch execution -----------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.cfg.buckets:
            if n <= b:
                return b
        return self.cfg.buckets[-1]

    def _cache_key(self, word_row: np.ndarray):
        """Result-cache key: the query's packed code words + every knob
        that changes the search result (scored included, so count-ranked
        and score-ranked results never alias)."""
        cfg = self.cfg
        return (word_row.tobytes(), cfg.top_k, cfg.mode, cfg.min_bands,
                cfg.n_probes, cfg.scored, cfg.rerank_m, cfg.fused,
                cfg.table_dtype)

    def _sync_cache_generation(self):
        gen = getattr(self.engine, "generation", 0)
        if gen != self._cache_gen:
            if self._cache_gen is not None and self._cache:
                self._c_inval.inc()
            self._cache.clear()
            self._cache_gen = gen

    def flush(self):
        """Run every pending query; returns {ticket: (ids, rho)}.

        Queries are taken in arrival order, in slices of at most the
        largest bucket; cache hits are served on the host and only misses
        are padded up to a bucket shape and searched. The flush is one
        tail-sampled request, retained when its oldest ticket's lateness
        against ``cfg.deadline_s`` lands in the slow tail, when it
        raises, or when a quality monitor flagged drift since the last
        request. An error is also captured as an incident bundle when an
        ``IncidentManager`` is wired."""
        t_flush = time.perf_counter()
        with self.sampler.request("search",
                                  pending=len(self._queue)) as rq:
            with span("serve.flush", pending=len(self._queue)) as sp:
                try:
                    out = self._flush(sp, rq)
                except Exception as e:
                    self._c_flush_err.inc()
                    if self.incidents is not None:
                        self.incidents.capture(
                            "error", f"flush: {type(e).__name__}: {e}")
                    raise
            if self._drift_flags:
                for s in self._drift_flags:
                    rq.flag(s)
                self._drift_flags = []
        dur = time.perf_counter() - t_flush
        self._h_flush.observe(dur)
        if rq.retained:
            self._h_flush.exemplar(dur, rq.trace_id)
        self._g_pending.set(len(self._queue))
        if self.slo is not None:
            self.slo.tick()
        return out

    # -- canary-probe endpoints ----------------------------------------------
    @contextmanager
    def _probe_context(self):
        """Run one probe through the real endpoint code with its telemetry
        segregated: every per-request metric is swapped for a
        ``serve.probe.*`` twin, the tail sampler for a disabled one (a
        probe never takes trace budget or moves the tail threshold), and
        quality sampling is suspended at the service and at the engine's
        hook (a probe advances no seeded sampling stream and skews no
        collision statistic). The result cache and engine path are
        untouched: a probe exercises exactly what user traffic
        exercises."""
        reg = self.registry
        saved = (self._h_flush, self._h_batch, self._h_age,
                 self._h_classify, self._c_queries, self._c_hits,
                 self._c_misses, self._c_batches, self._c_padded,
                 self._c_classified, self._c_flush_err,
                 self._c_classify_err, self._g_waste, self.sampler,
                 self.quality)
        eng_quality = getattr(self.engine, "quality", None)
        self._h_flush = reg.histogram("serve.probe.flush_s")
        self._h_batch = reg.histogram("serve.probe.search_batch_s")
        self._h_age = reg.histogram("serve.probe.ticket_age_s")
        self._h_classify = reg.histogram("serve.probe.classify_s")
        self._c_queries = reg.counter("serve.probe.queries")
        self._c_hits = reg.counter("serve.probe.cache_hits")
        self._c_misses = reg.counter("serve.probe.cache_misses")
        self._c_batches = reg.counter("serve.probe.batches")
        self._c_padded = reg.counter("serve.probe.padded_rows")
        self._c_classified = reg.counter("serve.probe.classified_rows")
        self._c_flush_err = reg.counter("serve.probe.flush_errors")
        self._c_classify_err = reg.counter("serve.probe.classify_errors")
        self._g_waste = reg.gauge("serve.probe.padding_waste")
        self.sampler = _PROBE_SAMPLER
        self.quality = None
        if eng_quality is not None:      # the engine's collision hook
            self.engine.quality = None
        try:
            yield
        finally:
            (self._h_flush, self._h_batch, self._h_age,
             self._h_classify, self._c_queries, self._c_hits,
             self._c_misses, self._c_batches, self._c_padded,
             self._c_classified, self._c_flush_err,
             self._c_classify_err, self._g_waste, self.sampler,
             self.quality) = saved
            if eng_quality is not None:
                self.engine.quality = eng_quality

    def probe_search(self, x):
        """Known-answer canary search of ONE vector [D]; returns (ids,
        rho). The real submit -> flush path runs (bucket padding, result
        cache, engine search) with the probe invisible to user-facing
        metrics and the tail sampler."""
        x = torch.as_tensor(x, device=self._device).to(torch.float32)
        if x.dim() != 1:
            raise ValueError(f"probe_search takes one vector, got "
                             f"{tuple(x.shape)}")
        saved_queue, self._queue = self._queue, []
        t0 = time.perf_counter()
        outcome = "error"
        t = None
        try:
            with self._probe_context():
                t = self.submit(x)
                out = self.flush()
            outcome = "ok"
            return out[t]
        finally:
            if t is not None:
                self._results.pop(t, None)
                self._submit_ts.pop(t, None)
            self._queue = saved_queue
            self._g_pending.set(len(self._queue))
            self.flight.record("serve.probe", t0, time.perf_counter(),
                               batch=1, generation=self._cache_gen or 0,
                               outcome=outcome)

    def probe_classify(self, x):
        """Canary classify of a batch [m, D] through the real ``classify``
        path with probe-segregated telemetry; returns (labels,
        margins)."""
        t0 = time.perf_counter()
        outcome = "ok"
        try:
            with self._probe_context():
                return self.classify(x)
        except Exception:
            outcome = "error"
            raise
        finally:
            self.flight.record("serve.probe_classify", t0,
                               time.perf_counter(),
                               batch=len(x),
                               generation=self._cache_gen or 0,
                               outcome=outcome)

    def _search_config(self, chunk_q: int) -> SearchConfig:
        cfg = self.cfg
        return SearchConfig(top_k=cfg.top_k, mode=cfg.mode,
                            min_bands=cfg.min_bands, n_probes=cfg.n_probes,
                            chunk_q=chunk_q, impl=cfg.impl,
                            scored=cfg.scored, rerank_m=cfg.rerank_m,
                            fused=cfg.fused, table_dtype=cfg.table_dtype)

    def _flush(self, sp, rq=None):
        out = {}
        cfg = self.cfg
        self._sync_cache_generation()
        max_b = cfg.buckets[-1]
        max_age = 0.0
        trace_id = rq.trace_id if rq is not None else 0
        while self._queue:
            batch = self._queue[:max_b]
            self._queue = self._queue[max_b:]
            n = len(batch)
            # pad to the bucket before any device work, so every stage
            # (encode included) only ever sees bucket shapes
            b = self._bucket_for(n)
            x = self._pad_rows(torch.stack([v for _, v in batch]), b)
            q_codes = self.engine.encode_queries(x, impl=cfg.impl)
            qm = self.quality
            if qm is not None and qm.sample():
                # budgeted shadow check of one real (unpadded) query:
                # exact-cosine ground truth vs the coded ranking over the
                # reservoir (obs.shadow)
                qi = int(qm.rng.integers(n))
                r = qm.shadow_check(batch[qi][1],
                                    self.engine.encode_queries,
                                    q_codes=q_codes[qi])
                if r is not None and self.slo is not None:
                    # shadow recall is the quality SLO's ground truth
                    self.slo.observe_quality("search", r)
            res = [None] * n
            miss = list(range(n))
            keys = None
            if cfg.cache_size:
                words = _packing.pack_codes(
                    q_codes[:n], self.engine.store.bits).cpu().numpy()
                keys = [self._cache_key(words[i]) for i in range(n)]
                miss = []
                for i, key in enumerate(keys):
                    hit = self._cache.get(key)
                    if hit is not None:
                        self._cache.move_to_end(key)
                        res[i] = hit
                    else:
                        miss.append(i)
            if miss:
                if len(miss) == n:
                    sub, b2 = q_codes, b          # already bucket-shaped
                else:
                    # gather with a bucket-shaped index list (row 0
                    # repeated as filler)
                    b2 = self._bucket_for(len(miss))
                    idx = miss + [0] * (b2 - len(miss))
                    sub = q_codes[torch.tensor(idx, device=q_codes.device)]
                t_batch = time.perf_counter()
                ids, rho = self.engine.search_codes(
                    sub, self._search_config(b2))
                # the host copy is the device sync for this batch's timing
                ids = sp.sync(ids).cpu().numpy()
                rho = rho.cpu().numpy()
                t_done = time.perf_counter()
                self._h_batch.observe(t_done - t_batch)
                self.flight.record(
                    "serve.search", t_batch, t_done,
                    t_queue=min(self._submit_ts.get(t, t_batch)
                                for t, _ in batch),
                    batch=b2, cache_hits=n - len(miss),
                    generation=self._cache_gen or 0,
                    trace_id=trace_id, synced=True)
                for j, i in enumerate(miss):
                    res[i] = (ids[j], rho[j])
                    if cfg.cache_size:
                        self._cache[keys[i]] = res[i]
                        while len(self._cache) > cfg.cache_size:
                            self._cache.popitem(last=False)
                            self._c_evict.inc()
                self._c_batches.inc()
                self._c_padded.inc(b2 - len(miss))
                self._g_waste.set((b2 - len(miss)) / b2)
            now = time.perf_counter()
            for (t, _), r in zip(batch, res):
                self._results[t] = r
                out[t] = r
                t0 = self._submit_ts.pop(t, None)
                if t0 is not None:
                    age = now - t0
                    self._h_age.observe(age)
                    if age > max_age:
                        max_age = age
            self._c_queries.inc(n)
            self._c_hits.inc(n - len(miss))
            self._c_misses.inc(len(miss))
        if rq is not None:
            # deadline-relative lateness keys the slow-tail reservoir
            rq.set_key(max_age - cfg.deadline_s)
        return out

    def warmup(self, d: int):
        """Run every bucket shape once (cold-start insurance: the kernels
        build and the caches fill before the first real query).

        With ``autotune_warmup=True`` this first sweeps the search
        kernels' launch knobs at the engine's corpus shape
        (``kernels.autotune.tune_search_ops``), so the buckets below
        already pick up tuned knobs; without a card the sweep is a
        no-op."""
        cfg = self.cfg
        if cfg.autotune_warmup:
            from repro_torch.kernels import autotune as _autotune
            store = self.engine.store
            dtype = {"auto": "float32", "f32": "float32",
                     "bf16": "bfloat16", "int8": "int8"}.get(
                         cfg.table_dtype, "float32")
            # CodeStore carries its rows in ``n``; SegmentLogStore in
            # ``n_rows`` (both carry ``n_words``)
            n_rows = int(getattr(store, "n", 0)
                         or getattr(store, "n_rows", 0) or 0)
            w = store.n_words
            _autotune.tune_search_ops(
                n=max(n_rows, 1), w=w, bits=store.bits,
                k=self.engine.sketcher.cfg.k, q=cfg.buckets[-1],
                top_k=cfg.top_k, table_dtype=dtype, device=self._device)
        with span("serve.warmup", buckets=len(cfg.buckets)) as sp:
            for b in cfg.buckets:
                sp.sync(self.engine.search(
                    torch.zeros((b, d), device=self._device), cfg.top_k,
                    mode=cfg.mode, min_bands=cfg.min_bands,
                    n_probes=cfg.n_probes, chunk_q=b, impl=cfg.impl,
                    scored=cfg.scored, rerank_m=cfg.rerank_m,
                    fused=cfg.fused, table_dtype=cfg.table_dtype))
                self._c_warm.inc()
        # warm-up builds are free; a compile after this burns the
        # never-recompile budget (obs.resources, obs.slo)
        if self.resources is not None:
            self.resources.mark()
        if self.slo is not None:
            self.slo.mark_steady()
        return self
