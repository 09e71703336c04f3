"""Mutable ANN engine: batched search over the segment log.

Counterpart of ``repro/index/engine.py:55-313``. The query path is the
immutable engine's (``ann.engine.QueryCoder``, ``SearchConfig``,
``run_chunked``); the corpus is a ``SegmentLogStore``. Each segment is
searched on its own, with its validity bitmask:

``exact``      the masked top-k kernel (``ops.packed_topk_masked``);
scored fused   the masked fused kernel (``ops.fused_scored_topk_masked``)
               with f32, bf16 or int8 tables;
two-stage      the masked top-k at top-m, then the LUT re-rank
               (``ann.engine.lut_rerank_stage``);
``lsh``        the all-pairs counts kernel, the band filter and the
               live mask in plain PyTorch, a stable top-k (scored: then
               the LUT re-rank), as ``ann.engine`` does it.

Rows become external ids, and the per-segment lists are merged by
``ann.engine.merge_topk`` in log order. Count-ranked results therefore
equal one search over a fresh ``AnnEngine`` of ``live_words()``, ids
mapped through ``live_ids()``. Scored search takes its coarse top-m per
segment, as the reference does, so it equals the fresh engine only when
m covers every segment's live rows.

Each segment's search runs under ``search.fused``, or ``search.coarse``
and ``search.rerank``, spans (synced only under a deep ``obs.Tracer``),
and each search appends an ``index.search`` flight event and, with
quality monitors attached (``attach_quality``), offers its results to
the budgeted collision audit.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.ann.bands import BandSpec, probe_hashes
from repro_torch.ann.engine import (QueryCoder, SearchConfig,
                                    _coarse_band_scores, lut_rerank_stage,
                                    merge_topk, resolve_query_tables,
                                    rho_counts, rho_scored, run_chunked)
from repro_torch.core import packing as _packing
from repro_torch.core.sketch import CodedRandomProjection
from repro_torch.index.compaction import CompactionPolicy, compact
from repro_torch.index.segment_log import Segment, SegmentLogStore
from repro_torch.index.snapshot import restore_index, save_index
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import ref as _ref
from repro_torch.obs import default_flight_recorder, deep_tracing_active, span
from repro_torch.rank.tables import RankTables, build_rank_tables

__all__ = ["MutableAnnEngine"]


class MutableAnnEngine:
    """Mutable index: add, delete, upsert, compact, snapshot, and batched
    search. It runs on the sketcher's device (the card unless the
    sketcher was made with ``device="cpu"``).

    Returned ids are external item ids (stable across upserts, seals,
    compaction and restarts), not rows. ``generation`` increments on
    every mutation.
    """

    mutable = True

    def __init__(self, sketcher: CodedRandomProjection, *,
                 band_spec: BandSpec = BandSpec(), tail_rows: int = 1024,
                 impl: str = "auto", store: SegmentLogStore = None,
                 rank_tables: RankTables = None):
        self.sketcher = sketcher
        self._rank_tables = rank_tables
        if store is None:
            store = SegmentLogStore(sketcher.cfg.k, sketcher.spec.bits,
                                    band_spec=band_spec,
                                    tail_rows=tail_rows, impl=impl,
                                    device=sketcher.device)
        if (store.k, store.bits) != (sketcher.cfg.k, sketcher.spec.bits):
            raise ValueError(
                f"store k/bits {(store.k, store.bits)} != sketcher "
                f"{(sketcher.cfg.k, sketcher.spec.bits)}")
        if store.device != sketcher.device:
            raise ValueError(f"store on {store.device}, sketcher on "
                             f"{sketcher.device}")
        self.store = store
        self.band_spec = store.band_spec
        self._coder = QueryCoder(sketcher)
        self.quality = None       # obs.quality.QualityMonitors, if attached

    # -- mutation ------------------------------------------------------------
    @property
    def generation(self) -> int:
        """Monotone mutation counter (the result-cache key)."""
        return self.store.generation

    @property
    def n(self) -> int:
        """Live (not tombstoned) rows."""
        return self.store.n_live

    @property
    def encoder(self):
        """The sketcher's shared ``StreamingEncoder`` (one R cache for
        queries, ``add`` and ``ingest``)."""
        return self._coder._encoder

    def add(self, x, ids=None) -> np.ndarray:
        """Encode vectors x [m, D] (dense or ``encode.CsrMatrix``) and
        append them (O(batch) tail write); returns the external ids int64
        [m]."""
        return self.store.add_codes(self.encoder.encode_codes(x), ids=ids)

    def add_codes(self, codes, ids=None) -> np.ndarray:
        """Append int codes [m, k]; returns the external ids int64 [m]."""
        return self.store.add_codes(codes, ids=ids)

    def add_words(self, words, ids=None) -> np.ndarray:
        """Append packed rows [m, W]; returns the external ids int64 [m]."""
        return self.store.add_words(words, ids=ids)

    def ingest(self, x, ids=None, *, chunk_rows: int = 2048,
               impl: str = "auto") -> np.ndarray:
        """Bulk-load vectors [m, D] (dense or ``encode.CsrMatrix``)
        through the encode kernels straight into the log
        (``encode.IngestPipeline``): no [m, k] codes; returns the external
        ids int64 [m]."""
        from repro_torch.encode.pipeline import IngestPipeline
        return IngestPipeline(self.encoder, self.store,
                              chunk_rows=chunk_rows, impl=impl).ingest(
                                  x, ids=ids)

    def delete(self, ids, strict: bool = True) -> int:
        """Tombstone external ids (one mask bit each); returns the rows
        killed. Unknown ids raise iff ``strict``."""
        return self.store.delete(ids, strict=strict)

    def upsert(self, ids, x) -> np.ndarray:
        """Replace or insert vectors x [m, D] (dense or
        ``encode.CsrMatrix``) under stable external ids int [m]; returns
        the ids."""
        return self.store.upsert_codes(ids, self.encoder.encode_codes(x))

    def upsert_codes(self, ids, codes) -> np.ndarray:
        """Replace or insert int codes [m, k] under stable external ids."""
        return self.store.upsert_codes(ids, codes)

    def compact(self, policy: CompactionPolicy = CompactionPolicy()) -> dict:
        """Size-tiered compaction (drops tombstones, keeps the row order);
        returns the compaction report."""
        return compact(self.store, policy)

    # -- durability ----------------------------------------------------------
    def save(self, directory: str, step: int, keep: int = 3) -> str:
        """Atomic snapshot of the store at ``directory/step_<step>``
        (keeping the ``keep`` newest); returns its path."""
        return save_index(self.store, directory, step, keep=keep)

    @classmethod
    def restore(cls, sketcher: CodedRandomProjection, directory: str,
                step: int = None) -> "MutableAnnEngine":
        """Engine over a restored store (the latest snapshot, or
        ``step``), on the sketcher's device."""
        return cls(sketcher, store=restore_index(directory, step,
                                                 device=sketcher.device))

    # -- search --------------------------------------------------------------
    @property
    def rank_tables(self) -> RankTables:
        """LUT scoring tables for scored search, built on first use from
        the sketcher's scheme and k (pass ``rank_tables`` to ``__init__``
        for others, e.g. bf16-quantized ones)."""
        if self._rank_tables is None:
            self._rank_tables = build_rank_tables(self.sketcher)
        return self._rank_tables

    def encode_queries(self, x, impl: str = "auto") -> torch.Tensor:
        """x [Q, D] (dense or ``encode.CsrMatrix``) -> int32 codes [Q, k]."""
        return self._coder.encode(x, impl=impl)

    def attach_quality(self, monitors) -> "MutableAnnEngine":
        """Attach an ``obs.quality.QualityMonitors`` bundle: every search
        gets a budgeted chance (its ``sample_rate``) of feeding one
        query's candidates to the collision monitor, and the bundle's
        shadow reservoir subscribes to the store's delete events, so its
        ground truth stays tombstone-aware. Returns self."""
        self.quality = monitors
        self.store.add_listener(monitors.on_store_event)
        return self

    def codes_for_ids(self, ids) -> np.ndarray:
        """int32 codes [m, k] of live external ids (host numpy), the small
        gather the quality audit re-scores."""
        return self.store.take_codes(ids)

    def search(self, queries, top_k: int = 10, *, mode: str = "exact",
               min_bands: int = 1, n_probes: int = 0, chunk_q: int = 256,
               impl: str = "auto", scored: bool = False,
               rerank_m: int = 0, fused: bool = True,
               table_dtype: str = "auto"):
        """queries float [Q, D] -> (external ids int32 [Q, top_k], rho_hat
        float32 [Q, top_k]); -1 marks empty slots. ``scored``, ``fused``,
        ``rerank_m`` and ``table_dtype`` as for ``AnnEngine.search``."""
        cfg = SearchConfig(top_k=top_k, mode=mode, min_bands=min_bands,
                           n_probes=n_probes, chunk_q=chunk_q, impl=impl,
                           scored=scored, rerank_m=rerank_m, fused=fused,
                           table_dtype=table_dtype)
        return self.search_codes(self.encode_queries(queries, impl=impl),
                                 cfg)

    def search_codes(self, q_codes: torch.Tensor, cfg: SearchConfig):
        """Search pre-encoded queries [Q, k] across all segments."""
        if cfg.mode not in ("exact", "lsh"):
            raise ValueError(f"unknown mode {cfg.mode!r}")
        if cfg.mode == "lsh" and self.band_spec is None:
            raise ValueError("store built without band_spec: lsh "
                             "retrieval unavailable")
        if cfg.table_dtype == "int8" and not cfg.use_fused():
            raise ValueError("table_dtype='int8' requires the fused "
                             "scored path (scored=True, fused=True, "
                             "mode='exact')")
        q = q_codes.shape[0]
        if q == 0 or self.store.n_live == 0:
            dev = self.store.device
            return (torch.full((q, cfg.top_k), -1, dtype=torch.int32,
                               device=dev),
                    torch.full((q, cfg.top_k), -1.0, dtype=torch.float32,
                               device=dev))
        t0 = time.perf_counter()
        out = run_chunked(q_codes, cfg, self._search_chunk)
        default_flight_recorder().record(
            "index.search", t0, time.perf_counter(), batch=int(q),
            generation=self.generation, outcome=cfg.mode,
            synced=deep_tracing_active())
        if self.quality is not None:
            self.quality.observe_search(q_codes, out[0], self.codes_for_ids)
        return out

    def _lsh_coarse(self, seg: Segment, q_words, qh, top: int,
                    cfg: SearchConfig):
        """One segment's LSH candidates -> (counts, rows) [c, top]: full
        collision counts, -1 for rows dead or with fewer than
        ``min_bands`` matching bands, then a stable top."""
        counts = _ops.packed_collision_counts(
            q_words, seg.words, self.store.bits, self.sketcher.cfg.k,
            impl=cfg.impl)
        keep = _coarse_band_scores(qh, seg.hashes) >= cfg.min_bands
        keep &= _packing.unpack_bitmask(seg.valid_dev(), seg.cap)[None, :]
        counts = torch.where(keep, counts, torch.full_like(counts, -1))
        return _ref.topk_stable_ref(counts, top)

    def _search_chunk(self, q_codes: torch.Tensor, cfg: SearchConfig):
        """One padded query chunk across all segments, then the merge ->
        (ids int32 [c, top_k], rho float32 [c, top_k])."""
        k, bits = self.sketcher.cfg.k, self.store.bits
        q_words = _ops.pack_codes(q_codes, bits, impl=cfg.impl)
        qh = (_packing.as_i32(probe_hashes(q_codes, self.band_spec,
                                           cfg.n_probes))
              if cfg.mode == "lsh" else None)
        # per-query tables are the same for every segment: built once
        fused = cfg.use_fused()
        q_tables = scales = None
        if fused:
            q_tables, scales = resolve_query_tables(
                self.rank_tables, q_codes, cfg.table_dtype)
        elif cfg.scored:
            q_tables = self.rank_tables.query_tables(q_codes)
        vals_l, ids_l = [], []
        # the span syncs block only under a deep tracer (profiling)
        for i, seg in enumerate(self.store.segments()):
            if seg.live == 0:
                continue
            if fused:
                m = cfg.resolve_m(seg.cap)
                with span("search.fused", segment=i, rows=seg.cap, m=m,
                          top_k=cfg.top_k) as sp:
                    vals, rows = _ops.fused_scored_topk_masked(
                        q_words, q_tables, seg.words, seg.valid_dev(), bits,
                        k, m, cfg.top_k, scales=scales, impl=cfg.impl)
                    sp.sync(vals)
            else:
                top = cfg.resolve_m(seg.cap) if cfg.scored else cfg.top_k
                with span("search.coarse", mode=cfg.mode, segment=i,
                          rows=seg.cap) as sp:
                    if cfg.mode == "exact":
                        vals, rows = _ops.packed_topk_masked(
                            q_words, seg.words, seg.valid_dev(), bits, k,
                            top, impl=cfg.impl)
                    else:
                        vals, rows = self._lsh_coarse(seg, q_words, qh, top,
                                                      cfg)
                    sp.sync(rows)
                if cfg.scored:
                    with span("search.rerank", segment=i,
                              top_k=cfg.top_k) as sp:
                        rows, vals = lut_rerank_stage(
                            self.rank_tables, q_codes, rows, seg.words,
                            cfg.top_k, impl=cfg.impl, q_tables=q_tables)
                        sp.sync(vals)
            ext = seg.ids_dev()[rows.clamp(0, seg.cap - 1).to(torch.int64)]
            ids_l.append(torch.where(rows < 0, torch.full_like(ext, -1), ext))
            vals_l.append(vals)
        vals, ids = merge_topk(vals_l, ids_l, cfg.top_k)
        if cfg.scored:
            return ids, rho_scored(self.rank_tables, ids, vals)
        return ids, rho_counts(self.sketcher, vals)
