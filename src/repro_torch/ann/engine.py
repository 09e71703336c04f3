"""Batched search over packed codes on one device.

Counterpart of ``repro/ann/engine.py:61-518``. Queries are coded by the
fused project + code kernel, packed, and matched against a ``CodeStore``
in chunks of ``chunk_q`` rows. Two candidate modes:

``exact``  the whole store: the streaming packed top-k kernel by
           collision count, or, scored, the fused kernel that LUT-scores
           the stable top-``rerank_m`` by count in one call;
``lsh``    banded candidates: rows sharing at least ``min_bands`` band
           buckets with the query (probes prefix-nested in
           ``n_probes``) are ranked by their full collision count, over
           the whole count matrix.

``scored=True`` ranks by the per-code-pair LUT scores of ``rank`` and
calibrates rho_hat from them; ``fused=False`` (and every scored LSH
search) takes the two-stage path: coarse top-m by count, then the LUT
re-rank kernel over the gathered candidates. Count-ranked rho_hat
comes from the paper's collision estimator.

``search_sharded`` is the exact search with the corpus row-sharded over
a ``DeviceMesh`` dim: every rank holds the whole store, searches its own
block of rows (the same kernels as above), and the ranks' lists are
all-gathered and merged, with ties going to the lower shard, so every
rank returns the same result.

Under a deep ``obs.Tracer`` every chunk runs under device-synced spans
(``search.chunk``, ``search.fused``, or ``search.coarse`` then
``search.rerank`` for two-stage scored search); otherwise one
submission-timed ``search.chunks`` span covers the call. Each search
appends an ``ann.search`` flight event, and with an attached
``obs.quality.QualityMonitors`` (``attach_quality``) offers its results
to the budgeted collision audit, which reads back to the host only on a
sampled call.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace

import torch

from repro_torch.ann.bands import (BandSpec, band_hashes, probe_hashes,
                                   word_band_hashes)
from repro_torch.ann.store import CodeStore
from repro_torch.core import packing as _packing
from repro_torch.core.sketch import CodedRandomProjection
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import ref as _ref
from repro_torch.obs import default_flight_recorder, deep_tracing_active, span
from repro_torch.parallel.collectives import all_gather_stack, axis_group
from repro_torch.rank.tables import RankTables, build_rank_tables

__all__ = ["SearchConfig", "AnnEngine", "QueryCoder", "merge_topk",
           "run_chunked", "lut_rerank_stage", "rho_scored", "rho_counts",
           "resolve_query_tables"]

@dataclass(frozen=True)
class SearchConfig:
    """Static knobs of one search variant."""
    top_k: int = 10
    mode: str = "exact"          # exact | lsh
    min_bands: int = 1           # lsh: matching bands required to be a candidate
    n_probes: int = 0            # lsh: multi-probe expansions per band
    chunk_q: int = 256           # query rows per device step
    impl: str = "auto"           # kernel dispatch (see kernels.ops)
    scored: bool = False         # scored search: LUT scores, calibrated rho
    rerank_m: int = 0            # scored: coarse candidates (0 = auto)
    fused: bool = True           # scored exact: one fused call (False =
    #                              coarse top-m, then the LUT re-rank)
    table_dtype: str = "auto"    # LUT storage: auto | f32 | bf16 | int8

    def resolve_m(self, n: int) -> int:
        """Coarse candidates for ``n`` rows: ``rerank_m`` (default
        max(64, 4*top_k)), never below ``top_k`` nor above ``n``."""
        m = self.rerank_m or max(64, 4 * self.top_k)
        return max(1, min(max(m, self.top_k), n))

    def use_fused(self) -> bool:
        """Scored exact search takes the fused kernel unless fused=False;
        scored LSH stays two-stage (its band filter is in the coarse
        stage)."""
        return self.scored and self.fused and self.mode == "exact"


def resolve_query_tables(tables: RankTables, q_codes: torch.Tensor,
                         table_dtype: str):
    """Per-query LUTs in the configured storage -> (tables [Q, F*P],
    scales [Q, W] or None): ``auto`` takes the bundle's dtype, ``f32``
    and ``bf16`` force one, ``int8`` gives power-of-two-scaled int8
    tables, which only the fused kernel takes."""
    if table_dtype == "int8":
        return tables.query_tables_int8(q_codes)
    named = {"auto": None, "f32": torch.float32, "bf16": torch.bfloat16}
    if table_dtype not in named:
        raise ValueError(f"unknown table_dtype {table_dtype!r}")
    return tables.query_tables(q_codes, dtype=named[table_dtype]), None


class QueryCoder:
    """Query encoder over the sketcher's shared ``StreamingEncoder``: the
    fused project + code kernel over the cached R below the residency
    cap, unit streaming above it, so a D = 3.2M index never builds
    [D, k] for its queries either."""

    def __init__(self, sketcher: CodedRandomProjection):
        self.sketcher = sketcher
        self._encoder = sketcher.stream_encoder()

    def r_matrix(self) -> torch.Tensor:
        """R [D, k] (cached); raises above the encoder's residency cap."""
        return self._encoder.r_matrix()

    def encode(self, x, impl: str = "auto") -> torch.Tensor:
        """x [Q, D] (dense or ``encode.CsrMatrix``) -> int32 codes [Q, k]."""
        return self._encoder.encode_codes(x, impl=impl)

    def encode_packed(self, x, impl: str = "auto") -> torch.Tensor:
        """x [Q, D] (dense or ``encode.CsrMatrix``) -> packed int32 words
        [Q, W] through the ingest path."""
        return self._encoder.encode_packed(x, impl=impl)


def merge_topk(vals_list, ids_list, top_k: int):
    """Merge per-part top-k lists [Q, k_part] into a global top-k.

    Parts are concatenated in list order and selected by a stable sort,
    so ties go to the earliest part and, within it, to the part's own
    order. Empty slots keep ids of -1: the sentinel value is -1 for
    integer counts and -inf for float scores.
    """
    cat_v = torch.cat(vals_list, dim=1)
    cat_i = torch.cat(ids_list, dim=1)
    if top_k > cat_v.shape[1]:
        fill = float("-inf") if cat_v.is_floating_point() else -1
        cat_v = torch.nn.functional.pad(cat_v, (0, top_k - cat_v.shape[1]),
                                        value=fill)
        cat_i = torch.nn.functional.pad(cat_i, (0, top_k - cat_i.shape[1]),
                                        value=-1)
    best_v, pos = torch.sort(cat_v, dim=1, descending=True, stable=True)
    best_v, pos = best_v[:, :top_k], pos[:, :top_k]
    best_i = torch.gather(cat_i, 1, pos)
    empty = torch.isneginf(best_v) if best_v.is_floating_point() \
        else best_v < 0
    return best_v, torch.where(empty, torch.full_like(best_i, -1), best_i)


def run_chunked(q_codes: torch.Tensor, cfg: SearchConfig, chunk_fn):
    """Pad Q up to a multiple of a power-of-two chunk (at most
    ``chunk_q``), run ``chunk_fn(chunk, cfg)`` per chunk, unpad."""
    q = q_codes.shape[0]
    chunk = min(cfg.chunk_q, 1 << (q - 1).bit_length())
    cfg = replace(cfg, chunk_q=chunk)
    pad = (-q) % chunk
    if pad:
        q_codes = torch.nn.functional.pad(q_codes, (0, 0, 0, pad))
    ids, rho = [], []
    for lo in range(0, q + pad, chunk):
        i, r = chunk_fn(q_codes[lo:lo + chunk], cfg)
        ids.append(i)
        rho.append(r)
    return torch.cat(ids)[:q], torch.cat(rho)[:q]


def lut_rerank_stage(tables: RankTables, q_codes: torch.Tensor,
                     cand_ids: torch.Tensor, words_src: torch.Tensor,
                     top_k: int, impl: str = "auto", q_tables=None):
    """Second stage of a two-stage scored search: candidate rows
    ``cand_ids`` int32 [c, M] into ``words_src`` [n, W] (-1 = empty) ->
    (rows int32 [c, top_k], -1 empty; scores float32 [c, top_k], -inf
    empty), by gathering the candidates' words and running the LUT
    re-rank kernel on the queries' tables (``q_tables`` [c, F*P] when
    given, as a loop over segments passes them, else built here)."""
    n = words_src.shape[0]
    cand = words_src[cand_ids.clamp(0, n - 1).to(torch.int64)]
    if q_tables is None:
        q_tables = tables.query_tables(q_codes)
    scores, pos = _ops.packed_lut_rerank(q_tables, cand, cand_ids >= 0,
                                         tables.bits, top_k, impl=impl)
    rows = torch.gather(cand_ids, 1,
                        pos.clamp(0, cand_ids.shape[1] - 1).to(torch.int64))
    return torch.where(pos < 0, torch.full_like(rows, -1), rows), scores


def rho_scored(tables: RankTables, ids: torch.Tensor,
               scores: torch.Tensor) -> torch.Tensor:
    """LUT scores -> calibrated rho_hat float32; empty slots (id < 0)
    give -1."""
    rho = tables.rho_from_scores(scores)
    return torch.where(ids < 0, torch.full_like(rho, -1.0), rho)


def rho_counts(sketcher: CodedRandomProjection,
               counts: torch.Tensor) -> torch.Tensor:
    """Collision counts -> rho_hat by the paper's estimator; empty slots
    (count < 0) give -1."""
    k = torch.tensor(float(sketcher.cfg.k), device=counts.device)
    rho = sketcher._estimator(counts.to(torch.float32) / k)
    return torch.where(counts < 0, torch.full_like(rho, -1.0), rho)


def _coarse_band_scores(q_probe_hashes: torch.Tensor,
                        db_hashes: torch.Tensor) -> torch.Tensor:
    """Matching-band counts: [c, P, L] vs [N, L] -> int32 [c, N]; a band
    matches when any probe hits its bucket. Each band's column of corpus
    hashes is made contiguous first, so the [c, N] comparisons stream."""
    c, p_n, l_n = q_probe_hashes.shape
    score = torch.zeros((c, db_hashes.shape[0]), dtype=torch.int32,
                        device=db_hashes.device)
    for band in range(l_n):
        col = db_hashes[:, band].contiguous()
        hit = q_probe_hashes[:, 0, band, None] == col
        for p in range(1, p_n):
            hit |= q_probe_hashes[:, p, band, None] == col
        score += hit
    return score


class AnnEngine:
    """Immutable search engine: sketcher + packed corpus + band hashes."""

    def __init__(self, sketcher: CodedRandomProjection, store: CodeStore,
                 band_spec: BandSpec = BandSpec(), db_band_hashes=None,
                 rank_tables: RankTables = None):
        if store.words.device != sketcher.device:
            raise ValueError(f"store on {store.words.device}, sketcher on "
                             f"{sketcher.device}")
        self.sketcher = sketcher
        self.store = store
        self.band_spec = band_spec.validate(sketcher.cfg.k)
        if db_band_hashes is None:
            db_band_hashes = word_band_hashes(store.words, store.bits,
                                              self.band_spec)
        self.db_band_hashes = db_band_hashes      # uint32 values, int64 [n, L]
        self._coder = QueryCoder(sketcher)
        self._rank_tables = rank_tables
        self.quality = None       # obs.quality.QualityMonitors, if attached

    # -- construction / ingestion -------------------------------------------
    @classmethod
    def build(cls, sketcher: CodedRandomProjection, corpus,
              band_spec: BandSpec = BandSpec(),
              impl: str = "auto") -> "AnnEngine":
        """Index a corpus [n, D] (dense or ``encode.CsrMatrix``): project
        and code, pack, band-hash."""
        codes = sketcher.stream_encoder().encode_codes(corpus, impl=impl)
        return cls.from_codes(sketcher, codes, band_spec, impl=impl)

    @classmethod
    def from_codes(cls, sketcher: CodedRandomProjection, codes: torch.Tensor,
                   band_spec: BandSpec = BandSpec(),
                   impl: str = "auto") -> "AnnEngine":
        """Index int32 codes [n, k]: pack + band-hash."""
        store = CodeStore.from_codes(codes, sketcher.cfg.k,
                                     sketcher.spec.bits, impl=impl)
        return cls(sketcher, store, band_spec,
                   db_band_hashes=band_hashes(codes, band_spec))

    def add(self, x, impl: str = "auto") -> "AnnEngine":
        """New engine with rows appended (ids continue from n); the rank
        tables carry across."""
        codes = self._coder.encode(x, impl=impl)
        hashes = torch.cat([self.db_band_hashes,
                            band_hashes(codes, self.band_spec)])
        new = AnnEngine(self.sketcher, self.store.add(codes, impl=impl),
                        self.band_spec, db_band_hashes=hashes,
                        rank_tables=self._rank_tables)
        new.quality = self.quality
        return new

    @property
    def n(self) -> int:
        """Corpus rows resident in the store."""
        return self.store.n

    @property
    def rank_tables(self) -> RankTables:
        """LUT scoring tables for scored search, built on first use from
        the sketcher's scheme and k (pass ``rank_tables`` to ``__init__``
        for others, e.g. bf16-quantized ones)."""
        if self._rank_tables is None:
            self._rank_tables = build_rank_tables(self.sketcher)
        return self._rank_tables

    # -- queries -------------------------------------------------------------
    def encode_queries(self, x, impl: str = "auto") -> torch.Tensor:
        """x [Q, D] (dense or ``encode.CsrMatrix``) -> int32 codes [Q, k]."""
        return self._coder.encode(x, impl=impl)

    def attach_quality(self, monitors) -> "AnnEngine":
        """Attach an ``obs.quality.QualityMonitors`` bundle: every search
        gets a budgeted chance (its ``sample_rate``) of feeding one
        query's candidates to the collision monitor. Returns self."""
        self.quality = monitors
        return self

    def codes_for_ids(self, ids) -> torch.Tensor:
        """int32 codes [m, k] of store rows ``ids`` (on the store's
        device), the small gather the quality audit re-scores."""
        words = self.store.take(torch.as_tensor(ids))
        return _packing.unpack_codes(words, self.sketcher.spec.bits,
                                     self.sketcher.cfg.k)

    def search(self, queries, top_k: int = 10, *, mode: str = "exact",
               min_bands: int = 1, n_probes: int = 0, chunk_q: int = 256,
               impl: str = "auto", scored: bool = False, rerank_m: int = 0,
               fused: bool = True, table_dtype: str = "auto"):
        """queries [Q, D] (dense or ``encode.CsrMatrix``) -> (ids int32
        [Q, top_k], rho_hat float32 [Q, top_k]); ids of -1 mark empty
        slots."""
        cfg = SearchConfig(top_k=top_k, mode=mode, min_bands=min_bands,
                           n_probes=n_probes, chunk_q=chunk_q, impl=impl,
                           scored=scored, rerank_m=rerank_m, fused=fused,
                           table_dtype=table_dtype)
        self._check(cfg)
        return self.search_codes(self.encode_queries(queries, impl=impl), cfg)

    def _check(self, cfg: SearchConfig):
        if cfg.mode not in ("exact", "lsh"):
            raise ValueError(f"unknown mode {cfg.mode!r}")
        if cfg.table_dtype == "int8" and not cfg.use_fused():
            raise ValueError("int8 tables require the fused scored exact "
                             "path (scored=True, fused=True, mode='exact')")

    def search_codes(self, q_codes: torch.Tensor, cfg: SearchConfig):
        """Search pre-encoded queries [Q, k] in chunks of ``cfg.chunk_q``
        (under spans and with an ``ann.search`` flight event, as the
        module docstring says)."""
        self._check(cfg)
        q = q_codes.shape[0]
        dev = self.store.words.device
        if q == 0 or self.store.n == 0:
            return (torch.full((q, cfg.top_k), -1, dtype=torch.int32,
                               device=dev),
                    torch.full((q, cfg.top_k), -1.0, dtype=torch.float32,
                               device=dev))
        t0 = time.perf_counter()
        deep = deep_tracing_active()
        if deep:
            out = run_chunked(q_codes, cfg, self._traced_chunk)
        else:
            body = (self._exact_chunk if cfg.mode == "exact"
                    else self._lsh_chunk)
            with span("search.chunks", sync=False, mode=cfg.mode, q=int(q),
                      scored=cfg.scored):
                out = run_chunked(q_codes, cfg,
                                  lambda chunk, c: body(chunk, cfg=c))
        default_flight_recorder().record(
            "ann.search", t0, time.perf_counter(), batch=int(q),
            outcome=cfg.mode, synced=deep)
        if self.quality is not None:
            self.quality.observe_search(q_codes, out[0], self.codes_for_ids)
        return out

    def _traced_chunk(self, chunk: torch.Tensor, cfg: SearchConfig):
        """One chunk under device-synced spans (deep tracer installed):
        ``search.chunk`` count-ranked, ``search.fused`` fused scored,
        ``search.coarse`` then ``search.rerank`` two-stage scored."""
        if not cfg.scored:
            body = (self._exact_chunk if cfg.mode == "exact"
                    else self._lsh_chunk)
            with span("search.chunk", mode=cfg.mode,
                      q=int(chunk.shape[0])) as sp:
                return sp.sync(body(chunk, cfg=cfg))
        if cfg.use_fused():
            with span("search.fused", mode=cfg.mode, q=int(chunk.shape[0]),
                      m=cfg.resolve_m(self.store.n),
                      top_k=cfg.top_k) as sp:
                return sp.sync(self._fused_chunk(chunk, cfg=cfg))
        coarse = (self._exact_coarse if cfg.mode == "exact"
                  else self._lsh_coarse)
        with span("search.coarse", mode=cfg.mode, q=int(chunk.shape[0]),
                  m=cfg.resolve_m(self.store.n)) as sp:
            _, cand_ids = sp.sync(coarse(chunk, cfg=cfg))
        with span("search.rerank", top_k=cfg.top_k) as sp:
            return sp.sync(self._rerank(chunk, cand_ids, cfg))

    def search_sharded(self, queries, mesh, axis: str = "data",
                       top_k: int = 10, impl: str = "auto",
                       scored: bool = False, rerank_m: int = 0,
                       fused: bool = True, table_dtype: str = "auto"):
        """Exact search with the corpus row-sharded over ``mesh[axis]``
        (a ``DeviceMesh`` on the store's device type; n must divide).

        queries [Q, D] -> (ids int32 [Q, top_k], rho_hat float32
        [Q, top_k]), the same on every rank. Each rank codes the queries,
        takes the top-k of its own rows by count (or, scored, LUT-scores
        its local coarse top-m, m = ``resolve_m`` of its rows: the fused
        kernel, or the two-stage re-rank with ``fused=False``), offsets
        its ids to global ones, and the ranks' lists are all-gathered and
        merged by ``merge_topk`` in rank order. At world size 1 this is
        ``search(mode="exact")`` bit for bit; above it, scored search
        picks its coarse candidates per shard and need not equal it."""
        _, rank, _ = axis_group(mesh, axis, self.store.words)
        local = self.store.shard(mesh, axis)
        q_codes = self.encode_queries(queries, impl=impl)
        cfg = SearchConfig(top_k=top_k, impl=impl, scored=scored,
                           rerank_m=rerank_m, fused=fused,
                           table_dtype=table_dtype)
        if cfg.table_dtype == "int8" and not cfg.use_fused():
            raise ValueError("table_dtype='int8' requires the fused "
                             "scored path (scored=True, fused=True)")
        q = q_codes.shape[0]
        if q == 0 or self.store.n == 0:
            dev = self.store.words.device
            return (torch.full((q, top_k), -1, dtype=torch.int32,
                               device=dev),
                    torch.full((q, top_k), -1.0, dtype=torch.float32,
                               device=dev))
        tables = self.rank_tables if scored else None
        bits, k, words = local.bits, self.sketcher.cfg.k, local.words
        m = cfg.resolve_m(local.n)

        def local_chunk(chunk, c):
            """One query chunk over this rank's rows -> (values, local
            ids): counts, or scores with -inf empty."""
            qw = _ops.pack_codes(chunk, bits, impl=impl)
            if not scored:
                return _ops.packed_topk(qw, words, bits, k, top_k,
                                        impl=impl)
            if c.use_fused():
                q_tables, scales = resolve_query_tables(tables, chunk,
                                                        c.table_dtype)
                return _ops.fused_scored_topk(qw, q_tables, words, bits, k,
                                              m, top_k, scales=scales,
                                              impl=impl)
            cvals, cids = _ops.packed_topk(qw, words, bits, k, m, impl=impl)
            cids = torch.where(cvals < 0, torch.full_like(cids, -1), cids)
            rows, scores = lut_rerank_stage(tables, chunk, cids, words,
                                            top_k, impl=impl)
            return scores, rows

        vals, ids = run_chunked(q_codes, cfg, local_chunk)
        ids = torch.where(ids < 0, torch.full_like(ids, -1),
                          ids + rank * local.n)
        vals_g = all_gather_stack(vals, mesh, axis)      # [world, Q, top_k]
        ids_g = all_gather_stack(ids, mesh, axis)
        vals, ids = merge_topk(list(vals_g), list(ids_g), top_k)
        if scored:
            return ids, rho_scored(tables, ids, vals)
        return ids, self._rho(vals)

    def _rho(self, counts: torch.Tensor) -> torch.Tensor:
        """Collision counts -> rho_hat; empty slots (count < 0) give -1."""
        return rho_counts(self.sketcher, counts)

    def _rerank(self, q_codes: torch.Tensor, cand_ids: torch.Tensor,
                cfg: SearchConfig):
        """Coarse candidate rows -> (ids, rho) by the LUT re-rank."""
        ids, scores = lut_rerank_stage(self.rank_tables, q_codes, cand_ids,
                                       self.store.words, cfg.top_k,
                                       impl=cfg.impl)
        return ids, rho_scored(self.rank_tables, ids, scores)

    def _exact_coarse(self, q_codes: torch.Tensor, *, cfg: SearchConfig):
        """One exact chunk -> (counts, ids) at top-m (scored) or top-k:
        pack the query codes, then the streaming packed top-k over the
        whole store."""
        q_words = _ops.pack_codes(q_codes, self.store.bits, impl=cfg.impl)
        top = cfg.resolve_m(self.store.n) if cfg.scored else cfg.top_k
        vals, ids = _ops.packed_topk(q_words, self.store.words,
                                     self.store.bits, self.sketcher.cfg.k,
                                     top, impl=cfg.impl)
        return vals, torch.where(vals < 0, torch.full_like(ids, -1), ids)

    def _fused_chunk(self, q_codes: torch.Tensor, *, cfg: SearchConfig):
        """One scored exact chunk through the fused kernel: the coarse
        top-m by count and the LUT re-rank in one call."""
        q_words = _ops.pack_codes(q_codes, self.store.bits, impl=cfg.impl)
        q_tables, scales = resolve_query_tables(self.rank_tables, q_codes,
                                                cfg.table_dtype)
        scores, ids = _ops.fused_scored_topk(
            q_words, q_tables, self.store.words, self.store.bits,
            self.sketcher.cfg.k, cfg.resolve_m(self.store.n), cfg.top_k,
            scales=scales, impl=cfg.impl)
        return ids, rho_scored(self.rank_tables, ids, scores)

    def _exact_chunk(self, q_codes: torch.Tensor, *, cfg: SearchConfig):
        if cfg.use_fused():
            return self._fused_chunk(q_codes, cfg=cfg)
        vals, ids = self._exact_coarse(q_codes, cfg=cfg)
        if cfg.scored:
            return self._rerank(q_codes, ids, cfg)
        return ids, self._rho(vals)

    def _lsh_coarse(self, q_codes: torch.Tensor, *, cfg: SearchConfig):
        """One lsh chunk -> (counts, ids): full collision counts, rows
        with fewer than ``min_bands`` matching bands set to -1, then a
        stable top-m (scored) or top-k."""
        q_words = _ops.pack_codes(q_codes, self.store.bits, impl=cfg.impl)
        qh = probe_hashes(q_codes, self.band_spec, cfg.n_probes)
        coarse = _coarse_band_scores(qh, self.db_band_hashes)
        counts = _ops.packed_collision_counts(
            q_words, self.store.words, self.store.bits, self.sketcher.cfg.k,
            impl=cfg.impl)
        counts = torch.where(coarse >= cfg.min_bands, counts,
                             torch.full_like(counts, -1))
        del coarse
        top = cfg.resolve_m(self.store.n) if cfg.scored else cfg.top_k
        return _ref.topk_stable_ref(counts, top)

    def _lsh_chunk(self, q_codes: torch.Tensor, *, cfg: SearchConfig):
        vals, ids = self._lsh_coarse(q_codes, cfg=cfg)
        if cfg.scored:
            return self._rerank(q_codes, ids, cfg)
        return ids, self._rho(vals)

    # -- candidate introspection ---------------------------------------------
    def band_match_counts(self, q_codes: torch.Tensor,
                          n_probes: int = 0) -> torch.Tensor:
        """[Q, k] codes -> int32 [Q, n] matching-band counts (a row is a
        candidate iff its count > 0); non-decreasing in ``n_probes``."""
        qh = probe_hashes(q_codes, self.band_spec, n_probes)
        return _coarse_band_scores(qh, self.db_band_hashes)

    def rerank(self, q_codes: torch.Tensor, cand_ids):
        """Full packed collision counts of one query row's candidate list
        -> (counts [c], rho_hat [c])."""
        q_words = _ops.pack_codes(q_codes[None, :], self.store.bits,
                                  impl="ref")
        counts = _packing.match_count_packed(
            q_words, self.store.take(torch.as_tensor(cand_ids)),
            self.store.bits, self.sketcher.cfg.k)
        return counts, self._rho(counts)
