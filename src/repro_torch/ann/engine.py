"""Batched exact search over packed codes on one device.

Counterpart of ``repro/ann/engine.py:61-178,241-458,474-480`` in its
count-ranked exact mode: queries are coded by the fused project + code
kernel, packed, and matched against a ``CodeStore`` by the streaming
packed top-k kernel; rho_hat comes from the paper's collision estimator.
Queries run in chunks of ``chunk_q`` rows. Scored (LUT) search, LSH
candidates and the sharded search are later slices of the port and
raise ``NotImplementedError`` naming their ROADMAP items.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch.ann.bands import BandSpec, band_hashes
from repro_torch.ann.store import CodeStore
from repro_torch.core import packing as _packing
from repro_torch.core.sketch import CodedRandomProjection
from repro_torch.kernels import ops as _ops

__all__ = ["SearchConfig", "AnnEngine", "QueryCoder", "merge_topk",
           "run_chunked"]

_HASH_ROWS = 1 << 16   # rows per band-hash step (bounds the temporaries)


@dataclass(frozen=True)
class SearchConfig:
    """Static knobs of one search variant."""
    top_k: int = 10
    mode: str = "exact"          # exact | lsh (lsh: a later slice)
    chunk_q: int = 256           # query rows per device step
    impl: str = "auto"           # kernel dispatch (see kernels.ops)
    scored: bool = False         # scored search (a later slice)


class QueryCoder:
    """Query encoder over the sketcher's shared ``StreamingEncoder``."""

    def __init__(self, sketcher: CodedRandomProjection):
        self.sketcher = sketcher
        self._encoder = sketcher.stream_encoder()

    def encode(self, x, impl: str = "auto") -> torch.Tensor:
        """x [Q, D] -> int32 codes [Q, k] (fused project + code kernel)."""
        return self._encoder.encode_codes(x, impl=impl)


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


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is ROADMAP queue A item {item}, not "
                               f"yet ported to repro_torch")


class AnnEngine:
    """Immutable search engine: sketcher + packed corpus + band hashes."""

    def __init__(self, sketcher: CodedRandomProjection, store: CodeStore,
                 band_spec: BandSpec = BandSpec(), db_band_hashes=None):
        if store.words.device != sketcher.device:
            raise ValueError(f"store on {store.words.device}, sketcher on "
                             f"{sketcher.device}")
        self.sketcher = sketcher
        self.store = store
        self.band_spec = band_spec.validate(sketcher.cfg.k)
        if db_band_hashes is None:
            db_band_hashes = self._hash_words(store.words)
        self.db_band_hashes = db_band_hashes      # uint32 values, int64 [n, L]
        self._coder = QueryCoder(sketcher)

    def _hash_words(self, words: torch.Tensor) -> torch.Tensor:
        """Band hashes of packed rows, in row chunks: only the words that
        hold the first L*m codes are unpacked, never the whole store."""
        spec, bits = self.band_spec, self.store.bits
        used = spec.n_tables * spec.band_width
        n_w = _packing.packed_width(used, bits)
        parts = [band_hashes(_packing.unpack_codes(words[lo:lo + _HASH_ROWS,
                                                         :n_w], bits, used),
                             spec)
                 for lo in range(0, words.shape[0], _HASH_ROWS)]
        if not parts:
            return torch.empty((0, spec.n_tables), dtype=torch.int64,
                               device=words.device)
        return torch.cat(parts)

    # -- construction / ingestion -------------------------------------------
    @classmethod
    def build(cls, sketcher: CodedRandomProjection, corpus,
              band_spec: BandSpec = BandSpec(),
              impl: str = "auto") -> "AnnEngine":
        """Index a corpus [n, D]: fused project + code, pack, band-hash."""
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
        """New engine with rows appended (ids continue from n)."""
        codes = self._coder.encode(x, impl=impl)
        hashes = torch.cat([self.db_band_hashes,
                            band_hashes(codes, self.band_spec)])
        return AnnEngine(self.sketcher, self.store.add(codes, impl=impl),
                         self.band_spec, db_band_hashes=hashes)

    @property
    def n(self) -> int:
        """Corpus rows resident in the store."""
        return self.store.n

    # -- queries -------------------------------------------------------------
    def encode_queries(self, x, impl: str = "auto") -> torch.Tensor:
        """x [Q, D] -> int32 codes [Q, k] via the fused project + code kernel."""
        return self._coder.encode(x, impl=impl)

    def codes_for_ids(self, ids) -> torch.Tensor:
        """int32 codes [m, k] of store rows ``ids``."""
        words = self.store.take(torch.as_tensor(ids))
        return _packing.unpack_codes(words, self.sketcher.spec.bits,
                                     self.sketcher.cfg.k)

    def search(self, queries, top_k: int = 10, *, mode: str = "exact",
               chunk_q: int = 256, impl: str = "auto", scored: bool = False):
        """queries float [Q, D] -> (ids int32 [Q, top_k], rho_hat float32
        [Q, top_k]); ids of -1 mark empty slots."""
        cfg = SearchConfig(top_k=top_k, mode=mode, chunk_q=chunk_q,
                           impl=impl, scored=scored)
        self._check(cfg)
        return self.search_codes(self.encode_queries(queries, impl=impl), cfg)

    def _check(self, cfg: SearchConfig):
        if cfg.mode not in ("exact", "lsh"):
            raise ValueError(f"unknown mode {cfg.mode!r}")
        if cfg.mode == "lsh":
            raise _not_ported("LSH candidate search (mode='lsh')", "4")
        if cfg.scored:
            raise _not_ported("scored search (scored=True)", "5")

    def search_codes(self, q_codes: torch.Tensor, cfg: SearchConfig):
        """Search pre-encoded queries [Q, k] in chunks of ``cfg.chunk_q``."""
        self._check(cfg)
        q = q_codes.shape[0]
        dev = self.store.words.device
        if q == 0 or self.store.n == 0:
            return (torch.full((q, cfg.top_k), -1, dtype=torch.int32,
                               device=dev),
                    torch.full((q, cfg.top_k), -1.0, dtype=torch.float32,
                               device=dev))
        return run_chunked(q_codes, cfg,
                           lambda chunk, c: self._exact_chunk(chunk, cfg=c))

    def search_sharded(self, *args, **kwargs):
        """Row-sharded search across devices: not yet ported."""
        raise _not_ported("search_sharded (torch.distributed merge)", "4")

    def _rho(self, counts: torch.Tensor) -> torch.Tensor:
        """Collision counts -> rho_hat; empty slots (count < 0) give -1."""
        k = torch.tensor(float(self.sketcher.cfg.k), device=counts.device)
        rho = self.sketcher._estimator(counts.to(torch.float32) / k)
        return torch.where(counts < 0, torch.full_like(rho, -1.0), rho)

    def _exact_coarse(self, q_codes: torch.Tensor, *, cfg: SearchConfig):
        """One exact chunk -> (counts, ids) at top-k: pack the query codes,
        then the streaming packed top-k over the whole store."""
        q_words = _ops.pack_codes(q_codes, self.store.bits, impl=cfg.impl)
        vals, ids = _ops.packed_topk(q_words, self.store.words,
                                     self.store.bits, self.sketcher.cfg.k,
                                     cfg.top_k, impl=cfg.impl)
        return vals, torch.where(vals < 0, torch.full_like(ids, -1), ids)

    def _exact_chunk(self, q_codes: torch.Tensor, *, cfg: SearchConfig):
        vals, ids = self._exact_coarse(q_codes, cfg=cfg)
        return ids, self._rho(vals)
