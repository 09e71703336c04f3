"""LSH tables over coded random projections (paper §1.1): compat wrapper.

Counterpart of ``repro/core/lsh.py``: the historical one-query-at-a-time
API (build / candidates / query) over the device-resident
``ann.AnnEngine``. New code should call ``AnnEngine.search`` directly
for batched and multi-probe search.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.ann.bands import BandSpec
from repro_torch.ann.engine import AnnEngine
from repro_torch.core.sketch import CodedRandomProjection

__all__ = ["LSHIndex"]


@dataclass
class LSHIndex:
    """L banded hash tables over coded projections (engine-backed)."""
    sketcher: CodedRandomProjection
    n_tables: int = 8
    band_width: int = 8

    def __post_init__(self):
        need = self.n_tables * self.band_width
        if need > self.sketcher.cfg.k:
            raise ValueError(f"need n_tables*band_width <= k, "
                             f"{need} > {self.sketcher.cfg.k}")
        self._engine = None

    @property
    def engine(self) -> AnnEngine:
        if self._engine is None:
            raise RuntimeError("index not built; call build(corpus) first")
        return self._engine

    def build(self, x):
        """Index a corpus x [n, D]."""
        self._engine = AnnEngine.build(
            self.sketcher, x,
            BandSpec(n_tables=self.n_tables, band_width=self.band_width))
        return self

    def candidates(self, q_codes) -> list:
        """Union of bucket members across tables for one query code row."""
        q = torch.as_tensor(q_codes, device=self.sketcher.device)
        counts = self.engine.band_match_counts(q[None, :])[0]
        return [int(i) for i in np.flatnonzero(counts.cpu().numpy() > 0)]

    def query(self, x_query, top: int = 10) -> list:
        """x_query [D] -> list[(corpus_idx, rho_hat)] sorted by similarity
        (ties in candidate order)."""
        x = torch.as_tensor(x_query, dtype=torch.float32,
                            device=self.sketcher.device)
        q_codes = self.engine.encode_queries(x[None, :])[0]
        cand = self.candidates(q_codes)
        if not cand:
            return []
        _, rho = self.engine.rerank(q_codes, torch.as_tensor(cand))
        order = torch.argsort(-rho, stable=True)[:top]
        return [(cand[int(i)], float(rho[i])) for i in order]
