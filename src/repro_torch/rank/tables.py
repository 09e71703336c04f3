"""Per-query lookup tables: packed codes -> calibrated similarity scores.

Counterpart of ``repro/rank/tables.py:52-183``. The pair table holds
per-code-pair log-likelihood ratios S[a, b] = log p_ab(rho_ref) -
log p_ab(0) from the scheme's contingency-cell model
(``core.estimators.cell_probs``); the expected total score over a dense
rho grid calibrates raw scores back to rho_hat. ``query_tables`` gathers
the pair table's rows by a query's codes into a flat table [Q, F*P]
(F field slots of P = 2**bits entries; padded slots hold zeros) that
the scored kernels read.

The cell model runs in float64 on the CPU, once per sketcher; the
reference runs it in float32, so the two packages' tables agree to a
relative 1e-4. Given the same tables, everything downstream is
bit-exact, including the int8 scales: ``query_tables_int8`` takes
log2 as XLA computes it on the CPU (``prng.log2_xla``), so a word whose
largest entry sits at 127 * 2^j gets the reference's scale on either
side of the rounding.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core import packing as _packing
from repro_torch.core.estimators import cell_probs, interp
from repro_torch.core.prng import log2_xla
from repro_torch.core.schemes import CodeSpec
from repro_torch.device import resolve_device

__all__ = ["RankTables", "build_rank_tables"]


def _exp2_int(e: torch.Tensor) -> torch.Tensor:
    """2**e for integral float32 e in the normal range, exactly (XLA's
    float32 exp2, exp(e * ln 2), misses some powers of two; the int8
    path's exactness needs every scale to be one)."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


@dataclass(frozen=True)
class RankTables:
    """LUT bundle for one (scheme, k): ``pair`` float32 [P, P] (code
    pairs past n_codes zero), ``rho_grid``/``score_grid`` float32 [G]
    (score_grid strictly increasing), all on one device; ``dtype`` is
    the storage type of the query tables (float32 or bfloat16)."""
    spec: CodeSpec
    k: int
    pair: torch.Tensor
    rho_grid: torch.Tensor
    score_grid: torch.Tensor
    dtype: torch.dtype = torch.float32

    @property
    def bits(self) -> int:
        """Packed field width of the scheme."""
        return self.spec.bits

    @property
    def n_entries(self) -> int:
        """Entries per field slot (2**bits)."""
        return 1 << self.spec.bits

    @property
    def n_fields(self) -> int:
        """Field slots per row: n_words * codes_per_word (>= k)."""
        return (_packing.packed_width(self.k, self.bits)
                * _packing.codes_per_word(self.bits))

    def query_tables(self, q_codes: torch.Tensor, dtype=None) -> torch.Tensor:
        """int32 codes [Q, k] -> tables [Q, F*P] in ``dtype`` (default
        the bundle's): entry [i, (w*cpw + f)*P + c] scores corpus code c
        at code position w*cpw + f of query i; padded positions are 0."""
        t = self.pair[q_codes.to(torch.int64)]                 # [Q, k, P]
        pad = self.n_fields - self.k
        if pad:
            t = torch.nn.functional.pad(t, (0, 0, 0, pad))
        return t.reshape(t.shape[0], self.n_fields * self.n_entries).to(
            self.dtype if dtype is None else dtype)

    def query_tables_int8(self, q_codes: torch.Tensor):
        """-> (int8 tables [Q, F*P], float32 scales [Q, W]): each packed
        word's entries share the scale 2**ceil(log2(max_abs / 127)), 1.0
        for all-zero words; entries round half to even and clip to
        [-127, 127]."""
        t32 = self.query_tables(q_codes, dtype=torch.float32)
        q = t32.shape[0]
        cpw = _packing.codes_per_word(self.bits)
        per_word = t32.reshape(q, self.n_fields // cpw, cpw * self.n_entries)
        max_abs = per_word.abs().amax(dim=-1)                   # [Q, W]
        floor = torch.tensor(np.float32(1e-30), device=max_abs.device)
        e = torch.ceil(log2_xla(torch.maximum(max_abs, floor)
                                / torch.tensor(np.float32(127.0),
                                               device=max_abs.device)))
        scale = torch.where(max_abs > 0, _exp2_int(e),
                            torch.ones_like(max_abs))
        qt = torch.round(per_word / scale[:, :, None]).clamp(-127, 127)
        return qt.to(torch.int8).reshape(q, -1), scale

    def rho_from_scores(self, scores: torch.Tensor) -> torch.Tensor:
        """Raw LUT scores -> rho_hat float32 by monotone inversion of the
        expected-score curve (scores off the grid clamp to its ends)."""
        return interp(scores.to(torch.float32), self.score_grid,
                      self.rho_grid)

    def quantize(self, dtype=torch.bfloat16) -> "RankTables":
        """Same tables with query-table storage ``dtype``."""
        return replace(self, dtype=dtype)


def build_rank_tables(spec, k: int = None, *, rho_ref: float = 0.9,
                      grid_size: int = 512, rho_max: float = 0.99995,
                      floor: float = 1e-12, dtype=torch.float32,
                      device=None) -> RankTables:
    """LUT scoring and calibration tables for one (scheme, k).

    ``spec`` is a ``CodeSpec`` (``k`` then required) or a sketcher,
    whose spec, k and device are taken. The cell model runs in float64
    on the CPU; the tables are placed on ``device``.
    """
    if k is None:
        if isinstance(spec, CodeSpec):
            raise TypeError("k is required when passing a bare CodeSpec "
                            "(or pass a CodedRandomProjection)")
        sk = spec
        spec, k = sk.spec, sk.cfg.k
        device = sk.device if device is None else device
    if not isinstance(spec, CodeSpec):
        raise TypeError(f"spec must be CodeSpec or sketcher, got {spec!r}")
    dev = resolve_device(device)
    n = spec.n_codes
    p_entries = 1 << spec.bits
    rho = np.linspace(0.0, rho_max, grid_size)
    probs = np.maximum(cell_probs(torch.from_numpy(rho), spec).numpy(),
                       floor)                                   # [G, n, n]
    p_ref = np.maximum(cell_probs(torch.tensor(rho_ref), spec).numpy(),
                       floor)
    pair = np.log(p_ref) - np.log(probs[0])                     # [n, n] LLR
    g = k * np.einsum("gab,ab->g", probs, pair)
    g = np.maximum.accumulate(g) + 1e-9 * np.arange(grid_size)
    full = np.zeros((p_entries, p_entries), np.float32)
    full[:n, :n] = pair.astype(np.float32)
    return RankTables(spec=spec, k=k, pair=torch.from_numpy(full).to(dev),
                      rho_grid=torch.from_numpy(rho.astype(np.float32)).to(dev),
                      score_grid=torch.from_numpy(g.astype(np.float32)).to(dev),
                      dtype=dtype)
