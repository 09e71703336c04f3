"""Streaming encoder: raw vectors -> packed words, O(unit) memory.

Counterpart of ``repro/encode/encoder.py:52-174``, in three regimes:

* R-resident (``d * k`` at most ``r_cap_elems``): R is drawn once from
  its canonical units, cached on the sketcher's device with the GEMM
  kernels' split of it (``r_split``), and every dense batch runs one
  kernel: the fused project -> code -> pack for the corpus, the fused
  project -> code for queries.
* Matrix-free (above the cap; the paper's URL width, where R would be
  3.3 GB): dense batches stream over D unit by unit, each unit drawn on
  the device where it is used (``CodedRandomProjection.project``), into
  one [n, k] accumulator in the sketch's dtype.
* CSR (``encode.CsrMatrix``, at any D): the chunk's arrays go to the
  device once; the occupied units, in ascending order, go in runs of up
  to ``csr_group`` consecutive unit ids: one launch draws a run's
  occupied units into a buffer of G units, and one launch of the grouped
  CSR step adds each row's products, unit by unit and within a unit in
  CSR order. Units no entry touches are neither drawn nor read. The
  accumulator is float32 for a bf16 sketch too, with each bf16 unit
  widened exactly: the reference's first step promotes its bf16 zeros
  to float32 (``acc + segment_sum`` of float32 products).

The streamed and CSR regimes finalize with the code-and-pack kernel
(``ops.code_pack``). They sum in the unit order of the ``core.sketch``
oracle; the fused kernels take the product as three TF32 tensor-core
products in their own order (about 1e-6 from the float32 product for
unit rows), so the regimes agree except where a projection lies that
close to a bin edge. The data-parallel ``encode.pipeline.encode_sharded``
projects each rank's rows through ``CodedRandomProjection.project`` and
codes them with ``ops.code_pack``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.packing import packed_width
from repro_torch.encode.sparse import CsrMatrix
from repro_torch.kernels import normal_unit as _normal_unit
from repro_torch.kernels import ops as _ops

__all__ = ["StreamingEncoder", "R_CAP_ELEMS", "CSR_GROUP_MAX"]

R_CAP_ELEMS = 1 << 24   # d * k float32 elements (64 MB)
CSR_GROUP_MAX = _normal_unit.MAX_UNITS   # units of one grouped draw

# column ids counted per slice, so the unit ids never take nnz * 4 bytes
_COUNT_SLICE = 1 << 22


def _unit_counts(indices: torch.Tensor, r_unit: int, n_units: int) -> list:
    """Entries a unit of the column ids ``indices`` -> list [n_units]."""
    hist = torch.zeros(n_units, dtype=torch.int64, device=indices.device)
    for a in range(0, indices.numel(), _COUNT_SLICE):
        hist += torch.bincount(indices[a:a + _COUNT_SLICE] // r_unit,
                               minlength=n_units)
    return hist.tolist()


def _runs(counts: list, group: int):
    """The occupied units in runs of at most ``group`` consecutive unit
    ids, ascending -> (first unit id, occupied unit ids, their entries)
    a run."""
    occupied = [u for u, c in enumerate(counts) if c]
    i = 0
    while i < len(occupied):
        u0, j = occupied[i], i
        while j < len(occupied) and occupied[j] < u0 + group:
            j += 1
        units = occupied[i:j]
        yield u0, units, sum(counts[u] for u in units)
        i = j


class StreamingEncoder:
    """Dense [n, D] or ``CsrMatrix`` input -> packed words [n, W] or
    codes [n, k]."""

    def __init__(self, sketcher, *, r_cap_elems: int = R_CAP_ELEMS):
        self.sketcher = sketcher
        self.r_cap_elems = int(r_cap_elems)
        self._rmat = None
        self._rsplit = None     # (R it was split from, ops.split_r(R))

    # -- R residency ---------------------------------------------------------
    @property
    def r_resident(self) -> bool:
        """Whether R may be materialized (``d * k`` under the cap)."""
        s = self.sketcher
        return s.d * s.cfg.k <= self.r_cap_elems

    @property
    def r_slab_elems(self) -> int:
        """Peak R elements held by the matrix-free path: one unit."""
        s = self.sketcher
        return s.cfg.r_unit * s.cfg.k

    @property
    def csr_group(self) -> int:
        """Units G of R drawn and stepped together on the CSR path: the
        most whose buffer (G * r_unit * k elements) takes at most half of
        ``r_cap_elems``, at least 1 and at most ``CSR_GROUP_MAX`` and the
        sketch's units."""
        s = self.sketcher
        g = (self.r_cap_elems // 2) // (s.cfg.r_unit * s.cfg.k)
        return max(1, min(g, CSR_GROUP_MAX, s.n_units))

    def r_matrix(self) -> torch.Tensor:
        """R [D, k] in the sketch's dtype on the sketcher's device,
        cached; raises above the residency cap, where the point is never
        to build it."""
        s = self.sketcher
        if not self.r_resident:
            raise ValueError(
                f"R is {s.d} x {s.cfg.k} = {s.d * s.cfg.k} elements, over "
                f"the residency cap {self.r_cap_elems}; use the streaming "
                f"encode path instead of materializing")
        if self._rmat is None:
            self._rmat = torch.cat([s._block_r(u, s.unit_width(u))
                                    for u in range(s.n_units)])
        return self._rmat

    def r_split(self):
        """The GEMM kernels' prepared R (``ops.split_r``: R^T in TF32 hi
        and lo planes), made once per R and cached beside it; None off
        the card, where the plain versions take R itself."""
        r = self.r_matrix()
        if r.device.type != "cuda":
            return None
        if self._rsplit is None or self._rsplit[0] is not r:
            self._rsplit = (r, _ops.split_r(r))
        return self._rsplit[1]

    # -- streaming -----------------------------------------------------------
    def project(self, x, impl: str = "auto") -> torch.Tensor:
        """Streaming projection x -> z [n, k] without building R (in the
        sketch's dtype for dense rows, float32 for CSR rows): dense rows
        unit by unit, CSR rows over their nonzeros only.
        ``impl`` selects the kernels or the plain versions of the draw
        and of the CSR step."""
        s = self.sketcher
        if not isinstance(x, CsrMatrix):
            return s.project(x, impl=impl)
        if x.d != s.d:
            raise ValueError(f"csr d={x.d} != sketcher d={s.d}")
        acc = torch.zeros((x.n, s.cfg.k), dtype=torch.float32,
                          device=s.device)
        if x.nnz == 0:
            return acc
        ru, group = s.cfg.r_unit, self.csr_group
        indptr = torch.as_tensor(np.asarray(x.indptr, np.int64),
                                 device=s.device)
        indices = torch.as_tensor(np.asarray(x.indices, np.int32),
                                  device=s.device)
        data = torch.as_tensor(np.asarray(x.data, np.float32),
                               device=s.device)
        r = torch.empty((group, ru, s.cfg.k), dtype=s.dtype, device=s.device)
        for u0, units, nnz in _runs(_unit_counts(indices, ru, s.n_units),
                                    group):
            s._draw_units(units, r, impl=impl)
            span = min(group * ru, s.d - u0 * ru)   # the sketch's end
            _ops.csr_group_step(acc, indptr, indices, data,
                                r[:-(-span // ru)], u0 * ru, span,
                                impl=impl, nnz=nnz)
        return acc

    # -- encoding ------------------------------------------------------------
    def encode_packed(self, x, impl: str = "auto") -> torch.Tensor:
        """x dense [n, D] or ``CsrMatrix`` -> packed int32 words [n, W]:
        the fused kernel for dense input while R is resident, else the
        streamed projection and the code-and-pack kernel."""
        s = self.sketcher
        if not isinstance(x, CsrMatrix) and self.r_resident:
            return _ops.encode_fused(s.as_input(x), self.r_matrix(), s.spec,
                                     s._offsets, impl=impl,
                                     r_split=self.r_split())
        return _ops.code_pack(self.project(x, impl=impl), s.spec, s._offsets,
                              impl=impl)

    def encode_codes(self, x, impl: str = "auto") -> torch.Tensor:
        """x dense [n, D] or ``CsrMatrix`` -> int32 codes [n, k] (the
        query side): the fused project + code kernel while R is resident,
        else the streamed projection and the scheme's encode."""
        s = self.sketcher
        if not isinstance(x, CsrMatrix) and self.r_resident:
            return _ops.coded_project(s.as_input(x), self.r_matrix(), s.spec,
                                      s._offsets, impl=impl,
                                      r_split=self.r_split())
        return s.encode_projected(self.project(x, impl=impl))

    @property
    def n_words(self) -> int:
        """Words per packed row: ceil(k / (32/bits))."""
        return packed_width(self.sketcher.cfg.k, self.sketcher.spec.bits)
