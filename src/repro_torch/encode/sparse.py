"""CSR-sparse input for the streaming encoder.

Counterpart of ``repro/encode/sparse.py``. The paper's near-neighbour
corpora are extremely sparse and extremely wide (URL: D = 3,231,961,
2,396,130 rows, about 115 nonzeros a row), so the projection of a CSR
chunk is a gather and segment sum over its nonzeros,

    z[i] = sum over the nonzeros j of row i of vals[j] * R[cols[j], :],

unit by unit of R in ascending order and, within a unit, in CSR order:
O(nnz * k) work, and units that no entry touches are skipped (their
contribution is an exact zero). On the card the unit step is the CUDA
kernel ``kernels/csrc/csr_step.cu``, which selects a unit's entries as
it scans the chunk's rows.

``CsrMatrix`` is the same small host container as the reference's (numpy
arrays, no scipy): enough to chunk rows for the ingest pipeline and to
densify for oracles at test scale. ``unit_buckets`` returns the
reference's buckets, padding included.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["CsrMatrix", "unit_buckets"]


@dataclass(frozen=True)
class CsrMatrix:
    """Host-side CSR matrix [n, d]: ``indptr`` int64 [n+1], ``indices``
    int32 [nnz] (column ids, any order within a row, duplicates allowed),
    ``data`` float32 [nnz], ``shape`` (n, d)."""
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple

    def __post_init__(self):
        n, d = self.shape
        if self.indptr.shape != (n + 1,):
            raise ValueError(f"indptr {self.indptr.shape} != ({n + 1},)")
        if self.indices.shape != self.data.shape:
            raise ValueError(f"indices {self.indices.shape} != data "
                             f"{self.data.shape}")
        if int(self.indptr[-1]) != self.indices.size:
            raise ValueError(f"indptr[-1]={int(self.indptr[-1])} != "
                             f"nnz={self.indices.size}")
        if self.indices.size and (self.indices.min() < 0
                                  or self.indices.max() >= d):
            raise ValueError(f"column ids out of range [0, {d})")

    # -- geometry ------------------------------------------------------------
    @property
    def n(self) -> int:
        """Rows."""
        return self.shape[0]

    @property
    def d(self) -> int:
        """Columns (the projection input dimensionality D)."""
        return self.shape[1]

    @property
    def nnz(self) -> int:
        """Stored nonzeros."""
        return self.indices.size

    # -- construction --------------------------------------------------------
    @classmethod
    def from_dense(cls, x) -> "CsrMatrix":
        """Dense [n, d] array -> CSR of its nonzero entries, row-major."""
        x = np.asarray(x, np.float32)
        rows, cols = np.nonzero(x)
        counts = np.bincount(rows, minlength=x.shape[0])
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return cls(indptr=indptr, indices=cols.astype(np.int32),
                   data=x[rows, cols].astype(np.float32), shape=x.shape)

    # -- views ---------------------------------------------------------------
    def row_slice(self, lo: int, hi: int) -> "CsrMatrix":
        """Rows [lo, hi) as a standalone CSR (the pipeline's chunk; the
        column ids and values are views)."""
        lo, hi = max(lo, 0), min(hi, self.n)
        a, b = int(self.indptr[lo]), int(self.indptr[hi])
        return CsrMatrix(indptr=(self.indptr[lo:hi + 1] - a).astype(np.int64),
                         indices=self.indices[a:b], data=self.data[a:b],
                         shape=(hi - lo, self.d))

    def densify(self) -> np.ndarray:
        """Dense float32 [n, d] (oracle path only; of duplicate columns
        one value is kept, where the projection sums them)."""
        out = np.zeros(self.shape, np.float32)
        rows = np.repeat(np.arange(self.n), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out


def unit_buckets(csr: CsrMatrix, r_unit: int):
    """A CSR chunk's nonzeros bucketed by projection unit, as the
    reference buckets them.

    Returns ``(units, rows, lcols, vals)``: ``units`` the occupied unit
    ids in ascending order; the others lists of per-unit arrays (rows of
    the chunk int32, unit-local column offsets int32, values float32),
    each in CSR order (a stable sort by unit) and padded to its own power
    of two with zero entries, as the reference pads them for its jit.
    The encoder does not call this: its kernel selects each unit's
    entries in the same order while it scans the rows.
    """
    rows = np.repeat(np.arange(csr.n, dtype=np.int32), np.diff(csr.indptr))
    cols = csr.indices
    unit_id = cols // r_unit
    order = np.argsort(unit_id, kind="stable")
    rows, cols, vals = rows[order], cols[order], csr.data[order]
    units, counts = np.unique(unit_id, return_counts=True)
    starts = np.concatenate([[0], np.cumsum(counts)])
    b_rows, b_lcol, b_vals = [], [], []
    for i in range(units.size):
        a, b = int(starts[i]), int(starts[i + 1])
        m = b - a
        cap = 1 << (m - 1).bit_length() if m else 1
        b_rows.append(np.pad(rows[a:b], (0, cap - m)).astype(np.int32))
        b_lcol.append(np.pad(cols[a:b] - units[i] * r_unit,
                             (0, cap - m)).astype(np.int32))
        b_vals.append(np.pad(vals[a:b], (0, cap - m)).astype(np.float32))
    return [int(u) for u in units], b_rows, b_lcol, b_vals
