"""Packed-code feature geometry for linear models (paper §6 features).

Counterpart of ``repro/learn/features.py``. The paper's SVM features are
the one-hot expansion of the codes: row i is k blocks of width n_codes,
one 1.0 per block, scaled to unit norm. ``learn`` never builds that
matrix (a linear model over it is a per-projection weight-table gather
over the packed words), but every layer needs its geometry:

* the **flat table layout** shared with ``rank.RankTables`` and the
  packed-linear kernels: F = n_words * (32/bits) field slots x P =
  2**bits entries a slot. F*P >= k*n_codes; the surplus columns are
  **phantoms**: field slots >= k decode the zero padding of the last
  word, entries >= n_codes are code values no encoder emits;
* the **row normalization**: every row has exactly k ones, so unit-norm
  scaling is the constant 1/sqrt(k), applied to the margins (one scalar
  multiply), never to features.

Invariant (kept by ``learn.linear``): weight tables hold exact zeros in
every phantom column, so packed margins, the L2 term and gradients agree
with the dense ``expand_codes`` path to float rounding.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.core import packing as _packing
from repro_torch.core.schemes import CodeSpec
from repro_torch.device import resolve_device

__all__ = ["PackedFeatureSpec", "feature_spec_for", "expand_codes"]


def _on_device(x, device) -> torch.Tensor:
    """A tensor stays on its device; an array goes to ``device`` (the
    card by default)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=resolve_device(device))


def expand_codes(codes, spec: CodeSpec, normalize: bool = True, *,
                 device=None) -> torch.Tensor:
    """One-hot expand codes [n, k] -> dense float32 features
    [n, k * n_codes], rows scaled to unit norm (1/sqrt(k)) when
    ``normalize``. The oracle feature path, O(n * k * n_codes) floats,
    for parity checks and toy sizes; training goes through
    ``PackedFeatureSpec`` and the packed-linear kernels instead. A
    tensor stays on its device; an array goes to ``device``."""
    codes = _on_device(codes, device)
    n, k = codes.shape
    feats = torch.nn.functional.one_hot(codes.to(torch.int64), spec.n_codes) \
        .to(torch.float32).reshape(n, k * spec.n_codes)
    if normalize:
        feats = feats / torch.sqrt(torch.tensor(float(k), dtype=torch.float32,
                                                device=feats.device))
    return feats


@functools.lru_cache(maxsize=64)
def _entry_mask(k: int, bits: int, n_codes: int, n_fields: int,
                device: str) -> torch.Tensor:
    field = torch.arange(n_fields, device=device)[:, None]
    entry = torch.arange(1 << bits, device=device)[None, :]
    m = (field < k) & (entry < n_codes)
    return m.to(torch.float32).reshape(-1)


@dataclass(frozen=True)
class PackedFeatureSpec:
    """Geometry of one packed-code feature space: (k, bits, n_codes)."""
    k: int                 # projections per row
    bits: int              # packed field width (1/2/4/8/16)
    n_codes: int           # real code values per projection (<= 2**bits)
    normalize: bool = True  # unit-norm rows (1/sqrt(k) pre-scale)

    def __post_init__(self):
        if self.n_codes > (1 << self.bits):
            raise ValueError(f"n_codes {self.n_codes} does not fit "
                             f"{self.bits}-bit fields")

    # -- layout --------------------------------------------------------------
    @property
    def n_words(self) -> int:
        """Packed words per row: ceil(k / (32/bits))."""
        return _packing.packed_width(self.k, self.bits)

    @property
    def n_entries(self) -> int:
        """Table entries per field slot (2**bits; >= n_codes)."""
        return 1 << self.bits

    @property
    def n_fields(self) -> int:
        """Field slots per row: n_words * (32/bits) (>= k)."""
        return self.n_words * _packing.codes_per_word(self.bits)

    @property
    def table_width(self) -> int:
        """Flat weight-table width F*P (phantom columns included)."""
        return self.n_fields * self.n_entries

    @property
    def dense_dim(self) -> int:
        """Width of the dense ``expand_codes`` feature space: k*n_codes."""
        return self.k * self.n_codes

    @property
    def scale(self) -> float:
        """Row normalization as a margin pre-scale: 1/sqrt(k) when
        ``normalize`` (every row has exactly k ones), else 1."""
        return 1.0 / math.sqrt(self.k) if self.normalize else 1.0

    def entry_mask(self, device=None) -> torch.Tensor:
        """float32 [table_width] on ``device`` (the card by default): 1.0
        at real columns, 0.0 at phantoms (field slot >= k, or entry >=
        n_codes). Multiplied into every table gradient so that phantom
        columns, which the backward kernel does touch (padded fields
        decode to code 0 in every row), never learn. Cached per
        device."""
        return _entry_mask(self.k, self.bits, self.n_codes, self.n_fields,
                           str(resolve_device(device)))

    # -- dense <-> packed weight layout --------------------------------------
    def tables_from_dense(self, w_dense, *, device=None) -> torch.Tensor:
        """Dense weights [..., k*n_codes] (``expand_codes`` layout) ->
        flat float32 tables [..., table_width], phantom columns zero. A
        tensor stays on its device; an array goes to ``device``."""
        w = _on_device(w_dense, device).to(torch.float32)
        lead = tuple(w.shape[:-1])
        w = w.reshape(lead + (self.k, self.n_codes))
        w = torch.nn.functional.pad(w, (0, self.n_entries - self.n_codes,
                                        0, self.n_fields - self.k))
        return w.reshape(lead + (self.table_width,))

    def dense_from_tables(self, tables, *, device=None) -> torch.Tensor:
        """Inverse of ``tables_from_dense``: drop the phantom columns. A
        tensor stays on its device; an array goes to ``device``."""
        t = _on_device(tables, device)
        lead = tuple(t.shape[:-1])
        t = t.reshape(lead + (self.n_fields, self.n_entries))
        return t[..., :self.k, :self.n_codes].reshape(
            lead + (self.dense_dim,))


def feature_spec_for(spec, k: int = None,
                     normalize: bool = True) -> PackedFeatureSpec:
    """Feature spec from a ``CodeSpec`` (+ k) or a sketcher
    (``CodedRandomProjection``: its spec and, when ``k`` is omitted, its
    k; an explicit ``k`` wins either way)."""
    if not isinstance(spec, CodeSpec):
        inner = getattr(spec, "spec", None)
        if not isinstance(inner, CodeSpec):
            raise TypeError(f"spec must be CodeSpec or sketcher, got "
                            f"{spec!r}")
        if k is None:
            k = spec.cfg.k
        spec = inner
    if k is None:
        raise TypeError("k is required when passing a bare CodeSpec "
                        "(or pass a CodedRandomProjection)")
    return PackedFeatureSpec(k=k, bits=spec.bits, n_codes=spec.n_codes,
                             normalize=normalize)
