"""Streaming encoder: raw vectors -> packed words (R-resident regime).

Counterpart of ``repro/encode/encoder.py:52-174``. While ``d * k`` is at
most ``R_CAP_ELEMS`` the whole R is drawn once from its canonical units,
cached on the sketcher's device, and every batch runs one kernel: the
fused project -> code -> pack for the corpus, the fused project -> code
for queries. Unit streaming above the cap and CSR input are ROADMAP
queue A item 3 and raise here.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import packed_width
from repro_torch.kernels import ops as _ops

__all__ = ["StreamingEncoder", "R_CAP_ELEMS"]

R_CAP_ELEMS = 1 << 24   # d * k float32 elements (64 MB)


class StreamingEncoder:
    """Dense [n, D] input -> packed words [n, W] or codes [n, k]."""

    def __init__(self, sketcher, *, r_cap_elems: int = R_CAP_ELEMS):
        self.sketcher = sketcher
        self.r_cap_elems = int(r_cap_elems)
        self._rmat = None

    @property
    def r_resident(self) -> bool:
        """Whether R may be materialized (``d * k`` under the cap)."""
        s = self.sketcher
        return s.d * s.cfg.k <= self.r_cap_elems

    def r_matrix(self) -> torch.Tensor:
        """R [D, k] float32 on the sketcher's device, cached; raises above
        the residency cap."""
        s = self.sketcher
        if not self.r_resident:
            raise NotImplementedError(
                f"R is {s.d} x {s.cfg.k} = {s.d * s.cfg.k} elements, over the "
                f"residency cap {self.r_cap_elems}: matrix-free unit "
                f"streaming is ROADMAP queue A item 3, not yet ported")
        if self._rmat is None:
            self._rmat = torch.cat([s._block_r(u, s.unit_width(u))
                                    for u in range(s.n_units)]).to(s.device)
        return self._rmat

    def encode_packed(self, x, impl: str = "auto") -> torch.Tensor:
        """x [n, D] -> packed int32 words [n, W] (fused kernel). Agrees
        with the unit-ordered oracle except where a projection lies
        within float32 rounding of a bin edge."""
        s = self.sketcher
        return _ops.encode_fused(s.as_input(x), self.r_matrix(), s.spec,
                                 s._offsets, impl=impl)

    def encode_codes(self, x, impl: str = "auto") -> torch.Tensor:
        """x [n, D] -> int32 codes [n, k] (fused project + code kernel)."""
        s = self.sketcher
        return _ops.coded_project(s.as_input(x), self.r_matrix(), s.spec,
                                  s._offsets, impl=impl)

    @property
    def n_words(self) -> int:
        """Words per packed row: ceil(k / (32/bits))."""
        return packed_width(self.sketcher.cfg.k, self.sketcher.spec.bits)
