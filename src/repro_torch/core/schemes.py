"""Encoders for the four coding schemes (paper Eq. 4, Eq. 5, §4, §5).

Counterpart of ``repro/core/schemes.py``: projected values x (last axis
= k projections) -> unsigned int32 codes in [0, n_codes). Uniform and
offset codes take ``floor(x / w)`` with a true float32 division, as the
reference does; the CUDA epilogues do the same.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core import prng

__all__ = ["CodeSpec", "encode", "sample_offsets"]


@dataclass(frozen=True)
class CodeSpec:
    """Static description of a coding scheme instance."""
    scheme: str            # uniform | offset | 2bit | sign
    w: float               # bin width (ignored for sign)
    cutoff: float = 6.0    # clamp for uniform/offset schemes

    @property
    def n_bins_side(self) -> int:
        """Bins on each side of zero (the offset can push one further)."""
        if self.scheme == "uniform":
            return max(1, int(math.ceil(self.cutoff / self.w)))
        if self.scheme == "offset":
            return max(1, int(math.ceil(self.cutoff / self.w)) + 1)
        if self.scheme == "2bit":
            return 2
        return 1

    @property
    def n_codes(self) -> int:
        """Distinct codes: 2 * n_bins_side."""
        return 2 * self.n_bins_side

    @property
    def bits(self) -> int:
        """Bits per packed field: ceil(log2(n_codes)) rounded up to one
        of 1, 2, 4, 8, 16."""
        raw = max(1, int(math.ceil(math.log2(self.n_codes))))
        for b in (1, 2, 4, 8, 16):
            if raw <= b:
                return b
        raise ValueError(f"codes too wide to pack: {self.n_codes}")


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """0-dim float32 tensor on ``like``'s device: a tensor divisor keeps
    CUDA from turning ``x / w`` into ``x * (1/w)``."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _floor_code(v: torch.Tensor, w: float, n_side: int) -> torch.Tensor:
    c = torch.floor(v / _f32(w, v)).clamp(-n_side, n_side - 1)
    return (c + n_side).to(torch.int32)


def encode(x: torch.Tensor, spec: CodeSpec, q=None) -> torch.Tensor:
    """float32 projections [..., k] -> int32 codes under ``spec``;
    ``q`` [k] is required iff the scheme is ``offset``."""
    if spec.scheme == "uniform":
        return _floor_code(x, spec.w, spec.n_bins_side)
    if spec.scheme == "offset":
        if q is None:
            raise ValueError("offset scheme requires offsets q (sample_offsets)")
        return _floor_code(x + q, spec.w, spec.n_bins_side)
    if spec.scheme == "2bit":
        w = _f32(spec.w, x)
        return ((x >= -w).to(torch.int32) + (x >= 0.0).to(torch.int32)
                + (x >= w).to(torch.int32))
    if spec.scheme == "sign":
        return (x >= 0.0).to(torch.int32)
    raise ValueError(f"unknown scheme {spec.scheme!r}")


def sample_offsets(key: tuple, k: int, w: float,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q_j ~ Uniform(0, w), one per projection (CPU [k] in ``dtype``,
    float32 or bf16, as the reference draws them in the sketch's
    dtype)."""
    return prng.uniform(key, (k,), 0.0, w, dtype=dtype)
