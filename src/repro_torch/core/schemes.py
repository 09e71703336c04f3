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

__all__ = ["CodeSpec", "spec_for", "encode", "encode_uniform", "encode_offset",
           "encode_2bit", "encode_sign", "sample_offsets",
           "collision_fraction"]


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


def spec_for(scheme: str, w: float = 1.0, cutoff: float = 6.0) -> CodeSpec:
    """``CodeSpec`` with float fields."""
    return CodeSpec(scheme=scheme, w=float(w), cutoff=float(cutoff))


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """0-dim float32 tensor on ``like``'s device: a tensor divisor keeps
    CUDA from turning ``x / w`` into ``x * (1/w)``."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _floor_code(v: torch.Tensor, w: float, n_side: int) -> torch.Tensor:
    c = torch.floor(v / _f32(w, v)).clamp(-n_side, n_side - 1)
    return (c + n_side).to(torch.int32)


def encode_uniform(x, w: float, cutoff: float = 6.0) -> torch.Tensor:
    """h_w (Eq. 4): floor(x/w), clamped to +-cutoff, shifted to unsigned
    int32 codes in [0, 2*ceil(cutoff/w))."""
    return _floor_code(torch.as_tensor(x), w,
                       max(1, int(math.ceil(cutoff / w))))


def encode_offset(x, w: float, q, cutoff: float = 6.0) -> torch.Tensor:
    """h_{w,q} (Eq. 5, Datar et al.): floor((x + q)/w) with q ~ U(0, w)
    per projection (broadcast on the last axis), clamped; the offset can
    push a value one bin past the cutoff."""
    return _floor_code(torch.as_tensor(x) + q, w,
                       max(1, int(math.ceil(cutoff / w)) + 1))


def encode_2bit(x, w: float) -> torch.Tensor:
    """h_{w,2} (§4): (-inf,-w) -> 0, [-w,0) -> 1, [0,w) -> 2, [w,inf) -> 3."""
    x = torch.as_tensor(x)
    wt = _f32(w, x)
    return ((x >= -wt).to(torch.int32) + (x >= 0.0).to(torch.int32)
            + (x >= wt).to(torch.int32))


def encode_sign(x) -> torch.Tensor:
    """h_1 (§5): 1 where x >= 0, else 0."""
    return (torch.as_tensor(x) >= 0.0).to(torch.int32)


def encode(x: torch.Tensor, spec: CodeSpec, q=None) -> torch.Tensor:
    """float32 projections [..., k] -> int32 codes under ``spec``;
    ``q`` [k] is required iff the scheme is ``offset``."""
    if spec.scheme == "uniform":
        return encode_uniform(x, spec.w, spec.cutoff)
    if spec.scheme == "offset":
        if q is None:
            raise ValueError("offset scheme requires offsets q (sample_offsets)")
        return encode_offset(x, spec.w, q, spec.cutoff)
    if spec.scheme == "2bit":
        return encode_2bit(x, spec.w)
    if spec.scheme == "sign":
        return encode_sign(x)
    raise ValueError(f"unknown scheme {spec.scheme!r}")


def collision_fraction(codes_a, codes_b, axis: int = -1) -> torch.Tensor:
    """Empirical collision probability P_hat = mean_j [a_j == b_j]
    (float32): the exact count times float32(1/n), the rounding XLA's
    mean gives, so the fractions equal the reference's bit for bit."""
    eq = torch.as_tensor(codes_a) == torch.as_tensor(codes_b)
    n = eq.shape[axis]
    return eq.to(torch.float32).sum(dim=axis) * _f32(1.0 / n, eq) \
        if n else eq.to(torch.float32).mean(dim=axis)


def sample_offsets(key: tuple, k: int, w: float,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q_j ~ Uniform(0, w), one per projection (CPU [k] in ``dtype``,
    float32 or bf16, as the reference draws them in the sketch's
    dtype)."""
    return prng.uniform(key, (k,), 0.0, w, dtype=dtype)
