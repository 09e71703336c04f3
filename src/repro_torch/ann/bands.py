"""Batched LSH band hashes with prefix-nested multi-probe.

Counterpart of ``repro/ann/bands.py``: the first L*m codes are cut into L
bands of m codes, each hashed to a uint32 bucket id by a polynomial
accumulate and a murmur-style finalizer. The uint32 arithmetic runs in
int64 masked to 32 bits (products split into 16-bit halves, so nothing
overflows), bit-exact with the reference. Hashes are returned as int64
tensors holding the uint32 values.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["BandSpec", "band_hashes", "probe_hashes"]

_M = 0xFFFFFFFF
_MIX1 = 0x9E3779B9      # golden-ratio increment
_MIX2 = 0x85EBCA6B      # murmur3 finalizer constants
_MIX3 = 0xC2B2AE35


@dataclass(frozen=True)
class BandSpec:
    """L tables of m codes each over the first L*m of k projections."""
    n_tables: int = 8
    band_width: int = 8

    def validate(self, k: int) -> "BandSpec":
        """Check L*m fits within k code positions; returns self."""
        need = self.n_tables * self.band_width
        if need > k:
            raise ValueError(f"need n_tables*band_width <= k, {need} > {k}")
        return self


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32), in int64 without overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX2)
    h = h ^ (h >> 13)
    h = _mul32(h, _MIX3)
    return h ^ (h >> 16)


def _hash_bands(bands: torch.Tensor) -> torch.Tensor:
    """int codes [..., L, m] -> uint32 bucket ids (int64) [..., L]."""
    b = bands.to(torch.int64) & _M
    h = torch.zeros(b.shape[:-1], dtype=torch.int64, device=b.device)
    for j in range(b.shape[-1]):
        h = _mul32(h ^ ((b[..., j] + _MIX1) & _M), _MIX2)
        h = h ^ (h >> 15)
    return _mix(h)


def _bands(codes: torch.Tensor, spec: BandSpec) -> torch.Tensor:
    L, m = spec.validate(codes.shape[-1]).n_tables, spec.band_width
    return codes[..., :L * m].reshape(codes.shape[:-1] + (L, m))


def band_hashes(codes: torch.Tensor, spec: BandSpec) -> torch.Tensor:
    """int32 codes [..., k] -> band hashes [..., L] (uint32 in int64)."""
    return _hash_bands(_bands(codes, spec))


def probe_hashes(codes: torch.Tensor, spec: BandSpec,
                 n_probes: int = 0) -> torch.Tensor:
    """int32 codes [..., k] -> [..., P, L] with P = 1 + n_probes.

    Probe 0 is the unperturbed hash; probe p >= 1 bumps band position
    (p-1)//2 mod m by +1 (p odd) or -1 (p even) in every band.
    """
    bands = _bands(codes, spec).to(torch.int64)
    m = spec.band_width
    out = [_hash_bands(bands)]
    for p in range(1, n_probes + 1):
        bump = torch.zeros(m, dtype=torch.int64, device=bands.device)
        bump[(p - 1) // 2 % m] = 1 if p % 2 == 1 else -1
        out.append(_hash_bands(bands + bump))
    return torch.stack(out, dim=-2)
