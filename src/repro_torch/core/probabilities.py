"""Collision probabilities for the four coding schemes (paper §2, §4, §5).

Counterpart of ``repro/core/probabilities.py``, evaluated in float64 on
the CPU (the estimator tables are built once per sketcher);
``torch.special.ndtr`` stands in for ``jax.scipy.special.ndtr``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core._quad import interval_nodes

__all__ = ["phi", "Phi", "collision_prob", "SCHEMES"]

ZMAX = 9.0          # beyond |z| = 9 the N(0,1) mass is < 1e-18
_DEFAULT_ORDER = 48
SCHEMES = ("uniform", "offset", "2bit", "sign")


def phi(x):
    """Standard normal pdf."""
    return torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def Phi(x):
    """Standard normal cdf."""
    return torch.special.ndtr(x)


def _clip_rho(rho):
    return torch.as_tensor(rho, dtype=torch.float64).clamp(0.0, 1.0 - 1e-9)


def _uniform(rho, w: float, order: int = _DEFAULT_ORDER):
    """P_w (Thm 1): 2 sum_i Q_{iw,(i+1)w}(rho), truncated at ZMAX."""
    if w <= 0:
        raise ValueError("bin width w must be positive")
    n_bins = max(1, int(math.ceil(ZMAX / w)))
    r = _clip_rho(rho)[..., None, None]
    sd = torch.sqrt(1.0 - r * r)
    lower = torch.tensor([i * w for i in range(n_bins)], dtype=torch.float64)
    upper = torch.tensor([(i + 1) * w for i in range(n_bins)],
                         dtype=torch.float64)
    z, wz = interval_nodes(lower, torch.clamp(upper, max=ZMAX + w), order)
    inner = Phi((upper[:, None] - r * z) / sd) - Phi((lower[:, None] - r * z) / sd)
    return 2.0 * torch.sum(phi(z) * inner * wz, dim=(-1, -2))


def _offset(rho, w: float):
    """P_{w,q} (Eq. 7), closed form with r = w / sqrt(2(1-rho))."""
    d = torch.clamp(2.0 * (1.0 - _clip_rho(rho)), min=1e-24)
    r = w / torch.sqrt(d)
    return (2.0 * Phi(r) - 1.0
            + 2.0 / (math.sqrt(2.0 * math.pi) * r) * (torch.exp(-0.5 * r * r) - 1.0))


def _2bit(rho, w: float, order: int = _DEFAULT_ORDER):
    """P_{w,2} (Thm 4): 1 - acos(rho)/pi - 4 int_0^w phi(z) Phi((-w+rho z)/sd)."""
    rho = _clip_rho(rho)
    base = 1.0 - torch.arccos(rho) / math.pi
    hi = min(w, ZMAX)
    if hi <= 0.0:
        return base
    r = rho[..., None]
    sd = torch.sqrt(1.0 - r * r)
    z, wz = interval_nodes(0.0, hi, order)
    return base - 4.0 * torch.sum(phi(z) * Phi((-w + r * z) / sd) * wz, dim=-1)


def _sign(rho, w: float = 0.0):
    """P_1 (Eq. 19): 1 - acos(rho)/pi."""
    return 1.0 - torch.arccos(_clip_rho(rho)) / math.pi


_PROB = {"uniform": _uniform, "offset": _offset, "2bit": _2bit,
         "sign": _sign}


def collision_prob(rho, w: float, scheme: str):
    """Collision probability P(rho; w) of ``scheme`` (float64)."""
    try:
        fn = _PROB[scheme]
    except KeyError:
        raise ValueError(f"unknown scheme {scheme!r}; one of {SCHEMES}") from None
    return fn(rho, float(w))
