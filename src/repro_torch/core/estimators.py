"""Similarity estimators from empirical collision fractions (paper §3).

Counterpart of ``repro/core/estimators.py:31-73``: rho_hat = P^{-1}(P_hat)
by inverting a tabulated P(rho). The table is built in float64 and held
in float32, and the interpolation runs in float32, as ``jnp.interp``
does with 64-bit types off.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.probabilities import collision_prob

__all__ = ["CollisionEstimator", "rho_from_sign_collision", "interp"]


def rho_from_sign_collision(p_hat: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of P_1 = 1 - acos(rho)/pi."""
    return torch.cos(math.pi * (1.0 - p_hat.clamp(0.5, 1.0)))


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` with constant ends: fp[0] below xp[0], fp[-1]
    above xp[-1]; segments of zero width take their left value."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, xp.numel() - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    dx = xp[i] - x0
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, f0,
                    f0 + ((x - x0) / torch.where(dx0, torch.ones_like(dx), dx))
                    * (fp[i] - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class CollisionEstimator:
    """rho_hat = P^{-1}(P_hat) by table inversion (one table per scheme
    and w; moved to each device once)."""

    def __init__(self, scheme: str, w: float = 1.0, grid_size: int = 4096,
                 rho_max: float = 0.99995):
        self.scheme, self.w = scheme, float(w)
        rho = np.linspace(0.0, rho_max, grid_size)
        p = collision_prob(torch.from_numpy(rho), self.w, scheme).numpy()
        # strict monotonicity for the inversion (tails can plateau)
        p = np.maximum.accumulate(p) + 1e-12 * np.arange(grid_size)
        self._grids = {}
        self._p = torch.from_numpy(p.astype(np.float32))
        self._rho = torch.from_numpy(rho.astype(np.float32))

    def _on(self, device):
        key = str(device)
        if key not in self._grids:
            self._grids[key] = (self._p.to(device), self._rho.to(device))
        return self._grids[key]

    def __call__(self, p_hat: torch.Tensor) -> torch.Tensor:
        """Empirical collision fraction(s), float32 -> rho_hat float32."""
        p_grid, rho_grid = self._on(p_hat.device)
        return interp(p_hat.to(torch.float32), p_grid, rho_grid)

    def estimate(self, codes_a: torch.Tensor, codes_b: torch.Tensor) -> torch.Tensor:
        """rho_hat from two code arrays [..., k]."""
        return self((codes_a == codes_b).to(torch.float32).mean(dim=-1))
