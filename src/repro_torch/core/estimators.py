"""Similarity estimators from empirical collision fractions (paper §3).

Counterpart of ``repro/core/estimators.py:31-131``: rho_hat = P^{-1}(P_hat)
by inverting a tabulated P(rho). The table is built in float64 and held
in float32, and the interpolation runs in float32, as ``jnp.interp``
does with 64-bit types off. ``cell_probs`` gives the contingency-cell
probabilities the scoring tables of ``rank`` are built from; it runs in
float64, where the reference runs in float32, so tables built from it
agree with the reference's to a relative 1e-4, not bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core._quad import interval_nodes
from repro_torch.core.probabilities import ZMAX, Phi, collision_prob, phi
from repro_torch.core.schemes import CodeSpec

__all__ = ["CollisionEstimator", "rho_from_sign_collision", "interp",
           "region_bounds", "cell_probs"]


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


def region_bounds(spec: CodeSpec) -> list:
    """Code-region boundaries [(lo_0, hi_0), ...] of a coding scheme.

    Region c is the interval of projected values that encode to code c,
    truncated at |z| = ZMAX. The offset scheme draws an offset per
    projection, so its regions differ across projections: it raises.
    """
    if spec.scheme == "sign":
        return [(-ZMAX, 0.0), (0.0, ZMAX)]
    if spec.scheme == "2bit":
        w = spec.w
        return [(-ZMAX, -w), (-w, 0.0), (0.0, w), (w, ZMAX)]
    if spec.scheme == "uniform":
        n_side = spec.n_bins_side
        out = []
        for c in range(2 * n_side):
            v = c - n_side
            lo = -ZMAX if c == 0 else v * spec.w
            hi = ZMAX if c == 2 * n_side - 1 else (v + 1) * spec.w
            out.append((lo, min(hi, ZMAX)))
        return out
    raise ValueError(
        f"no shared code regions for scheme {spec.scheme!r} (the offset "
        f"scheme's regions are per-projection); use sign/2bit/uniform")


def cell_probs(rho, spec: CodeSpec, order: int = 64) -> torch.Tensor:
    """Contingency-cell probabilities Pr(code(x)=a, code(y)=b | rho),
    float64 [..., n, n] with n = spec.n_codes, by Gauss-Legendre
    quadrature over each pair of code regions under the bivariate
    normal with correlation rho."""
    bounds = region_bounds(spec)
    rho = torch.as_tensor(rho, dtype=torch.float64).clamp(0.0, 1.0 - 1e-7)
    r = rho[..., None]
    sd = torch.sqrt(1.0 - r * r)
    rows = []
    for a, b in bounds:
        z, wz = interval_nodes(a, b, order)
        rows.append(torch.stack(
            [torch.sum(phi(z) * (Phi((d - r * z) / sd) - Phi((c - r * z) / sd))
                       * wz, dim=-1) for c, d in bounds], dim=-1))
    return torch.stack(rows, dim=-2)
