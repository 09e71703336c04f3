"""Similarity estimators from empirical collision fractions (paper §3).

Counterpart of ``repro/core/estimators.py``: rho_hat = P^{-1}(P_hat)
by inverting a tabulated P(rho), and the maximum-likelihood estimator
over the whole contingency table of the codes (``MleRhoEstimator``). The table is built in float64 and held
in float32, and the interpolation runs in float32, as ``jnp.interp``
does with 64-bit types off. ``cell_probs`` gives the contingency-cell
probabilities the scoring tables of ``rank`` are built from; it runs in
float64, where the reference runs in float32, so tables built from it
agree with the reference's to a relative 1e-4, not bit for bit.

``MleRhoEstimator`` logs that float64 table and holds it in float32
(as the reference holds its own), moved to each device once; its
log-likelihood is one float32 product ``counts @ logp_t`` and its cell
counts one ``torch.bincount`` on the codes' device.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.core._quad import interval_nodes
from repro_torch.core.probabilities import ZMAX, Phi, collision_prob, phi
from repro_torch.core.schemes import CodeSpec
from repro_torch.core.variance import variance_factor

__all__ = ["CollisionEstimator", "rho_from_sign_collision", "interp",
           "region_bounds", "cell_probs", "MleRhoEstimator", "mle_rho_2bit"]


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

    def asymptotic_std(self, rho, k: int) -> torch.Tensor:
        """Predicted std of rho_hat, sqrt(V / k) (Thms 2-4), float64."""
        return torch.sqrt(variance_factor(rho, self.w, self.scheme) / k)


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


class MleRhoEstimator:
    """Maximum-likelihood rho over the full contingency table of a
    scheme's code pairs, by grid argmax (paper §7's extension; the
    follow-up 1602.06577 shows the full table carries most of what 2-bit
    codes know about rho).

    The table of log cell probabilities on a dense rho grid is built
    once on the host; counts may be fractional (expected counts work as
    well as observed ones). Ties in the likelihood go to the lowest grid
    point, as ``jnp.argmax`` gives them.
    """

    def __init__(self, spec: CodeSpec, grid_size: int = 512,
                 rho_max: float = 0.99995):
        self.spec, self.grid_size, self.rho_max = spec, grid_size, rho_max
        n = spec.n_codes
        rho = np.linspace(0.0, rho_max, grid_size)
        probs = cell_probs(torch.from_numpy(rho), spec).numpy()
        logp = np.log(np.maximum(probs, 1e-30)).reshape(grid_size, n * n)
        self._rho = torch.from_numpy(rho.astype(np.float32))
        self._logp_t = torch.from_numpy(
            np.ascontiguousarray(logp.T).astype(np.float32))   # [n*n, G]
        self._tables = {}

    def _on(self, device):
        key = str(device)
        if key not in self._tables:
            self._tables[key] = (self._rho.to(device),
                                 self._logp_t.to(device))
        return self._tables[key]

    @property
    def n_codes(self) -> int:
        return self.spec.n_codes

    def from_counts(self, counts) -> torch.Tensor:
        """Cell counts [..., n*n] (row-major (a, b), float or int) ->
        rho_hat float32 [...] on the counts' device."""
        counts = torch.as_tensor(counts)
        rho, logp_t = self._on(counts.device)
        ll = counts.to(torch.float32) @ logp_t                  # [..., G]
        return rho[torch.argmax(ll, dim=-1)]

    def cell_counts(self, codes_a, codes_b) -> torch.Tensor:
        """int codes [..., k] pairs -> int32 cell counts [..., n*n]: one
        ``bincount`` over each pair's cells offset by its row."""
        codes_a, codes_b = torch.as_tensor(codes_a), torch.as_tensor(codes_b)
        n2 = self.n_codes ** 2
        k = codes_a.shape[-1]
        lead = codes_a.shape[:-1]
        rows = codes_a.numel() // k if k else 0
        cell = (codes_a.to(torch.int64) * self.n_codes
                + codes_b.to(torch.int64)).reshape(rows, k)
        off = torch.arange(rows, device=cell.device)[:, None] * n2
        counts = torch.bincount((cell + off).reshape(-1),
                                minlength=rows * n2)
        return counts.reshape(lead + (n2,)).to(torch.int32)

    def estimate(self, codes_a, codes_b) -> torch.Tensor:
        """MLE rho_hat [...] from two int code arrays [..., k]."""
        return self.from_counts(self.cell_counts(codes_a, codes_b))


@functools.lru_cache(maxsize=8)
def _mle_2bit_estimator(w: float, grid_size: int) -> MleRhoEstimator:
    """The 2-bit estimator of (w, grid_size), built once."""
    return MleRhoEstimator(CodeSpec("2bit", w), grid_size=grid_size)


def mle_rho_2bit(codes_a, codes_b, w: float, grid_size: int = 512):
    """MLE rho_hat [...] of 2-bit codes [..., k] in {0, 1, 2, 3} over the
    4x4 contingency table (a cached ``MleRhoEstimator``)."""
    return _mle_2bit_estimator(float(w), grid_size).estimate(codes_a,
                                                             codes_b)
