"""Optimal bin-width selection (paper Figs. 5, 8).

Counterpart of ``repro/core/optimal.py``: for each similarity rho, the
bin width w*(rho) on a grid that minimises the variance factor
V(rho, w). Evaluated eagerly in float64 (nothing is compiled, so each
width costs only its own arithmetic). The paper's findings: h_w needs
w > 6 (one bit) below rho ~ 0.56 and w < 1 at high rho; h_{w,q} stays
near 1-2; h_{w,2} is flat over rho ~ [0.2, 0.62] and near 0.75-1 at
high rho.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.variance import variance_factor

__all__ = ["optimal_w", "default_w_grid"]


def default_w_grid(w_min: float = 0.05, w_max: float = 12.0, n: int = 240):
    """Geometric grid of bin widths (numpy float64)."""
    return np.geomspace(w_min, w_max, n)


def optimal_w(rho, scheme: str, w_grid=None):
    """Grid-minimise V(rho, w) over w for each rho [R]; returns float64
    tensors (w_star [R], v_star [R]); ties go to the smallest width."""
    if w_grid is None:
        w_grid = default_w_grid()
    rho = torch.as_tensor(rho, dtype=torch.float64)
    vs = torch.stack([variance_factor(rho, float(w), scheme)
                      for w in w_grid], dim=-1)           # [R, W]
    idx = torch.argmin(vs, dim=-1)
    grid = torch.as_tensor(np.asarray(w_grid, np.float64))
    return grid[idx], torch.gather(vs, -1, idx[..., None])[..., 0]
