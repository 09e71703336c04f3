"""Asymptotic estimator variances (paper Thms 2-4, Eq. 20).

Counterpart of ``repro/core/variance.py``, in float64 on the CPU as
``probabilities`` is. Every scheme's rho-estimator inverts a monotone
collision curve, so by the delta method Var(rho_hat) = V / k + O(1/k^2)
with V = P (1 - P) / (dP/drho)^2; dP/drho is the paper's analytic
derivative (appendices B-D).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.probabilities import (ZMAX, _clip_rho, phi,
                                            collision_prob_2bit,
                                            collision_prob_offset,
                                            collision_prob_sign,
                                            collision_prob_uniform)

__all__ = [
    "dP_drho_uniform", "dP_drho_offset", "dP_drho_2bit", "dP_drho_sign",
    "variance_factor_uniform", "variance_factor_offset",
    "variance_factor_2bit", "variance_factor_sign", "variance_factor",
    "dP_drho",
]


def dP_drho_uniform(rho, w: float):
    """Appendix C: dP_w/drho = (1/(pi s)) sum_i [e^{-(i+1)^2 w^2/(1+rho)}
    + e^{-i^2 w^2/(1+rho)} - 2 e^{-w^2/(2(1-rho^2))} e^{-i(i+1) w^2/(1+rho)}]."""
    w = float(w)
    n_terms = max(2, int(math.ceil(ZMAX / w)) + 1)
    rho = _clip_rho(rho)
    r = rho[..., None]
    s2 = 1.0 - r * r
    i = torch.arange(n_terms, dtype=torch.float64)
    w2 = w * w
    term = (torch.exp(-((i + 1.0) ** 2) * w2 / (1.0 + r))
            + torch.exp(-(i ** 2) * w2 / (1.0 + r))
            - 2.0 * torch.exp(-w2 / (2.0 * s2))
            * torch.exp(-i * (i + 1.0) * w2 / (1.0 + r)))
    return torch.sum(term, dim=-1) / (math.pi * torch.sqrt(1.0 - rho * rho))


def dP_drho_offset(rho, w: float):
    """Appendix B: dP_{w,q}/drho = 2 (1/sqrt(2 pi) - phi(r)) / (r d), with
    r = w / sqrt(d), d = 2 (1 - rho)."""
    d = torch.clamp(2.0 * (1.0 - _clip_rho(rho)), min=1e-24)
    r = float(w) / torch.sqrt(d)
    return 2.0 * (1.0 / math.sqrt(2.0 * math.pi) - phi(r)) / (r * d)


def dP_drho_2bit(rho, w: float):
    """Appendix D: dP_{w,2}/drho = (1/(pi s)) [1 - 2 e^{-w^2/(2 s^2)}
    + 2 e^{-w^2/(1+rho)}], s = sqrt(1 - rho^2)."""
    rho = _clip_rho(rho)
    s2 = 1.0 - rho * rho
    w2 = float(w) ** 2
    bracket = (1.0 - 2.0 * torch.exp(-w2 / (2.0 * s2))
               + 2.0 * torch.exp(-w2 / (1.0 + rho)))
    return bracket / (math.pi * torch.sqrt(s2))


def dP_drho_sign(rho, w: float = 0.0):
    """dP_1/drho = 1 / (pi sqrt(1 - rho^2))."""
    rho = _clip_rho(rho)
    return 1.0 / (math.pi * torch.sqrt(1.0 - rho * rho))


def _v(p, dp):
    return p * (1.0 - p) / torch.clamp(dp * dp, min=1e-30)


def variance_factor_uniform(rho, w: float):
    """V_w (Thm 3)."""
    return _v(collision_prob_uniform(rho, w), dP_drho_uniform(rho, w))


def variance_factor_offset(rho, w: float):
    """V_{w,q} (Thm 2, Eq. 13)."""
    return _v(collision_prob_offset(rho, w), dP_drho_offset(rho, w))


def variance_factor_2bit(rho, w: float):
    """V_{w,2} (Thm 4, Eq. 18)."""
    return _v(collision_prob_2bit(rho, w), dP_drho_2bit(rho, w))


def variance_factor_sign(rho, w: float = 0.0):
    """V_1 (Eq. 20) = pi^2 (1 - rho^2) P_1 (1 - P_1)."""
    rho = _clip_rho(rho)
    p = collision_prob_sign(rho)
    return math.pi ** 2 * (1.0 - rho * rho) * p * (1.0 - p)


_VAR = {"uniform": variance_factor_uniform, "offset": variance_factor_offset,
        "2bit": variance_factor_2bit, "sign": variance_factor_sign}
_DP = {"uniform": dP_drho_uniform, "offset": dP_drho_offset,
       "2bit": dP_drho_2bit, "sign": dP_drho_sign}


def variance_factor(rho, w: float, scheme: str):
    """Leading variance constant V of Var(rho_hat) ~ V / k (float64)."""
    return _VAR[scheme](rho, w)


def dP_drho(rho, w: float, scheme: str):
    """dP/drho of ``scheme`` at bin width w (float64)."""
    return _DP[scheme](rho, w)
