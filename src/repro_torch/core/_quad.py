"""Fixed-order Gauss-Legendre quadrature (counterpart of ``repro/core/_quad.py``)."""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["leggauss", "interval_nodes"]


@functools.lru_cache(maxsize=32)
def leggauss(order: int):
    """Gauss-Legendre nodes and weights on [-1, 1], float64 numpy."""
    x, w = np.polynomial.legendre.leggauss(order)
    return x.astype(np.float64), w.astype(np.float64)


def interval_nodes(a, b, order: int):
    """Nodes and weights over [a, b] (float64 tensors, broadcastable):
    shapes broadcast(a, b).shape + (order,)."""
    x, w = leggauss(order)
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64)
    half = (0.5 * (b - a))[..., None]
    mid = (0.5 * (b + a))[..., None]
    return mid + half * torch.from_numpy(x), half * torch.from_numpy(w)
