"""Linear SVM on coded random projections (paper §6): compat wrapper.

Counterpart of ``repro/core/svm.py``: the historical dense API over
``repro_torch.learn``. ``expand_codes`` is the parity oracle,
``train_linear_svm`` delegates to the dense solver
``learn.train_dense_linear``, ``svm_accuracy`` scores dense weights. New
code should train on packed words (``learn.train_packed_linear``,
``learn.fit_store``), which never builds the one-hot matrix.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.learn.features import expand_codes  # noqa: F401  (compat re-export)
from repro_torch.learn.linear import LearnConfig, train_dense_linear

__all__ = ["expand_codes", "SVMConfig", "train_linear_svm", "svm_accuracy"]


@dataclass(frozen=True)
class SVMConfig:
    """Knobs of the historical dense solver (see ``learn.LearnConfig``)."""
    c: float = 1.0           # L2 regularization tradeoff (LIBLINEAR's C)
    steps: int = 400
    lr: float = 0.1
    seed: int = 0


def train_linear_svm(x, y, cfg: SVMConfig = SVMConfig(),
                     x_val: Optional[torch.Tensor] = None,
                     y_val: Optional[torch.Tensor] = None, *, device=None):
    """Train a binary squared-hinge SVM on dense features x [n, d],
    y ±1 [n] -> (w, b), by ``learn.train_dense_linear`` (tensors stay
    on their device; arrays go to ``device``, the card by default)."""
    return train_dense_linear(
        x, y, LearnConfig(loss="sq_hinge", c=cfg.c, steps=cfg.steps,
                          lr=cfg.lr, seed=cfg.seed), x_val, y_val,
        device=device)


def svm_accuracy(w, b, x, y) -> torch.Tensor:
    """Accuracy of sign(x @ w + b) against ±1 labels (0 counts as +1)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=w.device)
    y = torch.as_tensor(y, dtype=torch.float32, device=w.device)
    pred = torch.sign(x @ w + b)
    pred = torch.where(pred == 0, torch.ones_like(pred), pred)
    return torch.mean((pred == y).to(torch.float32))
