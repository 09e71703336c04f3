"""L2 linear classifiers trained directly on packed codes (paper §6).

Counterpart of ``repro/learn/linear.py``. The objective is the
reference's,

    min_W  0.5 ||W||^2 + C * sum_i loss(y_i, margin_i)

with squared hinge (LIBLINEAR's L2R_L2LOSS primal) or logistic loss,
solved by Adam with cosine decay, on the packed words themselves:

* **margins** are per-projection weight-table gathers (the packed-linear
  forward kernel; the one-hot matrix never exists), row normalization
  applied as the scalar ``fspec.scale``;
* **gradients** are explicit, as in the reference: margins, then
  dloss/dmargin, then the backward kernel scatters each row's
  contribution into the [k, 2^b] tables, then ``fspec.entry_mask()``
  keeps phantom columns at zero. All of it runs under ``torch.no_grad``;
* **tombstones**: the masked kernels and a live-row mask on the loss let
  the same step run over a churned ``SegmentLogStore`` segment.

Adam is a Python loop that updates preallocated weight and moment
buffers in place. Numbers: the raw margins and the backward's sum order
are fixed by the kernels' plain versions, so on the card ``impl="auto"``
and ``impl="ref"`` train bit for bit alike. Against JAX the raw margins
are bit-exact; ``raw * scale + bias`` is a multiply and an add here,
where XLA contracts it into one FMA (equal when the scale is a power of
two, k = 256 at 1/16; otherwise within one rounding of the product and
one of the sum), and XLA may contract Adam's moment updates too, so
trained models agree within a tolerance.
``train_dense_linear`` is the dense twin by ``torch.autograd`` over an
explicit feature matrix: the parity oracle and the engine of the
``core.svm`` compat wrappers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import packing as _packing
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as _ops
from repro_torch.learn.features import PackedFeatureSpec

__all__ = ["LearnConfig", "PackedLinearModel", "packed_margins",
           "packed_data_grads", "packed_loss_and_grads", "targets_pm",
           "adam_update", "adam_cosine_train", "full_batch_fit",
           "train_packed_linear", "train_dense_linear"]

_LOSSES = ("sq_hinge", "logistic")
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class LearnConfig:
    """Static training knobs."""
    loss: str = "sq_hinge"   # sq_hinge | logistic
    c: float = 1.0           # data-loss tradeoff (LIBLINEAR's C)
    steps: int = 400         # optimizer steps (full-batch or minibatch)
    lr: float = 0.1          # peak Adam lr (cosine-decayed to 0)
    batch: int = 0           # minibatch rows; 0 = full batch
    seed: int = 0            # batch-sampling seed (minibatch path)
    impl: str = "auto"       # kernel dispatch (see kernels.ops)

    def __post_init__(self):
        if self.loss not in _LOSSES:
            raise ValueError(f"loss must be one of {_LOSSES}, "
                             f"got {self.loss!r}")


def targets_pm(y, n_outputs: int, device=None) -> torch.Tensor:
    """Labels -> ±1 float32 target matrix [C, n] on ``device`` (``y``'s
    own device for a tensor, else the CPU).

    n_outputs == 1 (binary): y [n] in {-1, +1} passes through as [1, n].
    n_outputs > 1 (one-vs-rest): int class ids in [0, n_outputs) become
    +1 at the true class row, -1 elsewhere.
    """
    y = torch.as_tensor(y)
    if device is not None:
        y = y.to(device)
    if n_outputs == 1:
        return y.to(torch.float32)[None, :]
    cls = torch.arange(n_outputs, device=y.device)[:, None]
    one = torch.ones((), dtype=torch.float32, device=y.device)
    return torch.where(y[None, :] == cls, one, -one)


def _loss_and_margin_grad(margins, y_pm, c: float, loss: str, live=None):
    """Data term of the objective and its margin gradient.

    margins/y_pm float32 [C, n]; ``live`` optional bool [n]: dead rows
    add zero loss and zero gradient. Returns (scalar loss_sum,
    g [C, n] = dloss/dmargin)."""
    zero = torch.zeros((), dtype=torch.float32, device=margins.device)
    if loss == "sq_hinge":
        h = torch.clamp_min(1.0 - y_pm * margins, 0.0)
        if live is not None:
            h = torch.where(live[None, :], h, zero)
        return c * torch.sum(h * h), (-2.0 * c) * (y_pm * h)
    z = -y_pm * margins
    ll = torch.logaddexp(z, zero)
    s = torch.sigmoid(z)
    if live is not None:
        ll = torch.where(live[None, :], ll, zero)
        s = torch.where(live[None, :], s, zero)
    return c * torch.sum(ll), -c * (y_pm * s)


def packed_margins(tables, bias, words, fspec: PackedFeatureSpec,
                   valid_words=None, impl: str = "auto") -> torch.Tensor:
    """Model margins on packed rows: tables float32 [C, F*P], bias [C],
    int32 words [n, W] -> float32 [C, n] = scale * gather-sum + bias.
    With ``valid_words`` (packed validity bitmask) the masked forward
    runs; dead rows come back as the bias alone, which every loss masks
    out with the same bitmask."""
    if valid_words is None:
        raw = _ops.packed_linear_fwd(tables, words, fspec.bits, impl=impl)
    else:
        raw = _ops.packed_linear_fwd_masked(tables, words, valid_words,
                                            fspec.bits, impl=impl)
    return raw * fspec.scale + bias[:, None]


@torch.no_grad()
def packed_data_grads(params, words, y_pm, fspec: PackedFeatureSpec,
                      c: float = 1.0, loss: str = "sq_hinge",
                      valid_words=None, impl: str = "auto"):
    """Data term of the objective and its gradients on one packed block.

    params = (tables float32 [C, F*P], bias float32 [C]); y_pm ±1 targets
    [C, n] (``targets_pm``). Returns (data_loss, (dTables, dBias)): the
    backward kernel's scatter scaled by ``fspec.scale``, phantom columns
    masked, and no L2 term, so that callers over several blocks
    (segments) sum the blocks and add the regularizer once."""
    tables, bias = params
    m = packed_margins(tables, bias, words, fspec, valid_words, impl)
    live = (None if valid_words is None
            else _packing.unpack_bitmask(valid_words, words.shape[0]))
    data_loss, g = _loss_and_margin_grad(m, y_pm, c, loss, live)
    if valid_words is None:
        dt = _ops.packed_linear_bwd(g, words, fspec.bits, impl=impl)
    else:
        dt = _ops.packed_linear_bwd_masked(g, words, valid_words,
                                           fspec.bits, impl=impl)
    dt = dt * (fspec.scale * fspec.entry_mask(dt.device))
    return data_loss, (dt, torch.sum(g, dim=1))


@torch.no_grad()
def packed_loss_and_grads(params, words, y_pm, fspec: PackedFeatureSpec,
                          c: float = 1.0, loss: str = "sq_hinge",
                          valid_words=None, impl: str = "auto"):
    """One full objective and gradient on packed rows: ``packed_data_grads``
    plus the L2 term (tables regularized, bias free, LIBLINEAR's
    convention). Returns (loss, (dTables, dBias))."""
    tables, bias = params
    data_loss, (dt, db) = packed_data_grads(params, words, y_pm, fspec,
                                            c, loss, valid_words, impl)
    return (0.5 * torch.sum(tables * tables) + data_loss,
            (dt + tables, db))


def _schedule(i: int, steps: int, lr: float):
    """Step i's float32 scalars, as the reference's traced float32 step
    index gives them: (lr_i, 1 - b1^t, 1 - b2^t) with t = i + 1."""
    f = np.float32
    fi = f(i)
    lr_i = f(lr * 0.5) * (f(1.0) + np.cos(f(np.pi) * fi / f(steps)))
    t = fi + f(1.0)
    return (float(lr_i), float(f(1.0) - f(_B1) ** t),
            float(f(1.0) - f(_B2) ** t))


@torch.no_grad()
def adam_update(params, m, v, g, i: int, steps: int, lr: float):
    """One Adam step with cosine decay, the update rule of every training
    path, IN PLACE on the tuples of tensors ``params``, ``m`` and ``v``
    (gradients ``g``); returns them. The step's scalars are computed in
    float32 on the host, so a step costs no device synchronisation."""
    lr_i, c1, c2 = _schedule(i, steps, lr)
    for p, mm, vv, gg in zip(params, m, v, g):
        mm.mul_(_B1).add_(gg, alpha=1.0 - _B1)
        vv.mul_(_B2).addcmul_(gg, gg, value=1.0 - _B2)
        upd = (mm / c1).mul_(lr_i)
        upd.div_((vv / c2).sqrt_().add_(_EPS))
        p.sub_(upd)
    return params, m, v


@torch.no_grad()
def adam_cosine_train(params, grad_fn, steps: int, lr: float):
    """Full-batch Adam with cosine decay (deterministic), shared by the
    dense and packed paths: ``adam_update`` in a loop over ``steps``,
    updating ``params`` (a tuple of tensors) in place.

    grad_fn(params) -> matching tuple of gradients."""
    m = tuple(torch.zeros_like(p) for p in params)
    v = tuple(torch.zeros_like(p) for p in params)
    for i in range(steps):
        adam_update(params, m, v, grad_fn(params), i, steps, lr)
    return params


@dataclass
class PackedLinearModel:
    """A trained linear classifier in weight-table space.

    tables float32 [C, F*P] (flat ``PackedFeatureSpec`` layout, phantom
    columns zero), bias float32 [C]. C == 1 is a binary model over ±1
    labels; C > 1 is one-vs-rest over int class ids (predict = argmax).
    """
    fspec: PackedFeatureSpec
    tables: torch.Tensor
    bias: torch.Tensor
    loss: str = "sq_hinge"

    @classmethod
    def zeros(cls, fspec: PackedFeatureSpec, n_outputs: int = 1,
              loss: str = "sq_hinge", device=None) -> "PackedLinearModel":
        """Zero-initialized model (the training start point)."""
        dev = resolve_device(device)
        return cls(fspec=fspec,
                   tables=torch.zeros((n_outputs, fspec.table_width),
                                      dtype=torch.float32, device=dev),
                   bias=torch.zeros((n_outputs,), dtype=torch.float32,
                                    device=dev), loss=loss)

    @property
    def n_outputs(self) -> int:
        """Margin rows: 1 for binary, n_classes for one-vs-rest."""
        return self.tables.shape[0]

    def margins(self, words, valid_words=None,
                impl: str = "auto") -> torch.Tensor:
        """Packed rows [n, W] -> margins float32 [C, n]."""
        return packed_margins(self.tables, self.bias, words, self.fspec,
                              valid_words, impl)

    def decision(self, words, impl: str = "auto") -> torch.Tensor:
        """Binary decision values float32 [n] (requires C == 1)."""
        if self.n_outputs != 1:
            raise ValueError("decision() is binary-only; use margins()")
        return self.margins(words, impl=impl)[0]

    def predict_from_margins(self, margins) -> torch.Tensor:
        """Margins [C, n] -> int32 labels [n]: ±1 (binary, zero margin ->
        +1) or class ids (one-vs-rest argmax, the first on ties)."""
        if self.n_outputs == 1:
            one = torch.ones((), dtype=torch.int32, device=margins.device)
            return torch.where(margins[0] >= 0, one, -one)
        return torch.argmax(margins, dim=0).to(torch.int32)

    def predict(self, words, impl: str = "auto") -> torch.Tensor:
        """Predicted labels [n] of a forward pass."""
        return self.predict_from_margins(self.margins(words, impl=impl))

    def accuracy(self, words, y, impl: str = "auto") -> float:
        """Mean prediction accuracy against labels ``y`` (±1 binary or
        int class ids, as ``predict`` gives them)."""
        pred = self.predict(words, impl=impl).cpu().numpy()
        return float(np.mean(pred == np.asarray(torch.as_tensor(y).cpu())))

    def dense_weights(self) -> torch.Tensor:
        """Weights in the dense ``expand_codes`` layout float32
        [C, k*n_codes] (phantom columns dropped)."""
        return self.fspec.dense_from_tables(self.tables)


def _zeros_params(fspec: PackedFeatureSpec, n_outputs: int, device):
    return (torch.zeros((n_outputs, fspec.table_width), dtype=torch.float32,
                        device=device),
            torch.zeros((n_outputs,), dtype=torch.float32, device=device))


@torch.no_grad()
def full_batch_fit(words, y_pm, fspec: PackedFeatureSpec, cfg: LearnConfig,
                   valid_words=None, grad_fn=None):
    """Full-batch training: zero init, then ``cfg.steps`` Adam steps on
    preallocated buffers updated in place. ``grad_fn(params) -> grads``
    replaces the default gradient. Returns (tables, bias)."""
    params = _zeros_params(fspec, y_pm.shape[0], words.device)
    if grad_fn is None:
        def grad_fn(p):
            return packed_loss_and_grads(
                p, words, y_pm, fspec, c=cfg.c, loss=cfg.loss,
                valid_words=valid_words, impl=cfg.impl)[1]
    return adam_cosine_train(params, grad_fn, cfg.steps, cfg.lr)


def train_packed_linear(words, y, fspec: PackedFeatureSpec,
                        cfg: LearnConfig = LearnConfig(), *,
                        valid_words=None,
                        n_outputs: int = 1) -> PackedLinearModel:
    """Full-batch training on packed rows: int32 words [n, W]; y ±1 [n]
    (binary) or int class ids (n_outputs > 1); ``valid_words`` an
    optional packed validity bitmask (dead rows add nothing).
    Minibatch and store-backed variants: ``learn.trainer``."""
    tables, bias = full_batch_fit(
        words, targets_pm(y, n_outputs, words.device), fspec, cfg,
        valid_words=valid_words)
    return PackedLinearModel(fspec=fspec, tables=tables, bias=bias,
                             loss=cfg.loss)


def _dense_objective(params, x, y, c: float, loss: str):
    w, b = params
    margin = y * (x @ w + b)
    if loss == "sq_hinge":
        hinge = torch.clamp_min(1.0 - margin, 0.0)
        return 0.5 * torch.sum(w * w) + c * torch.sum(hinge * hinge)
    return 0.5 * torch.sum(w * w) + c * torch.sum(
        torch.logaddexp(-margin, torch.zeros_like(margin)))


def train_dense_linear(x, y, cfg: LearnConfig = LearnConfig(),
                       x_val: Optional[torch.Tensor] = None,
                       y_val: Optional[torch.Tensor] = None, *,
                       device=None):
    """Dense twin of ``train_packed_linear``: a binary L2 linear
    classifier on an explicit feature matrix x [n, d], y ±1 [n], its
    gradient by ``torch.autograd``. Returns (w float32 [d], b float32
    scalar). Tensors stay on their device; arrays go to ``device`` (the
    card by default). The parity oracle, and the engine of
    ``core.svm.train_linear_svm`` (x_val/y_val accepted for that
    signature, unused)."""
    del x_val, y_val
    dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    y = torch.as_tensor(y, dtype=torch.float32).to(dev)
    params = (torch.zeros((x.shape[1],), dtype=torch.float32, device=dev),
              torch.zeros((), dtype=torch.float32, device=dev))

    def grad_fn(p):
        w, b = (t.detach().requires_grad_() for t in p)
        with torch.enable_grad():
            obj = _dense_objective((w, b), x, y, cfg.c, cfg.loss)
            return torch.autograd.grad(obj, (w, b))

    return adam_cosine_train(params, grad_fn, cfg.steps, cfg.lr)
