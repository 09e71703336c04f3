"""Training loops: where the rows come from and how steps are paced.

Counterpart of ``repro/learn/trainer.py``. ``learn.linear`` owns one
gradient evaluation; this module owns:

``fit_words``
    Full batch (``cfg.batch == 0``) or minibatch: each step draws its
    rows on the host exactly as the reference does
    (``np.random.default_rng(cfg.seed).choice(n, size=batch,
    replace=False)``, so both packages see identical batches), gathers
    them on the device and updates the weight and moment buffers in
    place.
``fit_store``
    Batches straight off an ``ann.CodeStore``: the packed corpus that
    serves search is the training set, with no copy.
``fit_log``
    Training over a live ``index.SegmentLogStore``: each step runs the
    masked kernels per segment (tombstoned and unwritten rows add
    nothing), sums the segments' data gradients in log order and adds
    the L2 term once. Labels are keyed by external id, so deletes,
    upserts and compaction never invalidate them.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
item: ``packed_grads_sharded`` and ``fit_words(mesh=...)`` (queue A item
4, with ``search_sharded``), ``quality=`` (item 10). The reference's
``repro.obs`` spans, counters and flight-recorder events wait for item 7.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.learn.features import PackedFeatureSpec, feature_spec_for
from repro_torch.learn.linear import (LearnConfig, PackedLinearModel,
                                      _zeros_params, adam_cosine_train,
                                      adam_update, full_batch_fit,
                                      packed_data_grads,
                                      packed_loss_and_grads, targets_pm)

__all__ = ["fit_words", "fit_store", "fit_log", "packed_grads_sharded"]


def _as_fspec(spec, k: int = None,
              normalize: bool = True) -> PackedFeatureSpec:
    """Accept a PackedFeatureSpec, a CodeSpec (+ k), or a sketcher."""
    if isinstance(spec, PackedFeatureSpec):
        return spec
    return feature_spec_for(spec, k, normalize=normalize)


def _not_ported(mesh=None, quality=None) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded training (mesh=, packed_grads_sharded) is not ported "
            "yet: ROADMAP queue A item 4, with search_sharded")
    if quality is not None:
        raise NotImplementedError(
            "quality monitors (quality=) are not ported yet: ROADMAP queue "
            "A item 10")


def packed_grads_sharded(*args, **kwargs):
    """The reference's data-parallel gradient (``shard_map`` with a
    ``psum``); raises ``NotImplementedError`` naming ROADMAP queue A
    item 4."""
    _not_ported(mesh=True)


@torch.no_grad()
def _fit_minibatch(words, y_pm, fspec, cfg):
    n = words.shape[0]
    if cfg.batch > n:
        raise ValueError(f"batch {cfg.batch} > rows {n}")
    params = _zeros_params(fspec, y_pm.shape[0], words.device)
    m = tuple(torch.zeros_like(p) for p in params)
    v = tuple(torch.zeros_like(p) for p in params)
    rng = np.random.default_rng(cfg.seed)
    for i in range(cfg.steps):
        idx = torch.from_numpy(rng.choice(n, size=cfg.batch,
                                          replace=False)).to(words.device)
        g = packed_loss_and_grads(params, words[idx], y_pm[:, idx], fspec,
                                  c=cfg.c, loss=cfg.loss, impl=cfg.impl)[1]
        adam_update(params, m, v, g, i, cfg.steps, cfg.lr)
    return params


def fit_words(words, y, spec, cfg: LearnConfig = LearnConfig(), *,
              k: int = None, valid_words=None, n_outputs: int = 1,
              normalize: bool = True, mesh=None, axis: str = "data",
              quality=None) -> PackedLinearModel:
    """Train a packed linear model on int32 words [n, W] (on the device
    it trains on).

    ``spec``: PackedFeatureSpec, CodeSpec (+ ``k``), or a sketcher. y:
    ±1 [n] (binary) or int class ids (``n_outputs`` > 1), any array or
    tensor. ``cfg.batch`` 0 trains full batch; > 0 streams minibatches.
    ``valid_words`` masks tombstoned rows (full batch only)."""
    _not_ported(mesh, quality)
    del axis
    fspec = _as_fspec(spec, k, normalize=normalize)
    y_pm = targets_pm(y, n_outputs, words.device)
    if cfg.batch:
        if valid_words is not None:
            raise ValueError("minibatch + validity mask unsupported; "
                             "train full-batch or drop dead rows")
        tables, bias = _fit_minibatch(words, y_pm, fspec, cfg)
    else:
        tables, bias = full_batch_fit(words, y_pm, fspec, cfg,
                                      valid_words=valid_words)
    return PackedLinearModel(fspec=fspec, tables=tables, bias=bias,
                             loss=cfg.loss)


def _check_store(fspec: PackedFeatureSpec, store) -> None:
    if (fspec.k, fspec.bits) != (store.k, store.bits):
        raise ValueError(f"spec k/bits {(fspec.k, fspec.bits)} != store "
                         f"{(store.k, store.bits)}")


def fit_store(store, y, spec, cfg: LearnConfig = LearnConfig(), *,
              n_outputs: int = 1, normalize: bool = True, mesh=None,
              axis: str = "data") -> PackedLinearModel:
    """Train straight off an ``ann.CodeStore``: its packed words are the
    training set. ``spec`` supplies n_codes (a CodeSpec or sketcher; k
    and bits are checked against the store)."""
    _not_ported(mesh)
    fspec = _as_fspec(spec, getattr(store, "k", None), normalize=normalize)
    _check_store(fspec, store)
    return fit_words(store.words, y, fspec, cfg, n_outputs=n_outputs)


def _segment_targets(seg, labels, n_outputs: int) -> torch.Tensor:
    """±1 targets [C, cap] of one segment from an external-id label map
    (mapping id -> label, or callable(ids int64 [m]) -> labels [m]).
    Only live rows are looked up (a live id missing from a mapping raises
    KeyError); other slots get +1, which the validity mask keeps out of
    loss and gradient."""
    y = np.full(seg.cap, 1, np.int64)
    rows = seg.live_rows()
    if rows.size:
        ids = seg.ids[rows]
        if callable(labels):
            y[rows] = np.asarray(labels(ids), np.int64)
        else:
            y[rows] = [int(labels[int(i)]) for i in ids]
    return targets_pm(torch.from_numpy(y), n_outputs, seg.words.device)


def fit_log(store, labels, spec, cfg: LearnConfig = LearnConfig(), *,
            n_outputs: int = 1, normalize: bool = True,
            quality=None) -> PackedLinearModel:
    """Train over a live mutable index (``index.SegmentLogStore``).

    Each step runs the masked kernels per live segment, sums the
    segments' data gradients in log order onto zeros and adds the L2
    term once. ``labels`` maps external ids to labels (dict-like or
    callable(ids) -> labels). The segments are read at call time;
    mutate, then refit to pick up churn."""
    _not_ported(quality=quality)
    if cfg.batch:
        raise ValueError("fit_log trains full-batch over the segment "
                         "snapshot; cfg.batch is unsupported (stream "
                         "minibatches with fit_words over live_words())")
    fspec = _as_fspec(spec, store.k, normalize=normalize)
    _check_store(fspec, store)
    if store.n_live == 0:
        raise ValueError("store has no live rows")
    parts = tuple((seg.words, seg.valid_dev(),
                   _segment_targets(seg, labels, n_outputs))
                  for seg in store.segments() if seg.live)
    params = _zeros_params(fspec, n_outputs, store.device)

    def grad_fn(p):
        tables, bias = p
        dt, db = torch.zeros_like(tables), torch.zeros_like(bias)
        for words, vw, y_pm in parts:
            _, (dt_s, db_s) = packed_data_grads(
                p, words, y_pm, fspec, c=cfg.c, loss=cfg.loss,
                valid_words=vw, impl=cfg.impl)
            dt = dt + dt_s
            db = db + db_s
        return (dt + tables, db)

    tables, bias = adam_cosine_train(params, grad_fn, cfg.steps, cfg.lr)
    return PackedLinearModel(fspec=fspec, tables=tables, bias=bias,
                             loss=cfg.loss)
