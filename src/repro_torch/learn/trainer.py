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

Observability, under the reference's names: each fit runs under a
``learn.fit`` span and adds to ``learn.rows``, ``learn.steps`` and the
``learn.fit_s`` histogram of the default registry (``fit_words`` also
appends a ``learn.fit`` flight event); each minibatch step runs under a
``learn.step`` span, timed into ``learn.step_s`` only under a deep
tracer (whose span sync would otherwise serialise the steps).

``packed_grads_sharded``
    One data-parallel gradient over a ``DeviceMesh`` dim: rows padded to
    a multiple of 32 * world (the padding carried as dead validity bits),
    each rank running the masked kernels on its own block, the data loss
    and gradients all-reduced, the L2 term added once. ``fit_words`` and
    ``fit_store`` with ``mesh=`` take every gradient through it.

``quality`` (an ``obs.quality.QualityMonitors``) on ``fit_words``,
``fit_store`` and ``fit_log`` receives the trained model's margins over
a seeded sample of at most ``cfg.margin_sample`` rows: the calibration
baseline of its ``margin_mean`` drift series.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import packing as _packing
from repro_torch.learn.features import PackedFeatureSpec, feature_spec_for
from repro_torch.learn.linear import (LearnConfig, PackedLinearModel,
                                      _zeros_params, adam_cosine_train,
                                      adam_update, full_batch_fit,
                                      packed_data_grads,
                                      packed_loss_and_grads, targets_pm)
from repro_torch.obs import (deep_tracing_active, default_flight_recorder,
                             default_registry, span)
from repro_torch.parallel.collectives import all_reduce_sum, axis_group

__all__ = ["fit_words", "fit_store", "fit_log", "packed_grads_sharded"]


def _as_fspec(spec, k: int = None,
              normalize: bool = True) -> PackedFeatureSpec:
    """Accept a PackedFeatureSpec, a CodeSpec (+ k), or a sketcher."""
    if isinstance(spec, PackedFeatureSpec):
        return spec
    return feature_spec_for(spec, k, normalize=normalize)


def _observe_fit_margins(model, words, quality, seed: int) -> None:
    """Feed a trained model's margins over a seeded sample of rows (the
    reference's draw: ``np.random.default_rng(seed).choice(n, cap,
    replace=False)``, sorted) to an ``obs.quality.QualityMonitors``
    bundle: the post-fit calibration snapshot its ``margin_mean`` drift
    series baselines against."""
    if quality is None or not quality.enabled:
        return
    n = int(words.shape[0])
    if n == 0:
        return
    cap = quality.cfg.margin_sample
    if n > cap:
        idx = np.random.default_rng(seed).choice(n, size=cap, replace=False)
        words = words[torch.from_numpy(np.sort(idx)).to(words.device)]
    quality.observe_margins(model.margins(words))


@torch.no_grad()
def packed_grads_sharded(params, words, y_pm, fspec: PackedFeatureSpec,
                         mesh, axis: str = "data", *, c: float = 1.0,
                         loss: str = "sq_hinge", valid_words=None,
                         impl: str = "auto"):
    """One data-parallel full objective and gradient over ``mesh[axis]``.

    Every rank holds all rows of ``words`` int32 [n, W] and the targets
    ``y_pm`` [C, n]. The rows are padded to a multiple of 32 * world
    (padded rows get y = +1 and dead validity bits: data, not shape);
    rank r runs ``packed_data_grads`` (the masked forward and backward)
    on its block of rows with the block's validity words; the data loss
    and both gradients are all-reduced; the L2 term is added once.
    Returns (loss, (dTables, dBias)), the same on every rank and equal
    to ``packed_loss_and_grads`` up to float summation order."""
    block = _rank_block(words, y_pm, valid_words, mesh, axis)
    return _block_grads(params, block, fspec, mesh, axis, c, loss, impl)


def _rank_block(words, y_pm, valid_words, mesh, axis: str) -> tuple:
    """This rank's (words, targets, validity words) of the rows padded
    to a multiple of 32 * world, as ``packed_grads_sharded`` splits
    them."""
    _, rank, world = axis_group(mesh, axis, words)
    n = words.shape[0]
    live = (torch.ones(n, dtype=torch.bool, device=words.device)
            if valid_words is None
            else _packing.unpack_bitmask(valid_words, n))
    pad = (-n) % (32 * world)
    if pad:
        words = torch.nn.functional.pad(words, (0, 0, 0, pad))
        y_pm = torch.nn.functional.pad(y_pm, (0, pad), value=1.0)
        live = torch.nn.functional.pad(live, (0, pad))
    n_local = (n + pad) // world
    lo, hi = rank * n_local, (rank + 1) * n_local
    vw = _packing.pack_bitmask(live[lo:hi])
    return words[lo:hi], y_pm[:, lo:hi].contiguous(), vw


@torch.no_grad()
def _block_grads(params, block, fspec, mesh, axis, c, loss, impl):
    """The objective and gradient from this rank's block: its data term,
    all-reduced over the dim in one collective, and the L2 term."""
    words, y_pm, vw = block
    tables = params[0]
    data_loss, (dt, db) = packed_data_grads(
        params, words, y_pm, fspec, c=c, loss=loss, valid_words=vw,
        impl=impl)
    # one all-reduce of [loss, dTables, dBias]: each entry is still the
    # sum of the ranks' values, as the reference's three psums give it
    flat = all_reduce_sum(torch.cat([data_loss.reshape(1), dt.reshape(-1),
                                     db]), mesh, axis)
    data_loss = flat[0]
    dt = flat[1:1 + dt.numel()].reshape(dt.shape)
    db = flat[1 + dt.numel():]
    return (0.5 * torch.sum(tables * tables) + data_loss,
            (dt + tables, db))


@torch.no_grad()
def _fit_minibatch(words, y_pm, fspec, cfg, mesh=None, axis="data"):
    n = words.shape[0]
    if cfg.batch > n:
        raise ValueError(f"batch {cfg.batch} > rows {n}")
    params = _zeros_params(fspec, y_pm.shape[0], words.device)
    m = tuple(torch.zeros_like(p) for p in params)
    v = tuple(torch.zeros_like(p) for p in params)
    rng = np.random.default_rng(cfg.seed)
    h_step = default_registry().histogram("learn.step_s")
    traced = deep_tracing_active()
    for i in range(cfg.steps):
        idx = torch.from_numpy(rng.choice(n, size=cfg.batch,
                                          replace=False)).to(words.device)
        t0 = time.perf_counter()
        with span("learn.step", step=i) as sp:
            if mesh is not None:
                g = packed_grads_sharded(params, words[idx], y_pm[:, idx],
                                         fspec, mesh, axis, c=cfg.c,
                                         loss=cfg.loss, impl=cfg.impl)[1]
            else:
                g = packed_loss_and_grads(params, words[idx], y_pm[:, idx],
                                          fspec, c=cfg.c, loss=cfg.loss,
                                          impl=cfg.impl)[1]
            adam_update(params, m, v, g, i, cfg.steps, cfg.lr)
            sp.sync(params)
        if traced:
            h_step.observe(time.perf_counter() - t0)
    return params


def _finish(sp, tables: torch.Tensor, bias: torch.Tensor) -> None:
    """Close a fit on its results: the span's sync, and a device sync
    in any case, so ``learn.fit_s`` is an execution time."""
    sp.sync((tables, bias))
    if tables.is_cuda:
        torch.cuda.synchronize(tables.device)


def _count_fit(n: int, steps: int, t0: float) -> float:
    reg = default_registry()
    reg.counter("learn.rows").inc(n)
    reg.counter("learn.steps").inc(steps)
    t1 = time.perf_counter()
    reg.histogram("learn.fit_s").observe(t1 - t0)
    return t1


def fit_words(words, y, spec, cfg: LearnConfig = LearnConfig(), *,
              k: int = None, valid_words=None, n_outputs: int = 1,
              normalize: bool = True, mesh=None, axis: str = "data",
              quality=None) -> PackedLinearModel:
    """Train a packed linear model on int32 words [n, W] (on the device
    it trains on).

    ``spec``: PackedFeatureSpec, CodeSpec (+ ``k``), or a sketcher. y:
    ±1 [n] (binary) or int class ids (``n_outputs`` > 1), any array or
    tensor. ``cfg.batch`` 0 trains full batch; > 0 streams minibatches.
    ``valid_words`` masks tombstoned rows (full batch only). ``mesh``
    (a ``DeviceMesh`` on the words' device type) runs every gradient
    data-parallel over ``mesh[axis]`` (``packed_grads_sharded``).
    ``quality`` (an ``obs.quality.QualityMonitors``) receives the trained
    model's margins over a sampled row subset."""
    fspec = _as_fspec(spec, k, normalize=normalize)
    y_pm = targets_pm(y, n_outputs, words.device)
    if cfg.batch and valid_words is not None:
        raise ValueError("minibatch + validity mask unsupported; "
                         "train full-batch or drop dead rows")
    n = int(words.shape[0])
    t0 = time.perf_counter()
    with span("learn.fit", rows=n, steps=cfg.steps) as sp:
        if cfg.batch:
            tables, bias = _fit_minibatch(words, y_pm, fspec, cfg, mesh,
                                          axis)
        else:
            grad_fn = None
            if mesh is not None:
                # the rows split once; each step runs the block and one
                # all-reduce, as packed_grads_sharded would
                block = _rank_block(words, y_pm, valid_words, mesh, axis)

                def grad_fn(p):
                    return _block_grads(p, block, fspec, mesh, axis, cfg.c,
                                        cfg.loss, cfg.impl)[1]
            tables, bias = full_batch_fit(words, y_pm, fspec, cfg,
                                          valid_words=valid_words,
                                          grad_fn=grad_fn)
        _finish(sp, tables, bias)
    t1 = _count_fit(n, cfg.steps, t0)
    default_flight_recorder().record("learn.fit", t0, t1, batch=n,
                                     synced=True)
    model = PackedLinearModel(fspec=fspec, tables=tables, bias=bias,
                              loss=cfg.loss)
    _observe_fit_margins(model, words, quality, cfg.seed)
    return model


def _check_store(fspec: PackedFeatureSpec, store) -> None:
    if (fspec.k, fspec.bits) != (store.k, store.bits):
        raise ValueError(f"spec k/bits {(fspec.k, fspec.bits)} != store "
                         f"{(store.k, store.bits)}")


def fit_store(store, y, spec, cfg: LearnConfig = LearnConfig(), *,
              n_outputs: int = 1, normalize: bool = True, mesh=None,
              axis: str = "data", quality=None) -> PackedLinearModel:
    """Train straight off an ``ann.CodeStore``: its packed words are the
    training set. ``spec`` supplies n_codes (a CodeSpec or sketcher; k
    and bits are checked against the store); ``mesh``, ``axis`` and
    ``quality`` as for ``fit_words``."""
    fspec = _as_fspec(spec, getattr(store, "k", None), normalize=normalize)
    _check_store(fspec, store)
    return fit_words(store.words, y, fspec, cfg, n_outputs=n_outputs,
                     mesh=mesh, axis=axis, quality=quality)


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
    mutate, then refit to pick up churn: subscribe the refit to a
    ``quality`` bundle's drift alarms (``on_drift``) and pass the same
    bundle here, so each refit re-baselines the margin series over
    ``live_words()``."""
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

    t0 = time.perf_counter()
    with span("learn.fit", rows=store.n_live, steps=cfg.steps) as sp:
        tables, bias = adam_cosine_train(params, grad_fn, cfg.steps, cfg.lr)
        _finish(sp, tables, bias)
    _count_fit(store.n_live, cfg.steps, t0)
    model = PackedLinearModel(fspec=fspec, tables=tables, bias=bias,
                              loss=cfg.loss)
    if quality is not None and quality.enabled:
        _observe_fit_margins(model, store.live_words(), quality, cfg.seed)
    return model
