"""Carry state across from the JAX package, as numpy arrays.

``sketch_from_numpy`` builds a sketcher around a given R and offset
vector (``r`` = ``crp.stream_encoder().r_matrix()`` of a ``repro``
sketcher, ``offsets`` = its ``_offsets``), so both packages can run on
identical R; ``store_from_numpy`` wraps uint32 words packed by ``repro``
as a searchable ``CodeStore``; ``rank_tables_from_numpy`` wraps the
arrays of a ``repro.rank.RankTables`` so that both packages score with
identical tables; ``linear_model_from_numpy`` wraps the tables and bias of
a ``repro.learn.PackedLinearModel`` so that both compute the same
margins; ``grad_compressor_from_numpy`` builds a gradient compressor
around a ``repro`` compressor's R (``_r_np``) and offsets, which its own
QR (LAPACK against cuSOLVER or another LAPACK) gives only to rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ann.store import CodeStore
from repro_torch.core.gradient_compression import (GradCompressionConfig,
                                                   GradCompressor)
from repro_torch.core.schemes import CodeSpec
from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
from repro_torch.device import resolve_device
from repro_torch.learn.features import PackedFeatureSpec
from repro_torch.learn.linear import PackedLinearModel
from repro_torch.rank.tables import RankTables

__all__ = ["sketch_from_numpy", "store_from_numpy", "rank_tables_from_numpy",
           "linear_model_from_numpy", "grad_compressor_from_numpy"]


def sketch_from_numpy(cfg: SketchConfig, d: int, r, offsets=None,
                      device=None) -> CodedRandomProjection:
    """Sketcher whose cached R is ``r`` float32 [d, k] and whose offsets
    are ``offsets`` float32 [k] (offset scheme) or None."""
    r = np.asarray(r, dtype=np.float32)
    if r.shape != (d, cfg.k):
        raise ValueError(f"r {r.shape} != ({d}, {cfg.k})")
    crp = CodedRandomProjection(cfg, d, device=device)
    crp.stream_encoder()._rmat = torch.from_numpy(r.copy()).to(crp.device)
    if (offsets is None) != (crp._offsets is None):
        raise ValueError(f"scheme {cfg.scheme!r} and offsets disagree")
    if offsets is not None:
        crp._offsets = torch.from_numpy(
            np.asarray(offsets, dtype=np.float32).copy()).to(crp.device)
    return crp


def store_from_numpy(words_u32, k: int, bits: int, device=None) -> CodeStore:
    """uint32 words [n, W] -> ``CodeStore`` of their int32 bit-views."""
    words = np.ascontiguousarray(words_u32, dtype=np.uint32).view(np.int32)
    return CodeStore(words=torch.from_numpy(words.copy()).to(
        resolve_device(device)), k=k, bits=bits)


def rank_tables_from_numpy(spec: CodeSpec, k: int, pair, rho_grid,
                           score_grid, dtype=torch.float32,
                           device=None) -> RankTables:
    """``RankTables`` holding float32 ``pair`` [P, P], ``rho_grid`` [G]
    and ``score_grid`` [G] as given (``np.asarray`` of a ``repro``
    bundle's fields), with query-table storage ``dtype``."""
    p = 1 << spec.bits
    pair = np.asarray(pair, dtype=np.float32)
    if pair.shape != (p, p):
        raise ValueError(f"pair {pair.shape} != ({p}, {p}) for {spec}")
    dev = resolve_device(device)

    def on(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return RankTables(spec=spec, k=k, pair=on(pair), rho_grid=on(rho_grid),
                      score_grid=on(score_grid), dtype=dtype)


def linear_model_from_numpy(fspec, tables, bias, loss: str = "sq_hinge",
                            device=None) -> PackedLinearModel:
    """``PackedLinearModel`` holding float32 ``tables`` [C, F*P] and
    ``bias`` [C] as given (``np.asarray`` of a ``repro`` model's
    fields). ``fspec`` is the port's ``PackedFeatureSpec`` or any object
    with its four fields (a ``repro`` one)."""
    fspec = PackedFeatureSpec(k=fspec.k, bits=fspec.bits,
                              n_codes=fspec.n_codes,
                              normalize=fspec.normalize)
    tables = np.asarray(tables, dtype=np.float32)
    bias = np.asarray(bias, dtype=np.float32)
    if tables.ndim != 2 or tables.shape[1] != fspec.table_width \
            or bias.shape != (tables.shape[0],):
        raise ValueError(f"tables {tables.shape} / bias {bias.shape} do not "
                         f"fit table width {fspec.table_width}")
    dev = resolve_device(device)
    return PackedLinearModel(
        fspec=fspec, tables=torch.from_numpy(tables.copy()).to(dev),
        bias=torch.from_numpy(bias.copy()).to(dev), loss=loss)


def grad_compressor_from_numpy(cfg: GradCompressionConfig, template, r,
                               offsets=None, device=None) -> GradCompressor:
    """``GradCompressor`` for the tree ``template`` whose R is ``r``
    float32 [chunk, k] and whose offsets are ``offsets`` float32 [k]
    (offset scheme) or None."""
    r = np.asarray(r, dtype=np.float32)
    if r.shape != (cfg.chunk, cfg.k):
        raise ValueError(f"r {r.shape} != ({cfg.chunk}, {cfg.k})")
    comp = GradCompressor(cfg, template, device=device)
    if (offsets is None) != (comp._offsets is None):
        raise ValueError(f"scheme {cfg.scheme!r} and offsets disagree")
    comp._r = torch.from_numpy(r.copy()).to(comp.device)
    if offsets is not None:
        comp._offsets = torch.from_numpy(
            np.asarray(offsets, dtype=np.float32).copy()).to(comp.device)
    return comp
