"""Carry state across from the JAX package, as numpy arrays.

``sketch_from_numpy`` builds a sketcher around a given R and offset
vector (``r`` = ``crp.stream_encoder().r_matrix()`` of a ``repro``
sketcher, ``offsets`` = its ``_offsets``), so both packages can run on
identical R; ``store_from_numpy`` wraps uint32 words packed by ``repro``
as a searchable ``CodeStore``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ann.store import CodeStore
from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
from repro_torch.device import resolve_device

__all__ = ["sketch_from_numpy", "store_from_numpy"]


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
