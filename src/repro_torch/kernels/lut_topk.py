"""Wrappers of the LUT-scored streaming top-k CUDA kernels
(``csrc/lut_topk.cu``).

Counterparts of ``repro/kernels/packed_lut.py``:

* ``packed_lut_topk_cuda`` (``packed_lut_topk_pallas``): float32 or bf16
  tables [Q, F*P] x corpus words int32 [N, W] -> (scores float32, ids
  int32) [Q, top_k], the stable top-k by LUT score, (-inf, -1) in empty
  slots;
* ``packed_lut_topk_masked_cuda`` (``packed_lut_topk_masked_pallas``):
  the same over the rows whose bit is set in a validity bitmask int32
  [ceil(N/32)]; dead rows never surface.

``n_ranges`` (S, the corpus ranges a query is split over; default
``packed_collision.n_ranges``) is the kernels' launch knob: the partial
lists merge in range order under the strictly-beats rule, so any S gives
the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.packed_collision import (check_valid, check_words,
                                                  resolve_ranges)
from repro_torch.kernels.packed_lut import check_tables

__all__ = ["packed_lut_topk_cuda", "packed_lut_topk_masked_cuda",
           "launches", "masked_launches"]

# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0          # packed_lut_topk
masked_launches = 0   # packed_lut_topk_masked

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lut_topk(tables, words_db, valid_words, bits: int, top_k: int,
              n_ranges):
    global launches, masked_launches
    from repro_torch.kernels import _build
    _, n, w = check_words(words_db, words_db, bits)   # the corpus alone
    nq = tables.shape[0] if tables.dim() == 2 else -1
    code = check_tables(tables, nq, w, bits, (torch.float32, torch.bfloat16))
    if tables.device != words_db.device:
        raise ValueError(f"tables on {tables.device}, words on "
                         f"{words_db.device}")
    if valid_words is not None:
        check_valid(valid_words, words_db)
    if top_k < 1:
        raise ValueError(f"top_k must be at least 1, got {top_k}")
    dev = words_db.device
    if nq == 0 or n == 0:
        return (torch.full((nq, top_k), float("-inf"), dtype=torch.float32,
                           device=dev),
                torch.full((nq, top_k), -1, dtype=torch.int32, device=dev))
    s = resolve_ranges(n_ranges, nq, n, dev)
    part_s = torch.empty((s, nq, top_k), dtype=torch.float32, device=dev)
    part_i = torch.empty((s, nq, top_k), dtype=torch.int32, device=dev)
    scores = torch.empty((nq, top_k), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, top_k), dtype=torch.int32, device=dev)
    tail = [part_s.data_ptr(), part_i.data_ptr(), scores.data_ptr(),
            ids.data_ptr(), nq, n, w, bits, top_k, s,
            torch.cuda.current_stream(dev).cuda_stream]
    types = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    if valid_words is None:
        fn = _build.function("lut_topk", "packed_lut_topk_launch",
                             [_P, _I, _P] + types)
        err = fn(tables.data_ptr(), code, words_db.data_ptr(), *tail)
    else:
        fn = _build.function("lut_topk", "packed_lut_topk_masked_launch",
                             [_P, _I, _P, _P] + types)
        err = fn(tables.data_ptr(), code, words_db.data_ptr(),
                 valid_words.data_ptr(), *tail)
    if err:
        raise RuntimeError(f"packed_lut_topk kernel launch failed: CUDA "
                           f"error {err}")
    if valid_words is None:
        launches += 1
    else:
        masked_launches += 1
    return scores, ids


def packed_lut_topk_cuda(tables: torch.Tensor, words_db: torch.Tensor,
                         bits: int, top_k: int, n_ranges=None):
    """Launches the partial LUT top-k kernel over S corpus ranges and the
    merge kernel -> (scores float32, ids int32) [Q, top_k]."""
    return _lut_topk(tables, words_db, None, bits, top_k, n_ranges)


def packed_lut_topk_masked_cuda(tables: torch.Tensor, words_db: torch.Tensor,
                                valid_words: torch.Tensor, bits: int,
                                top_k: int, n_ranges=None):
    """``packed_lut_topk_cuda`` over the rows whose bit is set in
    ``valid_words`` int32 [ceil(N/32)]; slots past the live count are
    (-inf, -1)."""
    return _lut_topk(tables, words_db, valid_words, bits, top_k, n_ranges)
