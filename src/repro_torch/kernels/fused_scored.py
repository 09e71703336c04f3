"""Wrapper of the fused scored search CUDA kernels (``csrc/fused_scored.cu``).

Counterpart of ``repro/kernels/fused_scored.py::fused_scored_topk_pallas``:
query words int32 [Q, W], query tables [Q, F*P] (float32, bf16, or int8
with float32 scales [Q, W]) and corpus words int32 [N, W] -> (scores
float32, corpus ids int32) [Q, top_k]: the stable top-k by LUT score
over the stable top-``rerank_m`` by collision count, (-inf, -1) in empty
slots. ``fused_scored_topk_masked_cuda``
(``fused_scored_topk_masked_pallas``) does the same over the rows whose
bit is set in a validity bitmask int32 [ceil(N/32)].

The count sweep is the one ``packed_collision.plan`` picks for m in
place of top_k (the int8 tensor-core kernel for 1- and 2-bit codes
whose one-hot queries fit shared memory, else the popcount kernel);
``packed_collision.tc_launches`` counts the tensor-core kernel's
launches. Any rerank_m and top_k are answered: survivor lists longer
than 2048 live in device memory (a merged scratch [Q, 2, m]), and the
final selection keeps only per-thread state. ``n_ranges`` (S) is the
launch knob; it changes no bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import packed_collision as _pc
from repro_torch.kernels.packed_collision import check_valid, check_words
from repro_torch.kernels.packed_lut import check_tables

__all__ = ["fused_scored_topk_cuda", "fused_scored_topk_masked_cuda",
           "SMEM_LIST_MAX", "launches", "masked_launches"]

SMEM_LIST_MAX = 2048   # longer survivor lists live in device memory
# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0          # fused_scored_topk
masked_launches = 0   # fused_scored_topk_masked

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fused(words_q, tables, words_db, valid_words, bits: int, k: int,
           rerank_m: int, top_k: int, scales, s):
    """Partial top-``rerank_m`` over S corpus ranges, then merge, score
    and select: the unmasked entry point when ``valid_words`` is None,
    else the masked one."""
    global launches, masked_launches
    from repro_torch.kernels import _build
    nq, n, w = check_words(words_q, words_db, bits)
    if valid_words is not None:
        check_valid(valid_words, words_db)
    code = check_tables(tables, nq, w, bits,
                        (torch.float32, torch.bfloat16, torch.int8))
    if tables.device != words_q.device:
        raise ValueError(f"tables on {tables.device}, words on "
                         f"{words_q.device}")
    if (scales is None) != (tables.dtype != torch.int8):
        raise ValueError("int8 tables need scales, and only int8 tables "
                         "take them")
    if scales is not None and (
            scales.dtype != torch.float32 or tuple(scales.shape) != (nq, w)
            or not scales.is_contiguous() or scales.device != words_q.device):
        raise ValueError(f"scales must be a contiguous float32 tensor "
                         f"[{nq}, {w}] on {words_q.device}, got "
                         f"{scales.dtype} {tuple(scales.shape)} on "
                         f"{scales.device}")
    if rerank_m < 1 or top_k < 1:
        raise ValueError(f"rerank_m and top_k must be at least 1, got "
                         f"{rerank_m}, {top_k}")
    dev = words_q.device
    if nq == 0 or n == 0:
        return (torch.full((nq, top_k), float("-inf"), dtype=torch.float32,
                           device=dev),
                torch.full((nq, top_k), -1, dtype=torch.int32, device=dev))
    p = _pc.plan(nq, n, w, bits, rerank_m, s, dev)
    s = p["n_ranges"]
    part_v = torch.empty((s, nq, rerank_m), dtype=torch.int32, device=dev)
    part_i = torch.empty((s, nq, rerank_m), dtype=torch.int32, device=dev)
    merged = (torch.empty((nq, 2, rerank_m), dtype=torch.int32, device=dev)
              if rerank_m > SMEM_LIST_MAX else None)
    scratch = torch.empty((nq, rerank_m), dtype=torch.float32, device=dev)
    scores = torch.empty((nq, top_k), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, top_k), dtype=torch.int32, device=dev)
    tail = [tables.data_ptr(), code,
            None if scales is None else scales.data_ptr(), part_v.data_ptr(),
            part_i.data_ptr(), None if merged is None else merged.data_ptr(),
            scratch.data_ptr(), scores.data_ptr(),
            ids.data_ptr(), nq, n, w, bits, k, rerank_m, top_k, s,
            *_pc._sweep_args(p), torch.cuda.current_stream(dev).cuda_stream]
    types = [_P, _I, _P, _P, _P, _P, _P, _P, _P] + [_I] * 11 + [_P]
    if valid_words is None:
        fn = _build.function("fused_scored", "fused_scored_launch",
                             [_P, _P] + types)
        err = fn(words_q.data_ptr(), words_db.data_ptr(), *tail)
    else:
        fn = _build.function("fused_scored",
                             "fused_scored_topk_masked_launch",
                             [_P, _P, _P] + types)
        err = fn(words_q.data_ptr(), words_db.data_ptr(),
                 valid_words.data_ptr(), *tail)
    if err:
        raise RuntimeError(f"fused_scored_topk kernel launch failed "
                           f"({p['kernel']} sweep): CUDA error {err}")
    if valid_words is None:
        launches += 1
    else:
        masked_launches += 1
    if p["kernel"] == "tensor":
        _pc.tc_launches += 1
    return scores, ids


def fused_scored_topk_cuda(words_q: torch.Tensor, tables: torch.Tensor,
                           words_db: torch.Tensor, bits: int, k: int,
                           rerank_m: int, top_k: int, scales=None,
                           n_ranges=None):
    """Launches the count sweep for the top-``rerank_m`` over S corpus
    ranges (``packed_collision.plan``) and the merge, score and select
    kernel -> (scores float32, ids
    int32) [Q, top_k]."""
    return _fused(words_q, tables, words_db, None, bits, k, rerank_m, top_k,
                  scales, n_ranges)


def fused_scored_topk_masked_cuda(words_q: torch.Tensor, tables: torch.Tensor,
                                  words_db: torch.Tensor,
                                  valid_words: torch.Tensor, bits: int,
                                  k: int, rerank_m: int, top_k: int,
                                  scales=None, n_ranges=None):
    """``fused_scored_topk_cuda`` over the rows whose bit is set in
    ``valid_words`` int32 [ceil(N/32)]: dead rows take count -1 before
    the survivor rule -> (scores float32, ids int32) [Q, top_k]."""
    return _fused(words_q, tables, words_db, valid_words, bits, k, rerank_m,
                  top_k, scales, n_ranges)
