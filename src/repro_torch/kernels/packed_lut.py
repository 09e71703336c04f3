"""Wrapper of the LUT re-rank CUDA kernel (``csrc/packed_lut.cu``).

Counterpart of ``repro/kernels/packed_lut.py::packed_lut_rerank_pallas``:
float32 or bf16 tables [Q, F*P], candidate words int32 [Q, M, W] and
their validity bool [Q, M] -> (scores float32, candidate positions int32)
[Q, top_k], the stable top-k by LUT score; invalid candidates and empty
slots are (-inf, -1). The selection keeps only per-thread state and
reads the scores from a device-memory scratch, so any top_k is answered.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["packed_lut_rerank_cuda", "check_tables", "TABLE_DTYPES",
           "launches"]

TABLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

_P = ctypes.c_void_p
_I = ctypes.c_int


def check_tables(tables: torch.Tensor, nq: int, w: int, bits: int,
                 dtypes) -> int:
    """Raises unless ``tables`` is a contiguous CUDA tensor [nq, F*P] of
    one of ``dtypes`` for W = ``w`` words of ``bits``-bit fields; returns
    the kernel's code for its dtype."""
    fp = w * (32 // bits) << bits
    if not tables.is_cuda or tables.dtype not in dtypes or \
            tuple(tables.shape) != (nq, fp) or not tables.is_contiguous():
        raise ValueError(
            f"tables must be a contiguous CUDA tensor [{nq}, {fp}] of "
            f"{[str(d) for d in dtypes]}, got {tables.dtype} "
            f"{tuple(tables.shape)} on {tables.device}")
    return TABLE_DTYPES[tables.dtype]


def packed_lut_rerank_cuda(tables: torch.Tensor, cand_words: torch.Tensor,
                           cand_valid: torch.Tensor, bits: int, top_k: int):
    """Launches the re-rank kernel, one block a query -> (scores float32,
    positions int32) [Q, top_k]."""
    global launches
    from repro_torch.kernels import _build
    if not cand_words.is_cuda or cand_words.dtype != torch.int32 or \
            cand_words.dim() != 3 or not cand_words.is_contiguous():
        raise ValueError(f"cand_words must be a contiguous int32 CUDA tensor "
                         f"[Q, M, W], got {cand_words.dtype} "
                         f"{tuple(cand_words.shape)} on {cand_words.device}")
    nq, m, w = cand_words.shape
    if bits not in (1, 2, 4, 8, 16):
        raise ValueError(f"bits must be 1, 2, 4, 8 or 16, got {bits}")
    code = check_tables(tables, nq, w, bits, (torch.float32, torch.bfloat16))
    if cand_valid.dtype != torch.bool or tuple(cand_valid.shape) != (nq, m) \
            or not cand_valid.is_contiguous() \
            or cand_valid.device != cand_words.device \
            or tables.device != cand_words.device:
        raise ValueError(f"cand_valid must be a contiguous bool tensor "
                         f"[{nq}, {m}] on {cand_words.device}, got "
                         f"{cand_valid.dtype} {tuple(cand_valid.shape)} on "
                         f"{cand_valid.device}")
    if top_k < 1:
        raise ValueError(f"top_k must be at least 1, got {top_k}")
    dev = cand_words.device
    scores = torch.empty((nq, top_k), dtype=torch.float32, device=dev)
    pos = torch.empty((nq, top_k), dtype=torch.int32, device=dev)
    if nq == 0:
        return scores, pos
    scratch = torch.empty((nq, m), dtype=torch.float32, device=dev)
    fn = _build.function("packed_lut", "packed_lut_rerank_launch",
                         [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _P])
    err = fn(tables.data_ptr(), code, cand_words.data_ptr(),
             cand_valid.data_ptr(), scratch.data_ptr(), scores.data_ptr(),
             pos.data_ptr(), nq, m, w, bits, top_k,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"packed_lut_rerank kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return scores, pos
