"""Wrapper of the LUT re-rank CUDA kernel (``csrc/packed_lut.cu``).

Counterpart of ``repro/kernels/packed_lut.py::packed_lut_rerank_pallas``:
float32 or bf16 tables [Q, F*P], candidate words int32 [Q, M, W] and
their validity bool [Q, M] -> (scores float32, candidate positions int32)
[Q, top_k], the stable top-k by LUT score; invalid candidates and empty
slots are (-inf, -1). Any top_k is answered.

Two kernels, chosen by ``rerank_plan`` from the shape alone and before
the launch (a failed launch raises; one never stands in for the other):
``lut_rerank_warp``, one warp a query, its table row and candidates in
the warp's shared memory, CPL = 1, 2 or 4 candidates a lane in registers
and the selection by warp reductions, for 1-, 2- and 4-bit codes with at
most 128 candidates whose table and words take at most
``WARP_SMEM_MAX`` bytes; else ``lut_rerank``, one block a query with a
device-memory scratch. ``warp_launches`` counts the warp kernel's
launches.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["packed_lut_rerank_cuda", "rerank_plan", "check_tables",
           "TABLE_DTYPES", "launches", "warp_launches"]

TABLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the warp kernel: its code widths, a warp's shared memory and a block's
WARP_BITS = (1, 2, 4)
WARP_SMEM_MAX = 48 * 1024
BLOCK_SMEM_MAX = 96 * 1024
# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0       # either kernel
warp_launches = 0  # the warp kernel

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


def rerank_plan(nq: int, m: int, w: int, bits: int, dtype, sms=None,
                device=None) -> dict:
    """The kernel a re-rank call launches, by shape alone: kernel
    ("warp" or "block"), cpl (candidates a lane), warps (queries a
    block), grid and smem (the warp kernel's: each warp's table row,
    rounded up to 16 bytes, and 32 CPL candidate rows of W | 1 words).
    Warps a block: 4, 2 or 1, the most that still give every SM a block
    (``sms`` stands in for the card's), within BLOCK_SMEM_MAX."""
    elem = torch.empty((), dtype=dtype).element_size()
    fp = (w * (32 // bits)) << bits
    cpl = next((c for c in (1, 2, 4) if m <= 32 * c), None)
    per_warp = None if cpl is None else \
        -(-fp * elem // 16) * 16 + 32 * cpl * (w | 1) * 4
    if bits not in WARP_BITS or cpl is None or per_warp > WARP_SMEM_MAX:
        return dict(kernel="block", cpl=None, warps=None, grid=(nq,),
                    smem=None)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    warps = next(wr for wr in (4, 2, 1)
                 if wr == 1 or (nq >= wr * sms
                                and wr * per_warp <= BLOCK_SMEM_MAX))
    return dict(kernel="warp", cpl=cpl, warps=warps,
                grid=(-(-nq // warps),), smem=warps * per_warp)


def packed_lut_rerank_cuda(tables: torch.Tensor, cand_words: torch.Tensor,
                           cand_valid: torch.Tensor, bits: int, top_k: int):
    """Launches the re-rank kernel ``rerank_plan`` picks -> (scores
    float32, positions int32) [Q, top_k]."""
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
    _launch(rerank_plan(nq, m, w, bits, tables.dtype, device=dev), tables,
            code, cand_words, cand_valid, bits, top_k, scores, pos)
    return scores, pos


def _launch(p: dict, tables, code: int, cand_words, cand_valid, bits: int,
            top_k: int, scores, pos) -> None:
    """Launches the kernel of plan ``p`` on checked tensors; counts it."""
    global launches, warp_launches
    from repro_torch.kernels import _build
    nq, m, w = cand_words.shape
    dev = cand_words.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if p["kernel"] == "warp":
        fn = _build.function("packed_lut", "packed_lut_rerank_warp_launch",
                             [_P, _I, _P, _P, _P, _P] + [_I] * 7 + [_P])
        err = fn(tables.data_ptr(), code, cand_words.data_ptr(),
                 cand_valid.data_ptr(), scores.data_ptr(), pos.data_ptr(),
                 nq, m, w, bits, top_k, p["cpl"], p["warps"], stream)
    else:
        scratch = torch.empty((nq, m), dtype=torch.float32, device=dev)
        fn = _build.function("packed_lut", "packed_lut_rerank_launch",
                             [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _P])
        err = fn(tables.data_ptr(), code, cand_words.data_ptr(),
                 cand_valid.data_ptr(), scratch.data_ptr(), scores.data_ptr(),
                 pos.data_ptr(), nq, m, w, bits, top_k, stream)
    if err:
        raise RuntimeError(f"packed_lut_rerank {p['kernel']} kernel launch "
                           f"failed: CUDA error {err}")
    launches += 1
    if p["kernel"] == "warp":
        warp_launches += 1
