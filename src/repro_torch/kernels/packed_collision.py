"""Wrapper of the packed top-k search CUDA kernel (``csrc/packed_topk.cu``).

Counterpart of ``repro/kernels/packed_collision.py::packed_topk_pallas``:
int32 words [Q, W] x [N, W] -> (counts, ids) int32 [Q, top_k], a stable
descending top-k by collision count, (-1, -1) in empty slots.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["packed_topk_cuda", "n_ranges", "MAX_TOP_K", "launches"]

MAX_TOP_K = 2048   # the per-warp lists of a block fit in shared memory
WARPS = 8          # queries per block (csrc/packed_topk.cu)
launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

_P = ctypes.c_void_p
_I = ctypes.c_int


def n_ranges(nq: int, n: int, sms: int) -> int:
    """Corpus ranges S: about 4 blocks per SM over the query tiles, and
    no range under 2048 rows."""
    tiles = -(-nq // WARPS)
    return max(1, min(-(-4 * sms // tiles), n // 2048))


def packed_topk_cuda(words_q: torch.Tensor, words_db: torch.Tensor,
                     bits: int, k: int, top_k: int):
    """Launches the partial top-k kernel over S corpus ranges and the
    merge kernel -> (counts, ids) int32 [Q, top_k]."""
    global launches
    from repro_torch.kernels import _build
    for name, t in (("words_q", words_q), ("words_db", words_db)):
        if not t.is_cuda or t.dtype != torch.int32 or t.dim() != 2 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D int32 CUDA "
                             f"tensor, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    nq, w = words_q.shape
    n = words_db.shape[0]
    if words_db.shape[1] != w or words_db.device != words_q.device:
        raise ValueError(f"words {tuple(words_q.shape)} vs "
                         f"{tuple(words_db.shape)}: widths or devices differ")
    if not 1 <= top_k <= MAX_TOP_K:
        raise ValueError(f"top_k must be in [1, {MAX_TOP_K}], got {top_k}")
    dev = words_q.device
    if nq == 0 or n == 0:
        empty = torch.full((nq, top_k), -1, dtype=torch.int32, device=dev)
        return empty, empty.clone()
    vals = torch.empty((nq, top_k), dtype=torch.int32, device=dev)
    ids = torch.empty((nq, top_k), dtype=torch.int32, device=dev)
    s = n_ranges(nq, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_v = torch.empty((s, nq, top_k), dtype=torch.int32, device=dev)
    part_i = torch.empty((s, nq, top_k), dtype=torch.int32, device=dev)
    fn = _build.function("packed_topk", "packed_topk_launch",
                         [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P])
    err = fn(words_q.data_ptr(), words_db.data_ptr(), part_v.data_ptr(),
             part_i.data_ptr(), vals.data_ptr(), ids.data_ptr(), nq, n, w,
             bits, k, top_k, s, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"packed_topk kernel launch failed: CUDA error {err}")
    launches += 1
    return vals, ids
