"""Wrappers of the packed collision-count CUDA kernels.

Counterparts of ``repro/kernels/packed_collision.py``:

* ``packed_topk_cuda`` (``csrc/packed_topk.cu``, ``packed_topk_pallas``):
  int32 words [Q, W] x [N, W] -> (counts, ids) int32 [Q, top_k], a
  stable descending top-k by collision count, (-1, -1) in empty slots;
* ``packed_topk_masked_cuda`` (``csrc/packed_topk.cu``,
  ``packed_topk_masked_pallas``): the same over the rows whose bit is set
  in a validity bitmask int32 [ceil(N/32)]; dead rows never surface;
* ``packed_collision_counts_cuda`` (``csrc/packed_counts.cu``,
  ``packed_collision_counts_pallas``): the whole int32 count matrix
  [Q, N].

Launch knobs, none of which changes a bit: ``n_ranges`` (S, the corpus
ranges of the top-k kernels; their partial lists merge in range order
under the strictly-beats rule) and ``block_q`` (queries a block of the
count kernel). Any top_k is answered: lists longer than 2048 entries
live in device memory (``csrc/topk_common.cuh``).
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["packed_topk_cuda", "packed_topk_masked_cuda",
           "packed_collision_counts_cuda", "n_ranges", "resolve_ranges",
           "check_words", "check_valid", "COUNT_BLOCK_Q", "launches",
           "masked_launches", "counts_launches"]

WARPS = 8          # queries per block (csrc/packed_topk.cu)
COUNT_BLOCK_Q = 32   # default queries a block of csrc/packed_counts.cu
# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0          # packed_topk
masked_launches = 0   # packed_topk_masked
counts_launches = 0   # packed_collision_counts

_P = ctypes.c_void_p
_I = ctypes.c_int


def n_ranges(nq: int, n: int, sms: int) -> int:
    """Corpus ranges S: about 4 blocks per SM over the query tiles, and
    no range under 2048 rows."""
    tiles = -(-nq // WARPS)
    return max(1, min(-(-4 * sms // tiles), n // 2048))


def resolve_ranges(s, nq: int, n: int, device) -> int:
    """S for a call: ``n_ranges`` of the card when ``s`` is None, else
    ``s`` clamped to [1, n]."""
    if s is None:
        return n_ranges(nq, n, torch.cuda.get_device_properties(
            device).multi_processor_count)
    if int(s) < 1:
        raise ValueError(f"n_ranges must be at least 1, got {s}")
    return min(int(s), n)


def check_words(words_q: torch.Tensor, words_db: torch.Tensor, bits: int):
    """Raises unless both are contiguous 2-D int32 CUDA tensors of one
    width on one device and bits is 1, 2, 4, 8 or 16 -> (Q, N, W)."""
    for name, t in (("words_q", words_q), ("words_db", words_db)):
        if not t.is_cuda or t.dtype != torch.int32 or t.dim() != 2 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D int32 CUDA "
                             f"tensor, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    nq, w = words_q.shape
    if words_db.shape[1] != w or words_db.device != words_q.device:
        raise ValueError(f"words {tuple(words_q.shape)} vs "
                         f"{tuple(words_db.shape)}: widths or devices differ")
    if bits not in (1, 2, 4, 8, 16):
        raise ValueError(f"bits must be 1, 2, 4, 8 or 16, got {bits}")
    return nq, words_db.shape[0], w


def check_valid(valid_words: torch.Tensor, words_db: torch.Tensor) -> None:
    """Raises unless ``valid_words`` is a contiguous int32 tensor of
    ceil(N/32) words on the corpus's device. Bits past N are never read:
    the kernels stop at row N."""
    nw = (words_db.shape[0] + 31) // 32
    if valid_words.dtype != torch.int32 or tuple(valid_words.shape) != (nw,) \
            or not valid_words.is_contiguous() \
            or valid_words.device != words_db.device:
        raise ValueError(f"valid_words must be a contiguous int32 tensor "
                         f"[{nw}] on {words_db.device}, got "
                         f"{valid_words.dtype} {tuple(valid_words.shape)} on "
                         f"{valid_words.device}")


def _topk(words_q, words_db, valid_words, bits: int, k: int, top_k: int,
          s):
    """Partial top-k over S corpus ranges, then the merge: the unmasked
    entry point when ``valid_words`` is None, else the masked one."""
    global launches, masked_launches
    from repro_torch.kernels import _build
    nq, n, w = check_words(words_q, words_db, bits)
    if valid_words is not None:
        check_valid(valid_words, words_db)
    if top_k < 1:
        raise ValueError(f"top_k must be at least 1, got {top_k}")
    dev = words_q.device
    if nq == 0 or n == 0:
        empty = torch.full((nq, top_k), -1, dtype=torch.int32, device=dev)
        return empty, empty.clone()
    vals = torch.empty((nq, top_k), dtype=torch.int32, device=dev)
    ids = torch.empty((nq, top_k), dtype=torch.int32, device=dev)
    s = resolve_ranges(s, nq, n, dev)
    part_v = torch.empty((s, nq, top_k), dtype=torch.int32, device=dev)
    part_i = torch.empty((s, nq, top_k), dtype=torch.int32, device=dev)
    tail = [part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), nq, n, w, bits, k, top_k, s,
            torch.cuda.current_stream(dev).cuda_stream]
    types = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    if valid_words is None:
        fn = _build.function("packed_topk", "packed_topk_launch",
                             [_P, _P] + types)
        err = fn(words_q.data_ptr(), words_db.data_ptr(), *tail)
    else:
        fn = _build.function("packed_topk", "packed_topk_masked_launch",
                             [_P, _P, _P] + types)
        err = fn(words_q.data_ptr(), words_db.data_ptr(),
                 valid_words.data_ptr(), *tail)
    if err:
        raise RuntimeError(f"packed_topk kernel launch failed: CUDA error {err}")
    if valid_words is None:
        launches += 1
    else:
        masked_launches += 1
    return vals, ids


def packed_topk_cuda(words_q: torch.Tensor, words_db: torch.Tensor,
                     bits: int, k: int, top_k: int, n_ranges=None):
    """Launches the partial top-k kernel over S corpus ranges and the
    merge kernel -> (counts, ids) int32 [Q, top_k]."""
    return _topk(words_q, words_db, None, bits, k, top_k, n_ranges)


def packed_topk_masked_cuda(words_q: torch.Tensor, words_db: torch.Tensor,
                            valid_words: torch.Tensor, bits: int, k: int,
                            top_k: int, n_ranges=None):
    """``packed_topk_cuda`` over the rows whose bit is set in
    ``valid_words`` int32 [ceil(N/32)] -> (counts, ids) int32 [Q, top_k];
    slots past the live count are (-1, -1)."""
    return _topk(words_q, words_db, valid_words, bits, k, top_k, n_ranges)


def packed_collision_counts_cuda(words_q: torch.Tensor,
                                 words_db: torch.Tensor, bits: int,
                                 k: int,
                                 block_q: int = COUNT_BLOCK_Q) -> torch.Tensor:
    """Launches the all-pairs count kernel, ``block_q`` queries a block
    -> int32 counts [Q, N]."""
    global counts_launches
    from repro_torch.kernels import _build
    nq, n, w = check_words(words_q, words_db, bits)
    if block_q < 1 or -(-nq // block_q) > 65535:
        raise ValueError(f"block_q must be positive and at most 65535 "
                         f"blocks of it cover the queries, got {block_q} "
                         f"for {nq}")
    out = torch.empty((nq, n), dtype=torch.int32, device=words_q.device)
    if nq == 0 or n == 0:
        return out
    fn = _build.function("packed_counts", "packed_counts_launch",
                         [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    err = fn(words_q.data_ptr(), words_db.data_ptr(), out.data_ptr(), nq, n,
             w, bits, k, block_q,
             torch.cuda.current_stream(words_q.device).cuda_stream)
    if err:
        raise RuntimeError(f"packed_collision_counts kernel launch failed: "
                           f"CUDA error {err}")
    counts_launches += 1
    return out
